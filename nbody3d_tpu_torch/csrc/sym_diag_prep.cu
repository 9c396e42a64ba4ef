// sym_diag_prep: first stage of the Newton-3 ("sym") step and force.
//
// Replaces: nbody3d_tpu/ops/pallas_force.py::_sym_diag_prep_kernel
// (reached by sym_diag_prep_pallas from sym_verlet_step_pallas and from
// accel_sym_pallas(center=True)).
//
// What it computes, per tile of b bodies (one CUDA block, one thread a body):
//   - src[row] = [x, y, z, G*m], the G-folded source rows the hops read;
//   - acc_diag[row] = the in-tile partial acceleration: every ordered pair
//     of the tile, the self pair skipped by index, w lane 0.
//
// What the GPU version does not copy: the TPU kernel also built a bf16
// 3-limb split of block-centred gm*(x - c) and the block centroids, so
// that operands survive the MXU's bf16 rounding.  A CUDA-core f32 kernel
// forms dx = x_j - x_i per pair anyway and sums w*gm*dx directly, so
// neither limbs nor centroids exist here.
//
// What bounds it on an H100: it does b^2 pairs per tile (N*b in all, a
// small share of the step's N^2/2), so FP32 issue and MUFU rsqrt again;
// the O(N) row reads and writes are coalesced float4 accesses.
//
// Design: the tile is staged once in shared memory as four SoA arrays and
// each thread sums its row with pair.cuh's in_tile_pull (the staggered
// order (t + r) mod b, r = 1..b-1, skips the self pair without a branch and
// keeps the 32 lanes of a warp on 32 consecutive banks).  sym_diag runs the
// same loop on source rows built outside the kernel.
#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

__global__ void __launch_bounds__(1024)
sym_diag_prep_kernel(const float4* __restrict__ pm, float4* __restrict__ src,
                     float4* __restrict__ acc, int b, float G, float eps2) {
    extern __shared__ float sh[];
    float* sx = sh;
    float* sy = sx + b;
    float* sz = sy + b;
    float* sg = sz + b;
    const int t = threadIdx.x;
    const long long row = static_cast<long long>(blockIdx.x) * b + t;
    const float4 p = pm[row];
    const float gm = G * p.w;
    src[row] = make_float4(p.x, p.y, p.z, gm);
    sx[t] = p.x;
    sy[t] = p.y;
    sz[t] = p.z;
    sg[t] = gm;
    __syncthreads();
    const float3 a = in_tile_pull(sx, sy, sz, sg, b, t, p, eps2);
    acc[row] = make_float4(a.x, a.y, a.z, 0.f);
}

}  // namespace

extern "C" int nb_sym_diag_prep(const void* pm, void* src, void* acc_diag, int nt, int b,
                                float G, float eps2, void* stream) {
    if (nt > 0) {
        const size_t smem = 4 * static_cast<size_t>(b) * sizeof(float);
        sym_diag_prep_kernel<<<nt, b, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(pm), static_cast<float4*>(src),
            static_cast<float4*>(acc_diag), b, G, eps2);
    }
    return static_cast<int>(cudaGetLastError());
}
