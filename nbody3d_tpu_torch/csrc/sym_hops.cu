// sym_hops: the off-diagonal tile pairs of the fused Newton-3 step.
//
// Replaces: nbody3d_tpu/ops/pallas_force.py::_sym_hops_kernel (reached by
// _sym_hops_raw from sym_verlet_step_pallas).  The TPU-only wrap-tail copy
// _extend_tail_kernel has no counterpart: this kernel indexes the source
// tile as j = (i + k) mod nt itself.
//
// What it computes: for every unordered tile pair (i, j = (i + k) mod nt)
// of one launch, each pair's weight inv3 = rsqrt(d2^3) once, then both
// directions of Newton's third law:
//   forward  acc[i-row] += G*m_j * inv3 * (x_j - x_i)
//   reverse  acc[j-row] -= G*m_i * inv3 * (x_j - x_i)
// The launches cover the pair sets of _sym_hops_raw: call B takes
// k = 1..half-1 for even nt (1..half for odd nt) over all nt rows; call C,
// even nt only, takes the shared half hop k = nt/2 over rows i < nt/2, so
// each pair at that distance is counted once.  nt = 2 has no call B.
//
// What the GPU version does not copy: the bf16 3-limb operands and the
// block-centroid un-centring of the TPU kernel (they exist for the MXU's
// bf16 rounding).  Here both directions use the same f32 inv3 and the same
// f32 dx, so the pair's momentum cancels to f32 rounding of the two
// products, not of a limb reconstruction.
//
// What bounds it on an H100: the step's N^2/2 pairs, each ~12 FP32 issue
// slots, one MUFU rsqrt and three shared-memory float atomics (the reverse
// sum).  Global memory sees O(N * nt) atomics in all, a small share.
//
// Design: one CUDA block per tile pair, one thread per target row of tile
// i.  Tile j is staged in shared memory (SoA, so a warp reads 32 banks).
// Thread t visits source s = (t + r) mod b at step r: the forward sum stays
// in registers, and the reverse term goes to a shared-memory accumulator
// with atomicAdd; in the staggered order the lanes of a warp hit 32
// distinct addresses, so they rarely collide.  CUDA blocks run in parallel
// and in no order, unlike the TPU's sequential grid that carried the
// reverse accumulator in VMEM, so each block ends with one global atomicAdd
// per row and component for each side.  Atomics make the f32 sum order
// vary from run to run: results agree with the plain version to f32
// reduction-order tolerance, not bit for bit.
#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

__global__ void __launch_bounds__(1024)
sym_hops_kernel(const float4* __restrict__ src, float* __restrict__ acc, int nt, int b, int k0,
                float eps2) {
    extern __shared__ float sh[];
    float* sx = sh;
    float* sy = sx + b;
    float* sz = sy + b;
    float* sg = sz + b;
    float* rx = sg + b;
    float* ry = rx + b;
    float* rz = ry + b;
    const int t = threadIdx.x;
    const int i = blockIdx.x;
    int j = i + k0 + static_cast<int>(blockIdx.y);
    if (j >= nt) j -= nt;
    const long long row_i = static_cast<long long>(i) * b + t;
    const long long row_j = static_cast<long long>(j) * b + t;
    const float4 me = src[row_i];
    const float4 q = src[row_j];
    sx[t] = q.x;
    sy[t] = q.y;
    sz[t] = q.z;
    sg[t] = q.w;
    rx[t] = 0.f;
    ry[t] = 0.f;
    rz[t] = 0.f;
    __syncthreads();
    float ax = 0.f, ay = 0.f, az = 0.f;
    for (int r = 0; r < b; ++r) {
        int s = t + r;
        if (s >= b) s -= b;
        const float dx = sx[s] - me.x;
        const float dy = sy[s] - me.y;
        const float dz = sz[s] - me.z;
        const float inv3 = pair_inv3(dx, dy, dz, eps2);
        const float wf = sg[s] * inv3;
        ax = fmaf(wf, dx, ax);
        ay = fmaf(wf, dy, ay);
        az = fmaf(wf, dz, az);
        const float wr = me.w * inv3;
        atomicAdd(&rx[s], -(wr * dx));
        atomicAdd(&ry[s], -(wr * dy));
        atomicAdd(&rz[s], -(wr * dz));
    }
    __syncthreads();
    float* ai = acc + row_i * 4;
    atomicAdd(ai + 0, ax);
    atomicAdd(ai + 1, ay);
    atomicAdd(ai + 2, az);
    float* aj = acc + row_j * 4;
    atomicAdd(aj + 0, rx[t]);
    atomicAdd(aj + 1, ry[t]);
    atomicAdd(aj + 2, rz[t]);
}

}  // namespace

// One launch: tile rows i = 0..grid_i-1 against hops k = k0..k0+nk-1.
extern "C" int nb_sym_hops(const void* src, void* acc_hop, int nt, int b, int k0, int nk,
                           int grid_i, float eps2, void* stream) {
    if (grid_i > 0 && nk > 0) {
        const size_t smem = 7 * static_cast<size_t>(b) * sizeof(float);
        const dim3 grid(grid_i, nk);
        sym_hops_kernel<<<grid, b, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(src), static_cast<float*>(acc_hop), nt, b, k0, eps2);
    }
    return static_cast<int>(cudaGetLastError());
}
