// sym_diag: the in-tile pairs of the uncentred Newton-3 force.
//
// Replaces: nbody3d_tpu/ops/pallas_force.py::_sym_diag_kernel (reached by
// accel_sym_pallas(center=False), the ablation route whose operands are
// built outside the kernel).
//
// What it computes, per tile of b bodies (one CUDA block, one thread a
// body): acc[row] = the pull on the row from every other body of its tile,
// read from the prepared source rows src = [x, y, z, G*m] (built by torch,
// as XLA builds the JAX kernel's operands), the self pair skipped by index,
// w lane 0.  That is sym_diag_prep without the preparation: on the same
// source rows the two give the same bits, so center=True and center=False
// give the same accelerations.
//
// What the GPU version does not copy: the TPU kernel took a (b, b)
// ones-minus-eye mask, the transposed sources, uncentred bf16 3-limb
// operands (N, 16) and zero centroids, and computed one masked MXU dot whose
// limbs combine16 later folded.  With no limbs, centring changes nothing
// here.  The other design, the moment form [Σ w·gm·x, Σ w·gm·y, Σ w·gm·z,
// Σ w·gm] with a = m − x·m_w (_fast_epilogue's algebra), was not taken: it
// subtracts two O(|x|) sums to get an O(tile radius) result, so f32 loses
// what centring saved on the TPU, and it would need a combine of its own.
// Fast mode, which needs that algebra on the tensor cores, brings it.
//
// What bounds it on an H100: b - 1 pairs a row (N*b in all, a small share
// of a force evaluation's N^2/2), ~10 FP32 issue slots and one MUFU rsqrt
// a pair: FP32 issue and MUFU throughput.  The O(N) reads and writes are
// coalesced float4 accesses, 32 bytes a row.
//
// Design: sym_diag_prep's: the tile is staged once in shared memory as four
// SoA arrays and each thread sums its row with pair.cuh's in_tile_pull.
#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

__global__ void __launch_bounds__(1024)
sym_diag_kernel(const float4* __restrict__ src, float4* __restrict__ acc, int b, float eps2) {
    extern __shared__ float sh[];
    float* sx = sh;
    float* sy = sx + b;
    float* sz = sy + b;
    float* sg = sz + b;
    const int t = threadIdx.x;
    const long long row = static_cast<long long>(blockIdx.x) * b + t;
    const float4 q = src[row];
    sx[t] = q.x;
    sy[t] = q.y;
    sz[t] = q.z;
    sg[t] = q.w;
    __syncthreads();
    const float3 a = in_tile_pull(sx, sy, sz, sg, b, t, q, eps2);
    acc[row] = make_float4(a.x, a.y, a.z, 0.f);
}

}  // namespace

extern "C" int nb_sym_diag(const void* src, void* acc_diag, int nt, int b, float eps2,
                           void* stream) {
    if (nt > 0) {
        const size_t smem = 4 * static_cast<size_t>(b) * sizeof(float);
        sym_diag_kernel<<<nt, b, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(src), static_cast<float4*>(acc_diag), b, eps2);
    }
    return static_cast<int>(cudaGetLastError());
}
