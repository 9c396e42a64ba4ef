// force_exact: f32 softened all-pairs accelerations of targets against
// every source.
//
// Replaces: nbody3d_tpu/ops/pallas_force.py::_force_kernel_exact (reached by
// accel_pallas(mode="exact")), the kernel of the default `cli run` path.
//
// What it computes: out[i] = sum_j G*m_j * rsqrt(d2^3) * (x_j - x_i), with
// d2 = |x_j - x_i|^2 + eps2, w lane 0.  No self mask: the self pair's
// separation is exactly zero.  Padded sources carry m = 0 and add nothing.
//
// What bounds it on an H100: per pair 12 FP32 issue slots and one MUFU
// rsqrt (exact.cuh); instruction issue binds, never memory (each source is
// staged once in shared memory for a block's 256 targets).
//
// Design (exact.cuh; the classic shared-memory tile kernel of arXiv
// 0706.3060 with two target rows a thread): each block takes 256 target
// rows, 2 a thread in registers, and sweeps staged tiles of 128 sources
// (G folded into the mass on the way in, so G is a runtime argument) as
// broadcast reads, each tile summed into its own partial first.  The TPU
// version streamed (4, BS) source tiles through VMEM and reduced over
// lanes; here the reduction is a register accumulator.  Where the row
// blocks cannot fill the card the wrapper asks for S > 1 (ops/launch.py
// exact_split): a cluster of S CTAs splits the source tiles and combines its
// partials through distributed shared memory in rank order.  The ftz rsqrt
// where eps2^3 is normal.  fused_step_exact runs the same loop and combine,
// so the two kernels' forces are the same bits.
#include <cuda_runtime.h>

#include "exact.cuh"
#include "sym_pairs.cuh"

namespace {

template <bool kNormal>
__global__ void __launch_bounds__(exact::kThreads)
force_exact_kernel(const float4* __restrict__ tgt, const float4* __restrict__ src,
                   float4* __restrict__ out, int n_t, int n_s, float G, float eps2, int split) {
    __shared__ float4 tile[exact::kTile];
    __shared__ float4 part[exact::kBlockRows];
    const int rank = blockIdx.x % split;
    const int row0 = blockIdx.x / split * exact::kBlockRows;
    float3 a[exact::kRows];
    exact::pull_share<kNormal>(tgt, row0, n_t, src, n_s, rank, split, G, eps2, a, tile);
    exact::finish(a, row0, n_t, rank, split, part,
                  [&](int row, float3 f) { out[row] = make_float4(f.x, f.y, f.z, 0.f); });
}

}  // namespace

extern "C" int nb_force_exact(const void* tgt, const void* src, void* out, int n_t, int n_s,
                              float G, float eps2, int split, void* stream) {
    if (n_t <= 0) return static_cast<int>(cudaGetLastError());
    const auto kernel = sym_pairs::normal_cubes(eps2) ? force_exact_kernel<true> : force_exact_kernel<false>;
    const cudaError_t rc = exact::launch(kernel, n_t, split, static_cast<cudaStream_t>(stream),
                                         static_cast<const float4*>(tgt), static_cast<const float4*>(src),
                                         static_cast<float4*>(out), n_t, n_s, G, eps2, split);
    return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}
