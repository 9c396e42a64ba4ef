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
// What bounds it on an H100: per pair, ~10 FP32 FMA/FMUL/FADD issue slots
// plus one MUFU rsqrt; the MUFU unit runs at a quarter of the FMA rate, so
// the pair loop is bound by instruction issue and MUFU throughput, never
// by memory (each source is read from shared memory by a whole block).
//
// Design (the classic shared-memory tile kernel, arXiv 0706.3060): one
// thread per target holding its sum in registers; each block stages a
// tile of kTile sources through shared memory (G folded into the mass on
// the way in, so G is a runtime argument and needs no rebuild) and every
// thread sweeps the tile as a broadcast read.  The TPU version streamed
// (4, BS) source tiles through VMEM and reduced over lanes; here the
// reduction is a register accumulator and needs no cross-thread step.
// The loop is pair.cuh's all_pairs_pull, which sums each source tile into
// its own partial first (its note says why) and which fused_step_exact
// shares, so the two kernels' forces are the same bits.
#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

constexpr int kTile = 128;

__global__ void __launch_bounds__(kTile)
force_exact_kernel(const float4* __restrict__ tgt, const float4* __restrict__ src,
                   float4* __restrict__ out, int n_t, int n_s, float G, float eps2) {
    __shared__ float4 tile[kTile];
    const int row = blockIdx.x * kTile + threadIdx.x;
    const float4 me = row < n_t ? tgt[row] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float3 a = all_pairs_pull<kTile>(src, n_s, G, eps2, me, tile);
    if (row < n_t) out[row] = make_float4(a.x, a.y, a.z, 0.f);
}

}  // namespace

extern "C" int nb_force_exact(const void* tgt, const void* src, void* out, int n_t,
                              int n_s, float G, float eps2, void* stream) {
    if (n_t > 0) {
        const dim3 grid((n_t + kTile - 1) / kTile);
        force_exact_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(tgt), static_cast<const float4*>(src),
            static_cast<float4*>(out), n_t, n_s, G, eps2);
    }
    return static_cast<int>(cudaGetLastError());
}
