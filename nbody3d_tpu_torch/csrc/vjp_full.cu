// vjp_full: the force VJP over the full grid, every target against every
// source.
//
// Replaces: nbody3d_tpu/ops/force_vjp.py::_vjp_kernel (reached by
// force_vjp_pallas, the backward of make_diff_accel(sym=False)).
//
// What it computes: for the cotangent A of a = G * F (F_k = sum_j w m_j d),
//   pm_bar[k] = G * [sum_j t_kj, sum_j mbar_kj]   (pair terms in pair.cuh)
//   gbar     += sum_k sum_j phi_kj                 (= sum_k A_k . F_k)
// with the self pair masked by index.  Sources past n read as zero rows
// (mass 0, cotangent 0), whose terms are exactly 0.
//
// What the GPU version does not copy: the TPU kernel cast the x̄ sum into
// three MXU dots (W, S, T against [A, m] and [x, 1]) and folded the target
// term out with the row-sum identity S@x - x*(S@1); to survive the MXU's
// bf16 rounding it split every operand into bf16 limbs.  A CUDA-core f32
// kernel forms d per pair, so it adds the pair's x̄ term t directly: no
// limbs, no fold, no cancellation of large row sums.
//
// What bounds it on an H100: FP32 issue.  Per pair about 53 FP32 FLOP
// (an FMA counted as 2) and one MUFU rsqrt, over N^2 ordered pairs; the
// FP32 rate (67 TFLOP/s) binds before the MUFU rate (1/8 of the FMA rate).
// Memory traffic is O(N * N/128) reads of shared tiles, far below HBM.
//
// Design: the force_exact shape.  One thread per target row, kTile rows a
// block; the block stages kTile source rows (position+mass and cotangent)
// through shared memory and every thread sweeps them as broadcast reads.
// Each tile's sums go into a partial before the running totals take it
// (the TPU kernel summed each source block before accumulating), which
// keeps the heavy bodies' terms from swamping the light ones' in one long
// f32 sum.  No atomics on the rows, so pm_bar is the same bit for bit
// from run to run.  gbar: each block reduces its rows' phi in double
// (warp shuffles, then one shared slot a warp) and adds it with one double
// atomicAdd; the wrapper zeroes the scalar.
#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

constexpr int kTile = 128;

__global__ void __launch_bounds__(kTile)
vjp_full_kernel(const float4* __restrict__ pm, const float4* __restrict__ abar,
                float4* __restrict__ pm_bar, double* __restrict__ gbar, int n, float G,
                float eps2) {
    __shared__ float4 tp[kTile];
    __shared__ float4 ta[kTile];
    __shared__ double warp_sum[kTile / 32];
    const int row = blockIdx.x * kTile + threadIdx.x;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 me = row < n ? pm[row] : zero;
    const float4 a4 = row < n ? abar[row] : zero;
    const float3 ak = make_float3(a4.x, a4.y, a4.z);
    float xx = 0.f, xy = 0.f, xz = 0.f, mb = 0.f, phi = 0.f;
    for (int base = 0; base < n; base += kTile) {
        const int s = base + threadIdx.x;
        tp[threadIdx.x] = s < n ? pm[s] : zero;
        ta[threadIdx.x] = s < n ? abar[s] : zero;
        __syncthreads();
        float px = 0.f, py = 0.f, pz = 0.f, pmb = 0.f, pphi = 0.f;
#pragma unroll 4
        for (int r = 0; r < kTile; ++r) {
            if (base + r == row) continue;  // self pair
            const float4 a = ta[r];
            const VjpPair e = vjp_pair(me, ak, tp[r], make_float3(a.x, a.y, a.z), eps2);
            px += e.tx;
            py += e.ty;
            pz += e.tz;
            pmb += e.mbar_t;
            pphi += e.phi_t;
        }
        xx += px;
        xy += py;
        xz += pz;
        mb += pmb;
        phi += pphi;
        __syncthreads();
    }
    if (row < n) pm_bar[row] = make_float4(G * xx, G * xy, G * xz, G * mb);

    double v = phi;  // 0 for rows past n
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        double total = 0.0;
        for (int w = 0; w < kTile / 32; ++w) total += warp_sum[w];
        atomicAdd(gbar, total);
    }
}

}  // namespace

extern "C" int nb_vjp_full(const void* pm, const void* abar, void* pm_bar, void* gbar, int n,
                           float G, float eps2, void* stream) {
    if (n > 0) {
        const dim3 grid((n + kTile - 1) / kTile);
        vjp_full_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(pm), static_cast<const float4*>(abar),
            static_cast<float4*>(pm_bar), static_cast<double*>(gbar), n, G, eps2);
    }
    return static_cast<int>(cudaGetLastError());
}
