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
// What the first design lost: one row a thread, so each pair read its
// source as two 16-byte shared loads (position+mass, cotangent), tested the
// self pair in every tile, and took rsqrtf's subnormal guard: 49.00
// instructions a pair in its SASS; at two-galaxy its 314 blocks of 4 warps
// left the card's 132 SMs ~9.5 warps each.
//
// Design: exact.cuh's schedule with the VJP pair.
//   * A thread holds kRows = 2 target rows (t, t + 128) in registers, so
//     the two 16-byte reads of a staged source serve two pairs.
//   * The block stages 128 sources at a time (two float4 planes, [x, y, z,
//     m] and [Ā, 0]), fetching the next tile into registers while it sweeps
//     this one.  Each tile's sums go into a partial before the running
//     totals take it, as in the first design, which keeps the heavy bodies'
//     terms from swamping the light ones' in one long f32 sum.
//   * Only the two tiles the block's rows lie in can hold a row's self pair:
//     the loop tests the index there alone, a branch uniform over the block.
//     The self pair must be masked, not left as w * 0: there g cancels only
//     to rounding while w = eps2^-3/2.
//   * Where eps2 >= FLT_MIN the pair takes the ftz rsqrt (vjp_pair<true>,
//     rsqrtf's bits: d2 >= eps2 is normal).
//   * Where the row blocks alone cannot fill the card (two-galaxy's 157
//     blocks of 256 rows), S = `split` CTAs of a cluster take the same rows,
//     each over a contiguous range of source tiles, and exact::finish adds
//     their [x̄, m̄] partials in rank order through distributed shared
//     memory.  S is ops/launch.py's exact_split, as for force_exact (the
//     VJP's sweep of S at two-galaxy peaked where force_exact's did).
//   * gbar: each CTA reduces its rows' φ partials in double (warp shuffles,
//     then one shared slot a warp) and adds it with one double atomicAdd;
//     the wrapper zeroes the scalar.
// 39.62 instructions a pair (44.50 in the two diagonal tiles).  With S = 1 a
// row's sum is, term for term, the first design's (the same pair
// arithmetic, tiles and order), so pm_bar is that kernel's to the bit; no
// atomics touch the rows, so it is the same from run to run.
#include <cfloat>

#include <cuda_runtime.h>

#include "exact.cuh"
#include "pair.cuh"

// Build-time knobs with the shipped values, for studies/vjp_variants.py
// (-D): NB_VJP_FULL_UNROLL, the tile loop's unroll; NB_VJP_FULL_MIN_BLOCKS,
// the launch bound's CTAs an SM; NB_VJP_FULL_FACTORED, the tile_sums of
// studies/vjp_full_factored.cuh (x̄ factored through row sums; the study
// puts studies/ on the include path) in place of the one below.
#ifndef NB_VJP_FULL_UNROLL
#define NB_VJP_FULL_UNROLL 4
#endif
#ifndef NB_VJP_FULL_MIN_BLOCKS
#define NB_VJP_FULL_MIN_BLOCKS 4
#endif

namespace {

using exact::kBlockRows;
using exact::kRows;
using exact::kThreads;
using exact::kTile;

struct Sums {
    float x, y, z, m, phi;  // x̄, m̄ and φ of a row, per unit G
};

__device__ __forceinline__ float4 staged(const float4* __restrict__ rows, int s, int n) {
    return s < n ? rows[s] : make_float4(0.f, 0.f, 0.f, 0.f);
}

constexpr int kUnroll = NB_VJP_FULL_UNROLL;

#ifdef NB_VJP_FULL_FACTORED
#include "vjp_full_factored.cuh"
#else
// The terms of the staged tile (tp, ta) on the thread's rows, each row's
// summed into a partial in source order, then added to its total.  kDiag:
// the tile holds a row of the block, the one whose self[r] is in
// [0, kTile): that source is skipped.
template <bool kNormal, bool kDiag>
__device__ __forceinline__ void tile_sums(const float4* tp, const float4* ta, const float4 (&me)[kRows],
                                          const float3 (&ak)[kRows], const int (&self)[kRows], float eps2,
                                          Sums (&tot)[kRows]) {
    Sums p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) p[r] = Sums{0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll (kUnroll)
    for (int j = 0; j < kTile; ++j) {
        const float4 s = tp[j];
        const float4 a = ta[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            if (kDiag && j == self[r]) continue;  // self pair
            const VjpPair e = vjp_pair<kNormal>(me[r], ak[r], s, make_float3(a.x, a.y, a.z), eps2);
            p[r].x += e.tx;
            p[r].y += e.ty;
            p[r].z += e.tz;
            p[r].m += e.mbar_t;
            p[r].phi += e.phi_t;
        }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        tot[r].x += p[r].x;
        tot[r].y += p[r].y;
        tot[r].z += p[r].z;
        tot[r].m += p[r].m;
        tot[r].phi += p[r].phi;
    }
}
#endif

// CTAs an SM the launch bound asks for: 4 x 128 threads leave a thread up to
// 128 registers (it takes 91-95) where 8 left 64; 6% faster on an H100 (PERF.md
// section 6).
constexpr int kMinBlocks = NB_VJP_FULL_MIN_BLOCKS;

template <bool kNormal>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
vjp_full_kernel(const float4* __restrict__ pm, const float4* __restrict__ abar, float4* __restrict__ pm_bar,
                double* __restrict__ gbar, int n, float G, float eps2, int split) {
    __shared__ float4 tp[kTile];
    __shared__ float4 ta[kTile];
    __shared__ float4 part[kBlockRows];
    __shared__ double warp_sum[kThreads / 32];
    const int t = threadIdx.x;
    const int rank = blockIdx.x % split;
    const int row0 = blockIdx.x / split * kBlockRows;
    float4 me[kRows];
    float3 ak[kRows];
    Sums tot[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int row = row0 + t + r * kThreads;
        me[r] = staged(pm, row, n);
        const float4 a = staged(abar, row, n);
        ak[r] = make_float3(a.x, a.y, a.z);
        tot[r] = Sums{0.f, 0.f, 0.f, 0.f, 0.f};
    }
    const int n_tiles = (n + kTile - 1) / kTile;
    const int lo = exact::range_start(rank, n_tiles, split);
    const int hi = exact::range_start(rank + 1, n_tiles, split);
    const int diag = row0 / kTile;  // the block's rows are source tiles diag and diag + 1
    float4 np = staged(pm, lo * kTile + t, n);
    float4 na = staged(abar, lo * kTile + t, n);
    for (int c = lo; c < hi; ++c) {
        tp[t] = np;
        ta[t] = make_float4(na.x, na.y, na.z, 0.f);
        __syncthreads();
        if (c + 1 < hi) {
            np = staged(pm, (c + 1) * kTile + t, n);
            na = staged(abar, (c + 1) * kTile + t, n);
        }
        if (c - diag == 0 || c - diag == 1) {
            int self[kRows];
#pragma unroll
            for (int r = 0; r < kRows; ++r) self[r] = row0 + t + r * kThreads - c * kTile;
            tile_sums<kNormal, true>(tp, ta, me, ak, self, eps2, tot);
        } else {
            const int none[kRows] = {};
            tile_sums<kNormal, false>(tp, ta, me, ak, none, eps2, tot);
        }
        __syncthreads();
    }

    double v = 0.0;
    float4 xm[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (row0 + t + r * kThreads < n) v += static_cast<double>(tot[r].phi);
        xm[r] = make_float4(tot[r].x, tot[r].y, tot[r].z, tot[r].m);
    }
    exact::finish(xm, row0, n, rank, split, part, [&](int row, float4 s) {
        pm_bar[row] = make_float4(G * s.x, G * s.y, G * s.z, G * s.w);
    });

    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if ((t & 31) == 0) warp_sum[t >> 5] = v;
    __syncthreads();
    if (t == 0) {
        double total = 0.0;
        for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
        atomicAdd(gbar, total);
    }
}

}  // namespace

// n rows; `split` CTAs a block of exact::kBlockRows rows (ops/launch.py
// exact_split), a thread-block cluster where it is more than 1.
extern "C" int nb_vjp_full(const void* pm, const void* abar, void* pm_bar, void* gbar, int n, float G, float eps2,
                           int split, void* stream) {
    if (n <= 0) return static_cast<int>(cudaGetLastError());
    const auto kernel = eps2 >= FLT_MIN ? vjp_full_kernel<true> : vjp_full_kernel<false>;
    const cudaError_t rc = exact::launch(kernel, n, split, static_cast<cudaStream_t>(stream),
                                         static_cast<const float4*>(pm), static_cast<const float4*>(abar),
                                         static_cast<float4*>(pm_bar), static_cast<double*>(gbar), n, G, eps2, split);
    return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}
