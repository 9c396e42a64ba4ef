// vjp_sym_diag: the diagonal tiles of the Newton-3 ("sym") force VJP.
//
// Replaces: nbody3d_tpu/ops/force_vjp.py::_vjp_sym_diag_kernel (reached by
// force_vjp_sym_pallas, the backward of the fused sym step and of
// make_diff_accel(sym=True)).
//
// What it computes, per tile of b bodies (one CUDA block, one thread a
// body): every ordered pair inside the tile, self pair skipped by index,
// into acc_diag (N, 8) per unit G, rows [x̄(3), m̄, φ, 0, 0, 0] (pair terms
// in pair.cuh).  vjp_sym_hops adds the off-diagonal tile pairs and
// vjp_combine sums both.
//
// What the GPU version does not copy: the TPU kernel multiplied a (B, B)
// 0/1 mask into its weight matrices and contracted them on the MXU against
// bf16 limb planes of [A, m | x, 1], then folded the target term out
// through row sums.  Here the self pair is skipped by the loop's order and
// the pair's x̄ term is added directly in f32.
//
// What bounds it on an H100: FP32 issue.  The function needs each of the
// N(b-1)/2 unordered pairs of its tiles once, about 61 FP32 FLOP and one MUFU
// rsqrt each (vjp_sym_hops' pair), a small share of the VJP's N^2/2 pairs;
// the O(N) row traffic is coalesced float4 loads and stores.
//
// What the first design lost: it staged the tile as seven SoA arrays, so a
// pair read its source as seven scalar LDS, took the staggered order's wrap
// test (s >= b ? s - b : s), rsqrtf's subnormal guard, and a runtime b that
// kept the loop rolled: 61 instructions a pair for the pair's 40 FP32.
//
// Design.  The tile is staged twice over as two float4 planes, [x, y, z, m]
// and [Ax, Ay, Az, 0], each 2b rows, so thread t reads source (t + r) mod b
// as plane[t + r]: two 16-byte reads a pair, no wrap test, a warp's 32 lanes
// on 32 consecutive rows.  Where eps2 >= FLT_MIN the pair takes the ftz
// rsqrt (vjp_pair<true>: d2 >= eps2 is normal, so rsqrtf's bits).
//   * The tile width 256 (the port's GPU_TILE, every main path's) takes each
//     unordered pair once (Newton-3): thread t the sources t + r,
//     r = 1..128 (r = 128, the pair half a tile apart, only for t < 128).
//     The pair's terms serve both rows: the target keeps t, mbar_t and
//     phi_t, the source's five sums (-t, mbar_s, phi_s) move down the warp by
//     shuffles, so that at step r lane l holds row t0 + l + r's: lane 0 hands
//     row t0 + r to its warp's slab in shared memory, lane 31 starts the next
//     row.  At the end each row adds the 8 warps' slabs to its own sums, in
//     warp order.  61.78 instructions an unordered pair in its SASS against
//     the ordered loop's 2 x 41.00 (0.0865 against 0.1062 ms at N = 262,144
//     on an H100, PERF.md section 6); another order of summation than the
//     first design's, so it is held to the twin's tolerance, not to its
//     bits.
//   * Other widths (up to 1,024) take the ordered loop, sym_diag_prep's
//     (pair.cuh's in_tile_pull with the VJP pair): row t sums its sources in
//     the staggered order (t + r) mod b, r = 1..b-1, unrolled by 8, the self
//     pair skipped by the order: the first design's order and arithmetic, so
//     its bits.
#include <cfloat>

#include <cuda_runtime.h>

#include "pair.cuh"
#include "sym_pairs.cuh"

// Build-time knobs with the shipped values, for studies/vjp_variants.py
// (-D): NB_VJP_DIAG_N3 0 takes the ordered loop at every width, the tile of
// 256 too; NB_VJP_DIAG_N3_UNROLL is the Newton-3 loop's unroll.
#ifndef NB_VJP_DIAG_N3
#define NB_VJP_DIAG_N3 1
#endif
#ifndef NB_VJP_DIAG_N3_UNROLL
#define NB_VJP_DIAG_N3_UNROLL 9
#endif

namespace {

constexpr int kTile = 256;           // the Newton-3 instance's tile (ops/step.py GPU_TILE)
constexpr int kN3Unroll = NB_VJP_DIAG_N3_UNROLL;
constexpr int kWarps = kTile / 32;
constexpr int kSpan = kTile / 2 + 32;  // a warp's reverse rows: t0 + 1 .. t0 + kTile / 2 + 31
constexpr int kSums = 5;             // a row's sums: x̄ (3), m̄, φ

// Stages row t of a tile of b rows at t and b + t of both planes.
__device__ __forceinline__ void stage(float4* tp, float4* ta, int t, int b, float4 me, float4 a) {
    const float4 av = make_float4(a.x, a.y, a.z, 0.f);
    tp[t] = me;
    tp[b + t] = me;
    ta[t] = av;
    ta[b + t] = av;
}

__device__ __forceinline__ void store(float4* __restrict__ acc, long long row, const float (&s)[kSums]) {
    acc[2 * row] = make_float4(s[0], s[1], s[2], s[3]);
    acc[2 * row + 1] = make_float4(s[4], 0.f, 0.f, 0.f);
}

// The ordered loop, any width b up to 1,024.
template <bool kNormal>
__global__ void __launch_bounds__(1024)
vjp_sym_diag_kernel(const float4* __restrict__ pm, const float4* __restrict__ abar,
                    float4* __restrict__ acc, int b, float eps2) {
    extern __shared__ float4 planes[];
    float4* tp = planes;          // [x, y, z, m] of row s at s and b + s
    float4* ta = planes + 2 * b;  // [Ax, Ay, Az, 0] likewise
    const int t = threadIdx.x;
    const long long row = static_cast<long long>(blockIdx.x) * b + t;
    const float4 me = pm[row];
    const float4 a4 = abar[row];
    stage(tp, ta, t, b, me, a4);
    __syncthreads();
    const float3 ak = make_float3(a4.x, a4.y, a4.z);
    const float4* fp = tp + t;
    const float4* fa = ta + t;
    float s[kSums] = {};
#pragma unroll 8
    for (int r = 1; r < b; ++r) {
        const float4 a = fa[r];
        const VjpPair e = vjp_pair<kNormal>(me, ak, fp[r], make_float3(a.x, a.y, a.z), eps2);
        s[0] += e.tx;
        s[1] += e.ty;
        s[2] += e.tz;
        s[3] += e.mbar_t;
        s[4] += e.phi_t;
    }
    store(acc, row, s);
}

// One unordered pair: the target's terms into `own`, the source's into `rev`.
template <bool kNormal>
__device__ __forceinline__ void both_rows(float4 me, float3 ak, float4 p, float4 a, float eps2,
                                          float (&own)[kSums], float (&rev)[kSums]) {
    const VjpPair e = vjp_pair<kNormal>(me, ak, p, make_float3(a.x, a.y, a.z), eps2);
    own[0] += e.tx;
    own[1] += e.ty;
    own[2] += e.tz;
    own[3] += e.mbar_t;
    own[4] += e.phi_t;
    rev[0] -= e.tx;
    rev[1] -= e.ty;
    rev[2] -= e.tz;
    rev[3] += e.mbar_s;
    rev[4] += e.phi_s;
}

// Step r of the Newton-3 loop on lane `lane`: the pair (t, t + r), then
// lane 0 hands its reverse sums (row t0 + r's, final now) to its warp's slab
// `ws` and the sums move down a lane; lane 31 starts row t0 + 32 + r.
template <bool kNormal>
__device__ __forceinline__ void hand_over_step(int r, int lane, float4 me, float3 ak, const float4* fp,
                                               const float4* fa, float eps2, float (&own)[kSums],
                                               float (&rev)[kSums], float (&ws)[kSums][kSpan]) {
    both_rows<kNormal>(me, ak, fp[r], fa[r], eps2, own, rev);
    if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kSums; ++c) ws[c][r - 1] = rev[c];
    }
#pragma unroll
    for (int c = 0; c < kSums; ++c) {
        const float v = __shfl_down_sync(0xffffffffu, rev[c], 1);
        rev[c] = lane == 31 ? 0.f : v;
    }
}

// The Newton-3 loop, b = kTile.
template <bool kNormal>
__global__ void __launch_bounds__(kTile)
vjp_sym_diag_n3_kernel(const float4* __restrict__ pm, const float4* __restrict__ abar,
                       float4* __restrict__ acc, float eps2) {
    __shared__ float4 tp[2 * kTile];
    __shared__ float4 ta[2 * kTile];
    __shared__ float slab[kWarps][kSums][kSpan];
    const int t = threadIdx.x, lane = t & 31, w = t >> 5;
    const long long row = static_cast<long long>(blockIdx.x) * kTile + t;
    const float4 me = pm[row];
    const float4 a4 = abar[row];
    stage(tp, ta, t, kTile, me, a4);
    float (&ws)[kSums][kSpan] = slab[w];
    for (int j = lane; j < kSums * kSpan; j += 32) (&ws[0][0])[j] = 0.f;
    __syncthreads();
    const float3 ak = make_float3(a4.x, a4.y, a4.z);
    const float4* fp = tp + t;
    const float4* fa = ta + t;
    float own[kSums] = {}, rev[kSums] = {};
    // Steps 1..126 hand over in every warp: a trip count known at compile
    // time (a runtime one left the unrolled loop's remainder, shuffles and
    // all, to a second loop ~1.8x the instructions a pair).
#pragma unroll (kN3Unroll)
    for (int r = 1; r <= kTile / 2 - 2; ++r) hand_over_step<kNormal>(r, lane, me, ak, fp, fa, eps2, own, rev, ws);
    // Step 127 is the last of the second half's warps; the first half's
    // hands over once more and ends at 128 (warp-uniform).
    int last = kTile / 2 - 1;
    if ((t & ~31) < kTile / 2) hand_over_step<kNormal>(last++, lane, me, ak, fp, fa, eps2, own, rev, ws);
    both_rows<kNormal>(me, ak, fp[last], fa[last], eps2, own, rev);
#pragma unroll
    for (int c = 0; c < kSums; ++c) ws[c][lane + last - 1] = rev[c];
    __syncthreads();
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
        const int o = (t - 32 * v - 1) & (kTile - 1);  // row t in warp v's slab
        if (o < kSpan) {
#pragma unroll
            for (int c = 0; c < kSums; ++c) own[c] += slab[v][c][o];
        }
    }
    store(acc, row, own);
}

cudaError_t launch(int nt, int b, bool normal, cudaStream_t s, const float4* pm, const float4* abar, float4* acc,
                   float eps2) {
    if (NB_VJP_DIAG_N3 && b == kTile) {
        const auto kernel = normal ? vjp_sym_diag_n3_kernel<true> : vjp_sym_diag_n3_kernel<false>;
        kernel<<<nt, kTile, 0, s>>>(pm, abar, acc, eps2);
        return cudaSuccess;
    }
    const auto kernel = normal ? vjp_sym_diag_kernel<true> : vjp_sym_diag_kernel<false>;
    const size_t smem = 4 * static_cast<size_t>(b) * sizeof(float4);  // two planes, each doubled
    const cudaError_t e = sym_pairs::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<nt, b, smem, s>>>(pm, abar, acc, b, eps2);
    return cudaSuccess;
}

}  // namespace

extern "C" int nb_vjp_sym_diag(const void* pm, const void* abar, void* acc_diag, int nt, int b,
                               float eps2, void* stream) {
    if (nt > 0) {
        const cudaError_t e = launch(nt, b, eps2 >= FLT_MIN, static_cast<cudaStream_t>(stream),
                                     static_cast<const float4*>(pm), static_cast<const float4*>(abar),
                                     static_cast<float4*>(acc_diag), eps2);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return static_cast<int>(cudaGetLastError());
}
