// short_range: P3M's block-sparse short-range correction, isolated or
// periodic boundary.
//
// Replaces: nbody3d_tpu/ops/p3m.py::_short_range_kernel (reached by
// _short_range_tiles_pallas through short_range_tiles), the pair pass of
// every P3M step, in both of its forms (periodic=False and True).
//
// What it computes: for target row i of tile t, over the k neighbour tiles
// j = nbr[t][s] whose mutual mask mask[t][s] is not 0,
//
//   out[i] = sum_s mask[t][s] * sum_{r in tile j} w(r) * d,
//   w = k_short(|d|^2) * m_r  where 0 < |d|^2 < rcut^2, else 0,
//   u = r a,  s^2 = r^2 + eps2,
//   isolated (box = 0):  d = x_r - x_i,
//     k_short = erfc(u) / s^3 + c2 e^{-u^2} / (s r)
//   periodic (box = L > 0): d = the minimum image of x_r - x_i, one
//     conditional shift by L an axis (positions are wrapped, so |d| < L),
//     k_short = 1/s^3 - k_long,  k_long = erf(u) / r^3 - c2 e^{-u^2} / r^2
//     (ops/ewald.py::k_short_periodic), k_long by its series below u = 0.5
//     (periodic.cuh),
//
// with scal = [rcut^2, a = 1/(sqrt2 sigma), c2 = (2/sqrt(pi)) a, a^2, ...]
// read from device memory (sigma is a per-step device value on the isolated
// box: passing it as a host float would sync the host every step) and the
// box L, a static config value, as a host float.  The isolated pair
// arithmetic is the Pallas kernel's (p3m.py:736-761): two rsqrt, one exp
// feeding the Abramowitz-Stegun 7.1.26 erfc (|abs err| <= 1.5e-7), the
// same constants.  The periodic form takes the Pallas kernel's minimum
// image (p3m.py:730-735) but not its erfc: there erfc(u) multiplies 1/r^3,
// unbounded as r -> 0, and the A-S error of 1.5e-7 times 1/r^3 swamps k at
// pairs much closer than the softening (at r = 1e-4, eps2 = 1e-4, sigma =
// 0.117: a quarter of k), which 2M bodies in a box of 10 have.  CUDA's
// erff is accurate to 2 ulp, so 1/s^3 - erf(u)/r^3 + c2 e/r^2 keeps the
// f32 error of the terms' cancellation alone (the plain twin's, 4e-6 of k
// there).  That cancellation of erf(u)/r^3 against c2 e/r^2 left an f32
// error of order 1/(sigma r^2) at r << sigma, so below u = 0.5 k_long is
// its series (periodic.cuh): k keeps a few ulp of 1/s^3 + k_long at any r.
// Where r^2 >> eps2, 1/s^3 - k_long cancels too: a few ulp of 1/r^3, where
// k itself is small.  A slot with
// mask 0 is skipped, which is exact (the Pallas kernel multiplies that
// slot's reduced partial by 0); each slot is summed in registers before
// mask * partial joins the row's total, the order of sums of the Pallas
// kernel.  Deterministic; w lane of out is 0.
//
// What bounds it on an H100: operations.  Per pair within rcut, isolated:
// about 35 FP32 issue slots, two MUFU rsqrt, one MUFU ex2 (in expf) and the
// reciprocal of 1/(1 + p u) (a MUFU rcp and its Newton step without
// --use_fast_math); periodic: the minimum image and erff's polynomial in
// place of the A-S erfc, about 45 FP32 slots and three MUFU (erff may add
// an ex2 where u > 1); below u = 0.5 k_long's 9-term series replaces erff
// (periodic.cuh), on a small share of the pairs.  A pair whose warp votes
// dead costs its distance test alone: the separation (and minimum image),
// r^2, the predicate and the vote.  The share of live-slot pairs within
// rcut depends on the data: about 0.16 at p3m_bench's periodic 2M box, 0.3
// at its 2M uniform sphere, 0.96 at the two-galaxy 2M run (PERF.md section
// 6, where chip_smoke.py counts them).
//
// What the first design lost: one thread held one target row and ran the
// whole pair arithmetic on every pair of every live slot, then set w = 0
// for the pairs past rcut, so a pair issued ~115 instructions (periodic)
// and ~72 (isolated) wherever it lay.
//
// Design: one CUDA block per target tile; a thread holds kRows target rows
// t, t + T, ... (T threads), so a warp's lanes hold 32 consecutive
// (Morton-adjacent) rows of each row slot.  The source tile of each live
// slot is staged in shared memory as float4 (x, y, z, m); one broadcast
// read serves kRows pairs.  For each source and row slot the warp computes
// the separation and r^2 exactly as the plain form does and votes on the
// kernel's own predicate (row in the tile, 0 < r^2 < rcut^2): the pair
// arithmetic runs only when some lane of that slot is live, and dead lanes
// then take w = 0 as before.  A pair past rcut had w == 0 exactly and added
// fmaf(0, d, p) = p (p starts at +0, and a sum that is exactly 0 rounds
// to +0, so p is -0 only if a live term underflows to -0), so skipping it
// changes no bit: the result is the first design's row for row.  Rows past
// b vote false.  A slot whose two tile boxes lie within rcut of each other
// (isolated only; the wrapper flags such slots from the tiles' boxes,
// ops/p3m.py _dense_slots) is dense: every pair but a coincident one is
// live, so its sweep skips the votes, which would only add instructions;
// the flag picks one of two loops that compute the same w.  The source
// loop is unrolled by 4, so one
// source's loads and distance tests overlap another's arithmetic.  The
// slot's id and mask are block-uniform, so the skip of a mask-0 slot is a
// uniform branch and the barriers stay matched.  The TPU kernel ran a
// sequential (tile, slot) grid with a scratch accumulator; here the slot
// loop runs inside the block and the sum stays in registers.  The two
// boundaries are one source loop, instanced by a template flag, so the
// isolated instance carries no minimum-image code.  The minimum image and
// the periodic k live in periodic.cuh, which short_range_bwd.cu includes
// too.
//
// The constants were chosen on an H100 (PERF.md section 6): 2 rows a
// thread against 1 and 4 (4 spill in the periodic form), no prefetch of the
// next slot's rows, the unroll by 4.
#include <type_traits>

#include <cuda_runtime.h>

#include "periodic.cuh"
#include "sym_pairs.cuh"

namespace {

using sym_pairs::kAll;

constexpr int kRows = 2;  // target rows a thread

constexpr float kAsP = 0.3275911f;
constexpr float kAsA1 = 0.254829592f;
constexpr float kAsA2 = -0.284496736f;
constexpr float kAsA3 = 1.421413741f;
constexpr float kAsA4 = -1.453152027f;
constexpr float kAsA5 = 1.061405429f;

// Threads for a tile of b target rows: kRows rows each, whole warps.
constexpr int threads_for(int b) { return sym_pairs::threads_for(b, kRows); }

template <bool PERIODIC>
__global__ void __launch_bounds__(threads_for(1024))
short_range_kernel(const float4* __restrict__ ps, const int* __restrict__ nbr, const float* __restrict__ mask,
                   const unsigned char* __restrict__ dense_slot, const float* __restrict__ scal,
                   float4* __restrict__ out, int k, int b, float eps2, float box) {
    extern __shared__ float4 tile[];
    const int t = blockIdx.x;
    const int nthr = blockDim.x;
    const long long base = static_cast<long long>(t) * b;
    const float rcut2 = scal[0];
    const float a = scal[1];
    const float c2 = scal[2];
    const float a2 = scal[3];
    const float c2a2 = __fmul_rn(c2, a2);
    const float half = 0.5f * box;
    float4 me[kRows];
    bool in_tile[kRows];
    float ax[kRows], ay[kRows], az[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int row = threadIdx.x + r * nthr;
        in_tile[r] = row < b;
        me[r] = in_tile[r] ? ps[base + row] : make_float4(0.f, 0.f, 0.f, 0.f);
        ax[r] = ay[r] = az[r] = 0.f;
    }
    for (int s = 0; s < k; ++s) {
        const float msk = mask[t * k + s];
        if (msk == 0.f) continue;  // block-uniform
        const long long src = static_cast<long long>(nbr[t * k + s]) * b;
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
            const int row = threadIdx.x + u * nthr;
            if (row < b) tile[row] = ps[src + row];
        }
        __syncthreads();
        // Dense (block-uniform): every pair but a coincident one is live, so
        // the sweep skips the votes.
        const bool dense = !PERIODIC && dense_slot[t * k + s];
        float px[kRows], py[kRows], pz[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) px[r] = py[r] = pz[r] = 0.f;
        // The sweep over the slot's sources, with or without the votes.
        const auto sweep = [&](auto vote) {
#pragma unroll 4
            for (int q = 0; q < b; ++q) {
                const float4 p = tile[q];
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    float dx = p.x - me[r].x;
                    float dy = p.y - me[r].y;
                    float dz = p.z - me[r].z;
                    if (PERIODIC) {
                        dx = min_image(dx, box, half);
                        dy = min_image(dy, box, half);
                        dz = min_image(dz, box, half);
                    }
                    const float r2 = dx * dx + (dy * dy + dz * dz);
                    const bool pos = r2 > 0.f;
                    const bool live = in_tile[r] && pos && r2 < rcut2;
                    // Every lane's w is 0 for this row slot and source.
                    if (decltype(vote)::value && !__any_sync(kAll, live)) continue;
                    const float r2s = pos ? r2 : 1.f;
                    const float inv_r = rsqrtf(r2s);
                    const float r1 = r2s * inv_r;
                    const float inv_s = rsqrtf(r2s + eps2);
                    const float u = r1 * a;
                    const float e = expf(-(u * u));
                    float ks;
                    if (PERIODIC) {
                        ks = k_short_periodic(inv_r, inv_s, u, e, c2, c2a2, r2s * a2);
                    } else {
                        const float tt = 1.f / (1.f + kAsP * u);
                        const float erfc_u =
                            tt * (kAsA1 + tt * (kAsA2 + tt * (kAsA3 + tt * (kAsA4 + tt * kAsA5)))) * e;
                        ks = erfc_u * (inv_s * inv_s * inv_s) + (c2 * e) * (inv_s * inv_r);
                    }
                    const float w = live ? ks * p.w : 0.f;
                    px[r] = fmaf(w, dx, px[r]);
                    py[r] = fmaf(w, dy, py[r]);
                    pz[r] = fmaf(w, dz, pz[r]);
                }
            }
        };
        if (dense)
            sweep(std::false_type{});
        else
            sweep(std::true_type{});
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            ax[r] = fmaf(msk, px[r], ax[r]);
            ay[r] = fmaf(msk, py[r], ay[r]);
            az[r] = fmaf(msk, pz[r], az[r]);
        }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
        if (in_tile[r]) out[base + threadIdx.x + r * nthr] = make_float4(ax[r], ay[r], az[r], 0.f);
}

}  // namespace

// ps (nt*b, 4), nbr and mask (nt, k), dense (nt, k) u8 (isolated only: 1
// where every pair of the slot lies within rcut; unread, may be null, when
// periodic), scal f32[5] (four read), out (nt*b, 4); b <= 1024; box = 0
// isolated, box = L > 0 periodic (positions in [0, L)).
extern "C" int nb_short_range(const void* ps, const void* nbr, const void* mask, const void* dense,
                              const void* scal, void* out, int nt, int k, int b, float eps2, float box,
                              void* stream) {
    if (nt > 0) {
        const auto* p = static_cast<const float4*>(ps);
        const auto* ids = static_cast<const int*>(nbr);
        const auto* msk = static_cast<const float*>(mask);
        const auto* dns = static_cast<const unsigned char*>(dense);
        const auto* sc = static_cast<const float*>(scal);
        auto* o = static_cast<float4*>(out);
        const cudaStream_t st = static_cast<cudaStream_t>(stream);
        const int threads = threads_for(b);
        const size_t smem = b * sizeof(float4);
        if (box > 0.f) {
            short_range_kernel<true><<<nt, threads, smem, st>>>(p, ids, msk, dns, sc, o, k, b, eps2, box);
        } else {
            short_range_kernel<false><<<nt, threads, smem, st>>>(p, ids, msk, dns, sc, o, k, b, eps2, box);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
