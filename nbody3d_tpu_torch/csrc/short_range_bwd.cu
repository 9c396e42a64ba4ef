// short_range_bwd: the VJP of short_range (P3M's block-sparse short-range
// pass), isolated or periodic boundary.
//
// Replaces: nbody3d_tpu/ops/p3m.py::_short_range_bwd_kernel (reached by
// _short_range_tiles_bwd_pallas from _make_sr_pallas_diff's full-range
// backward), the backward of every P3M step that needs a gradient, in both
// of its forms (periodic=False and True).
//
// What it computes: for the cotangent g of short_range's output, with
// target row i of tile t and source rows j of the k neighbour tiles
// nbr[t][s] whose mutual mask mask[t][s] is not 0, d = x_j - x_i (on the
// periodic box its minimum image, the forward's), the pair scalar k =
// k_short(|d|^2), k' = dk/d|d|^2 and k_s = dk/dsigma (all three 0 outside
// 0 < |d|^2 < rcut^2),
//
//   dps[i].xyz = sum mask * [2 k' (m_i (d.g_j) - m_j (d.g_i)) d + k (m_i g_j - m_j g_i)]
//   dps[i].w   = sum mask * (-k (d.g_j))                        (the mass cotangent)
//   dsig[i]    = sum mask * m_j (d.g_i) k_s                     (summed outside)
//
// with scal = [rcut^2, a = 1/(sqrt2 sigma), c2 = (2/sqrt(pi)) a, a^2 = 1/(2 sigma^2),
// 1/sigma]
// in device memory (sigma is a per-step device value on the isolated box)
// and the box L, a static config value, as a host float (0: isolated).
//
// Isolated: the formulas are the isolated branch of the Pallas kernel
// (p3m.py:899-903, 954-969), with its Abramowitz-Stegun 7.1.26 erfc; k' is
// the same sum with its two equal -c2 e / (2 r s^3) terms added.
//
// Periodic: k is the forward's (periodic.cuh, 1/s^3 - k_long with k_long
// by its series below u = 0.5), but k' and k_s are NOT the Pallas
// kernel's (p3m.py:938-953).
// There k' is a sum of terms of size c2/r^4 that cancel down to about a^5,
// and its A-S erfc errs by 1.5e-7 times 1/r^5: at pairs far closer than
// sigma it is wrong by more than its size, and at a pair 3e-4 apart the
// Pallas backward's row is 8e-3 off f64 (sigma = 0.094, eps2 = 1e-4;
// tests/test_torch_periodic_grad.py prints it).  Here,
// with u = r a and u^2 = r^2 a^2,
//
//   k' = -1.5/s^5 - k_long',
//   u < 0.2:  k_long' = (2/sqrt(pi)) a^5 (-2/5 + u^2 (2/7 + u^2 (-1/9 + u^2/33)))
//             (its series; the truncation is below 2e-8 of k_long'),
//   u >= 0.2: k' = 1.5 (1/r^5 - 1/s^5) - 1.5 erfc(u)/r^5 - 1.5 c2 e/r^4 - c2 a^2 e/r^2
//             with 1/r^5 - 1/s^5 = eps2 (1/(r s)) / (r + s) * sum_{p+q=4} r^-p s^-q,
//             a sum of positive terms (no cancellation), and erfcf(u),
//   k_s = 2 c2 a^2 e / sigma
//
// (k_s is the Pallas kernel's sum with its two 1/r^2 terms cancelled by
// hand), and e = exp(-r^2 a^2) from r^2 itself and a^2 = 0.5/sigma^2 as
// scal[3] (u * u or a * a round u^2 more often, and e's relative error
// is u^2 times u^2's, about 10 near rcut).  The twin (the same formulas) against f64 at sigma = 0.117,
// eps2 = 1e-4, for r from 1e-5 to rcut = 4.5 sigma: k_s within 6.4e-7
// relative; k' within 6.3e-7 relative up to r = 0.3, and within 8.2e-7 of
// the larger of |k'| and half its two parts up to rcut, where k' nears its
// zero and the parts cancel (1.9e-6 relative there): f32 cannot do better
// than round each part (tests/test_torch_periodic_grad.py).
//
// A row's cotangent gathers over the row's OWN neighbour list only: the
// mutual mask makes the pair set symmetric (a pair (i, j) listed in i's
// tile is listed in j's), so every term in which row i acts as a source
// appears on its own list, and the kernel never scatters.  A slot with mask
// 0 is skipped; a slot whose source tile has no mass is NOT (its m_i g_j and
// mass terms are not 0).  Each slot is summed in registers before mask *
// partial joins the row's total, the order of sums of the Pallas kernel.
// Deterministic, no atomics.
//
// What bounds it on an H100: operations.  Isolated, per pair within rcut
// about 100 FP32 FLOP (an FMA counts 2, expf's range reduction and the
// reciprocal's Newton step included, as short_range.cu's 47 count them) and
// four MUFU results, as in the forward: two rsqrt, the ex2 of expf and the
// rcp of 1/(1 + p u).  FP32 binds: 100 / 256 FLOP a clock and SM against
// 4 / 16 MUFU results.  Periodic, per pair within rcut about 180 FP32 FLOP:
// the minimum image (6), the separation and r^2 (8), k (10), erff's
// polynomial (about 20; k_long's series of 17 in its place below u = 0.5),
// erfcf's (about 40), the series (11), the positive sum of 1/r^5 - 1/s^5
// and its division (about 20), the rest of k' (12), k_s (2) and the five
// sums (41); and six MUFU results: two rsqrt, the ex2 of expf, the rcp of
// 1/(r + s), erfcf's ex2 and rcp (erff's ex2 for u > 1 is not counted, so
// the bound is a least time).  FP32 binds: 180 / 256 against 6 / 16.  A
// pair whose warp votes dead costs its distance test alone: the separation
// (and minimum image), r^2, the predicate and the vote (12 FLOP isolated,
// 18 periodic).  The share of live-slot pairs within rcut depends on the
// data (PERF.md section 6, where chip_smoke.py counts them).
//
// What the first design lost: one thread held one target row and ran the
// whole pair arithmetic on every pair of every live slot, in or out of
// rcut, with both branches of the periodic k' evaluated and one selected.
//
// Design: short_range.cu's.  One CUDA block per target tile; a thread
// holds kRows target rows t, t + T, ... (T threads), so a warp's lanes hold
// 32 consecutive rows of each row slot.  Each live slot's source positions
// and cotangents are staged in shared memory as two float4 a row; one pair
// of broadcast reads serves kRows pairs.  For each source and row slot the
// warp computes the separation and r^2 exactly as the first design did and
// votes on the kernel's own predicate (row in the tile, 0 < r^2 < rcut^2):
// the pair arithmetic runs only when some lane of that slot is live, and
// dead lanes take k = k' = k_s = 0 as before.  A pair past rcut added
// products with a zero factor to each of the five sums, so skipping it
// changes no bit (short_range.cu says why a sum that starts at +0 stays
// put), and with the roundings written out (below) the result is the first
// design's row for row.  An isolated slot that the wrapper flags dense
// (ops/p3m.py _dense_slots: every pair within rcut) sweeps without the
// votes.  The periodic k' is a branch at u = 0.2, as k_long is at 0.5
// (periodic.cuh): the same value, and a warp whose lanes all lie on one
// side skips the other's work.  The slot's id, mask and flag are
// block-uniform, so the skip of a mask-0 slot is a uniform branch and the
// barriers stay matched.  The TPU kernel ran a
// sequential (tile, slot) grid with scratch accumulators; here the slot
// loop runs inside the block and the five sums stay in registers.  The two
// boundaries are one source loop, instanced by a template flag, so the
// isolated instance carries no periodic code.
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
constexpr float kSqrt2 = 1.4142135623730951f;

// Threads for a tile of b target rows: kRows rows each, whole warps.
constexpr int threads_for(int b) { return sym_pairs::threads_for(b, kRows); }

// The pair arithmetic below has every rounding written out: each product and
// sum is an explicit __fmul_rn, __fadd_rn, __fdiv_rn or fmaf, in the order
// and with the contractions that nvcc and ptxas gave the first design (one
// row a thread, every pair evaluated).  Left to the compiler, ptxas fuses a
// product into a neighbouring difference on one side or the other
// depending on the loop around it, which moves the bits of rows whose sums
// cancel (PERF.md section 6).

// The isolated pair's k, k' = dk/dr^2 and k_s = dk/dsigma (see above) from
// r2s = r^2 > 0, inv_r, inv_s, u = r a, the hoisted c2 = (2/sqrt(pi)) a,
// a2 = a * a, c2s = sqrt2 c2 and c2is = c2 / sigma.
__device__ __forceinline__ void isolated_grads(float inv_r, float inv_s, float u, float c2, float a2, float c2s,
                                               float c2is, float& ks, float& kp, float& kg) {
    const float e = expf(-__fmul_rn(u, u));
    const float tt = 1.f / fmaf(u, kAsP, 1.f);
    const float poly = fmaf(tt, fmaf(tt, fmaf(tt, fmaf(tt, kAsA5, kAsA4), kAsA3), kAsA2), kAsA1);
    const float erfc_u = __fmul_rn(e, __fmul_rn(tt, poly));
    const float inv_s2 = __fmul_rn(inv_s, inv_s);
    const float inv_s3 = __fmul_rn(inv_s, inv_s2);
    const float sr = __fmul_rn(inv_r, inv_s);
    const float ce = __fmul_rn(c2, e);
    ks = fmaf(sr, ce, __fmul_rn(inv_s3, erfc_u));
    const float tail = fmaf(inv_r, inv_s3, __fmul_rn(sr, fmaf(inv_r, __fmul_rn(inv_r, 0.5f), a2)));
    kp = fmaf(__fmul_rn(erfc_u, -1.5f), __fmul_rn(inv_s2, inv_s3), -__fmul_rn(ce, tail));
    kg = __fmul_rn(e, fmaf(inv_s3, __fmul_rn(c2s, u), __fmul_rn(sr, __fmul_rn(c2is, fmaf(u, __fadd_rn(u, u), -1.f)))));
}

// The periodic pair's k (periodic.cuh's k_short_periodic, the forward's),
// k' and k_s (see above) from r2s = r^2 > 0, inv_r, r, inv_s, u = r a,
// u2 = r^2 a2 and the hoisted a2 = scal[3], c2a2 = c2 a2, c2a4 = c2 a2^2,
// c2a2x2 = 2 c2 a2, eps2 and 1/sigma.  k' is a branch at u = 0.2, as k_long is at 0.5.
__device__ __forceinline__ void periodic_grads(float r2s, float inv_r, float r, float inv_s, float u, float u2,
                                               float c2, float a2, float c2a2, float c2a4, float c2a2x2, float eps2,
                                               float inv_sigma, float& ks, float& kp, float& kg) {
    const float e = expf(-u2);
    const float inv_r2 = __fmul_rn(inv_r, inv_r);
    const float inv_r3 = __fmul_rn(inv_r, inv_r2);
    const float c2e_r2 = __fmul_rn(inv_r2, __fmul_rn(c2, e));  // as k_long_periodic rounds it
    const float inv_s2 = __fmul_rn(inv_s, inv_s);
    ks = k_short_periodic(inv_r, inv_s, u, e, c2, c2a2, u2);
    if (u2 < 0.04f) {
        const float series =
            __fmul_rn(c2a4, fmaf(u2, fmaf(u2, fmaf(u2, 1.f / 33.f, -1.f / 9.f), 2.f / 7.f), -0.4f));
        kp = fmaf(__fmul_rn(inv_s, __fmul_rn(inv_s2, inv_s2)), -1.5f, -series);
    } else {
        const float s2 = __fadd_rn(r2s, eps2);
        const float powers = fmaf(inv_s, fmaf(inv_s, fmaf(inv_s, __fadd_rn(inv_r, inv_s), inv_r2), inv_r3),
                                  __fmul_rn(inv_r2, inv_r2));
        const float d5 = __fmul_rn(powers, __fdiv_rn(__fmul_rn(__fmul_rn(inv_r, eps2), inv_s), fmaf(inv_s, s2, r)));
        const float far = __fmul_rn(__fmul_rn(inv_r, __fmul_rn(inv_r2, inv_r2)), __fmul_rn(erfcf(u), 1.5f));
        kp = fmaf(d5, 1.5f, -fmaf(fmaf(inv_r2, 1.5f, a2), c2e_r2, far));
    }
    kg = __fmul_rn(inv_sigma, __fmul_rn(c2a2x2, e));
}

template <bool PERIODIC>
__global__ void __launch_bounds__(threads_for(1024))
short_range_bwd_kernel(const float4* __restrict__ ps, const float4* __restrict__ g, const int* __restrict__ nbr,
                       const float* __restrict__ mask, const unsigned char* __restrict__ dense_slot,
                       const float* __restrict__ scal, float4* __restrict__ dps, float* __restrict__ dsig, int k,
                       int b, float eps2, float box) {
    extern __shared__ float4 smem[];
    float4* tile = smem;       // source rows (x, y, z, m)
    float4* gtile = smem + b;  // their cotangents (w not read)
    const int t = blockIdx.x;
    const int nthr = blockDim.x;
    const long long base = static_cast<long long>(t) * b;
    const float rcut2 = scal[0];
    const float a = scal[1];
    const float c2 = scal[2];
    const float inv_sigma = scal[4];
    const float a2 = __fmul_rn(a, a);        // 1 / (2 sigma^2)
    const float a2p = scal[3];               // 1 / (2 sigma^2), rounded once less
    const float c2s = __fmul_rn(c2, kSqrt2);  // (2/sqrt(pi)) / sigma
    const float c2is = __fmul_rn(c2, inv_sigma);
    const float c2a2 = __fmul_rn(c2, a2p);
    const float c2a4 = __fmul_rn(c2, __fmul_rn(a2p, a2p));
    const float c2a2x2 = __fmul_rn(__fadd_rn(c2, c2), a2p);
    const float half = 0.5f * box;
    float4 me[kRows];
    float4 gi[kRows];
    bool in_tile[kRows];
    float ax[kRows], ay[kRows], az[kRows], am[kRows], asg[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int row = threadIdx.x + r * nthr;
        in_tile[r] = row < b;
        me[r] = in_tile[r] ? ps[base + row] : make_float4(0.f, 0.f, 0.f, 0.f);
        gi[r] = in_tile[r] ? g[base + row] : make_float4(0.f, 0.f, 0.f, 0.f);
        ax[r] = ay[r] = az[r] = am[r] = asg[r] = 0.f;
    }
    for (int s = 0; s < k; ++s) {
        const float msk = mask[t * k + s];
        if (msk == 0.f) continue;  // block-uniform
        const long long src = static_cast<long long>(nbr[t * k + s]) * b;
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
            const int row = threadIdx.x + u * nthr;
            if (row < b) {
                tile[row] = ps[src + row];
                gtile[row] = g[src + row];
            }
        }
        __syncthreads();
        // Dense (block-uniform): every pair but a coincident one is live, so
        // the sweep skips the votes.
        const bool dense = !PERIODIC && dense_slot[t * k + s];
        float px[kRows], py[kRows], pz[kRows], pm[kRows], psg[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) px[r] = py[r] = pz[r] = pm[r] = psg[r] = 0.f;
        // The sweep over the slot's sources, with or without the votes.
        const auto sweep = [&](auto vote) {
#pragma unroll 2
            for (int q = 0; q < b; ++q) {
                const float4 p = tile[q];
                const float4 gj = gtile[q];
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
                    const float r2 = fmaf(dx, dx, fmaf(dy, dy, __fmul_rn(dz, dz)));
                    const bool pos = r2 > 0.f;
                    const bool gate = in_tile[r] && pos && r2 < rcut2;
                    // Every lane's k, k' and k_s are 0 for this row slot and source.
                    if (decltype(vote)::value && !__any_sync(kAll, gate)) continue;
                    const float r2s = pos ? r2 : 1.f;
                    const float inv_r = rsqrtf(r2s);
                    const float r1 = __fmul_rn(r2s, inv_r);
                    const float s2 = __fadd_rn(r2s, eps2);
                    const float inv_s = rsqrtf(s2);
                    const float u = __fmul_rn(a, r1);
                    float ks, kp, kg;
                    if (PERIODIC)
                        periodic_grads(r2s, inv_r, r1, inv_s, u, __fmul_rn(r2s, a2p), c2, a2p, c2a2, c2a4, c2a2x2,
                                       eps2, inv_sigma, ks, kp, kg);
                    else
                        isolated_grads(inv_r, inv_s, u, c2, a2, c2s, c2is, ks, kp, kg);
                    const float k0 = gate ? ks : 0.f;
                    const float k1x2 = gate ? __fadd_rn(kp, kp) : 0.f;
                    const float k2 = gate ? kg : 0.f;
                    const float4 gr = gi[r];
                    const float dgi = fmaf(dz, gr.z, fmaf(dx, gr.x, __fmul_rn(dy, gr.y)));
                    const float dgj = fmaf(dz, gj.z, fmaf(dx, gj.x, __fmul_rn(dy, gj.y)));
                    const float pdgi = __fmul_rn(p.w, dgi);
                    const float coef = __fmul_rn(k1x2, fmaf(me[r].w, dgj, -pdgi));
                    px[r] = __fadd_rn(px[r], fmaf(k0, fmaf(me[r].w, gj.x, -__fmul_rn(gr.x, p.w)), __fmul_rn(coef, dx)));
                    py[r] = __fadd_rn(py[r], fmaf(k0, fmaf(me[r].w, gj.y, -__fmul_rn(gr.y, p.w)), __fmul_rn(coef, dy)));
                    pz[r] = __fadd_rn(pz[r], fmaf(k0, fmaf(me[r].w, gj.z, -__fmul_rn(gr.z, p.w)), __fmul_rn(coef, dz)));
                    pm[r] = fmaf(k0, -dgj, pm[r]);
                    psg[r] = fmaf(k2, pdgi, psg[r]);
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
            am[r] = fmaf(msk, pm[r], am[r]);
            asg[r] = fmaf(msk, psg[r], asg[r]);
        }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (!in_tile[r]) continue;
        const long long row = base + threadIdx.x + r * nthr;
        dps[row] = make_float4(ax[r], ay[r], az[r], am[r]);
        dsig[row] = asg[r];
    }
}

}  // namespace

// ps, g (nt*b, 4) (g's w lane not read), nbr and mask (nt, k), dense (nt, k)
// u8 (isolated only: 1 where every pair of the slot lies within rcut;
// unread, may be null, when periodic), scal f32[5], dps (nt*b, 4), dsig
// (nt*b,); b <= 1024; box = 0 isolated, box = L > 0 periodic (positions in
// [0, L)).
extern "C" int nb_short_range_bwd(const void* ps, const void* g, const void* nbr, const void* mask, const void* dense,
                                  const void* scal, void* dps, void* dsig, int nt, int k, int b, float eps2, float box,
                                  void* stream) {
    if (nt > 0) {
        const auto* p = static_cast<const float4*>(ps);
        const auto* gg = static_cast<const float4*>(g);
        const auto* ids = static_cast<const int*>(nbr);
        const auto* msk = static_cast<const float*>(mask);
        const auto* dns = static_cast<const unsigned char*>(dense);
        const auto* sc = static_cast<const float*>(scal);
        auto* dp = static_cast<float4*>(dps);
        auto* ds = static_cast<float*>(dsig);
        const cudaStream_t st = static_cast<cudaStream_t>(stream);
        const int threads = threads_for(b);
        const size_t smem = 2 * b * sizeof(float4);
        if (box > 0.f)
            short_range_bwd_kernel<true><<<nt, threads, smem, st>>>(p, gg, ids, msk, dns, sc, dp, ds, k, b, eps2, box);
        else
            short_range_bwd_kernel<false><<<nt, threads, smem, st>>>(p, gg, ids, msk, dns, sc, dp, ds, k, b, eps2, box);
    }
    return static_cast<int>(cudaGetLastError());
}
