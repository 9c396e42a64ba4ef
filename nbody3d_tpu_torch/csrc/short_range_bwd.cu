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
// What bounds it on an H100: operations.  Isolated, per pair about 100 FP32
// FLOP (an FMA counts 2, expf's range reduction and the reciprocal's Newton
// step included, as short_range.cu's 47 count them) and four MUFU results,
// as in the forward: two rsqrt, the ex2 of expf and the rcp of 1/(1 + p u).
// FP32 binds: 100 / 256 FLOP a clock and SM against 4 / 16 MUFU results.
// Periodic, per pair about 180 FP32 FLOP: the minimum image (6), the
// separation and r^2 (8), k (10), erff's polynomial (about 20; k_long's
// series of 17 in its place below u = 0.5), erfcf's
// (about 40), the series (11), the positive sum of 1/r^5 - 1/s^5 and its
// division (about 20), the rest of k' (12), k_s (2) and the five sums (41);
// and six MUFU results: two rsqrt, the ex2 of expf, the rcp of 1/(r + s),
// erfcf's ex2 and rcp (erff's ex2 for u > 1 is not counted, so the bound
// is a least time).  FP32 binds: 180 / 256 against 6 / 16.
// Every pair of every live slot is evaluated, in or out of rcut, and both
// branches of k' are evaluated and one selected.
//
// Design: the forward's schedule.  One CUDA block per target tile, one
// thread per target row (the tile is at most 1024 rows).  Each live slot's
// source positions and cotangents are staged in shared memory as two float4
// a row and read by the whole block as broadcasts; the slot's id and mask
// are block-uniform, so the skip is a uniform branch and the barriers stay
// matched.  The TPU kernel ran a sequential (tile, slot) grid with scratch
// accumulators; here the slot loop runs inside the block and the five sums
// stay in registers.  The two boundaries are one source loop, instanced by
// a template flag, so the isolated instance carries no periodic code.
#include <cuda_runtime.h>

#include "periodic.cuh"

namespace {

constexpr float kAsP = 0.3275911f;
constexpr float kAsA1 = 0.254829592f;
constexpr float kAsA2 = -0.284496736f;
constexpr float kAsA3 = 1.421413741f;
constexpr float kAsA4 = -1.453152027f;
constexpr float kAsA5 = 1.061405429f;
constexpr float kSqrt2 = 1.4142135623730951f;

// The periodic pair's k, k' = dk/dr^2 and k_s = dk/dsigma (see above) from
// r2s = r^2 > 0, inv_r, r, inv_s, u = r a, a2 = a^2 (scal[3]), c2, eps2 and
// 1/sigma.
__device__ __forceinline__ void periodic_grads(float r2s, float inv_r, float r, float inv_s, float u, float a2,
                                               float c2, float eps2, float inv_sigma, float& ks, float& kp,
                                               float& kg) {
    const float u2 = r2s * a2;
    const float e = expf(-u2);
    ks = k_short_periodic(inv_r, inv_s, u, e, c2, a2, u2);
    const float inv_r2 = inv_r * inv_r;
    const float inv_s2 = inv_s * inv_s;
    const float series = (c2 * (a2 * a2)) * (-0.4f + u2 * (2.f / 7.f + u2 * (-1.f / 9.f + u2 * (1.f / 33.f))));
    const float kp_series = -1.5f * (inv_s2 * inv_s2 * inv_s) - series;
    const float s = (r2s + eps2) * inv_s;
    const float powers = inv_r2 * inv_r2 + inv_s * (inv_r2 * inv_r + inv_s * (inv_r2 + inv_s * (inv_r + inv_s)));
    const float d5 = (eps2 * inv_r * inv_s) / (r + s) * powers;
    const float kp_closed =
        1.5f * d5 - (1.5f * erfcf(u) * (inv_r2 * inv_r2 * inv_r) + (c2 * e) * inv_r2 * (1.5f * inv_r2 + a2));
    kp = u2 < 0.04f ? kp_series : kp_closed;
    kg = 2.f * c2 * a2 * e * inv_sigma;
}

template <bool PERIODIC>
__global__ void short_range_bwd_kernel(const float4* __restrict__ ps, const float4* __restrict__ g,
                                       const int* __restrict__ nbr, const float* __restrict__ mask,
                                       const float* __restrict__ scal, float4* __restrict__ dps,
                                       float* __restrict__ dsig, int k, int b, float eps2, float box) {
    extern __shared__ float4 smem[];
    float4* tile = smem;      // source rows (x, y, z, m)
    float4* gtile = smem + b; // their cotangents (w not read)
    const int t = blockIdx.x;
    const int row = t * b + threadIdx.x;
    const float4 me = ps[row];
    const float4 gi = g[row];
    const float rcut2 = scal[0];
    const float a = scal[1];
    const float c2 = scal[2];
    const float inv_sigma = scal[4];
    const float a2 = a * a;              // 1 / (2 sigma^2)
    const float a2p = scal[3];           // 1 / (2 sigma^2), rounded once less
    const float c2s = kSqrt2 * c2;       // (2/sqrt(pi)) / sigma
    const float half = 0.5f * box;
    float ax = 0.f, ay = 0.f, az = 0.f, am = 0.f, asg = 0.f;
    for (int s = 0; s < k; ++s) {
        const float msk = mask[t * k + s];
        if (msk == 0.f) continue;  // block-uniform
        const int j = nbr[t * k + s];
        __syncthreads();
        tile[threadIdx.x] = ps[j * b + threadIdx.x];
        gtile[threadIdx.x] = g[j * b + threadIdx.x];
        __syncthreads();
        float px = 0.f, py = 0.f, pz = 0.f, pm = 0.f, psg = 0.f;
        for (int q = 0; q < b; ++q) {
            const float4 p = tile[q];
            const float4 gj = gtile[q];
            float dx = p.x - me.x;
            float dy = p.y - me.y;
            float dz = p.z - me.z;
            if (PERIODIC) {
                dx = min_image(dx, box, half);
                dy = min_image(dy, box, half);
                dz = min_image(dz, box, half);
            }
            const float r2 = dx * dx + (dy * dy + dz * dz);
            const bool pos = r2 > 0.f;
            const float r2s = pos ? r2 : 1.f;
            const float inv_r = rsqrtf(r2s);
            const float r = r2s * inv_r;
            const float inv_s = rsqrtf(r2s + eps2);
            const float u = r * a;
            float ks, kp, kg;
            if (PERIODIC) {
                periodic_grads(r2s, inv_r, r, inv_s, u, a2p, c2, eps2, inv_sigma, ks, kp, kg);
            } else {
                const float e = expf(-(u * u));
                const float tt = 1.f / (1.f + kAsP * u);
                const float erfc_u = tt * (kAsA1 + tt * (kAsA2 + tt * (kAsA3 + tt * (kAsA4 + tt * kAsA5)))) * e;
                const float inv_s2 = inv_s * inv_s;
                const float inv_s3 = inv_s2 * inv_s;
                const float sr = inv_s * inv_r;
                const float ce = c2 * e;
                ks = erfc_u * inv_s3 + ce * sr;
                kp = -1.5f * erfc_u * (inv_s3 * inv_s2) - ce * (inv_r * inv_s3 + sr * (a2 + 0.5f * inv_r * inv_r));
                kg = e * (c2s * u * inv_s3 + c2 * inv_sigma * (2.f * u * u - 1.f) * sr);
            }
            const bool gate = pos && r2 < rcut2;
            const float k0 = gate ? ks : 0.f;
            const float k1 = gate ? kp : 0.f;
            const float k2 = gate ? kg : 0.f;
            const float dgi = dx * gi.x + dy * gi.y + dz * gi.z;
            const float dgj = dx * gj.x + dy * gj.y + dz * gj.z;
            const float coef = 2.f * k1 * (me.w * dgj - p.w * dgi);
            px += coef * dx + k0 * (me.w * gj.x - p.w * gi.x);
            py += coef * dy + k0 * (me.w * gj.y - p.w * gi.y);
            pz += coef * dz + k0 * (me.w * gj.z - p.w * gi.z);
            pm -= k0 * dgj;
            psg += p.w * dgi * k2;
        }
        ax = fmaf(msk, px, ax);
        ay = fmaf(msk, py, ay);
        az = fmaf(msk, pz, az);
        am = fmaf(msk, pm, am);
        asg = fmaf(msk, psg, asg);
    }
    dps[row] = make_float4(ax, ay, az, am);
    dsig[row] = asg;
}

}  // namespace

// ps, g (nt*b, 4) (g's w lane not read), nbr and mask (nt, k), scal f32[5],
// dps (nt*b, 4), dsig (nt*b,); b <= 1024; box = 0 isolated, box = L > 0
// periodic (positions in [0, L)).
extern "C" int nb_short_range_bwd(const void* ps, const void* g, const void* nbr, const void* mask,
                                  const void* scal, void* dps, void* dsig, int nt, int k, int b, float eps2,
                                  float box, void* stream) {
    if (nt > 0) {
        const auto* p = static_cast<const float4*>(ps);
        const auto* gg = static_cast<const float4*>(g);
        const auto* ids = static_cast<const int*>(nbr);
        const auto* msk = static_cast<const float*>(mask);
        const auto* sc = static_cast<const float*>(scal);
        auto* dp = static_cast<float4*>(dps);
        auto* ds = static_cast<float*>(dsig);
        const cudaStream_t st = static_cast<cudaStream_t>(stream);
        const size_t smem = 2 * b * sizeof(float4);
        if (box > 0.f) {
            short_range_bwd_kernel<true><<<nt, b, smem, st>>>(p, gg, ids, msk, sc, dp, ds, k, b, eps2, box);
        } else {
            short_range_bwd_kernel<false><<<nt, b, smem, st>>>(p, gg, ids, msk, sc, dp, ds, k, b, eps2, box);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
