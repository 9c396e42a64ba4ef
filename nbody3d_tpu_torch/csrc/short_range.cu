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
// What bounds it on an H100: operations.  Per pair, isolated: about 35
// FP32 issue slots, two MUFU rsqrt, one MUFU ex2 (in expf) and the
// reciprocal of 1/(1 + p u) (a MUFU rcp and its Newton step without
// --use_fast_math); periodic: the minimum image and erff's polynomial in
// place of the A-S erfc, about 45 FP32 slots and three MUFU (erff may add
// an ex2 where u > 1); below u = 0.5 k_long's 9-term series replaces erff
// (periodic.cuh), on a small share of the pairs.  Every pair of every slot is evaluated, in or out
// of rcut.
//
// Design: one CUDA block per target tile, one thread per target row (the
// tile is at most 1024 rows).  The source tile of each slot is staged in
// shared memory as float4 (x, y, z, m) and read by the whole block as a
// broadcast; the slot's id and mask are block-uniform, so the skip is a
// uniform branch and the barriers stay matched.  The TPU kernel ran a
// sequential (tile, slot) grid with a scratch accumulator; here the slot
// loop runs inside the block and the sum stays in registers.  The two
// boundaries are one source loop, instanced by a template flag, so the
// isolated instance carries no minimum-image code.  The minimum image and
// the periodic k live in periodic.cuh, which short_range_bwd.cu includes
// too.
#include <cuda_runtime.h>

#include "periodic.cuh"

namespace {

constexpr float kAsP = 0.3275911f;
constexpr float kAsA1 = 0.254829592f;
constexpr float kAsA2 = -0.284496736f;
constexpr float kAsA3 = 1.421413741f;
constexpr float kAsA4 = -1.453152027f;
constexpr float kAsA5 = 1.061405429f;

template <bool PERIODIC>
__global__ void short_range_kernel(const float4* __restrict__ ps, const int* __restrict__ nbr,
                                   const float* __restrict__ mask, const float* __restrict__ scal,
                                   float4* __restrict__ out, int k, int b, float eps2, float box) {
    extern __shared__ float4 tile[];
    const int t = blockIdx.x;
    const int row = t * b + threadIdx.x;
    const float4 me = ps[row];
    const float rcut2 = scal[0];
    const float a = scal[1];
    const float c2 = scal[2];
    const float a2 = scal[3];
    const float half = 0.5f * box;
    float ax = 0.f, ay = 0.f, az = 0.f;
    for (int s = 0; s < k; ++s) {
        const float msk = mask[t * k + s];
        if (msk == 0.f) continue;  // block-uniform
        const int j = nbr[t * k + s];
        __syncthreads();
        tile[threadIdx.x] = ps[j * b + threadIdx.x];
        __syncthreads();
        float px = 0.f, py = 0.f, pz = 0.f;
        for (int q = 0; q < b; ++q) {
            const float4 p = tile[q];
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
            const float e = expf(-(u * u));
            float ks;
            if (PERIODIC) {
                ks = k_short_periodic(inv_r, inv_s, u, e, c2, a2, r2s * a2);
            } else {
                const float tt = 1.f / (1.f + kAsP * u);
                const float erfc_u = tt * (kAsA1 + tt * (kAsA2 + tt * (kAsA3 + tt * (kAsA4 + tt * kAsA5)))) * e;
                ks = erfc_u * (inv_s * inv_s * inv_s) + (c2 * e) * (inv_s * inv_r);
            }
            const float w = (pos && r2 < rcut2) ? ks * p.w : 0.f;
            px = fmaf(w, dx, px);
            py = fmaf(w, dy, py);
            pz = fmaf(w, dz, pz);
        }
        ax = fmaf(msk, px, ax);
        ay = fmaf(msk, py, ay);
        az = fmaf(msk, pz, az);
    }
    out[row] = make_float4(ax, ay, az, 0.f);
}

}  // namespace

// ps (nt*b, 4), nbr and mask (nt, k), scal f32[5] (four read), out (nt*b, 4);
// b <= 1024; box = 0 isolated, box = L > 0 periodic (positions in [0, L)).
extern "C" int nb_short_range(const void* ps, const void* nbr, const void* mask, const void* scal,
                              void* out, int nt, int k, int b, float eps2, float box, void* stream) {
    if (nt > 0) {
        const auto* p = static_cast<const float4*>(ps);
        const auto* ids = static_cast<const int*>(nbr);
        const auto* msk = static_cast<const float*>(mask);
        const auto* sc = static_cast<const float*>(scal);
        auto* o = static_cast<float4*>(out);
        const cudaStream_t st = static_cast<cudaStream_t>(stream);
        if (box > 0.f) {
            short_range_kernel<true><<<nt, b, b * sizeof(float4), st>>>(p, ids, msk, sc, o, k, b, eps2, box);
        } else {
            short_range_kernel<false><<<nt, b, b * sizeof(float4), st>>>(p, ids, msk, sc, o, k, b, eps2, box);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
