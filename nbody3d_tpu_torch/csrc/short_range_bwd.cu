// short_range_bwd: the VJP of short_range (P3M's block-sparse short-range
// pass), isolated boundary.
//
// Replaces: nbody3d_tpu/ops/p3m.py::_short_range_bwd_kernel (reached by
// _short_range_tiles_bwd_pallas from _make_sr_pallas_diff's full-range
// backward), the backward of every P3M step that needs a gradient.
//
// What it computes: for the cotangent g of short_range's output, with
// target row i of tile t and source rows j of the k neighbour tiles
// nbr[t][s] whose mutual mask mask[t][s] is not 0, d = x_j - x_i, the pair
// scalar k = k_short(|d|^2), k' = dk/d|d|^2 and k_s = dk/dsigma (all three 0
// outside 0 < |d|^2 < rcut^2),
//
//   dps[i].xyz = sum mask * [2 k' (m_i (d.g_j) - m_j (d.g_i)) d + k (m_i g_j - m_j g_i)]
//   dps[i].w   = sum mask * (-k (d.g_j))                        (the mass cotangent)
//   dsig[i]    = sum mask * m_j (d.g_i) k_s                     (summed outside)
//
// with scal = [rcut^2, a = 1/(sqrt2 sigma), c2 = (2/sqrt(pi)) a, 0, 1/sigma]
// in device memory (sigma is a per-step device value).  The formulas are the
// isolated branch of the Pallas kernel (p3m.py:899-903, 954-969), with its
// Abramowitz-Stegun 7.1.26 erfc; k' is the same sum with its two equal
// -c2 e / (2 r s^3) terms added.  A row's cotangent gathers over the row's
// OWN neighbour list only: the mutual mask makes the pair set symmetric (a
// pair (i, j) listed in i's tile is listed in j's), so every term in which
// row i acts as a source appears on its own list, and the kernel never
// scatters.  A slot with mask 0 is skipped; a slot whose source tile has no
// mass is NOT (its m_i g_j and mass terms are not 0).  Each slot is summed in
// registers before mask * partial joins the row's total, the order of sums
// of the Pallas kernel.  Deterministic, no atomics.
//
// What bounds it on an H100: operations.  Per pair about 100 FP32 FLOP (an
// FMA counts 2, expf's range reduction and the reciprocal's Newton step
// included, as short_range.cu's 47 count them) and four MUFU results, as in
// the forward: two rsqrt, the ex2 of expf and the rcp of 1/(1 + p u).  FP32
// binds: 100 / 256 FLOP a clock and SM against 4 / 16 MUFU results.  Every
// pair of every live slot is evaluated, in or out of rcut.
//
// Design: the forward's schedule.  One CUDA block per target tile, one
// thread per target row (the tile is at most 1024 rows).  Each live slot's
// source positions and cotangents are staged in shared memory as two float4
// a row and read by the whole block as broadcasts; the slot's id and mask
// are block-uniform, so the skip is a uniform branch and the barriers stay
// matched.  The TPU kernel ran a sequential (tile, slot) grid with scratch
// accumulators; here the slot loop runs inside the block and the five sums
// stay in registers.
#include <cuda_runtime.h>

namespace {

constexpr float kAsP = 0.3275911f;
constexpr float kAsA1 = 0.254829592f;
constexpr float kAsA2 = -0.284496736f;
constexpr float kAsA3 = 1.421413741f;
constexpr float kAsA4 = -1.453152027f;
constexpr float kAsA5 = 1.061405429f;
constexpr float kSqrt2 = 1.4142135623730951f;

__global__ void short_range_bwd_kernel(const float4* __restrict__ ps, const float4* __restrict__ g,
                                       const int* __restrict__ nbr, const float* __restrict__ mask,
                                       const float* __restrict__ scal, float4* __restrict__ dps,
                                       float* __restrict__ dsig, int k, int b, float eps2) {
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
    const float c2s = kSqrt2 * c2;       // (2/sqrt(pi)) / sigma
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
            const float dx = p.x - me.x;
            const float dy = p.y - me.y;
            const float dz = p.z - me.z;
            const float r2 = dx * dx + (dy * dy + dz * dz);
            const bool pos = r2 > 0.f;
            const float r2s = pos ? r2 : 1.f;
            const float inv_r = rsqrtf(r2s);
            const float r = r2s * inv_r;
            const float inv_s = rsqrtf(r2s + eps2);
            const float u = r * a;
            const float e = expf(-(u * u));
            const float tt = 1.f / (1.f + kAsP * u);
            const float erfc_u = tt * (kAsA1 + tt * (kAsA2 + tt * (kAsA3 + tt * (kAsA4 + tt * kAsA5)))) * e;
            const float inv_s2 = inv_s * inv_s;
            const float inv_s3 = inv_s2 * inv_s;
            const float sr = inv_s * inv_r;
            const float ce = c2 * e;
            const float ks = erfc_u * inv_s3 + ce * sr;
            const float kp = -1.5f * erfc_u * (inv_s3 * inv_s2) - ce * (inv_r * inv_s3 + sr * (a2 + 0.5f * inv_r * inv_r));
            const float kg = e * (c2s * u * inv_s3 + c2 * inv_sigma * (2.f * u * u - 1.f) * sr);
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
// dps (nt*b, 4), dsig (nt*b,); b <= 1024.
extern "C" int nb_short_range_bwd(const void* ps, const void* g, const void* nbr, const void* mask,
                                  const void* scal, void* dps, void* dsig, int nt, int k, int b, float eps2,
                                  void* stream) {
    if (nt > 0) {
        short_range_bwd_kernel<<<nt, b, 2 * b * sizeof(float4), static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(ps), static_cast<const float4*>(g), static_cast<const int*>(nbr),
            static_cast<const float*>(mask), static_cast<const float*>(scal), static_cast<float4*>(dps),
            static_cast<float*>(dsig), k, b, eps2);
    }
    return static_cast<int>(cudaGetLastError());
}
