// short_range: P3M's block-sparse short-range correction, isolated boundary.
//
// Replaces: nbody3d_tpu/ops/p3m.py::_short_range_kernel (reached by
// _short_range_tiles_pallas through short_range_tiles), the pair pass of
// every isolated P3M step.
//
// What it computes: for target row i of tile t, over the k neighbour tiles
// j = nbr[t][s] whose mutual mask mask[t][s] is not 0,
//
//   out[i] = sum_s mask[t][s] * sum_{r in tile j} w(r) * (x_r - x_i),
//   w = k_short(|d|^2) * m_r  where 0 < |d|^2 < rcut^2, else 0,
//   k_short = erfc(u) / s^3 + c2 e^{-u^2} / (s r),  u = r a,  s^2 = r^2 + eps2,
//
// with scal = [rcut^2, a = 1/(sqrt2 sigma), c2 = (2/sqrt(pi)) a, ...] read
// from device memory (sigma is a per-step device value: passing it as a
// host float would sync the host every step).  The pair arithmetic is the
// isolated branch of the Pallas kernel (p3m.py:736-761): two rsqrt, one
// exp feeding the Abramowitz-Stegun 7.1.26 erfc (|abs err| <= 1.5e-7), the
// same constants.  A slot with mask 0 is skipped, which is exact (the
// Pallas kernel multiplies that slot's reduced partial by 0); each slot is
// summed in registers before mask * partial joins the row's total, the
// order of sums of the Pallas kernel.  Deterministic; w lane of out is 0.
//
// What bounds it on an H100: operations.  Per pair about 35 FP32 issue
// slots, two MUFU rsqrt, one MUFU ex2 (in expf) and the reciprocal of
// 1/(1 + p u) (a MUFU rcp and its Newton step without --use_fast_math).
// Every pair of every slot is evaluated, in or out of rcut.
//
// Design: one CUDA block per target tile, one thread per target row (the
// tile is at most 1024 rows).  The source tile of each slot is staged in
// shared memory as float4 (x, y, z, m) and read by the whole block as a
// broadcast; the slot's id and mask are block-uniform, so the skip is a
// uniform branch and the barriers stay matched.  The TPU kernel ran a
// sequential (tile, slot) grid with a scratch accumulator; here the slot
// loop runs inside the block and the sum stays in registers.
#include <cuda_runtime.h>

namespace {

constexpr float kAsP = 0.3275911f;
constexpr float kAsA1 = 0.254829592f;
constexpr float kAsA2 = -0.284496736f;
constexpr float kAsA3 = 1.421413741f;
constexpr float kAsA4 = -1.453152027f;
constexpr float kAsA5 = 1.061405429f;

__global__ void short_range_kernel(const float4* __restrict__ ps, const int* __restrict__ nbr,
                                   const float* __restrict__ mask, const float* __restrict__ scal,
                                   float4* __restrict__ out, int k, int b, float eps2) {
    extern __shared__ float4 tile[];
    const int t = blockIdx.x;
    const int row = t * b + threadIdx.x;
    const float4 me = ps[row];
    const float rcut2 = scal[0];
    const float a = scal[1];
    const float c2 = scal[2];
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
            const float ks = erfc_u * (inv_s * inv_s * inv_s) + (c2 * e) * (inv_s * inv_r);
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

// ps (nt*b, 4), nbr and mask (nt, k), scal f32[5] (three read), out (nt*b, 4);
// b <= 1024.
extern "C" int nb_short_range(const void* ps, const void* nbr, const void* mask, const void* scal,
                              void* out, int nt, int k, int b, float eps2, void* stream) {
    if (nt > 0) {
        short_range_kernel<<<nt, b, b * sizeof(float4), static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(ps), static_cast<const int*>(nbr),
            static_cast<const float*>(mask), static_cast<const float*>(scal),
            static_cast<float4*>(out), k, b, eps2);
    }
    return static_cast<int>(cudaGetLastError());
}
