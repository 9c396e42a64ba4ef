// Shared pair arithmetic of the force kernels and the force VJP kernels,
// and the in-tile loop of the sym diagonal kernels (exact.cuh holds the
// exact kernels' source loop).
//
// The softened pair weight of the reference shader, with the nesting of
// nbody3d_tpu/ops/pallas_force.py::_pair_diffs / _accum_exact kept:
//
//   d2   = dx*dx + (dy*dy + (dz*dz + eps2))      (three fused multiply-adds)
//   inv3 = rsqrt(d2 * (d2 * d2))
//
// The caller multiplies inv3 by the G-folded mass of the body that pulls.
// For the self pair dx = dy = dz = 0 exactly, so its term w * 0 is 0 for
// any finite w (eps2 > 0 keeps w finite).
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float pair_inv3(float dx, float dy, float dz, float eps2) {
    const float d2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
    return rsqrtf(d2 * (d2 * d2));
}

// rsqrtf of a normal or infinite argument: rsqrtf guards a subnormal
// argument (a compare and two multiplies: 3 instructions a pair, 14.12 ->
// 17.12 in exact.cuh's loop as counted in its SASS on an H100); the ftz
// form has no guard and returns the same bits there.
// pair_inv3_normal is pair_inv3 for a caller that knows d2^3 is a normal
// float for every pair: eps2 * (eps2 * eps2) >= FLT_MIN, since d2 >= eps2
// and rounding is monotone.
__device__ __forceinline__ float rsqrt_normal(float x) {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ float pair_inv3_normal(float dx, float dy, float dz, float eps2) {
    const float d2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
    return rsqrt_normal(d2 * (d2 * d2));
}

// The in-tile pull on body t (position me) of a tile of b bodies staged in
// shared memory twice over, tile[s] = tile[b + s] = [x, y, z, G*m] of row s
// (sym_diag_prep and sym_diag): every ordered pair of the tile with the self
// pair skipped, the sources in the staggered order (t + r) mod b,
// r = 1..b-1, read as tile[t + r].  The second copy takes the wrap, so the
// loop tests nothing, and the 32 lanes of a warp read 32 consecutive rows,
// one 16-byte read a pair; unrolled by 8 (by 4 it ran 2% slower on an
// H100, not unrolled 21%: PERF.md).  kNormal: eps2^3 is a normal float, so
// pair_inv3_normal gives pair_inv3's bits.  B > 0: b is B, known at compile
// time.
template <bool kNormal, int B>
__device__ __forceinline__ float3 in_tile_pull(const float4* tile, int b_rt, int t, float4 me, float eps2) {
    const int b = B > 0 ? B : b_rt;
    const float4* from = tile + t;
    float ax = 0.f, ay = 0.f, az = 0.f;
#pragma unroll 8
    for (int r = 1; r < b; ++r) {
        const float4 p = from[r];
        const float dx = p.x - me.x;
        const float dy = p.y - me.y;
        const float dz = p.z - me.z;
        const float w = p.w * (kNormal ? pair_inv3_normal(dx, dy, dz, eps2) : pair_inv3(dx, dy, dz, eps2));
        ax = fmaf(w, dx, ax);
        ay = fmaf(w, dy, ay);
        az = fmaf(w, dz, az);
    }
    return make_float3(ax, ay, az);
}

// One pair's share of the force VJP (per unit G), for target k and source
// j with d = x_j - x_k, the cotangents A_k, A_j and the masses m_k, m_j
// (the .w lanes of xk and xj):
//
//   w = (|d|^2 + eps2)^-3/2,  w5 = w / (|d|^2 + eps2)
//   g = m_k A_j - m_j A_k
//   t = w g - 3 w5 (d.g) d       x̄_k += t,  x̄_j -= t (antisymmetric)
//   m̄_k += -w (d.A_j)            m̄_j += w (d.A_k)
//   φ_k  +=  w m_j (d.A_k)        φ_j  += -w m_k (d.A_j)     Ḡ = Σ φ
//   φ_k + φ_j = -w (d.g)          (phi: one product for the Newton-3
//                                  kernel, which needs the pair's sum alone)
//
// (the math of nbody3d_tpu/ops/force_vjp.py's docstring, with the x̄ term
// accumulated per pair rather than folded through row sums).  d.g is
// m_k (d.A_j) - m_j (d.A_k), so the pair needs two cotangent dot products.
// The caller masks the self pair: there g cancels only to f32 rounding
// while w is the softening floor eps2^-3/2.
struct VjpPair {
    float tx, ty, tz;  // x̄ term of the target (the source takes -t)
    float mbar_t;      // m̄ term of the target
    float mbar_s;      // m̄ term of the source
    float phi_t;       // φ term of the target
    float phi;         // φ term of the target and the source, -w (d.g)
};

// kNormal: eps2 >= FLT_MIN, so d2 >= eps2 is normal and rsqrt_normal gives
// rsqrtf's bits.
template <bool kNormal = false>
__device__ __forceinline__ VjpPair vjp_pair(float4 xk, float3 ak, float4 xj, float3 aj,
                                            float eps2) {
    const float dx = xj.x - xk.x;
    const float dy = xj.y - xk.y;
    const float dz = xj.z - xk.z;
    const float d2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
    const float r = kNormal ? rsqrt_normal(d2) : rsqrtf(d2);
    const float inv = r * r;
    const float w = inv * r;
    const float w5 = w * inv;
    const float p = fmaf(dx, aj.x, fmaf(dy, aj.y, dz * aj.z));  // d.A_j
    const float q = fmaf(dx, ak.x, fmaf(dy, ak.y, dz * ak.z));  // d.A_k
    const float dg = fmaf(xk.w, p, -(xj.w * q));
    const float c = 3.f * w5 * dg;
    const float gx = fmaf(xk.w, aj.x, -(xj.w * ak.x));
    const float gy = fmaf(xk.w, aj.y, -(xj.w * ak.y));
    const float gz = fmaf(xk.w, aj.z, -(xj.w * ak.z));
    VjpPair e;
    e.tx = fmaf(w, gx, -(c * dx));
    e.ty = fmaf(w, gy, -(c * dy));
    e.tz = fmaf(w, gz, -(c * dz));
    e.mbar_t = -(w * p);
    e.mbar_s = w * q;
    e.phi_t = w * xj.w * q;
    e.phi = -(w * dg);
    return e;
}
