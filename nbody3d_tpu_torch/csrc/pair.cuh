// Shared pair arithmetic of the force kernels and the force VJP kernels.
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

// One pair's share of the force VJP (per unit G), for target k and source
// j with d = x_j - x_k, the cotangents A_k, A_j and the masses m_k, m_j
// (the .w lanes of xk and xj):
//
//   w = (|d|^2 + eps2)^-3/2,  w5 = w / (|d|^2 + eps2)
//   g = m_k A_j - m_j A_k
//   t = w g - 3 w5 (d.g) d       x̄_k += t,  x̄_j -= t (antisymmetric)
//   m̄_k += -w (d.A_j)            m̄_j += w (d.A_k)
//   φ_k  +=  w m_j (d.A_k)        φ_j  += -w m_k (d.A_j)     Ḡ = Σ φ
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
    float phi_s;       // φ term of the source
};

__device__ __forceinline__ VjpPair vjp_pair(float4 xk, float3 ak, float4 xj, float3 aj,
                                            float eps2) {
    const float dx = xj.x - xk.x;
    const float dy = xj.y - xk.y;
    const float dz = xj.z - xk.z;
    const float d2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
    const float r = rsqrtf(d2);
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
    e.phi_s = -(w * xk.w * p);
    return e;
}
