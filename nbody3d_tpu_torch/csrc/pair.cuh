// Shared pair arithmetic of the force kernels and the force VJP kernels,
// and the two source loops the force kernels share.
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

// The pull on `me` from every row of src[0, n_s), for a block of kTile
// threads that all call it (force_exact and fused_step_exact).  The block
// stages each tile of kTile sources through shared memory `tile` (G folded
// into the mass on the way in) and every thread sweeps it as a broadcast
// read.  Each tile's terms are summed into their own partial before the
// running total takes it, as the TPU kernel summed each source tile: one
// sequential f32 sum over all 40k sources of the two-galaxy run measured
// 3.0e-5 max-abs/scale against the plain twin on an H100, above the 1e-5
// bound, because a central body's term dwarfs the rest of its row.  Every
// operation is an explicit fmaf, add, multiply or rsqrt with nothing for
// nvcc to contract, so two kernels that call this get the same bits.
template <int kTile>
__device__ __forceinline__ float3 all_pairs_pull(const float4* __restrict__ src, int n_s,
                                                 float G, float eps2, float4 me,
                                                 float4* tile) {
    float ax = 0.f, ay = 0.f, az = 0.f;
    for (int base = 0; base < n_s; base += kTile) {
        const int s = base + threadIdx.x;
        float4 q = s < n_s ? src[s] : make_float4(0.f, 0.f, 0.f, 0.f);
        q.w = G * q.w;
        tile[threadIdx.x] = q;
        __syncthreads();
        float tx = 0.f, ty = 0.f, tz = 0.f;
#pragma unroll 8
        for (int r = 0; r < kTile; ++r) {
            const float4 p = tile[r];
            const float dx = p.x - me.x;
            const float dy = p.y - me.y;
            const float dz = p.z - me.z;
            const float w = p.w * pair_inv3(dx, dy, dz, eps2);
            tx = fmaf(w, dx, tx);
            ty = fmaf(w, dy, ty);
            tz = fmaf(w, dz, tz);
        }
        ax += tx;
        ay += ty;
        az += tz;
        __syncthreads();
    }
    return make_float3(ax, ay, az);
}

// The in-tile pull on body t of a tile of b bodies held in shared memory as
// four SoA arrays (sg: the G-folded masses), every ordered pair of the tile
// with the self pair skipped (sym_diag_prep and sym_diag).  Thread t visits
// sources in the staggered order (t + r) mod b, r = 1..b-1, which skips the
// self pair without a branch and keeps the 32 lanes of a warp on 32
// consecutive banks.
__device__ __forceinline__ float3 in_tile_pull(const float* sx, const float* sy, const float* sz,
                                               const float* sg, int b, int t, float4 me,
                                               float eps2) {
    float ax = 0.f, ay = 0.f, az = 0.f;
    for (int r = 1; r < b; ++r) {
        int s = t + r;
        if (s >= b) s -= b;
        const float dx = sx[s] - me.x;
        const float dy = sy[s] - me.y;
        const float dz = sz[s] - me.z;
        const float w = sg[s] * pair_inv3(dx, dy, dz, eps2);
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
