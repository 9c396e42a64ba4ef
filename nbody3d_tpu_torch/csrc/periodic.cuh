// periodic.cuh: the pair geometry and the pair scalar of the periodic short
// range, shared by short_range.cu (the forward) and short_range_bwd.cu (its
// VJP), so that both take the same image of a pair that straddles the seam
// and the same k.
#pragma once

// The minimum image of a separation d with |d| < box (p3m.py:732-735):
// one conditional shift by box, half = box / 2.
__device__ __forceinline__ float min_image(float d, float box, float half) {
    return (d - (d > half ? box : 0.f)) + (d < -half ? box : 0.f);
}

// The periodic split's pair scalar k = 1/s^3 - erf(u)/r^3 + c2 e/r^2
// (ops/ewald.py::k_short_periodic) from inv_r = 1/r, inv_s = 1/s,
// erf_u = erf(u), e = exp(-u^2) and c2 = (2/sqrt(pi)) / (sqrt2 sigma).
__device__ __forceinline__ float k_short_periodic(float inv_r, float inv_s, float erf_u, float e, float c2) {
    const float inv_s3 = inv_s * inv_s * inv_s;
    return (inv_s3 - erf_u * (inv_r * inv_r * inv_r)) + (c2 * e) * (inv_r * inv_r);
}
