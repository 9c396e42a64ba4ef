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

// The long-range pair scalar of the Gaussian split, k_long = erf(u)/r^3 -
// c2 e/r^2 (ops/ewald.py::k_long_terms), from inv_r = 1/r, u = r a, e =
// exp(-u^2), c2 = (2/sqrt(pi)) a, c2a2 = c2 a^2 and u2 = u^2, a =
// 1/(sqrt2 sigma).  The two terms agree to O(u^2) and cancel: in f32 their
// difference at r << sigma is rounding noise of size 1/(sigma r^2), which
// swamped k at pairs far closer than sigma.  Below u = 0.5 (u2 < 0.25)
// k_long is its Maclaurin series in u^2 instead,
//   k_long = c2 a2 (2/3 - 2u^2/5 + u^4/7 - u^6/27 + u^8/132 - u^10/780
//                   + u^12/5400 - u^14/42840 + u^16/383040),
// truncated at 2e-12 relative (the next term, u^18/3810240); above, the
// closed form cancels by at most a factor 6.4 (at u = 0.5).  The switch
// sits at 0.5 and not 0.2 because at u just above 0.2 the closed form's
// rounding is still ~37x amplified: k = 1/s^3 - k_long came out 12.6 units
// of 2^-24 off f64 relative to 1/s^3 + k_long at sigma = 0.0117, eps2 =
// 1e-4; with the switch at 0.5 the twin stays within 6.8 of them for
// sigma in [0.0117, 0.1] at eps2 = 1e-4 and 1e-6, from r = 1e-6 sigma to
// rcut (tests/test_torch_ewald.py).  A branch, not a select: the pairs
// within u = 0.5 are a small share of those within rcut = 4.5 sigma
// (about (0.5/3.18)^3), so a warp mostly takes one side and skips the
// other's work, erff included.  Every rounding is written out (__fmul_rn,
// fmaf): left to it, ptxas fuses a product into a neighbouring difference
// on one side or the other depending on the loop around it, and a caller's
// k would then change bits with the caller's loop shape.  1/r^2 is taken
// before the branch: inside it, ptxas scheduled the forward's loop worse
// for the same instructions (PERF.md section 6).
__device__ __forceinline__ float k_long_periodic(float inv_r, float u, float e, float c2, float c2a2, float u2) {
    const float inv_r2 = __fmul_rn(inv_r, inv_r);
    if (u2 < 0.25f) {
        return __fmul_rn(
            c2a2,
            fmaf(u2,
                 fmaf(u2,
                      fmaf(u2,
                           fmaf(u2,
                                fmaf(u2,
                                     fmaf(u2, fmaf(u2, fmaf(u2, 1.f / 383040.f, -1.f / 42840.f), 1.f / 5400.f),
                                          -1.f / 780.f),
                                     1.f / 132.f),
                                -1.f / 27.f),
                           1.f / 7.f),
                      -0.4f),
                 2.f / 3.f));
    }
    return fmaf(__fmul_rn(inv_r, inv_r2), erff(u), -__fmul_rn(inv_r2, __fmul_rn(c2, e)));
}

// The periodic split's pair scalar k = 1/s^3 - k_long
// (ops/ewald.py::k_short_periodic), inv_s = 1/s, the rest as above.  It
// keeps a few ulp of 1/s^3 + k_long at any r.
__device__ __forceinline__ float k_short_periodic(float inv_r, float inv_s, float u, float e, float c2, float c2a2,
                                                  float u2) {
    return fmaf(inv_s, __fmul_rn(inv_s, inv_s), -k_long_periodic(inv_r, u, e, c2, c2a2, u2));
}
