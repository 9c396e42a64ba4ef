// Shared pair arithmetic of the force kernels.
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
