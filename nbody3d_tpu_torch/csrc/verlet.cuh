// The frame-shifted Verlet update of one row, shared by the two kernels that
// end in it (sym_epilogue, fused_step_exact).
//
// The operation order of the JAX kernels' _integrate and of
// ops/integrate.py::apply_integrator, on all four lanes (the w lanes stay
// put: vel.w == accel.w == 0):
//   v' = v + (a_old + a) * (dt/2)
//   x' = x + (v' + a * (dt/2)) * dt
// Every operation is an explicit round-to-nearest add or multiply, so nvcc
// forms no fused multiply-add and the result equals PyTorch's elementwise
// Verlet bit for bit on the same acceleration.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float verlet_v(float v, float ao, float a, float half_dt) {
    return __fadd_rn(v, __fmul_rn(__fadd_rn(ao, a), half_dt));
}

__device__ __forceinline__ float verlet_x(float x, float vn, float a, float half_dt, float dt) {
    return __fadd_rn(x, __fmul_rn(__fadd_rn(vn, __fmul_rn(a, half_dt)), dt));
}

// (p, v, a_old) -> (p', v') for the new acceleration a.
__device__ __forceinline__ void verlet_row(float4 p, float4 v, float4 ao, float4 a, float dt,
                                           float4& pn, float4& vn) {
    const float half_dt = __fmul_rn(dt, 0.5f);
    vn = make_float4(verlet_v(v.x, ao.x, a.x, half_dt), verlet_v(v.y, ao.y, a.y, half_dt),
                     verlet_v(v.z, ao.z, a.z, half_dt), verlet_v(v.w, ao.w, a.w, half_dt));
    pn = make_float4(verlet_x(p.x, vn.x, a.x, half_dt, dt), verlet_x(p.y, vn.y, a.y, half_dt, dt),
                     verlet_x(p.z, vn.z, a.z, half_dt, dt), verlet_x(p.w, vn.w, a.w, half_dt, dt));
}
