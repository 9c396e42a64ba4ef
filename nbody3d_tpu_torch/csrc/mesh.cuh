// Shared assignment weights and stencil cells of the mesh deposit and
// gather kernels.
//
// The per-axis weights of nbody3d_tpu/ops/mesh_pallas.py::_axis_weights at
// the stencil offsets, from the fraction f computed in torch:
//   ORDER 3 (TSC, f in [-1/2, 1/2], cells c-1, c, c+1):
//     0.5 (0.5 - f)^2,  0.75 - f^2,  0.5 (0.5 + f)^2
//   ORDER 2 (CIC, f in [0, 1], cells c, c+1):  1 - f,  f
// Each product and difference is rounded on its own (__fmul_rn keeps nvcc
// from fusing 0.75 - f*f into one FMA), so the weights are the plain
// twin's to the bit.
#pragma once

#include <cuda_runtime.h>

template <int ORDER>
__device__ __forceinline__ void axis_weights(float f, float* w);

template <>
__device__ __forceinline__ void axis_weights<3>(float f, float* w) {
    const float lo = 0.5f - f;
    const float hi = 0.5f + f;
    w[0] = 0.5f * __fmul_rn(lo, lo);
    w[1] = 0.75f - __fmul_rn(f, f);
    w[2] = 0.5f * __fmul_rn(hi, hi);
}

template <>
__device__ __forceinline__ void axis_weights<2>(float f, float* w) {
    w[0] = 1.f - f;
    w[1] = f;
}

// The ORDER cells of one axis of a stencil whose base cell is c (TSC:
// c-1, c, c+1; CIC: c, c+1).  On the isolated box the caller clipped c so
// the stencil lies in the grid; on the periodic box (wrap != 0) c is in
// [0, grid) and a cell one step past either face wraps to the other.
template <int ORDER>
__device__ __forceinline__ void axis_cells(int c, int grid, int wrap, int* cell) {
    const int lo = ORDER == 3 ? 1 : 0;
#pragma unroll
    for (int a = 0; a < ORDER; ++a) {
        int v = c - lo + a;
        if (wrap) v = v < 0 ? v + grid : (v >= grid ? v - grid : v);
        cell[a] = v;
    }
}
