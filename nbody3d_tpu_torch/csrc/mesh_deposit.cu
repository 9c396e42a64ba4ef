// mesh_deposit: TSC (order 3) or CIC (order 2) mass deposit onto the mesh.
//
// Replaces: nbody3d_tpu/ops/mesh_pallas.py::_deposit_kernel (reached by
// deposit_tiles from mesh_accel_pallas and pm_accel_pallas), and with it
// the XLA repair pass of the particles outside their tile's box.
//
// What it computes: rho[x][y][z] += m * wx * wy * wz for every stencil
// point of every particle, with the per-axis weights of
// mesh_pallas.py::_axis_weights (TSC: 0.5 (0.5-f)^2, 0.75 - f^2,
// 0.5 (0.5+f)^2 at cells c-1, c, c+1; CIC: 1-f, f at c, c+1) from the
// fraction f computed in torch, the product taken ((m wx) wy) wz as the
// plain twin takes it.  The caller has zeroed rho, and on the isolated box
// clipped c so the stencil lies in the grid.  On the periodic box
// (periodic != 0: nbody3d_tpu/ops/mesh_pallas.py's zmod form, reached by
// mesh_accel_periodic_pallas) c lies in [0, grid) and every stencil index
// wraps mod grid in x, y and z, at both orders; the TPU kernel wraps z in
// the kernel (_zwrap) and x/y through halo pads folded back afterwards,
// TSC only.  Particles of mass 0 (padding) add nothing and are skipped.
//
// What bounds it on an H100: bytes and atomics.  Each particle reads 32
// bytes and makes 27 (8) float atomicAdds; a 128^3 grid (8 MB) stays in
// the 50 MB L2, where the atomics resolve, so the least time is the
// particles' bytes plus the grid written once.  Dense cores put many
// particles on few cells, and atomics to one address serialise.
//
// Design: one thread per particle, the order a template parameter, the
// boundary a runtime flag (the wrap is 2 compares an index, 3 ORDER a
// particle).  The
// TPU had no scatter and deposited per Morton tile through one-hot
// matmuls into a box of a VMEM-resident grid, repairing the particles
// outside the box in XLA within a budget of tiles; the card has atomics,
// so every particle deposits in this one pass and no budget can drop
// one.  The atomics add in no fixed order: the result matches the twin to
// f32 rounding, not bit for bit.
#include <cuda_runtime.h>

#include "mesh.cuh"

namespace {

template <int ORDER>
__global__ void mesh_deposit_kernel(const int4* __restrict__ c, const float4* __restrict__ fm,
                                    float* __restrict__ rho, int n, int grid, int periodic) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float4 q = fm[i];
    if (q.w == 0.f) return;
    const int4 cc = c[i];
    float wx[ORDER], wy[ORDER], wz[ORDER];
    axis_weights<ORDER>(q.x, wx);
    axis_weights<ORDER>(q.y, wy);
    axis_weights<ORDER>(q.z, wz);
    int ix[ORDER], iy[ORDER], iz[ORDER];
    axis_cells<ORDER>(cc.x, grid, periodic, ix);
    axis_cells<ORDER>(cc.y, grid, periodic, iy);
    axis_cells<ORDER>(cc.z, grid, periodic, iz);
#pragma unroll
    for (int a = 0; a < ORDER; ++a) {
        const float ma = q.w * wx[a];
#pragma unroll
        for (int b = 0; b < ORDER; ++b) {
            const float mab = __fmul_rn(ma, wy[b]);
            const long long row = (static_cast<long long>(ix[a]) * grid + iy[b]) * grid;
#pragma unroll
            for (int d = 0; d < ORDER; ++d) {
                atomicAdd(rho + row + iz[d], __fmul_rn(mab, wz[d]));
            }
        }
    }
}

}  // namespace

// c (n, 4) int32 [cx, cy, cz, 0], fm (n, 4) f32 [fx, fy, fz, m], rho (grid^3) zeroed;
// periodic != 0: stencil indices wrap mod grid.
extern "C" int nb_mesh_deposit(const void* c, const void* fm, void* rho, int n, int grid, int order,
                               int periodic, void* stream) {
    constexpr int kThreads = 256;
    if (n > 0) {
        const dim3 blocks((n + kThreads - 1) / kThreads);
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const int4* ci = static_cast<const int4*>(c);
        const float4* f = static_cast<const float4*>(fm);
        float* r = static_cast<float*>(rho);
        if (order == 3) {
            mesh_deposit_kernel<3><<<blocks, kThreads, 0, s>>>(ci, f, r, n, grid, periodic);
        } else if (order == 2) {
            mesh_deposit_kernel<2><<<blocks, kThreads, 0, s>>>(ci, f, r, n, grid, periodic);
        } else {
            return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
