// mesh_gather: TSC (order 3) or CIC (order 2) interpolation of the three
// force grids at the particles.
//
// Replaces: nbody3d_tpu/ops/mesh_pallas.py::_gather_kernel (reached by
// gather_tiles from mesh_accel_pallas and pm_accel_pallas), and with it
// the XLA repair pass of the particles outside their tile's box.
//
// What it computes: out[i][comp] = sum over the stencil of
// grids[comp][x][y][z] * ((wx wy) wz), the weights of mesh.cuh (the
// deposit's assignment function: matched deposit and gather keep the
// mesh force free of self-force and momentum-conserving), summed in a
// fixed order (x outermost, z innermost); w lane of out is 0.
// Deterministic.  On the periodic box (periodic != 0: the zmod form of
// _gather_kernel, mesh_pallas.py:315, whose x/y wrap the TPU took from
// halo pads prefilled in XLA) the base cell lies in [0, grid) and every
// stencil index wraps mod grid in all three axes, at both orders.
//
// What bounds it on an H100: bytes.  Each particle reads 32 bytes and
// writes 16; the three grids (24 MB at 128^3) are read once from HBM and
// then hit in the 50 MB L2, 81 (24) reads a particle.
//
// Design: one thread per particle, the order a template parameter, the
// boundary a runtime flag, no atomics.  The TPU kernel contracted a box of the VMEM-resident grids
// against one-hot weight matrices per Morton tile and repaired the
// out-of-box particles in XLA; here each thread reads its own stencil.
#include <cuda_runtime.h>

#include "mesh.cuh"

namespace {

template <int ORDER>
__global__ void mesh_gather_kernel(const float* __restrict__ grids, const int4* __restrict__ c,
                                   const float4* __restrict__ fm, float4* __restrict__ out, int n,
                                   int grid, int periodic) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float4 q = fm[i];
    const int4 cc = c[i];
    const long long g3 = static_cast<long long>(grid) * grid * grid;
    float wx[ORDER], wy[ORDER], wz[ORDER];
    axis_weights<ORDER>(q.x, wx);
    axis_weights<ORDER>(q.y, wy);
    axis_weights<ORDER>(q.z, wz);
    int ix[ORDER], iy[ORDER], iz[ORDER];
    axis_cells<ORDER>(cc.x, grid, periodic, ix);
    axis_cells<ORDER>(cc.y, grid, periodic, iy);
    axis_cells<ORDER>(cc.z, grid, periodic, iz);
    float ax = 0.f, ay = 0.f, az = 0.f;
#pragma unroll
    for (int a = 0; a < ORDER; ++a) {
#pragma unroll
        for (int b = 0; b < ORDER; ++b) {
            const float wab = __fmul_rn(wx[a], wy[b]);
            const long long row = (static_cast<long long>(ix[a]) * grid + iy[b]) * grid;
#pragma unroll
            for (int d = 0; d < ORDER; ++d) {
                const long long at = row + iz[d];
                const float w = __fmul_rn(wab, wz[d]);
                ax = fmaf(__ldg(grids + at), w, ax);
                ay = fmaf(__ldg(grids + g3 + at), w, ay);
                az = fmaf(__ldg(grids + 2 * g3 + at), w, az);
            }
        }
    }
    out[i] = make_float4(ax, ay, az, 0.f);
}

}  // namespace

// grids (3, grid^3) f32, c (n, 4) int32, fm (n, 4) f32 (m not read), out (n, 4);
// periodic != 0: stencil indices wrap mod grid.
extern "C" int nb_mesh_gather(const void* grids, const void* c, const void* fm, void* out, int n,
                              int grid, int order, int periodic, void* stream) {
    constexpr int kThreads = 256;
    if (n > 0) {
        const dim3 blocks((n + kThreads - 1) / kThreads);
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const float* g = static_cast<const float*>(grids);
        const int4* ci = static_cast<const int4*>(c);
        const float4* f = static_cast<const float4*>(fm);
        float4* o = static_cast<float4*>(out);
        if (order == 3) {
            mesh_gather_kernel<3><<<blocks, kThreads, 0, s>>>(g, ci, f, o, n, grid, periodic);
        } else if (order == 2) {
            mesh_gather_kernel<2><<<blocks, kThreads, 0, s>>>(g, ci, f, o, n, grid, periodic);
        } else {
            return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
