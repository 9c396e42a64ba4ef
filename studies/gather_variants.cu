// Gather loops beside csrc/mesh_gather.cu's, for studies/gather_variants.py:
// the first design's per-thread loop with the periodic wrap a compile-time
// flag ("static": no runtime select of the wrap), and the same loop reading
// one 16-byte stencil point of all three grids from an interleaved copy of
// the grids, g4 (grid^3, 4) ("float4").  Both keep the first design's
// weights, products and order of sums, so both give its bits.
#include <cuda_runtime.h>

#include "../nbody3d_tpu_torch/csrc/mesh.cuh"

namespace {

template <int ORDER, bool PERIODIC, bool F4>
__global__ void __launch_bounds__(256)
gather_loop(const float* __restrict__ grids, const float4* __restrict__ g4, const int4* __restrict__ c,
            const float4* __restrict__ fm, float4* __restrict__ out, int n, int grid) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float4 q = fm[i];
    const int4 cc = c[i];
    const int g3 = grid * grid * grid;
    float wx[ORDER], wy[ORDER], wz[ORDER];
    axis_weights<ORDER>(q.x, wx);
    axis_weights<ORDER>(q.y, wy);
    axis_weights<ORDER>(q.z, wz);
    int ix[ORDER], iy[ORDER], iz[ORDER];
    axis_cells<ORDER>(cc.x, grid, PERIODIC, ix);
    axis_cells<ORDER>(cc.y, grid, PERIODIC, iy);
    axis_cells<ORDER>(cc.z, grid, PERIODIC, iz);
    float ax = 0.f, ay = 0.f, az = 0.f;
#pragma unroll
    for (int a = 0; a < ORDER; ++a) {
#pragma unroll
        for (int b = 0; b < ORDER; ++b) {
            const float wab = __fmul_rn(wx[a], wy[b]);
            const int row = (ix[a] * grid + iy[b]) * grid;
#pragma unroll
            for (int d = 0; d < ORDER; ++d) {
                const int at = row + iz[d];
                const float w = __fmul_rn(wab, wz[d]);
                float gx, gy, gz;
                if (F4) {
                    const float4 v = __ldg(g4 + at);
                    gx = v.x, gy = v.y, gz = v.z;
                } else {
                    gx = __ldg(grids + at), gy = __ldg(grids + g3 + at), gz = __ldg(grids + 2 * g3 + at);
                }
                ax = fmaf(gx, w, ax);
                ay = fmaf(gy, w, ay);
                az = fmaf(gz, w, az);
            }
        }
    }
    out[i] = make_float4(ax, ay, az, 0.f);
}

template <int ORDER, bool F4>
int run(const float* g, const float4* g4, const int4* c, const float4* fm, float4* out, int n, int grid,
        int periodic, cudaStream_t s) {
    const dim3 blocks((n + 255) / 256);
    if (periodic) {
        gather_loop<ORDER, true, F4><<<blocks, 256, 0, s>>>(g, g4, c, fm, out, n, grid);
    } else {
        gather_loop<ORDER, false, F4><<<blocks, 256, 0, s>>>(g, g4, c, fm, out, n, grid);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant 0: "static" (three grids), 1: "float4" (g4).
extern "C" int gather_study(int variant, const void* grids, const void* g4, const void* c, const void* fm, void* out,
                            int n, int grid, int order, int periodic, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* g = static_cast<const float*>(grids);
    const float4* v = static_cast<const float4*>(g4);
    const int4* ci = static_cast<const int4*>(c);
    const float4* f = static_cast<const float4*>(fm);
    float4* o = static_cast<float4*>(out);
    if (order == 3) return variant ? run<3, true>(g, v, ci, f, o, n, grid, periodic, s)
                                   : run<3, false>(g, v, ci, f, o, n, grid, periodic, s);
    return variant ? run<2, true>(g, v, ci, f, o, n, grid, periodic, s)
                   : run<2, false>(g, v, ci, f, o, n, grid, periodic, s);
}
