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
// then hit in the 50 MB L2.
//
// Design.  The first design, a thread a particle that loads its own
// stencil (81 or 24 scalar loads), is held back by the loads, not the
// bytes, where the rows are spread: on P3M's uniform box in Morton order
// (one body a cell) a warp's load touches ~14 lines of L1, on the dense
// disks ~2.5 (PERF.md).  So for rows in Morton order (boxes != 0, P3M's)
// the kernel takes the counterpart of mesh_deposit's box (and of the JAX
// kernel's tile-local box in VMEM): a block takes a run of 256 consecutive
// rows and reduces the least and greatest base cell per axis; on the
// periodic box each base cell is first unwrapped to the image nearest the
// run's first row (mesh_deposit's unwrap), so a run across a seam has a
// small box.  The stencil widens it by 1 cell each side (TSC) or 1 above
// (CIC).
//   - If the box holds at most kBoxCap cells (path 0) the block stages it,
//     three grids, into shared memory (consecutive threads on consecutive
//     z cells, the indices wrapped mod grid on the periodic box), and each
//     thread reads its stencil there.
//   - Otherwise (path 1) each thread reads its stencil from the grids in
//     global memory, the first design's loop.
// kBoxCap = 2048 (24 KB): 1,024 and 1,536 cells were slower at 12b (more
// runs over the cap), 3,072 (36 KB) 4% faster at 12b and 0.5% slower at
// 8b (PERF.md).  The loop leans on the L1 that the boxes take: on unsorted
// rows, where every run's box exceeds the cap, this kernel ran 9% slower
// than the loop alone at 12d and 38% at 8d (18 KB boxes: 8% and 19%).  So
// unsorted rows (boxes == 0, PM's) take the first design's kernel as it
// was, with no shared memory, every block on path 1.
// Both kernels form the same weights and products and sum in the same
// order, so the output does not depend on the kernel or the path.  With
// paths non-null, thread 0 of each block adds one to its path.
#include <cuda_runtime.h>

#include <climits>

#include "mesh.cuh"

namespace {

constexpr int kThreads = 256;                 // rows a block's run
constexpr int kWarps = kThreads / 32;
// Cells of a run's box (3 grids: 24 KB of shared memory); studies/gather_variants.py
// builds this file with other caps through -DNB_GATHER_BOX_CAP.
#ifndef NB_GATHER_BOX_CAP
#define NB_GATHER_BOX_CAP 2048
#endif
constexpr int kBoxCap = NB_GATHER_BOX_CAP;

// The image of periodic cell v nearest to ref: v, v - grid or v + grid.
__device__ __forceinline__ int unwrap(int v, int ref, int grid) {
    const int d = v - ref;
    return d > grid / 2 ? v - grid : (d < -(grid / 2) ? v + grid : v);
}

// v in [-grid, 2 grid) back into [0, grid).
__device__ __forceinline__ int wrap(int v, int grid) { return v < 0 ? v + grid : (v >= grid ? v - grid : v); }

// One particle's stencil read from the grids in global memory (the first
// design's loop).
template <int ORDER>
__device__ __forceinline__ float4 gather_global(const float* __restrict__ grids, int4 cc, float4 q, int grid,
                                                int periodic) {
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
    return make_float4(ax, ay, az, 0.f);
}

// Unsorted rows: a thread a particle, no shared memory.
template <int ORDER>
__global__ void mesh_gather_kernel(const float* __restrict__ grids, const int4* __restrict__ c,
                                   const float4* __restrict__ fm, float4* __restrict__ out, int n, int grid,
                                   int periodic, int* __restrict__ paths) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (paths && threadIdx.x == 0) atomicAdd(paths + 1, 1);
    if (i >= n) return;
    out[i] = gather_global<ORDER>(grids, c[i], fm[i], grid, periodic);
}

// Least (v[0:3]) and greatest (v[3:6]) over the warp, in every lane.
__device__ __forceinline__ void warp_reduce(int* v) {
#pragma unroll
    for (int a = 0; a < 6; ++a)
        v[a] = a < 3 ? __reduce_min_sync(0xffffffffu, v[a]) : __reduce_max_sync(0xffffffffu, v[a]);
}

// Rows in Morton order: each run's box in shared memory, or the loop.
template <int ORDER, bool PERIODIC>
__global__ void __launch_bounds__(kThreads)
mesh_gather_box_kernel(const float* __restrict__ grids, const int4* __restrict__ c, const float4* __restrict__ fm,
                       float4* __restrict__ out, int n, int grid, int* __restrict__ paths) {
    __shared__ float box[3][kBoxCap];
    __shared__ int part[kWarps][6];
    const int tid = threadIdx.x, lane = tid & 31;
    const long long first = static_cast<long long>(blockIdx.x) * kThreads;  // the run's first row
    const long long i = first + tid;
    const bool live = i < n;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    int4 cc = make_int4(0, 0, 0, 0);
    if (live) {
        q = fm[i];
        cc = c[i];
    }
    int4 cu = cc;  // the base cell, unwrapped about the run's first on the periodic box
    if (PERIODIC) {
        const int4 ref = c[first];
        cu.x = unwrap(cc.x, ref.x, grid), cu.y = unwrap(cc.y, ref.y, grid), cu.z = unwrap(cc.z, ref.z, grid);
    }
    // least x, y, z; greatest x, y, z
    int v[6] = {live ? cu.x : INT_MAX, live ? cu.y : INT_MAX, live ? cu.z : INT_MAX,
                live ? cu.x : INT_MIN, live ? cu.y : INT_MIN, live ? cu.z : INT_MIN};
    warp_reduce(v);
    if (lane == 0) {
#pragma unroll
        for (int a = 0; a < 6; ++a) part[tid >> 5][a] = v[a];
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 6; ++a) v[a] = lane < kWarps ? part[lane][a] : (a < 3 ? INT_MAX : INT_MIN);
    warp_reduce(v);
    const int ex = v[3] - v[0] + ORDER, ey = v[4] - v[1] + ORDER, ez = v[5] - v[2] + ORDER;
    const bool boxed = static_cast<long long>(ex) * ey * ez <= kBoxCap;  // every block has a live row
    if (paths && tid == 0) atomicAdd(paths + (boxed ? 0 : 1), 1);
    const int lo = ORDER == 3 ? 1 : 0;  // the stencil's cells below the base cell
    if (boxed) {
        // grid^3 and a cell's index fit in int (the wrapper keeps grid^3 below
        // 2^31); 2 grid^3 does not from grid 1,024 on, so the third grid is
        // reached by two int steps of pointer arithmetic.  (A 64-bit g3 cost
        // the isolated TSC instance registers and a block an SM.)
        const int g3 = grid * grid * grid;
        const int x0 = v[0] - lo, y0 = v[1] - lo, z0 = v[2] - lo;  // the box's first cell
        const int nc = ex * ey * ez;
        for (int j = tid; j < nc; j += kThreads) {
            const int bz = j % ez, t = j / ez, by = t % ey, bx = t / ey;
            int gx = x0 + bx, gy = y0 + by, gz = z0 + bz;
            if (PERIODIC) gx = wrap(gx, grid), gy = wrap(gy, grid), gz = wrap(gz, grid);
            const int at = (gx * grid + gy) * grid + gz;
            box[0][j] = __ldg(grids + at);
            box[1][j] = __ldg(grids + g3 + at);
            box[2][j] = __ldg(grids + g3 + g3 + at);
        }
    }
    __syncthreads();
    if (!live) return;
    if (!boxed) {
        out[i] = gather_global<ORDER>(grids, cc, q, grid, PERIODIC);
        return;
    }
    float wx[ORDER], wy[ORDER], wz[ORDER];
    axis_weights<ORDER>(q.x, wx);
    axis_weights<ORDER>(q.y, wy);
    axis_weights<ORDER>(q.z, wz);
    const int at0 = ((cu.x - v[0]) * ey + cu.y - v[1]) * ez + cu.z - v[2];  // the stencil's first cell in the box
    float ax = 0.f, ay = 0.f, az = 0.f;
#pragma unroll
    for (int a = 0; a < ORDER; ++a) {
#pragma unroll
        for (int b = 0; b < ORDER; ++b) {
            const float wab = __fmul_rn(wx[a], wy[b]);
            const int row = at0 + (a * ey + b) * ez;
#pragma unroll
            for (int d = 0; d < ORDER; ++d) {
                const float w = __fmul_rn(wab, wz[d]);
                ax = fmaf(box[0][row + d], w, ax);
                ay = fmaf(box[1][row + d], w, ay);
                az = fmaf(box[2][row + d], w, az);
            }
        }
    }
    out[i] = make_float4(ax, ay, az, 0.f);
}

template <int ORDER>
int launch(const float* g, const int4* c, const float4* fm, float4* out, int n, int grid, int periodic, int boxes,
           int* paths, cudaStream_t s) {
    const dim3 blocks(static_cast<unsigned>((n + kThreads - 1) / kThreads));
    if (!boxes) {
        mesh_gather_kernel<ORDER><<<blocks, kThreads, 0, s>>>(g, c, fm, out, n, grid, periodic, paths);
    } else if (periodic) {
        mesh_gather_box_kernel<ORDER, true><<<blocks, kThreads, 0, s>>>(g, c, fm, out, n, grid, paths);
    } else {
        mesh_gather_box_kernel<ORDER, false><<<blocks, kThreads, 0, s>>>(g, c, fm, out, n, grid, paths);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grids (3, grid^3) f32, c (n, 4) int32, fm (n, 4) f32 (m not read), out (n, 4);
// periodic != 0: stencil indices wrap mod grid.  boxes != 0: the rows come
// in Morton order (the runs' boxes in shared memory); 0: the loop alone.
// paths: null or two int32 counters, the blocks on path 0 (the box) and 1
// (global reads).
extern "C" int nb_mesh_gather(const void* grids, const void* c, const void* fm, void* out, int n, int grid,
                              int order, int periodic, int boxes, void* paths, void* stream) {
    if (n <= 0) return static_cast<int>(cudaGetLastError());
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* g = static_cast<const float*>(grids);
    const int4* ci = static_cast<const int4*>(c);
    const float4* f = static_cast<const float4*>(fm);
    float4* o = static_cast<float4*>(out);
    int* p = static_cast<int*>(paths);
    if (order == 3) return launch<3>(g, ci, f, o, n, grid, periodic, boxes, p, s);
    if (order == 2) return launch<2>(g, ci, f, o, n, grid, periodic, boxes, p, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
