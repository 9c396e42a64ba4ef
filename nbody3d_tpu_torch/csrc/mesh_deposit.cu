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
// bytes; a 128^3 grid (8 MB) stays in the 50 MB L2, so the least time is
// the particles' bytes plus the grid written once.  Depositing every
// stencil point with a global atomicAdd makes 27 (8) L2 atomics a
// particle, and on Morton-sorted input the 32 lanes of a warp are 32
// neighbours that send each stencil point's atomic to the same few cells
// at once, where they serialise.
//
// Design: a box of the grid per block in shared memory, the JAX kernel's
// tile-local box in the form this card offers.  A block takes a run of 256
// consecutive particles and reduces, over those of nonzero mass, the least
// and greatest base cell per axis and their sum; the stencil adds 1 cell
// each side (TSC) or 1 above (CIC).  On the periodic box each base cell is
// first unwrapped to the image nearest the run's first particle (shifted
// by +-grid when it lies more than grid/2 away), so a run across a seam has
// a small box, and the flush wraps the indices back.
//   - If the run's box holds at most kBoxCap = 4096 cells (16 KB of shared
//     memory, chosen by measurement: PERF.md), every particle deposits into
//     it (path 0).  Morton-sorted rows, P3M's, mostly do.
//   - Otherwise the box is cut to a window of at most kBoxCap cells, as
//     even on its axes as the box allows, centred on the particles' mean
//     cell along the axes it cuts.  The particles whose stencil lies in
//     the window deposit into it, the others with global atomics (path 1).
//     A run of unsorted rows (PM's) from one galaxy has its mean at the
//     core, where global atomics would pile up on few cells.
//   - If fewer than kMinInside particles fall in the window, the block
//     deposits them all with global atomics (path 2): the window would
//     cost more to clear and flush than it saves (a uniform box in random
//     order).
// In the box a warp whose lanes hold at most kMerge = 24 runs of equal base
// cells (Morton order puts a dense cell's particles in neighbouring lanes)
// first sums each stencil point over each run with a segmented shuffle
// reduction, and only the run's first lane adds into shared memory: atomics
// on one shared address serialise.  After __syncthreads each nonzero cell
// of the box goes to rho with one global atomicAdd.  A global deposit
// takes each z-row of the stencil (ORDER neighbouring cells) with one
// 16-byte vector atomicAdd (sm_90) for each aligned group of four cells
// the row touches, the group's other cells adding +0: a CIC particle makes
// 4-8 global atomics instead of 8 and a TSC one 9-18 instead of 27.  With
// paths non-null, thread 0 adds one to its block's path.  The atomics add
// in no fixed order: the result matches the twin to f32 rounding, not bit
// for bit, and sums of exact terms stay exact (adding +0 changes no cell:
// a cell starts at +0 and so never holds -0).
#include <cuda_runtime.h>

#include <climits>

#include "mesh.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBoxCap = 4096;   // cells of the box (floats of shared memory)
constexpr int kMerge = 24;      // the most runs of equal cells in a warp that sum before their shared add
constexpr int kMinInside = 32;  // particles in a window below which the block goes global
// Eight blocks an SM (32 registers a thread), as many as the global path
// had before the box: fewer leave an SM's atomics too few blocks to overlap.
constexpr int kBlocksPerSM = 8;

// The image of periodic cell v nearest to ref: v, v - grid or v + grid.
__device__ __forceinline__ int unwrap(int v, int ref, int grid) {
    const int d = v - ref;
    return d > grid / 2 ? v - grid : (d < -(grid / 2) ? v + grid : v);
}

// v in [-grid, 2 grid) back into [0, grid).
__device__ __forceinline__ int wrap(int v, int grid) { return v < 0 ? v + grid : (v >= grid ? v - grid : v); }

// v[d], or 0 where d is not in [0, ORDER) (unrolled: v stays in registers).
template <int ORDER>
__device__ __forceinline__ float pick(const float* v, int d) {
    float x = 0.f;
#pragma unroll
    for (int e = 0; e < ORDER; ++e) x = d == e ? v[e] : x;
    return x;
}

// rho[k0 : k0 + ORDER] += v with one float4 atomicAdd for each aligned
// group of four cells the row touches; a group past the grid's last cell
// (an odd grid) goes one scalar atomic a cell.  The wrapper keeps grid^3
// below 2^31, so the flat indices fit an int (and keep the registers of
// eight blocks an SM).
template <int ORDER>
__device__ __forceinline__ void add_row(float* __restrict__ rho, int k0, const float* v, int cells) {
    const int s = k0 & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int first = 4 * h - s;  // v's index at the group's first cell
        if (first >= ORDER) break;
        const int g = k0 + first;
        if (g + 3 < cells) {
            atomicAdd(reinterpret_cast<float4*>(rho + g),
                      make_float4(pick<ORDER>(v, first), pick<ORDER>(v, first + 1), pick<ORDER>(v, first + 2),
                                  pick<ORDER>(v, first + 3)));
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (first + j >= 0 && first + j < ORDER) atomicAdd(rho + g + j, pick<ORDER>(v, first + j));
        }
    }
}

// One particle's stencil with global atomics, a z-row at a time (c in
// [0, grid) on the periodic box; a row that wraps there goes one scalar
// atomic a point).
template <int ORDER>
__device__ __forceinline__ void deposit_global(int4 cc, float4 q, float* __restrict__ rho, int grid,
                                               int periodic) {
    float wx[ORDER], wy[ORDER], wz[ORDER];
    axis_weights<ORDER>(q.x, wx);
    axis_weights<ORDER>(q.y, wy);
    axis_weights<ORDER>(q.z, wz);
    int ix[ORDER], iy[ORDER], iz[ORDER];
    axis_cells<ORDER>(cc.x, grid, periodic, ix);
    axis_cells<ORDER>(cc.y, grid, periodic, iy);
    axis_cells<ORDER>(cc.z, grid, periodic, iz);
    const int cells = grid * grid * grid;
    const bool whole = iz[ORDER - 1] == iz[0] + ORDER - 1;  // the z-row does not wrap
#pragma unroll
    for (int a = 0; a < ORDER; ++a) {
        const float ma = q.w * wx[a];
#pragma unroll
        for (int b = 0; b < ORDER; ++b) {
            const float mab = __fmul_rn(ma, wy[b]);
            const int row = (ix[a] * grid + iy[b]) * grid;
            float v[ORDER];
#pragma unroll
            for (int d = 0; d < ORDER; ++d) v[d] = __fmul_rn(mab, wz[d]);
            if (whole) {
                add_row<ORDER>(rho, row + iz[0], v, cells);
            } else {
#pragma unroll
                for (int d = 0; d < ORDER; ++d) atomicAdd(rho + row + iz[d], v[d]);
            }
        }
    }
}

// One particle's stencil into the box (its base cell at flat index `at` of
// the box, extents ey, ez), by every lane of the warp together: `in` says
// whether this lane has a particle there.  With `runs` (warp-uniform) the
// lanes first sum each point over their run of equal `at` (its last lane
// `end`) and the run's first lane adds.
template <int ORDER>
__device__ __forceinline__ void deposit_box(bool in, int at, float4 q, float* box, int ey, int ez, bool runs,
                                            bool head, int end) {
    const int lane = threadIdx.x & 31;
    float wx[ORDER], wy[ORDER], wz[ORDER];
    axis_weights<ORDER>(q.x, wx);
    axis_weights<ORDER>(q.y, wy);
    axis_weights<ORDER>(q.z, wz);
#pragma unroll
    for (int a = 0; a < ORDER; ++a) {
        const float ma = q.w * wx[a];
#pragma unroll
        for (int b = 0; b < ORDER; ++b) {
            const float mab = __fmul_rn(ma, wy[b]);
            float* row = box + at + (a * ey + b) * ez;
#pragma unroll
            for (int d = 0; d < ORDER; ++d) {
                float v = in ? __fmul_rn(mab, wz[d]) : 0.f;
                if (runs) {
#pragma unroll
                    for (int off = 1; off < 32; off <<= 1) {
                        const float t = __shfl_down_sync(0xffffffffu, v, off);
                        if (lane + off <= end) v += t;
                    }
                    if (in && head) atomicAdd(row + d, v);
                } else if (in) {
                    atomicAdd(row + d, v);
                }
            }
        }
    }
}

// Least (v[0:3]), greatest (v[3:6]) and sum (v[6:10]) over the warp, in
// every lane.
__device__ __forceinline__ void warp_reduce(int* v) {
#pragma unroll
    for (int a = 0; a < 10; ++a)
        v[a] = a < 3 ? __reduce_min_sync(0xffffffffu, v[a])
                     : (a < 6 ? __reduce_max_sync(0xffffffffu, v[a]) : __reduce_add_sync(0xffffffffu, v[a]));
}

// The largest k with k^p <= v (p = 2 or 3), v >= 1.
__device__ __forceinline__ int iroot(int v, int p) {
    int k = static_cast<int>(p == 2 ? sqrtf(static_cast<float>(v)) : cbrtf(static_cast<float>(v)));
    while ((p == 2 ? (k + 1) * (k + 1) : (k + 1) * (k + 1) * (k + 1)) <= v) ++k;
    while (k > 0 && (p == 2 ? k * k : k * k * k) > v) --k;
    return k;
}

// A window of at most cap cells in a box of extents e0, e1, e2, as even as
// the box allows: the shortest axes keep their extent while it is below
// the even share, the others share the rest.  Axes rank by extent, ties by
// axis (a stable sort); the window's extents go to w0, w1, w2.
__device__ __forceinline__ void window_extents(int e0, int e1, int e2, int cap, int& w0, int& w1, int& w2) {
    const int lo = e0 <= e1 && e0 <= e2 ? 0 : (e1 <= e2 ? 1 : 2);  // first of the shortest
    const int hi = e2 >= e1 && e2 >= e0 ? 2 : (e1 >= e0 ? 1 : 0);  // last of the longest
    const int mid = 3 - lo - hi;
    const int f0 = lo == 0 ? e0 : (lo == 1 ? e1 : e2), f1 = mid == 0 ? e0 : (mid == 1 ? e1 : e2);
    const int f2 = hi == 0 ? e0 : (hi == 1 ? e1 : e2);
    const int s3 = iroot(cap, 3), rest = cap / f0, s2 = iroot(rest, 2);
    int g0 = f0, g1 = f1, g2 = f2 < rest / f1 ? f2 : rest / f1;
    if (f1 > s2) g1 = g2 = s2;
    if (f0 > s3) g0 = g1 = g2 = s3;
    w0 = lo == 0 ? g0 : (mid == 0 ? g1 : g2);
    w1 = lo == 1 ? g0 : (mid == 1 ? g1 : g2);
    w2 = lo == 2 ? g0 : (mid == 2 ? g1 : g2);
}

template <int ORDER>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
mesh_deposit_kernel(const int4* __restrict__ c, const float4* __restrict__ fm, float* __restrict__ rho,
                    int n, int grid, int periodic, int* __restrict__ paths) {
    __shared__ float box[kBoxCap];
    __shared__ int part[kWarps][10];
    const int tid = threadIdx.x, lane = tid & 31;
    const long long base = static_cast<long long>(blockIdx.x) * kThreads;
    const long long i = base + tid;
    const int4 ref = periodic ? c[base] : make_int4(0, 0, 0, 0);
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    int4 cc = make_int4(0, 0, 0, 0);
    if (i < n) {
        q = fm[i];
        cc = c[i];
    }
    if (periodic) cc.x = unwrap(cc.x, ref.x, grid), cc.y = unwrap(cc.y, ref.y, grid), cc.z = unwrap(cc.z, ref.z, grid);
    const bool live = q.w != 0.f;
    // least x, y, z; greatest x, y, z; sums x, y, z; count
    int v[10] = {live ? cc.x : INT_MAX, live ? cc.y : INT_MAX, live ? cc.z : INT_MAX,
                 live ? cc.x : INT_MIN, live ? cc.y : INT_MIN, live ? cc.z : INT_MIN,
                 live ? cc.x : 0,       live ? cc.y : 0,       live ? cc.z : 0,       live ? 1 : 0};
    warp_reduce(v);
    if (lane == 0) {
#pragma unroll
        for (int a = 0; a < 10; ++a) part[tid >> 5][a] = v[a];
    }
    __syncthreads();
    // Every warp reduces the warps' partials and every thread places the
    // same window: no second barrier before the first atomic.
#pragma unroll
    for (int a = 0; a < 10; ++a) v[a] = lane < kWarps ? part[lane][a] : (a < 3 ? INT_MAX : (a < 6 ? INT_MIN : 0));
    warp_reduce(v);
    const bool any = v[9] > 0;  // a particle of nonzero mass in the run
    int ex = any ? v[3] - v[0] + ORDER : 0, ey = any ? v[4] - v[1] + ORDER : 0, ez = any ? v[5] - v[2] + ORDER : 0;
    int path = 0, wx = any ? v[0] : 0, wy = any ? v[1] : 0, wz = any ? v[2] : 0;
    if (static_cast<long long>(ex) * ey * ez > kBoxCap) {
        path = 1;
        int w0, w1, w2;
        window_extents(ex, ey, ez, kBoxCap, w0, w1, w2);
        // Where the window is shorter than the box, its base cells lie about
        // the run's mean, inside the run's.
        const auto place = [&](int w, int e, int least, int most, int sum) {
            if (w == e) return least;
            const int span = w - ORDER + 1, start = sum / v[9] - span / 2;
            return start < least ? least : (start > most - span + 1 ? most - span + 1 : start);
        };
        wx = place(w0, ex, v[0], v[3], v[6]), wy = place(w1, ey, v[1], v[4], v[7]), wz = place(w2, ez, v[2], v[5], v[8]);
        ex = w0, ey = w1, ez = w2;
    }
    const int lx = cc.x - wx, ly = cc.y - wy, lz = cc.z - wz;
    bool in = live && lx >= 0 && lx <= ex - ORDER && ly >= 0 && ly <= ey - ORDER && lz >= 0 && lz <= ez - ORDER;
    if (path == 1 && __syncthreads_count(in) < kMinInside) path = 2;
    if (paths && tid == 0) atomicAdd(paths + path, 1);
    if (path == 2) in = false;
    const int nc = ex * ey * ez;
    if (path != 2) {
        for (int j = tid; j < nc; j += kThreads) box[j] = 0.f;
        __syncthreads();
    }
    if (live && !in) {
        int4 cw = cc;
        if (periodic) cw.x = wrap(cw.x, grid), cw.y = wrap(cw.y, grid), cw.z = wrap(cw.z, grid);
        deposit_global<ORDER>(cw, q, rho, grid, periodic);
    }
    if (path == 2) return;
    // Runs of equal box cells among the warp's lanes; lanes outside the box
    // each make a run of their own.
    const int at = in ? (lx * ey + ly) * ez + lz : -1 - lane;
    const int prev = __shfl_up_sync(0xffffffffu, at, 1);
    const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || at != prev);
    const unsigned later = lane == 31 ? 0u : heads & (0xffffffffu << (lane + 1));
    const int end = later ? __ffs(later) - 2 : 31;
    const bool runs = __popc(heads) <= kMerge;
    if (__any_sync(0xffffffffu, in)) deposit_box<ORDER>(in, in ? at : 0, q, box, ey, ez, runs, (heads >> lane) & 1u, end);
    __syncthreads();
    const int off = ORDER == 3 ? 1 : 0;  // the box's first cell is the window's least base cell less this
    for (int j = tid; j < nc; j += kThreads) {
        const float s = box[j];
        if (s == 0.f) continue;
        const int bz = j % ez, t = j / ez, by = t % ey, bx = t / ey;
        int gx = wx - off + bx, gy = wy - off + by, gz = wz - off + bz;
        if (periodic) gx = wrap(gx, grid), gy = wrap(gy, grid), gz = wrap(gz, grid);
        atomicAdd(rho + (static_cast<long long>(gx) * grid + gy) * grid + gz, s);
    }
}

template <int ORDER>
int launch(const int4* c, const float4* fm, float* rho, int n, int grid, int periodic, int* paths, cudaStream_t s) {
    const dim3 blocks(static_cast<unsigned>((n + kThreads - 1) / kThreads));
    mesh_deposit_kernel<ORDER><<<blocks, kThreads, 0, s>>>(c, fm, rho, n, grid, periodic, paths);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// c (n, 4) int32 [cx, cy, cz, 0], fm (n, 4) f32 [fx, fy, fz, m], rho (grid^3) zeroed;
// periodic != 0: stencil indices wrap mod grid.  paths: null or three int32
// counters, the blocks of path 0 (the whole box), 1 (a window) and 2 (global
// atomics only).  rho must be 16-byte aligned (the vector atomics).
extern "C" int nb_mesh_deposit(const void* c, const void* fm, void* rho, int n, int grid, int order,
                               int periodic, void* paths, void* stream) {
    if (n <= 0) return static_cast<int>(cudaGetLastError());
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int4* ci = static_cast<const int4*>(c);
    const float4* f = static_cast<const float4*>(fm);
    float* r = static_cast<float*>(rho);
    int* p = static_cast<int*>(paths);
    if (order == 3) return launch<3>(ci, f, r, n, grid, periodic, p, s);
    if (order == 2) return launch<2>(ci, f, r, n, grid, periodic, p, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
