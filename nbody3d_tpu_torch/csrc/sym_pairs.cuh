// The Newton-3 pair loop that sym_hops.cu and pair_sym.cu share: one target
// tile against a run of source tiles, both directions of each pair from one
// weight, with no atomic inside the pair loop.  vjp_sym_hops.cu runs the
// same schedule and pattern on the VJP's pair terms with the helpers here
// (threads_for, padded, smem_bytes, allow_smem, reduce8, kRun, kGroup).
//
// What it computes, for the target tile's rows i and each source tile's
// rows j (both [x, y, z, m] f32; the caller's G scales both masses):
//   acc_t[i] +=  G m_j inv3 (x_j - x_i)
//   acc_s[j] += -G m_i inv3 (x_j - x_i)
//   inv3 = rsqrt(d2^3),  d2 = |x_j - x_i|^2 + eps2   (pair.cuh::pair_inv3)
//
// The block schedule (which target tile and which run of source tiles each
// block takes) is ops/launch.py's sym_runs / hop_blocks; kRun there is
// SYM_RUN, and the C entry points refuse a grid sized for another run.
//
// Design.  A thread holds kRows = 4 target rows (t, t + T, ... for T
// threads) in registers; a warp's 32 lanes hold 128 rows.  Each source tile is
// staged once in shared memory as float4 [x, y, z, G m], padded with
// massless rows to a multiple of kGroup.  A warp sweeps the tile in groups
// of kGroup = 8 sources:
//   * the forward sum of each target row stays in registers: each source
//     tile's terms are summed into their own partial first, then added to
//     the row's running total (the summation that pair.cuh::all_pairs_pull
//     needs for a 1e7 body), and the total goes to global memory once a run;
//   * the reverse terms of the group stay in registers, 3 x 8 a lane, the
//     4 rows of a lane already summed (one float4 load serves 4 pairs);
//   * at the end of the group a reduce-scatter butterfly (reduce8) sums the
//     24 values over the warp's 32 lanes with 27 shuffles, and the warp
//     writes each source's total to its own slab of shared memory.
// Lane l visits the group's sources in the order q ^ (l & 7): the eight
// lanes of a quarter warp read eight distinct 16-byte rows (one 128-byte
// line, no bank conflict), and each butterfly stage keeps the lower half
// of its values and sends the upper half, with no select.  After a tile the
// block sums the warps' slabs and sends one float4 atomicAdd a source row.
// So a block makes b float4 global atomics a source tile and b a run, and
// none inside the pair loop.  Where eps2^3 is a normal float (normal_cubes)
// the kernels take pair_inv3_normal, the same bits without rsqrtf's
// subnormal guard.
//
// The constants were chosen on an H100 (PERF.md section 6): 2 rows a thread
// issue 23.2 instructions a pair against 4 rows' 20.4; 8 rows take 196
// registers (10 one-warp blocks an SM) or spill at 128; runs of 4, 8 and 16
// tiles time alike, and 8 keeps every main-path grid above 132 SMs' worth.
#pragma once

#include <cfloat>

#include <cuda_runtime.h>

#include "pair.cuh"

namespace sym_pairs {

constexpr int kRows = 4;   // target rows a thread
constexpr int kGroup = 8;  // sources between two warp reductions (reduce8 is written for 8)
constexpr int kRun = 8;    // source tiles a block takes (ops/launch.py SYM_RUN)
constexpr unsigned kAll = 0xffffffffu;

// Threads for a tile of b target rows: `rows` rows each, whole warps.
__host__ __device__ constexpr int threads_for(int b, int rows = kRows) { return ((b + rows - 1) / rows + 31) / 32 * 32; }

// Threads of the largest tile, b = 1024: the kernels' launch bound.
constexpr int kMaxThreads = threads_for(1024);

// Whether every pair's d2^3 is a normal float: d2 >= eps2, so d2 * (d2 * d2)
// >= eps2 * (eps2 * eps2) in f32 too.  Then pair_inv3_normal gives
// pair_inv3's bits.
inline bool normal_cubes(float eps2) { return eps2 * (eps2 * eps2) >= FLT_MIN; }

// Rows of the staged source tile: b padded to whole groups.
__host__ __device__ constexpr int padded(int b) { return (b + kGroup - 1) / kGroup * kGroup; }

// Blocks along the run axis for n source tiles, the last run cut short.
__host__ __device__ constexpr int runs_for(int n) { return (n + kRun - 1) / kRun; }

// Dynamic shared memory: the staged tile (`planes` float4 rows a source
// row) and one slab of comps x padded(b) reverse sums a warp, for blocks of
// threads_for(b, rows).
inline size_t smem_bytes(int b, int planes = 1, int comps = 3, int rows = kRows) {
    return static_cast<size_t>(planes) * padded(b) * sizeof(float4) +
           static_cast<size_t>(threads_for(b, rows) / 32) * comps * padded(b) * sizeof(float);
}

// Allows a kernel more than the default 48 KB of dynamic shared memory (a
// sym_hops tile of more than 288 rows needs it, a vjp_sym_hops tile of more
// than 256).
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// v[q] holds this lane's term for source q ^ (lane & 7) of a group.  Returns
// the sum over the warp's 32 lanes of source lane & 7.  Stage xor 4 adds the
// partner's upper half onto the lower half (the partner visits the sources in
// the order q ^ 4 of this lane's), then xor 2 and xor 1 likewise; after them
// lane l holds source l & 7 summed over its 8 lanes, and xor 8 and xor 16 sum
// the four lanes that hold the same source.
__device__ __forceinline__ float reduce8(float (&v)[kGroup]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] += __shfl_xor_sync(kAll, v[q + 4], 4);
#pragma unroll
    for (int q = 0; q < 2; ++q) v[q] += __shfl_xor_sync(kAll, v[q + 2], 2);
    float s = v[0] + __shfl_xor_sync(kAll, v[1], 1);
    s += __shfl_xor_sync(kAll, s, 8);
    s += __shfl_xor_sync(kAll, s, 16);
    return s;
}

__device__ __forceinline__ float4 scaled_row(const float4* __restrict__ rows, int s, int b, float G) {
    if (s >= b) return make_float4(0.f, 0.f, 0.f, 0.f);
    float4 q = rows[s];
    q.w = G * q.w;
    return q;
}

// One block: the b rows of tgt (its target tile) against the source tiles
// tile_of(0), ..., tile_of(n_run - 1) of src, each b rows.  Adds the forward
// sums to acc_t's b rows and the reverse sums to acc_s's rows of each source
// tile.  Every thread of the block calls it; blockDim.x is threads_for(b).
// kNormal: normal_cubes(eps2) holds.
template <bool kNormal, class TileOf>
__device__ __forceinline__ void tile_run(const float4* __restrict__ tgt, float4* __restrict__ acc_t,
                                         const float4* __restrict__ src, float4* __restrict__ acc_s, int b,
                                         int n_run, TileOf tile_of, float G, float eps2) {
    extern __shared__ float4 sh[];
    const int bp = padded(b);
    float4* tile = sh;
    float* slab = reinterpret_cast<float*>(sh + bp);
    const int t = threadIdx.x;
    const int nthr = blockDim.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int nwarps = nthr >> 5;
    const int perm = lane & 7;

    float4 me[kRows];
    float ax[kRows], ay[kRows], az[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        me[r] = scaled_row(tgt, t + r * nthr, b, G);
        ax[r] = ay[r] = az[r] = 0.f;
    }
    // The next source tile, fetched into registers while this one is swept.
    float4 next[kRows];
    long long j_rows = static_cast<long long>(tile_of(0)) * b;
#pragma unroll
    for (int u = 0; u < kRows; ++u) next[u] = scaled_row(src + j_rows, t + u * nthr, b, G);

    for (int c = 0; c < n_run; ++c) {
        const long long rows_c = j_rows;
#pragma unroll
        for (int u = 0; u < kRows; ++u)
            if (t + u * nthr < bp) tile[t + u * nthr] = next[u];
        __syncthreads();
        if (c + 1 < n_run) {
            j_rows = static_cast<long long>(tile_of(c + 1)) * b;
#pragma unroll
            for (int u = 0; u < kRows; ++u) next[u] = scaled_row(src + j_rows, t + u * nthr, b, G);
        }

        float tx[kRows], ty[kRows], tz[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) tx[r] = ty[r] = tz[r] = 0.f;
        for (int g0 = 0; g0 < bp; g0 += kGroup) {
            const float4* grp = tile + g0;
            float rx[kGroup], ry[kGroup], rz[kGroup];
#pragma unroll
            for (int q = 0; q < kGroup; ++q) {
                const float4 p = grp[q ^ perm];
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    const float dx = p.x - me[r].x;
                    const float dy = p.y - me[r].y;
                    const float dz = p.z - me[r].z;
                    const float inv3 =
                        kNormal ? pair_inv3_normal(dx, dy, dz, eps2) : pair_inv3(dx, dy, dz, eps2);
                    const float wf = p.w * inv3;
                    tx[r] = fmaf(wf, dx, tx[r]);
                    ty[r] = fmaf(wf, dy, ty[r]);
                    tz[r] = fmaf(wf, dz, tz[r]);
                    const float wr = me[r].w * inv3;
                    if (r == 0) {
                        rx[q] = wr * dx;
                        ry[q] = wr * dy;
                        rz[q] = wr * dz;
                    } else {
                        rx[q] = fmaf(wr, dx, rx[q]);
                        ry[q] = fmaf(wr, dy, ry[q]);
                        rz[q] = fmaf(wr, dz, rz[q]);
                    }
                }
            }
            const float sx = reduce8(rx);
            const float sy = reduce8(ry);
            const float sz = reduce8(rz);
            // Lanes 0-7 write x, 8-15 y, 16-23 z of sources g0 + (lane & 7).
            const int comp = lane >> 3;
            if (comp < 3) slab[(warp * 3 + comp) * bp + g0 + perm] = comp == 0 ? sx : (comp == 1 ? sy : sz);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            ax[r] += tx[r];
            ay[r] += ty[r];
            az[r] += tz[r];
        }
        __syncthreads();
        // The tile's reverse sums: the warps' slabs summed, one float4
        // atomicAdd a source row (w lane 0).
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
            const int s = t + u * nthr;
            if (s < b) {
                float rx = 0.f, ry = 0.f, rz = 0.f;
                for (int w = 0; w < nwarps; ++w) {
                    rx += slab[(w * 3 + 0) * bp + s];
                    ry += slab[(w * 3 + 1) * bp + s];
                    rz += slab[(w * 3 + 2) * bp + s];
                }
                atomicAdd(acc_s + rows_c + s, make_float4(-rx, -ry, -rz, 0.f));
            }
        }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
        if (t + r * nthr < b) atomicAdd(acc_t + t + r * nthr, make_float4(ax[r], ay[r], az[r], 0.f));
}

}  // namespace sym_pairs
