// The source loop and the combine that force_exact.cu and fused_exact.cu
// share, so the two kernels' forces are the same bits.
//
// What it computes, for each target row i of a block and the sources j of
// its range (both [x, y, z, m] f32, G folded into the source mass as the
// tile is staged):
//   a_i = sum_j G m_j * rsqrt(d2^3) * (x_j - x_i),  d2 = |x_j - x_i|^2 + eps2
// No self mask: the self pair's separation is exactly zero.  Sources past
// n_s are staged as massless rows at the origin and add nothing.
//
// What bounds it on an H100: per pair 3 FADD, 3 FFMA (d2), 2 FMUL (d2^3),
// one MUFU rsqrt, 1 FMUL (w) and 3 FFMA (the sums): 12 FP32 issue slots and
// a MUFU (16 results a clock an SM, 8 of a scheduler's cycles a warp), never
// memory.  On the card that mix stops near 1.8e12 pairs/s, ~70% of the issue
// rate: a synthetic loop of 12 FFMA and one MUFU.RSQ a step, 8 independent
// chains a thread and every warp resident, ran 1.79e12 steps/s (PERF.md
// section 6).
//
// Design.
//   * A thread holds kRows = 2 target rows (t, t + T for T = kThreads) in
//     registers, so one broadcast float4 read of a staged source serves 2
//     pairs.  Measured on an H100 against 1, 4 and 8 rows and unrolls of 1
//     to 8 (PERF.md section 6): 4 rows issue fewer instructions a
//     pair but give each SM fewer warps to hide the MUFU and FFMA latencies,
//     and ran slower at both the sphere's 262,144 and two-galaxy's 40,192.
//   * The block stages kTile = 128 sources at a time through shared memory,
//     fetching the next tile into a register while it sweeps this one.
//     Each tile's terms are summed into their own partial in source order,
//     then the row's running total takes the partial: one sequential f32
//     sum over all 40k sources of the two-galaxy run measured 3.0e-5
//     max-abs/scale against the plain twin on an H100, above the 1e-5
//     bound, because a central body's term dwarfs the rest of its row.
//   * Where eps2^3 is a normal float (sym_pairs::normal_cubes) the loop
//     takes pair_inv3_normal, the same bits as pair_inv3 without rsqrtf's
//     subnormal guard (3 FP32 instructions a pair); the caller picks the
//     instance at launch time.
//   * Where the row blocks alone cannot fill the card (two-galaxy: 157
//     blocks of 256 rows for 132 SMs), S = `split` CTAs take the same rows,
//     each over a contiguous, ordered range of source tiles (range_start),
//     launched as a thread-block cluster of S CTAs.  After cluster.sync()
//     each CTA combines a share of the rows from the S partial totals in
//     distributed shared memory in rank order, ((P0 + P1) + P2) ...: one
//     launch, no atomics, a fixed order.  S is ops/launch.py's exact_split;
//     with S = 1 a thread writes its own rows and the sum is, term for term,
//     the first design's (one row a thread, pair.cuh's pair_inv3), so its
//     bits are that kernel's.
// Every operation is an explicit fmaf, add, multiply or rsqrt with nothing
// for nvcc to contract (a product feeds only a multiply or an fmaf's
// product), so two kernels that run this loop get the same bits.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pair.cuh"

namespace exact {

constexpr int kTile = 128;                     // sources a staged tile (a partial sum each)
constexpr int kThreads = kTile;                // threads a block: one staged source each
constexpr int kRows = 2;                       // target rows a thread
constexpr int kBlockRows = kRows * kThreads;   // target rows a block (ops/launch.py EXACT_ROWS)
constexpr int kMaxSplit = 8;                   // the portable cluster size (EXACT_MAX_SPLIT)

// Blocks of kBlockRows rows for n rows.
inline int row_blocks(int n) { return (n + kBlockRows - 1) / kBlockRows; }

// First source tile of rank r of `split` over n_tiles tiles; rank r takes
// [range_start(r), range_start(r + 1)) (ops/launch.py source_ranges).
__device__ __forceinline__ int range_start(int r, int n_tiles, int split) {
    return static_cast<int>(static_cast<long long>(r) * n_tiles / split);
}

__device__ __forceinline__ float4 staged_row(const float4* __restrict__ src, int s, int n_s, float G) {
    float4 q = s < n_s ? src[s] : make_float4(0.f, 0.f, 0.f, 0.f);
    q.w = G * q.w;
    return q;
}

// The positions of this thread's rows of the block at row0 (zero past n).
__device__ __forceinline__ void load_rows(const float4* __restrict__ rows, int row0, int n,
                                          float3 (&me)[kRows]) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int row = row0 + threadIdx.x + r * kThreads;
        const float4 p = row < n ? rows[row] : make_float4(0.f, 0.f, 0.f, 0.f);
        me[r] = make_float3(p.x, p.y, p.z);
    }
}

// The pull on the thread's rows `me` from source tiles [lo, hi) of src.
// Every thread of the block calls it; `tile` holds kTile float4.
template <bool kNormal>
__device__ __forceinline__ void pull(const float4* __restrict__ src, int n_s, int lo, int hi, float G,
                                     float eps2, const float3 (&me)[kRows], float3 (&acc)[kRows],
                                     float4* tile) {
    const int t = threadIdx.x;
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = make_float3(0.f, 0.f, 0.f);
    float4 next = staged_row(src, lo * kTile + t, n_s, G);
    for (int c = lo; c < hi; ++c) {
        tile[t] = next;
        __syncthreads();
        if (c + 1 < hi) next = staged_row(src, (c + 1) * kTile + t, n_s, G);
        float tx[kRows], ty[kRows], tz[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) tx[r] = ty[r] = tz[r] = 0.f;
#pragma unroll 4
        for (int j = 0; j < kTile; ++j) {
            const float4 p = tile[j];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                const float dx = p.x - me[r].x;
                const float dy = p.y - me[r].y;
                const float dz = p.z - me[r].z;
                const float w = p.w * (kNormal ? pair_inv3_normal(dx, dy, dz, eps2) : pair_inv3(dx, dy, dz, eps2));
                tx[r] = fmaf(w, dx, tx[r]);
                ty[r] = fmaf(w, dy, ty[r]);
                tz[r] = fmaf(w, dz, tz[r]);
            }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            acc[r].x += tx[r];
            acc[r].y += ty[r];
            acc[r].z += tz[r];
        }
        __syncthreads();
    }
}

// The block's rows at row0 (n rows in all) pulled by rank `rank` of
// `split`'s source range; `tile` kTile float4 of shared memory.
template <bool kNormal>
__device__ __forceinline__ void pull_share(const float4* __restrict__ rows, int row0, int n,
                                           const float4* __restrict__ src, int n_s, int rank, int split,
                                           float G, float eps2, float3 (&acc)[kRows], float4* tile) {
    float3 me[kRows];
    load_rows(rows, row0, n, me);
    const int n_tiles = (n_s + kTile - 1) / kTile;
    pull<kNormal>(src, n_s, range_start(rank, n_tiles, split), range_start(rank + 1, n_tiles, split), G, eps2,
                  me, acc, tile);
}

// Hands each row of the block at row0 below n, with its total force, to
// emit(row, a) once.  split == 1: each thread its own rows from `acc`.
// Otherwise the block is rank `rank` of a cluster of `split`: every CTA
// writes its partials to `part` (kBlockRows float4 of shared memory), and
// CTA r sums a share of the rows over the S ranks' `part` in rank order.
template <class Emit>
__device__ __forceinline__ void finish(const float3 (&acc)[kRows], int row0, int n, int rank, int split,
                                       float4* part, Emit emit) {
    const int t = threadIdx.x;
    if (split == 1) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
            if (row0 + t + r * kThreads < n) emit(row0 + t + r * kThreads, acc[r]);
        return;
    }
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[t + r * kThreads] = make_float4(acc[r].x, acc[r].y, acc[r].z, 0.f);
    cluster.sync();
    const int share = (kBlockRows + split - 1) / split;
    for (int i = t; i < share; i += kThreads) {
        const int local = rank * share + i;
        if (local >= kBlockRows || row0 + local >= n) break;
        float4 s = cluster.map_shared_rank(part, 0)[local];
        for (int q = 1; q < split; ++q) {
            const float4 p = cluster.map_shared_rank(part, q)[local];
            s.x = __fadd_rn(s.x, p.x);
            s.y = __fadd_rn(s.y, p.y);
            s.z = __fadd_rn(s.z, p.z);
        }
        emit(row0 + local, make_float3(s.x, s.y, s.z));
    }
    // No CTA leaves while another may still read its partials.
    cluster.sync();
}

// Launches kernel over n rows with `split` CTAs a row block, a cluster of
// `split` where it is more than 1.  The kernel's rank is blockIdx.x % split.
template <class... Params, class... Args>
inline cudaError_t launch(void (*kernel)(Params...), int n, int split, cudaStream_t stream, Args... args) {
    if (split < 1 || split > kMaxSplit) return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(row_blocks(n) * split);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = split > 1 ? 1 : 0;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace exact
