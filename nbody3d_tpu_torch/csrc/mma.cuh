// Fast mode's source loop on the bf16 tensor cores, shared by force_fast and
// fused_step_fast.
//
// What it computes (nbody3d_tpu/ops/pallas_force.py::_accum_fast and
// _fast_epilogue): for each target row i, the 16 limb sums
//
//   A[i][c] = sum_j bf16(inv3_ij) * L[j][c],  inv3_ij = rsqrt(d2^3),
//
// with L the (N_s, 16) bf16 limb matrix of the sources (columns 0-8 three
// limbs each of G*m*x, G*m*y, G*m*z; 9-11 three limbs of G*m; 12-15 zero:
// ops/cuda_force.py::src_limbs), and then the acceleration
//
//   a_x = (A0 + A1) + A2 - x_i * s,  s = (A9 + A10) + A11   (y, z alike).
//
// Every operand of the tensor cores is bf16, the gm limbs too: a raw f32 gm
// column rounded by the multiplier would leave w * x * gm * 2^-9 of the
// self-pair cancellation behind (docs/DESIGN.md:40-59).  Only the weights
// are approximate (bf16, round to nearest even, as the MXU rounds them).
//
// The self pair is masked by index, as the TPU kernels do: its weight is
// the softening floor eps2^-3/2 (1e6 at the default), and times a heavy
// body's gm that term fills the f32 accumulator of its row and absorbs
// every real term there.  A pair is a self pair iff col == row + off and
// lo <= row < hi (global indices; Diag).  The single-device path passes
// (0, 0, n), a disjoint source set off = kNoDiag.  Whether a staged tile,
// and then a 16 x 16 chunk of it, can hold a self pair is decided per warp,
// so the mask costs nothing off the diagonal.
//
// Layout: each warp owns 16 target rows and runs
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 twice a chunk of 16
// sources (limb columns 0-7 and 8-15).  A lane computes its 8 weights
// directly in the A-fragment layout: rows g and g+8 (g = lane / 4), source
// columns 2t, 2t+1, 2t+8, 2t+9 (t = lane % 4), two to a bf16x2 register.
// The B fragments come pre-arranged by the wrapper (cuda_force.py::
// fragment_order): one uint4 a lane a chunk, b0 and b1 of each MMA.  A
// block of kWarps warps stages kTileS sources (positions and fragments)
// through shared memory.
//
// Summation.  The tensor cores' f32 accumulation rounds coarser than f32
// adds, and a row's sums can hold terms thousands of times its result (a
// pair closer than the softening length: w ~ eps2^-3/2).  So each chunk's
// MMAs start from zero, a tile's chunk sums are added by round-to-nearest
// f32 adds, and each tile's sum joins the running total through TwoSum, the
// rounding error kept in a second register.  Chaining the MMAs instead, as
// the TPU kernel chains a block's dot, loses far more of a near-coincident
// pair's acceleration on an H100 (PERF.md, section 6).
//
// What the loop issues a pair: the separation (3 FADD), d2 (3 FFMA), d2^3
// (2 FMUL), the rsqrt (one MUFU; the ftz form where eps2^3 is normal,
// pair.cuh, so without rsqrtf's subnormal guard), half a bf16x2 pack, one
// f32 add of the chunk sums, five eighths of an LDS.128 (four positions
// and a B fragment serve a lane's 8 pairs) and a quarter of an HMMA.  The
// self-pair test runs only in the staged tiles that the diagonal crosses
// (a warp-uniform branch a tile), so the loop off the diagonal carries no
// test.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pair.cuh"

namespace fast {

constexpr int kWarps = 4;           // warps a block, 16 target rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // target rows a block
constexpr int kTileS = 128;         // sources a shared-memory tile (the TwoSum group)
constexpr int kChunks = kTileS / 16;

struct Diag {
    int off, lo, hi;
};

struct Smem {
    float4 pos[kTileS];
    uint4 frag[kChunks][32];
    float acc[kWarps][16][17];  // the epilogue's (16, 16) accumulator, padded
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

// c += A (16 x 16 bf16, row) * B (16 x 8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// s + e += a with the rounding error of s + a kept in e (Knuth's TwoSum).
__device__ __forceinline__ void two_sum_into(float& s, float& e, float a) {
    const float t = __fadd_rn(s, a);
    const float v = __fsub_rn(t, s);
    e = __fadd_rn(e, __fadd_rn(__fsub_rn(s, __fsub_rn(t, v)), __fsub_rn(a, v)));
    s = t;
}

// kNormal: eps2^3 is a normal float (sym_pairs::normal_cubes), so the ftz
// rsqrt gives rsqrtf's bits.
template <bool kNormal>
__device__ __forceinline__ float weight(float4 s, float4 t, float eps2) {
    return kNormal ? pair_inv3_normal(s.x - t.x, s.y - t.y, s.z - t.z, eps2)
                   : pair_inv3(s.x - t.x, s.y - t.y, s.z - t.z, eps2);
}

// One staged tile's first nk chunks into tile (sums from zero) for the
// lane's target rows tg (r0 + g) and tg8 (r0 + g + 8).  kDiag: the diagonal
// crosses this tile, so each chunk it crosses tests its self pairs: column
// col of row rg is one iff col - rg == dg.off and dg.lo <= rg < dg.hi.
template <bool kNormal, bool kDiag>
__device__ __forceinline__ void tile_chunks(const Smem& sm, float4 tg, float4 tg8, float eps2, Diag dg, int r0,
                                            int base, int nk, int cdlo, int cdhi, float (&tile)[2][4]) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rg = r0 + g, rg8 = r0 + g + 8;
    const bool in_g = rg >= dg.lo && rg < dg.hi, in_g8 = rg8 >= dg.lo && rg8 < dg.hi;
#pragma unroll 2
    for (int k = 0; k < nk; ++k) {
        const int j = 16 * k + 2 * t;  // the lane's first source column in the tile
        float w[2][4];                  // [row g, g+8][column 2t, 2t+1, 2t+8, 2t+9]
        const int cols[4] = {j, j + 1, j + 8, j + 9};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float4 s = sm.pos[cols[q]];
            w[0][q] = weight<kNormal>(s, tg, eps2);
            w[1][q] = weight<kNormal>(s, tg8, eps2);
        }
        const int c0 = base + 16 * k;
        if (kDiag && c0 < cdhi && c0 + 16 > cdlo) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int col = base + cols[q];
                if (in_g && col - rg == dg.off) w[0][q] = 0.f;
                if (in_g8 && col - rg8 == dg.off) w[1][q] = 0.f;
            }
        }
        const uint32_t a0 = pack_bf16(w[0][0], w[0][1]);
        const uint32_t a1 = pack_bf16(w[1][0], w[1][1]);
        const uint32_t a2 = pack_bf16(w[0][2], w[0][3]);
        const uint32_t a3 = pack_bf16(w[1][2], w[1][3]);
        const uint4 b = sm.frag[k][lane];
        float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // each chunk's MMAs from zero
        mma_bf16(d[0], a0, a1, a2, a3, b.x, b.y);
        mma_bf16(d[1], a0, a1, a2, a3, b.z, b.w);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int i = 0; i < 4; ++i) tile[nb][i] = __fadd_rn(tile[nb][i], d[nb][i]);
    }
}

// The limb sums of rows [r0, r0 + 16) of the calling warp against sources
// [0, n_s), into tot[n-block][C fragment].  Every thread of the block calls
// it (it stages tiles and synchronises); tg and tg8 are the lane's target
// rows r0 + g and r0 + g + 8 (zeros past the end).
template <bool kNormal>
__device__ __forceinline__ void limb_sums(const float4* __restrict__ src, const uint4* __restrict__ frag, int n_s,
                                          float eps2, Diag dg, int r0, float4 tg, float4 tg8, Smem& sm,
                                          float (&tot)[2][4]) {
    const int n_chunks = (n_s + 15) / 16;
    // The source columns the diagonal takes in this warp's rows.
    long long dlo = static_cast<long long>(max(r0, dg.lo)) + dg.off;
    long long dhi = static_cast<long long>(min(r0 + 16, dg.hi)) + dg.off;
    dlo = dlo < 0 ? 0 : dlo;
    dhi = dhi > n_s ? n_s : dhi;
    const bool has_diag = dlo < dhi;
    const int cdlo = has_diag ? static_cast<int>(dlo) : 0;
    const int cdhi = has_diag ? static_cast<int>(dhi) : 0;
    float err[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) tot[nb][i] = err[nb][i] = 0.f;

    for (int base = 0; base < n_s; base += kTileS) {
        for (int i = threadIdx.x; i < kTileS; i += kThreads) {
            const int s = base + i;
            sm.pos[i] = s < n_s ? src[s] : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        for (int i = threadIdx.x; i < kChunks * 32; i += kThreads) {
            const int c = base / 16 + i / 32;
            sm.frag[i / 32][i % 32] = c < n_chunks ? frag[c * 32 + i % 32] : make_uint4(0, 0, 0, 0);
        }
        __syncthreads();
        float tile[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const int nk = min(kChunks, (n_s - base + 15) / 16);
        if (has_diag && base < cdhi && base + kTileS > cdlo)  // warp-uniform
            tile_chunks<kNormal, true>(sm, tg, tg8, eps2, dg, r0, base, nk, cdlo, cdhi, tile);
        else
            tile_chunks<kNormal, false>(sm, tg, tg8, eps2, dg, r0, base, nk, cdlo, cdhi, tile);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int i = 0; i < 4; ++i) two_sum_into(tot[nb][i], err[nb][i], tile[nb][i]);
        __syncthreads();
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) tot[nb][i] = __fadd_rn(tot[nb][i], err[nb][i]);
}

// _fast_epilogue for one row: lane l < 16 of the warp gets row r0 + l's
// acceleration from the warp's accumulator fragments, with p the row's
// position.  Explicit roundings: no operation contracts, as in the twin.
__device__ __forceinline__ float3 epilogue_row(const float (&tot)[2][4], Smem& sm, float4 p) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    float(*a)[17] = sm.acc[warp];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
        a[g][8 * nb + 2 * t] = tot[nb][0];
        a[g][8 * nb + 2 * t + 1] = tot[nb][1];
        a[g + 8][8 * nb + 2 * t] = tot[nb][2];
        a[g + 8][8 * nb + 2 * t + 1] = tot[nb][3];
    }
    __syncwarp();
    const float* r = a[lane & 15];
    const float s = __fadd_rn(__fadd_rn(r[9], r[10]), r[11]);
    const float ax = __fsub_rn(__fadd_rn(__fadd_rn(r[0], r[1]), r[2]), __fmul_rn(p.x, s));
    const float ay = __fsub_rn(__fadd_rn(__fadd_rn(r[3], r[4]), r[5]), __fmul_rn(p.y, s));
    const float az = __fsub_rn(__fadd_rn(__fadd_rn(r[6], r[7]), r[8]), __fmul_rn(p.z, s));
    return make_float3(ax, ay, az);
}

__device__ __forceinline__ float4 row_or_zero(const float4* __restrict__ rows, int i, int n) {
    return i < n ? rows[i] : make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace fast
