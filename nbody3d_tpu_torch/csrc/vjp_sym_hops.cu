// vjp_sym_hops: the off-diagonal tile pairs of the Newton-3 force VJP.
//
// Replaces: nbody3d_tpu/ops/force_vjp.py::_vjp_sym_hops_kernel (reached by
// force_vjp_sym_pallas's hop calls).
//
// What it computes: for every unordered tile pair (i, j = (i + k) mod nt)
// of one launch, each pair's terms once (pair.cuh), then both sides:
//   target row (tile i):  x̄ += t,  m̄ += mbar_t,  φ += phi_t + phi_s
//   source row (tile j):  x̄ -= t,  m̄ += mbar_s
// into acc_hop (N, 8) per unit G, rows [x̄(3), m̄, φ, 0, 0, 0].  The pair's
// x̄ term is antisymmetric (d and g change sign, w and d.g do not), the
// reason one evaluation serves both rows.  φ matters only through its sum
// Ḡ, so the source side's φ lands in the target row: per row, φ is not
// A.F, but the sum over rows is; the pair's two φ terms are taken as one,
// phi_t + phi_s = -w (d.g) (pair.cuh), one product where they were four.
// The launches cover the pair sets of vjp_sym_hops_plain / sym_hops: call B
// takes k = 1..half-1 for even nt (1..half for odd nt) over all nt tiles;
// call C, even nt only, takes the half hop k = nt/2 over tiles i < nt/2.
//
// What the GPU version does not copy: the TPU kernel ran six MXU
// contractions a block pair (three forward dots, two TN reverse dots,
// each on bf16 limb planes) and carried an (nt, 16, B) reverse
// accumulator across its sequential grid in VMEM.
//
// What bounds it on an H100: FP32 issue.  Per unordered pair about 61 FP32
// FLOP (~40 instructions) and one MUFU rsqrt over N^2/2 pairs; the loop adds
// the warp reductions' shuffles and adds (four values a source) and the
// shared loads.  Global memory sees one float4 atomic a source row and tile
// and two atomics a target row and run.
//
// What the first design lost: one block took one tile pair with one thread
// a target row, read each source as seven scalars from SoA shared arrays
// and added its four reverse terms with four shared-memory float
// atomicAdds, which compile to compare-and-swap retry loops: ~118
// instructions a pair for ~61 FLOP (0.258 of the FP32 bound).
//
// Design: sym_pairs.cuh's schedule and pattern.  A block takes target tile
// i and a run of up to kRun consecutive hops of its launch (ops/launch.py
// hop_blocks), a thread kRows target rows (their positions, masses and
// cotangents in registers).  Each source tile is staged in shared memory as
// two float4 planes, [x, y, z, m] and [Ā, 0], padded with zero rows to whole
// groups (a zero row adds nothing on either side); a pair reads its source
// as two broadcast float4 loads shared by kRows pairs.  The forward sums
// (x̄, m̄, φ) of each source tile go to their own partial first, then to
// the row's total for the run (the 1e7 body's summation, as in
// sym_pairs.cuh), and reach global memory once a run.  The reverse terms
// (-t and mbar_s) of a group of kGroup sources stay in registers, the kRows
// rows of a lane already summed, and reduce8 sums each of the four over the
// warp; lanes 0-7, 8-15, 16-23 and 24-31 write x̄, ȳ, z̄ and m̄ of the
// group's sources to the warp's slab.  After a tile the block sums the
// slabs and sends one float4 atomicAdd a source row.  No atomic in the pair
// loop.  The next tile's rows are fetched into registers while this one is
// swept.  Atomics make the f32 sum order vary from run to run: results
// agree with the plain version to f32 reduction-order tolerance, not bit
// for bit.
//
// The constants were chosen on an H100 (PERF.md section 6): 4 rows a
// thread against 2, the prefetch against none, at 255 registers (a
// thread's rows, cotangents, partials, reverse terms and the prefetched
// tile; 8 warps an SM) against a cap of 128, which spills.  Where eps2 >=
// FLT_MIN the pair takes the ftz rsqrt (vjp_pair<true>, the same bits):
// 3 instructions a pair fewer, 5.5% of the kernel's time (chip_smoke.py
// --parent times both instances in turns).
#include <cfloat>

#include <cuda_runtime.h>

#include "pair.cuh"
#include "sym_pairs.cuh"

namespace {

using sym_pairs::kGroup;
using sym_pairs::kRun;

constexpr int kRows = 4;    // target rows a thread
constexpr int kPlanes = 2;  // float4 rows a source row: [x, y, z, m], [Ā, 0]
constexpr int kComps = 4;   // reverse sums a source row: x̄ (3) and m̄

__host__ __device__ constexpr int threads_for(int b) { return sym_pairs::threads_for(b, kRows); }

inline size_t smem_bytes(int b) { return sym_pairs::smem_bytes(b, kPlanes, kComps, kRows); }

// This thread's rows t + u T of a tile (positions and cotangents), zero past b.
__device__ __forceinline__ void fetch(float4 (&x)[kRows], float4 (&a)[kRows], const float4* __restrict__ pm,
                                      const float4* __restrict__ abar, long long rows, int b) {
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
        const int s = threadIdx.x + u * blockDim.x;
        const bool in = s < b;
        x[u] = in ? pm[rows + s] : make_float4(0.f, 0.f, 0.f, 0.f);
        a[u] = in ? abar[rows + s] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

template <bool kNormal>
__global__ void __launch_bounds__(threads_for(1024))
vjp_sym_hops_kernel(const float4* __restrict__ pm, const float4* __restrict__ abar, float* __restrict__ acc,
                    int nt, int b, int k0, int nk, float eps2) {
    extern __shared__ float4 sh[];
    const int bp = sym_pairs::padded(b);
    float4* sx = sh;
    float4* sa = sh + bp;
    float* slab = reinterpret_cast<float*>(sh + kPlanes * bp);
    const int t = threadIdx.x;
    const int nthr = blockDim.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int nwarps = nthr >> 5;
    const int perm = lane & 7;
    const int i = blockIdx.x;
    const int first = k0 + static_cast<int>(blockIdx.y) * kRun;
    const int n_run = min(kRun, k0 + nk - first);
    const auto rows_of = [=](int c) {
        const int j = i + first + c;
        return static_cast<long long>(j >= nt ? j - nt : j) * b;
    };
    const long long rows_i = static_cast<long long>(i) * b;

    float4 me[kRows], a4[kRows];
    fetch(me, a4, pm, abar, rows_i, b);
    float3 ak[kRows];
    float fx[kRows], fy[kRows], fz[kRows], fm[kRows], fphi[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        ak[r] = make_float3(a4[r].x, a4[r].y, a4[r].z);
        fx[r] = fy[r] = fz[r] = fm[r] = fphi[r] = 0.f;
    }
    float4 nx[kRows], na[kRows];
    long long j_rows = rows_of(0);
    fetch(nx, na, pm, abar, j_rows, b);

    for (int c = 0; c < n_run; ++c) {
        const long long rows_c = j_rows;
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
            const int s = t + u * nthr;
            if (s < bp) {
                sx[s] = nx[u];
                sa[s] = na[u];
            }
        }
        __syncthreads();
        if (c + 1 < n_run) {
            j_rows = rows_of(c + 1);
            fetch(nx, na, pm, abar, j_rows, b);
        }

        float tx[kRows], ty[kRows], tz[kRows], tm[kRows], tphi[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) tx[r] = ty[r] = tz[r] = tm[r] = tphi[r] = 0.f;
        for (int g0 = 0; g0 < bp; g0 += kGroup) {
            float rx[kGroup], ry[kGroup], rz[kGroup], rm[kGroup];
#pragma unroll
            for (int q = 0; q < kGroup; ++q) {
                const int s = g0 + (q ^ perm);
                const float4 xj = sx[s];
                const float4 aj = sa[s];
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    const VjpPair e = vjp_pair<kNormal>(me[r], ak[r], xj, make_float3(aj.x, aj.y, aj.z), eps2);
                    tx[r] += e.tx;
                    ty[r] += e.ty;
                    tz[r] += e.tz;
                    tm[r] += e.mbar_t;
                    tphi[r] += e.phi;
                    if (r == 0) {
                        rx[q] = -e.tx;
                        ry[q] = -e.ty;
                        rz[q] = -e.tz;
                        rm[q] = e.mbar_s;
                    } else {
                        rx[q] -= e.tx;
                        ry[q] -= e.ty;
                        rz[q] -= e.tz;
                        rm[q] += e.mbar_s;
                    }
                }
            }
            const float sx_ = sym_pairs::reduce8(rx);
            const float sy_ = sym_pairs::reduce8(ry);
            const float sz_ = sym_pairs::reduce8(rz);
            const float sm_ = sym_pairs::reduce8(rm);
            // Lanes 0-7 write x̄, 8-15 ȳ, 16-23 z̄, 24-31 m̄ of sources g0 + (lane & 7).
            const int comp = lane >> 3;
            slab[(warp * kComps + comp) * bp + g0 + perm] =
                comp == 0 ? sx_ : (comp == 1 ? sy_ : (comp == 2 ? sz_ : sm_));
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            fx[r] += tx[r];
            fy[r] += ty[r];
            fz[r] += tz[r];
            fm[r] += tm[r];
            fphi[r] += tphi[r];
        }
        __syncthreads();
        // The tile's reverse sums: the warps' slabs summed, one float4
        // atomicAdd a source row ([x̄, m̄] of its acc_hop row).
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
            const int s = t + u * nthr;
            if (s < b) {
                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                for (int w = 0; w < nwarps; ++w) {
                    v.x += slab[(w * kComps + 0) * bp + s];
                    v.y += slab[(w * kComps + 1) * bp + s];
                    v.z += slab[(w * kComps + 2) * bp + s];
                    v.w += slab[(w * kComps + 3) * bp + s];
                }
                atomicAdd(reinterpret_cast<float4*>(acc + (rows_c + s) * 8), v);
            }
        }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int s = t + r * nthr;
        if (s < b) {
            float* row = acc + (rows_i + s) * 8;
            atomicAdd(reinterpret_cast<float4*>(row), make_float4(fx[r], fy[r], fz[r], fm[r]));
            atomicAdd(row + 4, fphi[r]);
        }
    }
}

}  // namespace

// One launch: tile rows i = 0..grid_i-1 against hops k = k0..k0+nk-1, in
// `runs` blocks a row (ops/launch.py hop_blocks; refused unless it is
// sym_pairs::runs_for(nk)); acc_hop (N, 8) zeroed by the caller.
extern "C" int nb_vjp_sym_hops(const void* pm, const void* abar, void* acc_hop, int nt, int b, int k0, int nk,
                               int grid_i, int runs, float eps2, void* stream) {
    if (grid_i > 0 && nk > 0) {
        if (runs != sym_pairs::runs_for(nk) || runs > 65535) return static_cast<int>(cudaErrorInvalidValue);
        const size_t smem = smem_bytes(b);
        const auto kernel = eps2 >= FLT_MIN ? vjp_sym_hops_kernel<true> : vjp_sym_hops_kernel<false>;
        const cudaError_t e = sym_pairs::allow_smem(kernel, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        const dim3 grid(grid_i, runs);
        kernel<<<grid, threads_for(b), smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(pm), static_cast<const float4*>(abar), static_cast<float*>(acc_hop), nt, b,
            k0, nk, eps2);
    }
    return static_cast<int>(cudaGetLastError());
}
