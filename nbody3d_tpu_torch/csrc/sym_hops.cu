// sym_hops: the off-diagonal tile pairs of the fused Newton-3 step.
//
// Replaces: nbody3d_tpu/ops/pallas_force.py::_sym_hops_kernel (reached by
// _sym_hops_raw from sym_verlet_step_pallas).  The TPU-only wrap-tail copy
// _extend_tail_kernel has no counterpart: this kernel indexes the source
// tile as j = (i + k) mod nt itself.
//
// What it computes: for every unordered tile pair (i, j = (i + k) mod nt)
// of one launch, each pair's weight inv3 = rsqrt(d2^3) once, then both
// directions of Newton's third law:
//   forward  acc[i-row] += G*m_j * inv3 * (x_j - x_i)
//   reverse  acc[j-row] -= G*m_i * inv3 * (x_j - x_i)
// The launches cover the pair sets of _sym_hops_raw: call B takes
// k = 1..half-1 for even nt (1..half for odd nt) over all nt rows; call C,
// even nt only, takes the shared half hop k = nt/2 over rows i < nt/2, so
// each pair at that distance is counted once.  nt = 2 has no call B.
//
// What the GPU version does not copy: the bf16 3-limb operands and the
// block-centroid un-centring of the TPU kernel (they exist for the MXU's
// bf16 rounding).  Here both directions use the same f32 inv3 and the same
// f32 dx, so the pair's momentum cancels to f32 rounding of the two
// products, not of a limb reconstruction.
//
// What bounds it on an H100: instruction issue.  A pair is 16 FP32
// instructions (25 FLOP, an FMA counting 2: the separation, d2, d2^3, the
// two weights, the forward FMAs and the reverse terms) and one MUFU rsqrt;
// sym_pairs.cuh's loop adds about 0.8 shuffles, 0.8 shuffle adds, 0.25
// float4 loads and 1.3 integer operations a pair, 20.4 instructions in all
// (its SASS), against 128 lanes a clock issued on each SM: about 6.3 pairs a
// clock and SM at full issue, 0.6 of the FP32 rate.
//
// What the first design lost: a block took one tile pair, read
// each source as four staggered scalar loads from SoA shared arrays and
// added each reverse term with three shared-memory float atomicAdds, so a
// pair cost about seven LSU operations beside its arithmetic (2.0 pairs a
// clock and SM measured, 0.197 of the FP32 bound), and each tile pair ended
// in 6 b global atomics.
//
// Design: sym_pairs.cuh's loop.  A block takes target tile i and a run of
// up to kRun consecutive hops k of its launch (ops/launch.py hop_blocks: the
// last run of a launch is cut short), so the forward sums stay in registers
// across the run and reach global memory once; each pair reads its source
// as one float4 from shared memory, and the reverse sums go through
// registers and warp shuffles, one float4 global atomic a source row and
// tile.  Call C (the half hop) has one hop, so its runs are one tile.
// Atomics make the f32 sum order vary from run to run: results agree with
// the plain version to f32 reduction-order tolerance, not bit for bit.
#include <cuda_runtime.h>

#include "sym_pairs.cuh"

namespace {

template <bool kNormal>
__global__ void __launch_bounds__(sym_pairs::kMaxThreads)
sym_hops_kernel(const float4* __restrict__ src, float4* __restrict__ acc, int nt, int b, int k0, int nk,
                float eps2) {
    const int i = blockIdx.x;
    const int first = k0 + static_cast<int>(blockIdx.y) * sym_pairs::kRun;
    const int n_run = min(sym_pairs::kRun, k0 + nk - first);
    const long long rows = static_cast<long long>(i) * b;
    sym_pairs::tile_run<kNormal>(
        src + rows, acc + rows, src, acc, b, n_run,
        [=](int c) {
            const int j = i + first + c;
            return j >= nt ? j - nt : j;
        },
        1.f, eps2);
}

}  // namespace

// One launch: tile rows i = 0..grid_i-1 against hops k = k0..k0+nk-1, in
// `runs` blocks a row (ops/launch.py hop_blocks; refused unless it is
// sym_pairs::runs_for(nk)).
extern "C" int nb_sym_hops(const void* src, void* acc_hop, int nt, int b, int k0, int nk, int grid_i, int runs,
                           float eps2, void* stream) {
    if (grid_i > 0 && nk > 0) {
        if (runs != sym_pairs::runs_for(nk) || runs > 65535) return static_cast<int>(cudaErrorInvalidValue);
        const size_t smem = sym_pairs::smem_bytes(b);
        const auto kernel = sym_pairs::normal_cubes(eps2) ? sym_hops_kernel<true> : sym_hops_kernel<false>;
        const cudaError_t e = sym_pairs::allow_smem(kernel, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        const dim3 grid(grid_i, runs);
        kernel<<<grid, sym_pairs::threads_for(b), smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(src), static_cast<float4*>(acc_hop), nt, b, k0, nk, eps2);
    }
    return static_cast<int>(cudaGetLastError());
}
