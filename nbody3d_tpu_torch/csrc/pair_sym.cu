// pair_sym: Newton-3 forces between two disjoint body sets.
//
// Replaces: nbody3d_tpu/ops/pallas_force.py::_pair_sym_kernel (reached by
// accel_pair_sym_pallas from the macro-tiled sym schedule of
// nbody3d_tpu/ops/step.py::make_sym_accel_fn above SYM_MAX_N, and from the
// Newton-3 ring's hops).
//
// What it computes: for targets tgt (Nt, 4) and sources src (Ns, 4), both
// [x, y, z, m] f32 and disjoint by precondition (no self-pair mask), each
// pair's weight inv3 = rsqrt(d2^3), d2 = |x_j - x_i|^2 + eps2, once, then
// both directions of Newton's third law:
//   acc_t[i] += G*m_j * inv3 * (x_j - x_i)
//   acc_s[j] -= G*m_i * inv3 * (x_j - x_i)
// into acc_t (Nt, 4) and acc_s (Ns, 4), which the wrapper zeroes; the w
// lanes stay 0.  Nt and Ns are multiples of the tile b and may differ.
//
// What the GPU version does not copy: the bf16 3-limb source operands
// (s16), the block-centroid un-centring (cents/centt), the (ns, 16, B)
// VMEM-resident reverse accumulator and the combine16_pallas pass that
// folds the limbs afterwards.  They exist for the MXU's bf16 rounding and
// the TPU's sequential grid; here both directions use the same f32 inv3
// and the same f32 dx, as in sym_hops.cu, so a pair's momentum cancels to
// the f32 rounding of the two products.
//
// What bounds it on an H100: operations.  Per pair 25 FP32 FLOP (an FMA
// counts 2): the separation (3), d2 (3 FMA), d2^3 (2), the two weights
// G*m*inv3 (2), the forward sum (3 FMA) and the reverse terms (3), and one
// MUFU rsqrt: FP32 binds, 25 / 256 FLOP a clock and SM against 1 / 16 MUFU
// results; with the loop's shuffles, loads and index arithmetic a pair
// issues 20.4 instructions (sym_hops.cu).  Global memory sees one float4
// atomic a source row and tile and one a target row and run, a small share.
//
// What the first design lost: sym_hops.cu's first design, a block a
// tile pair, four staggered scalar shared loads and three shared-memory
// float atomicAdds a pair (0.198 of the FP32 bound).
//
// Design: sym_pairs.cuh's loop.  A block takes target tile blockIdx.x and
// a run of up to kRun consecutive source tiles (ops/launch.py pair_schedule:
// the last run is cut short), so the forward sums stay in registers across the
// run; each pair reads its source as one float4 from shared memory with G
// folded into the mass, and the reverse sums go through registers and warp
// shuffles to one float4 global atomic a source row and tile.  Atomics make
// the f32 sum order vary from run to run: results agree with the plain
// version to f32 reduction-order tolerance, not bit for bit.
#include <cuda_runtime.h>

#include "sym_pairs.cuh"

namespace {

template <bool kNormal>
__global__ void __launch_bounds__(sym_pairs::kMaxThreads)
pair_sym_kernel(const float4* __restrict__ tgt, const float4* __restrict__ src, float4* __restrict__ acc_t,
                float4* __restrict__ acc_s, int ns, int b, float G, float eps2) {
    const long long rows = static_cast<long long>(blockIdx.x) * b;
    // Block (i, r) takes run (r + i) mod runs: the blocks in flight together
    // (consecutive i) add into different source tiles.
    const int first = static_cast<int>((blockIdx.y + blockIdx.x) % gridDim.y) * sym_pairs::kRun;
    const int n_run = min(sym_pairs::kRun, ns - first);
    sym_pairs::tile_run<kNormal>(tgt + rows, acc_t + rows, src, acc_s, b, n_run, [=](int c) { return first + c; },
                                 G, eps2);
}

}  // namespace

// tgt (nt*b, 4), src (ns*b, 4), acc_t and acc_s zeroed by the caller;
// b <= 1024; `runs` blocks a target tile (ops/launch.py sym_runs; refused
// unless it is sym_pairs::runs_for(ns)).
extern "C" int nb_pair_sym(const void* tgt, const void* src, void* acc_t, void* acc_s, int nt, int ns, int runs,
                           int b, float G, float eps2, void* stream) {
    if (nt > 0 && ns > 0) {
        if (runs != sym_pairs::runs_for(ns) || runs > 65535) return static_cast<int>(cudaErrorInvalidValue);
        const size_t smem = sym_pairs::smem_bytes(b);
        const auto kernel = sym_pairs::normal_cubes(eps2) ? pair_sym_kernel<true> : pair_sym_kernel<false>;
        const cudaError_t e = sym_pairs::allow_smem(kernel, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        const dim3 grid(nt, runs);
        kernel<<<grid, sym_pairs::threads_for(b), smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(tgt), static_cast<const float4*>(src), static_cast<float4*>(acc_t),
            static_cast<float4*>(acc_s), ns, b, G, eps2);
    }
    return static_cast<int>(cudaGetLastError());
}
