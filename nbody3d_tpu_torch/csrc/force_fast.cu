// force_fast: fast-mode accelerations of targets against sources, bf16
// weights on the tensor cores against 3-limb sources (force_mode="fast").
//
// Replaces: nbody3d_tpu/ops/pallas_force.py::_force_kernel_fast_nomask,
// _force_kernel_fast_diag and _force_kernel_fast (reached by
// accel_pallas(mode="fast")): one kernel for the three.  The TPU split the
// diagonal block into a call of its own (a predicated dot cost Mosaic ~30%);
// here the self-pair mask is a warp-uniform branch per staged tile and
// 16 x 16 chunk, taken only where the runtime diagonal (off, lo, hi)
// crosses, so one kernel serves the static diagonal (0, 0, n), a disjoint
// source set (off = NO_DIAG) and a diagonal at any offset.
//
// What it computes: mma.cuh's limb sums and _fast_epilogue, out[i] =
// (a_x, a_y, a_z, 0).  G is folded into the limbs by the wrapper.
//
// What bounds it on an H100: per pair one MUFU rsqrt, 8 FP32 operations
// (three subtractions, three FMA and two multiplies for d2^3), half a bf16x2
// conversion, one f32 add of the chunk sums and 32 bf16 FLOP on the tensor
// cores, whose 989 TFLOP/s take pairs at ~7x the MUFU rate.  The MUFU unit
// (16 results a clock and SM) takes 8 issue slots' time a warp's pair, and
// the loop issues somewhat more instructions than that a pair (mma.cuh), so
// issue binds first, then the MUFU; memory does not (each block stages a
// source tile once for 64 targets).  On the card the loop issues at well
// under full rate (PERF.md section 6).
//
// Design: mma.cuh: a warp owns 16 target rows, computes the weights in
// registers in the MMA's A-fragment layout, two m16n8k16 MMAs a chunk of 16
// sources, each chunk's sums added into f32 totals that stay in registers
// across the source loop; the self-pair test only in the staged tiles the
// diagonal crosses; the ftz rsqrt where eps2^3 is normal (one instance
// each way).  Neither changes a sum, so the result is bit for bit the
// first design's (the self-pair test in every chunk, rsqrtf).
#include "mma.cuh"
#include "sym_pairs.cuh"

namespace {

template <bool kNormal>
__global__ void __launch_bounds__(fast::kThreads)
force_fast_kernel(const float4* __restrict__ tgt, const float4* __restrict__ src,
                  const uint4* __restrict__ frag, float4* __restrict__ out, int n_t, int n_s,
                  float eps2, fast::Diag dg) {
    __shared__ fast::Smem sm;
    const int lane = threadIdx.x & 31;
    const int r0 = blockIdx.x * fast::kRows + (threadIdx.x >> 5) * 16;
    const float4 tg = fast::row_or_zero(tgt, r0 + (lane >> 2), n_t);
    const float4 tg8 = fast::row_or_zero(tgt, r0 + (lane >> 2) + 8, n_t);
    float tot[2][4];
    fast::limb_sums<kNormal>(src, frag, n_s, eps2, dg, r0, tg, tg8, sm, tot);
    const int row = r0 + (lane & 15);
    const float4 p = fast::row_or_zero(tgt, row, n_t);
    const float3 a = fast::epilogue_row(tot, sm, p);
    if (lane < 16 && row < n_t) out[row] = make_float4(a.x, a.y, a.z, 0.f);
}

}  // namespace

extern "C" int nb_force_fast(const void* tgt, const void* src, const void* frag, void* out,
                             int n_t, int n_s, float eps2, int off, int lo, int hi,
                             void* stream) {
    if (n_t > 0) {
        const dim3 grid((n_t + fast::kRows - 1) / fast::kRows);
        const auto kernel = sym_pairs::normal_cubes(eps2) ? force_fast_kernel<true> : force_fast_kernel<false>;
        kernel<<<grid, fast::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(tgt), static_cast<const float4*>(src),
            static_cast<const uint4*>(frag), static_cast<float4*>(out), n_t, n_s, eps2,
            fast::Diag{off, lo, hi});
    }
    return static_cast<int>(cudaGetLastError());
}
