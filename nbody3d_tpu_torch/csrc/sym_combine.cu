// sym_combine: the last stage of the unfused Newton-3 ("sym") force, one
// O(N) pass.
//
// Replaces: nbody3d_tpu/ops/pallas_force.py::_combine16_kernel (reached by
// combine16_pallas from accel_sym_pallas, the force of the unfused sym
// step: --integrator yoshida4|euler, fuse_epilogue=False, one tile).
//
// What it computes, per row: a = acc_diag + acc_hop (the in-tile and the
// hop partials), w lane 0, on every row, padding included.  Like
// combine16_pallas it takes no n_real: a padded row (mass 0) carries the
// pull of the real bodies on it, and the integrator's valid mask freezes it.
//
// What the GPU version does not copy: the TPU kernel folded a (N, 16) limb
// accumulator into (N, 4) (the sum of three bf16 limbs per component, the
// c*W correction, minus x times the summed gm limbs) to undo the block
// centring that kept the MXU's bf16 operands small.  The CUDA-core sym
// kernels accumulate plain f32 vectors of w*gm*dx, so only the sum remains.
//
// What bounds it on an H100: HBM bytes.  It reads two (N, 4) f32 arrays and
// writes one, 48 bytes a row, for three adds a row.
//
// Design: one thread per row, float4 loads and stores (coalesced, 16 bytes
// a thread); plain round-to-nearest adds, so it equals the plain PyTorch
// version bit for bit.  It is a fused elementwise pass and Triton would
// serve; it stays CUDA C++ so that the port has one build path.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sym_combine_kernel(const float4* __restrict__ acc_diag, const float4* __restrict__ acc_hop,
                   float4* __restrict__ out, int n) {
    const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (row >= n) return;
    const float4 d = acc_diag[row];
    const float4 h = acc_hop[row];
    out[row] = make_float4(d.x + h.x, d.y + h.y, d.z + h.z, 0.f);
}

}  // namespace

extern "C" int nb_sym_combine(const void* acc_diag, const void* acc_hop, void* out, int n,
                              void* stream) {
    if (n > 0) {
        const dim3 grid((n + kThreads - 1) / kThreads);
        sym_combine_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(acc_diag), static_cast<const float4*>(acc_hop),
            static_cast<float4*>(out), n);
    }
    return static_cast<int>(cudaGetLastError());
}
