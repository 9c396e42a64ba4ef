// vjp_combine: last stage of the Newton-3 force VJP, one O(N) pass.
//
// Replaces: nbody3d_tpu/ops/force_vjp.py::_vjp_combine_kernel (reached by
// force_vjp_sym_pallas's epilogue call), and the jnp.sum that took Ḡ from
// its output.
//
// What it computes, per row: pm_bar = G * (acc_diag + acc_hop)[x̄(3), m̄];
// and gbar += the sum over all rows of acc_diag.φ + acc_hop.φ, in double.
//
// What the GPU version does not copy: the TPU epilogue un-folded the row-sum
// identities (m W a - a W m - 3 m (S x - x σ) + ...) from sixteen
// accumulator columns; here the accumulators already hold x̄ and m̄.
//
// What bounds it on an H100: HBM bytes.  It reads two (N, 8) f32 arrays
// and writes one (N, 4), 80 bytes a row, with a few flops a row.
//
// Design: one thread per row, float4 loads and stores.  The row update is
// an add then a multiply, written with round-to-nearest intrinsics, so it
// equals the plain version bit for bit.  Each block reduces its rows' φ in
// double (warp shuffles, one shared slot a warp) and adds its sum to gbar
// with one double atomicAdd; the wrapper zeroes gbar first.  Triton would
// serve for an elementwise pass and a reduction; it stays CUDA C++ so that
// the port keeps one build path.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
vjp_combine_kernel(const float4* __restrict__ acc_diag, const float4* __restrict__ acc_hop,
                   float4* __restrict__ pm_bar, double* __restrict__ gbar, int n, float G) {
    __shared__ double warp_sum[kThreads / 32];
    const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    double phi = 0.0;
    if (row < n) {
        const float4 d = acc_diag[2 * row];
        const float4 h = acc_hop[2 * row];
        pm_bar[row] = make_float4(__fmul_rn(__fadd_rn(d.x, h.x), G), __fmul_rn(__fadd_rn(d.y, h.y), G),
                                  __fmul_rn(__fadd_rn(d.z, h.z), G), __fmul_rn(__fadd_rn(d.w, h.w), G));
        phi = static_cast<double>(acc_diag[2 * row + 1].x) + static_cast<double>(acc_hop[2 * row + 1].x);
    }
    for (int off = 16; off > 0; off >>= 1) phi += __shfl_down_sync(0xffffffffu, phi, off);
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = phi;
    __syncthreads();
    if (threadIdx.x == 0) {
        double total = 0.0;
        for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
        atomicAdd(gbar, total);
    }
}

}  // namespace

extern "C" int nb_vjp_combine(const void* acc_diag, const void* acc_hop, void* pm_bar, void* gbar,
                              int n, float G, void* stream) {
    if (n > 0) {
        const dim3 grid((n + kThreads - 1) / kThreads);
        vjp_combine_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(acc_diag), static_cast<const float4*>(acc_hop),
            static_cast<float4*>(pm_bar), static_cast<double*>(gbar), n, G);
    }
    return static_cast<int>(cudaGetLastError());
}
