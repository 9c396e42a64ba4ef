// sym_epilogue: last stage of the fused Newton-3 step, one O(N) pass.
//
// Replaces: nbody3d_tpu/ops/pallas_force.py::_sym_step_epilogue_kernel
// (reached by _sym_epilogue_call from sym_verlet_step_pallas).
//
// What it computes, per row: a = acc_diag + acc_hop (the in-tile and the
// hop partials); rows >= n_real keep their position and velocity and store
// a zero acceleration; real rows take the frame-shifted Verlet update in
// the operation order of the JAX kernel (and of ops/integrate.py):
//   v' = v + (a_old + a) * (dt/2)
//   x' = x + (v' + a * (dt/2)) * dt
// on all four lanes (the w lanes stay put: vel.w == accel.w == 0).
//
// What the GPU version does not copy: the TPU epilogue also reduced the
// (16, B) limb accumulators, transposed them through an identity matmul and
// un-centred the limbs; the GPU step accumulates plain f32 vectors, so only
// the sum and the update remain.
//
// What bounds it on an H100: HBM bytes.  It reads five (N, 4) f32 arrays
// and writes three, 128 bytes a row, and does a few flops a row.
//
// Design: one thread per row, float4 loads and stores (coalesced, 16 bytes
// a thread).  The update is verlet.cuh's verlet_row, whose explicit
// round-to-nearest adds and multiplies leave nvcc no fused multiply-add to
// form, so the result equals the plain PyTorch version bit for bit on the
// same accumulators.  The state is updated in place: each thread reads its
// whole row before it writes.
// It is an elementwise pass and Triton would serve; it stays CUDA C++ so
// that the port has one build path.
#include <cuda_runtime.h>

#include "verlet.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sym_epilogue_kernel(const float4* __restrict__ acc_diag, const float4* __restrict__ acc_hop,
                    float4* pm, float4* vel, float4* accel, int n, int n_real, float dt) {
    const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (row >= n) return;
    if (row >= n_real) {
        accel[row] = make_float4(0.f, 0.f, 0.f, 0.f);
        return;
    }
    const float4 d = acc_diag[row];
    const float4 h = acc_hop[row];
    const float4 a = make_float4(__fadd_rn(d.x, h.x), __fadd_rn(d.y, h.y),
                                 __fadd_rn(d.z, h.z), __fadd_rn(d.w, h.w));
    float4 pn, vn;
    verlet_row(pm[row], vel[row], accel[row], a, dt, pn, vn);
    pm[row] = pn;
    vel[row] = vn;
    accel[row] = a;
}

}  // namespace

extern "C" int nb_sym_epilogue(const void* acc_diag, const void* acc_hop, void* pm, void* vel,
                               void* accel, int n, int n_real, float dt, void* stream) {
    if (n > 0) {
        const dim3 grid((n + kThreads - 1) / kThreads);
        sym_epilogue_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(acc_diag), static_cast<const float4*>(acc_hop),
            static_cast<float4*>(pm), static_cast<float4*>(vel), static_cast<float4*>(accel), n,
            n_real, dt);
    }
    return static_cast<int>(cudaGetLastError());
}
