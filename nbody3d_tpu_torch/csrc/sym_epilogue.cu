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
// a thread).  Every operation is an explicit round-to-nearest add or
// multiply, so nvcc forms no fused multiply-add and the result equals the
// plain PyTorch version bit for bit on the same accumulators.  The state
// is updated in place: each thread reads its whole row before it writes.
// It is an elementwise pass and Triton would serve; it stays CUDA C++ so
// that the port has one build path.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float verlet_v(float v, float ao, float a, float half_dt) {
    return __fadd_rn(v, __fmul_rn(__fadd_rn(ao, a), half_dt));
}

__device__ __forceinline__ float verlet_x(float x, float vn, float a, float half_dt, float dt) {
    return __fadd_rn(x, __fmul_rn(__fadd_rn(vn, __fmul_rn(a, half_dt)), dt));
}

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
    const float4 p = pm[row];
    const float4 v = vel[row];
    const float4 ao = accel[row];
    const float half_dt = __fmul_rn(dt, 0.5f);
    const float4 vn = make_float4(verlet_v(v.x, ao.x, a.x, half_dt), verlet_v(v.y, ao.y, a.y, half_dt),
                                  verlet_v(v.z, ao.z, a.z, half_dt), verlet_v(v.w, ao.w, a.w, half_dt));
    const float4 pn = make_float4(verlet_x(p.x, vn.x, a.x, half_dt, dt),
                                  verlet_x(p.y, vn.y, a.y, half_dt, dt),
                                  verlet_x(p.z, vn.z, a.z, half_dt, dt),
                                  verlet_x(p.w, vn.w, a.w, half_dt, dt));
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
