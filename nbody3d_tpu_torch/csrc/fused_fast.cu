// fused_step_fast: the fast-mode force and the frame-shifted Verlet update in
// one launch (force_mode="fast", fuse_integrate=True).
//
// Replaces: nbody3d_tpu/ops/pallas_force.py::_fused_kernel_fast (reached by
// fused_step_pallas(mode="fast")).
//
// What it computes, per row i < n: force_fast's acceleration a of row i
// against every row (targets == sources, self pair masked: the diagonal
// (0, 0, n)), then for i < n_real
//   v' = v + (a_old + a) * (dt/2),  x' = x + (v' + a * (dt/2)) * dt
// and for the padded rows i >= n_real x' = x, v' = v, a = 0 (_integrate's
// guard).  Outputs are fresh (N, 4) arrays, as fused_step_exact's.
//
// What bounds it on an H100: force_fast's pairs (one MUFU rsqrt each); the
// Verlet epilogue adds 96 bytes a row.
//
// Design: force_fast's loop (mma.cuh, the same code and block shape), then
// verlet.cuh's verlet_row on lanes 0-15 of each warp, one row each.  Both
// are shared code with explicit rounding, so the step equals force_fast
// followed by PyTorch's Verlet (ops/integrate.py) bit for bit.  The row is
// read again after the loop (__ldcv), as fused_step_exact does, rather than
// kept live through it.
#include "mma.cuh"
#include "sym_pairs.cuh"
#include "verlet.cuh"

namespace {

template <bool kNormal>
__global__ void __launch_bounds__(fast::kThreads)
fused_step_fast_kernel(const float4* __restrict__ pm, const uint4* __restrict__ frag,
                       const float4* __restrict__ vel, const float4* __restrict__ acc_old,
                       float4* __restrict__ pm_out, float4* __restrict__ vel_out,
                       float4* __restrict__ acc_out, int n, int n_real, float dt, float eps2) {
    __shared__ fast::Smem sm;
    const int lane = threadIdx.x & 31;
    const int r0 = blockIdx.x * fast::kRows + (threadIdx.x >> 5) * 16;
    const float4 tg = fast::row_or_zero(pm, r0 + (lane >> 2), n);
    const float4 tg8 = fast::row_or_zero(pm, r0 + (lane >> 2) + 8, n);
    float tot[2][4];
    fast::limb_sums<kNormal>(pm, frag, n, eps2, fast::Diag{0, 0, n}, r0, tg, tg8, sm, tot);
    const int row = r0 + (lane & 15);
    const float4 p = row < n ? __ldcv(pm + row) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float3 f = fast::epilogue_row(tot, sm, p);
    if (lane >= 16 || row >= n) return;
    if (row >= n_real) {
        pm_out[row] = p;
        vel_out[row] = vel[row];
        acc_out[row] = make_float4(0.f, 0.f, 0.f, 0.f);
        return;
    }
    const float4 a = make_float4(f.x, f.y, f.z, 0.f);
    float4 pn, vn;
    verlet_row(p, vel[row], acc_old[row], a, dt, pn, vn);
    pm_out[row] = pn;
    vel_out[row] = vn;
    acc_out[row] = a;
}

}  // namespace

extern "C" int nb_fused_step_fast(const void* pm, const void* frag, const void* vel,
                                  const void* acc_old, void* pm_out, void* vel_out,
                                  void* acc_out, int n, int n_real, float dt, float eps2,
                                  void* stream) {
    if (n > 0) {
        const dim3 grid((n + fast::kRows - 1) / fast::kRows);
        const auto kernel =
            sym_pairs::normal_cubes(eps2) ? fused_step_fast_kernel<true> : fused_step_fast_kernel<false>;
        kernel<<<grid, fast::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(pm), static_cast<const uint4*>(frag),
            static_cast<const float4*>(vel), static_cast<const float4*>(acc_old),
            static_cast<float4*>(pm_out), static_cast<float4*>(vel_out),
            static_cast<float4*>(acc_out), n, n_real, dt, eps2);
    }
    return static_cast<int>(cudaGetLastError());
}
