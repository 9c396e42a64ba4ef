// fused_step_exact: the exact all-pairs force and the frame-shifted Verlet
// update in one launch (force_mode="exact", fuse_integrate=True).
//
// Replaces: nbody3d_tpu/ops/pallas_force.py::_fused_kernel_exact (reached by
// fused_step_pallas(mode="exact")), the WebGPU reference's own design of
// one shader doing force and integration.
//
// What it computes, per row i < n: a = sum_j G*m_j * rsqrt(d2^3) * (x_j -
// x_i) over every row j (force_exact's sum), then for i < n_real
//   v' = v + (a_old + a) * (dt/2),  x' = x + (v' + a * (dt/2)) * dt
// and for the padded rows i >= n_real x' = x, v' = v, a = 0 (_integrate's
// guard).  Outputs are fresh (N, 4) arrays: the state cannot be updated in
// place, because every block reads every position while others write.
//
// What bounds it on an H100: the N^2 pairs, ~10 FP32 issue slots and one
// MUFU rsqrt each, as force_exact; the Verlet epilogue adds 96 bytes a row
// (three rows read, three written), nothing at these sizes.
//
// Design: force_exact's kernel, one thread per target and the sources
// staged through shared memory by pair.cuh's all_pairs_pull, then
// verlet.cuh's verlet_row on the thread's row.  Both are shared code with
// explicit rounding, so the step equals force_exact followed by PyTorch's
// Verlet (ops/integrate.py) bit for bit.  What fusing saves is the torch
// Verlet's launches and their passes over the state.  The epilogue reads
// the row's position again after the loop (__ldcv) instead of keeping the
// mass lane of the target in a register through it: at two-galaxy
// (314 blocks of 4 warps, 2-3 blocks an SM) the loop is latency-bound, and
// that one register more reordered its rsqrts and cost 13% (chip_smoke.py
// on an H100 at 700 W: 1.649 against force_exact's 1.458 ms, both at 32
// registers); with the reload the two take the same time.
#include <cuda_runtime.h>

#include "pair.cuh"
#include "verlet.cuh"

namespace {

constexpr int kTile = 128;

__global__ void __launch_bounds__(kTile)
fused_step_exact_kernel(const float4* __restrict__ pm, const float4* __restrict__ vel,
                        const float4* __restrict__ acc_old, float4* __restrict__ pm_out,
                        float4* __restrict__ vel_out, float4* __restrict__ acc_out, int n,
                        int n_real, float dt, float G, float eps2) {
    __shared__ float4 tile[kTile];
    const int row = blockIdx.x * kTile + threadIdx.x;
    const float4 me = row < n ? pm[row] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float3 f = all_pairs_pull<kTile>(pm, n, G, eps2, me, tile);
    if (row >= n) return;
    // The row again, by a load nvcc may not merge with the first one: the
    // loop then keeps force_exact's live registers (me.w would be one more).
    const float4 p = __ldcv(pm + row);
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

extern "C" int nb_fused_step_exact(const void* pm, const void* vel, const void* acc_old,
                                   void* pm_out, void* vel_out, void* acc_out, int n,
                                   int n_real, float dt, float G, float eps2, void* stream) {
    if (n > 0) {
        const dim3 grid((n + kTile - 1) / kTile);
        fused_step_exact_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(pm), static_cast<const float4*>(vel),
            static_cast<const float4*>(acc_old), static_cast<float4*>(pm_out),
            static_cast<float4*>(vel_out), static_cast<float4*>(acc_out), n, n_real, dt, G,
            eps2);
    }
    return static_cast<int>(cudaGetLastError());
}
