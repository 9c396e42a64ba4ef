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
// What bounds it on an H100: the N^2 pairs, 12 FP32 issue slots and one
// MUFU rsqrt each, as force_exact; the Verlet epilogue adds 96 bytes a row
// (three rows read, three written), nothing at these sizes.
//
// Design: force_exact's kernel (exact.cuh: 2 target rows a thread, staged
// source tiles, the cluster split of the sources where the wrapper asks
// for S > 1 and its combine in rank order), then verlet.cuh's verlet_row on
// each row, by the thread that holds the row's total.  Both are shared code
// with explicit rounding, so the step equals force_exact followed by
// PyTorch's Verlet (ops/integrate.py) bit for bit.  What fusing saves is
// the torch Verlet's launches and their passes over the state.  The
// epilogue reads the row's position again by __ldcv, a load nvcc may not
// merge with the loop's.  With a plain load the same bits took 10% longer
// on an H100 (PERF.md section 6: ptxas gave the loop 40 registers
// and a slower schedule than the reload's 48).
#include <cuda_runtime.h>

#include "exact.cuh"
#include "sym_pairs.cuh"
#include "verlet.cuh"

namespace {

template <bool kNormal>
__global__ void __launch_bounds__(exact::kThreads)
fused_step_exact_kernel(const float4* __restrict__ pm, const float4* __restrict__ vel,
                        const float4* __restrict__ acc_old, float4* __restrict__ pm_out,
                        float4* __restrict__ vel_out, float4* __restrict__ acc_out, int n,
                        int n_real, float dt, float G, float eps2, int split) {
    __shared__ float4 tile[exact::kTile];
    __shared__ float4 part[exact::kBlockRows];
    const int rank = blockIdx.x % split;
    const int row0 = blockIdx.x / split * exact::kBlockRows;
    float3 f[exact::kRows];
    exact::pull_share<kNormal>(pm, row0, n, pm, n, rank, split, G, eps2, f, tile);
    exact::finish(f, row0, n, rank, split, part, [&](int row, float3 a3) {
        const float4 p = __ldcv(pm + row);
        if (row >= n_real) {
            pm_out[row] = p;
            vel_out[row] = vel[row];
            acc_out[row] = make_float4(0.f, 0.f, 0.f, 0.f);
            return;
        }
        const float4 a = make_float4(a3.x, a3.y, a3.z, 0.f);
        float4 pn, vn;
        verlet_row(p, vel[row], acc_old[row], a, dt, pn, vn);
        pm_out[row] = pn;
        vel_out[row] = vn;
        acc_out[row] = a;
    });
}

}  // namespace

extern "C" int nb_fused_step_exact(const void* pm, const void* vel, const void* acc_old,
                                   void* pm_out, void* vel_out, void* acc_out, int n,
                                   int n_real, float dt, float G, float eps2, int split, void* stream) {
    if (n <= 0) return static_cast<int>(cudaGetLastError());
    const auto kernel =
        sym_pairs::normal_cubes(eps2) ? fused_step_exact_kernel<true> : fused_step_exact_kernel<false>;
    const cudaError_t rc = exact::launch(
        kernel, n, split, static_cast<cudaStream_t>(stream), static_cast<const float4*>(pm),
        static_cast<const float4*>(vel), static_cast<const float4*>(acc_old), static_cast<float4*>(pm_out),
        static_cast<float4*>(vel_out), static_cast<float4*>(acc_out), n, n_real, dt, G, eps2, split);
    return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}
