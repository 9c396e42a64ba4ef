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
// G*m*inv3 (2), the forward sum (3 FMA) and the reverse terms (3 multiplies
// and 3 shared-memory atomic adds), and one MUFU rsqrt: FP32 binds, 25 /
// 256 FLOP a clock and SM against 1 / 16 MUFU results.  Global memory sees
// 6 b float atomics a block, 3 (Nt ns + Ns nt) in all: 6 for every b pairs,
// a small share.
//
// Design: sym_hops.cu's, over the full (target tile, source tile) grid.
// One CUDA block per tile pair (blockIdx.x the target tile, blockIdx.y the
// source tile), one thread per target row.  The source tile is staged in
// shared memory as SoA with G folded into its masses.  Thread t visits
// source s = (t + r) mod b at step r: the forward sum stays in registers;
// the reverse term goes to a shared-memory accumulator with atomicAdd, and
// in the staggered order the lanes of a warp hit 32 distinct addresses.
// Unlike the hop launch, many blocks share a target tile as well as a
// source tile, so each block ends with one global atomicAdd per row and
// component for each side.  Atomics make the f32 sum order vary from run
// to run: results agree with the plain version to f32 reduction-order
// tolerance, not bit for bit.
#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

__global__ void __launch_bounds__(1024)
pair_sym_kernel(const float4* __restrict__ tgt, const float4* __restrict__ src, float* __restrict__ acc_t,
                float* __restrict__ acc_s, int b, float G, float eps2) {
    extern __shared__ float sh[];
    float* sx = sh;
    float* sy = sx + b;
    float* sz = sy + b;
    float* sg = sz + b;
    float* rx = sg + b;
    float* ry = rx + b;
    float* rz = ry + b;
    const int t = threadIdx.x;
    const long long row_i = static_cast<long long>(blockIdx.x) * b + t;
    const long long row_j = static_cast<long long>(blockIdx.y) * b + t;
    const float4 me = tgt[row_i];
    const float gm_i = G * me.w;
    const float4 q = src[row_j];
    sx[t] = q.x;
    sy[t] = q.y;
    sz[t] = q.z;
    sg[t] = G * q.w;
    rx[t] = 0.f;
    ry[t] = 0.f;
    rz[t] = 0.f;
    __syncthreads();
    float ax = 0.f, ay = 0.f, az = 0.f;
    for (int r = 0; r < b; ++r) {
        int s = t + r;
        if (s >= b) s -= b;
        const float dx = sx[s] - me.x;
        const float dy = sy[s] - me.y;
        const float dz = sz[s] - me.z;
        const float inv3 = pair_inv3(dx, dy, dz, eps2);
        const float wf = sg[s] * inv3;
        ax = fmaf(wf, dx, ax);
        ay = fmaf(wf, dy, ay);
        az = fmaf(wf, dz, az);
        const float wr = gm_i * inv3;
        atomicAdd(&rx[s], -(wr * dx));
        atomicAdd(&ry[s], -(wr * dy));
        atomicAdd(&rz[s], -(wr * dz));
    }
    __syncthreads();
    float* ai = acc_t + row_i * 4;
    atomicAdd(ai + 0, ax);
    atomicAdd(ai + 1, ay);
    atomicAdd(ai + 2, az);
    float* aj = acc_s + row_j * 4;
    atomicAdd(aj + 0, rx[t]);
    atomicAdd(aj + 1, ry[t]);
    atomicAdd(aj + 2, rz[t]);
}

}  // namespace

// tgt (nt*b, 4), src (ns*b, 4), acc_t and acc_s zeroed by the caller;
// b <= 1024, ns <= 65535 (the grid's y extent).
extern "C" int nb_pair_sym(const void* tgt, const void* src, void* acc_t, void* acc_s, int nt, int ns, int b,
                           float G, float eps2, void* stream) {
    if (ns > 65535) return static_cast<int>(cudaErrorInvalidValue);
    if (nt > 0 && ns > 0) {
        const size_t smem = 7 * static_cast<size_t>(b) * sizeof(float);
        const dim3 grid(nt, ns);
        pair_sym_kernel<<<grid, b, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(tgt), static_cast<const float4*>(src), static_cast<float*>(acc_t),
            static_cast<float*>(acc_s), b, G, eps2);
    }
    return static_cast<int>(cudaGetLastError());
}
