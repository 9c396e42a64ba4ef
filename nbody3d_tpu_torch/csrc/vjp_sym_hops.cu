// vjp_sym_hops: the off-diagonal tile pairs of the Newton-3 force VJP.
//
// Replaces: nbody3d_tpu/ops/force_vjp.py::_vjp_sym_hops_kernel (reached by
// force_vjp_sym_pallas's hop calls).
//
// What it computes: for every unordered tile pair (i, j = (i + k) mod nt)
// of one launch, each pair's terms once (pair.cuh), then both sides:
//   target row (tile i):  x̄ += t,  m̄ += mbar_t,  φ += phi_t + phi_s
//   source row (tile j):  x̄ -= t,  m̄ += mbar_s
// into acc_hop (N, 8) per unit G, rows [x̄(3), m̄, φ, 0, 0, 0].  The pair's
// x̄ term is antisymmetric (d and g change sign, w and d.g do not), the
// reason one evaluation serves both rows.  φ matters only through its sum
// Ḡ, so the source side's φ stays in the target thread's register and
// lands in the target row: per row, φ is not A.F, but sum over rows is.
// The launches cover the pair sets of vjp_sym_hops_plain / sym_hops: call B
// takes k = 1..half-1 for even nt (1..half for odd nt) over all nt tiles;
// call C, even nt only, takes the half hop k = nt/2 over tiles i < nt/2.
//
// What the GPU version does not copy: the TPU kernel ran six MXU
// contractions a block pair (three forward dots, two TN reverse dots,
// each on bf16 limb planes) and carried an (nt, 16, B) reverse
// accumulator across its sequential grid in VMEM.
//
// What bounds it on an H100: FP32 issue.  Per unordered pair about 61 FP32
// FLOP, one MUFU rsqrt and four shared-memory float atomics (the source
// side's x̄ and m̄), over N^2/2 pairs; global memory sees O(N * nt) atomics.
//
// Design: sym_hops's.  One CUDA block per tile pair, one thread per target
// row of tile i; tile j (position+mass and cotangent, SoA) and its reverse
// sums live in shared memory.  Thread t visits source s = (t + r) mod b at
// step r: the target sums stay in registers, the source terms go to the
// shared reverse sums by atomicAdd (the staggered order keeps a warp on 32
// distinct addresses).  CUDA blocks run in parallel in no order, so each
// block ends with one global atomicAdd per row and component for each
// side.  The f32 sum order then varies from run to run: results agree with
// the plain version to reduction-order tolerance, not bit for bit.
#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

__global__ void __launch_bounds__(1024)
vjp_sym_hops_kernel(const float4* __restrict__ pm, const float4* __restrict__ abar,
                    float* __restrict__ acc, int nt, int b, int k0, float eps2) {
    extern __shared__ float sh[];
    float* sx = sh;
    float* sy = sx + b;
    float* sz = sy + b;
    float* sm = sz + b;
    float* sax = sm + b;
    float* say = sax + b;
    float* saz = say + b;
    float* rx = saz + b;
    float* ry = rx + b;
    float* rz = ry + b;
    float* rm = rz + b;
    const int t = threadIdx.x;
    const int i = blockIdx.x;
    int j = i + k0 + static_cast<int>(blockIdx.y);
    if (j >= nt) j -= nt;
    const long long row_i = static_cast<long long>(i) * b + t;
    const long long row_j = static_cast<long long>(j) * b + t;
    const float4 me = pm[row_i];
    const float4 a4 = abar[row_i];
    const float3 ak = make_float3(a4.x, a4.y, a4.z);
    const float4 q = pm[row_j];
    const float4 qa = abar[row_j];
    sx[t] = q.x;
    sy[t] = q.y;
    sz[t] = q.z;
    sm[t] = q.w;
    sax[t] = qa.x;
    say[t] = qa.y;
    saz[t] = qa.z;
    rx[t] = 0.f;
    ry[t] = 0.f;
    rz[t] = 0.f;
    rm[t] = 0.f;
    __syncthreads();
    float xx = 0.f, xy = 0.f, xz = 0.f, mb = 0.f, phi = 0.f;
    for (int r = 0; r < b; ++r) {
        int s = t + r;
        if (s >= b) s -= b;
        const VjpPair e = vjp_pair(me, ak, make_float4(sx[s], sy[s], sz[s], sm[s]),
                                   make_float3(sax[s], say[s], saz[s]), eps2);
        xx += e.tx;
        xy += e.ty;
        xz += e.tz;
        mb += e.mbar_t;
        phi += e.phi_t + e.phi_s;
        atomicAdd(&rx[s], -e.tx);
        atomicAdd(&ry[s], -e.ty);
        atomicAdd(&rz[s], -e.tz);
        atomicAdd(&rm[s], e.mbar_s);
    }
    __syncthreads();
    float* ai = acc + row_i * 8;
    atomicAdd(ai + 0, xx);
    atomicAdd(ai + 1, xy);
    atomicAdd(ai + 2, xz);
    atomicAdd(ai + 3, mb);
    atomicAdd(ai + 4, phi);
    float* aj = acc + row_j * 8;
    atomicAdd(aj + 0, rx[t]);
    atomicAdd(aj + 1, ry[t]);
    atomicAdd(aj + 2, rz[t]);
    atomicAdd(aj + 3, rm[t]);
}

}  // namespace

// One launch: tile rows i = 0..grid_i-1 against hops k = k0..k0+nk-1.
extern "C" int nb_vjp_sym_hops(const void* pm, const void* abar, void* acc_hop, int nt, int b,
                               int k0, int nk, int grid_i, float eps2, void* stream) {
    if (grid_i > 0 && nk > 0) {
        const size_t smem = 11 * static_cast<size_t>(b) * sizeof(float);
        const dim3 grid(grid_i, nk);
        vjp_sym_hops_kernel<<<grid, b, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(pm), static_cast<const float4*>(abar),
            static_cast<float*>(acc_hop), nt, b, k0, eps2);
    }
    return static_cast<int>(cudaGetLastError());
}
