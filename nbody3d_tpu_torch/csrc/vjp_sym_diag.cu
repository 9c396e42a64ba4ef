// vjp_sym_diag: the diagonal tiles of the Newton-3 ("sym") force VJP.
//
// Replaces: nbody3d_tpu/ops/force_vjp.py::_vjp_sym_diag_kernel (reached by
// force_vjp_sym_pallas, the backward of the fused sym step and of
// make_diff_accel(sym=True)).
//
// What it computes, per tile of b bodies (one CUDA block, one thread a
// body): every ordered pair inside the tile, self pair skipped by index,
// into acc_diag (N, 8) per unit G, rows [x̄(3), m̄, φ, 0, 0, 0] (pair terms
// in pair.cuh).  vjp_sym_hops adds the off-diagonal tile pairs and
// vjp_combine sums both.
//
// What the GPU version does not copy: the TPU kernel multiplied a (B, B)
// 0/1 mask into its weight matrices and contracted them on the MXU against
// bf16 limb planes of [A, m | x, 1], then folded the target term out
// through row sums.  Here the self pair is skipped by the loop's order and
// the pair's x̄ term is added directly in f32.
//
// What bounds it on an H100: N(b-1) pairs of about 53 FP32 FLOP and one
// MUFU rsqrt each, a small share of the VJP's N^2/2 pairs; the O(N) row
// traffic is coalesced float4 loads and stores.
//
// Design: sym_diag_prep's.  The tile (position+mass, cotangent) is staged
// once in shared memory as seven SoA arrays; thread t visits sources in the
// staggered order (t + r) mod b, r = 1..b-1, which skips the self pair
// without a branch and keeps a warp's 32 lanes on 32 consecutive banks.
#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

__global__ void __launch_bounds__(1024)
vjp_sym_diag_kernel(const float4* __restrict__ pm, const float4* __restrict__ abar,
                    float4* __restrict__ acc, int b, float eps2) {
    extern __shared__ float sh[];
    float* sx = sh;
    float* sy = sx + b;
    float* sz = sy + b;
    float* sm = sz + b;
    float* sax = sm + b;
    float* say = sax + b;
    float* saz = say + b;
    const int t = threadIdx.x;
    const long long row = static_cast<long long>(blockIdx.x) * b + t;
    const float4 me = pm[row];
    const float4 a4 = abar[row];
    const float3 ak = make_float3(a4.x, a4.y, a4.z);
    sx[t] = me.x;
    sy[t] = me.y;
    sz[t] = me.z;
    sm[t] = me.w;
    sax[t] = a4.x;
    say[t] = a4.y;
    saz[t] = a4.z;
    __syncthreads();
    float xx = 0.f, xy = 0.f, xz = 0.f, mb = 0.f, phi = 0.f;
    for (int r = 1; r < b; ++r) {
        int s = t + r;
        if (s >= b) s -= b;
        const VjpPair e = vjp_pair(me, ak, make_float4(sx[s], sy[s], sz[s], sm[s]),
                                   make_float3(sax[s], say[s], saz[s]), eps2);
        xx += e.tx;
        xy += e.ty;
        xz += e.tz;
        mb += e.mbar_t;
        phi += e.phi_t;
    }
    acc[2 * row] = make_float4(xx, xy, xz, mb);
    acc[2 * row + 1] = make_float4(phi, 0.f, 0.f, 0.f);
}

}  // namespace

extern "C" int nb_vjp_sym_diag(const void* pm, const void* abar, void* acc_diag, int nt, int b,
                               float eps2, void* stream) {
    if (nt > 0) {
        const size_t smem = 7 * static_cast<size_t>(b) * sizeof(float);
        vjp_sym_diag_kernel<<<nt, b, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(pm), static_cast<const float4*>(abar),
            static_cast<float4*>(acc_diag), b, eps2);
    }
    return static_cast<int>(cudaGetLastError());
}
