// A Newton-3 form of sym_diag_prep for studies/sym_diag_variants.py: each
// unordered pair of a tile once.  Thread t takes the sources t + r,
// r = 1..128 (r = 128, the pair half a tile apart, only for t < 128, so
// that the pair is taken once), from a doubled tile; it sums its own pull
// and, for the source, the reverse term G m_t inv3 (x_s - x_t).  At step r
// lane l's reverse partial is row t0 + l + r's: lane 0 hands row t0 + r to
// its warp's slab in shared memory, then the partials move down a lane
// (three shuffles) and lane 31 starts the next row.  At the end each row
// takes its own pull less the 8 warps' slabs in warp order.  Another order
// of summation than the staggered one: within 1e-5 of the twin, not its
// bits.
#include <cuda_runtime.h>

#include "../nbody3d_tpu_torch/csrc/pair.cuh"
#include "../nbody3d_tpu_torch/csrc/sym_pairs.cuh"

namespace {

constexpr int B = 256, kWarps = B / 32, kSpan = 160;  // a warp's reverse rows: t0 + 1 .. t0 + 159

template <bool kNormal>
__global__ void __launch_bounds__(B, 8)
n3_kernel(const float4* __restrict__ pm, float4* __restrict__ src, float4* __restrict__ acc, float G, float eps2) {
    __shared__ float4 tile[2 * B];
    __shared__ float slab[kWarps][3][kSpan];
    const int t = threadIdx.x, lane = t & 31, w = t >> 5, t0 = t & ~31;
    const long long row = static_cast<long long>(blockIdx.x) * B + t;
    const float4 p = pm[row];
    const float4 q = make_float4(p.x, p.y, p.z, G * p.w);
    src[row] = q;
    tile[t] = q;
    tile[B + t] = q;
    for (int j = lane; j < 3 * kSpan; j += 32) (&slab[w][0][0])[j] = 0.f;
    __syncthreads();
    const int steps = t0 < B / 2 ? B / 2 : B / 2 - 1;  // warp-uniform
    const float4* from = tile + t;
    float ax = 0.f, ay = 0.f, az = 0.f, rx = 0.f, ry = 0.f, rz = 0.f;
#pragma unroll 4
    for (int r = 1; r <= steps; ++r) {
        const float4 s = from[r];
        const float dx = s.x - p.x;
        const float dy = s.y - p.y;
        const float dz = s.z - p.z;
        const float inv = kNormal ? pair_inv3_normal(dx, dy, dz, eps2) : pair_inv3(dx, dy, dz, eps2);
        const float ws = s.w * inv, wt = q.w * inv;
        ax = fmaf(ws, dx, ax);
        ay = fmaf(ws, dy, ay);
        az = fmaf(ws, dz, az);
        rx = fmaf(wt, dx, rx);
        ry = fmaf(wt, dy, ry);
        rz = fmaf(wt, dz, rz);
        if (r < steps) {
            if (lane == 0) slab[w][0][r - 1] = rx, slab[w][1][r - 1] = ry, slab[w][2][r - 1] = rz;
            rx = __shfl_down_sync(0xffffffffu, rx, 1);
            ry = __shfl_down_sync(0xffffffffu, ry, 1);
            rz = __shfl_down_sync(0xffffffffu, rz, 1);
            if (lane == 31) rx = ry = rz = 0.f;
        }
    }
    slab[w][0][lane + steps - 1] = rx;
    slab[w][1][lane + steps - 1] = ry;
    slab[w][2][lane + steps - 1] = rz;
    __syncthreads();
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
        const int o = (t - 32 * v - 1) & (B - 1);
        if (o < kSpan) ax -= slab[v][0][o], ay -= slab[v][1][o], az -= slab[v][2][o];
    }
    acc[row] = make_float4(ax, ay, az, 0.f);
}

}  // namespace

// sym_diag_prep's C signature; b must be 256.
extern "C" int nb_sym_diag_prep(const void* pm, void* src, void* acc_diag, int nt, int b, float G, float eps2,
                                void* stream) {
    if (b != B) return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel = sym_pairs::normal_cubes(eps2) ? n3_kernel<true> : n3_kernel<false>;
    kernel<<<nt, B, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float4*>(pm), static_cast<float4*>(src),
                                                            static_cast<float4*>(acc_diag), G, eps2);
    return static_cast<int>(cudaGetLastError());
}
