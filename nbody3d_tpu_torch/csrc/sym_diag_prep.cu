// sym_diag_prep: first stage of the Newton-3 ("sym") step and force.
//
// Replaces: nbody3d_tpu/ops/pallas_force.py::_sym_diag_prep_kernel
// (reached by sym_diag_prep_pallas from sym_verlet_step_pallas and from
// accel_sym_pallas(center=True)).
//
// What it computes, per tile of b bodies (one CUDA block, one thread a body):
//   - src[row] = [x, y, z, G*m], the G-folded source rows the hops read;
//   - acc_diag[row] = the in-tile partial acceleration: every ordered pair
//     of the tile, the self pair skipped by index, w lane 0.
//
// What the GPU version does not copy: the TPU kernel also built a bf16
// 3-limb split of block-centred gm*(x - c) and the block centroids, so
// that operands survive the MXU's bf16 rounding.  A CUDA-core f32 kernel
// forms dx = x_j - x_i per pair anyway and sums w*gm*dx directly, so
// neither limbs nor centroids exist here.
//
// What bounds it on an H100: it does b(b-1) pairs per tile (N(b-1) in all,
// a small share of the step's N^2/2), 12 FP32 issue slots and one MUFU
// rsqrt a pair (pair.cuh), so FP32 issue and MUFU; the O(N) row reads and
// writes are coalesced float4 accesses.
//
// Design: the tile is staged once in shared memory as float4 rows
// [x, y, z, G*m], twice over (the first design kept four SoA arrays: four
// reads a pair), and each thread sums its row with pair.cuh's in_tile_pull:
// the staggered order (t + r) mod b, r = 1..b-1, which skips the self pair
// without a branch, read as tile[t + r] from the doubled tile (no wrap
// test; one 16-byte read a pair), unrolled by 8, with the ftz rsqrt where
// eps2^3 is normal (pair_inv3_normal, rsqrtf's bits there).  The tile
// width 256 (the port's GPU_TILE) is a template instance with eight blocks
// an SM (1,024 tiles at N = 262,144 fill 132 SMs in one wave); other widths
// take the runtime instance.  Each row sums its sources in the first
// design's order with the same arithmetic, so the output is that kernel's
// to the bit.  sym_diag runs the same loop on source rows built outside the
// kernel.
#include <cuda_runtime.h>

#include "pair.cuh"
#include "sym_pairs.cuh"

namespace {

constexpr int kTile = 256;  // the template instance's tile (ops/step.py GPU_TILE)

// Threads a block of the instance for tile B (0: the runtime width, up to 1,024).
constexpr int threads_for(int B) { return B > 0 ? B : 1024; }

template <int B, bool kNormal>
__global__ void __launch_bounds__(threads_for(B), 2048 / threads_for(B))
sym_diag_prep_kernel(const float4* __restrict__ pm, float4* __restrict__ src,
                     float4* __restrict__ acc, int b, float G, float eps2) {
    extern __shared__ float4 tile[];
    const int t = threadIdx.x;
    const long long row = static_cast<long long>(blockIdx.x) * (B > 0 ? B : b) + t;
    const float4 p = pm[row];
    const float4 q = make_float4(p.x, p.y, p.z, G * p.w);
    src[row] = q;
    tile[t] = q;
    tile[(B > 0 ? B : b) + t] = q;
    __syncthreads();
    const float3 a = in_tile_pull<kNormal, B>(tile, b, t, p, eps2);
    acc[row] = make_float4(a.x, a.y, a.z, 0.f);
}

template <int B>
void launch(int nt, int b, bool normal, cudaStream_t s, const float4* pm, float4* src, float4* acc, float G,
            float eps2) {
    const auto kernel = normal ? sym_diag_prep_kernel<B, true> : sym_diag_prep_kernel<B, false>;
    kernel<<<nt, b, 2 * static_cast<size_t>(b) * sizeof(float4), s>>>(pm, src, acc, b, G, eps2);
}

}  // namespace

extern "C" int nb_sym_diag_prep(const void* pm, void* src, void* acc_diag, int nt, int b,
                                float G, float eps2, void* stream) {
    if (nt > 0) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const bool normal = sym_pairs::normal_cubes(eps2);
        const auto* p = static_cast<const float4*>(pm);
        auto* o = static_cast<float4*>(src);
        auto* a = static_cast<float4*>(acc_diag);
        if (b == kTile) {
            launch<kTile>(nt, b, normal, s, p, o, a, G, eps2);
        } else {
            launch<0>(nt, b, normal, s, p, o, a, G, eps2);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
