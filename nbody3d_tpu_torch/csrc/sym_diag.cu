// sym_diag: the in-tile pairs of the uncentred Newton-3 force.
//
// Replaces: nbody3d_tpu/ops/pallas_force.py::_sym_diag_kernel (reached by
// accel_sym_pallas(center=False), the ablation route whose operands are
// built outside the kernel).
//
// What it computes, per tile of b bodies (one CUDA block, one thread a
// body): acc[row] = the pull on the row from every other body of its tile,
// read from the prepared source rows src = [x, y, z, G*m] (built by torch,
// as XLA builds the JAX kernel's operands), the self pair skipped by index,
// w lane 0.  That is sym_diag_prep without the preparation: on the same
// source rows the two give the same bits, so center=True and center=False
// give the same accelerations.
//
// What the GPU version does not copy: the TPU kernel took a (b, b)
// ones-minus-eye mask, the transposed sources, uncentred bf16 3-limb
// operands (N, 16) and zero centroids, and computed one masked MXU dot whose
// limbs combine16 later folded.  With no limbs, centring changes nothing
// here.  The other design, the moment form [Σ w·gm·x, Σ w·gm·y, Σ w·gm·z,
// Σ w·gm] with a = m − x·m_w (_fast_epilogue's algebra), was not taken: it
// subtracts two O(|x|) sums to get an O(tile radius) result, so f32 loses
// what centring saved on the TPU, and it would need a combine of its own.
// Fast mode, which needs that algebra on the tensor cores, brings it.
//
// What bounds it on an H100: b - 1 pairs a row (N*b in all, a small share
// of a force evaluation's N^2/2), ~10 FP32 issue slots and one MUFU rsqrt
// a pair: FP32 issue and MUFU throughput.  The O(N) reads and writes are
// coalesced float4 accesses, 32 bytes a row.
//
// Design: sym_diag_prep's: the tile staged twice over in shared memory as
// float4 rows and pair.cuh's in_tile_pull (the staggered order with no wrap
// test, the ftz rsqrt where eps2^3 is normal), the tile width 256 a
// template instance; on the same source rows the two kernels run the same
// instructions in the same order.
#include <cuda_runtime.h>

#include "pair.cuh"
#include "sym_pairs.cuh"

namespace {

constexpr int kTile = 256;  // the template instance's tile (ops/step.py GPU_TILE)

// Threads a block of the instance for tile B (0: the runtime width, up to 1,024).
constexpr int threads_for(int B) { return B > 0 ? B : 1024; }

template <int B, bool kNormal>
__global__ void __launch_bounds__(threads_for(B), 2048 / threads_for(B))
sym_diag_kernel(const float4* __restrict__ src, float4* __restrict__ acc, int b, float eps2) {
    extern __shared__ float4 tile[];
    const int t = threadIdx.x;
    const long long row = static_cast<long long>(blockIdx.x) * (B > 0 ? B : b) + t;
    const float4 q = src[row];
    tile[t] = q;
    tile[(B > 0 ? B : b) + t] = q;
    __syncthreads();
    const float3 a = in_tile_pull<kNormal, B>(tile, b, t, q, eps2);
    acc[row] = make_float4(a.x, a.y, a.z, 0.f);
}

template <int B>
void launch(int nt, int b, bool normal, cudaStream_t s, const float4* src, float4* acc, float eps2) {
    const auto kernel = normal ? sym_diag_kernel<B, true> : sym_diag_kernel<B, false>;
    kernel<<<nt, b, 2 * static_cast<size_t>(b) * sizeof(float4), s>>>(src, acc, b, eps2);
}

}  // namespace

extern "C" int nb_sym_diag(const void* src, void* acc_diag, int nt, int b, float eps2,
                           void* stream) {
    if (nt > 0) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const bool normal = sym_pairs::normal_cubes(eps2);
        const auto* q = static_cast<const float4*>(src);
        auto* a = static_cast<float4*>(acc_diag);
        if (b == kTile) {
            launch<kTile>(nt, b, normal, s, q, a, eps2);
        } else {
            launch<0>(nt, b, normal, s, q, a, eps2);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
