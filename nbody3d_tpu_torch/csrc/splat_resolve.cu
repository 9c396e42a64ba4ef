// splat_resolve: the depth resolve of the point-splat renderer.  Every
// visible splat min-reduces its packed key into the pixels of its disc.
//
// Replaces: nbody3d_tpu/render/pallas_resolve.py::_resolve_kernel (reached
// by _rasterize_sorted / resolve_all_pallas), the renderer's on-device
// resolve.
//
// What it computes: for each visible splat i, key_i = (depth_bits_i << 32)
// | rgb24_i (IEEE non-negative floats order like their bit patterns, so the
// minimum key is the nearest splat, ties broken by colour), min-reduced
// into every frame pixel (cx_i + dx, cy_i + dy) with |dy| <= floor(r_i) and
// dx^2 + dy^2 <= r_i^2, native/_raster.c's predicate.  r is a float, so
// r^2 in double is exact and dx^2 + dy^2 <= r^2 holds exactly when the
// integer dx^2 + dy^2 is at most floor(r^2): the kernel tests that in
// 64-bit integers, with no sqrt, and the frame is bit for bit the host
// resolve's on the same inputs (radii up to 2^30 px; a larger one covers
// what lies within 2^30 px of its centre on each axis).  The framebuffer is
// H*W unsigned 64-bit words, all ones where nothing landed.
//
// What bounds it on an H100: memory traffic, not arithmetic.  The least
// work is each splat's visible byte read once, a visible splat's other 20
// bytes, and the framebuffer written once; the atomics resolve in L2 (a
// 1920x1080 frame is 16.6 MB).  Where many splats cover one pixel (a
// galaxy's dense core) their atomics serialise at that address.
//
// Design: one thread per splat reads its visible byte and fields: the
// threads of a warp read 32 neighbouring splats, so an invisible splat
// costs one lane of one coalesced load.  The warp then stamps its discs
// together.  The discs with floor(r) <= kSmallMax = 1 go in one packed
// pass: their 3x3 squares are flattened over (disc, pixel), 32 pixels an
// iteration, each disc's fields in shared memory.  The larger discs are
// found by a ballot and stamped one after another, the lanes on the
// clipped bounding square's pixels flattened over (row, x), so an r = 64
// disc keeps all 32 lanes on neighbouring words.  Each covered pixel gets
// one 64-bit atomicMin, with no read of the word first: measured on an
// H100 (PERF.md) such a read costs more than the atomics it saves at every
// scene chip_smoke.py times, and so did stamping each small disc by its
// own thread and a packed pass for floor(r) = 0 alone.  The TPU kernel's
// machinery is not carried over: it has no scatter, so it sorts splats
// into 8x256 pixel bins with halos, in three radius tiers with fixed
// capacities, and takes dense (splat x pixel) minima per bin.  Here there
// is no radius cap, no capacity and no host composite.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmallMax = 1;  // the largest floor(r) of the packed pass: a disc within its 3x3 square
constexpr long long kMaxRad = 1LL << 30;  // floor(r) beyond this covers the same frame pixels

__global__ void __launch_bounds__(kThreads)
splat_resolve_kernel(const int* __restrict__ cx, const int* __restrict__ cy,
                     const unsigned* __restrict__ depth_bits, const unsigned* __restrict__ rgb24,
                     const float* __restrict__ r, const unsigned char* __restrict__ visible,
                     unsigned long long* buf, int n, int w, int h) {
    __shared__ long long sx[kThreads], sy[kThreads], sr2[kThreads];
    __shared__ unsigned long long skey[kThreads];
    const int lane = threadIdx.x & 31, wbase = threadIdx.x & ~31;
    const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    long long x0 = 0, y0 = 0, irad = -1, r2 = 0;
    unsigned long long key = 0;
    if (i < n && visible[i]) {
        const double rd = static_cast<double>(r[i]);
        // NaN and r < 0 draw nothing (native: floor(r) < 0 gives no rows);
        // r = -0.0 passes and, as in native, covers its centre.
        if (rd >= 0.0) {
            irad = rd >= static_cast<double>(kMaxRad) ? kMaxRad : static_cast<long long>(floor(rd));
            const double rr = rd * rd;  // exact: a float squared fits a double
            r2 = rr >= 4611686018427387904.0 ? (1LL << 62) : static_cast<long long>(floor(rr));
            key = (static_cast<unsigned long long>(depth_bits[i]) << 32) | rgb24[i];
            x0 = cx[i];
            y0 = cy[i];
        }
    }
    // The packed pass: the warp's small discs in rank order, 9 pixels each
    // (floor(r) <= 1 gives floor(r^2) <= 3, so the disc fits its square).
    const bool is_small = irad >= 0 && irad <= kSmallMax;
    const unsigned smalls = __ballot_sync(0xffffffffu, is_small);
    if (is_small) {
        const int at = wbase + __popc(smalls & ((1u << lane) - 1u));
        sx[at] = x0, sy[at] = y0, sr2[at] = r2, skey[at] = key;
    }
    __syncwarp();
    const int pixels = __popc(smalls) * 9;
    for (int p = lane; p < pixels; p += 32) {
        const int d = wbase + p / 9, j = p % 9;
        const long long dx = j % 3 - 1, dy = j / 3 - 1, x = sx[d] + dx, y = sy[d] + dy;
        if (dx * dx + dy * dy <= sr2[d] && x >= 0 && x < w && y >= 0 && y < h) atomicMin(buf + y * w + x, skey[d]);
    }
    unsigned big = __ballot_sync(0xffffffffu, irad > kSmallMax);
    while (big) {
        const int src = __ffs(big) - 1;
        big &= big - 1;
        const long long bx = __shfl_sync(0xffffffffu, x0, src), by = __shfl_sync(0xffffffffu, y0, src);
        const long long br = __shfl_sync(0xffffffffu, irad, src), br2 = __shfl_sync(0xffffffffu, r2, src);
        const unsigned long long bkey = __shfl_sync(0xffffffffu, key, src);
        const long long ya = by - br > 0 ? by - br : 0, yb = by + br < h - 1 ? by + br : h - 1;
        const long long xa = bx - br > 0 ? bx - br : 0, xb = bx + br < w - 1 ? bx + br : w - 1;
        if (ya > yb || xa > xb) continue;  // the same for every lane
        // The clipped square holds at most w*h < 2^31 pixels.
        const unsigned cols = static_cast<unsigned>(xb - xa + 1);
        const unsigned count = cols * static_cast<unsigned>(yb - ya + 1);
        for (unsigned p = lane; p < count; p += 32) {
            const unsigned row = p / cols, col = p - row * cols;
            const long long dy = ya + row - by, dx = xa + col - bx;
            if (dx * dx + dy * dy <= br2) atomicMin(buf + (ya + row) * w + xa + col, bkey);
        }
    }
}

}  // namespace

extern "C" int nb_splat_resolve(const void* cx, const void* cy, const void* depth_bits,
                                const void* rgb24, const void* r, const void* visible,
                                void* buf, int n, int w, int h, void* stream) {
    if (n > 0) {
        const dim3 grid((n + kThreads - 1) / kThreads);
        splat_resolve_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int*>(cx), static_cast<const int*>(cy),
            static_cast<const unsigned*>(depth_bits), static_cast<const unsigned*>(rgb24),
            static_cast<const float*>(r), static_cast<const unsigned char*>(visible),
            static_cast<unsigned long long*>(buf), n, w, h);
    }
    return static_cast<int>(cudaGetLastError());
}
