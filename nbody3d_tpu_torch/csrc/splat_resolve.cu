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
// into every frame pixel (cx_i + dx, cy_i + dy) with dx^2 + dy^2 <= r_i^2.
// The predicate is native/_raster.c's, evaluated the same way: in double,
// with r the float radius widened, and each row's half-width from a double
// sqrt corrected by the same two integer loops, so the frame is bit for bit
// the host resolve's on the same inputs.  The framebuffer is H*W unsigned
// 64-bit words, all ones where nothing landed.
//
// What bounds it on an H100: memory traffic, not arithmetic.  The least
// work is each splat's 21 bytes read once and the framebuffer written and
// read once; the atomics on top of that go to L2.  Where many splats cover
// one pixel (a galaxy's dense core) their atomics serialise at that
// address.
//
// Design (simple first): one warp per splat, lanes take the disc's rows,
// and each covered pixel gets one 64-bit atomicMin.  A lane reads the word
// first and skips the atomic when its key cannot win: the word only ever
// decreases, so a stale read is never below the final value, and the skip
// is safe.  The TPU kernel's machinery is not carried over: it has no
// scatter, so it sorts splats into 8x256 pixel bins with halos, in three
// radius tiers with fixed capacities, and takes dense (splat x pixel) minima
// per bin.  Here a scatter is native: there is no radius cap, no capacity
// and no host composite, and every splat is covered at any radius.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // warps (splats) per block

__global__ void __launch_bounds__(kWarps * 32)
splat_resolve_kernel(const int* __restrict__ cx, const int* __restrict__ cy,
                     const unsigned* __restrict__ depth_bits, const unsigned* __restrict__ rgb24,
                     const float* __restrict__ r, const unsigned char* __restrict__ visible,
                     unsigned long long* buf, int n, int w, int h) {
    const int lane = threadIdx.x & 31;
    const long long i = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    if (i >= n || !visible[i]) return;
    const double rd = static_cast<double>(r[i]);
    const double r2 = rd * rd;
    const long long irad = static_cast<long long>(floor(rd));
    const unsigned long long key =
        (static_cast<unsigned long long>(depth_bits[i]) << 32) | rgb24[i];
    const long long x0 = cx[i], y0 = cy[i];
    long long dy0 = -irad, dy1 = irad;
    if (y0 + dy0 < 0) dy0 = -y0;
    if (y0 + dy1 >= h) dy1 = h - 1 - y0;
    for (long long dy = dy0 + lane; dy <= dy1; dy += 32) {
        // Widest dx with dx*dx + dy*dy <= r*r, as native/_raster.c finds it.
        const double rem = r2 - static_cast<double>(dy * dy);
        long long dxm = static_cast<long long>(floor(sqrt(rem > 0.0 ? rem : 0.0)));
        while (static_cast<double>((dxm + 1) * (dxm + 1) + dy * dy) <= r2) ++dxm;
        while (dxm >= 0 && static_cast<double>(dxm * dxm + dy * dy) > r2) --dxm;
        if (dxm < 0) continue;
        long long xa = x0 - dxm, xb = x0 + dxm;
        if (xa < 0) xa = 0;
        if (xb >= w) xb = w - 1;
        unsigned long long* row = buf + (y0 + dy) * w;
        for (long long x = xa; x <= xb; ++x)
            if (key < row[x]) atomicMin(row + x, key);
    }
}

}  // namespace

extern "C" int nb_splat_resolve(const void* cx, const void* cy, const void* depth_bits,
                                const void* rgb24, const void* r, const void* visible,
                                void* buf, int n, int w, int h, void* stream) {
    if (n > 0) {
        const dim3 grid((n + kWarps - 1) / kWarps);
        splat_resolve_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int*>(cx), static_cast<const int*>(cy),
            static_cast<const unsigned*>(depth_bits), static_cast<const unsigned*>(rgb24),
            static_cast<const float*>(r), static_cast<const unsigned char*>(visible),
            static_cast<unsigned long long*>(buf), n, w, h);
    }
    return static_cast<int>(cudaGetLastError());
}
