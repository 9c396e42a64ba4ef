/* Disc stamp of the renderer's host resolves: scatter-min of packed
 * uint64 words over per-splat discs.
 *
 * The port's copy of nbody3d_tpu/native/_raster.c with a plain C
 * interface (loaded with ctypes, no Python headers), built with the host
 * C compiler at first use into nbody3d_tpu_torch/_build/
 * (_build.load_host_library).  Each splat is stamped row by row: the rows
 * |dy| <= floor(r), and in each the pixels with dx*dx + dy*dy <= r*r in
 * float64, clipped to the frame, where the word is below the pixel's.
 * The minimum does not depend on the order of the splats, so the result
 * is bit for bit the torch twins' (render/resolve.py: _stamp_large,
 * resolve_keys_plain) and the JAX package's.
 *
 * nb_stamp_discs(buf, h, w, cx, cy, r, keys, n)
 *   buf:   h*w uint64 words, row-major, min-reduced in place
 *   cx,cy: n int64 centre pixels (may lie off the frame)
 *   r:     n float64 radii in pixels, finite
 *   keys:  n uint64 words
 */
#include <math.h>
#include <stddef.h>
#include <stdint.h>

void nb_stamp_discs(uint64_t *buf, int64_t h, int64_t w, const int64_t *cx, const int64_t *cy,
                    const double *r, const uint64_t *keys, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    const double ri = r[i];
    const double r2 = ri * ri;
    const int64_t irad = (int64_t)floor(ri);
    const uint64_t key = keys[i];
    const int64_t x0 = cx[i], y0 = cy[i];
    int64_t dy0 = -irad, dy1 = irad;
    if (y0 + dy0 < 0) dy0 = -y0;
    if (y0 + dy1 >= h) dy1 = h - 1 - y0;
    for (int64_t dy = dy0; dy <= dy1; dy++) {
      /* The widest dx with dx*dx + dy*dy <= r*r: sqrt's guess, then the
       * two guard loops make it the float64 mask test's answer exactly
       * (where r*r rounds past floor(r)^2, row 0 reaches one pixel
       * further than a rounded sqrt says). */
      const double rem = r2 - (double)(dy * dy);
      int64_t dxm = (int64_t)floor(sqrt(rem > 0 ? rem : 0));
      while ((double)((dxm + 1) * (dxm + 1) + dy * dy) <= r2) dxm++;
      while (dxm >= 0 && (double)(dxm * dxm + dy * dy) > r2) dxm--;
      if (dxm < 0) continue;
      int64_t xa = x0 - dxm, xb = x0 + dxm;
      if (xa < 0) xa = 0;
      if (xb >= w) xb = w - 1;
      if (xa > xb) continue;
      uint64_t *row = buf + (size_t)(y0 + dy) * (size_t)w;
      for (int64_t x = xa; x <= xb; x++)
        if (key < row[x]) row[x] = key;
    }
  }
}
