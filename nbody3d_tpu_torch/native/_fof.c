/* Friends-of-friends group finder core: spatial hash + union-find.
 *
 * The port's copy of nbody3d_tpu/native/_fof.c with a plain C interface
 * (loaded with ctypes, no Python headers): the same cell table, the same
 * walk over the 27 neighbouring cells, the same r^2 <= b^2 test (minimum
 * image on a periodic box) and the same union rule, so it gives the same
 * labels.  nbody3d_tpu_torch/analysis.py builds it with the host C
 * compiler at first use, into nbody3d_tpu_torch/_build/.
 *
 * Cells are identified by a mixed 64-bit key of the integer cell coords
 * (open-addressed table, chained bodies).  Key collisions between
 * distinct cells are harmless: a merged chain only adds distance checks,
 * and every real neighbour cell's bodies are reached through its exact
 * key; the linking decision itself is the r^2 <= b^2 test alone.
 *
 * nb_fof_labels(pos, cell, n, nx, ny, nz, ll2, lx, ly, lz, labels)
 *   pos:    n*3 float32 positions
 *   cell:   n*3 int32 integer cell coords, each in [0, n?) of its axis
 *   nx/y/z: cells per axis
 *   ll2:    squared linking length
 *   lx/y/z: periodic box edge per axis, 0 = isolated (no wrap)
 *   labels: n int32, receives the union-find root of each body
 * Returns 0, or -1 when memory runs out.
 */
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

static inline uint64_t mix_key(int64_t cx, int64_t cy, int64_t cz) {
  uint64_t k = (uint64_t)cx * 0x9E3779B97F4A7C15ULL;
  k ^= (uint64_t)cy * 0xC2B2AE3D27D4EB4FULL;
  k ^= (uint64_t)cz * 0x165667B19E3779F9ULL;
  /* splitmix finalizer so table probing sees all bits */
  k ^= k >> 30;
  k *= 0xBF58476D1CE4E5B9ULL;
  k ^= k >> 27;
  return k;
}

static inline int32_t uf_find(int32_t *parent, int32_t i) {
  while (parent[i] != i) {
    parent[i] = parent[parent[i]]; /* path halving */
    i = parent[i];
  }
  return i;
}

int nb_fof_labels(const float *pos, const int32_t *cell, int64_t n, int64_t nx, int64_t ny, int64_t nz,
                  double ll2, double lx, double ly, double lz, int32_t *labels) {
  /* open-addressed cell table, size = next pow2 >= 2n */
  size_t tsize = 16;
  while (tsize < (size_t)(2 * n)) tsize <<= 1;
  const size_t tmask = tsize - 1;
  uint64_t *tkey = malloc(tsize * sizeof(uint64_t));
  int32_t *thead = malloc(tsize * sizeof(int32_t));
  int32_t *next = malloc((size_t)n * sizeof(int32_t));
  int32_t *parent = malloc((size_t)n * sizeof(int32_t));
  if (!tkey || !thead || !next || !parent) {
    free(tkey);
    free(thead);
    free(next);
    free(parent);
    return -1;
  }
  for (size_t t = 0; t < tsize; t++) thead[t] = -1;

  /* build: one chain per occupied cell key */
  for (int64_t i = 0; i < n; i++) {
    parent[i] = (int32_t)i;
    const uint64_t key = mix_key(cell[3 * i], cell[3 * i + 1], cell[3 * i + 2]);
    size_t s = (size_t)key & tmask;
    while (thead[s] != -1 && tkey[s] != key) s = (s + 1) & tmask;
    if (thead[s] == -1) tkey[s] = key;
    next[i] = thead[s];
    thead[s] = (int32_t)i;
  }

  const int periodic = (lx > 0.0);
  for (int64_t i = 0; i < n; i++) {
    const float xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    const int64_t cx = cell[3 * i], cy = cell[3 * i + 1], cz = cell[3 * i + 2];
    for (int dz = -1; dz <= 1; dz++) {
      for (int dy = -1; dy <= 1; dy++) {
        for (int dx = -1; dx <= 1; dx++) {
          int64_t ax = cx + dx, ay = cy + dy, az = cz + dz;
          if (periodic) {
            if (ax < 0) ax += nx;
            if (ax >= nx) ax -= nx;
            if (ay < 0) ay += ny;
            if (ay >= ny) ay -= ny;
            if (az < 0) az += nz;
            if (az >= nz) az -= nz;
          } else {
            if (ax < 0 || ax >= nx || ay < 0 || ay >= ny || az < 0 || az >= nz) continue;
          }
          const uint64_t key = mix_key(ax, ay, az);
          size_t s = (size_t)key & tmask;
          while (thead[s] != -1 && tkey[s] != key) s = (s + 1) & tmask;
          if (thead[s] == -1) continue;
          for (int32_t j = thead[s]; j != -1; j = next[j]) {
            if (j >= (int32_t)i) continue; /* each unordered pair once */
            double ddx = (double)xi - (double)pos[3 * j];
            double ddy = (double)yi - (double)pos[3 * j + 1];
            double ddz = (double)zi - (double)pos[3 * j + 2];
            if (periodic) { /* minimum image */
              ddx -= lx * floor(ddx / lx + 0.5);
              ddy -= ly * floor(ddy / ly + 0.5);
              ddz -= lz * floor(ddz / lz + 0.5);
            }
            if (ddx * ddx + ddy * ddy + ddz * ddz <= ll2) {
              int32_t ri = uf_find(parent, (int32_t)i);
              int32_t rj = uf_find(parent, j);
              if (ri != rj) parent[ri < rj ? ri : rj] = ri < rj ? rj : ri;
            }
          }
        }
      }
    }
  }
  for (int64_t i = 0; i < n; i++) labels[i] = uf_find(parent, (int32_t)i);

  free(tkey);
  free(thead);
  free(next);
  free(parent);
  return 0;
}
