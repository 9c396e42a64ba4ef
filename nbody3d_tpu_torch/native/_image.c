/* Image encoders' bit-level cores: the JPEG entropy coder and GIF's LZW.
 *
 * Plain C loaded with ctypes (no Python headers); nbody3d_tpu_torch/render
 * builds it with the host C compiler at first use, into
 * nbody3d_tpu_torch/_build/ (_build.load_host_library).  Each function has
 * a plain Python twin that gives the same bytes (render/jpeg.py,
 * render/image.py).
 *
 * nb_jpeg_scan(coef, nblocks, comp, code, size, out, cap)
 *   The entropy-coded segment of a baseline JPEG scan (ITU T.81 F.1.2).
 *   coef:  nblocks * 64 int16 quantized DCT coefficients, each block in
 *          natural (row-major) order, the blocks in scan order
 *   comp:  nblocks int32 component of each block (0 = Y, 1 = Cb, 2 = Cr):
 *          its DC predictor, and its tables (Y: 0 and 1, chroma: 2 and 3)
 *   code, size: 4 x 256 Huffman codes (uint16) and lengths (uint8), tables
 *          DC luma, AC luma, DC chroma, AC chroma, indexed by symbol
 *   Each block: the DC difference's category and bits, then the AC run
 *   lengths in zig-zag order (ZRL for 16 zeros, EOB after the last
 *   non-zero); every 0xFF byte is followed by 0x00; the last byte is
 *   padded with 1 bits.  Returns the bytes written, or -1 past cap.
 *
 * nb_gif_lzw(idx, n, out, cap)
 *   GIF's variable-width LZW code stream of n 8-bit colour indices (minimum
 *   code size 8): a clear code first, codes of 9 up to 12 bits packed from
 *   the low bit, the width growing after a code is written once the next
 *   free code reaches 2^width, a clear code (and a fresh table) when the
 *   table reaches 4,096 codes, the end code last.  Returns the bytes
 *   written, -1 past cap, or -2 when memory runs out.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

typedef struct {
  uint8_t *out;
  int64_t cap, len;
  uint32_t acc; /* pending bits, high-aligned in the low 'nbits' */
  int nbits;
  int overflow;
} JpegBits;

static inline void jpeg_byte(JpegBits *b, uint8_t v) {
  if (b->len + 2 > b->cap) {
    b->overflow = 1;
    return;
  }
  b->out[b->len++] = v;
  if (v == 0xFF) b->out[b->len++] = 0x00;
}

static inline void jpeg_put(JpegBits *b, uint32_t bits, int n) {
  /* n <= 16 bits, written most significant first */
  b->acc = (b->acc << n) | (bits & ((1u << n) - 1u));
  b->nbits += n;
  while (b->nbits >= 8) {
    jpeg_byte(b, (uint8_t)(b->acc >> (b->nbits - 8)));
    b->nbits -= 8;
  }
  b->acc &= (1u << b->nbits) - 1u;
}

static inline int category(int v) {
  int a = v < 0 ? -v : v, c = 0;
  while (a) {
    c++;
    a >>= 1;
  }
  return c;
}

static inline void jpeg_symbol(JpegBits *b, const uint16_t *code, const uint8_t *size, int sym) {
  jpeg_put(b, code[sym], size[sym]);
}

static inline void jpeg_value(JpegBits *b, int v, int cat) {
  /* a negative value goes out as v - 1 in its low cat bits */
  if (cat) jpeg_put(b, (uint32_t)(v < 0 ? v - 1 : v), cat);
}

int64_t nb_jpeg_scan(const int16_t *coef, int64_t nblocks, const int32_t *comp, const uint16_t *code,
                     const uint8_t *size, uint8_t *out, int64_t cap) {
  JpegBits b = {out, cap, 0, 0, 0, 0};
  int pred[3] = {0, 0, 0};
  for (int64_t i = 0; i < nblocks && !b.overflow; i++) {
    const int16_t *blk = coef + i * 64;
    const int c = comp[i] < 0 || comp[i] > 2 ? 0 : comp[i];
    const uint16_t *dc_code = code + (c ? 2 : 0) * 256, *ac_code = code + (c ? 3 : 1) * 256;
    const uint8_t *dc_size = size + (c ? 2 : 0) * 256, *ac_size = size + (c ? 3 : 1) * 256;
    const int diff = blk[0] - pred[c];
    pred[c] = blk[0];
    int cat = category(diff);
    jpeg_symbol(&b, dc_code, dc_size, cat);
    jpeg_value(&b, diff, cat);
    int run = 0;
    for (int k = 1; k < 64; k++) {
      const int v = blk[kZigzag[k]];
      if (v == 0) {
        run++;
        continue;
      }
      while (run > 15) {
        jpeg_symbol(&b, ac_code, ac_size, 0xF0);
        run -= 16;
      }
      cat = category(v);
      jpeg_symbol(&b, ac_code, ac_size, (run << 4) | cat);
      jpeg_value(&b, v, cat);
      run = 0;
    }
    if (run) jpeg_symbol(&b, ac_code, ac_size, 0x00);
  }
  if (b.nbits) jpeg_put(&b, 0x7F, 8 - b.nbits);
  return b.overflow ? -1 : b.len;
}

/* ------------------------------------------------------------------ GIF */
#define LZW_HASH 8192 /* open-addressed (prefix, byte) -> code, > 4,096 */

typedef struct {
  uint8_t *out;
  int64_t cap, len;
  uint32_t acc;
  int nbits;
  int overflow;
} LzwBits;

static inline void lzw_put(LzwBits *b, uint32_t code, int width) {
  b->acc |= code << b->nbits;
  b->nbits += width;
  while (b->nbits >= 8) {
    if (b->len >= b->cap) {
      b->overflow = 1;
      return;
    }
    b->out[b->len++] = (uint8_t)(b->acc & 0xFF);
    b->acc >>= 8;
    b->nbits -= 8;
  }
}

int64_t nb_gif_lzw(const uint8_t *idx, int64_t n, uint8_t *out, int64_t cap) {
  enum { CLEAR = 256, END = 257, FIRST = 258, MAX_CODES = 4096 };
  int32_t *key = malloc(LZW_HASH * sizeof(int32_t));
  int16_t *val = malloc(LZW_HASH * sizeof(int16_t));
  if (!key || !val) {
    free(key);
    free(val);
    return -2;
  }
  LzwBits b = {out, cap, 0, 0, 0, 0};
  int width = 9, next = FIRST;
  memset(key, 0xFF, LZW_HASH * sizeof(int32_t));
  lzw_put(&b, CLEAR, width);
  if (n == 0) {
    free(key);
    free(val);
    lzw_put(&b, END, width);
    if (b.nbits) lzw_put(&b, 0, 8 - b.nbits);
    return b.overflow ? -1 : b.len;
  }
  int prefix = idx[0];
  for (int64_t i = 1; i < n && !b.overflow; i++) {
    const int k = idx[i];
    const int32_t want = (prefix << 8) | k;
    uint32_t h = ((uint32_t)want * 2654435761u) >> 19; /* 13 bits */
    while (key[h] != -1 && key[h] != want) h = (h + 1) & (LZW_HASH - 1);
    if (key[h] == want) {
      prefix = val[h];
      continue;
    }
    lzw_put(&b, (uint32_t)prefix, width);
    if (next >= (1 << width) && width < 12) width++;
    key[h] = want;
    val[h] = (int16_t)next++;
    if (next == MAX_CODES) {
      lzw_put(&b, CLEAR, width);
      memset(key, 0xFF, LZW_HASH * sizeof(int32_t));
      width = 9;
      next = FIRST;
    }
    prefix = k;
  }
  free(key);
  free(val);
  lzw_put(&b, (uint32_t)prefix, width);
  if (next >= (1 << width) && width < 12) width++;
  lzw_put(&b, END, width);
  if (b.nbits) lzw_put(&b, 0, 8 - b.nbits);
  return b.overflow ? -1 : b.len;
}
