/* float32 <-> JSON number arrays for reference-schema checkpoints.
 *
 * The port's copy of nbody3d_tpu/native/_fastjson.c with a plain C
 * interface (loaded with ctypes, no Python headers), built with the host
 * C compiler at first use into nbody3d_tpu_torch/_build/
 * (_build.load_host_library).  The same format and the same parse, so a
 * state gives the JAX package's bytes and a file gives its arrays.
 *
 * nb_dumps_f32(v, n, out, cap)
 *   Writes "[a, b, ...]" (json.dump's ", " separators) into out, each
 *   value %.9g of the float widened to double: nine significant digits
 *   give every float32 back exactly.  Returns the byte count; -1 when
 *   cap is short, -2 under a locale whose decimal point is not '.', -3 at
 *   a value that is not finite (its JSON spelling is json.dump's).
 *
 * nb_scan_f32(buf, len, start, out, cap, end)
 *   Parses the JSON number array at buf[start] == '[' (whitespace before
 *   it skipped): each number by strtod, rounded once to float32.  Writes
 *   the first cap values to out and one past the closing ']' to *end.
 *   Returns the count of values, which may pass cap (then call again with
 *   a larger out); -1 for a malformed array, -2 under a locale whose
 *   decimal point is not '.'.  buf[len] must be a NUL byte (a Python
 *   bytes object's buffer has one), where strtod stops at the latest.
 */
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

/* %.9g and strtod read LC_NUMERIC: under a comma-decimal locale they would
 * write and read other numbers, so both functions refuse to run there. */
static int decimal_point_ok(void) {
  char probe[8];
  snprintf(probe, sizeof probe, "%.1f", 0.5);
  return probe[1] == '.';
}

int64_t nb_dumps_f32(const float *v, int64_t n, char *out, int64_t cap) {
  if (!decimal_point_ok()) return -2;
  int64_t pos = 0;
  if (cap < 2) return -1;
  out[pos++] = '[';
  for (int64_t i = 0; i < n; i++) {
    if (!isfinite(v[i])) return -3;
    if (i) {
      if (cap - pos < 2) return -1;
      out[pos++] = ',';
      out[pos++] = ' ';
    }
    const int64_t room = cap - pos; /* snprintf also writes a NUL */
    if (room < 2) return -1;
    const int wrote = snprintf(out + pos, (size_t)(room < 64 ? room : 64), "%.9g", (double)v[i]);
    if (wrote < 0 || wrote >= room) return -1;
    pos += wrote;
  }
  if (cap - pos < 1) return -1;
  out[pos++] = ']';
  return pos;
}

static int is_space(char c) { return c == ' ' || c == '\n' || c == '\t' || c == '\r'; }

int64_t nb_scan_f32(const char *buf, int64_t len, int64_t start, float *out, int64_t cap, int64_t *end) {
  if (!decimal_point_ok()) return -2;
  if (start < 0) return -1;
  int64_t i = start;
  while (i < len && is_space(buf[i])) i++;
  if (i >= len || buf[i] != '[') return -1;
  i++;
  int64_t cnt = 0;
  for (;;) {
    while (i < len && (is_space(buf[i]) || buf[i] == ',')) i++;
    if (i >= len) return -1; /* unterminated */
    if (buf[i] == ']') {
      i++;
      break;
    }
    char *stop = NULL;
    const double d = strtod(buf + i, &stop);
    if (stop == buf + i || stop > buf + len) return -1;
    if (cnt < cap) out[cnt] = (float)d;
    cnt++;
    i = stop - buf;
  }
  *end = i;
  return cnt;
}
