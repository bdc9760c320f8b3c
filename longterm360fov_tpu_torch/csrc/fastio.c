/* fastio: the two host hot paths of trace ingest, in plain C.
 *
 *   fastio_parse_trace: numeric log text -> float32 (rows, cols), one pass.
 *       Commas, spaces, tabs and carriage returns separate values; blank
 *       lines and lines starting with '#' are skipped; a line with a token
 *       that is not a number (a header) is dropped. The column count is
 *       n_cols, or the first numeric row's when n_cols is 0; longer rows are
 *       truncated, shorter ones dropped. Values are parsed as doubles
 *       (strtod) and rounded to float32 at the end.
 *
 *   fastio_window_fill: a (T, D) float32 trace -> its packed sliding windows,
 *       written into caller-provided C-contiguous (N, h_in, D) past and
 *       (N, h_out, D) future buffers; with past NULL only the futures,
 *       offset by h_in.
 *
 * The interface is plain C over caller buffers, loaded with ctypes by
 * longterm360fov_tpu_torch/native.py, which checks shapes and types before
 * each call. Build: cc -O3 -shared -fPIC fastio.c -o libfastio.so
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum { FASTIO_OK = 0, FASTIO_TOO_WIDE = 1, FASTIO_NO_MEMORY = 2, FASTIO_BAD_COLS = 3 };

#define MAX_COLS 64

static int is_sep(char c) { return c == ',' || c == ' ' || c == '\t' || c == '\r'; }

void fastio_free(void *p) { free(p); }

/* Parse `len` bytes of `buf` (not NUL-terminated). On FASTIO_OK, *out holds
 * rows * cols floats, allocated with malloc (free with fastio_free; NULL when
 * there are no rows). */
int fastio_parse_trace(const char *buf, int64_t len, int64_t want_cols, float **out, int64_t *rows,
                       int64_t *cols) {
  *out = NULL;
  *rows = 0;
  *cols = 0;
  if (want_cols < 0 || want_cols > MAX_COLS) return FASTIO_BAD_COLS;

  const char *p = buf;
  const char *end = buf + len;
  size_t cap = 1024, n_vals = 0;
  double *vals = (double *)malloc(cap * sizeof(double));
  if (!vals) return FASTIO_NO_MEMORY;
  /* strtod needs NUL-terminated text: each line is copied into a scratch */
  size_t scratch_cap = 256;
  char *scratch = (char *)malloc(scratch_cap);
  if (!scratch) {
    free(vals);
    return FASTIO_NO_MEMORY;
  }
  int64_t n_cols = want_cols, n_rows = 0;
  double row[MAX_COLS];
  int status = FASTIO_OK;

  while (p < end) {
    const char *eol = (const char *)memchr(p, '\n', (size_t)(end - p));
    if (!eol) eol = end;
    const char *s = p;
    while (s < eol && is_sep(*s)) s++;
    if (s >= eol || *s == '#') {
      p = eol + 1;
      continue;
    }
    size_t line_len = (size_t)(eol - s);
    if (line_len + 1 > scratch_cap) {
      while (line_len + 1 > scratch_cap) scratch_cap *= 2;
      char *grown = (char *)realloc(scratch, scratch_cap);
      if (!grown) {
        status = FASTIO_NO_MEMORY;
        break;
      }
      scratch = grown;
    }
    memcpy(scratch, s, line_len);
    scratch[line_len] = '\0';

    const char *q = scratch, *qend = scratch + line_len;
    int64_t c = 0; /* numeric tokens on the line */
    int bad = 0;
    while (q < qend) {
      char *next;
      double v = strtod(q, &next);
      if (next == q) { /* a token that is not a number: drop the row */
        bad = 1;
        break;
      }
      if (c < MAX_COLS) row[c] = v; /* keep the first 64, count them all */
      c++;
      q = next;
      while (q < qend && is_sep(*q)) q++;
    }
    if (!bad && n_cols == 0 && c > MAX_COLS) {
      status = FASTIO_TOO_WIDE; /* the width cannot be inferred from this row */
      break;
    }
    if (!bad && c > 0) {
      if (n_cols == 0) n_cols = c;
      if (c >= n_cols) {
        if (n_vals + (size_t)n_cols > cap) {
          while (n_vals + (size_t)n_cols > cap) cap *= 2;
          double *grown = (double *)realloc(vals, cap * sizeof(double));
          if (!grown) {
            status = FASTIO_NO_MEMORY;
            break;
          }
          vals = grown;
        }
        memcpy(vals + n_vals, row, (size_t)n_cols * sizeof(double));
        n_vals += (size_t)n_cols;
        n_rows++;
      }
    }
    p = eol + 1;
  }
  free(scratch);
  if (status != FASTIO_OK) {
    free(vals);
    return status;
  }
  float *f = NULL;
  if (n_vals) {
    f = (float *)malloc(n_vals * sizeof(float));
    if (!f) {
      free(vals);
      return FASTIO_NO_MEMORY;
    }
    for (size_t i = 0; i < n_vals; i++) f[i] = (float)vals[i];
  }
  free(vals);
  *out = f;
  *rows = n_rows;
  *cols = n_cols;
  return FASTIO_OK;
}

/* Window i covers trace rows [i * stride, i * stride + h_in + h_out). The
 * caller has checked that (n - 1) * stride + h_in + h_out <= T. */
void fastio_window_fill(const float *trace, int64_t d, float *past, float *future, int64_t n, int64_t h_in,
                        int64_t h_out, int64_t stride) {
  size_t row_in = (size_t)(h_in * d), row_out = (size_t)(h_out * d);
  for (int64_t i = 0; i < n; i++) {
    const float *base = trace + (size_t)(i * stride) * (size_t)d;
    if (past) memcpy(past + (size_t)i * row_in, base, row_in * sizeof(float));
    memcpy(future + (size_t)i * row_out, base + row_in, row_out * sizeof(float));
  }
}
