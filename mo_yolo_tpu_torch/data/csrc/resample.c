/* PIL's `Image.resize` on uint8 images, for `data/letterbox.py`.
 *
 * Replaces the `Image.resize(BILINEAR)` of the JAX package's letterbox and
 * mosaic and the `Image.resize(BICUBIC)` of its mask overlays (the card's
 * machine has no PIL). It repeats the arithmetic of PIL's Resample.c at 8
 * bits a channel, so that the port's resized frames equal the JAX
 * package's byte for byte:
 *
 * - `precompute_coeffs`: scale = in / out, the filter widened by
 *   max(scale, 1) (a shrink antialiases), the taps of output index i from
 *   (int)(centre - support + 0.5) to (int)(centre + support + 0.5),
 *   centre = (i + 0.5) * scale, clamped to the image, each weight the
 *   filter at (x + xmin - centre + 0.5) / max(scale, 1), in double,
 *   divided by their sum where that is not 0;
 * - `normalize_coeffs_8bpc`: each weight as a 22-bit fixed-point integer,
 *   rounded half away from zero;
 * - the 8-bpc passes: each output (1 << 21) + the sum of pixel * weight,
 *   shifted right by 22 and clipped to 0-255; the horizontal pass first,
 *   into a uint8 intermediate, then the vertical one; a pass whose axis
 *   keeps its size is skipped.
 *
 * `Image.resize` reduces nothing first (its `reducing_gap` is None) and
 * does not premultiply RGB or L. Images are uint8 [h][w][c], contiguous,
 * any channel count. Each pass splits its rows among up to MAX_THREADS
 * threads, one per online CPU, where it has MIN_WORK multiply-adds a
 * thread; every output is computed alone, so the split changes no value.
 * Plain C entry point, bound with ctypes; build with -ffp-contract=off,
 * so that no multiply-add is fused where PIL's build rounds the weights
 * twice, and link with -lpthread. */

#define _POSIX_C_SOURCE 200809L

#include <math.h>
#include <pthread.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#define PRECISION_BITS (32 - 8 - 2)
#define MAX_THREADS 8
#define MIN_WORK (1 << 20)

static double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

/* Keys' cubic with a = -0.5, in PIL's order of operations. */
static double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

/* The fixed-point weights of resizing an axis of n_in to n_out: output i
 * reads k[i * ksize + t] at input bounds[2 i] + t, t < bounds[2 i + 1].
 * Returns ksize, or 0 where the memory cannot be had. */
static int coeffs(int n_in, int n_out, int filter, int** bounds_out,
                  int32_t** kk_out) {
  const double support_base = filter ? 2.0 : 1.0;
  double (*f)(double) = filter ? bicubic_filter : bilinear_filter;
  const double scale = (double)n_in / n_out;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = support_base * filterscale;
  const int ksize = (int)ceil(support) * 2 + 1;
  int* bounds = malloc((size_t)n_out * 2 * sizeof(int));
  int32_t* kk = malloc((size_t)n_out * ksize * sizeof(int32_t));
  double* k = malloc((size_t)ksize * sizeof(double));
  if (!bounds || !kk || !k) {
    free(bounds);
    free(kk);
    free(k);
    return 0;
  }
  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < n_out; ++xx) {
    const double center = (xx + 0.5) * scale;
    double ww = 0.0;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > n_in) xmax = n_in;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      const double w = f((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    int32_t* kx = kk + (size_t)xx * ksize;
    for (int x = 0; x < ksize; ++x) {
      double w = 0.0;
      if (x < xmax) w = ww != 0.0 ? k[x] / ww : k[x];
      kx[x] = w < 0 ? (int32_t)(-0.5 + w * (1 << PRECISION_BITS))
                    : (int32_t)(0.5 + w * (1 << PRECISION_BITS));
    }
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  free(k);
  *bounds_out = bounds;
  *kk_out = kk;
  return ksize;
}

static uint8_t clip8(int32_t in) {
  if (in >= (1 << PRECISION_BITS << 8)) return 255;
  if (in <= 0) return 0;
  return (uint8_t)(in >> PRECISION_BITS);
}

/* One pass over rows [r0, r1): of the input for the horizontal pass
 * ([h][w][c] -> [h][n][c]), of the output for the vertical one
 * ([h][w][c] -> [n][w][c]). */
typedef struct {
  const uint8_t* in;
  uint8_t* out;
  int w, c, n;
  const int* bounds;
  const int32_t* kk;
  int ksize, r0, r1;
} Pass;

/* One row of the horizontal pass, all c channels of an output together;
 * inlined with c a constant where the caller names one. */
static inline void horizontal_row(const Pass* p, const uint8_t* row,
                                  uint8_t* o, const int c) {
  for (int xx = 0; xx < p->n; ++xx) {
    const uint8_t* px = row + (size_t)p->bounds[xx * 2] * c;
    const int m = p->bounds[xx * 2 + 1];
    const int32_t* k = p->kk + (size_t)xx * p->ksize;
    int32_t ss[c];
    for (int ch = 0; ch < c; ++ch) ss[ch] = 1 << (PRECISION_BITS - 1);
    for (int x = 0; x < m; ++x, px += c)
      for (int ch = 0; ch < c; ++ch) ss[ch] += px[ch] * k[x];
    for (int ch = 0; ch < c; ++ch) o[xx * c + ch] = clip8(ss[ch]);
  }
}

static void* horizontal(void* arg) {
  const Pass* p = arg;
  const int c = p->c;
  for (int y = p->r0; y < p->r1; ++y) {
    const uint8_t* row = p->in + (size_t)y * p->w * c;
    uint8_t* o = p->out + (size_t)y * p->n * c;
    if (c == 3)
      horizontal_row(p, row, o, 3);
    else if (c == 1)
      horizontal_row(p, row, o, 1);
    else
      horizontal_row(p, row, o, c);
  }
  return NULL;
}

static void* vertical(void* arg) {
  const Pass* p = arg;
  const size_t row = (size_t)p->w * p->c;
  for (int yy = p->r0; yy < p->r1; ++yy) {
    const uint8_t* rows = p->in + (size_t)p->bounds[yy * 2] * row;
    const int m = p->bounds[yy * 2 + 1];
    const int32_t* k = p->kk + (size_t)yy * p->ksize;
    uint8_t* o = p->out + (size_t)yy * row;
    for (size_t i = 0; i < row; ++i) {
      int32_t ss = 1 << (PRECISION_BITS - 1);
      for (int y = 0; y < m; ++y) ss += rows[y * row + i] * k[y];
      o[i] = clip8(ss);
    }
  }
  return NULL;
}

/* Resize the axis of n_in (the rows' width for the horizontal pass, the
 * height for the vertical one) to p.n, `rows` rows, split among threads.
 * Returns 0, or -1 where the weights' memory cannot be had. */
static int run_pass(Pass p, int n_in, int rows, int filter,
                    void* (*fn)(void*)) {
  int* bounds;
  int32_t* kk;
  p.ksize = coeffs(n_in, p.n, filter, &bounds, &kk);
  if (!p.ksize) return -1;
  p.bounds = bounds;
  p.kk = kk;
  const double work = (double)rows * (fn == horizontal ? p.n : p.w) * p.c *
                      (p.ksize / 2);
  long t = sysconf(_SC_NPROCESSORS_ONLN);
  if (t > MAX_THREADS) t = MAX_THREADS;
  if (t > work / MIN_WORK) t = (long)(work / MIN_WORK);
  if (t > rows) t = rows;
  if (t < 1) t = 1;
  Pass jobs[MAX_THREADS];
  pthread_t ids[MAX_THREADS];
  int started[MAX_THREADS] = {0};
  for (int i = 0; i < t; ++i) {
    jobs[i] = p;
    jobs[i].r0 = (int)((long)rows * i / t);
    jobs[i].r1 = (int)((long)rows * (i + 1) / t);
    if (i) started[i] = !pthread_create(&ids[i], NULL, fn, &jobs[i]);
  }
  fn(&jobs[0]);
  for (int i = 1; i < t; ++i) {
    if (started[i])
      pthread_join(ids[i], NULL);
    else
      fn(&jobs[i]);   /* no thread to be had: this one computes it */
  }
  free(bounds);
  free(kk);
  return 0;
}

/* `Image.resize((ow, oh), BILINEAR if filter == 0 else BICUBIC)` of the
 * uint8 [h][w][c] image `in` into `out` [oh][ow][c]. Returns 0, or -1 for
 * an empty input, an unknown filter or memory that cannot be had. */
int resample_u8(const uint8_t* in, int h, int w, int c, uint8_t* out, int oh,
                int ow, int filter) {
  if (h < 1 || w < 1 || c < 1 || oh < 0 || ow < 0 ||
      (filter != 0 && filter != 1))
    return -1;
  if (oh == 0 || ow == 0) return 0;
  const int need_h = ow != w, need_v = oh != h;
  if (!need_h && !need_v) {
    memcpy(out, in, (size_t)h * w * c);
    return 0;
  }
  uint8_t* tmp = need_h && need_v ? malloc((size_t)h * ow * c) : NULL;
  if (need_h && need_v && !tmp) return -1;
  int rc = 0;
  if (need_h) {
    const Pass p = {.in = in, .out = need_v ? tmp : out, .w = w, .c = c,
                    .n = ow};
    rc = run_pass(p, w, h, filter, horizontal);
  }
  if (!rc && need_v) {
    const Pass p = {.in = need_h ? tmp : in, .out = out, .w = ow, .c = c,
                    .n = oh};
    rc = run_pass(p, h, oh, filter, vertical);
  }
  free(tmp);
  return rc;
}
