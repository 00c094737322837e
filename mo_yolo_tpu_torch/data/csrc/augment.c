/* Pixel arithmetic of the training augmentations on the host, for
 * `data/augment.py`.
 *
 * Replaces the PIL calls of the JAX package's `mo_yolo_tpu/data/augment.py`
 * (the card's machine has no PIL): the colour conversions behind
 * `convert("HSV")`, `convert("RGB")` from HSV and YCbCr, `convert("L")` and
 * `convert("YCbCr")`; `Image.transform(AFFINE | PERSPECTIVE, BILINEAR)`;
 * `ImageFilter.BoxBlur` and `ImageFilter.MedianFilter` (the JPEG round trip
 * is the port's own codec, `jpeg.c`). Each one repeats PIL's own arithmetic (its types, its rounding, its edge rules),
 * so that the port's augmented frames equal the JAX package's; the tests
 * hold each against PIL (the conversions on all 2^24 inputs).
 *
 * Images are uint8 RGB, [h][w][3], contiguous. Plain C entry points, bound
 * with ctypes; build with -ffp-contract=off, so that no multiply-add is
 * fused where PIL's build rounds twice. */

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define CLIP8(v) ((v) <= 0 ? 0 : (v) < 256 ? (v) : 255)

/* ------------------------------------------------------------------ colour */

/* PIL's rgb2hsv (Convert.c, after colorsys): float ratios, the hue's
 * wrap in double, truncation to 0-255. */
void rgb_to_hsv(const uint8_t* in, uint8_t* out, int64_t n) {
  for (int64_t k = 0; k < n; ++k, in += 3, out += 3) {
    const uint8_t r = in[0], g = in[1], b = in[2];
    const uint8_t maxc = r > g ? (r > b ? r : b) : (g > b ? g : b);
    const uint8_t minc = r < g ? (r < b ? r : b) : (g < b ? g : b);
    uint8_t uh = 0, us = 0;
    if (minc != maxc) {
      const float cr = (float)(maxc - minc);
      const float s = cr / (float)maxc;
      const float rc = ((float)(maxc - r)) / cr;
      const float gc = ((float)(maxc - g)) / cr;
      const float bc = ((float)(maxc - b)) / cr;
      float h;
      if (r == maxc) {
        h = bc - gc;
      } else if (g == maxc) {
        h = 2.0 + rc - bc;
      } else {
        h = 4.0 + gc - rc;
      }
      h = fmod((h / 6.0 + 1.0), 1.0);
      uh = (uint8_t)CLIP8((int)(h * 255.0));
      us = (uint8_t)CLIP8((int)(s * 255.0));
    }
    out[0] = uh;
    out[1] = us;
    out[2] = maxc;
  }
}

/* PIL's hsv2rgb (Convert.c). */
void hsv_to_rgb(const uint8_t* in, uint8_t* out, int64_t n) {
  for (int64_t k = 0; k < n; ++k, in += 3, out += 3) {
    const uint8_t h = in[0], s = in[1], v = in[2];
    if (s == 0) {
      out[0] = out[1] = out[2] = v;
      continue;
    }
    const int i = (int)floor((float)h * 6.0 / 255.0);
    const float f = (float)h * 6.0 / 255.0 - (float)i;
    const float fs = ((float)s) / 255.0;
    const int p = (int)round((float)v * (1.0 - fs));
    const int q = (int)round((float)v * (1.0 - fs * f));
    const int t = (int)round((float)v * (1.0 - fs * (1.0 - f)));
    const uint8_t up = (uint8_t)CLIP8(p), uq = (uint8_t)CLIP8(q),
                  ut = (uint8_t)CLIP8(t);
    switch (i % 6) {
      case 0: out[0] = v; out[1] = ut; out[2] = up; break;
      case 1: out[0] = uq; out[1] = v; out[2] = up; break;
      case 2: out[0] = up; out[1] = v; out[2] = ut; break;
      case 3: out[0] = up; out[1] = uq; out[2] = v; break;
      case 4: out[0] = ut; out[1] = up; out[2] = v; break;
      case 5: out[0] = v; out[1] = up; out[2] = uq; break;
    }
  }
}

/* PIL's rgb2l: ITU-R 601-2 luma in 16-bit fixed point, rounded. */
void rgb_to_l(const uint8_t* in, uint8_t* out, int64_t n) {
  for (int64_t k = 0; k < n; ++k, in += 3)
    out[k] = (uint8_t)((in[0] * 19595 + in[1] * 38470 + in[2] * 7471 +
                        0x8000) >> 16);
}

/* PIL's JFIF YCbCr (ConvertYCbCr.c): per-channel tables of the
 * coefficients times 2^SCALE, summed and shifted back. A table entry is
 * the product plus one half, truncated toward zero (so a negative one
 * rounds up from its half). */
#define YCC_SCALE 6
static int16_t Y_R[256], Y_G[256], Y_B[256], Cb_R[256], Cb_G[256], Cb_B[256],
    Cr_R[256], Cr_G[256], Cr_B[256], R_Cr[256], G_Cb[256], G_Cr[256],
    B_Cb[256];
static int ycc_ready = 0;

static int16_t scaled(double coeff, int v) {
  return (int16_t)(coeff * v * (1 << YCC_SCALE) + 0.5);
}

static void ycc_tables(void) {
  if (ycc_ready) return;
  for (int i = 0; i < 256; ++i) {
    Y_R[i] = scaled(0.29900, i);
    Y_G[i] = scaled(0.58700, i);
    Y_B[i] = scaled(0.11400, i);
    Cb_R[i] = scaled(-0.16874, i);
    Cb_G[i] = scaled(-0.33126, i);
    Cb_B[i] = scaled(0.50000, i);
    Cr_R[i] = scaled(0.50000, i);
    Cr_G[i] = scaled(-0.41869, i);
    Cr_B[i] = scaled(-0.08131, i);
    R_Cr[i] = scaled(1.40200, i - 128);
    G_Cb[i] = scaled(-0.34414, i - 128);
    G_Cr[i] = scaled(-0.71414, i - 128);
    B_Cb[i] = scaled(1.77200, i - 128);
  }
  ycc_ready = 1;
}

void rgb_to_ycbcr(const uint8_t* in, uint8_t* out, int64_t n) {
  ycc_tables();
  for (int64_t k = 0; k < n; ++k, in += 3, out += 3) {
    const int r = in[0], g = in[1], b = in[2];
    out[0] = (uint8_t)((Y_R[r] + Y_G[g] + Y_B[b]) >> YCC_SCALE);
    out[1] = (uint8_t)(((Cb_R[r] + Cb_G[g] + Cb_B[b]) >> YCC_SCALE) + 128);
    out[2] = (uint8_t)(((Cr_R[r] + Cr_G[g] + Cr_B[b]) >> YCC_SCALE) + 128);
  }
}

void ycbcr_to_rgb(const uint8_t* in, uint8_t* out, int64_t n) {
  ycc_tables();
  for (int64_t k = 0; k < n; ++k, in += 3, out += 3) {
    const int y = in[0], cb = in[1], cr = in[2];
    const int r = y + (R_Cr[cr] >> YCC_SCALE);
    const int g = y + ((G_Cb[cb] + G_Cr[cr]) >> YCC_SCALE);
    const int b = y + (B_Cb[cb] >> YCC_SCALE);
    out[0] = (uint8_t)(r <= 0 ? 0 : r >= 255 ? 255 : r);
    out[1] = (uint8_t)(g <= 0 ? 0 : g >= 255 ? 255 : g);
    out[2] = (uint8_t)(b <= 0 ? 0 : b >= 255 ? 255 : b);
  }
}

/* ------------------------------------------------------------------- warp */

/* PIL's generic transform with its bilinear filter (Geometry.c): output
 * pixel (x, y) maps its centre (x + 0.5, y + 0.5) through the inverse
 * coefficients a[0..5] (affine) or a[0..7] (perspective, a[6], a[7] the
 * last row, its corner 1); a point outside [0, w) x [0, h) keeps `fill`;
 * inside, the four neighbours of (x - 0.5, y - 0.5), clamped to the
 * image, are blended in double and truncated. The filter does not widen
 * when the map shrinks (no antialiasing), as PIL's does not. */
void warp_bilinear(const uint8_t* in, int h, int w, uint8_t* out, int oh,
                   int ow, const double* a, int perspective, int fill) {
  for (int y = 0; y < oh; ++y) {
    for (int x = 0; x < ow; ++x) {
      uint8_t* o = out + ((size_t)y * ow + x) * 3;
      const double xin = x + 0.5, yin = y + 0.5;
      double xx, yy;
      if (perspective) {
        xx = (a[0] * xin + a[1] * yin + a[2]) / (a[6] * xin + a[7] * yin + 1);
        yy = (a[3] * xin + a[4] * yin + a[5]) / (a[6] * xin + a[7] * yin + 1);
      } else {
        xx = a[0] * xin + a[1] * yin + a[2];
        yy = a[3] * xin + a[4] * yin + a[5];
      }
      if (xx < 0.0 || xx >= w || yy < 0.0 || yy >= h) {
        o[0] = o[1] = o[2] = (uint8_t)fill;
        continue;
      }
      xx -= 0.5;
      yy -= 0.5;
      const int xi = xx < 0.0 ? (int)floor(xx) : (int)xx;
      const int yi = yy < 0.0 ? (int)floor(yy) : (int)yy;
      const double dx = xx - xi, dy = yy - yi;
      const int x0 = xi < 0 ? 0 : xi >= w ? w - 1 : xi;
      const int x1 = xi + 1 < 0 ? 0 : xi + 1 >= w ? w - 1 : xi + 1;
      const int yc = yi < 0 ? 0 : yi >= h ? h - 1 : yi;
      const uint8_t* r0 = in + (size_t)yc * w * 3;
      const int has_y1 = yi + 1 >= 0 && yi + 1 < h;
      const uint8_t* r1 = in + (size_t)(yi + 1) * w * 3;
      for (int c = 0; c < 3; ++c) {
        double v1 = r0[x0 * 3 + c] + (r0[x1 * 3 + c] - r0[x0 * 3 + c]) * dx;
        double v2 = v1;
        if (has_y1)
          v2 = r1[x0 * 3 + c] + (r1[x1 * 3 + c] - r1[x0 * 3 + c]) * dx;
        v1 = v1 + (v2 - v1) * dy;
        o[c] = (uint8_t)v1;
      }
    }
  }
}

/* ------------------------------------------------------------------ blurs */

/* One line of PIL's box blur (BoxBlur.c) over n pixels `stride` bytes
 * apart, per channel: the 2r+1 pixels around x, edges repeated, weighted
 * ww, and the two pixels just outside weighted fw, in 24-bit fixed point,
 * rounded. */
static void box_line(const uint8_t* in, uint8_t* out, int n, size_t stride,
                     int r, uint32_t ww, uint32_t fw) {
  for (int x = 0; x < n; ++x) {
    for (int c = 0; c < 3; ++c) {
      uint32_t acc = 0;
      for (int k = -r; k <= r; ++k) {
        const int i = x + k < 0 ? 0 : x + k >= n ? n - 1 : x + k;
        acc += in[i * stride + c];
      }
      const int lo = x - r - 1 < 0 ? 0 : x - r - 1 >= n ? n - 1 : x - r - 1;
      const int hi = x + r + 1 < 0 ? 0 : x + r + 1 >= n ? n - 1 : x + r + 1;
      const uint32_t bulk =
          acc * ww + (uint32_t)(in[lo * stride + c] + in[hi * stride + c]) * fw;
      out[x * stride + c] = (uint8_t)((bulk + (1u << 23)) >> 24);
    }
  }
}

/* PIL's BoxBlur(radius) at an integer radius: rows first, rounded to
 * uint8, then columns. `tmp` holds h*w*3 bytes. */
void box_blur(const uint8_t* in, uint8_t* tmp, uint8_t* out, int h, int w,
              int radius) {
  const float fr = (float)radius;
  const uint32_t ww = (uint32_t)((float)(1 << 24) / (fr * 2 + 1));
  const uint32_t fw = ((1 << 24) - (radius * 2 + 1) * ww) / 2;
  for (int y = 0; y < h; ++y)
    box_line(in + (size_t)y * w * 3, tmp + (size_t)y * w * 3, w, 3, radius, ww,
             fw);
  for (int x = 0; x < w; ++x)
    box_line(tmp + (size_t)x * 3, out + (size_t)x * 3, h, (size_t)w * 3,
             radius, ww, fw);
}

/* PIL's MedianFilter(k): per channel, the middle of the k*k window
 * around each pixel, the image's edges repeated (PIL expands the image by
 * k/2 on each side first). */
void median_filter(const uint8_t* in, uint8_t* out, int h, int w, int k) {
  const int r = k / 2, mid = k * k / 2;
  int hist[256];
  for (int c = 0; c < 3; ++c) {
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        memset(hist, 0, sizeof hist);
        for (int dy = -r; dy <= r; ++dy) {
          const int yy = y + dy < 0 ? 0 : y + dy >= h ? h - 1 : y + dy;
          for (int dx = -r; dx <= r; ++dx) {
            const int xx = x + dx < 0 ? 0 : x + dx >= w ? w - 1 : x + dx;
            ++hist[in[((size_t)yy * w + xx) * 3 + c]];
          }
        }
        int seen = 0, v = 0;
        for (; v < 256; ++v) {
          seen += hist[v];
          if (seen > mid) break;
        }
        out[((size_t)y * w + x) * 3 + c] = (uint8_t)v;
      }
    }
  }
}
