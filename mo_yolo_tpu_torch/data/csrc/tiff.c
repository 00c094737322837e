/* TIFF strip and tile decompression on the host, for `data/tiff.py`.
 *
 * Replaces libtiff's LZW and PackBits codecs, which PIL runs when the JAX
 * package's `load_image` opens a compressed TIFF; the card's machine has
 * no libtiff. Deflate strips are inflated by Python's zlib. Links nothing.
 *
 * And PIL's CIELab -> RGB (`tiff_lab_rgb`): the LittleCMS transform PIL
 * builds for `convert("RGB")` of mode LAB, whose 8-bit path is a
 * tetrahedral interpolation (cmsintrp.c TetrahedralInterp16) in a 33^3
 * table of 16-bit RGB; the table, lab_srgb_clut.u16 beside data/tiff.py,
 * is LittleCMS's own (tests/data/tiff/make_fixtures.py writes it).
 *
 * Plain C entry points, bound with ctypes. The codecs return the bytes
 * written to `dst` (at most `cap`), or a negative code:
 *   -1  the data ends before an end code (LZW) or a run (PackBits)
 *   -2  an LZW code that is not yet in the table
 *   -3  old-style (LSB-first) LZW, which libtiff reads and this does not
 * Decoding stops once `cap` bytes are written, as libtiff stops at the
 * strip's size. */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define LZW_CLEAR 256
#define LZW_EOI 257
#define LZW_MAX_BITS 12
#define LZW_TABLE (1 << LZW_MAX_BITS)

/* TIFF 6.0 LZW: MSB-first codes of 9 to 12 bits, the width growing one
 * code early (at 511, 1023 and 2047 entries), as libtiff's LZWDecode. */
long long tiff_lzw(const uint8_t *src, long long n, uint8_t *dst,
                   long long cap) {
  static __thread uint16_t prefix[LZW_TABLE];
  static __thread uint8_t suffix[LZW_TABLE], first[LZW_TABLE];
  static __thread uint16_t length[LZW_TABLE];
  uint8_t stack[LZW_TABLE];
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) return -3;
  for (int i = 0; i < 256; ++i) {
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
    prefix[i] = 0xFFFF;
  }
  long long out = 0, bitpos = 0, nbits_total = n * 8;
  int nbits = 9, next = 258, old = -1;
  while (out < cap) {
    if (bitpos + nbits > nbits_total) return -1;
    int code = 0;
    for (int k = 0; k < nbits; ++k, ++bitpos)
      code = (code << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    if (code == LZW_EOI) break;
    if (code == LZW_CLEAR) {
      nbits = 9;
      next = 258;
      old = -1;
      continue;
    }
    int emit;
    if (old < 0) {
      if (code >= 256) return -2;
      emit = code;
    } else if (code < next) {
      emit = code;
      if (next < LZW_TABLE) {
        prefix[next] = (uint16_t)old;
        suffix[next] = first[code];
        first[next] = first[old];
        length[next] = (uint16_t)(length[old] + 1);
        ++next;
      }
    } else if (code == next && next < LZW_TABLE) {
      prefix[next] = (uint16_t)old;
      suffix[next] = first[old];
      first[next] = first[old];
      length[next] = (uint16_t)(length[old] + 1);
      emit = next++;
    } else {
      return -2;
    }
    /* the string of `emit`, written back to front */
    int len = length[emit], c = emit;
    for (int k = len - 1; k >= 0; --k) {
      stack[k] = suffix[c];
      c = prefix[c];
    }
    long long take = len < cap - out ? len : cap - out;
    memcpy(dst + out, stack, (size_t)take);
    out += take;
    old = emit;
    if (next + 1 >= (1 << nbits) && nbits < LZW_MAX_BITS) ++nbits;
  }
  return out;
}

/* PackBits: a header byte n, then n + 1 literal bytes (n >= 0), or one
 * byte repeated 1 - n times (n in -127..-1); -128 is skipped. */
long long tiff_packbits(const uint8_t *src, long long n, uint8_t *dst,
                        long long cap) {
  long long in = 0, out = 0;
  while (out < cap) {
    if (in >= n) return -1;
    int h = (int8_t)src[in++];
    if (h >= 0) {
      long long len = h + 1;
      if (in + len > n) return -1;
      if (len > cap - out) len = cap - out;
      memcpy(dst + out, src + in, (size_t)len);
      in += h + 1;
      out += len;
    } else if (h != -128) {
      if (in >= n) return -1;
      long long len = 1 - h;
      if (len > cap - out) len = cap - out;
      memset(dst + out, src[in++], (size_t)len);
      out += len;
    }
  }
  return out;
}

#define LAB_GRID 33

/* lcms2's _cmsToFixedDomain */
static inline int to_fixed(int a) { return a + ((a + 0x7fff) / 0xffff); }

/* n pixels of PIL's LAB (L, a + 128, b + 128) to RGB: each byte widened
 * to 16 bits (v * 257), TetrahedralInterp16 over `clut` ([L][a][b][3]),
 * each result narrowed as lcms2's FROM_16_TO_8. */
void tiff_lab_rgb(const uint8_t *lab, long long n, const uint16_t *clut,
                  uint8_t *rgb) {
  const int opta0 = 3, opta1 = 3 * LAB_GRID, opta2 = 3 * LAB_GRID * LAB_GRID;
  for (long long i = 0; i < n; ++i) {
    const int in0 = lab[3 * i] * 257, in1 = lab[3 * i + 1] * 257,
              in2 = lab[3 * i + 2] * 257;
    const int fx = to_fixed(in0 * (LAB_GRID - 1)),
              fy = to_fixed(in1 * (LAB_GRID - 1)),
              fz = to_fixed(in2 * (LAB_GRID - 1));
    const int rx = fx & 0xffff, ry = fy & 0xffff, rz = fz & 0xffff;
    const int x0 = fx >> 16, y0 = fy >> 16, z0 = fz >> 16;
    int X1 = in0 == 0xffff ? 0 : opta2, Y1 = in1 == 0xffff ? 0 : opta1,
        Z1 = in2 == 0xffff ? 0 : opta0;
    const uint16_t *t = clut + opta2 * x0 + opta1 * y0 + opta0 * z0;
    /* the corner offsets of the tetrahedron, as TetrahedralInterp16 */
    int o1, o2, o3, order;
    if (rx >= ry) {
      if (ry >= rz) {
        order = 0; o1 = X1; o2 = X1 + Y1; o3 = X1 + Y1 + Z1;
      } else if (rz >= rx) {
        order = 1; o1 = X1 + Z1; o2 = X1 + Y1 + Z1; o3 = Z1;
      } else {
        order = 2; o1 = X1; o2 = X1 + Y1 + Z1; o3 = X1 + Z1;
      }
    } else {
      if (rx >= rz) {
        order = 3; o1 = X1 + Y1; o2 = Y1; o3 = X1 + Y1 + Z1;
      } else if (ry >= rz) {
        order = 4; o1 = X1 + Y1 + Z1; o2 = Y1; o3 = Y1 + Z1;
      } else {
        order = 5; o1 = X1 + Y1 + Z1; o2 = Y1 + Z1; o3 = Z1;
      }
    }
    for (int ch = 0; ch < 3; ++ch) {
      const int c0 = t[ch], v1 = t[o1 + ch], v2 = t[o2 + ch], v3 = t[o3 + ch];
      int c1, c2, c3;
      switch (order) {
        case 0: c1 = v1 - c0; c2 = v2 - v1; c3 = v3 - v2; break;
        case 1: c1 = v1 - v3; c2 = v2 - v1; c3 = v3 - c0; break;
        case 2: c1 = v1 - c0; c2 = v2 - v3; c3 = v3 - v1; break;
        case 3: c1 = v1 - v2; c2 = v2 - c0; c3 = v3 - v1; break;
        case 4: c1 = v1 - v3; c2 = v2 - c0; c3 = v3 - v2; break;
        default: c1 = v1 - v2; c2 = v2 - v3; c3 = v3 - c0; break;
      }
      const long long rest = (long long)c1 * rx + (long long)c2 * ry +
                             (long long)c3 * rz + 0x8001;
      const unsigned v = (unsigned)(c0 + ((rest + (rest >> 16)) >> 16)) &
                         0xffff;
      rgb[3 * i + ch] = (uint8_t)((v * 65281u + 8388608u) >> 24);
    }
  }
}

/* libtiff's tif_color.c: TIFFYCbCrToRGBInit's tables (in float, as there)
 * and TIFFYCbCrtoRGB, for YCbCr strips PIL reads through libtiff's RGBA
 * interface (`tiff_ycbcr_rgb`: n pixels of Y, Cb, Cr to RGB). */
#define YCC_SHIFT 16
#define YCC_FIX(x) ((int32_t)((x) * (1L << YCC_SHIFT) + 0.5))
#define YCC_HALF ((int32_t)(1 << (YCC_SHIFT - 1)))
#define YCC_CODE2V(c, RB, RW, CR)                       \
  ((((c) - (int32_t)(RB)) * (float)(CR)) /              \
   (float)(((RW) - (RB) != 0) ? ((RW) - (RB)) : 1))
#define YCC_CLAMP(f, lo, hi) ((f) < (lo) ? (lo) : (f) > (hi) ? (hi) : (f))
#define YCC_CLAMPW(f, lo, hi) \
  ((float)(f) < (lo) ? (lo) : (float)(f) > (hi) ? (hi) : (f))

void tiff_ycbcr_rgb(const uint8_t *ycc, long long n, const float *luma,
                    const float *refbw, uint8_t *rgb) {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y_t[256];
  const float f1 = 2 - 2 * luma[0];
  const int32_t d1 = YCC_FIX(YCC_CLAMP(f1, 0.0F, 2.0F));
  const float f2 = luma[0] * f1 / luma[1];
  const int32_t d2 = -YCC_FIX(YCC_CLAMP(f2, 0.0F, 2.0F));
  const float f3 = 2 - 2 * luma[2];
  const int32_t d3 = YCC_FIX(YCC_CLAMP(f3, 0.0F, 2.0F));
  const float f4 = luma[2] * f3 / luma[1];
  const int32_t d4 = -YCC_FIX(YCC_CLAMP(f4, 0.0F, 2.0F));
  for (int i = 0, x = -128; i < 256; i++, x++) {
    const int32_t cr = (int32_t)YCC_CLAMPW(
        YCC_CODE2V(x, refbw[4] - 128.0F, refbw[5] - 128.0F, 127),
        -128.0F * 32, 128.0F * 32);
    const int32_t cb = (int32_t)YCC_CLAMPW(
        YCC_CODE2V(x, refbw[2] - 128.0F, refbw[3] - 128.0F, 127),
        -128.0F * 32, 128.0F * 32);
    cr_r[i] = (int32_t)((d1 * cr + YCC_HALF) >> YCC_SHIFT);
    cb_b[i] = (int32_t)((d3 * cb + YCC_HALF) >> YCC_SHIFT);
    cr_g[i] = d2 * cr;
    cb_g[i] = d4 * cb + YCC_HALF;
    y_t[i] = (int32_t)YCC_CLAMPW(
        YCC_CODE2V(x + 128, refbw[0], refbw[1], 255), -128.0F * 32,
        128.0F * 32);
  }
  for (long long k = 0; k < n; ++k) {
    const int y = ycc[3 * k], cb = ycc[3 * k + 1], cr = ycc[3 * k + 2];
    int32_t v = y_t[y] + cr_r[cr];
    rgb[3 * k] = (uint8_t)YCC_CLAMP(v, 0, 255);
    v = y_t[y] + (int32_t)((cb_g[cb] + cr_g[cr]) >> YCC_SHIFT);
    rgb[3 * k + 1] = (uint8_t)YCC_CLAMP(v, 0, 255);
    v = y_t[y] + cb_b[cb];
    rgb[3 * k + 2] = (uint8_t)YCC_CLAMP(v, 0, 255);
  }
}
