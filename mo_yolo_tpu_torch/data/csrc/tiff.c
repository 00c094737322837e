/* TIFF strip and tile decompression on the host, for `data/tiff.py`.
 *
 * Replaces libtiff's LZW and PackBits codecs, which PIL runs when the JAX
 * package's `load_image` opens a compressed TIFF; the card's machine has
 * no libtiff. Deflate strips are inflated by Python's zlib. Links nothing.
 *
 * Plain C entry points, bound with ctypes. Each returns the bytes written
 * to `dst` (at most `cap`), or a negative code:
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
