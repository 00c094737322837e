/* Frame decoding on the host: raw uint8 rows for `data/decode.py`.
 *
 * Replaces PIL's decoders in `load_image` (the JAX package's
 * `mo_yolo_tpu/data/loaders.py`), which the card's machine does not have.
 *
 * PNG: Python's zlib inflates the IDAT stream; `png_unfilter` undoes the
 * five per-row filters (None, Sub, Up, Average, Paeth) in place of a
 * library. Average and Paeth depend on the byte just decoded to their left,
 * so a row is a sequential loop, which numpy cannot express in one call.
 *
 * JPEG is the port's own codec, `jpeg.c`.
 *
 * Plain C entry points, bound with ctypes. */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

/* src: `height` rows of 1 + `stride` bytes, each a filter type byte and the
 * filtered row; dst: height * stride bytes. `bpp` is the bytes a pixel (1
 * for depths below 8 bits), the distance to the byte "to the left".
 * Returns 0, or 1 + the row whose filter type is not 0-4. */
int png_unfilter(const uint8_t* src, uint8_t* dst, int height,
                 long long stride, int bpp) {
  const uint8_t* prev = NULL;  /* the row above, unfiltered; none for row 0 */
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = src + (long long)y * (stride + 1);
    uint8_t* out = dst + (long long)y * stride;
    const int type = in[0];
    ++in;
    switch (type) {
      case 0:
        memcpy(out, in, (size_t)stride);
        break;
      case 1:
        for (long long i = 0; i < stride; ++i)
          out[i] = (uint8_t)(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (long long i = 0; i < stride; ++i)
          out[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (long long i = 0; i < stride; ++i) {
          const int left = i >= bpp ? out[i - bpp] : 0;
          const int up = prev ? prev[i] : 0;
          out[i] = (uint8_t)(in[i] + ((left + up) >> 1));
        }
        break;
      case 4:
        for (long long i = 0; i < stride; ++i) {
          const int left = i >= bpp ? out[i - bpp] : 0;
          const int up = prev ? prev[i] : 0;
          const int ul = (prev && i >= bpp) ? prev[i - bpp] : 0;
          out[i] = (uint8_t)(in[i] + paeth(left, up, ul));
        }
        break;
      default:
        return y + 1;
    }
    prev = out;
  }
  return 0;
}
