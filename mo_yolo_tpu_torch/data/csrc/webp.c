/* WebP decoding on the host, for `data/webp.py`: the lossless (VP8L) and
 * lossy (VP8) bitstreams to RGB, as libwebp decodes them for PIL's
 * `WebPImagePlugin` (the JAX package's `load_image`); the card's machine
 * has no libwebp. Links nothing but libc.
 *
 * VP8L: prefix codes with meta (entropy-image) groups, the color cache,
 * LZ77 backward references with the 120-entry distance map, and the
 * predictor, cross-color, subtract-green and color-indexing transforms.
 * VP8 (RFC 6386 key frames): the boolean decoder, segments, token
 * probabilities, intra modes, dequantisation, the WHT and IDCT, the simple
 * and normal loop filters, then libwebp's fancy upsampler and its 14-bit
 * YUV -> RGB. Each step mirrors libwebp's arithmetic, so the pixels equal
 * PIL's. Alpha (ALPH, or the alpha of VP8L) is not needed: RGB conversion
 * drops it.
 *
 * Plain C entry points, bound with ctypes. Each returns 0, or non-zero
 * with a message in `err` (256 bytes). */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* RFC 6386 tables (section 14.1 quantizer steps, 13.5 default token
 * probabilities, 13.4 their update probabilities, 11.5 sub-block mode
 * probabilities in libwebp's mode order) and the VP8L distance map. */
static const uint8_t kDcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
  18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
  29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
  44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
  59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
  75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
  91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
  122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
static const uint16_t kAcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
  20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
  36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
  52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
  78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
  110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
  155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
  213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
static const uint8_t CoeffsProba0[4][8][3][11] = {
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
  189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
  106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
  1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
  181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
  78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
  1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
  184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
  77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
  1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
  170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
  37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
  1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
  207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
  102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
  1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
  177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
  80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
  131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
  68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
  1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
  184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
  81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
  1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
  99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
  23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
  1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
  109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
  44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
  1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
  94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
  22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
  1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
  124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
  35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
  1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
  121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
  45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
  1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
  203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
  253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
  175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
  73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
  1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
  239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
  155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
  1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
  201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
  69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
  1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
  223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
  141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
  149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
  213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
  55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
  126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
  61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
  1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
  166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
  39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
  1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
  124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
  24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
  1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
  149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
  28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
  1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
  123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
  20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
  1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
  168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
  47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
  1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
  141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
  42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
static const uint8_t CoeffsUpdateProba[4][8][3][11] = {
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
  250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
  234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
  251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
static const uint8_t kBModesProba[10][10][9] = {
  231, 120, 48, 89, 115, 113, 120, 152, 112,
  152, 179, 64, 126, 170, 118, 46, 70, 95,
  175, 69, 143, 80, 85, 82, 72, 155, 103,
  56, 58, 10, 171, 218, 189, 17, 13, 152,
  114, 26, 17, 163, 44, 195, 21, 10, 173,
  121, 24, 80, 195, 26, 62, 44, 64, 85,
  144, 71, 10, 38, 171, 213, 144, 34, 26,
  170, 46, 55, 19, 136, 160, 33, 206, 71,
  63, 20, 8, 114, 114, 208, 12, 9, 226,
  81, 40, 11, 96, 182, 84, 29, 16, 36,
  134, 183, 89, 137, 98, 101, 106, 165, 148,
  72, 187, 100, 130, 157, 111, 32, 75, 80,
  66, 102, 167, 99, 74, 62, 40, 234, 128,
  41, 53, 9, 178, 241, 141, 26, 8, 107,
  74, 43, 26, 146, 73, 166, 49, 23, 157,
  65, 38, 105, 160, 51, 52, 31, 115, 128,
  104, 79, 12, 27, 217, 255, 87, 17, 7,
  87, 68, 71, 44, 114, 51, 15, 186, 23,
  47, 41, 14, 110, 182, 183, 21, 17, 194,
  66, 45, 25, 102, 197, 189, 23, 18, 22,
  88, 88, 147, 150, 42, 46, 45, 196, 205,
  43, 97, 183, 117, 85, 38, 35, 179, 61,
  39, 53, 200, 87, 26, 21, 43, 232, 171,
  56, 34, 51, 104, 114, 102, 29, 93, 77,
  39, 28, 85, 171, 58, 165, 90, 98, 64,
  34, 22, 116, 206, 23, 34, 43, 166, 73,
  107, 54, 32, 26, 51, 1, 81, 43, 31,
  68, 25, 106, 22, 64, 171, 36, 225, 114,
  34, 19, 21, 102, 132, 188, 16, 76, 124,
  62, 18, 78, 95, 85, 57, 50, 48, 51,
  193, 101, 35, 159, 215, 111, 89, 46, 111,
  60, 148, 31, 172, 219, 228, 21, 18, 111,
  112, 113, 77, 85, 179, 255, 38, 120, 114,
  40, 42, 1, 196, 245, 209, 10, 25, 109,
  88, 43, 29, 140, 166, 213, 37, 43, 154,
  61, 63, 30, 155, 67, 45, 68, 1, 209,
  100, 80, 8, 43, 154, 1, 51, 26, 71,
  142, 78, 78, 16, 255, 128, 34, 197, 171,
  41, 40, 5, 102, 211, 183, 4, 1, 221,
  51, 50, 17, 168, 209, 192, 23, 25, 82,
  138, 31, 36, 171, 27, 166, 38, 44, 229,
  67, 87, 58, 169, 82, 115, 26, 59, 179,
  63, 59, 90, 180, 59, 166, 93, 73, 154,
  40, 40, 21, 116, 143, 209, 34, 39, 175,
  47, 15, 16, 183, 34, 223, 49, 45, 183,
  46, 17, 33, 183, 6, 98, 15, 32, 183,
  57, 46, 22, 24, 128, 1, 54, 17, 37,
  65, 32, 73, 115, 28, 128, 23, 128, 205,
  40, 3, 9, 115, 51, 192, 18, 6, 223,
  87, 37, 9, 115, 59, 77, 64, 21, 47,
  104, 55, 44, 218, 9, 54, 53, 130, 226,
  64, 90, 70, 205, 40, 41, 23, 26, 57,
  54, 57, 112, 184, 5, 41, 38, 166, 213,
  30, 34, 26, 133, 152, 116, 10, 32, 134,
  39, 19, 53, 221, 26, 114, 32, 73, 255,
  31, 9, 65, 234, 2, 15, 1, 118, 73,
  75, 32, 12, 51, 192, 255, 160, 43, 51,
  88, 31, 35, 67, 102, 85, 55, 186, 85,
  56, 21, 23, 111, 59, 205, 45, 37, 192,
  55, 38, 70, 124, 73, 102, 1, 34, 98,
  125, 98, 42, 88, 104, 85, 117, 175, 82,
  95, 84, 53, 89, 128, 100, 113, 101, 45,
  75, 79, 123, 47, 51, 128, 81, 171, 1,
  57, 17, 5, 71, 102, 57, 53, 41, 49,
  38, 33, 13, 121, 57, 73, 26, 1, 85,
  41, 10, 67, 138, 77, 110, 90, 47, 114,
  115, 21, 2, 10, 102, 255, 166, 23, 6,
  101, 29, 16, 10, 85, 128, 101, 196, 26,
  57, 18, 10, 102, 102, 213, 34, 20, 43,
  117, 20, 15, 36, 163, 128, 68, 1, 26,
  102, 61, 71, 37, 34, 53, 31, 243, 192,
  69, 60, 71, 38, 73, 119, 28, 222, 37,
  68, 45, 128, 34, 1, 47, 11, 245, 171,
  62, 17, 19, 70, 146, 85, 55, 62, 70,
  37, 43, 37, 154, 100, 163, 85, 160, 1,
  63, 9, 92, 136, 28, 64, 32, 201, 85,
  75, 15, 9, 9, 64, 255, 184, 119, 16,
  86, 6, 28, 5, 64, 255, 25, 248, 1,
  56, 8, 17, 132, 137, 255, 55, 116, 128,
  58, 15, 20, 82, 135, 57, 26, 121, 40,
  164, 50, 31, 137, 154, 133, 25, 35, 218,
  51, 103, 44, 131, 131, 123, 31, 6, 158,
  86, 40, 64, 135, 148, 224, 45, 183, 128,
  22, 26, 17, 131, 240, 154, 14, 1, 209,
  45, 16, 21, 91, 64, 222, 7, 1, 197,
  56, 21, 39, 155, 60, 138, 23, 102, 213,
  83, 12, 13, 54, 192, 255, 68, 47, 28,
  85, 26, 85, 85, 128, 128, 32, 146, 171,
  18, 11, 7, 63, 144, 171, 4, 4, 246,
  35, 27, 10, 146, 174, 171, 12, 26, 128,
  190, 80, 35, 99, 180, 80, 126, 54, 45,
  85, 126, 47, 87, 176, 51, 41, 20, 32,
  101, 75, 128, 139, 118, 146, 116, 128, 85,
  56, 41, 15, 176, 236, 85, 37, 9, 62,
  71, 30, 17, 119, 118, 255, 17, 18, 138,
  101, 38, 60, 138, 55, 70, 43, 26, 142,
  146, 36, 19, 30, 171, 255, 97, 27, 20,
  138, 45, 61, 62, 219, 1, 81, 188, 64,
  32, 41, 20, 117, 151, 142, 20, 21, 163,
  112, 19, 12, 61, 195, 128, 48, 4, 24,
};
static const uint8_t kCodeToPlane[120] = {
  24, 7, 23, 25, 40, 6, 39, 41, 22, 26,
  38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
  37, 43, 72, 4, 71, 73, 20, 28, 53, 59,
  70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
  87, 89, 19, 29, 86, 90, 35, 45, 68, 76,
  85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
  102, 106, 34, 46, 84, 92, 67, 77, 101, 107,
  50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
  100, 108, 66, 78, 118, 122, 33, 47, 117, 123,
  49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
  79, 16, 32, 98, 110, 48, 115, 125, 81, 95,
  64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

/* ------------------------------------------------------------------ */
/* Shared                                                               */

static void set_err(char *err, const char *msg) {
  if (err) {
    strncpy(err, msg, 255);
    err[255] = 0;
  }
}

static inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

/* ------------------------------------------------------------------ */
/* VP8L (lossless)                                                      */

typedef struct {
  const uint8_t *buf;
  size_t len, pos;   /* next byte to load */
  uint64_t val;      /* bits not yet consumed, LSB first */
  int nbits;         /* bits held in val */
  int eos;           /* read past the end of the data */
} LBR;

static void lbr_init(LBR *br, const uint8_t *buf, size_t len) {
  br->buf = buf;
  br->len = len;
  br->pos = 0;
  br->val = 0;
  br->nbits = 0;
  br->eos = 0;
}

static inline void lbr_fill(LBR *br) {
  while (br->nbits <= 56) {
    if (br->pos < br->len) {
      br->val |= (uint64_t)br->buf[br->pos++] << br->nbits;
      br->nbits += 8;
    } else {
      break;
    }
  }
}

static inline uint32_t lbr_peek(LBR *br) {
  lbr_fill(br);
  return (uint32_t)br->val;
}

static inline void lbr_skip(LBR *br, int n) {
  if (n > br->nbits) {   /* past the end: the bits read as zeros */
    br->eos = 1;
    br->val = 0;
    br->nbits = 0;
    return;
  }
  br->val >>= n;
  br->nbits -= n;
}

static inline uint32_t lbr_read(LBR *br, int n) {
  if (n == 0) return 0;
  const uint32_t v = lbr_peek(br) & ((1u << n) - 1);
  lbr_skip(br, n);
  return br->eos ? 0 : v;
}

/* Canonical prefix codes: a 256-entry first-level table indexed by the
 * next 8 bits (LSB first); codes longer than 8 bits go through a 128-entry
 * second-level table a distinct 8-bit prefix. A code of one symbol reads
 * no bits. Lengths that do not form a complete code are refused, as
 * libwebp's BuildHuffmanTable refuses them. */
#define HUFF_BITS 8
#define HUFF_SUB 7
#define MAX_CODE_LENGTH 15
#define HUFF_LONG 0xFF

typedef struct {
  uint8_t bits;   /* code length, or HUFF_LONG */
  uint16_t value; /* symbol, or the second-level table's offset */
} HCode;

typedef struct {
  HCode *table;
  int single;
} Huff;

static int huff_build(Huff *h, const int *lengths, int n) {
  int count[MAX_CODE_LENGTH + 1] = {0}, next[MAX_CODE_LENGTH + 2];
  h->table = NULL;
  h->single = 0;
  for (int s = 0; s < n; ++s) {
    if (lengths[s] < 0 || lengths[s] > MAX_CODE_LENGTH) return 0;
    ++count[lengths[s]];
  }
  if (count[0] == n) return 0;
  int nsym = n - count[0];
  if (nsym == 1) {
    h->table = (HCode *)malloc(sizeof(HCode));
    if (!h->table) return 0;
    for (int s = 0; s < n; ++s)
      if (lengths[s] > 0) h->table[0].value = (uint16_t)s;
    h->table[0].bits = 0;
    h->single = 1;
    return 1;
  }
  long long left = 1;
  for (int len = 1; len <= MAX_CODE_LENGTH; ++len) {
    left = (left << 1) - count[len];
    if (left < 0) return 0;
  }
  if (left != 0) return 0;
  /* first canonical code of each length */
  int code = 0;
  count[0] = 0;
  for (int len = 1; len <= MAX_CODE_LENGTH; ++len) {
    code = (code + count[len - 1]) << 1;
    next[len] = code;
  }
  /* distinct prefixes of the long codes */
  int n_sub = 0;
  uint8_t is_long[1 << HUFF_BITS] = {0};
  int *codes = (int *)malloc(sizeof(int) * (size_t)n);
  if (!codes) return 0;
  for (int s = 0; s < n; ++s) {
    const int len = lengths[s];
    if (!len) continue;
    const int c = next[len]++;
    int rev = 0;
    for (int b = 0; b < len; ++b) rev |= ((c >> (len - 1 - b)) & 1) << b;
    codes[s] = rev;
    if (len > HUFF_BITS && !is_long[rev & 0xFF]) {
      is_long[rev & 0xFF] = 1;
      ++n_sub;
    }
  }
  const int total = (1 << HUFF_BITS) + (n_sub << HUFF_SUB);
  h->table = (HCode *)calloc((size_t)total, sizeof(HCode));
  if (!h->table) {
    free(codes);
    return 0;
  }
  int at = 1 << HUFF_BITS;
  for (int p = 0; p < (1 << HUFF_BITS); ++p) {
    if (is_long[p]) {
      h->table[p].bits = HUFF_LONG;
      h->table[p].value = (uint16_t)at;
      at += 1 << HUFF_SUB;
    }
  }
  for (int s = 0; s < n; ++s) {
    const int len = lengths[s];
    if (!len) continue;
    const int rev = codes[s];
    if (len <= HUFF_BITS) {
      for (int r = rev; r < (1 << HUFF_BITS); r += 1 << len) {
        h->table[r].bits = (uint8_t)len;
        h->table[r].value = (uint16_t)s;
      }
    } else {
      HCode *sub = h->table + h->table[rev & 0xFF].value;
      const int l2 = len - HUFF_BITS;
      for (int r = rev >> HUFF_BITS; r < (1 << HUFF_SUB); r += 1 << l2) {
        sub[r].bits = (uint8_t)l2;
        sub[r].value = (uint16_t)s;
      }
    }
  }
  free(codes);
  return 1;
}

static void huff_free(Huff *h) {
  free(h->table);
  h->table = NULL;
}

static inline int huff_read(const Huff *h, LBR *br) {
  if (h->single) return h->table[0].value;
  const uint32_t bits = lbr_peek(br);
  const HCode *c = &h->table[bits & 0xFF];
  if (c->bits == HUFF_LONG) {
    const HCode *c2 = &h->table[c->value + ((bits >> HUFF_BITS) & 0x7F)];
    lbr_skip(br, HUFF_BITS + c2->bits);
    return c2->value;
  }
  lbr_skip(br, c->bits);
  return c->value;
}

/* ---- VP8L image streams ---- */

#define NUM_LITERAL_CODES 256
#define NUM_LENGTH_CODES 24
#define NUM_DISTANCE_CODES 40
#define CODE_LENGTH_CODES 19

static const uint8_t kCodeLengthCodeOrder[CODE_LENGTH_CODES] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

typedef struct {
  Huff h[5];   /* green+length+cache, red, blue, alpha, distance */
} HGroup;

typedef struct {
  LBR br;
  const char *err;
} LDec;

static void groups_free(HGroup *g, int n) {
  if (!g) return;
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < 5; ++k) huff_free(&g[i].h[k]);
  free(g);
}

static int read_code_lengths(LDec *d, const int *cl_lengths, int num_symbols,
                             int *lengths) {
  LBR *br = &d->br;
  Huff table;
  if (!huff_build(&table, cl_lengths, CODE_LENGTH_CODES)) return 0;
  int max_symbol, prev = 8, symbol = 0, ok = 0;
  if (lbr_read(br, 1)) {
    const int nbits = 2 + 2 * (int)lbr_read(br, 3);
    max_symbol = 2 + (int)lbr_read(br, nbits);
    if (max_symbol > num_symbols) goto End;
  } else {
    max_symbol = num_symbols;
  }
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    const int code_len = huff_read(&table, br);
    if (code_len < 16) {
      lengths[symbol++] = code_len;
      if (code_len != 0) prev = code_len;
    } else {
      static const int extra[3] = {2, 3, 7}, offs[3] = {3, 3, 11};
      const int slot = code_len - 16;
      int repeat = (int)lbr_read(br, extra[slot]) + offs[slot];
      if (symbol + repeat > num_symbols) goto End;
      const int len = code_len == 16 ? prev : 0;
      while (repeat-- > 0) lengths[symbol++] = len;
    }
  }
  ok = 1;
End:
  huff_free(&table);
  return ok;
}

static int read_huffman_code(LDec *d, int alphabet, Huff *out) {
  LBR *br = &d->br;
  int *lengths = (int *)calloc((size_t)alphabet, sizeof(int));
  if (!lengths) return 0;
  int ok = 0;
  if (lbr_read(br, 1)) {   /* simple code: one or two symbols */
    const int num = (int)lbr_read(br, 1) + 1;
    const int first_8bits = (int)lbr_read(br, 1);
    /* a symbol past the alphabet is dropped, as libwebp drops it */
    int s = (int)lbr_read(br, first_8bits ? 8 : 1);
    if (s < alphabet) lengths[s] = 1;
    if (num == 2) {
      s = (int)lbr_read(br, 8);
      if (s < alphabet) lengths[s] = 1;
    }
    ok = 1;
  } else {
    int cl[CODE_LENGTH_CODES] = {0};
    const int num_codes = (int)lbr_read(br, 4) + 4;
    if (num_codes > CODE_LENGTH_CODES) goto End;
    for (int i = 0; i < num_codes; ++i)
      cl[kCodeLengthCodeOrder[i]] = (int)lbr_read(br, 3);
    ok = read_code_lengths(d, cl, alphabet, lengths);
  }
  ok = ok && !br->eos && huff_build(out, lengths, alphabet);
End:
  free(lengths);
  return ok;
}

static inline int div_round_up(int n, int bits) {
  return (n + (1 << bits) - 1) >> bits;
}

static int decode_image_stream(LDec *d, int xsize, int ysize, int level0,
                               uint32_t **out);

static inline int copy_distance(int sym, LBR *br) {
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  const int offset = (2 + (sym & 1)) << extra;
  return offset + (int)lbr_read(br, extra) + 1;
}

static inline int plane_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int dc = kCodeToPlane[code - 1];
  const int yoff = dc >> 4, xoff = 8 - (dc & 0xF);
  const int dist = yoff * xsize + xoff;
  return dist >= 1 ? dist : 1;
}

/* The entropy-coded image of xsize x ysize ARGB pixels (after the color
 * cache bits and, at level 0, the meta prefix codes). */
static int decode_entropy_image(LDec *d, int xsize, int ysize, int level0,
                                uint32_t *data) {
  LBR *br = &d->br;
  int cache_bits = 0;
  uint32_t *cache = NULL;
  if (lbr_read(br, 1)) {
    cache_bits = (int)lbr_read(br, 4);
    if (cache_bits < 1 || cache_bits > 11) {
      d->err = "VP8L: invalid color cache size";
      return 0;
    }
  }
  int huff_bits = 0, num_groups = 1, huff_xsize = 0;
  uint32_t *huff_image = NULL;
  if (level0 && lbr_read(br, 1)) {
    huff_bits = (int)lbr_read(br, 3) + 2;
    huff_xsize = div_round_up(xsize, huff_bits);
    if (!decode_image_stream(d, huff_xsize, div_round_up(ysize, huff_bits),
                             0, &huff_image))
      return 0;
    const int n = huff_xsize * div_round_up(ysize, huff_bits);
    for (int i = 0; i < n; ++i) {
      const int g = (huff_image[i] >> 8) & 0xFFFF;
      huff_image[i] = (uint32_t)g;
      if (g >= num_groups) num_groups = g + 1;
    }
  }
  if (br->eos) {
    free(huff_image);
    d->err = "VP8L: data ends early";
    return 0;
  }
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  const int sizes[5] = {NUM_LITERAL_CODES + NUM_LENGTH_CODES + cache_size,
                        NUM_LITERAL_CODES, NUM_LITERAL_CODES,
                        NUM_LITERAL_CODES, NUM_DISTANCE_CODES};
  HGroup *groups = (HGroup *)calloc((size_t)num_groups, sizeof(HGroup));
  if (!groups) {
    free(huff_image);
    d->err = "VP8L: out of memory";
    return 0;
  }
  for (int g = 0; g < num_groups; ++g)
    for (int k = 0; k < 5; ++k)
      if (!read_huffman_code(d, sizes[k], &groups[g].h[k])) {
        groups_free(groups, num_groups);
        free(huff_image);
        d->err = "VP8L: invalid prefix code";
        return 0;
      }
  if (cache_bits) {
    cache = (uint32_t *)calloc((size_t)cache_size, sizeof(uint32_t));
    if (!cache) {
      groups_free(groups, num_groups);
      free(huff_image);
      d->err = "VP8L: out of memory";
      return 0;
    }
  }
  const int total = xsize * ysize;
  int pos = 0, col = 0, row = 0, cached = 0, ok = 1;
  const uint32_t hash_shift = 32 - cache_bits;
  while (pos < total) {
    const HGroup *g = &groups[huff_bits ?
        huff_image[(row >> huff_bits) * huff_xsize + (col >> huff_bits)] : 0];
    const int code = huff_read(&g->h[0], br);
    if (code < NUM_LITERAL_CODES) {
      const int red = huff_read(&g->h[1], br);
      const int blue = huff_read(&g->h[2], br);
      const int alpha = huff_read(&g->h[3], br);
      if (br->eos) break;
      data[pos++] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) |
                    ((uint32_t)code << 8) | (uint32_t)blue;
      if (++col >= xsize) col = 0, ++row;
    } else if (code < NUM_LITERAL_CODES + NUM_LENGTH_CODES) {
      const int length = copy_distance(code - NUM_LITERAL_CODES, br);
      const int dist_sym = huff_read(&g->h[4], br);
      const int dist = plane_distance(xsize, copy_distance(dist_sym, br));
      if (br->eos) break;
      if (pos < dist || total - pos < length) {
        ok = 0;
        d->err = "VP8L: backward reference out of the image";
        break;
      }
      for (int k = 0; k < length; ++k) data[pos + k] = data[pos + k - dist];
      pos += length;
      col += length;
      while (col >= xsize) col -= xsize, ++row;
    } else if (code < sizes[0]) {
      while (cached < pos) {
        const uint32_t c = data[cached++];
        cache[(0x1e35a7bdu * c) >> hash_shift] = c;
      }
      data[pos++] = cache[code - NUM_LITERAL_CODES - NUM_LENGTH_CODES];
      if (++col >= xsize) col = 0, ++row;
    } else {
      ok = 0;
      d->err = "VP8L: invalid symbol";
      break;
    }
    if (cache_bits) {
      while (cached < pos) {
        const uint32_t c = data[cached++];
        cache[(0x1e35a7bdu * c) >> hash_shift] = c;
      }
    }
  }
  if (ok && br->eos) {
    ok = 0;
    d->err = "VP8L: data ends before the image (truncated)";
  }
  free(cache);
  groups_free(groups, num_groups);
  free(huff_image);
  return ok;
}

/* ---- VP8L transforms ---- */

enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2,
       COLOR_INDEXING = 3 };

typedef struct {
  int type, bits, xsize, ysize;
  uint32_t *data;
} Transform;

static inline uint32_t add_px(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

static inline uint32_t avg2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

static inline int sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return abs(pb) - abs(pa);
}

static inline uint32_t select_px(uint32_t a, uint32_t b, uint32_t c) {
  const int d = sub3((int)(a >> 24), (int)(b >> 24), (int)(c >> 24)) +
                sub3((int)((a >> 16) & 0xff), (int)((b >> 16) & 0xff),
                     (int)((c >> 16) & 0xff)) +
                sub3((int)((a >> 8) & 0xff), (int)((b >> 8) & 0xff),
                     (int)((c >> 8) & 0xff)) +
                sub3((int)(a & 0xff), (int)(b & 0xff), (int)(c & 0xff));
  return d <= 0 ? a : b;
}

static inline uint32_t clamp_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = (int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) -
                  (int)((c2 >> s) & 0xff);
    out |= (uint32_t)clip255(v) << s;
  }
  return out;
}

static inline uint32_t clamp_half(uint32_t c0, uint32_t c1) {
  const uint32_t ave = c0;
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (int)((ave >> s) & 0xff), b = (int)((c1 >> s) & 0xff);
    out |= (uint32_t)clip255(a + (a - b) / 2) << s;
  }
  return out;
}

static inline uint32_t predict(int mode, const uint32_t *cur, int x,
                               const uint32_t *top) {
  const uint32_t L = cur[x - 1], T = top[x], TR = top[x + 1],
                 TL = top[x - 1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return avg2(avg2(L, TR), T);
    case 6: return avg2(L, TL);
    case 7: return avg2(L, T);
    case 8: return avg2(TL, T);
    case 9: return avg2(T, TR);
    case 10: return avg2(avg2(L, TL), avg2(T, TR));
    case 11: return select_px(T, L, TL);
    case 12: return clamp_full(L, T, TL);
    case 13: return clamp_half(avg2(L, T), TL);
    default: return 0xff000000u;
  }
}

static void inverse_transform(const Transform *t, uint32_t *data, int width,
                              int height, uint32_t *out) {
  /* `data` holds width x height pixels (`width` the packed width for
   * color indexing); `out` gets t->xsize x height pixels */
  switch (t->type) {
    case PREDICTOR: {
      const int tiles = div_round_up(t->xsize, t->bits);
      for (int y = 0; y < height; ++y) {
        uint32_t *cur = data + (size_t)y * width;
        if (y == 0) {
          cur[0] = add_px(cur[0], 0xff000000u);
          for (int x = 1; x < width; ++x) cur[x] = add_px(cur[x], cur[x - 1]);
          continue;
        }
        const uint32_t *top = cur - width;
        cur[0] = add_px(cur[0], top[0]);
        const uint32_t *modes = t->data + (size_t)(y >> t->bits) * tiles;
        for (int x = 1; x < width; ++x) {
          const int mode = (modes[x >> t->bits] >> 8) & 0xf;
          cur[x] = add_px(cur[x], predict(mode, cur, x, top));
        }
      }
      memcpy(out, data, sizeof(uint32_t) * (size_t)width * height);
      break;
    }
    case CROSS_COLOR: {
      const int tiles = div_round_up(t->xsize, t->bits);
      for (int y = 0; y < height; ++y) {
        const uint32_t *codes = t->data + (size_t)(y >> t->bits) * tiles;
        for (int x = 0; x < width; ++x) {
          const uint32_t cc = codes[x >> t->bits];
          const int8_t g2r = (int8_t)(cc & 0xff), g2b = (int8_t)((cc >> 8) & 0xff),
                       r2b = (int8_t)((cc >> 16) & 0xff);
          const uint32_t argb = data[(size_t)y * width + x];
          const int8_t green = (int8_t)(argb >> 8);
          int new_red = (int)((argb >> 16) & 0xff);
          int new_blue = (int)(argb & 0xff);
          new_red += ((int)g2r * green) >> 5;
          new_red &= 0xff;
          new_blue += ((int)g2b * green) >> 5;
          new_blue += ((int)r2b * (int8_t)new_red) >> 5;
          new_blue &= 0xff;
          out[(size_t)y * width + x] = (argb & 0xff00ff00u) |
                                       ((uint32_t)new_red << 16) |
                                       (uint32_t)new_blue;
        }
      }
      break;
    }
    case SUBTRACT_GREEN: {
      const size_t n = (size_t)width * height;
      for (size_t i = 0; i < n; ++i) {
        const uint32_t argb = data[i];
        const uint32_t g = (argb >> 8) & 0xff;
        uint32_t rb = argb & 0x00ff00ffu;
        rb += (g << 16) | g;
        out[i] = (argb & 0xff00ff00u) | (rb & 0x00ff00ffu);
      }
      break;
    }
    case COLOR_INDEXING: {
      const int bits_per_px = 8 >> t->bits, ppb = 1 << t->bits;
      const uint32_t mask = (1u << bits_per_px) - 1;
      for (int y = 0; y < height; ++y) {
        const uint32_t *src = data + (size_t)y * width;
        uint32_t *dst = out + (size_t)y * t->xsize;
        for (int x = 0; x < t->xsize; ++x) {
          const uint32_t g = (src[x >> t->bits] >> 8) & 0xff;
          const uint32_t idx = (g >> ((x & (ppb - 1)) * bits_per_px)) & mask;
          dst[x] = t->data[idx];
        }
      }
      break;
    }
  }
}

static int decode_image_stream(LDec *d, int xsize, int ysize, int level0,
                               uint32_t **out) {
  LBR *br = &d->br;
  Transform tr[4];
  int ntr = 0, seen = 0, ok = 1;
  int cur_xsize = xsize;
  uint32_t *data = NULL, *tmp = NULL;
  if (level0) {
    while (lbr_read(br, 1)) {
      Transform *t = &tr[ntr];
      t->type = (int)lbr_read(br, 2);
      if (seen & (1 << t->type)) {
        d->err = "VP8L: a transform used twice";
        ok = 0;
        break;
      }
      seen |= 1 << t->type;
      t->xsize = cur_xsize;
      t->ysize = ysize;
      t->data = NULL;
      t->bits = 0;
      ++ntr;
      if (t->type == PREDICTOR || t->type == CROSS_COLOR) {
        t->bits = (int)lbr_read(br, 3) + 2;
        if (!decode_image_stream(d, div_round_up(cur_xsize, t->bits),
                                 div_round_up(ysize, t->bits), 0, &t->data)) {
          ok = 0;
          break;
        }
      } else if (t->type == COLOR_INDEXING) {
        const int num_colors = (int)lbr_read(br, 8) + 1;
        const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 :
                         num_colors > 2 ? 2 : 3;
        uint32_t *pal = NULL;
        if (!decode_image_stream(d, num_colors, 1, 0, &pal)) {
          ok = 0;
          break;
        }
        const int final_colors = 1 << (8 >> bits);
        t->data = (uint32_t *)calloc((size_t)final_colors, sizeof(uint32_t));
        if (!t->data) {
          free(pal);
          ok = 0;
          d->err = "VP8L: out of memory";
          break;
        }
        t->data[0] = pal[0];
        for (int i = 1; i < num_colors && i < final_colors; ++i)
          t->data[i] = add_px(pal[i], t->data[i - 1]);
        free(pal);
        t->bits = bits;
        cur_xsize = div_round_up(cur_xsize, bits);
      }
      if (br->eos) {
        d->err = "VP8L: data ends early";
        ok = 0;
        break;
      }
    }
  }
  if (ok) {
    data = (uint32_t *)malloc(sizeof(uint32_t) * (size_t)cur_xsize * ysize);
    if (!data) {
      d->err = "VP8L: out of memory";
      ok = 0;
    }
  }
  if (ok) ok = decode_entropy_image(d, cur_xsize, ysize, level0, data);
  /* inverse transforms, last read first */
  for (int i = ntr - 1; ok && i >= 0; --i) {
    const Transform *t = &tr[i];
    const int in_w = t->type == COLOR_INDEXING ? div_round_up(t->xsize,
                                                              t->bits)
                                               : t->xsize;
    tmp = (uint32_t *)malloc(sizeof(uint32_t) * (size_t)t->xsize * ysize);
    if (!tmp) {
      d->err = "VP8L: out of memory";
      ok = 0;
      break;
    }
    inverse_transform(t, data, in_w, ysize, tmp);
    free(data);
    data = tmp;
    tmp = NULL;
  }
  for (int i = 0; i < ntr; ++i) free(tr[i].data);
  if (!ok) {
    free(data);
    if (!d->err) d->err = "VP8L: bitstream error";
    return 0;
  }
  *out = data;
  return 1;
}

/* The VP8L bitstream `buf` (after its chunk header) -> RGB rows at `out`
 * with `stride` bytes a row; `w`, `h` must be the header's. */
int webp_vp8l_decode(const uint8_t *buf, size_t len, uint8_t *out,
                     int stride, int w, int h, char *err) {
  LDec d;
  lbr_init(&d.br, buf, len);
  d.err = NULL;
  if (len < 5 || buf[0] != 0x2f) {
    set_err(err, "VP8L: bad signature");
    return 1;
  }
  lbr_read(&d.br, 8);
  const int xsize = (int)lbr_read(&d.br, 14) + 1;
  const int ysize = (int)lbr_read(&d.br, 14) + 1;
  lbr_read(&d.br, 1);
  if (lbr_read(&d.br, 3) != 0) {
    set_err(err, "VP8L: unknown version");
    return 1;
  }
  if (xsize != w || ysize != h) {
    set_err(err, "VP8L: size differs from the container's");
    return 1;
  }
  uint32_t *argb = NULL;
  if (!decode_image_stream(&d, xsize, ysize, 1, &argb)) {
    set_err(err, d.err);
    return 1;
  }
  for (int y = 0; y < ysize; ++y) {
    uint8_t *row = out + (size_t)y * stride;
    const uint32_t *src = argb + (size_t)y * xsize;
    for (int x = 0; x < xsize; ++x) {
      row[3 * x] = (uint8_t)(src[x] >> 16);
      row[3 * x + 1] = (uint8_t)(src[x] >> 8);
      row[3 * x + 2] = (uint8_t)src[x];
    }
  }
  free(argb);
  return 0;
}

/* The header's size of a VP8L bitstream. */
int webp_vp8l_info(const uint8_t *buf, size_t len, int *w, int *h) {
  if (len < 5 || buf[0] != 0x2f) return 1;
  const uint32_t bits = (uint32_t)buf[1] | ((uint32_t)buf[2] << 8) |
                        ((uint32_t)buf[3] << 16) | ((uint32_t)buf[4] << 24);
  *w = (int)(bits & 0x3fff) + 1;
  *h = (int)((bits >> 14) & 0x3fff) + 1;
  return (bits >> 29) != 0;
}

/* ------------------------------------------------------------------ */
/* VP8 (lossy), as libwebp's decoder: the boolean decoder of vp8i_dec.h /
 * bit_reader_inl_utils.h, the token and mode parsing of vp8_dec.c and
 * tree_dec.c, the reconstruction of frame_dec.c and the dsp of dec.c. */

typedef struct {
  const uint8_t *buf, *end;
  uint32_t value;
  uint32_t range;   /* range - 1, in [126, 254] */
  int bits;         /* bits held below the 8-bit window */
  int eof;
} BR;

static void br_load(BR *br) {
  if (br->buf < br->end) {
    br->bits += 8;
    br->value = (br->value << 8) | *br->buf++;
  } else if (!br->eof) {
    br->value <<= 8;
    br->bits += 8;
    br->eof = 1;
  } else {
    br->bits = 0;
  }
}

static void br_init(BR *br, const uint8_t *start, size_t size) {
  br->buf = start;
  br->end = start + size;
  br->value = 0;
  br->range = 255 - 1;
  br->bits = -8;
  br->eof = 0;
  br_load(br);
}

static inline int log2_floor(uint32_t v) {
  int n = 0;
  while (v >>= 1) ++n;
  return n;
}

static inline int get_bit(BR *br, int prob) {
  uint32_t range = br->range;
  if (br->bits < 0) br_load(br);
  const int pos = br->bits;
  const uint32_t split = (range * (uint32_t)prob) >> 8;
  const uint32_t value = br->value >> pos;
  int bit;
  if (value > split) {
    range -= split;
    br->value -= (split + 1) << pos;
    bit = 1;
  } else {
    range = split + 1;
    bit = 0;
  }
  const int shift = 7 ^ log2_floor(range);
  range <<= shift;
  br->bits -= shift;
  br->range = range - 1;
  return bit;
}

static inline int get_signed(BR *br, int v) {
  if (br->bits < 0) br_load(br);
  const int pos = br->bits;
  const uint32_t split = br->range >> 1;
  const uint32_t value = br->value >> pos;
  const int32_t mask = (int32_t)(split - value) >> 31;
  br->bits -= 1;
  br->range += (uint32_t)mask;
  br->range |= 1;
  br->value -= ((split + 1) & (uint32_t)mask) << pos;
  return (v ^ mask) - mask;
}

static inline uint32_t get_value(BR *br, int bits) {
  uint32_t v = 0;
  while (bits-- > 0) v |= (uint32_t)get_bit(br, 0x80) << bits;
  return v;
}

static inline int get_signed_value(BR *br, int bits) {
  const int value = (int)get_value(br, bits);
  return get_value(br, 1) ? -value : value;
}

/* intra modes, in libwebp's order */
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
       B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED, NUM_BMODES,
       DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
       TM_PRED = B_TM_PRED };

static const int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED,
    -B_HU_PRED};

static const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                                    9, 12, 13, 10, 7, 11, 14, 15};
static const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6,
                                   6, 6, 6, 6, 6, 6, 7, 0};
static const uint8_t kCat3[] = {173, 148, 140, 0};
static const uint8_t kCat4[] = {176, 155, 140, 135, 0};
static const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
static const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177,
                                153, 140, 133, 130, 129, 0};
static const uint8_t *const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

typedef struct {
  int y1[2], y2[2], uv[2];
} Quant;

typedef struct {
  int limit, ilevel, inner, hev_thresh;
} FInfo;

typedef struct {
  uint8_t is_i4x4, segment, skip, uvmode;
  uint8_t imodes[16];
  uint8_t f_inner;   /* the MB has coefficients, or is i4x4 */
} MBInfo;

typedef struct {
  int w, h, mb_w, mb_h;
  int use_segment, update_map, absolute_delta;
  int quantizer[4], filter_strength[4];
  uint8_t seg_probs[3];
  int simple, level, sharpness, use_lf_delta;
  int ref_lf_delta[4], mode_lf_delta[4];
  int filter_type;
  int num_parts;
  BR br, parts[8];
  Quant dqm[4];
  uint8_t proba[4][8][3][11];
  int use_skip, skip_p;
  FInfo fstrengths[4][2];
} VP8;

static int parse_headers(VP8 *d, const uint8_t *buf, size_t size,
                         const char **err) {
  if (size < 10) {
    *err = "VP8: truncated header";
    return 0;
  }
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const int key = !(bits & 1), profile = (bits >> 1) & 7,
            show = (bits >> 4) & 1;
  const uint32_t part_len = bits >> 5;
  if (!key) {
    *err = "VP8: not a key frame";
    return 0;
  }
  if (profile > 3) {
    *err = "VP8: incorrect keyframe parameters";
    return 0;
  }
  if (!show) {
    *err = "VP8: frame not displayable";
    return 0;
  }
  buf += 3;
  size -= 3;
  if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) {
    *err = "VP8: bad code word";
    return 0;
  }
  d->w = ((buf[4] << 8) | buf[3]) & 0x3fff;
  d->h = ((buf[6] << 8) | buf[5]) & 0x3fff;
  buf += 7;
  size -= 7;
  d->mb_w = (d->w + 15) >> 4;
  d->mb_h = (d->h + 15) >> 4;
  if (part_len > size) {
    *err = "VP8: bad partition length";
    return 0;
  }
  BR *br = &d->br;
  br_init(br, buf, part_len);
  buf += part_len;
  size -= part_len;
  get_value(br, 1);   /* colorspace */
  get_value(br, 1);   /* clamp type */
  /* segment header */
  d->use_segment = (int)get_value(br, 1);
  d->update_map = 0;
  d->absolute_delta = 1;
  memset(d->quantizer, 0, sizeof(d->quantizer));
  memset(d->filter_strength, 0, sizeof(d->filter_strength));
  memset(d->seg_probs, 255, sizeof(d->seg_probs));
  if (d->use_segment) {
    d->update_map = (int)get_value(br, 1);
    if (get_value(br, 1)) {
      d->absolute_delta = (int)get_value(br, 1);
      for (int s = 0; s < 4; ++s)
        d->quantizer[s] = get_value(br, 1) ? get_signed_value(br, 7) : 0;
      for (int s = 0; s < 4; ++s)
        d->filter_strength[s] = get_value(br, 1) ? get_signed_value(br, 6)
                                                 : 0;
    }
    if (d->update_map)
      for (int s = 0; s < 3; ++s)
        d->seg_probs[s] = get_value(br, 1) ? (uint8_t)get_value(br, 8) : 255;
  }
  if (br->eof) {
    *err = "VP8: cannot parse segment header";
    return 0;
  }
  /* filter header */
  d->simple = (int)get_value(br, 1);
  d->level = (int)get_value(br, 6);
  d->sharpness = (int)get_value(br, 3);
  d->use_lf_delta = (int)get_value(br, 1);
  memset(d->ref_lf_delta, 0, sizeof(d->ref_lf_delta));
  memset(d->mode_lf_delta, 0, sizeof(d->mode_lf_delta));
  if (d->use_lf_delta && get_value(br, 1)) {
    for (int i = 0; i < 4; ++i)
      if (get_value(br, 1)) d->ref_lf_delta[i] = get_signed_value(br, 6);
    for (int i = 0; i < 4; ++i)
      if (get_value(br, 1)) d->mode_lf_delta[i] = get_signed_value(br, 6);
  }
  d->filter_type = d->level == 0 ? 0 : d->simple ? 1 : 2;
  if (br->eof) {
    *err = "VP8: cannot parse filter header";
    return 0;
  }
  /* partitions */
  d->num_parts = 1 << get_value(br, 2);
  {
    const size_t last = (size_t)d->num_parts - 1;
    const uint8_t *sz = buf, *end = buf + size;
    size_t left = size;
    if (size < 3 * last) {
      *err = "VP8: cannot parse partitions";
      return 0;
    }
    const uint8_t *start = buf + last * 3;
    left -= last * 3;
    for (size_t p = 0; p < last; ++p) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      br_init(&d->parts[p], start, psize);
      start += psize;
      left -= psize;
      sz += 3;
    }
    br_init(&d->parts[last], start, left);
    if (start >= end) {
      *err = "VP8: cannot parse partitions";
      return 0;
    }
  }
  /* quantizers */
  {
    const int base_q0 = (int)get_value(br, 7);
    const int dqy1_dc = get_value(br, 1) ? get_signed_value(br, 4) : 0;
    const int dqy2_dc = get_value(br, 1) ? get_signed_value(br, 4) : 0;
    const int dqy2_ac = get_value(br, 1) ? get_signed_value(br, 4) : 0;
    const int dquv_dc = get_value(br, 1) ? get_signed_value(br, 4) : 0;
    const int dquv_ac = get_value(br, 1) ? get_signed_value(br, 4) : 0;
#define QCLIP(v, m) ((v) < 0 ? 0 : (v) > (m) ? (m) : (v))
    for (int i = 0; i < 4; ++i) {
      int q;
      if (d->use_segment) {
        q = d->quantizer[i];
        if (!d->absolute_delta) q += base_q0;
      } else {
        if (i > 0) {
          d->dqm[i] = d->dqm[0];
          continue;
        }
        q = base_q0;
      }
      Quant *m = &d->dqm[i];
      m->y1[0] = kDcTable[QCLIP(q + dqy1_dc, 127)];
      m->y1[1] = kAcTable[QCLIP(q + 0, 127)];
      m->y2[0] = kDcTable[QCLIP(q + dqy2_dc, 127)] * 2;
      m->y2[1] = (kAcTable[QCLIP(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m->y2[1] < 8) m->y2[1] = 8;
      m->uv[0] = kDcTable[QCLIP(q + dquv_dc, 117)];
      m->uv[1] = kAcTable[QCLIP(q + dquv_ac, 127)];
    }
#undef QCLIP
  }
  get_value(br, 1);   /* update_proba, ignored */
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          d->proba[t][b][c][p] = get_bit(br, CoeffsUpdateProba[t][b][c][p])
                                     ? (uint8_t)get_value(br, 8)
                                     : CoeffsProba0[t][b][c][p];
  d->use_skip = (int)get_value(br, 1);
  if (d->use_skip) d->skip_p = (int)get_value(br, 8);
  return 1;
}

static void precompute_filter_strengths(VP8 *d) {
  if (d->filter_type <= 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (d->use_segment) {
      base_level = d->filter_strength[s];
      if (!d->absolute_delta) base_level += d->level;
    } else {
      base_level = d->level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo *info = &d->fstrengths[s][i4x4];
      int level = base_level;
      if (d->use_lf_delta) {
        level += d->ref_lf_delta[0];
        if (i4x4) level += d->mode_lf_delta[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (d->sharpness > 0) {
          ilevel >>= d->sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - d->sharpness) ilevel = 9 - d->sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info->ilevel = ilevel;
        info->limit = 2 * level + ilevel;
        info->hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info->limit = 0;
      }
      info->inner = i4x4;
    }
  }
}

static void parse_intra_mode(VP8 *d, BR *br, MBInfo *mb, uint8_t *top,
                             uint8_t *left) {
  if (d->update_map)
    mb->segment = !get_bit(br, d->seg_probs[0])
                      ? (uint8_t)get_bit(br, d->seg_probs[1])
                      : (uint8_t)(get_bit(br, d->seg_probs[2]) + 2);
  else
    mb->segment = 0;
  mb->skip = d->use_skip ? (uint8_t)get_bit(br, d->skip_p) : 0;
  mb->is_i4x4 = !get_bit(br, 145);
  if (!mb->is_i4x4) {
    const int ymode = get_bit(br, 156) ? (get_bit(br, 128) ? TM_PRED : H_PRED)
                                       : (get_bit(br, 163) ? V_PRED : DC_PRED);
    mb->imodes[0] = (uint8_t)ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t *modes = mb->imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t *prob = kBModesProba[top[x]][ymode];
        int i = kYModesIntra4[get_bit(br, prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + get_bit(br, prob[i])];
        ymode = -i;
        top[x] = (uint8_t)ymode;
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = (uint8_t)ymode;
    }
  }
  mb->uvmode = !get_bit(br, 142) ? DC_PRED
               : !get_bit(br, 114) ? V_PRED
               : get_bit(br, 183) ? TM_PRED : H_PRED;
}

static int get_large_value(BR *br, const uint8_t *p) {
  int v;
  if (!get_bit(br, p[3])) {
    if (!get_bit(br, p[4])) {
      v = 2;
    } else {
      v = 3 + get_bit(br, p[5]);
    }
  } else {
    if (!get_bit(br, p[6])) {
      if (!get_bit(br, p[7])) {
        v = 5 + get_bit(br, 159);
      } else {
        v = 7 + 2 * get_bit(br, 165);
        v += get_bit(br, 145);
      }
    } else {
      const int bit1 = get_bit(br, p[8]);
      const int bit0 = get_bit(br, p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t *tab = kCat3456[cat]; *tab; ++tab)
        v += v + get_bit(br, *tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

/* libwebp's GetCoeffs: the index after the last coefficient read */
static int get_coeffs(BR *br, const uint8_t (*bands)[3][11], int ctx,
                      const int *dq, int n, int16_t *out) {
  const uint8_t *p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!get_bit(br, p[0])) return n;
    while (!get_bit(br, p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    {
      const uint8_t (*p_ctx)[11] = bands[kBands[n + 1]];
      int v;
      if (!get_bit(br, p[2])) {
        v = 1;
        p = p_ctx[1];
      } else {
        v = get_large_value(br, p);
        p = p_ctx[2];
      }
      out[kZigzag[n]] = (int16_t)(get_signed(br, v) * dq[n > 0]);
    }
  }
  return 16;
}

static void transform_wht(const int16_t *in, int16_t *out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

/* libwebp's ParseResiduals; 1 where the MB has no non-zero coefficient */
static int parse_residuals(VP8 *d, BR *br, const MBInfo *mb, uint8_t *top_nz,
                           uint8_t *top_nz_dc, uint8_t *left_nz,
                           uint8_t *left_nz_dc, int16_t *coeffs) {
  const Quant *q = &d->dqm[mb->segment];
  int16_t *dst = coeffs;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  int first;
  const uint8_t (*ac_proba)[3][11];
  memset(dst, 0, 384 * sizeof(*dst));
  if (!mb->is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = *top_nz_dc + *left_nz_dc;
    const int nz = get_coeffs(br, (const uint8_t (*)[3][11])d->proba[1], ctx,
                              q->y2, 0, dc);
    *top_nz_dc = *left_nz_dc = (uint8_t)(nz > 0);
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
    }
    first = 1;
    ac_proba = (const uint8_t (*)[3][11])d->proba[0];
  } else {
    first = 0;
    ac_proba = (const uint8_t (*)[3][11])d->proba[3];
  }
  uint8_t tnz = *top_nz & 0x0f, lnz = *left_nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_proba, ctx, q->y1, first, dst);
      l = (nz > first);
      tnz = (uint8_t)((tnz >> 1) | (l << 7));
      nz_coeffs = (nz_coeffs << 2) |
                  (uint32_t)((nz > 3) ? 3 : (nz > 1) ? 2 : (dst[0] != 0));
      dst += 16;
    }
    tnz >>= 4;
    lnz = (uint8_t)((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = (uint8_t)(*top_nz >> (4 + ch));
    lnz = (uint8_t)(*left_nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, (const uint8_t (*)[3][11])d->proba[2],
                                  ctx, q->uv, 0, dst);
        l = (nz > 0);
        tnz = (uint8_t)((tnz >> 1) | (l << 3));
        nz_coeffs = (nz_coeffs << 2) |
                    (uint32_t)((nz > 3) ? 3 : (nz > 1) ? 2 : (dst[0] != 0));
        dst += 16;
      }
      tnz >>= 2;
      lnz = (uint8_t)((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (uint32_t)(tnz << 4) << ch;
    out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
  }
  *top_nz = (uint8_t)out_t_nz;
  *left_nz = (uint8_t)out_l_nz;
  return !(non_zero_y | non_zero_uv);
}

/* ---- reconstruction (dsp/dec.c) ---- */

#define BPS 32
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)
#define DST(x, y) dst[(x) + (y) * BPS]

static inline uint8_t clip_8b(int v) {
  return (!(v & ~0xff)) ? (uint8_t)v : (v < 0) ? 0 : 255;
}

#define MUL1(a) ((((a) * 20091) >> 16) + (a))
#define MUL2(a) (((a) * 35468) >> 16)
#define STORE(x, y, v) \
  dst[(x) + (y) * BPS] = clip_8b(dst[(x) + (y) * BPS] + ((v) >> 3))

static void transform_one(const int16_t *in, uint8_t *dst) {
  int C[4 * 4], *tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = MUL2(in[4]) - MUL1(in[12]);
    const int d = MUL1(in[4]) + MUL2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = MUL2(tmp[4]) - MUL1(tmp[12]);
    const int d = MUL1(tmp[4]) + MUL2(tmp[12]);
    STORE(0, 0, a + d);
    STORE(1, 0, b + c);
    STORE(2, 0, b - c);
    STORE(3, 0, a - d);
    tmp++;
    dst += BPS;
  }
}

static void true_motion(uint8_t *dst, int size) {
  const uint8_t *top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip_8b(top[x] + l - tl);
    dst += BPS;
  }
}

static void pred_luma4(int mode, uint8_t *dst) {
  const uint8_t *top = dst - BPS;
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) memset(dst + i * BPS, (int)dc, 4);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {AVG3(top[-1], top[0], top[1]),
                               AVG3(top[0], top[1], top[2]),
                               AVG3(top[1], top[2], top[3]),
                               AVG3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS],
                D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
      memset(dst + 0 * BPS, AVG3(A, B, C), 4);
      memset(dst + 1 * BPS, AVG3(B, C, D), 4);
      memset(dst + 2 * BPS, AVG3(C, D, E), 4);
      memset(dst + 3 * BPS, AVG3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS],
                K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS],
                X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    }
    case B_LD_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS],
                D = dst[3 - BPS], E = dst[4 - BPS], F = dst[5 - BPS],
                G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS],
                K = dst[-1 + 2 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS],
                B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    }
    case B_VL_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS],
                D = dst[3 - BPS], E = dst[4 - BPS], F = dst[5 - BPS],
                G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS],
                K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS],
                X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS];
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    }
    case B_HU_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS],
                K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          (uint8_t)L;
      break;
    }
  }
}

/* 16x16 luma (size 16) and 8x8 chroma (size 8) predictions; DC has the
 * edge variants of frame_dec.c's CheckMode */
static void pred_block(int mode, int mb_x, int mb_y, uint8_t *dst, int size) {
  const int shift = size == 16 ? 4 : 3;
  if (mode == DC_PRED) {
    int dc;
    if (mb_x > 0 && mb_y > 0) {
      dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      dc >>= shift + 1;
    } else if (mb_y > 0) {      /* no left */
      dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      dc >>= shift;
    } else if (mb_x > 0) {      /* no top */
      dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      dc >>= shift;
    } else {
      dc = 0x80;
    }
    for (int j = 0; j < size; ++j) memset(dst + j * BPS, dc, (size_t)size);
  } else if (mode == TM_PRED) {
    true_motion(dst, size);
  } else if (mode == V_PRED) {
    for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, (size_t)size);
  } else {                        /* H_PRED */
    for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1],
                                          (size_t)size);
  }
}

/* ---- loop filter (dsp/dec.c) ---- */

static inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
static inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
static inline uint8_t clip1(int v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

static inline void do_filter2(uint8_t *p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip1(p0 + a2);
  p[0] = clip1(q0 - a1);
}

static inline void do_filter4(uint8_t *p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip1(p1 + a3);
  p[-step] = clip1(p0 + a2);
  p[0] = clip1(q0 - a1);
  p[step] = clip1(q1 - a3);
}

static inline void do_filter6(uint8_t *p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip1(p2 + a3);
  p[-2 * step] = clip1(p1 + a2);
  p[-step] = clip1(p0 + a1);
  p[0] = clip1(q0 - a1);
  p[step] = clip1(q1 - a2);
  p[2 * step] = clip1(q2 - a3);
}

static inline int hev(const uint8_t *p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (abs(p1 - p0) > thresh) || (abs(q1 - q0) > thresh);
}

static inline int needs_filter(const uint8_t *p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (4 * abs(p0 - q0) + abs(p1 - q1)) <= t;
}

static inline int needs_filter2(const uint8_t *p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if ((4 * abs(p0 - q0) + abs(p1 - q1)) > t) return 0;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
         abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

static void simple_filter(uint8_t *p, int step, int along, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * along, step, thresh2)) do_filter2(p + i * along, step);
}

static void filter_loop26(uint8_t *p, int hstride, int vstride, int size,
                          int thresh, int ithresh, int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
      else do_filter6(p, hstride);
    }
    p += vstride;
  }
}

static void filter_loop24(uint8_t *p, int hstride, int vstride, int size,
                          int thresh, int ithresh, int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
      else do_filter4(p, hstride);
    }
    p += vstride;
  }
}

/* frame_dec.c's DoFilter for the MB at (mb_x, mb_y) of the full planes */
static void do_mb_filter(const VP8 *d, const FInfo *f, int mb_x, int mb_y,
                         uint8_t *yp, int ys, uint8_t *up, uint8_t *vp,
                         int uvs) {
  const int limit = f->limit, ilevel = f->ilevel;
  if (limit == 0) return;
  uint8_t *y_dst = yp + (size_t)mb_y * 16 * ys + mb_x * 16;
  if (d->filter_type == 1) {
    if (mb_x > 0) simple_filter(y_dst, 1, ys, limit + 4);
    if (f->inner)
      for (int k = 1; k < 4; ++k) simple_filter(y_dst + 4 * k, 1, ys, limit);
    if (mb_y > 0) simple_filter(y_dst, ys, 1, limit + 4);
    if (f->inner)
      for (int k = 1; k < 4; ++k)
        simple_filter(y_dst + 4 * k * ys, ys, 1, limit);
  } else {
    uint8_t *u_dst = up + (size_t)mb_y * 8 * uvs + mb_x * 8;
    uint8_t *v_dst = vp + (size_t)mb_y * 8 * uvs + mb_x * 8;
    const int hev_t = f->hev_thresh;
    if (mb_x > 0) {
      filter_loop26(y_dst, 1, ys, 16, limit + 4, ilevel, hev_t);
      filter_loop26(u_dst, 1, uvs, 8, limit + 4, ilevel, hev_t);
      filter_loop26(v_dst, 1, uvs, 8, limit + 4, ilevel, hev_t);
    }
    if (f->inner) {
      for (int k = 1; k < 4; ++k)
        filter_loop24(y_dst + 4 * k, 1, ys, 16, limit, ilevel, hev_t);
      filter_loop24(u_dst + 4, 1, uvs, 8, limit, ilevel, hev_t);
      filter_loop24(v_dst + 4, 1, uvs, 8, limit, ilevel, hev_t);
    }
    if (mb_y > 0) {
      filter_loop26(y_dst, ys, 1, 16, limit + 4, ilevel, hev_t);
      filter_loop26(u_dst, uvs, 1, 8, limit + 4, ilevel, hev_t);
      filter_loop26(v_dst, uvs, 1, 8, limit + 4, ilevel, hev_t);
    }
    if (f->inner) {
      for (int k = 1; k < 4; ++k)
        filter_loop24(y_dst + 4 * k * ys, ys, 1, 16, limit, ilevel, hev_t);
      filter_loop24(u_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t);
      filter_loop24(v_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t);
    }
  }
}

/* ---- YUV -> RGB with the fancy upsampler (yuv.h, upsampling.c) ---- */

static inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
static inline uint8_t yuv_clip8(int v) {
  return ((v & ~16383) == 0) ? (uint8_t)(v >> 6) : (v < 0) ? 0 : 255;
}
static inline void yuv_to_rgb(int y, int u, int v, uint8_t *rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) -
                     mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

#define LOAD_UV(u, v) ((uint32_t)(u) | ((uint32_t)(v) << 16))

static void upsample_pair(const uint8_t *top_y, const uint8_t *bottom_y,
                          const uint8_t *top_u, const uint8_t *top_v,
                          const uint8_t *cur_u, const uint8_t *cur_v,
                          uint8_t *top_dst, uint8_t *bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  uint32_t tl_uv = LOAD_UV(top_u[0], top_v[0]);
  uint32_t l_uv = LOAD_UV(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgb(top_y[0], uv0 & 0xff, (uv0 >> 16), top_dst);
  }
  if (bottom_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgb(bottom_y[0], uv0 & 0xff, (uv0 >> 16), bottom_dst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t_uv = LOAD_UV(top_u[x], top_v[x]);
    const uint32_t uv = LOAD_UV(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16),
                 top_dst + (2 * x - 1) * 3);
      yuv_to_rgb(top_y[2 * x], uv1 & 0xff, (uv1 >> 16), top_dst + 2 * x * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16),
                 bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x], uv1 & 0xff, (uv1 >> 16),
                 bottom_dst + 2 * x * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgb(top_y[len - 1], uv0 & 0xff, (uv0 >> 16),
                 top_dst + (len - 1) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, (uv0 >> 16),
                 bottom_dst + (len - 1) * 3);
    }
  }
}

/* The VP8 bitstream `buf` (after its chunk header) -> RGB rows at `out`
 * with `stride` bytes a row; `w`, `h` must be the header's. */
int webp_vp8_decode(const uint8_t *buf, size_t len, uint8_t *out, int stride,
                    int w, int h, char *err) {
  VP8 *d = (VP8 *)calloc(1, sizeof(VP8));
  const char *msg = NULL;
  uint8_t *yp = NULL, *up = NULL, *vp = NULL, *intra_t = NULL;
  MBInfo *mbs = NULL;
  uint8_t *top_nz = NULL, *top_nz_dc = NULL;
  int16_t *coeffs = NULL;
  int rc = 1;
  if (!d) {
    set_err(err, "VP8: out of memory");
    return 1;
  }
  if (!parse_headers(d, buf, len, &msg)) goto End;
  if (d->w != w || d->h != h) {
    msg = "VP8: size differs from the container's";
    goto End;
  }
  if (d->w == 0 || d->h == 0) {
    msg = "VP8: empty frame";
    goto End;
  }
  precompute_filter_strengths(d);
  const int mb_w = d->mb_w, mb_h = d->mb_h;
  const int ys = mb_w * 16, uvs = mb_w * 8;
  yp = (uint8_t *)malloc((size_t)ys * mb_h * 16);
  up = (uint8_t *)malloc((size_t)uvs * mb_h * 8);
  vp = (uint8_t *)malloc((size_t)uvs * mb_h * 8);
  intra_t = (uint8_t *)malloc((size_t)4 * mb_w);
  mbs = (MBInfo *)calloc((size_t)mb_w * mb_h, sizeof(MBInfo));
  top_nz = (uint8_t *)calloc((size_t)mb_w, 1);
  top_nz_dc = (uint8_t *)calloc((size_t)mb_w, 1);
  coeffs = (int16_t *)malloc(384 * sizeof(int16_t));
  if (!yp || !up || !vp || !intra_t || !mbs || !top_nz || !top_nz_dc ||
      !coeffs) {
    msg = "VP8: out of memory";
    goto End;
  }
  memset(intra_t, B_DC_PRED, (size_t)4 * mb_w);
  /* the work area of frame_dec.c: Y at rows 1..16, U and V below */
  uint8_t work[BPS * 17 + BPS * 9 * 2 + 64];
  uint8_t *y_dst = work + BPS + 8;
  uint8_t *u_dst = work + BPS * 17 + BPS + 8;
  uint8_t *v_dst = u_dst + 16;
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BR *tbr = &d->parts[mb_y & (d->num_parts - 1)];
    uint8_t intra_l[4], left_nz = 0, left_nz_dc = 0;
    memset(intra_l, B_DC_PRED, 4);
    for (int mb_x = 0; mb_x < mb_w; ++mb_x)
      parse_intra_mode(d, &d->br, &mbs[(size_t)mb_y * mb_w + mb_x],
                       intra_t + 4 * mb_x, intra_l);
    if (d->br.eof) {
      msg = "VP8: premature end of partition 0 (truncated)";
      goto End;
    }
    /* left border, as ReconstructRow initialises it */
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      memset(u_dst - BPS - 1, 127, 8 + 1);
      memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBInfo *mb = &mbs[(size_t)mb_y * mb_w + mb_x];
      int skip = d->use_skip ? mb->skip : 0;
      if (!skip) {
        skip = parse_residuals(d, tbr, mb, &top_nz[mb_x], &top_nz_dc[mb_x],
                               &left_nz, &left_nz_dc, coeffs);
      } else {
        left_nz = top_nz[mb_x] = 0;
        if (!mb->is_i4x4) left_nz_dc = top_nz_dc[mb_x] = 0;
        memset(coeffs, 0, 384 * sizeof(int16_t));
      }
      mb->f_inner = (uint8_t)(mb->is_i4x4 || !skip);
      if (tbr->eof) {
        msg = "VP8: premature end of file (truncated)";
        goto End;
      }
      /* reconstruct into the work area */
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j)
          memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      const uint8_t *top_y = yp + (size_t)(mb_y * 16 - 1) * ys + mb_x * 16;
      const uint8_t *top_u = up + (size_t)(mb_y * 8 - 1) * uvs + mb_x * 8;
      const uint8_t *top_v = vp + (size_t)(mb_y * 8 - 1) * uvs + mb_x * 8;
      if (mb_y > 0) {
        memcpy(y_dst - BPS, top_y, 16);
        memcpy(u_dst - BPS, top_u, 8);
        memcpy(v_dst - BPS, top_v, 8);
      }
      if (mb->is_i4x4) {
        uint8_t *top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) memset(top_right, top_y[15], 4);
          else memcpy(top_right, top_y + 16, 4);
        }
        memcpy(top_right + 4 * BPS, top_right, 4);
        memcpy(top_right + 8 * BPS, top_right, 4);
        memcpy(top_right + 12 * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t *dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          pred_luma4(mb->imodes[n], dst);
          transform_one(coeffs + n * 16, dst);
        }
      } else {
        pred_block(mb->imodes[0], mb_x, mb_y, y_dst, 16);
        for (int n = 0; n < 16; ++n)
          transform_one(coeffs + n * 16, y_dst + (n & 3) * 4 +
                                              (n >> 2) * 4 * BPS);
      }
      pred_block(mb->uvmode, mb_x, mb_y, u_dst, 8);
      pred_block(mb->uvmode, mb_x, mb_y, v_dst, 8);
      for (int n = 0; n < 4; ++n) {
        transform_one(coeffs + (16 + n) * 16, u_dst + (n & 1) * 4 +
                                                  (n >> 1) * 4 * BPS);
        transform_one(coeffs + (20 + n) * 16, v_dst + (n & 1) * 4 +
                                                  (n >> 1) * 4 * BPS);
      }
      /* to the unfiltered planes */
      for (int j = 0; j < 16; ++j)
        memcpy(yp + (size_t)(mb_y * 16 + j) * ys + mb_x * 16,
               y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(up + (size_t)(mb_y * 8 + j) * uvs + mb_x * 8,
               u_dst + j * BPS, 8);
        memcpy(vp + (size_t)(mb_y * 8 + j) * uvs + mb_x * 8,
               v_dst + j * BPS, 8);
      }
    }
  }
  /* the loop filter, in MB order over the reconstructed planes */
  if (d->filter_type > 0)
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const MBInfo *mb = &mbs[(size_t)mb_y * mb_w + mb_x];
        FInfo f = d->fstrengths[mb->segment][mb->is_i4x4];
        f.inner |= mb->f_inner;
        do_mb_filter(d, &f, mb_x, mb_y, yp, ys, up, vp, uvs);
      }
  /* fancy upsampling to RGB, as io_dec.c's EmitFancyRGB */
  upsample_pair(yp, NULL, up, vp, up, vp, out, NULL, w);
  int k = 1;
  for (; 2 * k < h; ++k)
    upsample_pair(yp + (size_t)(2 * k - 1) * ys, yp + (size_t)(2 * k) * ys,
                  up + (size_t)(k - 1) * uvs, vp + (size_t)(k - 1) * uvs,
                  up + (size_t)k * uvs, vp + (size_t)k * uvs,
                  out + (size_t)(2 * k - 1) * stride,
                  out + (size_t)(2 * k) * stride, w);
  if (!(h & 1) && h > 1)
    upsample_pair(yp + (size_t)(h - 1) * ys, NULL,
                  up + (size_t)(h / 2 - 1) * uvs, vp + (size_t)(h / 2 - 1) * uvs,
                  up + (size_t)(h / 2 - 1) * uvs, vp + (size_t)(h / 2 - 1) * uvs,
                  out + (size_t)(h - 1) * stride, NULL, w);
  rc = 0;
End:
  if (rc) set_err(err, msg ? msg : "VP8: decoding failed");
  free(yp);
  free(up);
  free(vp);
  free(intra_t);
  free(mbs);
  free(top_nz);
  free(top_nz_dc);
  free(coeffs);
  free(d);
  return rc;
}

/* The header's size of a VP8 key frame. */
int webp_vp8_info(const uint8_t *buf, size_t len, int *w, int *h) {
  if (len < 10) return 1;
  if (buf[3] != 0x9d || buf[4] != 0x01 || buf[5] != 0x2a) return 1;
  *w = ((buf[7] << 8) | buf[6]) & 0x3fff;
  *h = ((buf[9] << 8) | buf[8]) & 0x3fff;
  return 0;
}
