/* The port's JPEG codec on the host, with no libjpeg and no PIL.
 *
 * `jpeg_decode` gives the pixels that the JAX package's `load_image` gets
 * from PIL (`Image.open(path).convert("RGB")`, which runs libjpeg-turbo
 * with its defaults), and `jpeg_encode` writes the bytes of PIL's
 * `save(..., "JPEG", quality=q)`. The arithmetic is libjpeg-turbo's own:
 *
 * - decoding: the marker reader of jdmarker.c; the Huffman decoder of
 *   jdhuff.c (its fast and slow paths and its 64-bit bit buffer) and
 *   jdphuff.c (progressive: DC and AC, first and refining scans, EOBRUN);
 *   the islow IDCT as PIL's libjpeg-turbo runs it (jidctint-avx2.asm:
 *   jidctint.c's arithmetic in 16-bit lanes, saturated where jidctint.c's
 *   range-limit table wraps; the two agree on every valid file, and only
 *   the AVX2 form equals PIL on corrupt data); jdsample.c's fancy
 *   upsampling (h2v1, h2v2 and h1v2, each component's first and last row
 *   and column its own context) and plain replication for other integral
 *   factors; jdcolor.c's YCbCr->RGB tables.
 *   The colour space is guessed as jdapimin.c guesses it (JFIF, Adobe
 *   `transform`, or component ids 'R','G','B'); a grey image comes out
 *   repeated over three channels, as PIL's `.convert("RGB")` does. Four
 *   components are CMYK, or YCCK where an Adobe marker's transform is not
 *   0 (jdcolor.c ycck_cmyk_convert); PIL reads libjpeg's CMYK as CMYK;I
 *   (inverted) and converts it with Convert.c cmyk2rgb.
 * - truncation: PIL hands libjpeg the file 64 KiB at a time and raises
 *   "image file is truncated" when libjpeg asks for bytes past the end
 *   before the last row is out. The decoder keeps the same window over
 *   the data (`end`), so it needs the bytes that libjpeg needs: a file cut
 *   short raises where PIL raises, and decodes where PIL decodes.
 * - encoding: PIL's defaults, i.e. jpeg_set_defaults + jpeg_set_quality(q,
 *   TRUE): the JFIF APP0 header, two DQT, SOF0, four DHT, SOS; RGB->YCbCr
 *   (jccolor.c), 4:2:0 with jcprepct.c's edge expansion and jcsample.c's
 *   h2v2_downsample, jfdctint.c's islow FDCT, the quantization of
 *   jcdctmgr.c in its reciprocal form (16-bit DCTELEM, as libjpeg-turbo
 *   builds it with SIMD), the standard Huffman tables and the dummy blocks
 *   of jccoefct.c; the last byte padded with 1-bits.
 * - arithmetic decoding: jdarith.c (the Q-coder's Table D.2, DC and AC
 *   statistics bins, the DAC conditioning, restarts), sequential and
 *   progressive. It cannot suspend: its data past what PIL has fed raises,
 *   as libjpeg's JERR_CANT_SUSPEND does under PIL.
 * - block smoothing: jdcoefct.c smoothing_ok and decompress_smooth_data
 *   as libjpeg-turbo 2.1+ has them (a 5x5 block neighbourhood of DC
 *   values, DC-only images too); a DNL marker after a known height is
 *   skipped, as jdmarker.c skips it.
 * - TIFF strips (jpeg_decode_tiff): the JPEGTables stream, then the strip,
 *   every byte at hand and a fake EOI after, as libtiff's tif_jpeg.c.
 *
 * Not taken (each raises, naming it): lossless (SOF3, SOF11), and what
 * PIL refuses too: 12-bit samples, hierarchical files (SOF5-7, SOF13-15,
 * DHP, EXP), a height of 0 left to DNL. The tests run on the CPU
 * (tests/test_torch_port_jpeg.py, test_torch_port_codecs.py), against
 * the JAX package's load_image; chip_smoke.py's jpeg phase holds the
 * fixtures to PIL's digests on the card's host.
 *
 * Every call keeps its state in its own structures and reports an error
 * through the caller's buffer: threads may decode and encode at once.
 * Plain C entry points, bound with ctypes by `data/jpeg.py`. */

#include <setjmp.h>
#include <stdarg.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define ERR_LEN 256
#define CHUNK 65536               /* PIL's decodermaxblock */
#define MIN_GET_BITS 57           /* 64-bit bit buffer, jdhuff.h */
#define LOOKAHEAD 8
#define FAST_BYTES 512            /* jdhuff.c's BUFSIZE: bytes a block */
#define MAX_COMPS 4
#define MAX_BLOCKS 10             /* D_MAX_BLOCKS_IN_MCU */

/* zigzag index -> natural index; the extra entries keep a corrupt run
 * inside the block (jutils.c) */
static const int natural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

/* ------------------------------------------------ standard Huffman tables */

static const uint8_t dc_lum_bits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                        1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t dc_chr_bits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                        1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t dc_vals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t ac_lum_bits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                        5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t ac_lum_vals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t ac_chr_bits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                        7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t ac_chr_vals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

typedef struct {
  uint8_t bits[17];     /* codes of each length 1..16 */
  uint8_t vals[256];
  int defined;
} HuffSpec;

static void std_spec(HuffSpec* s, int ac, int chroma) {
  const uint8_t* bits = ac ? (chroma ? ac_chr_bits : ac_lum_bits)
                           : (chroma ? dc_chr_bits : dc_lum_bits);
  const uint8_t* vals = ac ? (chroma ? ac_chr_vals : ac_lum_vals) : dc_vals;
  int n = 0;
  memcpy(s->bits, bits, 17);
  for (int l = 1; l <= 16; ++l) n += bits[l];
  memset(s->vals, 0, 256);
  memcpy(s->vals, vals, (size_t)n);
  s->defined = 1;
}

/* the canonical codes of a table (Figures C.1 and C.2); returns the number
 * of symbols, or -1 for counts that are no Huffman code */
static int make_codes(const HuffSpec* s, uint8_t size[257],
                      uint32_t code[257]) {
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (p + s->bits[l] > 256) return -1;
    for (int i = 0; i < s->bits[l]; ++i) size[p++] = (uint8_t)l;
  }
  size[p] = 0;
  const int n = p;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) return -1;
    c <<= 1;
    ++si;
  }
  return n;
}

/* ------------------------------------------------------------- decoding */

typedef struct {        /* jdhuff.c's d_derived_tbl */
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
  uint16_t lookup[1 << LOOKAHEAD];  /* (length << 8) | symbol, or 9 << 8 */
} Huff;

typedef struct {
  int id, h, v, tq;
  int dc_tbl, ac_tbl;
  int wib, hib;         /* width_in_blocks, height_in_blocks */
  int bw, bh;           /* blocks stored: the interleaved MCU grid */
  int dw, dh;           /* downsampled_width, downsampled_height */
  int16_t* coef;        /* bh * bw blocks of 64, natural order */
  uint8_t* plane;       /* wib*8 columns, hib*8 rows after the IDCT */
  int16_t qt[64];       /* latched quantization table, natural order */
  int latched;
  int coef_bits[64];    /* progressive: Al of the last scan, -1 for none */
  /* lossless: each sample's difference (bw x bh of the MCU grid), the rows
   * that start a restart interval, the predictor and point transform */
  int32_t* diff;
  uint8_t* first;
  int pred, pt;
} Comp;

typedef struct {        /* the bit reader; pos is the next byte */
  uint64_t buf;
  int bits;
  size_t pos;
} Bits;

typedef struct {
  const uint8_t* data;
  size_t len, pos, end; /* the file; the next byte; the bytes PIL has fed */
  char* err;
  jmp_buf jmp;
  /* tables */
  uint16_t qtab[4][64];
  int qdef[4];
  HuffSpec dcs[4], acs[4];
  Huff dct[4], act[4];
  int restart_interval;
  int jfif, adobe, adobe_transform;
  uint8_t dac_l[16], dac_u[16], dac_k[16];  /* DAC conditioning (jdmarker.c) */
  /* frame */
  int have_sof, progressive, arith, lossless, w, h, ncomp, max_h, max_v, mcux,
      mcuy;
  Comp comp[MAX_COMPS];
  /* scan */
  int ns, sc[MAX_COMPS], Ss, Se, Ah, Al;
  int nblocks, member[MAX_BLOCKS];
  int scans, single_scan;
  int tail;             /* reading on after a single scan's last row */
  int tiff;             /* a TIFF strip: every byte at hand, a fake EOI after */
  int tables_only;      /* reading JPEGTables: EOI ends it */
  int out_raw, out_ycc; /* TIFF: the components as they are, or YCbCr->RGB */
  /* entropy state (jdhuff.c / jdphuff.c) */
  Bits bs;              /* buf and bits; the position is d->pos */
  int unread_marker, insufficient, next_restart, restarts_to_go;
  int last_dc[MAX_COMPS];
  unsigned eobrun;
  /* jdarith.c state: C and A registers, the bit counter, contexts, bins */
  int64_t ar_c, ar_a;
  int ar_ct, no_suspend;
  int dc_context[MAX_COMPS];
  uint8_t dc_stats[16][64], ac_stats[16][256], fixed_bin[4];
} Dec;

static void fail(Dec* d, const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(d->err, ERR_LEN, fmt, ap);
  va_end(ap);
  longjmp(d->jmp, 1);
}

static void truncated(Dec* d) {
  fail(d, "image file is truncated: the JPEG data ends before the image "
          "is complete (%zu bytes not processed)", d->len - d->pos);
}

/* PIL's next block of the file, or the truncation error where there is
 * none */
static void broken(Dec* d) {
  fail(d, "broken data stream when reading image file: libjpeg's arithmetic "
          "decoder cannot suspend, and its data runs past the %d bytes PIL "
          "had fed it", (int)d->end);
}

static void feed(Dec* d) {
  if (d->no_suspend && !d->tiff) broken(d);
  if (d->end >= d->len) {
    if (d->tail) longjmp(d->jmp, 2);
    if (d->tiff) fail(d, "the JPEG data of a TIFF strip or tile ends early");
    truncated(d);
  }
  d->end = d->end + CHUNK < d->len ? d->end + CHUNK : d->len;
}

/* one byte of a marker: a marker read that suspends in libjpeg restarts
 * with more data and no other effect */
static int mbyte(Dec* d) {
  while (d->pos >= d->end) feed(d);
  return d->data[d->pos++];
}

static int mword(Dec* d) {
  const int hi = mbyte(d);
  return (hi << 8) | mbyte(d);
}

static void skip(Dec* d, long n) {
  while (n > 0) {
    if (d->pos >= d->end) feed(d);
    size_t k = d->end - d->pos;
    if ((long)k > n) k = (size_t)n;
    d->pos += k;
    n -= (long)k;
  }
}

/* jdmarker.c next_marker: skip to the next marker, past fill bytes */
static void next_marker(Dec* d) {
  int c;
  for (;;) {
    c = mbyte(d);
    while (c != 0xFF) c = mbyte(d);
    do c = mbyte(d); while (c == 0xFF);
    if (c != 0) break;
  }
  d->unread_marker = c;
}

static void derive(Dec* d, const HuffSpec* s, int dc, Huff* t) {
  uint8_t size[257];
  uint32_t code[257];
  const int n = make_codes(s, size, code);
  if (n < 0) fail(d, "bad Huffman table");
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (s->bits[l]) {
      t->valoffset[l] = p - (int32_t)code[p];
      p += s->bits[l];
      t->maxcode[l] = (int32_t)code[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  memcpy(t->huffval, s->vals, 256);
  for (int i = 0; i < (1 << LOOKAHEAD); ++i)
    t->lookup[i] = (LOOKAHEAD + 1) << LOOKAHEAD;
  p = 0;
  for (int l = 1; l <= LOOKAHEAD; ++l) {
    for (int i = 1; i <= s->bits[l]; ++i, ++p) {
      int look = (int)(code[p] << (LOOKAHEAD - l));
      for (int ctr = 1 << (LOOKAHEAD - l); ctr > 0; --ctr)
        t->lookup[look++] = (uint16_t)((l << LOOKAHEAD) | s->vals[p]);
    }
  }
  if (dc)                 /* lossless differences take 16 categories */
    for (int i = 0; i < n; ++i)
      if (s->vals[i] > (d->lossless ? 16 : 15)) fail(d, "bad Huffman table");
}

/* jdhuff.c jpeg_fill_bit_buffer: 0 where libjpeg would suspend */
static int fill(Dec* d, Bits* b, int nbits) {
  uint64_t buf = b->buf;
  int bits = b->bits;
  size_t pos = b->pos;
  if (d->unread_marker == 0) {
    while (bits < MIN_GET_BITS) {
      int c;
      if (pos >= d->end) return 0;
      c = d->data[pos++];
      if (c == 0xFF) {
        do {
          if (pos >= d->end) return 0;
          c = d->data[pos++];
        } while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          d->unread_marker = c;
          break;
        }
      }
      buf = (buf << 8) | (uint64_t)c;
      bits += 8;
    }
  }
  if (d->unread_marker != 0 && nbits > bits) {
    d->insufficient = 1;          /* JWRN_HIT_MARKER: zeros from here */
    buf <<= MIN_GET_BITS - bits;
    bits = MIN_GET_BITS;
  }
  b->buf = buf;
  b->bits = bits;
  b->pos = pos;
  return 1;
}

#define GET_BITS(b, n) \
  (((int)((b)->buf >> ((b)->bits -= (n)))) & ((1 << (n)) - 1))
#define PEEK_BITS(b, n) \
  (((int)((b)->buf >> ((b)->bits - (n)))) & ((1 << (n)) - 1))
#define HUFF_EXTEND(x, s) ((x) < (1 << ((s) - 1)) ? (x) - (1 << (s)) + 1 : (x))
#define NEED(d, b, n, fail_action) \
  if ((b)->bits < (n) && !fill(d, b, n)) { fail_action; }

/* jdhuff.c jpeg_huff_decode: the symbol, or -1 to suspend */
static int huff_slow(Dec* d, Bits* b, const Huff* t, int l) {
  int32_t code;
  NEED(d, b, l, return -1);
  code = GET_BITS(b, l);
  while (code > t->maxcode[l]) {
    code <<= 1;
    NEED(d, b, 1, return -1);
    code |= GET_BITS(b, 1);
    ++l;
  }
  if (l > 16) return 0;           /* JWRN_HUFF_BAD_CODE */
  return t->huffval[(code + t->valoffset[l]) & 0xFF];
}

/* jdhuff.h HUFF_DECODE */
static inline int huff_decode(Dec* d, Bits* b, const Huff* t) {
  if (b->bits < LOOKAHEAD) {
    if (!fill(d, b, 0)) return -1;
    if (b->bits < LOOKAHEAD) return huff_slow(d, b, t, 1);
  }
  const int look = PEEK_BITS(b, LOOKAHEAD);
  const int nb = t->lookup[look] >> LOOKAHEAD;
  if (nb <= LOOKAHEAD) {
    b->bits -= nb;
    return t->lookup[look] & 0xFF;
  }
  return huff_slow(d, b, t, nb);
}

/* jdmarker.c read_restart_marker with jpeg_resync_to_restart */
static void read_restart_marker(Dec* d) {
  if (d->unread_marker == 0) next_marker(d);
  if (d->unread_marker == 0xD0 + d->next_restart) {
    d->unread_marker = 0;
  } else {
    const int desired = d->next_restart;
    for (;;) {
      const int m = d->unread_marker;
      int action;
      if (m < 0xC0)
        action = 2;
      else if (m < 0xD0 || m > 0xD7)
        action = 3;
      else if (m == 0xD0 + ((desired + 1) & 7) ||
               m == 0xD0 + ((desired + 2) & 7))
        action = 3;
      else if (m == 0xD0 + ((desired - 1) & 7) ||
               m == 0xD0 + ((desired - 2) & 7))
        action = 2;
      else
        action = 1;
      if (action == 1) {
        d->unread_marker = 0;
        break;
      }
      if (action == 3) break;
      next_marker(d);
    }
  }
  d->next_restart = (d->next_restart + 1) & 7;
}

/* jdhuff.c / jdphuff.c process_restart */
static void process_restart(Dec* d) {
  d->bs.bits = 0;
  read_restart_marker(d);
  for (int i = 0; i < MAX_COMPS; ++i) d->last_dc[i] = 0;
  d->eobrun = 0;
  d->restarts_to_go = d->restart_interval;
  if (d->unread_marker == 0) d->insufficient = 0;
}

/* jdhuff.c decode_mcu_fast: 0 where a marker was met (the slow path then
 * decodes the MCU again) */
static int mcu_fast(Dec* d, int16_t** blocks) {
  const uint8_t* data = d->data;
  const size_t len = d->len;
  uint64_t buf = d->bs.buf;
  int bits = d->bs.bits;
  size_t pos = d->pos;
  int last[MAX_COMPS];
  memcpy(last, d->last_dc, sizeof last);

#define GET_BYTE_FAST                                             \
  {                                                               \
    const int c0 = pos < len ? data[pos] : 0;                     \
    const int c1 = pos + 1 < len ? data[pos + 1] : 0;             \
    ++pos;                                                        \
    buf = (buf << 8) | (uint64_t)c0;                              \
    bits += 8;                                                    \
    if (c0 == 0xFF) {                                             \
      ++pos;                                                      \
      if (c1 != 0) {                                              \
        d->unread_marker = c1;                                    \
        pos -= 2;                                                 \
        buf &= ~(uint64_t)0xFF;                                   \
      }                                                           \
    }                                                             \
  }
#define FILL_FAST                                                 \
  if (bits <= 16) {                                               \
    GET_BYTE_FAST GET_BYTE_FAST GET_BYTE_FAST                     \
    GET_BYTE_FAST GET_BYTE_FAST GET_BYTE_FAST                     \
  }
#define FAST_GET(n) (((int)(buf >> (bits -= (n)))) & ((1 << (n)) - 1))
#define HUFF_DECODE_FAST(s, nb, t)                                \
  FILL_FAST;                                                      \
  s = ((int)(buf >> (bits - LOOKAHEAD))) & 0xFF;                  \
  s = (t)->lookup[s];                                             \
  nb = s >> LOOKAHEAD;                                            \
  bits -= nb;                                                     \
  s &= 0xFF;                                                      \
  if (nb > LOOKAHEAD) {                                           \
    s = (int)(buf >> bits) & ((1 << nb) - 1);                     \
    while (s > (t)->maxcode[nb]) {                                \
      s <<= 1;                                                    \
      s |= FAST_GET(1);                                           \
      ++nb;                                                       \
    }                                                             \
    s = nb > 16 ? 0 : (t)->huffval[(s + (t)->valoffset[nb]) & 0xFF]; \
  }

  for (int blkn = 0; blkn < d->nblocks; ++blkn) {
    int16_t* block = blocks[blkn];
    const int ci = d->member[blkn];
    const Comp* c = &d->comp[d->sc[ci]];
    const Huff* dct = &d->dct[c->dc_tbl];
    const Huff* act = &d->act[c->ac_tbl];
    int s, k, r, l;
    HUFF_DECODE_FAST(s, l, dct);
    if (s) {
      FILL_FAST;
      r = FAST_GET(s);
      s = HUFF_EXTEND(r, s);
    }
    s += last[ci];
    last[ci] = s;
    block[0] = (int16_t)s;
    for (k = 1; k < 64; ++k) {
      HUFF_DECODE_FAST(s, l, act);
      r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        FILL_FAST;
        r = FAST_GET(s);
        s = HUFF_EXTEND(r, s);
        block[natural[k]] = (int16_t)s;
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }
  if (d->unread_marker != 0) {
    d->unread_marker = 0;
    return 0;
  }
  d->bs.buf = buf;
  d->bs.bits = bits;
  d->pos = pos;
  memcpy(d->last_dc, last, sizeof last);
  return 1;
}

static inline Bits load_bits(const Dec* d) {
  Bits b = d->bs;
  b.pos = d->pos;
  return b;
}

static inline void save_bits(Dec* d, const Bits* b) {
  d->bs = *b;
  d->pos = b->pos;
}

/* jdhuff.c decode_mcu_slow: 0 to suspend */
static int mcu_slow(Dec* d, int16_t** blocks) {
  Bits b = load_bits(d);
  int last[MAX_COMPS];
  memcpy(last, d->last_dc, sizeof last);
  for (int blkn = 0; blkn < d->nblocks; ++blkn) {
    int16_t* block = blocks[blkn];
    const int ci = d->member[blkn];
    const Comp* c = &d->comp[d->sc[ci]];
    const Huff* act = &d->act[c->ac_tbl];
    int s = huff_decode(d, &b, &d->dct[c->dc_tbl]), r;
    if (s < 0) return 0;
    if (s) {
      NEED(d, &b, s, return 0);
      r = GET_BITS(&b, s);
      s = HUFF_EXTEND(r, s);
    }
    s = (int)((unsigned)s + (unsigned)last[ci]);
    last[ci] = s;
    block[0] = (int16_t)s;
    for (int k = 1; k < 64; ++k) {
      s = huff_decode(d, &b, act);
      if (s < 0) return 0;
      r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        NEED(d, &b, s, return 0);
        r = GET_BITS(&b, s);
        s = HUFF_EXTEND(r, s);
        block[natural[k]] = (int16_t)s;
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }
  save_bits(d, &b);
  memcpy(d->last_dc, last, sizeof last);
  return 1;
}

/* jdhuff.c decode_mcu */
static int mcu_sequential(Dec* d, int16_t** blocks) {
  int usefast = 1;
  if (d->restart_interval) {
    if (d->restarts_to_go == 0) process_restart(d);
    usefast = 0;
  }
  if (d->end - d->pos < (size_t)FAST_BYTES * (size_t)d->nblocks ||
      d->unread_marker != 0)
    usefast = 0;
  if (!d->insufficient) {
    if (!(usefast && mcu_fast(d, blocks)) && !mcu_slow(d, blocks)) return 0;
  }
  if (d->restart_interval) d->restarts_to_go--;
  return 1;
}

/* jdphuff.c decode_mcu_DC_first */
static int mcu_dc_first(Dec* d, int16_t** blocks) {
  if (d->restart_interval && d->restarts_to_go == 0) process_restart(d);
  if (!d->insufficient) {
    Bits b = load_bits(d);
    int last[MAX_COMPS];
    memcpy(last, d->last_dc, sizeof last);
    for (int blkn = 0; blkn < d->nblocks; ++blkn) {
      const int ci = d->member[blkn];
      const Comp* c = &d->comp[d->sc[ci]];
      int s = huff_decode(d, &b, &d->dct[c->dc_tbl]), r;
      if (s < 0) return 0;
      if (s) {
        NEED(d, &b, s, return 0);
        r = GET_BITS(&b, s);
        s = HUFF_EXTEND(r, s);
      }
      const long long sum = (long long)s + last[ci];
      if (sum > 2147483647LL || sum < -2147483647LL - 1)
        fail(d, "bogus DCT coefficient in a progressive DC scan");
      last[ci] = (int)sum;
      blocks[blkn][0] = (int16_t)((unsigned)last[ci] << d->Al);
    }
    save_bits(d, &b);
    memcpy(d->last_dc, last, sizeof last);
  }
  if (d->restart_interval) d->restarts_to_go--;
  return 1;
}

/* jdphuff.c decode_mcu_AC_first */
static int mcu_ac_first(Dec* d, int16_t** blocks) {
  if (d->restart_interval && d->restarts_to_go == 0) process_restart(d);
  if (!d->insufficient) {
    unsigned eobrun = d->eobrun;
    if (eobrun > 0) {
      --eobrun;
    } else {
      Bits b = load_bits(d);
      int16_t* block = blocks[0];
      const Huff* t = &d->act[d->comp[d->sc[0]].ac_tbl];
      for (int k = d->Ss; k <= d->Se; ++k) {
        int s = huff_decode(d, &b, t), r;
        if (s < 0) return 0;
        r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          NEED(d, &b, s, return 0);
          r = GET_BITS(&b, s);
          s = HUFF_EXTEND(r, s);
          block[natural[k]] = (int16_t)((unsigned)s << d->Al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1u << r;
          if (r) {
            NEED(d, &b, r, return 0);
            r = GET_BITS(&b, r);
            eobrun += (unsigned)r;
          }
          --eobrun;
          break;
        }
      }
      save_bits(d, &b);
    }
    d->eobrun = eobrun;
  }
  if (d->restart_interval) d->restarts_to_go--;
  return 1;
}

/* jdphuff.c decode_mcu_DC_refine */
static int mcu_dc_refine(Dec* d, int16_t** blocks) {
  const int p1 = 1 << d->Al;
  if (d->restart_interval && d->restarts_to_go == 0) process_restart(d);
  Bits b = load_bits(d);
  for (int blkn = 0; blkn < d->nblocks; ++blkn) {
    NEED(d, &b, 1, return 0);
    if (GET_BITS(&b, 1)) blocks[blkn][0] = (int16_t)(blocks[blkn][0] | p1);
  }
  save_bits(d, &b);
  if (d->restart_interval) d->restarts_to_go--;
  return 1;
}

/* jdphuff.c decode_mcu_AC_refine: on suspension the coefficients made
 * nonzero here are zeroed again; bits added to others are seen again */
static int mcu_ac_refine(Dec* d, int16_t** blocks) {
  const int p1 = 1 << d->Al;
  const int m1 = (int)(~0u << d->Al);
  int newnz[64], num_newnz = 0;
  if (d->restart_interval && d->restarts_to_go == 0) process_restart(d);
  if (!d->insufficient) {
    Bits b = load_bits(d);
    unsigned eobrun = d->eobrun;
    int16_t* block = blocks[0];
    const Huff* t = &d->act[d->comp[d->sc[0]].ac_tbl];
    int k = d->Ss;
    if (eobrun == 0) {
      for (; k <= d->Se; ++k) {
        int s = huff_decode(d, &b, t), r;
        if (s < 0) goto undo;
        r = s >> 4;
        s &= 15;
        if (s) {
          NEED(d, &b, 1, goto undo);
          s = GET_BITS(&b, 1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1u << r;
          if (r) {
            NEED(d, &b, r, goto undo);
            r = GET_BITS(&b, r);
            eobrun += (unsigned)r;
          }
          break;
        }
        do {
          int16_t* coef = block + natural[k];
          if (*coef != 0) {
            NEED(d, &b, 1, goto undo);
            if (GET_BITS(&b, 1) && (*coef & p1) == 0)
              *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= d->Se);
        if (s) {
          const int pos = natural[k];
          block[pos] = (int16_t)s;
          newnz[num_newnz++] = pos;
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= d->Se; ++k) {
        int16_t* coef = block + natural[k];
        if (*coef != 0) {
          NEED(d, &b, 1, goto undo);
          if (GET_BITS(&b, 1) && (*coef & p1) == 0)
            *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
        }
      }
      --eobrun;
    }
    save_bits(d, &b);
    d->eobrun = eobrun;
  }
  if (d->restart_interval) d->restarts_to_go--;
  return 1;
undo:
  while (num_newnz > 0) blocks[0][newnz[--num_newnz]] = 0;
  return 0;
}

/* ------------------------------------------------- arithmetic decoding */

/* jaricom.c jpeg_aritab: Table D.2 of the standard, (Qe << 16) |
 * (Next_Index_MPS << 8) | (Switch_MPS << 7) | Next_Index_LPS; the last
 * entry is the fixed 0.5 estimate */
static const int32_t aritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

/* jdarith.c get_byte: the arithmetic decoder cannot suspend (feed fails) */
static int arith_byte(Dec* d) {
  while (d->pos >= d->end) feed(d);
  return d->data[d->pos++];
}

/* jdarith.c arith_decode: one binary decision with the statistics bin st;
 * a marker in the data supplies zeros from there */
static int arith_decode(Dec* d, uint8_t* st) {
  while (d->ar_a < 0x8000L) {
    if (--d->ar_ct < 0) {
      int data = 0;
      if (!d->unread_marker) {
        data = arith_byte(d);
        if (data == 0xFF) {
          do data = arith_byte(d); while (data == 0xFF);
          if (data == 0) {
            data = 0xFF;
          } else {
            d->unread_marker = data;
            data = 0;
          }
        }
      }
      d->ar_c = (d->ar_c << 8) | data;
      if ((d->ar_ct += 8) < 0)
        if (++d->ar_ct == 0) d->ar_a = 0x8000L;
    }
    d->ar_a <<= 1;
  }
  int sv = *st;
  int64_t qe = aritab[sv & 0x7F];
  const int nl = (int)(qe & 0xFF);
  qe >>= 8;
  const int nm = (int)(qe & 0xFF);
  qe >>= 8;
  int64_t temp = d->ar_a - qe;
  d->ar_a = temp;
  temp = (int64_t)((uint64_t)temp << (d->ar_ct & 63));
  if (d->ar_c >= temp) {
    d->ar_c -= temp;
    if (d->ar_a < qe) {
      d->ar_a = qe;
      *st = (uint8_t)((sv & 0x80) ^ nm);
    } else {
      d->ar_a = qe;
      *st = (uint8_t)((sv & 0x80) ^ nl);
      sv ^= 0x80;
    }
  } else if (d->ar_a < 0x8000L) {
    if (d->ar_a < qe) {
      *st = (uint8_t)((sv & 0x80) ^ nl);
      sv ^= 0x80;
    } else {
      *st = (uint8_t)((sv & 0x80) ^ nm);
    }
  }
  return sv >> 7;
}

/* jdarith.c process_restart: the statistics of the scan's tables and the
 * registers start again */
static void arith_restart(Dec* d) {
  read_restart_marker(d);
  for (int i = 0; i < d->ns; ++i) {
    const Comp* c = &d->comp[d->sc[i]];
    if (!d->progressive || (d->Ss == 0 && d->Ah == 0)) {
      memset(d->dc_stats[c->dc_tbl], 0, 64);
      d->last_dc[i] = 0;
      d->dc_context[i] = 0;
    }
    if (!d->progressive || d->Ss) memset(d->ac_stats[c->ac_tbl], 0, 256);
  }
  d->ar_c = 0;
  d->ar_a = 0;
  d->ar_ct = -16;
  d->restarts_to_go = d->restart_interval;
}

static void arith_restart_check(Dec* d) {
  if (d->restart_interval) {
    if (d->restarts_to_go == 0) arith_restart(d);
    d->restarts_to_go--;
  }
}

/* Figures F.19-F.24 for one DC difference of block member ci: the value
 * added to the prediction, or 0; -1 where libjpeg stops the scan */
static int arith_dc_diff(Dec* d, int ci, int tbl, int* diff) {
  uint8_t* st = d->dc_stats[tbl] + d->dc_context[ci];
  *diff = 0;
  if (arith_decode(d, st) == 0) {
    d->dc_context[ci] = 0;
    return 0;
  }
  const int sign = arith_decode(d, st + 1);
  int m, v;
  st += 2 + sign;
  if ((m = arith_decode(d, st)) != 0) {
    st = d->dc_stats[tbl] + 20;
    while (arith_decode(d, st)) {
      if ((m <<= 1) == 0x8000) {
        d->ar_ct = -1;          /* JWRN_ARITH_BAD_CODE: magnitude overflow */
        return -1;
      }
      st += 1;
    }
  }
  if (m < (int)((1L << d->dac_l[tbl]) >> 1))
    d->dc_context[ci] = 0;
  else if (m > (int)((1L << d->dac_u[tbl]) >> 1))
    d->dc_context[ci] = 12 + sign * 4;
  else
    d->dc_context[ci] = 4 + sign * 4;
  v = m;
  st += 14;
  while (m >>= 1)
    if (arith_decode(d, st)) v |= m;
  v += 1;
  *diff = sign ? -v : v;
  return 0;
}

/* Figures F.21-F.24 for the AC value at zigzag k, st on its bins: the
 * value, with 0 where libjpeg stops the scan (ct set to -1) */
static int arith_ac_value(Dec* d, int tbl, int k, uint8_t* st) {
  const int sign = arith_decode(d, d->fixed_bin);
  int m, v;
  st += 2;
  if ((m = arith_decode(d, st)) != 0) {
    if (arith_decode(d, st)) {
      m <<= 1;
      st = d->ac_stats[tbl] + (k <= d->dac_k[tbl] ? 189 : 217);
      while (arith_decode(d, st)) {
        if ((m <<= 1) == 0x8000) {
          d->ar_ct = -1;
          return 0;
        }
        st += 1;
      }
    }
  }
  v = m;
  st += 14;
  while (m >>= 1)
    if (arith_decode(d, st)) v |= m;
  v += 1;
  return sign ? -v : v;
}

/* jdarith.c decode_mcu (sequential) */
static int mcu_arith(Dec* d, int16_t** blocks) {
  arith_restart_check(d);
  if (d->ar_ct == -1) return 1;
  for (int blkn = 0; blkn < d->nblocks; ++blkn) {
    int16_t* block = blocks[blkn];
    const int ci = d->member[blkn];
    const Comp* c = &d->comp[d->sc[ci]];
    int diff;
    if (arith_dc_diff(d, ci, c->dc_tbl, &diff) < 0) return 1;
    d->last_dc[ci] = (d->last_dc[ci] + diff) & 0xffff;
    block[0] = (int16_t)d->last_dc[ci];
    const int tbl = c->ac_tbl;
    for (int k = 1; k <= 63; ++k) {
      uint8_t* st = d->ac_stats[tbl] + 3 * (k - 1);
      if (arith_decode(d, st)) break;               /* EOB */
      while (arith_decode(d, st + 1) == 0) {
        st += 3;
        if (++k > 63) {
          d->ar_ct = -1;                            /* spectral overflow */
          return 1;
        }
      }
      const int v = arith_ac_value(d, tbl, k, st);
      if (d->ar_ct == -1) return 1;
      block[natural[k]] = (int16_t)v;
    }
  }
  return 1;
}

/* jdarith.c decode_mcu_DC_first */
static int mcu_arith_dc_first(Dec* d, int16_t** blocks) {
  arith_restart_check(d);
  if (d->ar_ct == -1) return 1;
  for (int blkn = 0; blkn < d->nblocks; ++blkn) {
    const int ci = d->member[blkn];
    int diff;
    if (arith_dc_diff(d, ci, d->comp[d->sc[ci]].dc_tbl, &diff) < 0) return 1;
    d->last_dc[ci] = (d->last_dc[ci] + diff) & 0xffff;
    blocks[blkn][0] = (int16_t)((unsigned)d->last_dc[ci] << d->Al);
  }
  return 1;
}

/* jdarith.c decode_mcu_AC_first */
static int mcu_arith_ac_first(Dec* d, int16_t** blocks) {
  arith_restart_check(d);
  if (d->ar_ct == -1) return 1;
  int16_t* block = blocks[0];
  const int tbl = d->comp[d->sc[0]].ac_tbl;
  for (int k = d->Ss; k <= d->Se; ++k) {
    uint8_t* st = d->ac_stats[tbl] + 3 * (k - 1);
    if (arith_decode(d, st)) break;
    while (arith_decode(d, st + 1) == 0) {
      st += 3;
      if (++k > d->Se) {
        d->ar_ct = -1;
        return 1;
      }
    }
    const int v = arith_ac_value(d, tbl, k, st);
    if (d->ar_ct == -1) return 1;
    block[natural[k]] = (int16_t)((unsigned)v << d->Al);
  }
  return 1;
}

/* jdarith.c decode_mcu_DC_refine (no check of a stopped scan, as there) */
static int mcu_arith_dc_refine(Dec* d, int16_t** blocks) {
  arith_restart_check(d);
  const int p1 = 1 << d->Al;
  for (int blkn = 0; blkn < d->nblocks; ++blkn)
    if (arith_decode(d, d->fixed_bin))
      blocks[blkn][0] = (int16_t)(blocks[blkn][0] | p1);
  return 1;
}

/* jdarith.c decode_mcu_AC_refine */
static int mcu_arith_ac_refine(Dec* d, int16_t** blocks) {
  arith_restart_check(d);
  if (d->ar_ct == -1) return 1;
  int16_t* block = blocks[0];
  const int tbl = d->comp[d->sc[0]].ac_tbl;
  const int p1 = 1 << d->Al;
  const int m1 = (int)(~0u << d->Al);
  int kex;
  for (kex = d->Se; kex > 0; kex--)
    if (block[natural[kex]]) break;
  for (int k = d->Ss; k <= d->Se; ++k) {
    uint8_t* st = d->ac_stats[tbl] + 3 * (k - 1);
    if (k > kex && arith_decode(d, st)) break;
    for (;;) {
      int16_t* coef = block + natural[k];
      if (*coef) {
        if (arith_decode(d, st + 2))
          *coef = (int16_t)(*coef < 0 ? *coef + m1 : *coef + p1);
        break;
      }
      if (arith_decode(d, st + 1)) {
        *coef = (int16_t)(arith_decode(d, d->fixed_bin) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > d->Se) {
        d->ar_ct = -1;
        return 1;
      }
    }
  }
  return 1;
}

/* ------------------------------------------------------------- markers */

static void get_sof(Dec* d, int marker, int header_only) {
  if (d->have_sof) fail(d, "a second SOF marker");
  const int length = mword(d);
  const int prec = mbyte(d);
  d->h = mword(d);
  d->w = mword(d);
  d->ncomp = mbyte(d);
  if (prec != 8)
    fail(d, "%d-bit samples: 12-bit and other precisions are not yet taken "
            "by the port's JPEG decoder (8-bit only)", prec);
  if (d->h == 0)
    fail(d, "the image height is 0, to be given by a DNL marker: DNL is "
            "not yet taken by the port's JPEG decoder");
  if (d->w == 0 || d->ncomp == 0) fail(d, "empty JPEG image (DNL not taken)");
  if (d->w > 65500 || d->h > 65500)
    fail(d, "the image is %d x %d pixels, over JPEG's 65500", d->w, d->h);
  if (length != 8 + 3 * d->ncomp) fail(d, "bogus SOF marker length");
  if (d->ncomp != 1 && d->ncomp != 3 && d->ncomp != 4 &&
      !(d->tiff && d->ncomp == 2))
    fail(d, "a JPEG of %d components: only 1 (grey), 3 and 4 (CMYK or YCCK) "
            "are taken", d->ncomp);
  d->progressive = marker == 0xC2 || marker == 0xCA;
  d->arith = marker == 0xC9 || marker == 0xCA;
  d->lossless = marker == 0xC3;
  const int unit = d->lossless ? 1 : 8;   /* a sample, or an 8x8 block */
  d->max_h = d->max_v = 1;
  for (int i = 0; i < d->ncomp; ++i) {
    Comp* c = &d->comp[i];
    c->id = mbyte(d);
    const int f = mbyte(d);
    c->h = f >> 4;
    c->v = f & 15;
    c->tq = mbyte(d);
    if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4)
      fail(d, "bogus sampling factors %dx%d", c->h, c->v);
    if (c->tq > 3) fail(d, "bogus quantization table index %d", c->tq);
    if (c->h > d->max_h) d->max_h = c->h;
    if (c->v > d->max_v) d->max_v = c->v;
    for (int k = 0; k < 64; ++k) c->coef_bits[k] = -1;
  }
  d->mcux = (d->w + unit * d->max_h - 1) / (unit * d->max_h);
  d->mcuy = (d->h + unit * d->max_v - 1) / (unit * d->max_v);
  for (int i = 0; i < d->ncomp; ++i) {
    Comp* c = &d->comp[i];
    c->wib = (int)(((long)d->w * c->h + 8L * d->max_h - 1) / (8L * d->max_h));
    c->hib = (int)(((long)d->h * c->v + 8L * d->max_v - 1) / (8L * d->max_v));
    c->dw = (int)(((long)d->w * c->h + d->max_h - 1) / d->max_h);
    c->dh = (int)(((long)d->h * c->v + d->max_v - 1) / d->max_v);
    c->bw = d->mcux * c->h;
    c->bh = d->mcuy * c->v;
    if (!header_only && d->lossless) {
      c->diff = (int32_t*)calloc((size_t)c->bw * c->bh, sizeof(int32_t));
      c->first = (uint8_t*)calloc((size_t)c->bh, 1);
      if (!c->diff || !c->first)
        fail(d, "out of memory for a %d x %d JPEG", d->w, d->h);
    } else if (!header_only) {
      c->coef = (int16_t*)calloc((size_t)c->bw * c->bh * 64, sizeof(int16_t));
      if (!c->coef) fail(d, "out of memory for a %d x %d JPEG", d->w, d->h);
    }
  }
  d->have_sof = 1;
}

static void get_dqt(Dec* d) {
  long length = mword(d) - 2;
  while (length > 0) {
    const int n = mbyte(d);
    const int prec = n >> 4, t = n & 15;
    --length;
    if (t > 3) fail(d, "bogus DQT index %d", t);
    if (length < 64L * (prec ? 2 : 1))
      fail(d, "a DQT table of fewer than 64 entries");
    for (int i = 0; i < 64; ++i)
      d->qtab[t][natural[i]] = (uint16_t)(prec ? mword(d) : mbyte(d));
    d->qdef[t] = 1;
    length -= 64L * (prec ? 2 : 1);
  }
  if (length != 0) fail(d, "bogus DQT marker length");
}

static void get_dht(Dec* d) {
  long length = mword(d) - 2;
  while (length > 16) {
    int index = mbyte(d), count = 0;
    HuffSpec s;
    s.bits[0] = 0;
    for (int i = 1; i <= 16; ++i) {
      s.bits[i] = (uint8_t)mbyte(d);
      count += s.bits[i];
    }
    length -= 17;
    if (count > 256 || count > length) fail(d, "bogus Huffman table");
    memset(s.vals, 0, 256);
    for (int i = 0; i < count; ++i) s.vals[i] = (uint8_t)mbyte(d);
    length -= count;
    s.defined = 1;
    const int ac = index & 0x10;
    index &= ~0x10;
    if (index > 3) fail(d, "bogus DHT index %d", index);
    if (ac)
      d->acs[index] = s;
    else
      d->dcs[index] = s;
  }
  if (length != 0) fail(d, "bogus DHT marker length");
}

static void get_app(Dec* d, int marker) {
  const long length = mword(d) - 2;
  uint8_t b[14];
  const long keep = marker == 0xE0 ? 14 : marker == 0xEE ? 12 : 0;
  const long n = length < keep ? length : keep;
  if (length < 0) fail(d, "bogus marker length");
  for (long i = 0; i < n; ++i) b[i] = (uint8_t)mbyte(d);
  skip(d, length - n);
  if (marker == 0xE0 && n >= 14 && memcmp(b, "JFIF", 5) == 0) d->jfif = 1;
  if (marker == 0xEE && n >= 12 && memcmp(b, "Adobe", 5) == 0) {
    d->adobe = 1;
    d->adobe_transform = b[11];
  }
}

/* jdmarker.c get_dac: arithmetic conditioning, L and U of a DC table and
 * K of an AC table */
static void get_dac(Dec* d) {
  long length = mword(d) - 2;
  while (length > 0) {
    const int index = mbyte(d), val = mbyte(d);
    length -= 2;
    if (index >= 32) fail(d, "bogus DAC index %d", index);
    if (index >= 16) {
      d->dac_k[index - 16] = (uint8_t)val;
    } else {
      d->dac_l[index] = (uint8_t)(val & 15);
      d->dac_u[index] = (uint8_t)(val >> 4);
      if (d->dac_l[index] > d->dac_u[index])
        fail(d, "bogus DAC value 0x%x", val);
    }
  }
  if (length != 0) fail(d, "bogus DAC marker length");
}

static void get_sos(Dec* d) {
  if (!d->have_sof) fail(d, "SOS marker before SOF");
  const int length = mword(d);
  const int n = mbyte(d);
  int used[MAX_COMPS] = {0};
  if (length != n * 2 + 6 || n < 1 || n > 4) fail(d, "bogus SOS marker");
  for (int i = 0; i < n; ++i) {
    const int id = mbyte(d), f = mbyte(d);
    int ci = 0;
    while (ci < d->ncomp && (d->comp[ci].id != id || used[ci])) ++ci;
    if (ci == d->ncomp) fail(d, "SOS names component id %d, not in SOF", id);
    used[ci] = 1;
    d->sc[i] = ci;
    d->comp[ci].dc_tbl = f >> 4;
    d->comp[ci].ac_tbl = f & 15;
  }
  d->ns = n;
  d->Ss = mbyte(d);
  d->Se = mbyte(d);
  const int a = mbyte(d);
  d->Ah = a >> 4;
  d->Al = a & 15;
  d->next_restart = 0;
  ++d->scans;
}

static void table(Dec* d, int dc, int index) {
  HuffSpec* s = dc ? &d->dcs[index] : &d->acs[index];
  if (index > 3) fail(d, "a scan names Huffman table %d", index);
  if (!s->defined) {
    if (index > 1) fail(d, "a scan names Huffman table %d, not defined",
                        index);
    std_spec(s, !dc, index == 1);  /* libjpeg-turbo's default tables */
  }
  derive(d, s, dc, dc ? &d->dct[index] : &d->act[index]);
}

/* jdinput.c per_scan_setup and latch_quant_tables, and the scan checks of
 * jdphuff.c start_pass_phuff_decoder */
static void start_scan(Dec* d, int* mcus_per_row, int* mcu_rows) {
  for (int i = 0; i < d->ns; ++i) {
    Comp* c = &d->comp[d->sc[i]];
    if (!c->latched && d->lossless) {
      c->latched = 1;             /* lossless: no quantization */
    } else if (!c->latched) {
      if (!d->qdef[c->tq])
        fail(d, "quantization table %d is not defined", c->tq);
      for (int k = 0; k < 64; ++k) c->qt[k] = (int16_t)d->qtab[c->tq][k];
      c->latched = 1;
    }
  }
  if (d->ns == 1) {
    const Comp* c = &d->comp[d->sc[0]];
    *mcus_per_row = c->wib;
    *mcu_rows = c->hib;
    d->nblocks = 1;
    d->member[0] = 0;
  } else {
    *mcus_per_row = d->mcux;
    *mcu_rows = d->mcuy;
    d->nblocks = 0;
    for (int i = 0; i < d->ns; ++i) {
      const Comp* c = &d->comp[d->sc[i]];
      if (d->nblocks + c->h * c->v > MAX_BLOCKS)
        fail(d, "sampling factors too large for an interleaved scan");
      for (int k = 0; k < c->h * c->v; ++k) d->member[d->nblocks++] = i;
    }
  }
  if (d->progressive) {
    const int dc_band = d->Ss == 0;
    int bad = dc_band ? d->Se != 0 : (d->Ss > d->Se || d->Se > 63 ||
                                      d->ns != 1);
    if (d->Ah != 0 && d->Al != d->Ah - 1) bad = 1;
    if (d->Al > 13) bad = 1;
    if (bad)
      fail(d, "invalid progressive scan Ss=%d Se=%d Ah=%d Al=%d", d->Ss,
           d->Se, d->Ah, d->Al);
    for (int i = 0; i < d->ns; ++i) {
      Comp* c = &d->comp[d->sc[i]];
      for (int k = d->Ss; k <= d->Se; ++k) c->coef_bits[k] = d->Al;
      if (d->arith) continue;
      if (dc_band) {
        if (d->Ah == 0) table(d, 1, c->dc_tbl);
      } else {
        table(d, 0, c->ac_tbl);
      }
    }
  } else if (!d->arith) {
    for (int i = 0; i < d->ns; ++i) {
      table(d, 1, d->comp[d->sc[i]].dc_tbl);
      table(d, 0, d->comp[d->sc[i]].ac_tbl);
    }
  }
  if (d->arith) {         /* jdarith.c start_pass: the bins this scan uses */
    for (int i = 0; i < d->ns; ++i) {
      const Comp* c = &d->comp[d->sc[i]];
      if (!d->progressive || (d->Ss == 0 && d->Ah == 0))
        memset(d->dc_stats[c->dc_tbl], 0, 64);
      if (!d->progressive || d->Ss) memset(d->ac_stats[c->ac_tbl], 0, 256);
      d->dc_context[i] = 0;
    }
    d->ar_c = 0;
    d->ar_a = 0;
    d->ar_ct = -16;
  }
  d->bs.buf = 0;
  d->bs.bits = 0;
  d->insufficient = 0;
  d->eobrun = 0;
  for (int i = 0; i < MAX_COMPS; ++i) d->last_dc[i] = 0;
  d->restarts_to_go = d->restart_interval;
}

static void decode_scan(Dec* d) {
  int mcus_per_row, mcu_rows;
  int16_t* blocks[MAX_BLOCKS];
  int (*mcu)(Dec*, int16_t**) = d->arith ? mcu_arith : mcu_sequential;
  start_scan(d, &mcus_per_row, &mcu_rows);
  if (d->progressive && d->arith)
    mcu = d->Ss == 0 ? (d->Ah == 0 ? mcu_arith_dc_first : mcu_arith_dc_refine)
                     : (d->Ah == 0 ? mcu_arith_ac_first : mcu_arith_ac_refine);
  else if (d->progressive)
    mcu = d->Ss == 0 ? (d->Ah == 0 ? mcu_dc_first : mcu_dc_refine)
                     : (d->Ah == 0 ? mcu_ac_first : mcu_ac_refine);
  d->no_suspend = d->arith;
  for (int my = 0; my < mcu_rows; ++my) {
    for (int mx = 0; mx < mcus_per_row; ++mx) {
      if (d->ns == 1) {
        const Comp* c = &d->comp[d->sc[0]];
        blocks[0] = c->coef + ((size_t)my * c->bw + mx) * 64;
      } else {
        int n = 0;
        for (int i = 0; i < d->ns; ++i) {
          const Comp* c = &d->comp[d->sc[i]];
          for (int y = 0; y < c->v; ++y)
            for (int x = 0; x < c->h; ++x)
              blocks[n++] = c->coef +
                  ((size_t)(my * c->v + y) * c->bw + mx * c->h + x) * 64;
        }
      }
      for (;;) {
        if (d->single_scan)       /* jdcoefct.c decompress_onepass */
          for (int i = 0; i < d->nblocks; ++i)
            memset(blocks[i], 0, 64 * sizeof(int16_t));
        if (mcu(d, blocks)) break;
        feed(d);                  /* libjpeg suspended: PIL's next block */
      }
    }
  }
  d->bs.bits = 0;                 /* finish_pass: the unused bits go */
  d->no_suspend = 0;
}

/* jdlhuff.c decode_mcus, one MCU: each sample's difference category and
 * bits (16: 32768, no bits); 0 to suspend. A row begun with the data
 * already short of its marker keeps zero differences, as libjpeg skips
 * it; one that runs short inside decodes on from zero bits. */
static int mcu_lossless(Dec* d, int32_t** dst, int skip) {
  if (!skip) {
    Bits b = load_bits(d);
    for (int blkn = 0; blkn < d->nblocks; ++blkn) {
      const Comp* c = &d->comp[d->sc[d->member[blkn]]];
      int s = huff_decode(d, &b, &d->dct[c->dc_tbl]), r;
      if (s < 0) return 0;
      if (s == 16) {
        s = 32768;
      } else if (s) {
        NEED(d, &b, s, return 0);
        r = GET_BITS(&b, s);
        s = HUFF_EXTEND(r, s);
      }
      *dst[blkn] = s;
    }
    save_bits(d, &b);
  }
  return 1;
}

/* a lossless scan (jddiffct.c, jdlhuff.c): the differences of its
 * components into their MCU grids; restarts at MCU-row boundaries mark
 * the row where their predictors start again */
static void decode_scan_lossless(Dec* d) {
  int mcus_per_row, mcu_rows;
  start_scan(d, &mcus_per_row, &mcu_rows);
  if (d->Ss < 1 || d->Ss > 7 || d->Se != 0 || d->Ah != 0 || d->Al >= 8)
    fail(d, "invalid lossless scan Ss=%d Se=%d Ah=%d Al=%d", d->Ss, d->Se,
         d->Ah, d->Al);
  if (d->ns == 1) {
    const Comp* c = &d->comp[d->sc[0]];
    mcus_per_row = c->dw;
    mcu_rows = c->dh;
  } else {
    mcus_per_row = d->mcux;
    mcu_rows = d->mcuy;
  }
  if (d->restart_interval % mcus_per_row != 0)
    fail(d, "the restart interval %d is not a multiple of the %d MCUs in "
            "a row, which libjpeg's lossless decoder needs",
         d->restart_interval, mcus_per_row);
  for (int i = 0; i < d->ns; ++i) {
    Comp* c = &d->comp[d->sc[i]];
    c->pred = d->Ss;
    c->pt = d->Al;
    c->first[0] = 1;
  }
  int32_t* dst[MAX_BLOCKS];
  for (int my = 0; my < mcu_rows; ++my) {
    int skip = 0;
    for (int mx = 0; mx < mcus_per_row; ++mx) {
      int reset = 0;
      if (d->restart_interval && d->restarts_to_go == 0) {
        process_restart(d);
        reset = 1;
      }
      if (mx == 0) {
        /* a row begun out of data: zero differences, predictors reset,
         * so the rows come out at the centre value (jdlhuff.c) */
        skip = d->insufficient;
        reset |= skip;
      }
      for (int i = 0; reset && i < d->ns; ++i) {
        Comp* c = &d->comp[d->sc[i]];
        /* libjpeg undifferences an iMCU row (v sample rows of a lone
         * component) once its MCU rows are read: a reset inside it starts
         * the predictors again at its first row */
        c->first[d->ns == 1 ? my / c->v * c->v : my * c->v] = 1;
      }
      int n = 0;
      for (int i = 0; i < d->ns; ++i) {
        Comp* c = &d->comp[d->sc[i]];
        if (d->ns == 1) {
          dst[n++] = c->diff + (size_t)my * c->bw + mx;
          continue;
        }
        for (int y = 0; y < c->v; ++y)
          for (int x = 0; x < c->h; ++x)
            dst[n++] = c->diff + (size_t)(my * c->v + y) * c->bw +
                       mx * c->h + x;
      }
      while (!mcu_lossless(d, dst, skip)) feed(d);
      if (d->restart_interval) d->restarts_to_go--;
    }
  }
  d->bs.bits = 0;
}

/* jdlossls.c: undifference each component's rows (the first row of the
 * scan and of each restart interval from 1 << (7 - Pt) along the row, the
 * others by the scan's predictor, the first column from the row above),
 * then scale by the point transform to 8-bit samples */
static void undifference(Dec* d) {
  for (int i = 0; i < d->ncomp; ++i)
    if (!d->comp[i].latched)
      fail(d, "lossless JPEG component %d appears in no scan: libjpeg's "
              "lossless decoder stops there", d->comp[i].id);
  for (int i = 0; i < d->ncomp; ++i) {
    Comp* c = &d->comp[i];
    const size_t stride = (size_t)c->wib * 8;
    int32_t* prev = (int32_t*)calloc((size_t)c->dw, sizeof(int32_t));
    int32_t* cur = (int32_t*)calloc((size_t)c->dw, sizeof(int32_t));
    c->plane = (uint8_t*)calloc(stride * (size_t)c->hib * 8, 1);
    if (!prev || !cur || !c->plane) {
      free(prev);
      free(cur);
      fail(d, "out of memory for a %d x %d JPEG", d->w, d->h);
    }
    for (int r = 0; r < c->dh; ++r) {
      const int32_t* df = c->diff + (size_t)r * c->bw;
      if (r == 0 || c->first[r]) {
        int ra = (df[0] + (1 << (7 - c->pt))) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < c->dw; ++x) cur[x] = ra = (df[x] + ra) & 0xFFFF;
      } else {
        int rb = prev[0], rc;
        int ra = (df[0] + rb) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < c->dw; ++x) {
          rc = rb;
          rb = prev[x];
          int64_t p;
          switch (c->pred) {
            case 1: p = ra; break;
            case 2: p = rb; break;
            case 3: p = rc; break;
            case 4: p = (int64_t)ra + rb - rc; break;
            case 5: p = ra + (((int64_t)rb - rc) >> 1); break;
            case 6: p = rb + (((int64_t)ra - rc) >> 1); break;
            default: p = ((int64_t)ra + rb) >> 1; break;
          }
          cur[x] = ra = (int)((df[x] + p) & 0xFFFF);
        }
      }
      uint8_t* o = c->plane + (size_t)r * stride;
      for (int x = 0; x < c->dw; ++x) o[x] = (uint8_t)(cur[x] << c->pt);
      int32_t* t = prev;
      prev = cur;
      cur = t;
    }
    free(prev);
    free(cur);
  }
}

/* ---------------------------------------------------------------- output */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 2446
#define FIX_0_390180644 3196
#define FIX_0_541196100 4433
#define FIX_0_765366865 6270
#define FIX_0_899976223 7373
#define FIX_1_175875602 9633
#define FIX_1_501321110 12299
#define FIX_1_847759065 15137
#define FIX_1_961570560 16069
#define FIX_2_053119869 16819
#define FIX_2_562915447 20995
#define FIX_3_072711026 25172
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

static inline int16_t wrap16(int32_t v) {
  return (int16_t)(uint16_t)(uint32_t)v;
}
static inline int16_t sat16(int32_t v) {
  return (int16_t)(v > 32767 ? 32767 : v < -32768 ? -32768 : v);
}
static inline uint8_t sat8(int16_t v) {   /* packsswb, then + 128 */
  return (uint8_t)((v > 127 ? 127 : v < -128 ? -128 : v) + 128);
}

/* one 8-point pass of jidctint-avx2.asm's dodct on 16-bit inputs: the sums
 * in0+in4, in0-in4, in7+in3 and in5+in1 wrap in 16 bits, the rotations are
 * pmaddwd pairs, the results are descaled by `n` and saturated to 16 bits.
 * From 16-bit inputs no 32-bit sum here can overflow (at most ~1.7e9). */
static inline void idct_pass(const int16_t* in, int step, int16_t* out,
                             int ostep, int n) {
  const int32_t z2 = in[2 * step], z3 = in[6 * step];
  const int32_t tmp3e = z2 * (FIX_0_541196100 + FIX_0_765366865) +
                        z3 * FIX_0_541196100;
  const int32_t tmp2e = z2 * FIX_0_541196100 +
                        z3 * (FIX_0_541196100 - FIX_1_847759065);
  const int32_t tmp0e = (int32_t)wrap16(in[0] + in[4 * step]) *
                        (1 << CONST_BITS);
  const int32_t tmp1e = (int32_t)wrap16(in[0] - in[4 * step]) *
                        (1 << CONST_BITS);
  const int32_t tmp10 = tmp0e + tmp3e, tmp13 = tmp0e - tmp3e;
  const int32_t tmp11 = tmp1e + tmp2e, tmp12 = tmp1e - tmp2e;
  const int32_t i7 = in[7 * step], i5 = in[5 * step];
  const int32_t i3 = in[3 * step], i1 = in[step];
  const int32_t z3s = wrap16(i7 + i3), z4s = wrap16(i5 + i1);
  const int32_t z3o = z3s * (FIX_1_175875602 - FIX_1_961570560) +
                      z4s * FIX_1_175875602;
  const int32_t z4o = z3s * FIX_1_175875602 +
                      z4s * (FIX_1_175875602 - FIX_0_390180644);
  const int32_t tmp0 = i7 * (FIX_0_298631336 - FIX_0_899976223) +
                       i1 * -FIX_0_899976223 + z3o;
  const int32_t tmp1 = i5 * (FIX_2_053119869 - FIX_2_562915447) +
                       i3 * -FIX_2_562915447 + z4o;
  const int32_t tmp2 = i5 * -FIX_2_562915447 +
                       i3 * (FIX_3_072711026 - FIX_2_562915447) + z3o;
  const int32_t tmp3 = i7 * -FIX_0_899976223 +
                       i1 * (FIX_1_501321110 - FIX_0_899976223) + z4o;
  const int32_t half = 1 << (n - 1);
  out[0] = sat16((tmp10 + tmp3 + half) >> n);
  out[7 * ostep] = sat16((tmp10 - tmp3 + half) >> n);
  out[ostep] = sat16((tmp11 + tmp2 + half) >> n);
  out[6 * ostep] = sat16((tmp11 - tmp2 + half) >> n);
  out[2 * ostep] = sat16((tmp12 + tmp1 + half) >> n);
  out[5 * ostep] = sat16((tmp12 - tmp1 + half) >> n);
  out[3 * ostep] = sat16((tmp13 + tmp0 + half) >> n);
  out[4 * ostep] = sat16((tmp13 - tmp0 + half) >> n);
}

/* pass 2 of one row of the workspace into 8 samples */
static inline void idct_row(const int16_t* w, uint8_t* o) {
  if ((w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7]) == 0) {
    /* what the full pass gives for a lone w[0] */
    const int32_t n = CONST_BITS + PASS1_BITS + 3;
    memset(o, sat8(sat16(((int32_t)w[0] * (1 << CONST_BITS) +
                          (1 << (n - 1))) >> n)), 8);
    return;
  }
  int16_t row[8];
  idct_pass(w, 1, row, 1, CONST_BITS + PASS1_BITS + 3);
  for (int c = 0; c < 8; ++c) o[c] = sat8(row[c]);
}

/* libjpeg-turbo's islow IDCT as PIL's build runs it (jidctint-avx2.asm):
 * jidctint.c's arithmetic in 16-bit lanes, the dequantized values wrapped
 * to 16 bits (pmullw), the output saturated (packsswb). On the
 * coefficients of any valid file it equals jidctint.c; on corrupt data it
 * equals PIL where jidctint.c's RANGE_MASK wrap does not. The shortcuts
 * give what the full passes give. */
static void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out,
                       size_t stride) {
  int16_t in[64], ws[64];
  int ac = 0;
  for (int i = 0; i < 8; ++i) in[i] = wrap16(coef[i] * q[i]);
  for (int i = 8; i < 64; ++i) {
    in[i] = wrap16(coef[i] * q[i]);
    ac |= in[i];
  }
  if (!ac) {
    /* rows 1-7 all zero: the AVX2 code shifts row 0 in 16 bits (wrapping)
     * for every row, so every output row is the same */
    int16_t w[8];
    uint8_t row[8];
    for (int c = 0; c < 8; ++c) w[c] = wrap16(in[c] * (1 << PASS1_BITS));
    idct_row(w, row);
    for (int r = 0; r < 8; ++r) memcpy(out + (size_t)r * stride, row, 8);
    return;
  }
  for (int c = 0; c < 8; ++c) {
    if ((in[8 + c] | in[16 + c] | in[24 + c] | in[32 + c] | in[40 + c] |
         in[48 + c] | in[56 + c]) == 0) {
      /* the full pass on a lone in[c]: in[c] << 2, saturated */
      const int16_t v = sat16((int32_t)in[c] * (1 << PASS1_BITS));
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
    } else {
      idct_pass(in + c, 8, ws + c, 8, CONST_BITS - PASS1_BITS);
    }
  }
  for (int r = 0; r < 8; ++r) idct_row(ws + 8 * r, out + (size_t)r * stride);
}

enum { UP_FULL, UP_H2V1, UP_H1V2, UP_H2V2, UP_REP };

/* jdsample.c jinit_upsampler's choice for component c */
static int up_method(Dec* d, const Comp* c) {
  if (c->h == d->max_h && c->v == d->max_v) return UP_FULL;
  if (d->lossless && d->max_h % c->h == 0 && d->max_v % c->v == 0)
    return UP_REP;          /* a 1x1 DCT scale: libjpeg's fancy is off */
  if (c->h * 2 == d->max_h && c->v == d->max_v)
    return c->dw > 2 ? UP_H2V1 : UP_REP;
  if (c->h == d->max_h && c->v * 2 == d->max_v) return UP_H1V2;
  if (c->h * 2 == d->max_h && c->v * 2 == d->max_v)
    return c->dw > 2 ? UP_H2V2 : UP_REP;
  if (d->max_h % c->h == 0 && d->max_v % c->v == 0) return UP_REP;
  fail(d, "fractional sampling factors are not implemented");
  return UP_REP;
}

/* row y of component c at the image's sampling, in `tmp` (or the plane) */
static const uint8_t* up_row(const Dec* d, const Comp* c, int method, int y,
                             uint8_t* tmp, int* colsum) {
  const size_t stride = (size_t)c->wib * 8;
  const uint8_t* p = c->plane;
  if (method == UP_FULL) return p + (size_t)y * stride;
  if (method == UP_REP) {
    const int hx = d->max_h / c->h, vx = d->max_v / c->v;
    const uint8_t* in = p + (size_t)(y / vx) * stride;
    for (int x = 0; x < d->w; ++x) tmp[x] = in[x / hx];
    return tmp;
  }
  if (method == UP_H2V1) {     /* jdsample.c h2v1_fancy_upsample */
    const uint8_t* in = p + (size_t)y * stride;
    const int n = c->dw;
    tmp[0] = in[0];
    tmp[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
    for (int i = 1; i < n - 1; ++i) {
      const int cur = in[i] * 3;
      tmp[2 * i] = (uint8_t)((cur + in[i - 1] + 1) >> 2);
      tmp[2 * i + 1] = (uint8_t)((cur + in[i + 1] + 2) >> 2);
    }
    tmp[2 * n - 2] = (uint8_t)((in[n - 1] * 3 + in[n - 2] + 1) >> 2);
    tmp[2 * n - 1] = in[n - 1];
    return tmp;
  }
  /* the row nearer and the one farther: the component's first and last
   * rows are their own context (jdmainct.c's funny pointers) */
  const int row = y >> 1;
  int other = (y & 1) ? row + 1 : row - 1;
  if (other < 0) other = 0;
  if (other > c->dh - 1) other = c->dh - 1;
  const uint8_t* near = p + (size_t)row * stride;
  const uint8_t* far = p + (size_t)other * stride;
  if (method == UP_H1V2) {     /* libjpeg-turbo's h1v2_fancy_upsample */
    const int bias = (y & 1) ? 2 : 1;
    for (int x = 0; x < c->dw; ++x)
      tmp[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
    return tmp;
  }
  const int n = c->dw;         /* jdsample.c h2v2_fancy_upsample */
  for (int i = 0; i < n; ++i) colsum[i] = near[i] * 3 + far[i];
  tmp[0] = (uint8_t)((colsum[0] * 4 + 8) >> 4);
  tmp[1] = (uint8_t)((colsum[0] * 3 + colsum[1] + 7) >> 4);
  for (int i = 1; i < n - 1; ++i) {
    const int cur = colsum[i] * 3;
    tmp[2 * i] = (uint8_t)((cur + colsum[i - 1] + 8) >> 4);
    tmp[2 * i + 1] = (uint8_t)((cur + colsum[i + 1] + 7) >> 4);
  }
  tmp[2 * n - 2] = (uint8_t)((colsum[n - 1] * 3 + colsum[n - 2] + 8) >> 4);
  tmp[2 * n - 1] = (uint8_t)((colsum[n - 1] * 4 + 7) >> 4);
  return tmp;
}

/* jdcoefct.c smoothing_ok (libjpeg-turbo 2.1 and later): a progressive
 * image is block-smoothed where every component has its quantization table
 * (nonzero at the DC and first nine AC positions) and a DC scan, and some
 * of the first nine AC coefficients are not yet exact */
static int smoothing_ok(const Dec* d) {
  static const int qpos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  int useful = 0;
  if (!d->progressive) return 0;
  for (int i = 0; i < d->ncomp; ++i) {
    const Comp* c = &d->comp[i];
    if (!c->latched) return 0;
    for (int k = 0; k < 10; ++k)
      if (c->qt[qpos[k]] == 0) return 0;
    if (c->coef_bits[0] < 0) return 0;
    for (int k = 1; k < 10; ++k)
      if (c->coef_bits[k] != 0) useful = 1;
  }
  return useful;
}

/* the estimate of one coefficient: libjpeg's rounding and, for Al > 0, its
 * clamp below 1 << Al */
static inline int16_t smooth_pred(int64_t q, int64_t num, int al) {
  int pred;
  if (num >= 0) {
    pred = (int)(((q << 7) + num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = (int)(((q << 7) - num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return (int16_t)pred;
}

/* jdcoefct.c decompress_smooth_data over component c: each block's DC and
 * first nine AC coefficients estimated from the DC values of a 5x5 block
 * neighbourhood where they are still zero and not exact (with only DC
 * known, the DC is re-estimated too), then the IDCT. The rows are counted
 * as libjpeg counts them: image_block_rows is the iMCU row's block rows
 * times the number of iMCU rows, also in the last, shorter iMCU row. */
static void smooth_component(const Dec* d, const Comp* c) {
  const int* cb = c->coef_bits;
  const int16_t* qt = c->qt;
  const int change_dc = cb[1] == -1 && cb[2] == -1 && cb[3] == -1 &&
                        cb[4] == -1 && cb[5] == -1 && cb[6] == -1 &&
                        cb[7] == -1 && cb[8] == -1 && cb[9] == -1;
  const int64_t Q00 = qt[0], Q01 = qt[1], Q10 = qt[8], Q20 = qt[16],
                Q11 = qt[9], Q02 = qt[2], Q03 = qt[3], Q12 = qt[10],
                Q21 = qt[17], Q30 = qt[24];
  const size_t stride = (size_t)c->wib * 8, row_blocks = (size_t)c->bw * 64;
  const int total = d->mcuy, last = c->wib - 1;
  for (int imcu = 0; imcu < total; ++imcu) {
    int block_rows = c->v;
    if (imcu == total - 1) {
      block_rows = c->hib % c->v;
      if (block_rows == 0) block_rows = c->v;
    }
    const int image_block_rows = block_rows * total;
    for (int br = 0; br < block_rows; ++br) {
      const int row = imcu * c->v + br;
      const int ibr = imcu * block_rows + br;
      const int prev = ibr > 0 ? row - 1 : row;
      const int pprev = ibr > 1 ? row - 2 : prev;
      const int next = ibr < image_block_rows - 1 ? row + 1 : row;
      const int nnext = ibr < image_block_rows - 2 ? row + 2 : next;
      const int16_t* r0 = c->coef + (size_t)pprev * row_blocks;
      const int16_t* r1 = c->coef + (size_t)prev * row_blocks;
      const int16_t* r2 = c->coef + (size_t)row * row_blocks;
      const int16_t* r3 = c->coef + (size_t)next * row_blocks;
      const int16_t* r4 = c->coef + (size_t)nnext * row_blocks;
      int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11,
          DC12, DC13, DC14, DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22,
          DC23, DC24, DC25;
      DC01 = DC02 = DC03 = DC04 = DC05 = r0[0];
      DC06 = DC07 = DC08 = DC09 = DC10 = r1[0];
      DC11 = DC12 = DC13 = DC14 = DC15 = r2[0];
      DC16 = DC17 = DC18 = DC19 = DC20 = r3[0];
      DC21 = DC22 = DC23 = DC24 = DC25 = r4[0];
      for (int bn = 0; bn <= last; ++bn) {
        int16_t ws[64];
        memcpy(ws, r2 + (size_t)bn * 64, sizeof ws);
        if (bn == 0 && bn < last) {
          DC04 = DC05 = r0[64];
          DC09 = DC10 = r1[64];
          DC14 = DC15 = r2[64];
          DC19 = DC20 = r3[64];
          DC24 = DC25 = r4[64];
        }
        if (bn + 1 < last) {
          const size_t o = (size_t)(bn + 2) * 64;
          DC05 = r0[o];
          DC10 = r1[o];
          DC15 = r2[o];
          DC20 = r3[o];
          DC25 = r4[o];
        }
        int al;
        int64_t num;
        if ((al = cb[1]) != 0 && ws[1] == 0) {                    /* AC01 */
          num = Q00 * (change_dc
                ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                   13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
                   3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
                   DC21 - DC22 + DC24 + DC25)
                : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = smooth_pred(Q01, num, al);
        }
        if ((al = cb[2]) != 0 && ws[8] == 0) {                    /* AC10 */
          num = Q00 * (change_dc
                ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                   13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                   13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                   3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = smooth_pred(Q10, num, al);
        }
        if ((al = cb[3]) != 0 && ws[16] == 0) {                   /* AC20 */
          num = Q00 * (change_dc
                ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                   14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 +
                   DC23)
                : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
          ws[16] = smooth_pred(Q20, num, al);
        }
        if ((al = cb[4]) != 0 && ws[9] == 0) {                    /* AC11 */
          num = Q00 * (change_dc
                ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                   9 * DC19 + DC21 - DC25)
                : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 +
                   DC22 - DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
          ws[9] = smooth_pred(Q11, num, al);
        }
        if ((al = cb[5]) != 0 && ws[2] == 0) {                    /* AC02 */
          num = Q00 * (change_dc
                ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                   14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                   2 * DC19)
                : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
          ws[2] = smooth_pred(Q02, num, al);
        }
        if (change_dc) {
          if ((al = cb[6]) != 0 && ws[3] == 0) {                  /* AC03 */
            num = Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
            ws[3] = smooth_pred(Q03, num, al);
          }
          if ((al = cb[7]) != 0 && ws[10] == 0) {                 /* AC12 */
            num = Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
            ws[10] = smooth_pred(Q12, num, al);
          }
          if ((al = cb[8]) != 0 && ws[17] == 0) {                 /* AC21 */
            num = Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
            ws[17] = smooth_pred(Q21, num, al);
          }
          if ((al = cb[9]) != 0 && ws[24] == 0) {                 /* AC30 */
            num = Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
            ws[24] = smooth_pred(Q30, num, al);
          }
          num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 -
                       2 * DC05 - 6 * DC06 + 6 * DC07 + 42 * DC08 +
                       6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                       152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 +
                       6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                       2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                       2 * DC25);
          ws[0] = smooth_pred(Q00, num, 0);
        }
        idct_islow(ws, qt, c->plane + (size_t)row * 8 * stride +
                               (size_t)bn * 8, stride);
        DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
        DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
        DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
        DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
        DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
      }
    }
  }
}

static void output(Dec* d, uint8_t* out) {
  const int smooth = smoothing_ok(d);
  if (d->lossless) undifference(d);
  for (int i = 0; i < d->ncomp && !d->lossless; ++i) {
    Comp* c = &d->comp[i];
    /* a component in no scan keeps a zero table (jddctmgr.c): grey 128 */
    const size_t stride = (size_t)c->wib * 8;
    c->plane = (uint8_t*)malloc(stride * (size_t)c->hib * 8);
    if (!c->plane) fail(d, "out of memory for a %d x %d JPEG", d->w, d->h);
    if (smooth) {
      smooth_component(d, c);
      continue;
    }
    for (int by = 0; by < c->hib; ++by)
      for (int bx = 0; bx < c->wib; ++bx)
        idct_islow(c->coef + ((size_t)by * c->bw + bx) * 64, c->qt,
                   c->plane + (size_t)by * 8 * stride + (size_t)bx * 8,
                   stride);
  }
  /* jdapimin.c default_decompress_parms */
  int ycc = d->out_ycc;
  /* 4 components: YCCK where an Adobe marker says transform 2 or another
   * not 0, CMYK otherwise */
  const int ycck = d->ncomp == 4 && d->adobe && d->adobe_transform != 0;
  if (d->ncomp == 3 && !d->out_raw) {
    if (d->jfif)
      ycc = 1;
    else if (d->adobe)
      ycc = d->adobe_transform != 0;
    else              /* lossless: ids 1, 2, 3 and unknown ones are RGB */
      ycc = !d->lossless && !(d->comp[0].id == 'R' && d->comp[1].id == 'G' &&
                              d->comp[2].id == 'B');
  }
  if (d->lossless && (ycc || ycck))
    fail(d, "a lossless JPEG in YCbCr or YCCK: libjpeg converts no colour "
            "in lossless mode");
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  uint8_t limit_tab[256 * 3];          /* jdmaster.c's sample_range_limit */
  const uint8_t* limit = limit_tab + 256;
  for (int i = 0; i < 256 * 3; ++i)
    limit_tab[i] = (uint8_t)(i < 256 ? 0 : i < 512 ? i - 256 : 255);
  for (int i = 0; i < 256; ++i) {   /* jdcolor.c build_ycc_rgb_table */
    const int64_t x = i - 128;
    cr_r[i] = (int)((91881 * x + 32768) >> 16);
    cb_b[i] = (int)((116130 * x + 32768) >> 16);
    cr_g[i] = -46802 * x;
    cb_g[i] = -22554 * x + 32768;
  }
  int method[MAX_COMPS];
  int width = d->w;
  for (int i = 0; i < d->ncomp; ++i) {
    method[i] = up_method(d, &d->comp[i]);
    const int up = d->comp[i].dw * (d->max_h / d->comp[i].h + 1);
    if (up > width) width = up;
  }
  uint8_t* tmp = (uint8_t*)malloc((size_t)width * d->ncomp);
  int* colsum = (int*)malloc(sizeof(int) * (size_t)width);
  if (!tmp || !colsum) {
    free(tmp);
    free(colsum);
    fail(d, "out of memory for a %d x %d JPEG", d->w, d->h);
  }
  const int nout = d->out_raw ? d->ncomp : 3;
  for (int y = 0; y < d->h; ++y) {
    const uint8_t* r[MAX_COMPS];
    uint8_t* o = out + (size_t)y * d->w * nout;
    for (int i = 0; i < d->ncomp; ++i)
      r[i] = up_row(d, &d->comp[i], method[i], y, tmp + (size_t)i * width,
                    colsum);
    if (d->out_raw && !ycc) {
      for (int x = 0; x < d->w; ++x)
        for (int i = 0; i < d->ncomp; ++i) o[nout * x + i] = r[i][x];
    } else if (d->ncomp == 1) {
      for (int x = 0; x < d->w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] =
          r[0][x];
    } else if (d->ncomp == 4) {
      /* libjpeg's CMYK (YCCK through jdcolor.c ycck_cmyk_convert), read by
       * PIL as CMYK;I (inverted), then PIL's cmyk2rgb: with c' = 255 - c
       * and k' = 255 - k, each channel is k - c' * k / 255 (MULDIV255) */
      for (int x = 0; x < d->w; ++x) {
        int cmy[3];
        const int k = r[3][x];
        if (ycck) {
          const int yy = r[0][x], cb = r[1][x], cr = r[2][x];
          cmy[0] = limit[255 - (yy + cr_r[cr])];
          cmy[1] = limit[255 - (yy + (int)((cb_g[cb] + cr_g[cr]) >> 16))];
          cmy[2] = limit[255 - (yy + cb_b[cb])];
        } else {
          cmy[0] = r[0][x];
          cmy[1] = r[1][x];
          cmy[2] = r[2][x];
        }
        for (int ch = 0; ch < 3; ++ch) {
          const int t = (255 - cmy[ch]) * k + 128;
          o[3 * x + ch] = (uint8_t)(k - (((t >> 8) + t) >> 8));
        }
      }
    } else if (!ycc) {
      for (int x = 0; x < d->w; ++x) {
        o[3 * x] = r[0][x];
        o[3 * x + 1] = r[1][x];
        o[3 * x + 2] = r[2][x];
      }
    } else {
      for (int x = 0; x < d->w; ++x) {
        const int yy = r[0][x], cb = r[1][x], cr = r[2][x];
        o[3 * x] = limit[yy + cr_r[cr]];
        o[3 * x + 1] = limit[yy + (int)((cb_g[cb] + cr_g[cr]) >> 16)];
        o[3 * x + 2] = limit[yy + cb_b[cb]];
      }
    }
  }
  free(tmp);
  free(colsum);
}

/* jdmarker.c read_markers and jdinput.c consume_markers over the file:
 * returns at EOI, after a single-scan image's scan, or, with header_only,
 * after the first SOF; in tail mode reads on from the scan's end */
static void read_file(Dec* d, int header_only) {
  if (!d->tail) {
    if (d->len < 2 || d->data[0] != 0xFF || d->data[1] != 0xD8)
      fail(d, "not a JPEG file: it does not start with the SOI marker");
    d->pos = 2;
    d->fixed_bin[0] = 113;            /* jdarith.c: the fixed 0.5 bin */
    for (int i = 0; i < 16; ++i) {    /* jdmarker.c get_soi */
      d->dac_l[i] = 0;
      d->dac_u[i] = 1;
      d->dac_k[i] = 5;
    }
    d->end = d->len < CHUNK || d->tiff ? d->len : CHUNK;
    d->unread_marker = 0;
    d->restart_interval = 0;
  }
  for (;;) {
    if (d->unread_marker == 0) next_marker(d);
    const int m = d->unread_marker;
    d->unread_marker = 0;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 ||
        m == 0xCA) {
      if (d->tables_only) fail(d, "the JPEGTables of a TIFF hold an image");
      get_sof(d, m, header_only);
      if (header_only) return;
    } else if (m == 0xCB) {
      fail(d, "arithmetic-coded lossless JPEG (SOF11) is not yet taken by "
              "the port's JPEG decoder");
    } else if ((m >= 0xC5 && m <= 0xC7) || (m >= 0xCD && m <= 0xCF) ||
               m == 0xDE || m == 0xDF) {
      fail(d, "hierarchical JPEG (marker 0x%02X) is not yet taken by the "
              "port's JPEG decoder", m);
    } else if (m == 0xCC) {
      get_dac(d);
    } else if (m == 0xDC) {
      skip(d, mword(d) - 2L);     /* DNL after a known height: ignored */
    } else if (m == 0xC4) {
      get_dht(d);
    } else if (m == 0xDB) {
      get_dqt(d);
    } else if (m == 0xDD) {
      if (mword(d) != 4) fail(d, "bogus DRI marker length");
      d->restart_interval = mword(d);
    } else if (m >= 0xE0 && m <= 0xEF) {
      get_app(d, m);
    } else if (m == 0xFE) {
      skip(d, mword(d) - 2L);
    } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      /* a stray RSTn or TEM: nothing to do */
    } else if (m == 0xD8) {
      fail(d, "a second SOI marker");
    } else if (m == 0xD9) {
      if (d->tables_only) return;
      if (!d->scans) fail(d, "the JPEG data holds no image");
      return;
    } else if (m == 0xDA) {
      if (header_only) fail(d, "SOS marker before SOF");
      if (d->scans > 0 && d->single_scan)
        fail(d, "a second scan after a complete single-scan image");
      get_sos(d);
      if (d->scans == 1) d->single_scan = !d->progressive && d->ns == d->ncomp;
      if (d->lossless)
        decode_scan_lossless(d);
      else
        decode_scan(d);
      if (d->single_scan) return;   /* the rows can go out: jpeg_decode */
    } else {
      fail(d, "unknown JPEG marker 0x%02X", m);
    }
  }
}

static void release(Dec* d) {
  for (int i = 0; i < MAX_COMPS; ++i) {
    free(d->comp[i].coef);
    free(d->comp[i].plane);
    free(d->comp[i].diff);
    free(d->comp[i].first);
  }
  free(d);
}

/* The size of the JPEG in `data`: 0, or -1 with the message in err (at
 * least 256 bytes). */
int jpeg_info(const uint8_t* data, size_t len, int* w, int* h, char* err) {
  Dec* d = (Dec*)calloc(1, sizeof(Dec));
  err[0] = 0;
  if (!d) {
    snprintf(err, ERR_LEN, "out of memory");
    return -1;
  }
  d->data = data;
  d->len = len;
  d->err = err;
  if (setjmp(d->jmp)) {
    release(d);
    return -1;
  }
  read_file(d, 1);
  if (!d->have_sof) fail(d, "the JPEG data holds no image");
  *w = d->w;
  *h = d->h;
  release(d);
  return 0;
}

/* Decode the JPEG in `data` to h rows of w * 3 bytes of RGB at `out` (w
 * and h from jpeg_info). Returns 0, or -1 with the message in err. */
int jpeg_decode(const uint8_t* data, size_t len, uint8_t* out, int w, int h,
                char* err) {
  Dec* d = (Dec*)calloc(1, sizeof(Dec));
  err[0] = 0;
  if (!d) {
    snprintf(err, ERR_LEN, "out of memory");
    return -1;
  }
  d->data = data;
  d->len = len;
  d->err = err;
  const int jumped = setjmp(d->jmp);
  if (jumped) {
    release(d);
    return jumped == 2 ? 0 : -1;
  }
  read_file(d, 0);
  if (d->w != w || d->h != h)
    fail(d, "the image is %d x %d, not the %d x %d asked for", d->w, d->h, w,
         h);
  output(d, out);
  if (d->single_scan) {
    /* jpeg_finish_decompress reads on to EOI: PIL ignores its running out
     * of data once every row is out, but not an error in what it reads */
    d->tail = 1;
    read_file(d, 0);
  }
  release(d);
  return 0;
}

/* Decode one strip or tile of a JPEG-compressed TIFF (compression 7) as
 * libtiff's tif_jpeg.c drives libjpeg: the JPEGTables stream (tables only,
 * `tlen` may be 0) first, then the strip's own stream, all of it at hand
 * with a fake EOI after its end (`data` holds len + 2 bytes, the last two
 * 0xFF 0xD9). The components come out as they are (libtiff asks for
 * JCS_UNKNOWN), or YCbCr -> RGB where `ycc` (JPEGCOLORMODE_RGB for
 * photometric YCbCr): h rows of w * ncomp bytes at `out`. The stream must
 * be w x h with ncomp components. Returns 0, or -1 with the message in
 * err. */
int jpeg_decode_tiff(const uint8_t* tables, size_t tlen, const uint8_t* data,
                     size_t len, uint8_t* out, int w, int h, int ncomp,
                     int ycc, char* err) {
  Dec* d = (Dec*)calloc(1, sizeof(Dec));
  err[0] = 0;
  if (!d) {
    snprintf(err, ERR_LEN, "out of memory");
    return -1;
  }
  d->err = err;
  d->tiff = 1;
  const int jumped = setjmp(d->jmp);
  if (jumped) {
    release(d);
    return jumped == 2 ? 0 : -1;
  }
  if (tlen) {
    d->data = tables;
    d->len = tlen;
    d->tables_only = 1;
    read_file(d, 0);
    d->tables_only = 0;
  }
  d->data = data;
  d->len = len + 2;
  read_file(d, 0);
  if (d->w != w || d->h != h || d->ncomp != ncomp)
    fail(d, "JPEG strip/tile size: %d x %d of %d components, not the %d x "
            "%d of %d the TIFF expects", d->w, d->h, d->ncomp, w, h, ncomp);
  d->out_raw = 1;
  d->out_ycc = ycc && ncomp == 3;
  output(d, out);
  if (d->single_scan) {
    d->tail = 1;
    read_file(d, 0);
  }
  release(d);
  return 0;
}

/* ------------------------------------------------------------- encoding */

static const uint8_t std_lum_quant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const uint8_t std_chr_quant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

typedef struct {
  uint16_t code[256];
  uint8_t size[256];
} EHuff;

typedef struct {        /* jcdctmgr.c divisors, 16-bit DCTELEM */
  uint16_t recip[64], corr[64];
  int shift[64];        /* r: the product is shifted right by r */
} Divisors;

typedef struct {
  uint8_t* buf;
  size_t len, cap;
  uint64_t acc;
  int nbits;
  int oom;
} Out;

static void put_byte(Out* o, int c) {
  if (o->len == o->cap) {
    const size_t cap = o->cap * 2;
    uint8_t* p = (uint8_t*)realloc(o->buf, cap);
    if (!p) {
      o->oom = 1;
      o->len = 0;         /* keep writing in place; the result is dropped */
      return;
    }
    o->buf = p;
    o->cap = cap;
  }
  o->buf[o->len++] = (uint8_t)c;
}

static void put_word(Out* o, int v) {
  put_byte(o, v >> 8);
  put_byte(o, v & 0xFF);
}

/* entropy-coded bits, MSB first, a 0 stuffed after every 0xFF */
static void put_bits(Out* o, unsigned code, int size) {
  o->acc = (o->acc << size) | (code & ((1u << size) - 1));
  o->nbits += size;
  while (o->nbits >= 8) {
    o->nbits -= 8;
    const int c = (int)(o->acc >> o->nbits) & 0xFF;
    put_byte(o, c);
    if (c == 0xFF) put_byte(o, 0);
  }
}

/* jchuff.c jpeg_make_c_derived_tbl */
static void ehuff(const HuffSpec* s, EHuff* t) {
  uint8_t size[257];
  uint32_t code[257];
  const int n = make_codes(s, size, code);
  memset(t, 0, sizeof *t);
  for (int p = 0; p < n; ++p) {
    t->code[s->vals[p]] = (uint16_t)code[p];
    t->size[s->vals[p]] = size[p];
  }
}

/* jcdctmgr.c compute_reciprocal for one divisor (quantval << 3) */
static void reciprocal(unsigned divisor, Divisors* t, int i) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;   /* flss(divisor) - 1 */
  int r = 16 + b;
  uint32_t fq = (uint32_t)((1u << r) / divisor);
  const uint32_t fr = (uint32_t)((1u << r) % divisor);
  unsigned c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  t->recip[i] = (uint16_t)fq;
  t->corr[i] = (uint16_t)c;
  t->shift[i] = r;
}

/* jfdctint.c jpeg_fdct_islow on samples - 128, then jcdctmgr.c quantize */
static void fdct_quantize(const uint8_t* in, size_t stride, const Divisors* q,
                          int16_t* coef) {
  int32_t data[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c)
      data[8 * r + c] = (int32_t)in[(size_t)r * stride + c] - 128;
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1;      /* pass 0: rows; pass 1: columns */
    for (int i = 0; i < 8; ++i) {
      int32_t* p = data + (pass ? i : 8 * i);
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step];
      int64_t tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step];
      int64_t tmp4 = p[3 * step] - p[4 * step];
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int sh = pass ? CONST_BITS + PASS1_BITS : CONST_BITS - PASS1_BITS;
      if (pass) {
        p[0] = (int32_t)DESCALE(tmp10 + tmp11, PASS1_BITS);
        p[4 * step] = (int32_t)DESCALE(tmp10 - tmp11, PASS1_BITS);
      } else {
        p[0] = (int32_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
        p[4 * step] = (int32_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
      }
      int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      p[2 * step] = (int32_t)DESCALE(z1 + tmp13 * FIX_0_765366865, sh);
      p[6 * step] = (int32_t)DESCALE(z1 + tmp12 * -FIX_1_847759065, sh);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      const int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 = tmp4 * FIX_0_298631336;
      tmp5 = tmp5 * FIX_2_053119869;
      tmp6 = tmp6 * FIX_3_072711026;
      tmp7 = tmp7 * FIX_1_501321110;
      z1 = z1 * -FIX_0_899976223;
      z2 = z2 * -FIX_2_562915447;
      z3 = z3 * -FIX_1_961570560;
      z4 = z4 * -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      p[7 * step] = (int32_t)DESCALE(tmp4 + z1 + z3, sh);
      p[5 * step] = (int32_t)DESCALE(tmp5 + z2 + z4, sh);
      p[3 * step] = (int32_t)DESCALE(tmp6 + z2 + z3, sh);
      p[step] = (int32_t)DESCALE(tmp7 + z1 + z4, sh);
    }
  }
  for (int i = 0; i < 64; ++i) {
    const int32_t v = data[i];
    const uint32_t a = (uint32_t)(v < 0 ? -v : v);
    const uint32_t prod = (a + q->corr[i]) * (uint32_t)q->recip[i];
    const int32_t t = (int32_t)(prod >> q->shift[i]);
    coef[i] = (int16_t)(v < 0 ? -t : t);
  }
}

/* jchuff.c encode_one_block */
static void encode_block(Out* o, const int16_t* blk, int* last_dc,
                         const EHuff* dc, const EHuff* ac) {
  int temp = blk[0] - *last_dc, temp2, nbits = 0;
  *last_dc = blk[0];
  temp2 = temp;
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  while (temp) {
    ++nbits;
    temp >>= 1;
  }
  put_bits(o, dc->code[nbits], dc->size[nbits]);
  if (nbits) put_bits(o, (unsigned)temp2, nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = blk[natural[k]];
    if (temp == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      put_bits(o, ac->code[0xF0], ac->size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nbits = 1;
    while ((temp >>= 1)) ++nbits;
    const int sym = (r << 4) + nbits;
    put_bits(o, ac->code[sym], ac->size[sym]);
    put_bits(o, (unsigned)temp2, nbits);
    r = 0;
  }
  if (r > 0) put_bits(o, ac->code[0], ac->size[0]);
}

static void put_dqt(Out* o, int index, const uint16_t* q) {
  put_word(o, 0xFFDB);
  put_word(o, 67);
  put_byte(o, index);
  for (int i = 0; i < 64; ++i) put_byte(o, q[natural[i]]);
}

static void put_dht(Out* o, int index, const HuffSpec* s) {
  int n = 0;
  for (int l = 1; l <= 16; ++l) n += s->bits[l];
  put_word(o, 0xFFC4);
  put_word(o, n + 19);
  put_byte(o, index);
  for (int l = 1; l <= 16; ++l) put_byte(o, s->bits[l]);
  for (int i = 0; i < n; ++i) put_byte(o, s->vals[i]);
}

/* Encode the RGB image `in` (h rows of w * 3 bytes) as PIL's save(...,
 * "JPEG", quality=quality) does. *out is set to a buffer of *out_len bytes,
 * to be released with jpeg_free. Returns 0, or -1 with the message in err
 * (at least 256 bytes). */
int jpeg_encode(const uint8_t* in, int h, int w, int quality, uint8_t** out,
                size_t* out_len, char* err) {
  err[0] = 0;
  *out = NULL;
  *out_len = 0;
  if (w < 1 || h < 1 || w > 65500 || h > 65500) {
    snprintf(err, ERR_LEN, "a JPEG is 1 to 65500 pixels a side, not %d x %d",
             w, h);
    return -1;
  }
  /* jcparam.c jpeg_quality_scaling and jpeg_add_quant_table(force_baseline)
   */
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t qt[2][64];
  Divisors div[2];
  for (int t = 0; t < 2; ++t) {
    for (int i = 0; i < 64; ++i) {
      long v = ((long)(t ? std_chr_quant : std_lum_quant)[i] * scale + 50) /
               100;
      if (v <= 0) v = 1;
      if (v > 255) v = 255;
      qt[t][i] = (uint16_t)v;
      reciprocal((unsigned)v << 3, &div[t], i);
    }
  }
  HuffSpec spec[4];               /* DC 0, AC 0, DC 1, AC 1 */
  EHuff code[4];
  for (int i = 0; i < 4; ++i) {
    std_spec(&spec[i], i & 1, i >> 1);
    ehuff(&spec[i], &code[i]);
  }

  /* jccolor.c rgb_ycc_convert, then the planes as jcprepct.c and
   * jcsample.c pad them */
  const int wy = (w + 7) / 8, hy = (h + 7) / 8;     /* Y blocks */
  const int wc = (w + 15) / 16, hc = (h + 15) / 16; /* Cb, Cr blocks */
  const size_t sy = (size_t)wy * 8, sc = (size_t)wc * 8;
  uint8_t* yp = (uint8_t*)malloc(sy * (size_t)hy * 8);
  uint8_t* full = (uint8_t*)malloc((size_t)w * h * 2);
  uint8_t* cp = (uint8_t*)malloc(sc * (size_t)hc * 8 * 2);
  Out o = {NULL, 0, 0, 0, 0, 0};
  o.cap = 4096 + (size_t)w * h / 4;
  o.buf = (uint8_t*)malloc(o.cap);
  if (!yp || !full || !cp || !o.buf) {
    free(yp);
    free(full);
    free(cp);
    free(o.buf);
    snprintf(err, ERR_LEN, "out of memory for a %d x %d JPEG", w, h);
    return -1;
  }
  int32_t tab[8 * 256];
#define FIX(x) ((int32_t)((x) * 65536.0 + 0.5))
  for (int i = 0; i < 256; ++i) {
    tab[i] = FIX(0.29900) * i;
    tab[i + 256] = FIX(0.58700) * i;
    tab[i + 512] = FIX(0.11400) * i + 32768;
    tab[i + 768] = -FIX(0.16874) * i;
    tab[i + 1024] = -FIX(0.33126) * i;
    tab[i + 1280] = FIX(0.50000) * i + (128 << 16) + 32768 - 1;
    tab[i + 1536] = -FIX(0.41869) * i;
    tab[i + 1792] = -FIX(0.08131) * i;
  }
#undef FIX
  uint8_t* cbf = full;
  uint8_t* crf = full + (size_t)w * h;
  for (int y = 0; y < h; ++y) {
    const uint8_t* p = in + (size_t)y * w * 3;
    uint8_t* yo = yp + (size_t)y * sy;
    for (int x = 0; x < w; ++x) {
      const int r = p[3 * x], g = p[3 * x + 1], b = p[3 * x + 2];
      yo[x] = (uint8_t)((tab[r] + tab[g + 256] + tab[b + 512]) >> 16);
      cbf[(size_t)y * w + x] =
          (uint8_t)((tab[r + 768] + tab[g + 1024] + tab[b + 1280]) >> 16);
      crf[(size_t)y * w + x] =
          (uint8_t)((tab[r + 1280] + tab[g + 1536] + tab[b + 1792]) >> 16);
    }
    for (size_t x = (size_t)w; x < sy; ++x) yo[x] = yo[w - 1];
  }
  for (int y = h; y < hy * 8; ++y)
    memcpy(yp + (size_t)y * sy, yp + (size_t)(h - 1) * sy, sy);
  const int rows = (h + 1) / 2;   /* chroma rows from image rows */
  for (int k = 0; k < 2; ++k) {
    const uint8_t* f = k ? crf : cbf;
    uint8_t* c = cp + (size_t)k * sc * hc * 8;
    for (int r = 0; r < rows; ++r) {
      const uint8_t* r0 = f + (size_t)(2 * r) * w;
      const uint8_t* r1 = f + (size_t)(2 * r + 1 < h ? 2 * r + 1 : h - 1) * w;
      uint8_t* co = c + (size_t)r * sc;
      for (size_t x = 0; x < sc; ++x) {
        const size_t xa = 2 * x < (size_t)w ? 2 * x : (size_t)w - 1;
        const size_t xb = 2 * x + 1 < (size_t)w ? 2 * x + 1 : (size_t)w - 1;
        co[x] = (uint8_t)((r0[xa] + r0[xb] + r1[xa] + r1[xb] + 1 + (x & 1)) >>
                          2);
      }
    }
    for (int r = rows; r < hc * 8; ++r)
      memcpy(c + (size_t)r * sc, c + (size_t)(rows - 1) * sc, sc);
  }

  /* the headers, in jcmarker.c's order */
  static const uint8_t app0[18] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10,
                                   'J',  'F',  'I',  'F',  0x00, 0x01,
                                   0x01, 0x00, 0x00, 0x01, 0x00, 0x01};
  for (int i = 0; i < 18; ++i) put_byte(&o, app0[i]);
  put_byte(&o, 0);
  put_byte(&o, 0);
  put_dqt(&o, 0, qt[0]);
  put_dqt(&o, 1, qt[1]);
  static const uint8_t sof_comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  put_word(&o, 0xFFC0);
  put_word(&o, 17);
  put_byte(&o, 8);
  put_word(&o, h);
  put_word(&o, w);
  put_byte(&o, 3);
  for (int i = 0; i < 9; ++i) put_byte(&o, sof_comps[i]);
  put_dht(&o, 0x00, &spec[0]);
  put_dht(&o, 0x10, &spec[1]);
  put_dht(&o, 0x01, &spec[2]);
  put_dht(&o, 0x11, &spec[3]);
  static const uint8_t sos[14] = {0xFF, 0xDA, 0x00, 0x0C, 3, 1, 0x00,
                                  2,    0x11, 3,    0x11, 0, 63, 0};
  for (int i = 0; i < 14; ++i) put_byte(&o, sos[i]);

  /* jccoefct.c compress_data: MCUs of 2x2 Y blocks, Cb, Cr; a dummy block
   * past the right or bottom edge has no AC and the DC of the block before
   * it */
  int last[3] = {0, 0, 0};
  int16_t blk[6][64];
  for (int my = 0; my < hc; ++my) {
    for (int mx = 0; mx < wc; ++mx) {
      for (int yi = 0; yi < 2; ++yi) {
        const int by = 2 * my + yi;
        for (int xi = 0; xi < 2; ++xi) {
          const int bx = 2 * mx + xi, n = 2 * yi + xi;
          if (by < hy && bx < wy) {
            fdct_quantize(yp + (size_t)by * 8 * sy + (size_t)bx * 8, sy,
                          &div[0], blk[n]);
          } else {
            memset(blk[n], 0, sizeof blk[n]);
            blk[n][0] = by < hy ? blk[n - 1][0] : blk[2 * yi - 1][0];
          }
        }
      }
      for (int k = 0; k < 2; ++k)
        fdct_quantize(cp + (size_t)k * sc * hc * 8 + (size_t)my * 8 * sc +
                          (size_t)mx * 8,
                      sc, &div[1], blk[4 + k]);
      for (int n = 0; n < 4; ++n)
        encode_block(&o, blk[n], &last[0], &code[0], &code[1]);
      encode_block(&o, blk[4], &last[1], &code[2], &code[3]);
      encode_block(&o, blk[5], &last[2], &code[2], &code[3]);
    }
  }
  if (o.nbits > 0) put_bits(&o, 0x7F, 7);   /* pad with 1-bits */
  put_word(&o, 0xFFD9);
  free(yp);
  free(full);
  free(cp);
  if (o.oom) {
    free(o.buf);
    snprintf(err, ERR_LEN, "out of memory writing a %d x %d JPEG", w, h);
    return -1;
  }
  *out = o.buf;
  *out_len = o.len;
  return 0;
}

void jpeg_free(void* p) { free(p); }
