/* Zstandard frame decoding on the host, for ZSTD-compressed TIFF strips
 * (compression 50000) in `data/tiff.py`: libtiff's tif_zstd.c hands each
 * strip or tile to libzstd's streaming decoder, which PIL runs; the card's
 * machine has no libzstd. Links nothing.
 *
 * RFC 8878: frames (skippable frames skipped, concatenated frames decoded
 * in turn), raw, RLE and compressed blocks; literals raw, RLE, Huffman
 * with FSE-coded or direct weights, in one or four streams, and treeless
 * (the previous block's table); sequences with predefined, RLE,
 * FSE-coded and repeated tables, repeat offsets; the content checksum
 * (XXH64's low 32 bits) checked as libzstd checks it. No dictionaries:
 * libtiff writes none.
 *
 * Plain C entry point, bound with ctypes: `tiff_zstd` returns the bytes
 * written to `dst`, at most `cap`, or -1 for corrupt data or data that
 * ends before `cap` bytes, -2 for a checksum that does not match, -3 for a
 * dictionary. As libzstd's streaming decoder under libtiff, each block is
 * decoded and checked whole; decoding stops once `cap` bytes are out
 * (libtiff's strip is full), and input that ends after that is no error. */

#include <setjmp.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MAX_BLOCK (128 * 1024)
#define LL_MAX 35
#define ML_MAX 52
#define OF_MAX 31

typedef struct {          /* an FSE decoding table */
  int log;                /* accuracy log; 0 with one symbol (RLE) */
  uint8_t sym[512], bits[512];
  uint16_t base[512];
} Fse;

typedef struct {          /* a Huffman decoding table */
  int max_bits;
  uint8_t sym[1 << 11], bits[1 << 11];
} Huf;

typedef struct {
  jmp_buf jmp;
  int err;
  uint8_t *out;           /* every byte decoded so far, grown as needed */
  long long pos, size, cap, frame_start;
  Fse ll, of, ml;         /* the last tables, for Repeat mode */
  int have_tables[3];
  Huf huf;
  int have_huf;
  uint64_t rep[3];
  uint8_t lit[MAX_BLOCK + 32];
} Z;

static void bad(Z *z, int code) {
  z->err = code;
  longjmp(z->jmp, 1);
}

/* the input ends: libzstd waits for more, and libtiff stops there, which
 * is an error only where the strip is not yet full */
static void short_input(Z *z) { bad(z, z->pos >= z->cap ? -5 : -1); }

static void room(Z *z, long long n) {
  if (z->pos + n <= z->size) return;
  long long size = z->size ? z->size : 1 << 16;
  while (size < z->pos + n) size *= 2;
  uint8_t *out = (uint8_t *)realloc(z->out, (size_t)size);
  if (!out) bad(z, -1);
  z->out = out;
  z->size = size;
}

static int highbit(uint32_t v) {       /* the index of the highest set bit */
  int n = -1;
  while (v) {
    v >>= 1;
    ++n;
  }
  return n;
}

/* ------------------------------------------------------------- bits */

/* `n` bits (n <= 57) of `src` from bit `off`, least significant first */
static uint64_t bits_le(const uint8_t *src, long long len, long long off,
                        int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) {
    const long long b = off + i;
    if (b >= 0 && (b >> 3) < len) v |= (uint64_t)((src[b >> 3] >> (b & 7)) & 1)
                                      << i;
  }
  return v;
}

typedef struct {          /* a backward bitstream: bits read from the end */
  const uint8_t *src;
  long long len, off;     /* off: the bit below the next bits to read */
} Back;

static void back_init(Z *z, Back *b, const uint8_t *src, long long len) {
  if (len <= 0 || src[len - 1] == 0) bad(z, -1);
  b->src = src;
  b->len = len;
  b->off = len * 8 - (8 - highbit(src[len - 1]));
}

/* the reference decoder's STREAM_read_bits: below the start, zeros */
static uint64_t back_read(Back *b, int n) {
  if (n == 0) return 0;
  b->off -= n;
  if (b->off >= 0) return bits_le(b->src, b->len, b->off, n);
  const long long under = -b->off;
  if (under >= n) return 0;
  return bits_le(b->src, b->len, 0, (int)(n - under)) << under;
}

/* ------------------------------------------------------------- FSE */

static void fse_build(Z *z, Fse *t, const int16_t *norm, int nsym, int log) {
  const int size = 1 << log;
  uint16_t next[64];
  int high = size;
  for (int s = 0; s < nsym; ++s)
    if (norm[s] == -1) {
      if (high <= 1) bad(z, -1);
      t->sym[--high] = (uint8_t)s;
      next[s] = 1;
    }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = (uint16_t)norm[s];
    for (int i = 0; i < norm[s]; ++i) {
      t->sym[pos] = (uint8_t)s;
      do pos = (pos + step) & mask; while (pos >= high);
    }
  }
  if (pos != 0) bad(z, -1);
  for (int i = 0; i < size; ++i) {
    const int s = t->sym[i];
    const int d = next[s]++;
    t->bits[i] = (uint8_t)(log - highbit((uint32_t)d));
    t->base[i] = (uint16_t)((d << t->bits[i]) - size);
  }
  t->log = log;
}

static void fse_rle(Fse *t, int sym) {
  t->log = 0;
  t->sym[0] = (uint8_t)sym;
  t->bits[0] = 0;
  t->base[0] = 0;
}

/* an FSE table description (forward bits): its size in bytes */
static long long fse_header(Z *z, Fse *t, const uint8_t *src, long long len,
                            int max_log, int max_sym) {
  long long off = 0;
  const int log = 5 + (int)bits_le(src, len, off, 4);
  off += 4;
  if (log > max_log) bad(z, -1);
  int remaining = 1 << log, nsym = 0;
  int16_t norm[64];
  while (remaining > 0 && nsym <= max_sym) {
    const int bits = highbit((uint32_t)remaining + 1) + 1;
    int val = (int)bits_le(src, len, off, bits);
    off += bits;
    const int lower = (1 << (bits - 1)) - 1;
    const int threshold = (1 << bits) - 1 - (remaining + 1);
    if ((val & lower) < threshold) {
      off -= 1;
      val &= lower;
    } else if (val > lower) {
      val -= threshold;
    }
    const int p = val - 1;
    remaining -= p < 0 ? -p : p;
    norm[nsym++] = (int16_t)p;
    if (p == 0) {
      int rep = (int)bits_le(src, len, off, 2);
      off += 2;
      for (;;) {
        for (int i = 0; i < rep && nsym <= max_sym; ++i) norm[nsym++] = 0;
        if (rep != 3) break;
        rep = (int)bits_le(src, len, off, 2);
        off += 2;
      }
    }
  }
  if (remaining != 0 || nsym > max_sym + 1) bad(z, -1);
  const long long used = (off + 7) / 8;
  if (used > len) bad(z, -1);
  fse_build(z, t, norm, nsym, log);
  return used;
}

static inline int fse_init(const Fse *t, Back *b) {
  return (int)back_read(b, t->log);
}

static inline int fse_update(const Fse *t, int state, Back *b) {
  return t->base[state] + (int)back_read(b, t->bits[state]);
}

/* ------------------------------------------------------------ Huffman */

static void huf_build(Z *z, Huf *t, const uint8_t *w, int n) {
  uint8_t bits[256];
  uint64_t sum = 0;
  for (int i = 0; i < n; ++i) {
    if (w[i] > 11) bad(z, -1);
    sum += w[i] ? (uint64_t)1 << (w[i] - 1) : 0;
  }
  if (sum == 0 || n >= 256) bad(z, -1);
  const int max_bits = highbit((uint32_t)sum) + 1;
  const uint64_t left = ((uint64_t)1 << max_bits) - sum;
  if (left & (left - 1)) bad(z, -1);
  const int last = highbit((uint32_t)left) + 1;
  for (int i = 0; i < n; ++i)
    bits[i] = w[i] ? (uint8_t)(max_bits + 1 - w[i]) : 0;
  bits[n] = (uint8_t)(max_bits + 1 - last);
  if (max_bits > 11) bad(z, -1);
  int count[13] = {0};
  for (int i = 0; i <= n; ++i) count[bits[i]]++;
  uint32_t rank[13];
  rank[max_bits] = 0;
  for (int i = max_bits; i >= 1; --i) {
    rank[i - 1] = rank[i] + (uint32_t)count[i] * (1u << (max_bits - i));
    if (rank[i - 1] > (1u << max_bits)) bad(z, -1);
    memset(t->bits + rank[i], i, rank[i - 1] - rank[i]);
  }
  if (rank[0] != (1u << max_bits)) bad(z, -1);
  for (int i = 0; i <= n; ++i)
    if (bits[i]) {
      const uint32_t len = 1u << (max_bits - bits[i]);
      memset(t->sym + rank[bits[i]], i, len);
      rank[bits[i]] += len;
    }
  t->max_bits = max_bits;
}

/* the tree description: its size in bytes */
static long long huf_header(Z *z, Huf *t, const uint8_t *src, long long len) {
  if (len < 1) bad(z, -1);
  const int hb = src[0];
  uint8_t w[256];
  int n;
  if (hb >= 128) {                      /* direct 4-bit weights */
    n = hb - 127;
    if (1 + (n + 1) / 2 > len) bad(z, -1);
    for (int i = 0; i < n; ++i)
      w[i] = (uint8_t)(i % 2 == 0 ? src[1 + i / 2] >> 4 : src[1 + i / 2] & 15);
    huf_build(z, t, w, n);
    return 1 + (n + 1) / 2;
  }
  if (1 + hb > len) bad(z, -1);         /* FSE-coded weights */
  Fse f;
  const long long h = fse_header(z, &f, src + 1, hb, 6, 12);
  Back b;
  back_init(z, &b, src + 1 + h, hb - h);
  int s1 = fse_init(&f, &b), s2 = fse_init(&f, &b);
  n = 0;
  for (;;) {
    if (n >= 255) bad(z, -1);
    w[n++] = f.sym[s1];
    s1 = fse_update(&f, s1, &b);
    if (b.off < 0) {
      w[n++] = f.sym[s2];
      break;
    }
    if (n >= 255) bad(z, -1);
    w[n++] = f.sym[s2];
    s2 = fse_update(&f, s2, &b);
    if (b.off < 0) {
      w[n++] = f.sym[s1];
      break;
    }
  }
  huf_build(z, t, w, n);
  return 1 + hb;
}

static void huf_stream(Z *z, const Huf *t, const uint8_t *src, long long len,
                       uint8_t *dst, long long n) {
  Back b;
  back_init(z, &b, src, len);
  const int mask = (1 << t->max_bits) - 1;
  int state = (int)back_read(&b, t->max_bits);
  for (long long i = 0; i < n; ++i) {
    dst[i] = t->sym[state];
    const int nb = t->bits[state];
    state = ((state << nb) + (int)back_read(&b, nb)) & mask;
  }
  if (b.off != -t->max_bits) bad(z, -1);
}

/* the literals section: its size in bytes; the literals in z->lit */
static long long literals(Z *z, const uint8_t *src, long long len,
                          long long *nlit) {
  if (len < 1) bad(z, -1);
  const int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
  long long regen, comp = 0, hsize;
  if (type < 2) {
    if (fmt == 0 || fmt == 2) {
      hsize = 1;
      regen = src[0] >> 3;
    } else if (fmt == 1) {
      hsize = 2;
      if (len < 2) bad(z, -1);
      regen = (src[0] >> 4) + ((long long)src[1] << 4);
    } else {
      hsize = 3;
      if (len < 3) bad(z, -1);
      regen = (src[0] >> 4) + ((long long)src[1] << 4) +
              ((long long)src[2] << 12);
    }
    if (regen > MAX_BLOCK) bad(z, -1);
    if (type == 0) {
      if (hsize + regen > len) bad(z, -1);
      memcpy(z->lit, src + hsize, (size_t)regen);
      *nlit = regen;
      return hsize + regen;
    }
    if (hsize + 1 > len) bad(z, -1);
    memset(z->lit, src[hsize], (size_t)regen);
    *nlit = regen;
    return hsize + 1;
  }
  const int streams = fmt == 0 ? 1 : 4;
  const int sbits = fmt < 2 ? 10 : fmt == 2 ? 14 : 18;
  hsize = fmt < 2 ? 3 : fmt == 2 ? 4 : 5;
  if (hsize > len) bad(z, -1);
  uint64_t h = 0;
  for (int i = 0; i < hsize; ++i) h |= (uint64_t)src[i] << (8 * i);
  regen = (long long)((h >> 4) & ((1u << sbits) - 1));
  comp = (long long)((h >> (4 + sbits)) & ((1u << sbits) - 1));
  if (regen > MAX_BLOCK || hsize + comp > len) bad(z, -1);
  const uint8_t *p = src + hsize;
  long long left = comp;
  if (type == 2) {
    const long long t = huf_header(z, &z->huf, p, left);
    p += t;
    left -= t;
    z->have_huf = 1;
  } else if (!z->have_huf) {
    bad(z, -1);
  }
  if (streams == 1) {
    huf_stream(z, &z->huf, p, left, z->lit, regen);
  } else {
    if (left < 6) bad(z, -1);
    const long long s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8),
                    s3 = p[4] | (p[5] << 8);
    const long long s4 = left - 6 - s1 - s2 - s3;
    if (s4 < 0) bad(z, -1);
    const long long q = (regen + 3) / 4;
    if (3 * q > regen) bad(z, -1);
    const uint8_t *b = p + 6;
    huf_stream(z, &z->huf, b, s1, z->lit, q);
    huf_stream(z, &z->huf, b + s1, s2, z->lit + q, q);
    huf_stream(z, &z->huf, b + s1 + s2, s3, z->lit + 2 * q, q);
    huf_stream(z, &z->huf, b + s1 + s2 + s3, s4, z->lit + 3 * q,
               regen - 3 * q);
  }
  *nlit = regen;
  return hsize + comp;
}

/* ----------------------------------------------------------- sequences */

static const uint32_t ll_base[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10,   11,   12,   13,
    14, 15, 16, 18, 20, 22, 24, 28, 32, 40, 48,   64,   128,  256,
    512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t ll_extra[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                     0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                                     4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                                     16};
static const uint32_t ml_base[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,  14,  15,  16,  17,   18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,  33,   34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,  131, 259, 515, 1027, 2051,
    4099, 8195, 16387, 32771, 65539};
static const uint8_t ml_extra[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9,
    10, 11, 12, 13, 14, 15, 16};
static const int16_t ll_default[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                       2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                       2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1,
                                       -1};
static const int16_t ml_default[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1,
    -1, -1, -1, -1, -1, -1, -1};
static const int16_t of_default[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, -1, -1, -1, -1, -1};

/* one of the three tables, by its mode: its description's size */
static long long seq_table(Z *z, int which, int mode, const uint8_t *src,
                           long long len) {
  Fse *t = which == 0 ? &z->ll : which == 1 ? &z->of : &z->ml;
  const int max_sym = which == 0 ? LL_MAX : which == 1 ? OF_MAX : ML_MAX;
  const int max_log = which == 0 ? 9 : which == 1 ? 8 : 9;
  long long used = 0;
  if (mode == 0) {
    if (which == 0) fse_build(z, t, ll_default, 36, 6);
    else if (which == 1) fse_build(z, t, of_default, 29, 5);
    else fse_build(z, t, ml_default, 53, 6);
  } else if (mode == 1) {
    if (len < 1 || src[0] > max_sym) bad(z, -1);
    fse_rle(t, src[0]);
    used = 1;
  } else if (mode == 2) {
    used = fse_header(z, t, src, len, max_log, max_sym);
  } else if (!z->have_tables[which]) {
    bad(z, -1);
  }
  z->have_tables[which] = 1;
  return used;
}

static void put_match(Z *z, uint64_t offset, uint32_t n) {
  if (offset == 0 || offset > (uint64_t)(z->pos - z->frame_start))
    bad(z, -1);
  room(z, n);
  for (uint32_t i = 0; i < n; ++i, ++z->pos)
    z->out[z->pos] = z->out[z->pos - offset];
}

static void put_literals(Z *z, const uint8_t *src, long long n) {
  room(z, n);
  memcpy(z->out + z->pos, src, (size_t)n);
  z->pos += n;
}

static void compressed_block(Z *z, const uint8_t *src, long long len) {
  long long nlit;
  long long p = literals(z, src, len, &nlit);
  if (p >= len) bad(z, -1);
  long long nseq = src[p++];
  if (nseq >= 128) {
    if (p >= len) bad(z, -1);
    if (nseq < 255) {
      nseq = ((nseq - 128) << 8) + src[p++];
    } else {
      if (p + 1 >= len) bad(z, -1);
      nseq = src[p] + ((long long)src[p + 1] << 8) + 0x7F00;
      p += 2;
    }
  }
  if (nseq == 0) {
    put_literals(z, z->lit, nlit);
    return;
  }
  if (p >= len) bad(z, -1);
  const int modes = src[p++];
  if (modes & 3) bad(z, -1);
  p += seq_table(z, 0, modes >> 6, src + p, len - p);
  p += seq_table(z, 1, (modes >> 4) & 3, src + p, len - p);
  p += seq_table(z, 2, (modes >> 2) & 3, src + p, len - p);
  if (p > len) bad(z, -1);
  Back b;
  back_init(z, &b, src + p, len - p);
  int sl = fse_init(&z->ll, &b), so = fse_init(&z->of, &b),
      sm = fse_init(&z->ml, &b);
  long long lit = 0;
  for (long long i = 0; i < nseq; ++i) {
    const int ofc = z->of.sym[so], llc = z->ll.sym[sl], mlc = z->ml.sym[sm];
    if (llc > LL_MAX || mlc > ML_MAX || ofc > OF_MAX) bad(z, -1);
    uint64_t ofv = ((uint64_t)1 << ofc) + back_read(&b, ofc);
    const uint32_t ml = ml_base[mlc] + (uint32_t)back_read(&b, ml_extra[mlc]);
    const uint32_t ll = ll_base[llc] + (uint32_t)back_read(&b, ll_extra[llc]);
    if (i + 1 < nseq) {
      sl = fse_update(&z->ll, sl, &b);
      sm = fse_update(&z->ml, sm, &b);
      so = fse_update(&z->of, so, &b);
    }
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      z->rep[2] = z->rep[1];
      z->rep[1] = z->rep[0];
      z->rep[0] = offset;
    } else {
      uint32_t idx = (uint32_t)ofv - 1 + (ll == 0);
      if (idx == 0) {
        offset = z->rep[0];
      } else {
        offset = idx < 3 ? z->rep[idx] : z->rep[0] - 1;
        if (idx > 1) z->rep[2] = z->rep[1];
        z->rep[1] = z->rep[0];
        z->rep[0] = offset;
      }
    }
    if (lit + ll > nlit) bad(z, -1);
    put_literals(z, z->lit + lit, ll);
    lit += ll;
    put_match(z, offset, ml);
  }
  if (b.off != 0) bad(z, -1);
  put_literals(z, z->lit + lit, nlit - lit);
}

/* ------------------------------------------------------------ XXH64 */

#define P1 11400714785074694791ULL
#define P2 14029467366897019727ULL
#define P3 1609587929392839161ULL
#define P4 9650029242287828579ULL
#define P5 2870177450012600261ULL

static inline uint64_t rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}
static inline uint64_t rd64(const uint8_t *p) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; --i) v = (v << 8) | p[i];
  return v;
}
static inline uint64_t rd32(const uint8_t *p) {
  return (uint64_t)p[0] | ((uint64_t)p[1] << 8) | ((uint64_t)p[2] << 16) |
         ((uint64_t)p[3] << 24);
}
static inline uint64_t round64(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl(acc, 31) * P1;
}
static inline uint64_t merge64(uint64_t acc, uint64_t v) {
  acc ^= round64(0, v);
  return acc * P1 + P4;
}

static uint64_t xxh64(const uint8_t *p, long long n) {
  const uint8_t *end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (end - p >= 32) {
      v1 = round64(v1, rd64(p));
      v2 = round64(v2, rd64(p + 8));
      v3 = round64(v3, rd64(p + 16));
      v4 = round64(v4, rd64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge64(h, v1);
    h = merge64(h, v2);
    h = merge64(h, v3);
    h = merge64(h, v4);
  } else {
    h = P5;
  }
  h += (uint64_t)n;
  while (end - p >= 8) {
    h ^= round64(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= rd32(p) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

/* ------------------------------------------------------------ frames */

/* one frame at src: the bytes it takes */
static long long frame(Z *z, const uint8_t *src, long long n) {
  if (n < 4) bad(z, -1);
  const uint32_t magic = (uint32_t)rd32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {      /* skippable */
    if (n < 8) bad(z, -1);
    const long long size = (long long)rd32(src + 4);
    if (8 + size > n) bad(z, -1);
    return 8 + size;
  }
  if (magic != 0xFD2FB528u) bad(z, -1);
  long long p = 4;
  if (p >= n) bad(z, -1);
  const int fhd = src[p++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1,
            checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
  if (fhd & 8) bad(z, -1);
  if (!single) ++p;                                 /* window descriptor */
  const int dict_bytes = dict_flag == 3 ? 4 : dict_flag;
  uint32_t dict = 0;
  for (int i = 0; i < dict_bytes; ++i)
    if (p + i < n) dict |= (uint32_t)src[p + i] << (8 * i);
  p += dict_bytes;
  if (dict) bad(z, -3);
  const int fcs_bytes = fcs_flag == 0 ? single : 1 << fcs_flag;
  if (p + fcs_bytes > n) short_input(z);
  long long fcs = -1;                       /* the frame content size */
  if (fcs_bytes) {
    uint64_t v = 0;
    for (int i = 0; i < fcs_bytes; ++i) v |= (uint64_t)src[p + i] << (8 * i);
    fcs = (long long)(v + (fcs_bytes == 2 ? 256 : 0));
  }
  p += fcs_bytes;
  z->frame_start = z->pos;
  z->rep[0] = 1;
  z->rep[1] = 4;
  z->rep[2] = 8;
  z->have_tables[0] = z->have_tables[1] = z->have_tables[2] = 0;
  z->have_huf = 0;
  for (;;) {
    if (p + 3 > n) short_input(z);
    const uint32_t bh = (uint32_t)src[p] | ((uint32_t)src[p + 1] << 8) |
                        ((uint32_t)src[p + 2] << 16);
    if (z->pos >= z->cap) {
      /* libtiff has its strip; libzstd still reads the next block's
       * header, and refuses one that cannot be */
      if (((bh >> 1) & 3) == 3 || (bh >> 3) > MAX_BLOCK ||
          (fcs >= 0 && z->pos - z->frame_start == fcs))
        bad(z, -1);
      return n;
    }
    p += 3;
    const int last = bh & 1, type = (bh >> 1) & 3;
    const long long size = bh >> 3;
    if (type == 3) bad(z, -1);
    if (size > MAX_BLOCK) bad(z, -1);
    if (type == 1) {
      if (p + 1 > n) short_input(z);
      room(z, size);
      memset(z->out + z->pos, src[p], (size_t)size);
      z->pos += size;
      p += 1;
    } else {
      if (p + size > n) short_input(z);
      if (type == 0)
        put_literals(z, src + p, size);
      else
        compressed_block(z, src + p, size);
      p += size;
    }
    /* libzstd checks the content against the frame's declared size */
    if (fcs >= 0 && z->pos - z->frame_start > fcs) bad(z, -1);
    if (last) break;
  }
  if (fcs >= 0 && z->pos - z->frame_start != fcs) bad(z, -1);
  if (checksum) {
    if (p + 4 > n) short_input(z);
    const uint32_t want = (uint32_t)rd32(src + p);
    const uint64_t h = xxh64(z->out + z->frame_start, z->pos - z->frame_start);
    if ((uint32_t)h != want) bad(z, -2);
    p += 4;
  }
  return p;
}

long long tiff_zstd(const uint8_t *src, long long n, uint8_t *dst,
                    long long cap) {
  Z *z = (Z *)calloc(1, sizeof(Z));
  if (!z) return -1;
  z->cap = cap;
  long long ret;
  if (setjmp(z->jmp)) {
    ret = z->err == -5 ? z->pos : z->err;
  } else {
    long long p = 0;
    while (p < n && z->pos < cap) p += frame(z, src + p, n - p);
    ret = z->pos;
  }
  if (ret > cap) ret = cap;
  if (ret > 0) memcpy(dst, z->out, (size_t)ret);
  free(z->out);
  free(z);
  return ret;
}
