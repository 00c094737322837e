/* CCITT bilevel strip and tile decoding on the host, for `data/tiff.py`:
 * compression 2 (CCITT RLE, modified Huffman), 3 (Group 3, T.4: 1-D, and
 * 2-D where T4Options bit 0 is set) and 4 (Group 4, T.6), as libtiff's
 * tif_fax3.c decodes them when PIL opens such a TIFF; the card's machine
 * has no libtiff. Links nothing.
 *
 * The coded bytes are read most significant bit first (data/tiff.py
 * bit-reverses FillOrder 2 strips first, as libtiff's bit map does). Each
 * row is decoded to its runs, alternately white and black from white, with
 * tif_fax3.c's clean-up of a row whose runs do not add up to the width,
 * then filled into a packed row with 1 bits black (_TIFFFax3fillruns).
 * The T.4 code words are matched through lookup tables made for each call
 * (12 bits white, 13 bits black, 7 bits for the 2-D modes), as
 * tif_fax3sm.c's tables; eleven zero bits are an EOL there.
 *
 * Plain C entry point, bound with ctypes. Returns the bytes written, or
 *   -1  the data ends before the last row (tif_fax3.c's premature EOF,
 *       an error for RLE and Group 3; Group 4 returns after a row)
 *   -2  Group 3 uncompressed mode (T4Options bit 1), which libtiff
 *       refuses */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum { S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERM, S_MAKEUP,
       S_EOL };

typedef struct {
  uint8_t state, width;
  int16_t param;
} Ent;

typedef struct {
  int run;
  const char* code;
} Code;

static const Code white_codes[] = {
    {0, "00110101"},     {1, "000111"},       {2, "0111"},
    {3, "1000"},         {4, "1011"},         {5, "1100"},
    {6, "1110"},         {7, "1111"},         {8, "10011"},
    {9, "10100"},        {10, "00111"},       {11, "01000"},
    {12, "001000"},      {13, "000011"},      {14, "110100"},
    {15, "110101"},      {16, "101010"},      {17, "101011"},
    {18, "0100111"},     {19, "0001100"},     {20, "0001000"},
    {21, "0010111"},     {22, "0000011"},     {23, "0000100"},
    {24, "0101000"},     {25, "0101011"},     {26, "0010011"},
    {27, "0100100"},     {28, "0011000"},     {29, "00000010"},
    {30, "00000011"},    {31, "00011010"},    {32, "00011011"},
    {33, "00010010"},    {34, "00010011"},    {35, "00010100"},
    {36, "00010101"},    {37, "00010110"},    {38, "00010111"},
    {39, "00101000"},    {40, "00101001"},    {41, "00101010"},
    {42, "00101011"},    {43, "00101100"},    {44, "00101101"},
    {45, "00000100"},    {46, "00000101"},    {47, "00001010"},
    {48, "00001011"},    {49, "01010010"},    {50, "01010011"},
    {51, "01010100"},    {52, "01010101"},    {53, "00100100"},
    {54, "00100101"},    {55, "01011000"},    {56, "01011001"},
    {57, "01011010"},    {58, "01011011"},    {59, "01001010"},
    {60, "01001011"},    {61, "00110010"},    {62, "00110011"},
    {63, "00110100"},    {64, "11011"},       {128, "10010"},
    {192, "010111"},     {256, "0110111"},    {320, "00110110"},
    {384, "00110111"},   {448, "01100100"},   {512, "01100101"},
    {576, "01101000"},   {640, "01100111"},   {704, "011001100"},
    {768, "011001101"},  {832, "011010010"},  {896, "011010011"},
    {960, "011010100"},  {1024, "011010101"}, {1088, "011010110"},
    {1152, "011010111"}, {1216, "011011000"}, {1280, "011011001"},
    {1344, "011011010"}, {1408, "011011011"}, {1472, "010011000"},
    {1536, "010011001"}, {1600, "010011010"}, {1664, "011000"},
    {1728, "010011011"}};

static const Code black_codes[] = {
    {0, "0000110111"},     {1, "010"},            {2, "11"},
    {3, "10"},             {4, "011"},            {5, "0011"},
    {6, "0010"},           {7, "00011"},          {8, "000101"},
    {9, "000100"},         {10, "0000100"},       {11, "0000101"},
    {12, "0000111"},       {13, "00000100"},      {14, "00000111"},
    {15, "000011000"},     {16, "0000010111"},    {17, "0000011000"},
    {18, "0000001000"},    {19, "00001100111"},   {20, "00001101000"},
    {21, "00001101100"},   {22, "00000110111"},   {23, "00000101000"},
    {24, "00000010111"},   {25, "00000011000"},   {26, "000011001010"},
    {27, "000011001011"},  {28, "000011001100"},  {29, "000011001101"},
    {30, "000001101000"},  {31, "000001101001"},  {32, "000001101010"},
    {33, "000001101011"},  {34, "000011010010"},  {35, "000011010011"},
    {36, "000011010100"},  {37, "000011010101"},  {38, "000011010110"},
    {39, "000011010111"},  {40, "000001101100"},  {41, "000001101101"},
    {42, "000011011010"},  {43, "000011011011"},  {44, "000001010100"},
    {45, "000001010101"},  {46, "000001010110"},  {47, "000001010111"},
    {48, "000001100100"},  {49, "000001100101"},  {50, "000001010010"},
    {51, "000001010011"},  {52, "000000100100"},  {53, "000000110111"},
    {54, "000000111000"},  {55, "000000100111"},  {56, "000000101000"},
    {57, "000001011000"},  {58, "000001011001"},  {59, "000000101011"},
    {60, "000000101100"},  {61, "000001011010"},  {62, "000001100110"},
    {63, "000001100111"},  {64, "0000001111"},    {128, "000011001000"},
    {192, "000011001001"}, {256, "000001011011"}, {320, "000000110011"},
    {384, "000000110100"}, {448, "000000110101"}, {512, "0000001101100"},
    {576, "0000001101101"},  {640, "0000001001010"},  {704, "0000001001011"},
    {768, "0000001001100"},  {832, "0000001001101"},  {896, "0000001110010"},
    {960, "0000001110011"},  {1024, "0000001110100"}, {1088, "0000001110101"},
    {1152, "0000001110110"}, {1216, "0000001110111"}, {1280, "0000001010010"},
    {1344, "0000001010011"}, {1408, "0000001010100"}, {1472, "0000001010101"},
    {1536, "0000001011010"}, {1600, "0000001011011"}, {1664, "0000001100100"},
    {1728, "0000001100101"}};

/* the makeup codes both colours share */
static const Code ext_codes[] = {
    {1792, "00000001000"},  {1856, "00000001100"},  {1920, "00000001101"},
    {1984, "000000010010"}, {2048, "000000010011"}, {2112, "000000010100"},
    {2176, "000000010101"}, {2240, "000000010110"}, {2304, "000000010111"},
    {2368, "000000011100"}, {2432, "000000011101"}, {2496, "000000011110"},
    {2560, "000000011111"}};

/* the 2-D mode codes (T.4 Table 4) */
static const struct {
  uint8_t state;
  int8_t param;
  const char* code;
} mode_codes[] = {{S_V0, 0, "1"},          {S_HORIZ, 0, "001"},
                  {S_PASS, 0, "0001"},     {S_VR, 1, "011"},
                  {S_VR, 2, "000011"},     {S_VR, 3, "0000011"},
                  {S_VL, 1, "010"},        {S_VL, 2, "000010"},
                  {S_VL, 3, "0000010"},    {S_EXT, 0, "0000001"},
                  {S_EOL, 0, "0000000"}};

static void put(Ent* t, int bits, const char* code, int state, int param) {
  const int len = (int)strlen(code);
  int v = 0;
  for (int i = 0; i < len; ++i) v = (v << 1) | (code[i] - '0');
  for (int r = 0; r < 1 << (bits - len); ++r) {
    Ent* e = &t[(v << (bits - len)) | r];
    e->state = (uint8_t)state;
    e->width = (uint8_t)len;
    e->param = (int16_t)param;
  }
}

static void make_run_table(Ent* t, int bits, const Code* codes, int n) {
  memset(t, 0, sizeof(Ent) << bits);
  for (int i = 0; i < n; ++i)
    put(t, bits, codes[i].code, codes[i].run < 64 ? S_TERM : S_MAKEUP,
        codes[i].run);
  for (int i = 0; i < (int)(sizeof ext_codes / sizeof *ext_codes); ++i)
    put(t, bits, ext_codes[i].code, S_MAKEUP, ext_codes[i].run);
  put(t, bits, "00000000000", S_EOL, 0);   /* 11 zeros: the EOL's prefix */
}

/* tif_fax3.c's bit reader: `avail` bits in `acc`, the oldest highest.
 * NeedBits loads a byte (NeedBits8) or up to two (NeedBits16) where fewer
 * than n bits are left; at the end of the data it pads with zeros up to n
 * bits, and fails only where no bit is left. Row alignment (RLE) drops
 * avail % 8 bits, padding included, as libtiff does. */
typedef struct {
  const uint8_t *cp, *ep;
  uint64_t acc;
  int avail;
  Ent white[1 << 12], black[1 << 13], main[1 << 7];
  int32_t *cur, *ref;     /* runs of this row and of the reference row */
  int nruns, width, eol;  /* eol: an EOL's zeros were read (EOLcnt) */
} Fax;

static inline int need(Fax* f, int n, int two) {
  if (f->avail >= n) return 1;
  for (int k = 0; k < (two ? 2 : 1) && f->avail < n; ++k) {
    if (f->cp >= f->ep) {
      if (f->avail == 0) return 0;
      f->acc <<= n - f->avail;          /* pad with zeros */
      f->avail = n;
      return 1;
    }
    f->acc = (f->acc << 8) | *f->cp++;
    f->avail += 8;
  }
  return 1;
}

static inline int get_bits(const Fax* f, int n) {
  return (int)((f->acc >> (f->avail - n)) & ((1u << n) - 1));
}

static inline void clr_bits(Fax* f, int n) {
  f->avail -= n;
  f->acc &= f->avail > 0 ? (((uint64_t)1 << f->avail) - 1) : 0;
}

#define NEED8(f, n, lab) \
  if (!need(f, n, 0)) goto lab
#define NEED16(f, n, lab) \
  if (!need(f, n, 1)) goto lab

/* tif_fax3.c SYNC_EOL: skip to the next EOL (11 zeros, fill zeros, a 1) */
static int sync_eol(Fax* f) {
  if (!f->eol) {
    for (;;) {
      NEED16(f, 11, eof);
      if (get_bits(f, 11) == 0) break;
      clr_bits(f, 1);
    }
  }
  for (;;) {
    NEED8(f, 8, eof);
    if (get_bits(f, 8)) break;
    clr_bits(f, 8);
  }
  while (get_bits(f, 1) == 0) clr_bits(f, 1);
  clr_bits(f, 1);
  f->eol = 0;
  return 0;
eof:
  return -1;
}

typedef struct {
  int32_t* pa;            /* the next run of this row */
  int a0, run_length;
} Row;

#define SETVALUE(f, r, x)                               \
  do {                                                  \
    if ((r)->pa >= (f)->cur + (f)->nruns) return -3;    \
    *(r)->pa++ = (r)->run_length + (x);                 \
    (r)->a0 += (x);                                     \
    (r)->run_length = 0;                                \
  } while (0)

/* tif_fax3.c CLEANUP_RUNS: a row whose runs miss or pass the width */
static int cleanup_runs(Fax* f, Row* r) {
  const int lastx = f->width;
  if (r->run_length) SETVALUE(f, r, 0);
  if (r->a0 != lastx) {
    while (r->a0 > lastx && r->pa > f->cur) r->a0 -= *--r->pa;
    if (r->a0 < lastx) {
      if (r->a0 < 0) r->a0 = 0;
      if ((r->pa - f->cur) & 1) SETVALUE(f, r, 0);
      SETVALUE(f, r, lastx - r->a0);
    } else if (r->a0 > lastx) {
      SETVALUE(f, r, lastx);
      SETVALUE(f, r, 0);
    }
  }
  return 0;
}

/* one run of a colour (makeup codes, then a terminating code): 0, 1 where
 * the row ends (an EOL or a bad code), -1 at the end of the data */
static int read_run(Fax* f, Row* r, int black) {
  for (;;) {
    const int bits = black ? 13 : 12;
    NEED16(f, bits, eof);
    const Ent* e = black ? &f->black[get_bits(f, 13)]
                         : &f->white[get_bits(f, 12)];
    clr_bits(f, e->width);
    if (e->state == S_TERM) {
      SETVALUE(f, r, e->param);
      return 0;
    }
    if (e->state == S_MAKEUP) {
      r->a0 += e->param;
      r->run_length += e->param;
      continue;
    }
    if (e->state == S_EOL) f->eol = 1;
    return 1;
  }
eof:
  return -1;
}

/* tif_fax3.c EXPAND1D: 0, or -1 at the end of the data (runs cleaned) */
static int expand_1d(Fax* f, Row* r) {
  for (;;) {
    int got = read_run(f, r, 0);
    if (got < -1) return got;
    if (got < 0) goto eof;
    if (got > 0 || r->a0 >= f->width) break;
    got = read_run(f, r, 1);
    if (got < -1) return got;
    if (got < 0) goto eof;
    if (got > 0 || r->a0 >= f->width) break;
    if (r->pa - f->cur >= 2 && r->pa[-1] == 0 && r->pa[-2] == 0) r->pa -= 2;
  }
  return cleanup_runs(f, r);
eof:
  if (cleanup_runs(f, r) < 0) return -3;
  return -1;
}

/* tif_fax3.c EXPAND2D against the reference row's runs */
static int expand_2d(Fax* f, Row* r) {
  const int lastx = f->width;
  const int32_t* pb = f->ref;
  const int32_t* const pb_end = f->ref + f->nruns;
  int b1 = *pb++;
#define CHECK_B1                                              \
  if (r->pa != f->cur)                                        \
    while (b1 <= r->a0 && b1 < lastx) {                       \
      if (pb + 1 >= pb_end) return -3;                        \
      b1 += pb[0] + pb[1];                                    \
      pb += 2;                                                \
    }
  while (r->a0 < lastx) {
    if (r->pa >= f->cur + f->nruns) return -3;
    NEED8(f, 7, eof);
    const Ent* e = &f->main[get_bits(f, 7)];
    clr_bits(f, e->width);
    switch (e->state) {
      case S_PASS:
        CHECK_B1;
        if (pb + 1 >= pb_end) return -3;
        b1 += *pb++;
        r->run_length += b1 - r->a0;
        r->a0 = b1;
        b1 += *pb++;
        break;
      case S_HORIZ: {
        const int first = (r->pa - f->cur) & 1;   /* 1: black first */
        int got = read_run(f, r, first);
        if (got == -1) goto eof;
        if (got) goto eol;
        got = read_run(f, r, !first);
        if (got == -1) goto eof;
        if (got) goto eol;
        CHECK_B1;
        break;
      }
      case S_V0:
        CHECK_B1;
        SETVALUE(f, r, b1 - r->a0);
        if (pb >= pb_end) return -3;
        b1 += *pb++;
        break;
      case S_VR:
        CHECK_B1;
        SETVALUE(f, r, b1 - r->a0 + e->param);
        if (pb >= pb_end) return -3;
        b1 += *pb++;
        break;
      case S_VL:
        CHECK_B1;
        if (b1 < r->a0 + e->param) goto eol;
        SETVALUE(f, r, b1 - r->a0 - e->param);
        b1 -= *--pb;
        break;
      case S_EXT:
        *r->pa++ = lastx - r->a0;
        goto eol;
      case S_EOL:
        *r->pa++ = lastx - r->a0;
        NEED8(f, 4, eof);
        clr_bits(f, 4);
        f->eol = 1;
        goto eol;
      default:
        goto eol;
    }
  }
  if (r->run_length) {
    if (r->run_length + r->a0 < lastx) {   /* a final V0 */
      NEED8(f, 1, eof);
      if (!get_bits(f, 1)) goto eol;
      clr_bits(f, 1);
    }
    SETVALUE(f, r, 0);
  }
eol:
  return cleanup_runs(f, r);
eof:
  if (cleanup_runs(f, r) < 0) return -3;
  return -1;
#undef CHECK_B1
}

/* _TIFFFax3fillruns: white, black, white ... from the row's start, black
 * as 1 bits, cut at the width */
static void fill_runs(uint8_t* row, const int32_t* runs, const int32_t* erun,
                      int lastx) {
  int x = 0;
  memset(row, 0, (size_t)(lastx + 7) / 8);
  for (const int32_t* p = runs; p < erun; p += 2) {
    x += p[0];
    if (p + 1 >= erun || x >= lastx) break;
    int end = x + p[1];
    if (end > lastx) end = lastx;
    for (int i = x; i < end; ++i) row[i >> 3] |= (uint8_t)(0x80 >> (i & 7));
    x = end;
  }
}

/* Decode `rows` rows of `width` pixels of CCITT data (compression 2, 3 or
 * 4; T4Options for 3) to packed rows of (width + 7) / 8 bytes at dst. */
long long tiff_fax(const uint8_t* src, long long n, uint8_t* dst, int width,
                   int rows, int comp, int t4) {
  if (comp == 3 && (t4 & 2)) return -2;
  Fax* f = (Fax*)calloc(1, sizeof(Fax));
  if (!f) return -1;
  const int rowbytes = (width + 7) / 8;
  f->cp = src;
  f->ep = src + n;
  f->width = width;
  f->nruns = (width + 1 + 31) / 32 * 32;     /* TIFFroundup_32(w + 1, 32) */
  f->cur = (int32_t*)calloc((size_t)f->nruns, sizeof(int32_t));
  f->ref = (int32_t*)calloc((size_t)f->nruns, sizeof(int32_t));
  long long ret = (long long)rows * rowbytes;
  if (!f->cur || !f->ref) {
    ret = -1;
    goto done;
  }
  make_run_table(f->white, 12, white_codes,
                 (int)(sizeof white_codes / sizeof *white_codes));
  make_run_table(f->black, 13, black_codes,
                 (int)(sizeof black_codes / sizeof *black_codes));
  memset(f->main, 0, sizeof f->main);
  for (int i = 0; i < (int)(sizeof mode_codes / sizeof *mode_codes); ++i)
    put(f->main, 7, mode_codes[i].code, mode_codes[i].state,
        mode_codes[i].param);
  f->ref[0] = width;          /* the row above the first: all white */
  f->ref[1] = 0;
  for (int y = 0; y < rows; ++y) {
    Row r = {f->cur, 0, 0};
    uint8_t* out = dst + (size_t)y * rowbytes;
    int got;
    if (comp == 2) {
      got = expand_1d(f, &r);
      clr_bits(f, f->avail & 7);          /* RLE rows are byte-aligned */
    } else if (comp == 3) {
      /* Fax3Decode1D / Fax3Decode2D: an EOL, then (2-D) the tag bit */
      if (sync_eol(f) < 0) {
        got = cleanup_runs(f, &r) < 0 ? -3 : -1;
      } else if (!(t4 & 1)) {
        got = expand_1d(f, &r);
      } else if (!need(f, 1, 0)) {
        got = cleanup_runs(f, &r) < 0 ? -3 : -1;
      } else {
        const int is_1d = get_bits(f, 1);
        clr_bits(f, 1);
        got = is_1d ? expand_1d(f, &r) : expand_2d(f, &r);
      }
    } else {
      got = expand_2d(f, &r);
      if (got == 0 && f->eol) got = -1;
    }
    if (got == -3) {
      ret = -1;
      goto done;
    }
    fill_runs(out, f->cur, r.pa, width);
    if (got < 0) {
      if (comp == 4 && y > 0) memset(out + rowbytes, 0,
                                     (size_t)(rows - y - 1) * rowbytes);
      ret = comp == 4 && y > 0 ? ret : -1;
      goto done;
    }
    if (comp == 4 || (comp == 3 && (t4 & 1))) {
      /* the imaginary change that ends the reference row */
      if (r.pa < f->cur + f->nruns) *r.pa++ = 0;
      int32_t* t = f->cur;
      f->cur = f->ref;
      f->ref = t;
    }
  }
done:
  free(f->cur);
  free(f->ref);
  free(f);
  return ret;
}
