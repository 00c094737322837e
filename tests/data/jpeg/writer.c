/* A small JPEG writer over the system libjpeg, for test fixtures that PIL
 * cannot write: arithmetic coding, YCCK, CMYK without an Adobe marker, any
 * sampling factors and scan script. Only the test machine builds and runs
 * it (`make_fixtures.py` and the tests compile it with `cc ... -ljpeg`);
 * the port never links libjpeg.
 *
 *   writer IN OUT W H NCOMP IN_SPACE JPEG_SPACE QUALITY ARITH RESTART
 *          SAMPLING ADOBE [SCANS]
 *
 * IN holds H rows of W * NCOMP bytes. IN_SPACE and JPEG_SPACE are libjpeg's
 * J_COLOR_SPACE numbers (1 grey, 2 RGB, 3 YCbCr, 4 CMYK, 5 YCCK). ARITH is
 * 0 (Huffman, optimized tables) or 1 (arithmetic). RESTART is the restart
 * interval in MCUs (0 for none). SAMPLING is "h,v/h,v/...", one pair a
 * component. ADOBE 0 drops the Adobe marker libjpeg writes for CMYK/YCCK.
 * SCANS, when given, is a scan script "c0,c1..:Ss:Se:Ah:Al/..." (progressive);
 * "p" is libjpeg's simple progression. */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

int main(int argc, char **argv) {
  if (argc < 13) {
    fprintf(stderr, "usage: writer IN OUT W H NCOMP IN_SPACE JPEG_SPACE "
                    "QUALITY ARITH RESTART SAMPLING ADOBE [SCANS]\n");
    return 2;
  }
  const int w = atoi(argv[3]), h = atoi(argv[4]), nc = atoi(argv[5]);
  FILE *in = fopen(argv[1], "rb");
  unsigned char *px = malloc((size_t)w * h * nc);
  if (!in || fread(px, 1, (size_t)w * h * nc, in) != (size_t)w * h * nc)
    return 3;
  fclose(in);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr jerr;
  c.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&c);
  FILE *out = fopen(argv[2], "wb");
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = (J_COLOR_SPACE)atoi(argv[6]);
  jpeg_set_defaults(&c);
  jpeg_set_colorspace(&c, (J_COLOR_SPACE)atoi(argv[7]));
  jpeg_set_quality(&c, atoi(argv[8]), TRUE);
  c.arith_code = atoi(argv[9]) ? TRUE : FALSE;
  c.optimize_coding = c.arith_code ? FALSE : TRUE;
  c.restart_interval = atoi(argv[10]);
  const char *s = argv[11];
  for (int i = 0; i < c.num_components && *s; ++i) {
    c.comp_info[i].h_samp_factor = atoi(s);
    s = strchr(s, ',') + 1;
    c.comp_info[i].v_samp_factor = atoi(s);
    while (*s && *s != '/') ++s;
    if (*s) ++s;
  }
  if (!atoi(argv[12])) c.write_Adobe_marker = FALSE;
  static jpeg_scan_info scans[64];
  if (argc > 13 && strcmp(argv[13], "p") == 0) {
    jpeg_simple_progression(&c);
  } else if (argc > 13) {
    int n = 0;
    for (char *t = strtok(argv[13], "/"); t; t = strtok(NULL, "/")) {
      jpeg_scan_info *sc = &scans[n++];
      sc->comps_in_scan = 0;
      char *f = t;
      for (;;) {
        sc->component_index[sc->comps_in_scan++] = atoi(f);
        while (*f != ',' && *f != ':') ++f;
        if (*f++ == ':') break;
      }
      sscanf(f, "%d:%d:%d:%d", &sc->Ss, &sc->Se, &sc->Ah, &sc->Al);
    }
    c.scan_info = scans;
    c.num_scans = n;
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  free(px);
  return 0;
}
