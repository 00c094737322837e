"""The image codecs the port took over from libjpeg and libtiff as PIL runs
them (`data/csrc/jpeg.c`, `data/csrc/ccitt.c`, `data/tiff.py`), against
the JAX package's `load_image` (PIL's `Image.open(...).convert("RGB")`) on
the CPU, with no tolerance: every case equal byte for byte, or raising in
both packages.

- JPEG: CMYK with and without the Adobe marker, YCCK, arithmetic coding
  (SOF9 sequential, SOF10 progressive, restarts), lossless (SOF3, every
  predictor), at odd sizes and several sampling factors; progressive
  files libjpeg block-smooths (cut after their first scan, after the DC
  scans, after some AC scans, a script that leaves low bits unrefined); a DNL marker after a known height; an
  arithmetic file past PIL's first 64 KiB block raises in both. The files
  PIL cannot write come from `tests/data/jpeg/writer.c` over the system
  libjpeg (`make_fixtures.libjpeg_write`).
- TIFF: 12-, 16- and 32-bit integer and float samples, 16-bit colour and
  CMYK with each compression, strips, tiles and planar configuration 2,
  both byte orders, classic and BigTIFF, the predictors, values at PIL's
  clipping and rounding edges; JPEG strips and tiles (RGB, grey, CMYK,
  RGBA, YCbCr); CCITT RLE, Group 3 1-D and 2-D and Group 4 with FillOrder
  2 and WhiteIsZero; LZMA; ZSTD; CIELab through LittleCMS's transform; YCbCr
  outside JPEG as libtiff's RGBA interface gives it; what PIL refuses
  raises in both.
- a file cut at half raises in both;
- (`TrackPredictor` over a folder mixing CMYK JPEG, 16-bit TIFF and
  JPEG-TIFF frames in both packages is in `test_torch_port_stream.py`,
  which has the model pair built once);
- the digests `chip_smoke.py` holds its run-time TIFFs to are PIL's.
"""

import hashlib
import importlib.util
import io

import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_port_common import ROOT

torch.set_num_threads(1)

DATA = ROOT / "tests" / "data"


def _module(kind):
    spec = importlib.util.spec_from_file_location(
        f"{kind}_codec_fixtures", DATA / kind / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JF = _module("jpeg")
TF = _module("tiff")
write, frame = JF.libjpeg_write, JF.frame


def _jax(data):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:        # PIL's OSError, SyntaxError, ValueError
        return f"{type(e).__name__}: {e}"


def _port(data, decode):
    try:
        return decode(data)
    except ValueError as e:
        return f"ValueError: {e}"


def _check(data, decode, tag=""):
    """Both decode to the same pixels, or both raise; returns which."""
    want, got = _jax(data), _port(data, decode)
    if isinstance(want, str) or isinstance(got, str):
        assert isinstance(want, str) and isinstance(got, str), (tag, want if
                                                                isinstance(
                                                                    want, str)
                                                                else got)
        return "raises"
    assert got.dtype == np.uint8 and got.shape == want.shape, tag
    np.testing.assert_array_equal(got, want, err_msg=str(tag))
    return "ok"


def _jpeg(data, tag=""):
    from mo_yolo_tpu_torch.data.jpeg import decode_jpeg
    return _check(data, decode_jpeg, tag)


def _tiff(data, tag=""):
    from mo_yolo_tpu_torch.data.tiff import decode_tiff
    return _check(data, decode_tiff, tag)


SAMPLINGS = {1: [[(1, 1)]], 3: [[(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)],
                                [(2, 1), (1, 1), (1, 1)]],
             4: [[(1, 1)] * 4, [(2, 2), (1, 1), (1, 1), (2, 2)],
                 [(1, 2), (1, 1), (1, 2), (1, 1)]]}
SIZES = ((1, 1), (9, 17), (31, 47))

# ---------------------------------------------------------------- JPEG

# kind -> (components, libjpeg in and out colour spaces, Adobe marker)
FOUR = {"cmyk_adobe": (JF.CMYK, JF.CMYK, True),
        "cmyk_no_adobe": (JF.CMYK, JF.CMYK, False),
        "ycck": (JF.CMYK, JF.YCCK, True)}


@pytest.mark.parametrize("kind", list(FOUR))
def test_four_component_jpeg_matches_jax(kind):
    """CMYK (PIL reads it inverted, CMYK;I, with or without an Adobe
    marker) and YCCK (libjpeg's ycck_cmyk_convert first), Huffman and
    arithmetic, sequential and progressive, at each size and sampling."""
    space_in, space, adobe = FOUR[kind]
    for i, (h, w) in enumerate(SIZES):
        for samp in SAMPLINGS[4]:
            for arith in (False, True):
                for scans in (None, "p"):
                    data = write(JF.cmyk_frame(h, w, i), space_in, space, 80,
                                 arith=arith, sampling=samp, adobe=adobe,
                                 scans=scans)
                    assert _jpeg(data, (h, w, samp, arith, scans)) == "ok"


def test_pil_cmyk_jpeg_matches_jax():
    for q in (10, 75, 100):
        for h, w in SIZES:
            buf = io.BytesIO()
            Image.frombytes("CMYK", (w, h), JF.cmyk_frame(h, w, q).tobytes()
                            ).save(buf, "JPEG", quality=q)
            assert _jpeg(buf.getvalue(), (q, h, w)) == "ok"


@pytest.mark.parametrize("scans", [None, "p"], ids=["sof9", "sof10"])
def test_arithmetic_jpeg_matches_jax(scans):
    """Arithmetic coding: colour at each sampling and grey, qualities 10 to
    100, restart intervals of 1 and 3 MCUs."""
    for i, (h, w) in enumerate(SIZES + ((64, 80),)):
        for samp in SAMPLINGS[3]:
            for q, restart in ((10, 0), (75, 1), (100, 3)):
                data = write(frame(h, w, i), JF.RGB, JF.YCC, q, arith=True,
                             restart=restart, sampling=samp, scans=scans)
                assert _jpeg(data, (h, w, samp, q, restart)) == "ok"
        data = write(frame(h, w, i)[..., 1], JF.GREY, JF.GREY, 60,
                     arith=True, restart=2, scans=scans)
        assert _jpeg(data, (h, w, "grey")) == "ok"


def test_arithmetic_past_pils_first_block_raises_as_jax():
    """libjpeg's arithmetic decoder cannot suspend: where its data runs
    past the 64 KiB PIL feeds it first, PIL raises "broken data stream";
    so does the port. Below that size, and cut at half, both agree."""
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (200, 400, 3), np.uint8)
    for scans in (None, "p"):
        data = write(noise, JF.RGB, JF.YCC, 90, arith=True, scans=scans)
        assert len(data) > 65536
        assert _jpeg(data, scans) == "raises"
    data = write(frame(64, 80, 1), JF.RGB, JF.YCC, 75, arith=True,
                 restart=2, sampling=SAMPLINGS[3][1])
    for cut in (len(data) // 2, len(data) - 2):
        assert _jpeg(data[:cut], cut) == "raises"
        assert _jpeg(data[:cut] + b"\xff\xd9", cut) == "ok"


@pytest.mark.parametrize("arith", [False, True], ids=["huffman", "arith"])
def test_block_smoothing_matches_jax(arith):
    """Progressive files cut before each later scan (after the first scan,
    after the DC scans, after some AC scans), which libjpeg-turbo
    block-smooths over a 5x5 block neighbourhood; a scan script that
    leaves the low bits of DC and AC unrefined (Al > 0 at the end); a
    script whose DC scans are one component each, cut while components
    are still missing (grey 128 there)."""
    sep = [((0,), 0, 0, 0, 0), ((1,), 0, 0, 0, 0), ((2,), 0, 0, 0, 0),
           ((0,), 1, 63, 0, 0), ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0)]
    for i, (h, w) in enumerate(((8, 8), (9, 17), (31, 47), (17, 90),
                                (70, 13))):
        for samp in SAMPLINGS[3]:
            data = write(frame(h, w, i), JF.RGB, JF.YCC, 75, arith=arith,
                         sampling=samp, scans="p")
            for k, cut in enumerate(JF.cut_scans(data)):
                assert _jpeg(cut, (h, w, samp, k)) == "ok"
        data = write(frame(h, w, i + 1), JF.RGB, JF.YCC, 75, arith=arith,
                     sampling=SAMPLINGS[3][1], scans=JF.SCRIPT_AL)
        for k, cut in enumerate([data] + JF.cut_scans(data)):
            assert _jpeg(cut, (h, w, "al", k)) == "ok"
        data = write(frame(h, w, i + 2), JF.RGB, JF.YCC, 75, arith=arith,
                     sampling=SAMPLINGS[3][1], scans=sep)
        for k, cut in enumerate(JF.cut_scans(data)[:2]):
            assert _jpeg(cut, (h, w, "sep", k)) == "ok"
        for kind, px, space in (("grey", frame(h, w, i)[..., 0], JF.GREY),
                                ("ycck", JF.cmyk_frame(h, w, i), JF.YCCK)):
            data = write(px, JF.GREY if kind == "grey" else JF.CMYK, space,
                         60, arith=arith, scans="p")
            for k, cut in enumerate(JF.cut_scans(data)):
                assert _jpeg(cut, (h, w, kind, k)) == "ok"


def test_dnl_after_a_known_height_matches_jax():
    """libjpeg skips a DNL marker once the frame's height is known; a
    frame of height 0, to be set by DNL, raises in both."""
    data = write(frame(24, 32, 3), JF.RGB, JF.YCC, 75)
    for at in (len(data) - 2, data.find(b"\xff\xda")):
        patched = data[:at] + b"\xff\xdc\x00\x04\x00\x18" + data[at:]
        assert _jpeg(patched, at) == "ok"
    sof = data.find(b"\xff\xc0")
    zero = data[:sof + 5] + b"\x00\x00" + data[sof + 7:]
    assert _jpeg(zero + b"\xff\xdc\x00\x04\x00\x18") == "raises"


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_jpeg_matches_jax(predictor):
    """Lossless JPEG (SOF3, `make_fixtures.lossless_jpeg`), which PIL's
    libjpeg-turbo reads: colour, grey and CMYK at 1x1, 4:2:0 and 4:2:2
    (upsampled by replication: libjpeg's fancy upsampling is off at a 1x1
    scale), point transforms 0 and 2, restarts every 1 or 2 MCU rows, one
    interleaved scan or a scan a component, ids 'R','G','B' or 1-3 (RGB in
    lossless mode); JFIF and Adobe YCbCr raise in both (no colour
    conversion in lossless mode); cut files raise or decode as PIL."""
    rng = np.random.default_rng(predictor)
    for h, w in ((1, 1), (9, 13), (31, 47)):
        rgb = rng.integers(0, 256, (h, w, 3)) if predictor % 2 else \
            frame(h, w, predictor)
        for samp in ([(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)],
                     [(2, 1), (1, 1), (1, 1)]):
            planes = JF.subsample(rgb, samp)
            for pt, rows, inter in ((0, 0, True), (2, 1, True),
                                    (0, 2, False)):
                data = JF.lossless_jpeg(planes, samp, predictor, pt, rows,
                                        interleave=inter)
                assert _jpeg(data, (h, w, samp, pt, rows, inter)) == "ok"
        planes = [rgb[..., i] for i in range(3)]
        for kw, want in ((dict(ids=[1, 2, 3]), "ok"),
                         (dict(ids=[1, 2, 3], jfif=True), "raises"),
                         (dict(ids=[1, 2, 3], adobe=1), "raises"),
                         (dict(adobe=0), "ok")):
            data = JF.lossless_jpeg(planes, [(1, 1)] * 3, predictor, **kw)
            assert _jpeg(data, kw) == want
    data = JF.lossless_jpeg([rgb[..., 0]], [(1, 1)], predictor, 1, 1)
    for cut in (len(data) // 2, len(data) // 3):
        assert _jpeg(data[:cut], cut) == "raises"
        assert _jpeg(data[:cut] + b"\xff\xd9", cut) == "ok"


JPEG_NEW = sorted(set(JF.libjpeg_fixtures()) | set(JF.lossless_fixtures()) |
                  set(JF.timed_fixtures()))


@pytest.mark.parametrize("name", [n for n in JPEG_NEW if "smooth" not in n
                                  and "dnl" not in n])
def test_jpeg_cut_at_half_raises_as_jax(name):
    data = (DATA / "jpeg" / name).read_bytes()
    assert _jpeg(data[:len(data) // 2], name) == "raises"


# ---------------------------------------------------------------- TIFF

def _values(rng, h, w, c, kind):
    """Samples at PIL's edges: clipping at 0 and 255, the high byte,
    signed extremes, float truncation, NaN and the infinities."""
    if kind == "u16":
        return rng.choice(np.array([0, 1, 254, 255, 256, 257, 1000, 65280,
                                    65535]), (h, w, c))
    if kind == "s16":
        return rng.choice(np.array([-32768, -1, 0, 1, 127, 254, 255, 256,
                                    32767]), (h, w, c))
    if kind == "s32":
        return rng.choice(np.array([-2 ** 31, -300, -1, 0, 1, 254, 255, 256,
                                    2 ** 31 - 1]), (h, w, c))
    if kind == "u32":
        return rng.choice(np.array([0, 1, 255, 256, 2 ** 31 - 1, 2 ** 31,
                                    2 ** 32 - 1]), (h, w, c))
    if kind == "f32":
        return rng.choice(np.array([-1e30, -1.0, -0.5, 0.0, 0.4, 0.5, 0.99,
                                    1.0, 1.5, 254.5, 254.99, 255.0, 255.5,
                                    1e30, np.nan, np.inf, -np.inf]),
                          (h, w, c))
    if kind == "u12":
        return rng.integers(0, 4096, (h, w, c))
    return rng.integers(0, 256, (h, w, c))


# name -> (photometric, bits, samples, values, sample format, extra)
SAMPLE_MODES = {
    "grey16": (1, 16, 1, "u16", None, None),
    "grey16_wiz": (0, 16, 1, "u16", None, None),
    "int16": (1, 16, 1, "s16", [2], None),
    "int32": (1, 32, 1, "s32", [2], None),
    "uint32": (1, 32, 1, "u32", None, None),
    "float32": (1, 32, 1, "f32", [3], None),
    "float32_wiz": (0, 32, 1, "f32", [3], None),
    "float64": (1, 64, 1, "f32", [3], None),
    "grey12": (1, 12, 1, "u12", None, None),
    "rgb16": (2, 16, 3, "u16", None, None),
    "rgba16": (2, 16, 4, "u16", None, [2]),
    "rgba16_assoc": (2, 16, 4, "u16", None, [1]),
    "rgbx16": (2, 16, 4, "u16", None, [0]),
    "rgba16_no_extra": (2, 16, 4, "u16", None, None),
    "cmyk8": (5, 8, 4, "u8", None, None),
    "cmykx8": (5, 8, 5, "u8", None, [0]),
    "cmyk16": (5, 16, 4, "u16", None, None),
}
LAYOUTS = {"strip": {}, "strips": dict(rows_per_strip=4),
           "tiles": dict(tile=(16, 16)),
           "planar": dict(planar=2, rows_per_strip=5),
           "planar_tiles": dict(planar=2, tile=(16, 16))}


@pytest.mark.parametrize("mode", list(SAMPLE_MODES))
def test_tiff_sample_modes_match_jax(mode):
    """Each sample layout uncompressed and through LZW, Deflate, LZMA,
    PackBits and ZSTD, with the predictors libtiff applies (2 on integers, 3 on
    floats), in each layout and both byte orders (Deflate in a BigTIFF
    too)."""
    photo, bits, spp, kind, fmt, extra = SAMPLE_MODES[mode]
    rng = np.random.default_rng(len(mode))
    px = _values(rng, 19, 21, spp, kind)
    outcomes = set()
    for comp in (1, 5, 8, 34925, 32773, 50000):
        for pred in (1, 2, 3):
            if pred > 1 and comp in (1, 32773) or pred == 3 and fmt != [3]:
                continue
            for layout, kw in LAYOUTS.items():
                if layout.startswith("planar") and spp == 1:
                    continue
                for order, big in (("<", False), (">", False)) + (
                        (("<", True),) if comp == 8 else ()):
                    blob = TF.write_tiff(px, photo, bits=bits,
                                         compression=comp, order=order,
                                         predictor=pred, sample_format=fmt,
                                         extra=extra, big=big, **kw)
                    outcomes.add(_tiff(blob, (comp, pred, layout, order,
                                              big)))
    # PIL reads no 64-bit float; big-endian unsigned 32-bit and 16-bit
    # WhiteIsZero, some 12-bit strips and some planes it refuses
    assert outcomes == ({"raises"} if mode == "float64" else
                        {"ok", "raises"} if mode in (
                            "rgbx16", "cmykx8", "rgba16_assoc", "grey16_wiz",
                            "uint32", "grey12") else {"ok"}), outcomes


def test_tiff_jpeg_matches_jax():
    """JPEG strips and tiles: PIL's own (RGB, grey, CMYK, RGBA, grey with
    alpha; JPEGTables and abbreviated streams, no colour conversion), RGB
    and grey tiles in both byte orders, and YCbCr with whole JFIF streams
    at 4:4:4, 4:2:2 and 4:2:0 (libtiff's JPEGCOLORMODE_RGB)."""
    rgb = frame(37, 45, 1)
    for mode in ("RGB", "L", "CMYK", "RGBA", "LA"):
        for info in ({}, {278: 16}):
            buf = io.BytesIO()
            arr = JF.cmyk_frame(37, 45, 2) if mode == "CMYK" else rgb
            im = Image.frombytes("CMYK", (45, 37), arr.tobytes()) \
                if mode == "CMYK" else Image.fromarray(rgb).convert(mode)
            im.save(buf, "TIFF", compression="jpeg", tiffinfo=info)
            assert _tiff(buf.getvalue(), (mode, info)) == "ok"
    for layout in (dict(tile=(16, 16)), dict(tile=(32, 16)),
                   dict(rows_per_strip=8)):
        for order in "<>":
            assert _tiff(TF.pil_coded(rgb, 2, "jpeg", order=order,
                                      **layout), layout) == "ok"
            assert _tiff(TF.pil_coded(rgb[..., :1], 1, "jpeg", order=order,
                                      **layout), layout) == "ok"
        for sampling in ((1, 1), (2, 1), (2, 2)):
            assert _tiff(TF.ycbcr_jpeg(rgb, sampling, **layout),
                         (sampling, layout)) == "ok"


@pytest.mark.parametrize("comp", ["tiff_ccitt", "group3", "group3_2d",
                                  "group4"])
def test_tiff_ccitt_matches_jax(comp):
    """CCITT at odd widths: PIL's strips, then strips and tiles of PIL's
    codes with FillOrder 2, WhiteIsZero and BlackIsZero, both byte orders
    (Group 3 2-D with T4Options 5: 2-D rows and fill bits)."""
    name, info = (("group3", {292: 5}) if comp == "group3_2d"
                  else (comp, {}))
    rng = np.random.default_rng(len(comp))
    for h, w in ((1, 1), (7, 9), (37, 45), (33, 300)):
        for b in (TF.bilevel(h, w, h), (rng.random((h, w, 1)) < 0.3).astype(
                np.uint8)):
            buf = io.BytesIO()
            Image.fromarray(b[..., 0] * 255).convert("1").save(
                buf, "TIFF", compression=name, tiffinfo=info)
            assert _tiff(buf.getvalue(), (h, w)) == "ok"
            for photo in (0, 1):
                for kw in (dict(rows_per_strip=5, fill=2),
                           dict(tile=(16, 16), order=">")):
                    blob = TF.pil_coded(b, photo, name, info=info, **kw)
                    assert _tiff(blob, (h, w, photo, kw)) == "ok"


def test_tiff_pil_written_codecs_match_jax():
    """PIL's own writer (libtiff) in each mode it writes, LZMA, JPEG, LZW,
    Deflate, PackBits and none, classic and BigTIFF."""
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:23, 0:31]
    img = rng.integers(0, 256, (23, 31, 3), np.uint8)
    ims = {m: Image.fromarray(img).convert(m) for m in
           ("RGB", "L", "CMYK", "RGBA", "LA", "P", "1")}
    ims["I;16"] = Image.fromarray((img[..., 0].astype(np.uint16) * 257 -
                                   300 * (x % 3)).astype(np.uint16))
    ims["I"] = Image.fromarray(img[..., 0].astype(np.int32) * 5 - 300)
    ims["F"] = Image.fromarray(img[..., 0].astype(np.float32) * 1.37 - 40.2)
    for mode, im in ims.items():
        for comp in ("lzma", "jpeg", "tiff_lzw", "tiff_adobe_deflate",
                     "packbits", None):
            if comp == "jpeg" and mode not in ("RGB", "L", "CMYK", "RGBA",
                                               "LA"):
                continue
            for big in (False, True):
                buf = io.BytesIO()
                im.save(buf, "TIFF", compression=comp, big_tiff=big)
                assert _tiff(buf.getvalue(), (mode, comp, big)) == "ok"


def test_tiff_cielab_matches_jax():
    """CIELab (photometric 8): PIL's LAB unpacker (a and b made unsigned,
    not in separate planes) and LittleCMS's Lab -> sRGB transform, every
    codec and layout, both byte orders; the values cover each axis."""
    rng = np.random.default_rng(8)
    for h, w in ((1, 1), (19, 21), (64, 64)):
        px = rng.integers(0, 256, (h, w, 3))
        if h == 64:               # every L, a and b value at least once
            la = np.meshgrid(np.arange(64) * 4 + 1, np.arange(64) * 4,
                             indexing="ij")
            px = np.stack([*la, np.arange(64 * 64).reshape(64, 64) % 256],
                          -1)
        for comp in (1, 5, 8, 34925, 32773):
            for layout, kw in LAYOUTS.items():
                for order in "<>":
                    blob = TF.write_tiff(px, 8, compression=comp,
                                         order=order, **kw)
                    assert _tiff(blob, (h, w, comp, layout)) == "ok"


def test_lab_table_is_littlecms():
    """The port's Lab table is what PIL's own LittleCMS computes."""
    assert TF.LAB_TABLE.read_bytes() == TF.lab_table()


@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (2, 2), (4, 2),
                                      (4, 4), (1, 2), (4, 1), (2, 4)])
def test_tiff_ycbcr_outside_jpeg_matches_jax(sampling):
    """YCbCr through LZW and Deflate, as PIL reads it through libtiff's
    RGBA interface (blocks of hs x vs Y sharing Cb and Cr, libtiff's
    YCbCr -> RGB tables and its put functions' quirks at odd sizes and
    cut tiles; 2x4 refused by both), and uncompressed, as PIL's raw
    decoder reads it (as RGBX, or raising where the file runs out)."""
    hs, vs = sampling
    rng = np.random.default_rng(hs * 8 + vs)
    for h, w in ((1, 1), (9, 17), (31, 47)):
        px = rng.integers(0, 256, (h, w, 3))
        for comp in (1, 5, 8):
            for kw in (dict(), dict(rows_per_strip=3), dict(tile=(16, 16)),
                       dict(tile=(32, 16), order=">")):
                blob = TF.ycbcr_coded(px, hs, vs, comp, **kw)
                _tiff(blob, (h, w, comp, kw))


@pytest.mark.parametrize("level", [1, 19])
def test_tiff_zstd_matches_jax(level):
    """ZSTD strips and tiles (`csrc/zstd.c`) from the system libzstd at a
    fast and a high level, with and without the content checksum, noise
    (Huffman literals, FSE tables) and flat rows (RLE, repeat offsets),
    several blocks a strip; then cut, extended and corrupted streams, which
    raise or decode as libzstd under libtiff does (the checksum, the
    declared content size, the blocks' headers)."""
    rng = np.random.default_rng(level)
    for h, w in ((1, 1), (40, 50), (300, 400)):
        px = rng.integers(0, 256, (h, w, 3))
        px[::2] = 3
        for checksum in (False, True):
            def code(c, checksum=checksum):
                return TF.zstd(c.astype(np.uint8).tobytes(), level, checksum)
            for kw in (dict(), dict(rows_per_strip=7), dict(tile=(64, 64))):
                blob = TF.write_tiff(px, 2, compression=50000, encode=code,
                                     **kw)
                assert _tiff(blob, (h, w, checksum, kw)) == "ok"
            raw = code(px)
            n = len(raw)
            cases = [raw + b"\x00\x01", raw + raw] + [
                raw[:max(n - k, 1)] for k in (1, 4, n // 2)] + [
                raw[:i] + bytes([raw[i] ^ x]) + raw[i + 1:]
                for i in sorted({4, 5, 6, 7, n // 3, n // 2, n - 5, n - 2,
                                 n - 1}) if i < n for x in (1, 0x55)]
            for i, v in enumerate(cases):
                _tiff(TF.write_tiff(px, 2, compression=50000,
                                    encode=lambda c, v=v: v), (h, w, i))


def test_big_endian_bigtiff_raises_as_jax():
    """PIL takes only little-endian BigTIFF for BigTIFF (it reads the third
    byte); a big-endian one it reads as a classic TIFF and fails, as the
    port does."""
    for comp in (1, 8):
        blob = TF.write_tiff(frame(9, 11), 2, compression=comp, big=True,
                             order=">")
        assert _tiff(blob) == "raises"


def test_tiff_refusals_pil_shares():
    """What PIL does not read raises in both: 64-bit floats, unsigned
    32-bit and 16-bit WhiteIsZero big-endian, 12-bit strips PIL reads
    short, predictor 3 on integers, WebP strips (PIL's libtiff has no
    WebP), SGILog on RGB, JPEG at 12 bits."""
    f = frame(8, 8, 1).astype(np.int64)
    blobs = [TF.write_tiff(f.astype(float), 1, bits=64, sample_format=[3]),
             TF.write_tiff(f, 1, bits=32, order=">"),
             TF.write_tiff(f, 0, bits=16, order=">"),
             TF.write_tiff(f * 16, 1, bits=12, rows_per_strip=3),
             TF.write_tiff(f, 1, compression=5, predictor=3),
             TF.write_tiff(f, 1, compression=50001, encode=lambda c: b"RIFF"),
             TF.write_tiff(np.repeat(f, 3, -1), 2, compression=34676,
                           encode=lambda c: bytes(16)),
             TF.write_tiff(f * 16, 1, bits=12, compression=7,
                           encode=lambda c: b"\xff\xd8\xff\xd9")]
    for i, blob in enumerate(blobs):
        assert _tiff(blob, i) == "raises"


@pytest.mark.parametrize("name", ["grey16_lzw_pred2_tiles_mm.tif",
                                  "float32_pred3_lzma.tif",
                                  "cmyk8_raw_planar.tif",
                                  "bigtiff_rgb_deflate_tiles.tif",
                                  "jpeg_rgb_pil.tif",
                                  "jpeg_ycbcr_420_tiles.tif", "g4_pil.tif",
                                  "g3_2d_fill_strips.tif",
                                  "ccitt_rle_pil.tif",
                                  "rgb_lzma_pred2_tiles.tif"])
def test_tiff_cut_at_half_raises_as_jax(name):
    data = (DATA / "tiff" / name).read_bytes()
    assert _tiff(data[:len(data) // 2], name) == "raises"


# ------------------------------------------------------- chip_smoke

def test_chip_smoke_format_digests_are_pils():
    """`chip_smoke.py` times 1080p TIFFs it writes at run time (no PIL on
    the card's host) and holds them to these digests: PIL's decodes."""
    import chip_smoke
    from mo_yolo_tpu_torch.data.jpeg import encode_jpeg
    files = chip_smoke.format_timed_files(TF, encode_jpeg)
    assert set(files) == set(chip_smoke.FORMAT_DIGESTS)
    for name, data in files.items():
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert hashlib.sha1(want.tobytes()).hexdigest() == \
            chip_smoke.FORMAT_DIGESTS[name], name
