"""The port's PNG, BMP, TIFF and WebP decoding (`data/decode.py`,
`data/tiff.py`, `data/webp.py` and their C) against the JAX package's
`load_image` (PIL's `Image.open(...).convert("RGB")`), on the CPU, with no
tolerance: every case equal byte for byte.

- the fixtures of `tests/data/tiff` and `tests/data/webp`, and their
  manifests (the digests the card's host, with no PIL, is held to);
- PNG: every colour type and depth, plain and Adam7-interlaced, with all
  five row filters, 16-bit and tRNS;
- BMP: 1-, 4- and 8-bit palettes, grey palettes, 16-bit 555 and 565,
  core headers, RLE8 and RLE4 streams with runs, absolute runs, deltas,
  end-of-line and end-of-bitmap escapes;
- TIFF: each compression with strips, tiles and planar configuration 2,
  each photometric interpretation, both byte orders;
- WebP: lossy at several qualities and odd sizes, lossless, alpha;
- a file cut at half raises in the port where it raises in the JAX
  package; each feature still refused raises naming itself;
- no file of the port's new decoders imports PIL or links a library (the
  TIFF codecs' C includes libc's headers only).
"""

import hashlib
import importlib.util
import io
import json
import re
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_port_common import ROOT

torch.set_num_threads(1)

DATA = ROOT / "tests" / "data"


def _tiff_fixtures():
    """tests/data/tiff/make_fixtures.py, under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "tiff_make_fixtures", DATA / "tiff" / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_tf = _tiff_fixtures()
colormap, frame, write_tiff = _tf.colormap, _tf.frame, _tf.write_tiff


def _jax_load(path):
    from mo_yolo_tpu.data.loaders import load_image
    return load_image(str(path))


def _port_load(path):
    from mo_yolo_tpu_torch.data.loaders import load_image
    return load_image(path)


def _same(tmp_path, blob: bytes, name: str):
    """Write `blob`; the port's decode equals the JAX package's exactly,
    or both raise. Returns "ok" or "raises"."""
    path = tmp_path / name
    path.write_bytes(blob)
    try:
        want = _jax_load(path)
    except Exception:
        with pytest.raises(ValueError):
            _port_load(path)
        return "raises"
    got = _port_load(path)
    assert got.dtype == np.uint8 and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)
    return "ok"


# ------------------------------------------------------------- fixtures

FIXTURES = [(kind, name) for kind in ("tiff", "webp") for name in sorted(
    json.loads((DATA / kind / "manifest.json").read_text()))]


@pytest.mark.parametrize("kind,name", FIXTURES,
                         ids=[n for _, n in FIXTURES])
def test_fixture_matches_jax_and_manifest(kind, name):
    path = DATA / kind / name
    entry = json.loads((DATA / kind / "manifest.json").read_text())[name]
    want = _jax_load(path)
    assert hashlib.sha1(want.tobytes()).hexdigest() == entry["sha1"]
    assert list(want.shape) == entry["shape"]
    assert path.stat().st_size == entry["bytes"]
    np.testing.assert_array_equal(_port_load(path), want)


def test_webp_animation_first_frame_on_its_canvas():
    """The first frame of `animated_offset.webp` at (6, 10) of a zero
    canvas, as the animation decoder gives it to PIL."""
    got = _port_load(DATA / "webp" / "animated_offset.webp")
    assert got.shape == (40, 56, 3)
    assert not got[:6].any() and not got[:, :10].any()
    assert got[6:36, 10:50].any()


def test_fixture_folders_stay_small():
    size = sum(p.stat().st_size for kind in ("tiff", "webp")
               for p in (DATA / kind).iterdir())
    assert size < 1 << 20


# ------------------------------------------------------------------ PNG

def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _pack_rows(px, depth):
    h, w, s = px.shape
    if depth == 16:
        return px.astype(">u2").reshape(h, w * s).view(np.uint8).reshape(h, -1)
    if depth == 8:
        return px.astype(np.uint8).reshape(h, w * s)
    bits = np.unpackbits(px.astype(np.uint8).reshape(h, w * s, 1), axis=2)
    return np.packbits(bits[:, :, 8 - depth:].reshape(h, -1), axis=1)


def _filter(rows, bpp, kinds):
    """Each row with its filter (0-4) applied, the type byte first."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for r, t in zip(rows.astype(np.int64), kinds):
        left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if t == 0:
            f = r
        elif t == 1:
            f = r - left
        elif t == 2:
            f = r - prev
        elif t == 3:
            f = r - (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
            f = r - pred
        out.append(bytes([t]) + (f % 256).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png(px, depth, ctype, interlace, rng, palette=None, trns=None):
    h, w, s = px.shape
    bpp = max(s * depth // 8, 1)
    parts = [px[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7] \
        if interlace else [px]
    raw = b""
    for p in parts:
        if p.shape[0] and p.shape[1]:
            raw += _filter(_pack_rows(p, depth), bpp,
                           rng.integers(0, 5, p.shape[0]))
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", bytes(palette))
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


PNG_FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
               (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
               (6, 16)]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype,depth", PNG_FORMATS)
def test_png_matches_jax(tmp_path, ctype, depth, interlace):
    rng = np.random.default_rng(ctype * 100 + depth * 2 + interlace)
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    for h, w in ((1, 1), (5, 3), (9, 17), (16, 13)):
        px = rng.integers(0, 1 << depth, (h, w, samples))
        if depth == 16:      # values near 255 too, where I;16 clips
            px[::2] = rng.integers(0, 300, px[::2].shape)
        # a palette one entry short at 8 bits: index 255 converts to black
        pal = rng.integers(0, 256, 3 * (1 << depth) - 3 * (depth == 8),
                           dtype=np.uint8) if ctype == 3 else None
        trns = {0: b"\x00\x01", 2: b"\x00\x01\x00\x02\x00\x03",
                3: b"\x00\x80"}.get(ctype) if h == 9 else None
        assert _same(tmp_path, _png(px, depth, ctype, interlace, rng, pal,
                                    trns), f"{h}x{w}.png") == "ok"
    if ctype == 3:                      # a palette PIL refuses as too long
        assert _same(tmp_path, _png(px, depth, ctype, interlace, rng,
                                    bytes(771)), "long.png") == "raises"


# ------------------------------------------------------------------ BMP

def _bmp(w, h, bits, pixdata, comp=0, palette=b"", colors=0, header=40,
         top_down=False, masks=None):
    mk = b"" if masks is None else struct.pack(f"<{len(masks)}I", *masks)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, comp, len(pixdata), 2835, 2835, colors, 0)
        if header > 40:
            extra = bytearray(header - 40)
            extra[:len(mk)] = mk
            info, mk = info + bytes(extra), b""
    off = 14 + len(info) + len(mk) + len(palette)
    return struct.pack("<2sIHHI", b"BM", off + len(pixdata), 0, 0, off) + \
        info + mk + palette + pixdata


def _bmp_rows(px, bits, top_down=False):
    h, w = px.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    out = np.zeros((h, stride), np.uint8)
    if bits < 8:
        b = np.unpackbits(px.astype(np.uint8)[..., None], axis=2)
        p = np.packbits(b[..., 8 - bits:].reshape(h, -1), axis=1)
    else:
        p = px.astype(np.uint8).reshape(h, -1)
    out[:, :p.shape[1]] = p
    return (out if top_down else out[::-1]).tobytes()


def _rle_stream(rng, w, h, rle4):
    out = bytearray()
    for _ in range(int(rng.integers(3, 4 * h + 6))):
        k = rng.integers(0, 10)
        if k < 5:                                     # encoded run
            out += bytes([int(rng.integers(1, w + 3)),
                          int(rng.integers(0, 256))])
        elif k < 7:                                   # absolute run
            n = int(rng.integers(3, w + 4))
            out += bytes([0, n]) + bytes(rng.integers(
                0, 256, n // 2 if rle4 else n).astype(np.uint8))
            if len(out) % 2:
                out += b"\x00"
        elif k < 9:                                   # end of line
            out += b"\x00\x00"
        else:                                         # delta
            out += bytes([0, 2, 0, 0, int(rng.integers(0, 3)),
                          int(rng.integers(0, 2))])
    if rng.integers(0, 2):
        out += b"\x00\x01"                            # end of bitmap
    return bytes(out)


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_bmp_palettes_match_jax(tmp_path, bits):
    rng = np.random.default_rng(bits)
    n = 0
    for w, h in ((1, 1), (3, 2), (9, 5), (33, 3)):
        for colors in (0, 2, 5, 1 << bits):
            k = colors or 1 << bits
            px = rng.integers(0, 1 << bits, (h, w))
            pal = rng.integers(0, 256, (k, 4)).astype(np.uint8)
            for blob in (
                    _bmp(w, h, bits, _bmp_rows(px, bits), palette=pal.tobytes(),
                         colors=colors),
                    _bmp(w, h, bits, _bmp_rows(px, bits, True),
                         palette=pal.tobytes(), colors=colors,
                         top_down=True),
                    _bmp(w, h, bits, _bmp_rows(px, bits),
                         palette=pal[:, :3].tobytes(), header=12)):
                n += _same(tmp_path, blob, "p.bmp") == "ok"
        grey = np.repeat(np.arange(1 << bits, dtype=np.uint8)[:, None], 4, 1) \
            if bits != 1 else np.array([[0] * 4, [255] * 4], np.uint8)
        n += _same(tmp_path, _bmp(w, h, bits, _bmp_rows(px, bits),
                                  palette=grey.tobytes()), "g.bmp") == "ok"
    assert n >= 40


@pytest.mark.parametrize("layout", ["555", "bitfields565", "bitfields555",
                                    "v4_rgba", "v5_bgra", "core24"])
def test_bmp_16_bit_and_layouts_match_jax(tmp_path, layout):
    rng = np.random.default_rng(len(layout))
    for w, h in ((1, 1), (3, 4), (8, 2), (13, 7)):
        if layout == "555":
            blob = _bmp(w, h, 16, _bmp_rows(rng.integers(0, 256, (h, w, 2)),
                                            16))
        elif layout.startswith("bitfields"):
            masks = (0xF800, 0x7E0, 0x1F) if layout.endswith("565") else \
                (0x7C00, 0x3E0, 0x1F)
            blob = _bmp(w, h, 16, _bmp_rows(rng.integers(0, 256, (h, w, 2)),
                                            16), comp=3, masks=masks)
        elif layout == "core24":
            blob = _bmp(w, h, 24, _bmp_rows(rng.integers(0, 256, (h, w, 3)),
                                            24), header=12)
        else:
            masks = (0xFF, 0xFF00, 0xFF0000, 0xFF000000) \
                if layout == "v4_rgba" else (0xFF0000, 0xFF00, 0xFF,
                                             0xFF000000)
            blob = _bmp(w, h, 32, _bmp_rows(rng.integers(0, 256, (h, w, 4)),
                                            32), comp=3, masks=masks,
                        header=108 if layout == "v4_rgba" else 124)
        assert _same(tmp_path, blob, "f.bmp") == "ok"


@pytest.mark.parametrize("rle4", [False, True], ids=["rle8", "rle4"])
def test_bmp_rle_matches_jax(tmp_path, rle4):
    """Random RLE streams, some cut short: the same pixels as PIL's
    BmpRleDecoder, or a raise where it raises."""
    rng = np.random.default_rng(7 + rle4)
    bits = 4 if rle4 else 8
    kinds = {"ok": 0, "raises": 0}
    for i in range(60):
        w, h = int(rng.integers(1, 12)), int(rng.integers(1, 6))
        stream = _rle_stream(rng, w, h, rle4)
        if i % 7 == 0:
            stream = stream[:len(stream) // 2]
        colors = int(rng.integers(0, 1 << bits))
        pal = rng.integers(0, 256, (colors or 1 << bits, 4)).astype(np.uint8)
        if i % 5 == 0:      # a grey palette: PIL reads the indices as L
            pal = np.repeat(np.arange(1 << bits, dtype=np.uint8)[:, None],
                            4, 1)
            colors = 0
        kinds[_same(tmp_path, _bmp(w, h, bits, stream, comp=2 if rle4 else 1,
                                   palette=pal.tobytes(), colors=colors,
                                   top_down=bool(i % 3 == 0)), "r.bmp")] += 1
    assert kinds["ok"] >= 20 and kinds["raises"] >= 1


def test_bmp_what_pil_refuses_raises(tmp_path):
    for blob in (_bmp(3, 3, 2, bytes(64)), _bmp(3, 3, 24, bytes(64), comp=4),
                 _bmp(3, 3, 16, bytes(64), comp=3, masks=(0xF00, 0xF0, 0xF)),
                 _bmp(3, 3, 24, bytes(64), header=44)):
        assert _same(tmp_path, blob, "bad.bmp") == "raises"


# ----------------------------------------------------------------- TIFF

TIFF_COMPRESSIONS = {"raw": 1, "packbits": 32773, "lzw": 5, "deflate": 8}
TIFF_LAYOUTS = {"strip": {}, "strips": dict(rows_per_strip=4),
                "tiles": dict(tile=(16, 16)),
                "planar": dict(planar=2, rows_per_strip=5),
                "planar_tiles": dict(planar=2, tile=(16, 16))}


def _tiff_pixels(photo, rng, h=19, w=21):
    """(samples, write_tiff keywords) of each photometric case."""
    if photo == "wiz1":
        return rng.integers(0, 2, (h, w, 1)), dict(photometric=0, bits=1)
    if photo == "biz4":
        return rng.integers(0, 16, (h, w, 1)), dict(photometric=1, bits=4)
    if photo == "biz8":
        return frame(h, w, 1), dict(photometric=1)
    if photo == "rgb":
        return frame(h, w, 3), dict(photometric=2)
    if photo == "rgba":
        return frame(h, w, 4), dict(photometric=2, extra=[2])
    if photo == "rgba_assoc":
        px = frame(h, w, 4).astype(np.int64)
        px[..., :3] = px[..., :3] * px[..., 3:] // 255   # premultiplied
        return px, dict(photometric=2, extra=[1])
    return rng.integers(0, 16, (h, w, 1)), dict(photometric=3, bits=4,
                                                colormap=colormap(4, 5))


@pytest.mark.parametrize("photo", ["wiz1", "biz4", "biz8", "rgb", "rgba",
                                   "rgba_assoc", "palette4"])
@pytest.mark.parametrize("comp", list(TIFF_COMPRESSIONS))
def test_tiff_matches_jax(tmp_path, comp, photo):
    """Every layout of TIFF_LAYOUTS at this compression and photometric
    interpretation, in both byte orders (planar only where a pixel has
    more than one sample)."""
    rng = np.random.default_rng(len(comp) * 10 + len(photo))
    px, kw = _tiff_pixels(photo, rng)
    for layout, lkw in TIFF_LAYOUTS.items():
        if layout.startswith("planar") and px.shape[-1] == 1:
            continue
        for order in "<>":
            blob = write_tiff(px, compression=TIFF_COMPRESSIONS[comp],
                              order=order, **kw, **lkw)
            got = _same(tmp_path, blob, f"{layout}.tif")
            # PIL reads separate planes of RGB and RGBA only, uncompressed
            assert got == "ok" or (layout.startswith("planar") and
                                   comp == "raw" and photo == "rgba_assoc"), \
                layout


def test_tiff_predictor_fill_order_and_orientation_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    rgb = frame(22, 30, 3)
    cases = [write_tiff(rgb, 2, compression=c, predictor=2, **lkw)
             for c in (5, 8, 32946) for lkw in TIFF_LAYOUTS.values()]
    cases += [write_tiff(rng.integers(0, 2, (9, 13, 1)), 1, bits=1,
                         compression=c, fill=2) for c in (1, 5, 32773)]
    cases += [write_tiff(rgb, 2, compression=8, orientation=o)
              for o in range(1, 9)]
    cases += [write_tiff(frame(9, 11, 2), 1, extra=[2], compression=5),
              write_tiff(frame(9, 11, 2), 3, extra=[2], colormap=colormap(8))]
    for i, blob in enumerate(cases):
        assert _same(tmp_path, blob, f"c{i}.tif") == "ok", i


def _retag(blob: bytes, tag: int, old: int, new: int) -> bytes:
    """`blob` (little-endian, from write_tiff) with one SHORT tag's value
    changed."""
    entry = struct.pack("<HHIH", tag, 3, 1, old)
    assert blob.count(entry) == 1
    return blob.replace(entry, struct.pack("<HHIH", tag, 3, 1, new))


def _old_style_lzw() -> bytes:
    """A strip whose first bytes are libtiff's old-style LZW mark."""
    px = frame(8, 8, 1)
    px[0, :2, 0] = (0, 1)
    return _retag(write_tiff(px, 1), 259, 1, 5)


def _pil_tiff(im, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


def _grey16() -> bytes:
    px = frame(8, 8, 1).astype(np.int64) * 257 - 200
    return write_tiff(px % 65536, 1, bits=16)


# the layouts the port once refused: those PIL reads are decoded now, the
# others still raise, naming themselves, and PIL raises on them too
REFUSED_TIFF = {
    "JPEG compression": lambda: _pil_tiff(Image.fromarray(frame(8, 8, 3)),
                                          compression="jpeg"),
    "CCITT Group 4": lambda: _pil_tiff(Image.fromarray(
        frame(8, 8, 1)[..., 0] >> 7 << 7).convert("1"), compression="group4"),
    "16-bit samples": _grey16,
    "YCbCr": lambda: write_tiff(frame(8, 8, 3), 6),
    "CMYK": lambda: write_tiff(frame(8, 8, 4), 5),
    "predictor 3": lambda: write_tiff(frame(8, 8, 3), 2, compression=8,
                                      predictor=3),
    "BigTIFF": lambda: write_tiff(frame(8, 8, 3), 2, compression=8,
                                  big=True),
    "old-style LZW": _old_style_lzw,
}
TAKEN_NOW = ("JPEG compression", "CCITT Group 4", "16-bit samples", "CMYK",
             "BigTIFF")


@pytest.mark.parametrize("what", list(REFUSED_TIFF))
def test_tiff_refused_features_name_themselves(tmp_path, what):
    """Each layout the port once refused: now decoded as the JAX package
    decodes it (real files: PIL's JPEG and Group 4, 16-bit grey, CMYK, a
    BigTIFF), or, where PIL refuses it too (uncompressed YCbCr, predictor 3
    on integer samples, old-style LZW), a ValueError naming it."""
    from mo_yolo_tpu_torch.data.tiff import decode_tiff
    blob = REFUSED_TIFF[what]()
    if what in TAKEN_NOW:
        assert _same(tmp_path, blob, "f.tif") == "ok"
        return
    with pytest.raises(ValueError, match=what):
        decode_tiff(blob)
    path = tmp_path / "f.tif"
    path.write_bytes(blob)
    with pytest.raises(ValueError, match=what):
        _port_load(path)
    with pytest.raises(Exception):
        _jax_load(path)


# ----------------------------------------------------------------- WebP

def _webp(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("quality", [1, 25, 60, 90, 100])
def test_webp_lossy_matches_jax(tmp_path, quality):
    rng = np.random.default_rng(quality)
    for h, w in ((1, 1), (7, 5), (16, 16), (31, 45), (50, 77)):
        img = frame(h, w, 3, seed=h)
        img[rng.random((h, w)) < 0.2] = rng.integers(0, 256, 3)
        assert _same(tmp_path, _webp(img, quality=quality,
                                     method=quality % 7), "f.webp") == "ok"


@pytest.mark.parametrize("kw", [dict(lossless=True),
                                dict(lossless=True, quality=0, method=0),
                                dict(lossless=True, quality=100, method=6),
                                dict(quality=80), dict(lossless=True,
                                                       exact=True)],
                         ids=["lossless", "lossless_fast", "lossless_best",
                              "alpha_lossy", "alpha_exact"])
def test_webp_lossless_and_alpha_match_jax(tmp_path, kw):
    rng = np.random.default_rng(len(kw))
    for h, w in ((1, 2), (9, 11), (40, 33)):
        img = frame(h, w, 3, seed=w)
        img[::3] = rng.integers(0, 256, img[::3].shape)
        if "alpha" in str(kw) or "exact" in kw or kw.get("quality") == 80:
            a = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
            a[rng.random((h, w)) < 0.3] = 0
            img = np.concatenate([img, a], -1)
        assert _same(tmp_path, _webp(img, **kw), "f.webp") == "ok"


# ----------------------------------------------------------- truncation

@pytest.mark.parametrize("name", [
    "tiff/rgb_lzw_strip.tif", "tiff/rgb_raw_tiles16.tif",
    "tiff/rgb_deflate_planar.tif", "tiff/grey4_biz_packbits.tif",
    "webp/lossy_q75_48x64.webp", "webp/lossless_29x37.webp",
    "webp/animated_offset.webp", "webp/alpha_lossy.webp"])
def test_file_cut_at_half_raises_as_jax(tmp_path, name):
    data = (DATA / name).read_bytes()
    assert _same(tmp_path, data[:len(data) // 2], Path(name).name) == \
        "raises"


def test_png_and_bmp_cut_at_half_raise_as_jax(tmp_path):
    rng = np.random.default_rng(0)
    png = _png(rng.integers(0, 256, (20, 30, 3)), 8, 2, 1, rng)
    bmp = _bmp(30, 20, 24, _bmp_rows(rng.integers(0, 256, (20, 30, 3)), 24))
    for name, data in (("f.png", png), ("f.bmp", bmp)):
        _same(tmp_path, data[:len(data) // 2], name)


def test_decoders_import_no_pil_and_link_nothing():
    port = ROOT / "mo_yolo_tpu_torch" / "data"
    for f in ("tiff.py", "webp.py", "decode.py", "loaders.py"):
        text = (port / f).read_text()
        assert not re.search(r"^\s*(import|from) (PIL|cv2)", text,
                             re.MULTILINE), f
        assert "load_c(SRC)" in text or f in ("loaders.py", "decode.py"), f
    tiff = (port / "tiff.py").read_text()
    assert "load_c(CCITT_SRC)" in tiff and "load_c(ZSTD_SRC)" in tiff
    for f in ("tiff.c", "webp.c", "decode.c", "ccitt.c", "zstd.c"):
        text = (port / "csrc" / f).read_text()
        includes = {line.split()[1] for line in text.splitlines()
                    if line.startswith("#include")}
        assert includes <= {"<stddef.h>", "<stdint.h>", "<stdlib.h>",
                            "<string.h>"} | (
            {"<setjmp.h>"} if f == "zstd.c" else set()), (f, includes)
