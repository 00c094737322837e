"""The port's JPEG codec (`data/jpeg.py`, `data/csrc/jpeg.c`) against PIL
and the JAX package, on the CPU.

- decode: the fixtures of `tests/data/jpeg` and frames PIL writes at
  qualities 1-100 in 4:4:4, 4:2:2 and 4:2:0 at odd sizes equal the JAX
  `load_image` exactly; so do layouts PIL cannot write (4:4:0, 4:1:1, a
  luma sampled below its chroma, non-interleaved scans, 'R','G','B' ids,
  Adobe transforms, restart intervals, no DHT), written by the small
  baseline writer here; threads decoding at once give the same pixels;
- encode: PIL's `save(buf, "JPEG", quality=q)` bytes, byte for byte;
- `jpeg_compression` equals the JAX one;
- the fixture manifest and `chip_smoke.JPEG_DIGESTS` (which the card's
  host, with no PIL, is held to) are PIL's output;
- truncation: a file cut short raises where the JAX `load_image` raises
  ("image file is truncated") and decodes where it decodes, files that
  lack only their EOI marker included (PIL's 64 KiB feeding decides which;
  the larger files cross it);
- CMYK, YCCK, arithmetic coding and block smoothing (more in
  `test_torch_port_codecs.py`); the processes not taken raise, naming
  them, where the JAX package raises too;
- the slice: `TrackValidator` on a JPEG copy of `make_mot_fixture` in both
  packages, within `test_torch_port_val.py`'s tolerances;
- no file of the port names jpeglib.h, links libjpeg or imports PIL or
  cv2.
"""

import hashlib
import io
import json
import re
import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_port_common import ROOT

torch.set_num_threads(1)

FIXTURES = ROOT / "tests" / "data" / "jpeg"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())


def _frame(h, w, seed=0, noise=20):
    """A smooth frame with two boxes and some noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 5.0)
                    for c in range(3)], -1)
    img = img + rng.normal(0, noise, (h, w, 3))
    img[h // 4:h // 2, w // 3:2 * w // 3] = (220, 30, 60)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_bytes(img, **opts):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **opts)
    return buf.getvalue()


def _jax_load(data, tmp_path, name="f.jpg"):
    """The JAX package's `load_image` of `data`, or the exception's text."""
    from mo_yolo_tpu.data.loaders import load_image
    path = tmp_path / name
    path.write_bytes(data)
    try:
        return load_image(str(path))
    except OSError as e:
        return f"{type(e).__name__}: {e}"


def _port_load(data, tmp_path, name="f.jpg"):
    from mo_yolo_tpu_torch.data.loaders import load_image
    path = tmp_path / name
    path.write_bytes(data)
    try:
        return load_image(path)
    except ValueError as e:
        return f"ValueError: {e}"


def _same(a, b):
    """Both raised, or both decoded to the same pixels."""
    if isinstance(a, str) or isinstance(b, str):
        return isinstance(a, str) and isinstance(b, str)
    return a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------- decode

@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_decodes_as_jax_and_as_the_manifest_says(name, tmp_path):
    from mo_yolo_tpu.data.loaders import load_image as jax_load
    from mo_yolo_tpu_torch.data.loaders import load_image
    got = load_image(FIXTURES / name)
    want = jax_load(str(FIXTURES / name))
    np.testing.assert_array_equal(got, want)
    assert list(want.shape) == MANIFEST[name]["shape"]
    assert hashlib.sha1(want.tobytes()).hexdigest() == MANIFEST[name]["sha1"]
    assert (FIXTURES / name).stat().st_size == MANIFEST[name]["bytes"]


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [1, 5, 50, 75, 95, 100])
def test_pil_frames_decode_as_jax(quality, subsampling, tmp_path):
    """Qualities 1-100 in 4:4:4, 4:2:2 and 4:2:0 at odd sizes; baseline,
    optimized and progressive."""
    for i, (h, w, opts) in enumerate((
            (37, 53, {}), (1, 1, {}), (17, 9, dict(optimize=True)),
            (33, 71, dict(progressive=True)))):
        img = _frame(h, w, seed=quality + i)
        data = _pil_bytes(img, quality=quality, subsampling=subsampling,
                          **opts)
        got, want = _port_load(data, tmp_path), _jax_load(data, tmp_path)
        assert isinstance(got, np.ndarray) and _same(got, want), (h, w, opts)


def test_grey_and_restart_frames_decode_as_jax(tmp_path):
    img = _frame(45, 61, seed=3)
    for opts in (dict(restart_marker_blocks=1), dict(restart_marker_rows=2),
                 dict(progressive=True, restart_marker_blocks=3)):
        for im in (Image.fromarray(img), Image.fromarray(img).convert("L")):
            buf = io.BytesIO()
            im.save(buf, "JPEG", quality=80, **opts)
            data = buf.getvalue()
            got = _port_load(data, tmp_path)
            assert isinstance(got, np.ndarray)
            assert _same(got, _jax_load(data, tmp_path)), (opts, im.mode)


# a baseline writer for layouts PIL does not write: standard tables, random
# quantized coefficients, each component's sampling factors and id given
_ZZ = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26,
       33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57,
       50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
       39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


def _std_tables():
    """(DC bits, DC values, AC bits, AC values) of a PIL file's first DC
    and AC tables: the standard luminance tables."""
    data = _pil_bytes(np.zeros((8, 8, 3), np.uint8))
    tables, i = [], data.find(b"\xff\xc4")
    for _ in range(2):
        n = int.from_bytes(data[i + 2:i + 4], "big")
        body = data[i + 5:i + 2 + n]
        tables += [list(body[:16]), list(body[16:])]
        i += 2 + n
    return tables


def _codes(bits, vals):
    code, out, k = 0, {}, 0
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            out[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, v, n):
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            c = (self.acc >> self.n) & 255
            self.out += bytes([c, 0]) if c == 255 else bytes([c])

    def flush(self):
        if self.n:
            self.put(0x7F, 7)
        self.acc = self.n = 0


def _write(rng, h, w, samp, ids=(1, 2, 3), jfif=True, adobe=None,
           interleave=True, dri=0, dht=True):
    dcb, dcv, acb, acv = _std_tables()
    dc, ac = _codes(dcb, dcv), _codes(acb, acv)
    mh, mv = max(s[0] for s in samp), max(s[1] for s in samp)
    mx, my = -(-w // (8 * mh)), -(-h // (8 * mv))
    comps = []
    for hs, vs in samp:
        coef = np.zeros((my * vs, mx * hs, 64), int)
        coef[..., 0] = rng.integers(-60, 60, coef.shape[:2])
        for k in range(1, 20):
            coef[..., _ZZ[k]] = rng.integers(-6, 7, coef.shape[:2]) * (
                rng.random(coef.shape[:2]) < 0.5)
        comps.append(dict(h=hs, v=vs, coef=coef,
                          wib=-(-w * hs // (8 * mh)),
                          hib=-(-h * vs // (8 * mv))))
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    if adobe is not None:
        out += b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes(
            [adobe])
    q = rng.integers(1, 20, 64)
    out += b"\xff\xdb\x00\x43\x00" + bytes(int(q[_ZZ[i]]) for i in range(64))
    out += b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * len(samp), 8, h, w,
                                     len(samp))
    for i, (hs, vs) in enumerate(samp):
        out += bytes([ids[i], (hs << 4) | vs, 0])
    if dht:
        out += b"\xff\xc4" + struct.pack(">H", 19 + len(dcv)) + b"\x00" + \
            bytes(dcb) + bytes(dcv)
        out += b"\xff\xc4" + struct.pack(">H", 19 + len(acv)) + b"\x10" + \
            bytes(acb) + bytes(acv)
    if dri:
        out += b"\xff\xdd\x00\x04" + struct.pack(">H", dri)
    scans = [list(range(len(samp)))] if interleave else \
        [[i] for i in range(len(samp))]
    for scan in scans:
        out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * len(scan), len(scan))
        out += b"".join(bytes([ids[i], 0]) for i in scan) + b"\x00\x3f\x00"
        bits, last, mcus, rst = _Bits(), [0] * len(samp), 0, 0
        if len(scan) > 1:
            units = [[(i, y * comps[i]["v"] + yy, x * comps[i]["h"] + xx)
                      for i in scan for yy in range(comps[i]["v"])
                      for xx in range(comps[i]["h"])]
                     for y in range(my) for x in range(mx)]
        else:
            c = comps[scan[0]]
            units = [[(scan[0], y, x)] for y in range(c["hib"])
                     for x in range(c["wib"])]
        for mcu in units:
            if dri and mcus and mcus % dri == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + rst])
                rst, last = (rst + 1) % 8, [0] * len(samp)
            for i, y, x in mcu:
                blk = [int(v) for v in comps[i]["coef"][y, x]]
                diff = blk[0] - last[i]
                last[i] = blk[0]
                n = abs(diff).bit_length()
                bits.put(*dc[n])
                if n:
                    bits.put(diff if diff >= 0 else diff - 1, n)
                run = 0
                for k in range(1, 64):
                    v = blk[_ZZ[k]]
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        bits.put(*ac[0xF0])
                        run -= 16
                    n = abs(v).bit_length()
                    bits.put(*ac[(run << 4) | n])
                    bits.put(v if v >= 0 else v - 1, n)
                    run = 0
                if run:
                    bits.put(*ac[0])
            mcus += 1
        bits.flush()
        out += bits.out
    return bytes(out + b"\xff\xd9")


LAYOUTS = {
    "440": dict(samp=((1, 2), (1, 1), (1, 1))),
    "411": dict(samp=((4, 1), (1, 1), (1, 1))),
    "luma_below_chroma": dict(samp=((1, 1), (2, 2), (2, 2))),
    "3x1": dict(samp=((3, 1), (1, 1), (1, 1))),
    "mixed": dict(samp=((2, 2), (2, 1), (1, 2))),
    "rgb_ids": dict(samp=((1, 1),) * 3, jfif=False, ids=(82, 71, 66)),
    "adobe_rgb": dict(samp=((1, 1),) * 3, jfif=False, adobe=0),
    "adobe_ycc": dict(samp=((2, 2), (1, 1), (1, 1)), jfif=False, adobe=1),
    "unknown_ids": dict(samp=((2, 1), (1, 1), (1, 1)), jfif=False,
                        ids=(7, 8, 9)),
    "non_interleaved": dict(samp=((2, 2), (1, 1), (1, 1)), interleave=False),
    "restarts": dict(samp=((2, 2), (1, 1), (1, 1)), dri=2),
    "restarts_non_interleaved": dict(samp=((1, 2), (1, 1), (1, 1)),
                                     interleave=False, dri=1),
    "grey_2x2": dict(samp=((2, 2),)),
    "no_dht": dict(samp=((1, 1), (1, 1), (1, 1)), dht=False),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layouts_pil_does_not_write_decode_as_jax(layout, tmp_path):
    rng = np.random.default_rng(sorted(LAYOUTS).index(layout))
    for h, w in ((1, 1), (9, 17), (31, 47)):
        data = _write(rng, h, w, **LAYOUTS[layout])
        got, want = _port_load(data, tmp_path), _jax_load(data, tmp_path)
        assert isinstance(got, np.ndarray) and _same(got, want), (h, w)


def test_threads_decode_at_once():
    """The dataset's prefetch threads decode together: no state is shared
    (each call has its own error buffer)."""
    from mo_yolo_tpu_torch.data.jpeg import decode_jpeg
    datas = [_pil_bytes(_frame(64 + i, 80 + 3 * i, seed=i), quality=90)
             for i in range(8)] + [b"\xff\xd8\xff\xc3"] * 4
    want = []
    for d in datas:
        try:
            want.append(decode_jpeg(d))
        except ValueError as e:
            want.append(str(e))

    def one(d):
        try:
            return decode_jpeg(d)
        except ValueError as e:
            return str(e)
    with ThreadPoolExecutor(6) as pool:
        for _ in range(3):
            got = list(pool.map(one, datas * 2))
            assert all(_same(g, w) and (not isinstance(g, str) or g == w)
                       for g, w in zip(got, want * 2))


# ---------------------------------------------------------------- encode

@pytest.mark.parametrize("quality", [1, 5, 24, 25, 50, 75, 95, 100])
def test_encode_equals_pil_bytes(quality):
    from mo_yolo_tpu_torch.data.jpeg import encode_jpeg
    for i, (h, w) in enumerate(((1, 1), (1, 2), (2, 3), (8, 8), (16, 16),
                                (17, 9), (31, 47), (97, 133))):
        img = _frame(h, w, seed=i) if i % 2 else np.random.default_rng(
            i).integers(0, 256, (h, w, 3), np.uint8)
        assert encode_jpeg(img, quality) == _pil_bytes(img, quality=quality), \
            (h, w)


def test_write_image_and_jpeg_compression_equal_the_jax_package(tmp_path):
    """`write_image(.jpg)` writes PIL's default save (quality 75), and
    `jpeg_compression` is the JAX round trip."""
    from mo_yolo_tpu.data import augment as J
    from mo_yolo_tpu_torch.data import augment as P
    from mo_yolo_tpu_torch.data.encode import write_image
    img = _frame(50, 70, seed=5)
    Image.fromarray(img).save(tmp_path / "pil.jpg")
    write_image(tmp_path / "port.jpg", img)
    assert (tmp_path / "port.jpg").read_bytes() == \
        (tmp_path / "pil.jpg").read_bytes()
    for q in (1, 40, 75, 99, 100):
        np.testing.assert_array_equal(P.jpeg_compression(img, q),
                                      J.jpeg_compression(img, q))


@pytest.mark.parametrize("bad", ["float", "gray", "rgba", "quality"])
def test_encode_refuses_what_it_does_not_write(bad):
    from mo_yolo_tpu_torch.data.jpeg import encode_jpeg
    img = _frame(8, 8)
    args = {"float": (img.astype(np.float32), 75), "gray": (img[..., 0], 75),
            "rgba": (np.dstack([img, img[..., :1]]), 75),
            "quality": (img, 101)}[bad]
    with pytest.raises(ValueError):
        encode_jpeg(*args)


def test_chip_smoke_digests_are_pils():
    """The card's host is held to these without PIL: the frames numpy
    makes and PIL's bytes of them; the port's bytes are the same."""
    import chip_smoke
    from mo_yolo_tpu_torch.data.jpeg import encode_jpeg
    cases = chip_smoke.jpeg_cases()
    assert [c[0] for c in cases] == list(chip_smoke.JPEG_DIGESTS) == \
        list(chip_smoke.JPEG_FRAME_DIGESTS)
    for name, img, q in cases:
        data = _pil_bytes(img, quality=q)
        assert hashlib.sha256(img.tobytes()).hexdigest() == \
            chip_smoke.JPEG_FRAME_DIGESTS[name]
        assert hashlib.sha256(data).hexdigest() == \
            chip_smoke.JPEG_DIGESTS[name], name
        assert encode_jpeg(img, q) == data, name


# ------------------------------------------------------------ truncation

def test_a_file_cut_at_half_raises_where_jax_raises(tmp_path):
    """Queue 3 item 16: the port used to pad the missing rows grey."""
    data = _pil_bytes(_frame(64, 80, seed=1), quality=75)
    cut = data[:len(data) // 2]
    assert isinstance(_jax_load(cut, tmp_path), str)
    with pytest.raises(ValueError, match="truncated"):
        from mo_yolo_tpu_torch.data.loaders import load_image
        (tmp_path / "cut.jpg").write_bytes(cut)
        load_image(tmp_path / "cut.jpg")
    # data that stops at a marker is padded, by both
    closed = cut + b"\xff\xd9"
    got, want = _port_load(closed, tmp_path), _jax_load(closed, tmp_path)
    assert isinstance(want, np.ndarray) and _same(got, want)


@pytest.mark.parametrize("kind", ["small", "past_64k"])
def test_files_missing_only_their_eoi_behave_as_jax(kind, tmp_path):
    """Without EOI, libjpeg (fed 64 KiB at a time by PIL) decodes some
    baseline files, whose last MCU needs no byte past the end, and raises
    on the rest; progressive files always raise. The port does the same
    on every file."""
    outcomes = set()
    n = 40 if kind == "small" else 8
    for i in range(n):
        if kind == "small":
            h, w = 16 + 7 * (i % 5), 24 + 5 * (i % 7)
        else:
            h, w = 240 + 8 * i, 320
        opts = dict(progressive=True) if i % 10 == 9 else {}
        img = np.random.default_rng(i).integers(0, 256, (h, w, 3), np.uint8) \
            if kind == "past_64k" else _frame(h, w, seed=i)
        data = _pil_bytes(img, quality=95 if kind == "past_64k" else 50 + i,
                          **opts)
        assert kind == "small" or len(data) > 65536
        for cut in (data[:-2], data[:-1]):
            got, want = _port_load(cut, tmp_path), _jax_load(cut, tmp_path)
            assert _same(got, want), (i, len(data), want if isinstance(
                want, str) else "decodes")
            outcomes.add(isinstance(want, str))
    if kind == "small":
        assert outcomes == {True, False}


# --------------------------------------------------------- not taken yet

def _patched(data, old, new):
    i = data.find(old)
    assert i >= 0
    return data[:i] + new + data[i + len(old):]


def _sof(data):
    return data.find(b"\xff\xc0")


NOT_TAKEN = {
    "arithmetic_sof9": (lambda d: _patched(d, b"\xff\xc0", b"\xff\xc9"),
                        "arithmetic"),
    "arithmetic_sof10": (lambda d: _patched(d, b"\xff\xc0", b"\xff\xca"),
                         "arithmetic"),
    "arithmetic_sof11": (lambda d: _patched(d, b"\xff\xc0", b"\xff\xcb"),
                         "arithmetic"),
    "arithmetic_dac": (lambda d: d[:_sof(d)] + b"\xff\xcc\x00\x04\x00\x10" +
                       d[_sof(d):], "arithmetic"),
    "lossless_sof3": (lambda d: _patched(d, b"\xff\xc0", b"\xff\xc3"),
                      "lossless"),
    "hierarchical_sof5": (lambda d: _patched(d, b"\xff\xc0", b"\xff\xc5"),
                          "hierarchical"),
    "hierarchical_sof7": (lambda d: _patched(d, b"\xff\xc0", b"\xff\xc7"),
                          "hierarchical"),
    "hierarchical_sof13": (lambda d: _patched(d, b"\xff\xc0", b"\xff\xcd"),
                           "hierarchical"),
    "hierarchical_dhp": (lambda d: d[:_sof(d)] + b"\xff\xde" +
                         d[_sof(d) + 2:], "hierarchical"),
    "12_bit": (lambda d: d[:_sof(d) + 4] + b"\x0c" + d[_sof(d) + 5:],
               "12-bit"),
    "dnl_height_0": (lambda d: d[:_sof(d) + 5] + b"\x00\x00" +
                     d[_sof(d) + 7:], "DNL"),
    "dnl_marker": (lambda d: d[:-2] + b"\xff\xdc\x00\x04\x00\x10" + d[-2:],
                   "DNL"),
}


# the patches the port now decodes as libjpeg does: an arithmetic SOF9 over
# Huffman data (decoded as the arithmetic data it now is), a DAC marker,
# a DNL marker after a frame of known height
TAKEN_NOW = ("arithmetic_dac", "arithmetic_sof9", "dnl_marker")


@pytest.mark.parametrize("case", sorted(NOT_TAKEN))
def test_processes_not_taken_raise_naming_them(case, tmp_path):
    """Each on a PIL file whose SOF (or one marker) is patched: the port
    decodes what it now takes to the JAX `load_image`'s pixels, and raises
    naming the process where the JAX package raises too (SOF10 over a
    sequential scan and SOF11 raise in both)."""
    from mo_yolo_tpu_torch.data.jpeg import decode_jpeg
    patch, name = NOT_TAKEN[case]
    data = patch(_pil_bytes(_frame(16, 16), quality=75))
    want = _jax_load(data, tmp_path)
    if case in TAKEN_NOW:
        got = _port_load(data, tmp_path)
        assert isinstance(want, np.ndarray) and _same(got, want)
        return
    assert isinstance(want, str)
    with pytest.raises(ValueError, match=name if case not in (
            "arithmetic_sof10",) else "progressive"):
        decode_jpeg(data)


def test_cmyk_and_block_smoothing_raise_naming_them(tmp_path):
    """Once refused, now the JAX package's pixels: PIL's CMYK JPEG (Adobe,
    inverted), and a progressive file whose later scans are missing, which
    libjpeg block-smooths; a PNG still raises."""
    from mo_yolo_tpu_torch.data.jpeg import decode_jpeg
    buf = io.BytesIO()
    Image.fromarray(_frame(16, 16)).convert("CMYK").save(buf, "JPEG")
    data = buf.getvalue()
    want = _jax_load(data, tmp_path)
    assert isinstance(want, np.ndarray)
    np.testing.assert_array_equal(decode_jpeg(data), want)
    data = _pil_bytes(_frame(40, 48), quality=75, progressive=True)
    short = data[:data.find(b"\xff\xda", data.find(b"\xff\xda") + 2)] + \
        b"\xff\xd9"
    want = _jax_load(short, tmp_path)
    assert isinstance(want, np.ndarray)
    np.testing.assert_array_equal(decode_jpeg(short), want)
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n")


# --------------------------------------------------------------- the slice

def test_track_validator_on_jpeg_frames_equals_jax(tmp_path):
    """`TrackValidator` in both packages on a 1-sequence x 4-frame JPEG copy
    (quality 95, by PIL) of `make_mot_fixture` at 96x96, MOT17's layout:
    every metric within `test_torch_port_val.py`'s tolerances, IDSW
    exactly; the port read JPEG frames."""
    from scripts.make_synth_mot import make_mot_fixture

    from mo_yolo_tpu.engine.validator import TrackValidator as JValidator
    from mo_yolo_tpu_torch.data import dataset as ds_mod
    from mo_yolo_tpu_torch.data.dataset import load_dataset_yaml
    from mo_yolo_tpu_torch.data.mot_challenge import convert_mot_to_yolo
    from mo_yolo_tpu_torch.engine.validator import TrackValidator
    from tests.test_torch_port_val import HW, METRIC_ATOL, SCORE_BIAS
    from tests.torch_port_common import build_pair
    base = Path(make_mot_fixture(str(tmp_path / "raw"), n_seq=1, size=HW,
                                 n_frames=4))
    for png in sorted(base.rglob("img1/*.png")):
        Image.open(png).convert("RGB").save(png.with_suffix(".jpg"),
                                            quality=95)
        png.unlink()
    for ini in base.rglob("seqinfo.ini"):
        ini.write_text(ini.read_text().replace("imExt=.png", "imExt=.jpg"))
    files = load_dataset_yaml(convert_mot_to_yolo(
        str(tmp_path / "raw"), str(tmp_path / "yolo")))["train"]
    assert len(files) == 4 and all(f.endswith(".jpg") for f in files)
    jm, v, pm = build_pair(image_hw=(HW, HW), score_bias=SCORE_BIAS)
    jout = JValidator(jm, v, imgsz=HW, conf=0.0)(files, max_gt=8)
    read = []
    load = ds_mod.load_image
    ds_mod.load_image = lambda p: read.append(str(p)) or load(p)
    try:
        pout = TrackValidator(pm, imgsz=HW, conf=0.0)(files, max_gt=8)
    finally:
        ds_mod.load_image = load
    assert read and all(p.endswith(".jpg") for p in read)
    assert pout.keys() == jout.keys()
    for k in jout:
        if k == "fps":
            assert pout[k] > 0
        elif k == "IDSW":
            assert pout[k] == jout[k]
        else:
            assert abs(pout[k] - jout[k]) <= 100 * METRIC_ATOL, \
                (k, pout[k], jout[k])


# ------------------------------------------------------ no image library

def test_the_port_links_no_image_library():
    """No file of the port (nor chip_smoke.py) includes jpeglib.h or links
    libjpeg, and none imports PIL or cv2 but `utils/plotting.show_image`,
    which opens a window with them where a display exists (as the JAX
    package's does) and decodes or encodes nothing; the codec builds from
    jpeg.c alone."""
    files = [p for p in (ROOT / "mo_yolo_tpu_torch").rglob("*")
             if p.suffix in (".py", ".c", ".h", ".cu", ".cuh")]
    files.append(ROOT / "chip_smoke.py")
    show = ROOT / "mo_yolo_tpu_torch" / "utils" / "plotting.py"
    for p in files:
        text = p.read_text()
        assert "jpeglib.h" not in text, p
        assert "-ljpeg" not in text, p
        assert not re.search(r"libs=\([^)]*[\"']jpeg[\"']", text), p
        if p == show:
            a = text.index("def show_image(")
            text = text[:a] + text[text.index("\ndef ", a + 1):]
        assert not re.search(r"^\s*(import|from)\s+(PIL|cv2)\b", text,
                             re.M), p
    src = (ROOT / "mo_yolo_tpu_torch" / "data" / "csrc" / "jpeg.c").read_text()
    assert set(re.findall(r"#include <([^>]+)>", src)) <= {
        "setjmp.h", "stdarg.h", "stddef.h", "stdint.h", "stdio.h",
        "stdlib.h", "string.h"}
