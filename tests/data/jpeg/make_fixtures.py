"""Write the JPEG fixtures of this folder, and `manifest.json`: for each
file, its size and the SHA-1 of PIL's decode of it
(`Image.open(path).convert("RGB")`, the JAX package's `load_image`).

    python tests/data/jpeg/make_fixtures.py

PIL writes most of them. The lossless ones (SOF3) come from
`lossless_jpeg` here. The CMYK without an Adobe marker, YCCK and
arithmetic-coded ones (SOF9, SOF10), and the scan scripts that leave
coefficients unrefined, come from `writer.c`, a small writer over the
system libjpeg that `libjpeg_write` compiles with `cc ... -ljpeg`: only the
test machine, which has libjpeg's headers, runs it (`libjpeg_write` is
also what `tests/test_torch_port_codecs.py` writes its cases with); the
port never links libjpeg.

`chip_smoke.py`'s `jpeg` phase holds the port's decoder to the manifest on
the card's host, which has no PIL; `tests/test_torch_port_jpeg.py` holds
the manifest to PIL. The frames are integer patterns (gradients, boxes, a
checkerboard and a hashed texture), so they need no random generator."""

import hashlib
import io
import json
import struct
import subprocess
import tempfile
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent


def frame(h, w, seed=0):
    y, x = np.mgrid[0:h, 0:w].astype(np.int64)
    img = np.stack([(x * 255) // max(w - 1, 1), (y * 255) // max(h - 1, 1),
                    np.full_like(x, 40 + 50 * (seed % 4))], -1)
    img += (((x * 73856093) ^ (y * 19349663) ^ (seed * 83492791)) % 23 -
            11)[..., None]
    k = (seed % 3) + 2
    img[(x // k + y // k) % 2 == 0] //= 2                 # a checkerboard
    img[h // 4:h // 2, w // 3:w // 2] = (200, 30 + seed, 90)
    img[h // 2:3 * h // 4, w // 2:w - 2] = (20, 220, 255 - seed)
    return np.clip(img, 0, 255).astype(np.uint8)


# name -> (height, width, mode, save options)
FIXTURES = {
    "baseline_444.jpg": (48, 64, "RGB", dict(quality=90, subsampling=0)),
    "baseline_422.jpg": (45, 61, "RGB", dict(quality=75, subsampling=1)),
    "baseline_420.jpg": (37, 53, "RGB", dict(quality=75, subsampling=2)),
    "grey.jpg": (40, 50, "L", dict(quality=85)),
    "odd_1x1.jpg": (1, 1, "RGB", dict(quality=75)),
    "odd_2x3.jpg": (2, 3, "RGB", dict(quality=50)),
    "odd_17x9.jpg": (17, 9, "RGB", dict(quality=95, subsampling=1)),
    "q100_444.jpg": (24, 40, "RGB", dict(quality=100, subsampling=0)),
    "optimized.jpg": (48, 64, "RGB", dict(quality=80, optimize=True)),
    "restart_blocks.jpg": (40, 56, "RGB",
                           dict(quality=85, restart_marker_blocks=3)),
    "restart_rows.jpg": (40, 56, "RGB",
                         dict(quality=85, restart_marker_rows=1)),
    "progressive.jpg": (48, 64, "RGB", dict(quality=85, progressive=True)),
    "progressive_optimized.jpg": (41, 59, "RGB",
                                  dict(quality=70, progressive=True,
                                       optimize=True)),
    "progressive_grey.jpg": (33, 47, "L", dict(quality=90,
                                               progressive=True)),
}


# libjpeg's J_COLOR_SPACE numbers
GREY, RGB, YCC, CMYK, YCCK = 1, 2, 3, 4, 5
_WRITER = {}


def libjpeg_write(px, in_space, jpeg_space, quality=75, arith=False,
                  restart=0, sampling=None, adobe=True, scans=None) -> bytes:
    """The bytes libjpeg writes for uint8 [h, w, c] `px` (c = 1, 3 or 4) in
    `in_space`, coded as `jpeg_space`: Huffman with optimized tables or
    arithmetic coding, a restart interval in MCUs, each component's
    (h, v) sampling, with or without the Adobe marker libjpeg writes for
    CMYK and YCCK, and `scans`: None (sequential), "p" (libjpeg's
    progression) or a list of (components, Ss, Se, Ah, Al)."""
    px = np.ascontiguousarray(px, np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    h, w, c = px.shape
    if "exe" not in _WRITER:
        out = Path(tempfile.mkdtemp()) / "jpeg_writer"
        subprocess.run(["cc", "-O2", "-o", str(out), str(HERE / "writer.c"),
                        "-ljpeg"], check=True)
        _WRITER["exe"] = out
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in", Path(tmp) / "out.jpg"
        src.write_bytes(px.tobytes())
        samp = "/".join(f"{a},{b}" for a, b in (sampling or [(1, 1)] * c))
        args = [str(_WRITER["exe"]), str(src), str(dst), str(w), str(h),
                str(c), str(in_space), str(jpeg_space), str(quality),
                str(int(arith)), str(restart), samp, str(int(adobe))]
        if scans == "p":
            args.append("p")
        elif scans:
            args.append("/".join(
                ",".join(map(str, comps)) + f":{ss}:{se}:{ah}:{al}"
                for comps, ss, se, ah, al in scans))
        subprocess.run(args, check=True)
        return dst.read_bytes()


def cut_scans(data: bytes):
    """A progressive file cut before each of its later scans, EOI after:
    what libjpeg block-smooths."""
    out, i = [], data.find(b"\xff\xda")
    while (j := data.find(b"\xff\xda", i + 2)) >= 0:
        out.append(data[:j] + b"\xff\xd9")
        i = j
    return out


def cmyk_frame(h, w, seed=0):
    """A CMYK frame: the inverse of `frame` and a black from its darkest
    channel."""
    rgb = frame(h, w, seed).astype(np.int64)
    k = 255 - rgb.max(-1, keepdims=True)
    return np.concatenate([255 - rgb - k // 2, k], -1).clip(0, 255).astype(
        np.uint8)


# name -> what writes it: the frames of `frame` and `cmyk_frame` through
# libjpeg (`libjpeg_write`) or PIL, some cut before a later scan
SCRIPT_AL = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
             ((0,), 6, 63, 0, 1), ((1,), 1, 63, 0, 1), ((2,), 1, 63, 0, 1),
             ((0,), 1, 5, 2, 1)]


def libjpeg_fixtures():
    """name -> bytes of the fixtures libjpeg (or PIL in CMYK) writes."""
    out = {}
    im = Image.fromarray(cmyk_frame(37, 45, 1), "CMYK")
    buf = io.BytesIO()
    im.save(buf, "JPEG", quality=80)
    out["cmyk_pil.jpg"] = buf.getvalue()
    out["cmyk_no_adobe.jpg"] = libjpeg_write(
        cmyk_frame(29, 41, 2), CMYK, CMYK, 85, adobe=False)
    out["ycck_420.jpg"] = libjpeg_write(
        cmyk_frame(33, 47, 3), CMYK, YCCK, 75,
        sampling=[(2, 2), (1, 1), (1, 1), (2, 2)])
    out["ycck_progressive.jpg"] = libjpeg_write(
        cmyk_frame(40, 31, 4), CMYK, YCCK, 70, scans="p",
        sampling=[(2, 1), (1, 1), (1, 1), (2, 1)])
    out["arith_sof9_420_restarts.jpg"] = libjpeg_write(
        frame(45, 61, 5), RGB, YCC, 80, arith=True, restart=3,
        sampling=[(2, 2), (1, 1), (1, 1)])
    out["arith_sof10_progressive.jpg"] = libjpeg_write(
        frame(48, 64, 6), RGB, YCC, 85, arith=True, scans="p",
        sampling=[(2, 2), (1, 1), (1, 1)])
    out["arith_grey.jpg"] = libjpeg_write(frame(23, 35, 7)[..., 1], GREY,
                                          GREY, 90, arith=True, restart=2)
    out["arith_cmyk_progressive.jpg"] = libjpeg_write(
        cmyk_frame(30, 38, 8), CMYK, CMYK, 75, arith=True, scans="p")
    prog = libjpeg_write(frame(41, 57, 9), RGB, YCC, 75, scans="p",
                         sampling=[(2, 2), (1, 1), (1, 1)])
    cuts = cut_scans(prog)
    out["smooth_first_scan.jpg"] = cuts[0]
    out["smooth_dc_scans.jpg"] = cuts[1]
    out["smooth_some_ac.jpg"] = cuts[4]
    out["smooth_al_left.jpg"] = libjpeg_write(
        frame(35, 50, 10), RGB, YCC, 75, scans=SCRIPT_AL,
        sampling=[(2, 2), (1, 1), (1, 1)])
    out["smooth_arith_first_scan.jpg"] = cut_scans(libjpeg_write(
        frame(26, 30, 11), RGB, YCC, 75, arith=True, scans="p"))[0]
    base = libjpeg_write(frame(24, 32, 12), RGB, YCC, 75)
    out["dnl_known_height.jpg"] = base[:-2] + b"\xff\xdc\x00\x04\x00\x18" + \
        base[-2:]
    return out


# lossless Huffman table: difference categories 0-16, canonical codes of
# these lengths (16 is 32768 and takes no extra bits)
_LOSSLESS_LENGTHS = (2, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14)


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
            self.put(0x7F, 8 - self.n)
        self.acc = self.n = 0


def _lossless_codes():
    order = sorted(range(17), key=lambda c: (_LOSSLESS_LENGTHS[c], c))
    bits = [sum(1 for v in _LOSSLESS_LENGTHS if v == n) for n in range(1, 17)]
    codes, code, k = {}, 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            codes[order[k]] = (code, n)
            code, k = code + 1, k + 1
        code <<= 1
    return bits, order, codes


def subsample(img, sampling):
    """[h, w, c] -> the component planes at `sampling` (h, v) each: every
    (max / factor)-th sample, ceil(w * h / max_h) wide."""
    mh, mv = max(a for a, _ in sampling), max(b for _, b in sampling)
    h, w = img.shape[:2]
    return [img[::mv // b, ::mh // a, i][:-(-h * b // mv), :-(-w * a // mh)]
            for i, (a, b) in enumerate(sampling)]


def lossless_jpeg(planes, sampling, predictor=1, pt=0, restart_rows=0,
                  ids=None, interleave=True, jfif=False, adobe=None) -> bytes:
    """A lossless JPEG (SOF3, Huffman; this system libjpeg cannot write
    one) of `planes`, one 2-D array of 8-bit samples a component at its own
    size (`subsample`), `sampling` its (h, v), one component at the
    largest factors: `predictor` 1-7, point transform `pt`, a
    restart every `restart_rows` MCU rows, one interleaved scan or a scan a
    component; the first row of the scan and of each restart interval
    predicted along the row from 1 << (7 - pt), as ITU T.81 H.1.2.1."""
    nc = len(planes)
    mh, mv = max(a for a, _ in sampling), max(b for _, b in sampling)
    full = [p for p, (a, b) in zip(planes, sampling) if (a, b) == (mh, mv)]
    h, w = full[0].shape               # a component at the frame's size
    ids = ids or ([82, 71, 66] if nc == 3 else list(range(1, nc + 1)))
    bits, order, codes = _lossless_codes()
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    if adobe is not None:
        out += b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + \
            bytes([adobe])
    out += b"\xff\xc3" + struct.pack(">HBHHB", 8 + 3 * nc, 8, h, w, nc)
    for i, (a, b) in enumerate(sampling):
        out += bytes([ids[i], (a << 4) | b, 0])
    out += b"\xff\xc4" + struct.pack(">H", 19 + 17) + b"\x00" + \
        bytes(bits) + bytes(order)
    x = [np.asarray(p, np.int64) >> pt for p in planes]

    def pred(p, ra, rb, rc):
        return (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                rb + ((ra - rc) >> 1), (ra + rb) >> 1)[p - 1]
    for scan in ([list(range(nc))] if interleave else [[i] for i in
                                                        range(nc)]):
        one = len(scan) == 1
        if one:
            mcux, mcuy = x[scan[0]].shape[1], x[scan[0]].shape[0]
        else:
            mcux, mcuy = -(-w // mh), -(-h // mv)
        if restart_rows:
            out += b"\xff\xdd\x00\x04" + struct.pack(">H", restart_rows *
                                                     mcux)
        out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * len(scan), len(scan))
        out += b"".join(bytes([ids[i], 0]) for i in scan)
        out += bytes([predictor, 0, pt])
        bitw, rst = _Bits(), 0
        for my in range(mcuy):
            restart = restart_rows and my and my % restart_rows == 0
            if restart:
                bitw.flush()
                bitw.out += bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) % 8
            for mx in range(mcux):
                for i in scan:
                    hs, vs = (1, 1) if one else sampling[i]
                    p = x[i]
                    first = my * vs if (my == 0 or restart) else -1
                    for yy in range(vs):
                        for xx in range(hs):
                            r, c = my * vs + yy, mx * hs + xx
                            if r >= p.shape[0] or c >= p.shape[1]:
                                d = 0
                            elif r == first:
                                d = p[r, c] - ((1 << (7 - pt)) if c == 0
                                               else p[r, c - 1])
                            elif c == 0:
                                d = p[r, c] - p[r - 1, c]
                            else:
                                d = p[r, c] - pred(
                                    predictor, p[r, c - 1], p[r - 1, c],
                                    p[r - 1, c - 1])
                            d = int(d) % 65536
                            d = d - 65536 if d >= 32768 else d
                            n = abs(d).bit_length() if d != -32768 else 16
                            bitw.put(*codes[n])
                            if 0 < n < 16:
                                bitw.put(d if d >= 0 else d - 1, n)
        bitw.flush()
        out += bitw.out
    return bytes(out + b"\xff\xd9")


def lossless_fixtures():
    """name -> bytes of the lossless fixtures: RGB at each predictor's
    extremes, 4:2:0 with restarts and a point transform, grey, CMYK, a
    scan a component."""
    out = {}
    rgb = frame(29, 37, 14)
    planes = [rgb[..., i] for i in range(3)]
    for p in (1, 4, 7):
        out[f"lossless_rgb_pred{p}.jpg"] = lossless_jpeg(planes, [(1, 1)] * 3,
                                                        predictor=p)
    s420 = [(2, 2), (1, 1), (1, 1)]
    out["lossless_420_restarts_pt1.jpg"] = lossless_jpeg(
        subsample(rgb, s420), s420, predictor=6, pt=1, restart_rows=2,
        ids=[1, 2, 3])
    out["lossless_grey_pred5.jpg"] = lossless_jpeg([rgb[..., 1]], [(1, 1)],
                                                   predictor=5)
    cmyk = cmyk_frame(21, 25, 15)
    out["lossless_cmyk_scans.jpg"] = lossless_jpeg(
        [cmyk[..., i] for i in range(4)], [(1, 1)] * 4, predictor=2,
        interleave=False, restart_rows=3)
    return out


def timed_fixtures():
    """name -> bytes of the 1080p files chip_smoke.py times, of a smooth
    scene (gradients, two boxes, a 64-pixel checkerboard): CMYK (Huffman,
    4:2:0 with K at full size) and an arithmetic-coded progressive file,
    small enough for PIL's first 64 KiB block (past it,
    libjpeg's arithmetic decoder cannot suspend and PIL raises)."""
    h, w = 1080, 1920
    y, x = np.mgrid[0:h, 0:w].astype(np.int64)
    img = np.stack([(x * 255) // (w - 1), (y * 255) // (h - 1),
                    ((x + y) // 8) % 256], -1)
    img[h // 4:h // 2, w // 3:w // 2] = (200, 30, 90)
    img[h // 2:3 * h // 4, w // 2:w - 200] = (20, 220, 255)
    img[(x // 64 + y // 64) % 2 == 0] //= 2
    img = img.astype(np.uint8)
    cmyk = np.concatenate([255 - img, 255 - img.max(-1, keepdims=True)], -1)
    return {"cmyk_1080p.jpg": libjpeg_write(
                cmyk, CMYK, CMYK, 75, sampling=[(2, 2), (1, 1), (1, 1),
                                                 (2, 2)]),
            "arith_progressive_1080p.jpg": libjpeg_write(
                img, RGB, YCC, 75, arith=True, scans="p",
                sampling=[(2, 2), (1, 1), (1, 1)])}


def main():
    manifest = {}
    for i, (name, (h, w, mode, opts)) in enumerate(FIXTURES.items()):
        im = Image.fromarray(frame(h, w, i))
        if mode == "L":
            im = im.convert("L")
        im.save(HERE / name, "JPEG", **opts)
    made = {**libjpeg_fixtures(), **lossless_fixtures(), **timed_fixtures()}
    for name, blob in made.items():
        (HERE / name).write_bytes(blob)
    for name in [*FIXTURES, *made]:
        rgb = np.asarray(Image.open(HERE / name).convert("RGB"))
        manifest[name] = {"shape": list(rgb.shape),
                          "bytes": (HERE / name).stat().st_size,
                          "sha1": hashlib.sha1(rgb.tobytes()).hexdigest()}
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1) +
                                        "\n")


if __name__ == "__main__":
    main()
