"""TIFF frames without PIL or libtiff: the first IFD of a TIFF file to
uint8 [H, W, 3] RGB, pixel for pixel what the JAX package's `load_image`
gets from PIL (`Image.open(...).convert("RGB")`).

- Both byte orders; strips or tiles; PlanarConfiguration 1 (chunky) and
  2 (one plane a sample) for the sample layouts PIL reads that way.
- Compression: none, PackBits and LZW (`csrc/tiff.c`, built by
  `utils/cuda_build.load_c` at first use, never at import), Deflate (8 and
  32946) through Python's zlib; the horizontal predictor (2) at 8 bits
  after LZW and Deflate, as libtiff applies it; FillOrder 2 where PIL
  takes it (compressed data bit-reversed before decoding, as libtiff
  does).
- Photometric: WhiteIsZero and BlackIsZero grey at 1, 2, 4 and 8 bits,
  grey with alpha, RGB, RGB with extra samples (unassociated alpha and
  unspecified samples dropped; associated alpha unpremultiplied, as PIL's
  `RGBa` unpacker does, then dropped), palette at 1 to 8 bits (PIL scales
  the 16-bit colormap by `// 256`), with an extra sample dropped.
- Orientation 2-8 is applied after decoding, as PIL's TIFF loader applies
  it (`ImageOps.exif_transpose` in `load_end`).

The sample layouts are PIL's `OPEN_INFO` keys at these depths. Everything
else raises a ValueError naming what is not taken: BigTIFF, JPEG, CCITT
and the other codecs, old-style LZW, predictor 3 and the predictor at
other depths, 12-, 16- and 32-bit and float samples, CMYK, YCbCr, CIELab.
A file whose strips or tiles lie past its end, or decode short, raises.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from mo_yolo_tpu_torch.data.decode import unpack_bits
from mo_yolo_tpu_torch.utils import cuda_build

SRC = Path(__file__).resolve().parent / "csrc" / "tiff.c"
TIFF_MAGICS = (b"II*\x00", b"MM\x00*")
BIGTIFF_MAGICS = (b"II+\x00", b"MM\x00+")

# tags
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILLORDER = (
    256, 257, 258, 259, 262, 266)
STRIP_OFFSETS, ORIENTATION, SAMPLES, ROWS_PER_STRIP, STRIP_BYTES = (
    273, 274, 277, 278, 279)
PLANAR, PREDICTOR, COLORMAP = 284, 317, 320
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_BYTES = 322, 323, 324, 325
EXTRA_SAMPLES, SAMPLE_FORMAT = 338, 339

# field type -> (struct code, bytes)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4),
          5: ("II", 8), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4),
          10: ("ii", 8), 11: ("f", 4), 12: ("d", 8), 13: ("I", 4),
          16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
_CODECS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate",
           32773: "PackBits"}
_NAMED = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
          6: "old-style JPEG", 7: "JPEG", 32771: "raw-16 padding",
          32809: "ThunderScan", 34676: "SGILog", 34677: "SGILog24",
          34925: "LZMA", 50000: "ZSTD", 50001: "WebP"}
_PHOTOMETRIC = {0: "WhiteIsZero", 1: "BlackIsZero", 2: "RGB", 3: "palette",
                4: "transparency mask", 5: "CMYK", 6: "YCbCr",
                8: "CIELab"}
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                    np.uint8)


def _fn(symbol):
    return cuda_build.bind(cuda_build.load_c(SRC), symbol,
                           [ctypes.c_char_p, ctypes.c_longlong,
                            ctypes.c_void_p, ctypes.c_longlong],
                           ctypes.c_longlong)


def _refuse(what: str):
    return ValueError(f"TIFF: {what} is not taken")


def _ifd(data: bytes):
    """The first IFD's tags: {tag: tuple of values}."""
    if len(data) < 8:
        raise ValueError("TIFF header cut short")
    bo = "<" if data[:2] == b"II" else ">"
    pos = struct.unpack(bo + "I", data[4:8])[0]
    if pos + 2 > len(data):
        raise ValueError("TIFF: the first IFD lies past the end of the file")
    n = struct.unpack(bo + "H", data[pos:pos + 2])[0]
    if pos + 2 + 12 * n > len(data):
        raise ValueError("TIFF: the first IFD is cut short")
    tags = {}
    for k in range(n):
        tag, typ, count, val = struct.unpack(
            bo + "HHI4s", data[pos + 2 + 12 * k:pos + 14 + 12 * k])
        if typ not in _TYPES:
            continue
        code, size = _TYPES[typ]
        nbytes = size * count
        if nbytes > 4:
            at = struct.unpack(bo + "I", val)[0]
            if at + nbytes > len(data):
                raise ValueError(f"TIFF: tag {tag}'s values lie past the "
                                 f"end of the file")
            raw = data[at:at + nbytes]
        else:
            raw = val[:nbytes]
        tags[tag] = struct.unpack(bo + code * count, raw)
    return tags


def _rawmode(tags):
    """(mode, rawmode) as PIL's `_setup` keys `OPEN_INFO`, within the
    layouts taken here."""
    photo = tags.get(PHOTOMETRIC, (0,))[0]
    fill = tags.get(FILLORDER, (1,))[0]
    fmt = tags.get(SAMPLE_FORMAT, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bits = tags.get(BITS, (1,))
    extra = tags.get(EXTRA_SAMPLES, ())
    spp = tags.get(SAMPLES, (1,))[0]
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        raise ValueError("TIFF: unknown data organization")
    if photo not in (0, 1, 2, 3):
        raise _refuse(f"photometric interpretation {photo} "
                      f"({_PHOTOMETRIC.get(photo, 'unknown')})")
    if any(b != 8 for b in bits) and (len(bits) > 1 or bits[0] > 8):
        raise _refuse(f"{'/'.join(map(str, bits))}-bit samples "
                      f"(frames are 8-bit)")
    if fmt not in ((1,), (2,)) or (fmt == (2,) and (
            photo != 1 or bits != (8,))):
        raise _refuse(f"sample format {fmt}")
    n = len(bits)
    if photo in (0, 1):
        if n == 1 and bits[0] in (1, 2, 4, 8):
            base = {1: "1", 2: "L;2", 4: "L;4", 8: "L"}[bits[0]]
            return ("1" if bits[0] == 1 else "L"), \
                base + ("I" if photo == 0 else "") + ("R" if fill == 2
                                                     else "")
        if photo == 1 and n == 2 and extra == (2,) and fill == 1:
            return "LA", "LA"
    if photo == 2 and n >= 3:
        tail = {(): "", (0,): "X", (0, 0): "XX", (0, 0, 0): "XXX",
                (1,): "a", (1, 0): "aX", (1, 0, 0): "aXX", (2,): "A",
                (2, 0): "AX", (2, 0, 0): "AXX", (999,): "A"}
        if n == 3 and extra == ():
            return "RGB", "RGB" + ("R" if fill == 2 else "")
        if n == 4 and extra == () and fill == 1:
            return "RGBA", "RGBA"           # ExtraSamples missing
        if n == 3 + len(extra) and extra in tail and fill == 1:
            raw = "RGB" + tail[extra]
            return ("RGBA" if tail[extra][:1] in ("a", "A") else "RGB"), raw
    if photo == 3:
        if n == 1 and bits[0] in (1, 2, 4, 8):
            return "P", ("P" if bits[0] == 8 else f"P;{bits[0]}") + \
                ("R" if fill == 2 else "")
        if n == 2 and extra in ((0,), (2,)) and fill == 1:
            return ("PA" if extra == (2,) else "P"), \
                ("PA" if extra == (2,) else "PX")
    raise ValueError(f"TIFF: unknown pixel mode (photometric {photo}, "
                     f"{bits} bits, extra samples {extra}, fill order "
                     f"{fill})")


def _decompress(chunk: bytes, comp: int, fill: int, size: int) -> bytes:
    """One strip or tile, decompressed to its `size` bytes."""
    if comp == 1:
        return chunk[:size]
    if fill == 2:          # libtiff bit-reverses the coded bytes first
        chunk = _REVERSE[np.frombuffer(chunk, np.uint8)].tobytes()
    if comp in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(chunk, size)
        except zlib.error as e:
            raise ValueError(f"TIFF: Deflate data: {e}") from None
    else:
        buf = np.empty(size, np.uint8)
        got = _fn("tiff_lzw" if comp == 5 else "tiff_packbits")(
            chunk, len(chunk), buf.ctypes.data, size)
        if got == -3:
            raise _refuse("old-style LZW")
        if got < 0:
            raise ValueError(f"TIFF: {_CODECS[comp]} data is corrupt "
                             f"or cut short")
        out = buf[:got].tobytes()
    if len(out) < size:
        raise ValueError(f"TIFF: {_CODECS[comp]} data decodes to "
                         f"{len(out)} of the {size} bytes of a strip")
    return out


def decode_tiff(data: bytes) -> np.ndarray:
    """The TIFF file's bytes -> uint8 [H, W, 3] RGB."""
    data = bytes(data)
    if data[:4] in BIGTIFF_MAGICS:
        raise _refuse("BigTIFF")
    if data[:4] not in TIFF_MAGICS:
        raise ValueError("not a TIFF file")
    tags = _ifd(data)
    for tag, name in ((WIDTH, "ImageWidth"), (LENGTH, "ImageLength")):
        if tag not in tags:
            raise ValueError(f"TIFF: no {name} tag")
    w, h = tags[WIDTH][0], tags[LENGTH][0]
    comp = tags.get(COMPRESSION, (1,))[0]
    if comp not in _CODECS:
        raise _refuse(f"{_NAMED.get(comp, 'unknown')} compression "
                      f"({comp})")
    mode, raw = _rawmode(tags)
    fill = tags.get(FILLORDER, (1,))[0]
    bits = tags.get(BITS, (1,))[0]
    spp = tags.get(SAMPLES, (1,))[0]
    planar = tags.get(PLANAR, (1,))[0]
    predictor = tags.get(PREDICTOR, (1,))[0] if comp in (5, 8, 32946) \
        else 1
    if predictor not in (1, 2) or (predictor == 2 and bits != 8):
        raise _refuse(f"predictor {predictor} at {bits} bits")
    if planar not in (1, 2):
        raise _refuse(f"planar configuration {planar}")
    if planar == 2 and spp > 1:
        # PIL reads separate planes through a one-band unpacker a plane
        # (uncompressed) or libtiff's (compressed), which take only these
        if raw not in (("RGB", "RGBA") if comp == 1 else
                       ("RGB", "RGBA", "RGBa", "LA", "PA")) or \
                EXTRA_SAMPLES in tags and tags[EXTRA_SAMPLES] == (999,):
            raise _refuse(f"planar configuration 2 with {raw} samples")
        if comp != 1 and raw == "RGBA" and EXTRA_SAMPLES not in tags:
            raw = "RGBa"    # libtiff's planes come back unpremultiplied
    if w == 0 or h == 0:
        raise ValueError(f"TIFF of {w} x {h} pixels")
    tiled = TILE_OFFSETS in tags
    if tiled:
        tw, th = tags.get(TILE_WIDTH, (0,))[0], tags.get(TILE_LENGTH, (0,))[0]
        if not tw or not th:
            raise ValueError("TIFF: Invalid tile dimensions")
        offsets = tags[TILE_OFFSETS]
        counts = tags.get(TILE_BYTES)
    elif STRIP_OFFSETS in tags:
        tw, th = w, min(tags.get(ROWS_PER_STRIP, (h,))[0], h) or h
        offsets = tags[STRIP_OFFSETS]
        counts = tags.get(STRIP_BYTES)
    else:
        raise ValueError("TIFF: unknown data organization")
    per_chunk = 1 if planar == 2 else spp       # samples in a chunk's pixel
    row_bytes = (tw * per_chunk * bits + 7) // 8
    across, down = -(-w // tw), -(-h // th)
    planes = spp if planar == 2 else 1
    if len(offsets) < across * down * planes:
        raise ValueError(f"TIFF: {len(offsets)} strips or tiles, "
                         f"{across * down * planes} needed")
    if counts is None and comp != 1:
        raise ValueError("TIFF: no byte counts for compressed data")
    # the samples, one byte each: [planes, h, w, per_chunk]
    px = np.zeros((planes, down * th, across * tw, per_chunk), np.uint8)
    for k in range(across * down * planes):
        p, k2 = divmod(k, across * down)
        ty, tx = divmod(k2, across)
        need = min(th, h - ty * th)             # rows inside the image
        rows_here = th if tiled and comp != 1 else need
        size = rows_here * row_bytes
        start = offsets[k]
        n = size if comp == 1 else counts[k]
        if start + n > len(data):
            raise ValueError("TIFF: image data lies past the end of the "
                             "file (truncated)")
        chunk = data[start:start + n]
        buf = np.frombuffer(_decompress(chunk, comp, fill, size), np.uint8)
        rows = buf.reshape(rows_here, row_bytes)
        if comp == 1 and fill == 2:
            rows = _REVERSE[rows]
        samples = (rows if bits == 8 else unpack_bits(
            rows, tw * per_chunk, bits)).reshape(rows_here, tw, per_chunk)
        if predictor == 2:
            samples = np.cumsum(samples, axis=1, dtype=np.uint8)
        px[p, ty * th:ty * th + need, tx * tw:(tx + 1) * tw] = \
            samples[:need]
    px = px[:, :h, :w]
    px = px[0] if planes == 1 else np.moveaxis(px[..., 0], 0, -1)
    out = _to_rgb(px, mode, raw, bits, tags)
    return _orient(out, tags.get(ORIENTATION, (1,))[0])


def _to_rgb(px: np.ndarray, mode: str, raw: str, bits: int,
            tags) -> np.ndarray:
    """[h, w, samples] raw samples -> RGB, as PIL's unpacker for `raw` and
    its conversion of `mode` to RGB."""
    v = px[..., 0]
    if mode in ("1", "L"):
        if "I" in raw:                     # WhiteIsZero
            v = ((1 << bits) - 1 - v).astype(np.uint8)
        v = v * np.uint8(255 // ((1 << bits) - 1))
        return np.repeat(v[..., None], 3, -1)
    if mode == "LA":
        return np.repeat(v[..., None], 3, -1)
    if mode in ("P", "PA"):
        cmap = np.asarray(tags.get(COLORMAP, ()), np.int64) // 256
        n = 1 << bits
        if cmap.size < 3 * n:
            raise ValueError("TIFF: palette image without a full "
                             "ColorMap")
        table = np.zeros((256, 3), np.uint8)
        table[:n] = cmap[:3 * n].reshape(3, n).T.astype(np.uint8)
        return table[v]
    rgb = px[..., :3]
    if "a" in raw:                         # associated alpha
        a = px[..., 3:4].astype(np.int32)
        un = np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a, 1), 255)
        rgb = np.where(a == 255, rgb, np.where(a == 0, 0, un)).astype(
            np.uint8)
    return np.ascontiguousarray(rgb)


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """`ImageOps.exif_transpose`'s transposition for the Orientation tag."""
    ops = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: a.transpose(1, 0, 2),
           6: lambda a: np.rot90(a, -1), 7: lambda a: np.rot90(a, 2)
           .transpose(1, 0, 2), 8: lambda a: np.rot90(a, 1)}
    return np.ascontiguousarray(ops[orientation](img)) \
        if orientation in ops else img
