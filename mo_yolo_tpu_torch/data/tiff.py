"""TIFF frames without PIL or libtiff: the first IFD of a TIFF or BigTIFF
file to uint8 [H, W, 3] RGB, pixel for pixel what the JAX package's
`load_image` gets from PIL (`Image.open(...).convert("RGB")`).

- Classic TIFF and BigTIFF (8-byte offsets and counts; a big-endian
  BigTIFF is read as PIL reads it, as a classic TIFF), both byte orders;
  strips or tiles; PlanarConfiguration 1 (chunky) and 2 (one plane a
  sample) for the sample layouts PIL reads that way.
- Compression: none, PackBits and LZW (`csrc/tiff.c`), CCITT RLE, Group 3
  (1-D and 2-D) and Group 4 (`csrc/ccitt.c`, libtiff's tif_fax3.c), JPEG
  (7: each strip or tile a JPEG stream after the JPEGTables, decoded by
  the port's own `csrc/jpeg.c` as libtiff drives libjpeg), ZSTD (50000,
  `csrc/zstd.c`, a Zstandard frame decoder), Deflate (8 and 32946)
  through Python's zlib and LZMA (34925) through Python's lzma, as
  libtiff's tif_zip.c and tif_lzma.c run zlib and liblzma. The C is built
  by `utils/cuda_build.load_c` at first use, never at import, and links
  nothing. FillOrder 2 where PIL takes it (the coded bytes bit-reversed
  first, as libtiff does).
- Predictors: horizontal differencing (2) at 8, 16 and 32 bits and the
  floating-point predictor (3) on float samples (libtiff's byte-plane
  shuffle), after LZW, Deflate and LZMA, as libtiff applies them.
- Samples: the layouts of PIL's `OPEN_INFO`, kept here as `OPEN_INFO`:
  1-8 bit grey, palette, grey with alpha, RGB and RGBA with extra samples
  (associated alpha unpremultiplied as PIL's `RGBa` unpacker does), 12-
  and 16-bit grey (`I;16`), signed 16-bit and 32-bit integers (`I`) and
  32-bit floats (`F`), 16-bit RGB, RGBA and CMYK, 8-bit CMYK. Where PIL
  reads a compressed strip through libtiff its byte order is the host's,
  so PIL's big-endian signed and float rawmodes read those values
  byte-swapped; this does the same. Each mode becomes RGB as PIL's
  `convert("RGB")` makes it: 16-bit and integer grey clip at 0 and 255,
  float grey truncates (NaN to 0), 16-bit colour keeps the high byte,
  CMYK goes through PIL's cmyk2rgb.
- Orientation 2-8 is applied after decoding, as PIL's TIFF loader applies
  it (`ImageOps.exif_transpose` in `load_end`).

Everything else raises a ValueError naming what is not taken, as PIL
raises on what it does not read: the codecs PIL does not decode or this
does not take (old-style JPEG, WebP, SGILog, ...), old-style LZW,
predictor 3 on integer samples, CIELab and YCbCr outside JPEG, sample
layouts outside `OPEN_INFO`. A file whose strips or tiles lie past its
end, or decode short, raises. On the CPU the tests hold every layout to
the JAX `load_image` (`tests/test_torch_port_formats.py`,
`tests/test_torch_port_codecs.py`); `chip_smoke.py`'s `formats` phase
holds the fixtures to PIL's digests on the card's host, which has no PIL.
"""

from __future__ import annotations

import ctypes
import lzma
import struct
import zlib
from pathlib import Path

import numpy as np

from mo_yolo_tpu_torch.data.decode import unpack_bits
from mo_yolo_tpu_torch.utils import cuda_build

SRC = Path(__file__).resolve().parent / "csrc" / "tiff.c"
# LittleCMS's Lab -> sRGB table as PIL's LAB conversion samples it
LAB_TABLE = Path(__file__).resolve().parent / "lab_srgb_clut.u16"
_LAB = None
CCITT_SRC = Path(__file__).resolve().parent / "csrc" / "ccitt.c"
ZSTD_SRC = Path(__file__).resolve().parent / "csrc" / "zstd.c"
TIFF_MAGICS = (b"II*\x00", b"MM\x00*")
BIGTIFF_MAGICS = (b"II+\x00", b"MM\x00+")

# tags
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILLORDER = (
    256, 257, 258, 259, 262, 266)
STRIP_OFFSETS, ORIENTATION, SAMPLES, ROWS_PER_STRIP, STRIP_BYTES = (
    273, 274, 277, 278, 279)
T4_OPTIONS, PLANAR, PREDICTOR, COLORMAP = 292, 284, 317, 320
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_BYTES = 322, 323, 324, 325
EXTRA_SAMPLES, SAMPLE_FORMAT, JPEG_TABLES = 338, 339, 347
YCBCR_COEFFICIENTS, YCBCR_SUBSAMPLING, REFERENCE_BLACK_WHITE = 529, 530, 532

# field type -> (struct code, bytes)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4),
          5: ("II", 8), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4),
          10: ("ii", 8), 11: ("f", 4), 12: ("d", 8), 13: ("I", 4),
          16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
_CODECS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3",
           4: "CCITT Group 4", 5: "LZW", 7: "JPEG", 8: "Deflate",
           32946: "Deflate", 32773: "PackBits", 34925: "LZMA",
           50000: "ZSTD"}
_NAMED = {6: "old-style JPEG", 32771: "raw-16 padding",
          32809: "ThunderScan", 34676: "SGILog", 34677: "SGILog24",
          50001: "WebP"}
_PREDICTED = (5, 8, 32946, 34925, 50000)  # codecs libtiff predicts after
_PHOTOMETRIC = {0: "WhiteIsZero", 1: "BlackIsZero", 2: "RGB", 3: "palette",
                4: "transparency mask", 5: "CMYK", 6: "YCbCr",
                8: "CIELab"}
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                    np.uint8)

# PIL's TiffImagePlugin.OPEN_INFO: (byte order, "" for both; photometric;
# sample format; fill order; bits; extra samples; mode; rawmode)
OPEN_INFO = [
    ('', 0, (1,), 1, (1,), (), '1', '1;I'),
    ('', 0, (1,), 2, (1,), (), '1', '1;IR'),
    ('', 1, (1,), 1, (1,), (), '1', '1'),
    ('', 1, (1,), 2, (1,), (), '1', '1;R'),
    ('', 0, (1,), 1, (2,), (), 'L', 'L;2I'),
    ('', 0, (1,), 2, (2,), (), 'L', 'L;2IR'),
    ('', 1, (1,), 1, (2,), (), 'L', 'L;2'),
    ('', 1, (1,), 2, (2,), (), 'L', 'L;2R'),
    ('', 0, (1,), 1, (4,), (), 'L', 'L;4I'),
    ('', 0, (1,), 2, (4,), (), 'L', 'L;4IR'),
    ('', 1, (1,), 1, (4,), (), 'L', 'L;4'),
    ('', 1, (1,), 2, (4,), (), 'L', 'L;4R'),
    ('', 0, (1,), 1, (8,), (), 'L', 'L;I'),
    ('', 0, (1,), 2, (8,), (), 'L', 'L;IR'),
    ('', 1, (1,), 1, (8,), (), 'L', 'L'),
    ('', 1, (2,), 1, (8,), (), 'L', 'L'),
    ('', 1, (1,), 2, (8,), (), 'L', 'L;R'),
    ('<', 1, (1,), 1, (12,), (), 'I;16', 'I;12'),
    ('<', 0, (1,), 1, (16,), (), 'I;16', 'I;16'),
    ('<', 1, (1,), 1, (16,), (), 'I;16', 'I;16'),
    ('>', 1, (1,), 1, (16,), (), 'I;16B', 'I;16B'),
    ('<', 1, (1,), 2, (16,), (), 'I;16', 'I;16R'),
    ('<', 1, (2,), 1, (16,), (), 'I', 'I;16S'),
    ('>', 1, (2,), 1, (16,), (), 'I', 'I;16BS'),
    ('<', 0, (3,), 1, (32,), (), 'F', 'F;32F'),
    ('>', 0, (3,), 1, (32,), (), 'F', 'F;32BF'),
    ('<', 1, (1,), 1, (32,), (), 'I', 'I;32N'),
    ('<', 1, (2,), 1, (32,), (), 'I', 'I;32S'),
    ('>', 1, (2,), 1, (32,), (), 'I', 'I;32BS'),
    ('<', 1, (3,), 1, (32,), (), 'F', 'F;32F'),
    ('>', 1, (3,), 1, (32,), (), 'F', 'F;32BF'),
    ('', 1, (1,), 1, (8, 8), (2,), 'LA', 'LA'),
    ('', 2, (1,), 1, (8, 8, 8), (), 'RGB', 'RGB'),
    ('', 2, (1,), 2, (8, 8, 8), (), 'RGB', 'RGB;R'),
    ('', 2, (1,), 1, (8, 8, 8, 8), (), 'RGBA', 'RGBA'),
    ('', 2, (1,), 1, (8, 8, 8, 8), (0,), 'RGB', 'RGBX'),
    ('', 2, (1,), 1, (8, 8, 8, 8, 8), (0, 0), 'RGB', 'RGBXX'),
    ('', 2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0), 'RGB', 'RGBXXX'),
    ('', 2, (1,), 1, (8, 8, 8, 8), (1,), 'RGBA', 'RGBa'),
    ('', 2, (1,), 1, (8, 8, 8, 8, 8), (1, 0), 'RGBA', 'RGBaX'),
    ('', 2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0), 'RGBA', 'RGBaXX'),
    ('', 2, (1,), 1, (8, 8, 8, 8), (2,), 'RGBA', 'RGBA'),
    ('', 2, (1,), 1, (8, 8, 8, 8, 8), (2, 0), 'RGBA', 'RGBAX'),
    ('', 2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0), 'RGBA', 'RGBAXX'),
    ('', 2, (1,), 1, (8, 8, 8, 8), (999,), 'RGBA', 'RGBA'),
    ('<', 2, (1,), 1, (16, 16, 16), (), 'RGB', 'RGB;16L'),
    ('>', 2, (1,), 1, (16, 16, 16), (), 'RGB', 'RGB;16B'),
    ('<', 2, (1,), 1, (16, 16, 16, 16), (), 'RGBA', 'RGBA;16L'),
    ('>', 2, (1,), 1, (16, 16, 16, 16), (), 'RGBA', 'RGBA;16B'),
    ('<', 2, (1,), 1, (16, 16, 16, 16), (0,), 'RGB', 'RGBX;16L'),
    ('>', 2, (1,), 1, (16, 16, 16, 16), (0,), 'RGB', 'RGBX;16B'),
    ('<', 2, (1,), 1, (16, 16, 16, 16), (1,), 'RGBA', 'RGBa;16L'),
    ('>', 2, (1,), 1, (16, 16, 16, 16), (1,), 'RGBA', 'RGBa;16B'),
    ('<', 2, (1,), 1, (16, 16, 16, 16), (2,), 'RGBA', 'RGBA;16L'),
    ('>', 2, (1,), 1, (16, 16, 16, 16), (2,), 'RGBA', 'RGBA;16B'),
    ('', 3, (1,), 1, (1,), (), 'P', 'P;1'),
    ('', 3, (1,), 2, (1,), (), 'P', 'P;1R'),
    ('', 3, (1,), 1, (2,), (), 'P', 'P;2'),
    ('', 3, (1,), 2, (2,), (), 'P', 'P;2R'),
    ('', 3, (1,), 1, (4,), (), 'P', 'P;4'),
    ('', 3, (1,), 2, (4,), (), 'P', 'P;4R'),
    ('', 3, (1,), 1, (8,), (), 'P', 'P'),
    ('', 3, (1,), 1, (8, 8), (0,), 'P', 'PX'),
    ('', 3, (1,), 1, (8, 8), (2,), 'PA', 'PA'),
    ('', 3, (1,), 2, (8,), (), 'P', 'P;R'),
    ('', 5, (1,), 1, (8, 8, 8, 8), (), 'CMYK', 'CMYK'),
    ('', 5, (1,), 1, (8, 8, 8, 8, 8), (0,), 'CMYK', 'CMYKX'),
    ('', 5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0), 'CMYK', 'CMYKXX'),
    ('<', 5, (1,), 1, (16, 16, 16, 16), (), 'CMYK', 'CMYK;16L'),
    ('>', 5, (1,), 1, (16, 16, 16, 16), (), 'CMYK', 'CMYK;16B'),
    ('', 6, (1,), 1, (8,), (), 'L', 'L'),
    ('', 6, (1,), 1, (8, 8, 8), (), 'RGB', 'RGBX'),
    ('', 8, (1,), 1, (8, 8, 8), (), 'LAB', 'LAB'),
]
_OPEN_INFO = {}
for _o, *_key, _mode, _raw in OPEN_INFO:
    for _bo in (_o,) if _o else ("<", ">"):
        _OPEN_INFO[(_bo, *_key)] = (_mode, _raw)
# the rawmodes that read values in the file's order, where libtiff hands
# PIL the host's (little-endian) order
_SWAPPED_BY_PIL = ("I;16BS", "I;32BS", "F;32BF")


def _fn(symbol):
    return cuda_build.bind(cuda_build.load_c(SRC), symbol,
                           [ctypes.c_char_p, ctypes.c_longlong,
                            ctypes.c_void_p, ctypes.c_longlong],
                           ctypes.c_longlong)


def _refuse(what: str):
    return ValueError(f"TIFF: {what} is not taken")


def _ifd(data: bytes, big: bool):
    """The byte order and the first IFD's tags: {tag: tuple of values}."""
    if len(data) < (16 if big else 8):
        raise ValueError("TIFF header cut short")
    bo = "<" if data[:2] == b"II" else ">"
    if big:
        size, zero, pos = struct.unpack(bo + "HHQ", data[4:16])
        if size != 8 or zero != 0:
            raise ValueError("TIFF: a BigTIFF header with offsets of "
                             f"{size} bytes")
        count_fmt, entry, inline, off_fmt = "Q", "HHQ8s", 8, "Q"
    else:
        pos = struct.unpack(bo + "I", data[4:8])[0]
        count_fmt, entry, inline, off_fmt = "H", "HHI4s", 4, "I"
    head, size = struct.calcsize(bo + count_fmt), struct.calcsize(bo + entry)
    if pos + head > len(data):
        raise ValueError("TIFF: the first IFD lies past the end of the file")
    n = struct.unpack(bo + count_fmt, data[pos:pos + head])[0]
    if pos + head + size * n > len(data):
        raise ValueError("TIFF: the first IFD is cut short")
    tags = {}
    for k in range(n):
        at0 = pos + head + size * k
        tag, typ, count, val = struct.unpack(bo + entry,
                                             data[at0:at0 + size])
        if typ not in _TYPES:
            continue
        code, tsize = _TYPES[typ]
        nbytes = tsize * count
        if nbytes > inline:
            at = struct.unpack(bo + off_fmt, val)[0]
            if at + nbytes > len(data):
                raise ValueError(f"TIFF: tag {tag}'s values lie past the "
                                 f"end of the file")
            raw = data[at:at + nbytes]
        else:
            raw = val[:nbytes]
        tags[tag] = struct.unpack(bo + code * count, raw)
    return bo, tags


def _rawmode(tags, bo, comp):
    """(mode, rawmode) as PIL's `_setup` keys `OPEN_INFO`, with the
    rawmodes it uses where libtiff decodes (every codec but none)."""
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
    key = (bo, photo, tuple(fmt), fill, tuple(bits), tuple(extra))
    if key not in _OPEN_INFO:
        raise ValueError(f"TIFF: unknown pixel mode (photometric {photo} "
                         f"({_PHOTOMETRIC.get(photo, 'unknown')}), "
                         f"{'/'.join(map(str, bits))}-bit samples, sample "
                         f"format {fmt}, extra samples {extra}, fill order "
                         f"{fill}): PIL does not read it either")
    mode, raw = _OPEN_INFO[key]
    if comp != 1:                       # libtiff's path in PIL
        if fill == 2:
            mode, raw = _OPEN_INFO[key[:3] + (1,) + key[4:]]
        planar = tags.get(PLANAR, (1,))[0]
        if photo == 6 and comp == 7 and planar == 1:
            raw = "RGB"
        elif raw == "I;16":
            raw = "I;16N"
        elif raw.endswith((";16B", ";16L")):
            raw = raw[:-1] + "N"
    return mode, raw


def _lzma(chunk: bytes, size: int) -> bytes:
    """libtiff's tif_lzma.c: an xz stream a strip or tile."""
    try:
        return lzma.LZMADecompressor(format=lzma.FORMAT_XZ).decompress(
            chunk, size)
    except lzma.LZMAError as e:
        raise ValueError(f"TIFF: LZMA data: {e}") from None


def _fax(chunk: bytes, comp: int, tags, width: int, rows: int,
         size: int) -> bytes:
    """One CCITT strip or tile to `rows` packed rows, 1 bits black."""
    t4 = tags.get(T4_OPTIONS, (0,))[0] if comp == 3 else 0
    buf = np.empty(size, np.uint8)
    fax = cuda_build.bind(
        cuda_build.load_c(CCITT_SRC), "tiff_fax",
        [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int],
        ctypes.c_longlong)
    got = fax(chunk, len(chunk), buf.ctypes.data, width, rows, comp, t4)
    if got == -2:
        raise _refuse("CCITT uncompressed mode")
    if got < 0:
        raise ValueError(f"TIFF: {_CODECS[comp]} data ends before the "
                         f"strip is complete (premature EOF)")
    return buf.tobytes()


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
    elif comp == 34925:
        out = _lzma(chunk, size)
    elif comp == 50000:
        buf = np.empty(size, np.uint8)
        got = cuda_build.bind(cuda_build.load_c(ZSTD_SRC), "tiff_zstd",
                              [ctypes.c_char_p, ctypes.c_longlong,
                               ctypes.c_void_p, ctypes.c_longlong],
                              ctypes.c_longlong)(chunk, len(chunk),
                                                 buf.ctypes.data, size)
        if got < 0:
            raise ValueError("TIFF: ZSTD data: " + {
                -2: "the content checksum does not match",
                -3: "a dictionary is needed"}.get(got, "corrupt or cut "
                                                       "short"))
        out = buf[:got].tobytes()
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


def _samples(buf: bytes, rows: int, width: int, per: int, bits: int,
             bo: str) -> np.ndarray:
    """Decoded bytes -> [rows, width, per] sample values in the file's byte
    order (what libtiff hands PIL after its swab, or PIL reads itself)."""
    row_bytes = (width * per * bits + 7) // 8
    a = np.frombuffer(buf, np.uint8)[:rows * row_bytes].reshape(rows,
                                                                row_bytes)
    n = width * per
    if bits == 8:
        s = a
    elif bits < 8:
        s = unpack_bits(a, n, bits)
    elif bits == 12:                 # PIL's I;12: two samples in 3 bytes
        b = np.concatenate([a, np.zeros((rows, 1), np.uint8)], 1).astype(
            np.uint16)
        k = np.arange(n)
        at = (k * 3) // 2
        s = np.where(k % 2 == 0, (b[:, at] << 4) | (b[:, at + 1] >> 4),
                     ((b[:, at] & 15) << 8) | b[:, at + 1])
    else:
        s = a[:, :n * bits // 8].copy().view(f"{bo}u{bits // 8}").astype(
            f"=u{bits // 8}")
    return s.reshape(rows, width, per)


def _predict_float(buf: bytes, rows: int, width: int, per: int,
                   bits: int) -> np.ndarray:
    """libtiff's fpAcc: each row's bytes summed with a stride of `per`, then
    its byte planes (most significant first) woven back into values."""
    nb = bits // 8
    wc = width * per
    a = np.frombuffer(buf, np.uint8)[:rows * wc * nb].reshape(rows, -1, per)
    a = np.cumsum(a, axis=1, dtype=np.uint8).reshape(rows, nb, wc)
    return np.ascontiguousarray(a.transpose(0, 2, 1)).view(
        f">u{nb}").astype(f"=u{nb}").reshape(rows, width, per)


def decode_tiff(data: bytes) -> np.ndarray:
    """The TIFF file's bytes -> uint8 [H, W, 3] RGB."""
    data = bytes(data)
    # PIL takes a file for BigTIFF where its third byte is 43, which holds
    # for little-endian files only: it reads a big-endian BigTIFF as a
    # classic TIFF (the IFD offset from bytes 4-7), and so does this
    big = data[:4] == BIGTIFF_MAGICS[0]
    if data[:4] not in TIFF_MAGICS + BIGTIFF_MAGICS:
        raise ValueError("not a TIFF file")
    bo, tags = _ifd(data, big)
    for tag, name in ((WIDTH, "ImageWidth"), (LENGTH, "ImageLength")):
        if tag not in tags:
            raise ValueError(f"TIFF: no {name} tag")
    w, h = tags[WIDTH][0], tags[LENGTH][0]
    comp = tags.get(COMPRESSION, (1,))[0]
    if comp not in _CODECS:
        raise _refuse(f"{_NAMED.get(comp, 'unknown')} compression "
                      f"({comp})")
    mode, raw = _rawmode(tags, bo, comp)
    fill = tags.get(FILLORDER, (1,))[0]
    bits = tags.get(BITS, (1,))[0]
    spp = tags.get(SAMPLES, (1,))[0]
    planar = tags.get(PLANAR, (1,))[0]
    fmt = tags.get(SAMPLE_FORMAT, (1,))[0]
    predictor = tags.get(PREDICTOR, (1,))[0] if comp in _PREDICTED else 1
    if predictor not in (1, 2, 3) or (predictor == 2 and bits not in (
            8, 16, 32)) or (predictor == 3 and fmt != 3):
        raise _refuse(f"predictor {predictor} at {bits} bits, sample "
                      f"format {fmt}")
    if comp in (2, 3, 4) and (bits != 1 or spp != 1):
        raise ValueError("TIFF: Bits/sample must be 1 for Group 3/4 "
                         "encoding/decoding")
    if comp == 7 and bits != 8:
        raise _refuse(f"{bits}-bit JPEG")
    if planar not in (1, 2):
        raise _refuse(f"planar configuration {planar}")
    bands = spp
    if planar == 2 and spp > 1:
        # PIL reads separate planes uncompressed through the one-band 8-bit
        # unpacker rawmode[plane], in rows of its own stride (16-bit planes
        # come out scrambled, as there); through libtiff it copies the
        # first planes, one a band of the mode, at 8 or 16 bits, and takes
        # planes beyond the mode's bands in tiles only
        bands = {"RGB": 3, "RGBA": 4, "CMYK": 4, "LA": 2, "PA": 2,
                 "LAB": 3}.get(mode, 0)
        if comp == 1:
            ok = raw in ("RGB", "RGBA", "CMYK", "LAB") or raw[:-1] in (
                "RGB;16", "RGBA;16", "CMYK;16")
        else:
            ok = bands and bits in (8, 16) and (spp == bands or
                                                 TILE_OFFSETS in tags)
        if not ok or EXTRA_SAMPLES in tags and tags[EXTRA_SAMPLES] == (999,):
            raise _refuse(f"planar configuration 2 with {raw} samples")
        if raw == "LAB":
            raw = "LAB;planes"    # a and b copied as they are, not unsigned
        if comp != 1 and raw.startswith("RGBA") and \
                EXTRA_SAMPLES not in tags:
            raw = "RGBa" + raw[4:]  # libtiff's planes come unpremultiplied
    # YCbCr through any codec but none or JPEG: PIL reads it through
    # libtiff's RGBA interface (TIFFRGBAImageGet), chroma shared by each
    # hs x vs block; uncompressed, through its own raw decoder as RGBX
    ycc = tags.get(PHOTOMETRIC, (0,))[0] == 6 and comp not in (1, 7)
    raw_rgbx = tags.get(PHOTOMETRIC, (0,))[0] == 6 and comp == 1 and \
        raw == "RGBX"
    hs, vs = tags.get(YCBCR_SUBSAMPLING, (2, 2))[:2] if ycc else (1, 1)
    if ycc and (planar != 1 or predictor != 1 or (hs, vs) not in (
            (1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))):
        raise _refuse(f"YCbCr at {hs}x{vs} sampling, planar configuration "
                      f"{planar}, predictor {predictor}")
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
    tables = bytes(tags.get(JPEG_TABLES, ())) if comp == 7 else b""
    px = None
    raw_planes = comp == 1 and planes > 1
    photo = tags.get(PHOTOMETRIC, (0,))[0]
    bits_all = tags.get(BITS, (1,)) * (spp if len(tags.get(BITS, ())) == 1
                                       else 1)
    bps_count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + len(
        tags.get(EXTRA_SAMPLES, ()))
    for k in range(across * down * min(planes, bands)):
        p, k2 = divmod(k, across * down)
        ty, tx = divmod(k2, across)
        need = min(th, h - ty * th)             # rows inside the image
        if raw_rgbx:        # PIL's raw decoder: 4 bytes a pixel, RGB kept
            ew = min(tw, w - tx * tw)
            stride = tw * 3 if tx * tw + tw > w else 4 * ew
            if offsets[k] + need * stride > len(data):
                raise ValueError("TIFF: uncompressed YCbCr, read as PIL's "
                                 "raw decoder reads it (4 bytes a pixel), "
                                 "lies past the end of the file "
                                 "(truncated)")
            rows = np.frombuffer(data, np.uint8, need * stride, offsets[k])
            if px is None:
                px = np.zeros((1, down * th, across * tw, 3), np.uint8)
            px[0, ty * th:ty * th + need, tx * tw:tx * tw + ew] = \
                rows.reshape(need, stride)[:, :4 * ew].reshape(
                    need, ew, 4)[..., :3]
            continue
        if raw_planes:                          # PIL's own raw decoder
            ew = min(tw, w - tx * tw)
            stride = int(tw * sum(bits_all) / 8 / bps_count) \
                if tx * tw + tw > w else ew
            if offsets[k] + need * stride > len(data):
                raise ValueError("TIFF: image data lies past the end of "
                                 "the file (truncated)")
            band = np.frombuffer(data, np.uint8, need * stride, offsets[k])
            if px is None:
                px = np.zeros((planes, down * th, across * tw, 1), np.uint8)
            px[p, ty * th:ty * th + need, tx * tw:tx * tw + ew, 0] = \
                band.reshape(need, stride)[:, :ew]
            continue
        rows_here = th if tiled and comp != 1 else need
        size = rows_here * row_bytes
        if ycc:             # blocks of hs x vs Y, then Cb and Cr
            size = -(-rows_here // vs) * -(-tw // hs) * (hs * vs + 2)
        start = offsets[k]
        n = size if comp == 1 else counts[k]
        if start + n > len(data):
            raise ValueError("TIFF: image data lies past the end of the "
                             "file (truncated)")
        chunk = data[start:start + n]
        if comp == 7:
            from mo_yolo_tpu_torch.data.jpeg import decode_jpeg_tiff
            samples = decode_jpeg_tiff(tables, chunk, tw, rows_here,
                                       per_chunk, ycc=tags.get(
                                           PHOTOMETRIC, (0,))[0] == 6)
        else:
            if comp in (2, 3, 4):
                if fill == 2:
                    chunk = _REVERSE[np.frombuffer(chunk, np.uint8)].tobytes()
                buf = _fax(chunk, comp, tags, tw, rows_here, size)
            else:
                buf = _decompress(chunk, comp, fill, size)
            if ycc:
                samples = _ycbcr_samples(buf, need, min(tw, w - tx * tw),
                                         tw, hs, vs, tiled)
            elif predictor == 3:
                samples = _predict_float(buf, rows_here, tw, per_chunk, bits)
            else:
                if comp == 1 and fill == 2:
                    buf = _REVERSE[np.frombuffer(buf, np.uint8)].tobytes()
                samples = _samples(buf, rows_here, tw, per_chunk, bits, bo)
                if predictor == 2:
                    samples = np.cumsum(samples, axis=1,
                                        dtype=samples.dtype)
        if px is None:
            px = np.zeros((planes, down * th, across * tw,
                           samples.shape[2]), samples.dtype)
        px[p, ty * th:ty * th + need,
           tx * tw:tx * tw + samples.shape[1]] = samples[:need]
    px = px[:, :h, :w]
    px = px[0] if planes == 1 else np.moveaxis(px[..., 0], 0, -1)
    if comp != 1 and raw in _SWAPPED_BY_PIL:
        px = px.byteswap()
    if ycc:
        out = _ycbcr_to_rgb(px, tags)
    else:
        out = _to_rgb(px, mode, raw, 8 if raw_planes else bits, tags)
    return _orient(out, tags.get(ORIENTATION, (1,))[0])


# per libtiff YCbCr put function, the samples it skips for each block's
# worth of `fromskew` pixels (putcontig8bitYCbCr44tile skips 10, not 18)
_YCC_SKEW = {(4, 4): 10, (4, 2): 10, (4, 1): 6, (2, 2): 6, (2, 1): 4,
             (1, 2): 4, (1, 1): 3}


def _ycbcr_samples(buf: bytes, rows: int, width: int, tw: int, hs: int,
                   vs: int, tiled: bool) -> np.ndarray:
    """A subsampled YCbCr strip or tile -> [rows, width, 3] Y, Cb, Cr of
    its `rows` x `width` pixels in the image, as tif_getimage.c reads it:
    each block's hs x vs Y values row by row, its Cb and Cr for all of
    them. Its quirks are kept: a strip is decoded to rows rounded up to
    vs times TIFFScanlineSize (which rounds down: the last bytes of a 4x4
    strip with an odd block count stay 0), and a tile cut by the image's
    right edge skips its hidden blocks by _YCC_SKEW."""
    bs = hs * vs + 2
    uc_all = -(-tw // hs)
    u = np.frombuffer(buf, np.uint8)
    if not tiled:
        keep = -(-rows // vs) * vs * (uc_all * bs // vs)
        u = np.concatenate([u[:keep], np.zeros(max(len(u) - keep, 0),
                                               np.uint8)])
    ur, uc = -(-rows // vs), -(-width // hs)
    step = uc * bs + ((tw - width) // hs) * _YCC_SKEW[(hs, vs)]
    need = (ur - 1) * step + uc * bs
    if len(u) < need:
        u = np.concatenate([u, np.zeros(need - len(u), np.uint8)])
    blocks = np.stack([u[r * step:r * step + uc * bs] for r in range(ur)])
    blocks = blocks.reshape(ur, uc, bs)
    y = blocks[..., :hs * vs].reshape(ur, uc, vs, hs).transpose(0, 2, 1, 3)
    chroma = np.repeat(np.repeat(blocks[..., hs * vs:], vs, 0), hs, 1)
    return np.concatenate([y.reshape(ur * vs, uc * hs, 1), chroma],
                          -1)[:rows, :width]


def _ycbcr_to_rgb(px: np.ndarray, tags) -> np.ndarray:
    """libtiff's TIFFYCbCrtoRGB with the file's YCbCrCoefficients and
    ReferenceBlackWhite, or libtiff's defaults."""
    def floats(tag, default):
        v = tags.get(tag)
        if v is None:
            return np.asarray(default, np.float32)
        return np.asarray([a / b if b else 0.0 for a, b in zip(v[::2],
                                                               v[1::2])],
                          np.float32)
    luma = floats(YCBCR_COEFFICIENTS, (0.299, 0.587, 0.114))
    refbw = floats(REFERENCE_BLACK_WHITE, (0, 255, 128, 255, 128, 255))
    if not np.isfinite(luma).all() or abs(luma[1]) < 1e-5 or \
            not np.isfinite(refbw).all():
        raise ValueError("TIFF: Invalid values for YCbCrCoefficients or "
                         "ReferenceBlackWhite tag")
    ycc = np.ascontiguousarray(px[..., :3], np.uint8)
    out = np.empty(ycc.shape, np.uint8)
    cuda_build.bind(cuda_build.load_c(SRC), "tiff_ycbcr_rgb",
                    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p], None)(
        ycc.ctypes.data, ycc.size // 3, luma.ctypes.data, refbw.ctypes.data,
        out.ctypes.data)
    return out


def _lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """PIL's `convert("RGB")` of mode LAB ([h, w, 3] uint8, a and b offset
    by 128): LittleCMS's transform, in `csrc/tiff.c` over LAB_TABLE."""
    global _LAB
    if _LAB is None:
        _LAB = np.frombuffer(LAB_TABLE.read_bytes(), "<u2").astype(np.uint16)
    lab = np.ascontiguousarray(lab, np.uint8)
    out = np.empty(lab.shape, np.uint8)
    cuda_build.bind(cuda_build.load_c(SRC), "tiff_lab_rgb",
                    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                     ctypes.c_void_p], None)(
        lab.ctypes.data, lab.size // 3, _LAB.ctypes.data, out.ctypes.data)
    return out


def _cmyk_to_rgb(px: np.ndarray) -> np.ndarray:
    """PIL's cmyk2rgb: each channel k' - c * k' / 255 (MULDIV255), with
    k' = 255 - k."""
    nk = 255 - px[..., 3:4].astype(np.int32)
    t = px[..., :3].astype(np.int32) * nk + 128
    return (nk - (((t >> 8) + t) >> 8)).astype(np.uint8)


def _to_rgb(px: np.ndarray, mode: str, raw: str, bits: int,
            tags) -> np.ndarray:
    """[h, w, samples] raw samples -> RGB, as PIL's unpacker for `raw` and
    its conversion of `mode` to RGB."""
    v = px[..., 0]
    if mode in ("I;16", "I;16B"):
        return np.repeat(np.minimum(v, 255).astype(np.uint8)[..., None], 3,
                         -1)
    if mode == "I":
        signed = v.astype(np.uint16).view(np.int16) if bits == 16 else \
            v.astype(np.uint32).view(np.int32)
        return np.repeat(np.clip(signed, 0, 255).astype(np.uint8)[..., None],
                         3, -1)
    if mode == "F":
        f = v.astype(np.uint32).view(np.float32)
        with np.errstate(invalid="ignore"):
            g = np.where(f >= 255, 255, np.where(f > 0, f, 0))
        return np.repeat(g.astype(np.uint8)[..., None], 3, -1)
    if bits == 16:                         # PIL keeps the high byte
        px = (px >> 8).astype(np.uint8)
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
    if mode == "CMYK":
        return _cmyk_to_rgb(px)
    if mode == "LAB":      # PIL's LAB unpacker makes a and b unsigned
        return _lab_to_rgb(px[..., :3] ^ np.array(
            [0, 128, 128], np.uint8) if raw == "LAB" else px[..., :3])
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
