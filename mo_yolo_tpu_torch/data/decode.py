"""Frame decoding without PIL or cv2: PNG, JPEG and BMP files to raw uint8
[H, W, 3] RGB frames, as the JAX package's `load_image` returns them
through PIL's `.convert("RGB")` (`mo_yolo_tpu/data/loaders.py:47`).
`data/loaders.load_image` picks the decoder by the file's first bytes.

- PNG: the chunks are parsed here, Python's `zlib` inflates the image
  data, and `csrc/decode.c`'s `png_unfilter` undoes the row filters.
  Gray, gray+alpha, RGB, RGBA and palette images at 8 bits (gray and
  palette also at 1, 2 and 4, all but palette at 16), plain or
  Adam7-interlaced, convert as PIL converts them: gray repeated over three
  channels (scaled to 0-255 below 8 bits, clipped to 255 at 16 bits, as
  PIL's I;16 converts), the high byte of 16-bit gray+alpha, RGB and RGBA
  samples, alpha and tRNS dropped, the palette looked up.
- JPEG: the port's own codec, `data/jpeg.py` (`csrc/jpeg.c`), equal to
  PIL's decode pixel for pixel; `JPEG_MAGIC` routes a file to it.
- BMP: in numpy, as PIL's `BmpImagePlugin` reads it: core and 40- to
  124-byte headers, bottom-up or top-down; 1-, 4- and 8-bit palette
  images, 16-bit 555 and 565, 24- and 32-bit images, BI_BITFIELDS in the
  layouts PIL takes, RLE8 and RLE4 (PIL's run decoder, step for step);
  alpha dropped. What PIL refuses raises.
- TIFF and WebP: `data/tiff.py` and `data/webp.py`.

The C code is built by `utils/cuda_build.load_c` at first use, never at
import. Tests: `tests/test_torch_port_formats.py` and
`test_torch_port_data.py` against PIL and the JAX `load_image` on the CPU;
`chip_smoke.py`'s `jpeg`, `formats` and `val` phases on the card's host.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from mo_yolo_tpu_torch.utils import cuda_build

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8"
BMP_MAGIC = b"BM"
SRC = Path(__file__).resolve().parent / "csrc" / "decode.c"
# PNG colour type -> samples a pixel
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter():
    return cuda_build.bind(cuda_build.load_c(SRC), "png_unfilter",
                  [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int])


def unpack_bits(rows: np.ndarray, n: int, bits: int) -> np.ndarray:
    """The first `n` samples of `bits` (1, 2 or 4) bits, MSB first, of
    each byte row of `rows`, one uint8 each."""
    u = np.unpackbits(rows, axis=-1)[..., :n * bits]
    u = u.reshape(*rows.shape[:-1], n, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (u * weights).sum(-1, dtype=np.uint8)


# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_samples(raw: np.ndarray, pos: int, w: int, h: int, samples: int,
                 depth: int):
    """The (h, w, samples) samples of one filtered sub-image of `raw` at
    `pos` (uint16 at 16 bits, else uint8), and the position after it."""
    stride = (w * samples * depth + 7) // 8
    need = h * (stride + 1)
    if raw.size < pos + need:
        raise ValueError(f"PNG data holds {raw.size - pos} bytes, {h} rows "
                         f"of {stride + 1} need {need}")
    rows = np.empty((h, stride), np.uint8)
    bad = _unfilter()(raw[pos:].ctypes.data, rows.ctypes.data, h, stride,
                      max(samples * depth // 8, 1))
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type")
    if depth == 16:
        px = rows.view(">u2").astype(np.uint16)
    elif depth < 8:
        px = unpack_bits(rows, w, depth)
    else:
        px = rows
    return px.reshape(h, w, samples), pos + need


def decode_png(data: bytes) -> np.ndarray:
    """The PNG file's bytes -> uint8 [H, W, 3] RGB."""
    if data[:8] != PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, header, palette, idat = 8, None, b"", []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = body
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or len(header) != 13:
        raise ValueError("PNG without a valid IHDR chunk")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", header)
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {interlace} is not a PNG "
                         f"interlace method")
    if ctype not in _SAMPLES or depth not in (1, 2, 4, 8, 16) or \
            (depth < 8 and ctype not in (0, 3)) or \
            (depth == 16 and ctype == 3):
        raise ValueError(f"PNG colour type {ctype} at {depth} bits is not "
                         f"a PNG colour format")
    samples = _SAMPLES[ctype]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG image data is truncated or corrupt: {e}") \
            from None
    if not interlace:
        px = _png_samples(raw, 0, w, h, samples, depth)[0]
    else:
        px = np.zeros((h, w, samples), np.uint16 if depth == 16
                      else np.uint8)
        at = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:      # an empty pass has no rows at all
                px[y0::dy, x0::dx], at = _png_samples(raw, at, pw, ph,
                                                      samples, depth)
    if ctype == 3:
        if len(palette) // 3 > 256:     # PIL's putpalette refuses it
            raise ValueError(f"PNG palette of {len(palette)} bytes: invalid "
                             f"palette size")
        table = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(palette, np.uint8)
        entries = entries[:entries.size // 3 * 3].reshape(-1, 3)[:256]
        table[:len(entries)] = entries
        return table[px[..., 0]]
    if depth == 16:
        # PIL opens 16-bit grey as I;16, whose RGB conversion clips to 255;
        # grey+alpha, RGB and RGBA keep each sample's high byte
        px = np.minimum(px, 255).astype(np.uint8) if ctype == 0 else \
            (px >> 8).astype(np.uint8)
    if ctype in (0, 4):
        gray = px[..., 0]
        if depth < 8:
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(gray[..., None], 3, -1)
    return np.ascontiguousarray(px[..., :3])


# PIL's BMP readers: bits -> raw mode; the bit-field layouts it takes
# (red, green, blue[, alpha] masks) -> raw mode
_BMP_RAW = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR",
            32: "BGRX"}
_BMP_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_BMP_BITS_OF = {"1": 1, "P;1": 1, "P;4": 4, "L": 8, "P": 8, "BGR;15": 16,
                "BGR;16": 16, "BGR": 24}


def _bmp_rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> bytes:
    """PIL's `BmpRleDecoder`, step for step: one index a pixel, rows in
    file order. Runs past the row's end are cut; end-of-line pads the row
    with zeros; a delta reads two bytes and then the next two as its
    (right, up), as PIL reads it; absolute runs are word-aligned (RLE4's
    take byte_count // 2 bytes, two pixels each)."""
    out = bytearray()
    x, need, n = 0, w * h, len(data)
    while len(out) < need:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:                                  # encoded run
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                pair = bytes((byte >> 4, byte & 0x0F))
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes((byte,)) * count
            x += count
        elif byte == 0:                            # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:                            # end of bitmap
            break
        elif byte == 2:                            # delta
            if pos + 2 > n:
                break
            if pos + 4 > n:
                raise ValueError("BMP RLE delta cut short")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * w)
            x = len(out) % w
        else:                                      # absolute run
            count = byte // 2 if rle4 else byte
            run = data[pos:pos + count]
            pos += len(run)
            if rle4:
                b = np.frombuffer(run, np.uint8)
                out += np.stack([b >> 4, b & 0x0F], 1).tobytes()
            else:
                out += run
            if len(run) < count:
                break
            x += byte
            pos += pos % 2                         # word alignment
    return bytes(out)


def decode_bmp(data: bytes) -> np.ndarray:
    """The BMP file's bytes -> uint8 [H, W, 3] RGB, as PIL's
    `BmpImagePlugin` reads it: core (12-byte) and 40- to 124-byte headers;
    1-, 4- and 8-bit palette images (a palette that is the grey ramp read
    as grey, as PIL ditches it), 16-bit 555 and 565, 24- and 32-bit
    images, bit fields in PIL's layouts, RLE8 and RLE4. What PIL refuses
    raises."""
    if data[:2] != BMP_MAGIC or len(data) < 18:
        raise ValueError("not a BMP file")
    offset, header = struct.unpack("<II", data[10:18])
    body = data[18:14 + header]
    if len(body) < header - 4:
        raise ValueError("BMP header cut short")
    pos = 14 + header
    if header == 12:
        w, h, _, bits = struct.unpack("<HHHH", body[:8])
        comp, colors, pad, direction = 0, 0, 3, -1
    elif header in (40, 52, 56, 64, 108, 124):
        w, h, _, bits, comp = struct.unpack("<IIHHI", body[:16])
        colors = struct.unpack("<I", body[28:32])[0]
        pad, direction = 4, -1
        if body[7] == 0xFF:                        # negative height: top-down
            h, direction = 2 ** 32 - h, 1
        if comp == 3:
            if len(body) >= 48:
                n = 4 if len(body) >= 52 else 3
                masks = struct.unpack(f"<{n}I", body[36:36 + 4 * n])
            else:
                masks = struct.unpack("<3I", data[pos:pos + 12])
                pos += 12
            masks = (tuple(masks) + (0,))[:4]
    else:
        raise ValueError(f"Unsupported BMP header type ({header})")
    colors = colors or (1 << bits)
    if offset == 14 + header and bits <= 8:
        offset += 4 * colors
    if bits not in _BMP_RAW:
        raise ValueError(f"Unsupported BMP pixel depth ({bits})")
    raw, mode = _BMP_RAW[bits], "P" if bits <= 8 else "RGB"
    if comp == 3:
        key = (bits, masks) if bits == 32 else (bits, masks[:3])
        if bits not in (16, 24, 32) or key not in _BMP_MASKS:
            raise ValueError("Unsupported BMP bitfields layout")
        raw = _BMP_MASKS[key]
    elif comp not in (0, 1, 2):
        raise ValueError(f"Unsupported BMP compression ({comp})")
    table = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"Unsupported BMP Palette size ({colors})")
        palette = data[pos:pos + pad * colors]
        indices = (0, 255) if colors == 2 else range(colors)
        if all(palette[i * pad:i * pad + 3] == bytes((v,)) * 3
               for i, v in enumerate(indices)):
            mode = raw = "1" if colors == 2 else "L"
        else:
            entries = len(palette) // pad
            if entries > 256:
                raise ValueError(f"BMP palette of {entries} entries: at "
                                 f"most 256 are taken")
            # an index past the file's entries converts to black, as in PIL
            table = np.zeros((256, 3), np.uint8)
            table[:entries] = np.frombuffer(
                palette, np.uint8, entries * pad).reshape(-1, pad)[:, 2::-1]
    if w == 0 or h == 0:
        raise ValueError(f"BMP of {w} x {h} pixels")
    if comp in (1, 2):
        rle = _bmp_rle(data, offset, w, h, comp == 2)
        raw = "L" if mode == "L" else "P"
        if mode == "1":
            raise ValueError("RLE BMP with a black-and-white palette: PIL "
                             "has no P unpacker for its 1-bit mode")
        if len(rle) < w * h:
            raise ValueError("not enough image data")
        px = np.frombuffer(rle, np.uint8, w * h).reshape(h, w)
    else:
        rbits = _BMP_BITS_OF.get(raw, 32)
        row = (w * rbits + 7) // 8
        stride = ((w * bits + 31) >> 3) & ~3
        if raw in ("L", "P"):
            # PIL maps an L or P file's rows straight from the file (its
            # mmap path): h strides must lie in the file; a row may run
            # into the next one
            need = h * stride
        elif stride < row:
            raise ValueError(f"BMP rows of {stride} bytes hold no {w} "
                             f"pixels of {rbits} bits (codec configuration "
                             f"error)")
        else:
            # PIL's raw decoder: the last row needs no padding
            need = (h - 1) * stride + row
        if len(data) < offset + need:
            raise ValueError(f"BMP data holds {len(data) - offset} bytes, "
                             f"{h} rows need {need}")
        buf = np.frombuffer(data[offset:offset + need] +
                            bytes(max(row - stride, 0) + stride), np.uint8)
        rows = np.lib.stride_tricks.as_strided(
            buf, (h, row), (stride, 1)).copy()
        if rbits < 8:
            px = unpack_bits(rows, w, rbits)
        elif rbits == 8:
            px = rows
        else:
            px = rows.reshape(h, w, rbits // 8)
    if direction == -1:                            # rows stored bottom-up
        px = px[::-1]
    if mode == "1":
        return np.repeat((px * np.uint8(255))[..., None], 3, -1)
    if mode == "L":
        return np.repeat(px[..., None], 3, -1)
    if mode == "P":
        return table[px]
    if raw in ("BGR;15", "BGR;16"):
        v = px[..., 0].astype(np.int32) | (px[..., 1].astype(np.int32) << 8)
        g6 = raw == "BGR;16"
        out = np.empty((h, w, 3), np.uint8)
        out[..., 2] = (v & 31) * 255 // 31
        out[..., 1] = ((v >> 5) & (63 if g6 else 31)) * 255 // \
            (63 if g6 else 31)
        out[..., 0] = ((v >> (11 if g6 else 10)) & 31) * 255 // 31
        return out
    return np.ascontiguousarray(px[..., [raw.index(c) for c in "RGB"]])
