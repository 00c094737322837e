"""Frame decoding without PIL or cv2: PNG, JPEG and BMP files to raw uint8
[H, W, 3] RGB frames, as the JAX package's `load_image` returns them
through PIL's `.convert("RGB")` (`mo_yolo_tpu/data/loaders.py:47`).
`data/loaders.load_image` picks the decoder by the file's first bytes.

- PNG: the chunks are parsed here, Python's `zlib` inflates the image
  data, and `csrc/decode.c`'s `png_unfilter` undoes the row filters.
  Gray, gray+alpha, RGB, RGBA and palette images at 8 bits (gray and
  palette also at 1, 2 and 4) convert as PIL converts them: gray repeated
  over three channels (scaled to 0-255 below 8 bits), alpha dropped, the
  palette looked up. 16-bit and interlaced images raise.
- JPEG: the port's own codec, `data/jpeg.py` (`csrc/jpeg.c`), equal to
  PIL's decode pixel for pixel; `JPEG_MAGIC` routes a file to it.
- BMP: uncompressed 24- and 32-bit images (BI_RGB, or BI_BITFIELDS with
  byte-aligned masks), bottom-up or top-down, rows padded to 4 bytes, in
  numpy; the fourth byte of a 32-bit pixel is dropped, as PIL's RGB
  conversion drops it. Palette, 16-bit and run-length BMPs raise.
The C code is built by `utils/cuda_build.load_c` at first use, never at
import.
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
    if depth == 16:
        raise ValueError("16-bit PNG is not taken: frames are 8-bit")
    if interlace:
        raise ValueError("interlaced PNG is not taken")
    if ctype not in _SAMPLES or depth not in (1, 2, 4, 8) or \
            (depth < 8 and ctype not in (0, 3)):
        raise ValueError(f"PNG colour type {ctype} at {depth} bits is not "
                         f"a PNG colour format")
    samples = _SAMPLES[ctype]
    stride = (w * samples * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, {h} rows of "
                         f"{stride + 1} need {h * (stride + 1)}")
    rows = np.empty((h, stride), np.uint8)
    bad = _unfilter()(raw.ctypes.data, rows.ctypes.data, h, stride,
                      max(samples * depth // 8, 1))
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type")
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :w * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (bits.reshape(h, w, depth) * weights).sum(-1, dtype=np.uint8)
    else:
        px = rows.reshape(h, w, samples)
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(palette, np.uint8)
        entries = entries[:entries.size // 3 * 3].reshape(-1, 3)[:256]
        table[:len(entries)] = entries
        return table[px if depth < 8 else px[..., 0]]
    if ctype in (0, 4):
        gray = px if depth < 8 else px[..., 0]
        if depth < 8:
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(gray[..., None], 3, -1)
    return np.ascontiguousarray(px[..., :3])


def decode_bmp(data: bytes) -> np.ndarray:
    """The BMP file's bytes -> uint8 [H, W, 3] RGB."""
    if data[:2] != BMP_MAGIC or len(data) < 54:
        raise ValueError("not a BMP file")
    offset, header = struct.unpack("<I", data[10:14])[0], \
        struct.unpack("<I", data[14:18])[0]
    if header < 40:
        raise ValueError(f"BMP with a {header}-byte core header is not taken")
    w, h, _, bits, comp = struct.unpack("<iiHHI", data[18:34])
    if bits not in (24, 32) or comp not in (0, 3) or (comp == 3 and
                                                     bits != 32):
        raise ValueError(f"BMP of {bits} bits, compression {comp}, is not "
                         f"taken: only uncompressed 24- and 32-bit images")
    if w <= 0 or h == 0:
        raise ValueError(f"BMP of {w} x {h} pixels")
    rows, step = abs(h), bits // 8
    stride = (w * step + 3) // 4 * 4
    if len(data) < offset + rows * stride:
        raise ValueError(f"BMP data holds {len(data) - offset} bytes, "
                         f"{rows} rows of {stride} need {rows * stride}")
    px = np.frombuffer(data, np.uint8, rows * stride, offset).reshape(
        rows, stride)[:, :w * step].reshape(rows, w, step)
    if h > 0:                       # rows stored bottom-up
        px = px[::-1]
    if comp == 0:
        return np.ascontiguousarray(px[..., 2::-1])
    # BI_BITFIELDS: red, green and blue masks after the 40-byte header
    masks = struct.unpack("<III", data[54:66])
    word = px.astype(np.uint32) << np.arange(0, 32, 8, dtype=np.uint32)
    word = word.sum(-1, dtype=np.uint32)
    out = np.empty((rows, w, 3), np.uint8)
    for c, m in enumerate(masks):
        shift = (m & -m).bit_length() - 1
        if m == 0 or m >> shift != 0xFF:
            raise ValueError(f"BMP channel mask {m:#x} is not one byte")
        out[..., c] = (word >> shift) & 0xFF
    return out
