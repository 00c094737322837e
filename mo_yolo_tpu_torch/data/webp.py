"""WebP frames without PIL or libwebp: a WebP file to uint8 [H, W, 3] RGB,
pixel for pixel what the JAX package's `load_image` gets from PIL, which
opens every WebP through libwebp's `WebPAnimDecoder` and drops the alpha
(`Image.open(...).convert("RGB")`).

The RIFF container is read here, as libwebp's demuxer reads it: a simple
file (`VP8 ` or `VP8L`), or `VP8X` with `ALPH`, `ICCP`, `EXIF`, `XMP ` and
unknown chunks skipped; an animated file gives its first frame on a
zero-filled canvas at the frame's offset, as the animation decoder's first
(key) frame. The bitstreams decode in `csrc/webp.c` (built by
`utils/cuda_build.load_c` at first use, never at import). A file shorter
than its RIFF size raises, as the demuxer refuses it; so does a frame that
does not fit its canvas. Every error is a ValueError; nothing falls back
to another decoder.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np

from mo_yolo_tpu_torch.utils import cuda_build

SRC = Path(__file__).resolve().parent / "csrc" / "webp.c"
ERR_LEN = 256
_ANIMATION_FLAG = 0x02


def is_webp(data: bytes) -> bool:
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def _fn(symbol, argtypes, restype=ctypes.c_int):
    return cuda_build.bind(cuda_build.load_c(SRC), symbol, argtypes, restype)


def _chunks(data: bytes, pos: int, end: int):
    """(fourcc, payload) of the chunks in data[pos:end], each padded to an
    even size; a chunk past `end` raises."""
    while pos + 8 <= end:
        fourcc, size = data[pos:pos + 4], struct.unpack(
            "<I", data[pos + 4:pos + 8])[0]
        if pos + 8 + size > end:
            raise ValueError(f"WebP: chunk {fourcc!r} runs past the end of "
                             f"the file (truncated)")
        yield fourcc, data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)


def _u24(b: bytes, at: int) -> int:
    return b[at] | (b[at + 1] << 8) | (b[at + 2] << 16)


def _frame(chunks):
    """The first image bitstream among `chunks`: (kind, payload)."""
    for fourcc, body in chunks:
        if fourcc in (b"VP8 ", b"VP8L"):
            return fourcc, body
    raise ValueError("WebP: no VP8 or VP8L image data")


def _size(kind: bytes, body: bytes):
    w, h = ctypes.c_int(), ctypes.c_int()
    info = _fn("webp_vp8l_info" if kind == b"VP8L" else "webp_vp8_info",
               [ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)])
    if info(body, len(body), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise ValueError(f"WebP: bad {kind.decode().strip()} header")
    return w.value, h.value


def decode_webp(data: bytes) -> np.ndarray:
    """The WebP file's bytes -> uint8 [H, W, 3] RGB."""
    data = bytes(data)
    if len(data) < 12 or not is_webp(data):
        raise ValueError("not a WebP file")
    riff = struct.unpack("<I", data[4:8])[0]
    if riff < 12 or riff & 1:
        raise ValueError(f"WebP: bad RIFF size {riff}")
    end = riff + 8
    if len(data) < end:
        raise ValueError(f"WebP: the file holds {len(data)} of its {end} "
                         f"bytes (truncated)")
    chunks = list(_chunks(data, 12, end))
    if not chunks:
        raise ValueError("WebP: no chunks")
    x_off = y_off = 0
    first, head = chunks[0]
    if first == b"VP8X":
        if len(head) < 10:
            raise ValueError("WebP: VP8X chunk too small")
        flags = head[0]
        canvas_w, canvas_h = _u24(head, 4) + 1, _u24(head, 7) + 1
        if flags & _ANIMATION_FLAG:
            anmf = next((b for f, b in chunks[1:] if f == b"ANMF"), None)
            if anmf is None or len(anmf) < 16:
                raise ValueError("WebP: animation without a frame")
            x_off, y_off = 2 * _u24(anmf, 0), 2 * _u24(anmf, 3)
            fw, fh = _u24(anmf, 6) + 1, _u24(anmf, 9) + 1
            kind, body = _frame(_chunks(anmf, 16, len(anmf)))
        else:
            kind, body = _frame(chunks[1:])
            fw, fh = canvas_w, canvas_h
    elif first in (b"VP8 ", b"VP8L"):
        kind, body = first, head
        fw, fh = canvas_w, canvas_h = _size(kind, body)
    else:
        raise ValueError(f"WebP: first chunk {first!r} is not an image")
    w, h = _size(kind, body)
    if (w, h) != (fw, fh):
        raise ValueError(f"WebP: the bitstream is {w} x {h}, its frame "
                         f"{fw} x {fh}")
    if w == 0 or h == 0 or x_off + w > canvas_w or y_off + h > canvas_h:
        raise ValueError(f"WebP: a {w} x {h} frame at ({x_off}, {y_off}) "
                         f"does not fit the {canvas_w} x {canvas_h} canvas")
    out = np.zeros((canvas_h, canvas_w, 3), np.uint8)
    err = ctypes.create_string_buffer(ERR_LEN)
    decode = _fn("webp_vp8l_decode" if kind == b"VP8L" else
                 "webp_vp8_decode",
                 [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p])
    at = out.ctypes.data + (y_off * canvas_w + x_off) * 3
    if decode(body, len(body), at, canvas_w * 3, w, h, err) != 0:
        raise ValueError(f"WebP: {err.value.decode(errors='replace')}")
    return out
