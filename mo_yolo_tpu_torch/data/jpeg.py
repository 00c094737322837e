"""The port's JPEG codec: `csrc/jpeg.c`, built with the host compiler by
`utils/cuda_build.load_c` at first use (no libjpeg, no PIL, no other
library).

- `decode_jpeg(data)` -> uint8 [H, W, 3] RGB, pixel for pixel what the JAX
  package's `load_image` gets from PIL (`Image.open(...).convert("RGB")`):
  baseline and extended Huffman (SOF0, SOF1) and progressive (SOF2) files,
  grey or three components at any sampling factors libjpeg takes, restart
  markers. A file whose data ends before the image is complete raises
  where PIL raises ("image file is truncated"). Arithmetic coding,
  lossless, 12-bit, hierarchical, DNL, CMYK/YCCK and progressive files that
  libjpeg would block-smooth raise, naming what is not taken.
- `encode_jpeg(img, quality=75)` -> the bytes of PIL's `save(buf, "JPEG",
  quality=quality)` of a uint8 [H, W, 3] RGB image (JFIF, 4:2:0, baseline,
  standard tables), byte for byte.

Every error is a `ValueError` with the codec's message; nothing falls back
to another decoder. The C calls release the GIL and share no state, so the
dataset's worker threads decode at once.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from mo_yolo_tpu_torch.utils import cuda_build

SRC = Path(__file__).resolve().parent / "csrc" / "jpeg.c"
ERR_LEN = 256
_INT_P = ctypes.POINTER(ctypes.c_int)


def _fn(symbol, argtypes, restype=ctypes.c_int):
    return cuda_build.bind(cuda_build.load_c(SRC), symbol, argtypes, restype)


def _message(err) -> str:
    return err.value.decode(errors="replace")


def decode_jpeg(data: bytes) -> np.ndarray:
    """The JPEG file's bytes -> uint8 [H, W, 3] RGB (a grey JPEG repeated
    over the three channels)."""
    data = bytes(data)
    err = ctypes.create_string_buffer(ERR_LEN)
    w, h = ctypes.c_int(), ctypes.c_int()
    info = _fn("jpeg_info", [ctypes.c_char_p, ctypes.c_size_t, _INT_P,
                             _INT_P, ctypes.c_char_p])
    if info(data, len(data), ctypes.byref(w), ctypes.byref(h), err) != 0:
        raise ValueError(f"JPEG: {_message(err)}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    decode = _fn("jpeg_decode", [ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_char_p])
    if decode(data, len(data), out.ctypes.data, w.value, h.value, err) != 0:
        raise ValueError(f"JPEG: {_message(err)}")
    return out


def encode_jpeg(img: np.ndarray, quality: int = 75) -> bytes:
    """The bytes of uint8 [H, W, 3] RGB `img` as a JPEG at `quality` (0-100;
    0 encodes as 1, as libjpeg clamps it)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"a JPEG is written from uint8 [H, W, 3] RGB, got "
                         f"{img.dtype} {img.shape}")
    if isinstance(quality, bool) or not isinstance(
            quality, (int, np.integer)) or not 0 <= int(quality) <= 100:
        raise ValueError(f"JPEG quality is an integer in 0-100, not "
                         f"{quality!r}")
    img = np.ascontiguousarray(img)
    err = ctypes.create_string_buffer(ERR_LEN)
    buf = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    encode = _fn("jpeg_encode", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int,
                                 ctypes.POINTER(ctypes.POINTER(
                                     ctypes.c_uint8)),
                                 ctypes.POINTER(ctypes.c_size_t),
                                 ctypes.c_char_p])
    if encode(img.ctypes.data, img.shape[0], img.shape[1], int(quality),
              ctypes.byref(buf), ctypes.byref(size), err) != 0:
        raise ValueError(f"JPEG: {_message(err)}")
    try:
        return ctypes.string_at(buf, size.value)
    finally:
        _fn("jpeg_free", [ctypes.c_void_p], None)(buf)
