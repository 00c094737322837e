"""The port's JPEG codec: `csrc/jpeg.c`, built with the host compiler by
`utils/cuda_build.load_c` at first use (no libjpeg, no PIL, no other
library).

- `decode_jpeg(data)` -> uint8 [H, W, 3] RGB, pixel for pixel what the JAX
  package's `load_image` gets from PIL (`Image.open(...).convert("RGB")`):
  baseline and extended Huffman (SOF0, SOF1), progressive (SOF2) and
  arithmetic-coded (SOF9, SOF10, with DAC conditioning) files; grey,
  three components, or four (CMYK, YCCK: libjpeg's CMYK read by PIL as
  CMYK;I, then PIL's cmyk2rgb) at any sampling factors libjpeg takes;
  restart markers; progressive files whose scans leave coefficients
  unrefined block-smoothed as libjpeg-turbo 2.1+ smooths them; a DNL
  marker after a known height skipped. A file whose data ends before the
  image is complete raises where PIL raises ("image file is truncated"),
  and an arithmetic-coded file whose data runs past the 64 KiB PIL feeds
  libjpeg first raises as PIL does ("broken data stream"): that decoder
  cannot suspend. Lossless (SOF3, SOF11), 12-bit, hierarchical files and
  a height left to DNL raise, naming what is not taken.
- `decode_jpeg_tiff(tables, chunk, w, h, ncomp, ycc)` -> uint8 [h, w,
  ncomp]: a strip or tile of a JPEG-compressed TIFF as libtiff drives
  libjpeg (the JPEGTables first, no colour conversion, or YCbCr -> RGB).
- `encode_jpeg(img, quality=75)` -> the bytes of PIL's `save(buf, "JPEG",
  quality=quality)` of a uint8 [H, W, 3] RGB image (JFIF, 4:2:0, baseline,
  standard tables), byte for byte.

Every error is a `ValueError` with the codec's message; nothing falls back
to another decoder. The C calls release the GIL and share no state, so the
dataset's worker threads decode at once. On the CPU,
`tests/test_torch_port_jpeg.py` and `tests/test_torch_port_codecs.py` hold
every case to the JAX package's `load_image`; on the card's host,
`chip_smoke.py`'s `jpeg` phase holds the fixtures to PIL's digests.
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


def decode_jpeg_tiff(tables: bytes, chunk: bytes, w: int, h: int,
                     ncomp: int, ycc: bool = False) -> np.ndarray:
    """One strip or tile of a JPEG-compressed TIFF -> uint8 [h, w, ncomp]:
    the JPEGTables stream `tables` (may be empty) read first, then the
    strip's stream, as libtiff drives libjpeg (no colour conversion, or
    YCbCr -> RGB where `ycc`)."""
    tables, chunk = bytes(tables), bytes(chunk) + b"\xff\xd9"
    err = ctypes.create_string_buffer(ERR_LEN)
    out = np.empty((h, w, ncomp), np.uint8)
    decode = _fn("jpeg_decode_tiff", [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p])
    if decode(tables, len(tables), chunk, len(chunk) - 2, out.ctypes.data,
              w, h, ncomp, int(ycc), err) != 0:
        raise ValueError(f"TIFF: JPEG: {_message(err)}")
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
