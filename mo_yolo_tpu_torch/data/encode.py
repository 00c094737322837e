"""Image files without PIL or cv2: uint8 [H, W, 3] RGB (or [H, W] gray)
arrays to PNG and JPEG files, chosen by the name's suffix.

- PNG: written here with stdlib `zlib` at level 1 (8-bit, no interlace,
  every row filtered with Sub; level 1 deflates an annotated 1080p frame
  in less than half the time of PIL's level 6, for files ~20 % larger);
  `data/decode.py` and PIL read it back.
- JPEG: the port's own encoder (`data/jpeg.py`) at quality 75, PIL's
  default: the bytes of PIL's `save(path)`, byte for byte.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

from mo_yolo_tpu_torch.data.jpeg import encode_jpeg

JPEG_SUFFIXES = (".jpg", ".jpeg")
SUFFIXES = (".png",) + JPEG_SUFFIXES
JPEG_QUALITY = 75


def _suffix(path) -> str:
    suffix = Path(path).suffix.lower()
    if suffix not in SUFFIXES:
        raise ValueError(f"{path}: images are written as {SUFFIXES}, not "
                         f"{suffix or 'a name without a suffix'}")
    return suffix


def check_writable(path) -> None:
    """Raise now if an image named `path` could not be written: a suffix
    not taken."""
    _suffix(path)


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """The PNG file's bytes of uint8 [H, W, 3] RGB or [H, W] gray `img`."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        ctype, ch = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, ch = 2, 3
    else:
        raise ValueError(f"expected [H, W, 3] or [H, W], got {img.shape}")
    h, w = img.shape[:2]
    x = img.reshape(h, w * ch)
    rows = np.empty((h, 1 + w * ch), np.uint8)
    rows[:, 0] = 1                                     # Sub
    rows[:, 1:1 + ch] = x[:, :ch]
    rows[:, 1 + ch:] = x[:, ch:] - x[:, :-ch]          # wraps mod 256

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))
    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) +
            chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) +
            chunk(b"IEND", b""))


def write_image(path: Union[str, Path], img: np.ndarray) -> str:
    """Write `img` to `path` as its suffix says (.png, .jpg, .jpeg);
    creates the folder. Returns the path."""
    suffix = _suffix(path)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if suffix == ".png":
        Path(path).write_bytes(encode_png(img))
        return str(path)
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] or [H, W], got {img.shape}")
    Path(path).write_bytes(encode_jpeg(img, JPEG_QUALITY))
    return str(path)
