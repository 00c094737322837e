"""Image-size parsing, the host letterbox and box rescaling (the port's own
copies of `to_hw`, `rect_hw`, `letterbox` and `boxes_to_original` from
`mo_yolo_tpu/data/letterbox.py`).

`letterbox` is the dataset's: it keeps the aspect, pads with 114 and
resizes on the host, as the JAX package does with PIL's
`Image.resize(BILINEAR)`. `resample` is PIL's resize exactly: its
arithmetic (the filter widened on a shrink, 22-bit fixed-point weights, a
horizontal then a vertical pass through uint8) in `csrc/resample.c`,
built with the host compiler by `utils/cuda_build.load_c` at first use.
So the letterbox, mosaic (`data/augment.py`) and the mask overlays
(`engine/results.py`, BICUBIC) equal the JAX package's byte for byte
(tests/test_torch_port_resample.py). Without a host compiler `resample`
raises, naming it. `resize_plain` is the same arithmetic in numpy, the
tests' and `chip_smoke.py`'s reference; no path of the port calls it.
The stream predictor's letterbox is another function,
`ops/preprocess.device_letterbox`: a scale-fill resize on the card
without antialiasing.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Tuple, Union

import numpy as np

from mo_yolo_tpu_torch.utils import cuda_build

ImgSize = Union[int, str, Tuple[int, int]]
SRC = Path(__file__).resolve().parent / "csrc" / "resample.c"
# PIL's filters: the C entry point's code and the filter's support
FILTERS = {"bilinear": (0, 1.0), "bicubic": (1, 2.0)}
PRECISION_BITS = 22


def to_hw(imgsz: ImgSize) -> Tuple[int, int]:
    """(H, W) from an int (square), an (h, w) pair or a "WxH" string
    ("1536x800" = W 1536, H 800)."""
    if isinstance(imgsz, str):
        if "x" in imgsz:
            w, h = (int(v) for v in imgsz.split("x"))
            return h, w
        return int(imgsz), int(imgsz)
    if isinstance(imgsz, (tuple, list)):
        h, w = imgsz
        return int(h), int(w)
    return int(imgsz), int(imgsz)


def rect_hw(orig_h: int, orig_w: int, imgsz: ImgSize,
            stride: int = 32) -> Tuple[int, int]:
    """The `rect=True` input shape: the source aspect with the long side at
    `imgsz`, each side rounded up to a multiple of `stride` (and at most
    `imgsz`)."""
    h, w = to_hw(imgsz)
    size = max(h, w)
    g = size / max(orig_h, orig_w)
    rh = int(math.ceil(orig_h * g / stride) * stride)
    rw = int(math.ceil(orig_w * g / stride) * stride)
    return min(rh, size), min(rw, size)


def resample(img: np.ndarray, hw: Tuple[int, int],
             filter: str = "bilinear") -> np.ndarray:
    """`Image.resize((w, h), BILINEAR | BICUBIC)` of uint8 HW or HWC (any
    channel count), by PIL's arithmetic in `csrc/resample.c`."""
    lib = cuda_build.load_c(SRC, libs=("m", "pthread"))
    fn = cuda_build.bind(lib, "resample_u8",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int])
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resample takes uint8 HW or HWC, not {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    oh, ow = (int(v) for v in hw)
    out = np.empty((oh, ow, *img.shape[2:]), np.uint8)
    rc = fn(img.ctypes.data, h, w, c, out.ctypes.data, oh, ow,
            FILTERS[filter][0])
    if rc:
        raise RuntimeError(f"resample_u8 failed on {img.shape} -> {hw}")
    return out


def _coeffs_plain(n_in: int, n_out: int, filter: str):
    """The first input index [n_out] and fixed-point weights [n_out, ksize]
    of resizing an axis of n_in to n_out, as `csrc/resample.c`."""
    a = -0.5
    support = FILTERS[filter][1] * max(n_in / n_out, 1.0)
    ss = 1.0 / max(n_in / n_out, 1.0)
    center = (np.arange(n_out) + 0.5) * (n_in / n_out)
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    n = np.minimum((center + support + 0.5).astype(np.int64), n_in) - xmin
    ksize = int(math.ceil(support)) * 2 + 1
    t = np.arange(ksize)
    x = np.abs((t + xmin[:, None] - center[:, None] + 0.5) * ss)
    if filter == "bilinear":
        w = np.where(x < 1.0, 1.0 - x, 0.0)
    else:
        w = np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                     np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))
    w = np.where(t < n[:, None], w, 0.0)
    ww = np.zeros(n_out)
    for j in range(ksize):          # PIL's order of summation
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    scaled = w * (1 << PRECISION_BITS)
    return xmin, np.where(w < 0, -0.5 + scaled, 0.5 + scaled).astype(np.int64)


def _pass_plain(a: np.ndarray, axis: int, n_out: int, filter: str):
    xmin, k = _coeffs_plain(a.shape[axis], n_out, filter)
    shape = [1] * a.ndim
    shape[axis] = n_out
    acc = np.full(a.shape[:axis] + (n_out,) + a.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int64)
    for j in range(k.shape[1]):     # a weight past the taps is 0
        idx = np.minimum(xmin + j, a.shape[axis] - 1)
        acc += np.take(a, idx, axis=axis) * k[:, j].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255)


def resize_plain(img: np.ndarray, hw: Tuple[int, int],
                 filter: str = "bilinear") -> np.ndarray:
    """`resample`'s plain version: the same arithmetic in numpy."""
    a = np.asarray(img, np.uint8).astype(np.int64)
    oh, ow = (int(v) for v in hw)
    if ow != a.shape[1]:
        a = _pass_plain(a, 1, ow, filter)
    if oh != a.shape[0]:
        a = _pass_plain(a, 0, oh, filter)
    return a.astype(np.uint8)


def _resize(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """uint8 HWC -> uint8 HWC at (h, w): PIL's BILINEAR resize."""
    if img.shape[:2] == tuple(hw):
        return img
    return resample(img, hw, "bilinear")


def letterbox(img: np.ndarray, new_shape: Tuple[int, int] = (640, 640),
              scale_fill: bool = False, scaleup: bool = True,
              pad_value: int = 114):
    """img: uint8 HWC RGB. Returns (out uint8 HWC, gain, (pad_x, pad_y)).

    scale_fill=True stretches to `new_shape` without keeping the aspect;
    otherwise the image is scaled by the smaller gain (never above 1 when
    `scaleup` is False) and centred on a `pad_value` background."""
    h, w = img.shape[:2]
    nh, nw = new_shape
    if scale_fill:
        return _resize(img, (nh, nw)), (nw / w, nh / h), (0.0, 0.0)
    gain = min(nh / h, nw / w)
    if not scaleup:
        gain = min(gain, 1.0)
    uw, uh = round(w * gain), round(h * gain)
    out = np.full((nh, nw, img.shape[2]), pad_value, img.dtype)
    px, py = (nw - uw) // 2, (nh - uh) // 2
    out[py:py + uh, px:px + uw] = _resize(img, (uh, uw))
    return out, (gain, gain), (px, py)


def boxes_to_original(boxes_xyxy: np.ndarray, meta: dict) -> np.ndarray:
    """Map xyxy boxes from model-input pixels back to original pixels."""
    oh, ow = meta["orig_shape"]
    if meta["scale_fill"]:
        gx, gy = meta["gain"]
        out = boxes_xyxy / np.array([gx, gy, gx, gy])
    else:
        g = meta["gain"][0]
        px, py = meta["pad"]
        out = (boxes_xyxy - np.array([px, py, px, py])) / g
    out[..., [0, 2]] = np.clip(out[..., [0, 2]], 0, ow)
    out[..., [1, 3]] = np.clip(out[..., [1, 3]], 0, oh)
    return out
