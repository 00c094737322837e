"""Training-time image and label augmentations on the host (the port's copy
of `mo_yolo_tpu/data/augment.py`).

Labels are `[cls, cx, cy, w, h, track_id]`, normalized, and every geometric
transform keeps the track ids. The parameters are drawn from the
`np.random.Generator` given, in the JAX package's order, so that both
packages sample the same augmentation from the same seed. Where the JAX
package calls PIL, the port runs `csrc/augment.c` (built with the host
compiler by `utils/cuda_build.load_c` at first use), which repeats PIL's
arithmetic:

- the HSV, L and YCbCr conversions of `random_hsv`, `to_gray` and `clahe`
  equal PIL's on every one of the 2^24 inputs;
- `random_affine` maps each output pixel centre through the inverse matrix
  and samples bilinearly without widening the filter, as
  `Image.transform(AFFINE | PERSPECTIVE, BILINEAR)` does (the test states
  its difference against PIL);
- `blur` and `median_blur` are PIL's `BoxBlur` and `MedianFilter`;
- `jpeg_compression` is a round trip through the port's own JPEG codec
  (`data/jpeg.py`), PIL's `save(..., quality=q)` bytes decoded as PIL
  decodes them (`Photometrics`' `compression_p` is 0, so the default
  pipeline never calls it).

`mosaic4` resizes with `data/letterbox._resize`, PIL's
`resize(BILINEAR)` exactly (`csrc/resample.c`).

Geometric augmentations are sampled once per clip and applied to every
frame (`ClipAugmenter`), or track geometry decoheres across time.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from mo_yolo_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
from mo_yolo_tpu_torch.data.letterbox import _resize
from mo_yolo_tpu_torch.utils import cuda_build

SRC = Path(__file__).resolve().parent / "csrc" / "augment.c"
_CONVERSIONS = ("rgb_to_hsv", "hsv_to_rgb", "rgb_to_l", "rgb_to_ycbcr",
                "ycbcr_to_rgb")


def _lib() -> ctypes.CDLL:
    return cuda_build.load_c(SRC, libs=("m",))


def _convert(name: str, img: np.ndarray) -> np.ndarray:
    """One of `_CONVERSIONS` on uint8 [..., 3]; rgb_to_l gives [...]."""
    fn = cuda_build.bind(_lib(), name, [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int64], None)
    img = np.ascontiguousarray(img, np.uint8)
    n = img.size // 3
    out = np.empty(img.shape[:-1] if name == "rgb_to_l" else img.shape,
                   np.uint8)
    fn(img.ctypes.data, out.ctypes.data, n)
    return out


def _xywhn_to_xyxy_px(lab: np.ndarray, w: int, h: int) -> np.ndarray:
    b = lab[:, 1:5].copy()
    out = np.empty_like(b)
    out[:, 0] = (b[:, 0] - b[:, 2] / 2) * w
    out[:, 1] = (b[:, 1] - b[:, 3] / 2) * h
    out[:, 2] = (b[:, 0] + b[:, 2] / 2) * w
    out[:, 3] = (b[:, 1] + b[:, 3] / 2) * h
    return out


def _xyxy_px_to_xywhn(xyxy: np.ndarray, w: int, h: int) -> np.ndarray:
    out = np.empty_like(xyxy)
    out[:, 0] = (xyxy[:, 0] + xyxy[:, 2]) / 2 / w
    out[:, 1] = (xyxy[:, 1] + xyxy[:, 3]) / 2 / h
    out[:, 2] = (xyxy[:, 2] - xyxy[:, 0]) / w
    out[:, 3] = (xyxy[:, 3] - xyxy[:, 1]) / h
    return out


def random_hsv(img: np.ndarray, rng: np.random.Generator,
               hgain: float = 0.015, sgain: float = 0.7,
               vgain: float = 0.4) -> np.ndarray:
    """HSV jitter. img uint8 RGB."""
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hsv = _convert("rgb_to_hsv", img).astype(np.float32)
    hsv[..., 0] = (hsv[..., 0] * r[0]) % 256
    hsv[..., 1] = np.clip(hsv[..., 1] * r[1], 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] * r[2], 0, 255)
    return _convert("hsv_to_rgb", hsv.astype(np.uint8))


def random_flip_lr(img: np.ndarray, lab: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal flip; cx -> 1 - cx."""
    img = img[:, ::-1].copy()
    lab = lab.copy()
    if len(lab):
        lab[:, 1] = 1.0 - lab[:, 1]
    return img, lab


def random_flip_ud(img: np.ndarray, lab: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Vertical flip; cy -> 1 - cy."""
    img = img[::-1].copy()
    lab = lab.copy()
    if len(lab):
        lab[:, 2] = 1.0 - lab[:, 2]
    return img, lab


def warp(img: np.ndarray, coeffs, perspective: bool,
         fill: int = 114) -> np.ndarray:
    """`Image.transform((w, h), AFFINE | PERSPECTIVE, coeffs, BILINEAR,
    fillcolor=fill)` on uint8 RGB: `coeffs` map an output pixel centre to
    the input (6 affine, 8 perspective)."""
    fn = cuda_build.bind(_lib(), "warp_bilinear",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_int], None)
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    a = np.zeros(8, np.float64)
    a[:len(coeffs)] = coeffs
    out = np.empty_like(img)
    fn(img.ctypes.data, h, w, out.ctypes.data, h, w, a.ctypes.data,
       int(perspective), int(fill))
    return out


def random_affine(img: np.ndarray, lab: np.ndarray, rng: np.random.Generator,
                  degrees: float = 0.0, translate: float = 0.1,
                  scale: float = 0.5, shear: float = 0.0,
                  perspective: float = 0.0,
                  border: int = 0, min_box: float = 2.0,
                  params: Optional[dict] = None):
    """Random projective warp: rotation, scale, shear and translation about
    the centre, and the `perspective` homography row.

    Returns (img, labels, params); pass `params` back in to apply the same
    warp to another frame of the clip."""
    h, w = img.shape[:2]
    if params is None:
        a = rng.uniform(-degrees, degrees)
        s = rng.uniform(1 - scale, 1 + scale)
        shx = np.tan(np.radians(rng.uniform(-shear, shear)))
        shy = np.tan(np.radians(rng.uniform(-shear, shear)))
        tx = rng.uniform(0.5 - translate, 0.5 + translate) * w - w / 2
        ty = rng.uniform(0.5 - translate, 0.5 + translate) * h - h / 2
        px = rng.uniform(-perspective, perspective)
        py = rng.uniform(-perspective, perspective)
        params = {"a": a, "s": s, "shx": shx, "shy": shy, "tx": tx,
                  "ty": ty, "px": px, "py": py}
    a, s = params["a"], params["s"]
    px, py = params.get("px", 0.0), params.get("py", 0.0)
    ca, sa = np.cos(np.radians(a)) * s, np.sin(np.radians(a)) * s
    cx0, cy0 = w / 2, h / 2
    M = np.array([
        [ca + params["shx"] * sa, -sa + params["shx"] * ca, 0],
        [sa + params["shy"] * ca, ca - params["shy"] * sa, 0],
        [px, py, 1]], np.float64)
    M[0, 2] = cx0 - M[0, 0] * cx0 - M[0, 1] * cy0 + params["tx"]
    M[1, 2] = cy0 - M[1, 0] * cx0 - M[1, 1] * cy0 + params["ty"]
    Mi = np.linalg.inv(M)   # the warp maps output pixels to input ones
    if px == 0.0 and py == 0.0:
        img = warp(img, Mi[:2].ravel(), perspective=False)
    else:
        Mi = Mi / Mi[2, 2]
        img = warp(img, Mi.ravel()[:8], perspective=True)

    if len(lab):
        xyxy = _xywhn_to_xyxy_px(lab, w, h)
        corners = np.stack([
            xyxy[:, [0, 1]], xyxy[:, [2, 1]], xyxy[:, [0, 3]], xyxy[:, [2, 3]]],
            axis=1)  # [n,4,2]
        ones = np.ones((*corners.shape[:2], 1))
        tc = np.concatenate([corners, ones], -1) @ M.T
        tc = tc[..., :2] / np.maximum(np.abs(tc[..., 2:]), 1e-9) * \
            np.sign(tc[..., 2:])
        new = np.concatenate([tc.min(1), tc.max(1)], 1)  # [n,4] xyxy
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, w)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, h)
        keep = ((new[:, 2] - new[:, 0]) > min_box) & \
               ((new[:, 3] - new[:, 1]) > min_box)
        lab = lab[keep].copy()
        if len(lab):
            lab[:, 1:5] = _xyxy_px_to_xywhn(new[keep], w, h)
    return img, lab, params


def mosaic4(imgs: List[np.ndarray], labs: List[np.ndarray],
            rng: np.random.Generator, size: int = 640):
    """4-image mosaic: a 2x2 grid around a random centre on a 2*size
    canvas, then the centre crop of `size`."""
    s2 = size * 2
    canvas = np.full((s2, s2, 3), 114, np.uint8)
    cx = int(rng.uniform(size * 0.5, size * 1.5))
    cy = int(rng.uniform(size * 0.5, size * 1.5))
    out_labs = []
    placements = [(0, 0, cx, cy), (cx, 0, s2, cy), (0, cy, cx, s2),
                  (cx, cy, s2, s2)]
    for (x1, y1, x2, y2), img, lab in zip(placements, imgs, labs):
        tw, th = x2 - x1, y2 - y1
        if tw <= 0 or th <= 0:
            continue
        h, w = img.shape[:2]
        g = min(tw / w, th / h)
        nw, nh = max(int(w * g), 1), max(int(h * g), 1)
        rs = _resize(img, (nh, nw))
        canvas[y1:y1 + nh, x1:x1 + nw] = rs[:th, :tw]
        if len(lab):
            l2 = lab.copy()
            l2[:, 1] = (lab[:, 1] * nw + x1) / s2
            l2[:, 2] = (lab[:, 2] * nh + y1) / s2
            l2[:, 3] = lab[:, 3] * nw / s2
            l2[:, 4] = lab[:, 4] * nh / s2
            out_labs.append(l2)
    lab = np.concatenate(out_labs, 0) if out_labs else \
        np.zeros((0, 6), np.float32)
    off = size // 2
    crop = canvas[off:off + size, off:off + size]
    if len(lab):
        xyxy = _xywhn_to_xyxy_px(lab, s2, s2) - off
        xyxy[:, [0, 2]] = xyxy[:, [0, 2]].clip(0, size)
        xyxy[:, [1, 3]] = xyxy[:, [1, 3]].clip(0, size)
        keep = ((xyxy[:, 2] - xyxy[:, 0]) > 2) & ((xyxy[:, 3] - xyxy[:, 1]) > 2)
        lab = lab[keep]
        if len(lab):
            lab[:, 1:5] = _xyxy_px_to_xywhn(xyxy[keep], size, size)
    return crop, lab


def mixup(img1, lab1, img2, lab2, rng: np.random.Generator):
    """MixUp: a beta(32, 32) blend, labels concatenated."""
    r = rng.beta(32.0, 32.0)
    img = (img1.astype(np.float32) * r + img2.astype(np.float32) * (1 - r))
    return img.astype(np.uint8), np.concatenate([lab1, lab2], 0)


def copy_paste(img: np.ndarray, lab: np.ndarray, rng: np.random.Generator,
               p: float = 0.5, ioa_thresh: float = 0.30):
    """Box-level copy-paste: each object is copied with probability `p` to
    its horizontally mirrored x position, unless it would cover an existing
    box by `ioa_thresh` of that box's area or more. Copies carry track id
    -1: they are new objects, not continuations."""
    if p <= 0 or not len(lab):
        return img, lab
    h, w = img.shape[:2]
    img = img.copy()
    xyxy = _xywhn_to_xyxy_px(lab, w, h)
    occupied = [xyxy]
    new_rows = []
    for j in range(len(lab)):
        if rng.random() >= p:
            continue
        x1, y1, x2, y2 = (int(round(v)) for v in xyxy[j])
        x1, x2 = max(x1, 0), min(x2, w)
        y1, y2 = max(y1, 0), min(y2, h)
        if (x2 - x1) < 2 or (y2 - y1) < 2:
            continue
        nx1, nx2 = w - x2, w - x1     # mirrored-x paste location
        cand = np.array([nx1, y1, nx2, y2], float)
        boxes = np.concatenate(occupied, 0)
        ix1 = np.maximum(boxes[:, 0], cand[0])
        iy1 = np.maximum(boxes[:, 1], cand[1])
        ix2 = np.minimum(boxes[:, 2], cand[2])
        iy2 = np.minimum(boxes[:, 3], cand[3])
        inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
        area = np.maximum((boxes[:, 2] - boxes[:, 0]) *
                          (boxes[:, 3] - boxes[:, 1]), 1e-9)
        if len(inter) and (inter / area).max() >= ioa_thresh:
            continue
        img[y1:y2, nx1:nx2] = img[y1:y2, x1:x2][:, ::-1]
        row = lab[j].copy()
        row[1] = (nx1 + nx2) / 2 / w
        if row.shape[0] >= 6:
            row[5] = -1
        occupied.append(cand[None])
        new_rows.append(row)
    if new_rows:
        lab = np.concatenate([lab, np.stack(new_rows)], 0)
    return img, lab


# Photometric transforms (label-free): the Albumentations block of the
# reference pipeline with its shipped probabilities.

def blur(img: np.ndarray, k: int = 5) -> np.ndarray:
    """Box blur with an odd kernel k (PIL's `BoxBlur((k - 1) // 2)`)."""
    r = (k - 1) // 2
    img = np.ascontiguousarray(img, np.uint8)
    if r == 0:
        return img.copy()
    fn = cuda_build.bind(_lib(), "box_blur",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3, None)
    tmp, out = np.empty_like(img), np.empty_like(img)
    fn(img.ctypes.data, tmp.ctypes.data, out.ctypes.data, img.shape[0],
       img.shape[1], r)
    return out


def median_blur(img: np.ndarray, k: int = 5) -> np.ndarray:
    """Median of each channel's k x k window, edges repeated (PIL's
    `MedianFilter(size=k)`)."""
    fn = cuda_build.bind(_lib(), "median_filter",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3, None)
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty_like(img)
    fn(img.ctypes.data, out.ctypes.data, img.shape[0], img.shape[1], k)
    return out


def to_gray(img: np.ndarray) -> np.ndarray:
    g = _convert("rgb_to_l", img)
    return np.repeat(g[..., None], 3, axis=2)


def clahe(img: np.ndarray, clip_limit: float = 4.0,
          tiles: int = 8) -> np.ndarray:
    """Contrast-limited adaptive histogram equalization of the luma
    channel: per-tile clipped-histogram CDFs, bilinearly interpolated
    between tile centres."""
    ycc = _convert("rgb_to_ycbcr", img).astype(np.float32)
    y = ycc[..., 0].astype(np.uint8)
    h, w = y.shape
    th, tw = max(h // tiles, 1), max(w // tiles, 1)
    ny, nx = (h + th - 1) // th, (w + tw - 1) // tw
    luts = np.empty((ny, nx, 256), np.float32)
    clip_at = max(clip_limit * th * tw / 256.0, 1.0)
    for i in range(ny):
        for j in range(nx):
            tile = y[i * th:(i + 1) * th, j * tw:(j + 1) * tw]
            hist = np.bincount(tile.ravel(), minlength=256).astype(np.float32)
            excess = np.clip(hist - clip_at, 0, None).sum()
            hist = np.minimum(hist, clip_at) + excess / 256.0
            cdf = hist.cumsum()
            cdf = cdf / max(cdf[-1], 1e-9) * 255.0
            luts[i, j] = cdf
    yy = (np.arange(h, dtype=np.float32) - th / 2) / th
    xx = (np.arange(w, dtype=np.float32) - tw / 2) / tw
    y0 = np.clip(np.floor(yy).astype(int), 0, ny - 1)
    x0 = np.clip(np.floor(xx).astype(int), 0, nx - 1)
    y1 = np.minimum(y0 + 1, ny - 1)
    x1 = np.minimum(x0 + 1, nx - 1)
    fy = np.clip(yy - y0, 0, 1)[:, None]
    fx = np.clip(xx - x0, 0, 1)[None, :]
    v = y.astype(int)
    g00 = luts[y0[:, None], x0[None, :], v]
    g01 = luts[y0[:, None], x1[None, :], v]
    g10 = luts[y1[:, None], x0[None, :], v]
    g11 = luts[y1[:, None], x1[None, :], v]
    out_y = (g00 * (1 - fy) * (1 - fx) + g01 * (1 - fy) * fx +
             g10 * fy * (1 - fx) + g11 * fy * fx)
    ycc[..., 0] = np.clip(out_y, 0, 255)
    return _convert("ycbcr_to_rgb", ycc.astype(np.uint8))


def brightness_contrast(img: np.ndarray, brightness: float,
                        contrast: float) -> np.ndarray:
    """x * (1 + contrast) + brightness * 255."""
    x = img.astype(np.float32) * (1.0 + contrast) + brightness * 255.0
    return np.clip(x, 0, 255).astype(np.uint8)


def gamma(img: np.ndarray, g: float) -> np.ndarray:
    lut = (np.linspace(0, 1, 256) ** g * 255.0).astype(np.uint8)
    return lut[img]


def jpeg_compression(img: np.ndarray, quality: int) -> np.ndarray:
    """The image saved as a JPEG at `quality` and decoded again."""
    return decode_jpeg(encode_jpeg(np.ascontiguousarray(img, np.uint8),
                                   int(quality)))


@dataclasses.dataclass
class Photometrics:
    """The reference's Albumentations composition with its shipped
    probabilities; each transform fires independently. `sample(rng)`
    freezes one draw (clip coherence), `apply` runs it on a frame."""

    blur_p: float = 0.01
    median_p: float = 0.01
    gray_p: float = 0.01
    clahe_p: float = 0.01
    bc_p: float = 0.0          # RandomBrightnessContrast (reference p=0)
    gamma_p: float = 0.0       # RandomGamma (reference p=0)
    compression_p: float = 0.0  # ImageCompression (reference p=0)

    def sample(self, rng: np.random.Generator) -> dict:
        return {
            "blur_k": int(rng.choice([3, 5, 7]))
            if rng.random() < self.blur_p else 0,
            "median_k": int(rng.choice([3, 5]))
            if rng.random() < self.median_p else 0,
            "gray": rng.random() < self.gray_p,
            "clahe": rng.random() < self.clahe_p,
            "bc": (float(rng.uniform(-0.2, 0.2)),
                   float(rng.uniform(-0.2, 0.2)))
            if rng.random() < self.bc_p else None,
            "gamma": float(rng.uniform(0.8, 1.2))
            if rng.random() < self.gamma_p else None,
            "jpeg_q": int(rng.integers(75, 101))
            if rng.random() < self.compression_p else 0,
        }

    @staticmethod
    def apply(img: np.ndarray, d: dict) -> np.ndarray:
        if d["blur_k"]:
            img = blur(img, d["blur_k"])
        if d["median_k"]:
            img = median_blur(img, d["median_k"])
        if d["gray"]:
            img = to_gray(img)
        if d["clahe"]:
            img = clahe(img)
        if d["bc"] is not None:
            img = brightness_contrast(img, *d["bc"])
        if d["gamma"] is not None:
            img = gamma(img, d["gamma"])
        if d["jpeg_q"]:
            img = jpeg_compression(img, d["jpeg_q"])
        return img


@dataclasses.dataclass
class ClipAugmenter:
    """Per-clip frozen augmentation for video training: the parameters are
    sampled once a clip (`begin_clip`) and reused on every frame, so that
    the ids stay coherent."""

    hsv: bool = True
    hsv_h: float = 0.015   # gain magnitudes (reference hsv_h/hsv_s/hsv_v)
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    fliplr_p: float = 0.5
    flipud_p: float = 0.0
    degrees: float = 0.0
    translate: float = 0.05
    scale: float = 0.2
    shear: float = 0.0
    perspective: float = 0.0
    seed: int = 0
    # the reference pipeline runs its photometric block before HSV and the
    # flips; frozen per clip here
    photometrics: Optional[Photometrics] = dataclasses.field(
        default_factory=Photometrics)

    def begin_clip(self, clip_index: int):
        self._rng = np.random.default_rng(self.seed * 100003 + clip_index)
        self._photo = (self.photometrics.sample(self._rng)
                       if self.photometrics is not None else None)
        self._flip = self._rng.uniform() < self.fliplr_p
        self._flipud = self._rng.uniform() < self.flipud_p
        self._affine_params = None
        self._hsv_rng_state = self._rng.integers(0, 2 ** 31)

    def __call__(self, img: np.ndarray, lab: np.ndarray):
        rng = np.random.default_rng(self._hsv_rng_state)
        if self._photo is not None:
            img = Photometrics.apply(img, self._photo)
        if self.hsv and (self.hsv_h or self.hsv_s or self.hsv_v):
            img = random_hsv(img, rng, hgain=self.hsv_h,
                             sgain=self.hsv_s, vgain=self.hsv_v)
        if self._flip:
            img, lab = random_flip_lr(img, lab)
        if self._flipud:
            img, lab = random_flip_ud(img, lab)
        img, lab, self._affine_params = random_affine(
            img, lab, self._rng, degrees=self.degrees,
            translate=self.translate, scale=self.scale,
            shear=self.shear, perspective=self.perspective,
            params=self._affine_params)
        return img, lab
