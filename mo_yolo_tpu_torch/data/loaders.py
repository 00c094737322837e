"""Frame sources for streaming inference (the port's copies of
`IMG_EXTS`, `list_images`, `load_image`, `ImageFolderSource`,
`ArraySource`, `TensorSource` and `make_source` from
`mo_yolo_tpu/data/loaders.py`).

Images decode through the port's own decoders (`data/decode.py`: PNG
and uncompressed BMP; `data/jpeg.py`: JPEG; `.npy` frames through numpy),
not PIL. TIFF and WebP frames raise, naming the codec library they need.
Video files, URL streams, webcams and screenshots raise: the JAX package
reads them through an ffmpeg binary, a camera and a display, which the
machine with the card does not have; PIL images are not taken either (no
PIL there).
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple, Union

import numpy as np
import torch

from mo_yolo_tpu_torch.data.decode import (BMP_MAGIC, JPEG_MAGIC, PNG_MAGIC,
                                           decode_bmp, decode_png)
from mo_yolo_tpu_torch.data.jpeg import decode_jpeg

# the JAX package's list, so that a folder lists the same files; PNG, JPEG
# and BMP among them decode here
IMG_EXTS = {".bmp", ".jpeg", ".jpg", ".png", ".tif", ".tiff", ".webp"}
VID_EXTS = {".asf", ".avi", ".gif", ".m4v", ".mkv", ".mov", ".mp4",
            ".mpeg", ".mpg", ".ts", ".webm", ".wmv"}
STREAM_PREFIXES = ("rtsp://", "rtmp://", "http://", "https://", "tcp://",
                   "udp://")


def list_images(source: Union[str, Path]) -> List[str]:
    """The image files of a directory (recursively, sorted), one image, a
    `.txt` list of paths, or a glob."""
    p = str(source)
    if os.path.isdir(p):
        files = sorted(
            f for f in glob.glob(os.path.join(p, "**", "*"), recursive=True)
            if Path(f).suffix.lower() in IMG_EXTS)
    elif os.path.isfile(p) and Path(p).suffix.lower() in IMG_EXTS:
        files = [p]
    elif os.path.isfile(p) and p.endswith(".txt"):
        with open(p) as f:
            files = [line.strip() for line in f if line.strip()]
    else:
        files = sorted(f for f in glob.glob(p)
                       if Path(f).suffix.lower() in IMG_EXTS)
    if not files:
        raise FileNotFoundError(f"no images found for source {source!r}")
    return files


def load_image(path: Union[str, Path]) -> np.ndarray:
    """Decode one PNG, JPEG, BMP or `.npy` frame to HWC uint8 RGB. Other
    formats raise; TIFF and WebP name the codec library they need."""
    path = Path(path)
    if path.suffix.lower() == ".npy":
        frame = np.load(path)
        if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"{path}: a frame is uint8 [H, W, 3], got "
                             f"{frame.dtype} {frame.shape}")
        return frame
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_MAGIC:
        return decode_png(data)
    if data[:2] == JPEG_MAGIC:
        try:
            return decode_jpeg(data)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    if data[:2] == BMP_MAGIC:
        return decode_bmp(data)
    for magic, kind, lib in ((b"II*\x00", "TIFF", "libtiff"),
                             (b"MM\x00*", "TIFF", "libtiff"),
                             (b"RIFF", "WebP", "libwebp")):
        if data[:len(magic)] == magic and (kind != "WebP" or
                                           data[8:12] == b"WEBP"):
            raise ValueError(f"{path}: {kind} frames need the {lib} codec, "
                             f"which the port does not have (no PIL or cv2 "
                             f"on this path); convert them to PNG")
    raise ValueError(f"{path}: only PNG, JPEG, BMP and .npy frames are "
                     f"decoded (there is no PIL or cv2 on this path)")


class ImageFolderSource:
    """Sequential frames of a directory, glob, list file or list of paths,
    as (path, uint8 [H, W, 3])."""

    def __init__(self, source):
        if isinstance(source, (list, tuple)):
            self.files = [str(f) for f in source]
        else:
            self.files = list_images(source)

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        for f in self.files:
            yield f, load_image(f)


class ArraySource:
    """In-memory frames (numpy [T,H,W,3] uint8 or a list of HWC arrays)."""

    def __init__(self, frames: Union[np.ndarray, Sequence[np.ndarray]]):
        self.frames = list(frames)

    def __len__(self):
        return len(self.frames)

    def __iter__(self):
        for i, f in enumerate(self.frames):
            yield f"frame_{i:06d}", np.asarray(f)


class TensorSource:
    """Pre-decoded frames in a torch tensor or an array, [B,C,H,W] or
    [B,H,W,C] (or one frame without B), float in [0, 1] or uint8, as HWC
    uint8 RGB frames."""

    def __init__(self, tensor):
        if isinstance(tensor, torch.Tensor):
            tensor = tensor.detach().cpu().numpy()
        x = np.asarray(tensor)
        if x.ndim == 3:
            x = x[None]
        if x.ndim != 4:
            raise ValueError(f"tensor source must be 3D/4D, got {x.shape}")
        if x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3):
            x = np.moveaxis(x, 1, -1)          # BCHW -> BHWC
        if x.dtype != np.uint8:
            x = (np.clip(x, 0, 1) * 255).astype(np.uint8)
        if x.shape[-1] == 1:
            x = np.repeat(x, 3, axis=-1)
        self.frames = x

    def __len__(self):
        return len(self.frames)

    def __iter__(self):
        for i, f in enumerate(self.frames):
            yield f"tensor_{i:06d}", f


def _not_here(source, what: str, needs: str):
    return RuntimeError(f"{source!r}: {what} sources are not read by the "
                        f"port: they need {needs}, which the machine with "
                        f"the card does not have")


def make_source(source) -> Union[ImageFolderSource, ArraySource,
                                 TensorSource]:
    """The frame source of `source`, dispatched as the JAX package's
    `make_source` does: a directory, glob, `.txt` list or image file; a
    `.npy` stack of frames; a list of paths; an ndarray stack or one
    frame; a list of arrays; a torch tensor. A webcam index, a URL stream,
    `screen` and a video file raise, naming what they need."""
    if isinstance(source, int):
        raise _not_here(source, "webcam", "a camera and an ffmpeg binary")
    if isinstance(source, (str, Path)):
        s = str(source)
        if s.isdigit():
            raise _not_here(source, "webcam", "a camera and an ffmpeg binary")
        if s == "screen" or s.startswith("screen "):
            raise _not_here(source, "screenshot", "a display")
        if s.lower().startswith(STREAM_PREFIXES):
            raise _not_here(source, "URL stream", "an ffmpeg binary")
        suffix = Path(s).suffix.lower()
        if suffix in VID_EXTS:
            raise _not_here(source, "video", "an ffmpeg binary")
        if suffix == ".npy":
            return ArraySource(np.load(s))
        return ImageFolderSource(source)
    if isinstance(source, torch.Tensor):
        return TensorSource(source)
    if isinstance(source, np.ndarray):
        return ArraySource(source if source.ndim == 4 else source[None])
    if type(source).__module__.startswith("PIL"):
        raise TypeError("PIL images are not taken (there is no PIL on the "
                        "machine with the card): pass uint8 arrays")
    if isinstance(source, (list, tuple)) and len(source):
        if isinstance(source[0], np.ndarray):
            return ArraySource(source)
        if isinstance(source[0], (str, Path)):
            return ImageFolderSource(source)
    raise TypeError(f"unsupported source type: {type(source)}")
