"""Frame sources for streaming inference (the port's copies of
`IMG_EXTS`, `list_images`, `load_image`, `ImageFolderSource`,
`ArraySource`, `TensorSource`, `VideoSource`, `StreamSource`,
`ScreenshotSource` and `make_source` from `mo_yolo_tpu/data/loaders.py`).

Images decode through the port's own decoders, not PIL: PNG and BMP in
`data/decode.py`, JPEG in `data/jpeg.py`, TIFF in `data/tiff.py`, WebP in
`data/webp.py` (each C file built at first use), `.npy` frames through
numpy; `load_image` picks the decoder by the file's first bytes. Video
files, URL streams and webcams are read as the JAX package reads them,
through `ffmpeg`/`ffprobe` binaries on `PATH` and an rgb24 rawvideo pipe;
screenshots through the `mss` package; each raises RuntimeError where its
tool is missing. PIL images are taken by duck typing (`.convert("RGB")`);
the port never imports PIL.

Tests: on the CPU, `tests/test_torch_port_sources.py` holds every source
to the JAX package's through a stand-in ffmpeg (`tests/ffmpeg_stub.py`)
and a stand-in `mss`, and `tests/test_torch_port_formats.py` holds
`load_image` to the JAX one on every format; on the card, `chip_smoke.py`'s
`formats` and `sources` phases.
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
from mo_yolo_tpu_torch.data.tiff import BIGTIFF_MAGICS, TIFF_MAGICS, decode_tiff
from mo_yolo_tpu_torch.data.webp import decode_webp, is_webp

# the JAX package's list, so that a folder lists the same files
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
    """Decode one PNG, JPEG, BMP, TIFF, WebP or `.npy` frame to HWC uint8
    RGB, the decoder chosen by the file's first bytes; any other file
    raises."""
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
        decode = decode_png
    elif data[:2] == JPEG_MAGIC:
        decode = decode_jpeg
    elif data[:2] == BMP_MAGIC:
        decode = decode_bmp
    elif data[:4] in TIFF_MAGICS + BIGTIFF_MAGICS:
        decode = decode_tiff
    elif is_webp(data):
        decode = decode_webp
    else:
        raise ValueError(f"{path}: only PNG, JPEG, BMP, TIFF, WebP and .npy "
                         f"frames are decoded")
    try:
        return decode(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


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




def _end(proc, timeout: float = 5.0) -> None:
    """End an ffmpeg process whose frames are no longer read: close its
    pipe (a real ffmpeg exits on the broken pipe), wait, and kill it if it
    has not exited after `timeout` seconds, so that a closed source never
    hangs on it or leaves it running."""
    proc.stdout.close()
    try:
        proc.wait(timeout)
    except Exception:
        proc.kill()
        proc.wait()


def _probe(path: str, entries: str) -> dict:
    import json
    import subprocess
    probe = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0",
         "-show_entries", f"stream={entries}", "-of", "json", path],
        capture_output=True, check=True)
    return json.loads(probe.stdout)["streams"][0]


def _read_frame(proc, h: int, w: int):
    """The next uint8 [h, w, 3] frame of ffmpeg's pipe (a writable array),
    or None where the stream ends."""
    frame = np.empty((h, w, 3), np.uint8)
    return frame if proc.stdout.readinto(frame.data.cast("B")) == \
        frame.nbytes else None


def _rawvideo(cmd: List[str], nbytes: int):
    import subprocess
    return subprocess.Popen(cmd + ["-f", "rawvideo", "-pix_fmt", "rgb24", "-"],
                            stdout=subprocess.PIPE, bufsize=nbytes * 4)


class VideoSource:
    """The frames of a video file, decoded by an ffmpeg binary into an
    rgb24 rawvideo pipe, as the JAX package's `VideoSource` reads them;
    `vid_stride` keeps every k-th frame. Needs `ffmpeg` and `ffprobe` on
    `PATH` (RuntimeError without them)."""

    def __init__(self, path: str, vid_stride: int = 1):
        import shutil
        if shutil.which("ffmpeg") is None or shutil.which("ffprobe") is None:
            raise RuntimeError("video sources need an ffmpeg/ffprobe binary")
        self.path = str(path)
        self.vid_stride = max(int(vid_stride), 1)
        st = _probe(self.path, "width,height,nb_frames")
        self.w, self.h = int(st["width"]), int(st["height"])
        self.n_frames = int(st.get("nb_frames") or 0)

    def __len__(self):
        return (self.n_frames + self.vid_stride - 1) // self.vid_stride

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        nbytes = self.w * self.h * 3
        proc = _rawvideo(["ffmpeg", "-v", "error", "-i", self.path], nbytes)
        try:
            i = 0
            while (frame := _read_frame(proc, self.h, self.w)) is not None:
                if i % self.vid_stride == 0:
                    yield f"{self.path}#{i:06d}", frame
                i += 1
        finally:
            _end(proc)


class StreamSource:
    """A live stream (RTSP, RTMP, HTTP, TCP, UDP URL) or a webcam (an
    integer index, /dev/video<N> through ffmpeg's v4l2 demuxer at
    `fps_probe`'s size), decoded by ffmpeg into an rgb24 pipe that a
    reader thread drains. Only the latest frame is kept: a slow consumer
    drops frames rather than lagging. Iteration ends with the stream,
    after `max_frames`, or on `stop()`; ffmpeg is then ended."""

    def __init__(self, source: Union[str, int], max_frames: int = 0,
                 fps_probe: Tuple[int, int] = (640, 480)):
        import shutil
        self.src = str(source)
        self.max_frames = max_frames
        self._stop = False
        if self.src.isdigit():
            self._cmd = ["ffmpeg", "-v", "error", "-f", "v4l2",
                         "-i", f"/dev/video{source}"]
            self.w, self.h = fps_probe
        else:
            if shutil.which("ffprobe") is None:
                raise RuntimeError("stream sources need ffmpeg/ffprobe")
            st = _probe(self.src, "width,height")
            self.w, self.h = int(st["width"]), int(st["height"])
            self._cmd = ["ffmpeg", "-v", "error", "-i", self.src]
        if shutil.which("ffmpeg") is None:
            raise RuntimeError("stream sources need an ffmpeg binary")

    def stop(self):
        self._stop = True

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        import queue
        import threading

        nbytes = self.w * self.h * 3
        proc = _rawvideo(self._cmd, nbytes)
        latest: "queue.Queue" = queue.Queue(maxsize=1)

        def reader():
            while not self._stop:
                frame = _read_frame(proc, self.h, self.w)
                if frame is None:
                    break
                try:               # drop the stale frame, keep the new one
                    latest.get_nowait()
                except queue.Empty:
                    pass
                latest.put(frame)
            while True:            # sentinel: end of stream
                try:
                    latest.put(None, timeout=0.05)
                    break
                except queue.Full:
                    if self._stop:     # nobody reads any more
                        break

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        i = 0
        try:
            while not self._stop:
                frame = latest.get()
                if frame is None:
                    break
                yield f"{self.src}#{i:06d}", frame
                i += 1
                if self.max_frames and i >= self.max_frames:
                    break
        finally:
            # ffmpeg first: the reader's blocked read then returns
            self._stop = True
            proc.terminate()
            t.join()
            _end(proc)


class ScreenshotSource:
    """Screen captures through the `mss` package (imported when the source
    is made; RuntimeError without it). `spec` is `screen [monitor [left top
    width height]]`, the region relative to the monitor."""

    def __init__(self, spec: str = "screen", max_frames: int = 0):
        try:
            import mss  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "screenshot sources need the `mss` package") from e
        parts = str(spec).split()
        self.monitor = int(parts[1]) if len(parts) > 1 else 0
        self.region = [int(p) for p in parts[2:6]] if len(parts) >= 6 else None
        self.max_frames = max_frames

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        import mss

        with mss.mss() as sct:
            mon = sct.monitors[self.monitor]
            if self.region:
                left, top, w, h = self.region
                mon = {"left": mon["left"] + left, "top": mon["top"] + top,
                       "width": w, "height": h}
            i = 0
            while not self.max_frames or i < self.max_frames:
                shot = np.asarray(sct.grab(mon))[..., :3][..., ::-1]  # BGRA
                yield f"screen_{i:06d}", np.ascontiguousarray(shot)
                i += 1


def is_pil_image(x) -> bool:
    """Whether `x` is a PIL image, told without importing PIL."""
    return type(x).__module__.startswith("PIL") and hasattr(x, "convert")


def make_source(source, vid_stride: int = 1):
    """The frame source of `source`, dispatched in the JAX package's
    order: a webcam index (int or digit string), `screen ...`, a URL
    stream, a video file (every `vid_stride`-th frame), else a directory,
    glob, `.txt` list or image file (a `.npy` stack of frames too); a
    torch tensor; an ndarray stack or one frame; a PIL image; a list of
    arrays, of PIL images or of paths."""
    if isinstance(source, int):
        return StreamSource(source)
    if isinstance(source, (str, Path)):
        s = str(source)
        if s.isdigit():
            return StreamSource(s)
        if s == "screen" or s.startswith("screen "):
            return ScreenshotSource(s)
        if s.lower().startswith(STREAM_PREFIXES):
            return StreamSource(s)
        suffix = Path(s).suffix.lower()
        if suffix in VID_EXTS:
            return VideoSource(s, vid_stride=vid_stride)
        if suffix == ".npy":
            return ArraySource(np.load(s))
        return ImageFolderSource(source)
    if isinstance(source, torch.Tensor):
        return TensorSource(source)
    if isinstance(source, np.ndarray):
        return ArraySource(source if source.ndim == 4 else source[None])
    if is_pil_image(source):
        return ArraySource([np.asarray(source.convert("RGB"))])
    if isinstance(source, (list, tuple)) and len(source):
        if isinstance(source[0], np.ndarray):
            return ArraySource(source)
        if is_pil_image(source[0]):
            return ArraySource([np.asarray(im.convert("RGB"))
                                for im in source])
        if isinstance(source[0], (str, Path)):
            return ImageFolderSource(source)
    raise TypeError(f"unsupported source type: {type(source)}")
