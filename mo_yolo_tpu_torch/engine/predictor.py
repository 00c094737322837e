"""Streaming tracking inference engine (counterpart of
`mo_yolo_tpu/engine/predictor.py`).

A source is anything `data/loaders.make_source` takes: uint8 HWC numpy
frames, image files (a folder, a glob, a `.txt` list, a list of paths;
PNG, JPEG, BMP, TIFF, WebP), a `.npy` stack of frames, a video file
(every `vid_stride`-th frame), a URL stream or webcam (through an ffmpeg
binary), `screen` (through `mss`), PIL images or a tensor. Each frame is
copied to the device, letterboxed there (scale-fill, uint8) and run
through `stream_step`; its packed result is fetched one frame later, so
the host postprocesses frame t while the device runs frame t+1, and
`stream_step` brings nothing to the host. Results can be written as MOT
txt, annotated frames and crops (`engine/results.py`).

Tests: `tests/test_torch_port_stream.py` and `test_torch_port_sources.py`
(a video at `vid_stride=2`) against the JAX `TrackPredictor` on the CPU;
`chip_smoke.py`'s slice, formats and sources phases on the card.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from mo_yolo_tpu_torch.data.encode import check_writable
from mo_yolo_tpu_torch.data.letterbox import boxes_to_original, to_hw
from mo_yolo_tpu_torch.data.loaders import (ImageFolderSource,
                                           is_pil_image, load_image,
                                           make_source)
from mo_yolo_tpu_torch.engine.results import TrackResults
from mo_yolo_tpu_torch.metrics.mot import write_mot_txt
from mo_yolo_tpu_torch.models.tracker import unpack_outputs
from mo_yolo_tpu_torch.ops.preprocess import (device_letterbox,
                                              device_preprocess_meta)
from mo_yolo_tpu_torch.utils.callbacks import CallbackBus
from mo_yolo_tpu_torch.utils.device import resolve_device


def _prefetched(files: List[str], workers: int
                ) -> Iterator[Tuple[str, np.ndarray]]:
    """(path, frame) of `files` in order, decoded by `workers` threads up
    to 2 * `workers` frames ahead (the PNG inflate and the C unfilter
    release the GIL)."""
    it = iter(files)
    with ThreadPoolExecutor(workers) as pool:
        ahead = deque((f, pool.submit(load_image, f))
                      for f in itertools.islice(it, 2 * workers))
        try:
            while ahead:
                path, fut = ahead.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    ahead.append((nxt, pool.submit(load_image, nxt)))
                yield path, fut.result()
        finally:            # a stream closed early decodes no further
            for _, fut in ahead:
                fut.cancel()


def _frames(source, workers: int = 1, vid_stride: int = 1
            ) -> Iterator[Tuple[str, np.ndarray]]:
    """(path, frame) pairs of whatever `make_source` takes (image files, a
    `.npy` stack, a video file thinned by `vid_stride`, a stream, a webcam,
    `screen`, arrays, PIL images, a tensor); any other iterable of frames
    (a generator, a camera loop) is read lazily, one frame at a time. Image
    files decode on `workers` threads."""
    if isinstance(source, (str, Path, np.ndarray, torch.Tensor, int)) or \
            is_pil_image(source) or \
            (isinstance(source, (list, tuple)) and source and
             (isinstance(source[0], (str, Path, np.ndarray)) or
              is_pil_image(source[0]))):
        source = make_source(source, vid_stride=vid_stride)
        if isinstance(source, ImageFolderSource) and workers > 1:
            source = _prefetched(source.files, workers)
    else:
        # read lazily: a generator (a camera, a decode loop) may be endless
        source = ((f"frame_{i:06d}", img) for i, img in enumerate(source))
    for path, img in source:
        img = np.asarray(img)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError("frames must be uint8 [H, W, 3] arrays, got "
                             f"{img.dtype} {img.shape}")
        yield path, img


def frame_stem(path: str, n: int) -> str:
    """The file stem of frame `n` from `path`: a `#`-suffixed video-frame
    path (`clip.mp4#000012`) gets its frame number, so that its frames do
    not share one stem."""
    stem = Path(path).stem if path else f"frame{n:06d}"
    return f"{stem.replace('#', '_')}_{n:06d}" if "#" in str(path) else stem


class TrackPredictor:
    """`stream(source, ...)` yields a TrackResults a frame. `names` maps
    class ids to the labels' names; `classes` keeps those ids;
    `vid_stride` keeps every k-th frame of a video file; `visualize`
    writes each frame's feature-map grids; `workers` threads decode image
    files ahead; `callbacks` get `on_predict_start` at the first frame
    asked for, `on_predict_batch_end` after each frame and
    `on_predict_end` when the stream ends or is closed. `speed` holds the last frame's host ms: decode, dispatch of
    the step, postprocess."""

    def __init__(self, model, imgsz=640, conf: float = 0.5, classes=None,
                 device=None, names=None, vid_stride: int = 1,
                 visualize: bool = False, workers: int = 2,
                 callbacks: Optional[CallbackBus] = None):
        self.device = resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev.type != self.device.type:
            raise ValueError(f"model is on {model_dev}, predictor on "
                             f"{self.device}")
        self.model = model
        self.imgsz = imgsz               # int, (h, w), or "WxH"
        self.in_h, self.in_w = to_hw(imgsz)
        self.conf = conf
        self.names = names or {}
        self.classes = None if classes is None else \
            np.asarray(sorted({int(c) for c in np.atleast_1d(classes)}))
        self.vid_stride = max(int(vid_stride), 1)
        self.visualize = visualize
        self.workers = max(int(workers), 1)
        self.callbacks = callbacks or CallbackBus()
        self.speed = {"preprocess": 0.0, "dispatch": 0.0,
                      "postprocess": 0.0}

    def reset_state(self):
        """Fresh track memory for a new sequence."""
        return self.model.init_state(1)

    def _step(self, state, img: np.ndarray):
        u8 = torch.from_numpy(img[None]).to(self.device, non_blocking=True)
        x = device_letterbox(u8, (self.in_h, self.in_w), scale_fill=True)
        state, packed = self.model.stream_step(state, x)
        # start the copy now; it is waited on one frame later
        host = torch.empty(packed.shape, dtype=packed.dtype,
                           pin_memory=self.device.type == "cuda")
        host.copy_(packed, non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return state, (host, done), x

    def _visualize(self, x: torch.Tensor, save_dir: str, stem: str,
                   i: int) -> None:
        from mo_yolo_tpu_torch.utils.plotting import feature_visualization
        with torch.no_grad():
            feats = self.model.model(x)
        feature_visualization([f.float().cpu().numpy() for f in feats],
                              str(Path(save_dir) / f"{stem}_{i}"))

    def stream(self, source, save_mot: Optional[str] = None,
               save: bool = False, save_crop: bool = False,
               save_dir: str = "runs/track/predict", line_width: int = 2,
               show_labels: bool = True, show_conf: bool = True,
               boxes: bool = True, show: bool = False,
               save_format: str = "jpg") -> Iterator[TrackResults]:
        """Yield TrackResults per frame of `source` (see `_frames`);
        optionally write MOT txt (`save_mot`), annotated frames (`save`,
        `<save_dir>/<stem>.<save_format>`, jpg or png) and crops
        (`save_crop`, jpg, under `<save_dir>/crops`). A `save_format`
        that is not written raises before the first frame is stepped."""
        opts = dict(save=save, save_crop=save_crop, save_dir=save_dir,
                    line_width=line_width, show_labels=show_labels,
                    show_conf=show_conf, boxes=boxes, show=show,
                    suffix=f".{str(save_format).lstrip('.')}")
        if save:
            check_writable(f"frame{opts['suffix']}")
        if save_crop:
            check_writable("crop.jpg")
        self.callbacks.fire("on_predict_start", predictor=self)
        state = self.reset_state()
        mot_fh = None
        if save_mot:
            Path(save_mot).parent.mkdir(parents=True, exist_ok=True)
            mot_fh = open(save_mot, "w")
        n = 0
        pending = None       # (path, meta, img, fetch) one frame behind
        t1 = time.perf_counter()
        try:
            for i, (path, img) in enumerate(
                    _frames(source, self.workers, self.vid_stride)):
                t0, t1 = t1, time.perf_counter()
                meta = device_preprocess_meta(img.shape[:2],
                                              (self.in_h, self.in_w))
                state, fetch, x = self._step(state, img)
                if self.visualize:
                    self._visualize(x, save_dir, Path(path).stem, i)
                t2 = time.perf_counter()
                self.speed.update(preprocess=(t1 - t0) * 1e3,
                                  dispatch=(t2 - t1) * 1e3)
                if pending is not None:
                    yield self._emit(pending, mot_fh, n, **opts)
                    self.callbacks.fire("on_predict_batch_end",
                                        predictor=self, step=n)
                    n += 1
                pending = (path, meta, img, fetch)
                t1 = time.perf_counter()
            if pending is not None:
                yield self._emit(pending, mot_fh, n, **opts)
                self.callbacks.fire("on_predict_batch_end", predictor=self,
                                    step=n)
        finally:
            if mot_fh is not None:
                mot_fh.close()
            self.callbacks.fire("on_predict_end", predictor=self)

    def _emit(self, pending, mot_fh, n: int, save=False, save_crop=False,
              save_dir="runs/track/predict", line_width=2, show_labels=True,
              show_conf=True, boxes=True, show=False,
              suffix=".jpg") -> TrackResults:
        t0 = time.perf_counter()
        path, meta, img, (host, done) = pending
        if done is not None:
            done.synchronize()
        res = self._postprocess(unpack_outputs(host[0]), meta, path, img)
        if mot_fh is not None and len(res):
            write_mot_txt(mot_fh, n, res.track_id, res.boxes_xyxy, res.conf)
        stem = frame_stem(path, n)
        plot_kw = dict(line_width=line_width, show_labels=show_labels,
                       show_conf=show_conf, boxes=boxes)
        if save:
            res.save(Path(save_dir) / f"{stem}{suffix}", **plot_kw)
        if show:
            from mo_yolo_tpu_torch.utils.plotting import show_image
            show_image(res.plot(**plot_kw))
        if save_crop:
            res.save_crop(Path(save_dir) / "crops", file_name=stem)
        self.speed["postprocess"] = (time.perf_counter() - t0) * 1e3
        return res

    def _postprocess(self, out: dict, meta: dict, path: str,
                     img: Optional[np.ndarray] = None) -> TrackResults:
        """Keep live tracks above conf (and in `classes`), scale boxes to
        original pixels."""
        keep = out["valid"] & (out["obj_id"] >= 0) & (out["score"] >= self.conf)
        if self.classes is not None:
            keep &= np.isin(out["cls"].astype(int), self.classes)
        boxes = out["box"][keep]
        ih, iw = meta["input_shape"]
        xyxy = np.stack([
            (boxes[:, 0] - boxes[:, 2] / 2) * iw,
            (boxes[:, 1] - boxes[:, 3] / 2) * ih,
            (boxes[:, 0] + boxes[:, 2] / 2) * iw,
            (boxes[:, 1] + boxes[:, 3] / 2) * ih], 1) if len(boxes) else \
            np.zeros((0, 4))
        xyxy = boxes_to_original(xyxy, meta)
        return TrackResults(
            boxes_xyxy=xyxy, conf=out["score"][keep],
            cls=out["cls"][keep].astype(int),
            track_id=out["obj_id"][keep].astype(int),
            orig_shape=meta["orig_shape"], path=path, names=self.names,
            orig_img=img)
