"""Per-frame tracking results (the port's copy of `TrackResults` from
`mo_yolo_tpu/engine/results.py`, boxes only): normalized boxes, label
files, annotated frames and crops.

Drawing is numpy (`utils/draw.py`): box outlines pixel for pixel as the
JAX package's PIL `ImageDraw.rectangle`, the same 8-colour palette by
track id, and labels `id:N name conf` in a bitmap font of the port's own
(PIL's default font cannot be reproduced without PIL, so only the label
bands differ from the JAX package's frames). Files are written by suffix
through `data/encode.py`: PNG by the port's own writer, JPEG by the
port's own encoder (PIL's bytes for the same frame).

The task models fill `masks` (segment: instance masks blended at 40 %,
each brought to the frame's size as the JAX plot does, by PIL's BICUBIC
resize of the thresholded mask, pixel for pixel the same),
`keypoints` (pose: dots, and the COCO skeleton for 17 keypoints) and
`probs` (classify: the top five classes written at the top left); their
label rows are upstream's: `cls x1 y1 x2 y2 ...` of a mask's polygon, or
`cls cx cy w h kx ky kv ...`. A mask's polygon is its bounding box's four
corners: the JAX package traces the largest contour with cv2 where cv2 is
installed, and falls back to the same corners without it; the machine
with the card has no cv2.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from mo_yolo_tpu_torch.data.encode import write_image
from mo_yolo_tpu_torch.data.letterbox import resample
from mo_yolo_tpu_torch.utils import draw

PALETTE = [(255, 56, 56), (56, 168, 255), (72, 249, 10), (255, 178, 29),
           (207, 210, 49), (26, 147, 52), (61, 219, 134), (255, 112, 31)]
NO_TRACK = (200, 200, 200)
# COCO-17 keypoint skeleton (upstream's Annotator)
SKELETON = [(15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11),
            (6, 12), (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1),
            (0, 2), (1, 3), (2, 4), (3, 5), (4, 6)]


@dataclasses.dataclass
class TrackResults:
    """One frame of tracking output in original-image pixel coordinates."""

    boxes_xyxy: np.ndarray          # [n, 4]
    conf: np.ndarray                # [n]
    cls: np.ndarray                 # [n] int
    track_id: np.ndarray            # [n] int (-1 for a plain detection)
    orig_shape: tuple               # (h, w)
    path: str = ""
    names: Optional[Dict[int, str]] = None
    orig_img: Optional[np.ndarray] = None
    masks: Optional[np.ndarray] = None       # [n, h, w] segment masks
    keypoints: Optional[np.ndarray] = None   # [n, K, 3] x, y px, visibility
    probs: Optional[np.ndarray] = None       # [nc] class probabilities

    def __len__(self):
        return len(self.boxes_xyxy)

    def _name(self, i: int) -> str:
        c = int(self.cls[i])
        return (self.names or {}).get(c, str(c))

    @property
    def boxes_xywhn(self) -> np.ndarray:
        h, w = self.orig_shape
        b = self.boxes_xyxy
        cx = (b[:, 0] + b[:, 2]) / 2 / w
        cy = (b[:, 1] + b[:, 3]) / 2 / h
        bw = (b[:, 2] - b[:, 0]) / w
        bh = (b[:, 3] - b[:, 1]) / h
        return np.stack([cx, cy, bw, bh], 1)

    def save_txt(self, txt_file, save_conf: bool = False) -> None:
        """Append a label row a box to `txt_file`, normalized: `track_id cls
        cx cy w h`, with masks `cls x1 y1 ...` (the mask's polygon), with
        keypoints `cls cx cy w h kx ky kv ...`; `conf` last with
        `save_conf`."""
        lines = []
        for i, b in enumerate(self.boxes_xywhn):
            if self.masks is not None:
                vals = [int(self.cls[i]),
                        *mask_to_poly_n(self.masks[i]).reshape(-1).tolist()]
            elif self.keypoints is not None:
                h, w = self.orig_shape
                kp = np.asarray(self.keypoints[i], np.float32).copy()
                kp[:, 0] /= w
                kp[:, 1] /= h
                vals = [int(self.cls[i]), *b.tolist(),
                        *kp.reshape(-1).tolist()]
            else:
                vals = [int(self.track_id[i]), int(self.cls[i]), *b.tolist()]
            if save_conf:
                vals.append(float(self.conf[i]))
            lines.append(" ".join(str(v) if isinstance(v, int) else f"{v:g}"
                                  for v in vals))
        Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
        with open(txt_file, "a") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))

    def plot(self, img: Optional[np.ndarray] = None, line_width: int = 2,
             show_labels: bool = True, show_conf: bool = True,
             boxes: bool = True, masks: bool = True, kpt_radius: int = 3,
             kpt_line: bool = True) -> np.ndarray:
        """The frame with box outlines and `id:N name conf` labels, mask
        overlays, keypoints and the top-5 classes, uint8 [H, W, 3] (a
        copy; black where there is no image)."""
        base = img if img is not None else self.orig_img
        if base is None:
            base = np.zeros((*self.orig_shape, 3), np.uint8)
        out = np.array(base, np.uint8)
        if masks and self.masks is not None and len(self.masks):
            over = out.astype(np.float32)
            for i, mk in enumerate(_masks_at(self.masks, out.shape[:2])):
                color = np.asarray(PALETTE[i % len(PALETTE)], np.float32)
                over[mk] = over[mk] * 0.6 + color * 0.4
            out = over.astype(np.uint8)
        for i, b in enumerate(self.boxes_xyxy):
            tid = int(self.track_id[i])
            color = PALETTE[tid % len(PALETTE)] if tid >= 0 else NO_TRACK
            if boxes:
                draw.rectangle(out, b.tolist(), color, line_width)
            if show_labels:
                label = f"id:{tid} {self._name(i)}" if tid >= 0 \
                    else self._name(i)
                if show_conf:
                    label += f" {self.conf[i]:.2f}"
                draw.text(out, (b[0], max(0, b[1] - 12)), label, color)
        if self.keypoints is not None:
            for i, kp in enumerate(self.keypoints):
                color = PALETTE[i % len(PALETTE)]
                ok = kp[:, 2] > 0.5 if kp.shape[-1] == 3 else \
                    np.ones(len(kp), bool)
                if kpt_line and len(kp) == 17:
                    for a, b2 in SKELETON:
                        if ok[a] and ok[b2]:
                            draw.line(out, kp[a, :2], kp[b2, :2], color,
                                      max(line_width, 1))
                for k in np.nonzero(ok)[0]:
                    draw.disc(out, kp[k, :2], kpt_radius, color)
        if self.probs is not None:
            top = np.argsort(-np.asarray(self.probs))[:5]
            draw.text(out, (2, 2), ", ".join(
                f"{(self.names or {}).get(int(c), int(c))} "
                f"{float(self.probs[c]):.2f}" for c in top), (255, 255, 255))
        return out

    def save(self, filename, **plot_kw) -> str:
        """The annotated frame (`plot(**plot_kw)`) written to `filename`,
        PNG or JPEG by its suffix."""
        return write_image(filename, self.plot(**plot_kw))

    def save_crop(self, save_dir, file_name: Optional[str] = None) -> None:
        """One JPEG crop a box at `save_dir/<class name>/<stem>_<i>.jpg`,
        the box grown by 2 % of its size and clipped to the image."""
        if self.orig_img is None or not len(self):
            return
        stem = file_name or (Path(self.path).stem if self.path else "crop")
        h, w = self.orig_img.shape[:2]
        for i, b in enumerate(self.boxes_xyxy):
            bw, bh = b[2] - b[0], b[3] - b[1]
            x1 = int(max(0, b[0] - 0.02 * bw))
            y1 = int(max(0, b[1] - 0.02 * bh))
            x2 = int(min(w, b[2] + 0.02 * bw))
            y2 = int(min(h, b[3] + 0.02 * bh))
            if x2 <= x1 or y2 <= y1:
                continue
            write_image(Path(save_dir) / self._name(i) / f"{stem}_{i}.jpg",
                        self.orig_img[y1:y2, x1:x2])


def _masks_at(masks: np.ndarray, hw) -> np.ndarray:
    """[n, h, w] masks as bool at the image's size, as the JAX plot makes
    them: each thresholded at 0.5, as uint8 255 resized by PIL's BICUBIC
    (`data/letterbox.resample`), then > 127."""
    m = np.asarray(masks) > 0.5
    if m.shape[1:] == tuple(hw):
        return m
    return np.stack([resample(mk.astype(np.uint8) * 255, hw, "bicubic")
                     for mk in m]) > 127


def mask_to_poly_n(mask: np.ndarray) -> np.ndarray:
    """A mask's polygon, normalized xy [4, 2]: its bounding box's corners
    (none for an empty mask)."""
    m = np.asarray(mask) > 0.5
    h, w = m.shape
    ys, xs = np.nonzero(m)
    if not len(xs):
        return np.zeros((0, 2), np.float32)
    x1, x2, y1, y2 = xs.min(), xs.max() + 1, ys.min(), ys.max() + 1
    return np.asarray([[x1, y1], [x2, y1], [x2, y2], [x1, y2]],
                      np.float32) / np.asarray([w, h], np.float32)
