"""Segmentation-polygon and pose-keypoint labels (the port's copies of
`parse_seg_label`, `polygons_to_boxes`, `parse_pose_label` and
`rasterize_polygons` from `mo_yolo_tpu/data/seg_pose_labels.py`).

    seg row:  `cls x1 y1 x2 y2 x3 y3 ...`       (normalized polygon, >= 3 points)
    pose row: `cls cx cy w h px1 py1 v1 ... pxK pyK vK`  (normalized)

The JAX package rasterizes a polygon with PIL's `ImageDraw.polygon(...,
outline=1, fill=1)`; the machine with the card has no PIL, so
`rasterize_polygons` draws in numpy by PIL's rules: vertices truncated to
ints, each horizontal edge drawn whole, a scanline fill over the other
edges in float32 (a span from `ROUND_UP` of its start to `ROUND_DOWN` of
its end, an edge's last row counted twice above the polygon's bottom),
and PIL's widening of a sharp corner: where two edges leave a vertex on
the same side, downwards (or upwards at the polygon's last row), one of
the vertex's two crossings moves to one pixel short of where the edges
cross the next row. (An outline in the fill's own colour is not drawn
again.) It equals PIL pixel for pixel wherever no vertex is visited
twice (`tests/test_torch_port_tasks.py`).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

_f32 = np.float32


def parse_seg_label(path: str) -> Tuple[np.ndarray, list]:
    """-> (cls [N], polygons: a list of [M, 2] normalized arrays)."""
    cls, polys = [], []
    try:
        rows = open(path).read().strip().splitlines()
    except OSError:
        return np.zeros(0, np.int32), []
    for row in rows:
        v = row.split()
        if len(v) < 7 or (len(v) - 1) % 2:
            continue
        cls.append(int(float(v[0])))
        polys.append(np.asarray(v[1:], np.float32).reshape(-1, 2))
    return np.asarray(cls, np.int32), polys


def polygons_to_boxes(polys) -> np.ndarray:
    """Normalized polygons -> xyxy normalized boxes [N, 4]."""
    if not polys:
        return np.zeros((0, 4), np.float32)
    return np.stack([
        np.array([p[:, 0].min(), p[:, 1].min(), p[:, 0].max(),
                  p[:, 1].max()], np.float32) for p in polys])


def parse_pose_label(path: str, n_kpt: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (cls [N], boxes cxcywh normalized [N, 4], keypoints [N, K, 3]
    normalized xy and visibility)."""
    cls, boxes, kpts = [], [], []
    want = 5 + 3 * n_kpt
    try:
        rows = open(path).read().strip().splitlines()
    except OSError:
        rows = []
    for row in rows:
        v = row.split()
        if len(v) != want:
            continue
        cls.append(int(float(v[0])))
        boxes.append(np.asarray(v[1:5], np.float32))
        kpts.append(np.asarray(v[5:], np.float32).reshape(n_kpt, 3))
    if not cls:
        return (np.zeros(0, np.int32), np.zeros((0, 4), np.float32),
                np.zeros((0, n_kpt, 3), np.float32))
    return np.asarray(cls, np.int32), np.stack(boxes), np.stack(kpts)


def rasterize_polygons(polys, size: int) -> np.ndarray:
    """Normalized polygons -> [N, size, size] bool masks."""
    out = np.zeros((len(polys), size, size), bool)
    for i, p in enumerate(polys):
        p = np.asarray(p, np.float32)
        # the JAX package hands PIL float(x * size), an f32 product
        fill_polygon(out[i], [(float(x * _f32(size)), float(y * _f32(size)))
                              for x, y in p])
    return out


def _round_up(f) -> int:
    f = _f32(f)
    return int(math.floor(_f32(f + _f32(0.5)))) if f >= 0 else \
        int(-math.floor(abs(float(f)) + 0.5))


def _round_down(f) -> int:
    f = _f32(f)
    return int(math.ceil(_f32(f - _f32(0.5)))) if f >= 0 else \
        int(-math.ceil(abs(float(f)) - 0.5))


class _Edge:
    __slots__ = ("xmin", "xmax", "ymin", "ymax", "x0", "y0", "x1", "dx")

    def __init__(self, x0: int, y0: int, x1: int, y1: int):
        self.xmin, self.xmax = min(x0, x1), max(x0, x1)
        self.ymin, self.ymax = min(y0, y1), max(y0, y1)
        self.x0, self.y0, self.x1 = x0, y0, x1
        self.dx = _f32(0) if y0 == y1 else _f32(_f32(x1 - x0) /
                                                _f32(y1 - y0))

    def x_at(self, y: int):
        return _f32(_f32(y - self.y0) * self.dx + _f32(self.x0))


def fill_polygon(img: np.ndarray, pts) -> np.ndarray:
    """Fill the polygon `pts` ((x, y) floats) with 1 in the 2-D array
    `img`, as PIL's `ImageDraw.polygon(pts, fill=1, outline=1)` does on a
    mode "L" image; returns `img`."""
    H, W = img.shape
    xy = [(int(x), int(y)) for x, y in pts]

    def hline(x0: int, y: int, x1: int) -> None:
        if 0 <= y < H:
            x0, x1 = max(x0, 0), min(x1, W - 1)
            if x0 <= x1:
                img[y, x0:x1 + 1] = 1

    edges: List[_Edge] = []
    for i in range(len(xy) - 1):
        (x0, y0), (x1, y1) = xy[i], xy[i + 1]
        if y0 == y1 and i and y0 == xy[i - 1][1]:
            # a horizontal edge after another, in the same direction: one
            if x1 > x0 > xy[i - 1][0]:
                edges[-1].xmax = x1
                continue
            if x1 < x0 < xy[i - 1][0]:
                edges[-1].xmin = x1
                continue
        edges.append(_Edge(x0, y0, x1, y1))
    if xy and xy[-1] != xy[0]:
        edges.append(_Edge(*xy[-1], *xy[0]))
    if not edges:
        return img
    ymin = max(min([H - 1] + [e.ymin for e in edges]), 0)
    ymax = min(max([0] + [e.ymax for e in edges]), H)
    table = []
    for e in edges:
        if e.ymin == e.ymax:
            hline(e.xmin, e.ymin, e.xmax)
        else:
            table.append(e)
    for y in range(ymin, ymax + 1):
        xs: List[list] = []        # [x, moved by a sharp corner]
        ends = {}                  # (vertex x, dx > 0, at its ymax) -> edges
        for e in table:
            if e.ymin <= y <= e.ymax:
                slot = len(xs)
                xs.append([e.x_at(y), False])
                if y == e.ymax and y < ymax:
                    xs.append([xs[-1][0], False])
                elif y in (e.ymin, e.ymax):
                    vx = e.x0 if e.y0 == y else e.x1
                    ends.setdefault((vx, e.dx > 0, y == e.ymax),
                                    []).append((e, slot))
        for (vx, pos, bottom), pair in ends.items():
            if len(pair) < 2:
                continue
            off = -1 if bottom else 1
            a, b = pair[0][0].x_at(y + off), pair[1][0].x_at(y + off)
            right = pos != bottom      # both edges leave to the right
            moved = _f32(min(a, b) - 1) if right else _f32(max(a, b) + 1)
            if (moved > vx) if right else (moved < vx):
                xs[pair[0][1]] = [moved, True]
        xs.sort(key=lambda t: t[0])
        for k in range(1, len(xs), 2):
            (a, ma), (b, mb) = xs[k - 1], xs[k]
            start = math.floor(a + _f32(0.5)) if ma else _round_up(a)
            end = math.floor(b + _f32(0.5)) if mb else _round_down(b)
            if end >= start:
                hline(int(start), y, int(end))
    return img
