"""The clip training step (`train/train_step.make_train_step`) timed on one
card, and its input (`synthetic_clip`), which `chip_smoke.py` also trains
on.

    python3 -m mo_yolo_tpu_torch.scripts.train_bench [--steps N] [--out FILE]

The step of `chip_smoke.py`'s train phase: `yolo_track` at full width
(random weights from seed 0), bf16 autocast over f32 parameters, B=1,
5-frame clips at 1536x800 of 20 moving boxes padded to 64 GT slots, remat
on, the default AdamW. One warm-up step, then `--steps` steps, each timed
on the host clock from a synchronised start to its loss read back and a
synchronisation. One JSON line: each step's ms, their median, least and
greatest, the card and the package timed. Two checkouts compare on one
card when this file runs with each one's root first on the path, in turns
(A, B, B, A), all in one command:

    PYTHONPATH=path/to/checkout python3 mo_yolo_tpu_torch/scripts/train_bench.py
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch


def synthetic_clip(T, hw, nc, n_obj=20, seed=0, device="cuda", max_gt=64):
    """A clip of T uint8 frames [T,1,H,W,3] with `n_obj` rectangles that
    move at constant speed and keep their ids, and its targets padded to
    `max_gt` rows: gt_cls/gt_track_id [T,1,G], gt_boxes [T,1,G,4] cxcywh in
    [0, 1], gt_mask [T,1,G]."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h, np.full_like(xx, 96)],
                    -1).astype(np.uint8)
    wh = np.stack([rng.uniform(0.03, 0.08, n_obj),
                   rng.uniform(0.07, 0.18, n_obj)], -1)
    c0 = rng.uniform(0.15, 0.85, (n_obj, 2))
    vel = rng.uniform(-0.01, 0.01, (n_obj, 2))
    colour = rng.integers(0, 256, (n_obj, 3))
    images = np.empty((T, 1, h, w, 3), np.uint8)
    boxes = np.zeros((T, 1, max_gt, 4), np.float32)
    for t in range(T):
        img = base.copy()
        c = c0 + t * vel
        for k in range(n_obj):
            x0, y0 = ((c[k] - wh[k] / 2) * (w, h)).astype(int)
            x1, y1 = ((c[k] + wh[k] / 2) * (w, h)).astype(int)
            img[max(y0, 0):y1, max(x0, 0):x1] = colour[k]
        images[t, 0] = img
        boxes[t, 0, :n_obj] = np.concatenate([c, wh], -1)
    ids = np.full((T, 1, max_gt), -1, np.int32)
    ids[:, :, :n_obj] = np.arange(n_obj)
    mask = ids >= 0
    clip = {"images": images, "gt_cls": np.where(mask, ids % nc, 0),
            "gt_boxes": boxes, "gt_track_id": np.maximum(ids, 0),
            "gt_mask": mask}
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for k, a in clip.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8,
                    help="timed steps (default %(default)s)")
    ap.add_argument("--out", help="also write the record to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_bench: no CUDA device", file=sys.stderr)
        return 2
    from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
    from mo_yolo_tpu_torch.scripts.timing import card_line
    from mo_yolo_tpu_torch.train.losses import LossConfig
    from mo_yolo_tpu_torch.train.train_step import (TrainConfig,
                                                    make_train_step)
    from mo_yolo_tpu_torch.utils import cuda_build
    dev = torch.device("cuda")
    model = build_tracking_model("yolo_track", dtype="float32", device=dev,
                                 seed=0)
    tcfg = TrainConfig(clip_len=5)
    init_fn, step_fn = make_train_step(model, LossConfig(nc=model.spec.nc),
                                       tcfg, compute_dtype=torch.bfloat16)
    ts = init_fn()
    clip = synthetic_clip(tcfg.clip_len, (800, 1536), model.spec.nc,
                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ts, m = step_fn(ts, clip, gen)                      # warm-up
    float(m["loss"])
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, m = step_fn(ts, clip, gen)
        float(m["loss"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    rec = {"bench": "train_step", "imgsz": "1536x800",
           "clip_len": tcfg.clip_len, "step_ms": step_ms,
           "median_ms": statistics.median(step_ms), "min_ms": min(step_ms),
           "max_ms": max(step_ms), "card": card_line(dev),
           "package": str(cuda_build.CSRC.parent.parent)}
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
