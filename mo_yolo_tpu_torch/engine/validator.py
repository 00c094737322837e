"""Tracking validators: per-sequence streaming evaluation with HOTA, CLEAR
(MOTA, IDSW), IDF1 and detection mAP (the port's copies of
`TrackValidator`, `MultiStreamValidator` and `dedup_for_map` from
`mo_yolo_tpu/engine/validator.py`).

Frames go in sequence order (`TrackDataset`: grouped by `video_key`, each
video in string order). The track state starts afresh at each sequence
boundary. Each frame is letterboxed on the host, its uint8 image goes to
the device, one `stream_step` runs, and its packed [1, M, 8] result comes
back to the host once, after the step. The metrics run on the host.
`MultiStreamValidator` runs several sequences at once as the batch.
`DetectionValidator` scores a detection model's frames by mAP alone;
`SegmentationValidator` and `PoseValidator` a task model's images by box
mAP and mask or keypoint mAP, and `classify_accuracy` a classifier's
top-1 and top-5 accuracy.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mo_yolo_tpu_torch.data.dataset import TrackDataset, video_key
from mo_yolo_tpu_torch.metrics import hota as hota_m
from mo_yolo_tpu_torch.metrics.detection import DetMetrics, box_iou_np
from mo_yolo_tpu_torch.metrics.mot import clear_mot, idf1, pool_idf1
from mo_yolo_tpu_torch.models.tracker import unpack_outputs
from mo_yolo_tpu_torch.parallel.mesh import make_sharded_stream_step
from mo_yolo_tpu_torch.utils.callbacks import CallbackBus


def _xywhn2xyxy(b: np.ndarray, size: float = 1.0) -> np.ndarray:
    return np.stack([
        (b[:, 0] - b[:, 2] / 2) * size, (b[:, 1] - b[:, 3] / 2) * size,
        (b[:, 0] + b[:, 2] / 2) * size, (b[:, 1] + b[:, 3] / 2) * size], 1)


def dedup_for_map(boxes_xyxy: np.ndarray, scores: np.ndarray,
                  cls: np.ndarray, iou_thresh: float = 0.7) -> np.ndarray:
    """Score-ranked class-aware NMS over the combined [track | detect]
    output set, with no confidence floor: a tracked object is predicted by
    its track slot and again by a detect query, and the raw union would
    count one false positive per tracked object in mAP.

    Returns the kept indices (descending score order)."""
    if len(scores) == 0:
        return np.zeros(0, int)
    order = np.argsort(-scores)
    iou = box_iou_np(boxes_xyxy, boxes_xyxy)
    keep: List[int] = []
    for i in order:
        dup = False
        for k in keep:
            if cls[k] == cls[i] and iou[i, k] > iou_thresh:
                dup = True
                break
        if not dup:
            keep.append(int(i))
    return np.asarray(keep, int)


def _score_frame(o: Dict[str, np.ndarray], smp, conf: float,
                 det_conf: float, det: DetMetrics):
    """One frame's unpacked outputs `o` [M rows] against its sample `smp`:
    returns the tracking streams' entries (GT ids, predicted ids, their
    IoU matrix, GT boxes, predicted boxes; live tracks above `conf`), and
    adds the frame to the mAP stream `det`."""
    keep = o["valid"] & (o["obj_id"] >= 0) & (o["score"] >= conf)
    pr_boxes = _xywhn2xyxy(o["box"][keep])
    gt_boxes = _xywhn2xyxy(smp.boxes[smp.mask])
    sim = box_iou_np(gt_boxes, pr_boxes)
    # mAP sees every output above det_conf, tracked or not (the `valid` gate
    # is for the HOTA/CLEAR streams only), with the track/detect duplicates
    # removed
    det_keep = np.nonzero(o["score"] >= det_conf)[0]
    db = _xywhn2xyxy(o["box"][det_keep])
    ds_ = o["score"][det_keep]
    dc = o["cls"][det_keep]
    kept = dedup_for_map(db, ds_, dc)
    det.update(db[kept], ds_[kept], dc[kept], gt_boxes, smp.cls[smp.mask])
    return smp.track_id[smp.mask], o["obj_id"][keep], sim, gt_boxes, pr_boxes


def _summarize(seq_results: List, clear_accum: List, idf1_accum: List,
               det: DetMetrics, n_frames: int, t0: float) -> Dict[str, float]:
    """The metrics dict: HOTA and its parts averaged over the sequences,
    CLEAR and IDF1 pooled, the mAP stream's numbers and the frames/s since
    `t0`."""
    out = hota_m.summarize(seq_results)
    if clear_accum:
        n_gt = sum(c["n_gt"] for c in clear_accum)
        out["MOTA"] = 100 * (1 - sum(c["FN"] + c["FP"] + c["IDSW"]
                                     for c in clear_accum) / max(n_gt, 1))
        out["IDSW"] = int(sum(c["IDSW"] for c in clear_accum))
        out.update(pool_idf1(idf1_accum))
    out.update(det.compute())
    out["fps"] = n_frames / max(time.perf_counter() - t0, 1e-9)
    return out


class TrackValidator:
    """`validator(img_files, max_gt)` -> metrics dict. `model` is a port
    `TrackingModel` (its device is the validator's); `collect=True` keeps
    each sequence's per-frame streams on `self.sequences` as (seq_key,
    gt_ids, pr_ids, sims, gt_boxes, pr_boxes)."""

    def __init__(self, model, imgsz=640, conf: float = 0.5,
                 nc: Optional[int] = None, det_conf: float = 0.001,
                 callbacks: Optional[CallbackBus] = None,
                 collect: bool = False):
        self.callbacks = callbacks or CallbackBus()
        self.model = model
        self.device = next(model.parameters()).device
        self.imgsz = imgsz
        self.conf = conf
        self.det_conf = det_conf
        self.nc = nc or model.spec.nc
        self.collect = collect
        self.sequences: List[tuple] = []

    def __call__(self, img_files: List[str], max_gt: int = 64
                 ) -> Dict[str, float]:
        self.callbacks.fire("on_val_start", validator=self)
        ds = TrackDataset(img_files, imgsz=self.imgsz, max_gt=max_gt,
                          clip_len=1)
        det = DetMetrics(self.nc)
        seq_results = []
        clear_accum = []
        idf1_accum = []
        cur_seq = None
        gt_ids_seq: List[np.ndarray] = []
        pr_ids_seq: List[np.ndarray] = []
        sim_seq: List[np.ndarray] = []
        gt_boxes_seq: List[np.ndarray] = []
        pr_boxes_seq: List[np.ndarray] = []
        state = None
        self.sequences = []
        t0 = time.perf_counter()

        def flush():
            if gt_ids_seq:
                seq_results.append(
                    hota_m.eval_sequence(gt_ids_seq, pr_ids_seq, sim_seq))
                clear_accum.append(clear_mot(gt_ids_seq, pr_ids_seq, sim_seq))
                idf1_accum.append(idf1(gt_ids_seq, pr_ids_seq, sim_seq))
                if self.collect:
                    self.sequences.append(
                        (cur_seq, list(gt_ids_seq), list(pr_ids_seq),
                         list(sim_seq), list(gt_boxes_seq),
                         list(pr_boxes_seq)))

        for i in range(len(ds)):
            seq = video_key(ds.files[i])
            if seq != cur_seq:
                flush()
                gt_ids_seq, pr_ids_seq, sim_seq = [], [], []
                gt_boxes_seq, pr_boxes_seq = [], []
                cur_seq = seq
                state = self.model.init_state(1)
            s = ds.load_frame(i)
            x = torch.from_numpy(s.image[None]).to(self.device)
            state, packed = self.model.stream_step(state, x)
            o = unpack_outputs(packed[0])     # the frame's one copy back
            gt_ids, pr_ids, sim, gt_boxes, pr_boxes = _score_frame(
                o, s, self.conf, self.det_conf, det)
            gt_ids_seq.append(gt_ids)
            pr_ids_seq.append(pr_ids)
            sim_seq.append(sim)
            if self.collect:
                gt_boxes_seq.append(gt_boxes)
                pr_boxes_seq.append(pr_boxes)
        flush()

        out = _summarize(seq_results, clear_accum, idf1_accum, det, len(ds),
                         t0)
        self.callbacks.fire("on_val_end", validator=self, metrics=out)
        return out


class MultiStreamValidator:
    """`validator(img_files, max_gt)` -> the metrics of `TrackValidator`
    (per-sequence HOTA, pooled CLEAR and IDF1, mAP over the deduplicated
    outputs), with the sequences in waves of up to `streams` that advance
    in lockstep through one batched `stream_step` (the counterpart of
    `MultiStreamValidator` in `mo_yolo_tpu/engine/validator.py`, whose
    wave width is its mesh size). A sequence that ends before its wave
    keeps feeding its last frame, which no metric sees. One copy of the
    packed [B, M, 8] result comes back a frame."""

    def __init__(self, model, imgsz=640, conf: float = 0.5,
                 nc: Optional[int] = None, det_conf: float = 0.001,
                 streams: int = 8):
        if streams < 1:
            raise ValueError(f"streams must be >= 1, got {streams}")
        self.model = model
        self.device = next(model.parameters()).device
        self.imgsz = imgsz
        self.conf = conf
        self.det_conf = det_conf
        self.nc = nc or model.spec.nc
        self.streams = streams
        self._step = make_sharded_stream_step(model)

    def __call__(self, img_files: List[str], max_gt: int = 64
                 ) -> Dict[str, float]:
        ds = TrackDataset(img_files, imgsz=self.imgsz, max_gt=max_gt,
                          clip_len=1)
        seqs = list(ds.videos.values())     # each sequence's frame indices
        det = DetMetrics(self.nc)
        seq_results, clear_accum, idf1_accum = [], [], []
        t0 = time.perf_counter()
        for start in range(0, len(seqs), self.streams):
            wave = seqs[start:start + self.streams]
            B = len(wave)
            state = self.model.init_state(B)
            bufs = [([], [], []) for _ in wave]
            batch = None
            for t in range(max(len(s) for s in wave)):
                samples = [ds.load_frame(s[t]) if t < len(s) else None
                           for s in wave]
                if batch is None:
                    batch = np.stack([s.image for s in samples])
                for b, smp in enumerate(samples):
                    if smp is not None:
                        batch[b] = smp.image
                x = torch.from_numpy(batch).to(self.device)
                state, packed = self._step(state, x)
                out = unpack_outputs(packed)      # one copy back for all B
                for b, smp in enumerate(samples):
                    if smp is not None:
                        frame = _score_frame({k: v[b] for k, v in out.items()},
                                             smp, self.conf, self.det_conf,
                                             det)
                        for seq, entry in zip(bufs[b], frame):
                            seq.append(entry)
            for gt_ids, pr_ids, sims in bufs:
                seq_results.append(hota_m.eval_sequence(gt_ids, pr_ids, sims))
                clear_accum.append(clear_mot(gt_ids, pr_ids, sims))
                idf1_accum.append(idf1(gt_ids, pr_ids, sims))
        return _summarize(seq_results, clear_accum, idf1_accum, det, len(ds),
                          t0)


class DetectionValidator:
    """`validator(img_files, max_gt)` -> mAP50, mAP50-95, precision,
    recall and fps of a `DetectionModel` (the port's copy of
    `DetectionValidator` in `mo_yolo_tpu/engine/validator.py`): each frame
    letterboxed on the host, one `predict_step`, every query at or above
    `conf` scored against the frame's 5- or 6-column labels (track ids
    ignored). `save_json` writes COCO records in original-image pixels to
    `save_dir/predictions.json`; `save_hybrid` writes a label file a frame
    under `save_dir/labels` with the GT rows and the predictions at 0.25
    or above."""

    def __init__(self, model, imgsz=640, conf: float = 0.001,
                 nc: Optional[int] = None, save_json: bool = False,
                 save_dir: str = "runs/detect/val",
                 save_hybrid: bool = False,
                 callbacks: Optional[CallbackBus] = None):
        from mo_yolo_tpu_torch.data.letterbox import to_hw
        self.callbacks = callbacks or CallbackBus()
        self.model = model
        self.device = next(model.parameters()).device
        self.imgsz = imgsz
        self.in_h, self.in_w = to_hw(imgsz)
        self.conf = conf
        self.nc = nc or model.spec.nc
        self.save_json = save_json
        self.save_dir = save_dir
        self.save_hybrid = save_hybrid

    def __call__(self, img_files: List[str], max_gt: int = 64
                 ) -> Dict[str, float]:
        self.callbacks.fire("on_val_start", validator=self)
        ds = TrackDataset(img_files, imgsz=self.imgsz, max_gt=max_gt,
                          clip_len=1)
        det = DetMetrics(self.nc)
        records = []
        t0 = time.perf_counter()
        for i in range(len(ds)):
            s = ds.load_frame(i)
            x = torch.from_numpy(s.image[None]).to(self.device)
            boxes, scores, cls = (t[0].cpu().numpy() for t in
                                  self.model.predict_step(x))
            keep = scores >= self.conf
            gt_xyxy = _xywhn2xyxy(s.boxes[s.mask])
            det.update(_xywhn2xyxy(boxes[keep]), scores[keep], cls[keep],
                       gt_xyxy, s.cls[s.mask])
            stem = Path(ds.files[i]).stem
            if self.save_json:
                records += self._coco_records(s, stem, boxes[keep],
                                              scores[keep], cls[keep])
            if self.save_hybrid:
                strong = keep & (scores >= 0.25)
                rows = [f"{int(c)} " + " ".join(f"{v:.6f}" for v in b)
                        for c, b in zip(
                            np.concatenate([s.cls[s.mask], cls[strong]]),
                            np.concatenate([s.boxes[s.mask], boxes[strong]]))]
                labels = Path(self.save_dir) / "labels"
                labels.mkdir(parents=True, exist_ok=True)
                (labels / f"{stem}.txt").write_text("\n".join(rows) + "\n")
        out = det.compute()
        out["fps"] = len(ds) / max(time.perf_counter() - t0, 1e-9)
        if self.save_json:
            import json
            p = Path(self.save_dir)
            p.mkdir(parents=True, exist_ok=True)
            with open(p / "predictions.json", "w") as f:
                json.dump(records, f)
        self.callbacks.fire("on_val_end", validator=self, metrics=out)
        return out

    def _coco_records(self, s, stem: str, boxes: np.ndarray,
                      scores: np.ndarray, cls: np.ndarray) -> List[Dict]:
        """COCO detection records: the top-left xywh box in the original
        image's pixels (the letterbox's gain and padding undone, clipped to
        the image); a numeric stem is the integer image id."""
        xyxy = _xywhn2xyxy(boxes) * np.array(
            [self.in_w, self.in_h, self.in_w, self.in_h], float)
        px, py = s.pad
        xyxy = (xyxy - np.array([px, py, px, py], float)) / max(s.gain, 1e-9)
        h0, w0 = s.orig_hw
        xyxy[:, [0, 2]] = xyxy[:, [0, 2]].clip(0, w0)
        xyxy[:, [1, 3]] = xyxy[:, [1, 3]].clip(0, h0)
        image_id = int(stem) if stem.isnumeric() else stem
        out = []
        for (x1, y1, x2, y2), c, sc in zip(xyxy.tolist(), cls, scores):
            out.append({"image_id": image_id, "category_id": int(c),
                        "bbox": [round(x1, 3), round(y1, 3),
                                 round(x2 - x1, 3), round(y2 - y1, 3)],
                        "score": round(float(sc), 5)})
        return out


def _to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """The tensors as numpy arrays through one copy to the host: each
    flattened into one f32 buffer (every value here is exact in f32),
    split and cast back to its dtype."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].reshape(t.shape).astype(
            torch.empty((), dtype=t.dtype).numpy().dtype, copy=False))
        at += n
    return out


def _task_image(path: str, imgsz: int, device) -> torch.Tensor:
    from mo_yolo_tpu_torch.train.task_trainers import load_resized
    return torch.from_numpy(load_resized(path, imgsz)[None]).to(device)


class SegmentationValidator:
    """`validator(img_files)` -> box and mask mAP50, mAP50-95, precision,
    recall (keys `(B)` and `(M)`) and fps of a `SegmentationModel` (the
    port's copy of `SegmentationValidator` in
    `mo_yolo_tpu/engine/validator.py`): each image stretched to `imgsz`,
    one `predict_step` (NMS by the greedy kernel on the card), the kept
    masks composed on the device at the prototypes' resolution (or
    resized, nearest, to `mask_size`) and copied back with the boxes in
    one transfer; the polygon labels rasterized at `mask_size`."""

    def __init__(self, model, imgsz: int = 256, mask_size: int = 0,
                 callbacks: Optional[CallbackBus] = None):
        self.callbacks = callbacks or CallbackBus()
        self.model = model
        self.device = next(model.parameters()).device
        self.imgsz = imgsz
        self.mask_size = mask_size or imgsz // 4

    def __call__(self, img_files: List[str]) -> Dict[str, float]:
        from mo_yolo_tpu_torch.data.dataset import img2label_path
        from mo_yolo_tpu_torch.data.seg_pose_labels import (
            parse_seg_label, polygons_to_boxes, rasterize_polygons)
        from mo_yolo_tpu_torch.metrics.segment_pose import SegmentMetrics
        from mo_yolo_tpu_torch.models.heads_extra import masks_from
        self.callbacks.fire("on_val_start", validator=self)
        m = SegmentMetrics(self.model.spec.nc)
        ms = self.mask_size
        t0 = time.perf_counter()
        for f in img_files:
            boxes, scores, cls, coef, protos = self.model.predict_step(
                _task_image(f, self.imgsz, self.device))
            masks = masks_from(coef, protos)[0] > 0.5
            if masks.shape[-1] != ms:
                masks = F.interpolate(masks[None].float(), size=(ms, ms),
                                      mode="nearest-exact")[0] > 0.5
            boxes, scores, cls, masks = _to_host(boxes[0], scores[0], cls[0],
                                                 masks)
            keep = scores > 0
            gcls, polys = parse_seg_label(img2label_path(f))
            m.update(boxes[keep] / self.imgsz, masks[keep], scores[keep],
                     cls[keep], polygons_to_boxes(polys),
                     rasterize_polygons(polys, ms), gcls)
        out = m.compute()
        out["fps"] = len(img_files) / max(time.perf_counter() - t0, 1e-9)
        self.callbacks.fire("on_val_end", validator=self, metrics=out)
        return out


class PoseValidator:
    """`validator(img_files)` -> box and keypoint (OKS) mAP50, mAP50-95,
    precision, recall (keys `(B)` and `(P)`) and fps of a `PoseModel`: each
    image stretched to `imgsz`, one `predict_step`, one transfer back."""

    def __init__(self, model, imgsz: int = 256,
                 callbacks: Optional[CallbackBus] = None):
        self.callbacks = callbacks or CallbackBus()
        self.model = model
        self.device = next(model.parameters()).device
        self.imgsz = imgsz

    def __call__(self, img_files: List[str]) -> Dict[str, float]:
        from mo_yolo_tpu_torch.data.dataset import img2label_path
        from mo_yolo_tpu_torch.data.seg_pose_labels import parse_pose_label
        from mo_yolo_tpu_torch.metrics.segment_pose import PoseMetrics
        self.callbacks.fire("on_val_start", validator=self)
        K = self.model.kpt_shape[0]
        m = PoseMetrics(self.model.spec.nc)
        s = self.imgsz
        t0 = time.perf_counter()
        for f in img_files:
            out = self.model.predict_step(_task_image(f, s, self.device))
            boxes, scores, cls, kpts = _to_host(*(t[0] for t in out))
            keep = scores > 0
            gcls, gboxes, gkpts = parse_pose_label(img2label_path(f), K)
            gk = gkpts.copy()
            gk[..., :2] *= s
            m.update(boxes[keep], kpts[keep], scores[keep], cls[keep],
                     _xywhn2xyxy(gboxes, s), gk, gcls)
        out = m.compute()
        out["fps"] = len(img_files) / max(time.perf_counter() - t0, 1e-9)
        self.callbacks.fire("on_val_end", validator=self, metrics=out)
        return out


def classify_accuracy(model, root, imgsz: int,
                      callbacks: Optional[CallbackBus] = None
                      ) -> Dict[str, float]:
    """Top-1 and top-5 accuracy (in %) and the image count of a classifier
    over a class-subdir tree: its held-out split (`test/`, else `val/`)
    where it has a `train/` subtree, else the whole tree."""
    from mo_yolo_tpu_torch.train.task_trainers import class_files, class_tree
    callbacks = callbacks or CallbackBus()
    callbacks.fire("on_val_start", validator=model)
    train_root, held = class_tree(root)
    root = held or train_root
    classes = sorted(p.name for p in root.iterdir() if p.is_dir())
    files, labels = class_files(root, classes)
    dev = next(model.parameters()).device
    top1 = top5 = 0
    with torch.no_grad():
        for f, ci in zip(files, labels):
            logits = model(_task_image(f, imgsz, dev))[0].float().cpu().numpy()
            order = np.argsort(-logits)
            top1 += int(order[0] == ci)
            top5 += int(ci in order[:5])
    n = len(files)
    out = {"accuracy_top1": 100.0 * top1 / max(n, 1),
           "accuracy_top5": 100.0 * top5 / max(n, 1), "n": n}
    callbacks.fire("on_val_end", validator=model, metrics=out)
    return out
