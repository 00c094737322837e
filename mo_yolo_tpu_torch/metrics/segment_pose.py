"""Mask and keypoint metrics on the host, in numpy (the port's copy of
`mo_yolo_tpu/metrics/segment_pose.py`): box mAP beside mask mAP by mask
IoU (segmentation) or keypoint mAP by COCO OKS (pose), at the same ten
thresholds. The AP machinery is `metrics.detection`'s; only the
similarity changes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from mo_yolo_tpu_torch.metrics.detection import IOUV, DetMetrics

# COCO 17-keypoint sigmas (upstream `OKS_SIGMA`)
OKS_SIGMA_COCO17 = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
     .87, .87, .89, .89]) / 10.0


def mask_iou_np(gt_masks: np.ndarray, pred_masks: np.ndarray) -> np.ndarray:
    """[G,H,W] bool x [P,H,W] bool -> [G,P] IoU."""
    if len(gt_masks) == 0 or len(pred_masks) == 0:
        return np.zeros((len(gt_masks), len(pred_masks)))
    g = gt_masks.reshape(len(gt_masks), -1).astype(np.float32)
    p = pred_masks.reshape(len(pred_masks), -1).astype(np.float32)
    inter = g @ p.T
    union = g.sum(1)[:, None] + p.sum(1)[None] - inter
    return inter / np.maximum(union, 1e-9)


def oks_np(gt_kpts: np.ndarray, pred_kpts: np.ndarray, areas: np.ndarray,
           sigmas: Optional[np.ndarray] = None) -> np.ndarray:
    """COCO object-keypoint-similarity. gt [G,K,3] (x,y,vis) px,
    pred [P,K,>=2] px, areas [G] px^2 -> [G,P]."""
    G, P = len(gt_kpts), len(pred_kpts)
    if G == 0 or P == 0:
        return np.zeros((G, P))
    K = gt_kpts.shape[1]
    if sigmas is None:
        sigmas = (OKS_SIGMA_COCO17 if K == 17 else
                  np.full(K, 0.05, np.float64))
    d2 = ((gt_kpts[:, None, :, 0] - pred_kpts[None, :, :, 0]) ** 2 +
          (gt_kpts[:, None, :, 1] - pred_kpts[None, :, :, 1]) ** 2)
    vis = gt_kpts[..., 2] > 0                                  # [G,K]
    # upstream `kpt_iou`: d / (2*sigma)^2 / area / 2
    e = d2 / (((2 * sigmas[None, None]) ** 2) *
              (areas[:, None, None] + 1e-9) * 2)
    oks = np.exp(-e) * vis[:, None, :]
    n = np.maximum(vis.sum(-1), 1)[:, None]
    return oks.sum(-1) / n


def match_by_sim(sim: np.ndarray, gt_cls: np.ndarray,
                 pred_cls: np.ndarray, thresholds=IOUV) -> np.ndarray:
    """TP matrix [P, n_thr] by greedy class-aware matching over an
    arbitrary similarity matrix (generalizes `match_predictions`)."""
    tp = np.zeros((sim.shape[1], len(thresholds)), bool)
    if sim.size == 0:
        return tp
    sim = sim * (gt_cls[:, None] == pred_cls[None, :])
    for k, t in enumerate(thresholds):
        gi, pi = np.nonzero(sim >= t)
        if len(gi):
            order = np.argsort(-sim[gi, pi])
            gi, pi = gi[order], pi[order]
            used_g, used_p = set(), set()
            for g, p in zip(gi, pi):
                if g not in used_g and p not in used_p:
                    used_g.add(g)
                    used_p.add(p)
                    tp[p, k] = True
    return tp


class SimMetrics(DetMetrics):
    """DetMetrics with a caller-provided similarity matrix per image."""

    def update_sim(self, sim, pred_conf, pred_cls, gt_cls):
        self.tp.append(match_by_sim(np.asarray(sim), np.asarray(gt_cls),
                                    np.asarray(pred_cls)))
        self.conf.append(np.asarray(pred_conf))
        self.pred_cls.append(np.asarray(pred_cls))
        self.target_cls.append(np.asarray(gt_cls))


class SegmentMetrics:
    """Box mAP and mask mAP accumulated together: keys `<metric>(B)` and
    `<metric>(M)`."""

    def __init__(self, nc: int):
        self.box = DetMetrics(nc)
        self.mask = SimMetrics(nc)

    def update(self, pred_boxes, pred_masks, pred_conf, pred_cls,
               gt_boxes, gt_masks, gt_cls):
        self.box.update(pred_boxes, pred_conf, pred_cls, gt_boxes, gt_cls)
        self.mask.update_sim(mask_iou_np(gt_masks, pred_masks), pred_conf,
                             pred_cls, gt_cls)

    def compute(self) -> Dict[str, float]:
        b = self.box.compute()
        m = self.mask.compute()
        out = {f"{k}(B)": v for k, v in b.items()}
        out.update({f"{k}(M)": v for k, v in m.items()})
        return out


class PoseMetrics:
    """Box mAP and OKS keypoint mAP: keys `<metric>(B)` and `<metric>(P)`."""

    def __init__(self, nc: int, sigmas: Optional[np.ndarray] = None):
        self.box = DetMetrics(nc)
        self.kpt = SimMetrics(nc)
        self.sigmas = sigmas

    def update(self, pred_boxes, pred_kpts, pred_conf, pred_cls,
               gt_boxes, gt_kpts, gt_cls):
        areas = np.maximum(
            (gt_boxes[:, 2] - gt_boxes[:, 0]) *
            (gt_boxes[:, 3] - gt_boxes[:, 1]), 1e-9) * 0.53
        self.box.update(pred_boxes, pred_conf, pred_cls, gt_boxes, gt_cls)
        self.kpt.update_sim(
            oks_np(gt_kpts, pred_kpts, areas, self.sigmas),
            pred_conf, pred_cls, gt_cls)

    def compute(self) -> Dict[str, float]:
        b = self.box.compute()
        k = self.kpt.compute()
        out = {f"{kk}(B)": v for kk, v in b.items()}
        out.update({f"{kk}(P)": v for kk, v in k.items()})
        return out
