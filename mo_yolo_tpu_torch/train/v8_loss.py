"""YOLOv8 task losses: task-aligned assignment, then BCE, CIoU and DFL (the
port's copy of `mo_yolo_tpu/train/v8_loss.py`).

Anchors inside a GT box are its candidates; alignment = class score^alpha
· CIoU^beta; each GT takes its top-k anchors, and an anchor claimed by
several GTs goes to the one it overlaps most. The loss is BCE over the
aligned target scores, CIoU on the boxes and distribution-focal loss over
the DFL bins, with gains box 7.5, cls 0.5, dfl 1.5; the segmentation loss
adds a mask BCE a foreground anchor, the pose loss an OKS-style keypoint
term and a visibility BCE. GT is padded to [B, G] with a mask, so every
shape is fixed and nothing comes to the host.

The assignment runs under `torch.no_grad()` on detached scores and boxes,
as upstream's `TaskAlignedAssigner` does: its targets carry no gradient.
The JAX `task_aligned_assign` has no `stop_gradient`, so there the target
scores (the BCE target and the box and DFL weights) pass gradient back
into the logits and the DFL bins (ROADMAP Queue 3); loss values are the
same.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from mo_yolo_tpu_torch.models.detect import dfl_decode
from mo_yolo_tpu_torch.ops.boxes import elementwise_ciou, pairwise_ciou
from mo_yolo_tpu_torch.train.losses import sigmoid_bce

# COCO 17-keypoint OKS sigmas (upstream `OKS_SIGMA`)
OKS_SIGMA_COCO17 = (.026, .025, .025, .035, .035, .079, .079, .072, .072,
                    .062, .062, .107, .107, .087, .087, .089, .089)


@dataclasses.dataclass(frozen=True)
class V8LossConfig:
    nc: int
    reg_max: int = 16
    topk: int = 10
    alpha: float = 0.5
    beta: float = 6.0
    gain_box: float = 7.5
    gain_cls: float = 0.5
    gain_dfl: float = 1.5


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B,G,...] at idx [B,S] along dim 1 -> [B,S,...]."""
    return t[torch.arange(t.shape[0], device=t.device)[:, None], idx]


@torch.no_grad()
def task_aligned_assign(cfg: V8LossConfig, pd_scores: torch.Tensor,
                        pd_bboxes: torch.Tensor, anc_points: torch.Tensor,
                        gt_labels: torch.Tensor, gt_bboxes: torch.Tensor,
                        gt_mask: torch.Tensor):
    """pd_scores [B,S,nc] sigmoided, pd_bboxes [B,S,4] xyxy px, anc_points
    [S,2] centres px, gt_labels [B,G] int, gt_bboxes [B,G,4] xyxy px,
    gt_mask [B,G] bool. Returns (target_labels [B,S], target_bboxes
    [B,S,4], target_scores [B,S,nc], fg_mask [B,S], assigned_gt [B,S]).
    Top-k takes equal metrics in index order and every argmax the first
    maximum, as `jax.lax.top_k` and `jnp.argmax`."""
    pd_scores, pd_bboxes = pd_scores.detach(), pd_bboxes.detach()
    B, S, nc = pd_scores.shape
    G = gt_labels.shape[1]
    ax, ay = anc_points[:, 0], anc_points[:, 1]
    in_gt = ((ax > gt_bboxes[..., 0:1]) & (ax < gt_bboxes[..., 2:3]) &
             (ay > gt_bboxes[..., 1:2]) & (ay < gt_bboxes[..., 3:4]))
    in_gt &= gt_mask[..., None]                                   # [B,G,S]
    iou = pairwise_ciou(gt_bboxes, pd_bboxes).clamp(min=0.0)      # [B,G,S]
    labels = gt_labels.long().clamp(0, nc - 1)
    cls_score = torch.gather(pd_scores.transpose(1, 2), 1,
                             labels[..., None].expand(B, G, S))
    metric = cls_score ** cfg.alpha * iou ** cfg.beta
    metric = torch.where(in_gt, metric, torch.zeros_like(metric))
    vals, idx = torch.sort(metric, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :cfg.topk], idx[..., :cfg.topk]
    cand = torch.zeros_like(in_gt).scatter_(2, idx, vals > 1e-9)
    # an anchor claimed by several GTs goes to its highest-CIoU one
    n_claims = cand.sum(1)
    best_gt = torch.where(cand, iou, torch.full_like(iou, -1.0)).argmax(1)
    keep = cand & (torch.arange(G, device=cand.device)[None, :, None] ==
                   best_gt[:, None, :])
    cand = torch.where((n_claims > 1)[:, None, :], keep, cand)
    fg = cand.any(1)                                              # [B,S]
    assigned = cand.to(torch.uint8).argmax(1)                     # [B,S]
    target_labels = torch.gather(gt_labels, 1, assigned)
    target_bboxes = _take(gt_bboxes, assigned)
    # target scores: the metric scaled by each GT's largest CIoU over its
    # largest metric
    norm = metric * iou.amax(2, keepdim=True) / \
        metric.amax(2, keepdim=True).clamp(min=1e-9)
    norm_a = torch.gather(norm.transpose(1, 2), 2, assigned[..., None])[..., 0]
    onehot = (target_labels[..., None] ==
              torch.arange(nc, device=gt_labels.device)).to(pd_scores.dtype)
    target_scores = onehot * (norm_a * fg)[..., None]
    return target_labels, target_bboxes, target_scores, fg, assigned


def _detection(cfg: V8LossConfig, box_dist, cls_logits, anc_points, strides,
               gt_labels, gt_bboxes_xyxy, gt_mask
               ) -> Tuple[Dict[str, torch.Tensor], Tuple[torch.Tensor,
                                                          torch.Tensor]]:
    """The detection loss terms, and the foreground and assigned GT that
    the task losses reuse."""
    R = box_dist.shape[-1]
    pd_bboxes = dfl_decode(box_dist, anc_points, strides)
    _, tb, ts, fg, assigned = task_aligned_assign(
        cfg, cls_logits.sigmoid(), pd_bboxes, anc_points * strides[:, None],
        gt_labels, gt_bboxes_xyxy, gt_mask)
    ts_sum = ts.sum().clamp(min=1.0)
    cls_loss = sigmoid_bce(cls_logits, ts).sum() / ts_sum
    w = ts.sum(-1) * fg                                           # [B,S]
    ciou = elementwise_ciou(pd_bboxes, tb, xywh=False)
    box_loss = ((1.0 - ciou) * w).sum() / ts_sum
    st = strides[None, :, None]
    tdist = torch.cat([anc_points[None] - tb[..., :2] / st,
                       tb[..., 2:] / st - anc_points[None]], -1
                      ).clamp(0, R - 1 - 0.01)
    tl = tdist.floor()
    wr = tdist - tl
    logp = F.log_softmax(box_dist, -1)

    def at(i):
        return torch.gather(logp, -1, i.long()[..., None])[..., 0]
    dfl = -(at(tl) * (1.0 - wr) + at((tl + 1).clamp(max=R - 1)) * wr)
    dfl_loss = (dfl.mean(-1) * w).sum() / ts_sum
    total = (cfg.gain_box * box_loss + cfg.gain_cls * cls_loss +
             cfg.gain_dfl * dfl_loss)
    return ({"loss": total, "box": box_loss, "cls": cls_loss,
             "dfl": dfl_loss, "fg": fg.sum()}, (fg, assigned))


def v8_detection_loss(cfg: V8LossConfig, box_dist: torch.Tensor,
                      cls_logits: torch.Tensor, anc_points: torch.Tensor,
                      strides: torch.Tensor, gt_labels, gt_bboxes_xyxy,
                      gt_mask) -> Dict[str, torch.Tensor]:
    """box_dist [B,S,4,reg_max] raw DFL bins, cls_logits [B,S,nc], anchors
    [S,2] in cells, strides [S], GT boxes xyxy in input pixels. Returns
    the loss terms and `loss`, their weighted sum."""
    return _detection(cfg, box_dist, cls_logits, anc_points, strides,
                      gt_labels, gt_bboxes_xyxy, gt_mask)[0]


def v8_segmentation_loss(cfg: V8LossConfig, box_dist, cls_logits,
                         anc_points, strides, coef: torch.Tensor,
                         protos: torch.Tensor, gt_labels, gt_bboxes_xyxy,
                         gt_mask, gt_masks: torch.Tensor, imgsz: float,
                         gain_mask: Optional[float] = None
                         ) -> Dict[str, torch.Tensor]:
    """The detection loss plus a mask term: at each foreground anchor, BCE
    between coef @ protos (protos [B,Hp,Wp,nm] NHWC) and its GT's mask
    (gt_masks [B,G,Hp,Wp]), cropped (half-open) to the GT's box and
    divided by the box's area in prototype cells; the mean over an image's
    foreground anchors, then over the batch, times the box gain (or
    `gain_mask`)."""
    det, (fg, assigned) = _detection(
        cfg, box_dist, cls_logits, anc_points, strides, gt_labels,
        gt_bboxes_xyxy, gt_mask)
    Hp, Wp = protos.shape[1:3]
    pred = torch.einsum("bsn,bhwn->bshw", coef, protos)
    tgt = _take(gt_masks, assigned)
    box = _take(gt_bboxes_xyxy, assigned)                          # [B,S,4]
    sx, sy = Wp / imgsz, Hp / imgsz
    xs = torch.arange(Wp, dtype=pred.dtype, device=pred.device)
    ys = torch.arange(Hp, dtype=pred.dtype, device=pred.device)[:, None]
    b = box[..., None, None]
    inside = ((xs >= b[..., 0, :, :] * sx) & (xs < b[..., 2, :, :] * sx) &
              (ys >= b[..., 1, :, :] * sy) & (ys < b[..., 3, :, :] * sy))
    bce = sigmoid_bce(pred, tgt) * inside
    area = ((box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1]) *
            sx * sy).clamp(min=1e-9)
    per_anchor = bce.sum((2, 3)) / area
    n_fg = fg.sum(-1).clamp(min=1).to(pred.dtype)
    mask_loss = ((per_anchor * fg).sum(-1) / n_fg).mean()
    g = cfg.gain_box if gain_mask is None else gain_mask
    return {"loss": det["loss"] + g * mask_loss, "box": det["box"],
            "cls": det["cls"], "dfl": det["dfl"], "mask": mask_loss,
            "fg": det["fg"]}


_SIGMAS: Dict = {}


def _sigmas(K: int, dtype, device) -> torch.Tensor:
    """The keypoint sigmas, made on the device once (no copy a step)."""
    key = (K, dtype, str(device))
    if key not in _SIGMAS:
        _SIGMAS[key] = torch.tensor(
            OKS_SIGMA_COCO17 if K == 17 else [1.0 / K] * K, dtype=dtype
        ).to(device)
    return _SIGMAS[key]


def v8_pose_loss(cfg: V8LossConfig, box_dist, cls_logits, anc_points,
                 strides, pred_kpts: torch.Tensor, gt_labels,
                 gt_bboxes_xyxy, gt_mask, gt_kpts: torch.Tensor,
                 gain_pose: float = 12.0, gain_kobj: float = 1.0
                 ) -> Dict[str, torch.Tensor]:
    """The detection loss plus, at foreground anchors, the keypoint term
    1 - exp(-d² / (2σ)² / (area + 1e-9) / 2) over the visible keypoints of
    each image (COCO sigmas for 17 keypoints, else 1/K), and the
    visibility BCE's mean over an image's (foreground × K); each averaged
    over the batch. pred_kpts [B,S,K,3] decoded xy px and visibility
    logits, gt_kpts [B,G,K,3] xy px and visibility {0, 1, 2}."""
    det, (fg, assigned) = _detection(
        cfg, box_dist, cls_logits, anc_points, strides, gt_labels,
        gt_bboxes_xyxy, gt_mask)
    K = pred_kpts.shape[2]
    tkpt = _take(gt_kpts, assigned)
    box = _take(gt_bboxes_xyxy, assigned)
    area = (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])
    vis = (tkpt[..., 2] > 0).to(pred_kpts.dtype)                  # [B,S,K]
    d2 = ((pred_kpts[..., :2] - tkpt[..., :2]) ** 2).sum(-1)
    sigmas = _sigmas(K, pred_kpts.dtype, pred_kpts.device)
    e = d2 / ((2 * sigmas) ** 2 * (area[..., None] + 1e-9) * 2)
    fgk = fg[..., None] * vis
    pose_loss = (((1.0 - torch.exp(-e)) * fgk).sum((1, 2)) /
                 (fgk.sum((1, 2)) + 1e-9)).mean()
    kobj = sigmoid_bce(pred_kpts[..., 2], vis) * fg[..., None]
    kobj_loss = (kobj.sum((1, 2)) /
                 (fg.sum(-1) * K).clamp(min=1).to(kobj.dtype)).mean()
    return {"loss": det["loss"] + gain_pose * pose_loss +
            gain_kobj * kobj_loss, "box": det["box"], "cls": det["cls"],
            "dfl": det["dfl"], "pose": pose_loss, "kobj": kobj_loss,
            "fg": det["fg"]}


def classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                        label_smoothing: float = 0.0) -> torch.Tensor:
    """Cross entropy over [B,nc] logits; `label_smoothing` s takes the
    targets to (1 - s)·onehot + s/nc, as torch's `CrossEntropyLoss`."""
    logp = F.log_softmax(logits, -1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    if label_smoothing > 0.0:
        s = label_smoothing
        nll = (1.0 - s) * nll + s * (-logp.mean(-1))
    return nll.mean()
