"""DETR/MOTR set-prediction losses, masked and fixed-shape (counterpart of
`mo_yolo_tpu/train/losses.py`).

Gains {class 1, bbox 5, giou 2}; the class loss is varifocal (focal when a
layer has no matched GT) summed over queries; L1 and GIoU are sums over
matched pairs, unnormalised (the clip loss divides by the clip's object
count). GT is padded to [B, G] with a mask; a matching is an int32
`assign [B, G]` of query rows, -1 for padding. Every reduction is a
masked sum in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from mo_yolo_tpu_torch.ops.boxes import elementwise_iou
from mo_yolo_tpu_torch.ops.denoising import dn_positive_index
from mo_yolo_tpu_torch.ops.matching import match_layers


@dataclasses.dataclass(frozen=True)
class LossConfig:
    nc: int
    gain_class: float = 1.0
    gain_bbox: float = 5.0
    gain_giou: float = 2.0
    focal_alpha: float = 0.25
    focal_gamma: float = 1.5
    use_vfl: bool = True


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE-with-logits, elementwise (optax's form)."""
    return logits.clamp(min=0) - logits * labels + \
        torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal(logits: torch.Tensor, targets: torch.Tensor, alpha: float,
                  gamma: float) -> torch.Tensor:
    """Elementwise sigmoid focal loss."""
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    a_t = targets * alpha + (1 - targets) * (1 - alpha)
    return sigmoid_bce(logits, targets) * (1.0 - p_t) ** gamma * a_t


def varifocal(logits: torch.Tensor, gt_score: torch.Tensor,
              label: torch.Tensor, alpha: float = 0.75,
              gamma: float = 2.0) -> torch.Tensor:
    """Elementwise varifocal loss."""
    p = torch.sigmoid(logits)
    weight = alpha * p ** gamma * (1 - label) + gt_score * label
    return sigmoid_bce(logits, gt_score) * weight


def _scatter_onto_queries(Q: int, nc: int, assign: torch.Tensor,
                          gt_cls: torch.Tensor, value: torch.Tensor,
                          matched: torch.Tensor) -> torch.Tensor:
    """[B,Q,nc] with value[b,g] added at (assign[b,g], gt_cls[b,g]) for
    matched GTs; the others go to a spill row Q that is cut off."""
    B = assign.shape[0]
    idx_q = torch.where(matched, assign.long(), torch.full_like(
        assign, Q, dtype=torch.long))
    upd = F.one_hot(gt_cls.long().clamp(0, nc - 1), nc).to(value.dtype) * \
        value[..., None]
    out = torch.zeros(B, Q + 1, nc, dtype=value.dtype, device=value.device)
    out = out.scatter_add(1, idx_q[..., None].expand(-1, -1, nc), upd)
    return out[:, :Q]


def layer_loss(cfg: LossConfig, pred_boxes: torch.Tensor,
               pred_logits: torch.Tensor, gt_boxes: torch.Tensor,
               gt_cls: torch.Tensor, gt_mask: torch.Tensor,
               assign: torch.Tensor,
               query_mask: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
    """One decoder layer's class/bbox/giou loss given a matching.

    pred_boxes [B,Q,4] cxcywh, pred_logits [B,Q,nc]; `query_mask` [B,Q]
    restricts which queries contribute class loss."""
    B, Q, nc = pred_logits.shape
    matched = gt_mask & (assign >= 0)
    a_safe = assign.clamp(0, max(Q - 1, 0)).long()
    pb = torch.gather(pred_boxes, 1, a_safe[..., None].expand(-1, -1, 4))
    m = matched[..., None].to(pb.dtype)
    l1 = ((pb - gt_boxes).abs() * m).sum()
    giou = elementwise_iou(pb, gt_boxes, xywh=True, giou=True)
    giou_loss = ((1.0 - giou) * matched).sum()

    iou = elementwise_iou(pb, gt_boxes, xywh=True).detach()
    labels = _scatter_onto_queries(Q, nc, a_safe, gt_cls, torch.ones_like(iou),
                                   matched).clamp(max=1.0)
    gt_scores = _scatter_onto_queries(Q, nc, a_safe, gt_cls, iou, matched)
    num_gts = matched.sum()
    focal = sigmoid_focal(pred_logits, labels, cfg.focal_alpha,
                          cfg.focal_gamma)
    if cfg.use_vfl:
        # both branches run and the count picks one, with no host sync
        cls_elem = torch.where(num_gts > 0,
                               varifocal(pred_logits, gt_scores, labels),
                               focal)
    else:
        cls_elem = focal
    if query_mask is not None:
        cls_elem = cls_elem * query_mask[..., None]
    return {
        "loss_class": cfg.gain_class * cls_elem.sum(),
        "loss_bbox": cfg.gain_bbox * l1,
        "loss_giou": cfg.gain_giou * giou_loss,
        "num_gts": num_gts,
    }


def matched_layer_losses(cfg: LossConfig, dec_boxes: torch.Tensor,
                         dec_logits: torch.Tensor, gt_boxes: torch.Tensor,
                         gt_cls: torch.Tensor, gt_mask: torch.Tensor,
                         last_assign: torch.Tensor,
                         aux_query_mask: Optional[torch.Tensor] = None,
                         main_query_mask: Optional[torch.Tensor] = None,
                         postfix: str = "") -> Dict[str, torch.Tensor]:
    """The last layer's loss on the given matching plus the other layers'
    aux losses, each re-matched by Hungarian (on the `aux_query_mask`
    subset when given; the L-1 matchings solved as one batch by
    `match_layers`). dec_boxes/dec_logits [L,B,Q,...].
    `main_query_mask` limits the last layer's class loss to the queries
    that took part this frame (inactive track slots carry no loss)."""
    L = dec_boxes.shape[0]
    out = dict_prefix(layer_loss(cfg, dec_boxes[-1], dec_logits[-1], gt_boxes,
                                 gt_cls, gt_mask, last_assign,
                                 query_mask=main_query_mask), postfix)
    aux = {"loss_class": 0.0, "loss_bbox": 0.0, "loss_giou": 0.0}
    if L > 1:
        aux_assign = match_layers(dec_boxes[:-1], dec_logits[:-1], gt_boxes,
                                  gt_cls, gt_mask, aux_query_mask)
    for i in range(L - 1):
        pb, pl = dec_boxes[i], dec_logits[i]
        li = layer_loss(cfg, pb, pl, gt_boxes, gt_cls, gt_mask, aux_assign[i],
                        query_mask=aux_query_mask)
        for k in aux:
            aux[k] = aux[k] + li[k]
    out.update(dict_prefix(aux, postfix + "_aux"))
    return out


def dn_losses(cfg: LossConfig, dn_boxes: torch.Tensor,
              dn_logits: torch.Tensor, gt_boxes: torch.Tensor,
              gt_cls: torch.Tensor, gt_mask: torch.Tensor,
              num_group: int) -> Dict[str, torch.Tensor]:
    """Denoising loss: the positive copy of GT g in group k is query
    (2k)·G + g; the GT is tiled `num_group` times and matched to those
    positives directly, in every layer. dn_boxes/dn_logits [L,B,Ndn,...]."""
    keys = ("loss_class", "loss_bbox", "loss_giou")
    if num_group == 0:      # CDN off: no dn queries, the terms are 0
        zero = dn_boxes.new_zeros(())
        return {**{f"{k}_dn": zero for k in keys},
                **{f"{k}_dn_aux": zero for k in keys}}
    L, B = dn_boxes.shape[:2]
    G = gt_mask.shape[1]
    pos_idx = dn_positive_index(num_group, G, device=gt_mask.device).reshape(-1)
    gt_boxes_t = gt_boxes.repeat(1, num_group, 1)
    gt_cls_t = gt_cls.repeat(1, num_group)
    gt_mask_t = gt_mask.repeat(1, num_group)
    assign = pos_idx[None].expand(B, -1).to(torch.int32)
    last = layer_loss(cfg, dn_boxes[-1], dn_logits[-1], gt_boxes_t, gt_cls_t,
                      gt_mask_t, assign)
    out = {f"{k}_dn": last[k] for k in keys}
    aux = {k: 0.0 for k in keys}
    for i in range(L - 1):
        li = layer_loss(cfg, dn_boxes[i], dn_logits[i], gt_boxes_t, gt_cls_t,
                        gt_mask_t, assign)
        for key in keys:
            aux[key] = aux[key] + li[key]
    out.update({f"{k}_dn_aux": v for k, v in aux.items()})
    return out


def dict_prefix(d: Dict[str, torch.Tensor], postfix: str
                ) -> Dict[str, torch.Tensor]:
    """Drop `num_gts` and append `postfix` to the other keys."""
    return {f"{k}{postfix}": v for k, v in d.items() if k != "num_gts"}
