"""Box operations the tracker, the losses, the matcher and the YOLOv8 task
losses need (counterpart of `mo_yolo_tpu/ops/boxes.py`)."""

from __future__ import annotations

import math

import torch

EPS = 1e-7


def xywh2xyxy(b: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy2xywh(b: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes."""
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def pairwise_iou(box1: torch.Tensor, box2: torch.Tensor,
                 eps: float = EPS) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: [..., M, 4] x [..., N, 4] -> [..., M, N]."""
    b1 = box1[..., :, None, :]
    b2 = box2[..., None, :, :]
    x1 = torch.maximum(b1[..., 0], b2[..., 0])
    y1 = torch.maximum(b1[..., 1], b2[..., 1])
    x2 = torch.minimum(b1[..., 2], b2[..., 2])
    y2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    union = box_area(b1) + box_area(b2) - inter + eps
    return inter / union


def pairwise_giou(box1: torch.Tensor, box2: torch.Tensor,
                  eps: float = EPS) -> torch.Tensor:
    """Pairwise GIoU of xyxy boxes -> [..., M, N] (the matching cost's)."""
    return elementwise_iou(box1[..., :, None, :], box2[..., None, :, :],
                           xywh=False, giou=True, eps=eps)


def elementwise_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True,
                    giou: bool = False, eps: float = EPS) -> torch.Tensor:
    """IoU, or GIoU, of aligned box pairs [..., 4] -> [...]."""
    if xywh:
        box1, box2 = xywh2xyxy(box1), xywh2xyxy(box2)
    x1 = torch.maximum(box1[..., 0], box2[..., 0])
    y1 = torch.maximum(box1[..., 1], box2[..., 1])
    x2 = torch.minimum(box1[..., 2], box2[..., 2])
    y2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    union = box_area(box1) + box_area(box2) - inter + eps
    iou = inter / union
    if not giou:
        return iou
    # smallest enclosing box
    cx1 = torch.minimum(box1[..., 0], box2[..., 0])
    cy1 = torch.minimum(box1[..., 1], box2[..., 1])
    cx2 = torch.maximum(box1[..., 2], box2[..., 2])
    cy2 = torch.maximum(box1[..., 3], box2[..., 3])
    c_area = (cx2 - cx1) * (cy2 - cy1) + eps
    return iou - (c_area - union) / c_area


def elementwise_ciou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True,
                     eps: float = EPS) -> torch.Tensor:
    """Complete IoU of aligned box pairs [..., 4] -> [...]: IoU minus the
    squared centre distance over the enclosing box's squared diagonal,
    minus the aspect-ratio term v·alpha, with alpha held constant under
    differentiation (upstream `bbox_iou(..., CIoU=True)`)."""
    if xywh:
        box1, box2 = xywh2xyxy(box1), xywh2xyxy(box2)
    iou = elementwise_iou(box1, box2, xywh=False, eps=eps)
    cw = torch.maximum(box1[..., 2], box2[..., 2]) - \
        torch.minimum(box1[..., 0], box2[..., 0])
    ch = torch.maximum(box1[..., 3], box2[..., 3]) - \
        torch.minimum(box1[..., 1], box2[..., 1])
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((box1[..., 0] + box1[..., 2] - box2[..., 0] - box2[..., 2]) ** 2 +
            (box1[..., 1] + box1[..., 3] - box2[..., 1] - box2[..., 3]) ** 2
            ) / 4
    w1, h1 = box1[..., 2] - box1[..., 0], box1[..., 3] - box1[..., 1]
    w2, h2 = box2[..., 2] - box2[..., 0], box2[..., 3] - box2[..., 1]
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps)) -
                              torch.atan(w1 / (h1 + eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def pairwise_ciou(box1: torch.Tensor, box2: torch.Tensor,
                  eps: float = EPS) -> torch.Tensor:
    """Pairwise CIoU of xyxy boxes [..., M, 4] x [..., N, 4] -> [..., M, N]
    (the task-aligned assigner's alignment metric)."""
    return elementwise_ciou(box1[..., :, None, :], box2[..., None, :, :],
                            xywh=False, eps=eps)
