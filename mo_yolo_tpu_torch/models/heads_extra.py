"""The segment, pose and classify heads and models (the port's copy of
`mo_yolo_tpu/models/heads_extra.py`), upstream's `Segment`, `Pose` and
`Classify` on the YOLOv8 `Detect` head (`models/detect.YoloDetectHead`).

Each model holds the graph rows and its head as `model.{i}` (the head at
the head row's index), so its `state_dict` keys are upstream's:
`model.{h}.cv2/cv3` (the detect branches), `cv4` (mask coefficients or
keypoints), `proto` (`cv1`, `upsample`, `cv2`, `cv3`), and `conv`,
`linear` for Classify. The DFL decode is analytic, so no `dfl` weight.

`predict_step` runs the model and `nms_fixed` (the greedy kernel on the
card) and returns fixed-slot tensors, as the JAX `predict_step`s do;
`ClassifyModel` returns logits from `forward`. In training mode every
BatchNorm trains, the detect branches' too (see `models/detect.py`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from mo_yolo_tpu_torch.models.detect import (YoloDetectHead, branch,
                                             level_anchors, nms_fixed)
from mo_yolo_tpu_torch.models.graph import (BackboneNeck, GraphSpec,
                                            parse_model_yaml)
from mo_yolo_tpu_torch.models.layers import ConvBnAct
from mo_yolo_tpu_torch.utils.device import resolve_device, resolve_dtype


class Proto(nn.Module):
    """Mask prototypes on P3 (upstream `Proto`): conv, a learned 2×
    upsample (a transposed conv with a bias), conv, 1×1 conv to `nm`."""

    def __init__(self, c1: int, c_: int = 256, nm: int = 32):
        super().__init__()
        self.cv1 = ConvBnAct(c1, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = ConvBnAct(c_, c_, 3)
        self.cv3 = ConvBnAct(c_, nm, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


def masks_from(coef: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """[B,S,nm] coefficients x [B,H,W,nm] prototypes -> [B,S,H,W] sigmoid
    masks."""
    return torch.einsum("bsn,bhwn->bshw", coef, protos).sigmoid()


class SegmentHead(YoloDetectHead):
    """Detect + mask coefficients a anchor (`cv4`) + prototypes (`proto`).
    Returns (boxes, class probabilities, coef [B,S,nm], protos [B,2h,2w,nm]
    NHWC); `raw=True` the detect training tuple + (coef, protos)."""

    def __init__(self, nc: int, ch: Sequence[int], nm: int = 32,
                 npr: int = 256, strides: Sequence[int] = (8, 16, 32)):
        super().__init__(nc, ch, strides)
        self.nm = nm
        self.proto = Proto(ch[0], npr, nm)
        c4 = max(ch[0] // 4, nm)
        self.cv4 = nn.ModuleList(branch(c, c4, nm) for c in ch)

    def forward(self, feats, raw: bool = False):
        det = self.detect(feats, raw)
        protos = self.proto(feats[0]).permute(0, 2, 3, 1)
        B = feats[0].shape[0]
        coef = torch.cat([m(f).permute(0, 2, 3, 1).reshape(B, -1, self.nm)
                          for m, f in zip(self.cv4, feats)], 1)
        return (*det, coef, protos)


class PoseHead(YoloDetectHead):
    """Detect + keypoints a anchor (`cv4`), decoded against the anchor
    centres: xy = (raw·2 + anchor − 0.5)·stride. Returns (boxes, class
    probabilities, keypoints [B,S,K,3] with sigmoid visibility); `raw=True`
    the detect training tuple + keypoints with raw visibility logits."""

    def __init__(self, nc: int, ch: Sequence[int],
                 kpt_shape: Tuple[int, int] = (17, 3),
                 strides: Sequence[int] = (8, 16, 32)):
        super().__init__(nc, ch, strides)
        self.kpt_shape = tuple(kpt_shape)
        nk = kpt_shape[0] * kpt_shape[1]
        c4 = max(ch[0] // 4, nk)
        self.cv4 = nn.ModuleList(branch(c, c4, nk) for c in ch)

    def forward(self, feats, raw: bool = False):
        det = self.detect(feats, raw)
        B = feats[0].shape[0]
        kpt = torch.cat([m(f).permute(0, 2, 3, 1).reshape(
            B, -1, *self.kpt_shape) for m, f in zip(self.cv4, feats)], 1)
        anc, st = level_anchors(feats, self.strides)
        xy = (kpt[..., :2] * 2.0 + (anc[None, :, None, :] - 0.5)) * \
            st[None, :, None, None]
        vis = kpt[..., 2:3] if raw else kpt[..., 2:3].sigmoid()
        return (*det, torch.cat([xy, vis], -1))


class ClassifyHead(nn.Module):
    """Upstream `Classify`: 1×1 conv to `c_`, global average pool,
    dropout (in training, from the generator `forward` is given, or
    torch's), linear logits."""

    def __init__(self, c1: int, nc: int, c_: int = 1280,
                 dropout: float = 0.0):
        super().__init__()
        self.conv = ConvBnAct(c1, c_, 1)
        self.linear = nn.Linear(c_, nc)
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.conv(x).mean((2, 3))
        if self.training and self.dropout > 0.0:
            keep = 1.0 - self.dropout
            x = x * (torch.rand(x.shape, generator=generator, device=x.device,
                                dtype=x.dtype) < keep) / keep
        return self.linear(x)


class _TaskNet(nn.Module):
    """The graph rows and a head at `model.{head}`."""

    def __init__(self, spec: GraphSpec, head: nn.Module):
        super().__init__()
        self.spec = spec
        self.model = BackboneNeck(spec, head)

    @property
    def head(self) -> nn.Module:
        return self.model[self.spec.head_index]

    def forward(self, images: torch.Tensor, raw: bool = False):
        """images [B,H,W,3], raw uint8 or float in [0, 1]."""
        return self.head(self.model(images), raw=raw)


class SegmentationModel(_TaskNet):
    """`predict_step` -> (boxes xyxy px [B,max_det,4], scores (0 in an
    empty slot), classes int32, coef [B,max_det,nm], protos)."""

    def __init__(self, spec: GraphSpec, nm: int = 32, max_det: int = 100,
                 conf: float = 0.001, iou: float = 0.7,
                 agnostic: bool = False, retina_masks: bool = False):
        ha = spec.head_args
        nm = int(ha[1]) if len(ha) >= 2 else nm
        npr = int(ha[2]) if len(ha) >= 3 else 256
        super().__init__(spec, SegmentHead(spec.nc, spec.out_channels, nm,
                                           npr, spec.out_strides))
        self.nm, self.max_det, self.conf, self.iou = nm, max_det, conf, iou
        self.agnostic, self.retina_masks = agnostic, retina_masks

    @torch.no_grad()
    def predict_step(self, images: torch.Tensor):
        boxes, cls_p, coef, protos = self(images)
        bb, ss, cc, valid, cok = nms_fixed(
            boxes, cls_p.max(-1).values, cls_p.argmax(-1), self.iou,
            self.conf, self.max_det, (coef,), self.agnostic)
        return bb, ss * valid, cc.to(torch.int32), cok, protos

    @torch.no_grad()
    def compose_masks(self, boxes: torch.Tensor, coef: torch.Tensor,
                      protos: torch.Tensor) -> torch.Tensor:
        """Masks [B,S,H,W] at input resolution (4× the prototypes') for the
        kept boxes (xyxy input pixels [B,S,4]) and coefficients, zero
        outside each box. By default they are composed and cropped at the
        prototypes' resolution, then upsampled bilinearly; with
        `retina_masks` the prototypes are upsampled first and the masks
        composed and cropped at input resolution."""
        B, Hp, Wp, nm = protos.shape
        H, W = Hp * 4, Wp * 4
        if self.retina_masks:
            pr = F.interpolate(protos.permute(0, 3, 1, 2), size=(H, W),
                               mode="bilinear", align_corners=False)
            return _crop(masks_from(coef, pr.permute(0, 2, 3, 1)), boxes)
        m = _crop(masks_from(coef, protos), boxes / 4.0)
        return F.interpolate(m, size=(H, W), mode="bilinear",
                             align_corners=False)


def _crop(m: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero [B,S,h,w] masks outside their (fractional) xyxy boxes on the
    masks' own grid: x1 <= x < x2, y1 <= y < y2."""
    h, w = m.shape[-2:]
    ys = torch.arange(h, dtype=m.dtype, device=m.device)[None, None, :, None]
    xs = torch.arange(w, dtype=m.dtype, device=m.device)[None, None, None, :]
    x1, y1, x2, y2 = (boxes[..., i, None, None] for i in range(4))
    return m * ((xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2))


class PoseModel(_TaskNet):
    """`predict_step` -> (boxes xyxy px, scores, classes int32, keypoints
    [B,max_det,K,3])."""

    def __init__(self, spec: GraphSpec, kpt_shape=(17, 3),
                 max_det: int = 100, conf: float = 0.001, iou: float = 0.7,
                 agnostic: bool = False):
        super().__init__(spec, PoseHead(spec.nc, spec.out_channels,
                                        tuple(kpt_shape), spec.out_strides))
        self.kpt_shape = tuple(kpt_shape)
        self.max_det, self.conf, self.iou = max_det, conf, iou
        self.agnostic = agnostic

    @torch.no_grad()
    def predict_step(self, images: torch.Tensor):
        boxes, cls_p, kpts = self(images)
        bb, ss, cc, valid, kk = nms_fixed(
            boxes, cls_p.max(-1).values, cls_p.argmax(-1), self.iou,
            self.conf, self.max_det, (kpts,), self.agnostic)
        return bb, ss * valid, cc.to(torch.int32), kk


class ClassifyModel(_TaskNet):
    """The graph and upstream's `Classify` over the deepest tap; `forward`
    returns logits [B,nc]."""

    def __init__(self, spec: GraphSpec, c_: int = 1280,
                 dropout: float = 0.0):
        super().__init__(spec, ClassifyHead(spec.out_channels[-1], spec.nc,
                                            c_, dropout))

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        return self.head(self.model(images)[-1], generator)


TASK_MODELS = {"segment": SegmentationModel, "pose": PoseModel,
               "classify": ClassifyModel}


def build_task_model(task: str, cfg: Union[str, Dict[str, Any]] = "yolo_track",
                     nc: Optional[int] = None,
                     dtype: Union[str, torch.dtype] = torch.float32,
                     device=None, seed: int = 0, **kw) -> nn.Module:
    """The `task` model ("segment", "pose" or "classify") of a config
    (bundled name, dict or yaml path) with seeded random weights, in eval
    mode on `device` (None means the card; raises without one) in `dtype`.
    `kw` are the model's own arguments (`max_det`, `conf`, `iou`,
    `agnostic`, `retina_masks`, `kpt_shape`, `dropout`)."""
    from mo_yolo_tpu_torch.models.tracking_model import init_parameters
    dev = resolve_device(device)
    model = TASK_MODELS[task](parse_model_yaml(cfg, nc=nc), **kw)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device=dev, dtype=resolve_dtype(dtype)).eval()
