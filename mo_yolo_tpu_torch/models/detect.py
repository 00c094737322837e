"""The port's copy of `mo_yolo_tpu/models/detect.py`: two detection heads.

- `DetectionModel`: RT-DETR-style detection, the backbone and neck feeding
  the `TrackDecoder` with no track slots. Set prediction, no NMS: each of
  the `nq` detect queries is one box. The module tree is upstream's
  `RTDETR` layout: `model.{i}` for the graph rows and the decoder itself
  at `model.{head}`.
- `YoloDetectHead`: the anchor-free YOLOv8 `Detect` head (DFL box bins and
  class logits a level, `cv2`/`cv3` as upstream names them), which the
  segment and pose heads extend, and `nms_fixed`, its fixed-size NMS on
  the device: the greedy fixed point of the tracker's duplicate filter,
  run by the same kernel (`ops/suppress.py`, `csrc/greedy_keep.cu`) over
  every anchor of a batch at once.

In training mode the head's BatchNorms train, as upstream's do; the JAX
`YoloDetectHead` calls its `ConvBnAct`s without `train`, so their
statistics never move there (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from mo_yolo_tpu_torch.models.decoder import TrackDecoder
from mo_yolo_tpu_torch.models.graph import (BackboneNeck, GraphSpec,
                                            parse_model_yaml)
from mo_yolo_tpu_torch.models.layers import ConvBnAct
from mo_yolo_tpu_torch.ops.boxes import pairwise_iou
from mo_yolo_tpu_torch.ops.suppress import greedy_keep_from_conflicts
from mo_yolo_tpu_torch.utils.device import resolve_device, resolve_dtype

# the CDN query budget of the JAX detection loss (`build_cdn_group`'s
# default: its `DetectionModel` has no field for it)
NUM_DENOISING = 100


class DetectionModel(nn.Module):
    def __init__(self, spec: GraphSpec, hd: int = 256, nq: int = 300,
                 ndl: int = 6, d_ffn: int = 1024,
                 impl: Optional[str] = None):
        super().__init__()
        self.spec, self.hd, self.nq = spec, hd, nq
        self.num_denoising = NUM_DENOISING
        decoder = TrackDecoder(spec.out_channels, nc=spec.nc, hd=hd, nq=nq,
                               ndl=ndl, d_ffn=d_ffn, impl=impl)
        self.model = BackboneNeck(spec, decoder)

    @property
    def decoder(self) -> TrackDecoder:
        return self.model[self.spec.head_index]

    def forward(self, images: torch.Tensor, train: bool = False,
                dn_cls=None, dn_bbox_logit=None, dn_attn_mask=None
                ) -> Dict[str, Any]:
        """images [B,H,W,3], raw uint8 or float in [0, 1]. Returns the
        decoder outputs over the queries [dn | detect]."""
        return self.decoder(self.model(images), dn_cls=dn_cls,
                            dn_bbox_logit=dn_bbox_logit,
                            dn_attn_mask=dn_attn_mask, train=train)

    @torch.no_grad()
    def predict_step(self, images: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One detection step -> (boxes cxcywh [B,nq,4] in [0, 1], scores
        [B,nq] (the largest class sigmoid), classes [B,nq] int32), f32."""
        out = self(images)
        boxes = out["dec_bboxes"][-1].float()
        logits = out["dec_scores"][-1].float()
        return (boxes, torch.sigmoid(logits).max(-1).values,
                logits.argmax(-1).to(torch.int32))


def build_detection_model(cfg: Union[str, Dict[str, Any]] = "yolo_track",
                          nc: Optional[int] = None,
                          dtype: Union[str, torch.dtype] = torch.float32,
                          device=None, nq: Optional[int] = None,
                          seed: int = 0, impl: Optional[str] = None,
                          hd: Optional[int] = None, ndl: Optional[int] = None,
                          d_ffn: Optional[int] = None) -> DetectionModel:
    """Build the detection model from a config (bundled name, dict or yaml
    path) with seeded random weights, in eval mode on `device` (None means
    the card; raises without one) in `dtype`. `impl` names the sampler
    route as in `build_tracking_model`; `nq`, `hd`, `ndl` and `d_ffn`
    override the model's defaults."""
    from mo_yolo_tpu_torch.models.tracking_model import init_parameters
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    spec = parse_model_yaml(cfg, nc=nc)
    kw = {k: v for k, v in (("nq", nq), ("hd", hd), ("ndl", ndl),
                            ("d_ffn", d_ffn)) if v is not None}
    model = DetectionModel(spec, impl=impl, **kw)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device=dev, dtype=dt).eval()


# ---------------------------------------------------------------------- #
# YOLOv8 anchor-free Detect head (DFL)
# ---------------------------------------------------------------------- #
def branch(c1: int, cm: int, c2: int) -> nn.Sequential:
    """Upstream's head branch: two 3×3 Conv+BN+SiLU, then a 1×1 conv with
    a bias."""
    return nn.Sequential(ConvBnAct(c1, cm, 3), ConvBnAct(cm, cm, 3),
                         nn.Conv2d(cm, c2, 1))


def level_anchors(feats: Sequence[torch.Tensor], strides: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(anchors [S, 2] cell centres (x + 0.5, y + 0.5), strides [S]) over
    the levels' cells, row-major in each level."""
    anchors, st = [], []
    for f, s in zip(feats, strides):
        h, w = f.shape[-2:]
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=f.device),
            torch.arange(w, dtype=torch.float32, device=f.device),
            indexing="ij")
        anchors.append(torch.stack([gx + 0.5, gy + 0.5], -1).reshape(-1, 2))
        st.append(torch.full((h * w,), float(s), device=f.device))
    return torch.cat(anchors), torch.cat(st)


def dfl_decode(box_dist: torch.Tensor, anchors: torch.Tensor,
               strides: torch.Tensor) -> torch.Tensor:
    """DFL bins [B,S,4,R] -> xyxy boxes [B,S,4] in pixels: each side's
    distance the expectation over its softmaxed bins, from the anchor,
    times the stride."""
    R = box_dist.shape[-1]
    dist = (box_dist.softmax(-1) *
            torch.arange(R, dtype=box_dist.dtype, device=box_dist.device)
            ).sum(-1)
    x1y1 = (anchors[None] - dist[..., :2]) * strides[None, :, None]
    x2y2 = (anchors[None] + dist[..., 2:]) * strides[None, :, None]
    return torch.cat([x1y1, x2y2], -1)


class YoloDetectHead(nn.Module):
    """Upstream's `Detect`: a box branch of 4·reg_max DFL bins (`cv2`) and
    a class branch (`cv3`) a level. `forward(feats)` with NCHW feats
    returns (boxes xyxy [B,S,4] in input pixels, class probabilities
    [B,S,nc]); `raw=True` the training tuple (box_dist [B,S,4,reg_max],
    cls_logits [B,S,nc], anchors [S,2] in cells, strides [S]) that
    `train.v8_loss.v8_detection_loss` takes."""

    def __init__(self, nc: int, ch: Sequence[int],
                 strides: Sequence[int] = (8, 16, 32), reg_max: int = 16):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(branch(c, c2, 4 * reg_max) for c in ch)
        self.cv3 = nn.ModuleList(branch(c, c3, nc) for c in ch)

    def detect(self, feats: Sequence[torch.Tensor], raw: bool = False):
        B = feats[0].shape[0]
        box = torch.cat([b(f).permute(0, 2, 3, 1).reshape(
            B, -1, 4, self.reg_max) for b, f in zip(self.cv2, feats)], 1)
        cls = torch.cat([c(f).permute(0, 2, 3, 1).reshape(B, -1, self.nc)
                         for c, f in zip(self.cv3, feats)], 1)
        anchors, strides = level_anchors(feats, self.strides)
        if raw:
            return box, cls, anchors, strides
        return dfl_decode(box, anchors, strides), cls.sigmoid()

    forward = detect


def nms_fixed(boxes_xyxy: torch.Tensor, scores: torch.Tensor,
              cls: torch.Tensor, iou_thresh: float = 0.7,
              conf_thresh: float = 0.25, max_det: int = 300,
              extras: Sequence[torch.Tensor] = (), agnostic: bool = False):
    """Class-aware NMS with a fixed output size, over a batch: boxes
    [B,N,4], scores [B,N], cls [B,N], `extras` per-anchor payloads
    [B,N,...] (mask coefficients, keypoints). Returns (boxes [B,max_det,4],
    scores, cls (-1 in an empty slot), valid [B,max_det] bool, *extras at
    [B,max_det,...]).

    Each image's anchors are sorted by score (stably, as `jnp.argsort`),
    the conflicts are the pairs above `iou_thresh` of one class (any class
    with `agnostic`) among those at or above `conf_thresh`, the greedy
    fixed point keeps what no kept earlier box blocks (the CUDA kernel on
    the card, one launch for the batch), and the kept boxes are compacted
    to the first `max_det` slots in score order. No value comes back to
    the host."""
    B, N = scores.shape
    order = torch.argsort(-scores, dim=-1, stable=True)
    take = (lambda t: torch.take_along_dim(
        t, order.reshape(B, N, *([1] * (t.dim() - 2))), 1))
    b, s, c = take(boxes_xyxy), take(scores), take(cls)
    valid = s >= conf_thresh
    conflict = pairwise_iou(b, b) > iou_thresh
    if not agnostic:
        conflict &= c[:, :, None] == c[:, None, :]
    conflict &= torch.ones(N, N, dtype=torch.bool,
                           device=b.device).triu(1)[None]
    conflict &= valid[:, :, None] & valid[:, None, :]
    keep = greedy_keep_from_conflicts(conflict, valid)
    pos = keep.to(torch.int32).cumsum(-1) - 1
    ok = keep & (pos < max_det)
    slot = torch.where(ok, pos, max_det).long()
    rows = torch.arange(B, device=b.device)[:, None]

    def scatter(src: torch.Tensor, fill=0) -> torch.Tensor:
        buf = torch.full((B, max_det + 1, *src.shape[2:]), fill,
                         dtype=src.dtype, device=src.device)
        buf[rows, slot] = src
        return buf[:, :max_det]

    out = (scatter(b), scatter(s), scatter(c, -1), scatter(ok))
    return out + tuple(scatter(take(e)) for e in extras)
