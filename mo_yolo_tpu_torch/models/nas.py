"""The YOLO-NAS family (the port's copy of `mo_yolo_tpu/models/nas.py`).

    from mo_yolo_tpu_torch import NAS
    nas = NAS("yolo_nas_s", imgsz=640)          # random weights from seed
    for res in nas.predict("frames/", augment=True):
        print(res.cls, res.conf, res.boxes_xyxy)
    metrics = nas.val("data/det.yaml")           # mAP50, mAP50-95, ...
    nas.export("pt2", path="nas")                # the step, torch.export

The model is the `yolo_nas_s` graph (RepConv QSP/QCI stages, the YOLOv8
PAN neck), or any graph with a Detect row (the v3, v5, v6 and v8
detectors), and the anchor-free `YoloDetectHead`. `predict_step` runs the
head and `nms_fixed` on the device (the greedy kernel on the card, one
launch for the batch) and returns fixed slots with no host sync;
`predict_step_tta` runs three scales (1, 0.83, 0.67, the middle one
flipped), maps their boxes back to the input's pixels, drops the full
scale's last level's anchors (P5, or P6 in a four-level head) and the
smallest scale's first level's (P3), and suppresses
the union in one `nms_fixed`. Its down-scales are bilinear with
antialiasing, as `jax.image.resize` does when it shrinks an image.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from mo_yolo_tpu_torch.api import _ModelFacade, _split_files
from mo_yolo_tpu_torch.models.detect import PredictStep, YoloDetectHead, \
    nms_fixed
from mo_yolo_tpu_torch.models.graph import (BackboneNeck, GraphSpec,
                                            parse_model_yaml)
from mo_yolo_tpu_torch.utils.device import resolve_device, resolve_dtype

TTA_SCALES = (1.0, 0.83, 0.67)
TTA_FLIPS = (False, True, False)


class NASModel(nn.Module):
    """The graph rows at `model.{i}` and the Detect head at `model.{head}`
    (upstream's keys). `forward(images)` -> (boxes xyxy px [B,S,4], class
    probabilities [B,S,nc]); `raw=True` the head's training tuple."""

    def __init__(self, spec: GraphSpec, max_det: int = 300,
                 conf: float = 0.001, iou: float = 0.7,
                 agnostic: bool = False):
        super().__init__()
        self.spec = spec
        self.max_det, self.conf, self.iou = max_det, conf, iou
        self.agnostic = agnostic
        self.model = BackboneNeck(spec, YoloDetectHead(
            spec.nc, spec.out_channels, spec.out_strides, act=spec.act))

    @property
    def head(self) -> YoloDetectHead:
        return self.model[self.spec.head_index]

    def forward(self, images: torch.Tensor, raw: bool = False):
        """images [B,H,W,3], raw uint8 or float in [0, 1]."""
        return self.head(self.model(images), raw=raw)

    @torch.no_grad()
    def predict_step(self, images: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(boxes cxcywh [B,max_det,4] normalised per axis, scores
        [B,max_det] (0 in a suppressed slot), classes int32), the contract
        of `DetectionModel.predict_step`, so that `DetectionValidator`
        drives either."""
        boxes, cls_p = self(images)
        return self._nms_norm(boxes, cls_p, images.shape[1:3])

    def _nms_norm(self, boxes: torch.Tensor, cls_p: torch.Tensor, hw):
        H, W = hw
        bb, ss, cc, valid = nms_fixed(
            boxes, cls_p.max(-1).values, cls_p.argmax(-1), self.iou,
            self.conf, self.max_det, agnostic=self.agnostic)
        x1, y1, x2, y2 = bb.unbind(-1)
        # per axis (a rectangular input has H != W), by Python scalars: a
        # tensor of them would be a copy to the card, a host sync
        out = torch.stack([(x1 + x2) / 2 / W, (y1 + y2) / 2 / H,
                           (x2 - x1) / W, (y2 - y1) / H], -1)
        return out, ss * valid, cc.to(torch.int32)

    @torch.no_grad()
    def predict_step_tta(self, images: torch.Tensor):
        """Test-time augmentation (upstream `_predict_augment`): the
        `predict_step` contract over the three scales' union, one NMS.
        Each scaled side is rounded to a multiple of the graph's largest
        stride, as upstream's `gs`: 32 on a three-level graph, 64 on a
        stride-64 one such as yolov5-p6 (the JAX step rounds to 32 there
        and cannot run it)."""
        B, H, W, _ = images.shape
        dtype = self.model[0].conv.weight.dtype
        x01 = images if images.is_floating_point() else \
            images.to(dtype) * (1.0 / 255.0)
        gs = max(self.spec.out_strides)
        all_b, all_c = [], []
        for idx, (si, fl) in enumerate(zip(TTA_SCALES, TTA_FLIPS)):
            if si == 1.0:                  # the full scale: the input as is
                hi, wi, xi = H, W, images
            else:
                hi = max(int(round(H * si / gs)) * gs, gs)
                wi = max(int(round(W * si / gs)) * gs, gs)
                xi = F.interpolate(
                    x01.permute(0, 3, 1, 2), size=(hi, wi), mode="bilinear",
                    align_corners=False,
                    antialias=True).permute(0, 2, 3, 1)
            if fl:
                xi = torch.flip(xi, [2])
            b, c = self(xi)                          # xyxy in scaled pixels
            if fl:                                   # undo the flip
                b = torch.stack([wi - b[..., 2], b[..., 1],
                                 wi - b[..., 0], b[..., 3]], -1)
            if (hi, wi) != (H, W):
                # per axis: the stride rounding makes sx != sy
                sx, sy = W / wi, H / hi
                b = torch.stack([b[..., 0] * sx, b[..., 1] * sy,
                                 b[..., 2] * sx, b[..., 3] * sy], -1)
            # anchors are level-ordered (P3|P4|P5, or four levels),
            # ceil(side / stride) cells
            counts = [(-(-hi // s)) * (-(-wi // s))
                      for s in self.spec.out_strides]
            if idx == 0:              # the full scale: drop the last
                keep = sum(counts[:-1])
                b, c = b[:, :keep], c[:, :keep]
            if idx == len(TTA_SCALES) - 1:   # the smallest: the first
                b, c = b[:, counts[0]:], c[:, counts[0]:]
            all_b.append(b)
            all_c.append(c)
        return self._nms_norm(torch.cat(all_b, 1), torch.cat(all_c, 1),
                              (H, W))


def build_nas_model(cfg: Union[str, Dict[str, Any]] = "yolo_nas_s",
                    nc: Optional[int] = None,
                    dtype: Union[str, torch.dtype] = torch.float32,
                    device=None, seed: int = 0, **kw) -> NASModel:
    """`NASModel` of a config (bundled name, dict or yaml path) with seeded
    random weights, in eval mode on `device` (None means the card; raises
    without one). `kw`: `max_det`, `conf`, `iou`, `agnostic`."""
    from mo_yolo_tpu_torch.models.tracking_model import init_parameters
    dev = resolve_device(device)
    model = NASModel(parse_model_yaml(cfg, nc=nc), **kw)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device=dev, dtype=resolve_dtype(dtype)).eval()


class NAS(_ModelFacade):
    """The YOLO-NAS facade (upstream `nas/model.py`, the port's copy of the
    JAX `NAS`): `predict` (with `augment=True` the TTA sweep), `val`
    through `DetectionValidator`, `info`, the callback surface, `save` and
    `export` to `params`, `pt`, `torchscript`, `pt2` and `graph` (the JAX
    `jaxexport` and `stablehlo` raise, naming `pt2` and `graph`). Weights
    are random, made from `seed`; `load_torch` reads an upstream-keyed
    checkpoint. f32 by default, as the JAX facade."""

    task = "nas"
    _flops_per = "image"

    def __init__(self, model: Union[str, Dict[str, Any]] = "yolo_nas_s",
                 nc: Optional[int] = None, imgsz: int = 640,
                 dtype: str = "float32",
                 names: Optional[Dict[int, str]] = None, seed: int = 0,
                 max_det: int = 300, device=None):
        super().__init__(model, nc=nc, imgsz=imgsz, dtype=dtype, seed=seed,
                         device=device, names=names, max_det=max_det)

    def _build(self):
        return build_nas_model(self.cfg, nc=self.nc, dtype=self.dtype,
                               device=self.device, seed=self.seed,
                               **self.model_kw)

    def predict(self, source, conf: float = 0.25, augment: bool = False):
        """A TrackResults a frame (track id -1) over image files, a `.npy`
        stack or uint8 HWC frames: each stretched to `imgsz`, one step (the
        TTA step with `augment`), the boxes scoring `conf` or more in
        original pixels."""
        import numpy as np

        from mo_yolo_tpu_torch.data.letterbox import boxes_to_original, \
            letterbox
        from mo_yolo_tpu_torch.engine.predictor import _frames
        from mo_yolo_tpu_torch.engine.results import TrackResults
        from mo_yolo_tpu_torch.engine.validator import _to_host
        step = self.model.predict_step_tta if augment \
            else self.model.predict_step
        s = int(self.imgsz)
        self.callbacks.fire("on_predict_start", predictor=self, model=self)
        try:
            for n, (path, img) in enumerate(_frames(source, workers=2)):
                x, gain, pad = letterbox(img, (s, s), scale_fill=True)
                b, sc, c = (t[0] for t in _to_host(*step(
                    torch.from_numpy(x[None]).to(self.device))))
                keep = sc >= conf
                xyxy = np.stack([(b[:, 0] - b[:, 2] / 2) * s,
                                 (b[:, 1] - b[:, 3] / 2) * s,
                                 (b[:, 0] + b[:, 2] / 2) * s,
                                 (b[:, 1] + b[:, 3] / 2) * s], 1)[keep]
                meta = {"orig_shape": img.shape[:2], "gain": gain,
                        "pad": pad, "scale_fill": True}
                yield TrackResults(
                    boxes_xyxy=boxes_to_original(xyxy, meta), conf=sc[keep],
                    cls=c[keep].astype(int),
                    track_id=np.full(int(keep.sum()), -1),
                    orig_shape=img.shape[:2], path=path, names=self.names,
                    orig_img=img)
                self.callbacks.fire("on_predict_batch_end", predictor=self,
                                    model=self, step=n)
        finally:
            self.callbacks.fire("on_predict_end", predictor=self, model=self)

    __call__ = predict

    def val(self, data: Union[str, List[str]], max_gt: int = 64
            ) -> Dict[str, float]:
        """mAP50, mAP50-95, precision, recall and fps on a dataset yaml's
        val split or an image list (`DetectionValidator`, conf 0.001)."""
        from mo_yolo_tpu_torch.engine.validator import DetectionValidator
        if isinstance(data, str):
            from mo_yolo_tpu_torch.data.dataset import load_dataset_yaml
            d = load_dataset_yaml(data)
            files = _split_files(d, "val", data)
            self.names = self.names or dict(d.get("names") or {})
        else:
            files = list(data)
        return DetectionValidator(self.model, imgsz=self.imgsz, conf=0.001,
                                  callbacks=self.callbacks)(files,
                                                            max_gt=max_gt)

    def info(self, detailed: bool = False, verbose: bool = True,
             flops: bool = False, profile: bool = False) -> Dict[str, Any]:
        """The facades' summary plus the JAX `NAS.info` keys `nc` and
        `strides`."""
        out = super().info(detailed, verbose, flops, profile)
        out.update(nc=self.model.spec.nc,
                   strides=tuple(self.model.spec.out_strides))
        return out

    def _step_flops(self, hw) -> int:
        from mo_yolo_tpu_torch.utils.profiling import count_flops
        x = torch.zeros((1, *hw, 3), dtype=torch.uint8, device=self.device)
        return count_flops(self.model.predict_step, x)

    def _program(self, batch: int):
        return PredictStep(self.model), (self._frames(batch),), {}

    def _export_impl(self, fmt: str = "params", path: str = "nas_export",
                     half: bool = False, optimize: bool = False,
                     **kw) -> str:
        """`params`, `pt`, `pt2` and `graph` as the other facades (`pt`'s
        `train_args` name the detect task, as the JAX export does);
        `torchscript` traces the forward without NMS."""
        if fmt == "torchscript":
            from mo_yolo_tpu_torch.utils.torch_export import \
                export_torchscript
            return export_torchscript(self.model, path, self.imgsz,
                                      task="detect", names=self.names,
                                      half=half, optimize=optimize)
        if fmt == "pt":
            from mo_yolo_tpu_torch.utils.torch_export import \
                export_reference_pt
            return export_reference_pt(
                self.model, path,
                train_args={"model": self.cfg if isinstance(self.cfg, str)
                            else "dict", "task": "detect",
                            "imgsz": self.imgsz, "names": self.names},
                half=half)
        return super()._export_impl(fmt, path, half=half, optimize=optimize,
                                    **kw)
