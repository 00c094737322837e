"""Segment, pose and classify training (the port's copy of
`mo_yolo_tpu/train/task_trainers.py`): datasets of images with polygon or
keypoint labels, and trainers that take epochs of shuffled image batches
through one step (the loss of `train/v8_loss.py`), the ramped EMA and
per-epoch saves.

The trainers differ from the JAX ones as `DetectTrainer` does: each trains
an f32 module built from the facade's config and seed (in f32 throughout,
as the JAX trainers do), copies the EMA and the BatchNorm statistics into
the facade's model at each epoch end, and validates through the facade. The optimizer and the EMA are the track
step's (`train_step.ClipOptimizer`, `update_and_average`).
"""

from __future__ import annotations

import functools
import glob
import random
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mo_yolo_tpu_torch.data.dataset import img2label_path
from mo_yolo_tpu_torch.data.letterbox import letterbox
from mo_yolo_tpu_torch.data.loaders import IMG_EXTS, load_image
from mo_yolo_tpu_torch.data.seg_pose_labels import (parse_pose_label,
                                                    parse_seg_label,
                                                    polygons_to_boxes,
                                                    rasterize_polygons)
from mo_yolo_tpu_torch.train.train_step import (TrainConfig, TrainState,
                                                make_optimizer,
                                                update_and_average)
from mo_yolo_tpu_torch.train.v8_loss import (V8LossConfig,
                                             classification_loss,
                                             v8_pose_loss,
                                             v8_segmentation_loss)
from mo_yolo_tpu_torch.utils.logging import LOGGER


def load_resized(path: str, imgsz: int) -> np.ndarray:
    """An image file stretched to imgsz x imgsz, uint8 [H, W, 3]."""
    return letterbox(load_image(path), (imgsz, imgsz), scale_fill=True)[0]


# ------------------------------------------------------------- datasets

class SegDataset:
    """Images and polygon labels -> fixed-shape (image uint8 [H,W,3], cls
    [G], boxes xyxy px [G,4], pad mask [G], masks [G,m,m] at imgsz /
    `mask_ratio`). With `overlap_mask` a pixel covered by several
    instances belongs to one: the instances are drawn largest first, so
    the smallest wins."""

    def __init__(self, files, imgsz: int, max_gt: int = 16,
                 mask_ratio: int = 4, overlap_mask: bool = True):
        self.files = list(files)
        self.imgsz = imgsz
        self.proto = imgsz // int(mask_ratio)
        self.overlap_mask = overlap_mask
        self.max_gt = max_gt

    def __len__(self):
        return len(self.files)

    def load(self, i: int):
        img = load_resized(self.files[i], self.imgsz)
        cls, polys = parse_seg_label(img2label_path(self.files[i]))
        G, m = self.max_gt, self.proto
        n = min(len(cls), G)
        out_cls = np.zeros(G, np.int32)
        out_box = np.zeros((G, 4), np.float32)
        out_m = np.zeros(G, bool)
        out_masks = np.zeros((G, m, m), np.float32)
        if n:
            out_cls[:n] = cls[:n]
            out_box[:n] = polygons_to_boxes(polys[:n]) * self.imgsz
            out_m[:n] = True
            out_masks[:n] = rasterize_polygons(polys[:n], m)
            if self.overlap_mask and n > 1:
                areas = out_masks[:n].sum((1, 2))
                owner = np.full((m, m), -1, np.int32)
                for j in np.argsort(-areas):
                    owner[out_masks[j] > 0.5] = j
                for j in range(n):
                    out_masks[j] = (owner == j).astype(np.float32)
        return img, out_cls, out_box, out_m, out_masks


class PoseDataset:
    """Images and keypoint labels -> fixed-shape (image uint8 [H,W,3], cls
    [G], boxes xyxy px [G,4], pad mask [G], keypoints px [G,K,3])."""

    def __init__(self, files, imgsz: int, n_kpt: int, max_gt: int = 16):
        self.files = list(files)
        self.imgsz = imgsz
        self.n_kpt = n_kpt
        self.max_gt = max_gt

    def __len__(self):
        return len(self.files)

    def load(self, i: int):
        img = load_resized(self.files[i], self.imgsz)
        cls, boxes, kpts = parse_pose_label(img2label_path(self.files[i]),
                                            self.n_kpt)
        s, G = self.imgsz, self.max_gt
        n = min(len(cls), G)
        out_cls = np.zeros(G, np.int32)
        out_box = np.zeros((G, 4), np.float32)
        out_m = np.zeros(G, bool)
        out_k = np.zeros((G, self.n_kpt, 3), np.float32)
        if n:
            out_cls[:n] = cls[:n]
            cx, cy, w, h = (boxes[:n] * s).T
            out_box[:n] = np.stack([cx - w / 2, cy - h / 2,
                                    cx + w / 2, cy + h / 2], 1)
            out_m[:n] = True
            out_k[:n] = kpts[:n]
            out_k[:n, :, :2] *= s
        return img, out_cls, out_box, out_m, out_k


# ----------------------------------------------------------------- losses

def seg_loss_fn(model: nn.Module, cfg: V8LossConfig, imgsz: float,
                batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The segmentation loss of a batch (images, gt_cls, gt_boxes xyxy px,
    gt_mask, gt_masks); GT masks at another resolution than the
    prototypes' (`mask_ratio` != 4) are resized to it, nearest."""
    box, cls, anc, st, coef, protos = model(batch["images"], raw=True)
    gtm = batch["gt_masks"]
    if gtm.shape[-2:] != protos.shape[1:3]:
        gtm = F.interpolate(gtm, size=protos.shape[1:3], mode="nearest-exact")
    out = v8_segmentation_loss(cfg, box, cls, anc, st, coef, protos,
                               batch["gt_cls"], batch["gt_boxes"],
                               batch["gt_mask"], gtm, imgsz=imgsz)
    return out.pop("loss"), out


def pose_loss_fn(model: nn.Module, cfg: V8LossConfig, gain_pose: float,
                 gain_kobj: float, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The pose loss of a batch (images, gt_cls, gt_boxes, gt_mask,
    gt_kpts)."""
    box, cls, anc, st, kpts = model(batch["images"], raw=True)
    out = v8_pose_loss(cfg, box, cls, anc, st, kpts, batch["gt_cls"],
                       batch["gt_boxes"], batch["gt_mask"], batch["gt_kpts"],
                       gain_pose=gain_pose, gain_kobj=gain_kobj)
    return out.pop("loss"), out


def classify_loss_fn(model: nn.Module, label_smoothing: float,
                     batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross entropy of a batch (images, labels); dropout draws from
    `generator`."""
    return classification_loss(model(batch["images"], generator=generator),
                               batch["labels"],
                               label_smoothing=label_smoothing), {}


def make_task_train_step(model: nn.Module, loss_fn: Callable,
                         tcfg: TrainConfig, nc: int):
    """Returns (init_fn() -> TrainState, step_fn(ts, batch, **loss_kw) ->
    (ts, metrics)): `loss_fn(model, batch, **loss_kw)` in the model's
    dtype, backward, the optimizer's step and the EMA's move; metrics the
    loss terms and `loss`. Nothing comes back to the host."""

    def init_fn() -> TrainState:
        model.train()
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
        return TrainState(model=model, optimizer=make_optimizer(tcfg, model,
                                                                nc=nc),
                          ema=ema, step=0)

    def step_fn(ts: TrainState, batch: Dict[str, torch.Tensor], **loss_kw
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        ts.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, batch=batch, **loss_kw)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        update_and_average(ts, tcfg, dict(model.named_parameters()))
        return ts, metrics

    return init_fn, step_fn


# --------------------------------------------------------------- trainers

class _TaskTrainer:
    """The epoch loop the three trainers share: `make_dataset`, `loss_fn`,
    `batch_from` and `validate` are each task's."""

    task = "task"

    def __init__(self, api_model, data: str, epochs: int = 1,
                 batch: int = 4, lr: float = 1e-4, max_gt: int = 16,
                 save_dir: str = "", seed: int = 0, log_every: int = 10,
                 hyp=None, fraction: float = 1.0, pretrained=None,
                 val_every: int = -1, val: bool = True, patience: int = 50,
                 callbacks=None):
        from mo_yolo_tpu_torch.utils.callbacks import default_callbacks
        self.save_dir = Path(save_dir or f"runs/{self.task}")
        self.callbacks = callbacks or default_callbacks(str(self.save_dir))
        self.api = api_model
        self.imgsz = int(api_model.imgsz)
        self.data = data
        self.epochs = epochs
        self.batch = batch
        self.lr = lr
        self.max_gt = max_gt
        self.seed = seed
        self.log_every = log_every
        self.hyp = dict(hyp or {})      # box/cls/dfl/pose/kobj gains
        self.fraction = min(max(float(fraction), 0.0), 1.0) or 1.0
        self.pretrained = pretrained if isinstance(pretrained, str) else None
        # -1: validate every epoch when there is a val split; 0: off
        self.val_every = val_every if val else 0
        self.patience = patience
        self.train_state: Optional[TrainState] = None
        self.steps_per_epoch: Optional[int] = None

    def _loss_cfg(self) -> V8LossConfig:
        return V8LossConfig(nc=self.api.model.spec.nc,
                            gain_box=float(self.hyp.get("box", 7.5)),
                            gain_cls=float(self.hyp.get("cls", 0.5)),
                            gain_dfl=float(self.hyp.get("dfl", 1.5)))

    def make_dataset(self, files):
        raise NotImplementedError

    def loss_fn(self) -> Callable:
        raise NotImplementedError

    def batch_from(self, samples) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def validate(self, files) -> Dict[str, float]:
        return self.api.val(files)

    @staticmethod
    def fitness_of(metrics: Dict[str, float]) -> float:
        """0.1·mAP50 + 0.9·mAP50-95 summed over the task's metric suffixes
        ((B) and (M) for segment, (B) and (P) for pose)."""
        f = 0.0
        for k, v in metrics.items():
            if k.startswith("mAP50-95"):
                f += 0.9 * v
            elif k.startswith("mAP50"):
                f += 0.1 * v
        return f

    def _splits(self) -> Tuple[List, Optional[List]]:
        from mo_yolo_tpu_torch.data.dataset import load_dataset_yaml
        d = load_dataset_yaml(self.data)
        return d["train"], d.get("val") or None

    def _step_kw(self, epoch: int, i: int) -> Dict:
        return {}

    def _total_steps(self, n: int, steps: int) -> int:
        return max(self.epochs * steps, 1)

    def run(self) -> Dict[str, float]:
        from mo_yolo_tpu_torch.models.heads_extra import build_task_model
        from mo_yolo_tpu_torch.train.trainer import (EarlyStopping,
                                                     _ClipFeeder, adopt_ema,
                                                     training_module)
        from mo_yolo_tpu_torch.utils.checkpoint import (load_params,
                                                        save_params)

        self.callbacks.fire("on_train_start", trainer=self)
        train_files, val_files = self._splits()
        if self.val_every < 0:
            self.val_every = 1 if val_files else 0
        if self.fraction < 1.0:
            keep = max(int(round(len(train_files) * self.fraction)), 1)
            train_files = train_files[:keep]
        ds = self.make_dataset(train_files)
        steps = self.steps_per_epoch = max(len(ds) // self.batch, 1)
        dev = self.api.device
        model = training_module(
            self.api, functools.partial(build_task_model, self.task))
        if self.pretrained:
            load_params(self.pretrained, target=model)
            load_params(self.pretrained, target=self.api.model)
            LOGGER.info(f"pretrained weights loaded from {self.pretrained}")
        tcfg = TrainConfig(clip_len=1, lr=self.lr,
                           total_steps=self._total_steps(len(ds), steps))
        init_fn, step = make_task_train_step(model, self.loss_fn(), tcfg,
                                             nc=model.spec.nc)
        ts = self.train_state = init_fn()
        self.save_dir.mkdir(parents=True, exist_ok=True)
        LOGGER.info(f"{self.task} training: {len(ds)} images, {steps} "
                    f"steps/epoch x {self.epochs} epochs, batch "
                    f"{self.batch}, device={dev}")
        feeder = _ClipFeeder(dev)
        stopper = EarlyStopping(self.patience)
        best_fitness = -float("inf")
        metrics: Dict[str, float] = {}
        losses: List[float] = []
        for epoch in range(self.epochs):
            order = list(range(len(ds)))
            random.Random(self.seed + epoch).shuffle(order)
            t0 = time.time()
            loss_dev = []       # device scalars; one fetch at the epoch end
            for i in range(steps):
                idx = order[i * self.batch:(i + 1) * self.batch]
                if len(idx) < self.batch:
                    break
                batch = feeder(self.batch_from([ds.load(j) for j in idx]))
                ts, m = step(ts, batch, **self._step_kw(epoch, i))
                loss_dev.append(m["loss"])
                self.callbacks.fire("on_train_batch_end", trainer=self,
                                    step=i, metrics=m)
                if i % self.log_every == 0:
                    loss = float(m["loss"])  # a host sync, for logging only
                    losses.append(loss)
                    LOGGER.info(f"{self.task} epoch {epoch} step {i}/{steps} "
                                f"loss {loss:.4f}")
            adopt_ema(ts, self.api.model)
            save_params(str(self.save_dir / "last"), self.api.model)
            fitness = -float(torch.stack(loss_dev).mean()) if loss_dev \
                else 0.0
            if self.val_every and (epoch + 1) % self.val_every == 0 and \
                    val_files:
                metrics = self.validate(val_files)
                fitness = self.fitness_of(metrics)
                LOGGER.info(f"{self.task} epoch {epoch} val: {metrics}")
            if fitness > best_fitness:
                best_fitness = fitness
                save_params(str(self.save_dir / "best"), self.api.model)
            self.callbacks.fire("on_train_epoch_end", trainer=self,
                                epoch=epoch, metrics=metrics)
            LOGGER.info(f"{self.task} epoch {epoch} done in "
                        f"{time.time() - t0:.1f}s")
            if stopper(epoch, fitness):
                LOGGER.info(f"{self.task} early stopping at epoch {epoch}")
                break
        best = self.save_dir / "best"
        if self.val_every and val_files and best.exists():
            load_params(str(best), target=self.api.model)
            metrics = self.validate(val_files)
            LOGGER.info(f"{self.task} final eval (best): {metrics}")
        out = dict(metrics)
        out["final_loss"] = losses[-1] if losses else float("nan")
        self.callbacks.fire("on_train_end", trainer=self, metrics=out)
        return out


class SegTrainer(_TaskTrainer):
    task = "segment"

    def __init__(self, *a, mask_ratio: int = 4, overlap_mask: bool = True,
                 **kw):
        super().__init__(*a, **kw)
        self.mask_ratio = int(mask_ratio)
        self.overlap_mask = bool(overlap_mask)

    def make_dataset(self, files):
        return SegDataset(files, self.imgsz, self.max_gt,
                          mask_ratio=self.mask_ratio,
                          overlap_mask=self.overlap_mask)

    def batch_from(self, samples):
        img, cls, box, m, masks = (np.stack(z) for z in zip(*samples))
        return {"images": img, "gt_cls": cls, "gt_boxes": box,
                "gt_mask": m, "gt_masks": masks}

    def loss_fn(self):
        return functools.partial(seg_loss_fn, cfg=self._loss_cfg(),
                                 imgsz=float(self.imgsz))


class PoseTrainer(_TaskTrainer):
    task = "pose"

    def make_dataset(self, files):
        return PoseDataset(files, self.imgsz, self.api.model.kpt_shape[0],
                           self.max_gt)

    def batch_from(self, samples):
        img, cls, box, m, kpts = (np.stack(z) for z in zip(*samples))
        return {"images": img, "gt_cls": cls, "gt_boxes": box,
                "gt_mask": m, "gt_kpts": kpts}

    def loss_fn(self):
        return functools.partial(
            pose_loss_fn, cfg=self._loss_cfg(),
            gain_pose=float(self.hyp.get("pose", 12.0)),
            gain_kobj=float(self.hyp.get("kobj", 1.0)))


def class_tree(root) -> Tuple[Path, Optional[Path]]:
    """(train root, held-out root or None) of a class-subdir tree: a
    `train/` subtree beside `test/` (preferred) or `val/`, else the whole
    tree and no held-out split."""
    root = Path(root)
    if (root / "train").is_dir():
        for s in ("test", "val"):
            if (root / s).is_dir():
                return root / "train", root / s
        return root / "train", None
    return root, None


def class_files(root: Path, classes: List[str]
                ) -> Tuple[List[str], np.ndarray]:
    """The image files under `root/<class>/` and their class indices."""
    files, labels = [], []
    for ci, c in enumerate(classes):
        for f in sorted(glob.glob(str(root / c / "*"))):
            if Path(f).suffix.lower() in IMG_EXTS:
                files.append(f)
                labels.append(ci)
    return files, np.asarray(labels, np.int32)


class ClassDataset:
    """A class-subdir tree's images -> (image uint8 [H,W,3], class)."""

    def __init__(self, files, labels, imgsz: int):
        self.files, self.labels, self.imgsz = list(files), labels, imgsz

    def __len__(self):
        return len(self.files)

    def load(self, i: int):
        return load_resized(self.files[i], self.imgsz), self.labels[i]


class ClassifyTrainer(_TaskTrainer):
    """Image classification over a class-subdir tree (`data` is its root):
    top-1 and top-5 accuracy on the held-out split, fitness their mean.
    Dropout draws from a `torch.Generator` seeded from (seed, epoch)."""

    task = "classify"

    def _splits(self):
        train_root, val_root = class_tree(self.data)
        classes = sorted(p.name for p in train_root.iterdir() if p.is_dir())
        files, self._labels = class_files(train_root, classes)
        if not files:
            raise ValueError(f"no class-subdir images under {self.data}")
        return files, ([str(val_root)] if val_root is not None else None)

    def make_dataset(self, files):
        return ClassDataset(files, self._labels[:len(files)], self.imgsz)

    def batch_from(self, samples):
        img, labels = zip(*samples)
        return {"images": np.stack(img),
                "labels": np.asarray(labels, np.int32)}

    def _total_steps(self, n: int, steps: int) -> int:
        return max(self.epochs * n // self.batch, 1)

    def _step_kw(self, epoch: int, i: int) -> Dict:
        from mo_yolo_tpu_torch.train.trainer import epoch_seed
        if i == 0:
            self._gen = torch.Generator(device=self.api.device).manual_seed(
                epoch_seed(self.seed, epoch))
        return {"generator": self._gen}

    def loss_fn(self):
        return functools.partial(
            classify_loss_fn,
            label_smoothing=float(self.hyp.get("label_smoothing", 0.0)))

    def validate(self, files) -> Dict[str, float]:
        return self.api.val(files[0])

    @staticmethod
    def fitness_of(metrics: Dict[str, float]) -> float:
        return (metrics["accuracy_top1"] + metrics["accuracy_top5"]) / 2
