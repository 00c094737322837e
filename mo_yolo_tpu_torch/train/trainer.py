"""Host training loop: epochs over clip batches, checkpoints, logging (the
port's copy of `EarlyStopping` and `TrackTrainer` from
`mo_yolo_tpu/train/trainer.py`).

The clip step is `train.train_step.make_train_step`; this file feeds it
clips, logs, validates, saves and resumes, in the JAX trainer's order:

- clips of `clip_len` frames (a list advances at the epochs of
  `clip_stages`), `batch` clips a step, `accumulate` (or `nbs / batch`)
  steps an update, the schedule's `total_steps` fixed at the first stage;
- at each epoch end the EMA is adopted for evaluation and saving, `last`
  (and every `save_period` epochs `epoch<e>`) is saved, the fitness is
  HOTA on the first 200 val frames or minus the epoch's mean loss, `best`
  follows the fitness, `last_full` holds the whole training state and
  `results.csv` the logged steps;
- at the end `best` is loaded and evaluated, and its metrics returned with
  `final_loss`.

Three things differ from the JAX trainer by design:

- the parameters: the facade's model is its inference model, in its dtype
  (bf16 by default). The trainer trains an f32 module built from the
  facade's config and seed (or holding the facade's weights, where they
  are not the seed's), with bf16 autocast on the card when `amp`; the
  CPU trains in f32. Bf16 parameters are never trained;
- the EMA adoption: JAX swaps the facade's variables; here the training
  module is live, so the EMA and its BatchNorm buffers are copied into the
  facade's model (cast to its dtype), which `val` runs and `last`/`best`
  save; the training module is left as it is;
- the noise: the JAX trainer folds the start epoch into its key once and
  splits a key a step. PyTorch cannot draw JAX's numbers, so each epoch
  draws from a `torch.Generator` on the training device seeded from
  (seed, epoch): a run resumed at epoch e draws what the run that was not
  interrupted drew there.

`batch=-1` takes the largest of 1, 2, 4 and 8 streams whose full-clip
training step fits the card (`utils/autobatch`: each candidate runs one
step on a copy of the module). `plots=True` draws the label statistics
(matplotlib, where it imports), the first three training batches and
`results.png`, each best-effort: a plot never stops a run.

Data parallelism over ranks (`torchrun --nproc_per_node N -m
mo_yolo_tpu_torch track train ...`, or a process group the caller built):
`run` joins the group (`parallel.distributed.initialize`, a no-op in one
process) and builds its step with `parallel.mesh.make_sharded_train_step`.
`batch` stays the global batch: every rank loads the same clips and steps
its rows of them, with the BatchNorm statistics, the object count and the
gradients summed over the ranks, so every rank holds the same parameters
after every step. A batch the ranks do not divide raises a ValueError:
the JAX trainer shards over gcd(batch, devices) devices instead, but a
rank cannot sit out the group's collectives. `batch=-1` probes one card
on every rank and takes the smallest answer times the ranks. Rank 0
alone writes the run's files (results.csv, the plots, `last`,
`epoch<e>`, `best`, `last_full`; the default loggers run on it alone),
and every rank waits at a barrier before it reads one (`last_full` on
resume, `best` at the end). Every rank runs the same epoch-end
validation on the same parameters, so the fitness, `best` and early
stopping agree without a broadcast: the JAX program's SPMD reading, in
which every device runs the one program.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from mo_yolo_tpu_torch.parallel import distributed, mesh
from mo_yolo_tpu_torch.train import train_step
from mo_yolo_tpu_torch.utils.callbacks import default_callbacks
from mo_yolo_tpu_torch.utils.logging import LOGGER


class EarlyStopping:
    """Stop when the fitness has not improved for `patience` epochs."""

    def __init__(self, patience: int = 50):
        self.patience = patience
        self.best = -float("inf")
        self.best_epoch = 0

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness > self.best:
            self.best = fitness
            self.best_epoch = epoch
        return (epoch - self.best_epoch) >= self.patience


def plot_label_stats(ds, save_dir: Path) -> None:
    """labels.png and labels_correlogram.png from the dataset's label rows
    (no image decoded); skipped without matplotlib."""
    try:
        rows = [ds._label(i) for i in range(len(ds))]
        lab = np.concatenate([r for r in rows if len(r)], axis=0) \
            if any(len(r) for r in rows) else np.zeros((0, 6))
        if not len(lab):
            return
        from mo_yolo_tpu_torch.utils.plotting import (
            plot_labels, plot_labels_correlogram)
        plot_labels(lab[:, 0], lab[:, 1:5], str(save_dir / "labels.png"))
        plot_labels_correlogram(
            lab[:, 1:5], str(save_dir / "labels_correlogram.png"))
    except Exception as e:  # a plot never stops a run
        LOGGER.warning(f"label plots failed: {e}")


def adopt_ema(ts, target: torch.nn.Module) -> None:
    """The EMA and the training module's buffers into `target` (the
    facade's model), cast to its dtype."""
    params = dict(target.named_parameters())
    buffers = dict(target.named_buffers())
    with torch.no_grad():
        for n, e in ts.ema.items():
            params[n].copy_(e)
        for n, b in ts.model.named_buffers():
            buffers[n].copy_(b)


def training_module(api, build) -> torch.nn.Module:
    """The f32 module that trains: `build` (a `build_*_model`) from the
    facade's config and seed, holding the facade's weights where they are
    not the seed's."""
    model = build(api.cfg, nc=api.nc, dtype="float32", device=api.device,
                  seed=api.seed, **api.model_kw)
    facade = api.model.state_dict()
    own = model.state_dict()
    if any(not torch.equal(own[k].to(v.dtype), v) for k, v in facade.items()):
        model.load_state_dict(facade)
    return model


def augmenter_from_hyp(hyp, seed: int):
    """The single-image augmenter from `hyp`'s keys, with the reference's
    track defaults where a key is missing: HSV, flips and a mild affine
    on, perspective off."""
    from mo_yolo_tpu_torch.data.augment import ClipAugmenter
    h = hyp or {}
    return ClipAugmenter(
        hsv_h=float(h.get("hsv_h", 0.015)), hsv_s=float(h.get("hsv_s", 0.7)),
        hsv_v=float(h.get("hsv_v", 0.4)), fliplr_p=float(h.get("fliplr", 0.5)),
        flipud_p=float(h.get("flipud", 0.0)),
        degrees=float(h.get("degrees", 0.0)),
        translate=float(h.get("translate", 0.05)),
        scale=float(h.get("scale", 0.2)), shear=float(h.get("shear", 0.0)),
        perspective=float(h.get("perspective", 0.0)), seed=seed)


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of epoch `epoch`'s noise generator."""
    return (seed * 1_000_003 + epoch) % (2 ** 63)


class _ClipFeeder:
    """Host clips (dicts of numpy arrays) to tensors on the training
    device. On the card they go through pinned host buffers allocated at
    the first clip (a feeder serves one clip shape, one stage); a buffer is
    refilled only after the copy out of it has finished."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host: Optional[Dict[str, torch.Tensor]] = None
        self.copied: Optional[torch.cuda.Event] = None

    def __call__(self, clip: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        if self.device.type != "cuda":
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in clip.items()}
        if self.host is None:
            self.host = {k: torch.empty(v.shape,
                                        dtype=torch.from_numpy(v[:0]).dtype,
                                        pin_memory=True)
                         for k, v in clip.items()}
        if self.copied is not None:
            self.copied.synchronize()
        out = {}
        for k, v in clip.items():
            self.host[k].numpy()[...] = v
            out[k] = self.host[k].to(self.device, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()
        return out


class TrackTrainer:
    def __init__(self, api_model, data: str, epochs: int = 1, batch: int = 1,
                 clip_len=5, lr: float = 1e-4, max_gt: int = 64,
                 save_dir: str = "runs/track", seed: int = 0,
                 val_every: int = -1, log_every: int = 10,
                 patience: int = 50, callbacks=None,
                 resume: bool = False, accumulate: int = 1,
                 augment: bool = False, hyp=None, clip_stages=None,
                 cache: bool = True, single_cls: bool = False,
                 plots: bool = True, lrf: float = 0.01,
                 save_period: int = -1, optimizer: str = "adamw",
                 momentum: float = 0.937, cos_lr: bool = True,
                 warmup_momentum: float = 0.8, warmup_bias_lr: float = 0.0,
                 nbs: int = -1, fraction: float = 1.0,
                 warmup_epochs: float = -1.0, val: bool = True,
                 pretrained=None, amp: bool = True):
        self.api = api_model
        self.data = data
        self.epochs = epochs
        self.batch = batch
        # progressive clip length: clip_len may be a list, advancing at the
        # epochs in clip_stages; the parameters, EMA and optimizer state
        # carry across stages unchanged
        if isinstance(clip_len, (list, tuple)):
            self.clip_lens = [int(t) for t in clip_len]
            self.clip_stages = [int(e) for e in (clip_stages or [])]
            if len(self.clip_stages) != len(self.clip_lens) - 1:
                raise ValueError(
                    f"clip_stages needs {len(self.clip_lens) - 1} epoch "
                    f"thresholds for clip_len={self.clip_lens}")
        else:
            self.clip_lens = [int(clip_len)]
            self.clip_stages = []
        self.clip_len = self.clip_lens[0]
        self.lr = lr
        self.max_gt = max_gt
        self.save_dir = Path(save_dir)
        self.seed = seed
        # -1: validate every epoch when the dataset has a val split; 0: off;
        # N: every N epochs (resolved in run() once the data is read)
        self.val_every = val_every
        self.log_every = log_every
        self.stopper = EarlyStopping(patience)
        self.callbacks = callbacks or default_callbacks(save_dir)
        self.resume = resume
        self.accumulate = max(int(accumulate), 1)
        self.augment = augment
        self.hyp = hyp
        self.cache = cache              # RAM image cache
        self.single_cls = single_cls    # train all labels as class 0
        self.plots = plots
        self.lrf = lrf                  # final LR fraction
        self.save_period = save_period  # epoch-numbered saves every N
        self.optimizer = optimizer      # sgd|adam*|rmsprop|auto
        self.momentum = momentum
        self.cos_lr = cos_lr
        self.warmup_momentum = warmup_momentum
        self.warmup_bias_lr = warmup_bias_lr
        self.nbs = nbs                  # nominal batch: accumulate =
                                        # round(nbs / batch)
        if self.nbs and self.nbs > 0 and self.batch > 0:
            self.accumulate = max(round(self.nbs / self.batch), 1)
        # train on the first fraction of the dataset
        self.fraction = min(max(float(fraction), 0.0), 1.0) or 1.0
        # epoch-denominated LR warmup; < 0 keeps TrainConfig's 500 steps
        self.warmup_epochs = float(warmup_epochs)
        if not val:
            self.val_every = 0
        self.pretrained = pretrained if isinstance(pretrained, str) else None
        self.amp = bool(amp)
        self.steps_per_epoch = None
        self.train_state = None
        self.autobatch_seconds = None   # the probe's wall time, batch=-1

    def run(self) -> Dict[str, float]:
        from mo_yolo_tpu_torch.data.dataset import (TrackDataset, clip_loader,
                                                    load_dataset_yaml)
        from mo_yolo_tpu_torch.train.losses import LossConfig
        from mo_yolo_tpu_torch.train.train_step import TrainConfig
        from mo_yolo_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                        load_params,
                                                        save_checkpoint,
                                                        save_params)

        distributed.initialize()
        world = distributed.global_mesh()
        lead = world.rank == 0          # writes the run's files
        if self.batch > 0 and self.batch % world.size:
            raise ValueError(
                f"batch {self.batch} does not split over {world.size} "
                f"ranks: give a multiple of {world.size} (every rank takes "
                f"part in each step's collectives)")
        self.callbacks.fire("on_train_start", trainer=self)
        d = load_dataset_yaml(self.data)
        if self.val_every < 0:
            self.val_every = 1 if d.get("val") else 0
        if self.fraction < 1.0:
            keep = max(int(round(len(d["train"]) * self.fraction)), 1)
            LOGGER.info(f"fraction={self.fraction}: {keep}/"
                        f"{len(d['train'])} train frames")
            d["train"] = d["train"][:keep]
        augmenter = augmenter_from_hyp(self.hyp, self.seed) \
            if self.augment else None
        from mo_yolo_tpu_torch.models.tracking_model import \
            build_tracking_model
        dev = self.api.device
        model = training_module(self.api, build_tracking_model)
        compute_dtype = torch.bfloat16 if self.amp and dev.type == "cuda" \
            else None
        if compute_dtype is not None:
            LOGGER.info("amp: training with bf16 autocast (f32 params)")
        lcfg = LossConfig(nc=model.spec.nc)
        if self.batch == -1:
            t0 = time.perf_counter()
            per_card = distributed.min_over_ranks(
                self._autobatch(model, lcfg, compute_dtype))
            self.batch = per_card * world.size
            self.autobatch_seconds = time.perf_counter() - t0
            LOGGER.info(f"autobatch: {per_card} streams a card x "
                        f"{world.size} ranks -> batch {self.batch} "
                        f"({self.autobatch_seconds:.1f}s probe)")
        if self.nbs and self.nbs > 0:
            self.accumulate = max(round(self.nbs / max(self.batch, 1)), 1)
            LOGGER.info(f"nbs={self.nbs}: accumulate={self.accumulate}")

        def stage_for(epoch: int) -> int:
            return sum(1 for thr in self.clip_stages if epoch >= thr)

        total_steps = None      # fixed across stages: one LR schedule

        def build_stage(T: int):
            nonlocal total_steps
            ds = TrackDataset(d["train"], imgsz=self.api.imgsz,
                              max_gt=self.max_gt, clip_len=T,
                              augmenter=augmenter, verify=True,
                              cache_images=self.cache,
                              single_cls=self.single_cls)
            n_clips = len(ds.clips)
            if n_clips == 0:
                raise ValueError("no clips found: dataset too small for "
                                 f"clip_len={T}")
            steps_per_epoch = max(n_clips // self.batch, 1)
            if total_steps is None:
                # the schedule advances once an update (every
                # `accumulate` steps)
                total_steps = max(
                    self.epochs * steps_per_epoch // self.accumulate, 1)
            wu = {}
            if self.warmup_epochs >= 0:
                wu["warmup_steps"] = max(int(
                    self.warmup_epochs * steps_per_epoch
                    / self.accumulate), 1)
            tcfg = TrainConfig(clip_len=T, lr=self.lr, lrf=self.lrf,
                               accumulate=self.accumulate,
                               total_steps=total_steps,
                               optimizer=self.optimizer,
                               momentum=self.momentum, cos_lr=self.cos_lr,
                               warmup_momentum=self.warmup_momentum,
                               warmup_bias_lr=self.warmup_bias_lr, **wu)
            self.steps_per_epoch = steps_per_epoch
            init_fn, step = mesh.make_sharded_train_step(model, lcfg, tcfg,
                                                         compute_dtype)
            return ds, steps_per_epoch, init_fn, step

        cur_stage = 0
        ds, steps_per_epoch, init_fn, step = build_stage(self.clip_lens[0])
        if self.pretrained:
            load_params(self.pretrained, target=model)
            load_params(self.pretrained, target=self.api.model)
            LOGGER.info(f"pretrained weights loaded from {self.pretrained}")
        ts = self.train_state = init_fn()

        start_epoch = 0
        resumed_best_fitness = -float("inf")
        last_full = self.save_dir / "last_full"
        if self.resume:
            distributed.barrier()
        if self.resume and last_full.exists():
            load_checkpoint(str(last_full), target=ts)
            cfg_json = Path(str(last_full.resolve()) + ".config.json")
            if cfg_json.exists():
                with open(cfg_json) as f:
                    saved = json.load(f)
                start_epoch = int(saved.get("epoch", -1)) + 1
                # the best checkpoint's fitness and the stopper's state, so
                # that the first epoch after a resume does not replace a
                # better `best`
                resumed_best_fitness = float(
                    saved.get("best_fitness", -float("inf")))
                self.stopper.best = float(
                    saved.get("stopper_best", self.stopper.best))
                self.stopper.best_epoch = int(
                    saved.get("stopper_best_epoch", self.stopper.best_epoch))
            LOGGER.info(f"resumed from {last_full}: epoch {start_epoch}, "
                        f"step {ts.step}")
            if start_epoch >= self.epochs:
                LOGGER.info("nothing to resume: training already finished")
                return {"final_loss": float("nan")}
        elif self.resume:
            LOGGER.warning(f"resume requested but {last_full} not found; "
                           "starting fresh")

        LOGGER.info(f"training: {len(ds)} frames, {len(ds.clips)} clips, "
                    f"{steps_per_epoch} steps/epoch x {self.epochs} epochs, "
                    f"clip_len={self.clip_lens}, device={dev}")
        if lead:
            self.save_dir.mkdir(parents=True, exist_ok=True)
        if self.plots and lead:
            plot_label_stats(ds, self.save_dir)
        csv_path = self.save_dir / "results.csv"
        csv_rows = ["epoch,step,loss,grad_norm,num_objects,sec_per_step"]
        best_fitness = resumed_best_fitness
        metrics: Dict[str, float] = {}
        feeder = _ClipFeeder(dev)

        for epoch in range(start_epoch, self.epochs):
            if stage_for(epoch) != cur_stage:
                cur_stage = stage_for(epoch)
                T = self.clip_lens[cur_stage]
                LOGGER.info(f"epoch {epoch}: clip_len -> {T} "
                            "(progressive sampler stage switch)")
                ds, steps_per_epoch, _, step = build_stage(T)
                feeder = _ClipFeeder(dev)
                self.clip_len = T
            self.callbacks.fire("on_train_epoch_start", trainer=self,
                                epoch=epoch)
            t_ep = time.time()
            gen = torch.Generator(device=dev).manual_seed(
                epoch_seed(self.seed, epoch))
            loss_dev = []   # device scalars; one fetch at the epoch's end
            for i, clip in enumerate(clip_loader(ds, self.batch, shuffle=True,
                                                 seed=self.seed + epoch)):
                if self.plots and lead and epoch == start_epoch and i < 3:
                    self._plot_train_batch(clip, i)
                t0 = time.time()
                ts, m = step(ts, feeder(clip), gen)
                loss_dev.append(m["loss"])
                if i % self.log_every == 0:
                    loss = float(m["loss"])  # a host sync, for logging only
                    dt = time.time() - t0
                    LOGGER.info(f"epoch {epoch} step {i}/{steps_per_epoch} "
                                f"loss {loss:.4f} gnorm "
                                f"{float(m['grad_norm']):.2f} ({dt:.2f}s)")
                    csv_rows.append(f"{epoch},{i},{loss:.5f},"
                                    f"{float(m['grad_norm']):.4f},"
                                    f"{int(m['num_objects'])},{dt:.3f}")
                self.callbacks.fire("on_train_batch_end", trainer=self,
                                    step=i, metrics=m)
            # epoch end: the EMA weights are evaluated and saved
            adopt_ema(ts, self.api.model)
            if lead:
                save_params(str(self.save_dir / "last"), self.api.model)
            if lead and self.save_period > 0 and \
                    (epoch + 1) % self.save_period == 0:
                save_params(str(self.save_dir / f"epoch{epoch}"),
                            self.api.model)
            # fitness without validation: minus the mean loss of every step
            fitness = -float(torch.stack(loss_dev).mean()) if loss_dev \
                else 0.0
            if self.val_every and (epoch + 1) % self.val_every == 0 and \
                    d["val"]:
                metrics = self.api.val(d["val"][:200])
                fitness = metrics.get("HOTA", fitness)
                LOGGER.info(f"epoch {epoch} val: {metrics}")
            if fitness > best_fitness:
                best_fitness = fitness
                if lead:
                    save_params(str(self.save_dir / "best"), self.api.model)
            stop = self.stopper(epoch, fitness)
            # after the fitness and stopper updates, so that a resumed run
            # restores this epoch's best_fitness
            if lead:
                save_checkpoint(str(last_full), ts,
                                config={"epoch": epoch, "step": ts.step,
                                        "best_fitness": best_fitness,
                                        "stopper_best": self.stopper.best,
                                        "stopper_best_epoch":
                                            self.stopper.best_epoch})
                csv_path.write_text("\n".join(csv_rows) + "\n")
            self.callbacks.fire("on_train_epoch_end", trainer=self,
                                epoch=epoch, metrics=metrics)
            LOGGER.info(f"epoch {epoch} done in {time.time() - t_ep:.1f}s")
            if stop:
                LOGGER.info(f"early stopping at epoch {epoch} "
                            f"(best epoch {self.stopper.best_epoch})")
                break
        if self.plots and lead:
            try:
                from mo_yolo_tpu_torch.utils.plotting import plot_results
                plot_results(str(csv_path))
            except Exception as e:  # a plot never stops a run
                LOGGER.warning(f"plot_results failed: {e}")
        # final evaluation of the best checkpoint: the returned metrics
        # describe `best`, and the facade's model keeps its weights
        distributed.barrier()
        best_path = self.save_dir / "best"
        if self.val_every and d.get("val") and best_path.exists():
            load_params(str(best_path), target=self.api.model)
            metrics = self.api.val(d["val"][:200])
            LOGGER.info(f"final eval (best): {metrics}")
        self.callbacks.fire("on_train_end", trainer=self, metrics=metrics)
        metrics["final_loss"] = -best_fitness if not metrics else \
            metrics.get("final_loss", -best_fitness)
        return metrics

    def _plot_train_batch(self, clip, i: int) -> None:
        """train_batch<i>.png: the clip's frames with their boxes and track
        ids, as the model sees them (drawn by the port itself)."""
        try:
            from mo_yolo_tpu_torch.utils.plotting import save_train_batch
            T, B = clip["images"].shape[:2]

            def flat(a):
                return np.asarray(a).reshape((T * B,) + a.shape[2:])
            save_train_batch(flat(clip["images"]), flat(clip["gt_boxes"]),
                             str(self.save_dir / f"train_batch{i}.png"),
                             ids=flat(clip["gt_track_id"]),
                             mask=flat(clip["gt_mask"]))
        except Exception as e:
            LOGGER.warning(f"train-batch plot failed: {e}")

    def _autobatch(self, model, lcfg, compute_dtype,
                   candidates=(1, 2, 4, 8)) -> int:
        """The largest of `candidates` streams whose full-clip training
        step (the first clip length, this imgsz and max_gt) fits the card:
        each runs one step of a copy of `model` on a synthetic clip
        (`utils/autobatch.auto_streams`)."""
        import copy

        from mo_yolo_tpu_torch.data.letterbox import to_hw
        from mo_yolo_tpu_torch.train.train_step import TrainConfig
        from mo_yolo_tpu_torch.utils.autobatch import auto_streams

        T, G, dev = self.clip_lens[0], self.max_gt, self.api.device
        ih, iw = to_hw(self.api.imgsz)
        probe = copy.deepcopy(model)
        init_fn, step = train_step.make_train_step(
            probe, lcfg, TrainConfig(clip_len=T, lr=self.lr, total_steps=10),
            compute_dtype)
        ts = init_fn()
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        n_obj = min(G, 20)
        k = torch.arange(n_obj, device=dev)
        box = torch.stack([0.1 + 0.8 * (k % 5) / 4, 0.1 + 0.8 * (k // 5) / 4,
                           torch.full((n_obj,), 0.08, device=dev),
                           torch.full((n_obj,), 0.15, device=dev)], -1)

        def run(b):
            clip = {"images": torch.zeros((T, b, ih, iw, 3), dtype=torch.uint8,
                                          device=dev),
                    "gt_cls": torch.zeros((T, b, G), dtype=torch.int32,
                                          device=dev),
                    "gt_boxes": torch.zeros((T, b, G, 4), device=dev),
                    "gt_track_id": torch.zeros((T, b, G), dtype=torch.int32,
                                               device=dev),
                    "gt_mask": torch.zeros((T, b, G), dtype=torch.bool,
                                           device=dev)}
            clip["gt_boxes"][:, :, :n_obj] = box
            clip["gt_track_id"][:, :, :n_obj] = k.int()
            clip["gt_mask"][:, :, :n_obj] = True
            step(ts, clip, gen)

        try:
            return auto_streams(run, candidates, device=dev)
        finally:
            del ts, probe
            if dev.type == "cuda":
                torch.cuda.empty_cache()
