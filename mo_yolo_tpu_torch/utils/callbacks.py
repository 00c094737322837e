"""Callback event bus (the port's copy of `CallbackBus`, its event list,
`JsonlLogger` and `default_callbacks` from `mo_yolo_tpu/utils/callbacks.py`).

`default_callbacks` registers the JSONL run logger and, as the JAX
package does, the TensorBoard, MLflow, W&B, Comet, ClearML, Neptune, DVC
and Ray Tune loggers, each only where its package imports, its
credentials are set and `utils/settings.Settings` enables it. None is
installed on the card's machine, where the JSONL logger runs alone.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List

EVENTS = [
    "on_pretrain_routine_start", "on_pretrain_routine_end",
    "on_train_start", "on_train_epoch_start", "on_train_batch_start",
    "on_train_batch_end", "on_train_epoch_end", "on_fit_epoch_end",
    "on_model_save", "on_train_end", "on_params_update",
    "on_val_start", "on_val_batch_start", "on_val_batch_end", "on_val_end",
    "on_predict_start", "on_predict_batch_start", "on_predict_batch_end",
    "on_predict_postprocess_end", "on_predict_end",
    "on_export_start", "on_export_end",
    "teardown",
]


class CallbackBus:
    def __init__(self):
        self._cbs: Dict[str, List[Callable]] = defaultdict(list)

    def add(self, event: str, fn: Callable):
        if event not in EVENTS:
            raise KeyError(f"unknown event {event!r}")
        self._cbs[event].append(fn)

    def fire(self, event: str, **kwargs):
        for fn in self._cbs.get(event, []):
            fn(**kwargs)

    def clear(self, event: str | None = None):
        """Drop callbacks for one event, or all (reference
        `Model.clear_callback` / `reset_callbacks`)."""
        if event is None:
            self._cbs.clear()
        else:
            self._cbs.pop(event, None)

    def merge(self, other: "CallbackBus"):
        """Append every callback from `other` (the reference merges the
        Model facade's user callbacks into each trainer/predictor/
        validator it spawns, `engine/model.py:660-676`)."""
        for ev, fns in other._cbs.items():
            self._cbs[ev].extend(fns)


class JsonlLogger:
    """Minimal run logger: appends one JSON line per event it is given
    (the trainer is left out; a value json cannot write is written as its
    type's name)."""

    def __init__(self, path: str = "runs/track/events.jsonl"):
        self.path = Path(path)

    def __call__(self, **kw):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        rec = {"ts": time.time()}
        for k, v in kw.items():
            if k in ("trainer",):
                continue
            try:
                json.dumps(v)
                rec[k] = v
            except TypeError:
                rec[k] = str(type(v).__name__)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


class TensorBoardLogger:
    """TensorBoard scalars through tensorboardX; inert without it."""

    def __init__(self, log_dir: str, every: int = 10):
        try:
            from tensorboardX import SummaryWriter
            self.writer = SummaryWriter(log_dir)
        except Exception:
            self.writer = None
        self.every = max(every, 1)

    def on_batch(self, step: int = 0, metrics=None, **kw):
        # every `every` batches: float() of a card tensor is a host sync
        if self.writer is None or metrics is None or step % self.every:
            return
        for k, v in metrics.items():
            try:
                self.writer.add_scalar(f"train/{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def on_epoch(self, epoch: int = 0, metrics=None, **kw):
        if self.writer is None or not metrics:
            return
        for k, v in metrics.items():
            try:
                self.writer.add_scalar(f"val/{k}", float(v), epoch)
            except (TypeError, ValueError):
                pass
        self.writer.flush()

    def close(self, **kw):
        if self.writer is not None:
            self.writer.close()


class MLflowLogger:
    """MLflow: the trainer's scalar attributes at the start, metrics an
    epoch. Inert unless `mlflow` imports and MLFLOW_TRACKING_URI is set."""

    def __init__(self, run_name: str = "mo_yolo_tpu_torch"):
        import os
        self.mlflow = None
        if not os.environ.get("MLFLOW_TRACKING_URI"):
            return
        try:
            import mlflow
            self.mlflow = mlflow
            mlflow.start_run(run_name=run_name)
        except Exception:
            self.mlflow = None

    def on_start(self, trainer=None, **kw):
        if self.mlflow is None or trainer is None:
            return
        params = {k: v for k, v in vars(trainer).items()
                  if isinstance(v, (int, float, str, bool))}
        self.mlflow.log_params(params)

    def on_epoch(self, epoch: int = 0, metrics=None, **kw):
        if self.mlflow is None or not metrics:
            return
        clean = {}
        for k, v in metrics.items():
            try:
                clean[k.replace("(", "").replace(")", "")] = float(v)
            except (TypeError, ValueError):
                pass
        self.mlflow.log_metrics(clean, step=epoch)

    def on_end(self, **kw):
        if self.mlflow is not None:
            self.mlflow.end_run()


class WandbLogger:
    """Weights & Biases: scalars every `every` batches and an epoch.
    Inert unless `wandb` imports and WANDB_API_KEY or WANDB_MODE is set."""

    def __init__(self, project: str = "mo_yolo_tpu_torch", every: int = 10):
        import os
        self.wb = None
        self.every = max(every, 1)
        if not (os.environ.get("WANDB_API_KEY") or
                os.environ.get("WANDB_MODE")):
            return
        try:
            import wandb
            self.wb = wandb
            wandb.init(project=project)
        except Exception:
            self.wb = None

    def on_batch(self, step: int = 0, metrics=None, **kw):
        if self.wb is None or metrics is None or step % self.every:
            return
        self.wb.log({f"train/{k}": float(v) for k, v in metrics.items()
                     if _is_scalar(v)}, step=step)

    def on_epoch(self, epoch: int = 0, metrics=None, **kw):
        if self.wb is None or not metrics:
            return
        self.wb.log({f"val/{k}": float(v) for k, v in metrics.items()
                     if _is_scalar(v)})

    def on_end(self, **kw):
        if self.wb is not None:
            self.wb.finish()


class CometLogger:
    """Comet: one Experiment a run, the trainer's scalars at the start,
    metrics an epoch. Inert unless `comet_ml` imports and COMET_API_KEY is
    set."""

    def __init__(self, project: str = "mo_yolo_tpu_torch"):
        import os
        self.exp = None
        if not os.environ.get("COMET_API_KEY"):
            return
        try:
            import comet_ml
            self.exp = comet_ml.Experiment(project_name=project)
        except Exception:
            self.exp = None

    def on_start(self, trainer=None, **kw):
        if self.exp is None or trainer is None:
            return
        self.exp.log_parameters(
            {k: v for k, v in vars(trainer).items()
             if isinstance(v, (int, float, str, bool))})

    def on_epoch(self, epoch: int = 0, metrics=None, **kw):
        if self.exp is None or not metrics:
            return
        self.exp.log_metrics(
            {k: float(v) for k, v in metrics.items() if _is_scalar(v)},
            epoch=epoch)

    def on_end(self, **kw):
        if self.exp is not None:
            self.exp.end()


class ClearMLLogger:
    """ClearML: `Task.init` at the start, scalars an epoch. Inert unless
    `clearml` imports and CLEARML_API_HOST is set."""

    def __init__(self, project: str = "mo_yolo_tpu_torch",
                 task_name: str = "train"):
        import os
        self.task = None
        if not os.environ.get("CLEARML_API_HOST"):
            return
        try:
            from clearml import Task
            self.task = Task.init(project_name=project, task_name=task_name)
        except Exception:
            self.task = None

    def on_start(self, trainer=None, **kw):
        if self.task is None or trainer is None:
            return
        self.task.connect({k: v for k, v in vars(trainer).items()
                           if isinstance(v, (int, float, str, bool))})

    def on_epoch(self, epoch: int = 0, metrics=None, **kw):
        if self.task is None or not metrics:
            return
        logger = self.task.get_logger()
        for k, v in metrics.items():
            if _is_scalar(v):
                logger.report_scalar("val", k, float(v), epoch)

    def on_end(self, **kw):
        if self.task is not None:
            self.task.close()


class NeptuneLogger:
    """Neptune: `init_run` at the start, a metric series an epoch. Inert
    unless `neptune` imports and NEPTUNE_API_TOKEN is set."""

    def __init__(self, project: str = "mo_yolo_tpu_torch"):
        import os
        self.run = None
        if not os.environ.get("NEPTUNE_API_TOKEN"):
            return
        try:
            import neptune
            self.run = neptune.init_run(project=project)
        except Exception:
            self.run = None

    def on_start(self, trainer=None, **kw):
        if self.run is None or trainer is None:
            return
        self.run["config"] = {k: v for k, v in vars(trainer).items()
                              if isinstance(v, (int, float, str, bool))}

    def on_epoch(self, epoch: int = 0, metrics=None, **kw):
        if self.run is None or not metrics:
            return
        for k, v in metrics.items():
            if _is_scalar(v):
                self.run[f"val/{k}"].append(float(v), step=epoch)

    def on_end(self, **kw):
        if self.run is not None:
            self.run.stop()


class DVCLogger:
    """DVCLive: a `Live` logger stepped once an epoch. Inert unless
    `dvclive` imports."""

    def __init__(self, save_dir: str = "runs/track/dvclive"):
        self.live = None
        try:
            from dvclive import Live
            self.live = Live(save_dir, save_dvc_exp=True)
        except Exception:
            self.live = None

    def on_start(self, trainer=None, **kw):
        if self.live is None or trainer is None:
            return
        for k, v in vars(trainer).items():
            if isinstance(v, (int, float, str, bool)):
                self.live.log_param(k, v)

    def on_epoch(self, epoch: int = 0, metrics=None, **kw):
        if self.live is None or not metrics:
            return
        for k, v in metrics.items():
            if _is_scalar(v):
                self.live.log_metric(f"val/{k}", float(v))
        self.live.next_step()

    def on_end(self, **kw):
        if self.live is not None:
            self.live.end()


class RayTuneLogger:
    """Ray Tune: an epoch's metrics reported to the running Tune session.
    Inert unless `ray.tune` imports and a session runs."""

    def __init__(self):
        self.tune = None
        try:
            from ray import tune
            from ray.air import session  # noqa: F401
            if tune.is_session_enabled():
                self.tune = tune
        except Exception:
            self.tune = None

    def on_epoch(self, epoch: int = 0, metrics=None, **kw):
        if self.tune is None or not metrics:
            return
        from ray.air import session
        session.report({k: float(v) for k, v in metrics.items()
                        if _is_scalar(v)} | {"epoch": epoch})


def _is_scalar(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def default_callbacks(save_dir: str = "runs/track",
                      tensorboard: bool = True) -> CallbackBus:
    """A bus with the JSONL logger on the epoch and train ends, writing
    `save_dir/events.jsonl`, and each logger integration whose package
    imports (and whose credentials are set) where `Settings` enables it.
    In a data-parallel run these write the run's one record from rank 0:
    any other rank gets an empty bus."""
    from mo_yolo_tpu_torch.parallel.distributed import process_rank
    if process_rank() != 0:
        return CallbackBus()
    try:
        from mo_yolo_tpu_torch.utils.settings import load_settings
        st = load_settings()
    except (OSError, ValueError):  # a bad settings file never stops training
        st = {}

    def on(k):
        return bool(st.get(k, True))

    bus = CallbackBus()
    logger = JsonlLogger(str(Path(save_dir) / "events.jsonl"))
    bus.add("on_train_epoch_end", logger)
    bus.add("on_train_end", logger)
    if tensorboard and on("tensorboard"):
        tb = TensorBoardLogger(str(Path(save_dir) / "tb"))
        if tb.writer is not None:
            bus.add("on_train_batch_end", tb.on_batch)
            bus.add("on_train_epoch_end", tb.on_epoch)
            bus.add("on_train_end", tb.close)
    ml = MLflowLogger() if on("mlflow") else None
    if ml is not None and ml.mlflow is not None:
        bus.add("on_train_start", ml.on_start)
        bus.add("on_train_epoch_end", ml.on_epoch)
        bus.add("on_train_end", ml.on_end)
    wb = WandbLogger() if on("wandb") else None
    if wb is not None and wb.wb is not None:
        bus.add("on_train_batch_end", wb.on_batch)
        bus.add("on_train_epoch_end", wb.on_epoch)
        bus.add("on_train_end", wb.on_end)
    for key, make, active in (
            ("comet", CometLogger, lambda lg: lg.exp),
            ("clearml", ClearMLLogger, lambda lg: lg.task),
            ("neptune", NeptuneLogger, lambda lg: lg.run),
            ("dvc", lambda: DVCLogger(str(Path(save_dir) / "dvclive")),
             lambda lg: lg.live)):
        lg = make() if on(key) else None
        if lg is not None and active(lg) is not None:
            bus.add("on_train_start", lg.on_start)
            bus.add("on_train_epoch_end", lg.on_epoch)
            bus.add("on_train_end", lg.on_end)
    rt = RayTuneLogger() if on("raytune") else None
    if rt is not None and rt.tune is not None:
        bus.add("on_train_epoch_end", rt.on_epoch)
    return bus
