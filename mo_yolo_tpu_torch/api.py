"""The facades `MOTRTrack`, `Detector`, `RTDETR` and `YOLO` (the port's
counterparts of those in `mo_yolo_tpu/api.py`).

    from mo_yolo_tpu_torch import MOTRTrack
    tracker = MOTRTrack("yolo_track", imgsz="1536x800")
    for res in tracker.predict("frames/"):    # image files or uint8 arrays
        print(res.track_id, res.boxes_xyxy)
    metrics = tracker.val("data/mot.yaml")   # HOTA, MOTA, IDF1, mAP, ...
    metrics = tracker.train("data/mot.yaml", epochs=2, augment=True)
    tracker.save("runs/track/model")          # weights + .meta.json
    tracker = MOTRTrack("runs/track/model")   # the same model again
    tracker.export(fmt="pt", path="model")    # upstream-format checkpoint
    tracker.export(fmt="pt2", path="model")   # the step, torch.export

    from mo_yolo_tpu_torch import Detector, RTDETR
    det = Detector("yolo_mot", imgsz=640)     # RT-DETR-style, no tracker
    for res in det.predict("frames/"):
        print(res.cls, res.conf, res.boxes_xyxy)
    for res in det.track("frames/", tracker="botsort"):   # or bytetrack
        print(res.track_id, res.boxes_xyxy)
    det.train("data/mot.yaml", epochs=2, batch=4, augment=True)
    metrics = RTDETR("detr_track").val("data/mot.yaml")   # mAP

    from mo_yolo_tpu_torch import YOLO
    seg = YOLO("yolo_track", task="segment", imgsz=640)   # also pose, classify
    for path, res in seg.predict("frames/", as_results=True):
        print(res.boxes_xyxy, res.masks.shape)
    seg.train("data/seg.yaml", epochs=2, batch=4)         # polygon labels
    metrics = seg.val("data/seg.yaml")        # box and mask mAP

Export writes the port's formats: `params` (`save`), `pt` (an
upstream-format checkpoint), `pt2` (the step, `torch.export`ed, with K1
and the greedy suppression as registered ops; `utils/program_export`,
served by `engine/autobackend.AutoBackend`), `graph` (that program
printed), and for the task models `torchscript`. The JAX package's
`jaxexport` and `stablehlo` raise, naming `pt2` and `graph`; its
TensorFlow and ONNX formats raise, naming the package the card's machine
lacks.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch

from mo_yolo_tpu_torch.engine.predictor import TrackPredictor
from mo_yolo_tpu_torch.engine.results import TrackResults
from mo_yolo_tpu_torch.models.heads_extra import TASK_MODELS
from mo_yolo_tpu_torch.models.tracker import TrackerConfig
from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
from mo_yolo_tpu_torch.utils.callbacks import CallbackBus
from mo_yolo_tpu_torch.utils.device import resolve_device
from mo_yolo_tpu_torch.utils.logging import LOGGER

EXPORT_FORMATS = ("params", "pt", "pt2", "graph")
# the JAX package's formats the port does not write, and why
JAX_FORMATS = {
    "jaxexport": "the port's serialized step is format 'pt2' "
                 "(torch.export, loaded by AutoBackend)",
    "stablehlo": "the port's program text is format 'graph' (the "
                 "torch.export program printed)",
    **{f: "it needs TensorFlow, which the card's machine lacks"
       for f in ("saved_model", "keras", "tflite", "pb")},
    "onnx": "it needs the onnx package, which the card's machine lacks",
}


def _rect_from_first(files, imgsz):
    """(h, w) for `rect=True`: the minimum stride-32 rectangle with the
    first image's aspect at the configured long side."""
    from mo_yolo_tpu_torch.data.letterbox import rect_hw
    from mo_yolo_tpu_torch.data.loaders import load_image
    h0, w0 = load_image(str(files[0])).shape[:2]
    return rect_hw(h0, w0, imgsz)


def _split_files(d, split, data):
    """The image list of a dataset-yaml split. Raises when the split is
    missing or empty, so that `val(split="test")` never scores the val
    set under another name."""
    files = d.get(split) or []
    if not files:
        have = [k for k in ("train", "val", "test") if d.get(k)]
        raise ValueError(
            f"dataset '{data}' has no images for split='{split}' "
            f"(populated splits: {have or 'none'})")
    return files


def _merged_bus(*buses) -> CallbackBus:
    """A fresh bus with every callback of `buses`, in order: merging into a
    caller's bus would change the caller's object (a second `train()` would
    fire the facade's callbacks twice)."""
    out = CallbackBus()
    for b in buses:
        if b is not None:
            out.merge(b)
    return out


def _meta_path(path) -> Path:
    return Path(str(Path(path).resolve()) + ".meta.json")


class _CallbackMixin:
    """Callbacks added on the facade ride into every predictor, validator
    and trainer it makes; `export` fires `on_export_start` and
    `on_export_end` around `_export_impl`."""

    @property
    def callbacks(self) -> CallbackBus:
        if not hasattr(self, "_callbacks"):
            self._callbacks = CallbackBus()
        return self._callbacks

    def add_callback(self, event: str, fn):
        self.callbacks.add(event, fn)

    def clear_callback(self, event: str):
        self.callbacks.clear(event)

    def reset_callbacks(self):
        self.callbacks.clear()

    def export(self, *args, **kwargs):
        fmt = kwargs.get("fmt", args[0] if args else None)
        self.callbacks.fire("on_export_start", model=self, fmt=fmt)
        out = self._export_impl(*args, **kwargs)
        self.callbacks.fire("on_export_end", model=self, fmt=fmt, path=out)
        return out


class _TuneMixin:
    """`tune()`: random search with successive halving over freshly built
    models (`utils/tuner.Tuner`), or Ray Tune with `use_ray=True`. A facade
    provides `_fresh_for_tune(seed)`; `_TUNE_TOP` names the sampled keys
    its trainer takes as arguments (every other one goes into its `hyp`
    dict); `_tune_resume` says whether its trainer continues a trial from
    its save_dir at a later rung (else the trial trains again from
    scratch)."""

    _TUNE_TOP: Tuple[str, ...] = ()
    _tune_resume = False
    _tune_save_dir = "runs/tune"
    # trainers that take augment= get it on while tuning, so that the
    # sampled augmentation knobs change the fitness
    _tune_train_augment = False

    def _tune_space(self, space):
        from mo_yolo_tpu_torch.utils.tuner import DEFAULT_SPACE
        return dict(space) if space is not None else dict(DEFAULT_SPACE)

    def _route_tune_hyp(self, hyp: Dict[str, Any]) -> Dict[str, Any]:
        top = {k: v for k, v in hyp.items() if k in self._TUNE_TOP}
        rest = {k: v for k, v in hyp.items() if k not in self._TUNE_TOP}
        if rest:
            top["hyp"] = rest
        return top

    def fuse(self, verbose: bool = True):
        """Conv+BN fusion: a no-op that returns `self`, as in the JAX
        package; the weights are not rewritten. Kept so that upstream code
        (`model.fuse().predict(...)`) runs."""
        if verbose:
            LOGGER.info("fuse(): no conv+BN weight rewrite in the port; "
                        "model unchanged.")
        return self

    def tune(self, data: str, epochs: int = 10,
             space: Optional[Dict[str, Any]] = None, max_samples: int = 10,
             grace_period: int = 0, reduction: int = 2, seed: int = 0,
             save_dir: Optional[str] = None, use_ray: bool = False,
             **train_args) -> Dict[str, Any]:
        """Hyperparameter search. Each trial trains a freshly initialized
        model in save_dir/trial_N; `grace_period` > 0 turns on the halving
        rungs. Returns {best_hyp, best_fitness, best_trial, results}."""
        from mo_yolo_tpu_torch.utils.tuner import Tuner, run_ray_tune

        if use_ray:
            return run_ray_tune(self, space=space,
                                grace_period=grace_period,
                                max_samples=max_samples, data=data,
                                epochs=epochs, reduction=reduction,
                                seed=seed, save_dir=save_dir, **train_args)
        space = self._tune_space(space)
        if self._tune_train_augment:
            train_args.setdefault("augment", True)

        def train_fn(hyp, n_epochs, tdir, resume):
            # the trial's seed from its folder's number, so that a later
            # rung resumes the same initialization
            m = self._fresh_for_tune(
                seed=seed + 1 + int(tdir.rsplit("_", 1)[-1]))
            kw = dict(train_args)
            routed = self._route_tune_hyp(hyp)
            if "hyp" in kw and "hyp" in routed:  # fixed hyp + sampled hyp
                routed["hyp"] = {**kw.pop("hyp"), **routed["hyp"]}
            kw.update(routed)
            if self._tune_resume:
                kw["resume"] = resume
            return m.train(data, epochs=n_epochs, save_dir=tdir, **kw)

        return Tuner(train_fn, space=space, max_samples=max_samples,
                     grace_period=grace_period, reduction=reduction,
                     seed=seed,
                     save_dir=save_dir or self._tune_save_dir)(epochs=epochs)


class _ModelFacade(_CallbackMixin, _TuneMixin):
    """What the task facades share: the model saved as its weights and a
    `.meta.json` that rebuilds it, upstream checkpoints in, and export to
    the port's formats. A facade names its `task`, builds its model from
    `cfg`, `nc`, `dtype`, `seed` and `model_kw` in `_build`, and counts
    the FLOPs of the step that `info` reports in `_step_flops`."""

    task = ""
    _flops_per = "frame"

    def __init__(self, model: Union[str, Dict[str, Any]] = "yolo_track",
                 nc: Optional[int] = None, imgsz=640,
                 dtype: str = "bfloat16", seed: int = 0, device=None,
                 names: Optional[Dict[int, str]] = None, **model_kw):
        self.device = resolve_device(device)
        if isinstance(model, (str, Path)) and _meta_path(model).is_file():
            self.load(str(model))
            return
        self.imgsz = imgsz
        self.names = dict(names or {})
        # what the trainer needs to build its f32 twin of this model
        self.cfg, self.nc, self.seed, self.dtype = model, nc, seed, dtype
        self.model_kw = dict(model_kw)
        self.model = self._build()

    def _build(self):
        raise NotImplementedError

    def _step_flops(self, hw) -> int:
        raise NotImplementedError

    def _program(self, batch: int):
        """(module, example inputs at `batch`, meta) of the step that
        `pt2` and `graph` export."""
        raise NotImplementedError

    def _frames(self, batch: int) -> torch.Tensor:
        """Zero uint8 frames [batch, H, W, 3] at imgsz on the device: the
        input the predictors give a step."""
        from mo_yolo_tpu_torch.data.letterbox import to_hw
        return torch.zeros((batch, *to_hw(self.imgsz), 3), dtype=torch.uint8,
                           device=self.device)

    def _fresh_for_tune(self, seed: int = 0):
        """A freshly initialized copy of this model for one trial."""
        return type(self)(self.cfg, nc=self.nc, imgsz=self.imgsz,
                          dtype=self.dtype, seed=seed, device=self.device,
                          names=self.names, **self.model_kw)

    def info(self, detailed: bool = False, verbose: bool = True,
             flops: bool = False, profile: bool = False) -> Dict[str, Any]:
        """Model summary: modules holding parameters, the parameter count,
        with `detailed` a row a tensor, with `flops` the GFLOPs of one step
        (`_step_flops`: matrix products and convolutions, counted by
        `torch.utils.flop_counter`), with `profile` time and GFLOPs a node
        of the backbone and neck."""
        from mo_yolo_tpu_torch.data.letterbox import to_hw
        named = list(self.model.named_parameters())
        out: Dict[str, Any] = {
            "layers": len({n.rsplit(".", 1)[0] for n, _ in named}),
            "params": int(sum(p.numel() for _, p in named))}
        if detailed and verbose:
            LOGGER.info(f"{'name':>60} {'parameters':>12} {'shape':>20}")
            for n, p in named:
                LOGGER.info(f"{n:>60} {p.numel():>12} "
                            f"{str(list(p.shape)):>20}")
        hw = to_hw(self.imgsz)
        if flops:
            out["gflops"] = self._step_flops(hw) / 1e9
        if profile:
            from mo_yolo_tpu_torch.utils.profiling import profile_layers
            rows = profile_layers(self.model.model, torch.zeros(
                (1, *hw, 3), dtype=torch.uint8, device=self.device))
            out["layers_profile"] = rows
            if verbose:
                LOGGER.info(f"{'node':>5} {'module':>20} {'ms':>8} "
                            f"{'GFLOPs':>8}")
                for r in rows:
                    LOGGER.info(f"{r['index']:>5} {r['module']:>20} "
                                f"{r['ms']:>8.2f} {r['gflops']:>8.2f}")
        if verbose:
            fs = (f", {out['gflops']:.1f} GFLOPs/{self._flops_per}"
                  if "gflops" in out else "")
            name = Path(self.cfg).stem if isinstance(self.cfg, (str, Path)) \
                else "model"
            LOGGER.info(f"{name} summary: {out['layers']} param modules, "
                        f"{out['params']:,} parameters{fs}")
        return out

    def save(self, path: str, state_dict=None) -> str:
        """The weights at `path` (a `torch.save` of the state dict, or of
        `state_dict` where given) and, at `<path>.meta.json`, all that
        rebuilds this model: the task, the config, imgsz, names, nc,
        dtype, seed and the scalar `model_kw` (and a tracker's config)."""
        from mo_yolo_tpu_torch.utils.checkpoint import _save
        cfg = self.cfg
        if isinstance(cfg, (str, Path)) and Path(cfg).is_file():
            cfg = str(Path(cfg).resolve())
        kw = {k: v for k, v in self.model_kw.items()
              if isinstance(v, (int, float, str, bool)) or (
                  isinstance(v, (tuple, list)) and
                  all(isinstance(e, (int, float)) for e in v))}
        meta = {"task": self.task, "cfg": cfg, "imgsz": self.imgsz,
                "names": {str(k): v for k, v in self.names.items()},
                "model_kw": kw, "nc": self.nc, "dtype": self.dtype,
                "seed": self.seed}
        if hasattr(self.model, "tracker"):
            meta["tracker"] = dataclasses.asdict(self.model.tracker)
        _save(self.model.state_dict() if state_dict is None else state_dict,
              path)
        with open(_meta_path(path), "w") as f:
            json.dump(meta, f, default=str)
        return str(path)

    def load(self, path: str):
        """Rebuild the model saved at `path` (see `save`) on this facade's
        device. A model saved by another task's facade raises."""
        from mo_yolo_tpu_torch.utils.checkpoint import load_params
        with open(_meta_path(path)) as f:
            meta = json.load(f)
        task = meta.get("task", "track")
        if task != self.task:
            raise ValueError(f"{path!r} holds a {task!r} model; load it "
                             f"with that task's facade, not {self.task!r}'s")
        self.cfg = meta["cfg"]
        self.imgsz = meta.get("imgsz", 640)
        if isinstance(self.imgsz, list):
            self.imgsz = tuple(self.imgsz)
        self.names = {int(k): v for k, v in (meta.get("names") or {}).items()}
        self.nc = meta.get("nc")
        self.dtype = meta.get("dtype", "float32")
        self.seed = meta.get("seed", 0)
        # JSON gives lists where tuples were saved (kpt_shape)
        self.model_kw = {k: tuple(v) if isinstance(v, list) else v
                         for k, v in (meta.get("model_kw") or {}).items()}
        if meta.get("tracker"):
            self.model_kw["tracker"] = TrackerConfig(**meta["tracker"])
        self.model = self._build()
        load_params(path, target=self.model)
        return self

    def load_torch(self, pt_path: str, strict: bool = False):
        """Load an upstream `.pt` checkpoint's weights (the port's keys are
        upstream's; see `utils/checkpoint.import_torch_weights`)."""
        from mo_yolo_tpu_torch.utils.checkpoint import import_torch_weights
        import_torch_weights(pt_path, self.model, strict=strict)
        return self

    def _export_impl(self, fmt: str = "params", path: str = "model_export",
                     half: bool = False, int8: bool = False,
                     dynamic: bool = False, keras: bool = False,
                     opset: Optional[int] = None, simplify: bool = False,
                     nms: bool = False, workspace: int = 4,
                     optimize: bool = False) -> str:
        """Export the model. `params`: `save(path)`; `pt`: an
        upstream-format checkpoint (`utils/torch_export`); `pt2`: the step
        (`stream_step`, or `predict_step`) exported with `torch.export` at
        `<path>.pt2` with a `.meta.json` (`utils/program_export`), its
        batch a dimension of the program with `dynamic`; `graph`: that
        program printed at `<path>.graph.txt`. `half` writes bf16 weights
        into the artifact only; the live model keeps its own. `simplify`,
        `nms` and `optimize` are warned about and ignored, as in the JAX
        package, and so are `int8`, `keras`, `opset` and `workspace`,
        which only TensorFlow formats read, and `dynamic` outside `pt2`
        and `graph`."""
        for flag, why in ((simplify, "simplify (onnxsim)"),
                          (nms, "nms (CoreML-only)"),
                          (optimize, "optimize (torchscript-mobile-only)"),
                          (int8 or keras or opset,
                           "int8, keras and opset (TensorFlow formats "
                           "only)"),
                          (dynamic and fmt not in ("pt2", "graph"),
                           "dynamic (pt2 and graph only)")):
            if flag:
                LOGGER.warning(f"export arg {why} has no effect in the "
                               "port; ignored")
        if fmt in JAX_FORMATS:
            raise ValueError(
                f"export format {fmt!r} is the JAX package's: "
                f"{JAX_FORMATS[fmt]}. The port writes {EXPORT_FORMATS}")
        if fmt not in EXPORT_FORMATS:
            raise ValueError(f"unsupported export format {fmt!r} "
                             f"(supported: {EXPORT_FORMATS})")
        if fmt in ("pt2", "graph"):
            from mo_yolo_tpu_torch.utils import program_export
            # a dynamic batch is traced at 2: a batch of 1 would be
            # specialised
            module, inputs, meta = self._program(2 if dynamic else 1)
            if fmt == "graph":
                return program_export.export_graph_text(
                    module, inputs, path, dynamic=dynamic, half=half)
            meta.update(task=self.task, imgsz=self.imgsz)
            return program_export.export_program(
                module, inputs, path, dynamic=dynamic, half=half, meta=meta)
        if fmt == "pt":
            from mo_yolo_tpu_torch.utils.torch_export import \
                export_reference_pt
            return export_reference_pt(
                self.model, path,
                train_args={"model": self.cfg if isinstance(self.cfg, str)
                            else "dict", "task": self.task,
                            "imgsz": self.imgsz, "names": self.names},
                half=half)
        sd = self.model.state_dict()
        if half:
            sd = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                  for k, v in sd.items()}
        return self.save(path, state_dict=sd)


class MOTRTrack(_ModelFacade):
    """End-to-end multi-object tracker (DecoderTracker) on the card.

    `model` is a bundled config name ("yolo_track"), a config dict, a yaml
    path, or the path of a model saved with `save` (its weights and
    `.meta.json`; then the other arguments but `device` come from the
    file). Weights are random, made from `seed`. `model_kw` (`nq`, `hd`,
    `ndl`, `d_ffn`, `num_denoising`, `tracker`) override the model's
    defaults. `names` maps class ids to names (a dataset's, once `val`
    or `train` read one). `device=None` means the card and raises without
    one."""

    task = "track"

    def _build(self):
        return build_tracking_model(self.cfg, nc=self.nc, dtype=self.dtype,
                                    device=self.device, seed=self.seed,
                                    **self.model_kw)

    # ------------------------------------------------------------------ #
    def predict(self, source, conf: float = 0.5, stream: bool = True,
                save_mot: Optional[str] = None, classes=None,
                vid_stride: int = 1, save: bool = False,
                save_crop: bool = False,
                save_dir: str = "runs/track/predict", line_width: int = 2,
                show_labels: bool = True, show_conf: bool = True,
                rect: bool = False, visualize: bool = False,
                boxes: bool = True, show: bool = False, workers: int = 2,
                save_format: str = "jpg"
                ) -> Union[Iterator[TrackResults], List[TrackResults]]:
        """Streaming tracking over image files (a folder, a glob, a `.txt`
        list, a list of paths), a video file (every `vid_stride`-th frame),
        a URL stream, a webcam, `screen`, a `.npy` stack, PIL images or
        uint8 HWC frames. Returns a generator of TrackResults, one a frame
        (a list with `stream=False`). `save_mot` writes MOT-challenge txt;
        `classes` keeps those ids; `save` and `save_crop` write annotated
        frames (`save_format` jpg or png) and crops under `save_dir`;
        `show` shows frames where there is a display; `visualize` writes
        feature-map grids; `rect=True` sizes the input to the first
        image's aspect (file sources only); `workers` threads decode image
        files ahead."""
        imgsz = self.imgsz
        if rect:
            try:
                from mo_yolo_tpu_torch.data.loaders import list_images
                files = (list_images(source)
                         if isinstance(source, (str, Path))
                         else [str(p) for p in source])
                imgsz = _rect_from_first(files, self.imgsz)
            except (OSError, TypeError, ValueError, IndexError):
                LOGGER.warning("rect=True needs a file source to read the "
                               "first image of; using the configured imgsz")
        pred = TrackPredictor(self.model, imgsz=imgsz, conf=conf,
                              classes=classes, device=self.device,
                              names=self.names, vid_stride=vid_stride,
                              visualize=visualize, workers=workers,
                              callbacks=self.callbacks)
        gen = pred.stream(source, save_mot=save_mot, save=save,
                          save_crop=save_crop, save_dir=save_dir,
                          line_width=line_width, show_labels=show_labels,
                          show_conf=show_conf, boxes=boxes, show=show,
                          save_format=save_format)
        return gen if stream else list(gen)

    __call__ = predict

    def val(self, data: Union[str, List[str]], conf: float = 0.5,
            max_gt: int = 64, split: str = "val",
            rect: bool = False) -> Dict[str, float]:
        """HOTA/DetA/AssA/LocA/OWTA, MOTA/IDSW, IDF1/IDP/IDR, mAP50,
        mAP50-95, precision, recall and fps on a dataset yaml (or a bundled
        dataset name) or an image list. `split` picks the yaml's split;
        `rect=True` takes a minimum-rectangle input shape from the first
        image."""
        from mo_yolo_tpu_torch.engine.validator import TrackValidator
        if isinstance(data, str):
            from mo_yolo_tpu_torch.data.dataset import load_dataset_yaml
            d = load_dataset_yaml(data)
            files = _split_files(d, split, data)
            self.names = self.names or dict(d.get("names") or {})
        else:
            files = list(data)
        imgsz = _rect_from_first(files, self.imgsz) if rect else self.imgsz
        return TrackValidator(self.model, imgsz=imgsz, conf=conf,
                              callbacks=self.callbacks)(files, max_gt=max_gt)

    def train(self, data: str, epochs: int = 1, batch: int = 1,
              clip_len: int = 5, lr: float = 1e-4, max_gt: int = 64,
              save_dir: str = "runs/track", seed: int = 0,
              val_every: int = -1, log_every: int = 10,
              resume: bool = False, accumulate: int = 1,
              augment: bool = False, **kw) -> Dict[str, float]:
        """Train on a dataset yaml (`train/trainer.TrackTrainer`, which also
        takes `kw`). `batch=-1` picks the stream count that fits the card
        (`utils/autobatch`); `resume=True` continues from
        `save_dir/last_full`; `accumulate` > 1 accumulates gradients.
        Returns the validator's metrics of the best checkpoint and
        `final_loss` (with a val split), else `{"final_loss": ...}`;
        `self.model` then holds the best checkpoint's EMA weights. Under
        torchrun (`torchrun --nproc_per_node N -m mo_yolo_tpu_torch track
        train ...`) each process is one rank of a data-parallel run over
        the global `batch` (`train/trainer.py`)."""
        from mo_yolo_tpu_torch.train.trainer import TrackTrainer
        trainer = TrackTrainer(self, data=data, epochs=epochs, batch=batch,
                               clip_len=clip_len, lr=lr, max_gt=max_gt,
                               save_dir=save_dir, seed=seed,
                               val_every=val_every, log_every=log_every,
                               resume=resume, accumulate=accumulate,
                               augment=augment, **kw)
        trainer.callbacks = _merged_bus(trainer.callbacks, self.callbacks)
        return trainer.run()

    # keys TrackTrainer takes as arguments; every other sampled key goes
    # into its `hyp` dict (augmentation)
    _TUNE_TOP = ("lr", "lrf", "momentum", "warmup_epochs", "warmup_momentum")
    _tune_resume = True           # TrackTrainer continues rungs by resume
    _tune_save_dir = "runs/track/tune"
    _tune_train_augment = True

    def _tune_space(self, space):
        if space is not None:
            return dict(space)
        from mo_yolo_tpu_torch.utils.tuner import DEFAULT_SPACE
        # the multi-image augmentations the track trainer does not use
        return {k: v for k, v in DEFAULT_SPACE.items()
                if k not in ("mosaic", "mixup", "copy_paste")}

    def _step_flops(self, hw) -> int:
        from mo_yolo_tpu_torch.utils.profiling import stream_step_flops
        return stream_step_flops(self.model, hw)

    def _program(self, batch: int):
        from mo_yolo_tpu_torch.models.tracking_model import StreamStep
        return (StreamStep(self.model),
                (tuple(self.model.init_state(batch)), self._frames(batch)),
                {"n_slots": self.model.tracker.n_slots, "hd": self.model.hd})


class Detector(_ModelFacade):
    """RT-DETR-style detection on the card (the port's copy of `Detector`
    in `mo_yolo_tpu/api.py`): `DetectionModel`, set prediction, no NMS.

    The arguments are `MOTRTrack`'s; `model_kw` takes `nq`, `hd`, `ndl`
    and `d_ffn`. `predict` stretches each frame to `imgsz` on the host
    (no letterbox padding, as the JAX facade) and yields a TrackResults
    a frame with track id -1; `track` adds a classic tracker on the host
    (BYTETracker, BOT-SORT)."""

    task = "detect"
    _flops_per = "image"
    _TUNE_TOP = ("lr",)        # DetectTrainer reads the rest from its hyp
    _tune_save_dir = "runs/detect/tune"   # no resume: rungs train afresh
    _tune_train_augment = True

    def _build(self):
        from mo_yolo_tpu_torch.models.detect import build_detection_model
        return build_detection_model(self.cfg, nc=self.nc, dtype=self.dtype,
                                     device=self.device, seed=self.seed,
                                     **self.model_kw)

    def predict(self, source, conf: float = 0.5, augment: bool = False
                ) -> Iterator[TrackResults]:
        """Detections a frame over image files (decoded on two threads
        ahead), a `.npy` stack or uint8 HWC frames: the boxes scoring
        `conf` or more, in original pixels.
        `augment` (test-time augmentation) is a YOLOv8-head feature: it is
        warned about and the plain forward runs, as in the JAX facade."""
        import numpy as np

        from mo_yolo_tpu_torch.data.letterbox import (boxes_to_original,
                                                      letterbox, to_hw)
        from mo_yolo_tpu_torch.engine.predictor import _frames
        if augment:
            LOGGER.warning("augment=True (TTA) is not defined for the "
                           "RT-DETR head; running the plain forward")
        ih, iw = to_hw(self.imgsz)
        self.callbacks.fire("on_predict_start", predictor=self, model=self)
        try:
            for n, (path, img) in enumerate(_frames(source, workers=2)):
                x, gain, pad = letterbox(img, (ih, iw), scale_fill=True)
                boxes, scores, cls = (t[0].cpu().numpy() for t in
                                      self.model.predict_step(
                                          torch.from_numpy(x[None]).to(
                                              self.device)))
                keep = scores >= conf
                b = boxes[keep]
                xyxy = np.stack([(b[:, 0] - b[:, 2] / 2) * iw,
                                 (b[:, 1] - b[:, 3] / 2) * ih,
                                 (b[:, 0] + b[:, 2] / 2) * iw,
                                 (b[:, 1] + b[:, 3] / 2) * ih], 1)
                meta = {"orig_shape": img.shape[:2], "gain": gain,
                        "pad": pad, "scale_fill": True}
                yield TrackResults(
                    boxes_xyxy=boxes_to_original(xyxy, meta),
                    conf=scores[keep], cls=cls[keep].astype(int),
                    track_id=np.full(int(keep.sum()), -1),
                    orig_shape=img.shape[:2], path=path, names=self.names,
                    orig_img=img)
                self.callbacks.fire("on_predict_batch_end", predictor=self,
                                    model=self, step=n)
        finally:
            self.callbacks.fire("on_predict_end", predictor=self, model=self)

    __call__ = predict

    def track(self, source, conf: float = 0.1, tracker: str = "bytetrack"
              ) -> Iterator[TrackResults]:
        """Detection plus a classic box tracker on the host (the JAX
        `Detector.track`): `predict` on the card (K1 in the decoder), then
        `BYTETracker` or `BOT-SORT` (camera-motion compensation by GMC, in
        numpy) on each frame's boxes. `tracker` is "bytetrack", "botsort"
        (with or without `.yaml`) or a tracker yaml (`cfg/trackers.py`).
        `conf` defaults to the low-confidence threshold, 0.1, as upstream
        forces it when tracking, so that BYTE's second association sees
        the band [0.1, 0.5). Yields a TrackResults a frame with the
        confirmed tracks' ids."""
        import numpy as np

        from mo_yolo_tpu_torch.cfg.trackers import tracker_config
        from mo_yolo_tpu_torch.trackers import BOTSORT, BYTETracker
        kind, cfg = tracker_config(tracker)
        bt = BOTSORT(cfg) if kind == "botsort" else BYTETracker(cfg)
        for r in self.predict(source, conf=conf):
            dets = np.concatenate([r.boxes_xyxy, r.conf[:, None],
                                   r.cls[:, None].astype(float)], 1) \
                if len(r) else np.zeros((0, 6))
            out = bt.update(dets, r.orig_img if kind == "botsort" else None)
            yield TrackResults(
                boxes_xyxy=out[:, :4], conf=out[:, 5],
                cls=out[:, 6].astype(int), track_id=out[:, 4].astype(int),
                orig_shape=r.orig_shape, path=r.path, names=self.names,
                orig_img=r.orig_img)

    def train(self, data: str, epochs: int = 1, batch: int = 8,
              lr: float = 1e-4, max_gt: int = 64,
              save_dir: str = "runs/detect", seed: int = 0,
              log_every: int = 10, augment: bool = False,
              **kw) -> Dict[str, float]:
        """Train on a dataset yaml (5- or 6-column labels; track ids are
        ignored) through `train/detect_trainer.DetectTrainer`, which also
        takes `kw` (`hyp`, `close_mosaic`, `val_every`, ...)."""
        from mo_yolo_tpu_torch.train.detect_trainer import DetectTrainer
        t = DetectTrainer(self, data=data, epochs=epochs, batch=batch, lr=lr,
                          max_gt=max_gt, save_dir=save_dir, seed=seed,
                          log_every=log_every, augment=augment, **kw)
        t.callbacks = _merged_bus(t.callbacks, self.callbacks)
        return t.run()

    def val(self, data: Union[str, List[str]], conf: float = 0.001,
            max_gt: int = 64, save_json: bool = False,
            save_dir: str = "runs/detect/val", split: str = "val",
            rect: bool = False, save_hybrid: bool = False
            ) -> Dict[str, float]:
        """mAP50, mAP50-95, precision, recall and fps on a dataset yaml (its
        `split`) or an image list; `save_json` writes COCO records,
        `save_hybrid` label files of GT and predictions, under `save_dir`;
        `rect=True` takes a minimum-rectangle input shape from the first
        image."""
        from mo_yolo_tpu_torch.engine.validator import DetectionValidator
        if isinstance(data, str):
            from mo_yolo_tpu_torch.data.dataset import load_dataset_yaml
            d = load_dataset_yaml(data)
            files = _split_files(d, split, data)
            self.names = self.names or dict(d.get("names") or {})
        else:
            files = list(data)
        imgsz = _rect_from_first(files, self.imgsz) if rect else self.imgsz
        return DetectionValidator(self.model, imgsz=imgsz, conf=conf,
                                  save_json=save_json, save_dir=save_dir,
                                  save_hybrid=save_hybrid,
                                  callbacks=self.callbacks)(files,
                                                            max_gt=max_gt)

    def _step_flops(self, hw) -> int:
        from mo_yolo_tpu_torch.utils.profiling import count_flops
        x = torch.zeros((1, *hw, 3), dtype=torch.uint8, device=self.device)
        return count_flops(self.model.predict_step, x)

    def _program(self, batch: int):
        from mo_yolo_tpu_torch.models.detect import PredictStep
        return (PredictStep(self.model), (self._frames(batch),),
                {"hd": self.model.hd, "nq": self.model.nq})


class RTDETR(Detector):
    """The RT-DETR family under its published name: `Detector` with the
    HGNetV2 + hybrid-encoder graph `detr_track` by default."""

    def __init__(self, model: Union[str, Dict[str, Any]] = "detr_track",
                 **kw):
        super().__init__(model, **kw)


class _TaskModel(_ModelFacade):
    """The segment, pose and classify facade on the card (the port's copy
    of `_TaskModel` in `mo_yolo_tpu/api.py`): `task` names the model
    (`models/heads_extra.py`), built from `model` (a config or a saved
    model) with seeded random weights at `imgsz` (square), f32 as the JAX
    facade runs it. `conf`, `iou`, `max_det` and `agnostic_nms` reach the
    on-device NMS, `retina_masks` picks the mask composition, `kpt_shape`
    the pose head's keypoints, `dropout` the classifier's.

    `predict` yields fixed-slot outputs a frame (or TrackResults),
    `val` scores box and mask or keypoint mAP (classify: top-1 and top-5
    accuracy on a class-subdir tree), `train` runs the task's trainer
    (`train/task_trainers.py`), `tune` searches its loss gains, `export`
    writes `params`, `pt`, `pt2` and `graph` (`predict_step`, or the
    classifier's forward) or `torchscript`."""

    _flops_per = "image"
    _TUNE_TOP = ("lr",)          # the trainers read the rest from hyp

    def __init__(self, task: str, model: Union[str, Dict[str, Any]] =
                 "yolo_track", nc: Optional[int] = None, imgsz: int = 256,
                 seed: int = 0, kpt_shape=(17, 3), agnostic_nms: bool = False,
                 dropout: float = 0.0, conf: float = 0.001, iou: float = 0.7,
                 max_det: int = 100, retina_masks: bool = False,
                 dtype: str = "float32", device=None,
                 names: Optional[Dict[int, str]] = None):
        if task not in TASK_MODELS:
            raise ValueError(f"task {task!r} is not one of "
                             f"{', '.join(TASK_MODELS)}")
        self.task = task
        self._tune_save_dir = f"runs/{task}/tune"
        nms = dict(max_det=max_det, conf=conf, iou=iou, agnostic=agnostic_nms)
        kw = {"segment": dict(nms, retina_masks=retina_masks),
              "pose": dict(nms, kpt_shape=tuple(kpt_shape)),
              "classify": dict(dropout=dropout)}[task]
        super().__init__(model, nc=nc, imgsz=imgsz, dtype=dtype, seed=seed,
                         device=device, names=names, **kw)

    def _build(self):
        from mo_yolo_tpu_torch.models.heads_extra import build_task_model
        return build_task_model(self.task, self.cfg, nc=self.nc,
                                dtype=self.dtype, device=self.device,
                                seed=self.seed, **self.model_kw)

    def _fresh_for_tune(self, seed: int = 0) -> "_TaskModel":
        kw = dict(self.model_kw)
        if "agnostic" in kw:
            kw["agnostic_nms"] = kw.pop("agnostic")
        return _TaskModel(self.task, self.cfg, nc=self.nc, imgsz=self.imgsz,
                          dtype=self.dtype, seed=seed, device=self.device,
                          names=self.names, **kw)

    def _step_flops(self, hw) -> int:
        from mo_yolo_tpu_torch.utils.profiling import count_flops
        x = torch.zeros((1, *hw, 3), dtype=torch.uint8, device=self.device)
        return count_flops(getattr(self.model, "predict_step", self.model), x)

    def _program(self, batch: int):
        from mo_yolo_tpu_torch.models.detect import PredictStep
        module = self.model if self.task == "classify" \
            else PredictStep(self.model)
        return module, (self._frames(batch),), {}

    def _tune_space(self, space):
        """Only the keys the task trainers read: lr and the loss gains
        (pose: also pose and kobj; classify: lr and label smoothing)."""
        if space is not None:
            return dict(space)
        if self.task == "classify":
            return {"lr": (1e-5, 1e-1, "log"), "label_smoothing": (0.0, 0.1)}
        sp = {"lr": (1e-5, 1e-1, "log"), "box": (2.0, 20.0),
              "cls": (0.2, 4.0), "dfl": (0.5, 3.0)}
        if self.task == "pose":
            sp.update(pose=(2.0, 30.0), kobj=(0.5, 2.0))
        return sp

    def _export_impl(self, fmt: str = "params", path: Optional[str] = None,
                     half: bool = False, optimize: bool = False, **kw) -> str:
        """`params` and `pt` as the other facades; `torchscript` traces the
        model's forward without NMS (`utils/torch_export.export_torchscript`,
        `optimize` for the mobile interpreter)."""
        path = path or f"{self.task}_export"
        if fmt == "torchscript":
            from mo_yolo_tpu_torch.utils.torch_export import \
                export_torchscript
            return export_torchscript(self.model, path, self.imgsz,
                                      task=self.task, names=self.names,
                                      half=half, optimize=optimize)
        return super()._export_impl(fmt, path, half=half, optimize=optimize,
                                    **kw)

    @property
    def trainer_cls(self):
        """The task's trainer class (`train/task_trainers.py`)."""
        from mo_yolo_tpu_torch.train import task_trainers as tt
        return {"segment": tt.SegTrainer, "pose": tt.PoseTrainer,
                "classify": tt.ClassifyTrainer}[self.task]

    def train(self, data: str, **kw) -> Dict[str, float]:
        """Train on a dataset yaml of polygon (segment) or keypoint (pose)
        labels, or a class-subdir tree (classify), through the task's
        trainer, which takes `kw` (`epochs`, `batch`, `lr`, `max_gt`,
        `hyp`, `mask_ratio`, `overlap_mask`, ...). `self.model` then holds
        the best checkpoint's EMA weights."""
        t = self.trainer_cls(self, data, **kw)
        t.callbacks = _merged_bus(t.callbacks, self.callbacks)
        return t.run()

    def val(self, data) -> Dict[str, float]:
        """Segment: box and mask mAP; pose: box and OKS mAP (each on a
        dataset yaml's val split or an image list); classify: top-1 and
        top-5 accuracy on a class-subdir tree."""
        from mo_yolo_tpu_torch.engine import validator as v
        if self.task == "classify":
            return v.classify_accuracy(self.model, data, self.imgsz,
                                       callbacks=self.callbacks)
        if isinstance(data, str):
            from mo_yolo_tpu_torch.data.dataset import load_dataset_yaml
            d = load_dataset_yaml(data)
            files = _split_files(d, "val", data)
            self.names = self.names or dict(d.get("names") or {})
        else:
            files = list(data)
        cls = v.SegmentationValidator if self.task == "segment" \
            else v.PoseValidator
        return cls(self.model, imgsz=self.imgsz,
                   callbacks=self.callbacks)(files)

    def predict(self, source, masks: bool = False, as_results: bool = False):
        """(path, outputs) a frame over image files (decoded on two threads
        ahead), a `.npy` stack or uint8 HWC frames, each stretched
        to `imgsz`. Outputs are the fixed-slot arrays of `predict_step`
        (one copy back a frame): segment (boxes, scores, cls, coef,
        protos), with `masks=True` (boxes, scores, cls, masks [1,S,H,W] at
        input resolution, `retina_masks` picking the composition); pose
        (boxes, scores, cls, keypoints); classify logits [1, nc]. With
        `as_results=True` each is a TrackResults in original pixels with
        its `masks`, `keypoints` or `probs`."""
        from mo_yolo_tpu_torch.data.letterbox import letterbox
        from mo_yolo_tpu_torch.engine.predictor import _frames
        from mo_yolo_tpu_torch.engine.validator import _to_host
        m, s = self.model, int(self.imgsz)
        self.callbacks.fire("on_predict_start", predictor=self, model=self)
        try:
            for n, (path, img) in enumerate(_frames(source, workers=2)):
                x = torch.from_numpy(letterbox(img, (s, s), scale_fill=True)[0]
                                     [None]).to(self.device)
                if self.task == "classify":
                    with torch.no_grad():
                        out = _to_host(m(x))[0]
                else:
                    out = m.predict_step(x)
                    if self.task == "segment" and (masks or as_results):
                        out = (*out[:3], m.compose_masks(out[0], out[3],
                                                         out[4]))
                    out = tuple(_to_host(*out))
                yield path, (self._to_results(out, img, path) if as_results
                             else out)
                self.callbacks.fire("on_predict_batch_end", predictor=self,
                                    model=self, step=n)
        finally:
            self.callbacks.fire("on_predict_end", predictor=self, model=self)

    __call__ = predict

    def _to_results(self, out, img, path) -> TrackResults:
        """Fixed-slot outputs -> TrackResults in original pixels: the kept
        slots, boxes and keypoints scaled back per axis."""
        import numpy as np
        oh, ow = img.shape[:2]
        sx, sy = ow / self.imgsz, oh / self.imgsz
        common = dict(orig_shape=(oh, ow), path=str(path), orig_img=img,
                      names=self.names)
        if self.task == "classify":
            logits = np.asarray(out[0], np.float64)
            e = np.exp(logits - logits.max())
            z = np.zeros(0, int)
            return TrackResults(boxes_xyxy=np.zeros((0, 4)), conf=z,
                                cls=z, track_id=z, probs=e / e.sum(),
                                **common)
        bb, ss, cc = out[0][0], out[1][0], out[2][0]
        keep = ss > 0
        extra = {}
        if self.task == "segment":
            extra["masks"] = out[3][0][keep]
        else:
            kp = out[3][0][keep].copy()
            kp[..., 0] *= sx
            kp[..., 1] *= sy
            extra["keypoints"] = kp
        return TrackResults(
            boxes_xyxy=bb[keep] * np.asarray([sx, sy, sx, sy], np.float32),
            conf=ss[keep], cls=cc[keep].astype(int),
            track_id=np.full(int(keep.sum()), -1, int), **extra, **common)


class YOLO:
    """The facade for a task (the JAX `YOLO`): "track" gives `MOTRTrack`,
    "detect" `Detector`, "rtdetr" `RTDETR`, "segment", "pose" and
    "classify" `_TaskModel`."""

    def __new__(cls, model: Union[str, Dict[str, Any]] = "yolo_track",
                task: str = "track", **kw):
        facades = {"track": MOTRTrack, "detect": Detector, "rtdetr": RTDETR}
        if task in facades:
            return facades[task](model, **kw)
        if task in TASK_MODELS:
            return _TaskModel(task, model, **kw)
        raise NotImplementedError(
            f"task {task!r} is not a task of mo_yolo_tpu (available: "
            f"{sorted([*facades, *TASK_MODELS])})")
