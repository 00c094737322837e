"""`yolo`-style command line of the port (the counterpart of
`mo_yolo_tpu/cli.py`): `python -m mo_yolo_tpu_torch <task> <mode> k=v...`

    python -m mo_yolo_tpu_torch track predict model=yolo_track source=imgs/
    python -m mo_yolo_tpu_torch track predict source=imgs/ save=true \\
        save_format=png save_txt=true save_mot=runs/mot.txt
    python -m mo_yolo_tpu_torch track val model=runs/model data=MOT.yaml
    python -m mo_yolo_tpu_torch track train data=MOT.yaml epochs=1 batch=-1
    torchrun --nproc_per_node 4 -m mo_yolo_tpu_torch track train \\
        data=MOT.yaml batch=8          # 4 ranks, one card each, 2 clips a rank
    python -m mo_yolo_tpu_torch track tune data=MOT.yaml epochs=8 max_samples=4
    python -m mo_yolo_tpu_torch track export model=runs/model format=pt
    python -m mo_yolo_tpu_torch track export format=pt2 dynamic=true
    python -m mo_yolo_tpu_torch track benchmark imgsz=640
    python -m mo_yolo_tpu_torch track predict source=imgs/ device=cpu
    python -m mo_yolo_tpu_torch detect predict model=yolo_mot source=imgs/
    python -m mo_yolo_tpu_torch detect track source=imgs/ tracker=botsort
    python -m mo_yolo_tpu_torch detect train model=yolo_mot data=MOT.yaml
    python -m mo_yolo_tpu_torch rtdetr val data=MOT.yaml
    python -m mo_yolo_tpu_torch segment predict source=imgs/ save=true
    python -m mo_yolo_tpu_torch pose train data=pose.yaml epochs=2 batch=4
    python -m mo_yolo_tpu_torch classify val data=classes/ imgsz=224
    python -m mo_yolo_tpu_torch nas predict source=imgs/ augment=true
    python -m mo_yolo_tpu_torch nas val data=det.yaml
    python -m mo_yolo_tpu_torch sam predict model=b imgsz=1024 source=imgs/ \
        weights=sam_vit_b.pt grid=16
    python -m mo_yolo_tpu_torch fastsam predict source=imgs/ texts=red

Tasks: track, detect (RT-DETR-style detection, `yolo_track` by default),
rtdetr (the same on `detr_track`), and segment, pose and classify (the
YOLOv8 task heads on `yolo_track`, f32, at imgsz 256 unless given; predict,
val, train, tune, export), nas (YOLO-NAS, `yolo_nas_s`, f32: predict with
`augment=true` for TTA, val, export), sam (`model=b|l|h|mobile`,
`weights=` a local checkpoint or `file://` URL; predict: the everything
grid of `grid=` points a side, or `texts=`) and fastsam (`yolo_track`;
predict: everything mode, or `texts=`). Modes: predict, track
(for the track task the same as predict: the tracker runs inside the step;
for detect and rtdetr `Detector.track`, a classic tracker on the
detections, `tracker=bytetrack|botsort|<yaml>`), val (`profile=true`
runs the export-format harness after it), train, tune, export (formats
params, pt, pt2, graph; torchscript for the task heads), benchmark (the
export-format harness, `utils/benchmarks.py`, on the track model); bench
(the repository's speed benchmark) exits, naming the benchmark work.
Specials: checks, version, settings [reset], cfg, copy-cfg. Any
default.yaml key is taken as k=v (`cfg=custom.yaml` for a file); keys a
mode does not take are warned about and dropped.
`device=` takes cpu, cuda, cuda:N or a bare card index; without it the
port runs on the card and exits if there is none. `amp=false` runs in
float32.

Differences from the JAX CLI, on purpose:
- `save_txt=true` writes one label file per video frame
  (`<stem>_<frame>.txt`), as upstream writes them; the JAX CLI appends a
  video's frames to one file.
- `predict` without `save_dir` (or `project`/`name`) writes under a fresh
  `runs/track/predict`, `predict2`, ... each run, as upstream does; the
  JAX CLI reuses `runs/track/predict`, so a second run appends its label
  rows to the first's.
- `export` routes its keys (`half`, `dynamic`, `simplify`, ...) to the
  export itself; the JAX CLI drops them. The default format is `params`.
- `benchmark` runs the harness on the model the command line names (the
  JAX CLI builds `yolo_track` at imgsz); its rows are live, params, pt and
  pt2.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Any, Dict

from mo_yolo_tpu_torch.utils.files import increment_path
from mo_yolo_tpu_torch.utils.logging import LOGGER

TASKS = ("track", "detect", "rtdetr", "nas", "sam", "fastsam",
         "segment", "pose", "classify")
MODES = ("train", "val", "predict", "track", "export", "tune", "bench",
         "benchmark")
SPECIAL = ("checks", "version", "settings", "cfg", "copy-cfg")
DEFAULT_MODELS = {"track": "yolo_track", "detect": "yolo_track",
                  "rtdetr": "detr_track", "segment": "yolo_track",
                  "pose": "yolo_track", "classify": "yolo_track",
                  "nas": "yolo_nas_s", "sam": "b", "fastsam": "yolo_track"}
# the modes of the tasks that do not take them all
TASK_MODES = {"nas": ("predict", "val", "export"), "sam": ("predict",),
              "fastsam": ("predict",)}

# keys that go into the trainer's `hyp` dict when they are not arguments
# of the trainer (augmentation, loss gains, optimizer knobs)
HYP_KEYS = {"hsv_h", "hsv_s", "hsv_v", "degrees", "translate", "scale",
            "shear", "perspective", "fliplr", "flipud", "mosaic", "mixup",
            "copy_paste", "box", "cls", "dfl", "pose", "kobj",
            "label_smoothing", "optimizer", "momentum", "cos_lr", "lrf",
            "warmup_momentum", "warmup_bias_lr", "warmup_epochs",
            "close_mosaic"}
ALIASES = {"lr0": "lr"}


def parse_kv(args) -> Dict[str, Any]:
    """`k=v` arguments to a dict: true/false to bools, `[..]`, `(..)` and
    `{..}` through `ast.literal_eval`, numbers to ints or floats, the rest
    kept as strings."""
    out = {}
    for a in args:
        if "=" not in a:
            raise SystemExit(f"expected k=v argument, got {a!r}")
        k, v = a.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        elif v[:1] in "[({":
            import ast
            try:
                out[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                out[k] = v
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def route_kwargs(kv: Dict[str, Any], *sigs, allow_hyp: bool = True
                 ) -> Dict[str, Any]:
    """The keys of `kv` that the callables `sigs` take as arguments (plus,
    with `allow_hyp`, a `hyp` dict of HYP_KEYS). `lr0` is `lr`;
    `project`/`name` compose `save_dir` through `increment_path` (an
    earlier run is never overwritten unless `exist_ok`); every other key
    is warned about and dropped, so that a whole default.yaml copy can
    drive any mode."""
    import inspect
    kv = dict(kv)
    for a, b in ALIASES.items():
        if a in kv and b not in kv:
            kv[b] = kv.pop(a)
    if "project" in kv or "name" in kv:
        base = f"{kv.pop('project', 'runs')}/{kv.pop('name', 'exp')}"
        kv.setdefault("save_dir", str(increment_path(
            base, exist_ok=bool(kv.get("exist_ok", False)))))
        kv.pop("project", None)
        kv.pop("name", None)
    kv.pop("exist_ok", None)
    accepted = set()
    for s in sigs:
        accepted |= set(inspect.signature(s).parameters)
    accepted -= {"self", "data", "source", "kw", "kwargs"}
    out, dropped = {}, []
    hyp = dict(kv.pop("hyp", {}) or {})
    for k, v in kv.items():
        if k in accepted:
            out[k] = v
        elif allow_hyp and k in HYP_KEYS:
            hyp[k] = v
        else:
            dropped.append(k)
    if hyp and allow_hyp:
        out["hyp"] = hyp
    if dropped:
        LOGGER.warning("ignoring config keys not applicable here: "
                       f"{sorted(dropped)}")
    return out


def device_arg(d) -> str:
    """The `device=` value as a torch device string: cpu, cuda, cuda:N, or
    a bare card index N (cuda:N)."""
    d = str(d).lower()
    if d.isdigit():
        return f"cuda:{d}"
    if d in ("cpu", "cuda") or (d.startswith("cuda:") and d[5:].isdigit()):
        return d
    raise SystemExit(f"device={d!r}: expected cpu, cuda, cuda:N or N")


def _checks() -> None:
    """What the port needs on this machine, one line each."""
    import platform

    import torch

    from mo_yolo_tpu_torch import __version__
    from mo_yolo_tpu_torch.utils import cuda_build
    print(f"mo_yolo_tpu_torch {__version__}  python "
          f"{platform.python_version()}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            print(f"card {i}: {torch.cuda.get_device_name(i)}")
    else:
        print("card: none (CUDA is not available; pass device=cpu)")

    def found(fn):
        try:
            return fn()
        except RuntimeError as e:
            return f"MISSING ({e})"
    print(f"nvcc: {found(cuda_build._nvcc)}")
    print(f"host compiler: {found(cuda_build._cc)}")
    print("JPEG: the port's own codec (data/csrc/jpeg.c, built by the host "
          "compiler; no libjpeg)")


def _special(cmd: str, rest) -> int:
    """checks, version, settings [reset], cfg, copy-cfg."""
    from mo_yolo_tpu_torch.cfg.default import default_yaml
    if cmd == "version":
        from mo_yolo_tpu_torch import __version__
        print(__version__)
    elif cmd == "cfg":
        print(default_yaml(), end="")
    elif cmd == "copy-cfg":
        dst = Path.cwd() / "default_copy.yaml"
        dst.write_text(default_yaml())
        LOGGER.info(f"default configuration written to {dst}\nUsage: "
                    f"python -m mo_yolo_tpu_torch cfg={dst.name} "
                    f"<task> <mode> ...")
    elif cmd == "settings":
        from mo_yolo_tpu_torch.utils.settings import (load_settings,
                                                      settings_path)
        s = load_settings()
        if rest and rest[0] == "reset":
            s.reset()
            LOGGER.info("Settings reset successfully")
            s = load_settings()
        print(f"settings: {settings_path()}")
        for k, v in sorted(s.items()):
            print(f"{k}={v}")
    elif cmd == "checks":
        _checks()
    else:
        return 1
    return 0


def _log_metrics(metrics: Dict[str, Any]) -> None:
    LOGGER.info(" ".join(f"{k}={v:.2f}" if isinstance(v, float) else
                         f"{k}={v}" for k, v in metrics.items()))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(__doc__)
        return 0
    c = argv[0].lstrip("-")
    if c in SPECIAL:
        return _special(c, argv[1:])
    task = argv[0] if argv[0] in TASKS else "track"
    rest = argv[1:] if argv[0] in TASKS else argv
    if not rest or rest[0] not in MODES:
        raise SystemExit(f"usage: mo_yolo_tpu_torch [{'|'.join(TASKS)}] "
                         f"<{'|'.join(MODES)}> k=v ...")
    mode, kv = rest[0], parse_kv(rest[1:])
    if mode not in TASK_MODES.get(task, MODES):
        raise SystemExit(f"mode {mode!r} is not a mode of the {task} task "
                         f"(it runs {', '.join(TASK_MODES[task])})")
    if mode == "bench":
        raise SystemExit(
            "mode 'bench' runs the repository's speed benchmark (bench.py), "
            "whose port is benchmark work (a BENCHMARK.json and its "
            "harness), not a part of the port yet; chip_smoke.py times the "
            "paths, and mode 'benchmark' runs the export-format harness")
    if mode == "benchmark" and task != "track":
        raise SystemExit("mode 'benchmark' (the export-format harness) runs "
                         "the track task's model")

    # cfg=<file>: its values are the base, k=v arguments override them;
    # task and mode come from the command line
    cfg_file = kv.pop("cfg", None)
    if cfg_file:
        from mo_yolo_tpu_torch.cfg.default import read_cfg_file
        base = read_cfg_file(cfg_file)
        base.pop("task", None)
        base.pop("mode", None)
        kv = {**{k: v for k, v in base.items() if v is not None}, **kv}

    # the YOLOv8 task heads run through `api._TaskModel`
    from mo_yolo_tpu_torch.models.heads_extra import TASK_MODELS
    model_arg = kv.pop("model", None) or DEFAULT_MODELS[task]
    imgsz = kv.pop("imgsz", 256 if task in TASK_MODELS else 640)
    device = kv.pop("device", None)
    device = None if device in (None, "", "None") else device_arg(device)
    if kv.pop("dnn", False):
        LOGGER.warning("dnn=True (the OpenCV-DNN ONNX backend) has no "
                       "counterpart in the port; ignored")
    # amp: mixed precision on by default (a bf16 network); amp=false runs
    # in float32 unless dtype is given
    if not kv.pop("amp", True) and "dtype" not in kv:
        kv["dtype"] = "float32"

    from mo_yolo_tpu_torch import api
    from mo_yolo_tpu_torch.utils.device import resolve_device
    try:
        resolve_device(device)
    except RuntimeError as e:       # no card and no device=cpu
        raise SystemExit(f"mo_yolo_tpu_torch: {e}") from e
    if task in TASK_MODELS:
        if mode == "track":
            raise SystemExit(f"mode 'track' is not a mode of the {task} "
                             f"task; track with the track, detect or "
                             f"rtdetr task")
        return _task_mode(task, mode, model_arg, imgsz, device, kv)
    if task in ("sam", "fastsam"):
        return _segment_anything(task, model_arg, imgsz, device, kv)
    from mo_yolo_tpu_torch.models.nas import NAS
    cls = {"track": api.MOTRTrack, "detect": api.Detector,
           "rtdetr": api.RTDETR, "nas": NAS}[task]
    m = cls(model_arg, imgsz=imgsz, device=device, dtype=kv.pop(
        "dtype", "float32" if task == "nas" else "bfloat16"))
    if task == "track":
        from mo_yolo_tpu_torch.train.trainer import TrackTrainer as trainer
    else:
        from mo_yolo_tpu_torch.train.detect_trainer import \
            DetectTrainer as trainer
    if mode == "track" and task != "track":
        # a classic tracker on the host over the detections
        source = kv.pop("source")
        conf, tracker = kv.pop("conf", 0.1), kv.pop("tracker", "bytetrack")
        route_kwargs(kv, m.track, allow_hyp=False)     # warns on the rest
        n = 0
        for r in m.track(source, conf=conf, tracker=tracker):
            n += 1
            LOGGER.info(f"{r.path}: {len(r)} tracks")
        LOGGER.info(f"processed {n} frames")
    elif mode == "predict" and task != "track":
        n = 0
        for r in m.predict(kv.pop("source"), conf=kv.pop("conf", 0.25),
                           augment=bool(kv.pop("augment", False))):
            n += 1
            LOGGER.info(f"{r.path}: {len(r)} detections")
        LOGGER.info(f"processed {n} frames")
    elif mode in ("predict", "track"):
        # the tracker runs inside the step: `track` is streaming predict
        from mo_yolo_tpu_torch.engine.predictor import frame_stem
        source = kv.pop("source")
        verbose = kv.pop("verbose", True)
        save_txt = bool(kv.pop("save_txt", False))
        save_conf = bool(kv.pop("save_conf", False))
        kv = route_kwargs(kv, m.predict, allow_hyp=False)
        # a fresh folder each run, as upstream's `get_save_dir`: the label
        # files append, so a second run must not find the first's
        save_dir = kv.pop("save_dir", None) or \
            str(increment_path("runs/track/predict"))
        kv.pop("stream", None)
        n = 0
        for r in m.predict(source, save_dir=save_dir, **kv):
            if save_txt:
                # one file a frame, a video's frames too (upstream's names)
                r.save_txt(str(Path(save_dir) / "labels" /
                               f"{frame_stem(r.path, n)}.txt"),
                           save_conf=save_conf)
            n += 1
            if verbose:
                LOGGER.info(f"{r.path}: {len(r)} tracks ({r.orig_shape})")
        LOGGER.info(f"processed {n} frames")
    elif mode == "val":
        profile = bool(kv.pop("profile", False))
        _log_metrics(m.val(kv.pop("data"),
                           **route_kwargs(kv, m.val, allow_hyp=False)))
        if profile and task == "track":
            # upstream's `profile`: the export formats beside val
            from mo_yolo_tpu_torch.utils.benchmarks import benchmark
            benchmark(m, formats=["live", "params", "pt2"], n_iter=3)
        elif profile:
            LOGGER.warning("val profile=true: the export-format harness "
                           "runs the track model; ignored")
    elif mode == "benchmark":
        from mo_yolo_tpu_torch.utils.benchmarks import benchmark
        benchmark(m, **route_kwargs(kv, benchmark, allow_hyp=False))
    elif mode == "train":
        m.train(kv.pop("data"), **route_kwargs(kv, m.train, trainer.__init__))
    elif mode == "tune":
        out = m.tune(kv.pop("data"),
                     **route_kwargs(kv, m.tune, m.train, trainer.__init__))
        LOGGER.info(f"tune best fitness {out['best_fitness']:.4g} "
                    f"(trial {out['best_trial']}): {out['best_hyp']}")
    elif mode == "export":
        out = m.export(fmt=kv.pop("format", "params"),
                       path=kv.pop("path", "model_export"),
                       **route_kwargs(kv, m._export_impl, allow_hyp=False))
        LOGGER.info(f"exported to {out}")
    return 0


def _task_mode(task: str, mode: str, model_arg, imgsz, device,
               kv: Dict[str, Any]) -> int:
    """segment, pose and classify through `api._TaskModel`: the facade's
    own keys (conf, iou, max_det, kpt_shape, ...) build it, the rest go to
    the mode."""
    import inspect

    from mo_yolo_tpu_torch import api
    from mo_yolo_tpu_torch.train import task_trainers as tt
    init = set(inspect.signature(api._TaskModel.__init__).parameters) - \
        {"self", "task", "model", "imgsz", "device"}
    m = api._TaskModel(task, model_arg, imgsz=imgsz, device=device,
                       **{k: kv.pop(k) for k in list(kv) if k in init})
    trainer = m.trainer_cls
    if mode == "train":
        out = m.train(kv.pop("data"), **route_kwargs(
            kv, trainer.__init__, tt._TaskTrainer.__init__))
        LOGGER.info(f"{task} training done: {out}")
    elif mode == "tune":
        out = m.tune(kv.pop("data"), **route_kwargs(
            kv, m.tune, trainer.__init__, tt._TaskTrainer.__init__))
        LOGGER.info(f"tune best fitness {out['best_fitness']:.4g} "
                    f"(trial {out['best_trial']}): {out['best_hyp']}")
    elif mode == "val":
        _log_metrics(m.val(kv.pop("data")))
    elif mode == "predict":
        source = kv.pop("source")
        save, save_txt = bool(kv.pop("save", False)), \
            bool(kv.pop("save_txt", False))
        save_conf = bool(kv.pop("save_conf", False))
        fmt = str(kv.pop("save_format", "png"))
        save_dir = Path(kv.pop("save_dir", None) or
                        increment_path(f"runs/{task}/predict"))
        route_kwargs(kv, m.predict, allow_hyp=False)   # warns on the rest
        n = 0
        for path, r in m.predict(source, as_results=True):
            if r.probs is not None:
                top = int(r.probs.argmax())
                LOGGER.info(f"{path}: top1 class {top} "
                            f"({float(r.probs[top]):.3f})")
            else:
                LOGGER.info(f"{path}: {len(r)} detections")
            stem = Path(str(path)).stem
            if save:
                r.save(save_dir / f"{stem}.{fmt}")
            if save_txt and r.probs is None:
                r.save_txt(save_dir / "labels" / f"{stem}.txt",
                           save_conf=save_conf)
            n += 1
        LOGGER.info(f"processed {n} frames")
    elif mode == "export":
        out = m.export(fmt=kv.pop("format", "params"),
                       path=kv.pop("path", f"{task}_export"),
                       **route_kwargs(kv, m._export_impl, allow_hyp=False))
        LOGGER.info(f"exported to {out}")
    return 0


def _segment_anything(task: str, model_arg, imgsz, device,
                      kv: Dict[str, Any]) -> int:
    """`sam predict` and `fastsam predict`: everything mode (SAM's point
    grid of `grid` points a side, FastSAM's every mask) or, with `texts`,
    the mask that best matches the text; logs the masks a frame."""
    from mo_yolo_tpu_torch.engine.predictor import _frames
    source = kv.pop("source")
    texts, grid = kv.pop("texts", None), int(kv.pop("grid", 8))
    dtype = {"dtype": kv.pop("dtype")} if "dtype" in kv else {}
    if task == "sam":
        from mo_yolo_tpu_torch.models.sam import SAM
        m = SAM(str(model_arg), img_size=imgsz, device=device, **dtype)
        weights = kv.pop("weights", None)
        if weights:               # a local path or a file:// URL
            m.load_torch(str(weights))
    else:
        from mo_yolo_tpu_torch.models.fastsam import FastSAM
        m = FastSAM(model_arg, imgsz=imgsz, device=device, **dtype,
                    **{k: kv.pop(k) for k in ("conf", "iou", "max_det")
                       if k in kv})
    if kv:
        LOGGER.warning(f"{task} predict: keys {sorted(kv)} have no effect; "
                       "ignored")
    n = 0
    for path, img in _frames(source):
        if texts is not None:
            out = m.text_prompt(img, str(texts), grid=grid) \
                if task == "sam" else m(img, texts=str(texts))
        else:
            out = m.generate(img, grid=grid) if task == "sam" \
                else m.everything(img)
        LOGGER.info(f"{path}: {len(out['masks'])} masks")
        n += 1
    LOGGER.info(f"processed {n} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
