"""Checkpoint save and load (the port's counterpart of `save_checkpoint`,
`load_checkpoint`, `save_params` and `load_params` in
`mo_yolo_tpu/utils/checkpoint.py`).

A file is a `torch.save` of nested dicts of plain tensors and numbers, no
pickled code, and loads with `torch.load(..., weights_only=True)`.

- `save_checkpoint(path, ts, config)`: everything a `TrainState` holds, so
  that a resumed run continues the same sequence: the parameters, the
  module's buffers (BatchNorm statistics), the EMA, the optimizer's state
  per parameter (moments, SGD trace, the gradient accumulated so far in an
  accumulation cycle, `acc`), its update count `count` (the schedule's
  step) and its place in the cycle `mini_step` (plain attributes that
  `torch.optim.Optimizer.state_dict()` would drop), and the step. `config`
  goes beside it as `<path>.config.json`. In a data-parallel run rank 0
  writes it and every rank loads the same file (`train/trainer.py`), each
  onto its own model's device, so the ranks resume in one state.
- `save_params(path, module)`: inference weights only, the module's
  `state_dict` (upstream keys).
- `import_torch_weights(pt_path, module)`: an upstream-format `.pt`
  checkpoint dict (tensors under `state_dict` or `model`) into the
  module. The port's keys are upstream's, so this is a checked
  `load_state_dict`: tensors of other shapes or names are reported, as
  the JAX function reports its unmapped keys with `strict=False`.
- `export_torch_state_dict(module)`: the module's weights in upstream's
  layout, f32, as the JAX `export_torch_state_dict` renders its variables
  (no BatchNorm `num_batches_tracked`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
from torch import nn


def _save(obj, path) -> Path:
    path = Path(path).resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    tmp.replace(path)
    return path


def save_checkpoint(path: str, train_state, config: Optional[Dict] = None):
    """The whole training state of `train_state` (a
    `train.train_step.TrainState`) at `path`, `config` as json beside it."""
    model, opt = train_state.model, train_state.optimizer
    names = {id(p): n for n, p in model.named_parameters()}
    state = {
        "params": {n: p.detach() for n, p in model.named_parameters()},
        "buffers": {n: b for n, b in model.named_buffers()},
        "ema": dict(train_state.ema),
        "opt_state": {
            "count": opt.count, "mini_step": opt.mini_step,
            "per_param": {names[id(p)]: dict(opt.state[p])
                          for g in opt.param_groups for p in g["params"]
                          if opt.state.get(p)}},
        "step": train_state.step,
    }
    path = _save(state, path)
    if config is not None:
        with open(str(path) + ".config.json", "w") as f:
            json.dump(config, f, indent=2, default=str)


def load_checkpoint(path: str, target):
    """Restore the state saved at `path` into `target` (a `TrainState` of
    the same model and optimizer) in place, and return it."""
    model, opt = target.model, target.optimizer
    dev = next(model.parameters()).device
    state = torch.load(Path(path).resolve(), map_location=dev,
                       weights_only=True)
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    if state["params"].keys() != params.keys() or \
            state["buffers"].keys() != buffers.keys():
        raise ValueError(f"{path}: the checkpoint's tensors are not this "
                         f"model's")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(state["params"][n])
        for n, b in buffers.items():
            b.copy_(state["buffers"][n])
        for n, e in target.ema.items():
            e.copy_(state["ema"][n])
    opt_state = state["opt_state"]
    opt.state.clear()
    for n, st in opt_state["per_param"].items():
        opt.state[params[n]] = dict(st)
    opt.count = int(opt_state["count"])
    opt.mini_step = int(opt_state["mini_step"])
    target.step = int(state["step"])
    return target


def save_params(path: str, module: nn.Module):
    """Inference weights only: `module.state_dict()` at `path`."""
    _save(module.state_dict(), path)


def load_params(path: str, target: Optional[nn.Module] = None
                ) -> Any:
    """The state dict saved at `path`; loaded into `target` (strict, cast
    to its dtypes) and `target` returned when one is given."""
    state = torch.load(Path(path).resolve(), map_location="cpu",
                       weights_only=True)
    if target is None:
        return state
    target.load_state_dict(state)
    return target


def export_torch_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's `state_dict` as upstream reads it: f32 CPU copies,
    without the BatchNorm `num_batches_tracked` counters."""
    return {k: v.detach().to("cpu", torch.float32).clone()
            for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _checkpoint_state_dict(pt_path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a checkpoint dict: its `state_dict`, else its `model`
    dict, else the file itself as a dict. Loaded with `weights_only=True`:
    a checkpoint that pickles a module raises (unpickling can run code)."""
    ckpt = torch.load(Path(pt_path).resolve(), map_location="cpu",
                      weights_only=True)
    if isinstance(ckpt, dict) and ckpt.get("state_dict") is not None:
        sd = ckpt["state_dict"]
    elif isinstance(ckpt, dict) and ckpt.get("model") is not None:
        sd = ckpt["model"]
    else:
        sd = ckpt
    if not isinstance(sd, dict):
        raise ValueError(f"{pt_path}: no state_dict in the checkpoint")
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def import_torch_weights(pt_path: str, module: nn.Module,
                         strict: bool = False) -> Dict[str, List[str]]:
    """Load an upstream `.pt` checkpoint's tensors into `module` (cast to
    its dtypes): each key the module has with the same shape is loaded;
    the rest keep their values and are reported (`missing`: the module's
    keys the file lacks, `unexpected`: the file's keys the module lacks or
    holds in another shape). `strict=True` raises on either. Returns the
    report; logs a summary."""
    from mo_yolo_tpu_torch.utils.logging import LOGGER
    sd = _checkpoint_state_dict(pt_path)
    own = module.state_dict()
    take = {k: v for k, v in sd.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    report = {
        "loaded": sorted(take),
        "missing": sorted(k for k in own if k not in take and
                          not k.endswith("num_batches_tracked")),
        "unexpected": sorted(k for k in sd if k not in take)}
    if strict and (report["missing"] or report["unexpected"]):
        raise KeyError(f"{pt_path}: {len(report['missing'])} missing keys "
                       f"{report['missing'][:8]}, "
                       f"{len(report['unexpected'])} unexpected "
                       f"{report['unexpected'][:8]}")
    with torch.no_grad():
        for k, v in take.items():
            own[k].copy_(v)
    LOGGER.info(f"torch import: loaded {len(take)} tensors"
                + (f"; missing {len(report['missing'])} "
                   f"{report['missing'][:8]}" if report["missing"] else "")
                + (f"; unexpected {len(report['unexpected'])} "
                   f"{report['unexpected'][:8]}" if report["unexpected"]
                   else ""))
    return report
