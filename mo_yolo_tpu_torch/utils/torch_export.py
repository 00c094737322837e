"""Upstream-format `.pt` checkpoints and TorchScript (the port's
counterparts of `export_reference_pt` and `export_torchscript` in
`mo_yolo_tpu/utils/torch_export.py`).

The file is the dict upstream's trainer writes (epoch, best_fitness,
model, train_args, date, version) plus `state_dict`, the weights in
upstream's layout (`utils/checkpoint.export_torch_state_dict`). `model`,
upstream's pickled module, is None: building it needs the upstream
package, and `module.load_state_dict(torch.load(p)["state_dict"])` loads
the weights without it. The file loads with `weights_only=True`.

`export_torchscript` traces the port's own module (the JAX package builds
upstream's, which needs the upstream package): the forward without NMS,
as upstream exports it, taking [B, 3, H, W] float images in [0, 1], with
upstream's `config.txt` sidecar (imgsz, names, task, stride, half).
"""

from __future__ import annotations

import datetime
import json
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from torch import nn

from mo_yolo_tpu_torch import __version__
from mo_yolo_tpu_torch.utils.checkpoint import export_torch_state_dict


def export_reference_pt(module: nn.Module, path: str,
                        train_args: Dict[str, Any],
                        half: bool = False) -> str:
    """Write `module`'s weights as an upstream-format checkpoint at
    `path` with the suffix `.pt` (bf16 tensors where `half`); returns the
    path written."""
    sd = export_torch_state_dict(module)
    if half:
        sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    out = Path(path).with_suffix(".pt")
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({
        "epoch": -1,
        "best_fitness": None,
        "model": None,
        "state_dict": sd,
        "train_args": dict(train_args),
        "date": datetime.datetime.now().isoformat(),
        "version": f"mo-yolo-tpu-torch {__version__}",
    }, str(out))
    return str(out)


class _ImagesFirst(nn.Module):
    """The model on [B, 3, H, W] images (upstream's export input); the
    port's modules take [B, H, W, 3]."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor):
        return self.model(x.permute(0, 2, 3, 1))


def export_torchscript(module: nn.Module, path: str, imgsz: int,
                       task: str = "detect",
                       names: Optional[Dict[int, str]] = None,
                       half: bool = False, optimize: bool = False) -> str:
    """Trace `module`'s forward (no NMS) on a zero [1, 3, imgsz, imgsz]
    image and save it at `path` with the suffix `.torchscript` and a
    `config.txt` sidecar (`optimize`: for the mobile interpreter). The
    trace runs in eval mode, in f32 (f16 with `half`), on the module's
    device; the live module is left as it was. Returns the path written."""
    import copy
    h = w = int(imgsz)
    dev = next(module.parameters()).device
    dtype = torch.float16 if half else torch.float32
    wrapped = _ImagesFirst(copy.deepcopy(module).to(dtype).eval())
    example = torch.zeros(1, 3, h, w, dtype=dtype, device=dev)
    with torch.no_grad():
        ts = torch.jit.trace(wrapped, example, strict=False)
    out = Path(path).with_suffix(".torchscript")
    out.parent.mkdir(parents=True, exist_ok=True)
    extra = {"config.txt": json.dumps({
        "imgsz": [h, w], "names": {str(k): v for k, v in (names or {}).items()},
        "task": task, "stride": 32, "half": bool(half)})}
    if optimize:
        from torch.utils.mobile_optimizer import optimize_for_mobile
        optimize_for_mobile(ts)._save_for_lite_interpreter(
            str(out), _extra_files=extra)
    else:
        ts.save(str(out), _extra_files=extra)
    return str(out)
