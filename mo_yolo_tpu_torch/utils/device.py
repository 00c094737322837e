"""Device resolution for the port's entry points."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means the card: under torchrun (LOCAL_RANK set) this
    process's card, so that a rank's model is built where its rank of the
    process group runs. A CUDA device on a machine without one raises: the
    port never carries on on the CPU unless the caller asks for it."""
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        device = "cuda" if local is None else f"cuda:{int(local)}"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """'float32' / 'bfloat16' (the JAX facade's names) or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = {"float32": torch.float32,
               "bfloat16": torch.bfloat16}.get(str(dtype))
    if out not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype!r}")
    return out
