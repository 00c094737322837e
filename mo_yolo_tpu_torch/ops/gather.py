"""take_along_axis on a 2-D f32 table: the plain PyTorch version and the
wrapper of its CUDA kernel (counterpart of `probe_gather` and its two
kernels in `scripts/micro_peak_bench.py`).

    axis 0: out[i, j] = v[idx[i, j], j]      axis 1: out[i, j] = v[i, idx[i, j]]

v is f32 [S, N], idx int32 [S, N] with entries in [0, S) along axis 0 or
[0, N) along axis 1, out f32 [S, N]. Indices are promised in bounds, as the
TPU kernels promise; the plain version raises on a stray index, the kernel
clamps it so that it reads no foreign memory.
"""

from __future__ import annotations

import ctypes

import torch

from mo_yolo_tpu_torch.utils import cuda_build


def take_along_axis_torch(v: torch.Tensor, idx: torch.Tensor,
                          axis: int) -> torch.Tensor:
    """The plain version: integer-array indexing."""
    _check(v, idx, axis)
    S, N = v.shape
    if axis == 0:
        return v[idx.long(), torch.arange(N, device=v.device)[None, :]]
    return v[torch.arange(S, device=v.device)[:, None], idx.long()]


def _check(v: torch.Tensor, idx: torch.Tensor, axis: int) -> None:
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if v.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"v must be float32 and idx int32, got {v.dtype} "
                        f"and {idx.dtype}")
    if v.dim() != 2 or idx.shape != v.shape or v.numel() == 0:
        raise ValueError(f"v and idx must be 2-D, non-empty and of one "
                         f"shape, got {tuple(v.shape)} and "
                         f"{tuple(idx.shape)}")
    if not (v.is_contiguous() and idx.is_contiguous()):
        raise ValueError("v and idx must be contiguous")
    if idx.device != v.device:
        raise ValueError("v and idx must be on one device")


def take_along_axis(v: torch.Tensor, idx: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """take_along_axis(v, idx, axis). On a CPU tensor it is the plain
    version; on a CUDA tensor it launches the kernel
    (`csrc/take_along_axis.cu`) or raises; it never falls back.
    `take_along_axis.launches` counts launches."""
    if v.device.type == "cpu":
        return take_along_axis_torch(v, idx, axis)
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    _check(v, idx, axis)
    fn = cuda_build.entry("take_along_axis", "take_along_axis",
                          [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 +
                          [ctypes.c_void_p])
    out = torch.empty_like(v)
    err = cuda_build.call(fn, v, v.data_ptr(), idx.data_ptr(),
                          out.data_ptr(), v.shape[0], v.shape[1], axis)
    if err != 0:
        raise RuntimeError(f"take_along_axis launch failed: CUDA error {err}")
    take_along_axis.launches += 1
    return out


def empty_launch(device: torch.device) -> None:
    """Launch the kernel that does nothing on `device`'s current stream, by
    the launch path every wrapper takes (the study's measure of what a
    launch costs). Raises without a card."""
    if device.type != "cuda":
        raise ValueError("an empty launch needs a CUDA device")
    fn = cuda_build.entry("take_along_axis", "empty_launch",
                          [ctypes.c_void_p])
    err = cuda_build.call(fn, device)
    if err != 0:
        raise RuntimeError(f"empty launch failed: CUDA error {err}")


take_along_axis.launches = 0
