"""Carry the JAX package's weights across to the port.

`state_dict_from_jax` takes the variables of a JAX `TrackingModel`,
`DetectionModel`, `SegmentationModel`, `PoseModel` or `ClassifyModel` as a
nested dict of numpy arrays (`{"params": …,
"batch_stats": …}`) and returns the port's `state_dict`, keyed as upstream
ultralytics (`model.{i}.…`, the head at `model.{head_idx}`: a tracking
head holds `decoder` and `track_embed`, a detection head is the decoder
itself, as upstream's `RTDETRDecoder`). It is the port's own copy of the
mapping in `export_torch_state_dict` (`mo_yolo_tpu/utils/checkpoint.py`),
restricted to the modules the port has:

  * conv kernels HWIO -> OIHW;
  * dense kernels [in, out] -> [out, in];
  * q/k/v projections fused into `in_proj_weight` / `in_proj_bias`;
  * BatchNorm `scale`/`bias`/`mean`/`var` -> `weight`/`bias`/
    `running_mean`/`running_var`, plus `num_batches_tracked`;
  * a DWConv row's inner `conv` level is dropped (upstream's DWConv is a
    Conv), a Focus row's is kept (upstream's Focus holds a Conv); AIFI's
    attention, linear layers and norms as the decoder's;
  * transposed-conv kernels HWIO -> [in, out, kH, kW], flipped in space:
    flax's `ConvTranspose` correlates with its kernel where torch's
    `ConvTranspose2d` convolves;
  * the YOLOv8 task heads (`params/head/...`): `[detect/]cv{2,3,4}_{i}_{j}`
    -> `model.{h}.cv{2,3,4}.{i}.{j}` (j = 2 the plain output conv),
    `proto/{cv1,upsample,cv2,cv3}` -> `model.{h}.proto.…`, and Classify's
    `conv`, `linear` -> `model.{h}.conv`, `model.{h}.linear` (upstream's
    `model.{h}.conv` names Classify's conv, not a backbone row's, since
    the head is the row at `head_idx`).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}
_QIM = {"linear1": "linear1", "linear2": "linear2", "norm1": "norm1",
        "norm2": "norm2"}


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v, dtype=np.float32)


def _wb(leaf: str) -> str:
    return "weight" if leaf in ("kernel", "scale", "embedding") else "bias"


def _dense(leaf: str, a: np.ndarray) -> np.ndarray:
    return a.T if leaf == "kernel" else a


def _conv(a: np.ndarray) -> np.ndarray:
    return np.transpose(a, (3, 2, 0, 1))


def _conv_t(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a[::-1, ::-1], (2, 3, 0, 1)))


def _conv_bn(base: str, rest: List[str], a: np.ndarray
             ) -> Tuple[str, np.ndarray]:
    """A ConvBnAct's leaf (`conv/kernel`, `bn/<leaf>`) under `base`."""
    if rest[0] == "conv":
        return f"{base}.conv.weight", _conv(a)
    return f"{base}.bn.{_BN[rest[-1]]}", a


def _task_head(H: str, rest: List[str], a: np.ndarray
               ) -> Tuple[str, np.ndarray]:
    """A YOLOv8 task head's leaf -> (key under `H`, value)."""
    if rest[0] == "detect":       # Segment and Pose nest the Detect head
        rest = rest[1:]
    name, leaf = rest[0], rest[-1]
    if name[:3] in ("cv2", "cv3", "cv4"):
        cv, i, j = name.split("_")
        base = f"{H}.{cv}.{i}.{j}"
        if j == "2":              # the plain output conv
            return f"{base}.{_wb(leaf)}", _conv(a) if leaf == "kernel" else a
        return _conv_bn(base, rest[1:], a)
    if name == "proto":
        if rest[1] == "upsample":
            return (f"{H}.proto.upsample.{_wb(leaf)}",
                    _conv_t(a) if leaf == "kernel" else a)
        return _conv_bn(f"{H}.proto.{rest[1]}", rest[2:], a)
    if name == "conv":
        return _conv_bn(f"{H}.conv", rest[1:], a)
    if name == "linear":
        return f"{H}.linear.{_wb(leaf)}", _dense(leaf, a)
    raise KeyError("/".join(rest))


def _map(parts: Tuple[str, ...], a: np.ndarray, H: str,
         qkv: Dict[str, Dict[str, np.ndarray]], detect: bool = False,
         focus_rows: Sequence[int] = ()
         ) -> Optional[Tuple[str, np.ndarray]]:
    """One JAX leaf -> (torch key, value); q/k/v leaves are collected in
    `qkv` and fused afterwards (returns None for them)."""
    top, rest = parts[1], list(parts[2:])
    leaf = rest[-1]

    def attn(base: str, proj: str):
        if proj == "out_proj":
            return f"{base}.out_proj.{_wb(leaf)}", _dense(leaf, a)
        qkv.setdefault(base, {})[f"{proj}/{leaf}"] = a
        return None

    if top == "backbone":
        # n{i}/[m{j}/]{cv1|cv2}/{conv|bn}/leaf -> model.{i}[.m.{j}].cv1.…
        node = f"model.{rest[0][1:]}"
        if rest[1] == "ma":                     # AIFI's attention
            return attn(f"{node}.ma", rest[2])
        if rest[1] in ("fc1", "fc2", "norm1", "norm2"):     # AIFI
            return f"{node}.{rest[1]}.{_wb(leaf)}", _dense(leaf, a)
        if rest[1] == "conv_transpose":             # ConvTranspose rows
            return (f"{node}.conv_transpose.{_wb(leaf)}",
                    _conv_t(a) if leaf == "kernel" else a)
        if rest[1] == "conv" and len(rest) == 4 and \
                int(rest[0][1:]) not in focus_rows:  # DWConv's inner Conv
            rest = rest[:1] + rest[2:]
        mids: List[str] = [node]
        for p in rest[1:-1]:
            mids += ["m", p[1:]] if p[0] == "m" and p[1:].isdigit() else [p]
        if leaf == "kernel":
            return ".".join(mids + ["weight"]), _conv(a)
        return ".".join(mids + [_BN[leaf]]), a
    if top == "head":
        return _task_head(H, rest, a)
    if top == "qim":
        base = f"{H}.track_embed"
        if rest[0] == "self_attn":
            return attn(f"{base}.self_attn", rest[1])
        return f"{base}.{_QIM[rest[0]]}.{_wb(leaf)}", _dense(leaf, a)
    if top != "decoder":
        raise KeyError("/".join(parts))
    D = H if detect else f"{H}.decoder"
    sub = rest[0]
    if sub.startswith("input_proj"):
        i = sub[len("input_proj"):].rsplit("_", 1)[0]
        if sub.endswith("_conv"):
            return f"{D}.input_proj.{i}.0.weight", _conv(a)
        return f"{D}.input_proj.{i}.1.{_BN[leaf]}", a
    if sub == "denoising_class_embed":
        return f"{D}.denoising_class_embed.weight", a
    if sub == "enc_output_dense":
        return f"{D}.enc_output.0.{_wb(leaf)}", _dense(leaf, a)
    if sub == "enc_output_ln":
        return f"{D}.enc_output.1.{_wb(leaf)}", a
    if sub == "enc_score_head":
        return f"{D}.enc_score_head.{_wb(leaf)}", _dense(leaf, a)
    if sub == "enc_bbox_head":
        j = rest[1][len("layers"):]
        return f"{D}.enc_bbox_head.layers.{j}.{_wb(leaf)}", _dense(leaf, a)
    # sub == "decoder": the transformer stack and its per-layer heads
    inner = rest[1]
    if inner.startswith("score_head"):
        l = inner[len("score_head"):]
        return f"{D}.dec_score_head.{l}.{_wb(leaf)}", _dense(leaf, a)
    if inner.startswith("bbox_head"):
        l, j = inner[len("bbox_head"):], rest[2][len("layers"):]
        return (f"{D}.dec_bbox_head.{l}.layers.{j}.{_wb(leaf)}",
                _dense(leaf, a))
    L = f"{D}.decoder.layers.{inner[len('layer'):]}"
    mod = rest[2]
    if mod == "self_attn":
        return attn(f"{L}.self_attn", rest[3])
    if mod == "cross_attn":
        return f"{L}.cross_attn.{rest[3]}.{_wb(leaf)}", _dense(leaf, a)
    return f"{L}.{mod}.{_wb(leaf)}", _dense(leaf, a)   # norm{k}, linear{k}


def state_dict_from_jax(variables: Dict[str, Any], head_idx: int = 22,
                        detect: bool = False,
                        focus_rows: Sequence[int] = ()
                        ) -> Dict[str, torch.Tensor]:
    """The port's `state_dict` (f32 tensors) for JAX variables given as
    nested dicts of numpy arrays. `detect=True` reads a `DetectionModel`'s
    variables: its decoder goes straight to `model.{head_idx}`.
    `focus_rows` names the graph's Focus rows (their `conv` level stays)."""
    H = f"model.{head_idx}"
    sd: Dict[str, torch.Tensor] = {}
    qkv: Dict[str, Dict[str, np.ndarray]] = {}
    for parts, a in _flatten(variables):
        hit = _map(parts, a, H, qkv, detect, focus_rows)
        if hit is not None:
            key, val = hit
            sd[key] = torch.from_numpy(np.array(val, np.float32))  # a copy
            if key.endswith(".running_mean"):
                sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
                    torch.tensor(0, dtype=torch.long)
    for base, p in qkv.items():
        sd[f"{base}.in_proj_weight"] = torch.from_numpy(np.concatenate(
            [p[f"{n}_proj/kernel"].T for n in "qkv"], 0))
        sd[f"{base}.in_proj_bias"] = torch.from_numpy(np.concatenate(
            [p[f"{n}_proj/bias"] for n in "qkv"], 0))
    return sd
