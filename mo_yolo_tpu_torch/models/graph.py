"""Config-driven backbone/neck graph (counterpart of
`mo_yolo_tpu/models/graph.py`).

`parse_model_yaml` reads an ultralytics-style config dict (rows of
`[from, repeats, module, args]`) for the row types the track, detection
and task configs use: Conv (with its padding and activation arguments),
C2f, C3, SPPF, SPP, Upsample, Concat, ConvTranspose, Focus, GhostConv,
the RT-DETR rows DWConv, RepC3, HGStem, HGBlock and AIFI, and a head row
(any of `HEAD_MODULES`, as the JAX parser takes; the task model builds
its own head on the taps from the row's arguments, `head_args`, and the
taps' strides, `out_strides`).
`BackboneNeck` is an `nn.ModuleList` whose entry i is row i, so its
`state_dict` keys are upstream's `model.{i}.…` once the task model stores
it as `model`; the head module sits at the head row's index.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from mo_yolo_tpu_torch.cfg.models import load_model_cfg
from mo_yolo_tpu_torch.models.layers import (AIFI, C3, SPP, SPPF, C2f,
                                             Concat, ConvBnAct, ConvTranspose,
                                             DWConv, Focus, GhostConv,
                                             HGBlock, HGStem, RepC3)

HEAD_MODULES = {"MOTRTrack", "RTDETRDecoder", "MYDecoder", "Detect", "Segment",
                "Pose", "Classify"}


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    index: int
    frm: Tuple[int, ...]     # input node indices (-1 = previous)
    module: str              # 'Conv' | 'C2f' | 'SPPF' | 'Upsample' | ...
    repeats: int
    args: Tuple[Any, ...]
    in_channels: int
    out_channels: int


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    nodes: Tuple[NodeSpec, ...]
    out_indices: Tuple[int, ...]   # feature taps consumed by the head
    out_channels: Tuple[int, ...]
    nc: int
    head_module: str
    head_args: Tuple[Any, ...] = ()     # the head row's arguments
    out_strides: Tuple[int, ...] = ()   # each tap's stride in pixels

    @property
    def head_index(self) -> int:
        return len(self.nodes)


def parse_model_yaml(cfg: Union[str, Dict[str, Any]],
                     nc: Optional[int] = None) -> GraphSpec:
    """Parse a config (dict, bundled name or yaml path) into a GraphSpec.
    `nc` overrides the config's class count."""
    cfg = load_model_cfg(cfg)
    nc = nc if nc is not None else int(cfg.get("nc", 80))
    if cfg.get("activation") is not None:
        raise ValueError("activation overrides are not ported")
    if "scales" in cfg:
        raise ValueError("model config key 'scales' (compound depth, width "
                         "and max_channels) is not ported; give "
                         "depth_multiple and width_multiple")
    depth = float(cfg.get("depth_multiple", 1.0))
    width = float(cfg.get("width_multiple", 1.0))

    def channels(c) -> int:
        return make_divisible(c * width)

    rows = list(cfg["backbone"]) + list(cfg["head"])
    ch: List[int] = [3]            # ch[i + 1] = output channels of node i
    stride: List[int] = []         # stride[i] = node i's stride in pixels
    nodes: List[NodeSpec] = []
    head_row = None
    for i, (frm, n, mod, args) in enumerate(rows):
        mod = str(mod)
        frm_t = tuple(frm) if isinstance(frm, (list, tuple)) else (frm,)
        frm_t = tuple(f if f >= 0 else i + f for f in frm_t)
        # a yaml "None" string is None, as the JAX parser reads it
        args = [None if a == "None" else (nc if a == "nc" else a)
                for a in (args or [])]
        n_rep = max(round(n * depth), 1) if n > 1 else n
        if mod in HEAD_MODULES:
            head_row = (frm_t, mod, tuple(args))
            break
        c1 = ch[frm_t[0] + 1]
        st = stride[frm_t[0]] if frm_t[0] >= 0 else 1
        if mod == "Conv":
            c2 = channels(args[0])
            k = args[1] if len(args) > 1 else 1
            s = args[2] if len(args) > 2 else 1
            p = args[3] if len(args) > 3 else None
            act = args[6] if len(args) > 6 else True
            if n_rep != 1:
                raise ValueError("repeated Conv rows are not ported")
            nodes.append(NodeSpec(i, frm_t, "Conv", 1, (k, s, act, p), c1,
                                  c2))
            st *= s
        elif mod == "DWConv":
            c2 = channels(args[0])
            k = args[1] if len(args) > 1 else 1
            s = args[2] if len(args) > 2 else 1
            act = args[4] if len(args) > 4 else True
            nodes.append(NodeSpec(i, frm_t, "DWConv", 1, (k, s, act), c1, c2))
            st *= s
        elif mod in ("C2f", "C3"):
            c2 = channels(args[0])
            shortcut = bool(args[1]) if len(args) > 1 else mod == "C3"
            nodes.append(NodeSpec(i, frm_t, mod, n_rep, (shortcut,), c1, c2))
        elif mod == "ConvTranspose":
            c2 = channels(args[0])
            k = args[1] if len(args) > 1 else 2
            s = args[2] if len(args) > 2 else 2
            nodes.append(NodeSpec(i, frm_t, mod, 1, (k, s), c1, c2))
            st = max(st // s, 1)
        elif mod == "Focus":
            c2 = channels(args[0])
            k = args[1] if len(args) > 1 else 1
            nodes.append(NodeSpec(i, frm_t, mod, 1, (k,), c1, c2))
            st *= 2
        elif mod == "GhostConv":
            c2 = channels(args[0])
            k = args[1] if len(args) > 1 else 1
            s = args[2] if len(args) > 2 else 1
            nodes.append(NodeSpec(i, frm_t, mod, 1, (k, s), c1, c2))
            st *= s
        elif mod == "SPP":
            c2 = channels(args[0])
            ks = tuple(args[1]) if len(args) > 1 else (5, 9, 13)
            nodes.append(NodeSpec(i, frm_t, mod, 1, (ks,), c1, c2))
        elif mod == "RepC3":
            c2 = channels(args[0])
            nodes.append(NodeSpec(i, frm_t, "RepC3", n_rep, (), c1, c2))
        elif mod == "HGStem":
            c2 = channels(args[1])
            nodes.append(NodeSpec(i, frm_t, "HGStem", 1, (channels(args[0]),),
                                  c1, c2))
            st *= 4
        elif mod == "HGBlock":
            c2 = channels(args[1])
            k = args[2] if len(args) > 2 else 3
            light = bool(args[3]) if len(args) > 3 else False
            shortcut = bool(args[4]) if len(args) > 4 else False
            nodes.append(NodeSpec(i, frm_t, "HGBlock", n_rep,
                                  (channels(args[0]), k, light, shortcut),
                                  c1, c2))
        elif mod == "AIFI":
            c2 = c1
            cm = args[0] if args else 2048
            heads = args[1] if len(args) > 1 else 8
            nodes.append(NodeSpec(i, frm_t, "AIFI", 1, (cm, heads), c1, c2))
        elif mod == "SPPF":
            c2 = channels(args[0])
            k = args[1] if len(args) > 1 else 5
            nodes.append(NodeSpec(i, frm_t, "SPPF", 1, (k,), c1, c2))
        elif mod in ("nn.Upsample", "Upsample"):
            c2 = c1
            nodes.append(NodeSpec(i, frm_t, "Upsample", 1, (), c1, c2))
            st //= 2
        elif mod == "Concat":
            c2 = sum(ch[f + 1] for f in frm_t)
            nodes.append(NodeSpec(i, frm_t, "Concat", 1, (), c1, c2))
        else:
            raise ValueError(f"unsupported module in the port's graph: {mod}")
        ch.append(c2)
        stride.append(st)
    if head_row is None:
        raise ValueError("model config has no head row (one of "
                         f"{sorted(HEAD_MODULES)})")
    taps, head_module, head_args = head_row
    if head_module == "Segment" and len(head_args) >= 3:
        # the proto channels are a channel count like any other
        head_args = (*head_args[:2], channels(head_args[2]))
    return GraphSpec(tuple(nodes), taps, tuple(ch[f + 1] for f in taps), nc,
                     head_module, head_args,
                     tuple(stride[f] for f in taps))


def _build_node(node: NodeSpec) -> nn.Module:
    c1, c2, a = node.in_channels, node.out_channels, node.args
    if node.module == "Conv":
        k, s, act, p = a
        return ConvBnAct(c1, c2, k, s, act=act, p=p)
    if node.module == "DWConv":
        return DWConv(c1, c2, *a)
    if node.module == "C2f":
        return C2f(c1, c2, node.repeats, a[0])
    if node.module == "C3":
        return C3(c1, c2, node.repeats, a[0])
    if node.module == "ConvTranspose":
        return ConvTranspose(c1, c2, *a)
    if node.module == "Focus":
        return Focus(c1, c2, *a)
    if node.module == "GhostConv":
        return GhostConv(c1, c2, *a)
    if node.module == "SPP":
        return SPP(c1, c2, a[0])
    if node.module == "RepC3":
        return RepC3(c1, c2, node.repeats)
    if node.module == "HGStem":
        return HGStem(c1, a[0], c2)
    if node.module == "HGBlock":
        cm, k, light, shortcut = a
        return HGBlock(c1, cm, c2, k, node.repeats, light, shortcut)
    if node.module == "AIFI":
        return AIFI(c1, *a)
    if node.module == "SPPF":
        return SPPF(c1, c2, a[0])
    if node.module == "Upsample":
        return nn.Upsample(scale_factor=2.0, mode="nearest")
    return Concat()


class BackboneNeck(nn.ModuleList):
    """Runs the parsed CNN graph and returns the head's feature taps.

    Entry i is graph row i; `head`, when given, is appended at the head
    row's index and is not run here. For `yolo_track` this is the
    YOLOv8-l backbone (rows 0-9) and PAN neck (rows 10-21), for
    `detr_track` HGNetV2 (rows 0-9) and the hybrid encoder (rows 10-27),
    each returning (P3, P4, P5) at strides 8/16/32."""

    def __init__(self, spec: GraphSpec, head: Optional[nn.Module] = None):
        super().__init__(_build_node(n) for n in spec.nodes)
        if head is not None:
            self.append(head)
        self.spec = spec
        needed = set(spec.out_indices)
        for node in spec.nodes:
            needed.update(f for f in node.frm if f >= 0)
        self._needed = needed

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x: frames [B,H,W,3], uint8 (raw) or float in [0, 1]. Returns the
        taps NCHW."""
        prev = x.permute(0, 3, 1, 2)
        outputs: Dict[int, torch.Tensor] = {}
        for node in self.spec.nodes:
            ins = [prev if f == -1 else outputs[f] for f in node.frm]
            layer = self[node.index]
            y = layer(ins) if node.module == "Concat" else layer(ins[0])
            if node.index in self._needed:
                outputs[node.index] = y
            prev = y
        return tuple(outputs[i] for i in self.spec.out_indices)
