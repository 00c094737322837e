"""The forward-sampler variant study (port of
`scripts/kernel_variants_bench.py`).

    python3 -m mo_yolo_tpu_torch.scripts.kernel_variants_bench --parity

Times candidate formulations of the deformable-attention sampler against
the main-path kernel at the study's two sizes (640x640 and 1536x800, Q=600,
H=8, D=32, L=3, P=4, bf16 value), and with `--parity` first holds every
variant to the plain gather sampler in f32. Variants:

  v0      the main-path kernel (`ops.deform_attn.ms_deform_attn`)
  v1      hat weights, attn on the per-point sum; on the card the
          main-path kernel's grid and warp (a warp per (batch, query,
          head), sub-groups with 16-byte loads)
  v2      v1 with heads on the grid and head-major operands (the
          transposes are part of the variant and of its time); on the
          card v1's grid, warp and body on [B,H,S,D], a warp per (batch,
          head, query)
  v3      the levels fused into one pass, attn folded into the x weight;
          on the card v1's grid and warp
  v4, v5  intermediates rounded to the value dtype, u = t*cy a packed
          product in it; on the card v1's grid and warp, one code path for
          both (v4's compact y weights and v5's are the same values)
  v6      only the x weights rounded, the point sum per level; on the
          card v1's grid and warp with the main-path kernel's arithmetic
  nocy    no y weight (wrong on purpose: the sum over a level's whole
          column; left out of --parity)
  v7      v3's arithmetic and rounding points over a head-major value
          (its copy timed with it); on the card v1's grid in the order
          (batch, head, query), loc, attn and the output in their layouts
  v8      hat weights with attn in the x weight, intermediates in the
          value dtype, the point sum per y row before the y-sum; on the
          card v1's grid and warp, the rows matched once per (query, level)
  *t128   the same with 128 queries a block instead of 64
  *t256   the same with 256 (v7, v8)
  vx      the one-hot-matmul algorithm in plain tensor code, f32 product
  vx2     vx with the product's result in the value dtype and the y-sum and
          point sum fused into one reduction
  vx3     vx with only the product's result in the value dtype: this is
          `ops.deform_attn.ms_deform_attn_onehot_torch`, the route the JAX
          package takes on an accelerator
  vh      level 0 through the main-path kernel, the rest one-hot
  vh2     levels 0-1 through the kernel, the last one-hot

The names and queries a block are the JAX script's `VARIANTS`, each a
hand-written CUDA kernel or plain tensor code on the card.

Timing: the median, least and greatest of five runs of `--iters` calls
after a warm-up, by CUDA events around back-to-back calls (the JAX script's
slope method cancels a relay's dispatch cost, which has no counterpart
here). That is the rate a caller sees: the slower of the host's launch path
and the device. Beside it `device_ms` is the device's own time per call
(the calls replayed from a CUDA graph), and for v0-v8 `kernel_only_ms` and
`kernel_only_device_ms` time the kernel alone on operands prepared once.
A failing variant raises. One JSON line per variant and size.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
from typing import Dict, List, Optional, Sequence

import torch

from mo_yolo_tpu_torch.ops import deform_attn_variants as dv
from mo_yolo_tpu_torch.ops.deform_attn import (hat_weights, ms_deform_attn,
                                               ms_deform_attn_onehot_torch,
                                               ms_deform_attn_torch)
from mo_yolo_tpu_torch.scripts.timing import (card_line, device_ms,
                                              device_record, measure)
from mo_yolo_tpu_torch.utils.device import resolve_device

SIZES = ((640, 640), (800, 1536))        # (h, w)
PARITY_ATOL = 1e-5    # f32 on the card and the CPU: another summation order
GRAPHED_CALLS = 20    # calls in the CUDA graph that times the device alone


def _hats(locr, attnr, lvl, hl, wl):
    """cx = hat weights over x times attn [B,H,R,Wl], cy = hat weights over
    y [B,H,R,Hl], both f32."""
    cx = hat_weights(locr[..., lvl, 0] * wl - 0.5, wl) * attnr[..., lvl, None]
    return cx, hat_weights(locr[..., lvl, 1] * hl - 0.5, hl)


def fwd_vx(value, shapes, loc, attn):
    """The one-hot-matmul algorithm in plain tensor code: per level one
    product batched over heads with an f32 result (the operands rounded to
    the value dtype and multiplied in f32, since PyTorch's matmul returns
    its operands' dtype), the y mask, a cast to the value dtype, the y-sum,
    the f32 sum over levels, then the point sum."""
    B, _, H, D = value.shape
    Q, P = loc.shape[1], loc.shape[4]
    cdtype = value.dtype
    locr, attnr, _, _ = dv.point_rows(loc, attn, 1)
    tables = dv.level_tables(value, shapes)
    out = torch.zeros(B, H, Q * P, D, dtype=torch.float32,
                      device=value.device)
    for lvl, (hl, wl) in enumerate(shapes):
        cx, cy = _hats(locr, attnr, lvl, hl, wl)
        t = torch.matmul(cx.to(cdtype).float(), tables[lvl].float())
        u = (t.view(B, H, Q * P, hl, D) * cy[..., None]).to(cdtype)
        out = out + u.sum(3).float()
    out = out.view(B, H, Q, P, D).sum(3)
    return out.permute(0, 2, 1, 3).reshape(B, Q, H * D).to(cdtype)


def fwd_vx2(value, shapes, loc, attn):
    """vx with the product's result and the y mask in the value dtype, and
    the y-sum and the point sum fused into one f32 reduction."""
    B, _, H, D = value.shape
    Q, P = loc.shape[1], loc.shape[4]
    cdtype = value.dtype
    locr, attnr, _, _ = dv.point_rows(loc, attn, 1)
    tables = dv.level_tables(value, shapes)
    out = torch.zeros(B, H, Q, D, dtype=torch.float32, device=value.device)
    for lvl, (hl, wl) in enumerate(shapes):
        cx, cy = _hats(locr, attnr, lvl, hl, wl)
        t = torch.matmul(cx.to(cdtype), tables[lvl])
        u = t.view(B, H, Q, P, hl, D) * \
            cy.to(cdtype).view(B, H, Q, P, hl, 1)
        out = out + u.sum((3, 4), dtype=torch.float32)
    return out.permute(0, 2, 1, 3).reshape(B, Q, H * D).to(cdtype)


def fwd_vh(value, shapes, loc, attn, split=1):
    """The per-level hybrid: the first `split` levels (level 0 holds 76 %
    of S at 1536x800) through the main-path kernel, whose cost follows the
    samples, the rest through the one-hot route, whose cost follows the
    map."""
    big, small = list(shapes[:split]), list(shapes[split:])
    Sb = sum(h * w for h, w in big)
    out = ms_deform_attn(value[:, :Sb].contiguous(), big,
                         loc[:, :, :, :split], attn[:, :, :, :split])
    if small:
        out = out + ms_deform_attn_onehot_torch(
            value[:, Sb:], small, loc[:, :, :, split:],
            attn[:, :, :, split:])
    return out


# name -> (function of (value, shapes, loc, attn), the variant's `prepare`
# for a kernel-only time or None)
VARIANTS: Dict[str, tuple] = {"v0": (ms_deform_attn, None)}


def _kernel_variant(name: str, TQ: int, **kw) -> tuple:
    return (functools.partial(getattr(dv, f"fwd_{name}"), TQ=TQ, **kw),
            functools.partial(getattr(dv, f"prepare_{name}"), TQ=TQ, **kw))


for _v in ("v1", "v2", "v3"):
    for _suffix, _tq in (("", 64), ("t128", 128)):
        VARIANTS[_v + _suffix] = _kernel_variant(_v, _tq)
VARIANTS.update({
    "v4": _kernel_variant("v45", 64, compact_cy=True),
    "v4t128": _kernel_variant("v45", 128, compact_cy=True),
    "v5": _kernel_variant("v45", 64, compact_cy=False),
    "v6": _kernel_variant("v6", 64),
    "v6t128": _kernel_variant("v6", 128),
    "nocy": _kernel_variant("nocy", 64),
})
for _v in ("v7", "v8"):
    for _suffix, _tq in (("", 64), ("t128", 128), ("t256", 256)):
        VARIANTS[_v + _suffix] = _kernel_variant(_v, _tq)
VARIANTS.update({
    "vx": (fwd_vx, None),
    "vx2": (fwd_vx2, None),
    "vx3": (ms_deform_attn_onehot_torch, None),
    "vh": (functools.partial(fwd_vh, split=1), None),
    "vh2": (functools.partial(fwd_vh, split=2), None),
})


def level_shapes(h: int, w: int):
    return tuple((h // s, w // s) for s in (8, 16, 32))


def make_inputs(h: int, w: int, generator: torch.Generator, q: int = 600,
                heads: int = 8, d: int = 32, p: int = 4,
                dtype: torch.dtype = torch.bfloat16, device="cpu"):
    """The study's inputs: a normal value [1,S,heads,d] in `dtype`, loc
    uniform in [0.05, 0.95], attn a softmax over the points of each level,
    in `dtype`. Drawn on the CPU from `generator`, then moved."""
    shp = level_shapes(h, w)
    S = sum(a * b for a, b in shp)
    v = torch.randn(1, S, heads, d, generator=generator).to(dtype)
    loc = torch.rand(1, q, heads, len(shp), p, 2, generator=generator) * \
        0.9 + 0.05
    aw = torch.softmax(torch.randn(1, q, heads, len(shp), p,
                                   generator=generator), -1).to(dtype)
    return v.to(device), shp, loc.to(device), aw.to(device)


def check_parity(h: int, w: int, device: torch.device,
                 names: Optional[Sequence[str]] = None,
                 q: int = 600) -> Dict[str, float]:
    """Every variant against the plain gather sampler on f32 inputs; raises
    on an error over `PARITY_ATOL`. TF32 is off for the products. The nocy
    ablation computes another sum on purpose and is left out, as the JAX
    script leaves it out."""
    torch.backends.cuda.matmul.allow_tf32 = False
    v, shp, loc, aw = make_inputs(h, w, torch.Generator().manual_seed(0),
                                  q=q, dtype=torch.float32, device=device)
    ref = ms_deform_attn_torch(v, shp, loc, aw)
    errs = {}
    for name in names or list(VARIANTS):
        if name == "nocy":
            continue
        got = VARIANTS[name][0](v, shp, loc, aw)
        err = float((got - ref).abs().max())
        errs[name] = err
        print(f"  parity {name} @{w}x{h}: max abs err {err:.2e}", flush=True)
        if not (math.isfinite(err) and err <= PARITY_ATOL):
            raise AssertionError(f"parity {name} @{w}x{h}: max abs err "
                                 f"{err} over {PARITY_ATOL}")
    return errs


def bench_variant(name: str, h: int, w: int, device: torch.device,
                  q: int = 600, iters: int = 50) -> Dict[str, object]:
    """One record: the variant's whole call (layout preparation included)
    and, where it has a kernel of its own, the kernel alone."""
    fn, prepare = VARIANTS[name]
    v, shp, loc, aw = make_inputs(h, w, torch.Generator().manual_seed(0),
                                  q=q, device=device)
    out = fn(v, shp, loc, aw)
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{name} @{w}x{h}: non-finite output")
    def call():
        return fn(v, shp, loc, aw)
    rec = {"study": "kernel_variants", "size": f"{w}x{h}", "variant": name,
           "q": q, **measure(call, iters, device),
           "device_ms": device_ms(call, GRAPHED_CALLS, device),
           "kernel_only_ms": None, "kernel_only_device_ms": None,
           "device": device_record(device)}
    if device.type == "cuda":
        if prepare is not None:
            launch, _ = prepare(v, shp, loc, aw)
            rec["kernel_only_ms"] = measure(launch, iters, device)["ms"]
            rec["kernel_only_device_ms"] = device_ms(launch, GRAPHED_CALLS,
                                                     device)
        elif name == "v0":      # no preparation: the call is the kernel
            rec["kernel_only_ms"] = rec["ms"]
            rec["kernel_only_device_ms"] = rec["device_ms"]
    return rec


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--q", type=int, default=600)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--variants", type=str, default="")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions; default: the card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    names = args.variants.split(",") if args.variants else list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{list(VARIANTS)}")
    print(json.dumps({"study": "kernel_variants", "q": args.q,
                      "device": device_record(device),
                      "card": card_line(device)}), flush=True)
    if args.parity:
        check_parity(320, 320, device, names, q=args.q)
    records = []
    for h, w in SIZES:
        for name in names:
            rec = bench_variant(name, h, w, device, q=args.q,
                                iters=args.iters)
            print(json.dumps(rec), flush=True)
            records.append(rec)
    return records


if __name__ == "__main__":
    main()
