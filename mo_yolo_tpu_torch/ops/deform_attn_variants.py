"""Forward-sampler variants of the sampler study: v1-v8 and the nocy
ablation, each a plain PyTorch version and the wrapper of its CUDA kernel
(counterparts of `fwd_v1`, `fwd_v2`, `fwd_v3`, `_fwd_like_v0` with
`_kernel_v45`/`_kernel_nocy`/`_kernel_v6`, `fwd_v7` and `fwd_v8` in
`scripts/kernel_variants_bench.py`).

Each computes the function of `ops.deform_attn.ms_deform_attn` (nocy on
purpose not), with its shapes: value [B,S,H,D], loc [B,Q,H,L,P,2], attn
[B,Q,H,L,P], output [B,Q,H·D] in the value dtype; loc and attn are held in
f32. `TQ` is the number of queries one block of the TPU kernel owns; a
last partial tile is padded (plain versions) or masked (v7's kernel, the
one that tiles by it; v1-v6, v8 and nocy run one warp per (batch, query,
head) and do not use it).

What each studies, and what its kernel does on the card:

- v1 (`csrc/ms_deform_attn_fwd_v1.cu`): hat-function weights
  relu(1 − |x − c|) and the attention weight on each point's summed
  sample, f32 inside. Its kernel is the main-path kernel's warp on its
  grid: one warp per (b, q, h), a point's corner rows read by a sub-group
  of lanes with 16-byte loads, loc and attn handed out by shuffles. It
  reads the operands as they are: no layout preparation.
- v2 (`csrc/ms_deform_attn_fwd_v2.cu`): v1's arithmetic with heads on the
  grid and head-major operands. Its layout preparation makes value
  [B,H,S,D] and loc/attn [B,H,Q,...] and transposes the [B,H,Q,D] result
  back; that is part of the variant and of its time. Its kernel is v1's
  grid, warp and body on the head-major layout: one warp per (b, h, q).
- v3 (`csrc/ms_deform_attn_fwd_v3.cu`): the levels fused into one pass,
  the attention weight folded into the x weight, f32 inside. Its kernel is
  v1's grid and sub-groups on the native layout, each corner weighted
  (wx·a)·wy. No layout preparation.
- v4/v5 (`csrc/ms_deform_attn_fwd_v45.cu`): intermediates rounded to the
  value dtype, u = t·cy a packed product in it. Its kernel is v1's grid
  and sub-groups on the native layout; v4's compact y weights and v5's
  full-width ones are the same values, so one code path serves both.
- nocy (`csrc/ms_deform_attn_fwd_nocy.cu`): no y weight, the sum over a
  level's whole column; wrong on purpose (the TPU's ablation). Its kernel
  sums each column once into an f32 workspace, then samples those sums
  with two x taps a point on K1's grid.
- v6 (`csrc/ms_deform_attn_fwd_v6.cu`): only the x weights rounded, the
  point sum per level. Its kernel is the main-path kernel's arithmetic with
  that one rounding, on v1's grid and sub-groups.
- v7 (`csrc/ms_deform_attn_fwd_v7.cu`): v3's arithmetic with v2's layout
  preparation; its kernel still runs the TPU's grid, a block per (query
  tile, head, batch) with the tile's loc and attn in shared memory.
- v8 (`csrc/ms_deform_attn_fwd_v8.cu`): hat weights with attn in the x
  weight, intermediates rounded to the value dtype, the point sum per y row
  before the y-sum. Its kernel runs v1's grid and sub-groups on the native
  layout: the sub-groups write each point's rounded row terms to shared
  memory, the candidates' rows are matched once per (query, level), and
  each lane sums its elements row by row. No layout preparation.

The plain versions follow the JAX kernels' arithmetic (the one-hot or hat
matrix products, with their casts to the value dtype at the same places),
and the kernels keep those rounding points: in bf16 a kernel agrees with
its own plain version far more closely than with the f32 sampler.
`fwd_v1_torch` and `fwd_v2_torch` share `_hat_sampler_torch`, and
`fwd_v7_torch` is `fwd_v3_torch`: those TPU kernels differ in their grid,
not in their arithmetic.

On a CPU tensor a wrapper computes its plain version; on a CUDA tensor it
launches its kernel or raises. `fwd_v1.launches` etc. count launches.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from mo_yolo_tpu_torch.ops.deform_attn import (_DTYPE_CODE, MAX_LP, Shapes,
                                               _check, _check_kernel,
                                               _hw_array, hat_weights)
from mo_yolo_tpu_torch.utils import cuda_build

# what one block may take of an SM's shared memory on the card (227 KB)
MAX_DYNAMIC_SMEM = 232448
# v8's kernel matches a level's 2P candidate rows in the lanes of a warp
V8_MAX_POINTS = 8


# ------------------------------------------------------------ plain versions

def point_rows(loc: torch.Tensor, attn: torch.Tensor, TQ: int):
    """The counterpart of `_prep`'s loc/attn half: f32, Q padded with zeros
    to a multiple of TQ, rows r = q*P + p, head-major.
    Returns (loc [B,H,R,L,2], attn [B,H,R,L], Q, Qp)."""
    _check_tq(TQ)
    loc = loc.float()
    attn = attn.float()
    B, Q, H, L, P = attn.shape
    qpad = -Q % TQ
    if qpad:
        loc = F.pad(loc, (0, 0) * 4 + (0, qpad))
        attn = F.pad(attn, (0, 0) * 3 + (0, qpad))
    Qp = Q + qpad
    locr = loc.permute(0, 2, 1, 4, 3, 5).reshape(B, H, Qp * P, L, 2)
    attnr = attn.permute(0, 2, 1, 4, 3).reshape(B, H, Qp * P, L)
    return locr, attnr, Q, Qp


def level_tables(value: torch.Tensor, shapes: Shapes):
    """The counterpart of `_prep`'s value half: per level the table
    [B,H,Wl,Hl*D] (x along rows, (y, d) along columns)."""
    B, S, H, D = value.shape
    if sum(h * w for h, w in shapes) != S:
        raise ValueError(f"level shapes {tuple(shapes)} do not sum to S={S}")
    tables, off = [], 0
    for hl, wl in shapes:
        v = value[:, off:off + hl * wl].reshape(B, hl, wl, H, D)
        off += hl * wl
        tables.append(v.permute(0, 3, 2, 1, 4).reshape(B, H, wl, hl * D))
    return tables


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product of operands in the value dtype with an f32 result (JAX's
    `preferred_element_type=float32`): PyTorch's matmul returns its
    operands' dtype, so the rounded operands are multiplied in f32."""
    return torch.matmul(a.float(), b.float())


def _point_sum(s: torch.Tensor, Q: int, Qp: int, P: int,
               cdtype: torch.dtype) -> torch.Tensor:
    """The `psum_mat` product: rows rounded to the value dtype, summed over
    the P points of a query in f32. s [B,H,Qp*P,D] -> [B,Q,H*D]."""
    B, H, _, D = s.shape
    acc = s.to(cdtype).float().view(B, H, Qp, P, D).sum(3).to(cdtype)
    return acc.permute(0, 2, 1, 3).reshape(B, Qp, H * D)[:, :Q]


def _hat_sampler_torch(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
                       attn: torch.Tensor, TQ: int) -> torch.Tensor:
    """The arithmetic of `_kernel_v1` and `_kernel_v2`: per level hat
    weights over x, a product with the level's table (f32 result), the hat
    mask over y, a cast to the value dtype, the y-sum in f32, then the
    attention weight on the [R,D] sum; a point sum at the end."""
    cdtype = value.dtype
    P, D = loc.shape[4], value.shape[3]
    tables = level_tables(value, shapes)
    locr, attnr, Q, Qp = point_rows(loc, attn, TQ)
    B, H, R = attnr.shape[:3]
    s_acc = torch.zeros(B, H, R, D, dtype=torch.float32, device=value.device)
    for lvl, (hl, wl) in enumerate(shapes):
        x = locr[..., lvl, 0] * wl - 0.5                       # [B,H,R]
        y = locr[..., lvl, 1] * hl - 0.5
        cx, cy = hat_weights(x, wl), hat_weights(y, hl)  # [B,H,R,wl|hl]
        t = _dot_f32(cx.to(cdtype), tables[lvl])               # [B,H,R,hl*D]
        u = (t.view(B, H, R, hl, D) * cy[..., None]).to(cdtype)
        s_acc = s_acc + u.float().sum(3) * attnr[..., lvl, None]
    return _point_sum(s_acc, Q, Qp, P, cdtype)


def fwd_v1_torch(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
                 attn: torch.Tensor, TQ: int = 64) -> torch.Tensor:
    """The plain version of v1 (`_hat_sampler_torch`, shared with v2)."""
    return _hat_sampler_torch(value, shapes, loc, attn, TQ)


def fwd_v2_torch(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
                 attn: torch.Tensor, TQ: int = 64) -> torch.Tensor:
    """The plain version of v2: v1's arithmetic (`_hat_sampler_torch`); the
    TPU kernels differ only in their grid and block layout."""
    return _hat_sampler_torch(value, shapes, loc, attn, TQ)


def fwd_v3_torch(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
                 attn: torch.Tensor, TQ: int = 64) -> torch.Tensor:
    """The plain version of v3, the arithmetic of `_kernel_v3`: the levels'
    tables stacked into one block-diagonal table [B,H,ΣWl,ΣHl*D]; per level
    the guarded weights (1 − tx)·a and tx·a written at the level's row
    offset and 1 − ty and ty at its column offset (a tap outside its own
    level gets weight 0, so it cannot leak into a neighbour); one product
    (f32 result), the y mask, a cast to the value dtype, the y-sum and the
    point sum."""
    cdtype = value.dtype
    P, D = loc.shape[4], value.shape[3]
    dev = value.device
    tables = level_tables(value, shapes)
    SH = sum(h for h, _ in shapes)
    SW = sum(w for _, w in shapes)
    blocks, coff = [], 0
    for (hl, wl), v in zip(shapes, tables):
        blocks.append(F.pad(v, (coff * D, (SH - coff - hl) * D)))
        coff += hl
    vbd = torch.cat(blocks, 2)                                # [B,H,SW,SH*D]
    locr, attnr, Q, Qp = point_rows(loc, attn, TQ)
    B, H, R = attnr.shape[:3]
    wi = torch.arange(SW, device=dev)
    hi = torch.arange(SH, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    cxc = torch.zeros(B, H, R, SW, dtype=torch.float32, device=dev)
    cyc = torch.zeros(B, H, R, SH, dtype=torch.float32, device=dev)
    roff = coff = 0
    for lvl, (hl, wl) in enumerate(shapes):
        x = locr[..., lvl, 0] * wl - 0.5
        y = locr[..., lvl, 1] * hl - 0.5
        aw = attnr[..., lvl]
        x0, y0 = torch.floor(x), torch.floor(y)
        tx, ty = x - x0, y - y0
        # the guards run on floats, so NaN or inf coordinates match nothing
        taps = ((cxc, wi, roff, x0, (1.0 - tx) * aw, wl),
                (cxc, wi, roff, x0 + 1, tx * aw, wl),
                (cyc, hi, coff, y0, 1.0 - ty, hl),
                (cyc, hi, coff, y0 + 1, ty, hl))
        for dst, iota, offset, c, w, n in taps:
            w = torch.where((c >= 0) & (c <= n - 1), w, zero)
            pos = (offset + c.clamp(0, n - 1)).long()
            dst += torch.where(iota == pos[..., None], w[..., None], zero)
        roff += wl
        coff += hl
    t = _dot_f32(cxc.to(cdtype), vbd)                         # [B,H,R,SH*D]
    u = (t.view(B, H, R, SH, D) * cyc[..., None]).to(cdtype)
    s = u.float().sum(3)                                      # [B,H,R,D]
    return _point_sum(s, Q, Qp, P, cdtype)


def fwd_v7_torch(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
                 attn: torch.Tensor, TQ: int = 64) -> torch.Tensor:
    """The plain version of v7: `_kernel_v7` computes `_kernel_v3`'s
    arithmetic with the same casts in the same places (`fwd_v3_torch`); the
    TPU kernels differ only in their grid."""
    return fwd_v3_torch(value, shapes, loc, attn, TQ)


def _one_hot_pair(c: torch.Tensor, n: int, w0: torch.Tensor,
                  w1: torch.Tensor) -> torch.Tensor:
    """The one-hot taps of `_kernel_v45`, `_kernel_nocy` and `_kernel_v6`:
    [..., n] holding w0 at floor(c) and w1 at floor(c) + 1; a tap out of
    range matches no position. c, w0, w1 [...] f32."""
    c0 = torch.floor(c)[..., None]
    iota = torch.arange(n, dtype=torch.float32, device=c.device)
    zero = torch.zeros((), dtype=torch.float32, device=c.device)
    return torch.where(iota == c0, w0[..., None], zero) + \
        torch.where(iota == c0 + 1, w1[..., None], zero)


def _level_coords(locr, attnr, lvl, hl, wl):
    """x = loc_x·Wl − 0.5, its fraction tx, the same for y, and attn."""
    x = locr[..., lvl, 0] * wl - 0.5
    y = locr[..., lvl, 1] * hl - 0.5
    return x, x - torch.floor(x), y, y - torch.floor(y), attnr[..., lvl]


def _finish(acc: torch.Tensor, Q: int, cdtype: torch.dtype) -> torch.Tensor:
    """acc [B,H,Qp,D] f32 -> [B,Q,H·D] in the value dtype."""
    B, H, Qp, D = acc.shape
    return acc.to(cdtype).permute(0, 2, 1, 3).reshape(B, Qp, H * D)[:, :Q]


def fwd_v45_torch(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
                  attn: torch.Tensor, TQ: int = 64,
                  compact_cy: bool = True) -> torch.Tensor:
    """The plain version of v4 (`compact_cy`) and v5, the arithmetic of
    `_kernel_v45`: per level the one-hot x weights (1 − tx)·a and tx·a
    rounded to the value dtype; the product with the level's table (f32
    result) rounded to the value dtype; the one-hot y weights in the value
    dtype, built [R,Hl] and expanded by a one-hot product (v4) or built at
    [R,Hl·D] (v5), the same values; u = t·cy in the value dtype; the y-sum in
    f32, rounded to the value dtype; per level the point sum in f32."""
    cdtype = value.dtype
    P, D = loc.shape[4], value.shape[3]
    dev = value.device
    tables = level_tables(value, shapes)
    locr, attnr, Q, Qp = point_rows(loc, attn, TQ)
    B, H, R = attnr.shape[:3]
    acc = torch.zeros(B, H, Qp, D, dtype=torch.float32, device=dev)
    for lvl, (hl, wl) in enumerate(shapes):
        x, tx, y, ty, aw = _level_coords(locr, attnr, lvl, hl, wl)
        cx = _one_hot_pair(x, wl, (1.0 - tx) * aw, tx * aw).to(cdtype)
        t = _dot_f32(cx, tables[lvl]).to(cdtype)              # [B,H,R,hl*D]
        if compact_cy:
            cy = _one_hot_pair(y, hl, 1.0 - ty, ty).to(cdtype)    # [B,H,R,hl]
            e_mat = (torch.arange(hl, device=dev)[:, None] ==
                     torch.arange(hl * D, device=dev) // D).to(cdtype)
            cyb = _dot_f32(cy, e_mat).to(cdtype)
        else:
            yi = (torch.arange(hl * D, device=dev) // D).float()
            zero = torch.zeros((), device=dev)
            y0 = torch.floor(y)[..., None]
            cyb = (torch.where(yi == y0, (1.0 - ty)[..., None], zero) +
                   torch.where(yi == y0 + 1, ty[..., None], zero)
                   ).to(cdtype)
        u = t * cyb                                           # value dtype
        s = u.float().view(B, H, R, hl, D).sum(3)
        acc += s.to(cdtype).float().view(B, H, Qp, P, D).sum(3)
    return _finish(acc, Q, cdtype)


def fwd_nocy_torch(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
                   attn: torch.Tensor, TQ: int = 64) -> torch.Tensor:
    """The plain version of nocy, the arithmetic of `_kernel_nocy`, wrong on
    purpose: the one-hot x weights times a, rounded to the value dtype, the
    product with the level's table (f32), then the sum over ALL Hl rows of
    the level (no y weight) and the point sum, both f32."""
    cdtype = value.dtype
    P, D = loc.shape[4], value.shape[3]
    tables = level_tables(value, shapes)
    locr, attnr, Q, Qp = point_rows(loc, attn, TQ)
    B, H, R = attnr.shape[:3]
    acc = torch.zeros(B, H, Qp, D, dtype=torch.float32, device=value.device)
    for lvl, (hl, wl) in enumerate(shapes):
        x, tx, _, _, aw = _level_coords(locr, attnr, lvl, hl, wl)
        cx = (_one_hot_pair(x, wl, 1.0 - tx, tx) * aw[..., None]).to(cdtype)
        t = _dot_f32(cx, tables[lvl])                         # [B,H,R,hl*D]
        s = t.view(B, H, R, hl, D).sum(3)
        acc += s.view(B, H, Qp, P, D).sum(3)
    return _finish(acc, Q, cdtype)


def fwd_v6_torch(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
                 attn: torch.Tensor, TQ: int = 64) -> torch.Tensor:
    """The plain version of v6, the arithmetic of `_kernel_v6`: the one-hot
    x weights times a, rounded to the value dtype (the only rounding before
    the output); the product (f32), the one-hot y weights (f32), then per
    level the point sum before the y-sum, both f32."""
    cdtype = value.dtype
    P, D = loc.shape[4], value.shape[3]
    tables = level_tables(value, shapes)
    locr, attnr, Q, Qp = point_rows(loc, attn, TQ)
    B, H, R = attnr.shape[:3]
    acc = torch.zeros(B, H, Qp, D, dtype=torch.float32, device=value.device)
    for lvl, (hl, wl) in enumerate(shapes):
        x, tx, y, ty, aw = _level_coords(locr, attnr, lvl, hl, wl)
        cx = (_one_hot_pair(x, wl, 1.0 - tx, tx) * aw[..., None]).to(cdtype)
        cyb = _one_hot_pair(y, hl, 1.0 - ty, ty)              # [B,H,R,hl]
        u = _dot_f32(cx, tables[lvl]).view(B, H, R, hl, D) * cyb[..., None]
        su = u.view(B, H, Qp, P, hl, D).sum(3)                # point sum
        acc += su.sum(3)                                      # then y-sum
    return _finish(acc, Q, cdtype)


def fwd_v8_torch(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
                 attn: torch.Tensor, TQ: int = 128) -> torch.Tensor:
    """The plain version of v8, the arithmetic of `_kernel_v8`: hat weights
    relu(1 − |x − c|) times a over x, rounded to the value dtype; the
    product (f32); the hat weights over y (f32); u = t·cy rounded to the
    value dtype; per level the point sum of u in f32 per y row, rounded to
    the value dtype, then the y-sum in f32."""
    cdtype = value.dtype
    P, D = loc.shape[4], value.shape[3]
    tables = level_tables(value, shapes)
    locr, attnr, Q, Qp = point_rows(loc, attn, TQ)
    B, H, R = attnr.shape[:3]
    acc = torch.zeros(B, H, Qp, D, dtype=torch.float32, device=value.device)
    for lvl, (hl, wl) in enumerate(shapes):
        x, _, y, _, aw = _level_coords(locr, attnr, lvl, hl, wl)
        cx = (hat_weights(x, wl) * aw[..., None]).to(cdtype)
        t = _dot_f32(cx, tables[lvl]).view(B, H, R, hl, D)
        u = (t * hat_weights(y, hl)[..., None]).to(cdtype)
        su = u.float().view(B, H, Qp, P, hl, D).sum(3)        # point sum
        acc += su.to(cdtype).float().sum(3)                   # then y-sum
    return _finish(acc, Q, cdtype)


def _check_tq(TQ: int) -> None:
    if TQ < 1:
        raise ValueError(f"TQ must be positive, got {TQ}")


# ------------------------------------------------------------------ kernels

def _check_tile(loc: torch.Tensor, TQ: int, heads_in_block: bool) -> None:
    """A tile's loc and attn must fit the block's shared memory."""
    H, L, P = loc.shape[2], loc.shape[3], loc.shape[4]
    _check_tq(TQ)
    smem = TQ * (H if heads_in_block else 1) * L * P * 3 * 4
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"TQ={TQ} needs {smem} bytes of shared memory for "
                         f"a tile's loc and attn; a block has "
                         f"{MAX_DYNAMIC_SMEM}")


def _check_grid(value: torch.Tensor, loc: torch.Tensor, TQ: int,
                tiled: bool, heads_in_block: bool) -> None:
    """`tiled`: the kernel stages a tile of TQ queries (with all heads, or
    one) in shared memory (`_check_tile`); otherwise it runs one warp per
    (b, q, h), carries the row and the points in a warp as the main-path
    kernel does (D <= 128, L*P <= 64) and only checks TQ."""
    if tiled:
        _check_tile(loc, TQ, heads_in_block)
    else:
        _check_tq(TQ)
        _check_kernel(value, loc)


def _c_launch(name: str, counter: Callable, value: torch.Tensor,
              shapes: Shapes, loc: torch.Tensor, attn: torch.Tensor,
              out: torch.Tensor, dims: Tuple[int, ...], TQ: int,
              extra: Tuple[int, ...] = (),
              ws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch `csrc/<name>.cu` on the current stream; raise on a CUDA
    error; add one to `counter.launches`. dims = (B, S, Q, H, D, L, P);
    `extra` are the kernel's int arguments after TQ (v45's compact_cy);
    `ws` a workspace, passed after out (nocy's column sums)."""
    ptrs = [value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
            out.data_ptr()] + ([] if ws is None else [ws.data_ptr()])
    fn = cuda_build.entry(name, name, [ctypes.c_void_p] * len(ptrs) +
                          [ctypes.c_int] * (9 + len(extra)) +
                          [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    err = cuda_build.call(fn, value, *ptrs, _DTYPE_CODE[value.dtype], *dims,
                          TQ, *extra, _hw_array(shapes))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    counter.launches += 1
    return out


def _operands(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
              attn: torch.Tensor):
    """loc and attn in f32 and contiguous, everything validated as the
    main-path kernel's wrapper validates it."""
    if value.device.type != "cuda":
        raise ValueError(f"unsupported device {value.device}")
    loc = loc.float().contiguous()
    attn = attn.float().contiguous()
    _check(value, shapes, loc, attn)
    B, S, H, D = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    return loc, attn, (B, S, Q, H, D, L, P)


def _check_rows(name: str, value: torch.Tensor, rows: str) -> None:
    """What a kernel's row loads need. "vec16": 16-byte loads, so a row is
    a multiple of 16 bytes, at most 512, on a 16-byte boundary (v7).
    "pairs": the study interface's rule that nocy keeps, D even and at most
    64 and value on a two-element boundary."""
    D, esize = value.shape[3], value.element_size()
    row_bytes = D * esize
    if rows == "vec16" and (row_bytes % 16 or row_bytes > 512 or
                            value.data_ptr() % 16):
        raise ValueError(f"{name} needs rows of a multiple of 16 bytes, at "
                         f"most 512, 16-byte aligned; D={D} in {value.dtype} "
                         f"is {row_bytes} bytes at offset "
                         f"{value.data_ptr() % 16}")
    if rows == "pairs" and (D % 2 or D > 64 or
                            value.data_ptr() % (2 * esize)):
        raise ValueError(f"{name} needs an even D of at most 64 on a "
                         f"two-element boundary; got D={D} at offset "
                         f"{value.data_ptr() % (2 * esize)} bytes")


def _native_layout(name: str, counter: Callable, value, shapes, loc, attn,
                   TQ: int, rows: str = "", extra: Tuple[int, ...] = (),
                   ws_floats: int = 0, tiled: bool = True):
    """A variant that reads the operands as they are. Returns (launch,
    finish): `launch()` runs only the kernel, `finish(out)` gives the
    [B,Q,H·D] result. `rows`: the kernel's row rule (`_check_rows`);
    `ws_floats`: an f32 workspace of that many elements, allocated for each
    launch; `tiled`: as `_check_grid`, a tile with all heads."""
    loc, attn, dims = _operands(value, shapes, loc, attn)
    _check_grid(value, loc, TQ, tiled, heads_in_block=True)
    _check_rows(name, value, rows)
    B, _, Q, H, D = dims[:5]

    def launch():
        out = torch.empty(B, Q, H * D, dtype=value.dtype, device=value.device)
        ws = torch.empty(ws_floats, dtype=torch.float32,
                         device=value.device) if ws_floats else None
        return _c_launch(name, counter, value, shapes, loc, attn, out, dims,
                         TQ, extra, ws)
    return launch, lambda out: out


def _head_major(name: str, counter: Callable, value, shapes, loc, attn,
                TQ: int, rows: str = "", tiled: bool = True):
    """A variant on head-major operands: value [B,H,S,D], loc
    [B,H,Q,L,P,2], attn [B,H,Q,L,P], each a transposed copy. Returns
    (launch, finish): `launch()` runs only the kernel and gives [B,H,Q,D];
    `finish(out)` transposes it back to [B,Q,H·D]. `rows` as in
    `_native_layout`; `tiled`: as `_check_grid`, a tile with one head."""
    loc, attn, dims = _operands(value, shapes, loc, attn)
    _check_grid(value, loc, TQ, tiled, heads_in_block=False)
    B, _, Q, H, D = dims[:5]
    value_hm = value.permute(0, 2, 1, 3).contiguous()
    _check_rows(name, value_hm, rows)
    loc_hm = loc.permute(0, 2, 1, 3, 4, 5).contiguous()
    attn_hm = attn.permute(0, 2, 1, 3, 4).contiguous()

    def launch():
        out = torch.empty(B, H, Q, D, dtype=value.dtype, device=value.device)
        return _c_launch(name, counter, value_hm, shapes, loc_hm, attn_hm,
                         out, dims, TQ)

    def finish(out):
        return out.permute(0, 2, 1, 3).reshape(B, Q, H * D)
    return launch, finish


def prepare_v1(value, shapes, loc, attn, TQ=64):
    """v1 needs no layout preparation and tiles nothing
    (`_native_layout`)."""
    return _native_layout("ms_deform_attn_fwd_v1", fwd_v1, value, shapes, loc,
                          attn, TQ, tiled=False)


def prepare_v2(value, shapes, loc, attn, TQ=64):
    """v2's layout preparation (`_head_major`); its kernel runs one warp
    per (b, h, q) and tiles nothing."""
    return _head_major("ms_deform_attn_fwd_v2", fwd_v2, value, shapes, loc,
                       attn, TQ, tiled=False)


def prepare_v3(value, shapes, loc, attn, TQ=64):
    """v3 needs no layout preparation and tiles nothing
    (`_native_layout`)."""
    return _native_layout("ms_deform_attn_fwd_v3", fwd_v3, value, shapes, loc,
                          attn, TQ, tiled=False)


def prepare_v45(value, shapes, loc, attn, TQ=64, compact_cy=True):
    """v4 (`compact_cy`) and v5 need no layout preparation and tile
    nothing (`_native_layout`)."""
    return _native_layout("ms_deform_attn_fwd_v45", fwd_v45, value, shapes,
                          loc, attn, TQ, extra=(int(bool(compact_cy)),),
                          tiled=False)


def prepare_nocy(value, shapes, loc, attn, TQ=64):
    """The nocy ablation needs no layout preparation, but an even D of at
    most 64 (`_native_layout`), and the workspace its kernel sums every
    level's columns into: f32 [B,H,sum of W_l,D]. The sampler hands a
    warp's points out by shuffles, so L*P is at most 64."""
    B, _, H, D = value.shape
    if loc.dim() == 6 and loc.shape[3] * loc.shape[4] > MAX_LP:
        raise ValueError(f"ms_deform_attn_fwd_nocy takes L*P <= {MAX_LP}, "
                         f"got {loc.shape[3] * loc.shape[4]}")
    return _native_layout("ms_deform_attn_fwd_nocy", fwd_nocy, value, shapes,
                          loc, attn, TQ, rows="pairs",
                          ws_floats=B * H * sum(int(w) for _, w in shapes) * D)


def prepare_v6(value, shapes, loc, attn, TQ=64):
    """v6 needs no layout preparation and tiles nothing
    (`_native_layout`)."""
    return _native_layout("ms_deform_attn_fwd_v6", fwd_v6, value, shapes,
                          loc, attn, TQ, tiled=False)


def prepare_v7(value, shapes, loc, attn, TQ=64):
    """v7's layout preparation is v2's (`_head_major`), with rows its
    16-byte loads can take."""
    return _head_major("ms_deform_attn_fwd_v7", fwd_v7, value, shapes, loc,
                       attn, TQ, rows="vec16")


def prepare_v8(value, shapes, loc, attn, TQ=128):
    """v8 needs no layout preparation and tiles nothing (`_native_layout`);
    the kernel matches a level's 2P candidate rows in the lanes of a warp,
    so P is at most 8."""
    if loc.shape[4] > V8_MAX_POINTS:
        raise ValueError(f"ms_deform_attn_fwd_v8 takes at most "
                         f"{V8_MAX_POINTS} points, got {loc.shape[4]}")
    return _native_layout("ms_deform_attn_fwd_v8", fwd_v8, value, shapes, loc,
                          attn, TQ, tiled=False)


def _run(prepare, plain, value, shapes, loc, attn, TQ, **kw):
    if value.device.type == "cpu":
        return plain(value, shapes, loc, attn, TQ, **kw)
    launch, finish = prepare(value, shapes, loc, attn, TQ, **kw)
    return finish(launch())


def fwd_v1(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
           attn: torch.Tensor, TQ: int = 64) -> torch.Tensor:
    """Variant v1. CPU tensor: `fwd_v1_torch`. CUDA tensor: the kernel
    `csrc/ms_deform_attn_fwd_v1.cu`, or an exception; never the plain
    version. `fwd_v1.launches` counts launches."""
    return _run(prepare_v1, fwd_v1_torch, value, shapes, loc, attn, TQ)


def fwd_v2(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
           attn: torch.Tensor, TQ: int = 64) -> torch.Tensor:
    """Variant v2, its head-major transposes included. CPU tensor:
    `fwd_v2_torch`. CUDA tensor: the kernel
    `csrc/ms_deform_attn_fwd_v2.cu`, or an exception (D over 128 or L·P
    over 64 raises); never the plain version. `fwd_v2.launches` counts
    launches."""
    return _run(prepare_v2, fwd_v2_torch, value, shapes, loc, attn, TQ)


def fwd_v3(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
           attn: torch.Tensor, TQ: int = 64) -> torch.Tensor:
    """Variant v3. CPU tensor: `fwd_v3_torch`. CUDA tensor: the kernel
    `csrc/ms_deform_attn_fwd_v3.cu`, or an exception (D over 128 or L·P
    over 64 raises); never the plain version. `fwd_v3.launches` counts
    launches."""
    return _run(prepare_v3, fwd_v3_torch, value, shapes, loc, attn, TQ)


def fwd_v45(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
            attn: torch.Tensor, TQ: int = 64,
            compact_cy: bool = True) -> torch.Tensor:
    """Variants v4 (`compact_cy`) and v5. CPU tensor: `fwd_v45_torch`. CUDA
    tensor: the kernel `csrc/ms_deform_attn_fwd_v45.cu`, or an exception
    (D over 128 or L·P over 64 raises); never the plain version.
    `fwd_v45.launches` counts launches."""
    return _run(prepare_v45, fwd_v45_torch, value, shapes, loc, attn, TQ,
                compact_cy=compact_cy)


def fwd_nocy(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
             attn: torch.Tensor, TQ: int = 64) -> torch.Tensor:
    """The nocy ablation (wrong on purpose). CPU tensor: `fwd_nocy_torch`.
    CUDA tensor: the kernel `csrc/ms_deform_attn_fwd_nocy.cu`, or an
    exception (an odd D or one over 64 raises); never the plain version.
    `fwd_nocy.launches` counts launches."""
    return _run(prepare_nocy, fwd_nocy_torch, value, shapes, loc, attn, TQ)


def fwd_v6(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
           attn: torch.Tensor, TQ: int = 64) -> torch.Tensor:
    """Variant v6. CPU tensor: `fwd_v6_torch`. CUDA tensor: the kernel
    `csrc/ms_deform_attn_fwd_v6.cu`, or an exception, as `fwd_v45`; never
    the plain version. `fwd_v6.launches` counts launches."""
    return _run(prepare_v6, fwd_v6_torch, value, shapes, loc, attn, TQ)


def fwd_v7(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
           attn: torch.Tensor, TQ: int = 64) -> torch.Tensor:
    """Variant v7, its head-major transposes included. CPU tensor:
    `fwd_v7_torch`. CUDA tensor: the kernel `csrc/ms_deform_attn_fwd_v7.cu`,
    or an exception (a row that is not a multiple of 16 bytes raises);
    never the plain version. `fwd_v7.launches` counts launches."""
    return _run(prepare_v7, fwd_v7_torch, value, shapes, loc, attn, TQ)


def fwd_v8(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
           attn: torch.Tensor, TQ: int = 128) -> torch.Tensor:
    """Variant v8. CPU tensor: `fwd_v8_torch`. CUDA tensor: the kernel
    `csrc/ms_deform_attn_fwd_v8.cu`, or an exception (more than 8 points
    raises); never the plain version. `fwd_v8.launches` counts launches."""
    return _run(prepare_v8, fwd_v8_torch, value, shapes, loc, attn, TQ)


fwd_v1.launches = 0
fwd_v2.launches = 0
fwd_v3.launches = 0
fwd_v45.launches = 0
fwd_nocy.launches = 0
fwd_v6.launches = 0
fwd_v7.launches = 0
fwd_v8.launches = 0
