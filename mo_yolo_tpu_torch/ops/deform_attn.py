"""Multi-scale deformable attention: the plain PyTorch sampler and its
gradient, and the wrappers of their CUDA kernels (counterpart of
`mo_yolo_tpu/ops/deform_attn.py` and `mo_yolo_tpu/ops/deform_attn_pallas.py`).

Semantics follow `grid_sample(mode='bilinear', padding_mode='zeros',
align_corners=False)` per level, then an attention-weighted sum over
levels and points:

    out[b,q,h,:] = Σ_l Σ_p attn[b,q,h,l,p] ·
                   bilinear(V_l[b,:,:,h,:], loc_x·W_l − 0.5, loc_y·H_l − 0.5)

Shapes: value [B,S,H,D] (S = Σ h·w), loc [B,Q,H,L,P,2] in [0, 1],
attn [B,Q,H,L,P]; output [B,Q,H·D] in the value dtype. loc and attn are
held in f32 whatever the value dtype, and sums accumulate in f32 (f64 for
f64 inputs, which only the plain versions take).

On the card `ms_deform_attn` launches K1 (`csrc/ms_deform_attn_fwd.cu`);
where autograd needs it, through `MSDeformAttnFunction`, whose backward is
K2 (`csrc/ms_deform_attn_bwd.cu`), so the sampler trains like its plain
version. `ms_deform_attn_backward_rows_torch` is K2's design (corners
sorted by the d_value row they land on and by slot within a row, each row
summed once in that order) in plain tensor ops.
`ms_deform_attn_onehot_torch` is the one-hot-matmul route of the JAX
package (`ms_deform_attn_onehot`), plain tensor code on any device.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from mo_yolo_tpu_torch.utils import cuda_build

Shapes = Sequence[Tuple[int, int]]

# dtype codes of the C entry point (`csrc/ms_deform_attn_fwd.cu`)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_LEVELS = 8
# K1 and K2 carry a row of at most MAX_D elements in a warp, and a warp's
# L*P points in two registers a lane
MAX_D, MAX_LP = 128, 64
# K2 sorts a long d_value row's corners by their point q*P + p in a bit set
# of this many points
MAX_BWD_POINTS = 4096


# corner c = (dx, dy): bilinear weight (1-tx|tx)·(1-ty|ty)
_CORNERS = ((0, 0), (1, 0), (0, 1), (1, 1))


def _corners(loc_l: torch.Tensor, h: int, w: int):
    """Corner indices and bilinear weights at one level.

    loc_l [...,2] -> (flat index [...,4] long, in-bounds mask [...,4],
    weights [...,4] with 0 outside the map, tx, ty)."""
    x = loc_l[..., 0] * w - 0.5
    y = loc_l[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    idx, inbs, wts = [], [], []
    for dx, dy in _CORNERS:
        ix, iy = x0 + dx, y0 + dy
        inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        # the bounds test runs on floats, so NaN or inf coordinates fall
        # outside, as in the JAX oracle; index 0 stands in for them
        flat = torch.where(inb, iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1),
                           torch.zeros_like(ix))
        wx = tx if dx else 1 - tx
        wy = ty if dy else 1 - ty
        idx.append(flat.long())
        inbs.append(inb)
        wts.append(torch.where(inb, wx * wy, torch.zeros_like(wx)))
    return (torch.stack(idx, -1), torch.stack(inbs, -1), torch.stack(wts, -1),
            tx, ty)


def _gather_corners(value_l: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """value_l [B,hw,H,D]; idx [B,Q,H,P,4] -> corner rows [B,H,Q,P,4,D]."""
    B, _, H, D = value_l.shape
    Q, P = idx.shape[1], idx.shape[3]
    v = value_l.permute(0, 2, 1, 3)                           # [B,H,hw,D]
    flat_idx = idx.permute(0, 2, 1, 3, 4).reshape(B, H, Q * P * 4, 1)
    g = torch.gather(v, 2, flat_idx.expand(B, H, Q * P * 4, D))
    return g.reshape(B, H, Q, P, 4, D)


def _sample_level(value_l: torch.Tensor, loc_l: torch.Tensor, h: int,
                  w: int) -> torch.Tensor:
    """Bilinear zero-padded sampling at one level.

    value_l [B,h*w,H,D]; loc_l [B,Q,H,P,2]. Returns [B,Q,H,P,D]."""
    idx, _, wts, _, _ = _corners(loc_l, h, w)
    g = _gather_corners(value_l, idx)
    out = (g * wts.permute(0, 2, 1, 3, 4)[..., None]).sum(4)  # [B,H,Q,P,D]
    return out.permute(0, 2, 1, 3, 4)


def _acc_dtype(*ts: torch.Tensor) -> torch.dtype:
    """f32, or f64 when an input is f64."""
    return torch.float64 if any(t.dtype == torch.float64 for t in ts) \
        else torch.float32


def ms_deform_attn_torch(value: torch.Tensor, shapes: Shapes,
                         loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """The plain sampler (port of `ms_deform_attn_xla`): four-corner gather
    and lerp in f32, output in the value dtype."""
    B, S, H, D = value.shape
    Q = loc.shape[1]
    if sum(h * w for h, w in shapes) != S:
        raise ValueError(f"level shapes {tuple(shapes)} do not sum to S={S}")
    acc = _acc_dtype(value, loc, attn)
    loc = loc.to(acc)
    attn = attn.to(acc)
    v32 = value.to(acc)
    out = torch.zeros(B, Q, H, D, dtype=acc, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        sampled = _sample_level(v32[:, start:start + h * w], loc[:, :, :, lvl],
                                h, w)
        start += h * w
        out = out + (sampled * attn[:, :, :, lvl, :, None]).sum(3)
    return out.reshape(B, Q, H * D).to(value.dtype)


def hat_weights(coord: torch.Tensor, n: int) -> torch.Tensor:
    """Hat-function weights relu(1 - |coord - c|) of a pixel coordinate
    against the n positions c = 0..n-1 of an axis: the two bilinear taps,
    and zero outside [0, n-1], which gives the zero padding.
    coord [...] f32 -> [..., n] f32."""
    c = torch.arange(n, dtype=torch.float32, device=coord.device)
    return (1.0 - (coord[..., None] - c).abs()).clamp_min(0.0)


def ms_deform_attn_onehot_torch(value: torch.Tensor, shapes: Shapes,
                                loc: torch.Tensor, attn: torch.Tensor
                                ) -> torch.Tensor:
    """The one-hot-matmul route (port of `ms_deform_attn_onehot`): plain
    PyTorch, no kernel, the way the JAX package samples on an accelerator.

    Bilinear sampling is separable. Per level every (query, point) row
    builds a two-tap hat-function row over the level's W axis with the
    attention weight folded in; one batched matrix product over all heads
    takes the x taps; the y taps apply as a hat mask over the level's rows
    and a sum. Hat weights vanish outside [0, N-1], which gives the zero
    padding. The arithmetic order is the JAX function's: hat weights times
    attn in f32, cast to the value dtype, a product whose result is in the
    value dtype, the y mask in the value dtype, an f32 y-sum, an f32 point
    sum. The y mask is built per row of the map and broadcast over D, where
    the JAX function builds it per column of the [R, Hl*D] product: the same
    values. Being plain tensor code, autograd gives its gradient."""
    B, S, H, D = value.shape
    Q, P = loc.shape[1], loc.shape[4]
    L = len(shapes)
    if sum(h * w for h, w in shapes) != S:
        raise ValueError(f"level shapes {tuple(shapes)} do not sum to S={S}")
    cdtype = value.dtype
    R = Q * P
    # rows r = q*P + p, head-major: [B,H,R,L,...]
    locr = loc.float().permute(0, 2, 1, 4, 3, 5).reshape(B, H, R, L, 2)
    attnr = attn.float().permute(0, 2, 1, 4, 3).reshape(B, H, R, L)
    out = torch.zeros(B, H, R, D, dtype=torch.float32, device=value.device)
    off = 0
    for lvl, (hl, wl) in enumerate(shapes):
        v = value[:, off:off + hl * wl].reshape(B, hl, wl, H, D)
        off += hl * wl
        v = v.permute(0, 3, 2, 1, 4).reshape(B, H, wl, hl * D)
        x = locr[..., lvl, 0] * wl - 0.5                       # [B,H,R]
        y = locr[..., lvl, 1] * hl - 0.5
        cx = (hat_weights(x, wl) * attnr[..., lvl, None]).to(cdtype)
        cy = hat_weights(y, hl).to(cdtype)                     # [B,H,R,hl]
        t = torch.matmul(cx, v)                                # [B,H,R,hl*D]
        u = t.view(B, H, R, hl, D) * cy[..., None]
        out = out + u.sum(3, dtype=torch.float32)              # y-sum
    out = out.view(B, H, Q, P, D).sum(3)                       # point sum
    return out.permute(0, 2, 1, 3).reshape(B, Q, H * D).to(cdtype)


def ms_deform_attn_backward_torch(value: torch.Tensor, shapes: Shapes,
                                  loc: torch.Tensor, attn: torch.Tensor,
                                  grad_out: torch.Tensor):
    """The plain gradient of the sampler (the function of the TPU kernel
    `_bwd_kernel`), step by step: a four-corner gather, the dot products
    <g, v_corner>, then a scatter_add of g·attn·w_corner into d_value.

    grad_out [B,Q,H·D]. Returns (d_value [B,S,H,D] in the value dtype,
    d_loc [B,Q,H,L,P,2] and d_attn [B,Q,H,L,P] in f32, or f64 for f64
    inputs)."""
    B, S, H, D = value.shape
    Q = loc.shape[1]
    acc = _acc_dtype(value, loc, attn)
    loc = loc.to(acc)
    attn = attn.to(acc)
    v = value.to(acc)
    g = grad_out.to(acc).reshape(B, Q, H, D).permute(0, 2, 1, 3)  # [B,H,Q,D]
    d_value = torch.zeros(B, H, S, D, dtype=acc, device=value.device)
    d_loc = torch.zeros_like(loc)
    d_attn = torch.zeros_like(attn)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        idx, inb, wts, tx, ty = _corners(loc[:, :, :, lvl], h, w)
        rows = _gather_corners(v[:, start:start + h * w], idx)  # [B,H,Q,P,4,D]
        dot = (rows * g[:, :, :, None, None, :]).sum(-1)        # [B,H,Q,P,4]
        dot = dot.permute(0, 2, 1, 3, 4) * inb                  # [B,Q,H,P,4]
        a = attn[:, :, :, lvl]                                  # [B,Q,H,P]
        d_attn[:, :, :, lvl] = (wts * dot).sum(-1)
        dw = a[..., None] * dot
        # d w_c / d tx and d w_c / d ty for the corners (0,0),(1,0),(0,1),(1,1)
        dtx = torch.stack([-(1 - ty), 1 - ty, -ty, ty], -1)
        dty = torch.stack([-(1 - tx), -tx, 1 - tx, tx], -1)
        d_loc[:, :, :, lvl, :, 0] = (dw * dtx).sum(-1) * w
        d_loc[:, :, :, lvl, :, 1] = (dw * dty).sum(-1) * h
        contrib = g[:, :, :, None, None, :] * \
            (a[..., None] * wts).permute(0, 2, 1, 3, 4)[..., None]
        flat = idx.permute(0, 2, 1, 3, 4).reshape(B, H, -1, 1) + start
        d_value.scatter_add_(2, flat.expand(-1, -1, -1, D),
                             contrib.reshape(B, H, -1, D))
        start += h * w
    return (d_value.permute(0, 2, 1, 3).to(value.dtype).contiguous(),
            d_loc, d_attn)


def ms_deform_attn_backward_rows_torch(value: torch.Tensor, shapes: Shapes,
                                       loc: torch.Tensor, attn: torch.Tensor,
                                       grad_out: torch.Tensor):
    """K2's design in plain tensor ops: the same gradient as
    `ms_deform_attn_backward_torch`, computed the way the kernel computes
    it, with its intermediates.

    Every corner slot c (B·Q·H·L·P·4 of them, in the order (b, q, h, l, p,
    corner), corner (dx, dy) = (c & 1, c >> 1)) gets key[c], the d_value
    row (b·S + s)·H + h it lands on or -1 outside the map, and aw[c] =
    attn·wx·wy; <g, v_corner> gives d_attn and d_loc. The rows' counts
    (`bincount`), their exclusive prefix sum `start` (`cumsum`) and the
    slots sorted by row (`ids`, a stable `argsort`, so each row's list
    ascends by slot: the order K2 sums it in) make the CSR lists; each
    row's d_value is the sum of g[c // (L·P·4)]·aw[c] over its list, and a
    row with an empty list is zero.

    Returns (d_value, d_loc, d_attn, rows): the gradient as
    `ms_deform_attn_backward_torch` returns it, and rows = {"key": int32
    [B,Q,H,L,P,4], "aw": [B,Q,H,L,P,4], "counts": int32 [B·S·H], "start":
    int32 [B·S·H + 1], "ids": int64 [start[-1]]}."""
    B, S, H, D = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    if sum(h * w for h, w in shapes) != S:
        raise ValueError(f"level shapes {tuple(shapes)} do not sum to S={S}")
    acc = _acc_dtype(value, loc, attn)
    loc = loc.to(acc)
    attn = attn.to(acc)
    dev = value.device
    keys, tys, txs, wts = [], [], [], []
    bi = torch.arange(B, device=dev)[:, None, None, None, None]
    hi = torch.arange(H, device=dev)[None, None, :, None, None]
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        idx, inb, wt, tx, ty = _corners(loc[:, :, :, lvl], h, w)  # [B,Q,H,P,4]
        keys.append(torch.where(inb, (bi * S + start + idx) * H + hi, -1))
        wts.append(wt)
        txs.append(tx)
        tys.append(ty)
        start += h * w
    key = torch.stack(keys, 3)                     # [B,Q,H,L,P,4]
    wt = torch.stack(wts, 3)
    tx, ty = torch.stack(txs, 3), torch.stack(tys, 3)   # [B,Q,H,L,P]
    aw = attn[..., None] * wt
    # <g, v_corner> for every slot, 0 outside the map
    g = grad_out.to(acc).reshape(B * Q * H, D)
    inb = key >= 0
    rows = value.to(acc).reshape(B * S * H, D)[key.clamp_min(0).reshape(-1)]
    gq = g.repeat_interleave(L * P * 4, 0)
    dot = ((rows * gq).sum(-1).view(key.shape)) * inb
    d_attn = (wt * dot).sum(-1)
    dw = attn[..., None] * dot
    dtx = torch.stack([-(1 - ty), 1 - ty, -ty, ty], -1)
    dty = torch.stack([-(1 - tx), -tx, 1 - tx, tx], -1)
    scale = torch.tensor([[float(w), float(h)] for h, w in shapes],
                         dtype=acc, device=dev)[:, None, :]      # [L,1,2]
    d_loc = torch.stack([(dw * dtx).sum(-1), (dw * dty).sum(-1)], -1) * scale
    # the CSR lists of the d_value rows
    flat = key.reshape(-1)
    counts = torch.bincount(flat[flat >= 0], minlength=B * S * H)
    starts = torch.zeros(B * S * H + 1, dtype=torch.long, device=dev)
    starts[1:] = torch.cumsum(counts, 0)
    n_in = int(starts[-1])
    big = torch.iinfo(torch.long).max
    ids = torch.argsort(torch.where(flat >= 0, flat.long(), big),
                        stable=True)[:n_in]
    contrib = aw.reshape(-1)[ids, None] * g[ids // (L * P * 4)]
    d_rows = torch.zeros(B * S * H, D, dtype=acc, device=dev)
    d_rows.index_add_(0, flat[ids].long(), contrib)
    d_value = d_rows.view(B, S, H, D).to(value.dtype)
    return d_value, d_loc, d_attn, {
        "key": key.int(), "aw": aw, "counts": counts.int(),
        "start": starts.int(), "ids": ids}


def _check(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
           attn: torch.Tensor) -> None:
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"value dtype {value.dtype} is not f32/bf16/fp16")
    if loc.dtype != torch.float32 or attn.dtype != torch.float32:
        raise TypeError("loc and attn must be float32")
    vs, ls = value.shape, loc.shape
    if len(vs) != 4 or len(ls) != 6 or attn.dim() != 5:
        raise ValueError("value [B,S,H,D], loc [B,Q,H,L,P,2], attn [B,Q,H,L,P]")
    B, S, H, D = vs
    L = len(shapes)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels are supported, got {L}")
    if ls[:4] != (B, ls[1], H, L) or ls[5] != 2 or attn.shape != ls[:5]:
        raise ValueError(f"shape mismatch: value {tuple(vs)}, loc "
                         f"{tuple(ls)}, attn {tuple(attn.shape)}, "
                         f"{L} levels")
    if _level_rows(shapes) != S:
        raise ValueError(f"level shapes {tuple(shapes)} do not sum to S={S}")
    if not (value.is_contiguous() and loc.is_contiguous() and
            attn.is_contiguous()):
        raise ValueError("value, loc and attn must be contiguous")
    if loc.device != value.device or attn.device != value.device:
        raise ValueError("value, loc and attn must be on one device")


# level shapes -> (S, the ctypes array of (h, w) pairs), made once a shape
_LEVELS: dict = {}


def _levels(shapes: Shapes):
    try:
        return _LEVELS[shapes]
    except (KeyError, TypeError):
        pass
    key = tuple((int(h), int(w)) for h, w in shapes)
    if key not in _LEVELS:
        flat = [v for hw in key for v in hw]
        _LEVELS[key] = (sum(h * w for h, w in key),
                        (ctypes.c_int * len(flat))(*flat))
    try:
        _LEVELS[shapes] = _LEVELS[key]
    except TypeError:      # a list of level shapes: not a key
        pass
    return _LEVELS[key]


def _level_rows(shapes: Shapes) -> int:
    return _levels(shapes)[0]


def _hw_array(shapes: Shapes):
    """The C entry points' level table: L pairs (h, w) as a ctypes array,
    made once for each level-shape tuple."""
    return _levels(shapes)[1]


def _check_kernel(value: torch.Tensor, loc: torch.Tensor) -> None:
    """What K1 and K2 take beyond `_check`."""
    D, LP = value.shape[3], loc.shape[3] * loc.shape[4]
    if D > MAX_D or LP > MAX_LP:
        raise ValueError(f"the kernels take D <= {MAX_D} and L*P <= "
                         f"{MAX_LP}, got D={D}, L*P={LP}")


# (value, loc and attn's shapes and dtypes, level shapes) -> the C entry
# points' shape block: checked once for each signature
_PLANS: dict = {}


def _plan(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
          attn: torch.Tensor):
    """Check the operands as `_check` and `_check_kernel` do and return
    (shape block, B, S, Q, H, D, L, P): the block is the C entry points'
    int array dtype code, B, S, Q, H, D, L, P and the L pairs (h, w).
    Shapes and dtypes are checked once for each signature, contiguity and
    device on every call: the sampler runs for less time than its wrapper
    takes on the host."""
    try:
        key = (value.shape, value.dtype, loc.shape, loc.dtype, attn.shape,
               attn.dtype, shapes)
        plan = _PLANS.get(key)
    except TypeError:       # a list of level shapes: not a key
        key, plan = None, None
    if plan is None:
        _check(value, shapes, loc, attn)
        _check_kernel(value, loc)
        B, S, H, D = value.shape
        _, Q, _, L, P, _ = loc.shape
        dims = [_DTYPE_CODE[value.dtype], B, S, Q, H, D, L, P] + \
            list(_hw_array(shapes))
        plan = ((ctypes.c_int * len(dims))(*dims), B, S, Q, H, D, L, P)
        if key is not None:
            _PLANS[key] = plan
    elif not (value.is_contiguous() and loc.is_contiguous() and
              attn.is_contiguous()) or \
            loc.get_device() != value.get_device() or \
            attn.get_device() != value.get_device():
        _check(value, shapes, loc, attn)        # raises what is wrong
    return plan


_FWD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int),
                                     ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_int),
                                     ctypes.c_void_p]


def _launch(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
            attn: torch.Tensor, plan=None) -> torch.Tensor:
    fn = cuda_build.entry("ms_deform_attn_fwd", "ms_deform_attn_fwd",
                          _FWD_ARGS)
    if plan is None:
        plan = _plan(value, shapes, loc, attn)
    dims, B, _, Q, H, D = plan[:6]
    out = torch.empty(B, Q, H * D, dtype=value.dtype, device=value.device)
    err = cuda_build.call(fn, value, value.data_ptr(), loc.data_ptr(),
                          attn.data_ptr(), out.data_ptr(), dims)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn_fwd launch failed: CUDA error "
                           f"{err}")
    ms_deform_attn.launches += 1
    return out


# K2's workspace: (B, S, Q, H, D, L, P) -> (bytes, offsets of its parts)
_BWD_LAYOUT: dict = {}
_BWD_PARTS = ("key", "aw", "placed", "rec", "counts", "start", "partials",
              "carry_row", "carry")


def _bwd_layout(plan):
    sig = plan[1:]
    layout = _BWD_LAYOUT.get(sig)
    if layout is None:
        Q, P = plan[3], plan[7]
        if Q * P > MAX_BWD_POINTS:
            raise ValueError(f"ms_deform_attn_bwd sorts a d_value row's "
                             f"corners by point: Q*P <= {MAX_BWD_POINTS}, "
                             f"got {Q * P}")
        fn = cuda_build.entry(
            "ms_deform_attn_bwd", "ms_deform_attn_bwd_workspace",
            [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)],
            ctypes.c_longlong)
        offsets = (ctypes.c_longlong * len(_BWD_PARTS))()
        total = fn(plan[0], offsets)
        if total < 0:
            raise ValueError(f"ms_deform_attn_bwd does not take the shape "
                             f"(B, S, Q, H, D, L, P) = {plan[1:]}")
        layout = _BWD_LAYOUT[sig] = (total, tuple(offsets))
    return layout


def _launch_bwd(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
                attn: torch.Tensor, grad_out: torch.Tensor,
                rows: bool = False):
    """Launch K2. With `rows`, also return its intermediates: views of the
    workspace as `ms_deform_attn_backward_rows_torch` names them ("key",
    "counts", "start", and "ids", the slots of the sorted records, each
    row's in ascending order)."""
    fn = cuda_build.entry("ms_deform_attn_bwd", "ms_deform_attn_bwd",
                          _BWD_ARGS)
    plan = _plan(value, shapes, loc, attn)
    dims, B, S, Q, H, D, L, P = plan
    if grad_out.shape != (B, Q, H * D) or grad_out.dtype != value.dtype or \
            not grad_out.is_contiguous():
        raise ValueError(f"grad_out must be a contiguous {value.dtype} "
                         f"[{B},{Q},{H * D}], got {grad_out.dtype} "
                         f"{tuple(grad_out.shape)}")
    total, offsets = _bwd_layout(plan)
    # every d_value row is written once by the kernel: no zeroed buffer;
    # the scratch is one allocation, carved up by the entry point
    ws = torch.empty(total, dtype=torch.uint8, device=value.device)
    d_value = torch.empty(B, S, H, D, dtype=value.dtype, device=value.device)
    d_loc = torch.empty_like(loc)
    d_attn = torch.empty_like(attn)
    err = cuda_build.call(fn, value, value.data_ptr(), loc.data_ptr(),
                          attn.data_ptr(), grad_out.data_ptr(),
                          d_value.data_ptr(), d_loc.data_ptr(),
                          d_attn.data_ptr(), ws.data_ptr(), dims)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn_bwd launch failed: CUDA error "
                           f"{err}")
    ms_deform_attn_backward.launches += 1
    if not rows:
        return d_value, d_loc, d_attn
    at = dict(zip(_BWD_PARTS, offsets))
    n_slots, n_rows = B * Q * H * L * P * 4, B * S * H

    def part(name, n):
        return ws[at[name]:at[name] + 4 * n].view(torch.int32)
    start = part("start", n_rows + 1)
    return d_value, d_loc, d_attn, {
        "key": part("key", n_slots).view(B, Q, H, L, P, 4),
        "counts": part("counts", n_rows), "start": start,
        "ids": part("rec", 4 * int(start[-1])).view(-1, 4)[:, 0]}


class MSDeformAttnFunction(torch.autograd.Function):
    """The sampler with a kernel in each direction: K1 forward, K2 backward.
    Inputs are checked by the caller; loc and attn are f32. The launchers
    are looked up at call time, so a test can put the plain versions in
    their place and run this wiring on the CPU."""

    @staticmethod
    def forward(ctx, value, loc, attn, shapes):
        ctx.shapes = shapes
        ctx.save_for_backward(value, loc, attn)
        return _launch(value, shapes, loc, attn)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        d_value, d_loc, d_attn = _launch_bwd(
            value, ctx.shapes, loc, attn,
            grad_out.to(value.dtype).contiguous())
        return d_value, d_loc, d_attn, None


def ms_deform_attn(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
                   attn: torch.Tensor) -> torch.Tensor:
    """The sampler on the main path.

    On a CPU tensor it is the plain version. On a CUDA tensor it launches
    K1 (`csrc/ms_deform_attn_fwd.cu`) or raises; it never falls back. Where
    autograd needs the gradient it goes through `MSDeformAttnFunction`,
    whose backward launches K2; under `no_grad`, or when no input requires
    grad, it launches K1 directly. loc/attn are cast to f32 here, as the TPU
    kernel's `_forward` does. `ms_deform_attn.launches` counts K1
    launches."""
    if not value.is_cuda:
        if value.device.type == "cpu":
            return ms_deform_attn_torch(value, shapes, loc, attn)
        raise ValueError(f"unsupported device {value.device}")
    loc, attn = _f32(loc), _f32(attn)
    plan = _plan(value, shapes, loc, attn)
    if torch.is_grad_enabled() and (value.requires_grad or loc.requires_grad
                                    or attn.requires_grad):
        return MSDeformAttnFunction.apply(value, loc, attn, tuple(shapes))
    return _launch(value, shapes, loc, attn, plan)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """t as a contiguous f32 tensor, itself when it is one already."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.float().contiguous()


def ms_deform_attn_backward(value: torch.Tensor, shapes: Shapes,
                            loc: torch.Tensor, attn: torch.Tensor,
                            grad_out: torch.Tensor):
    """The sampler's gradient (d_value, d_loc, d_attn) for `grad_out`
    [B,Q,H·D]. On a CPU tensor it is the plain version; on a CUDA tensor it
    launches K2 or raises. `ms_deform_attn_backward.launches` counts K2
    calls (one per call, whatever number of device launches K2 makes)."""
    if not value.is_cuda:
        if value.device.type == "cpu":
            return ms_deform_attn_backward_torch(value, shapes, loc, attn,
                                                 grad_out)
        raise ValueError(f"unsupported device {value.device}")
    loc, attn = _f32(loc), _f32(attn)
    _plan(value, shapes, loc, attn)
    return _launch_bwd(value, shapes, loc, attn,
                       grad_out.to(value.dtype).contiguous())


ms_deform_attn.launches = 0
ms_deform_attn_backward.launches = 0
