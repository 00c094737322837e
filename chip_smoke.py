#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. card: name and power limit (`nvidia-smi`); exits non-zero without a card;
2. build: compiles every kernel of the paths from
   `mo_yolo_tpu_torch/ops/csrc` with nvcc (one process per source, all
   started together) and reports each instantiation's registers and spills
   from `ptxas -v`, holding S3-S6's kernels under K1's 112-register warning
   with at most 16 bytes of spill;
3. kernel: holds K1 (the sampler) against its plain PyTorch version at the
   streaming path's shapes, at a clustered case (728 queries, every point
   in [0.45, 0.55]) and at edge cases, and times both with CUDA events;
4. kernel_bwd: the same for K2 (the sampler's gradient) at the training
   path's shapes (728 queries: 128 denoising, 300 track slots, 300 detect),
   the clustered case and edge cases, in f32 and bf16; holds K2's
   intermediates (each corner slot's d_value row, the rows' counts and
   starts, the sorted slots) to the plain rows form exactly, checks that
   three calls and a CUDA-graph replay give the same gradient bit for bit,
   and times the plain rows form beside the plain gradient;
5. greedy: holds the greedy-suppression kernel (`greedy_keep`) exactly to
   its plain version at 4 streams of 600 (a frame's duplicates, random
   conflicts, a chain of depth 600, nothing valid, conflicts in both
   triangles) and times both at one stream;
6. kernel_variants: holds the study's kernels S2-S7 (`fwd_v1`, `fwd_v2`,
   `fwd_v3`, `fwd_v45` as v4 and v5, `fwd_nocy`, `fwd_v6`, `fwd_v7`,
   `fwd_v8`) against the plain sampler and their own plain versions at the
   study's inputs and at edge cases (odd D among them), with 64 and 128
   queries a block (and 256 for v7 and v8), the kernels on the main-path
   kernel's grid (all but nocy) also on clustered points (every point in
   [0.45, 0.55]) at 64, 128 and 256, v4 equal to v5 bit for bit in every
   case, and S1
   (`take_along_axis`) against `torch.gather`, exactly, also in its scalar
   forms; times each;
7. study: the sampler study through its entry points
   (`mo_yolo_tpu_torch.scripts.kernel_variants_bench.main(["--parity"])`,
   `micro_peak_bench`, `kernel_study_shapes`, `hbm_bw_bench`), one JSON
   line per variant and size, with the launch counts read around it;
8. slice: streaming tracking through `MOTRTrack(...).predict` at full
   `yolo_track` width, 1536x800 then 640x640, bf16, ~20 synthetic frames,
   with every kernel's launch count read around each run; then the same
   frames through `stream_step` with every host sync an error, and through
   one `stream_step` captured as a CUDA graph and replayed frame by frame,
   its outputs equal to the eager ones;
9. profile: where a frame's time goes at each size (host clock per stage,
   device kernel time and idle share from torch.profiler);
10. in_context: the same model at f32 and 640x640, with the kernel, with
   the plain sampler (`impl="torch"`) and with the one-hot route
   (`impl="onehot"`), holding boxes and ids to the plain sampler's;
11. train: the clip training step (`train.train_step.make_train_step`) at
   full `yolo_track` width, bf16 autocast, 1536x800, 5-frame synthetic
   clips with remat and the default AdamW: one warm-up and three timed
   steps (loss, grad norm, step time, frames/s, peak memory, kernel
   launches per step), then one profiled step, then `ClipOptimizer.step`
   with every host sync an error, the clip on and off;
12. train_in_context: one f32 step at 320x320 with the kernels, one with
   the plain sampler and one with the kernels without remat, holding the
   loss and every parameter's gradient.

Then a `kernels` line, the card's name and power limit, and as the last
line `{"ok": true, "device": {...}}`. Any failed check exits non-zero.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# the study's forward variants (S2-S7)
VARIANT_KERNELS = ("ms_deform_attn_fwd_v1", "ms_deform_attn_fwd_v2",
                   "ms_deform_attn_fwd_v3", "ms_deform_attn_fwd_v45",
                   "ms_deform_attn_fwd_nocy", "ms_deform_attn_fwd_v6",
                   "ms_deform_attn_fwd_v7", "ms_deform_attn_fwd_v8")
KERNELS = ["ms_deform_attn_fwd", "ms_deform_attn_bwd", "greedy_keep",
           "take_along_axis", *VARIANT_KERNELS]
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 CUDA-core flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# the main path's sampler shapes: B, Q (300 track slots + 300 queries),
# H, D, P and the level shapes at strides 8/16/32
B, Q, H, D, P = 1, 600, 8, 32, 4
LEVELS = {"1536x800": ((100, 192), (50, 96), (25, 48)),
          "640x640": ((80, 80), (40, 40), (20, 20))}
SCORE_BIAS = 0.3     # as the CPU stream test: keeps scores off 0.4 / 0.5
N_FRAMES, WARMUP = 20, 5
# the training path's queries: 128 denoising (num_denoising 100 at 64 padded
# GT rows gives one group of 2 x 64), 300 track slots, 300 detect queries
Q_TRAIN, MAX_GT = 728, 64
# every point in this range: training queries gather on a few objects, so
# a d_value row collects hundreds of corners
CLUSTERED = (0.45, 0.55)
CLIP_LEN, TRAIN_STEPS = 5, 3
# two 16-byte pieces a lane took K1 to this many registers a thread and
# ran it slower (fewer warps in flight); the kernels on K1's skeleton are
# held under it, with at most this many bytes of spill
REGISTER_WARNING, SPILL_LIMIT = 112, 16
REGISTER_HELD = ("ms_deform_attn_fwd_v2", "ms_deform_attn_fwd_v3",
                 "ms_deform_attn_fwd_v45", "ms_deform_attn_fwd_v6",
                 "ms_deform_attn_fwd_v7")


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ kernel

def sampler_inputs(levels, b=B, q=Q, h=H, d=D, p=P, dtype=None, seed=0,
                   device="cuda", loc_range=(-0.05, 1.05)):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    S = sum(a * c for a, c in levels)
    L = len(levels)
    value = torch.randn(b, S, h, d, generator=g)
    loc = torch.rand(b, q, h, L, p, 2, generator=g) * \
        (loc_range[1] - loc_range[0]) + loc_range[0]
    attn = torch.softmax(torch.randn(b, q, h, L * p, generator=g), -1)
    attn = attn.view(b, q, h, L, p)
    return (value.to(device=device, dtype=dtype or torch.float32), levels,
            loc.to(device), attn.to(device))


def touched(value, levels, loc):
    """(distinct value rows (b, h, s) that this data's in-bounds corners
    touch, number of in-bounds corners)."""
    import torch
    b, S, h, d = value.shape
    seen = torch.zeros(b, h, S, dtype=torch.bool, device=value.device)
    start, n_corner = 0, 0
    for l, (hl, wl) in enumerate(levels):
        x = loc[:, :, :, l, :, 0] * wl - 0.5
        y = loc[:, :, :, l, :, 1] * hl - 0.5
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            ix, iy = torch.floor(x) + dx, torch.floor(y) + dy
            inb = (ix >= 0) & (ix <= wl - 1) & (iy >= 0) & (iy <= hl - 1)
            s = (start + iy.clamp(0, hl - 1) * wl + ix.clamp(0, wl - 1)).long()
            bi = torch.arange(b, device=value.device)[:, None, None, None]
            hi = torch.arange(h, device=value.device)[None, None, :, None]
            seen[bi.expand_as(s)[inb], hi.expand_as(s)[inb], s[inb]] = True
            n_corner += int(inb.sum())
        start += hl * wl
    return int(seen.sum()), n_corner


def _roofline(nbytes, flops, **extra):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, **extra}


def bound(value, levels, loc, attn):
    """K1's least time on the card: bytes (value rows this data touches,
    each read once, plus loc, attn and the output) over HBM bandwidth, and
    flops (2 per corner value) over the f32 CUDA-core peak."""
    b, S, h, d = value.shape
    q = loc.shape[1]
    rows, n_corner = touched(value, levels, loc)
    esize = value.element_size()
    small = loc.numel() * 4 + attn.numel() * 4 + b * q * h * d * esize
    return _roofline(rows * d * esize + small, 2 * n_corner * d,
                     bound_ms_value_read_whole=(value.numel() * esize + small)
                     / PEAK_BYTES_PER_S * 1e3)


def bound_bwd(value, levels, loc, attn):
    """K2's least time on the card, counted as the function needs it:
    the touched value rows, g, loc and attn read once, the whole d_value,
    d_loc and d_attn written once; flops 4 per corner value (the dot
    <g, v> and g·a·w into d_value). `bound_ms_design` counts what this
    design moves instead, each stage's reads and writes once: dots reads
    the touched rows, g, loc and attn and writes d_loc, d_attn and each
    slot's key and aw (int32/f32); the counts and cursors are zeroed, the
    counts summed by tile and scanned into start; place reads key and aw
    and writes a 16-byte record (slot, row, aw) for each in-bounds slot;
    sort reads the records and writes them again, each row's in slot
    order; reduce reads the records and g again; every d_value row is
    written once (the carries of rows that cross reduce blocks are left
    out: at most one per block of 512 slots)."""
    b, S, h, d = value.shape
    q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    rows, n_corner = touched(value, levels, loc)
    esize = value.element_size()
    g = b * q * h * d * esize
    meta = (loc.numel() + attn.numel()) * 4 * 2         # read, then d_ written
    nbytes = rows * d * esize + g + meta + value.numel() * esize
    n_slots, n_rows = b * q * h * L * P * 4, b * S * h
    design = (rows * d * esize + 2 * g + meta + value.numel() * esize
              + n_slots * 4 * (2 + 2)        # key/aw written, then read
              + n_corner * 16 * 4            # records placed, sorted
              + n_rows * 4 * 5)              # counts, cursors zeroed; the
                                             # counts summed, scanned; start
    return _roofline(nbytes, 4 * n_corner * d,
                     bound_ms_design=design / PEAK_BYTES_PER_S * 1e3,
                     bytes_design=design)


def ptxas_usage(log: str):
    """Each entry function's registers and spill bytes from `ptxas -v`."""
    out, current, props = [], None, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            current = {"function": m.group(1)}
            out.append(current)
            continue
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and current is not None and props == current["function"]:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    for rec in out:
        rec.setdefault("spill_stores", 0)
        rec.setdefault("spill_loads", 0)
        rec.setdefault("registers", 0)
    return out


def time_ms(fn, iters=200, warmup=20) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_time_ms(fn, iters=20):
    """The device's own time per call (the calls replayed from a CUDA
    graph): `time_ms` gives the slower of the host's launch path and the
    device."""
    import torch

    from mo_yolo_tpu_torch.scripts.timing import device_ms
    return device_ms(fn, iters, torch.device("cuda"))


def phase_kernel():
    """Hold the kernel against the plain version; time both. Returns the
    main-path record (1536x800, bf16)."""
    import torch

    from mo_yolo_tpu_torch.ops.deform_attn import (ms_deform_attn,
                                                   ms_deform_attn_torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    F32_ATOL = 1e-5
    BF16_TOL = 1e-2
    cases = []
    for name, levels in LEVELS.items():
        cases.append((f"main_{name}", dict(levels=levels)))
    small = ((12, 16), (6, 8), (3, 4))
    cases += [
        ("clustered", dict(levels=LEVELS["1536x800"], q=Q_TRAIN,
                           loc_range=CLUSTERED)),
        ("all_out_of_bounds", dict(levels=small, q=64, loc_range=(2.5, 3.5))),
        ("batch2", dict(levels=LEVELS["640x640"], b=2)),
        ("q77_h3", dict(levels=small, q=77, h=3)),
        ("d8", dict(levels=small, q=70, h=2, d=8)),
        ("d40", dict(levels=small, q=33, h=2, d=40)),
    ]
    results = {}
    for name, kw in cases:
        for dt in (torch.float32, torch.bfloat16):
            value, levels, loc, attn = sampler_inputs(dtype=dt, **kw)
            got = ms_deform_attn(value, levels, loc, attn)
            torch.cuda.synchronize()
            check(got.dtype == dt and got.shape == (value.shape[0],
                                                    loc.shape[1],
                                                    value.shape[2] *
                                                    value.shape[3]),
                  f"{name}: output {got.dtype} {tuple(got.shape)}")
            want = ms_deform_attn_torch(value.float(), levels, loc, attn)
            err = float((got.float() - want).abs().max())
            if dt == torch.float32:
                tol = F32_ATOL
                ok = err <= F32_ATOL
            else:
                tol = BF16_TOL
                ok = bool(((got.float() - want).abs() <=
                           BF16_TOL + BF16_TOL * want.abs()).all())
            if name == "all_out_of_bounds":
                ok = ok and not got.any()
            check(math.isfinite(err) and ok,
                  f"kernel {name} {dt}: max err {err} over tolerance {tol}")
            results[f"{name}/{str(dt)[6:]}"] = {"max_abs_err": err,
                                                "tol": tol}
    timing = {}
    for name, levels in LEVELS.items():
        for dt, label, kw in ((torch.bfloat16, "bfloat16", {}),
                              (torch.float32, "float32", {}),
                              (torch.bfloat16, "clustered/bfloat16",
                               dict(q=Q_TRAIN, loc_range=CLUSTERED))):
            value, levels_, loc, attn = sampler_inputs(levels, dtype=dt,
                                                       seed=1, **kw)
            ms = time_ms(lambda: ms_deform_attn(value, levels_, loc, attn))
            plain = time_ms(lambda: ms_deform_attn_torch(value, levels_, loc,
                                                         attn), iters=20,
                            warmup=3)
            timing[f"{name}/{label}"] = {
                "ms": ms, "plain_ms": plain,
                "device_ms": device_time_ms(
                    lambda: ms_deform_attn(value, levels_, loc, attn)),
                **bound(value, levels_, loc, attn)}
    emit("kernel", checks=results, timing=timing)
    main = timing["1536x800/bfloat16"]
    return {**main, "max_abs_err":
            results["main_1536x800/bfloat16"]["max_abs_err"]}


def _rel_err(got, want):
    """max |got - want| over max(1, max |want|): the tensor's own scale."""
    return float((got.float() - want).abs().max()) / \
        max(1.0, float(want.abs().max()))


def phase_kernel_bwd():
    """Hold K2 against the plain gradient at the training path's shapes and
    at edge cases; time both. Returns the main-path record (1536x800,
    bf16).

    Tolerances, each relative to the largest magnitude of the tensor:
    f32 d_loc and d_attn 1e-5 (another summation order over D); f32
    d_value 1e-4 (a row's corners are summed in another order than the
    plain version's `index_add_`); bf16 1e-2 (one bf16 rounding of d_value
    and of the inputs' products). The intermediates (each corner slot's
    key, the rows' counts and starts, the slots in row and slot order)
    exactly, and the gradient of three calls and of a CUDA-graph replay on
    the same inputs bit for bit."""
    import torch

    from mo_yolo_tpu_torch.ops.deform_attn import (
        _launch_bwd, ms_deform_attn_backward, ms_deform_attn_backward_rows_torch,
        ms_deform_attn_backward_torch)
    from mo_yolo_tpu_torch.scripts.k2_bench import stages_ms
    torch.backends.cuda.matmul.allow_tf32 = False
    small = ((12, 16), (6, 8), (3, 4))
    cases = [(f"main_{name}", dict(levels=levels, q=Q_TRAIN))
             for name, levels in LEVELS.items()]
    cases += [
        ("clustered", dict(levels=LEVELS["1536x800"], q=Q_TRAIN,
                           loc_range=CLUSTERED)),
        ("all_out_of_bounds", dict(levels=small, q=64, loc_range=(2.5, 3.5))),
        ("batch2", dict(levels=LEVELS["640x640"], b=2, q=Q_TRAIN)),
        ("q77_h3", dict(levels=small, q=77, h=3)),
        ("d8", dict(levels=small, q=70, h=2, d=8)),
        ("d40", dict(levels=small, q=33, h=2, d=40)),
    ]
    results = {}
    for name, kw in cases:
        for dt in (torch.float32, torch.bfloat16):
            value, levels, loc, attn = sampler_inputs(dtype=dt, **kw)
            g = torch.randn(value.shape[0], loc.shape[1],
                            value.shape[2] * value.shape[3],
                            generator=torch.Generator().manual_seed(7)
                            ).to(value.device, dt)
            got = ms_deform_attn_backward(value, levels, loc, attn, g)
            torch.cuda.synchronize()
            want = ms_deform_attn_backward_torch(value.float(), levels, loc,
                                                 attn, g.float())
            check(got[0].dtype == dt and got[1].dtype == got[2].dtype ==
                  torch.float32, f"K2 {name}: output dtypes")
            errs = {k: _rel_err(a, w) for k, a, w in
                    zip(("d_value", "d_loc", "d_attn"), got, want)}
            tols = ({"d_value": 1e-4, "d_loc": 1e-5, "d_attn": 1e-5}
                    if dt == torch.float32 else
                    {"d_value": 1e-2, "d_loc": 1e-2, "d_attn": 1e-2})
            for k, e in errs.items():
                check(math.isfinite(e) and e <= tols[k],
                      f"K2 {name} {dt} {k}: error {e} over {tols[k]}")
            if name == "all_out_of_bounds":
                check(not any(t.any() for t in got),
                      f"K2 {name}: a gradient is not zero")
            results[f"{name}/{str(dt)[6:]}"] = {
                "max_abs_err": max(float((a.float() - w).abs().max())
                                   for a, w in zip(got, want)),
                "rel_err": errs, "tol": tols}
    # the intermediates, exactly, at a small shape and a clustered one
    rows_checks = {}
    for name, kw in (("q77_h3", dict(levels=small, q=77, h=3)),
                     ("clustered_640x640", dict(levels=LEVELS["640x640"],
                                                q=Q_TRAIN,
                                                loc_range=CLUSTERED))):
        value, levels, loc, attn = sampler_inputs(**kw)
        g = torch.randn(value.shape[0], loc.shape[1],
                        value.shape[2] * value.shape[3],
                        generator=torch.Generator().manual_seed(8)
                        ).to(value.device)
        *_, rows = _launch_bwd(value, levels, loc, attn, g, rows=True)
        *_, want = ms_deform_attn_backward_rows_torch(value, levels, loc,
                                                      attn, g)
        for k in ("key", "counts", "start"):
            check(torch.equal(rows[k], want[k]),
                  f"K2 {name}: {k} differs from the plain rows form")
        check(torch.equal(rows["ids"].long(), want["ids"]),
              f"K2 {name}: ids are not the in-bounds slots in row and slot "
              f"order")
        rows_checks[name] = {"slots": rows["key"].numel(),
                             "in_bounds": int(want["start"][-1]),
                             "longest_row": int(want["counts"].max()),
                             "exact": ["key", "counts", "start", "ids"]}
    # the same inputs give the same gradient, bit for bit: three calls and
    # a replay of one captured in a CUDA graph
    same = {}
    for name, kw in [(f"{spread}_{size}", dict(levels=levels, q=Q_TRAIN,
                                              loc_range=loc_range))
                     for size, levels in LEVELS.items()
                     for spread, loc_range in (("uniform", (-0.05, 1.05)),
                                               ("clustered", CLUSTERED))] + \
            [("batch2", dict(levels=LEVELS["640x640"], b=2, q=Q_TRAIN))]:
        for dt in (torch.float32, torch.bfloat16):
            value, levels, loc, attn = sampler_inputs(dtype=dt, seed=2, **kw)
            g = torch.randn(value.shape[0], loc.shape[1],
                            value.shape[2] * value.shape[3],
                            generator=torch.Generator().manual_seed(9)
                            ).to(value.device, dt)
            outs = [ms_deform_attn_backward(value, levels, loc, attn, g)
                    for _ in range(3)]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = ms_deform_attn_backward(value, levels, loc, attn,
                                                   g)
            graph.replay()
            torch.cuda.synchronize()
            for got in outs[1:] + [replayed]:
                for k, a, b in zip(("d_value", "d_loc", "d_attn"), got,
                                   outs[0]):
                    check(torch.equal(a, b),
                          f"K2 {name} {dt}: {k} differs between calls on "
                          f"the same inputs")
            same[f"{name}/{str(dt)[6:]}"] = "bit for bit, 3 calls + replay"
            del graph
    timing = {}
    for name, levels in LEVELS.items():
        for dt, label, kw in ((torch.bfloat16, "bfloat16", {}),
                              (torch.float32, "float32", {}),
                              (torch.bfloat16, "clustered/bfloat16",
                               dict(loc_range=CLUSTERED))):
            value, levels_, loc, attn = sampler_inputs(levels, q=Q_TRAIN,
                                                       dtype=dt, seed=1, **kw)
            g = torch.randn(1, Q_TRAIN, H * D, device="cuda", dtype=dt)
            ms = time_ms(lambda: ms_deform_attn_backward(value, levels_, loc,
                                                         attn, g))
            plain = time_ms(lambda: ms_deform_attn_backward_torch(
                value, levels_, loc, attn, g), iters=10, warmup=2)
            plain_rows = time_ms(lambda: ms_deform_attn_backward_rows_torch(
                value, levels_, loc, attn, g), iters=10, warmup=2)
            stages = (stages_ms(lambda: ms_deform_attn_backward(
                value, levels_, loc, attn, g))
                if dt == torch.bfloat16 else None)
            timing[f"{name}/{label}"] = {
                "ms": ms, "plain_ms": plain, "plain_rows_ms": plain_rows,
                "stages_device_ms": stages,
                "device_ms": device_time_ms(
                    lambda: ms_deform_attn_backward(value, levels_, loc,
                                                    attn, g)),
                **bound_bwd(value, levels_, loc, attn)}
    emit("kernel_bwd", checks=results, rows=rows_checks, same=same,
         timing=timing)
    main = timing["1536x800/bfloat16"]
    return {**main, "max_abs_err":
            results["main_1536x800/bfloat16"]["max_abs_err"]}


# ------------------------------------------------------------------ greedy

GREEDY_M = 600      # 300 track slots + 300 detect queries at yolo_track


def greedy_inputs(case, b=4, m=GREEDY_M, seed=0, device="cuda"):
    """(conflict [b,m,m], valid [b,m]) bool. "frame": duplicate suppression
    as `runtime_update` builds it, from boxes in clusters of near-copies
    (IoU over 0.8 within a cluster) and 80 % valid; "random": random
    conflicts i < j, 1-2 % dense; "chain": conflict[i, i+1] only, a chain
    of depth m (stream 1 with a random tenth invalid); "all_invalid": random
    conflicts, nothing valid; "any": random conflicts in both triangles,
    whose steps need not settle before the m-step cap."""
    import torch

    from mo_yolo_tpu_torch.ops.boxes import pairwise_iou, xywh2xyxy
    g = torch.Generator().manual_seed(seed)
    upper = torch.ones(m, m, dtype=torch.bool).triu(1)
    valid = torch.rand(b, m, generator=g) < 0.8
    if case == "frame":
        base = torch.cat([torch.rand(b, m // 3 + 1, 2, generator=g) * 0.8 + 0.1,
                          torch.rand(b, m // 3 + 1, 2, generator=g) * 0.15 +
                          0.05], -1)
        boxes = base.repeat_interleave(3, 1)[:, :m]
        boxes = boxes + torch.randn(b, m, 4, generator=g) * 0.002
        xy = xywh2xyxy(boxes)
        conflict = (pairwise_iou(xy, xy) > 0.8) & upper
    elif case in ("random", "all_invalid"):
        dens = torch.linspace(0.01, 0.02, b)[:, None, None]
        conflict = (torch.rand(b, m, m, generator=g) < dens) & upper
        if case == "all_invalid":
            valid = torch.zeros(b, m, dtype=torch.bool)
    elif case == "chain":
        conflict = torch.zeros(b, m, m, dtype=torch.bool)
        i = torch.arange(m - 1)
        conflict[:, i, i + 1] = True
        valid = torch.ones(b, m, dtype=torch.bool)
        valid[min(1, b - 1)] = torch.rand(m, generator=g) > 0.1
    elif case == "any":
        conflict = torch.rand(b, m, m, generator=g) < 0.005
    else:
        raise ValueError(case)
    conflict = conflict & valid[:, :, None] & valid[:, None, :]
    return conflict.to(device), valid.to(device)


def bound_greedy(conflict, valid):
    """The greedy's least time: the conflict matrix and valid read once,
    keep written once (one byte each); one test a conflict element."""
    return _roofline(conflict.numel() + 2 * valid.numel(), conflict.numel())


def phase_greedy():
    """Hold the greedy-suppression kernel exactly to its plain version (the
    host-tested loop, run on the card) at B=4, M=600 on every case of
    `greedy_inputs`; time both at one stream's frame (B=1)."""
    import torch

    from mo_yolo_tpu_torch.ops.suppress import (
        greedy_keep_from_conflicts, greedy_keep_from_conflicts_torch)
    results = {}
    for case in ("frame", "random", "chain", "all_invalid", "any"):
        conflict, valid = greedy_inputs(case)
        before = greedy_keep_from_conflicts.launches
        got = greedy_keep_from_conflicts(conflict, valid)
        torch.cuda.synchronize()
        check(greedy_keep_from_conflicts.launches == before + 1,
              f"greedy {case}: not one launch")
        want = greedy_keep_from_conflicts_torch(conflict, valid)
        check(got.dtype == torch.bool and torch.equal(got, want),
              f"greedy {case}: {int((got != want).sum())} of "
              f"{want.numel()} differ from the plain version")
        if case == "all_invalid":
            check(not got.any(), "greedy all_invalid: something kept")
        results[case] = {"kept": int(got.sum()), "exact": True}
    conflict, valid = greedy_inputs("frame", b=1, seed=1)
    timing = {
        "ms": time_ms(lambda: greedy_keep_from_conflicts(conflict, valid)),
        "device_ms": device_time_ms(
            lambda: greedy_keep_from_conflicts(conflict, valid)),
        "plain_ms": time_ms(
            lambda: greedy_keep_from_conflicts_torch(conflict, valid),
            iters=20, warmup=3),
        **bound_greedy(conflict, valid)}
    emit("greedy", checks=results, timing=timing)
    return {**timing, "max_abs_err": 0.0}


def bound_gather(v, idx, axis):
    """S1's least time on the card: idx read once, out written once and the
    values these indices touch read once; no arithmetic."""
    import torch
    S, N = v.shape
    hit = torch.zeros_like(v, dtype=torch.bool)
    if axis == 0:
        hit[idx.long(), torch.arange(N, device=v.device)[None]] = True
    else:
        hit[torch.arange(S, device=v.device)[:, None], idx.long()] = True
    return _roofline(int(hit.sum()) * 4 + idx.numel() * 4 + v.numel() * 4, 0)


def gather_sectors(v, idx, axis):
    """The value reads of one call in 32-byte L2 sectors: one a gathered
    element (`v_sector_reads`) and the distinct sectors they touch."""
    import torch
    S, N = v.shape
    k = idx.long().clamp(0, (S, N)[axis] - 1)
    if axis == 0:
        flat = k * N + torch.arange(N, device=v.device)[None]
    else:
        flat = torch.arange(S, device=v.device)[:, None] * N + k
    first = v.data_ptr() // 4
    return {"v_sector_reads": idx.numel(),
            "v_sectors_distinct": int(torch.unique((flat + first) // 8)
                                      .numel())}


# --------------------------------------------------------- kernel_variants

def bound_nocy(value, levels, loc, attn):
    """nocy's least time, counted as the function needs it: each point
    sums the whole two columns of its level (Hl rows each), and a column's
    sum is the same for every tap that touches it. So the bytes are the
    distinct columns this data touches, read once, plus loc, attn and the
    output; the flops one add per value of those columns plus 2 per x tap
    and element. `bound_ms_design` counts what this design moves instead:
    the whole value read once by the column sums, the f32 column sums
    ([B,H,sum of W_l,D]) written once and read once, loc, attn and the
    output."""
    import torch
    b, S, h, d = value.shape
    q = loc.shape[1]
    esize = value.element_size()
    rows, taps = 0, 0
    for l, (hl, wl) in enumerate(levels):
        x0 = torch.floor(loc[:, :, :, l, :, 0] * wl - 0.5)       # [b,q,h,P]
        seen = torch.zeros(b, h, wl, dtype=torch.bool, device=value.device)
        for dx in (0, 1):
            ix = x0 + dx
            inb = (ix >= 0) & (ix <= wl - 1)
            bi = torch.arange(b, device=value.device)[:, None, None, None]
            hi = torch.arange(h, device=value.device)[None, None, :, None]
            seen[bi.expand_as(ix)[inb], hi.expand_as(ix)[inb],
                 ix[inb].long()] = True
            taps += int(inb.sum())
        rows += int(seen.sum()) * hl
    small = loc.numel() * 4 + attn.numel() * 4 + b * q * h * d * esize
    nbytes = rows * d * esize + small
    colsum = b * h * sum(wl for _, wl in levels) * d * 4
    design = value.numel() * esize + 2 * colsum + small
    return _roofline(nbytes, rows * d + 2 * taps * d,
                     bound_ms_design=design / PEAK_BYTES_PER_S * 1e3,
                     bytes_design=design)


def bound_v2(value, levels, loc, attn):
    """v2's least time is K1's (`bound`): the function is the same.
    `bound_ms_design` counts what this design moves besides the kernel's
    own bytes (`bound`'s): the value's head-major copy, read and written;
    loc's and attn's, each cast to f32 where it is not (read, written),
    then copied (read, written); and the [B,H,Q,D] output, which the
    kernel writes and `finish` reads and writes again."""
    import torch
    rec = bound(value, levels, loc, attn)
    b, _, h, d = value.shape
    esize = value.element_size()
    design = rec["bytes"] + 2 * value.numel() * esize + \
        2 * b * loc.shape[1] * h * d * esize
    for t in (loc, attn):
        design += 2 * t.numel() * 4
        if t.dtype != torch.float32:
            design += t.numel() * (t.element_size() + 4)
    return {**rec, "bound_ms_design": design / PEAK_BYTES_PER_S * 1e3,
            "bytes_design": design}


def hold_variant(rule, got, want, own_of, value, what):
    """Hold a study variant's output `got` to its rule; return its errors.
    `want` is the f32 sampler on `value.float()`, `own_of(v)` the variant's
    own plain version on value `v`.

    f32, every rule: max abs error within 1e-5 of the plain sampler and of
    the variant's own plain version (the same f32 arithmetic in another
    order; TF32 off); "own" (nocy, another sum on purpose) only of its own,
    within 1e-5 of max(1, that tensor's largest magnitude) (its sums run
    over up to 100 rows).
    bf16, "sampler" (S2-S4, f32 inside): within 1e-2 + 1e-2·|want| of the
    f32 result on the same bf16 values, and of its own on them (one bf16
    rounding of the output).
    bf16, "rounding" (S5-S7, which round intermediates to bf16 where the
    TPU kernels do): within 2^-7 of max(1, largest |own|) (one bf16 ulp at
    the tensor's scale) of its own plain version on the same bf16 operands,
    with a mean error at most a tenth of its mean error against the f32
    sampler, which shows the rounding points are the TPU's; and within
    2.5e-2 + 1e-2·|want| of the f32 sampler.
    bf16, "own": within one bf16 ulp of its own on the same bf16 operands."""
    import torch
    F32_ATOL, BF16_TOL = 1e-5, 1e-2
    BF16_ULP, BF16_SAMPLER_ATOL, MEAN_SHARE = 2.0 ** -7, 2.5e-2, 0.1
    bf16 = value.dtype == torch.bfloat16
    own = own_of(value if bf16 and rule != "sampler" else value.float())
    own = own.float()
    d_own = (got.float() - own).abs()
    d_smp = (got.float() - want).abs()
    scale = max(1.0, float(own.abs().max()))
    errs = {"own": float(d_own.max())}
    if rule != "own":
        errs["sampler"] = float(d_smp.max())
    if rule == "own":
        tol = (BF16_ULP if bf16 else F32_ATOL) * scale
        check(math.isfinite(errs["own"]) and errs["own"] <= tol,
              f"{what}: max err {errs['own']} against its own plain version "
              f"over {tol}")
    elif not bf16:
        for k, e in errs.items():
            check(math.isfinite(e) and e <= F32_ATOL,
                  f"{what}: max err {e} against the plain {k}")
    elif rule == "sampler":
        for k, diff, ref in (("sampler", d_smp, want), ("own", d_own, own)):
            check(math.isfinite(errs[k]) and bool(
                (diff <= BF16_TOL + BF16_TOL * ref.abs()).all()),
                f"{what}: max err {errs[k]} against the plain {k}")
    else:
        errs["mean_own"] = float(d_own.mean())
        errs["mean_sampler"] = float(d_smp.mean())
        check(math.isfinite(errs["own"]) and
              errs["own"] <= BF16_ULP * scale,
              f"{what}: max err {errs['own']} against its own plain version, "
              f"over one bf16 ulp at scale {scale}")
        check(errs["mean_own"] <= MEAN_SHARE * errs["mean_sampler"],
              f"{what}: mean err {errs['mean_own']} against its own plain "
              f"version is not a tenth of {errs['mean_sampler']} against the "
              f"sampler: it does not round where the TPU kernel does")
        check(bool((d_smp <= BF16_SAMPLER_ATOL + BF16_TOL * want.abs()).all()),
              f"{what}: max err {errs['sampler']} against the f32 sampler")
    return errs


def phase_kernel_variants(device="cuda"):
    """Hold S2-S7 against the plain sampler and their own plain versions,
    and S1 against `torch.gather`; time each. Returns one record per kernel
    for the `kernels` line (1536x800, bf16 value, the wrapper's default
    queries a block: 64, 128 for v8; v45 as v4; S1 at [19200, 256] along
    axis 0).

    Each variant is held to its rule (`hold_variant`); nothing in bounds
    gives exactly zero."""
    import functools

    import torch

    from mo_yolo_tpu_torch.ops import deform_attn_variants as dv
    from mo_yolo_tpu_torch.ops.deform_attn import ms_deform_attn_torch
    from mo_yolo_tpu_torch.ops.gather import (take_along_axis,
                                              take_along_axis_torch)
    from mo_yolo_tpu_torch.scripts.kernel_variants_bench import make_inputs
    from mo_yolo_tpu_torch.scripts.micro_peak_bench import (GATHER_SHAPES,
                                                            gather_inputs)
    torch.backends.cuda.matmul.allow_tf32 = False
    # label -> (kernel, wrapper, plain version, queries a block, rule):
    # the rule `hold_variant` holds the variant to
    variants = {
        "v1": ("ms_deform_attn_fwd_v1", dv.fwd_v1, dv.fwd_v1_torch, (64, 128),
               "sampler"),
        "v2": ("ms_deform_attn_fwd_v2", dv.fwd_v2, dv.fwd_v2_torch, (64, 128),
               "sampler"),
        "v3": ("ms_deform_attn_fwd_v3", dv.fwd_v3, dv.fwd_v3_torch, (64, 128),
               "sampler"),
        "v4": ("ms_deform_attn_fwd_v45", dv.fwd_v45, dv.fwd_v45_torch,
               (64, 128), "rounding"),
        "v5": ("ms_deform_attn_fwd_v45",
               functools.partial(dv.fwd_v45, compact_cy=False),
               functools.partial(dv.fwd_v45_torch, compact_cy=False),
               (64, 128), "rounding"),
        "nocy": ("ms_deform_attn_fwd_nocy", dv.fwd_nocy, dv.fwd_nocy_torch,
                 (64, 128), "own"),
        "v6": ("ms_deform_attn_fwd_v6", dv.fwd_v6, dv.fwd_v6_torch, (64, 128),
               "rounding"),
        "v7": ("ms_deform_attn_fwd_v7", dv.fwd_v7, dv.fwd_v7_torch,
               (64, 128, 256), "rounding"),
        "v8": ("ms_deform_attn_fwd_v8", dv.fwd_v8, dv.fwd_v8_torch,
               (64, 128, 256), "rounding"),
    }

    def study_inputs(name, dt):
        w, h = (int(n) for n in name.split("x"))
        return make_inputs(h, w, torch.Generator().manual_seed(0), dtype=dt,
                           device=device)
    small = ((12, 16), (6, 8), (3, 4))
    cases = [(f"study_{name}", lambda dt, name=name: study_inputs(name, dt))
             for name in LEVELS]
    for case, kw in (
            ("all_out_of_bounds", dict(levels=small, q=64,
                                       loc_range=(2.5, 3.5))),
            ("batch2", dict(levels=LEVELS["640x640"], b=2)),
            ("q77_h3", dict(levels=small, q=77, h=3)),
            ("d8", dict(levels=small, q=70, h=2, d=8)),
            ("d40", dict(levels=small, q=33, h=2, d=40)),
            ("d6", dict(levels=small, q=70, h=2, d=6))):
        cases.append((case, lambda dt, kw=kw: sampler_inputs(
            dtype=dt, device=device, **kw)))
    # the kernels on K1's grid where the points of a level land on a few
    # rows (at the small levels' 6x8 and at 1536x800's 25x48 every point of
    # a level touches the same two or five): v8's row groups have many
    # members, and the corner rows of a warp's points coincide
    clustered = [(f"clustered_{name}", lambda dt, levels=levels:
                  sampler_inputs(levels, dtype=dt, device=device, seed=7,
                                 loc_range=CLUSTERED))
                 for name, levels in (("1536x800", LEVELS["1536x800"]),
                                      ("small", small))]
    results = {}
    maxima = {label: {} for label in variants}

    def worst(label, key, err):
        maxima[label][key] = max(maxima[label].get(key, 0.0), err)

    # (case, inputs, variants, queries a block: None for each variant's);
    # nocy keeps the study interface's even D and is held to its own plain
    # version elsewhere
    grid = tuple(v for v in variants if v != "nocy")
    runs = [(c, m, tuple(variants), None) for c, m in cases] + \
        [("d7", lambda dt: sampler_inputs(small, q=70, h=2, d=7, dtype=dt,
                                          device=device), grid, None)] + \
        [(c, m, grid, (64, 128, 256)) for c, m in clustered]
    for case, make, labels, case_tqs in runs:
        for dt in (torch.float32, torch.bfloat16):
            value, levels, loc, attn = make(dt)
            want = ms_deform_attn_torch(value.float(), levels, loc, attn)
            v4_out = {}       # TQ -> v4's output, which v5 must equal
            for label in labels:
                kname, fn, plain, tqs, rule = variants[label]
                for tq in case_tqs or tqs:
                    got = fn(value, levels, loc, attn, TQ=tq)
                    torch.cuda.synchronize()
                    if label == "v4":
                        v4_out[tq] = got
                    elif label == "v5":
                        check(torch.equal(got, v4_out[tq]),
                              f"v5 {case} {dt} TQ={tq}: not equal to v4 bit "
                              f"for bit")
                    check(got.dtype == dt and got.shape == want.shape,
                          f"{label} {case}: output {got.dtype} "
                          f"{tuple(got.shape)}")
                    errs = hold_variant(
                        rule, got, want,
                        lambda v: plain(v, levels, loc, attn, TQ=tq),
                        value, f"{label} {case} {dt} TQ={tq}")
                    if case == "all_out_of_bounds":
                        check(not got.any(), f"{label} {case}: not zero")
                    for k, e in errs.items():
                        worst(label, f"{k}/{str(dt)[6:]}", e)
                    results[f"{label}/{case}/{str(dt)[6:]}/tq{tq}"] = errs
    timing = {}
    # K1's bound for the rest: the same function, the same bytes
    own_bound = {"nocy": bound_nocy, "v2": bound_v2}
    for name in LEVELS:
        for dt in (torch.bfloat16, torch.float32):
            value, levels, loc, attn = study_inputs(name, dt)
            bnd = bound(value, levels, loc, attn)
            for label, (kname, fn, plain, _, _) in variants.items():
                if label == "v5":           # v45's kernel, timed as v4
                    continue
                # the kernel alone, on operands its wrapper prepared once;
                # for v2 and v7 also their head-major copies without it
                prepare = getattr(dv, "prepare_" + kname.split("_")[-1])
                launch, _ = prepare(value, levels, loc, attn)
                out = launch()
                copies = {"copies_device_ms": device_time_ms(
                    lambda: prepare(value, levels, loc, attn)[1](out))} \
                    if label in ("v2", "v7") else {}
                timing[f"{label}/{name}/{str(dt)[6:]}"] = {
                    "ms": time_ms(lambda: fn(value, levels, loc, attn)),
                    "device_ms": device_time_ms(
                        lambda: fn(value, levels, loc, attn)),
                    "alone_device_ms": device_time_ms(launch), **copies,
                    "plain_ms": time_ms(
                        lambda: plain(value, levels, loc, attn), iters=10,
                        warmup=2),
                    **(own_bound[label](value, levels, loc, attn)
                       if label in own_bound else bnd)}
    gather = {}
    for S, N, axis in GATHER_SHAPES:
        v, idx = gather_inputs(S, N, axis, torch.device(device))
        idx64 = idx.long()
        got = take_along_axis(v, idx, axis)
        torch.cuda.synchronize()
        check(torch.equal(got, torch.gather(v, axis, idx64)) and
              torch.equal(got, take_along_axis_torch(v, idx, axis)),
              f"take_along_axis [{S},{N}] axis={axis}: not exact")
        gather[f"[{S},{N}] axis={axis}"] = {
            "max_abs_err": 0.0,
            "ms": time_ms(lambda: take_along_axis(v, idx, axis)),
            "device_ms": device_time_ms(
                lambda: take_along_axis(v, idx, axis)),
            "library_device_ms": device_time_ms(
                lambda: torch.gather(v, axis, idx64)),
            "plain_ms": time_ms(lambda: take_along_axis_torch(v, idx, axis)),
            "library_ms": time_ms(lambda: torch.gather(v, axis, idx64)),
            **bound_gather(v, idx, axis), **gather_sectors(v, idx, axis)}
        rec = gather[f"[{S},{N}] axis={axis}"]
        rec["v_sector_reads_per_us"] = rec["v_sector_reads"] / (
            rec["device_ms"] * 1e3)
    # the scalar forms: a row length that is no multiple of 4 (with a tail
    # of two elements at [333, 250]) and views off a 16-byte boundary
    for S, N, axis, off in ((19200, 250, 0, 0), (333, 250, 1, 0),
                            (19200, 256, 0, 1), (257, 256, 1, 3)):
        v, idx = gather_inputs(S, N, axis, torch.device(device))
        if off:
            v = torch.cat([v.new_zeros(off), v.flatten()])[off:].view(S, N)
            idx = torch.cat([idx.new_zeros(off), idx.flatten()])[off:].view(
                S, N)
        got = take_along_axis(v, idx, axis)
        torch.cuda.synchronize()
        check(torch.equal(got, torch.gather(v, axis, idx.long())),
              f"take_along_axis [{S},{N}] axis={axis} offset {off}: not "
              f"exact")
        gather[f"[{S},{N}] axis={axis} offset={off}"] = {"exact": True}
    # what a head-major value gives K1's grid: v2's kernel alone (v1's
    # arithmetic on [B,H,S,D]) over v1's alone (on [B,S,H,D])
    head_major = {key[3:]: rec["alone_device_ms"] /
                  timing["v1" + key[2:]]["alone_device_ms"]
                  for key, rec in timing.items() if key.startswith("v2/")}
    emit("kernel_variants", checks=results, maxima=maxima, timing=timing,
         gather=gather, v2_over_v1_alone=head_major)
    recs = {"take_along_axis": gather["[19200,256] axis=0"]}
    for label, (kname, *_rest) in variants.items():
        if label == "v5":
            continue
        key = "own" if variants[label][4] == "own" else "sampler"
        recs[kname] = {
            **timing[f"{label}/1536x800/bfloat16"],
            "ms_640x640": timing[f"{label}/640x640/bfloat16"]["ms"],
            "max_abs_err": max(
                results[f"{label}/study_{name}/float32/tq{tq}"][key]
                for name in LEVELS for tq in variants[label][3])}
    return recs


def phase_study():
    """The sampler study through its own entry points, on the card: every
    variant held to the plain sampler (`--parity`) and timed at both sizes,
    the micro-benchmarks, the three routes across sizes and the memory
    bandwidth. Each prints its own JSON lines. Launch counts are set to 0
    before and read after: S1-S7 must each have been launched."""
    from mo_yolo_tpu_torch.scripts import (hbm_bw_bench, kernel_study_shapes,
                                           kernel_variants_bench,
                                           micro_peak_bench)
    reset_counts()
    variants = kernel_variants_bench.main(["--parity"])
    micro = micro_peak_bench.main([])
    shapes = kernel_study_shapes.main([])
    hbm = hbm_bw_bench.main([])
    launches = counts()
    for name in ("take_along_axis",) + VARIANT_KERNELS:
        check(launches[name] > 0, f"study: {name} was never launched")
    for rec in variants:
        check(math.isfinite(rec["ms"]) and rec["ms"] > 0,
              f"study: {rec['variant']} @{rec['size']} has no time")
    emit("study", launches=launches, variant_records=len(variants),
         micro_records=len(micro), shape_records=len(shapes),
         read_gb_per_s=max(r["gb_per_s"] for r in hbm
                           if r["bench"] == "read"),
         data_sheet_gb_per_s=PEAK_BYTES_PER_S / 1e9)
    return launches


# ------------------------------------------------------------------- slice

def static_scene(n, hw=(1080, 1920), seed=0):
    """Synthetic frames of a static scene: a smooth background with a few
    bright rectangles, plus per-frame sensor noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 255 // w), (yy * 255 // h),
                     np.full_like(xx, 96)], -1).astype(np.int16)
    for _ in range(12):   # people-sized boxes: 7-18 % of the height
        bh, bw = int(h * rng.uniform(0.07, 0.18)), int(w * rng.uniform(0.02,
                                                                        0.06))
        y0, x0 = rng.integers(0, h - bh), rng.integers(0, w - bw)
        base[y0:y0 + bh, x0:x0 + bw] = rng.integers(0, 256, 3)
    return [np.clip(base + rng.integers(-4, 5, base.shape), 0,
                    255).astype(np.uint8) for _ in range(n)]


def prepare(model, seed=0, shift_scores=False):
    """Random BatchNorm statistics (seeded); with `shift_scores`, the score
    heads' bias shift of the CPU stream test."""
    import torch
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.running_mean.numel()
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
        if shift_scores:
            dec = model.head.decoder
            for head in (dec.enc_score_head, dec.dec_score_head[-1]):
                head.bias.fill_(SCORE_BIAS)


def spy_outputs(model):
    """Keep each frame's packed [1,M,8] output for the checks."""
    packed = []
    step = model.stream_step

    def spy(state, x):
        state, out = step(state, x)
        packed.append(out)
        return state, out
    model.stream_step = spy
    return packed


def _wrappers():
    """Kernel name -> the wrapper that counts its launches."""
    from mo_yolo_tpu_torch.ops import deform_attn_variants as dv
    from mo_yolo_tpu_torch.ops.deform_attn import (ms_deform_attn,
                                                   ms_deform_attn_backward)
    from mo_yolo_tpu_torch.ops.gather import take_along_axis
    from mo_yolo_tpu_torch.ops.suppress import greedy_keep_from_conflicts
    return dict(zip(KERNELS, (ms_deform_attn, ms_deform_attn_backward,
                              greedy_keep_from_conflicts, take_along_axis,
                              dv.fwd_v1, dv.fwd_v2, dv.fwd_v3, dv.fwd_v45,
                              dv.fwd_nocy, dv.fwd_v6, dv.fwd_v7, dv.fwd_v8)))


def counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def phase_slice(imgsz, cfg="yolo_track", frames=None, device=None,
                dtype="bfloat16", shift_scores=False):
    """Stream the frames through `MOTRTrack.predict`. If the seeded weights
    give no births, run again with the score-bias shift, so that the
    tracker's paths run."""
    import torch

    from mo_yolo_tpu_torch import MOTRTrack
    tracker = MOTRTrack(cfg, imgsz=imgsz, dtype=dtype, seed=0, device=device)
    prepare(tracker.model, shift_scores=shift_scores)
    packed = spy_outputs(tracker.model)
    frames = static_scene(N_FRAMES) if frames is None else frames
    on_card = tracker.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stamps, n_rows = [], []
    for res in tracker.predict(frames, conf=0.5):
        stamps.append(time.perf_counter())
        n_rows.append(len(res))
    launches = counts()
    n = len(frames)
    n_slots = tracker.model.tracker.n_slots
    valid, ids = [], set()
    for out in packed:
        a = out[0].float().cpu().numpy()
        check(np.isfinite(a).all(), f"{imgsz}: non-finite outputs")
        live = a[:, 7] > 0.5
        valid.append(int(live.sum()))
        ids.update(a[live, 6].astype(int).tolist())
    check(len(packed) == n and len(n_rows) == n, f"{imgsz}: frame count")
    check(max(valid) <= n_slots, f"{imgsz}: {max(valid)} valid rows > "
          f"{n_slots} slots")
    if sum(valid) == 0:
        check(not shift_scores, f"{imgsz}: no track was born")
        return phase_slice(imgsz, cfg, frames, device, dtype, True)
    n_layers = len(tracker.model.head.decoder.decoder.layers)
    if on_card:
        check(launches["ms_deform_attn_fwd"] == n_layers * n and
              launches["greedy_keep"] == n,
              f"{imgsz}: launches {launches}, expected {n_layers} x {n} "
              f"of the sampler and {n} of the greedy suppression")
    steady = stamps[WARMUP:] if len(stamps) > WARMUP + 1 else stamps
    fps = (len(steady) - 1) / (steady[-1] - steady[0])
    rec = {"imgsz": imgsz, "dtype": dtype, "frames": n,
           "card": card_line() if on_card else None,
           "score_bias_shift": SCORE_BIAS if shift_scores else None,
           "valid_per_frame": valid, "distinct_ids": len(ids),
           "emitted_per_frame": n_rows,
           "launches": launches, "steady_fps": fps,
           "max_memory_allocated": torch.cuda.max_memory_allocated()
           if on_card else None}
    del tracker.model.stream_step          # the spy: back to the class's
    if on_card:
        rec["graph"] = stream_graph(tracker.model, imgsz, frames, n_layers)
    emit("slice", **rec)
    rec["tracker"] = tracker
    return rec


def stream_graph(model, imgsz, frames, n_layers):
    """`stream_step` without the host. Each frame is letterboxed on the
    card first. Eager: the frames stepped with every host sync an error
    (`torch.cuda.set_sync_debug_mode("error")`), K1 and the greedy
    suppression counted; then timed again, plainly. Graph: one
    `stream_step` captured after a warm-up (cuDNN has chosen its
    algorithms by then) into a CUDA graph, replayed for each frame, the
    frame copied into the static input before and the state out copied
    into the state in after. The replayed outputs must equal the eager
    ones exactly (boxes, scores, classes, ids, valid). Returns the frames/s
    of both loops (host clock, synchronised) and the replay's device ms a
    frame (CUDA events around back-to-back replays)."""
    import torch

    from mo_yolo_tpu_torch.data.letterbox import to_hw
    from mo_yolo_tpu_torch.ops.preprocess import device_letterbox
    hw = to_hw(imgsz)
    xs = [device_letterbox(torch.from_numpy(f[None]).cuda(), hw,
                           scale_fill=True) for f in frames]
    n = len(xs)
    torch.cuda.synchronize()
    reset_counts()
    state, eager = model.init_state(1), []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for x in xs:
            state, packed = model.stream_step(state, x)
            eager.append(packed)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = counts()
    check(launches["greedy_keep"] == n and
          launches["ms_deform_attn_fwd"] == n_layers * n,
          f"{imgsz} graph: eager launches {launches}")

    def eager_loop():
        st = model.init_state(1)
        for x in xs:
            st, _ = model.stream_step(st, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager_loop()
    torch.cuda.synchronize()
    eager_fps = n / (time.perf_counter() - t0)

    static_x = xs[0].clone()
    state_in = model.init_state(1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            model.stream_step(state_in, static_x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        state_out, packed_out = model.stream_step(state_in, static_x)

    def replay_loop(keep):
        for a, b in zip(state_in, model.init_state(1)):
            a.copy_(b)
        out = []
        for x in xs:
            static_x.copy_(x)
            graph.replay()
            if keep:
                out.append(packed_out.clone())
            for a, b in zip(state_in, state_out):
                a.copy_(b)
        return out
    replayed = replay_loop(True)
    torch.cuda.synchronize()
    for t, (a, b) in enumerate(zip(replayed, eager)):
        check(torch.equal(a, b),
              f"{imgsz} graph: replayed frame {t} differs from the eager "
              f"one in {int((a != b).any(-1).sum())} rows (ids equal: "
              f"{torch.equal(a[..., 6], b[..., 6])})")
    t0 = time.perf_counter()
    replay_loop(False)
    torch.cuda.synchronize()
    graph_fps = n / (time.perf_counter() - t0)
    replay_ms = time_ms(graph.replay, iters=n, warmup=2)
    del graph
    return {"frames": n, "sync_debug_mode": "error",
            "eager_launches": launches, "frames_equal": n,
            "eager_step_fps": eager_fps, "graph_fps": graph_fps,
            "graph_device_ms_per_frame": replay_ms,
            "graph_fps_device": 1e3 / replay_ms}


def host_ms(fn, iters=10) -> float:
    """Host clock around synchronised work, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def phase_profile(model, imgsz, frame, n=5):
    """Where a frame's time goes: host-clock times of the backbone, the
    whole forward and the whole step (synchronised), then the device's
    kernel time per frame from torch.profiler, the idle share and the
    kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mo_yolo_tpu_torch.data.letterbox import to_hw
    from mo_yolo_tpu_torch.ops.preprocess import device_letterbox
    u8 = torch.from_numpy(frame[None]).cuda()
    x = device_letterbox(u8, to_hw(imgsz))
    state = model.init_state(1)
    for _ in range(3):
        state, _ = model.stream_step(state, x)
    with torch.no_grad():
        backbone = host_ms(lambda: model.model(x))
        forward = host_ms(lambda: model.frame_forward(x, state))
    step = host_ms(lambda: model.stream_step(state, x))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _ = model.stream_step(state, x)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side rows only (kernels, copies): the CPU ops' own rows
    # repeat the time of the kernels they launch
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / n / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    rec = {"imgsz": imgsz, "backbone_ms": backbone,
           "decoder_ms": forward - backbone, "tracker_qim_ms": step - forward,
           "step_ms": step, "device_busy_ms": busy_ms,
           "device_idle_share": max(0.0, 1.0 - busy_ms / step),
           "device_ops_per_frame": sum(e.count for e in kernels) / n,
           "top": [{"name": e.key[:80], "ms_per_frame": dev_us(e) / n / 1e3,
                    "calls_per_frame": e.count / n} for e in top]}
    emit("profile", **rec)
    return rec


def phase_in_context(cfg="yolo_track", imgsz=640, n=4, device=None,
                     margin=1e-3, box_atol=1e-3):
    """The kernel and the one-hot route against the plain sampler inside
    the full model at f32: boxes within `box_atol`; obj_id equal on every
    row whose score is more than `margin` away from 0.4 and 0.5 (and on no
    row after a frame where one was not). The score-bias shift keeps most
    scores off the thresholds."""
    import torch

    from mo_yolo_tpu_torch.engine.predictor import TrackPredictor
    from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frames = static_scene(n, seed=1)
    outs = {}
    for impl in (None, "torch", "onehot"):
        model = build_tracking_model(cfg, dtype="float32", device=device,
                                     seed=0, impl=impl)
        prepare(model, shift_scores=True)
        packed = spy_outputs(model)
        list(TrackPredictor(model, imgsz=imgsz, device=device).stream(frames))
        outs[impl] = [p[0].cpu().numpy() for p in packed]
        del model
    rec = {"imgsz": imgsz, "frames": n, "box_atol": box_atol,
           "margin": margin}
    for impl, label in ((None, "kernel"), ("onehot", "onehot")):
        excluded, box_err, compared = 0, 0.0, 0
        diverged = False
        for k, p in zip(outs[impl], outs["torch"]):
            box_err = max(box_err, float(np.abs(k[:, :4] - p[:, :4]).max()))
            near = (np.abs(p[:, 4] - 0.4) <= margin) | \
                (np.abs(p[:, 4] - 0.5) <= margin)
            if diverged:
                excluded += len(p)
                continue
            keep = ~near
            check((k[keep, 6] == p[keep, 6]).all(),
                  f"in-context obj_id mismatch ({label})")
            compared += int(keep.sum())
            excluded += int(near.sum())
            diverged = bool(near.any())
        check(box_err <= box_atol,
              f"in-context box err {box_err} > {box_atol} ({label})")
        rec[label] = {"box_max_abs_err": box_err, "rows_compared": compared,
                      "rows_excluded_by_margin": excluded}
    emit("in_context", **rec)
    return rec


# ------------------------------------------------------------------- train

def synthetic_clip(T, hw, nc, n_obj=20, seed=0, device="cuda"):
    """A clip of T uint8 frames [T,1,H,W,3] with `n_obj` rectangles that
    move at constant speed and keep their ids, and its targets padded to
    MAX_GT rows: gt_cls/gt_track_id [T,1,G], gt_boxes [T,1,G,4] cxcywh in
    [0, 1], gt_mask [T,1,G]."""
    import torch
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h, np.full_like(xx, 96)],
                    -1).astype(np.uint8)
    wh = np.stack([rng.uniform(0.03, 0.08, n_obj),
                   rng.uniform(0.07, 0.18, n_obj)], -1)
    c0 = rng.uniform(0.15, 0.85, (n_obj, 2))
    vel = rng.uniform(-0.01, 0.01, (n_obj, 2))
    colour = rng.integers(0, 256, (n_obj, 3))
    images = np.empty((T, 1, h, w, 3), np.uint8)
    boxes = np.zeros((T, 1, MAX_GT, 4), np.float32)
    for t in range(T):
        img = base.copy()
        c = c0 + t * vel
        for k in range(n_obj):
            x0, y0 = ((c[k] - wh[k] / 2) * (w, h)).astype(int)
            x1, y1 = ((c[k] + wh[k] / 2) * (w, h)).astype(int)
            img[max(y0, 0):y1, max(x0, 0):x1] = colour[k]
        images[t, 0] = img
        boxes[t, 0, :n_obj] = np.concatenate([c, wh], -1)
    ids = np.full((T, 1, MAX_GT), -1, np.int32)
    ids[:, :, :n_obj] = np.arange(n_obj)
    mask = ids >= 0
    clip = {"images": images, "gt_cls": np.where(mask, ids % nc, 0),
            "gt_boxes": boxes, "gt_track_id": np.maximum(ids, 0),
            "gt_mask": mask}
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for k, a in clip.items()}


def _device_split(prof, n):
    """Device busy ms per step and the top kernels from a profile of n
    steps (device-side rows only: the CPU ops' rows repeat them)."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # user annotations (the optimizer's step range) span kernels already
    # counted, so they are left out
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and dev_us(e) > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    return (sum(dev_us(e) for e in kernels) / n / 1e3,
            sum(e.count for e in kernels) / n,
            [{"name": e.key[:80], "ms_per_step": dev_us(e) / n / 1e3,
              "calls_per_step": e.count / n} for e in top])


SAMPLER_PROJECTIONS = ("sampling_offsets", "attention_weights", "value_proj")


def phase_train(imgsz="1536x800", T=CLIP_LEN, steps=TRAIN_STEPS,
                cfg="yolo_track", device=None, **model_kw):
    """The clip training step at full `yolo_track` width (nc=5, hd 256, 6
    layers, 300 queries, 300 slots, num_denoising 100), bf16 autocast over
    f32 parameters, B=1, 5-frame clips of 20 moving boxes padded to 64,
    remat on, the default AdamW: one warm-up step, `steps` timed steps,
    one profiled step. On the CPU (`device="cpu"`, a rehearsal at a small
    `cfg`) it runs in f32 and checks no launch counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mo_yolo_tpu_torch.data.letterbox import to_hw
    from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
    from mo_yolo_tpu_torch.train.losses import LossConfig
    from mo_yolo_tpu_torch.train.train_step import (TrainConfig,
                                                    make_clip_loss_fn,
                                                    make_train_step)
    model = build_tracking_model(cfg, dtype="float32", device=device, seed=0,
                                 **model_kw)
    dev = next(model.parameters()).device
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    nc, ndl = model.spec.nc, len(model.head.decoder.decoder.layers)
    tcfg = TrainConfig(clip_len=T)
    init_fn, step_fn = make_train_step(
        model, LossConfig(nc=nc), tcfg,
        compute_dtype=torch.bfloat16 if on_card else None)
    ts = init_fn()
    clip = synthetic_clip(T, to_hw(imgsz), nc, device=dev)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(0)
    ts, _ = step_fn(ts, clip, gen)                       # warm-up
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    per_step, launches = [], []
    for _ in range(steps):
        reset_counts()
        sync()
        t0 = time.perf_counter()
        ts, m = step_fn(ts, clip, gen)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        sync()
        per_step.append({"step_ms": (time.perf_counter() - t0) * 1e3,
                         "loss": loss, "grad_norm": gnorm})
        launches.append(counts())
        check(math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0,
              f"train: loss {loss}, grad norm {gnorm}")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    want = {**dict.fromkeys(KERNELS, 0),   # the study's kernels: none here
            "ms_deform_attn_fwd": (2 if tcfg.remat else 1) * ndl * T,
            "ms_deform_attn_bwd": ndl * T}
    for c in launches:
        check(c == want or not on_card,
              f"train: launches {c} per step, expected {want}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts, m = step_fn(ts, clip, gen)
        float(m["loss"])
        sync()
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy, n_ops, top = _device_split(prof, 1)
    # the same step's parts on the host clock (synchronised): the clip's
    # forward and losses, the backward with each frame's recompute, and the
    # optimizer update (the EMA is left out)
    loss_fn = make_clip_loss_fn(model, LossConfig(nc=nc), tcfg,
                                torch.bfloat16 if on_card else None)
    noises = [model.draw_frame_noise(gen, 1, MAX_GT) for _ in range(T)]
    ts.optimizer.zero_grad(set_to_none=True)
    sync()
    t0 = time.perf_counter()
    loss, _ = loss_fn(clip, noises)
    float(loss.detach())
    sync()
    t1 = time.perf_counter()
    loss.backward()
    sync()
    t2 = time.perf_counter()
    ts.optimizer.step()
    sync()
    split = {"forward_and_loss_ms": (t1 - t0) * 1e3,
             "backward_ms": (t2 - t1) * 1e3,
             "optimizer_ms": (time.perf_counter() - t2) * 1e3}
    no_sync = optimizer_without_sync(ts.optimizer) if on_card else None
    moved = {n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    check(len(moved) > 0, "train: no parameter changed")
    for part in SAMPLER_PROJECTIONS:
        names = [n for n in before if part in n]
        check(names and all(n in moved for n in names),
              f"train: {part} did not change in every layer")
    step_ms = float(np.median([r["step_ms"] for r in per_step]))
    rec = {"imgsz": imgsz, "clip_len": T, "batch": 1, "max_gt": MAX_GT,
           "remat": tcfg.remat, "optimizer": tcfg.optimizer,
           "compute_dtype": "bfloat16" if on_card else "float32",
           "steps": per_step,
           "step_ms_median": step_ms,
           "frames_per_s": T / step_ms * 1e3, "max_memory_allocated": peak,
           "launches_per_step": launches[-1],
           "params_changed": len(moved), "params": len(before),
           "profiled_step_ms": prof_ms, "device_busy_ms": busy,
           "device_idle_share": max(0.0, 1.0 - busy / prof_ms),
           "device_ops_per_step": n_ops, "host_split": split,
           "optimizer_sync_free": no_sync, "top": top}
    emit("train", **rec)
    rec["launches_total"] = {k: sum(c[k] for c in launches)
                             for k in launches[0]}
    del ts, model
    if on_card:
        torch.cuda.empty_cache()
    return rec


def optimizer_without_sync(opt):
    """`ClipOptimizer.step` on the gradients it holds, with every host sync
    an error (`torch.cuda.set_sync_debug_mode("error")`): once with the
    clip at half the gradients' global norm (it scales them) and once at
    twice it (it leaves them). Returns the norm and the clips."""
    import dataclasses

    import torch

    from mo_yolo_tpu_torch.train.train_step import global_norm
    cfg = opt.cfg
    norm = float(global_norm(p.grad for g in opt.param_groups
                             for p in g["params"]))
    clips = {"on": norm / 2, "off": norm * 2}
    try:
        for clip in clips.values():
            opt.cfg = dataclasses.replace(cfg, grad_clip=clip)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                opt.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    finally:
        opt.cfg = cfg
    return {"grad_norm": norm, "grad_clip": clips,
            "sync_debug_mode": "error"}


def _grads_of_one_step(impl, remat, clip, device, T, cfg, model_kw,
                       jitter=False, tape=None, replay=False):
    """One training step's loss and gradients. With `tape` (and remat off,
    so that every matching goes through it), the step's Hungarian
    assignments are recorded, or with `replay` taken from the tape."""
    import contextlib

    import torch

    from mo_yolo_tpu_torch.ops.matching import using_tape

    from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
    from mo_yolo_tpu_torch.train.losses import LossConfig
    from mo_yolo_tpu_torch.train.train_step import (TrainConfig,
                                                    make_train_step)
    model = build_tracking_model(cfg, dtype="float32", device=device, seed=0,
                                 impl=impl, num_denoising=0, **model_kw)
    if jitter:        # every parameter moved by about one f32 ulp
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in model.parameters():
                sign = torch.randint(0, 2, p.shape, generator=g) * 2 - 1
                p.mul_(1 + 2.0 ** -23 * sign.to(p.device, p.dtype))
    tcfg = TrainConfig(clip_len=T, remat=remat, drop_prob=0.0, fp_ratio=0.0)
    init_fn, step_fn = make_train_step(model, LossConfig(nc=model.spec.nc),
                                       tcfg)
    ts = init_fn()
    with contextlib.ExitStack() as stack:
        if tape is not None:
            stack.enter_context(using_tape(tape))
            if replay:
                stack.enter_context(tape.replaying())
        ts, m = step_fn(ts, clip,
                        torch.Generator(device=clip["images"].device))
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .detach().clone() for n, p in model.named_parameters()}
    loss = float(m["loss"])
    del ts, model
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return loss, grads


def phase_train_in_context(imgsz=320, T=2, device=None, loss_rtol=1e-4,
                           grad_tol=1e-3, noise_mult=10.0, cfg="yolo_track",
                           **model_kw):
    """The training step at full width and f32 (TF32 off), 320x320, T=2,
    CDN, dropout and FP injection off, on the same weights and clip: one
    step with the kernels against one with the plain sampler
    (`impl="torch"`), both without remat and with the same Hungarian
    matchings (the plain step replays the kernel step's, so that a near-tie
    resolved the other way by f32 noise cannot send gradients to other
    queries); and the kernels with remat against the kernels without.

    The loss within `loss_rtol` relative. Each parameter's gradient within
    `grad_tol` of that tensor's largest magnitude (K2 sums d_value with
    atomics, in another order each run), or within `noise_mult` times its
    noise floor: how far the plain step's gradient moves when every
    parameter moves by one f32 ulp (a third plain step, same matchings).
    At random weights some gradients are that ill-conditioned."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clip = synthetic_clip(T, (imgsz, imgsz), 5, seed=1,
                          device=device or "cuda")
    from mo_yolo_tpu_torch.ops.matching import AssignmentTape
    tape = AssignmentTape()
    runs = {name: _grads_of_one_step(impl, remat, clip, device, T, cfg,
                                     model_kw, jitter, tape, replay)
            for name, impl, remat, jitter, replay in (
                ("kernel_no_remat", None, False, False, False),
                ("plain", "torch", False, False, True),
                ("plain_jitter", "torch", False, True, True))}
    runs["kernel"] = _grads_of_one_step(None, True, clip, device, T, cfg,
                                        model_kw)

    def rel(ga, gb):
        return {n: float((ga[n] - w).abs().max()) /
                max(float(w.abs().max()), 1e-12) for n, w in gb.items()}
    floor = rel(runs["plain_jitter"][1], runs["plain"][1])
    rec = {"imgsz": imgsz, "clip_len": T,
           "loss": {k: v[0] for k, v in runs.items()}, "pairs": {}}
    for a, b in (("kernel_no_remat", "plain"), ("kernel", "kernel_no_remat"),
                 ("plain_jitter", "plain")):
        (la, ga), (lb, gb) = runs[a], runs[b]
        errs = rel(ga, gb)
        worst = sorted(errs, key=errs.get, reverse=True)
        over = [n for n in worst
                if errs[n] > max(grad_tol, noise_mult * floor[n])]
        rec["pairs"][f"{a}_vs_{b}"] = {
            "loss_rel_err": abs(la - lb) / abs(lb),
            "tensors": len(errs),
            "within_grad_tol": sum(e <= grad_tol for e in errs.values()),
            "worst_grads": [{"name": n, "rel_err": errs[n],
                             "noise_floor": floor[n]} for n in worst[:5]],
            "over_tolerance": [{"name": n, "rel_err": errs[n],
                                "noise_floor": floor[n]} for n in over]}
    emit("train_in_context", **rec, loss_rtol=loss_rtol, grad_tol=grad_tol,
         noise_mult=noise_mult)
    for pair, r in rec["pairs"].items():
        if pair.startswith("plain_jitter"):
            continue
        check(r["loss_rel_err"] <= loss_rtol,
              f"train_in_context {pair}: loss error {r['loss_rel_err']}")
        check(not r["over_tolerance"],
              f"train_in_context {pair}: {r['over_tolerance'][:3]}")
    return rec


# -------------------------------------------------------------------- main

def main() -> int:
    if not (ROOT / "mo_yolo_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke.py: the mo_yolo_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    card = card_line()
    emit("card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    from mo_yolo_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    cuda_build.build(KERNELS)
    usage = {k: ptxas_usage(v) for k, v in cuda_build.build_log.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=usage,
         register_warning=REGISTER_WARNING)
    for name in REGISTER_HELD:
        if name not in usage:       # built by an earlier run: no report
            continue
        check(bool(usage[name]), f"{name}: no ptxas report")
        for rec in usage[name]:
            check(rec["registers"] < REGISTER_WARNING and
                  max(rec["spill_stores"], rec["spill_loads"]) <= SPILL_LIMIT,
                  f"{name}: {rec}")

    k1 = phase_kernel()
    k2 = phase_kernel_bwd()
    greedy = phase_greedy()
    study_recs = phase_kernel_variants()
    study_launches = phase_study()
    slices = [phase_slice("1536x800"), phase_slice(640)]
    for rec in slices:
        phase_profile(rec["tracker"].model, rec["imgsz"], static_scene(1)[0])
        del rec["tracker"]
    phase_in_context()
    train = phase_train()
    phase_train_in_context()
    launches = train["launches_total"]
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by")
    design = ("bound_ms_design",)   # what the design moves, where it differs
    csrc = "mo_yolo_tpu_torch/ops/csrc"
    kernels = [{
        "name": "ms_deform_attn_fwd", "route": "cuda",
        "source": f"{csrc}/ms_deform_attn_fwd.cu",
        "replaces": "mo_yolo_tpu/ops/deform_attn_pallas.py:43",
        "launches": launches["ms_deform_attn_fwd"],
        "launches_stream_1536x800": slices[0]["launches"][
            "ms_deform_attn_fwd"],
        "launches_study": study_launches["ms_deform_attn_fwd"],
        **{k: k1[k] for k in keys}, "library_ms": None}, {
        "name": "ms_deform_attn_bwd", "route": "cuda",
        "source": f"{csrc}/ms_deform_attn_bwd.cu",
        "replaces": "mo_yolo_tpu/ops/deform_attn_pallas.py:149",
        "launches": launches["ms_deform_attn_bwd"],
        **{k: k2[k] for k in keys + design}, "library_ms": None}, {
        "name": "greedy_keep", "route": "cuda",
        "source": f"{csrc}/greedy_keep.cu",
        "replaces": "mo_yolo_tpu/models/tracker.py:128 (lax.while_loop, XLA)",
        "launches": slices[0]["launches"]["greedy_keep"],
        "launches_per_frame": slices[0]["launches"]["greedy_keep"] /
        slices[0]["frames"],
        **{k: greedy[k] for k in keys}, "library_ms": None}]
    # the study's kernels: launches are the study phase's, the path that
    # runs them; the streaming and training paths launch none
    for name in ("take_along_axis",) + VARIANT_KERNELS:
        check(launches[name] == 0 and
              all(rec["launches"][name] == 0 for rec in slices),
              f"{name}: launched on the streaming or training path")
    for name, replaces in (
            ("take_along_axis", "scripts/micro_peak_bench.py:88"),
            ("ms_deform_attn_fwd_v1", "scripts/kernel_variants_bench.py:40"),
            ("ms_deform_attn_fwd_v2", "scripts/kernel_variants_bench.py:137"),
            ("ms_deform_attn_fwd_v3", "scripts/kernel_variants_bench.py:211"),
            ("ms_deform_attn_fwd_v45", "scripts/kernel_variants_bench.py:335"),
            ("ms_deform_attn_fwd_nocy",
             "scripts/kernel_variants_bench.py:390"),
            ("ms_deform_attn_fwd_v6", "scripts/kernel_variants_bench.py:494"),
            ("ms_deform_attn_fwd_v7", "scripts/kernel_variants_bench.py:553"),
            ("ms_deform_attn_fwd_v8", "scripts/kernel_variants_bench.py:665")):
        rec = study_recs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{csrc}/{name}.cu",
            "replaces": replaces, "launches": study_launches[name],
            "launches_train": launches[name],
            **{k: rec[k] for k in keys},
            **{k: rec[k] for k in design + ("alone_device_ms",
                                            "copies_device_ms") if k in rec},
            "library_ms": rec.get("library_ms")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke.py: check failed: {e}", file=sys.stderr)
        sys.exit(1)
