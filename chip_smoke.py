#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. card: name and power limit (`nvidia-smi`); exits non-zero without a card;
   host_tools: whether the host C compiler is found (the frame decoders
   and the host resize need it; nothing else: no libjpeg);
   resample: the host resize (`data/letterbox.resample`, PIL's
   `Image.resize` arithmetic in C, which the letterbox, mosaic and the
   mask overlays run) exactly against its plain numpy version on a 1080p
   frame into 800x1422 and a 480x640 frame into 640x640 (bilinear, 3
   channels) and a 160x160 mask into 1080x1920 (bicubic), with the ms of
   each;
   jpeg: the port's JPEG codec (`data/jpeg.py`, host C, no libjpeg): its
   decode of the fixtures PIL wrote (`tests/data/jpeg`: baseline 4:4:4,
   4:2:2, 4:2:0, grey, 1x1 and other odd sizes, optimized tables, restart
   markers, progressive) against the SHA-1 of PIL's decode, its encode of
   seeded frames against the SHA-256 of PIL's bytes (`JPEG_DIGESTS`);
   then the ms to decode a 1080p MOT17-like frame at quality 95 (one call,
   and a frame with 8 threads at once), to encode it at 75, and to decode
   the same frame as PNG;
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
   the clustered case, edge cases and 1,112 and 2,048 queries (Q*P past
   the 4,096 points of the sort's windows), in f32 and bf16; holds K2's
   intermediates (each corner slot's d_value row, the rows' counts and
   starts, the sorted slots) to the plain rows form exactly, checks that
   three calls and a CUDA-graph replay give the same gradient bit for bit,
   and times the plain rows form beside the plain gradient;
5. greedy: holds the greedy-suppression kernel (`greedy_keep`) exactly to
   its plain version at 4 streams of 600, 1,400, 2,048 and 4,096 (a
   frame's duplicates, random conflicts, a chain of depth M, nothing
   valid: each stream the one-pass walk in at most ceil(M/32) steps, as
   the kernel's stats report; conflicts in both triangles: the fixed
   point's turns; past ~1,300 the bit rows are staged into shared memory
   a word block at a time) and on `nms_fixed`'s conflicts at 1,344 and
   8,400 anchors, scores uniform and smooth (deep conflict chains), and
   times both at one stream of 600 and 2,048 and on those matrices;
   jv: holds the Jonker-Volgenant matcher's kernel (`jv_assign`) exactly
   to its plain version, assignment, Dijkstra steps and the padded rows
   decided at once or walked, launched with every host sync an error, and
   to scipy (the same assignment on continuous costs, as many pairs at
   the same total on ties), on the training step's problems (300 and 600
   queries against 64 GT slots, 600 against 256; the valid GT anywhere or
   first, as the dataset pads them; the tracker's mask; a frame's 5 aux
   layers in one launch), a sweep of 16 valid counts, costs at 1e6 where
   some padded rows must be walked, more GT slots than queries (solved
   transposed or with the padding dropped), ties and all padding; times
   it, with the steps walked and µs a walked step;
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
   formats (after the slice phase): the port's TIFF and WebP decoders
   (`data/tiff.py`, `data/webp.py`, host C, no libtiff or libwebp): every
   fixture of `tests/data/{tiff,webp}` against the SHA-1 of PIL's decode,
   the ms of the 1080p lossy and lossless WebP fixtures and a 1080p
   Deflate TIFF (one call, and 8 threads at once), and the slice phase's
   1536x800 bf16 tracker's `predict` over a folder of 12 WebP frames: 6
   K1 and 1 greedy launch a frame;
   sources: video as the JAX package reads it, through an ffmpeg pipe:
   a stand-in `ffmpeg`/`ffprobe` (`tests/ffmpeg_stub.py`; the card's
   machine has none) first on PATH serves 24 synthetic 1080p frames as
   `clip.mp4`; `predict(vid_stride=2, save=True)` on the same tracker:
   12 frames, `clip.mp4#<i>` paths, the frames served, `clip_<n>.jpg`
   written and read back, frames/s, 6 K1 and 1 greedy launch a kept
   frame; then a `StreamSource` over a stand-in `rtsp://` URL with
   `max_frames`: an ordered subset of the frames, no ffmpeg left running;
9. profile: where a frame's time goes at each size (host clock per stage,
   device kernel time and idle share from torch.profiler);
   multistream: 1, 4 and 8 streams of synthetic 1080p frames in lockstep
   through `MultiStreamPredictor` at full `yolo_track` width, 1536x800
   bf16: aggregate and per-stream frames/s eager and replayed from a CUDA
   graph of the batched `stream_step` (every host sync an error in the
   eager pass, replayed outputs equal to eager), device ms and idle share
   a step, peak memory, 6 K1 and 1 greedy launches a batched frame; then
   4 streams in f32 against each stream alone through `TrackPredictor`:
   every row's id, valid flag and class equal, boxes within 1e-3;
   val: evaluation through `MOTRTrack(...).val` at full `yolo_track` width,
   1536x800, bf16, on a synthetic MOT-layout fixture that the script
   writes itself (2 sequences x 12 PNG frames at 1920x1080, each row
   filter type in turn) and converts with the port's
   `convert_mot_to_yolo`: every decoded frame equal to the array written,
   every metric finite and in range, 6 K1 and 1 greedy launches a frame,
   the ids restarting with the second sequence, one step with every host
   sync an error; decode, host letterbox and step ms a frame from an
   instrumented pass, frames/s from a second, untouched `val` call; then
   `MultiStreamValidator` with both sequences as one batch: its frames/s,
   and in f32 its metrics against `TrackValidator`'s within 1e-4; then a
   JPEG copy of the fixture in MOT17's layout (`img1/000001.jpg`, written
   by the port's encoder at 95): 6 K1 and 1 greedy a frame, every metric
   finite and in range, its decode ms a frame and frames/s beside PNG's;
10. in_context: the same model at f32 and 640x640, with the kernel, with
   the plain sampler (`impl="torch"`) and with the one-hot route
   (`impl="onehot"`), holding boxes and ids to the plain sampler's;
11. train: the clip training step (`train.train_step.make_train_step`) at
   full `yolo_track` width, bf16 autocast, 1536x800, 5-frame synthetic
   clips with remat and the default AdamW: one warm-up and two timed
   steps (loss, grad norm, step time, frames/s, peak memory, kernel
   launches per step: 15 of the matcher and no scipy call), then one
   profiled step, then `ClipOptimizer.step` with every host sync an
   error, the clip on and off, and one step with every host sync a
   warning (counted and placed) and every matcher call's an error;
   trainer: training through `MOTRTrack(...).train` at full `yolo_track`
   width, 1536x800, bf16 autocast over f32 parameters, on a MOT-layout
   fixture it writes (2 sequences x 5 PNG frames at 1920x1080, converted
   by `convert_mot_to_yolo`; the last sequence doubles as val): 2 epochs
   of 2 steps, 5-frame clips, augmentation, accumulate 3, validation each
   epoch; checks finite losses, 60 K1 and 30 K2 launches a step, 6 K1 and
   1 greedy a val frame, the run's files, the best EMA in the facade;
   times a step through the trainer, the host's decoding, augmentation
   and loading a clip, the device's idle share and the val frames/s; then,
   in a subprocess with deterministic algorithms, a run resumed from
   `last_full` after its first epoch against an uninterrupted run (a
   second one only where they differ), on
   the first sequence alone at accumulate 2 (saved mid-accumulation, the
   resumed epoch makes the update);
   distributed: data parallelism over two ranks on the one card, each a
   process of its own: first NCCL's answer to two ranks on one device
   (`parallel.distributed.initialize()` as torchrun starts a rank,
   LOCAL_RANK unset, then one all-reduce), printed on a line of its own;
   where NCCL refuses, the ranks build a gloo group over CUDA tensors,
   which `initialize()` takes as it is. Then one f32 step (TF32 off) of
   `make_sharded_train_step` at full `yolo_track` width, 1536x800, 5-frame
   clips, remat, one clip a rank, against one process's step on both
   clips: loss terms to 1e-5, gradients and BatchNorm statistics to 1e-3
   of each tensor's max (the sampling offsets' gradients 0.25), the
   gradient norm within its triangle bound, the ranks' gradients equal
   bit for bit, with the margins printed; then `MOTRTrack.train` at batch
   2 over the two ranks, bf16 autocast, on 4 x 5 1080p frames (one epoch
   of 2 steps, validation on each rank): both ranks' parameters, buffers,
   EMA and optimizer state equal bit for bit, the run's files written by
   rank 0 alone, 60 K1, 30 K2 and 15 JV launches a rank's step and 6 K1
   and 1 greedy a rank's val frame, seconds a step beside one process's
   bf16 step on the same batch of 2;
12. train_in_context: one f32 step at 320x320 with the kernels, one with
   the plain sampler and one with the kernels without remat, holding the
   loss and every parameter's gradient; then the same with clips of 256
   GT slots and CDN on (1,112 queries: K2's sort in two windows);
13. cli (before train_in_context): the command line in process
   (`mo_yolo_tpu_torch.cli.main`) on a model saved by the facade at full
   `yolo_track` width, 1536x800, bf16: `track predict` over 12 1080p PNG
   frames writing annotated PNG frames, label files and MOT rows, `track
   val` on 2 x 12 frames, `track export format=params` and `track val` of
   the export (equal metrics), `track export format=pt` and `load_torch`
   (equal weights), `track train epochs=1 batch=-1` on 8 x 5 frames (the
   autobatch choice and the probe's seconds), a 2-trial `track tune` of
   1 epoch on 2 x 5 frames, and `info(flops=True)`; 6 K1 and 1 greedy
   launches a frame, 60 K1, 30 K2 and 15 JV every training step (the
   probe's too), no study kernel; `track predict save=true` at the
   default format writing one JPEG a frame, each read back; then
   `detect predict`, `detect val` (`yolo_mot`) and `rtdetr predict`
   (`detr_track`) at 640x640: 6 K1 a frame and nothing else;
14. slice_configs (after the slice phase): one 1536x800 bf16 `stream_step`
   of each other track config (`yolo_track_n`, `yolov8m_track`,
   `yolo_track_rare`, `yolo_mot`, `detr_track`) through
   `MOTRTrack(name).predict`: finite, valid rows <= slots, 6 K1 and 1
   greedy launch, its parameter count;
15. detect: `Detector("yolo_mot")` (one class, the RT-DETR-style decoder
   with no track slots) at 640x640 bf16: `predict` over 12 1080p PNG
   frames (frames/s, 6 K1 a frame, no greedy), `track` over them with
   `bytetrack` and with `botsort` (the classic trackers on the host;
   frames/s, the same launches, tracks a frame), `val` on 2 x 12 frames
   (frames/s, finite metrics), `predict_step` in f32 with the kernel
   against the plain sampler at 320x320, and `train` for 2 epochs x 3
   steps of 4 augmented images (s a step, peak memory, 6 K1, 6 K2 and 3
   JV a step, the second step's host syncs: 0); rtdetr: the same for
   `RTDETR("detr_track")`, predict and 2 training steps;
16. segment, pose, classify: the YOLOv8 task heads through
   `YOLO("yolo_track", task=...)` at 640x640 f32 with TF32 off: segment
   and pose `predict` over the 12 1080p PNG frames (segment with
   `masks=True` on both compositions) with one greedy launch an image
   (NMS over all 8,400 anchors) and nothing else, each greedy call of two
   frames exactly against the plain version on its conflict matrix (the
   first frame's matrix timed with both), `predict_step` against the plain
   suppression, `nms_fixed` with every host sync an error; `val` on 8
   images of a synthetic polygon or keypoint fixture; classify `val` on a
   class-subdir tree; every task `train` for 2 epochs x 3 steps of 4
   images (s a step, peak memory, no kernel launched, the loss in f32
   without autocast). The greedy phase also holds the kernel to its plain
   version on the conflict matrices that `nms_fixed` builds for an
   untrained head's boxes at 1,344 and 8,400 anchors and times it there;
17. export: the serialized step (`MOTRTrack.export(fmt="pt2")`, K1 and
   the greedy kernel as registered ops, loaded by `AutoBackend`) at full
   `yolo_track` width, 1536x800 bf16: the export's and load's seconds,
   the `.pt2`'s MB, the program's op nodes (6 K1, 1 greedy), 4 frames
   through the eager step and the loaded program (equal bit for bit,
   state too; 6 K1 and 1 greedy launches a frame), both through the
   slice phase's `stream_graph` (no host sync, frames/s, a CUDA graph's
   replay equal to eager and its device ms a frame); a `dynamic=True`
   program at 4 streams equal to the eager batched step; the segment
   head's program at 640x640 f32 (equal to `predict_step`, one greedy
   launch an image); the export-format harness at 640x640 (live, params,
   pt, pt2 all `ok`);
18. nas: `NAS("yolo_nas_s")` at 640x640 f32 (TF32 off): `predict` over
   the 12 1080p PNG frames, plain and with TTA (three scales, one NMS over
   their union), one greedy launch an image and nothing else, every
   greedy call exactly its plain version; `predict_step` and its TTA with
   every host sync an error and their device ms; `val` on 8 synthetic
   detection images; a `pt2` program equal to the eager step;
19. fastsam: `FastSAM("yolo_track")` at 640x640 f32: `everything` over the
   12 frames (one greedy launch a frame), each frame's keep set exactly
   the JAX host loop's at IoU 0.9 and 0.7, box, point and text prompts
   (the text through `StubEmbedder`), the greedy timed on the 256
   candidates' matrix;
20. sam_b, sam_mobile: `SAM("b")` and `SAM("mobile")` at 1024x1024 f32:
   `embed_image` and its device ms, a point, a box and a mixed prompt,
   `generate` at grid 8 and at grid 16 with a crop layer and no filter
   (3,840 masks into one greedy launch; the keep set exactly the plain
   version's, and over the top 512 masks the JAX host loop's; the greedy
   and the masks' IoU product timed), peak memory; a strict `sam_import`
   of the ViT-B model's own keys;
21. zoo: upstream's graphs as the JAX parser builds them
   (`tests/torch_port_zoo.py`), seeded random weights: YOLOv8-x with a
   MOTRTrack head (`scales` at x: 320/640/640 taps) through
   `MOTRTrack(...).predict` at 1536x800 bf16 over the slice phase's
   frames, then `yolo_track` through the same loop for comparison
   (frames/s, device ms a frame from a CUDA graph of
   `stream_step`, parameters, peak memory, 6 K1 and 1 greedy launch a
   frame and nothing else, every greedy call audited, every K1 call of
   the first frames held to the plain sampler on its own inputs); its
   `scale: l` form against `MOTRTrack("yolo_track")`: the same spec,
   weights and packed output bit for bit; the era detectors yolov3,
   yolov3-spp, yolov3-tiny, yolov5 (l), yolov5-p6 (l) and yolov6 (l, ReLU)
   through `NAS(cfg, imgsz=640)` and yolov8-seg (x) through
   `_TaskModel("segment")`, f32 with TF32 off, 4 1080p frames each (one
   audited greedy launch an image and nothing else, parameters,
   first-frame seconds), yolov5-p6's `predict(augment=True)` on one frame
   (its TTA sides rounded to its stride 64; one audited greedy launch
   over the three scales' union), and the v6 graph's `pt2` program equal
   to its eager step.

Every greedy call of the slice and multistream eager passes, the val
phase's instrumented pass, each slice_configs frame, the cli `predict`
and the task heads' `val` (outside CUDA-graph capture) is also held
exactly to the plain version and to the one-pass walk (`greedy_audit`).

Each phase line carries `at_seconds`, the script's time so far. Then a
`kernels` line, the card's name and power limit, and as the last
line `{"ok": true, "device": {...}}`. Any failed check exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
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
           "jv_assign", "take_along_axis", *VARIANT_KERNELS]
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
# K2's sort ranks a long row in windows of 4,096 points u = q*P + p: the
# queries of a training step with 256 GT slots (300 + 300 + 2 x 256
# denoising, Q*P = 4,448) and Q*P = 8,192 (two whole windows)
Q_LONG = {"q1112": 1112, "q2048": 2048}
# sampler cases at those Q*P, spread out and clustered
LONG_CASES = [(f"{name}_{spread}", dict(levels=LEVELS["1536x800"], q=q,
                                        loc_range=loc_range))
              for name, q in Q_LONG.items()
              for spread, loc_range in (("uniform", (-0.05, 1.05)),
                                        ("clustered", CLUSTERED))]
CLIP_LEN, TRAIN_STEPS = 5, 2
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


_T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One phase's JSON line, with the script's seconds so far."""
    print(json.dumps({"phase": phase, **kw,
                      "at_seconds": time.perf_counter() - _T0}), flush=True)


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
    cases += LONG_CASES
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
    at edge cases, and at Q*P past 4,096 (1,112 and 2,048 queries, spread
    out and clustered, where the sort ranks a long row in windows); time
    both. Returns the main-path record (1536x800, bf16).

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
    cases += LONG_CASES
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
    for name, kw in [("q77_h3", dict(levels=small, q=77, h=3)),
                     ("clustered_640x640", dict(levels=LEVELS["640x640"],
                                                q=Q_TRAIN,
                                                loc_range=CLUSTERED))] + \
            LONG_CASES:
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
            [("batch2", dict(levels=LEVELS["640x640"], b=2, q=Q_TRAIN))] + \
            LONG_CASES:
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
                               dict(loc_range=CLUSTERED)),
                              (torch.bfloat16, "q1112/bfloat16",
                               dict(q=Q_LONG["q1112"])),
                              (torch.bfloat16, "q1112_clustered/bfloat16",
                               dict(q=Q_LONG["q1112"], loc_range=CLUSTERED))):
            kw = {"q": Q_TRAIN, **kw}
            value, levels_, loc, attn = sampler_inputs(levels, dtype=dt,
                                                       seed=1, **kw)
            g = torch.randn(1, kw["q"], H * D, device="cuda", dtype=dt)
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


def nms_inputs(imgsz, b=1, seed=0, device="cuda", scores="uniform"):
    """What `nms_fixed` gets from an untrained YOLOv8 head at `imgsz`
    (every anchor: 1,344 at 256, 8,400 at 640): each anchor's box its
    centre +- (7.5 + noise) strides (the DFL expectation of near-equal
    bins), one class; `scores` "uniform" in [0, 1], or "smooth": a smooth
    function of the anchor's place in the image plus a little noise, as an
    untrained head's (and a trained head's around an object) fall off from
    a peak, so that the score order follows neighbouring boxes and the
    conflict chains run deep. Returns (boxes xyxy [b,N,4], scores [b,N],
    cls [b,N])."""
    import torch
    g = torch.Generator().manual_seed(seed)
    anchors, strides = [], []
    for s in (8, 16, 32):
        n = imgsz // s
        gy, gx = torch.meshgrid(torch.arange(n), torch.arange(n),
                                indexing="ij")
        anchors.append(torch.stack([gx + 0.5, gy + 0.5], -1).reshape(-1, 2))
        strides.append(torch.full((n * n,), float(s)))
    anc, st = torch.cat(anchors), torch.cat(strides)
    N = len(anc)
    dist = 7.5 + torch.randn(b, N, 4, generator=g) * 0.3
    boxes = torch.cat([(anc - dist[..., :2]) * st[:, None],
                       (anc + dist[..., 2:]) * st[:, None]], -1)
    if scores == "uniform":
        score = torch.rand(b, N, generator=g)
    elif scores == "smooth":
        x, y = (anc * st[:, None] / imgsz).unbind(-1)
        score = 0.5 + 0.3 * torch.sin(3.0 * x + 0.5) * torch.cos(2.0 * y) + \
            0.01 * torch.rand(b, N, generator=g)
    else:
        raise ValueError(scores)
    cls = torch.zeros(b, N, dtype=torch.long)
    return boxes.to(device), score.to(device), cls.to(device)


def nms_fixed_conflicts(imgsz, b=1, seed=0, device="cuda", conf=0.001,
                        iou=0.7, scores="uniform"):
    """The conflict matrix and valid mask that `nms_fixed` hands the greedy
    for `nms_inputs` (scores sorted, same class, dense), taken from
    `nms_fixed` itself."""
    from mo_yolo_tpu_torch.models import detect
    captured, greedy = [], detect.greedy_keep_from_conflicts

    def spy(conflict, valid):
        captured.append((conflict, valid))
        return valid                # any keep: only the inputs are kept
    detect.greedy_keep_from_conflicts = spy
    try:
        detect.nms_fixed(*nms_inputs(imgsz, b, seed, device, scores), iou,
                         conf)
    finally:
        detect.greedy_keep_from_conflicts = greedy
    return captured[0]


def bound_greedy(conflict, valid):
    """The greedy's least time: the conflict matrix and valid read once,
    keep written once (one byte each); one test a conflict element."""
    return _roofline(conflict.numel() + 2 * valid.numel(), conflict.numel())


def greedy_call(conflict, valid):
    """The kernel's keep and its stats ([B, 2] int32 on the host: each
    stream's branch, 0 the walk and 1 the fixed point's turns, and its
    steps or turns), in one launch."""
    import torch

    from mo_yolo_tpu_torch.ops.suppress import greedy_keep_from_conflicts
    stats = torch.full((valid.shape[0], 2), -1, dtype=torch.int32,
                       device=valid.device)
    before = greedy_keep_from_conflicts.launches
    keep = greedy_keep_from_conflicts(conflict, valid, stats)
    check(greedy_keep_from_conflicts.launches == before + 1,
          "greedy: not one launch")
    return keep, stats.cpu()


def check_walked(stats, M, what):
    """Every stream took the one-pass walk, in at most ceil(M/32) steps;
    returns the most steps."""
    check(bool((stats[:, 0] == 0).all() and (stats[:, 1] >= 0).all() and
               (stats[:, 1] <= (M + 31) // 32).all()),
          f"{what}: not the one-pass walk in at most {(M + 31) // 32} steps:"
          f" {stats.tolist()}")
    return int(stats[:, 1].max())


@contextlib.contextmanager
def greedy_audit(what):
    """Every greedy call of the tracker's and `nms_fixed`'s inside (outside
    CUDA-graph capture) runs the kernel with stats and keeps its inputs and
    keep, with no host sync; on leaving, each call's keep is held exactly
    to the plain version on the same inputs, and each stream's stats to
    the one-pass walk in at most ceil(M/32) steps. Yields a summary that
    is filled then: calls, streams, the largest M and the most steps."""
    import torch

    from mo_yolo_tpu_torch.models import detect, tracker
    from mo_yolo_tpu_torch.ops.suppress import (
        greedy_keep_from_conflicts, greedy_keep_from_conflicts_torch)
    calls, summary = [], {}

    def audited(conflict, valid):
        if conflict.device.type != "cuda" or \
                torch.cuda.is_current_stream_capturing():
            return greedy_keep_from_conflicts(conflict, valid)
        stats = torch.empty((valid.shape[0], 2), dtype=torch.int32,
                            device=valid.device)
        keep = greedy_keep_from_conflicts(conflict, valid, stats)
        calls.append((conflict, valid, keep, stats))
        return keep
    saved = tracker.greedy_keep_from_conflicts, detect.greedy_keep_from_conflicts
    tracker.greedy_keep_from_conflicts = audited
    detect.greedy_keep_from_conflicts = audited
    try:
        yield summary
    finally:
        tracker.greedy_keep_from_conflicts, \
            detect.greedy_keep_from_conflicts = saved
    steps = [0]
    for t, (conflict, valid, keep, stats) in enumerate(calls):
        want = greedy_keep_from_conflicts_torch(conflict, valid)
        check(torch.equal(keep, want), f"{what}: greedy call {t}: "
              f"{int((keep != want).sum())} differ from the plain version")
        steps.append(check_walked(stats.cpu(), valid.shape[1],
                                  f"{what}: greedy call {t}"))
    summary.update(calls=len(calls),
                   streams=sum(int(c[1].shape[0]) for c in calls),
                   max_m=max([int(c[1].shape[1]) for c in calls] or [0]),
                   max_steps=max(steps), exact=True)


# the streaming frame's M and sizes off the main path: up to ~1,300 a
# stream's bit rows all sit in the walk's shared memory, past it they are
# staged a word block at a time
GREEDY_LARGE_M = (1400, 2048, 4096)
# the task heads' NMS over every anchor: 1,344 at 256 (the facade's
# default), 8,400 at 640
NMS_IMGSZ = (256, 640)


def phase_greedy():
    """Hold the greedy-suppression kernel exactly to its plain version (the
    host-tested loop, run on the card) at B=4 on every case of
    `greedy_inputs`, at M=600 (the rows resident in shared memory) and at
    `GREEDY_LARGE_M` (staged), and on `nms_fixed`'s conflicts at N = 1,344
    and 8,400 with uniform and smooth scores (deep conflict chains); each
    stream's stats the one-pass walk in at most ceil(M/32) steps, the fixed
    point's turns on "any"; time both at one stream's frame (B=1) at M=600
    and M=2,048 and on the NMS matrices."""
    import torch

    from mo_yolo_tpu_torch.ops.suppress import (
        greedy_keep_from_conflicts, greedy_keep_from_conflicts_torch)
    results = {}
    for m in (GREEDY_M,) + GREEDY_LARGE_M:
        for case in ("frame", "random", "chain", "all_invalid", "any"):
            conflict, valid = greedy_inputs(case, m=m)
            got, stats = greedy_call(conflict, valid)
            want = greedy_keep_from_conflicts_torch(conflict, valid)
            check(got.dtype == torch.bool and torch.equal(got, want),
                  f"greedy {case} M={m}: {int((got != want).sum())} of "
                  f"{want.numel()} differ from the plain version")
            if case == "all_invalid":
                check(not got.any(), f"greedy all_invalid M={m}: something "
                      f"kept")
            if case == "any":
                check(bool((stats[:, 0] == 1).all()),
                      f"greedy any M={m}: not the turns: {stats.tolist()}")
            else:
                check_walked(stats, m, f"greedy {case} M={m}")
            results[f"{case}_m{m}"] = {"kept": int(got.sum()), "exact": True,
                                       "branch": stats[:, 0].tolist(),
                                       "steps": stats[:, 1].tolist()}
            del conflict, valid, got, want
    # nms_fixed's conflicts of an untrained YOLOv8 head: every anchor at
    # 256 and 640 (1,344 and 8,400), scores uniform or smooth
    nms_cases = [(imgsz, scores) for scores in ("uniform", "smooth")
                 for imgsz in NMS_IMGSZ]

    def nms_key(imgsz, scores, n):
        return f"nms_n{n}" if scores == "uniform" else f"nms_smooth_n{n}"
    for imgsz, scores in nms_cases:
        conflict, valid = nms_fixed_conflicts(imgsz, b=2, seed=2,
                                              scores=scores)
        n = conflict.shape[-1]
        got, stats = greedy_call(conflict, valid)
        want = greedy_keep_from_conflicts_torch(conflict, valid)
        check(torch.equal(got, want), f"greedy nms {scores} N={n}: "
              f"{int((got != want).sum())} differ from the plain version")
        check_walked(stats, n, f"greedy nms {scores} N={n}")
        results[nms_key(imgsz, scores, n)] = {
            "kept": int(got.sum()), "valid": int(valid.sum()),
            "conflicts_per_row": float(conflict.float().sum(-1).mean()),
            "exact": True, "steps": stats[:, 1].tolist()}
        del conflict, valid, got, want
    timings = {}

    def timed(conflict, valid, iters, plain_iters):
        _, stats = greedy_call(conflict, valid)
        return {"steps": int(stats[0, 1]),
                "ms": time_ms(lambda: greedy_keep_from_conflicts(
                    conflict, valid), iters=iters, warmup=max(2, iters // 10)),
                "device_ms": device_time_ms(
                    lambda: greedy_keep_from_conflicts(conflict, valid)),
                "plain_ms": time_ms(
                    lambda: greedy_keep_from_conflicts_torch(conflict, valid),
                    iters=plain_iters, warmup=2),
                **bound_greedy(conflict, valid)}
    for m in (GREEDY_M, 2048):
        conflict, valid = greedy_inputs("frame", b=1, m=m, seed=1)
        timings[f"m{m}"] = timed(conflict, valid, 200, 20)
    for imgsz, scores in nms_cases:
        conflict, valid = nms_fixed_conflicts(imgsz, b=1, seed=3,
                                              scores=scores)
        n = conflict.shape[-1]
        timings[nms_key(imgsz, scores, n)] = {
            "conflicts_per_row": float(conflict.float().sum(-1).mean()),
            **timed(conflict, valid, 50, 10)}
        del conflict, valid
    emit("greedy", checks=results, timing=timings)
    return {**timings[f"m{GREEDY_M}"], "max_abs_err": 0.0,
            "m2048": timings["m2048"],
            **{k: v for k, v in timings.items() if k.startswith("nms_")}}


# ---------------------------------------------------------------------- jv

# the matcher's problems and how they are made: `scripts/jv_bench.py`
# (`JV_CASES`, `jv_inputs`), shared with that script's timings beside a
# parent checkout
# a Dijkstra step's f32 operations a column: the reduced cost (2 subs), the
# compare and select, the argmin's compare, the v and minv updates
JV_FLOPS_PER_COLUMN = 6


def bound_jv(cost, mask, walked):
    """The matcher's least time on the card: the cost matrix's valid GT
    columns read once (Q floats a valid column; a padded column is never
    read: its row is constant 0 or dropped), the mask read once, the
    assignment written once; `JV_FLOPS_PER_COLUMN` f32 operations a column
    in each Dijkstra step this run's kernel walked (a padded row decided at
    once walks none). The kernel is not near it: its steps are a chain of
    dependent block-wide reductions (latency), which neither count sees."""
    B, Q, G = cost.shape
    return _roofline(int(mask.sum()) * Q * 4 + mask.numel() + B * G * 4,
                     walked * max(Q, G) * JV_FLOPS_PER_COLUMN)


def phase_jv():
    """Hold the matcher's kernel (`jv_assign`) exactly to its plain version
    (the same algorithm in tensor ops, its loop steered from the host, on
    the card) on every case of `JV_CASES`: the assignment, the Dijkstra
    steps, and the counts (`jv_counts`: steps walked, padded rows decided
    at once and walked); the kernel launched once with every host sync an
    error. Against scipy
    (`_scipy_assign`, on the host): the same assignment on the continuous
    costs, where the optimum is unique; on the ties as many pairs at the
    same total; at 1e6 ("rounding", where the JAX solver's f32 duals
    round) as many pairs within an ulp of 1e6 a pair. Times kernel and
    plain version at the training step's shapes (`JV_TIMED`), the steps
    walked and µs a walked step, and the aux layers' batch against its
    problems launched one by one."""
    import torch

    from mo_yolo_tpu_torch.ops.matching import (_scipy_assign, hungarian_jv,
                                                hungarian_jv_torch, jv_counts)
    from mo_yolo_tpu_torch.scripts.jv_bench import (JV_CASES, JV_TIMED,
                                                    jv_inputs)
    results, timings = {}, {}
    for case, (B, Q, G, n_valid, layout, kind) in JV_CASES.items():
        cost, mask = jv_inputs(case)
        torch.cuda.synchronize()
        before = hungarian_jv.launches
        counts = jv_counts(cost.device).zero_()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, steps = hungarian_jv(cost, mask, with_stats=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        check(hungarian_jv.launches == before + 1,
              f"jv {case}: not one launch")
        d = counts.tolist()
        counts.zero_()
        want, want_steps = hungarian_jv_torch(cost, mask)
        check(torch.equal(got, want) and torch.equal(steps, want_steps) and
              d == counts.tolist(),
              f"jv {case}: {int((got != want).sum())} of {got.numel()} "
              f"assignments, steps {steps.tolist()} and counts {d} against "
              f"{want_steps.tolist()} and {counts.tolist()} of the plain "
              f"version")
        c_np, m_np = cost.cpu().numpy(), mask.cpu().numpy()
        oracle = _scipy_assign(c_np, m_np)
        a = got.cpu().numpy()

        def total(assign, b):
            return sum(float(c_np[b, q, g]) for g, q in enumerate(assign[b])
                       if q >= 0)
        slack = 0.0625 * G if kind == "rounding" else 0.0
        for b in range(B):
            check((a[b] >= 0).sum() == (oracle[b] >= 0).sum() ==
                  min(Q, int(m_np[b].sum())) and
                  abs(total(a, b) - total(oracle, b)) <= slack,
                  f"jv {case}: problem {b} assigns {(a[b] >= 0).sum()} "
                  f"pairs at {total(a, b)}, scipy "
                  f"{(oracle[b] >= 0).sum()} at {total(oracle, b)}")
        if kind not in ("ties", "rounding"):
            check((a == oracle).all(), f"jv {case}: not scipy's assignment")
        results[case] = {"B": B, "Q": Q, "G": G, "valid": list(n_valid),
                         "layout": layout, "steps": steps.tolist(),
                         "walked_steps": d[0], "padded_decided": d[1],
                         "padded_walked": d[2], "exact_vs_plain": True,
                         "scipy": {"ties": "equal pairs and total",
                                   "rounding": "equal pairs, total within "
                                   "an ulp of 1e6 a pair"}.get(kind,
                                                               "equal")}
        if case in JV_TIMED:
            rec = timings[case] = {
                "ms": time_ms(lambda: hungarian_jv(cost, mask)),
                "device_ms": device_time_ms(lambda: hungarian_jv(cost, mask)),
                "plain_ms": time_ms(lambda: hungarian_jv_torch(cost, mask),
                                    iters=1, warmup=1),
                "steps": int(steps.sum()), "walked_steps": d[0],
                "padded_decided": d[1], "padded_walked": d[2],
                **bound_jv(cost, mask, d[0])}
            rec["device_us_per_walked_step"] = \
                rec["device_ms"] * 1e3 / max(d[0], 1)
            if B > 1:     # the batch against its problems one by one
                rec["one_by_one_device_ms"] = device_time_ms(
                    lambda: [hungarian_jv(cost[b:b + 1], mask[b:b + 1])
                             for b in range(B)])
    emit("jv", checks=results, timing=timings)
    return {**timings["aux"], "max_abs_err": 0.0, "shapes": timings}


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


def prepare(model, seed=0, shift_scores=False, bias=SCORE_BIAS):
    """Random BatchNorm statistics (seeded); with `shift_scores`, the score
    heads' bias set to `bias` (the CPU stream test's shift by default)."""
    import torch
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.running_mean.numel()
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
        if shift_scores:
            dec = model.decoder
            for head in (dec.enc_score_head, dec.dec_score_head[-1]):
                head.bias.fill_(bias)


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
    from mo_yolo_tpu_torch.ops.matching import hungarian_jv
    from mo_yolo_tpu_torch.ops.suppress import greedy_keep_from_conflicts
    return dict(zip(KERNELS, (ms_deform_attn, ms_deform_attn_backward,
                              greedy_keep_from_conflicts, hungarian_jv,
                              take_along_axis,
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
    """`stream_step` without the host. Each frame ([H, W, 3], or [B, H, W,
    3] for B streams in one batched step) is letterboxed on the card
    first. Eager: the frames stepped with every host sync an error
    (`torch.cuda.set_sync_debug_mode("error")`), K1 and the greedy
    suppression counted, each greedy call held to its plain version and to
    the one-pass walk (`greedy_audit`); then timed again, plainly. Graph: one
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
    xs = [device_letterbox(torch.from_numpy(f if f.ndim == 4 else f[None])
                           .cuda(), hw, scale_fill=True) for f in frames]
    n, batch = len(xs), xs[0].shape[0]
    torch.cuda.synchronize()
    reset_counts()
    state, eager = model.init_state(batch), []
    with greedy_audit(f"{imgsz} eager") as audit:
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
        st = model.init_state(batch)
        for x in xs:
            st, _ = model.stream_step(st, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager_loop()
    torch.cuda.synchronize()
    eager_fps = n / (time.perf_counter() - t0)

    static_x = xs[0].clone()
    state_in = model.init_state(batch)
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
        for a, b in zip(state_in, model.init_state(batch)):
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
    return {"frames": n, "streams": batch, "sync_debug_mode": "error",
            "eager_launches": launches, "greedy_audit": audit,
            "frames_equal": n,
            "eager_step_fps": eager_fps, "graph_fps": graph_fps,
            "graph_device_ms_per_frame": replay_ms,
            "graph_fps_device": 1e3 / replay_ms}


# ------------------------------------------------------------- multistream

# streams in one batched step, frames a stream (the first WARMUP untimed);
# the check against single streams: streams and frames
MS_STREAMS, MS_FRAMES = (1, 4, 8), 16
MS_CHECK_STREAMS, MS_CHECK_FRAMES = 4, 8
# The checks of batched against single-stream runs (f32, TF32 off): B
# streams in one batch take their convolutions' and products' sums in
# another order than one stream alone, ~1e-6 relative. A score that close
# to the tracker's 0.4 / 0.5 (or the validator's conf 0.5) would decide a
# birth, a drop or a kept row by that noise alone, so the models of these
# checks take a score-head bias that puts the scores far above them, and
# every score is held at least CHECK_MARGIN away first. Boxes within
# CHECK_BOX_ATOL of the input (in_context's bound for f32 noise).
CHECK_SCORE_BIAS, CHECK_MARGIN, CHECK_BOX_ATOL = 3.0, 1e-3, 1e-3


def score_margin(packed_rows):
    """The least distance of any score in these [M, 8] rows from 0.4 and
    0.5."""
    return min(float(np.minimum(np.abs(p[:, 4] - 0.4),
                                np.abs(p[:, 4] - 0.5)).min())
               for p in packed_rows)


def phase_multistream(imgsz="1536x800", cfg="yolo_track", dtype="bfloat16",
                      device=None, streams=MS_STREAMS, n_frames=MS_FRAMES,
                      check_streams=MS_CHECK_STREAMS,
                      check_frames=MS_CHECK_FRAMES, hw=(1080, 1920)):
    """B streams of synthetic 1080p frames (each its own static scene) in
    lockstep through `MultiStreamPredictor` at full `yolo_track` width,
    bf16, the score-bias shift so that tracks are born, for each B of
    `streams`: aggregate and per-stream frames/s eager (host clock after
    WARMUP steps), 6 K1 and 1 greedy launches a batched step and no
    matcher, peak memory; the same frames through a CUDA graph of the
    batched `stream_step` (`stream_graph`: every host sync an error in the
    eager pass, replayed outputs equal to the eager ones); the device's
    busy ms and idle share (`phase_profile`). Then, in f32 with TF32 off
    and the scores far from the thresholds (`CHECK_SCORE_BIAS`),
    `check_streams` streams of `check_frames` frames against each stream
    alone through `TrackPredictor`: every row's id, valid flag and class
    equal, boxes within `CHECK_BOX_ATOL`."""
    import torch

    from mo_yolo_tpu_torch.engine.multistream import MultiStreamPredictor
    from mo_yolo_tpu_torch.engine.predictor import TrackPredictor
    from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
    scenes = [static_scene(n_frames, hw, seed=s) for s in range(max(streams))]
    model = build_tracking_model(cfg, dtype=dtype, device=device, seed=0)
    prepare(model, shift_scores=True)
    on_card = next(model.parameters()).device.type == "cuda"
    n_layers = len(model.head.decoder.decoder.layers)
    runs = {}
    for B in streams:
        pred = MultiStreamPredictor(model, imgsz=imgsz, device=device)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        stamps, live = [], []
        for res in pred.stream(scenes[:B]):
            stamps.append(time.perf_counter())
            live.append(sum(int(r["valid"].sum()) for r in res))
        launches = counts()
        check(len(stamps) == n_frames, f"multistream B={B}: {len(stamps)} "
              f"steps for {n_frames} frames")
        if on_card:
            check(launches["ms_deform_attn_fwd"] == n_layers * n_frames and
                  launches["greedy_keep"] == n_frames and
                  launches["jv_assign"] == 0,
                  f"multistream B={B}: launches {launches}, expected "
                  f"{n_layers} x {n_frames} of the sampler, {n_frames} of "
                  f"the greedy suppression and no matcher")
        steady = stamps[WARMUP:]
        steps_per_s = (len(steady) - 1) / (steady[-1] - steady[0])
        rec = {"streams": B, "frames_per_stream": n_frames,
               "raw_hw": list(pred.raw_hw), "live_tracks_per_step": live,
               "launches": launches,
               "eager_frames_per_s": B * steps_per_s,
               "eager_frames_per_s_per_stream": steps_per_s,
               "max_memory_allocated": torch.cuda.max_memory_allocated()
               if on_card else None}
        check(sum(live) > 0, f"multistream B={B}: no track was born")
        if on_card:
            frames = [np.stack([sc[t] for sc in scenes[:B]])
                      for t in range(n_frames)]
            g = stream_graph(model, imgsz, frames, n_layers)
            g["graph_frames_per_s"] = B * g["graph_fps"]
            g["graph_frames_per_s_per_stream"] = g["graph_fps"]
            g["graph_device_ms_per_step"] = g["graph_device_ms_per_frame"]
            rec["graph"] = g
            prof = phase_profile(model, imgsz, frames[0])
            rec["device_busy_ms_per_step"] = prof["device_busy_ms"]
            rec["device_idle_share"] = prof["device_idle_share"]
            rec["profiled_step_ms"] = prof["step_ms"]
        runs[B] = rec
    del model, pred
    if on_card:
        torch.cuda.empty_cache()

    # the check: f32, TF32 off, each stream against itself alone
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = build_tracking_model(cfg, dtype="float32", device=device,
                                     seed=0)
        prepare(model, shift_scores=True, bias=CHECK_SCORE_BIAS)
        srcs = [sc[:check_frames] for sc in scenes[:check_streams]]
        multi = list(MultiStreamPredictor(model, imgsz=imgsz,
                                          device=device).stream(srcs))
        alone = []
        for frames in srcs:
            packed = spy_outputs(model)
            list(TrackPredictor(model, imgsz=imgsz, conf=0.5,
                                device=device).stream(frames))
            del model.stream_step                  # the spy
            alone.append([p[0].float().cpu().numpy() for p in packed])
        del model
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    margin = min(score_margin(a) for a in alone)
    check(margin > CHECK_MARGIN, f"multistream check: a score {margin} from "
          f"the tracker's thresholds: f32 noise could decide it")
    box_err, n_tracks = 0.0, 0
    for b, frames in enumerate(alone):
        check(len(frames) == len(multi) == check_frames,
              "multistream check: frame count")
        for t, want in enumerate(frames):
            got = multi[t][b]
            for k, col in (("obj_id", 6), ("valid", 7), ("cls", 5)):
                check(np.array_equal(got[k], want[:, col].astype(got[k].dtype)
                                     if k != "valid" else want[:, 7] > 0.5),
                      f"multistream check: stream {b} frame {t}: {k} "
                      f"differs batched and alone")
            box_err = max(box_err, float(np.abs(got["box"] -
                                                want[:, :4]).max()))
            n_tracks += int(got["valid"].sum())
    check(n_tracks > 0, "multistream check: no track")
    check(box_err <= CHECK_BOX_ATOL, f"multistream check: boxes {box_err} "
          f"off the single streams'")
    if on_card:
        torch.cuda.empty_cache()
    out = {"imgsz": imgsz, "dtype": dtype, "frame_hw": list(hw),
           "card": card_line() if on_card else None,
           "runs": {str(k): v for k, v in runs.items()},
           "check": {"streams": check_streams, "frames": check_frames,
                     "dtype": "float32", "tf32": False,
                     "score_bias": CHECK_SCORE_BIAS, "score_margin": margin,
                     "ids_valid_cls_equal": True, "tracks": n_tracks,
                     "box_max_abs_err": box_err,
                     "box_atol": CHECK_BOX_ATOL}}
    emit("multistream", **out)
    return out


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
    u8 = torch.from_numpy(frame if frame.ndim == 4 else frame[None]).cuda()
    x = device_letterbox(u8, to_hw(imgsz))
    state = model.init_state(u8.shape[0])
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
    rec = {"imgsz": imgsz, "streams": u8.shape[0], "backbone_ms": backbone,
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

def synthetic_clip(T, hw, nc, n_obj=20, seed=0, device="cuda",
                   max_gt=MAX_GT):
    """`scripts/train_bench.synthetic_clip`: a clip of T frames with
    `n_obj` moving boxes, its targets padded to `max_gt` rows."""
    from mo_yolo_tpu_torch.scripts.train_bench import synthetic_clip as clip
    return clip(T, hw, nc, n_obj, seed, device, max_gt)


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


def _kernel_ms(prof, n, needle):
    """Device ms and calls per step of the kernels whose name holds
    `needle`, from a profile of n steps."""
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and needle in e.key]
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) for e in rows)
    return {"ms_per_step": us / n / 1e3,
            "calls_per_step": sum(e.count for e in rows) / n}


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
    per_step, launches, scipy_calls = [], [], []
    for _ in range(steps):
        reset_counts()
        sync()
        t0 = time.perf_counter()
        with counting_scipy() as n_scipy:
            ts, m = step_fn(ts, clip, gen)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        sync()
        scipy_calls.append(n_scipy[0])
        per_step.append({"step_ms": (time.perf_counter() - t0) * 1e3,
                         "loss": loss, "grad_norm": gnorm})
        launches.append(counts())
        check(math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0,
              f"train: loss {loss}, grad norm {gnorm}")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    # the matcher a frame: the track assignment, the ndl - 1 aux layers in
    # one launch, the encoder's top-k (the recompute replays the tape: none
    # there)
    want = {**dict.fromkeys(KERNELS, 0),   # the study's kernels: none here
            "ms_deform_attn_fwd": (2 if tcfg.remat else 1) * ndl * T,
            "ms_deform_attn_bwd": ndl * T, "jv_assign": 3 * T}
    for c in launches:
        check(c == want or not on_card,
              f"train: launches {c} per step, expected {want}")
    # device activity only: `_device_split` and `_kernel_ms` read device
    # rows, and the host side of a step's trace is slow to process
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts, m = step_fn(ts, clip, gen)
        float(m["loss"])
        sync()
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy, n_ops, top = _device_split(prof, 1)
    matcher = _kernel_ms(prof, 1, "jv_assign_kernel")
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
    syncs = step_syncs(lambda: step_fn(ts, clip, gen)) if on_card else None
    check(not any(scipy_calls), f"train: scipy called {scipy_calls}")
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
           "device_ops_per_step": n_ops, "matcher_device": matcher,
           "host_split": split,
           "optimizer_sync_free": no_sync, "scipy_calls_per_step": scipy_calls,
           "host_syncs": syncs, "top": top}
    emit("train", **rec)
    rec["launches_total"] = {k: sum(c[k] for c in launches)
                             for k in launches[0]}
    del ts, model
    if on_card:
        torch.cuda.empty_cache()
    return rec


class counting_scipy:
    """Counts calls of scipy's `linear_sum_assignment` inside the block
    (the matcher's host solver before the kernel); `as` gives [count]."""

    def __enter__(self):
        import scipy.optimize
        self.mod, self.fn, self.n = scipy.optimize, \
            scipy.optimize.linear_sum_assignment, [0]

        def counted(*a, **kw):
            self.n[0] += 1
            return self.fn(*a, **kw)
        self.mod.linear_sum_assignment = counted
        return self.n

    def __exit__(self, *exc):
        self.mod.linear_sum_assignment = self.fn


def step_syncs(step):
    """One call of `step` with every host sync a warning
    (`torch.cuda.set_sync_debug_mode("warn")`), and every matcher call
    inside it with every host sync an error (so the matcher adds none).
    Returns the warnings' count and their sites (the Python line that made
    the synchronising call; those of the backward pass are raised where
    `backward` returns)."""
    import collections
    import warnings

    import torch

    from mo_yolo_tpu_torch.ops import matching
    hungarian = matching.hungarian

    def strict(cost, gt_mask):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return hungarian(cost, gt_mask)
        finally:
            torch.cuda.set_sync_debug_mode("warn")
    torch.cuda.synchronize()
    matching.hungarian = strict
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        matching.hungarian = hungarian
    torch.cuda.synchronize()
    sites = collections.Counter()
    for w in caught:
        if "synchronizing CUDA operation" not in str(w.message):
            continue
        path = Path(w.filename)
        where = path.relative_to(ROOT) if path.is_relative_to(ROOT) else \
            Path(*path.parts[-3:])
        sites[f"{where}:{w.lineno}"] += 1
    return {"count": sum(sites.values()), "sites": dict(sites.most_common()),
            "matcher_sync_debug_mode": "error"}


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
                       jitter=False, tape=None, replay=False,
                       num_denoising=0):
    """One training step's loss and gradients. With `tape` (and remat off,
    so that every matching goes through it), the step's Hungarian
    assignments are recorded, or with `replay` taken from the tape. With
    `num_denoising`, CDN is on: every step draws the same noise from a
    generator of the same seed."""
    import contextlib

    import torch

    from mo_yolo_tpu_torch.ops.matching import using_tape

    from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
    from mo_yolo_tpu_torch.train.losses import LossConfig
    from mo_yolo_tpu_torch.train.train_step import (TrainConfig,
                                                    make_train_step)
    model = build_tracking_model(cfg, dtype="float32", device=device, seed=0,
                                 impl=impl, num_denoising=num_denoising,
                                 **model_kw)
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
                           max_gt=MAX_GT, num_denoising=0, **model_kw):
    """The training step at full width and f32 (TF32 off), 320x320, T=2,
    dropout and FP injection off, CDN off unless `num_denoising` is given
    (then its noise is the same in every step), on the same weights and
    clip (padded to `max_gt` GT rows): one step with the kernels against
    one with the plain sampler (`impl="torch"`), both without remat and
    with the same Hungarian matchings (the plain step replays the kernel
    step's, so that a near-tie resolved the other way by f32 noise cannot
    send gradients to other queries); and the kernels with remat against
    the kernels without. With max_gt=256 and num_denoising=100 the sampler
    takes 300 + 300 + 512 = 1,112 queries: Q*P = 4,448, past the 4,096
    points of K2's sort windows.

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
                          device=device or "cuda", max_gt=max_gt)
    from mo_yolo_tpu_torch.ops.matching import AssignmentTape
    tape = AssignmentTape()
    reset_counts()
    runs = {"kernel_no_remat": _grads_of_one_step(
        None, False, clip, device, T, cfg, model_kw, False, tape, False,
        num_denoising)}
    launches = counts()
    runs.update({name: _grads_of_one_step(impl, remat, clip, device, T, cfg,
                                          model_kw, jitter, tape, replay,
                                          num_denoising)
                 for name, impl, remat, jitter, replay in (
                     ("plain", "torch", False, False, True),
                     ("plain_jitter", "torch", False, True, True))})
    runs["kernel"] = _grads_of_one_step(None, True, clip, device, T, cfg,
                                        model_kw, num_denoising=num_denoising)

    def rel(ga, gb):
        return {n: float((ga[n] - w).abs().max()) /
                max(float(w.abs().max()), 1e-12) for n, w in gb.items()}
    floor = rel(runs["plain_jitter"][1], runs["plain"][1])
    rec = {"imgsz": imgsz, "clip_len": T, "max_gt": max_gt,
           "num_denoising": num_denoising,
           "launches_kernel_no_remat": {
               k: launches[k] for k in ("ms_deform_attn_fwd",
                                        "ms_deform_attn_bwd")},
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
    if clip["images"].device.type == "cuda":
        check(launches["ms_deform_attn_fwd"] > 0 and
              launches["ms_deform_attn_bwd"] > 0,
              f"train_in_context: the kernel step launched {launches}")
    return rec


# --------------------------------------------------------------------- val

# the evaluation fixture: 2 sequences of 12 frames at 1920x1080 in the
# MOT-challenge layout, 12 moving boxes each; the stream_step of this
# frame of the loop runs with every host sync an error
VAL_SEQS, VAL_FRAMES, VAL_HW, VAL_OBJECTS, VAL_SYNC_FRAME = \
    2, 12, (1080, 1920), 12, 5
PERCENT_KEYS = ("HOTA", "DetA", "AssA", "LocA", "OWTA", "IDF1", "IDP", "IDR",
                "mAP50", "mAP50-95", "precision", "recall")


def phase_host_tools():
    """What the host C build finds: a compiler, which the frame decoders
    (PNG unfilter, the port's JPEG codec, TIFF's LZW, PackBits and CCITT)
    and the host resize need; they link nothing else but libm and
    libpthread. And whether Python's `lzma` imports, which LZMA TIFFs
    need (`check`ed in the formats phase)."""
    from mo_yolo_tpu_torch.utils import cuda_build
    try:
        cc = cuda_build._cc()
    except RuntimeError:
        cc = None
    try:        # the LZMA TIFF path runs Python's lzma (liblzma)
        import lzma
        lzma_ok = lzma.is_check_supported(lzma.CHECK_NONE)
    except ImportError:
        lzma_ok = False
    rec = {"cc": cc, "lzma_imports": lzma_ok}
    emit("host_tools", **rec)
    check(cc is not None, "no host C compiler: the frame decoders cannot be "
          "built")
    return rec


# the host resize against its plain version: (name, source h x w,
# channels, output h x w, PIL filter): a 1080p frame into the 1536x800
# letterbox, a 480x640 frame stretched to 640x640, and a segment head's
# 160x160 mask brought to a 1080p frame for its overlay
RESAMPLE_CASES = (
    ("frame_1080p_to_800x1422", (1080, 1920), 3, (800, 1422), "bilinear"),
    ("frame_480x640_to_640x640", (480, 640), 3, (640, 640), "bilinear"),
    ("mask_160x160_to_1080p", (160, 160), 1, (1080, 1920), "bicubic"))


def phase_resample(cases=RESAMPLE_CASES, iters=5):
    """The host resize (`data/letterbox.resample`: PIL's `Image.resize`
    arithmetic in `data/csrc/resample.c`, built with the host compiler)
    against its plain numpy version (`resize_plain`) on each of `cases`:
    every value equal; the C's ms a call (host clock, best and median of
    `iters`) beside the plain version's. Frames are random noise (every
    value's rounding meets the check), the mask random ellipses."""
    from mo_yolo_tpu_torch.data.letterbox import resample, resize_plain
    recs = {}
    for i, (name, src, c, hw, filt) in enumerate(cases):
        rng = np.random.default_rng(i)
        if c == 1:
            yy, xx = np.mgrid[:src[0], :src[1]] / np.asarray(
                src, float)[:, None, None]
            img = np.zeros(src, bool)
            for _ in range(4):
                cy, cx, ry, rx = rng.uniform([0.2, 0.2, 0.05, 0.05],
                                             [0.8, 0.8, 0.3, 0.3])
                img |= np.hypot((yy - cy) / ry, (xx - cx) / rx) < 1
            img = img.astype(np.uint8) * 255
        else:
            img = rng.integers(0, 256, (*src, c), np.uint8)
        ms = []
        for _ in range(iters):
            t = time.perf_counter()
            got = resample(img, hw, filt)
            ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        want = resize_plain(img, hw, filt)
        plain_ms = (time.perf_counter() - t) * 1e3
        recs[name] = {"src": list(src), "channels": c, "out": list(hw),
                      "filter": filt, "values": int(want.size),
                      "equal": int((got == want).sum()),
                      "differ": int((got != want).sum()),
                      "ms": min(ms), "ms_median": float(np.median(ms)),
                      "plain_ms": plain_ms}
    emit("resample", cases=recs)
    for name, rec in recs.items():
        check(rec["differ"] == 0 and rec["equal"] == rec["values"],
              f"resample {name}: {rec['differ']} of {rec['values']} values "
              f"differ from the plain version")
    return recs


# the JPEG phase: the fixtures PIL wrote (tests/data/jpeg, with the SHA-1
# of PIL's decode of each); the encode cases (name, quality, h x w), whose
# frames `jpeg_cases` makes; and the 1080p MOT17-like frame that is timed
JPEG_FIXTURES = Path("tests") / "data" / "jpeg"
JPEG_CASES = (("q1_1x1", 1, (1, 1)), ("q5_2x3", 5, (2, 3)),
              ("q24_17x9", 24, (17, 9)), ("q25_33x47", 25, (33, 47)),
              ("q50_64x80", 50, (64, 80)), ("q75_97x133", 75, (97, 133)),
              ("q95_120x160", 95, (120, 160)), ("q100_72x96", 100, (72, 96)))
JPEG_FRAME_QUALITY = 95     # the MOT17-like frames' JPEG quality
# a sanity bound, not the parity check (the digests are): the mean error of
# a q95 round trip of the MOT17-like frames (their texture is +-6 noise)
JPEG_Q95_MEAN_ERROR = 4
JPEG_THREADS = 8


def jpeg_cases():
    """[(name, uint8 [H, W, 3] frame, quality)] of `JPEG_CASES`: a gradient
    with two boxes and noise from the raw bytes of numpy's
    `default_rng(i)` (the bit generator's stream, the same in every numpy
    release)."""
    out = []
    for i, (name, q, (h, w)) in enumerate(JPEG_CASES):
        rng = np.random.default_rng(i)
        y, x = np.mgrid[0:h, 0:w]
        img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                        (x + y) * 127 // max(h + w - 2, 1)], -1)
        noise = np.frombuffer(rng.bytes(h * w * 3), np.uint8).reshape(
            h, w, 3) % 48
        img = np.clip(img + noise.astype(np.int64) - 24, 0, 255).astype(
            np.uint8)
        img[h // 3:2 * h // 3, w // 4:w // 2] = (230, 40, 60)
        img[h // 2:, 2 * w // 3:] = (20, 200, 250)
        out.append((name, img, q))
    return out


# SHA-256 of each `jpeg_cases` frame, and of PIL's `save(buf, "JPEG",
# quality=q)` bytes of it (tests/test_torch_port_jpeg.py holds both to
# numpy and PIL)
JPEG_FRAME_DIGESTS = {
    "q1_1x1":
    "da4e3164c1facf1bc9b6c127376446b9e616c01e70453ba8e015ebf2a0ddbe46",
    "q5_2x3":
    "68b48ede5981d08cd107d50f2001f0fbf7e728cbd09965075a182cdd55f4bb5f",
    "q24_17x9":
    "94ef8e3235ee565118211b2071b353cfa0e09ca9259cbf081690c49c9cd3a4c5",
    "q25_33x47":
    "b1244d676bbf7dd46e1a9d750892f195664536675a994a690418c222ce1a9a8b",
    "q50_64x80":
    "834440b9662f578aa7f576bafbd1a149dfb48fdfb65d0e6c3eb792357cfca760",
    "q75_97x133":
    "bb9d20a1ed99358d62250ab54054b28bb36a4bfa3280d8d83b6d0cc2845715a7",
    "q95_120x160":
    "44a4fd0326cdf82f6cc09726322055abc1f2cb35e762f57360b4a721c4846be7",
    "q100_72x96":
    "9895630a23a18470451530e2d7ed56960849721f7883ff8e2de5eea931e5c718"}
JPEG_DIGESTS = {
    "q1_1x1":
    "7efd9097af728037d996008bab93a2bb71442afe0d47f76e136bcbc6bc8dc8b1",
    "q5_2x3":
    "3da18db5a3e7801ad458bf6063a5f4ce5ce7a303c2dcf79d7de1d9278fd32fa8",
    "q24_17x9":
    "2a065f24a270bce35cf1b6922e99249c5669c216beed61f13fefd36d5acadd0f",
    "q25_33x47":
    "14f90d7d550dd0bebee31d48ed154fa5ce166ce9df7e4034442ea6e0dd04d2c9",
    "q50_64x80":
    "45854037f59bb6112a9ef8c95dd99b24ea31ab368e39b3ae8c38626a1a1a2421",
    "q75_97x133":
    "6c007ff80ae7355fe4b73ac631e25ca7576e1afae5901336ac39377d91d5699c",
    "q95_120x160":
    "8bea2a602d2655b4f3a903969ab0c10f83a4028bb42eac6493f5bfea55df43ab",
    "q100_72x96":
    "2cf8b3aa1a05c9681d087d70b62362d394f27b8183d9169f4f8508fde853251e"}


def phase_jpeg(hw=VAL_HW, iters=5, threads=JPEG_THREADS):
    """The port's JPEG codec (`data/jpeg.py`, host C built by the host
    compiler, no libjpeg) on the card's host: its decode of every fixture
    PIL wrote against the SHA-1 of PIL's decode (`tests/data/jpeg/
    manifest.json`: baseline 4:4:4, 4:2:2 and 4:2:0, grey, sizes down to
    1x1, optimized tables, restart markers, progressive); its encode of
    each `jpeg_cases` frame against the SHA-256 of PIL's bytes
    (`JPEG_DIGESTS`). Then times a 1080p MOT17-like frame (`mot_sequence`)
    at quality 95, 4:2:0: the decode ms on one call, the ms a frame with
    `threads` threads decoding at once (as the predictor's prefetch
    workers do), the encode ms at 75, and the PNG decode of the same frame
    (host clock; best and median of `iters`)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from mo_yolo_tpu_torch.data.decode import decode_png
    from mo_yolo_tpu_torch.data.encode import encode_png
    from mo_yolo_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
    folder = ROOT / JPEG_FIXTURES
    manifest = json.loads((folder / "manifest.json").read_text())
    decoded = {}
    for name, want in manifest.items():
        img = decode_jpeg((folder / name).read_bytes())
        decoded[name] = {
            "shape": list(img.shape),
            "equal": list(img.shape) == want["shape"] and hashlib.sha1(
                img.tobytes()).hexdigest() == want["sha1"]}
    encoded = {}
    for name, img, q in jpeg_cases():
        data = encode_jpeg(img, q)
        encoded[name] = {
            "quality": q, "bytes": len(data),
            "frame_equal": hashlib.sha256(img.tobytes()).hexdigest() ==
            JPEG_FRAME_DIGESTS[name],
            "equal": hashlib.sha256(data).hexdigest() == JPEG_DIGESTS[name]}

    frame, _ = next(mot_sequence(0, 1, hw))
    data, enc95_ms, enc95_med = _best_ms(
        lambda: encode_jpeg(frame, JPEG_FRAME_QUALITY), iters)
    img, dec_ms, dec_med = _best_ms(lambda: decode_jpeg(data), iters)
    diff = np.abs(img.astype(np.int16) - frame)
    n = threads * 4
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(decode_jpeg, [data] * threads))       # warm
        t = time.perf_counter()
        outs = list(pool.map(decode_jpeg, [data] * n))
        threaded_ms = (time.perf_counter() - t) * 1e3 / n
    same = all(np.array_equal(o, img) for o in outs)
    data75, enc75_ms, enc75_med = _best_ms(lambda: encode_jpeg(frame, 75),
                                           iters)
    png = encode_png(frame)
    _, png_ms, png_med = _best_ms(lambda: decode_png(png), iters)
    rec = {"fixtures": decoded, "encode_cases": encoded,
           "timing_frame": {"hw": list(hw), "quality": JPEG_FRAME_QUALITY,
                            "subsampling": "4:2:0", "bytes": len(data),
                            "bytes_q75": len(data75), "png_bytes": len(png),
                            "mean_abs_error": float(diff.mean()),
                            "max_abs_error": int(diff.max())},
           "decode_ms": dec_ms, "decode_ms_median": dec_med,
           "decode_ms_per_frame_threaded": threaded_ms, "threads": threads,
           "threaded_equal": same,
           "encode_q75_ms": enc75_ms, "encode_q75_ms_median": enc75_med,
           "encode_q95_ms": enc95_ms, "encode_q95_ms_median": enc95_med,
           "png_decode_ms": png_ms, "png_decode_ms_median": png_med,
           "cpu_count": os.cpu_count()}
    emit("jpeg", **rec)
    bad = [k for k, v in decoded.items() if not v["equal"]]
    check(not bad and len(decoded) == len(manifest),
          f"jpeg: the port's decode differs from PIL's on {bad}")
    frames = [k for k, v in encoded.items() if not v["frame_equal"]]
    check(not frames, f"jpeg: numpy made other frames for {frames}")
    bad = [k for k, v in encoded.items() if not v["equal"]]
    check(not bad, f"jpeg: the port's encode differs from PIL's bytes on "
          f"{bad}")
    check(same, "jpeg: threaded decodes differ from the single call")
    check(diff.mean() < JPEG_Q95_MEAN_ERROR and img.shape == frame.shape,
          f"jpeg: the 1080p q95 round trip is off by {diff.mean()} a value")
    return rec


# the formats phase: the TIFF and WebP fixtures (tests/data/{tiff,webp},
# each with the SHA-1 of PIL's decode); the 1080p files it times, WebP,
# CMYK and arithmetic-coded JPEG, Group 4 (fixtures) and the TIFFs
# `format_timed_files` writes at run time (held to FORMAT_DIGESTS, PIL's
# decodes, which tests/test_torch_port_codecs.py checks); the frames
# `MOTRTrack.predict` reads, these in turn
FORMAT_FIXTURES = ("tiff", "webp")
FORMAT_TIMED = ("scene_1080p_q90.webp", "scene_1080p_lossless.webp")
FORMAT_TIMED_FIXTURES = (("jpeg", "cmyk_1080p.jpg"),
                         ("jpeg", "arith_progressive_1080p.jpg"),
                         ("tiff", "g4_1080p.tif"))
FORMAT_DIGESTS = {
    "jpeg_ycbcr_1080p.tif": "c669e540d2814dd45b35196265094735bb7af91e",
    "rgb16_deflate_pred2_1080p.tif": "b9190fb739e10316a21a1e0c513072069c8633c8"}
FORMAT_FRAMES = 12


def format_timed_files(tiff_fixtures, encode_jpeg):
    """name -> bytes of the 1080p TIFFs the formats phase writes: YCbCr
    JPEG strips (whole JFIF streams from `encode_jpeg` at quality 75) and
    16-bit RGB as Deflate with the predictor (`tests/data/tiff/
    make_fixtures.py`, numpy only)."""
    return {"jpeg_ycbcr_1080p.tif": tiff_fixtures.jpeg_tiff_1080p(
                encode_jpeg),
            "rgb16_deflate_pred2_1080p.tif": tiff_fixtures.tiff16_1080p()}
# the sources phase: a clip of SOURCE_FRAMES synthetic 1080p frames read
# every SOURCE_STRIDE-th; a stream read for STREAM_FRAMES frames
SOURCE_FRAMES, SOURCE_STRIDE, STREAM_FRAMES = 24, 2, 4


def _fixture_module(kind):
    """tests/data/<kind>/make_fixtures.py as a module of its own name."""
    import importlib.util
    path = ROOT / "tests" / "data" / kind / "make_fixtures.py"
    spec = importlib.util.spec_from_file_location(f"{kind}_fixtures", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _best_ms(fn, iters):
    ms = []
    for _ in range(iters):
        t = time.perf_counter()
        out = fn()
        ms.append((time.perf_counter() - t) * 1e3)
    return out, min(ms), float(np.median(ms))


def _check_predict(what, results, launches, n_layers, n, on_card):
    check(len(results) == n, f"{what}: {len(results)} results, {n} frames")
    for r in results:
        check(np.isfinite(np.asarray(r.boxes_xyxy, np.float64)).all(),
              f"{what}: non-finite boxes")
    if on_card:
        check(launches["ms_deform_attn_fwd"] == n_layers * n and
              launches["greedy_keep"] == n,
              f"{what}: launches {launches}, expected {n_layers} x {n} of "
              f"the sampler and {n} of the greedy suppression")
        others = {k: v for k, v in launches.items()
                  if k not in ("ms_deform_attn_fwd", "greedy_keep") and v}
        check(not others, f"{what}: other kernels launched: {others}")


def phase_formats(tracker=None, iters=5, threads=JPEG_THREADS,
                  n_predict=FORMAT_FRAMES):
    """The port's TIFF and WebP decoders (`data/tiff.py`, `data/webp.py`,
    host C, no libtiff or libwebp) on the card's host: `load_image` of
    every fixture of `tests/data/{tiff,webp}` against the SHA-1 of PIL's
    decode in their manifests (TIFF: each compression, JPEG and CCITT
    included, strips, tiles, planar, the photometric interpretations, CMYK,
    16- and 32-bit and float samples, both predictors, BigTIFF, both byte
    orders, fill order 2, orientations; WebP: lossy, lossless, alpha, an
    animation's first frame at an offset, VP8X metadata); then the ms to
    decode each 1080p file: the lossy and lossless WebP fixtures, a Deflate
    TIFF with the predictor, the CMYK and the arithmetic-coded progressive
    JPEG fixtures, the Group 4 fixture, and the YCbCr JPEG and 16-bit
    Deflate TIFFs `format_timed_files` writes (one call, best and median of
    `iters`, and a frame with `threads` threads at once), each held to
    PIL's digest. With `tracker`, its `predict` over a folder of
    `n_predict` frames, these 1080p files in turn (but the Deflate TIFF):
    every frame decoded to its digest, frames/s, and 6 K1 and 1 greedy
    launch a frame."""
    import hashlib
    import lzma
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from mo_yolo_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
    from mo_yolo_tpu_torch.data.loaders import load_image
    from mo_yolo_tpu_torch.data.tiff import decode_tiff
    from mo_yolo_tpu_torch.data.webp import decode_webp
    check(lzma.is_check_supported(lzma.CHECK_NONE),
          "formats: Python's lzma cannot read LZMA TIFFs here")
    manifests, decoded = {}, {}
    for kind in FORMAT_FIXTURES + ("jpeg",):
        folder = ROOT / "tests" / "data" / kind
        manifests[kind] = json.loads((folder / "manifest.json").read_text())
        if kind == "jpeg":                  # decoded in the jpeg phase
            continue
        for name, want in manifests[kind].items():
            img = load_image(folder / name)
            decoded[name] = list(img.shape) == want["shape"] and hashlib.sha1(
                img.tobytes()).hexdigest() == want["sha1"]
    webp_dir = ROOT / "tests" / "data" / "webp"
    files = {name: (webp_dir / name).read_bytes() for name in FORMAT_TIMED}
    files["tiff_1080p_deflate_predictor.tif"] = \
        _fixture_module("tiff").tiff_1080p()
    digests = {name: manifests["webp"][name]["sha1"] for name in FORMAT_TIMED}
    for kind, name in FORMAT_TIMED_FIXTURES:
        files[name] = (ROOT / "tests" / "data" / kind / name).read_bytes()
        digests[name] = manifests[kind][name]["sha1"]
    files.update(format_timed_files(_fixture_module("tiff"), encode_jpeg))
    digests.update(FORMAT_DIGESTS)
    decoders = {".webp": decode_webp, ".jpg": decode_jpeg, ".tif": decode_tiff}
    timing = {}
    for name, data in files.items():
        fn = decoders[Path(name).suffix]
        img, ms, med = _best_ms(lambda: fn(data), iters)
        n = threads * 4
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(fn, [data] * threads))               # warm
            t = time.perf_counter()
            outs = list(pool.map(fn, [data] * n))
            threaded = (time.perf_counter() - t) * 1e3 / n
        timing[name] = {"bytes": len(data), "shape": list(img.shape),
                        "decode_ms": ms, "decode_ms_median": med,
                        "decode_ms_per_frame_threaded": threaded,
                        "threaded_equal": all(np.array_equal(o, img)
                                              for o in outs),
                        "equal": name not in digests or hashlib.sha1(
                            img.tobytes()).hexdigest() == digests[name]}
    rec = {"fixtures": decoded, "timing": timing, "threads": threads,
           "cpu_count": os.cpu_count()}
    if tracker is not None:
        on_card = tracker.device.type == "cuda"
        n_layers = len(tracker.model.head.decoder.decoder.layers)
        mix = [name for name in files if name in digests]
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            for i in range(n_predict):
                name = mix[i % len(mix)]
                (Path(tmp) / f"{i:06d}{Path(name).suffix}").write_bytes(
                    files[name])
            if on_card:
                torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            results = list(tracker.predict(tmp, conf=0.5))
            seconds = time.perf_counter() - t
            launches = counts()
        frames_equal = all(
            hashlib.sha1(r.orig_img.tobytes()).hexdigest() ==
            digests[mix[i % len(mix)]] for i, r in enumerate(results))
        rec["predict"] = {"imgsz": tracker.imgsz, "frames": len(results),
                          "formats": [mix[i % len(mix)]
                                      for i in range(n_predict)],
                          "seconds": seconds, "fps": len(results) / seconds,
                          "launches": launches,
                          "frames_equal": frames_equal,
                          "card": card_line() if on_card else None}
    emit("formats", **rec)
    bad = [k for k, v in decoded.items() if not v]
    check(not bad and len(decoded) == sum(
        len(manifests[k]) for k in FORMAT_FIXTURES),
          f"formats: the port's decode differs from PIL's on {bad}")
    check(all(t["threaded_equal"] for t in timing.values()),
          "formats: threaded decodes differ from the single call")
    bad = [k for k, t in timing.items() if not t["equal"]]
    check(not bad, f"formats: a timed 1080p decode differs from PIL's "
          f"digest: {bad}")
    if tracker is not None:
        check(frames_equal, "formats: a predicted frame differs from its "
              "file's digest")
        _check_predict("formats", results, launches, n_layers, n_predict,
                       on_card)
    return rec


def phase_sources(tracker, n_frames=SOURCE_FRAMES, stride=SOURCE_STRIDE,
                  stream_frames=STREAM_FRAMES, hw=(1080, 1920)):
    """Video through `MOTRTrack.predict` as the JAX package reads it (an
    ffmpeg rawvideo pipe, `data/loaders.VideoSource`). The card's machine
    has no ffmpeg: a stand-in `ffmpeg`/`ffprobe` (`tests/ffmpeg_stub.py`,
    Python run by this interpreter) goes first on PATH and serves
    `n_frames` synthetic 1080p frames as `clip.mp4`; the phase reports
    which binary ran. `predict(source=clip.mp4, vid_stride=stride,
    save=True)`: every `stride`-th frame, named `clip.mp4#<i>`, equal to
    the frame served; the saved JPEGs `clip_<n>.jpg` read back at 1080p;
    frames/s; 6 K1 and 1 greedy launch a kept frame. Then a
    `StreamSource` over a stand-in `rtsp://` URL with `max_frames`: an
    ordered subset of the served frames, the stream's ffmpeg ended."""
    import shutil
    import tempfile

    import torch

    from mo_yolo_tpu_torch.data.loaders import StreamSource, load_image
    sys.path.insert(0, str(ROOT))
    from tests import ffmpeg_stub
    on_card = tracker.device.type == "cuda"
    n_layers = len(tracker.model.head.decoder.decoder.layers)
    frames = np.stack(static_scene(n_frames, hw=hw, seed=3))
    env_keys = ("PATH", ffmpeg_stub.STREAM_ENV, ffmpeg_stub.FPS_ENV,
                ffmpeg_stub.LOG_ENV)
    saved_env = {k: os.environ.get(k) for k in env_keys}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        system_ffmpeg = shutil.which("ffmpeg")
        (tmp / "bin").mkdir()
        ffmpeg_stub.install(tmp / "bin")
        log = tmp / "calls.jsonl"
        try:
            os.environ["PATH"] = f"{tmp / 'bin'}{os.pathsep}" \
                                 f"{os.environ.get('PATH', '')}"
            os.environ[ffmpeg_stub.LOG_ENV] = str(log)
            used = shutil.which("ffmpeg")
            clip = tmp / "clip.mp4"
            with open(clip, "wb") as f:
                np.save(f, frames)
            if on_card:
                torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            results = list(tracker.predict(str(clip), vid_stride=stride,
                                           save=True, conf=0.5,
                                           save_dir=str(tmp / "out")))
            seconds = time.perf_counter() - t
            launches = counts()
            kept = list(range(0, n_frames, stride))
            paths_ok = [r.path for r in results] == [
                f"{clip}#{i:06d}" for i in kept]
            frames_ok = all(np.array_equal(r.orig_img, frames[i])
                            for r, i in zip(results, kept))
            saved = sorted(p.name for p in (tmp / "out").glob("*.jpg"))
            read_back = [load_image(tmp / "out" / n).shape for n in saved]
            # a live stream (the clip's frames, 50 a second), read slower
            # than it is served
            os.environ[ffmpeg_stub.STREAM_ENV] = str(clip)
            os.environ[ffmpeg_stub.FPS_ENV] = "50"
            url = "rtsp://camera.local/stream"
            got = []
            for name, img in StreamSource(url, max_frames=stream_frames):
                got.append((name, next(i for i in range(n_frames) if
                                       np.array_equal(img, frames[i]))))
                time.sleep(0.05)
            calls = [json.loads(line) for line in
                     log.read_text().splitlines()] if log.exists() else []
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        alive = []
        for c in calls:
            try:
                with open(f"/proc/{c['pid']}/stat") as f:
                    if f.read().rsplit(")", 1)[1].split()[0] != "Z":
                        alive.append(c["pid"])
            except (FileNotFoundError, IndexError):
                pass
    idx = [i for _, i in got]
    rec = {"ffmpeg": used, "stub": True, "system_ffmpeg": system_ffmpeg,
           "clip": {"frames": n_frames, "hw": list(hw), "vid_stride": stride},
           "imgsz": tracker.imgsz, "kept_frames": len(results),
           "paths_equal": paths_ok, "frames_equal": frames_ok,
           "saved": saved, "saved_shapes": [list(s) for s in read_back],
           "seconds": seconds, "fps": len(results) / seconds,
           "launches": launches,
           "stream": {"names": [n for n, _ in got], "served_index": idx},
           "ffmpeg_calls": [c["tool"] for c in calls],
           "ffmpeg_alive_after": alive,
           "card": card_line() if on_card else None}
    emit("sources", **rec)
    check(used == str(tmp / "bin" / "ffmpeg"),
          f"sources: PATH found {used}, not the stand-in")
    check(paths_ok and frames_ok,
          "sources: the predicted frames are not the clip's kept frames")
    check(saved == [f"clip_{n:06d}.jpg" for n in range(len(kept))] and
          all(s == (*hw, 3) for s in read_back),
          f"sources: saved {saved} {read_back}")
    _check_predict("sources", results, launches, n_layers, len(kept),
                   on_card)
    check([n for n, _ in got] == [f"{url}#{i:06d}"
                                  for i in range(stream_frames)] and
          idx == sorted(set(idx)),
          f"sources: the stream gave {got}")
    check(not alive, f"sources: ffmpeg processes {alive} still run")
    return rec


def write_png(path, img, level=1):
    """An 8-bit RGB PNG of uint8 [H, W, 3] `img` written with stdlib zlib,
    row y filtered with type y % 5 (None, Sub, Up, Average, Paeth), so that
    decoding it runs every unfilter path."""
    import struct
    import zlib
    h, w, _ = img.shape
    x = img.reshape(h, w * 3).astype(np.int16)
    up = np.concatenate([np.zeros((1, w * 3), np.int16), x[:-1]])
    left = np.concatenate([np.zeros((h, 3), np.int16), x[:, :-3]], 1)
    ul = np.concatenate([np.zeros((h, 3), np.int16), up[:, :-3]], 1)
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    preds = (np.zeros_like(x), left, up, (left + up) >> 1, paeth)
    types = np.arange(h) % 5
    rows = np.empty((h, 1 + w * 3), np.uint8)
    rows[:, 0] = types
    for t, pred in enumerate(preds):
        sel = types == t
        rows[sel, 1:] = ((x[sel] - pred[sel]) & 0xff).astype(np.uint8)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) +
        chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) +
        chunk(b"IEND", b""))


def mot_sequence(s, n_frames=VAL_FRAMES, hw=VAL_HW, n_obj=VAL_OBJECTS,
                 seed=0):
    """Frames of synthetic sequence `s`: a textured gradient with `n_obj`
    coloured boxes moving at constant speed. Yields (uint8 [H, W, 3] frame,
    its MOT gt rows)."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed + s)
    base = np.stack([xx * 200 // w, yy * 200 // h,
                     np.full_like(xx, 60 + 40 * s)], -1)
    base = (base + rng.integers(0, 12, base.shape)).astype(np.uint8)
    size = np.stack([rng.uniform(0.02, 0.06, n_obj) * w,
                     rng.uniform(0.08, 0.24, n_obj) * h], -1)
    c0 = rng.uniform(0.15, 0.85, (n_obj, 2)) * (w, h)
    vel = rng.uniform(-6, 6, (n_obj, 2))
    colour = rng.integers(0, 256, (n_obj, 3))
    for t in range(n_frames):
        img = base.copy()
        rows = []
        c = np.clip(c0 + t * vel, size / 2 + 1, (w, h) - size / 2 - 1)
        for k in range(n_obj):
            x0, y0 = (c[k] - size[k] / 2).astype(int)
            x1, y1 = (c[k] + size[k] / 2).astype(int)
            img[y0:y1, x0:x1] = colour[k]
            rows.append([t + 1, k + 1, x0, y0, x1 - x0, y1 - y0, 1, 1, 1.0])
        yield img, rows


def mot_fixture(root, n_seq=VAL_SEQS, n_frames=VAL_FRAMES, hw=VAL_HW,
                n_obj=VAL_OBJECTS, seed=0, ext=".png"):
    """Synthetic sequences (`mot_sequence`) in the MOT-challenge layout
    (`root/images/train/<seq>/img1/000001.png`, `gt/gt.txt`,
    `seqinfo.ini`), written by `write_png`, or with `ext=".jpg"` by the
    port's JPEG encoder at `JPEG_FRAME_QUALITY` (MOT17's own layout,
    `imExt=.jpg`).
    Returns {real path of a frame: sha1 of the frame a decoder must give}
    (for a JPEG, the port's decode of the bytes written, made here), and
    for a JPEG fixture also the mean and largest absolute difference of
    those decodes from the frames encoded, under the key "jpeg_error"."""
    import hashlib

    from mo_yolo_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
    from mo_yolo_tpu_torch.data.mot_challenge import write_mot_gt
    h, w = hw
    digests, err = {}, []
    for s in range(n_seq):
        seq = Path(root) / "images" / "train" / f"MOT17-{s + 1:02d}"
        (seq / "img1").mkdir(parents=True)
        rows = []
        for t, (img, frame_rows) in enumerate(
                mot_sequence(s, n_frames, hw, n_obj, seed)):
            rows += frame_rows
            path = seq / "img1" / f"{t + 1:06d}{ext}"
            if ext == ".png":
                write_png(path, img)
                want = img
            else:
                data = encode_jpeg(img, JPEG_FRAME_QUALITY)
                path.write_bytes(data)
                want = decode_jpeg(data)
                diff = np.abs(want.astype(np.int16) - img)
                err.append((float(diff.mean()), int(diff.max())))
            digests[str(path.resolve())] = hashlib.sha1(
                want.tobytes()).hexdigest()
        write_mot_gt(str(seq / "gt" / "gt.txt"), rows)
        (seq / "seqinfo.ini").write_text(
            f"[Sequence]\nname={seq.name}\nimDir=img1\nframeRate=30\n"
            f"seqLength={n_frames}\nimWidth={w}\nimHeight={h}\n"
            f"imExt={ext}\n")
    if err:
        digests["jpeg_error"] = {"mean": float(np.mean([e[0] for e in err])),
                                 "max": max(e[1] for e in err)}
    return digests


def task_fixture(root, task, n_train=12, n_val=4, hw=(480, 640), nc=5,
                 n_obj=4, n_kpt=17, seed=0, obj_scale=1.0):
    """A synthetic dataset for a YOLOv8 task head, written with
    `write_png` (generated, nothing read from elsewhere); objects span
    0.12-0.3 of the width and 0.15-0.4 of the height, times `obj_scale`:

    - segment: `root/images/{train,val}/NNNNNN.png` on a noisy gradient,
      each with `n_obj` star-shaped polygons filled in their class's
      colour, and `root/labels/...txt` rows `cls x1 y1 ...` (normalized);
    - pose: boxes with `n_kpt` visible keypoints each (dots), rows `cls cx
      cy w h kx ky 2 ...`;
    - detect: the same boxes without keypoints, rows `cls cx cy w h`;
    - classify: `root/{train,val}/class<k>/NNNNNN.png`, a class's colour
      under noise.

    Returns the dataset yaml's path (segment, pose) or the tree's root."""
    from mo_yolo_tpu_torch.data.seg_pose_labels import fill_polygon
    root = Path(root)
    rng = np.random.default_rng(seed)
    h, w = hw
    colours = rng.integers(40, 256, (nc, 3))
    yy, xx = np.mgrid[0:h, 0:w]
    for split, n in (("train", n_train), ("val", n_val)):
        for i in range(n):
            img = np.stack([xx * 160 // w, yy * 160 // h,
                            np.full_like(xx, 50)], -1)
            img = (img + rng.integers(0, 30, img.shape)).astype(np.uint8)
            if task == "classify":
                c = i % nc
                img = np.clip(img // 3 + colours[c] * 2 // 3, 0,
                              255).astype(np.uint8)
                d = root / split / f"class{c}"
                d.mkdir(parents=True, exist_ok=True)
                write_png(d / f"{i:06d}.png", img)
                continue
            rows = []
            for k in range(n_obj):
                c = int(rng.integers(0, nc))
                bw = rng.uniform(0.12, 0.3) * obj_scale * w
                bh = rng.uniform(0.15, 0.4) * obj_scale * h
                cx, cy = rng.uniform(bw / 2, w - bw / 2), rng.uniform(
                    bh / 2, h - bh / 2)
                if task == "segment":
                    m = int(rng.integers(5, 12))
                    ang = np.sort(rng.uniform(0, 2 * np.pi, m))
                    r = rng.uniform(0.5, 1.0, m)
                    px = cx + r * np.cos(ang) * bw / 2
                    py = cy + r * np.sin(ang) * bh / 2
                    mask = fill_polygon(np.zeros((h, w), np.uint8),
                                        list(zip(px, py)))
                    img[mask > 0] = colours[c]
                    rows.append(" ".join([str(c)] + [
                        f"{v:.6f}" for xy in zip(px / w, py / h)
                        for v in xy]))
                elif task == "detect":
                    x0, y0 = int(cx - bw / 2), int(cy - bh / 2)
                    img[y0:y0 + int(bh), x0:x0 + int(bw)] = colours[c]
                    rows.append(" ".join([str(c)] + [
                        f"{v:.6f}" for v in (cx / w, cy / h, bw / w,
                                             bh / h)]))
                else:
                    x0, y0 = int(cx - bw / 2), int(cy - bh / 2)
                    img[y0:y0 + int(bh), x0:x0 + int(bw)] = colours[c]
                    kx = rng.uniform(cx - bw / 2, cx + bw / 2, n_kpt)
                    ky = rng.uniform(cy - bh / 2, cy + bh / 2, n_kpt)
                    for a, b in zip(kx.astype(int), ky.astype(int)):
                        img[max(b - 1, 0):b + 2, max(a - 1, 0):a + 2] = 255
                    rows.append(" ".join(
                        [str(c)] + [f"{v:.6f}" for v in
                                    (cx / w, cy / h, bw / w, bh / h)] +
                        [f"{v:.6f}" for a, b in zip(kx / w, ky / h)
                         for v in (a, b, 2.0)]))
            for sub, name, body in (("images", f"{i:06d}.png", img),
                                    ("labels", f"{i:06d}.txt", rows)):
                d = root / sub / split
                d.mkdir(parents=True, exist_ok=True)
                if sub == "images":
                    write_png(d / name, body)
                else:
                    (d / name).write_text("\n".join(body) + "\n")
    if task == "classify":
        return str(root)
    names = ", ".join(f"class{c}" for c in range(nc))
    (root / "data.yaml").write_text(
        f"path: {root}\ntrain: images/train\nval: images/val\n"
        f"nc: {nc}\nnames: [{names}]\n")
    return str(root / "data.yaml")


def phase_val(cfg="yolo_track", imgsz="1536x800", dtype="bfloat16",
              device=None, n_frames=VAL_FRAMES, hw=VAL_HW):
    """Evaluation through `MOTRTrack(...).val` on the synthetic MOT fixture
    (`mot_fixture`), converted to YOLO layout by the port's
    `convert_mot_to_yolo`, its train split (both sequences): random weights
    from seed 0, the score-bias shift so that tracks are born. Checks
    that every decoded frame equals the array written, exactly; that
    every metric is present and finite, the percentages within [0, 100]
    (MOTA at most 100: false positives take it below 0); 6 K1 launches and
    1 greedy launch a frame; that the track ids restart with the second
    sequence; and runs one `stream_step` with every host sync an error.
    Two passes over the same files: an instrumented one, which times the
    decode, the host letterbox, the step (synchronised) and the mAP
    stream's `dedup_for_map` a frame, checks the decoded frames (hashed
    outside the timed decode) and warms the card; then one untouched
    `val` call, which gives frames/s, the validator's fps and the
    launches."""
    import hashlib
    import os
    import tempfile

    import torch

    from mo_yolo_tpu_torch import MOTRTrack
    from mo_yolo_tpu_torch.data import dataset as ds_mod
    from mo_yolo_tpu_torch.data.mot_challenge import convert_mot_to_yolo
    from mo_yolo_tpu_torch.engine import validator as val_mod
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        digests = mot_fixture(Path(tmp) / "raw", n_frames=n_frames, hw=hw)
        write_s = time.perf_counter() - t0
        yaml_path = convert_mot_to_yolo(str(Path(tmp) / "raw"),
                                        str(Path(tmp) / "yolo"))
        tracker = MOTRTrack(cfg, imgsz=imgsz, dtype=dtype, seed=0,
                            device=device)
        prepare(tracker.model, shift_scores=True)
        on_card = tracker.device.type == "cuda"
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        ms = {"decode": [], "letterbox": [], "step": [], "dedup": []}
        decoded = {"frames": 0, "equal": 0}
        ids, strict_steps = [], []
        load, box, step = ds_mod.load_image, ds_mod.letterbox, \
            tracker.model.stream_step
        dedup = val_mod.dedup_for_map

        def timed_dedup(*a, **kw):
            t = time.perf_counter()
            out = dedup(*a, **kw)
            ms["dedup"].append((time.perf_counter() - t) * 1e3)
            return out

        def timed_load(path):
            t = time.perf_counter()
            img = load(path)
            ms["decode"].append((time.perf_counter() - t) * 1e3)
            decoded["frames"] += 1
            decoded["equal"] += (hashlib.sha1(img.tobytes()).hexdigest() ==
                                 digests.get(os.path.realpath(path)))
            return img

        def timed_box(*a, **kw):
            t = time.perf_counter()
            out = box(*a, **kw)
            ms["letterbox"].append((time.perf_counter() - t) * 1e3)
            return out

        def timed_step(state, x):
            strict = on_card and len(ms["step"]) == VAL_SYNC_FRAME
            sync()
            t = time.perf_counter()
            if strict:
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, out = step(state, x)
            finally:
                if strict:
                    torch.cuda.set_sync_debug_mode(0)
            sync()
            ms["step"].append((time.perf_counter() - t) * 1e3)
            if strict:
                strict_steps.append(len(ms["step"]) - 1)
            a = out[0].float().cpu().numpy()
            ids.append(a[a[:, 7] > 0.5, 6].astype(int))
            return state, out

        ds_mod.load_image, ds_mod.letterbox = timed_load, timed_box
        val_mod.dedup_for_map = timed_dedup
        tracker.model.stream_step = timed_step
        try:
            with greedy_audit("val") as audit:
                metrics_instrumented = tracker.val(yaml_path, split="train")
        finally:
            ds_mod.load_image, ds_mod.letterbox = load, box
            val_mod.dedup_for_map = dedup
            del tracker.model.stream_step
        # the untouched pass: nothing of the above wraps it
        sync()
        reset_counts()
        t0 = time.perf_counter()
        metrics = tracker.val(yaml_path, split="train")
        val_s = time.perf_counter() - t0
        launches = counts()
        multi = multistream_val(tracker.model, imgsz, yaml_path, cfg, device,
                                metrics)
        jpeg = jpeg_val(tracker, tmp, n_frames, hw, sync)
    n = VAL_SEQS * n_frames
    n_layers = len(tracker.model.head.decoder.decoder.layers)
    seq_ids = [np.concatenate(ids[i * n_frames:(i + 1) * n_frames])
               for i in range(VAL_SEQS)]
    rec = {"cfg": cfg, "imgsz": imgsz, "dtype": dtype,
           "frames": n, "frame_hw": list(hw),
           "card": card_line() if on_card else None, "greedy_audit": audit,
           "val_frames_per_s": n / val_s, "validator_fps": metrics["fps"],
           "instrumented_validator_fps": metrics_instrumented["fps"],
           "metrics_equal_across_passes": all(
               metrics_instrumented[k] == v for k, v in metrics.items()
               if k != "fps"),
           "decode_ms_per_frame": float(np.mean(ms["decode"])),
           "letterbox_ms_per_frame": float(np.mean(ms["letterbox"])),
           "step_ms_per_frame": float(np.median(ms["step"])),
           "dedup_for_map_ms_per_frame": float(np.mean(ms["dedup"])),
           "fixture_write_s": write_s, "decoded_equal": decoded,
           "launches": launches, "sync_checked_step": strict_steps,
           "first_id_per_sequence": [int(i.min()) if len(i) else None
                                     for i in seq_ids],
           "ids_per_sequence": [len(set(i.tolist())) for i in seq_ids],
           "metrics": metrics, "multistream": multi, "jpeg": jpeg}
    emit("val", **rec)
    check(decoded["frames"] == n and decoded["equal"] == n,
          f"val: decoded frames {decoded} of {n} equal to those written")
    for k in PERCENT_KEYS + ("MOTA", "IDSW", "fps"):
        check(k in metrics and math.isfinite(metrics[k]),
              f"val: metric {k} missing or not finite: {metrics.get(k)}")
    for k in PERCENT_KEYS:
        check(0 <= metrics[k] <= 100, f"val: {k} = {metrics[k]}")
    check(metrics["MOTA"] <= 100 and metrics["IDSW"] >= 0 and
          metrics["fps"] > 0, f"val: {metrics}")
    jm = jpeg["metrics"]
    dec = jpeg["decoded_equal"]
    check(dec["equal"] == dec["frames"] == dec["jpeg_files"] == n,
          f"val (JPEG): decoded frames {dec} of {n} equal to the port's "
          f"decode when written")
    for k in PERCENT_KEYS + ("MOTA", "IDSW", "fps"):
        check(k in jm and math.isfinite(jm[k]),
              f"val (JPEG): metric {k} missing or not finite: {jm.get(k)}")
    for k in PERCENT_KEYS:
        check(0 <= jm[k] <= 100, f"val (JPEG): {k} = {jm[k]}")
    check(jm["MOTA"] <= 100 and jm["IDSW"] >= 0,
          f"val (JPEG): {jm}")
    check(jpeg["round_trip_error"]["mean"] < JPEG_Q95_MEAN_ERROR,
          f"val (JPEG): frames off by {jpeg['round_trip_error']} after the "
          f"q95 round trip")
    check(all(len(i) for i in seq_ids), "val: a sequence has no track")
    check(seq_ids[1].min() == seq_ids[0].min(),
          f"val: ids do not restart with the second sequence "
          f"({rec['first_id_per_sequence']})")
    if on_card:
        check(launches["ms_deform_attn_fwd"] == n_layers * n and
              launches["greedy_keep"] == n,
              f"val: launches {launches}, expected {n_layers} x {n} of the "
              f"sampler and {n} of the greedy suppression")
        check(strict_steps == [VAL_SYNC_FRAME],
              "val: no step ran with host syncs as errors")
        jl = jpeg["launches"]
        check(jl["ms_deform_attn_fwd"] == n_layers * n and
              jl["greedy_keep"] == n and jl["jv_assign"] == 0,
              f"val (JPEG): launches {jl}, expected {n_layers} x {n} of the "
              f"sampler and {n} of the greedy suppression")
        check(multi["launches"]["ms_deform_attn_fwd"] ==
              n_layers * n_frames and
              multi["launches"]["greedy_keep"] == n_frames and
              multi["launches"]["jv_assign"] == 0,
              f"val: MultiStreamValidator launches {multi['launches']}, "
              f"expected {n_layers} x {n_frames} of the sampler and "
              f"{n_frames} of the greedy suppression (one a batched frame)")
    return rec


def jpeg_val(tracker, tmp, n_frames, hw, sync):
    """`val` on a JPEG copy of the evaluation fixture in MOT17's own layout
    (`img1/000001.jpg`, `imExt=.jpg`), written by the port's encoder at
    `JPEG_FRAME_QUALITY`: one call with only the frame decode wrapped
    (timed, and each frame checked against the port's decode of the bytes
    written, hashed outside the timing). Frames/s leave out the
    hashing."""
    import hashlib
    import os

    from mo_yolo_tpu_torch.data import dataset as ds_mod
    from mo_yolo_tpu_torch.data.mot_challenge import convert_mot_to_yolo
    t0 = time.perf_counter()
    digests = mot_fixture(Path(tmp) / "raw_jpg", n_frames=n_frames, hw=hw,
                          ext=".jpg")
    write_s = time.perf_counter() - t0
    error = digests.pop("jpeg_error")
    yaml_path = convert_mot_to_yolo(str(Path(tmp) / "raw_jpg"),
                                    str(Path(tmp) / "yolo_jpg"))
    load = ds_mod.load_image
    ms, hash_s = [], [0.0]
    decoded = {"frames": 0, "equal": 0, "jpeg_files": 0}

    def timed_load(path):
        t = time.perf_counter()
        img = load(path)
        ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        decoded["frames"] += 1
        decoded["jpeg_files"] += str(path).lower().endswith(".jpg")
        decoded["equal"] += (hashlib.sha1(img.tobytes()).hexdigest() ==
                             digests.get(os.path.realpath(path)))
        hash_s[0] += time.perf_counter() - t
        return img

    ds_mod.load_image = timed_load
    sync()
    reset_counts()
    t0 = time.perf_counter()
    try:
        metrics = tracker.val(yaml_path, split="train")
    finally:
        ds_mod.load_image = load
    val_s = time.perf_counter() - t0
    launches = counts()
    n = VAL_SEQS * n_frames
    return {"frames": n, "quality": JPEG_FRAME_QUALITY,
            "fixture_write_s": write_s,
            "round_trip_error": error, "decoded_equal": decoded,
            "decode_ms_per_frame": float(np.mean(ms)),
            "decode_ms_per_frame_median": float(np.median(ms)),
            "val_frames_per_s": n / (val_s - hash_s[0]),
            "validator_fps": metrics["fps"], "launches": launches,
            "metrics": metrics}


# the multi-stream validator's metrics against the single-stream one's:
# within 1e-4, the JAX package's rule (tests/test_engine.py)
VAL_MULTI_TOL = 1e-4


def multistream_val(model, imgsz, yaml_path, cfg, device, metrics):
    """`MultiStreamValidator` over the val fixture's sequences in one wave
    (B = VAL_SEQS): on the bf16 `model` timed (frames/s, launches) beside
    the single-stream `metrics` of the same model; then on an f32 model of
    the same seed with TF32 off and the scores far from the thresholds
    (`CHECK_SCORE_BIAS`, every score held CHECK_MARGIN away), against
    `TrackValidator` on that model: every metric within VAL_MULTI_TOL,
    IDSW exactly."""
    import torch

    from mo_yolo_tpu_torch.data.dataset import load_dataset_yaml
    from mo_yolo_tpu_torch.engine.validator import (MultiStreamValidator,
                                                    TrackValidator)
    from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
    files = load_dataset_yaml(yaml_path)["train"]
    on_card = next(model.parameters()).device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    bf16 = MultiStreamValidator(model, imgsz=imgsz, conf=0.5,
                                streams=VAL_SEQS)(files, max_gt=64)
    multi_s = time.perf_counter() - t0
    launches = counts()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        m32 = build_tracking_model(cfg, dtype="float32", device=device,
                                   seed=0)
        prepare(m32, shift_scores=True, bias=CHECK_SCORE_BIAS)
        packed = spy_outputs(m32)
        single = TrackValidator(m32, imgsz=imgsz, conf=0.5)(files, max_gt=64)
        del m32.stream_step                        # the spy
        margin = score_margin([p[0].float().cpu().numpy() for p in packed])
        multi = MultiStreamValidator(m32, imgsz=imgsz, conf=0.5,
                                     streams=VAL_SEQS)(files, max_gt=64)
        del m32
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    check(margin > CHECK_MARGIN, f"val: a score {margin} from the "
          f"thresholds: f32 noise could decide it")
    diff = {k: abs(single[k] - multi[k]) for k in single if k != "fps"}
    rec = {"streams": VAL_SEQS, "frames_per_s": len(files) / multi_s,
           "validator_fps": bf16["fps"],
           "single_stream_validator_fps": metrics["fps"],
           "launches": launches,
           "bf16_max_metric_diff_vs_single": max(
               abs(bf16[k] - metrics[k]) for k in metrics if k != "fps"),
           "f32_max_metric_diff": max(diff.values()),
           "f32_score_bias": CHECK_SCORE_BIAS, "f32_score_margin": margin,
           "f32_metrics": multi, "tol": VAL_MULTI_TOL}
    check(multi.keys() == single.keys() and
          max(diff.values()) <= VAL_MULTI_TOL and
          multi["IDSW"] == single["IDSW"],
          f"val: MultiStreamValidator's metrics off TrackValidator's: "
          f"{ {k: v for k, v in diff.items() if v > VAL_MULTI_TOL} }")
    return rec


# ----------------------------------------------------------------- trainer

# 2 sequences of 5 frames: 2 clips, so 2 steps an epoch, short of
# accumulate 3: the first epoch's last_full is saved mid-accumulation
TRAINER_SEQS, TRAINER_FRAMES, TRAINER_EPOCHS = 2, 5, 2
TRAINER_KW = dict(epochs=TRAINER_EPOCHS, batch=1, clip_len=CLIP_LEN,
                  accumulate=3, augment=True, val_every=1, log_every=1)
# the resume check trains on the first sequence alone, one step an epoch:
# at accumulate 2 its last_full is saved mid-accumulation and the resumed
# epoch makes the one update, from the restored held gradient. That update
# moves the moments and the count; the parameters take the schedule's
# first learning rate, the warmup's start (0 for weights and norms under
# "auto", as in the JAX package), and move from the update after.
RESUME_ACCUMULATE = 2


def state_tensors(ts):
    """A TrainState's tensors by name: parameters, buffers, EMA, optimizer
    state (moments, held gradient), count, mini_step and step."""
    import torch
    opt = ts.optimizer
    names = {id(p): n for n, p in ts.model.named_parameters()}
    out = {f"param/{n}": p.detach() for n, p in ts.model.named_parameters()}
    out.update({f"buffer/{n}": b for n, b in ts.model.named_buffers()})
    out.update({f"ema/{n}": e for n, e in ts.ema.items()})
    for g in opt.param_groups:
        for p in g["params"]:
            for k, v in opt.state.get(p, {}).items():
                out[f"opt/{names[id(p)]}/{k}"] = v
    out["count"] = torch.tensor(opt.count)
    out["mini_step"] = torch.tensor(opt.mini_step)
    out["step"] = torch.tensor(ts.step)
    return out


def _state_diff(a, b):
    """Tensors that differ between two `state_tensors`, and the largest
    difference relative to each tensor's largest magnitude."""
    import torch
    differ, worst = [], 0.0
    for k in a:
        x, y = a[k].double(), b[k].double()
        if not torch.equal(x, y):
            differ.append(k)
            scale = max(float(x.abs().max()), 1e-30)
            worst = max(worst, float((x - y).abs().max()) / scale)
    return {"tensors": len(a), "differ": len(differ),
            "first_differ": differ[:5], "max_rel_diff": worst}


class _Interrupt(Exception):
    pass


def trainer_resume_runs(arg: str) -> int:
    """Run in a subprocess by `phase_trainer` with CUBLAS_WORKSPACE_CONFIG
    set: under `torch.use_deterministic_algorithms(True, warn_only=True)`,
    an uninterrupted `MOTRTrack.train` run (A) and one stopped after its
    first epoch and resumed from `last_full` (C), validation off, at
    accumulate RESUME_ACCUMULATE, and where C differs from A a second
    uninterrupted run (B) that says how far two runs part; writes the
    differences of C (and B) from A, A's updates and its optimizer tensors
    that are not zero, the epoch-1 results.csv rows and the operations that
    warned of no deterministic form, as json."""
    import warnings

    import torch

    from mo_yolo_tpu_torch import MOTRTrack
    from mo_yolo_tpu_torch.models.tracker import TrackerConfig
    cfg = json.loads(arg)
    if "tracker" in cfg["model_kw"]:
        cfg["model_kw"]["tracker"] = TrackerConfig(
            **cfg["model_kw"]["tracker"])
    torch.use_deterministic_algorithms(True, warn_only=True)
    kw = dict(TRAINER_KW, val=False, accumulate=RESUME_ACCUMULATE)

    def new_tracker():
        return MOTRTrack(cfg["cfg"], nc=cfg["nc"], imgsz=cfg["imgsz"],
                         dtype=cfg["dtype"], seed=0, device=cfg["device"],
                         **cfg["model_kw"])
    states, rows = {}, {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for run in ("A", "C", "B"):
            if run == "B" and rows["C"] == rows["A"] and \
                    _state_diff(states["A"], states["C"])["differ"] == 0:
                break
            save_dir = Path(cfg["dir"]) / run
            tracker = new_tracker()
            got = {}
            tracker.callbacks.add(
                "on_train_end", lambda trainer=None, **k: got.update(
                    ts=trainer.train_state))
            if run == "C":
                first = new_tracker()

                def stop(epoch=None, **k):
                    if epoch == 0:
                        raise _Interrupt
                first.callbacks.add("on_train_epoch_end", stop)
                try:
                    first.train(cfg["yaml"], save_dir=str(save_dir), **kw)
                except _Interrupt:
                    pass
                del first
                kw_run = dict(kw, resume=True)
            else:
                kw_run = kw
            tracker.train(cfg["yaml"], save_dir=str(save_dir), **kw_run)
            states[run] = {k: v.detach().cpu().clone()
                           for k, v in state_tensors(got["ts"]).items()}
            rows[run] = [r.rsplit(",", 1)[0] for r in
                         (save_dir / "results.csv").read_text().splitlines()
                         if r.startswith("1,")]
            del tracker, got
    ops = sorted({str(w.message).split(" does not have")[0][:160]
                  for w in caught if "deterministic" in str(w.message)})
    out = {"b_vs_a": _state_diff(states["A"], states["B"])
           if "B" in states else None,
           "c_vs_a": _state_diff(states["A"], states["C"]),
           "updates_a": int(states["A"]["count"]),
           "moments_moved_a": sum(
               bool(v.any()) for k, v in states["A"].items()
               if k.startswith("opt/")),
           "rows_equal_c_a": rows["C"] == rows["A"],
           "rows_equal_b_a": rows["B"] == rows["A"] if "B" in rows
           else None,
           "rows_a": rows["A"], "nondeterministic_ops": ops}
    Path(cfg["out"]).write_text(json.dumps(out))
    return 0


def phase_trainer(cfg="yolo_track", imgsz="1536x800", device=None,
                  hw=VAL_HW, n_seq=TRAINER_SEQS, n_frames=TRAINER_FRAMES,
                  train_step_ms=None, **model_kw):
    """Training through `MOTRTrack(cfg, imgsz).train` at full width (nc
    from the fixture, bf16 autocast over f32 parameters on the card) on
    `mot_fixture` (`n_seq` sequences of `n_frames` frames), converted by
    `convert_mot_to_yolo` (the last sequence is also the val split), with
    `TRAINER_KW`: augmentation, 5-frame clips, batch 1, 2 epochs of 2
    steps, accumulate 3, validation every epoch. Checks finite losses, 60
    K1 and 30 K2 launches a step (remat), 6 K1, 1 greedy and no K2 a val
    frame, the run's files and the validator's keys. Measures, on the same
    instrumented run: the median step time through the trainer (epoch 0),
    the host ms a clip in decoding (epoch 0; the images are cached),
    augmentation, letterbox and the whole loader, the device's idle share
    over the loading and step of epoch 1's last clip (torch.profiler), the
    seconds at which each trainer event fired, and the epoch-end evaluation's
    frames/s. Then, in a subprocess with deterministic algorithms, a run
    resumed after its first epoch against an uninterrupted one, on the
    first sequence alone (one step an epoch, accumulate RESUME_ACCUMULATE,
    so that the resumed epoch makes the one update, which is checked): bit
    for bit, unless a second uninterrupted run (made only where the two
    differ) parts from the first too; then the non-deterministic
    operations are named and the resumed run is held to twice that
    difference."""
    import dataclasses
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mo_yolo_tpu_torch import MOTRTrack
    from mo_yolo_tpu_torch.data import augment as aug_mod
    from mo_yolo_tpu_torch.data import dataset as ds_mod
    from mo_yolo_tpu_torch.data.mot_challenge import convert_mot_to_yolo
    from mo_yolo_tpu_torch.train import train_step as ts_mod
    from mo_yolo_tpu_torch.utils.checkpoint import load_params
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        mot_fixture(Path(tmp) / "raw", n_seq=n_seq, n_frames=n_frames, hw=hw)
        yaml_path = convert_mot_to_yolo(str(Path(tmp) / "raw"),
                                        str(Path(tmp) / "yolo"))
        nc = ds_mod.load_dataset_yaml(yaml_path)["nc"]
        on_card = device is None or str(device).startswith("cuda")
        dtype = "bfloat16" if on_card else "float32"
        tracker = MOTRTrack(cfg, nc=nc, imgsz=imgsz, dtype=dtype, seed=0,
                            device=device, **model_kw)
        dev = tracker.device
        sync = torch.cuda.synchronize if dev.type == "cuda" else \
            (lambda: None)
        n_layers = len(tracker.model.head.decoder.decoder.layers)
        host = {"decode": [], "augment": [], "letterbox": [], "loader": [],
                "step_call": []}
        state = {"epoch": 0, "mark": None, "prof": None, "t_prof": None}
        step_launches, val_launches, val_fps, events = [], [], [], []
        load, box, aug_call = ds_mod.load_image, ds_mod.letterbox, \
            aug_mod.ClipAugmenter.__call__
        make = ts_mod.make_train_step

        def timed(key, fn):
            """fn, its time kept while the trainer loads a clip (not while
            the validator loads its frames)."""
            def wrapped(*a, **kw):
                t = time.perf_counter()
                out = fn(*a, **kw)
                if state["mark"] is not None:
                    host[key].append((time.perf_counter() - t) * 1e3)
                return out
            return wrapped

        def make_timed(*a, **kw):
            init_fn, step_fn = make(*a, **kw)

            def step(*sa, **skw):
                t = time.perf_counter()
                if state["mark"] is not None:
                    host["loader"].append((t - state["mark"]) * 1e3)
                state["mark"] = None
                out = step_fn(*sa, **skw)
                host["step_call"].append((time.perf_counter() - t) * 1e3)
                return out
            return init_fn, step

        def event(name):
            events.append((name, time.perf_counter() - t0))

        def on_epoch_start(trainer=None, epoch=None, **kw):
            event("on_train_epoch_start")
            state["epoch"] = epoch
            reset_counts()
            state["mark"] = time.perf_counter()

        def on_batch_end(trainer=None, step=None, **kw):
            event("on_train_batch_end")
            step_launches.append(counts())
            reset_counts()
            last = trainer.steps_per_epoch - 1
            if state["prof"] is not None and step == last:
                sync()
                state["window_ms"] = (time.perf_counter() -
                                      state["t_prof"]) * 1e3
                state["prof"].__exit__(None, None, None)
                state["busy"] = _device_split(state["prof"], 1)[0]
                state["prof"] = None
            elif state["epoch"] == 1 and step == last - 1 and \
                    dev.type == "cuda":
                # the profiled window: epoch 1's last clip, loaded and
                # stepped
                sync()
                # device activity only: the window's busy time is all
                # that is read, and the host side of a trainer step's
                # trace took ~70 s to process
                state["prof"] = profile(activities=[ProfilerActivity.CUDA])
                state["prof"].__enter__()
                state["t_prof"] = time.perf_counter()
            # the next clip's loading starts, unless the epoch ends here
            state["mark"] = time.perf_counter() \
                if step < trainer.steps_per_epoch - 1 else None

        def on_epoch_end(trainer=None, epoch=None, metrics=None, **kw):
            event("on_train_epoch_end")
            val_launches.append(counts())
            val_fps.append(metrics.get("fps"))
            reset_counts()

        def on_train_end(trainer=None, metrics=None, **kw):
            event("on_train_end")
            val_launches.append(counts())
            state["ts"] = trainer.train_state

        tracker.callbacks.add("on_train_start",
                              lambda **kw: event("on_train_start"))
        tracker.callbacks.add("on_train_epoch_start", on_epoch_start)
        tracker.callbacks.add("on_train_batch_end", on_batch_end)
        tracker.callbacks.add("on_train_epoch_end", on_epoch_end)
        tracker.callbacks.add("on_train_end", on_train_end)
        ds_mod.load_image = timed("decode", load)
        ds_mod.letterbox = timed("letterbox", box)
        aug_mod.ClipAugmenter.__call__ = timed("augment", aug_call)
        ts_mod.make_train_step = make_timed
        save_dir = Path(tmp) / "run"
        reset_counts()
        t0 = time.perf_counter()
        try:
            metrics = tracker.train(yaml_path, save_dir=str(save_dir),
                                    **TRAINER_KW)
        finally:
            ds_mod.load_image, ds_mod.letterbox = load, box
            aug_mod.ClipAugmenter.__call__ = aug_call
            ts_mod.make_train_step = make
        train_s = time.perf_counter() - t0
        rows = (save_dir / "results.csv").read_text().splitlines()
        files = sorted(p.name for p in save_dir.iterdir())
        best = load_params(str(save_dir / "best"))
        facade_is_best = all(torch.equal(v.cpu(), best[k]) for k, v in
                             tracker.model.state_dict().items())
        ts = state.pop("ts")
        ema_apart = any(not torch.equal(p, ts.ema[n])
                        for n, p in ts.model.named_parameters())
        del tracker, ts
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # the resume check, in its own process, on the first sequence
        # alone (one step an epoch, RESUME_ACCUMULATE), for the time limit
        yolo = Path(yaml_path).parent
        (yolo / "resume_train.txt").write_text("\n".join(
            (yolo / "train.txt").read_text().splitlines()[:n_frames]) + "\n")
        resume_yaml = yolo / "resume.yaml"
        resume_yaml.write_text(Path(yaml_path).read_text().replace(
            "train: train.txt", "train: resume_train.txt"))
        out_json = Path(tmp) / "resume.json"
        arg = json.dumps({
            "dir": str(Path(tmp) / "resume"), "yaml": str(resume_yaml),
            "cfg": cfg,
            "nc": nc, "imgsz": imgsz, "dtype": dtype,
            "device": None if device is None else str(device),
            "model_kw": {k: dataclasses.asdict(v) if k == "tracker" else v
                         for k, v in model_kw.items()},
            "out": str(out_json)})
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
                   PYTHONPATH=str(ROOT))
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.trainer_resume_runs(sys.argv[1]))", arg],
            cwd=str(ROOT), env=env, capture_output=True, text=True,
            timeout=900)
        resume_s = time.perf_counter() - t1
        check(proc.returncode == 0, f"trainer: the resume runs failed:\n"
              f"{proc.stderr[-3000:]}")
        resume = json.loads(out_json.read_text())
    steps = [r.split(",") for r in rows[1:]]
    losses = [float(r[2]) for r in steps]
    sec = [float(r[5]) * 1e3 for r in steps]
    n_steps = len(steps) // TRAINER_EPOCHS
    n_val = n_frames
    want_step = {**dict.fromkeys(KERNELS, 0),
                 "ms_deform_attn_fwd": 2 * n_layers * CLIP_LEN,
                 "ms_deform_attn_bwd": n_layers * CLIP_LEN,
                 "jv_assign": 3 * CLIP_LEN}
    want_val = {**dict.fromkeys(KERNELS, 0),
                "ms_deform_attn_fwd": n_layers * n_val,
                "greedy_keep": n_val}
    per_clip = {k: float(np.sum(v)) / max(len(steps), 1)
                for k, v in host.items() if k in ("augment", "letterbox")}
    per_clip["decode_epoch0"] = float(np.sum(host["decode"])) / max(n_steps, 1)
    per_clip["loader"] = float(np.median(host["loader"])) if host["loader"] \
        else None
    # B runs only where C differs from A
    deterministic = resume["b_vs_a"] is None or (
        resume["b_vs_a"]["differ"] == 0 and resume["rows_equal_b_a"])
    rec = {"cfg": cfg, "imgsz": imgsz, "dtype": dtype,
           "card": card_line() if dev.type == "cuda" else None,
           "fixture": {"sequences": n_seq, "frames": n_frames,
                       "frame_hw": list(hw), "val_frames": n_val},
           "train_kw": TRAINER_KW, "steps_per_epoch": n_steps,
           "losses": losses,
           "step_ms_through_trainer": sec,
           "step_ms_median_epoch0": float(np.median(sec[:n_steps])),
           "step_call_ms": host["step_call"],
           "make_train_step_median_ms": train_step_ms,
           "host_ms_per_clip": per_clip,
           "device_busy_ms_last_clip": state.get("busy"),
           "window_ms_last_clip": state.get("window_ms"),
           "device_idle_share_last_clip":
               (max(0.0, 1.0 - state["busy"] / state["window_ms"])
                if "busy" in state else None),
           "val_fps": val_fps, "train_s": train_s, "resume_s": resume_s,
           "launches_per_step": step_launches[0] if step_launches else None,
           "launches_per_val": val_launches[0] if val_launches else None,
           "files": files, "metrics": metrics,
           "events_s": [(e, round(t, 3)) for e, t in events],
           "facade_holds_best": facade_is_best,
           "training_weights_not_ema": ema_apart,
           "resume": resume, "deterministic_runs": deterministic}
    emit("trainer", **rec)
    check(len(steps) == TRAINER_EPOCHS * n_steps and n_steps == n_seq,
          f"trainer: {len(steps)} logged steps, {n_steps} an epoch")
    check(all(math.isfinite(v) for v in losses),
          f"trainer: losses {losses}")
    for name in ("last", "best", "last_full", "last_full.config.json",
                 "events.jsonl", "results.csv"):
        check(name in files, f"trainer: {name} not written ({files})")
    for k in PERCENT_KEYS + ("MOTA", "IDSW", "fps", "final_loss"):
        check(k in metrics and math.isfinite(metrics[k]),
              f"trainer: metric {k} missing or not finite")
    check(facade_is_best and ema_apart,
          "trainer: the facade does not hold best, or the training module "
          "holds the EMA")
    if dev.type == "cuda":
        for c in step_launches:
            check(c == want_step, f"trainer: launches {c} a step, expected "
                  f"{want_step}")
        for c in val_launches:
            check(c == want_val, f"trainer: launches {c} a val pass of "
                  f"{n_val} frames, expected {want_val}")
    check(resume["updates_a"] == TRAINER_EPOCHS // RESUME_ACCUMULATE and
          resume["moments_moved_a"] > 0,
          f"trainer: the resume runs made {resume['updates_a']} updates and "
          f"moved {resume['moments_moved_a']} optimizer tensors; the resumed "
          f"epoch must update")
    if deterministic:
        check(resume["c_vs_a"]["differ"] == 0 and resume["rows_equal_c_a"],
              f"trainer: the resumed run differs from the uninterrupted "
              f"one: {resume['c_vs_a']}")
    else:
        check(bool(resume["nondeterministic_ops"]),
              "trainer: two uninterrupted runs differ and no operation "
              "warned")
        check(resume["c_vs_a"]["max_rel_diff"] <=
              2 * resume["b_vs_a"]["max_rel_diff"],
              f"trainer: resumed {resume['c_vs_a']} against uninterrupted "
              f"{resume['b_vs_a']}")
    return rec


# ------------------------------------------------------------- distributed

# two ranks of one process group on the one card: the step of a global
# clip of DIST_BATCH (one clip a rank) against one process's, then
# `MOTRTrack.train` at batch DIST_BATCH on DIST_SEQS sequences of CLIP_LEN
# frames (DIST_SEQS clips: 2 steps, one epoch; the last sequence doubles as
# val)
DIST_RANKS, DIST_BATCH, DIST_SEQS = 2, 2, 4
# the step against one process, as tests/test_torch_port_distributed.py
# holds it on the CPU: loss terms to 1e-5 relative, each gradient and
# BatchNorm statistic to 1e-3 of its tensor's largest magnitude, the
# sampling offsets' gradients to 0.25 (the sampler's derivative in the
# location jumps at pixel edges), the gradient norm by
# `tests/torch_port_common.grad_norm_margins`. That holds the CPU test's
# own step (tiny_track at 64², every anchor a query) on the card. At full
# width and random weights the step is chaotic at f32 rounding: every
# parameter moved by one ulp moved the loss terms by up to 0.85 % and 453
# of 469 gradient tensors by more than 1e-3 of their max on an H100 (this
# phase's `one_ulp_vs_one_process`; the port's f64 step keeps f32
# BatchNorm statistics and was as chaotic). So
# the full-width step holds what rounding cannot move (BatchNorm
# statistics, the object count, the gradient norm, the ranks' equality)
# and its loss terms and gradients within DIST_FLOOR_MULT of the same
# step's own one-ulp spread: the largest loss-term error and the median
# gradient error.
DIST_METRIC_RTOL, DIST_TENSOR_TOL, DIST_OFFSETS_TOL = 1e-5, 1e-3, 0.25
DIST_FLOOR_MULT = 4.0
DIST_NCCL_TIMEOUT, DIST_WORK_TIMEOUT = 60, 600     # seconds a launch
# the files a run writes (on rank 0 alone)
RUN_FILES = ("results.csv", "last", "best", "last_full",
             "last_full.config.json", "events.jsonl")


def record_writes(under, writes: list) -> None:
    """An audit hook that appends (event, path relative to `under`) for
    every file opened for writing and every directory made, file renamed
    or removed under `under`: torch.save opens its file in C++, but the
    port's checkpoint writer renames it into place."""
    under = str(Path(under).resolve())
    write_flags = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND

    def rel(p):
        try:
            p = os.path.abspath(os.fsdecode(p))
        except TypeError:         # a file descriptor
            return None
        inside = p == under or p.startswith(under + os.sep)
        return os.path.relpath(p, under) if inside else None

    def hook(event, args):
        if event == "open":
            path, mode, flags = args
            writing = any(c in (mode or "") for c in "wax+") or \
                bool((flags or 0) & write_flags)
            r = rel(path) if writing else None
        elif event in ("os.mkdir", "os.remove", "os.rmdir"):
            r = rel(args[0])
        elif event == "os.rename":
            r = rel(args[1])
        else:
            return
        if r is not None:
            writes.append((event, r))
    sys.addaudithook(hook)


def tensor_digests(tensors) -> dict:
    """The SHA-256 of each tensor's bytes, by name."""
    import hashlib

    import torch
    return {k: hashlib.sha256(v.detach().reshape(-1).contiguous().cpu()
                              .view(torch.uint8).numpy().tobytes())
            .hexdigest() for k, v in tensors.items()}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_clip(imgsz, nc, device):
    """The step check's global clip: DIST_BATCH `synthetic_clip`s (seeds
    1, 2, ...) side by side."""
    import torch

    from mo_yolo_tpu_torch.data.letterbox import to_hw
    clips = [synthetic_clip(CLIP_LEN, to_hw(imgsz), nc, seed=1 + b,
                            device=device) for b in range(DIST_BATCH)]
    return {k: torch.cat([c[k] for c in clips], 1) for k in clips[0]}


def dist_step(make, cfg, imgsz, device, jitter=False, **model_kw):
    """One f32 training step (TF32 off) of `make(model, lcfg, tcfg)`
    (remat, CDN, track dropout and FP injection as `TrainConfig` has them)
    at `cfg`'s width from seed 0 on `dist_clip`: its metrics, gradients
    and BatchNorm running statistics (on the host), seconds and launches.
    With `jitter` every parameter is first moved by about one f32 ulp."""
    import torch

    from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
    from mo_yolo_tpu_torch.train.losses import LossConfig
    from mo_yolo_tpu_torch.train.train_step import TrainConfig
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    with no_tf32():
        model = build_tracking_model(cfg, dtype="float32", device=device,
                                     seed=0, **model_kw)
        if jitter:
            g = torch.Generator().manual_seed(5)
            with torch.no_grad():
                for p in model.parameters():
                    sign = torch.randint(0, 2, p.shape, generator=g) * 2 - 1
                    p.mul_(1 + 2.0 ** -23 * sign.to(p.device, p.dtype))
        init_fn, step_fn = make(model, LossConfig(nc=model.spec.nc),
                                TrainConfig(clip_len=CLIP_LEN))
        ts = init_fn()
        clip = dist_clip(imgsz, model.spec.nc, device)
        gen = torch.Generator(device=device).manual_seed(0)
        sync()
        reset_counts()
        t = time.perf_counter()
        ts, m = step_fn(ts, clip, gen)
        sync()
        secs = time.perf_counter() - t
        launches = counts()
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "grads": {n: (p.grad if p.grad is not None
                         else torch.zeros_like(p)).detach().cpu()
                     for n, p in model.named_parameters()},
           "stats": {n: b.detach().cpu() for n, b in model.named_buffers()
                     if "running" in n},
           "seconds": secs, "launches": launches,
           "n_layers": len(model.head.decoder.decoder.layers)}
    del ts, model
    if on_card:
        torch.cuda.empty_cache()
    return out


def dist_small_step(make, device):
    """The CPU test's step (`tests/torch_port_dist_worker._step`: tiny_track
    at 64², every anchor a query, CDN, dropout and FP injection on) of
    `make` on `device`, f32 with TF32 off: as `dist_step` records it."""
    from tests import torch_port_dist_worker as worker
    with no_tf32():
        reset_counts()
        r = worker._step(make, device=device)
        launches = counts()
    return {"metrics": {k: float(v) for k, v in r["metrics"].items()},
            **{part: {n: t.cpu() for n, t in r[part].items()}
               for part in ("grads", "stats")}, "launches": launches}


def _dist_nccl(rank: int) -> dict:
    """`initialize()` as torchrun would run it (LOCAL_RANK unset: the
    rank's card is rank modulo the cards), then one all-reduce on the
    card: the answer NCCL gives two ranks on one device."""
    import torch
    import torch.distributed as dist

    from mo_yolo_tpu_torch.parallel import distributed as D
    rec = {"rank": rank}
    try:
        D.initialize()
        rec["backend"] = dist.get_backend()
        x = torch.full((1,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        rec.update(ran=True, all_reduce=float(x))
    except Exception as e:          # the answer is what is recorded
        lines = [s.strip() for s in str(e).splitlines() if s.strip()] or \
            [type(e).__name__]
        rec.update(ran=False, error_type=type(e).__name__, error=lines[0],
                   detail=[s for s in lines[1:]
                           if "Duplicate" in s or "invalid" in s][:2])
    return rec


def _dist_work(rank: int, out: Path, cfg: dict) -> dict:
    """Steps B and C of `phase_distributed` on one rank."""
    import torch
    import torch.distributed as dist

    from mo_yolo_tpu_torch import MOTRTrack
    from mo_yolo_tpu_torch.parallel import distributed as D
    from mo_yolo_tpu_torch.parallel.mesh import make_sharded_train_step
    device = cfg["device"]
    on_card = device == "cuda"
    if cfg["backend"] == "gloo":
        if on_card:
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{cfg['port']}",
            world_size=DIST_RANKS, rank=rank)
    check(D.initialize() is True, f"rank {rank}: initialize() found no "
          f"group of {DIST_RANKS}")
    world = D.global_mesh()
    rec = {"rank": rank, "world": list(world),
           "backend": dist.get_backend(), "step": {}}
    writes = []
    record_writes(out / "runs", writes)
    # B: the sharded step, this rank's clip of the global one, at full
    # width and as the CPU test takes it
    for name, step in (
            ("full", lambda: dist_step(make_sharded_train_step, cfg["cfg"],
                                       cfg["imgsz"], device,
                                       **cfg["model_kw"])),
            ("small", lambda: dist_small_step(make_sharded_train_step,
                                              device))):
        r = step()
        rec["step"][name] = {
            "metrics": r["metrics"], "seconds": r.get("seconds"),
            "launches": r["launches"], "grads": tensor_digests(r["grads"]),
            "stats": tensor_digests(r["stats"])}
        if rank == 0:
            torch.save({k: r[k] for k in ("grads", "stats")},
                       out / f"step_{name}_rank0.pt")
        del r
    # C: the trainer, batch DIST_BATCH over the ranks, bf16 autocast
    tracker = MOTRTrack(cfg["cfg"], nc=cfg["nc"], imgsz=cfg["imgsz"],
                        dtype="bfloat16" if on_card else "float32", seed=0,
                        device=device, **cfg["model_kw"])
    seen, per_step, per_val, stamps = {}, [], [], []

    def on_epoch_start(**kw):
        reset_counts()
        stamps.append(time.perf_counter())

    def on_batch_end(trainer=None, **kw):
        if on_card:
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        per_step.append(counts())
        reset_counts()

    def on_val(trainer=None, **kw):
        per_val.append(counts())
        reset_counts()
        seen["trainer"] = trainer
    tracker.callbacks.add("on_train_epoch_start", on_epoch_start)
    tracker.callbacks.add("on_train_batch_end", on_batch_end)
    tracker.callbacks.add("on_train_epoch_end", on_val)
    tracker.callbacks.add("on_train_end", on_val)
    metrics = tracker.train(cfg["yaml"], save_dir=str(out / "runs" / "run"),
                            batch=DIST_BATCH, clip_len=CLIP_LEN, epochs=1,
                            log_every=1)
    trainer = seen["trainer"]
    rec["trainer"] = {
        "batch": trainer.batch, "steps_per_epoch": trainer.steps_per_epoch,
        "metrics": {k: float(v) for k, v in metrics.items()},
        "launches_per_step": per_step, "launches_per_val": per_val,
        "step_s": list(np.diff(stamps)),
        "state": tensor_digests(state_tensors(trainer.train_state))}
    rec["writes"] = writes
    return rec


def dist_rank(arg: str) -> int:
    """One rank of `phase_distributed`, run in its own process with
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK set and LOCAL_RANK
    unset; `arg` is json: `mode` "nccl" (Step A) or "work" (Steps B and
    C), `dir` where the rank writes rank<r>_<mode>.json, and for "work"
    the backend, the gloo port, the config, the dataset yaml and nc."""
    cfg = json.loads(arg)
    rank, out = int(os.environ["RANK"]), Path(cfg["dir"])
    if cfg["mode"] == "nccl":
        rec = _dist_nccl(rank)
        (out / f"rank{rank}_nccl.json").write_text(json.dumps(rec))
        sys.stdout.flush()
        # a communicator that failed is left to the end of the process
        os._exit(0)
    import torch.distributed as dist
    if "tracker" in cfg["model_kw"]:
        from mo_yolo_tpu_torch.models.tracker import TrackerConfig
        cfg["model_kw"]["tracker"] = TrackerConfig(
            **cfg["model_kw"]["tracker"])
    rec = _dist_work(rank, out, cfg)
    (out / f"rank{rank}_work.json").write_text(json.dumps(rec))
    dist.destroy_process_group()
    return 0


def _run_ranks(cfg: dict, timeout: float, late_ok: bool = False):
    """DIST_RANKS processes of `dist_rank(cfg)` with the torchrun variables
    (a free port) and LOCAL_RANK unset; each rank's record. A rank that
    fails fails the phase, and so does one that outlives `timeout` unless
    `late_ok` (then None); every rank is ended."""
    env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
    # the host's cores shared among the ranks, as torchrun shares them
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(DIST_RANKS), PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS=str(max((os.cpu_count() or 1) // DIST_RANKS,
                                       1)))
    arg = json.dumps(cfg)
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.dist_rank(sys.argv[1]))", arg],
        cwd=str(ROOT), env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(DIST_RANKS)]
    outs, late = [], False
    try:
        t_end = time.perf_counter() + timeout
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(t_end - time.perf_counter(), 1))[0])
            except subprocess.TimeoutExpired:
                late = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if late and late_ok:
        return None
    check(not late, f"distributed {cfg['mode']}: the ranks outlived "
          f"{timeout} s")
    for r, (p, o) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"distributed {cfg['mode']}: rank {r} "
              f"exited {p.returncode}:\n{o[-3000:]}")
    return [json.loads((Path(cfg["dir"]) / f"rank{r}_{cfg['mode']}.json")
                       .read_text()) for r in range(DIST_RANKS)]


def _dist_margins(got, want):
    """A step's margins against another (`dist_step` records): the loss
    terms' relative errors, the gradient norm's (`grad_norm_margins`),
    each gradient's and BatchNorm statistic's largest error over its
    tensor's largest magnitude, and the tensors past the CPU test's
    tolerances."""
    from tests.torch_port_common import grad_norm_margins
    gn = grad_norm_margins(got["metrics"]["grad_norm"],
                           want["metrics"]["grad_norm"], got["grads"],
                           want["grads"])
    rec = {"metric_rel_err": {
        k: abs(got["metrics"][k] - w) / max(abs(w), 1e-30)
        for k, w in want["metrics"].items() if k != "grad_norm"},
        "grad_norm": {**gn, "gap_over_bound": gn["gap"] / gn["bound"]},
        "over_tolerance": []}
    rec["metric_max_rel_err"] = max(rec["metric_rel_err"].values())
    for part in ("grads", "stats"):
        rel = {n: float((got[part][n].double() - w.double()).abs().max()) /
               (float(w.abs().max()) or 1.0)
               for n, w in want[part].items()}
        for n, e in rel.items():
            offsets = part == "grads" and "sampling_offsets" in n
            if e > (DIST_OFFSETS_TOL if offsets else DIST_TENSOR_TOL):
                rec["over_tolerance"].append([part, n, e])
        top = sorted(rel, key=rel.get, reverse=True)
        rec[part] = {"tensors": len(rel),
                     "within_tensor_tol": sum(
                         e <= DIST_TENSOR_TOL for e in rel.values()),
                     "median_rel_err": float(np.median(list(rel.values()))),
                     "max_rel_err": rel[top[0]],
                     "worst": [[n, rel[n]] for n in top[:3]]}
    return rec


def _dist_holds(m, floor=None) -> bool:
    """The checks on `_dist_margins` `m`. Without `floor`, the CPU test's
    own: the loss terms, each gradient and statistic, the gradient norm.
    With `floor` (the same step's margins with every parameter moved one
    ulp), what rounding cannot move (the gradient norm within its bound
    and true to its own gradients, the BatchNorm statistics within
    DIST_TENSOR_TOL, the object count exact), and the largest loss-term
    error and the median gradient error within DIST_FLOOR_MULT of the
    floor's."""
    from tests.torch_port_common import GRAD_NORM_SELF_RTOL
    gn = m["grad_norm"]
    ok = gn["gap"] <= gn["bound"] and gn["self_rel"] <= GRAD_NORM_SELF_RTOL \
        and m["metric_rel_err"]["num_objects"] == 0.0 and \
        m["stats"]["max_rel_err"] <= DIST_TENSOR_TOL
    if floor is None:
        return ok and m["metric_max_rel_err"] <= DIST_METRIC_RTOL and \
            not m["over_tolerance"]
    return ok and m["metric_max_rel_err"] <= \
        DIST_FLOOR_MULT * floor["metric_max_rel_err"] and \
        m["grads"]["median_rel_err"] <= \
        DIST_FLOOR_MULT * floor["grads"]["median_rel_err"]


def phase_distributed(cfg="yolo_track", imgsz="1536x800", device=None,
                      hw=VAL_HW, **model_kw):
    """Data parallelism over two ranks on the one card, at `cfg`'s width:

    - A: two ranks join through `parallel.distributed.initialize()` as
      torchrun would start them, LOCAL_RANK unset, and run one all-reduce
      on the card: NCCL's answer to two ranks on one device (refused, or
      ran). Where it ran, the ranks use NCCL below; else each builds a gloo
      group over CUDA tensors, which `initialize()` takes as it is;
    - B: one f32 training step (TF32 off, the kernels) of
      `parallel.mesh.make_sharded_train_step` on a global clip of 2, one
      clip a rank, against one process's `make_train_step` on the same
      clip: at full width (remat, 5-frame clips; held as DIST_FLOOR_MULT
      says, beside the step's own one-ulp spread) and the CPU test's step
      (held to its tolerances); the ranks' gradients and statistics equal
      bit for bit; 60 K1, 30 K2 and 15 JV launches a rank's full step;
    - C: `MOTRTrack.train` at batch 2 over the two ranks, bf16 autocast, on
      `mot_fixture` (DIST_SEQS x CLIP_LEN 1080p frames): one epoch of 2
      steps, validation on each rank; both ranks' state (parameters,
      buffers, EMA, optimizer) equal bit for bit, the run's files written
      by rank 0 alone, 60 K1, 30 K2 and 15 JV launches a rank's step and 6
      K1 and 1 greedy a rank's val frame; seconds a step beside one
      process's bf16 step on the same global batch.

    `device="cpu"` rehearses B and C at a small `cfg` over gloo (no Step
    A, no launch counts)."""
    import dataclasses
    import tempfile

    import torch

    from mo_yolo_tpu_torch.data import dataset as ds_mod
    from mo_yolo_tpu_torch.data.mot_challenge import convert_mot_to_yolo
    from mo_yolo_tpu_torch.train.train_step import make_train_step
    device = device or "cuda"
    on_card = device == "cuda"
    card = card_line() if on_card else None
    rec = {"cfg": cfg, "imgsz": imgsz, "ranks": DIST_RANKS,
           "batch": DIST_BATCH, "clip_len": CLIP_LEN, "card": card}
    if on_card:
        torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        # A: NCCL's answer
        backend = "gloo"
        if on_card:
            t = time.perf_counter()
            nccl = _run_ranks({"mode": "nccl", "dir": str(tmp)},
                              DIST_NCCL_TIMEOUT, late_ok=True)
            ran = nccl is not None and all(r["ran"] for r in nccl)
            backend = "nccl" if ran else "gloo"
            if nccl is None:
                answer = f"no answer in {DIST_NCCL_TIMEOUT} s: the ranks " \
                    f"were ended"
            elif ran:
                answer = f"ran: all_reduce gave {nccl[0]['all_reduce']}"
            else:
                answer = nccl[0]["error"]
            rec["nccl"] = {"ran": ran, "answer": answer, "ranks": nccl,
                           "seconds": time.perf_counter() - t}
            emit("distributed_nccl", card=card, ran=ran, answer=answer,
                 detail=nccl and nccl[0].get("detail"),
                 backend_below=backend)
        rec["backend"] = backend
        mot_fixture(tmp / "raw", n_seq=DIST_SEQS, n_frames=CLIP_LEN, hw=hw)
        yaml_path = convert_mot_to_yolo(str(tmp / "raw"), str(tmp / "yolo"))
        nc = ds_mod.load_dataset_yaml(yaml_path)["nc"]
        t = time.perf_counter()
        ranks = _run_ranks({
            "mode": "work", "dir": str(tmp), "backend": backend,
            "port": _free_port(), "device": device, "cfg": cfg,
            "imgsz": imgsz, "yaml": yaml_path, "nc": nc,
            "model_kw": {k: dataclasses.asdict(v) if k == "tracker" else v
                         for k, v in model_kw.items()}}, DIST_WORK_TIMEOUT)
        rec["ranks_seconds"] = time.perf_counter() - t
        # B against one process; at full width also the one-ulp spread
        t = time.perf_counter()
        rec["step"] = {"tolerances": {
            "metric_rtol": DIST_METRIC_RTOL, "tensor": DIST_TENSOR_TOL,
            "sampling_offsets_grads": DIST_OFFSETS_TOL,
            "floor_mult": DIST_FLOOR_MULT}}
        for name in ("full", "small"):
            want = dist_step(make_train_step, cfg, imgsz, device,
                             **model_kw) if name == "full" else \
                dist_small_step(make_train_step, device)
            got = {"metrics": ranks[0]["step"][name]["metrics"],
                   **torch.load(tmp / f"step_{name}_rank0.pt")}
            r0, r1 = (x["step"][name] for x in ranks)
            rec["step"][name] = {
                "ranks_vs_one_process": _dist_margins(got, want),
                "ranks_equal": all(r0[k] == r1[k] for k in
                                   ("grads", "stats", "metrics")),
                "rank_step_s": [x["step"][name]["seconds"] for x in ranks],
                "one_process_step_s": want.get("seconds"),
                "launches_rank": [x["step"][name]["launches"]
                                  for x in ranks],
                "launches_one_process": want["launches"]}
            if name == "full":
                rec["n_layers"] = want["n_layers"]
                rec["step"][name]["one_ulp_vs_one_process"] = _dist_margins(
                    dist_step(make_train_step, cfg, imgsz, device,
                              jitter=True, **model_kw), want)
            del want, got
        # C: one process's bf16 step on the trainer's global batch
        rec["trainer"] = {k: [r["trainer"][k] for r in ranks] for k in
                          ("batch", "steps_per_epoch", "step_s",
                           "launches_per_step", "launches_per_val")}
        rec["trainer"]["one_process_b2_step_s"] = _one_process_steps(
            cfg, imgsz, nc, device, model_kw)
        rec["parent_seconds"] = time.perf_counter() - t
        states = [r["trainer"]["state"] for r in ranks]
        rec["trainer"]["state_tensors"] = len(states[0])
        rec["trainer"]["ranks_state_equal"] = states[0] == states[1]
        rec["trainer"]["metrics"] = ranks[0]["trainer"]["metrics"]
        rec["trainer"]["ranks_metrics_equal"] = all(
            ranks[0]["trainer"]["metrics"][k] ==
            ranks[1]["trainer"]["metrics"][k]
            for k in ranks[0]["trainer"]["metrics"] if k != "fps")
        rows = (tmp / "runs" / "run" / "results.csv").read_text() \
            .splitlines()
        rec["trainer"]["sec_per_step_csv"] = [
            float(r.split(",")[5]) for r in rows[1:]]
        rec["files"] = {"rank0_wrote": sorted({p for _, p in
                                               ranks[0]["writes"]}),
                        "rank1_wrote": ranks[1]["writes"]}
    emit("distributed", **rec)
    for r, x in enumerate(ranks):
        check(x["world"] == [DIST_RANKS, r] and x["backend"] == backend,
              f"distributed: rank {r} is {x['world']} on {x['backend']}")
    s = rec["step"]
    for name, floor in (("full", s["full"]["one_ulp_vs_one_process"]),
                        ("small", None)):
        m = s[name]["ranks_vs_one_process"]
        check(_dist_holds(m, floor),
              f"distributed {name} step against one process: "
              f"{m['over_tolerance'][:3]}, loss terms "
              f"{m['metric_max_rel_err']}, median gradient "
              f"{m['grads']['median_rel_err']}, grad norm {m['grad_norm']}, "
              f"statistics {m['stats']['max_rel_err']}")
        check(s[name]["ranks_equal"], f"distributed {name} step: the ranks' "
              f"gradients, statistics or metrics differ")
    tr = rec["trainer"]
    check(tr["ranks_state_equal"] and tr["ranks_metrics_equal"],
          "distributed: the ranks' trained state or metrics differ")
    check(all(b == DIST_BATCH for b in tr["batch"]) and
          all(n == DIST_SEQS // DIST_BATCH for n in tr["steps_per_epoch"]),
          f"distributed: batch {tr['batch']}, steps {tr['steps_per_epoch']}")
    check(all(math.isfinite(v) for v in tr["metrics"].values()),
          f"distributed: metrics {tr['metrics']}")
    check(not rec["files"]["rank1_wrote"] and
          all(f"run/{n}" in rec["files"]["rank0_wrote"] for n in RUN_FILES),
          f"distributed: files {rec['files']}")
    if on_card:
        n_layers = rec["n_layers"]
        want_step = {**dict.fromkeys(KERNELS, 0),
                     "ms_deform_attn_fwd": 2 * n_layers * CLIP_LEN,
                     "ms_deform_attn_bwd": n_layers * CLIP_LEN,
                     "jv_assign": 3 * CLIP_LEN}
        want_val = {**dict.fromkeys(KERNELS, 0),
                    "ms_deform_attn_fwd": n_layers * CLIP_LEN,
                    "greedy_keep": CLIP_LEN}
        for c in s["full"]["launches_rank"] + \
                [s["full"]["launches_one_process"]]:
            check(c == want_step, f"distributed step: launches {c}, "
                  f"expected {want_step}")
        for c in s["small"]["launches_rank"]:
            check(c["ms_deform_attn_fwd"] > 0 and
                  c["ms_deform_attn_bwd"] > 0 and c["jv_assign"] > 0,
                  f"distributed small step: launches {c}")
        for steps in tr["launches_per_step"]:
            for c in steps:
                check(c == want_step, f"distributed trainer: launches {c} "
                      f"a step, expected {want_step}")
        for vals in tr["launches_per_val"]:
            for c in vals:
                check(c == want_val, f"distributed trainer: launches {c} a "
                      f"val pass, expected {want_val}")
    return rec


def _one_process_steps(cfg, imgsz, nc, device, model_kw, steps=2):
    """Seconds of `steps` bf16-autocast training steps (after one warm-up)
    of one process on a global batch of DIST_BATCH `dist_clip`s, as the
    trainer runs them on the card (f32 on the CPU)."""
    import torch

    from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
    from mo_yolo_tpu_torch.train.losses import LossConfig
    from mo_yolo_tpu_torch.train.train_step import (TrainConfig,
                                                    make_train_step)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    model = build_tracking_model(cfg, nc=nc, dtype="float32", device=device,
                                 seed=0, **model_kw)
    init_fn, step_fn = make_train_step(
        model, LossConfig(nc=nc), TrainConfig(clip_len=CLIP_LEN),
        compute_dtype=torch.bfloat16 if on_card else None)
    ts = init_fn()
    clip = dist_clip(imgsz, nc, device)
    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for i in range(steps + 1):
        sync()
        t = time.perf_counter()
        ts, m = step_fn(ts, clip, gen)
        float(m["loss"])
        sync()
        if i:
            out.append(time.perf_counter() - t)
    del ts, model
    if on_card:
        torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------------- main

# --------------------------------------------------------------------- cli

# the command line's fixtures: the evaluation one cut to 12 frames a
# sequence; training 8 sequences x 5 frames (8 clips, so that up to 8
# streams make a step), tuning 2 x 5, both at 960x540
CLI_FRAMES, CLI_TRAIN_SEQS, CLI_TUNE_SEQS, CLI_TRAIN_HW = 12, 8, 2, (540, 960)
# the detection family: the single-class MOT detector and RT-DETR's graph,
# at 640x640
DETECT_MODELS, DETECT_IMGSZ = ("yolo_mot", "detr_track"), 640
STEP_LAUNCHES = {"ms_deform_attn_fwd": 60, "ms_deform_attn_bwd": 30,
                 "jv_assign": 15}


def phase_cli(cfg="yolo_track", imgsz="1536x800", device=None,
              hw=VAL_HW, n_frames=CLI_FRAMES, train_hw=CLI_TRAIN_HW,
              train_seqs=CLI_TRAIN_SEQS, tune_seqs=CLI_TUNE_SEQS,
              detect_models=DETECT_MODELS,
              detect_imgsz=DETECT_IMGSZ, **model_kw):
    """The command line, in process, through
    `mo_yolo_tpu_torch.cli.main`, on a model saved by the facade (full
    width, random weights from seed 0 with the score-bias shift, bf16 on
    the card): `track predict` over a sequence of PNG frames with
    `save=true save_format=png save_txt=true save_mot=...`, `track val`,
    `track export format=params` then `track val model=<it>` (equal
    metrics), `track export format=pt` then `load_torch` (equal
    `state_dict`), `track train epochs=1 batch=-1` (the autobatch choice
    and the probe's seconds), a 2-trial `track tune` of 1 epoch each, and
    `info(flops=True)`. Reads the kernels' launches around each command:
    6 K1 and 1 greedy a frame, 60 K1, 30 K2 and 15 JV a training step
    (the probe's steps too), no study kernel. Then `detect predict` and
    `detect val` of `detect_models[0]` and `rtdetr predict` of
    `detect_models[1]` at `detect_imgsz`: 6 K1 a frame and nothing else.
    `track predict save=true` at the default `save_format` writes one JPEG
    a frame (the port's own codec), each read back at the frame's size."""
    import functools
    import tempfile

    import torch

    from mo_yolo_tpu_torch import MOTRTrack
    from mo_yolo_tpu_torch.cli import main as cli
    from mo_yolo_tpu_torch.data.dataset import load_dataset_yaml
    from mo_yolo_tpu_torch.data.mot_challenge import convert_mot_to_yolo
    from mo_yolo_tpu_torch.train import train_step as ts_mod
    from mo_yolo_tpu_torch.train.trainer import TrackTrainer
    (ROOT / "build").mkdir(exist_ok=True)
    rec = {"imgsz": imgsz, "frames": n_frames}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        mot_fixture(tmp / "raw", n_frames=n_frames, hw=hw)
        yaml_val = convert_mot_to_yolo(str(tmp / "raw"), str(tmp / "yolo"))
        seq_dir = Path(load_dataset_yaml(yaml_val)["train"][0]).parent
        fixtures = {}
        for name, n_seq in (("train", train_seqs), ("tune", tune_seqs)):
            mot_fixture(tmp / f"{name}_raw", n_seq=n_seq, n_frames=CLIP_LEN,
                        hw=train_hw, seed=10)
            fixtures[name] = convert_mot_to_yolo(str(tmp / f"{name}_raw"),
                                                 str(tmp / name))
        nc = load_dataset_yaml(yaml_val)["nc"]
        on_card = device is None or str(device).startswith("cuda")
        tracker = MOTRTrack(cfg, nc=nc, imgsz=imgsz,
                            dtype="bfloat16" if on_card else "float32",
                            seed=0, device=device, **model_kw)
        prepare(tracker.model, shift_scores=True)
        model = str(tmp / "model")
        tracker.save(model)
        dev = tracker.device
        sync = torch.cuda.synchronize if dev.type == "cuda" else \
            (lambda: None)
        common = [] if device is None else [f"device={device}"]
        if not on_card:
            common.append("amp=false")

        def run(*args, task="track"):
            """One command: its seconds and the launches it made."""
            reset_counts()
            sync()
            t = time.perf_counter()
            check(cli([task, *args, *common]) == 0, f"cli {task} {args[0]}")
            sync()
            return time.perf_counter() - t, counts()

        def no_study(launches, what):
            check(all(launches[k] == 0 for k in
                      ("take_along_axis",) + VARIANT_KERNELS),
                  f"cli {what}: a study kernel launched: {launches}")

        # predict at the default save_format: one JPEG a frame, by the
        # port's own encoder, read back by its decoder at the frame's size
        from mo_yolo_tpu_torch.data.jpeg import decode_jpeg
        jpg_dir = tmp / "jpg"
        secs, launches = run("predict", f"model={model}",
                             f"source={seq_dir}", "save=true",
                             "verbose=false", f"save_dir={jpg_dir}")
        jpgs = sorted(jpg_dir.glob("*.jpg"))
        shapes = [decode_jpeg(p.read_bytes()).shape for p in jpgs]
        rec["predict_jpeg"] = {"seconds": secs, "launches": launches,
                               "files": len(jpgs),
                               "bytes": sum(p.stat().st_size for p in jpgs),
                               "shapes_ok": sum(sh == (*hw, 3)
                                                for sh in shapes)}
        check(len(jpgs) == n_frames and all(sh == (*hw, 3)
                                            for sh in shapes),
              f"cli predict save=true: {len(jpgs)} JPEGs for {n_frames} "
              f"frames, shapes {set(shapes)}")
        check(not on_card or launches["ms_deform_attn_fwd"] == 6 * n_frames
              and launches["greedy_keep"] == n_frames,
              f"cli predict save=true (JPEG): launches {launches}")

        # predict: annotated PNG frames, label files, MOT rows
        pred = tmp / "pred"
        with greedy_audit("cli predict") as audit:
            secs, launches = run("predict", f"model={model}",
                                 f"source={seq_dir}", "save=true",
                                 "save_format=png", "save_txt=true",
                                 "save_conf=true",
                                 f"save_mot={tmp / 'mot.txt'}",
                                 f"save_dir={pred}", "verbose=false")
        rec["greedy_audit_predict"] = audit
        no_study(launches, "predict")
        check(not on_card or launches["ms_deform_attn_fwd"] == 6 * n_frames
              and launches["greedy_keep"] == n_frames and
              launches["ms_deform_attn_bwd"] == 0 and
              launches["jv_assign"] == 0,
              f"cli predict: launches {launches} for {n_frames} frames")
        pngs = sorted(pred.glob("*.png"))
        labels = sorted((pred / "labels").glob("*.txt"))
        mot_rows = (tmp / "mot.txt").read_text().splitlines()
        check(len(pngs) == n_frames and len(labels) == n_frames,
              f"cli predict: {len(pngs)} frames and {len(labels)} label "
              f"files written for {n_frames}")
        from mo_yolo_tpu_torch.data.loaders import load_image
        check(load_image(str(pngs[0])).shape == (*hw, 3),
              "cli predict: a saved frame has another shape")
        label_rows = sum(len(f.read_text().splitlines()) for f in labels)
        check(len(mot_rows) == label_rows > 0,
              f"cli predict: {len(mot_rows)} MOT rows, {label_rows} label "
              f"rows")
        rec["predict"] = {"seconds": secs, "frames_per_s": n_frames / secs,
                          "launches": launches, "tracks": label_rows}

        # the detection tasks: 6 K1 a frame, no greedy suppression
        n_val = 2 * n_frames
        for key, task, args, n in (
                ("detect_predict", "detect",
                 ("predict", f"model={detect_models[0]}",
                  f"source={seq_dir}"), n_frames),
                ("detect_val", "detect",
                 ("val", f"model={detect_models[0]}", f"data={yaml_val}",
                  "split=train"), n_val),
                ("rtdetr_predict", "rtdetr",
                 ("predict", f"model={detect_models[1]}",
                  f"source={seq_dir}"), n_frames)):
            secs, launches = run(*args, f"imgsz={detect_imgsz}", task=task)
            no_study(launches, key)
            check(not on_card or launches["ms_deform_attn_fwd"] == 6 * n and
                  launches["greedy_keep"] == 0 and
                  launches["ms_deform_attn_bwd"] == 0 and
                  launches["jv_assign"] == 0,
                  f"cli {key}: launches {launches} for {n} frames")
            rec[key] = {"seconds": secs, "frames_per_s": n / secs,
                        "frames": n, "launches": launches}

        # val, then export params and val of the export: equal metrics
        vals = []
        orig_val = MOTRTrack.val

        @functools.wraps(orig_val)      # the CLI routes keys by signature
        def spy_val(self, *a, **kw):
            vals.append(orig_val(self, *a, **kw))
            return vals[-1]
        MOTRTrack.val = spy_val
        try:
            data = [f"data={yaml_val}", "split=train"]
            secs, launches = run("val", f"model={model}", *data)
            n_val = 2 * n_frames
            no_study(launches, "val")
            check(not on_card or launches["ms_deform_attn_fwd"] ==
                  6 * n_val and launches["greedy_keep"] == n_val and
                  launches["ms_deform_attn_bwd"] == 0,
                  f"cli val: launches {launches} for {n_val} frames")
            rec["val"] = {"seconds": secs, "frames_per_s": n_val / secs,
                          "launches": launches,
                          "metrics": {k: vals[-1][k] for k in
                                      ("HOTA", "MOTA", "IDF1", "mAP50",
                                       "fps")}}
            exported = tmp / "exported"
            run("export", f"model={model}", "format=params",
                f"path={exported}")
            run("val", f"model={exported}", *data)
        finally:
            MOTRTrack.val = orig_val
        first, again = vals
        for k, v in first.items():
            check(math.isfinite(v) if k != "fps" else v > 0,
                  f"cli val: {k} = {v}")
        diff = max(abs(first[k] - again[k]) for k in first if k != "fps")
        check(diff <= 100 * VAL_MULTI_TOL,
              f"cli val of the params export: metrics differ by {diff}")
        rec["export_params_val_max_diff"] = diff

        # export pt, then load_torch into another model: equal state_dict
        run("export", f"model={model}", "format=pt", f"path={tmp / 'pt'}")
        other = MOTRTrack(cfg, nc=nc, imgsz=imgsz,
                          dtype="bfloat16" if on_card else "float32",
                          seed=1, device=device, **model_kw)
        other.load_torch(str(tmp / "pt.pt"), strict=True)
        want = MOTRTrack(model, device=device).model.state_dict()
        got = other.model.state_dict()
        check(all(torch.equal(got[k], want[k]) for k in want
                  if not k.endswith("num_batches_tracked")),
              "cli export pt: load_torch did not restore the weights")

        # train (batch=-1) and tune: every step's launches
        steps, trainers = [], []
        make, run_trainer = ts_mod.make_train_step, TrackTrainer.run

        def counted_make(*a, **kw):
            init_fn, step_fn = make(*a, **kw)

            def counted(*sa, **skw):
                before = counts()
                sync()
                t = time.perf_counter()
                out = step_fn(*sa, **skw)
                sync()
                steps.append(({k: v - before[k] for k, v in
                               counts().items()},
                              sa[1]["gt_mask"].shape[1],
                              time.perf_counter() - t))
                return out
            return init_fn, counted

        def kept_run(self):
            trainers.append(self)
            return run_trainer(self)
        ts_mod.make_train_step, TrackTrainer.run = counted_make, kept_run
        try:
            secs, _ = run("train", f"model={model}",
                          f"data={fixtures['train']}", "epochs=1",
                          "batch=-1", f"save_dir={tmp / 'train'}",
                          "log_every=1")
            n_train = len(steps)
            trainer = trainers[-1]
            check(trainer.batch in (1, 2, 4, 8) and
                  trainer.autobatch_seconds is not None,
                  f"cli train: autobatch gave {trainer.batch}")
            n_probe = n_train - trainer.steps_per_epoch
            rec["train"] = {
                "seconds": secs, "autobatch_batch": trainer.batch,
                "autobatch_probe_seconds": trainer.autobatch_seconds,
                "probe_streams": [b for _, b, _ in steps[:n_probe]],
                "steps": trainer.steps_per_epoch,
                "step_seconds": [s for _, _, s in steps[n_probe:]]}
            emit("cli_autobatch", batch=trainer.batch,
                 probe_seconds=trainer.autobatch_seconds,
                 probe_streams=rec["train"]["probe_streams"])
            secs, _ = run("tune", f"model={model}",
                          f"data={fixtures['tune']}", "epochs=1",
                          "max_samples=2", "val=false", "plots=false",
                          f"save_dir={tmp / 'tune'}")
            rec["tune"] = {"seconds": secs, "trials": 2,
                           "steps": len(steps) - n_train}
        finally:
            ts_mod.make_train_step, TrackTrainer.run = make, run_trainer
        check(n_train > n_probe >= 1 and len(steps) - n_train == 2 * tune_seqs,
              f"cli train/tune: {n_train} train steps ({n_probe} probes), "
              f"{len(steps) - n_train} tune steps")
        for launched, b, _ in steps:
            no_study(launched, "train/tune")
            check(not on_card or all(launched[k] == v for k, v in
                                     STEP_LAUNCHES.items()),
                  f"cli train/tune: a step of {b} streams launched "
                  f"{launched}")
        check((tmp / "tune" / "tune_results.csv").is_file(),
              "cli tune: no tune_results.csv")

        t = time.perf_counter()
        info = MOTRTrack(model, device=device).info(flops=True,
                                                    verbose=False)
        rec["info"] = {"params": info["params"], "gflops": info["gflops"],
                       "seconds": time.perf_counter() - t}
        check(info["gflops"] > 0 and info["params"] > 0,
              f"cli info: {info}")
    emit("cli", **rec)
    return rec


# the track configs beside yolo_track, each stepped once at full width
SLICE_CONFIGS = ("yolo_track_n", "yolov8m_track", "yolo_track_rare",
                 "yolo_mot", "detr_track")


def phase_configs(imgsz="1536x800", names=SLICE_CONFIGS, dtype="bfloat16",
                  device=None, frame=None):
    """One `stream_step` of each config in `names` at full width through
    `MOTRTrack(name).predict` on a 1080p frame (random weights from seed
    0, the score-bias shift): finite outputs, valid rows <= slots, one K1
    launch a decoder layer and one greedy launch; its parameter count and
    the seconds of that first frame (build and warm-up included)."""
    import torch

    from mo_yolo_tpu_torch import MOTRTrack
    frame = static_scene(1)[0] if frame is None else frame
    recs, total = {}, dict.fromkeys(KERNELS, 0)
    for name in names:
        t0 = time.perf_counter()
        tracker = MOTRTrack(name, imgsz=imgsz, dtype=dtype, seed=0,
                            device=device)
        prepare(tracker.model, shift_scores=True)
        packed = spy_outputs(tracker.model)
        on_card = tracker.device.type == "cuda"
        built = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        with greedy_audit(f"{name}") as audit:
            n_rows = len(list(tracker.predict([frame], conf=0.5))[0])
            if on_card:
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = counts()
        a = packed[0][0].float().cpu().numpy()
        valid = int((a[:, 7] > 0.5).sum())
        n_slots = tracker.model.tracker.n_slots
        n_layers = len(tracker.model.decoder.decoder.layers)
        check(np.isfinite(a).all(), f"{name}: non-finite outputs")
        check(valid <= n_slots, f"{name}: {valid} valid rows > {n_slots}")
        check(not on_card or (launches["ms_deform_attn_fwd"] == n_layers and
                              launches["greedy_keep"] == 1 and
                              sum(launches.values()) == n_layers + 1),
              f"{name}: launches {launches}")
        recs[name] = {"params": sum(p.numel() for p in
                                    tracker.model.parameters()),
                      "head_row": tracker.model.spec.head_module,
                      "valid_rows": valid, "emitted": n_rows,
                      "launches": launches, "greedy_audit": audit,
                      "build_seconds": built,
                      "first_frame_seconds": secs}
        for k, v in launches.items():
            total[k] += v
        del tracker, packed
        if on_card:
            torch.cuda.empty_cache()
    emit("slice_configs", imgsz=imgsz, dtype=dtype,
         card=card_line() if device is None else None, configs=recs)
    return {"configs": recs, "launches": total}


DETECT_EPOCHS, DETECT_STEPS, DETECT_BATCH = 2, 3, 4
DETECT_CHECK_ATOL = 1e-3


def phase_detect(facade="Detector", cfg=DETECT_MODELS[0],
                 imgsz=DETECT_IMGSZ, dtype="bfloat16", device=None,
                 hw=VAL_HW, n_frames=CLI_FRAMES, train_hw=CLI_TRAIN_HW,
                 epochs=DETECT_EPOCHS, steps=DETECT_STEPS,
                 batch=DETECT_BATCH, validate=True, track=True,
                 **model_kw):
    """The detection family through its facade (`Detector` or `RTDETR`):

    - `predict` over a sequence of `n_frames` 1080p PNG frames (the
      fixture the val and cli phases write): frames/s, one K1 launch a
      decoder layer a frame, no greedy, K2 or JV launch;
    - with `track`: `track` over the same frames with `bytetrack` and with
      `botsort` (the classic trackers on the host, BOT-SORT's GMC in
      numpy): frames/s, the same launches a frame, tracks and ids;
    - with `validate`: `val` on both sequences (frames/s, finite metrics,
      the same launches a frame);
    - the kernels inside the f32 model at `imgsz`: `predict_step` with K1
      against it with the plain sampler (boxes and scores within
      DETECT_CHECK_ATOL), and every K1, K2 and JV call of one training
      step of `batch` images against its plain version
      (`_detect_step_kernels`);
    - `train` for `epochs` x `steps` steps of `batch` images (augmented:
      HSV, flips, affine, mosaic), validating each epoch when `validate`:
      the seconds of each step, the peak memory, each step's launches (one
      K1 and one K2 a decoder layer, three JV: the last layer, the aux
      layers in one launch, the encoder's top-k) and the host syncs of the
      second step (`step_syncs`, held at 0)."""
    import tempfile

    import torch

    from mo_yolo_tpu_torch import api
    from mo_yolo_tpu_torch.data.dataset import load_dataset_yaml
    from mo_yolo_tpu_torch.data.mot_challenge import convert_mot_to_yolo
    from mo_yolo_tpu_torch.train import detect_trainer as dt_mod
    cls = getattr(api, facade)
    phase = "detect" if facade == "Detector" else facade.lower()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        mot_fixture(tmp / "raw", n_frames=n_frames, hw=hw)
        yaml_val = convert_mot_to_yolo(str(tmp / "raw"), str(tmp / "yolo"))
        seq_dir = Path(load_dataset_yaml(yaml_val)["train"][0]).parent
        # two sequences of steps x batch / 2 frames: `steps` steps an epoch
        mot_fixture(tmp / "train_raw", n_seq=2,
                    n_frames=max(steps * batch // 2, 1), hw=train_hw,
                    seed=10)
        yaml_train = convert_mot_to_yolo(str(tmp / "train_raw"),
                                         str(tmp / "train"))
        det = cls(cfg, imgsz=imgsz, dtype=dtype, seed=0, device=device,
                  **model_kw)
        on_card = det.device.type == "cuda"
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        n_layers = len(det.model.decoder.decoder.layers)
        rec = {"facade": facade, "cfg": cfg, "imgsz": imgsz, "dtype": dtype,
               "params": sum(p.numel() for p in det.model.parameters()),
               "card": card_line() if on_card else None}

        def frame_launches(launches, n, what):
            check(not on_card or (
                launches["ms_deform_attn_fwd"] == n_layers * n and
                sum(launches.values()) == n_layers * n),
                f"{phase} {what}: launches {launches} for {n} frames")

        # predict: frames/s over the sequence, the first two left out
        reset_counts()
        sync()
        stamps, n_det = [time.perf_counter()], []
        for r in det.predict(str(seq_dir), conf=0.25):
            check(np.isfinite(r.boxes_xyxy).all(),
                  f"{phase} predict: non-finite boxes")
            n_det.append(len(r))
            stamps.append(time.perf_counter())
        launches = counts()
        check(len(n_det) == n_frames, f"{phase} predict: {len(n_det)} "
              f"frames of {n_frames}")
        frame_launches(launches, n_frames, "predict")
        rec["predict"] = {
            "frames": n_frames, "seconds": stamps[-1] - stamps[0],
            "frames_per_s": n_frames / (stamps[-1] - stamps[0]),
            "steady_frames_per_s": (len(stamps) - 3) /
            (stamps[-1] - stamps[2]),
            "detections_per_frame": float(np.mean(n_det)),
            "launches": launches}

        if track:
            rec["track"] = {}
            for kind in ("bytetrack", "botsort"):
                reset_counts()
                sync()
                t = time.perf_counter()
                n, rows, ids = 0, 0, set()
                for r in det.track(str(seq_dir), tracker=kind):
                    check(np.isfinite(r.boxes_xyxy).all() and
                          len(r.track_id) == len(r),
                          f"{phase} track {kind}: bad rows")
                    n, rows = n + 1, rows + len(r)
                    ids.update(r.track_id.tolist())
                secs = time.perf_counter() - t
                launches = counts()
                check(n == n_frames, f"{phase} track {kind}: {n} frames of "
                      f"{n_frames}")
                check(rows > 0, f"{phase} track {kind}: no track")
                frame_launches(launches, n_frames, f"track {kind}")
                rec["track"][kind] = {
                    "frames": n, "seconds": secs, "frames_per_s": n / secs,
                    "tracks_per_frame": rows / n, "distinct_ids": len(ids),
                    "launches": launches}

        if validate:
            reset_counts()
            sync()
            t = time.perf_counter()
            metrics = det.val(yaml_val, split="train")
            sync()
            secs = time.perf_counter() - t
            n_val = len(load_dataset_yaml(yaml_val)["train"])
            for k, v in metrics.items():
                check(math.isfinite(v) and (k == "fps" or 0 <= v <= 100),
                      f"{phase} val: {k} = {v}")
            frame_launches(counts(), n_val, "val")
            rec["val"] = {"frames": n_val, "seconds": secs,
                          "frames_per_s": n_val / secs, "metrics": metrics,
                          "launches": counts()}
        rec["in_context"] = _detect_in_context(cls, cfg, imgsz, device,
                                               model_kw)
        if on_card:
            rec["step_check"] = _detect_step_kernels(cfg, imgsz, batch,
                                                     device, model_kw)

        # train: every step counted and timed, the second one's syncs
        steps_rec = []
        make = dt_mod.make_detect_train_step

        def counted_make(*a, **kw):
            init_fn, step_fn = make(*a, **kw)

            def counted(*sa, **skw):
                before = counts()
                sync()
                t = time.perf_counter()
                syncs = None
                if on_card and len(steps_rec) == 1:
                    box = {}
                    syncs = step_syncs(
                        lambda: box.update(out=step_fn(*sa, **skw)))
                    out = box["out"]
                else:
                    out = step_fn(*sa, **skw)
                sync()
                steps_rec.append(({k: v - before[k] for k, v in
                                   counts().items()},
                                  time.perf_counter() - t, syncs))
                return out
            return init_fn, counted
        dt_mod.make_detect_train_step = counted_make
        try:
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = det.train(yaml_train, epochs=epochs, batch=batch,
                            augment=True, val=validate, plots=False,
                            log_every=1, save_dir=str(tmp / "run"))
            train_s = time.perf_counter() - t
        finally:
            dt_mod.make_detect_train_step = make
        check(len(steps_rec) == epochs * steps,
              f"{phase} train: {len(steps_rec)} steps, expected "
              f"{epochs} x {steps}")
        check(math.isfinite(out["final_loss"]),
              f"{phase} train: final loss {out['final_loss']}")
        want = {"ms_deform_attn_fwd": n_layers,
                "ms_deform_attn_bwd": n_layers, "jv_assign": 3}
        for launched, _, _ in steps_rec:
            check(not on_card or (
                all(launched[k] == v for k, v in want.items()) and
                sum(launched.values()) == sum(want.values())),
                f"{phase} train: a step launched {launched}")
        syncs = steps_rec[1][2] if len(steps_rec) > 1 else None
        check(syncs is None or syncs["count"] == 0,
              f"{phase} train: host syncs in a step: {syncs}")
        step_s = [s for _, s, _ in steps_rec]
        rec["train"] = {
            "epochs": epochs, "steps": len(steps_rec), "batch": batch,
            "seconds": train_s, "step_seconds": step_s,
            "median_step_seconds": float(np.median(step_s)),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9
            if on_card else None,
            "launches_per_step": steps_rec[0][0], "host_syncs": syncs,
            "final_loss": out["final_loss"],
            "metrics": {k: v for k, v in out.items() if k != "final_loss"}}
    emit(phase, **rec)
    return rec


def _detect_in_context(cls, cfg, imgsz, device, model_kw):
    """`predict_step` of the f32 model with the kernel and with the plain
    sampler (`impl="torch"`) on one letterboxed 1080p frame: boxes and
    scores within DETECT_CHECK_ATOL, classes equal where the scores are."""
    import torch

    from mo_yolo_tpu_torch.data.letterbox import letterbox
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, _, _ = letterbox(static_scene(1, seed=2)[0], (imgsz, imgsz),
                        scale_fill=True)
    outs = {}
    for impl in (None, "torch"):
        m = cls(cfg, imgsz=imgsz, dtype="float32", seed=0, device=device,
                impl=impl, **model_kw)
        outs[impl] = [t.cpu().numpy() for t in m.model.predict_step(
            torch.from_numpy(x[None]).to(m.device))]
        del m
    (kb, ks, kc), (pb, ps, pc) = outs[None], outs["torch"]
    box_err = float(np.abs(kb - pb).max())
    score_err = float(np.abs(ks - ps).max())
    check(box_err <= DETECT_CHECK_ATOL and score_err <= DETECT_CHECK_ATOL,
          f"detect in context: box err {box_err}, score err {score_err}")
    return {"imgsz": imgsz, "box_max_abs_err": box_err,
            "score_max_abs_err": score_err,
            "classes_equal": float((kc == pc).mean())}


# GT rows of each image of the step check's batch (of DetectTrainer's 64)
DETECT_STEP_GT = (12, 3, 30, 7)


def _detect_step_kernels(cfg, imgsz, batch, device, model_kw):
    """One f32 training step of the detection model at `imgsz` on `batch`
    images (random frames; DETECT_STEP_GT[i] boxes of 64 padded GT rows in
    image i), with every kernel call on the path recorded: each K1 call's
    output against the plain sampler on its inputs, each K2 call's
    gradient against the plain gradient on its inputs and upstream
    gradient, and each JV call's assignment against the plain solver's on
    its costs, exactly. Tolerances, relative to the tensor's largest
    magnitude, as phase_kernel's and phase_kernel_bwd's for f32: K1 1e-5,
    K2 d_value 1e-4 and d_loc, d_attn 1e-5."""
    import torch

    from mo_yolo_tpu_torch.models import transformer
    from mo_yolo_tpu_torch.models.detect import build_detection_model
    from mo_yolo_tpu_torch.ops import deform_attn, matching
    from mo_yolo_tpu_torch.train.detect_trainer import make_detect_train_step
    from mo_yolo_tpu_torch.train.losses import LossConfig
    from mo_yolo_tpu_torch.train.train_step import TrainConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fwd, bwd, solve = (transformer.SAMPLERS[None], deform_attn._launch_bwd,
                       matching.hungarian)
    calls = {"k1": [], "k2": [], "jv": []}

    def k1(v, shapes, loc, attn):
        out = fwd(v, shapes, loc, attn)
        calls["k1"].append((v.detach(), shapes, loc.detach(), attn.detach(),
                            out.detach()))
        return out

    def k2(v, shapes, loc, attn, g, *a, **kw):
        out = bwd(v, shapes, loc, attn, g, *a, **kw)
        calls["k2"].append((v.detach(), shapes, loc.detach(), attn.detach(),
                            g.detach(), tuple(t.detach() for t in out)))
        return out

    def jv(cost, mask):
        out = solve(cost, mask)
        calls["jv"].append((cost.clone(), mask.clone(), out.clone()))
        return out
    model = build_detection_model(cfg, dtype="float32", device=device,
                                  seed=0, **model_kw)
    init_fn, step = make_detect_train_step(
        model, LossConfig(nc=model.spec.nc), TrainConfig(clip_len=1))
    ts = init_fn()
    rng = np.random.default_rng(3)
    G, dev = 64, next(model.parameters()).device
    n_gt = [DETECT_STEP_GT[i % len(DETECT_STEP_GT)] for i in range(batch)]
    boxes = np.zeros((batch, G, 4), np.float32)
    mask = np.zeros((batch, G), bool)
    for i, n in enumerate(n_gt):
        boxes[i, :n, :2] = rng.uniform(0.2, 0.8, (n, 2))
        boxes[i, :n, 2:] = rng.uniform(0.03, 0.2, (n, 2))
        mask[i, :n] = True
    host = {"images": rng.integers(0, 256, (batch, imgsz, imgsz, 3),
                                   dtype=np.uint8),
            "gt_cls": rng.integers(0, model.spec.nc, (batch, G),
                                   dtype=np.int32),
            "gt_boxes": boxes, "gt_mask": mask}
    data = {k: torch.from_numpy(a).to(dev) for k, a in host.items()}
    transformer.SAMPLERS[None] = k1
    deform_attn._launch_bwd = k2
    matching.hungarian = jv
    try:
        ts, m = step(ts, data, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
    finally:
        transformer.SAMPLERS[None] = fwd
        deform_attn._launch_bwd = bwd
        matching.hungarian = solve
    check(math.isfinite(float(m["loss"])) and
          math.isfinite(float(m["grad_norm"])),
          f"detect step check {cfg}: loss {m['loss']}")
    n_layers = len(model.decoder.decoder.layers)
    check([len(calls[k]) for k in ("k1", "k2", "jv")] ==
          [n_layers, n_layers, 3],
          f"detect step check {cfg}: calls "
          f"{ {k: len(v) for k, v in calls.items()} }")
    errs = {"k1": [], "k2": {"d_value": [], "d_loc": [], "d_attn": []}}
    for v, shapes, loc, attn, out in calls["k1"]:
        e = _rel_err(out, deform_attn.ms_deform_attn_torch(v, shapes, loc,
                                                           attn))
        check(math.isfinite(e) and e <= 1e-5,
              f"detect step check {cfg}: K1 error {e}")
        errs["k1"].append(e)
    tols = {"d_value": 1e-4, "d_loc": 1e-5, "d_attn": 1e-5}
    for v, shapes, loc, attn, g, out in calls["k2"]:
        want = deform_attn.ms_deform_attn_backward_torch(v, shapes, loc,
                                                         attn, g)
        for k, a, w in zip(tols, out, want):
            e = _rel_err(a, w)
            check(math.isfinite(e) and e <= tols[k],
                  f"detect step check {cfg}: K2 {k} error {e}")
            errs["k2"][k].append(e)
    jv_rec = []
    for cost, mask_, got in calls["jv"]:
        want = matching.hungarian_jv_torch(cost, mask_)[0]
        check(torch.equal(got, want),
              f"detect step check {cfg}: JV assignment differs from the "
              f"plain solver's on cost {tuple(cost.shape)}")
        jv_rec.append({"shape": list(cost.shape),
                       "gt": int(mask_.sum()), "exact": True})
    rec = {"imgsz": imgsz, "batch": batch, "gt_rows": n_gt,
           "queries": calls["k1"][0][2].shape[1],
           "k1_rel_err": max(errs["k1"]),
           "k2_rel_err": {k: max(v) for k, v in errs["k2"].items()},
           "jv": jv_rec}
    del model, ts, calls
    torch.cuda.empty_cache()
    return rec


# the YOLOv8 task heads (segment, pose, classify) at yolo_track's full
# width, 640x640, f32 as the JAX facade runs them
TASK_IMGSZ, TASK_HW, TASK_EPOCHS, TASK_STEPS, TASK_BATCH = \
    640, (720, 1280), 2, 3, 4
TASK_N_VAL = 8
TASK_PLAIN_ATOL = 1e-5


@contextlib.contextmanager
def no_tf32():
    """f32 matmuls and convolutions without TF32 inside, as they were
    after."""
    import torch
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32


def _nms_split(m, x):
    """One `predict_step` on x under torch.profiler: the step's device ms,
    and of it `nms_fixed`'s, split into the dense IoU (`pairwise_iou`,
    [B, N, N] f32), the greedy kernel (pack and walk), the score sort and
    the rest (the class, triu and valid masks, the gathers, the
    compaction). The ranges come from `record_function` wrappers set here
    around `nms_fixed`, `pairwise_iou` and the greedy; nothing of the port
    changes."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from mo_yolo_tpu_torch.models import detect, heads_extra
    saved = (heads_extra.nms_fixed, detect.pairwise_iou,
             detect.greedy_keep_from_conflicts)

    def ranged(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run
    heads_extra.nms_fixed = ranged("nms_fixed", saved[0])
    detect.pairwise_iou = ranged("nms_fixed.iou", saved[1])
    detect.greedy_keep_from_conflicts = ranged("nms_fixed.greedy", saved[2])
    try:
        m.model.predict_step(x)                 # warm: nothing built inside
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            m.model.predict_step(x)
            torch.cuda.synchronize()
    finally:
        (heads_extra.nms_fixed, detect.pairwise_iou,
         detect.greedy_keep_from_conflicts) = saved

    def dev_ms(e, self_only=False):
        key = "self_device_time_total" if self_only else "device_time_total"
        old = "self_cuda_time_total" if self_only else "cuda_time_total"
        return getattr(e, key, getattr(e, old, 0.0)) / 1e3

    def under(e):
        yield e
        for c in e.cpu_children:
            yield from under(c)
    events = prof.events()
    # the host's range (the profiler may mirror it on the device's row)
    roots = [e for e in events if e.name == "nms_fixed" and
             str(e.device_type).endswith("CPU")]
    if len(roots) != 1:
        return {"not_measured": f"{len(roots)} nms_fixed ranges"}
    inside = list(under(roots[0]))
    part = {name: sum(dev_ms(e) for e in inside if e.name == name)
            for name in ("nms_fixed.iou", "nms_fixed.greedy")}
    sort = sum(dev_ms(e, True) for e in inside
               if e.name in ("aten::sort", "aten::argsort"))
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    step = sum(dev_ms(e, True) for e in kernels)
    # the greedy's kernels, launched through ctypes, come under no range
    # of the profile: they are counted by name, and added to the range's
    # total where its own greedy range shows none of them
    greedy = sum(dev_ms(e, True) for e in kernels if "greedy_" in e.name)
    total = dev_ms(roots[0]) + (greedy if part["nms_fixed.greedy"] == 0
                                else 0.0)
    return {"step_device_ms": step, "nms_device_ms": total,
            "iou_device_ms": part["nms_fixed.iou"],
            "greedy_device_ms": greedy, "sort_device_ms": sort,
            "rest_device_ms": total - part["nms_fixed.iou"] - greedy - sort}


def _task_checks(m, frames, device):
    """On `frames` (uint8 HWC, stretched to the model's input): each
    `nms_fixed` call's greedy keep exactly against the plain version on
    the same conflict matrix (on the card, each image the one-pass walk in
    at most ceil(N/32) steps), `predict_step` against itself with the plain
    suppression (every output within TASK_PLAIN_ATOL of its scale, the
    kept slots equal), one `nms_fixed` with every host sync an error, and
    on the card the greedy and its plain version timed on the first
    frame's conflict matrix and one profiled `predict_step` (`_nms_split`)."""
    import torch

    from mo_yolo_tpu_torch.data.letterbox import letterbox
    from mo_yolo_tpu_torch.models import detect
    from mo_yolo_tpu_torch.ops.suppress import (
        greedy_keep_from_conflicts, greedy_keep_from_conflicts_torch)
    s = int(m.imgsz)
    xs = [torch.from_numpy(letterbox(f, (s, s), scale_fill=True)[0][None]
                           ).to(device) for f in frames]
    calls, first = [], []

    def spy(conflict, valid):
        if conflict.device.type == "cuda":
            keep, stats = greedy_call(conflict, valid)
            steps = check_walked(stats, valid.shape[1], "task nms_fixed")
        else:
            keep, steps = greedy_keep_from_conflicts(conflict, valid), None
        same = torch.equal(keep, greedy_keep_from_conflicts_torch(conflict,
                                                                  valid))
        first[:] = first or [conflict, valid]
        calls.append({"n": conflict.shape[-1], "exact": same,
                      "valid": int(valid.sum()), "kept": int(keep.sum()),
                      "conflicts": int(conflict.sum()), "steps": steps})
        return keep
    plain_err, same_kept = 0.0, True
    for x in xs:
        detect.greedy_keep_from_conflicts = spy
        try:
            got = m.model.predict_step(x)
        finally:
            detect.greedy_keep_from_conflicts = greedy_keep_from_conflicts
        detect.greedy_keep_from_conflicts = greedy_keep_from_conflicts_torch
        try:
            want = m.model.predict_step(x)
        finally:
            detect.greedy_keep_from_conflicts = greedy_keep_from_conflicts
        same_kept &= torch.equal(got[1] > 0, want[1] > 0)
        for g, w in zip(got, want):
            scale = max(float(w.float().abs().max()), 1e-12)
            plain_err = max(plain_err,
                            float((g.float() - w.float()).abs().max()) / scale)
    check(len(calls) == len(xs) and all(c["exact"] for c in calls),
          f"task greedy against plain: {calls}")
    check(same_kept and plain_err <= TASK_PLAIN_ATOL,
          f"task predict_step against plain suppression: {plain_err}, "
          f"kept slots equal: {same_kept}")
    # the greedy on the first frame's own conflict matrix, timed
    greedy = None
    if device.type == "cuda":
        conflict, valid = first
        greedy = {
            "n": conflict.shape[-1], "steps": calls[0]["steps"],
            "conflicts_per_row": float(conflict.float().sum(-1).mean()),
            "kept": calls[0]["kept"], "valid": calls[0]["valid"],
            "ms": time_ms(lambda: greedy_keep_from_conflicts(conflict, valid),
                          iters=50, warmup=5),
            "device_ms": device_time_ms(
                lambda: greedy_keep_from_conflicts(conflict, valid)),
            "plain_ms": time_ms(
                lambda: greedy_keep_from_conflicts_torch(conflict, valid),
                iters=10, warmup=2),
            **bound_greedy(conflict, valid)}
    del first[:]
    boxes, cls_p = m.model(xs[0])[:2]
    args = (boxes, cls_p.max(-1).values, cls_p.argmax(-1), m.model.iou,
            m.model.conf, m.model.max_det)
    syncs = None
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            detect.nms_fixed(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = 0
    # where a predicted frame's time goes, on the first frame: the step
    # (network, NMS, and for segment the masks' composition) and the copy
    # back of its outputs
    from mo_yolo_tpu_torch.engine.validator import _to_host
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    stage = {"step_ms": [], "copy_ms": []}
    for _ in range(3):
        sync()
        t = time.perf_counter()
        out = m.model.predict_step(xs[0])
        if hasattr(m.model, "compose_masks"):
            out = (*out[:3], m.model.compose_masks(out[0], out[3], out[4]))
        sync()
        stage["step_ms"].append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        _to_host(*out)
        stage["copy_ms"].append(1e3 * (time.perf_counter() - t))
    nms_split = _nms_split(m, xs[0]) if device.type == "cuda" else None
    return {"greedy_calls": calls, "greedy_on_path": greedy,
            "nms_split": nms_split,
            "plain_suppression_rel_err": plain_err,
            "kept_slots_equal": same_kept, "nms_host_syncs": syncs,
            **{k: float(np.median(v)) for k, v in stage.items()}}


def phase_task(task, cfg="yolo_track", imgsz=TASK_IMGSZ, device=None,
               hw=VAL_HW, n_frames=CLI_FRAMES, fixture_hw=TASK_HW,
               epochs=TASK_EPOCHS, steps=TASK_STEPS, batch=TASK_BATCH,
               n_val=TASK_N_VAL, **model_kw):
    """A YOLOv8 task head through `YOLO(cfg, task=task)` (`_TaskModel`),
    f32 with TF32 off (each training step's loss checked to run so, with
    no autocast):

    - segment and pose: `predict` over `n_frames` 1080p PNG frames (the
      MOT fixture's sequence; segment with `masks=True` on the default
      composition, then again with `retina_masks`): frames/s, one greedy
      launch an image and nothing else; the checks of `_task_checks` on
      two frames; `val` on `n_val` images of a synthetic polygon or
      keypoint fixture (`task_fixture`): finite metrics, one greedy launch
      an image;
    - classify: `val` on a class-subdir tree of generated PNGs;
    - every task: `train` for `epochs` x `steps` steps of `batch` images
      (s a step, peak memory, each step's launches: none of the kernels).
    """
    import tempfile

    import torch

    from mo_yolo_tpu_torch import YOLO
    from mo_yolo_tpu_torch.train import task_trainers as tt
    (ROOT / "build").mkdir(exist_ok=True)
    rec = {"task": task, "cfg": cfg, "imgsz": imgsz, "dtype": "float32",
           "tf32": False}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, \
            no_tf32():
        tmp = Path(tmp)
        data = task_fixture(tmp / task, task,
                            n_train=steps * batch, n_val=n_val,
                            hw=fixture_hw)
        m = YOLO(cfg, task=task, imgsz=imgsz, device=device, **model_kw)
        dev = m.device
        on_card = dev.type == "cuda"
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        rec["params"] = sum(p.numel() for p in m.model.parameters())
        rec["card"] = card_line() if on_card else None

        def launched(what, want_greedy):
            c = counts()
            check(not on_card or (c["greedy_keep"] == want_greedy and
                                  sum(c.values()) == want_greedy),
                  f"{task} {what}: launches {c}, expected {want_greedy} "
                  f"greedy and nothing else")
            return c

        if task != "classify":
            mot_fixture(tmp / "raw", n_seq=1, n_frames=n_frames, hw=hw)
            seq = tmp / "raw" / "images" / "train" / "MOT17-01" / "img1"
            passes = [("predict", {"masks": task == "segment"})]
            if task == "segment":
                passes.append(("predict_retina", {"masks": True}))
            for name, kw in passes:
                m.model.retina_masks = name == "predict_retina"
                reset_counts()
                sync()
                # each frame's time inside the generator; the checks on
                # its outputs stand outside it
                secs, kept = [], []
                frames = iter(m.predict(str(seq), **kw))
                while True:
                    t = time.perf_counter()
                    out = next(frames, None)
                    if out is None:
                        break
                    secs.append(time.perf_counter() - t)
                    out = out[1]
                    check(all(np.isfinite(o).all() for o in out),
                          f"{task} {name}: non-finite outputs")
                    kept.append(int((out[1] > 0).sum()))
                check(len(secs) == n_frames,
                      f"{task} {name}: {len(secs)} frames")
                rec[name] = {
                    "frames": n_frames,
                    "frames_per_s": n_frames / sum(secs),
                    "steady_frames_per_s": (n_frames - 2) / sum(secs[2:]),
                    "kept_per_frame": float(np.mean(kept)),
                    "launches": launched(name, n_frames)}
            m.model.retina_masks = False
            from mo_yolo_tpu_torch.data.loaders import load_image
            rec["checks"] = _task_checks(
                m, [load_image(p) for p in sorted(seq.glob("*.png"))[:2]],
                dev)
        reset_counts()
        sync()
        t = time.perf_counter()
        with greedy_audit(f"{task} val") as audit:
            metrics = m.val(data)
            sync()
            secs = time.perf_counter() - t
        for k, v in metrics.items():
            check(math.isfinite(v), f"{task} val: {k} = {v}")
        rec["val"] = {"images": n_val, "seconds": secs,
                      "images_per_s": n_val / secs, "metrics": metrics,
                      "greedy_audit": audit,
                      "launches": launched(
                          "val", 0 if task == "classify" else n_val)}

        steps_rec, precision = [], set()
        make = tt.make_task_train_step

        def counted_make(model, loss_fn, *a, **kw):
            def watched(*la, **lkw):
                precision.add((str(next(model.parameters()).dtype),
                               torch.is_autocast_enabled(dev.type)))
                return loss_fn(*la, **lkw)
            init_fn, step_fn = make(model, watched, *a, **kw)

            def counted(*sa, **skw):
                reset_counts()
                sync()
                t0 = time.perf_counter()
                out = step_fn(*sa, **skw)
                sync()
                steps_rec.append((counts(), time.perf_counter() - t0))
                return out
            return init_fn, counted
        tt.make_task_train_step = counted_make
        try:
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = m.train(data, epochs=epochs, batch=batch, log_every=1,
                          val=False, save_dir=str(tmp / "run"))
            train_s = time.perf_counter() - t
        finally:
            tt.make_task_train_step = make
        check(len(steps_rec) == epochs * steps and
              math.isfinite(out["final_loss"]),
              f"{task} train: {len(steps_rec)} steps, final loss "
              f"{out['final_loss']}")
        for c, _ in steps_rec:
            check(sum(c.values()) == 0, f"{task} train: a step launched {c}")
        check(precision == {("torch.float32", False)},
              f"{task} train: the loss ran at {precision} (dtype, "
              f"autocast), not f32")
        step_s = [s_ for _, s_ in steps_rec]
        rec["train"] = {
            "epochs": epochs, "steps": len(steps_rec), "batch": batch,
            "seconds": train_s, "step_seconds": step_s,
            "median_step_seconds": float(np.median(step_s)),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9
            if on_card else None,
            "launches_per_step": steps_rec[0][0],
            "final_loss": out["final_loss"]}
        del m
        if on_card:
            torch.cuda.empty_cache()
    emit(task, **rec)
    return rec


# ------------------------------------------------------------------ export

EXPORT_IMGSZ, EXPORT_DYNAMIC_B, EXPORT_DYNAMIC_FRAMES = "1536x800", 4, 4
EXPORT_FRAMES = 4
HARNESS_IMGSZ = 640


class LoadedStep:
    """A loaded `pt2` stream step (through `AutoBackend`) with the
    `stream_step` and `init_state` that `stream_graph` drives."""

    def __init__(self, backend):
        self.backend = backend

    def stream_step(self, state, x):
        return self.backend.stream_step(state, x)

    def init_state(self, batch):
        return self.backend.new_state(batch)


def phase_export(cfg="yolo_track", imgsz=EXPORT_IMGSZ, dtype="bfloat16",
                 device=None, n_frames=EXPORT_FRAMES,
                 dynamic_b=EXPORT_DYNAMIC_B,
                 dynamic_frames=EXPORT_DYNAMIC_FRAMES,
                 harness_imgsz=HARNESS_IMGSZ, task_imgsz=TASK_IMGSZ,
                 hw=(1080, 1920), **model_kw):
    """The serialized step (`MOTRTrack.export(fmt="pt2")`, loaded by
    `AutoBackend`) at full `cfg` width:

    - at `imgsz` in `dtype`, one stream: the export's and the load's
      seconds and the `.pt2`'s MB; `n_frames` frames (the slice phase's
      synthetic scene, letterboxed on the card) through the eager
      `stream_step` and through the loaded program, every frame's packed
      rows and state equal bit for bit, 6 K1 and 1 greedy launch a frame
      counted in the program's run and nothing else; then both through
      `stream_graph` (each stepped with every host sync an error, frames/s
      on the host clock, a CUDA graph of one step replayed frame by frame
      equal to its eager outputs, and the replay's device ms a frame);
    - `dynamic=True`: one program traced at 2 streams, run at `dynamic_b`
      streams for `dynamic_frames` frames, equal to the eager batched
      step bit for bit, one K1 a layer and one greedy a batched frame;
    - the segment head's `predict_step` as a program at `task_imgsz` (f32):
      2 images equal to the eager step, one greedy launch an image;
    - the export-format harness (`utils/benchmarks.py`) at
      `harness_imgsz`: every row (live, params, pt, pt2) `ok`.

    `model_kw` override the model's defaults (a rehearsal's small sizes)."""
    import tempfile

    import torch

    from mo_yolo_tpu_torch import MOTRTrack
    from mo_yolo_tpu_torch.data.letterbox import to_hw
    from mo_yolo_tpu_torch.engine.autobackend import AutoBackend
    from mo_yolo_tpu_torch.ops.preprocess import device_letterbox
    from mo_yolo_tpu_torch.utils.benchmarks import benchmark
    from mo_yolo_tpu_torch.utils.program_export import OPS, load_program, \
        op_counts
    tracker = MOTRTrack(cfg, imgsz=imgsz, dtype=dtype, seed=0, device=device,
                        **model_kw)
    prepare(tracker.model, shift_scores=True)
    model, dev = tracker.model, tracker.device
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n_layers = len(model.head.decoder.decoder.layers)
    frames = static_scene(n_frames, hw=hw)
    xs = [device_letterbox(torch.from_numpy(f[None]).to(dev), to_hw(imgsz),
                           scale_fill=True) for f in frames]
    rec = {"cfg": cfg, "imgsz": imgsz, "dtype": dtype, "frames": n_frames,
           "card": card_line() if on_card else None}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        sync()
        t = time.perf_counter()
        path = tracker.export("pt2", path=str(tmp / "step"))
        rec["export_seconds"] = time.perf_counter() - t
        rec["pt2_mb"] = Path(path).stat().st_size / 1e6
        t = time.perf_counter()
        backend = AutoBackend(path, device=device)
        sync()
        rec["load_seconds"] = time.perf_counter() - t
        graph_ops = op_counts(load_program(path))
        rec["graph_ops"] = {k: graph_ops.get(k, 0) for k in OPS}
        check(rec["graph_ops"] == {OPS[0]: n_layers, OPS[1]: 1},
              f"export: the program's op nodes {rec['graph_ops']}")

        # the loaded program against the eager step, frame by frame
        st_e, st_l = model.init_state(1), backend.new_state(1)
        reset_counts()
        eager = []
        for x in xs:
            st_e, out = model.stream_step(st_e, x)
            eager.append(out)
        reset_counts()
        n_valid = 0
        for t, x in enumerate(xs):
            st_l, out = backend.stream_step(st_l, x)
            check(torch.equal(out, eager[t]),
                  f"export: frame {t} of the loaded program differs from "
                  f"the eager step in {int((out != eager[t]).any(-1).sum())}"
                  f" rows")
            n_valid += int((out[0, :, 7] > 0.5).sum())
        launches = counts()
        check(all(torch.equal(a, b) for a, b in zip(st_e, st_l)),
              "export: the loaded program's state differs from eager")
        check(n_valid > 0, "export: no valid row in any frame")
        check(not on_card or (
            launches["ms_deform_attn_fwd"] == n_layers * n_frames and
            launches["greedy_keep"] == n_frames and
            sum(launches.values()) == (n_layers + 1) * n_frames),
            f"export: the loaded program launched {launches}")
        rec.update(frames_equal=n_frames, valid_rows=n_valid,
                   launches=launches,
                   launches_per_frame={k: v / n_frames
                                       for k, v in launches.items() if v})
        if on_card:
            rec["eager"] = stream_graph(model, imgsz, frames, n_layers)
            rec["loaded"] = stream_graph(LoadedStep(backend), imgsz, frames,
                                         n_layers)
        del backend

        # one program for any number of streams
        t = time.perf_counter()
        dyn_path = tracker.export("pt2", path=str(tmp / "dynamic"),
                                  dynamic=True)
        dyn_s = time.perf_counter() - t
        dyn = AutoBackend(dyn_path, device=device)
        xb = [device_letterbox(torch.from_numpy(np.stack(
            static_scene(dynamic_b, hw=hw, seed=10 + i))).to(dev),
            to_hw(imgsz), scale_fill=True) for i in range(dynamic_frames)]
        st_e, st_l = model.init_state(dynamic_b), dyn.new_state(dynamic_b)
        dyn_launches = {}
        for t, x in enumerate(xb):
            st_e, want = model.stream_step(st_e, x)
            reset_counts()
            st_l, got = dyn.stream_step(st_l, x)
            for k, v in counts().items():
                dyn_launches[k] = dyn_launches.get(k, 0) + v
            check(torch.equal(got, want),
                  f"export dynamic: frame {t} at {dynamic_b} streams differs"
                  f" from the eager batched step")
        check(not on_card or (
            dyn_launches["ms_deform_attn_fwd"] == n_layers * dynamic_frames
            and dyn_launches["greedy_keep"] == dynamic_frames),
            f"export dynamic: launches {dyn_launches}")
        rec["dynamic"] = {"streams": dynamic_b, "frames": dynamic_frames,
                          "export_seconds": dyn_s, "equal": True,
                          "launches": {k: v for k, v in dyn_launches.items()
                                       if v}}
        del dyn, tracker, model

        # a task head's program: the greedy op over every anchor
        from mo_yolo_tpu_torch.api import _TaskModel
        seg = _TaskModel("segment", cfg, imgsz=task_imgsz, device=device,
                         **{k: v for k, v in model_kw.items()
                            if k not in ("nq", "hd", "ndl", "d_ffn",
                                         "tracker")})
        t = time.perf_counter()
        prog = AutoBackend(seg.export("pt2", path=str(tmp / "segment")),
                           device=device)
        seg_s = time.perf_counter() - t
        seg_launches = {}
        for i, f in enumerate(frames[:2]):
            x = device_letterbox(torch.from_numpy(f[None]).to(dev),
                                 (task_imgsz, task_imgsz), scale_fill=True)
            reset_counts()
            got = prog(x)
            for k, v in counts().items():
                seg_launches[k] = seg_launches.get(k, 0) + v
            want = seg.model.predict_step(x)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"export segment: image {i} differs from predict_step")
        check(not on_card or (seg_launches["greedy_keep"] == 2 and
                              sum(seg_launches.values()) == 2),
              f"export segment: launches {seg_launches}")
        rec["segment"] = {"imgsz": task_imgsz, "images": 2, "equal": True,
                          "export_and_load_seconds": seg_s,
                          "launches": {k: v for k, v in seg_launches.items()
                                       if v}}
        del prog, seg

        # the export-format harness
        h = MOTRTrack(cfg, imgsz=harness_imgsz, dtype=dtype, seed=0,
                      device=device, **model_kw)
        prepare(h.model, shift_scores=True)
        rows = benchmark(h, out_dir=str(tmp / "benchmark"), n_iter=10)
        check([r["format"] for r in rows] == ["live", "params", "pt", "pt2"]
              and all(r["ok"] for r in rows),
              f"export harness: rows {rows}")
        rec["harness"] = {"imgsz": harness_imgsz, "rows": rows}
    emit("export", **rec)
    return rec


# -------------------------------------------------------- nas, fastsam, sam

# YOLO-NAS-S at 640x640; FastSAM on yolo_track (YOLOv8-l width) at 640;
# SAM-B and MobileSAM at 1024, each f32 as the JAX facades run them
NAS_IMGSZ, FASTSAM_IMGSZ = 640, 640
SAM_VARIANTS, SAM_IMGSZ = ("b", "mobile"), 1024
# generate's calls: the default filters at grid 8; grid 16 with a crop
# layer and no filter (random weights predict IoUs below 0, so the IoU
# threshold is -10, as the JAX tests set it), so that every one of the 5 x
# 256 x 3 = 3,840 masks reaches the suppression
SAM_GENERATE = ((8, {}),
                (16, {"crop_layers": 1, "iou_thresh": -10.0,
                      "stability_thresh": 0.0}))
# the JAX host loop is run on the top masks in score order: a greedy keep
# decision depends only on the masks before it, so the device's keep set
# restricted to that prefix must equal the loop's
SAM_HOST_PREFIX = 512


class StubEmbedder:
    """A `TextImageEmbedder` for a machine without CLIP: an image embeds
    to its mean colour off the white canvas, a colour word to its unit
    vector."""

    COLORS = {"red": (1.0, 0.0, 0.0), "green": (0.0, 1.0, 0.0),
              "blue": (0.0, 0.0, 1.0)}

    def embed_images(self, images):
        out = []
        for im in images:
            px = im.reshape(-1, 3).astype(np.float64)
            keep = px.min(1) < 250
            out.append(px[keep].mean(0) if keep.any() else np.zeros(3))
        return np.stack(out)

    def embed_texts(self, texts):
        return np.array([self.COLORS[t] for t in texts], np.float64)


def _timed(gen):
    """(items, seconds of each) of a generator, timed inside it."""
    items, secs, it = [], [], iter(gen)
    while True:
        t = time.perf_counter()
        item = next(it, None)
        if item is None:
            return items, secs
        secs.append(time.perf_counter() - t)
        items.append(item)


def _without_sync(fn):
    """fn() with every host sync an error."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _only_greedy(what, want, on_card):
    """The launch counts since the last reset: `want` greedy and nothing
    else (on the card)."""
    c = counts()
    check(not on_card or (c["greedy_keep"] == want and
                          sum(c.values()) == want),
          f"{what}: launches {c}, expected {want} greedy and nothing else")
    return {k: v for k, v in c.items() if v}


def _greedy_timed(conflict, valid, steps):
    """The kernel and its plain version timed on one conflict matrix, with
    its bound."""
    from mo_yolo_tpu_torch.ops.suppress import (
        greedy_keep_from_conflicts, greedy_keep_from_conflicts_torch)
    return {"m": int(valid.shape[1]), "steps": steps,
            "conflicts_per_row": float(conflict.float().sum(-1).mean()),
            "ms": time_ms(lambda: greedy_keep_from_conflicts(conflict, valid),
                          iters=50, warmup=5),
            "device_ms": device_time_ms(
                lambda: greedy_keep_from_conflicts(conflict, valid)),
            "plain_ms": time_ms(
                lambda: greedy_keep_from_conflicts_torch(conflict, valid),
                iters=5, warmup=1),
            **bound_greedy(conflict, valid)}


def phase_nas(cfg="yolo_nas_s", imgsz=NAS_IMGSZ, device=None, hw=VAL_HW,
              n_frames=CLI_FRAMES, n_val=TASK_N_VAL, fixture_hw=TASK_HW):
    """YOLO-NAS through `NAS(cfg)` at `imgsz`, f32 with TF32 off:

    - `predict` over `n_frames` 1080p PNG frames, plain and with TTA (three
      scales, one NMS over their union): frames/s, one greedy launch an
      image and nothing else, every greedy call exactly its plain version
      and the one-pass walk (`greedy_audit`);
    - `predict_step` and `predict_step_tta` on one frame with every host
      sync an error, and their device ms (replayed from a CUDA graph);
    - `val` on `n_val` images of a synthetic detection fixture: finite
      metrics, one greedy launch an image, each call audited;
    - a `pt2` export, loaded: one greedy op node, its output equal to the
      eager step bit for bit, one launch."""
    import tempfile

    import torch

    from mo_yolo_tpu_torch import NAS
    from mo_yolo_tpu_torch.data.letterbox import letterbox
    from mo_yolo_tpu_torch.data.loaders import load_image
    from mo_yolo_tpu_torch.utils.program_export import (load_program,
                                                        op_counts)
    (ROOT / "build").mkdir(exist_ok=True)
    rec = {"cfg": cfg, "imgsz": imgsz, "dtype": "float32", "tf32": False}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, \
            no_tf32():
        tmp = Path(tmp)
        nas = NAS(cfg, imgsz=imgsz, device=device)
        dev = nas.device
        on_card = dev.type == "cuda"
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        rec["params"] = sum(p.numel() for p in nas.model.parameters())
        rec["card"] = card_line() if on_card else None
        mot_fixture(tmp / "raw", n_seq=1, n_frames=n_frames, hw=hw)
        seq = tmp / "raw" / "images" / "train" / "MOT17-01" / "img1"
        for name, aug in (("predict", False), ("predict_tta", True)):
            reset_counts()
            sync()
            with greedy_audit(f"nas {name}") as audit:
                outs, secs = _timed(nas.predict(str(seq), conf=0.25,
                                                augment=aug))
            check(len(outs) == n_frames and all(
                np.isfinite(r.boxes_xyxy).all() and np.isfinite(r.conf).all()
                for r in outs), f"nas {name}: {len(outs)} frames or "
                                f"non-finite outputs")
            rec[name] = {
                "frames": n_frames, "frames_per_s": n_frames / sum(secs),
                "steady_frames_per_s": (n_frames - 2) / sum(secs[2:]),
                "detections_per_frame": float(np.mean([len(r)
                                                       for r in outs])),
                "greedy_audit": audit,
                "launches": _only_greedy(f"nas {name}", n_frames, on_card)}
        x = torch.from_numpy(letterbox(load_image(sorted(seq.glob(
            "*.png"))[0]), (imgsz, imgsz), scale_fill=True)[0][None]).to(dev)
        rec["steps"] = {}
        for name, fn in (("predict_step", nas.model.predict_step),
                         ("predict_step_tta", nas.model.predict_step_tta)):
            fn(x)
            sync()
            if on_card:
                _without_sync(lambda: fn(x))
            rec["steps"][name] = {
                "host_syncs": 0 if on_card else None,
                "ms": time_ms(lambda: fn(x), iters=10, warmup=2)
                if on_card else None,
                "device_ms": device_time_ms(lambda: fn(x), iters=10)
                if on_card else None}
        data = task_fixture(tmp / "det", "detect", n_train=1, n_val=n_val,
                            hw=fixture_hw)
        reset_counts()
        sync()
        t = time.perf_counter()
        with greedy_audit("nas val") as audit:
            metrics = nas.val(data)
            sync()
            secs = time.perf_counter() - t
        for k, v in metrics.items():
            check(math.isfinite(v), f"nas val: {k} = {v}")
        rec["val"] = {"images": n_val, "seconds": secs,
                      "images_per_s": n_val / secs, "metrics": metrics,
                      "greedy_audit": audit,
                      "launches": _only_greedy("nas val", n_val, on_card)}
        t = time.perf_counter()
        ep = load_program(nas.export("pt2", path=str(tmp / "nas")), dev)
        export_s = time.perf_counter() - t
        nodes = op_counts(ep).get("mo_yolo_tpu_torch.greedy_keep.default")
        reset_counts()
        got = ep.module()(x)
        launches = _only_greedy("nas pt2", 1, on_card)
        want = nas.model.predict_step(x)
        check(nodes == 1 and all(torch.equal(a, b) for a, b in
                                 zip(got, want)),
              f"nas pt2: {nodes} greedy nodes, or differs from the step")
        rec["pt2"] = {"export_and_load_seconds": export_s,
                      "greedy_nodes": nodes, "equal": True,
                      "launches": launches}
        del nas, ep
        if on_card:
            torch.cuda.empty_cache()
    emit("nas", **rec)
    return rec


def phase_fastsam(cfg="yolo_track", imgsz=FASTSAM_IMGSZ, device=None,
                  hw=VAL_HW, n_frames=CLI_FRAMES):
    """FastSAM through `FastSAM(cfg)` at `imgsz`, f32 with TF32 off:

    - `everything` over `n_frames` 1080p frames: frames/s, masks a frame,
      one greedy launch a frame and nothing else;
    - on each frame, at the facade's IoU (0.9) and at 0.7 (where an
      untrained head's neighbouring boxes conflict), the keep set exactly
      the JAX host loop's (`greedy_box_nms_np` on the step's boxes and
      scores copied back, equal scores ordered by index as the port's
      stable sort orders them),
      and each greedy call exactly its plain version on its conflict
      matrix (on the card, the one-pass walk);
    - box, point and text prompts (the text through `StubEmbedder`) on
      the first frame, one greedy launch each;
    - the greedy timed on the first frame's 4·max_det-candidate matrix."""
    import tempfile

    import torch

    from mo_yolo_tpu_torch.data.letterbox import letterbox
    from mo_yolo_tpu_torch.data.loaders import load_image
    from mo_yolo_tpu_torch.models import fastsam as fsm
    from mo_yolo_tpu_torch.ops.suppress import (
        greedy_keep_from_conflicts, greedy_keep_from_conflicts_torch)
    (ROOT / "build").mkdir(exist_ok=True)
    rec = {"cfg": cfg, "imgsz": imgsz, "dtype": "float32", "tf32": False}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, \
            no_tf32():
        tmp = Path(tmp)
        fs = fsm.FastSAM(cfg, imgsz=imgsz, device=device)
        dev = fs.device
        on_card = dev.type == "cuda"
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        rec.update(params=sum(p.numel() for p in fs.model.parameters()),
                   conf=fs.conf, iou=fs.iou, max_det=fs.max_det,
                   card=card_line() if on_card else None)
        mot_fixture(tmp / "raw", n_seq=1, n_frames=n_frames, hw=hw)
        frames = [load_image(p) for p in sorted((
            tmp / "raw" / "images" / "train" / "MOT17-01" / "img1"
        ).glob("*.png"))]
        reset_counts()
        sync()
        outs, secs = _timed(fs.everything(f) for f in frames)
        check(all(np.isfinite(o["boxes"]).all() and len(o["masks"]) ==
                  len(o["boxes"]) for o in outs), "fastsam: outputs")
        rec["everything"] = {
            "frames": n_frames, "frames_per_s": n_frames / sum(secs),
            "steady_frames_per_s": (n_frames - 2) / sum(secs[2:]),
            "masks_per_frame": float(np.mean([len(o["masks"])
                                              for o in outs])),
            "launches": _only_greedy("fastsam everything", n_frames,
                                     on_card)}
        calls = []

        def spy(conflict, valid):
            if on_card:
                keep, stats = greedy_call(conflict, valid)
                steps = check_walked(stats, valid.shape[1], "fastsam")
            else:
                keep, steps = greedy_keep_from_conflicts(conflict,
                                                         valid), None
            check(torch.equal(keep, greedy_keep_from_conflicts_torch(
                conflict, valid)), "fastsam: greedy against plain")
            calls.append((conflict, valid, steps))
            return keep
        ties, host = 0, {}
        fsm.greedy_keep_from_conflicts = spy
        try:
            for i, f in enumerate(frames):
                x = torch.from_numpy(letterbox(f, (imgsz, imgsz),
                                               scale_fill=True)[0][None])
                b, sc = (t[0] for t in fs.model.predict_step(x.to(dev))[:2])
                b_np, s_np = b.float().cpu().numpy(), sc.float().cpu().numpy()
                ties = max(ties, int(len(s_np) - len(np.unique(s_np))))
                # the facade's IoU, and 0.7, where an untrained head's
                # neighbouring boxes conflict
                for iou in (fs.iou, 0.7):
                    kept = fsm.candidate_nms(b, sc, fs.conf, iou,
                                             fs.max_det).cpu().numpy()
                    want = fsm.greedy_box_nms_np(b_np, s_np, fs.conf, iou,
                                                 fs.max_det, kind="stable")
                    check(np.array_equal(kept, want),
                          f"fastsam frame {i}, iou {iou}: keep set "
                          f"{kept.tolist()} != host loop {want.tolist()}")
                    c = calls[-1][0]
                    h = host.setdefault(str(iou), {"frames": 0,
                                                   "conflicts_per_row": 0.0})
                    h["frames"] += 1
                    h["conflicts_per_row"] += float(
                        c.float().sum(-1).mean()) / len(frames)
                    if iou == fs.iou:
                        check(np.array_equal(b_np[kept], outs[i]["boxes"]),
                              f"fastsam frame {i}: everything's boxes")
        finally:
            fsm.greedy_keep_from_conflicts = greedy_keep_from_conflicts
        # the loop orders equal scores by index, as the port's stable sort
        rec.update(host_loop_equal=host, most_tied_scores=ties)
        first = outs[0]
        check(len(first["boxes"]) > 0, "fastsam: no mask on frame 0")
        gx, gy = first["meta"]["gain"]
        box = first["boxes"][0] / np.array([gx, gy, gx, gy])
        # a pixel of the largest mask (the box's centre where every mask is
        # empty), in original pixels
        ys, xs = np.nonzero(max(first["masks"], key=lambda m: m.sum()))
        Hp, Wp = first["masks"].shape[1:]
        k = len(ys) // 2
        point = ((xs[k] + 0.5) * imgsz / Wp / gx,
                 (ys[k] + 0.5) * imgsz / Hp / gy) if len(ys) else \
            ((box[0] + box[2]) / 2, (box[1] + box[3]) / 2)
        prompts = {}
        for name, kw in (("box", {"bboxes": [box]}),
                         ("point", {"points": [point]}),
                         ("text", {"texts": "red",
                                   "embedder": StubEmbedder()})):
            reset_counts()
            sel = fs(frames[0], **kw)
            prompts[name] = {
                "selected": len(sel["boxes"]),
                "launches": _only_greedy(f"fastsam {name}", 1, on_card)}
            check(len(sel["boxes"]) >= 1 or (name == "point" and
                                             not len(ys)),
                  f"fastsam {name} prompt: nothing selected")
        rec["prompts"] = prompts
        if on_card:
            conflict, valid, steps = calls[0]
            rec["greedy_on_path"] = _greedy_timed(conflict, valid, steps)
        del fs
        if on_card:
            torch.cuda.empty_cache()
    emit("fastsam", **rec)
    return rec


def phase_sam(variants=SAM_VARIANTS, img_size=SAM_IMGSZ, device=None,
              hw=(1080, 1920), generate=SAM_GENERATE,
              host_prefix=SAM_HOST_PREFIX):
    """SAM through `SAM(variant)` at `img_size`, f32 with TF32 off, for
    each variant (ViT-B and MobileSAM by default), on a 1080p frame:

    - `embed_image` (letterbox on the host, the embedding kept on the
      card) and the encoder's device ms;
    - a point, a box and a mixed prompt through `__call__` on the cached
      embedding (no kernel), and a decode's device ms;
    - `generate` at each grid, twice (the first call builds cuDNN's plans;
      the second is timed and checked): masks M before the suppression,
      one greedy launch (where M > 0) and nothing else, the kernel exactly its plain
      version on the conflict matrix (the one-pass walk), the keep set
      restricted to the top `host_prefix` masks exactly the JAX host loop
      over them, the greedy's device ms at M beside the plain version's,
      seconds and peak memory;
    - ViT-B: `import_sam_torch_weights` of a seeded state_dict of the
      model's own upstream keys (plus the buffers a checkpoint carries
      that are skipped), strict, every tensor loaded."""
    import torch

    from mo_yolo_tpu_torch.data.letterbox import letterbox
    from mo_yolo_tpu_torch.models import sam as sm
    from mo_yolo_tpu_torch.ops.suppress import greedy_keep_from_conflicts_torch
    from mo_yolo_tpu_torch.utils.sam_import import import_sam_torch_weights
    image = static_scene(1, hw=hw)[0]
    H, W = image.shape[:2]
    recs = {}
    with no_tf32():
        for variant in variants:
            s = sm.SAM(variant, img_size=img_size, device=device)
            dev = s.device
            on_card = dev.type == "cuda"
            sync = torch.cuda.synchronize if on_card else (lambda: None)
            g = img_size // 16
            rec = {"variant": variant, "encoder": s.model.encoder,
                   "img_size": img_size, "dtype": "float32", "tf32": False,
                   "params": sum(p.numel() for p in s.model.parameters()),
                   "card": card_line() if on_card else None}
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t = time.perf_counter()
            emb, meta = s.embed_image(image)
            sync()
            check(emb.shape == (g, g, 256) and emb.device.type == dev.type and
                  bool(torch.isfinite(emb).all()),
                  f"sam {variant}: embedding {tuple(emb.shape)}")
            x = torch.from_numpy(letterbox(image, (img_size, img_size))[0]
                                 [None]).to(dev).float() / 255.0
            rec["embed"] = {
                "first_seconds": time.perf_counter() - t,
                "ms": time_ms(lambda: s.model.embed(x), iters=3, warmup=1)
                if on_card else None,
                "device_ms": device_time_ms(lambda: s.model.embed(x),
                                            iters=3) if on_card else None}
            prompts = {
                "point": {"points": [[W * 0.5, H * 0.5]]},
                "box": {"bboxes": [[W * 0.3, H * 0.3, W * 0.6, H * 0.7]]},
                "mixed": {"points": [[W * 0.45, H * 0.5], [W * 0.1, H * 0.1]],
                          "labels": [1, 0],
                          "bboxes": [[W * 0.3, H * 0.3, W * 0.6, H * 0.7],
                                     [W * 0.1, H * 0.2, W * 0.4, H * 0.9]]}}
            rec["prompts"] = {}
            for name, kw in prompts.items():
                out = s(**kw)
                B = 2 if name == "mixed" else 1
                check(out["masks"].shape == (B, img_size, img_size) and
                      np.isfinite(out["low_res"]).all() and
                      np.isfinite(out["iou"]).all(),
                      f"sam {variant} {name}: outputs")
                p, l = s._pack(kw.get("points"), kw.get("labels"),
                               kw.get("bboxes"), meta)
                pt = torch.from_numpy(p).to(dev)
                lt = torch.from_numpy(l).to(dev)
                rec["prompts"][name] = {
                    "sets": B, "iou": out["iou"].tolist(),
                    "mask_fraction": float(out["masks"].mean()),
                    "decode_device_ms": device_time_ms(
                        lambda: s.model.decode(emb, pt, lt), iters=5)
                    if on_card else None}
            _only_greedy(f"sam {variant} prompts", 0, on_card)
            for grid, kw in generate:
                seen = []
                mask_nms = sm.mask_nms

                def spy(masks, scores, nms_iou):
                    kept = mask_nms(masks, scores, nms_iou)
                    seen.append((masks, scores, nms_iou, kept))
                    return kept
                # the first call builds cuDNN's plans for its shapes; the
                # second is timed and checked
                secs = []
                sm.mask_nms = spy
                try:
                    for _ in range(2):
                        seen.clear()
                        reset_counts()
                        sync()
                        t = time.perf_counter()
                        out = s.generate(image, grid=grid, **kw)
                        sync()
                        secs.append(time.perf_counter() - t)
                finally:
                    sm.mask_nms = mask_nms
                masks, scores, nms_iou, kept = seen[0]
                M = int(masks.shape[0])
                key = f"generate_grid{grid}" + (
                    f"_crop{kw['crop_layers']}" if kw.get("crop_layers")
                    else "")
                r = {"grid": grid, **kw, "seconds": secs[1],
                     "first_seconds": secs[0], "masks_before": M,
                     "kept": len(out["masks"]),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9
                     if on_card else None,
                     "launches": _only_greedy(f"sam {variant} {key}",
                                              1 if M else 0, on_card)}
                check(len(out["masks"]) == len(out["scores"]) ==
                      len(kept) and np.isfinite(out["scores"]).all(),
                      f"sam {variant} {key}: outputs")
                if M:
                    order = torch.argsort(-scores, stable=True)
                    conflict = sm.mask_conflicts(masks[order], nms_iou)
                    valid = torch.ones(1, M, dtype=torch.bool, device=dev)
                    if on_card:
                        keep, stats = greedy_call(conflict, valid)
                        steps = check_walked(stats, M, f"sam {key}")
                    else:
                        keep, steps = sm.greedy_keep_from_conflicts(
                            conflict, valid), None
                    check(torch.equal(keep, greedy_keep_from_conflicts_torch(
                        conflict, valid)) and torch.equal(order[keep[0]],
                                                          kept),
                          f"sam {variant} {key}: greedy against plain")
                    m_np, s_np = masks.cpu().numpy(), scores.cpu().numpy()
                    order_np, kept_np = order.cpu().numpy(), \
                        kept.cpu().numpy()
                    top = order_np[:host_prefix]
                    host = top[sm.greedy_mask_nms_np(m_np[top], s_np[top],
                                                     nms_iou, kind="stable")]
                    check(np.array_equal(kept_np[np.isin(kept_np, top)],
                                         host),
                          f"sam {variant} {key}: keep set against the host "
                          f"loop over the top {len(top)}")
                    r.update(host_loop_masks=len(top),
                             tied_scores=int(len(s_np) -
                                             len(np.unique(s_np))))
                    if on_card:
                        r["greedy"] = _greedy_timed(conflict, valid, steps)
                        r["conflicts_device_ms"] = device_time_ms(
                            lambda: sm.mask_conflicts(masks[order], nms_iou),
                            iters=3)
                rec[key] = r
            if variant == "b":
                rng = np.random.default_rng(0)
                sd = {k: rng.normal(0, 0.02, tuple(t.shape)).astype(
                    np.float32) for k, t in s.model.state_dict().items()}
                sd.update(pixel_mean=np.zeros((3, 1, 1), np.float32),
                          pixel_std=np.ones((3, 1, 1), np.float32))
                rep = import_sam_torch_weights(s.model, sd, strict=True)
                same = all(np.array_equal(t.cpu().numpy(), sd[k])
                           for k, t in s.model.state_dict().items())
                check(same and not rep["missing"] and not rep["unused"],
                      "sam_import: strict load of the port's own keys")
                rec["sam_import"] = {"tensors": len(rep["loaded"]),
                                     "strict": True, "equal": True}
            recs[variant] = rec
            emit(f"sam_{variant}", **rec)
            del s, emb, x
            if on_card:
                torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------- zoo

ZOO_TRACK_IMGSZ, ZOO_IMGSZ, ZOO_FRAMES, ZOO_K1_CHECK_FRAMES = \
    "1536x800", 640, 4, 2
# (name, graph, scale, facade): upstream's detectors as the JAX parser
# builds them
ZOO_DETECTORS = (("yolov3", "yolov3", None, "nas"),
                 ("yolov3-spp", "yolov3-spp", None, "nas"),
                 ("yolov3-tiny", "yolov3-tiny", None, "nas"),
                 ("yolov5l", "yolov5", "l", "nas"),
                 ("yolov5l6", "yolov5-p6", "l", "nas"),
                 ("yolov6l", "yolov6", "l", "nas"),
                 ("yolov8x-seg", "yolov8-seg", "x", "segment"))
K1_BF16_TOL = 1e-2        # phase_kernel's bf16 rule: |d| <= tol (1 + |want|)


def zoo_track(cfg, imgsz, frames, device=None, dtype="bfloat16"):
    """`MOTRTrack(cfg).predict` over `frames`: frames/s, launches (6 K1 and
    1 greedy a frame and nothing else), every greedy call audited, each K1
    call of the first ZOO_K1_CHECK_FRAMES frames held to the plain sampler
    on its own inputs, the device ms of a `stream_step` (from a CUDA
    graph), parameters and peak memory."""
    import torch

    from mo_yolo_tpu_torch import MOTRTrack
    from mo_yolo_tpu_torch.data.letterbox import to_hw
    from mo_yolo_tpu_torch.models import transformer
    from mo_yolo_tpu_torch.ops.deform_attn import ms_deform_attn_torch
    from mo_yolo_tpu_torch.ops.preprocess import device_letterbox
    tracker = MOTRTrack(cfg, imgsz=imgsz, dtype=dtype, seed=0, device=device)
    model = tracker.model
    prepare(model, shift_scores=True)
    on_card = tracker.device.type == "cuda"
    n_layers = len(model.head.decoder.decoder.layers)
    kernel, calls = transformer.SAMPLERS[None], []

    def k1(v, shapes, loc, attn):
        out = kernel(v, shapes, loc, attn)
        if len(calls) < n_layers * ZOO_K1_CHECK_FRAMES:
            calls.append((v.detach().clone(), shapes, loc.detach().clone(),
                          attn.detach().clone(), out.detach().clone()))
        return out
    packed = spy_outputs(model)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    transformer.SAMPLERS[None] = k1
    reset_counts()
    stamps = []
    try:
        with greedy_audit(f"zoo track {imgsz}") as audit:
            for _ in tracker.predict(frames, conf=0.5):
                stamps.append(time.perf_counter())
    finally:
        transformer.SAMPLERS[None] = kernel
    launches = counts()
    del model.stream_step                  # the spy: back to the class's
    n = len(frames)
    check(len(packed) == n, "zoo track: frame count")
    valid = []
    for out in packed:
        a = out[0].float().cpu().numpy()
        check(np.isfinite(a).all(), "zoo track: non-finite outputs")
        valid.append(int((a[:, 7] > 0.5).sum()))
    check(max(valid) <= model.tracker.n_slots and sum(valid) > 0,
          f"zoo track: valid rows a frame {valid}")
    if on_card:
        check(launches["ms_deform_attn_fwd"] == n_layers * n and
              launches["greedy_keep"] == n and
              sum(launches.values()) == (n_layers + 1) * n,
              f"zoo track: launches {launches}, expected {n_layers} K1 "
              f"and 1 greedy a frame and nothing else")
    k1_err = 0.0
    for v, shapes, loc, attn, out in calls:
        want = ms_deform_attn_torch(v.float(), shapes, loc.float(),
                                    attn.float())
        d = (out.float() - want).abs()
        check(bool((d <= K1_BF16_TOL * (1 + want.abs())).all()),
              f"zoo track: K1 differs from the plain sampler by "
              f"{float(d.max())}")
        k1_err = max(k1_err, float(d.max()))
    steady = stamps[WARMUP:] if len(stamps) > WARMUP + 1 else stamps
    rec = {"imgsz": imgsz, "dtype": dtype, "frames": n,
           "params": sum(p.numel() for p in model.parameters()),
           "taps": list(model.spec.out_channels),
           "steady_fps": (len(steady) - 1) / (steady[-1] - steady[0]),
           "valid_per_frame": valid, "launches": launches,
           "greedy_audit": audit,
           "k1_checked_calls": len(calls), "k1_max_abs_err": k1_err,
           "k1_tol": f"{K1_BF16_TOL} x (1 + |plain|)"}
    if on_card:
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        x = device_letterbox(torch.from_numpy(frames[0][None]).cuda(),
                             to_hw(imgsz), scale_fill=True)
        state = model.init_state(1)
        rec["device_ms_per_frame"] = device_time_ms(
            lambda: model.stream_step(state, x), iters=5)
    del tracker, model, calls
    return rec


def zoo_same_as_yolo_track(cfg, imgsz, frame, device=None,
                           dtype="bfloat16"):
    """The `scale: l` form of the v8-x track graph against the bundled
    `yolo_track`, both from seed 0: the same spec, state_dict keys, shapes
    and values, and the same packed output of one `stream_step`, bit for
    bit."""
    import torch

    from mo_yolo_tpu_torch import MOTRTrack
    from mo_yolo_tpu_torch.data.letterbox import to_hw
    from mo_yolo_tpu_torch.ops.preprocess import device_letterbox
    a = MOTRTrack("yolo_track", imgsz=imgsz, dtype=dtype, seed=0,
                  device=device).model
    b = MOTRTrack(cfg, imgsz=imgsz, dtype=dtype, seed=0, device=device).model
    check(a.spec == b.spec, "zoo scale l: spec differs from yolo_track's")
    sa, sb = a.state_dict(), b.state_dict()
    check(list(sa) == list(sb) and all(
        sa[k].shape == sb[k].shape and torch.equal(sa[k], sb[k])
        for k in sa), "zoo scale l: state_dict differs from yolo_track's")
    x = device_letterbox(torch.from_numpy(frame[None]).to(
        next(a.parameters()).device), to_hw(imgsz), scale_fill=True)
    pa = a.stream_step(a.init_state(1), x)[1]
    pb = b.stream_step(b.init_state(1), x)[1]
    check(torch.equal(pa, pb), f"zoo scale l: packed output differs from "
          f"yolo_track's in {int((pa != pb).any(-1).sum())} rows")
    rec = {"spec_equal": True, "tensors": len(sa), "packed_equal": True,
           "packed_rows": int(pa.shape[1])}
    del a, b
    return rec


def zoo_detector(name, cfg, facade, frames, imgsz, device, tmp):
    """One era detector: `predict` over `frames` with one audited greedy
    launch an image and nothing else; parameters and first-frame seconds;
    for v6 (ReLU, raw ConvTranspose2d rows) a `pt2` program equal to the
    eager step bit for bit, with one greedy node and one launch."""
    import torch

    from mo_yolo_tpu_torch.api import _TaskModel
    from mo_yolo_tpu_torch.data.letterbox import letterbox
    from mo_yolo_tpu_torch.models.nas import NAS
    m = NAS(cfg, imgsz=imgsz, device=device) if facade == "nas" else \
        _TaskModel(facade, cfg, imgsz=imgsz, device=device)
    on_card = m.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    reset_counts()
    sync()
    with greedy_audit(f"zoo {name}") as audit:
        outs, secs = _timed(m.predict(frames))
        sync()
    check(len(outs) == len(frames), f"zoo {name}: {len(outs)} frames")
    for o in outs:
        arrays = o[1] if facade != "nas" else (o.boxes_xyxy, o.conf)
        check(all(np.isfinite(np.asarray(a)).all() for a in arrays),
              f"zoo {name}: non-finite outputs")
    spec = m.model.spec
    rec = {"scale": cfg.get("scale"), "params": sum(
        p.numel() for p in m.model.parameters()),
        "taps": list(spec.out_channels), "strides": list(spec.out_strides),
        "act": "relu" if spec.act == "relu" else "silu",
        "first_frame_s": secs[0],
        "frames_per_s": (len(secs) - 1) / sum(secs[1:]),
        "greedy_audit": audit,
        "launches": _only_greedy(f"zoo {name}", len(frames), on_card)}
    if facade == "nas" and max(spec.out_strides) == 64:
        # TTA on a stride-64 graph: the sides rounded to 64, one NMS over
        # the three scales' union
        reset_counts()
        sync()
        with greedy_audit(f"zoo {name} tta") as audit:
            outs, secs = _timed(m.predict(frames[:1], augment=True))
            sync()
        check(len(outs) == 1 and np.isfinite(outs[0].boxes_xyxy).all() and
              np.isfinite(outs[0].conf).all(),
              f"zoo {name} tta: non-finite outputs")
        rec["tta"] = {"seconds": secs[0], "detections": len(outs[0]),
                      "greedy_audit": audit,
                      "launches": _only_greedy(f"zoo {name} tta", 1,
                                               on_card)}
        check(not on_card or audit["calls"] == 1,
              f"zoo {name} tta: {audit['calls']} greedy calls audited")
    if name.startswith("yolov6"):
        from mo_yolo_tpu_torch.utils.program_export import (load_program,
                                                            op_counts)
        x = torch.from_numpy(letterbox(frames[0], (imgsz, imgsz),
                                       scale_fill=True)[0][None]).to(m.device)
        t = time.perf_counter()
        ep = load_program(m.export("pt2", path=str(tmp / name)), m.device)
        export_s = time.perf_counter() - t
        nodes = op_counts(ep).get("mo_yolo_tpu_torch.greedy_keep.default")
        reset_counts()
        got = ep.module()(x)
        launches = _only_greedy(f"zoo {name} pt2", 1, on_card)
        want = m.model.predict_step(x)
        check(nodes == 1 and all(torch.equal(a, b)
                                 for a, b in zip(got, want)),
              f"zoo {name} pt2: {nodes} greedy nodes, or differs from the "
              f"eager step")
        rec["pt2"] = {"export_and_load_seconds": export_s,
                      "greedy_nodes": nodes, "equal": True,
                      "launches": launches}
        del ep
    del m
    if on_card:
        torch.cuda.empty_cache()
    return rec


def phase_zoo(device=None, track_imgsz=ZOO_TRACK_IMGSZ, imgsz=ZOO_IMGSZ,
              frames=None, n_frames=ZOO_FRAMES):
    """Upstream's graphs in the port: the v8-x tracker beside `yolo_track`
    through the same loop, its `scale: l` form against `yolo_track`, the
    era detectors (see the module's docstring)."""
    import tempfile

    from tests.torch_port_zoo import zoo
    frames = static_scene(N_FRAMES) if frames is None else frames
    (ROOT / "build").mkdir(exist_ok=True)
    rec = {"card": card_line() if device is None else None}
    cfg = zoo("v8x_track")
    rec["v8x_track"] = zoo_track(cfg, track_imgsz, frames, device)
    rec["yolo_track"] = zoo_track("yolo_track", track_imgsz, frames, device)
    rec["scale_l_is_yolo_track"] = zoo_same_as_yolo_track(
        dict(cfg, scale="l"), track_imgsz, frames[0], device)
    rec["detectors"] = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, no_tf32():
        for name, graph, scale, facade in ZOO_DETECTORS:
            rec["detectors"][name] = zoo_detector(
                name, zoo(graph, scale), facade, frames[:n_frames], imgsz,
                device, Path(tmp))
    rec["launches_detectors"] = {"greedy_keep": sum(
        r["launches"].get("greedy_keep", 0)
        for r in rec["detectors"].values())}
    emit("zoo", **rec)
    return rec


def _dist_launches(dist, name):
    """A kernel's launches a rank's step in the distributed phase: the
    sharded step's and the trainer's first step's, each rank's."""
    return {"launches_distributed_step_per_rank": [
        c[name] for c in dist["step"]["full"]["launches_rank"]],
        "launches_distributed_trainer_step_per_rank": [
        c[0][name] for c in dist["trainer"]["launches_per_step"]]}


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
    phase_host_tools()
    phase_resample()
    phase_jpeg()

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
    jv = phase_jv()
    study_recs = phase_kernel_variants()
    study_launches = phase_study()
    slices = [phase_slice("1536x800"), phase_slice(640)]
    formats = phase_formats(slices[0]["tracker"])
    sources = phase_sources(slices[0]["tracker"])
    for rec in slices:
        phase_profile(rec["tracker"].model, rec["imgsz"], static_scene(1)[0])
        del rec["tracker"]
    configs = phase_configs()
    multistream = phase_multistream()
    val = phase_val()
    phase_in_context()
    train = phase_train()
    trainer = phase_trainer(train_step_ms=train["step_ms_median"])
    dist = phase_distributed()
    cli = phase_cli()
    detect = phase_detect()
    rtdetr = phase_detect("RTDETR", DETECT_MODELS[1], epochs=1, steps=2,
                          validate=False, track=False)
    tasks = {t: phase_task(t) for t in ("segment", "pose", "classify")}
    export = phase_export()
    nas = phase_nas()
    fastsam = phase_fastsam()
    sam = phase_sam()
    zoo = phase_zoo()
    phase_train_in_context()
    phase_train_in_context(max_gt=256, num_denoising=100)
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
        "launches_val": val["launches"]["ms_deform_attn_fwd"],
        "launches_cli_predict": cli["predict"]["launches"][
            "ms_deform_attn_fwd"],
        "launches_multistream_b8": multistream["runs"][
            str(MS_STREAMS[-1])]["launches"]["ms_deform_attn_fwd"],
        "launches_study": study_launches["ms_deform_attn_fwd"],
        "launches_slice_configs": configs["launches"]["ms_deform_attn_fwd"],
        "launches_detect_predict": detect["predict"]["launches"][
            "ms_deform_attn_fwd"],
        "launches_detect_train_step": detect["train"]["launches_per_step"][
            "ms_deform_attn_fwd"],
        "launches_rtdetr_predict": rtdetr["predict"]["launches"][
            "ms_deform_attn_fwd"],
        "launches_rtdetr_train_step": rtdetr["train"]["launches_per_step"][
            "ms_deform_attn_fwd"],
        "launches_detect_track": {
            kind: t["launches"]["ms_deform_attn_fwd"]
            for kind, t in detect["track"].items()},
        "launches_pt2_1536x800": export["launches"]["ms_deform_attn_fwd"],
        "launches_pt2_per_frame": export["launches_per_frame"][
            "ms_deform_attn_fwd"],
        "launches_pt2_dynamic_b4": export["dynamic"]["launches"][
            "ms_deform_attn_fwd"],
        "launches_formats_mixed_predict": formats["predict"]["launches"][
            "ms_deform_attn_fwd"],
        "launches_sources_video_predict": sources["launches"][
            "ms_deform_attn_fwd"],
        "launches_zoo_v8x_track": zoo["v8x_track"]["launches"][
            "ms_deform_attn_fwd"],
        "launches_zoo_yolo_track": zoo["yolo_track"]["launches"][
            "ms_deform_attn_fwd"],
        **_dist_launches(dist, "ms_deform_attn_fwd"),
        **{k: k1[k] for k in keys}, "library_ms": None}, {
        "name": "ms_deform_attn_bwd", "route": "cuda",
        "source": f"{csrc}/ms_deform_attn_bwd.cu",
        "replaces": "mo_yolo_tpu/ops/deform_attn_pallas.py:149",
        "launches": launches["ms_deform_attn_bwd"],
        "launches_detect_train_step": detect["train"]["launches_per_step"][
            "ms_deform_attn_bwd"],
        "launches_rtdetr_train_step": rtdetr["train"]["launches_per_step"][
            "ms_deform_attn_bwd"],
        **_dist_launches(dist, "ms_deform_attn_bwd"),
        **{k: k2[k] for k in keys + design}, "library_ms": None}, {
        "name": "greedy_keep", "route": "cuda",
        "source": f"{csrc}/greedy_keep.cu",
        "replaces": "mo_yolo_tpu/models/tracker.py:128 (lax.while_loop, XLA)",
        "launches": slices[0]["launches"]["greedy_keep"],
        "launches_per_frame": slices[0]["launches"]["greedy_keep"] /
        slices[0]["frames"],
        "launches_val": val["launches"]["greedy_keep"],
        "launches_cli_predict": cli["predict"]["launches"]["greedy_keep"],
        "launches_slice_configs": configs["launches"]["greedy_keep"],
        "launches_detect_predict": detect["predict"]["launches"][
            "greedy_keep"],
        "launches_segment_predict": tasks["segment"]["predict"]["launches"][
            "greedy_keep"],
        "launches_segment_val": tasks["segment"]["val"]["launches"][
            "greedy_keep"],
        "launches_pose_predict": tasks["pose"]["predict"]["launches"][
            "greedy_keep"],
        "launches_task_train_step": sum(
            tasks[t]["train"]["launches_per_step"]["greedy_keep"]
            for t in tasks),
        "launches_pt2_1536x800": export["launches"]["greedy_keep"],
        "launches_pt2_per_frame": export["launches_per_frame"][
            "greedy_keep"],
        "launches_pt2_dynamic_b4": export["dynamic"]["launches"][
            "greedy_keep"],
        "launches_pt2_segment": export["segment"]["launches"]["greedy_keep"],
        "launches_formats_mixed_predict": formats["predict"]["launches"][
            "greedy_keep"],
        "launches_sources_video_predict": sources["launches"]["greedy_keep"],
        "launches_nas_predict": nas["predict"]["launches"]["greedy_keep"],
        "launches_nas_tta": nas["predict_tta"]["launches"]["greedy_keep"],
        "launches_nas_val": nas["val"]["launches"]["greedy_keep"],
        "launches_zoo_v8x_track": zoo["v8x_track"]["launches"][
            "greedy_keep"],
        "launches_zoo_yolo_track": zoo["yolo_track"]["launches"][
            "greedy_keep"],
        "launches_zoo_detectors": zoo["launches_detectors"]["greedy_keep"],
        "launches_zoo_p6_tta": zoo["detectors"]["yolov5l6"]["tta"][
            "launches"]["greedy_keep"],
        "launches_distributed_val_per_rank": [
            v[0]["greedy_keep"] for v in dist["trainer"]["launches_per_val"]],
        "launches_fastsam_everything": fastsam["everything"]["launches"][
            "greedy_keep"],
        "launches_sam_generate": {
            f"{v}_{k}": r[k]["launches"].get("greedy_keep", 0)
            for v, r in sam.items() for k in r if k.startswith("generate")},
        "fastsam_path": fastsam["greedy_on_path"],
        "sam_mask_nms": {f"{v}_{k}": {"masks": r[k]["masks_before"],
                                      **r[k].get("greedy", {})}
                         for v, r in sam.items() for k in r
                         if k.startswith("generate")},
        **{k: greedy[k] for k in keys}, "steps": greedy["steps"],
        "staged_m2048": {k: greedy["m2048"][k] for k in keys[1:] +
                         ("steps",)},
        **{k: {f: greedy[k][f] for f in keys[1:] + ("steps",)}
           for k in greedy if k.startswith("nms_")},
        "nms_segment_path": {f: tasks["segment"]["checks"]["greedy_on_path"][f]
                             for f in ("n", "conflicts_per_row", "steps") +
                             keys[1:]},
        "library_ms": None}, {
        "name": "jv_assign", "route": "cuda",
        "source": f"{csrc}/jv_assign.cu",
        "replaces": "mo_yolo_tpu/ops/matching.py:90 (_jv_single: "
                    "lax.scan + lax.while_loop, XLA)",
        "launches": launches["jv_assign"],
        "launches_per_train_step": train["launches_per_step"]["jv_assign"],
        "device_ms_per_train_step": train["matcher_device"]["ms_per_step"],
        "launches_stream_1536x800": slices[0]["launches"]["jv_assign"],
        "launches_val": val["launches"]["jv_assign"],
        "launches_detect_train_step": detect["train"]["launches_per_step"][
            "jv_assign"],
        "launches_rtdetr_train_step": rtdetr["train"]["launches_per_step"][
            "jv_assign"],
        **_dist_launches(dist, "jv_assign"),
        **{k: jv[k] for k in keys}, "steps": jv["steps"],
        "walked_steps": jv["walked_steps"],
        "device_us_per_walked_step": jv["device_us_per_walked_step"],
        "shapes": {case: {k: t[k] for k in keys[1:] + (
            "steps", "walked_steps", "padded_decided", "padded_walked",
            "device_us_per_walked_step", "one_by_one_device_ms") if k in t}
            for case, t in jv["shapes"].items()},
        "library_ms": None}]
    check(all(rec["launches"]["jv_assign"] == 0 for rec in slices) and
          val["launches"]["jv_assign"] == 0,
          "jv_assign: launched on the streaming or evaluation path")
    # the study's kernels: launches are the study phase's, the path that
    # runs them; the streaming and training paths launch none
    for name in ("take_along_axis",) + VARIANT_KERNELS:
        check(launches[name] == 0 and val["launches"][name] == 0 and
              trainer["launches_per_step"][name] == 0 and
              trainer["launches_per_val"][name] == 0 and
              all(rec["launches"][name] == 0 for rec in slices),
              f"{name}: launched on the streaming, evaluation or training "
              f"path")
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
