"""K2, the sampler's gradient (`ops/csrc/ms_deform_attn_bwd.cu`), timed on
one card at the training path's shapes, with its stages.

    python3 -m mo_yolo_tpu_torch.scripts.k2_bench [--out FILE]

Cases: B=1, Q=728 (128 denoising, 300 track slots, 300 detect queries),
H=8, D=32, L=3, P=4 at 1536x800's and 640x640's level shapes; loc uniform
in [-0.05, 1.05] or clustered in [0.45, 0.55] (training queries gather on a
few objects, so a d_value row collects hundreds of corners); bf16, and f32
for the uniform case. Inputs as `chip_smoke.py`'s timing (seed 1). Per case
one JSON line: `device_ms` (the calls replayed from a CUDA graph, the
median of five replays of 20) and `stages_device_ms` (torch.profiler's
device time per call of each of K2's launches). `--out` also writes every
kernel's `ptxas -v` report as nvcc printed it.

Two checkouts compare on one card when this file runs with each one's root
first on the path, in turns (A, B, B, A), all in one command:

    PYTHONPATH=path/to/checkout python3 mo_yolo_tpu_torch/scripts/k2_bench.py
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

LEVELS = {"1536x800": ((100, 192), (50, 96), (25, 48)),
          "640x640": ((80, 80), (40, 40), (20, 20))}
B, Q, H, D, P = 1, 728, 8, 32, 4
SPREADS = {"uniform": (-0.05, 1.05), "clustered": (0.45, 0.55)}


def inputs(levels, loc_range, dtype, seed=1):
    """value, loc, attn and g on the card, made on the host from a seed."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    S, L = sum(h * w for h, w in levels), len(levels)
    value = torch.randn(B, S, H, D, generator=g)
    loc = torch.rand(B, Q, H, L, P, 2, generator=g) * \
        (loc_range[1] - loc_range[0]) + loc_range[0]
    attn = torch.softmax(torch.randn(B, Q, H, L * P, generator=g), -1)
    grad = torch.randn(B, Q, H * D, generator=g)
    return (value.to("cuda", dtype), loc.cuda(),
            attn.view(B, Q, H, L, P).cuda(), grad.to("cuda", dtype))


def stages_ms(fn, n=10):
    """Device ms per call of each kernel (and memset) `fn` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            out[e.key.split("<")[0].split("(")[0].replace("void ", "")] = \
                us / n / 1e3
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the records and every "
                    "kernel's ptxas report to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_bench: no CUDA device", file=sys.stderr)
        return 2
    from mo_yolo_tpu_torch.ops.deform_attn import ms_deform_attn_backward
    from mo_yolo_tpu_torch.scripts.timing import card_line, device_ms
    from mo_yolo_tpu_torch.utils import cuda_build
    names = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    cuda_build.build(names)
    dev = torch.device("cuda")
    card = card_line(dev)
    records = []
    for size, levels in LEVELS.items():
        for spread, loc_range in SPREADS.items():
            for dtype in (torch.bfloat16, torch.float32):
                if spread == "clustered" and dtype == torch.float32:
                    continue
                value, loc, attn, grad = inputs(levels, loc_range, dtype)

                def call():
                    return ms_deform_attn_backward(value, levels, loc, attn,
                                                   grad)
                rec = {"bench": "k2", "size": size, "spread": spread,
                       "dtype": str(dtype)[6:],
                       "device_ms": device_ms(call, 20, dev),
                       "stages_device_ms": stages_ms(call),
                       "card": card,
                       "package": str(cuda_build.CSRC.parent.parent)}
                records.append(rec)
                print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"records": records, "ptxas": cuda_build.build_log},
                      f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
