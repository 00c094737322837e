"""Micro-benchmarks that ground the sampler's redesign (port of
`scripts/micro_peak_bench.py`).

    python3 -m mo_yolo_tpu_torch.scripts.micro_peak_bench

1. The matmul rate `torch.matmul` reaches at the study's shapes (the JAX
   script computes these outside any kernel of its own, too).
2. What one launch costs: a kernel that does nothing, launched as the
   port launches its kernels (a Python wrapper, ctypes, the raw current
   stream). It is the host's cost per launch, the floor under every
   back-to-back timing of a kernel that runs for less.
3. The gather. On the TPU the script asks whether Mosaic can gather beyond
   one vector register at all; on the card a gather is a load, so the probe
   runs `ops.gather.take_along_axis` at the four shapes on random in-bounds
   indices from a seed, says that it ran and is right, and gives its time
   beside `torch.gather`'s.

One JSON line per measurement, each with the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Sequence

import torch

from mo_yolo_tpu_torch.ops.gather import (empty_launch, take_along_axis,
                                          take_along_axis_torch)
from mo_yolo_tpu_torch.scripts.timing import (card_line, device_ms,
                                              device_record, measure)
from mo_yolo_tpu_torch.utils.device import resolve_device

# (m, k, n, dtype): two square sizes, and the sampler's one-hot product at
# 128 queries a tile (R = 512 rows against the level-0 table)
MATMUL_SHAPES = ((2048, 2048, 2048, torch.bfloat16),
                 (2048, 2048, 2048, torch.float32),
                 (512, 512, 512, torch.bfloat16),
                 (512, 3200, 3200, torch.bfloat16))
# (S, N, axis): a level-0-sized table and an 8-row one along axis 0, one
# and two 128-column blocks along axis 1
GATHER_SHAPES = ((19200, 256, 0), (8, 256, 0), (256, 128, 1), (256, 256, 1))


def bench_matmul(m: int, k: int, n: int, dtype: torch.dtype,
                 device: torch.device, iters: int = 50) -> Dict[str, object]:
    g = torch.Generator().manual_seed(0)
    a = torch.randn(m, k, generator=g).to(device, dtype)
    b = torch.randn(k, n, generator=g).to(device, dtype)
    rec = measure(lambda: torch.matmul(a, b), iters, device)
    return {"bench": "matmul", "shape": [m, k, n], "dtype": str(dtype)[6:],
            **rec, "tflops": 2 * m * k * n / (rec["ms"] * 1e-3) / 1e12,
            "device": device_record(device)}


def bench_empty_launch(device: torch.device, iters: int = 2000
                       ) -> Dict[str, object]:
    """The cost of one launch of an empty kernel, in microseconds: `us` as
    the host issues them one after another, `device_us` replayed from a
    CUDA graph, and the host clock's share of the steps a wrapper may
    take to find its stream: entering `torch.cuda.device` and asking
    `torch.cuda.current_stream()` (the wrappers' earlier launch path), and
    the raw current stream the wrappers now take
    (`torch._C._cuda_getCurrentRawStream`, `cuda_build.call`). On the CPU
    there is nothing to launch and all are null."""
    rec = {"bench": "empty_launch", "us": None, "device_us": None,
           "device_context_us": None, "current_stream_us": None,
           "raw_stream_us": None, "device": device_record(device)}
    if device.type == "cuda":
        def enter_context():
            with torch.cuda.device(device):
                pass

        def host_us(fn):
            fn()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) / iters * 1e6
        m = measure(lambda: empty_launch(device), iters, device)
        rec.update(us=m["ms"] * 1e3, us_min=m["ms_min"] * 1e3,
                   us_max=m["ms_max"] * 1e3, runs=m["runs"], iters=iters,
                   device_us=device_ms(lambda: empty_launch(device), 200,
                                       device) * 1e3,
                   device_context_us=host_us(enter_context),
                   current_stream_us=host_us(
                       lambda: torch.cuda.current_stream().cuda_stream),
                   raw_stream_us=host_us(
                       lambda: torch._C._cuda_getCurrentRawStream(
                           torch._C._cuda_getDevice())))
    return rec


def gather_inputs(S: int, N: int, axis: int, device: torch.device,
                  seed: int = 3):
    g = torch.Generator().manual_seed(seed)
    v = torch.randn(S, N, generator=g)
    idx = torch.randint(0, (S, N)[axis], (S, N), generator=g,
                        dtype=torch.int32)
    return v.to(device), idx.to(device)


def probe_gather(S: int, N: int, axis: int, device: torch.device,
                 iters: int = 200) -> Dict[str, object]:
    """Run the gather at [S, N] along `axis`, hold it to the plain version
    exactly, and time it beside `torch.gather`."""
    v, idx = gather_inputs(S, N, axis, device)
    got = take_along_axis(v, idx, axis)
    if not torch.equal(got, take_along_axis_torch(v, idx, axis)):
        raise AssertionError(f"gather [{S},{N}] axis={axis}: the kernel "
                             f"disagrees with the plain version")
    idx64 = idx.long()
    rec = measure(lambda: take_along_axis(v, idx, axis), iters, device)
    lib = measure(lambda: torch.gather(v, axis, idx64), iters, device)
    return {"bench": "gather", "shape": [S, N], "axis": axis, "ran": True,
            "exact": True, **rec,
            "device_ms": device_ms(lambda: take_along_axis(v, idx, axis), 20,
                                   device),
            "torch_gather_ms": lib["ms"],
            "torch_gather_device_ms": device_ms(
                lambda: torch.gather(v, axis, idx64), 20, device),
            "device": device_record(device)}


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions; default: the card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"bench": "micro_peak", "device": device_record(device),
                      "card": card_line(device)}), flush=True)
    records = [bench_empty_launch(device)]
    records += [bench_matmul(*shape, device) for shape in MATMUL_SHAPES]
    records += [probe_gather(*shape, device) for shape in GATHER_SHAPES]
    for rec in records:
        print(json.dumps(rec), flush=True)
    return records


if __name__ == "__main__":
    main()
