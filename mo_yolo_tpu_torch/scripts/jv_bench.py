"""The matcher's kernel (`ops/csrc/jv_assign.cu`) timed on one card at the
training step's problems, and the problems themselves (`JV_CASES`,
`jv_inputs`), which `chip_smoke.py`'s `jv` phase also checks.

    python3 -m mo_yolo_tpu_torch.scripts.jv_bench [--out FILE]

Per timed case one JSON line: `device_ms` (the calls replayed from a CUDA
graph, the median of five replays of 20), the Dijkstra steps the JAX
solver takes, and, where the checkout keeps them (`jv_counts`), the steps
the kernel walked, the padded GT rows it decided at once and those it
walked, and µs per walked step. The same inputs on every checkout: two
compare on one card when this file runs with each one's root first on the
path, in turns (A, B, B, A), all in one command:

    PYTHONPATH=path/to/checkout python3 mo_yolo_tpu_torch/scripts/jv_bench.py
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

JV_BIG = 1e6      # `match_cost`'s cost of a padded column or masked query
# (B, Q, G, valid GT a problem, layout, cost kind). Layouts: "random" valid
# GT slots anywhere; "first" the valid GT first, as the dataset pads a
# frame (`data/dataset.py`), so every padded row follows the valid ones;
# "tracked" that, with every third object tracked (the tracker's mask
# `gt_mask & ~gt_tracked`: valid rows after padded ones). Kinds: "detr"
# `match_cost` of random predictions against random GT boxes; "aux" that
# with the first half of the queries (the track slots) at `JV_BIG`, an aux
# decoder layer's problem; "ties" integer costs in {0, 1, 2}; "uniform" in
# [0, 10); "rounding" all but 4 queries at `JV_BIG` plus < 0.05, so the
# duals round at 1e6 and some padded rows must be walked.
JV_CASES = {"track": (1, 300, 64, (20,), "random", "detr"),
            "aux": (1, 600, 64, (20,), "random", "aux"),
            "max_gt_256": (1, 600, 256, (150,), "random", "detr"),
            "track_first": (1, 300, 64, (20,), "first", "detr"),
            "aux_first": (1, 600, 64, (20,), "first", "aux"),
            # a frame's 5 aux layers, one launch (`match_layers`)
            "aux_layers": (5, 600, 64, (20,) * 5, "first", "aux"),
            # every GT slot valid: every row walked, none decided
            "aux_full": (1, 600, 64, (64,), "first", "aux"),
            "tracked": (2, 300, 64, (20, 35), "tracked", "detr"),
            "sweep": (16, 300, 64, tuple(range(2, 64, 4)), "random",
                      "detr"),
            "rounding": (8, 24, 16, (8,) * 8, "random", "rounding"),
            # more than 1,536 and 2,048 queries: a thread's columns in four
            # registers, and in shared memory
            "q1600": (1, 1600, 64, (20,), "first", "detr"),
            "q2100": (1, 2100, 64, (20,), "first", "detr"),
            "wide": (3, 40, 70, (70, 30, 41), "random", "uniform"),
            "ties": (2, 600, 64, (40, 64), "random", "ties"),
            "all_padding": (2, 300, 64, (0, 0), "random", "detr")}
JV_TIMED = ("track", "aux", "max_gt_256", "track_first", "aux_first",
            "aux_layers", "aux_full", "tracked")


def jv_inputs(case, seed=0, device="cuda"):
    """(cost [B,Q,G] f32, gt_mask [B,G] bool) of `JV_CASES[case]`, made on
    the host from `seed`; padded columns at `JV_BIG`."""
    from mo_yolo_tpu_torch.ops.matching import match_cost
    B, Q, G, n_valid, layout, kind = JV_CASES[case]
    g = torch.Generator().manual_seed(seed)
    mask = torch.zeros(B, G, dtype=torch.bool)
    for b, n in enumerate(n_valid):
        if layout == "random":
            mask[b, torch.randperm(G, generator=g)[:n]] = True
        else:
            mask[b, :n] = True
            if layout == "tracked":
                mask[b, ::3] = False
    if kind in ("detr", "aux"):
        def boxes(n):
            return torch.cat([torch.rand(B, n, 2, generator=g) * 0.6 + 0.2,
                              torch.rand(B, n, 2, generator=g) * 0.25 + 0.05],
                             -1)
        logits = torch.randn(B, Q, 5, generator=g) * 2
        cost = match_cost(boxes(Q), logits, boxes(G),
                          torch.randint(0, 5, (B, G), generator=g), mask,
                          big=JV_BIG)
        if kind == "aux":
            cost[:, :Q // 2] = JV_BIG
    elif kind == "ties":
        cost = torch.randint(0, 3, (B, Q, G), generator=g).float()
    elif kind == "rounding":
        cost = JV_BIG + torch.rand(B, Q, G, generator=g) * 0.05
        cost[:, :4] = torch.rand(B, 4, G, generator=g) * 0.1
    else:
        cost = torch.rand(B, Q, G, generator=g) * 10
    cost = torch.where(mask[:, None, :], cost, torch.full_like(cost, JV_BIG))
    return cost.float().contiguous().to(device), mask.to(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("jv_bench: no CUDA device", file=sys.stderr)
        return 2
    from mo_yolo_tpu_torch.ops import matching
    from mo_yolo_tpu_torch.scripts.timing import card_line, device_ms
    from mo_yolo_tpu_torch.utils import cuda_build
    cuda_build.build(["jv_assign"])
    dev = torch.device("cuda")
    card = card_line(dev)
    # a checkout from before the counts (`jv_counts`) reports the steps
    counting = hasattr(matching, "jv_counts")
    records = []
    for case in JV_TIMED:
        cost, mask = jv_inputs(case)
        rec = {"bench": "jv", "case": case, "shape": list(cost.shape),
               "device_ms": device_ms(
                   lambda: matching.hungarian_jv(cost, mask), 20, dev),
               "card": card, "package": str(cuda_build.CSRC.parent.parent)}
        if counting:
            counts = matching.jv_counts(dev).zero_()
        _, steps = matching.hungarian_jv(cost, mask, with_stats=True)
        walked = int(steps.sum())
        if counting:
            walked, decided, padded_walked = counts.tolist()
            rec.update(walked_steps=walked, padded_decided=decided,
                       padded_walked=padded_walked)
        rec["steps"] = int(steps.sum())
        rec["device_us_per_walked_step"] = \
            rec["device_ms"] * 1e3 / max(walked, 1)
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"records": records}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
