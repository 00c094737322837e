"""Bipartite matching for the set-prediction losses (counterpart of
`mo_yolo_tpu/ops/matching.py`).

`match_cost` builds the DETR matching cost on the device; `hungarian`
solves each problem with the Jonker-Volgenant solver of the JAX package
(`hungarian_jv`): on a CUDA tensor as one launch of `csrc/jv_assign.cu`,
which reads nothing back to the host, on a CPU tensor as its plain PyTorch
version (`hungarian_jv_torch`); `match` does both for a layer's
predictions, `match_layers` for several layers as one batch (one launch).
Where G <= Q the solver gives the JAX one's assignment and Dijkstra step
count, ties included; a padded GT row, whose walk the JAX solver takes
through every column zero reduced costs reach, is decided without the
walk wherever its outcome is certain (`_decide_padded`); `jv_counts`
keeps the steps walked and the padded rows decided and walked. Where G > Q it
drops the padded GT columns and, if the valid ones still outnumber the
queries, solves the transposed problem, so it keeps the optimum where the
JAX solver leaves GT columns unassigned. scipy's `linear_sum_assignment`
(`_scipy_assign`) is the tests' oracle and runs on no path.

Ground truth is padded to a fixed G with a column mask; an assignment is
an int32 array [B, G] of query rows, -1 for padding.

`AssignmentTape` makes the matcher repeatable under activation
checkpointing: `torch.utils.checkpoint` re-runs a frame in the backward
pass, and a recomputed cost that differs in its last bits could give
another assignment there. The training step records every assignment of
the first pass (device tensors) on a tape and replays them in the
recompute.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from mo_yolo_tpu_torch.ops.boxes import pairwise_giou, xywh2xyxy
from mo_yolo_tpu_torch.utils import cuda_build


def match_cost(pred_boxes: torch.Tensor, pred_logits: torch.Tensor,
               gt_boxes: torch.Tensor, gt_cls: torch.Tensor,
               gt_mask: torch.Tensor, gain_class: float = 2.0,
               gain_bbox: float = 5.0, gain_giou: float = 2.0,
               alpha: float = 0.25, gamma: float = 2.0,
               big: float = 1e6) -> torch.Tensor:
    """DETR matching cost: focal class cost, L1 and GIoU.

    pred_boxes [..., Q, 4] cxcywh, pred_logits [..., Q, nc], gt_boxes
    [..., G, 4], gt_cls [..., G] int, gt_mask [..., G] bool (False =
    padding). Returns cost [..., Q, G] with padded columns at `big` and
    NaN/inf entries scrubbed to 0."""
    p = torch.sigmoid(pred_logits)
    neg = (1 - alpha) * p ** gamma * -torch.log(1 - p + 1e-8)
    pos = alpha * (1 - p) ** gamma * -torch.log(p + 1e-8)
    cls = pos - neg                                              # [..., Q, nc]
    # padded columns may hold any class id; they are set to `big` below
    idx = gt_cls.long().clamp(0, cls.shape[-1] - 1)[..., None, :].expand(
        *cls.shape[:-1], gt_cls.shape[-1])
    cls_cost = torch.gather(cls, -1, idx)                       # [..., Q, G]
    bbox_cost = (pred_boxes[..., :, None, :] -
                 gt_boxes[..., None, :, :]).abs().sum(-1)
    giou_cost = 1.0 - pairwise_giou(xywh2xyxy(pred_boxes), xywh2xyxy(gt_boxes))
    c = gain_class * cls_cost + gain_bbox * bbox_cost + gain_giou * giou_cost
    c = torch.where(torch.isnan(c) | torch.isinf(c), torch.zeros_like(c), c)
    return torch.where(gt_mask[..., None, :], c, torch.full_like(c, big))


def _scipy_assign(cost: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The oracle: scipy's `linear_sum_assignment` on each problem's valid
    columns (the JAX package's `_scipy_assign`)."""
    from scipy.optimize import linear_sum_assignment
    B, Q, G = cost.shape
    out = np.full((B, G), -1, np.int32)
    for b in range(B):
        cols = np.nonzero(mask[b])[0]
        if cols.size == 0:
            continue
        r, c = linear_sum_assignment(cost[b][:, cols])
        out[b, cols[c]] = r.astype(np.int32)
    return out


_INF = 1e30     # the JAX solver's `_INF`
# `csrc/jv_assign.cu`'s block: its threads, the shared memory it may take,
# and the most GT slots it keeps tight sets for
_THREADS, _MAX_SMEM, _TIGHT_MAX_G = 512, 232448, 1024


def _tight_sets_fit(Q: int, G: int) -> bool:
    """Whether the kernel keeps tight sets for a [Q, G] problem (`plan()` in
    `csrc/jv_assign.cu`): G <= Q, G <= 1,024 and the sets beside the walk's
    state in a block's shared memory. Only then are padded rows decided at
    once, by the kernel and the plain version alike."""
    if G > Q or G > _TIGHT_MAX_G:
        return False
    W = (G + 31) // 32
    base = 16 * (_THREADS // 32) + 16 + 16 * Q + 8 * G
    base = (base + G + 15) // 16 * 16
    return base + 4 * G * W + 4 * G + 4 * W <= _MAX_SMEM


def _decide_padded(C: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   col2row: torch.Tensor) -> Optional[Tuple[int, int]]:
    """A padded (constant-0) row's Dijkstra decided without walking it:
    (f0, steps) where it would take the lowest free column f0 in `steps`
    steps, or None where the walk is needed.

    Where v <= 0 on every column and no row the walk reaches has a
    negative reduced cost `(C[i] - u[i]) - v` (in f32, the walk's rounding)
    off its own column, every delta of the walk is exactly 0: no dual
    moves, the walk pops in turn the columns below f0 that zero reduced
    costs reach from the columns with v = 0, then f0, and the augment only
    sets col2row[f0]. So the steps are that closure's size plus one."""
    R = C.shape[0]
    f0 = int(torch.nonzero(col2row < 0)[0, 0])
    if not bool((v <= 0).all()) or float(v[f0]) != 0.0:
        return None
    rc = (C - u[:, None]) - v[None, :]
    own = col2row[None, :] == torch.arange(R, device=C.device)[:, None]
    ok = ((rc >= 0) | own).all(1)
    tight = rc[:, :f0] == 0
    closure = v[:f0] == 0
    reached = torch.zeros(R, dtype=torch.bool, device=C.device)
    while True:
        rows = torch.zeros_like(reached)
        rows[col2row[:f0][closure]] = True
        new = rows & ~reached
        if not bool(new.any()):
            return f0, int(closure.sum()) + 1
        if not bool(ok[new].all()):
            return None
        reached |= new
        closure = closure | tight[new].any(0)


def _jv_dense(C: torch.Tensor, padded: Optional[torch.Tensor] = None,
              decide: bool = True) -> Tuple[torch.Tensor, int, List[int]]:
    """Jonker-Volgenant on a dense f32 cost C [R, K], R <= K, as the JAX
    package's `_jv_single` runs it: one Dijkstra a row over the K columns
    with the duals u, v, then the augment walk; a row of `padded` [R] bool
    (a constant-0 row) is decided at once, with `decide`, where
    `_decide_padded` can, with the walk's result and step count. Returns (col2row [K] int64, the row
    per column or -1; the Dijkstra steps; [walked steps, padded rows
    decided, padded rows walked], as `jv_counts` keeps them). Every walked
    step reads its argmin and the next row on the host."""
    R, K = C.shape
    dev = C.device
    u = torch.zeros(R, dtype=torch.float32, device=dev)
    v = torch.zeros(K, dtype=torch.float32, device=dev)
    col2row = torch.full((K,), -1, dtype=torch.int64, device=dev)
    steps = 0
    detail = [0, 0, 0]
    for r in range(R):
        if padded is not None and bool(padded[r]):
            decided = _decide_padded(C, u, v, col2row) if decide else None
            if decided is not None:
                col2row[decided[0]] = r
                steps += decided[1]
                detail[1] += 1
                continue
            detail[2] += 1
        minv = torch.full((K,), _INF, dtype=torch.float32, device=dev)
        way = torch.full((K,), -1, dtype=torch.int64, device=dev)
        used = torch.zeros(K, dtype=torch.bool, device=dev)
        row_mask = torch.zeros(R, dtype=torch.float32, device=dev)
        row_mask[r] = 1.0
        j0, i0, done = -1, r, False
        # the JAX solver's cap of K steps; with R <= K a free column is
        # always reached before it
        for _ in range(K):
            cur = C[i0] - u[i0] - v
            upd = ~used & (cur < minv)
            minv = torch.where(upd, cur, minv)
            way = torch.where(upd, j0, way)
            cand = torch.where(used, _INF, minv)
            j1 = int(torch.argmin(cand))         # the lowest index of ties
            delta = cand[j1]
            u = u + delta * row_mask
            v = v - delta * used.float()
            minv = torch.where(used, minv, minv - delta)
            used[j1] = True
            i_next = int(col2row[j1])
            done = i_next < 0
            if not done:
                row_mask[i_next] = 1.0
                i0 = i_next
            j0 = j1
            steps += 1
            detail[0] += 1
            if done:
                break
        if done:
            j = j0
            while j >= 0:
                jp = int(way[j])
                col2row[j] = r if jp < 0 else col2row[jp]
                j = jp
    return col2row, steps, detail


def hungarian_jv_torch(cost: torch.Tensor, gt_mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `csrc/jv_assign.cu`: cost [B,Q,G], gt_mask
    [B,G] bool -> (assign [B,G] int32, query row per GT or -1; the Dijkstra
    steps [B] int32), on cost's device; it adds to `jv_counts` as the
    kernel does.

    G <= Q: the JAX solver's problem (every GT column a row, a padded one
    a constant-0 row), so assign and the steps equal `hungarian_jv(...,
    with_stats=True)` of the JAX package; where the kernel keeps tight sets
    (`_tight_sets_fit`) a padded row is decided without its walk if
    `_decide_padded` shows the walk's outcome. G > Q: the
    padded columns are dropped, and where the n valid ones outnumber the
    Q queries the transposed problem (queries as rows) is solved."""
    _check(cost, gt_mask)
    B, Q, G = cost.shape
    dev = cost.device
    cost = cost.detach().float()
    assign = torch.full((B, G), -1, dtype=torch.int64, device=dev)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    counts = [0, 0, 0]
    decide = _tight_sets_fit(Q, G)
    for b in range(B):
        if G <= Q:
            C = torch.where(gt_mask[b][:, None], cost[b].T,
                            torch.zeros((), device=dev))
            col2row, steps_b, detail_b = _jv_dense(C, ~gt_mask[b], decide)
            cols = torch.nonzero(col2row >= 0)[:, 0]
            assign[b, col2row[cols]] = cols
            assign[b] = torch.where(gt_mask[b], assign[b], -1)
        else:
            idx = torch.nonzero(gt_mask[b])[:, 0]
            if idx.numel() <= Q:
                col2row, steps_b, detail_b = _jv_dense(
                    cost[b][:, idx].T.contiguous())
                cols = torch.nonzero(col2row >= 0)[:, 0]
                assign[b, idx[col2row[cols]]] = cols
            else:
                col2row, steps_b, detail_b = _jv_dense(
                    cost[b][:, idx].contiguous())
                assign[b, idx] = col2row
        steps[b] = steps_b
        counts = [c + d for c, d in zip(counts, detail_b)]
    jv_counts(dev).add_(torch.tensor(counts, dtype=torch.int64, device=dev))
    return assign.to(torch.int32), steps


def _check(cost: torch.Tensor, gt_mask: torch.Tensor) -> None:
    if gt_mask.dtype != torch.bool:
        raise TypeError(f"gt_mask must be bool, got {gt_mask.dtype}")
    if cost.dim() != 3 or gt_mask.shape != (cost.shape[0], cost.shape[2]) \
            or min(cost.shape) < 1:
        raise ValueError(f"cost [B,Q,G] and gt_mask [B,G], non-empty, got "
                         f"{tuple(cost.shape)} and {tuple(gt_mask.shape)}")
    if cost.device != gt_mask.device:
        raise ValueError("cost and gt_mask must be on one device")


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# device -> the solver's running counts there (`jv_counts`)
_COUNTS: dict = {}
# (Q, G) -> the shared memory one problem's block takes (-1: too large),
# asked once for each shape
_SMEM: dict = {}


def _smem_bytes(Q: int, G: int) -> int:
    smem = _SMEM.get((Q, G))
    if smem is None:
        fn = cuda_build.entry("jv_assign", "jv_assign_smem_bytes",
                              [ctypes.c_int] * 2, ctypes.c_longlong)
        smem = _SMEM[Q, G] = fn(Q, G)
    return smem


def jv_counts(device) -> torch.Tensor:
    """The solver's running counts on `device`, an int64 [3] tensor there:
    the Dijkstra steps walked, the padded GT rows decided at once and those
    walked. Every solve on the device adds to them, the kernel's without
    reading anything back; `jv_counts(device).zero_()` starts them anew."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    counts = _COUNTS.get(device)
    if counts is None:
        counts = _COUNTS[device] = torch.zeros(3, dtype=torch.int64,
                                               device=device)
    return counts


def hungarian_jv(cost: torch.Tensor, gt_mask: torch.Tensor,
                 with_stats: bool = False):
    """Exact assignment [B,G] int32 of cost [B,Q,G] (f32 inside) under
    gt_mask [B,G] bool; with `with_stats`, also the Dijkstra steps [B]
    int32. On a CPU tensor it is the plain version; on a CUDA tensor it
    launches the kernel (`csrc/jv_assign.cu`: one block a problem, on the
    current stream, nothing read back) or raises; it never falls back.
    Both add to `jv_counts`; `hungarian_jv.launches` counts calls that
    launched."""
    if cost.device.type == "cpu":
        out = hungarian_jv_torch(cost, gt_mask)
        return out if with_stats else out[0]
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device}")
    _check(cost, gt_mask)
    B, Q, G = cost.shape
    if _smem_bytes(Q, G) < 0:
        raise ValueError(f"jv_assign: Q={Q}, G={G} needs more shared memory "
                         f"than a block has")
    cost = cost.detach().float().contiguous()
    gt_mask = gt_mask.contiguous()
    assign = torch.empty((B, G), dtype=torch.int32, device=cost.device)
    steps = torch.empty(B, dtype=torch.int32, device=cost.device) \
        if with_stats else None
    fn = cuda_build.entry("jv_assign", "jv_assign", _ARGS)
    err = cuda_build.call(fn, cost, cost.data_ptr(), gt_mask.data_ptr(),
                          assign.data_ptr(),
                          None if steps is None else steps.data_ptr(),
                          jv_counts(cost.device).data_ptr(), B, Q, G)
    if err != 0:
        raise RuntimeError(f"jv_assign launch failed: CUDA error {err}")
    hungarian_jv.launches += 1
    return (assign, steps) if with_stats else assign


hungarian_jv.launches = 0


class AssignmentTape:
    """Assignments of one pass, in call order, for replay in a recompute."""

    def __init__(self):
        self.records: List[torch.Tensor] = []
        self._pos: Optional[int] = None     # None = recording

    @contextlib.contextmanager
    def replaying(self) -> Iterator[None]:
        self._pos = 0
        try:
            yield
        finally:
            self._pos = None

    def __call__(self, cost: torch.Tensor, gt_mask: torch.Tensor
                 ) -> torch.Tensor:
        if self._pos is None:
            out = hungarian_jv(cost, gt_mask)
            self.records.append(out)
            return out
        if self._pos >= len(self.records):
            raise RuntimeError("the recompute asked for more assignments "
                               "than the first pass made")
        out = self.records[self._pos]
        self._pos += 1
        return out


_tape: Optional[AssignmentTape] = None


@contextlib.contextmanager
def using_tape(tape: AssignmentTape) -> Iterator[AssignmentTape]:
    """Route every `hungarian` call in the block through `tape`."""
    global _tape
    prev, _tape = _tape, tape
    try:
        yield tape
    finally:
        _tape = prev


def hungarian(cost: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    """Exact assignment: cost [B,Q,G], gt_mask [B,G] -> [B,G] int32 query
    row per GT (-1 for padding), by `hungarian_jv` on cost's device. Inside
    `using_tape` the call is recorded or replayed."""
    if _tape is not None:
        return _tape(cost, gt_mask)
    return hungarian_jv(cost, gt_mask)


def _masked_cost(pred_boxes: torch.Tensor, pred_logits: torch.Tensor,
                 gt_boxes: torch.Tensor, gt_cls: torch.Tensor,
                 gt_mask: torch.Tensor, query_mask: Optional[torch.Tensor],
                 big: float, gains: dict) -> torch.Tensor:
    """`match_cost` with the queries outside `query_mask` [B,Q] at `big`."""
    cost = match_cost(pred_boxes, pred_logits, gt_boxes, gt_cls, gt_mask,
                      big=big, **gains)
    if query_mask is not None:
        cost = torch.where(query_mask[:, :, None], cost,
                           torch.full_like(cost, big))
    return cost


def match(pred_boxes: torch.Tensor, pred_logits: torch.Tensor,
          gt_boxes: torch.Tensor, gt_cls: torch.Tensor,
          gt_mask: torch.Tensor, query_mask: Optional[torch.Tensor] = None,
          big: float = 1e6, **gains: float) -> torch.Tensor:
    """The Hungarian assignment [B,G] of predictions [B,Q,...] to padded GT
    on `match_cost` (its gains overridable), with no gradient; queries
    outside `query_mask` [B,Q] cost `big`."""
    with torch.no_grad():
        cost = _masked_cost(pred_boxes, pred_logits, gt_boxes, gt_cls,
                            gt_mask, query_mask, big, gains)
    return hungarian(cost, gt_mask)


def match_layers(pred_boxes: torch.Tensor, pred_logits: torch.Tensor,
                 gt_boxes: torch.Tensor, gt_cls: torch.Tensor,
                 gt_mask: torch.Tensor,
                 query_mask: Optional[torch.Tensor] = None,
                 big: float = 1e6, **gains: float) -> torch.Tensor:
    """`match` of each of L layers' predictions [L,B,Q,...] against the
    same GT, solved as one [L*B, Q, G] problem (one `hungarian` call, so
    one launch and one tape entry): [L,B,G] int32. Each layer's cost is
    built as `match` builds it, so every layer's assignment is the one
    its own `match` call gives, bit for bit."""
    L, B = pred_boxes.shape[:2]
    with torch.no_grad():
        cost = torch.cat([_masked_cost(pred_boxes[i], pred_logits[i],
                                       gt_boxes, gt_cls, gt_mask, query_mask,
                                       big, gains) for i in range(L)])
    assign = hungarian(cost, gt_mask.repeat(L, 1))
    return assign.view(L, B, -1)
