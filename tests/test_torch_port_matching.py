"""The port's Jonker-Volgenant matcher (`mo_yolo_tpu_torch.ops.matching`):
its plain version against the JAX package's `hungarian_jv` (G <= Q, ties
included, and the Dijkstra step counts) and against scipy (G > Q), the
assignment tape, the kernel's C entry point, and on a card the kernel
(`csrc/jv_assign.cu`) against the plain version.

JAX is imported inside the tests that compare with it, so that the card
test also runs on a machine with a card and without JAX:

    python -m pytest tests/test_torch_port_matching.py -q -k card
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

BIG = 1e6      # `match_cost`'s cost of a padded column or a masked query


def _detr_cost(rng, B, Q, G, mask):
    """`match_cost` of random predictions against random GT boxes, as the
    training step's layers see it."""
    from mo_yolo_tpu_torch.ops.matching import match_cost

    def boxes(n):
        return np.concatenate([rng.uniform(0.2, 0.8, (B, n, 2)),
                               rng.uniform(0.05, 0.3, (B, n, 2))], -1)
    t = {k: torch.from_numpy(a.astype(np.float32)) for k, a in
         (("pb", boxes(Q)), ("pl", rng.normal(0, 2, (B, Q, 5))),
          ("gb", boxes(G)))}
    return match_cost(t["pb"], t["pl"], t["gb"],
                      torch.from_numpy(rng.integers(0, 5, (B, G))),
                      torch.from_numpy(mask), big=BIG).numpy()


def _problem(case, seed=0):
    """(cost [B,Q,G] f32, gt_mask [B,G] bool) as the training step makes
    them: padded GT columns at BIG; "random" uniform costs; "ties" integer
    costs in {0, 1, 2}; "big_rows" the aux layers' problem, the first half
    of the queries (the track slots) at BIG; "all_padding" no valid GT;
    "track" / "aux" the training shapes (300 and 600 queries, 64 GT
    slots); "detr_300" / "detr_600" the same on `match_cost`'s costs, the
    valid GT first as the dataset pads them; "tracked" the tracker's mask
    `gt_mask & ~gt_tracked` (valid rows after padded ones); "rounding"
    all but 4 queries at BIG plus < 0.05, so the duals round at 1e6;
    "sweep_*" a seed sweep over valid counts and layouts."""
    rng = np.random.default_rng(seed)
    B, Q, G = {"random": (3, 12, 5), "ties": (3, 20, 9),
               "big_rows": (2, 16, 6), "all_padding": (2, 6, 4),
               "batch4": (4, 9, 9), "track": (1, 300, 64),
               "aux": (1, 600, 64), "detr_300": (2, 300, 64),
               "detr_600": (2, 600, 64), "tracked": (2, 300, 64),
               "rounding": (8, 24, 16), "sweep_first": (8, 40, 16),
               "sweep_random": (8, 40, 16),
               "sweep_interleaved": (8, 40, 16)}[case]
    if case in ("detr_300", "detr_600", "tracked"):
        mask = np.zeros((B, G), bool)
        mask[0, :20] = True
        mask[1, :35] = True
        if case == "tracked":           # every third object has a track
            mask[:, ::3] = False
        cost = _detr_cost(rng, B, Q, G, mask)
        if case == "detr_600":
            cost[:, :Q // 2] = BIG
        return cost.astype(np.float32), mask
    if case.startswith("sweep"):
        # eight problems of 1-15 valid GT, the first half of the queries
        # at BIG: the valid GT first, anywhere, or every other slot
        cost = rng.uniform(0, 10, (B, Q, G)).astype(np.float32)
        cost[:, :Q // 2] = BIG
        n = rng.integers(1, G, B)
        mask = np.arange(G)[None] < n[:, None]
        if case == "sweep_random":
            mask = np.stack([rng.permutation(m) for m in mask])
        elif case == "sweep_interleaved":
            mask = (np.arange(G)[None] % 2 == 1) & \
                (np.arange(G)[None] < 2 * n[:, None])
        return np.where(mask[:, None, :], cost, BIG).astype(np.float32), mask
    if case == "rounding":
        cost = (BIG + rng.uniform(0, 0.05, (B, Q, G))).astype(np.float32)
        cost[:, :4] = rng.uniform(0, 0.1, (B, 4, G))
        mask = rng.random((B, G)) < 0.5
        return np.where(mask[:, None, :], cost, BIG).astype(np.float32), mask
    if case == "ties":
        cost = rng.integers(0, 3, (B, Q, G)).astype(np.float32)
    else:
        cost = rng.uniform(0, 10, (B, Q, G)).astype(np.float32)
    mask = rng.random((B, G)) < 0.7
    mask[0, :2] = True
    if case == "all_padding":
        mask[:] = False
    if case in ("track", "aux"):
        mask[:] = False
        mask[:, :20] = True          # 20 objects in 64 GT slots
    if case in ("big_rows", "aux"):
        cost[:, :Q // 2] = BIG
    cost = np.where(mask[:, None, :], cost, BIG).astype(np.float32)
    return cost, mask


def _jax_jv(cost, mask):
    import jax.numpy as jnp

    from mo_yolo_tpu.ops.matching import hungarian_jv
    assign, iters = hungarian_jv(jnp.asarray(cost), jnp.asarray(mask),
                                 with_stats=True)
    return np.asarray(assign), np.asarray(iters)


JAX_CASES = ["random", "ties", "big_rows", "all_padding", "batch4", "track",
             "aux", "detr_300", "detr_600", "tracked", "rounding",
             "sweep_first", "sweep_random", "sweep_interleaved"]


@pytest.mark.parametrize("case", JAX_CASES)
def test_plain_jv_equals_jax_jv(case):
    """Where G <= Q the plain version is the JAX solver step for step: the
    same assignment, ties included, and the same Dijkstra steps as its
    `with_stats`."""
    from mo_yolo_tpu_torch.ops.matching import hungarian_jv
    cost, mask = _problem(case)
    want, want_iters = _jax_jv(cost, mask)
    got, iters = hungarian_jv(torch.from_numpy(cost), torch.from_numpy(mask),
                              with_stats=True)
    assert got.dtype == torch.int32 and iters.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(iters.numpy(), want_iters)
    assert (got.numpy()[~mask] == -1).all()


@pytest.mark.parametrize("case", ["detr_600", "rounding"])
def test_plain_jv_decides_padded_rows_and_walks_where_the_rule_fails(case):
    """The plain version's counts (`jv_counts`): every padded row is
    decided at once or walked; on the training shape all are decided and
    the steps walked are a few per valid row; at 1e6 some reduced costs
    round below 0 and those padded rows are walked, with the JAX solver's
    result all the same (`test_plain_jv_equals_jax_jv`)."""
    from mo_yolo_tpu_torch.ops.matching import hungarian_jv, jv_counts
    cost, mask = _problem(case)
    counts = jv_counts("cpu").zero_()
    _, steps = hungarian_jv(torch.from_numpy(cost), torch.from_numpy(mask),
                            with_stats=True)
    walked, decided, walked_padded = counts.tolist()
    assert decided + walked_padded == (~mask).sum()
    assert walked <= steps.sum() and decided > 0
    if case == "detr_600":
        assert walked_padded == 0
        assert walked < 0.1 * steps.sum()
    else:
        assert walked_padded > 0


def test_plain_jv_decides_padded_rows_only_where_the_kernel_keeps_tight_sets():
    """The plain version decides padded rows only where the kernel keeps
    tight sets (`_tight_sets_fit`, the rule of `plan()` in the kernel's
    source, whose constants it repeats: not past 1,024 GT slots or the
    shared memory). Walking every padded row gives the same assignment and
    steps as deciding them."""
    from mo_yolo_tpu_torch.ops import matching as mt
    from mo_yolo_tpu_torch.utils.cuda_build import CSRC
    src = (CSRC / "jv_assign.cu").read_text()
    for name, value in (("THREADS", mt._THREADS),
                        ("MAX_DYNAMIC_SMEM", mt._MAX_SMEM),
                        ("TIGHT_MAX_G", mt._TIGHT_MAX_G)):
        assert f"#define {name} {value}\n" in src, name
    assert mt._tight_sets_fit(300, 64) and mt._tight_sets_fit(4000, 1024)
    assert not mt._tight_sets_fit(1100, 1040)
    assert not mt._tight_sets_fit(40, 70)
    assert not mt._tight_sets_fit(6000, 1024)     # past the shared memory
    cost, mask = _problem("detr_300")
    C = torch.from_numpy(np.where(mask[0][:, None], cost[0].T, 0))
    padded = torch.from_numpy(~mask[0])
    col2row, steps, counts = mt._jv_dense(C, padded)
    walked, walked_steps, walked_counts = mt._jv_dense(C, padded, False)
    assert torch.equal(walked, col2row) and walked_steps == steps
    assert counts[1:] == [44, 0] and walked_counts == [steps, 0, 44]


def _total(cost, assign):
    return sum(float(cost[a, g]) for g, a in enumerate(assign) if a >= 0)


@pytest.mark.parametrize("costs", ["continuous", "ties"])
def test_plain_jv_keeps_scipys_answer_where_gt_outnumber_queries(costs):
    """4 queries against 7, 6 and 5 valid GT columns of 7: the JAX solver
    stops a Dijkstra at its cap and leaves rows unassigned; the port drops
    the padding, solves the transposed problem, and equals scipy: the same
    assignment on continuous costs, min(Q, valid) pairs at scipy's total
    on ties."""
    from mo_yolo_tpu.ops.matching import _scipy_assign
    from mo_yolo_tpu_torch.ops.matching import hungarian_jv_torch
    rng = np.random.default_rng(47)
    Q, G, n_valid = 4, 7, (7, 6, 5)
    B = len(n_valid)
    cost = rng.uniform(0, 10, (B, Q, G)) if costs == "continuous" else \
        rng.integers(0, 3, (B, Q, G))
    mask = np.zeros((B, G), bool)
    for b, n in enumerate(n_valid):
        mask[b, rng.permutation(G)[:n]] = True
    cost = np.where(mask[:, None, :], cost, BIG).astype(np.float32)
    got, _ = hungarian_jv_torch(torch.from_numpy(cost), torch.from_numpy(mask))
    got, want = got.numpy(), _scipy_assign(cost, mask)
    if costs == "continuous":
        np.testing.assert_array_equal(got, want)
    for b in range(B):
        pairs = got[b][got[b] >= 0]
        assert len(pairs) == len(set(pairs)) == min(Q, mask[b].sum())
        assert (got[b][~mask[b]] == -1).all()
        assert _total(cost[b], got[b]) == _total(cost[b], want[b])
    jax_assign, _ = _jax_jv(cost, mask)
    assert any((jax_assign[b] >= 0).sum() < min(Q, mask[b].sum())
               for b in range(B)), "the JAX solver's fault no longer shows"


def test_plain_jv_where_valid_gt_fit_the_queries_of_a_wide_problem():
    """G > Q with at most Q valid columns: the padded rows are dropped
    before the solve, so every valid GT gets a query, at scipy's answer."""
    from mo_yolo_tpu.ops.matching import _scipy_assign
    from mo_yolo_tpu_torch.ops.matching import hungarian_jv_torch
    rng = np.random.default_rng(5)
    cost = rng.uniform(0, 10, (2, 5, 12)).astype(np.float32)
    mask = np.zeros((2, 12), bool)
    mask[0, [1, 4, 9]] = True
    mask[1, [0, 2, 3, 7, 11]] = True
    cost = np.where(mask[:, None, :], cost, BIG).astype(np.float32)
    got, _ = hungarian_jv_torch(torch.from_numpy(cost), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), _scipy_assign(cost, mask))


def test_hungarian_solves_on_the_tensors_device_and_the_tape_keeps_it(
        monkeypatch):
    """`hungarian` runs the JV solver, never scipy; the tape records the
    solver's tensors as they are (on cost's device) and replays those very
    tensors; an unsupported device raises instead of falling back."""
    import scipy.optimize

    from mo_yolo_tpu_torch.ops import matching as mt

    def no_scipy(*a, **k):
        raise AssertionError("scipy called on the matching path")
    monkeypatch.setattr(scipy.optimize, "linear_sum_assignment", no_scipy)
    cost, mask = (torch.from_numpy(a) for a in _problem("random"))
    tape = mt.AssignmentTape()
    with mt.using_tape(tape):
        first = mt.hungarian(cost, mask)
    assert len(tape.records) == 1 and tape.records[0] is first
    assert first.device == cost.device and first.dtype == torch.int32
    assert torch.equal(first, mt.hungarian_jv(cost, mask))
    with mt.using_tape(tape), tape.replaying():
        assert mt.hungarian(-cost, mask) is first
    with pytest.raises(ValueError, match="device"):
        mt.hungarian_jv(cost.to("meta"), mask.to("meta"))
    with pytest.raises(TypeError):
        mt.hungarian_jv(cost, mask.int())


def _layer_predictions(L, B, Q, G, seed=21):
    rng = np.random.default_rng(seed)

    def boxes(*shape):
        return np.concatenate([rng.uniform(0.2, 0.8, shape + (2,)),
                               rng.uniform(0.05, 0.3, shape + (2,))], -1)
    t = {k: torch.from_numpy(a.astype(np.float32)) for k, a in
         (("pb", boxes(L, B, Q)), ("pl", rng.normal(0, 2, (L, B, Q, 5))),
          ("gb", boxes(B, G)))}
    mask = np.zeros((B, G), bool)
    mask[0, :5] = True
    mask[1, :9] = True
    qmask = np.arange(Q)[None] >= Q // 2
    return (t["pb"], t["pl"], t["gb"],
            torch.from_numpy(rng.integers(0, 5, (B, G))),
            torch.from_numpy(mask), torch.from_numpy(np.repeat(qmask, B, 0)))


def test_match_layers_equals_one_match_a_layer_and_the_tape_replays_it():
    """The aux layers' matchings solved as one [L*B, Q, G] problem equal L
    separate `match` calls bit for bit (the aux layers' detect queries
    only, as the training step asks); the tape keeps the batch as one entry
    and replays it for other predictions."""
    from mo_yolo_tpu_torch.ops import matching as mt
    pb, pl, gb, gc, mask, qmask = _layer_predictions(5, 2, 24, 12)
    want = torch.stack([mt.match(pb[i], pl[i], gb, gc, mask, qmask)
                        for i in range(5)])
    tape = mt.AssignmentTape()
    with mt.using_tape(tape):
        got = mt.match_layers(pb, pl, gb, gc, mask, qmask)
    assert got.shape == (5, 2, 12) and got.dtype == torch.int32
    assert torch.equal(got, want)
    assert len(tape.records) == 1 and tape.records[0].shape == (10, 12)
    with mt.using_tape(tape), tape.replaying():
        again = mt.match_layers(pb.flip(0), pl.flip(0), gb, gc, mask, qmask)
    assert torch.equal(again, got)


def test_matched_layer_losses_make_one_matcher_call_for_the_aux_layers(
        monkeypatch):
    """`matched_layer_losses` asks the matcher once for its L-1 aux layers
    (a [(L-1)*B, Q, G] problem) and gives the losses of one `match` call a
    layer."""
    from mo_yolo_tpu_torch.ops import matching as mt
    from mo_yolo_tpu_torch.train import losses as tl
    pb, pl, gb, gc, mask, qmask = _layer_predictions(6, 2, 24, 12, seed=22)
    calls = []
    hungarian = mt.hungarian

    def counted(cost, gt_mask):
        calls.append(tuple(cost.shape))
        return hungarian(cost, gt_mask)
    monkeypatch.setattr(mt, "hungarian", counted)
    cfg = tl.LossConfig(nc=5)
    last = mt.match(pb[-1], pl[-1], gb, gc, mask)
    calls.clear()
    got = tl.matched_layer_losses(cfg, pb, pl, gb, gc, mask, last,
                                  aux_query_mask=qmask)
    assert calls == [(10, 24, 12)]
    aux = {k: 0.0 for k in ("loss_class", "loss_bbox", "loss_giou")}
    for i in range(5):
        li = tl.layer_loss(cfg, pb[i], pl[i], gb, gc, mask,
                           mt.match(pb[i], pl[i], gb, gc, mask, qmask),
                           query_mask=qmask)
        for k in aux:
            aux[k] = aux[k] + li[k]
    for k, val in aux.items():
        assert torch.equal(got[f"{k}_aux"], val), k


def test_jv_kernel_source_has_its_c_entry_point():
    """The wrapper passes as many arguments as the C entry point takes
    (cost, mask, assign, iters, counts, B, Q, G, the stream; Q and G for
    the shared-memory size), and the source says what it replaces and what
    bounds it."""
    from mo_yolo_tpu_torch.ops.matching import _ARGS
    from mo_yolo_tpu_torch.utils.cuda_build import CSRC
    src = (CSRC / "jv_assign.cu").read_text()
    for entry, n_args in (('extern "C" int jv_assign(', len(_ARGS)),
                          ('extern "C" long long jv_assign_smem_bytes(', 2)):
        sig = src[src.index(entry):]
        sig = sig[:sig.index(")")]
        assert sig.count(",") + 1 == n_args, entry
    assert len(_ARGS) == 9
    assert "Replaces no TPU kernel" in src and "What bounds it" in src
    assert "_jv_single" in src and "while_loop" in src


@pytest.mark.gpu
@pytest.mark.parametrize("case", JAX_CASES + ["wide", "wide_ties",
                                              "max_gt_256", "q1600", "q2100",
                                              "g1040", "offset", "one",
                                              "one_wide"])
def test_jv_kernel_equals_plain_on_card(case):
    """The kernel against the plain version on the card, computed there:
    the same assignment and Dijkstra steps exactly, and the same counts
    (`jv_counts`: steps walked, padded rows decided and walked), with every
    host sync an error around the launch. "q1600" and "q2100" take a
    thread's columns in four registers and in shared memory; "g1040" has
    more GT slots than the kernel keeps tight sets for (1,024), so both
    walk every padded row; "offset" lies one float past a 16-byte boundary
    (the cost is staged with scalar reads there); "one" and "one_wide" are
    a single query against one and three GT slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernel has no CPU mode")
    from mo_yolo_tpu_torch.ops.matching import (hungarian_jv,
                                                hungarian_jv_torch,
                                                jv_counts)
    if case.startswith("wide"):      # G > Q: transposed and row-dropped
        rng = np.random.default_rng(3)
        cost = rng.uniform(0, 10, (3, 40, 70)) if case == "wide" else \
            rng.integers(0, 3, (3, 40, 70))
        mask = np.zeros((3, 70), bool)
        mask[0, :] = True                          # 70 valid > 40 queries
        mask[1, rng.permutation(70)[:30]] = True   # 30 valid <= 40
        mask[2, rng.permutation(70)[:41]] = True
        cost = np.where(mask[:, None, :], cost, BIG).astype(np.float32)
    elif case in ("q1600", "q2100", "g1040"):
        Q, G = {"q1600": (1600, 64), "q2100": (2100, 64),
                "g1040": (1100, 1040)}[case]
        rng = np.random.default_rng(6)
        mask = np.zeros((1, G), bool)
        mask[:, :40] = True
        cost = _detr_cost(rng, 1, Q, G, mask).astype(np.float32)
    elif case in ("one", "one_wide"):
        rng = np.random.default_rng(7)
        G = 1 if case == "one" else 3
        cost = rng.uniform(0, 10, (2, 1, G)).astype(np.float32)
        mask = np.ones((2, G), bool)
        mask[1, 0] = False
    elif case == "max_gt_256":
        rng = np.random.default_rng(4)
        cost = rng.uniform(0, 10, (1, 600, 256)).astype(np.float32)
        mask = np.zeros((1, 256), bool)
        mask[:, :150] = True
        cost = np.where(mask[:, None, :], cost, BIG).astype(np.float32)
    else:
        cost, mask = _problem("aux" if case == "offset" else case)
    cost_d = torch.from_numpy(cost).cuda()
    if case == "offset":
        buf = torch.empty(cost_d.numel() + 1, device="cuda")
        cost_d = buf[1:].view(cost_d.shape).copy_(cost_d)
        assert cost_d.is_contiguous() and cost_d.data_ptr() % 16 == 4
    mask_d = torch.from_numpy(mask).cuda()
    torch.cuda.synchronize()
    before = hungarian_jv.launches
    counts = jv_counts(cost_d.device).zero_()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, iters = hungarian_jv(cost_d, mask_d, with_stats=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert hungarian_jv.launches == before + 1
    got_counts = counts.tolist()
    counts.zero_()
    want, want_iters = hungarian_jv_torch(cost_d, mask_d)
    assert got.is_cuda and torch.equal(got, want), case
    assert torch.equal(iters, want_iters), case
    assert got_counts == counts.tolist(), case
    if case == "g1040":
        assert got_counts[1:] == [0, int((~mask_d).sum())]
