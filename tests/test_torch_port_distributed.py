"""The port's multi-process data parallelism (`mo_yolo_tpu_torch.parallel`,
`train/trainer.py`) on the CPU: the bootstrap in one process; a 2-process
gloo run whose sharded training step equals the one-process step on the
same batch-2 clip; and two gloo ranks training through `MOTRTrack.train`
against the one-process trainer at batch 2: the same steps, parameters
equal bit for bit on both ranks, the run's files written by rank 0 alone,
the autobatch's smallest answer times the ranks, and a batch the ranks do
not divide refused (tests/torch_port_dist_worker.py). Imports no JAX."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_port_dist_worker as worker
from tests.torch_port_common import assert_grad_norm

torch.set_num_threads(1)

# The two ranks' step against one process's on the batch of both: the same
# f32 arithmetic but for the order of sums. BatchNorm's batch statistics
# come from the ranks' summed sums and centred squares where the one
# process takes them in one pass over the batch, and each gradient is the
# sum of two ranks' where one backward accumulates both. The loss and its
# terms to 1e-5 relative; BatchNorm statistics and gradients to 1e-3 of
# each tensor's largest magnitude: measured up to 1.3e-4 (the stem's
# BatchNorm scale and shift, whose gradients sum 2,048 cancelling terms a
# channel), 6e-6 for the median tensor. A per-rank BatchNorm or a per-rank
# object count moves them by percents. The sampling offsets' gradients to
# 0.25 of their max, as tests/test_torch_port_train_step.py holds them
# against JAX and for its reason (the bilinear sampler's derivative in the
# location jumps at pixel edges, and these small tensors sum many terms
# that nearly cancel): measured 3.2e-2 here in the last layer. The
# gradient norm by `torch_port_common.assert_grad_norm`: each side's equals
# the norm of its own gradients (measured: 1.2e-7 relative), and the two
# differ by no more than their gradients do (measured: |Δ| = 0.0048 of
# 405.957, 0.19 of its bound ‖g_ranks − g_one‖₂ + 1e-6 · 405.957 = 0.0254);
# the 1e-5 rtol that held the scalar before failed with some hosts' f32
# sums (|Δ| = 1.19e-5 relative).
METRIC_RTOL = 1e-5
TENSOR_TOL = 1e-3
OFFSETS_GRAD_TOL = 0.25


def test_initialize_is_a_no_op_in_one_process(monkeypatch):
    """Without the torchrun variables `initialize()` joins nothing and the
    world is one process; `_env_spec` reads those variables as the JAX
    package's does (tests/test_train_step.py). Before a rank joins its
    group `process_rank()` reads them (the default loggers are built on
    rank 0 alone); `barrier` and `min_over_ranks` are no-ops without a
    group; under torchrun `resolve_device()` is the rank's own card."""
    from mo_yolo_tpu_torch.parallel import distributed as D
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert D.initialize() is False
    assert not torch.distributed.is_initialized()
    assert D._env_spec() is None
    assert D.global_mesh() == D.World(1, 0)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert D._env_spec() == ("10.0.0.1:29500", 4, 2)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert D._env_spec() is None
    batch = {"x": np.arange(8).reshape(8, 1), "y": torch.arange(12).view(2, 6)}
    part = D.shard_host_batch(D.World(2, 1), batch)
    np.testing.assert_array_equal(part["x"][:, 0], [4, 5, 6, 7])
    assert torch.equal(part["y"], torch.arange(6, 12).view(1, 6))
    with pytest.raises(ValueError):
        D.shard_host_batch(D.World(3, 0), batch)
    with pytest.raises(RuntimeError):
        with D.data_parallel():
            pass
    assert D.active_world() is None
    # before its group exists a rank knows itself from the variables: the
    # default loggers are built on rank 0 alone
    from mo_yolo_tpu_torch.utils.callbacks import default_callbacks
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert D.process_rank() == 2 and not default_callbacks("unused")._cbs
    D.barrier()                             # no group: returns at once
    assert D.min_over_ranks(3) == 3
    # under torchrun a rank's model is built on its own card
    from mo_yolo_tpu_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert resolve_device() == torch.device("cuda", 1)
    monkeypatch.delenv("LOCAL_RANK")
    assert resolve_device() == torch.device("cuda")


def test_sharded_step_without_a_group_is_the_plain_step():
    """One process: `make_sharded_train_step` is `make_train_step` and
    `make_sharded_stream_step` the model's own batched step."""
    from mo_yolo_tpu_torch.parallel.mesh import (make_sharded_stream_step,
                                                 make_sharded_train_step)
    got = worker._step(make_sharded_train_step)
    want = worker.one_process_step()
    for part in ("grads", "stats", "metrics"):
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)

    class Model:
        def stream_step(self, state, x):
            return state, x
    m = Model()
    assert make_sharded_stream_step(m) == m.stream_step


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_step_equals_one_process_batch(tmp_path):
    """Two gloo ranks, each with half of a batch-2 clip, run one sharded
    training step: a real all-reduce first, then the step, whose gradients
    (summed over the ranks), BatchNorm running statistics (taken over both
    ranks' frames) and loss (over both ranks' objects) equal the
    one-process step on the whole batch, and are the same on both ranks."""
    procs = _launch(tmp_path)
    try:
        want = worker.one_process_step()
    finally:
        _join(procs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for r, got in enumerate(ranks):
        assert got["world"] == (2, r) and got["all_reduce"] == 3.0
        _hold_step(got, want)
    for part in ("grads", "stats"):
        for k in want[part]:
            assert torch.equal(ranks[0][part][k], ranks[1][part][k]), k


def _hold_step(got, want, parts=("grads", "stats")):
    """A rank's step against the one-process step: the metrics, the
    gradient norm, and each tensor of `parts` (see the tolerances above)."""
    assert got["metrics"].keys() == want["metrics"].keys()
    for k, v in want["metrics"].items():
        if k != "grad_norm":
            np.testing.assert_allclose(got["metrics"][k].numpy(), v.numpy(),
                                       rtol=METRIC_RTOL, atol=1e-6,
                                       err_msg=k)
    assert_grad_norm(got["metrics"]["grad_norm"],
                     want["metrics"]["grad_norm"], got["grads"],
                     want["grads"])
    for part in parts:
        _hold_tensors(got[part], want[part], part)


def _hold_tensors(got, want, what, extra=0.0):
    """Each tensor within TENSOR_TOL of its own largest magnitude (the
    sampling offsets' gradients within OFFSETS_GRAD_TOL), plus `extra`."""
    assert got.keys() == want.keys(), what
    for k, v in want.items():
        scale = float(v.abs().max()) or 1.0
        err = float((got[k] - v).abs().max())
        tol = OFFSETS_GRAD_TOL if "sampling_offsets" in k else TENSOR_TOL
        assert err <= tol * scale + extra, (what, k, err, scale)


def _launch(out, *args, env=None):
    """The two ranks of the worker, with a free port."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="1", **(env or {}))
    return [subprocess.Popen(
        [sys.executable, worker.__file__, str(out), *args],
        env=dict(env, RANK=str(rank)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for rank in range(2)]


def _join(procs, timeout=240):
    """Each rank's output; every rank is ended whatever happens."""
    try:
        outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    return outs


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The worker's `trainer` mode on two ranks, and beside it, in this
    process, the one-process trainer at batch 2 on the same fixture; both
    with every logger integration off (the JSONL logger runs)."""
    base = tmp_path_factory.mktemp("dist_trainer")
    data = worker.write_fixture(base / "data")
    config = worker.quiet_settings(base / "settings")
    procs = _launch(base, "trainer", data,
                    env={"MO_YOLO_TPU_TORCH_CONFIG_DIR": config})
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MO_YOLO_TPU_TORCH_CONFIG_DIR", config)
            want = worker.train_run(data, base / "one")
    finally:
        _join(procs)
    ranks = [torch.load(base / f"trainer{r}.pt") for r in range(2)]
    return want, ranks, base


def test_two_rank_trainer_equals_one_process_batch(trainer_runs):
    """`MOTRTrack.train` over two gloo ranks (global batch 2, one clip a
    rank a step) against the one-process trainer at batch 2: each of the
    two steps' metrics and gradients under the step's checks, and the
    final parameters, BatchNorm statistics and EMA within TENSOR_TOL of
    each tensor's max plus what AdamW's two updates can add (2 lr each,
    where an element's gradient is f32 noise); on both ranks the same
    state bit for bit, optimizer moments included, and the same returned
    metrics but the validator's frames/s (each rank validated the same
    parameters)."""
    want, ranks, _ = trainer_runs
    assert want["batch"] == 2 and want["steps_per_epoch"] == 2
    lr = 1e-4
    for r, rec in enumerate(ranks):
        got = rec["run"]
        assert rec["world"] == (2, r)
        assert got["batch"] == 2 and got["steps_per_epoch"] == 2
        assert len(got["steps"]) == len(want["steps"]) == 2
        assert rec["gradient_sums"] == 2      # the sharded step, once a step
        for g, w in zip(got["steps"], want["steps"]):
            _hold_step(g, w, parts=("grads",))
        for part in ("param/", "buffer/", "ema/"):
            pick = {k: v for k, v in want["state"].items()
                    if k.startswith(part) and v.is_floating_point()}
            _hold_tensors({k: got["state"][k] for k in pick}, pick, part,
                          extra=2 * 2 * lr)
    a, b = (rec["run"] for rec in ranks)
    assert a["state"].keys() == b["state"].keys()
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k
    for sa, sb in zip(a["steps"], b["steps"]):
        for k, v in sa["grads"].items():
            assert torch.equal(v, sb["grads"][k]), k
    assert a["metrics"].keys() == b["metrics"].keys() and \
        "HOTA" in a["metrics"]
    for k, v in a["metrics"].items():
        assert k == "fps" or v == b["metrics"][k], k


def test_only_rank_zero_writes_and_every_rank_resumes_the_same(
        trainer_runs):
    """Rank 1 opened, made or renamed nothing under the runs' directory;
    rank 0 wrote the run's files (results.csv, last, best, last_full and
    its config, events.jsonl). A resume of that last_full, after the
    run's one epoch, restores on each rank the state the run ended with,
    bit for bit: parameters, buffers, EMA, optimizer moments, count and
    step. (The noise generator needs no saved state: every rank seeds an
    epoch's from (seed, epoch).)"""
    _, ranks, base = trainer_runs
    assert ranks[1]["writes"] == []
    written = {p for _, p in ranks[0]["writes"]}
    for name in ("results.csv", "last", "best", "last_full",
                 "last_full.config.json", "events.jsonl"):
        assert f"run/{name}" in written, (name, sorted(written))
    assert not any(p.startswith("batch3") for p in written)
    assert (base / "runs" / "run" / "results.csv").read_text().count(
        "\n") == 3
    end = ranks[0]["run"]["state"]
    for rec in ranks:
        resumed = rec["resumed"]
        assert resumed["steps"] == [] and \
            np.isnan(resumed["metrics"]["final_loss"])
        assert resumed["state"].keys() == end.keys()
        for k, v in end.items():
            assert torch.equal(resumed["state"][k], v), k


def test_batch_the_ranks_do_not_divide_raises(trainer_runs):
    """A batch of 3 over 2 ranks: both ranks raise a ValueError naming
    both numbers before any collective (the JAX trainer shards over
    gcd(3, devices) devices instead; a rank cannot sit out the group's
    all-reduce)."""
    _, ranks, _ = trainer_runs
    for rec in ranks:
        msg = rec["indivisible"]
        assert msg is not None and "batch 3" in msg and "2 ranks" in msg


def test_autobatch_takes_the_smallest_card_times_the_ranks(trainer_runs):
    """`min_over_ranks` gives each rank the smallest of the ranks' numbers
    (4 and 2: 2), and itself in one process; the trainer's `batch=-1`
    takes the smallest per-card answer times the ranks: probes answering
    1 and 3 give a global batch of 2."""
    from mo_yolo_tpu_torch.parallel import distributed as D
    assert D.min_over_ranks(5) == 5
    _, ranks, _ = trainer_runs
    for rec in ranks:
        assert rec["min_over_ranks"] == 2
        assert rec["run"]["batch"] == \
            min(worker.AUTOBATCH_PER_CARD) * 2
