"""The port's clip training step (`mo_yolo_tpu_torch.train.train_step`)
against the JAX package's `make_train_step`, at f32 on the CPU.

`tiny_track` at hd=32, two decoder layers, 8 track slots, T=2 frames of
64x64, CDN, track dropout and FP injection off. nq is the number of valid
anchors at that size (all 84 of them), so the detect-query selection is a
permutation of the anchors, and losses, gradients and the carried state do
not depend on the order in which near-ties come out of top-k.

The JAX step is compiled once. It runs with an optimizer that holds both
of the JAX package's own chains (`make_optimizer` for AdamW and for SGD),
applies the one a flag in its state selects, and keeps the gradient it was
given, so that the per-tensor gradients of `make_train_step` itself can be
compared.

Each port step starts from the JAX run's state after the step before it
(parameters, BatchNorm statistics, EMA and optimizer moments): a gradient
of norm ~2e3 through an untrained model amplifies f32 differences from one
step to the next, and AdamW moves every element by about lr whatever the
size of its gradient, so two free-running trajectories part by noise alone
within three steps. Step k then compares like with like."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.torch_port_common import (TINY_YAML, assert_grad_norm,
                                     randomize_norms)

torch.set_num_threads(1)

T, B, G, HW, N_SLOTS, HD, NDL, D_FFN = 2, 1, 5, 64, 8, 32, 2, 32
NQ = 84            # every anchor of tiny_track at 64x64 is valid
N_STEPS = 3
OPTIMIZERS = ("adamw", "sgd")
LR = 1e-4
# f32 on both sides with sums in another order: loss terms to 1e-4
# relative, and each parameter, EMA and BatchNorm statistic to 1e-3 of the
# tensor's largest magnitude. AdamW divides each element's gradient by its
# running RMS, so an element whose gradient is within f32 noise of zero can
# step by up to +-lr either way: its parameters get 2 lr on top.
LOSS_RTOL = 1e-4
TENSOR_TOL = 1e-3
# Gradients to 5e-3 of each tensor's largest magnitude. The JAX package's
# BatchNorm takes the batch
# variance as E[x^2] - E[x]^2, which at the 2x2 P5 map of a 64x64 frame
# loses precision to cancellation: against an f64 evaluation of the same
# step, its backbone gradients are off by up to 2.4e-3 of the tensor's
# max, the port's (two-pass variance) by up to 5e-4.
GRAD_TOL = 5e-3
# The gradient norm is held by `torch_port_common.assert_grad_norm`: each
# package's equals the norm of its own gradients to 1e-5 relative
# (measured: <= 3.6e-7), and the two differ by no more than ‖g_port −
# g_jax‖₂ + 1e-6 of JAX's norm (measured: the gap at most 0.66 of that
# bound, at steps 0-1: 1.473 against 2.249). A relative tolerance of 1e-3
# on the scalar was stricter than the per-tensor checks above, and failed
# with some hosts' f32 sums: at step 2 of AdamW |Δ| = 1.695 of 1659.38
# (1.02e-3), against ‖g_port − g_jax‖₂ = 2.912.
# The sampling offsets' gradients to 0.25 of their max, which still tells a
# missing or misplaced gradient (an error of 1) from noise: the bilinear
# sampler's derivative in the location jumps at pixel edges, and these small
# tensors sum many such terms that nearly cancel. The port's own f32 and
# f64 evaluations of step 0 differ by 3.3e-2 of the max on layer 1's, and
# JAX and the port by up to 1.1e-1 at step 2.
OFFSETS_GRAD_TOL = 0.25


def _tcfg(mod, optimizer, remat=False):
    return mod.TrainConfig(clip_len=T, remat=remat, drop_prob=0.0,
                           fp_ratio=0.0, lr=LR, warmup_steps=2,
                           total_steps=10, optimizer=optimizer)


def _clip():
    """Two frames of four moving boxes; id 2 leaves and id 4 enters in
    frame 1, and the last row is padding."""
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (T, B, HW, HW, 3)).astype(np.float32)
    ids = np.array([[0, 1, 2, 3, 0], [0, 1, 3, 4, 0]], np.int32)
    mask = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 0]], bool)
    base = {i: rng.uniform(0.2, 0.8, 2) for i in range(5)}
    boxes = np.zeros((T, B, G, 4), np.float32)
    for t in range(T):
        for g in range(G):
            c = base[ids[t, g]] + 0.03 * t
            boxes[t, 0, g] = [c[0], c[1], 0.15 + 0.02 * g, 0.2]
            imgs[t, 0, int(c[1] * HW) - 4:int(c[1] * HW) + 4,
                 int(c[0] * HW) - 4:int(c[0] * HW) + 4, g % 3] = 1.0
    return {"images": imgs, "gt_cls": (ids % 3)[:, None].astype(np.int32),
            "gt_boxes": boxes, "gt_track_id": ids[:, None],
            "gt_mask": mask[:, None]}


def _selectable_tx(tx_a, tx_b):
    """Both chains run on every update; `use_b` in the state picks whose
    update is applied, and the state keeps the incoming gradient."""
    def init(params):
        return {"a": tx_a.init(params), "b": tx_b.init(params),
                "use_b": jnp.zeros((), bool),
                "grads": jax.tree.map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        ua, sa = tx_a.update(grads, state["a"], params)
        ub, sb = tx_b.update(grads, state["b"], params)
        u = jax.tree.map(lambda x, y: jnp.where(state["use_b"], y, x), ua, ub)
        return u, {"a": sa, "b": sb, "use_b": state["use_b"], "grads": grads}
    return optax.GradientTransformation(init, update)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _moments(chain_state, params):
    """The per-parameter state of one `make_optimizer` chain (Adam's mu and
    nu, or SGD's trace) as full parameter trees: each group's tree holds
    MaskedNodes where the other groups' leaves are."""
    masked = lambda x: isinstance(x, optax.MaskedNode)     # noqa: E731
    out = {}
    for group in chain_state[1].inner_states.values():
        for st in group.inner_state:
            st = getattr(st, "inner_state", st)        # inject_hyperparams
            for field in ("mu", "nu", "trace"):
                if not hasattr(st, field):
                    continue
                tree = jax.tree_util.tree_map(
                    lambda p, m: np.zeros(np.shape(p), np.float32)
                    if masked(m) else np.asarray(m), params,
                    getattr(st, field), is_leaf=masked)
                out[field] = tree if field not in out else \
                    jax.tree_util.tree_map(np.add, out[field], tree)
    return out


def _jax_runs(clip):
    from mo_yolo_tpu.models.graph import parse_model_yaml
    from mo_yolo_tpu.models.tracker import TrackerConfig, init_track_state
    from mo_yolo_tpu.models.tracking_model import TrackingModel
    from mo_yolo_tpu.train import train_step as jts
    from mo_yolo_tpu.train.losses import LossConfig

    spec = parse_model_yaml(TINY_YAML)
    model = TrackingModel(spec=spec, tracker=TrackerConfig(n_slots=N_SLOTS),
                          nq=NQ, ndl=NDL, d_ffn=D_FFN, hd=HD,
                          num_denoising=0)
    init = jax.jit(lambda k, x, s: model.init(k, x, s, train=False))
    v = randomize_norms(_numpy(init(jax.random.PRNGKey(0),
                                    jnp.zeros((B, HW, HW, 3)),
                                    init_track_state(B, N_SLOTS, HD))))
    lcfg = LossConfig(nc=spec.nc)
    tx = _selectable_tx(*(jts.make_optimizer(_tcfg(jts, o), nc=spec.nc)
                          for o in OPTIMIZERS))
    init_fn, step_fn = jts.make_train_step(model, lcfg, _tcfg(jts, "adamw"),
                                           tx=tx)
    step = jax.jit(step_fn)
    jclip = {k: jnp.asarray(a) for k, a in clip.items()}
    runs = {}
    for i, name in enumerate(OPTIMIZERS):
        ts = init_fn(v)
        ts = ts._replace(opt_state={**ts.opt_state,
                                    "use_b": jnp.asarray(i == 1)})
        steps = []
        for k in range(N_STEPS):
            ts, m = step(ts, jclip, jax.random.PRNGKey(k))
            steps.append({"metrics": {a: float(b) for a, b in m.items()},
                          "params": _numpy(ts.params),
                          "batch_stats": _numpy(ts.batch_stats),
                          "ema": _numpy(ts.ema_params),
                          "grads": _numpy(ts.opt_state["grads"]),
                          "moments": _moments(ts.opt_state["ab"[i]],
                                              ts.params)})
        runs[name] = steps
    return v, spec.nc, runs


def _port_model(v):
    from mo_yolo_tpu_torch.models.tracker import TrackerConfig
    from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
    from mo_yolo_tpu_torch.utils.convert import state_dict_from_jax
    pm = build_tracking_model("tiny_track", device="cpu", nq=NQ, hd=HD,
                              ndl=NDL, d_ffn=D_FFN, num_denoising=0,
                              tracker=TrackerConfig(n_slots=N_SLOTS))
    pm.load_state_dict(state_dict_from_jax(v, head_idx=21), strict=True)
    return pm


def _torch_clip(clip):
    return {k: torch.from_numpy(np.ascontiguousarray(a))
            for k, a in clip.items()}


def _load_jax_state(ts, jax_step):
    """Put the JAX run's state after a step into the port's TrainState."""
    from mo_yolo_tpu_torch.utils.convert import state_dict_from_jax
    ts.model.load_state_dict(state_dict_from_jax(
        {"params": jax_step["params"], "batch_stats": jax_step["batch_stats"]},
        head_idx=21), strict=True)
    params = dict(ts.model.named_parameters())
    for n, e in state_dict_from_jax({"params": jax_step["ema"]},
                                    head_idx=21).items():
        ts.ema[n].copy_(e)
    for field, tree in jax_step["moments"].items():
        for n, t in state_dict_from_jax({"params": tree},
                                        head_idx=21).items():
            ts.optimizer.state[params[n]][field] = t.clone()


def _port_run(v, nc, clip, optimizer, remat=False, n_steps=N_STEPS,
              jax_steps=None):
    """n_steps of the port; with `jax_steps`, step k > 0 starts from the
    JAX run's state after step k - 1."""
    from mo_yolo_tpu_torch.train import train_step as pts
    from mo_yolo_tpu_torch.train.losses import LossConfig
    pm = _port_model(v)
    init_fn, step_fn = pts.make_train_step(pm, LossConfig(nc=nc),
                                           _tcfg(pts, optimizer, remat))
    ts = init_fn()
    gen = torch.Generator().manual_seed(0)
    steps = []
    for k in range(n_steps):
        if jax_steps is not None and k > 0:
            _load_jax_state(ts, jax_steps[k - 1])
        ts, m = step_fn(ts, clip, gen)
        steps.append({
            "metrics": {a: float(b) for a, b in m.items()},
            "params": {n: p.detach().clone()
                       for n, p in pm.named_parameters()},
            "grads": {n: (p.grad.clone() if p.grad is not None
                          else torch.zeros_like(p))
                      for n, p in pm.named_parameters()},
            "buffers": {n: b.clone() for n, b in pm.named_buffers()},
            "ema": {n: e.clone() for n, e in ts.ema.items()}})
    return steps


@pytest.fixture(scope="module")
def runs():
    clip = _clip()
    v, nc, jax_runs = _jax_runs(clip)
    tclip = _torch_clip(clip)
    port = {name: _port_run(v, nc, tclip, name, jax_steps=jax_runs[name])
            for name in OPTIMIZERS}
    return {"v": v, "nc": nc, "clip": tclip, "jax": jax_runs, "port": port}


def _close_per_tensor(got, want, what, tol=TENSOR_TOL, extra=0.0):
    """Each tensor within `tol` of its own max magnitude, plus `extra`;
    `tol` may be a function of the tensor's name."""
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k].numpy()
        w = w.numpy()
        assert np.isfinite(g).all(), (what, k)
        t = tol(k) if callable(tol) else tol
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= t * scale + extra, f"{what} {k}: {err} > " \
            f"{t} x {scale} + {extra}"


def _grad_tol(name):
    return OFFSETS_GRAD_TOL if "sampling_offsets" in name else GRAD_TOL


def _param_tol(name):
    """The offsets' weights start at zero, so they are the sum of their
    updates and keep their gradient's tolerance."""
    return OFFSETS_GRAD_TOL if "sampling_offsets" in name else TENSOR_TOL


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("k", range(N_STEPS))
def test_train_step_matches_jax(runs, optimizer, k):
    """Step k of a 3-step run from the same state: loss and every loss
    term, the per-tensor gradients, the updated parameters, the BatchNorm
    statistics and the EMA."""
    from mo_yolo_tpu_torch.utils.convert import state_dict_from_jax
    want, got = runs["jax"][optimizer][k], runs["port"][optimizer][k]
    wm, gm = want["metrics"], got["metrics"]
    assert set(wm) == set(gm)
    for key, w in wm.items():
        assert np.isfinite(gm[key]), key
        if key != "grad_norm":
            np.testing.assert_allclose(gm[key], w, rtol=LOSS_RTOL, atol=1e-6,
                                       err_msg=key)
    assert wm["loss"] > 0 and wm["grad_norm"] > 0
    want_grads = state_dict_from_jax({"params": want["grads"]}, head_idx=21)
    assert_grad_norm(gm["grad_norm"], wm["grad_norm"], got["grads"],
                     want_grads)
    _close_per_tensor(got["grads"], want_grads, "grad", tol=_grad_tol)
    extra = 2 * LR if optimizer == "adamw" else 0.0
    for key in ("params", "ema"):
        _close_per_tensor(got[key],
                          state_dict_from_jax({"params": want[key]},
                                              head_idx=21), key,
                          tol=_param_tol, extra=extra)
    stats = {n: t for n, t in state_dict_from_jax(
        {"batch_stats": want["batch_stats"]}, head_idx=21).items()
        if not n.endswith("num_batches_tracked")}
    _close_per_tensor({n: got["buffers"][n] for n in stats}, stats,
                      "batch_stats")
    # the step moved the parameters, the sampler's projections among them
    if k > 0:
        before = state_dict_from_jax(
            {"params": runs["jax"][optimizer][k - 1]["params"]}, head_idx=21)
        moved = {n for n, p in got["params"].items()
                 if not torch.equal(p, before[n])}
        for part in ("sampling_offsets", "attention_weights", "value_proj"):
            assert any(part in n for n in moved), part


def test_remat_matches_no_remat_and_updates_batch_stats_once(runs):
    """Checkpointed frames give the same loss, gradients and parameters as
    plain ones, and each BatchNorm counts one update per frame."""
    plain = runs["port"]["adamw"][0]
    remat = _port_run(runs["v"], runs["nc"], runs["clip"], "adamw",
                      remat=True, n_steps=1)[0]
    assert remat["metrics"] == plain["metrics"]
    for key in ("grads", "params", "ema"):
        for n, t in plain[key].items():
            torch.testing.assert_close(remat[key][n], t, rtol=0, atol=0,
                                       msg=f"{key} {n}")
    counts = {n: int(b) for n, b in remat["buffers"].items()
              if n.endswith("num_batches_tracked")}
    assert counts and set(counts.values()) == {T}
    for n, b in plain["buffers"].items():
        torch.testing.assert_close(remat["buffers"][n], b, rtol=0, atol=0)
