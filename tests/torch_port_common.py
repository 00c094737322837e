"""Shared set-up of the PyTorch-port tests (`test_torch_port_*`): sampler
inputs made with numpy, and one JAX TrackingModel with numpy weights plus
the same weights in the port (both at f32 on the CPU). Imports only numpy
at module level, so the card-only tests can use it without JAX."""

from __future__ import annotations

from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TINY_YAML = str(ROOT / "tests" / "tiny_track.yaml")
TRACK_YAML = str(ROOT / "mo_yolo_tpu" / "cfg" / "models" / "yolo_track.yaml")
# nq / slot count of the tiny tests: at 64x96 tiny_track has 126 anchors,
# 84 of them valid, so nq=32 stays clear of the k < nq index tiling, where
# the JAX package picks invalid anchors and returns NaN
TINY_NQ = 32


def rand_sampler_inputs(B=1, Q=70, H=2, D=8, P=4,
                        shapes=((12, 16), (6, 8), (3, 4)), seed=0):
    """Sampler inputs as tests/test_deform_attn_pallas.py makes them."""
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.standard_normal((B, S, H, D)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, Q, H, L, P, 2)).astype(np.float32)
    attn = rng.uniform(0, 1, (B, Q, H, L, P)).astype(np.float32)
    attn /= attn.sum(axis=(-1, -2), keepdims=True)
    return value, shapes, loc, attn


def _out_of_bounds(value, shapes, loc, attn):
    return value, shapes, np.full_like(loc, 3.0), attn


def _half_out_of_range(value, shapes, loc, attn):
    loc = np.where(np.arange(loc.shape[1])[None, :, None, None, None, None]
                   % 2 == 0, 3.0, loc).astype(np.float32)
    return value, shapes, loc, attn


# the cases of tests/test_deform_attn_pallas.py
SAMPLER_CASES = {
    "q70": lambda: rand_sampler_inputs(),
    "q64": lambda: rand_sampler_inputs(Q=64, seed=64),
    "q10": lambda: rand_sampler_inputs(Q=10, seed=10),
    "all_out_of_bounds":
        lambda: _out_of_bounds(*rand_sampler_inputs(Q=8, seed=3)),
    "batch2":
        lambda: _half_out_of_range(*rand_sampler_inputs(B=2, Q=16, seed=5)),
}


def _map_leaves(tree, fn, path=()):
    if hasattr(tree, "items"):
        return {k: _map_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def randomize_norms(variables, seed: int = 1):
    """Random BatchNorm statistics and affine parameters, so that layout
    bugs cannot hide behind identity BatchNorm."""
    rng = np.random.default_rng(seed)

    def fn(path, a):
        a = np.asarray(a, np.float32)
        leaf, parent = path[-1], path[-2] if len(path) > 1 else ""
        if leaf == "mean":
            return rng.normal(0, 0.2, a.shape).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if "bn" in parent and leaf == "scale":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if "bn" in parent and leaf == "bias":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a
    return _map_leaves(variables, fn)


def numpy_init(shapes, seed: int = 0):
    """Variables for the JAX shapes `shapes` (a tree of ShapeDtypeStructs,
    from `jax.eval_shape` of an init) drawn with numpy, with no init
    compiled: LeCun-normal kernels, unit-normal embeddings, unit scales and
    variances, zero biases and means."""
    rng = np.random.default_rng(seed)

    def fn(path, s):
        leaf = path[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, s.shape).astype(np.float32)
        if leaf == "embedding":
            return rng.normal(0, 1, s.shape).astype(np.float32)
        if leaf in ("scale", "var"):
            return np.ones(s.shape, np.float32)
        return np.zeros(s.shape, np.float32)
    return _map_leaves(shapes, fn)


def build_pair(image_hw=(64, 96), seed: int = 0, score_bias=None, impl=None,
               cfg=None, compile_init: bool = True):
    """(jax_model, numpy variables, port model) for tiny_track (or the
    config `cfg`, a dict or a yaml path) with shared weights, nq and slots
    at TINY_NQ. `score_bias`, when given, is written into the
    enc_score_head and last score_head biases of both. `impl` names the
    sampler route of both models (None: each package's default on the
    CPU). `compile_init=False` draws the weights with `numpy_init` from
    `jax.eval_shape` of the init, which compiles nothing."""
    import jax
    import jax.numpy as jnp

    from mo_yolo_tpu.models.tracker import TrackerConfig as JTrackerConfig
    from mo_yolo_tpu.models.tracker import init_track_state as j_init_state
    from mo_yolo_tpu.models.tracking_model import \
        build_tracking_model as j_build
    from mo_yolo_tpu_torch.models.tracker import TrackerConfig
    from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
    from mo_yolo_tpu_torch.utils.convert import state_dict_from_jax

    jm = j_build(TINY_YAML if cfg is None else cfg, nq=TINY_NQ, impl=impl,
                 tracker=JTrackerConfig(n_slots=TINY_NQ))
    state = j_init_state(1, TINY_NQ, jm.hd)
    imgs = jnp.zeros((1, *image_hw, 3), jnp.float32)

    def init(k, x, s):
        return jm.init(k, x, s, train=False)
    if compile_init:
        v = jax.tree_util.tree_map(
            np.asarray, jax.jit(init)(jax.random.PRNGKey(seed), imgs, state))
    else:
        v = numpy_init(jax.eval_shape(init, jax.random.PRNGKey(seed), imgs,
                                      state), seed)
    v = randomize_norms(v, seed + 1)
    if score_bias is not None:
        dec = v["params"]["decoder"]
        dec["enc_score_head"]["bias"] = np.full_like(
            dec["enc_score_head"]["bias"], score_bias)
        last = f"score_head{jm.ndl - 1}"
        dec["decoder"][last]["bias"] = np.full_like(
            dec["decoder"][last]["bias"], score_bias)
    pm = build_tracking_model("tiny_track" if cfg is None else cfg,
                              device="cpu", nq=TINY_NQ, impl=impl,
                              tracker=TrackerConfig(n_slots=TINY_NQ))
    pm.load_state_dict(state_dict_from_jax(v, head_idx=pm.spec.head_index),
                       strict=True)
    return jm, v, pm


def j_facade(cls, jm, variables, imgsz):
    """A JAX `MOTRTrack` holding `jm` and `variables` (numpy), made without
    its constructor, which would compile an init of its own: the fields
    `save` and the predictor read, as the constructor sets them for
    `MOTRTrack(TINY_YAML, imgsz=imgsz, dtype="float32", nq=TINY_NQ,
    tracker=TrackerConfig(n_slots=TINY_NQ))`."""
    import jax
    import jax.numpy as jnp
    from mo_yolo_tpu.data.letterbox import to_hw

    jf = cls.__new__(cls)
    jf.model, jf.cfg_path, jf.imgsz = jm, TINY_YAML, imgsz
    jf.in_h, jf.in_w = to_hw(imgsz)
    jf.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    jf.names, jf._nc, jf._dtype_str, jf._impl = {}, None, "float32", None
    jf._model_kw = {"nq": TINY_NQ}
    return jf


def check_full_width(name: str, detect: bool = False):
    """The bundled config `name` at full width against the JAX package's
    yaml of it: the parsed node lists (index, inputs, module, repeats,
    channels), the taps and head row, the parameter count of the tracking
    (or, with `detect`, the detection) model against `jax.eval_shape` of
    the JAX init (which traces and compiles nothing), and the converter's
    state_dict of those shapes loading with strict=True. Returns the port
    model."""
    import jax
    import jax.numpy as jnp

    from mo_yolo_tpu.models.graph import parse_model_yaml as j_parse
    from mo_yolo_tpu_torch.models.graph import parse_model_yaml
    from mo_yolo_tpu_torch.utils.convert import state_dict_from_jax

    path = str(ROOT / "mo_yolo_tpu" / "cfg" / "models" / f"{name}.yaml")
    js, ps = j_parse(path), parse_model_yaml(name)

    def rows(spec):
        return [(n.index, tuple(n.frm), n.module, n.repeats, n.out_channels)
                for n in spec.nodes]
    assert rows(ps) == rows(js)
    assert (ps.out_indices, ps.out_channels, ps.nc, ps.head_module) == \
        (js.out_indices, js.out_channels, js.nc, js.head_module)
    x = jnp.zeros((1, 64, 64, 3))
    if detect:
        from mo_yolo_tpu.models.detect import build_detection_model as j_build
        from mo_yolo_tpu_torch.models.detect import build_detection_model
        jm = j_build(path)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
        pm = build_detection_model(name, device="cpu")
    else:
        from mo_yolo_tpu.models.tracker import init_track_state
        from mo_yolo_tpu.models.tracking_model import \
            build_tracking_model as j_build
        from mo_yolo_tpu_torch.models.tracking_model import \
            build_tracking_model
        jm = j_build(path)
        shapes = jax.eval_shape(
            lambda k, x, s: jm.init(k, x, s, train=False),
            jax.random.PRNGKey(0), x,
            init_track_state(1, jm.tracker.n_slots, jm.hd))
        pm = build_tracking_model(name, device="cpu")
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in pm.parameters()) == n_jax
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    sd = state_dict_from_jax(zeros, head_idx=ps.head_index, detect=detect)
    own = pm.state_dict()
    assert set(sd) == set(own)
    for k, t in own.items():
        assert tuple(sd[k].shape) == tuple(t.shape), k
    pm.load_state_dict(sd, strict=True)
    return pm


def hide_libjpeg(monkeypatch, build_dir):
    """The card's machine for the port's host code: libjpeg cannot be
    found, and the host libraries are built afresh in `build_dir`."""
    import ctypes.util

    from mo_yolo_tpu_torch.utils import cuda_build
    find = ctypes.util.find_library
    monkeypatch.setattr(ctypes.util, "find_library",
                        lambda name: None if name == "jpeg" else find(name))
    deps = cuda_build.missing_c_deps

    def missing(libs=()):
        return [f"lib{lib}" for lib in libs if lib == "jpeg"] + \
            deps([lib for lib in libs if lib != "jpeg"])
    monkeypatch.setattr(cuda_build, "missing_c_deps", missing)
    monkeypatch.setattr(cuda_build, "_loaded_c", {})
    monkeypatch.setattr(cuda_build, "HOST_BUILD_DIR", Path(build_dir))


# A reported gradient norm is held by what it is, not by a relative
# tolerance of its own: each side's equals the norm of the gradients that
# side reports (to GRAD_NORM_SELF_RTOL, f32 sums against f64), and two
# sides' norms differ by no more than their gradients do, |‖a‖ − ‖b‖| <=
# ‖a − b‖ (in f64, over every tensor), plus GRAD_NORM_SLACK of the
# reference's norm for the f32 sums. A fixed rtol on the scalar is
# stricter than the per-tensor checks of the gradients it is the norm of,
# and passes or fails with the host's f32 reduction order.
GRAD_NORM_SELF_RTOL = 1e-5
GRAD_NORM_SLACK = 1e-6


def grad_norm_margins(norm, ref_norm, grads, ref_grads):
    """The two checks on a gradient norm, as numbers: `norm` and
    `ref_norm` the two sides' reported norms, `grads` and `ref_grads` their
    gradients by name (tensors or arrays, the same names and shapes).
    Returns the largest relative gap of a side's norm from its own
    gradients' (`self_rel`), |norm - ref_norm| (`gap`) and its bound
    ‖grads - ref_grads‖ + GRAD_NORM_SLACK · ref_norm (`bound`)."""
    assert set(grads) == set(ref_grads)

    def f64(t):
        return np.asarray(t.detach().cpu().double() if hasattr(t, "detach")
                          else t, np.float64)
    sq = sq_ref = sq_diff = 0.0
    for k in grads:
        a, b = f64(grads[k]), f64(ref_grads[k])
        assert a.shape == b.shape, k
        sq += float((a * a).sum())
        sq_ref += float((b * b).sum())
        sq_diff += float(((a - b) ** 2).sum())
    norm, ref_norm = float(norm), float(ref_norm)
    own, own_ref = np.sqrt(sq), np.sqrt(sq_ref)
    return {"self_rel": max(abs(norm - own) / own,
                            abs(ref_norm - own_ref) / own_ref),
            "gap": abs(norm - ref_norm),
            "bound": float(np.sqrt(sq_diff)) + GRAD_NORM_SLACK * ref_norm}


def assert_grad_norm(norm, ref_norm, grads, ref_grads, what="grad_norm"):
    """Both checks of `grad_norm_margins`; returns its margins."""
    m = grad_norm_margins(norm, ref_norm, grads, ref_grads)
    assert np.isfinite(float(norm)) and float(norm) > 0, (what, norm)
    assert m["self_rel"] <= GRAD_NORM_SELF_RTOL, \
        f"{what}: a side's norm is off its own gradients' by {m['self_rel']}"
    assert m["gap"] <= m["bound"], \
        f"{what}: |{norm} - {ref_norm}| > ‖g - g_ref‖ + slack = {m['bound']}"
    return m
