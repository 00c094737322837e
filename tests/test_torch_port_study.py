"""PyTorch port vs the JAX package on the sampler-study path: the variant
kernels' plain versions against the TPU kernels of
`scripts/kernel_variants_bench.py` and `scripts/micro_peak_bench.py` (run
in the Pallas interpreter, as tests/test_deform_attn_pallas.py runs the
main kernel), the one-hot route inside the streaming model, and the
ported study script (`mo_yolo_tpu_torch.scripts`)."""

import importlib.util

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tests.torch_port_common import (ROOT, SAMPLER_CASES, TINY_NQ,
                                     build_pair, rand_sampler_inputs)

torch.set_num_threads(1)

ATOL = 1e-5     # f32 on both sides, sums in another order


def _load_script(name):
    """A top-level JAX script, imported by path and left untouched."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_variants():
    return _load_script("kernel_variants_bench")


@pytest.fixture(scope="module")
def jax_micro():
    return _load_script("micro_peak_bench")


# ---------------------------------------------------------------- (b) ----

# study name -> (the JAX script's function, the port's variant, keywords)
VARIANT_FUNCS = {
    "v1": ("fwd_v1", "v1", {}),
    "v2": ("fwd_v2", "v2", {}),
    "v3": ("fwd_v3", "v3", {}),
    "v4": ("fwd_v4", "v45", {"compact_cy": True}),
    "v5": ("fwd_v4", "v45", {"compact_cy": False}),
    "nocy": ("fwd_nocy", "nocy", {}),
    "v6": ("fwd_v6", "v6", {}),
    "v7": ("fwd_v7", "v7", {}),
    "v8": ("fwd_v8", "v8", {}),
}
# the variants that keep the TPU kernels' rounding points in the value dtype
ROUNDING_VARIANTS = ["v4", "v5", "nocy", "v6", "v7", "v8"]
# S2-S4: their kernels compute in f32 inside, but their plain versions keep
# the TPU kernels' casts too
F32_INSIDE = ["v1", "v2", "v3"]
BF16_ULP = 2.0 ** -7


def _interpret(jax_variants, variant, value, shapes, loc, attn, tq):
    """The JAX script's TPU kernel for `variant`, in the Pallas
    interpreter, as float32 numpy."""
    fn, _, kw = VARIANT_FUNCS[variant]
    with pltpu.force_tpu_interpret_mode():
        out = getattr(jax_variants, fn)(jnp.asarray(value), shapes,
                                        jnp.asarray(loc), jnp.asarray(attn),
                                        TQ=tq, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(variant, plain=True):
    """The port's plain version (or wrapper) of `variant`, keywords bound."""
    from mo_yolo_tpu_torch.ops import deform_attn_variants as dv
    _, name, kw = VARIANT_FUNCS[variant]
    fn = getattr(dv, f"fwd_{name}_torch" if plain else f"fwd_{name}")
    return lambda *a, **k: fn(*a, **kw, **k)


@pytest.mark.parametrize("tq", [64, 16])    # Q=70: a partial tile either way
@pytest.mark.parametrize("variant", list(VARIANT_FUNCS))
def test_variant_plain_versions_match_pallas_interpret(jax_variants, variant,
                                                       tq):
    from mo_yolo_tpu_torch.ops import deform_attn_variants as dv
    from mo_yolo_tpu_torch.ops.deform_attn import ms_deform_attn_torch
    value, shapes, loc, attn = rand_sampler_inputs(seed=11)
    want = _interpret(jax_variants, variant, value, shapes, loc, attn, tq)
    args = (torch.from_numpy(value), shapes, torch.from_numpy(loc),
            torch.from_numpy(attn))
    plain = _port(variant)(*args, TQ=tq)
    assert plain.shape == want.shape == (1, 70, 16)
    np.testing.assert_allclose(plain.numpy(), want, atol=ATOL, rtol=0)
    # on a CPU tensor the wrapper is the plain version and launches nothing
    wrapper = getattr(dv, f"fwd_{VARIANT_FUNCS[variant][1]}")
    before = wrapper.launches
    assert torch.equal(_port(variant, plain=False)(*args, TQ=tq), plain)
    assert wrapper.launches == before
    if variant != "nocy":       # nocy computes another sum on purpose
        np.testing.assert_allclose(plain.numpy(),
                                   ms_deform_attn_torch(*args).numpy(),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", ROUNDING_VARIANTS + F32_INSIDE)
def test_variant_plain_versions_match_pallas_interpret_in_bf16(jax_variants,
                                                               variant):
    """The rounding points: in bf16 the plain version and the interpreted
    TPU kernel round to bf16 at the same places, so they agree to one bf16
    ulp at the output's scale (2^-7 of its largest magnitude: f32 sums in
    another order can move a rounding by one ulp; measured 0 here), and
    their mean difference is under a tenth of the TPU kernel's own mean
    error against the f32 sampler. That holds for the plain versions of
    v1-v3 as well, whose kernels compute in f32 inside."""
    from mo_yolo_tpu_torch.ops.deform_attn import ms_deform_attn_torch
    value, shapes, loc, attn = rand_sampler_inputs(seed=12)
    vb = jnp.asarray(value).astype(jnp.bfloat16)
    want = _interpret(jax_variants, variant, vb, shapes, loc, attn, 16)
    vt = torch.from_numpy(np.array(vb.astype(jnp.float32)))
    args = (vt.to(torch.bfloat16), shapes, torch.from_numpy(loc),
            torch.from_numpy(attn))
    plain = _port(variant)(*args, TQ=16)
    assert plain.dtype == torch.bfloat16
    diff = np.abs(plain.float().numpy() - want)
    assert diff.max() <= BF16_ULP * max(1.0, float(np.abs(want).max()))
    if variant != "nocy":
        ref = ms_deform_attn_torch(vt, shapes, *args[2:]).numpy()
        assert diff.mean() <= 0.1 * np.abs(want - ref).mean()


@pytest.mark.parametrize("levels", [((12, 16), (6, 8), (3, 4)),
                                    ((100, 192), (50, 96), (25, 48))],
                         ids=["small", "1536x800"])
@pytest.mark.parametrize("variant", ["v2", "v3", "v7", "v8"])
def test_v8_plain_version_on_clustered_points_matches_pallas_interpret(
        jax_variants, variant, levels):
    """Every point in [0.45, 0.55] (at the small levels' 6x8 every point of
    a level touches the same two rows, so a row sums the u of up to 4
    points before its rounding): in bf16 the plain versions of v2, v3, v7
    and v8 and the interpreted TPU kernels agree to one bf16 ulp at the
    output's scale; v2, v3 and v7, whose kernels run on K1's warp grid,
    also within 1e-5 in f32."""
    value, shapes, loc, attn = rand_sampler_inputs(Q=16, shapes=levels,
                                                   seed=13)
    loc = np.random.default_rng(13).uniform(0.45, 0.55, loc.shape).astype(
        np.float32)
    if variant != "v8":
        want = _interpret(jax_variants, variant, value, shapes, loc, attn, 16)
        plain = _port(variant)(torch.from_numpy(value), shapes,
                               torch.from_numpy(loc), torch.from_numpy(attn),
                               TQ=16)
        np.testing.assert_allclose(plain.numpy(), want, atol=ATOL, rtol=0)
    vb = jnp.asarray(value).astype(jnp.bfloat16)
    want = _interpret(jax_variants, variant, vb, shapes, loc, attn, 16)
    vt = torch.from_numpy(np.array(vb.astype(jnp.float32)))
    plain = _port(variant)(vt.to(torch.bfloat16), shapes,
                           torch.from_numpy(loc), torch.from_numpy(attn),
                           TQ=16)
    assert plain.dtype == torch.bfloat16 and plain.shape == (1, 16, 16)
    diff = np.abs(plain.float().numpy() - want)
    assert diff.max() <= BF16_ULP * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("case", ["q10", "all_out_of_bounds", "batch2"])
def test_variant_plain_versions_on_edge_cases(case):
    """A short last tile, nothing in bounds (exactly zero) and a batch of
    two, against the plain gather sampler."""
    from mo_yolo_tpu_torch.ops.deform_attn import ms_deform_attn_torch
    value, shapes, loc, attn = SAMPLER_CASES[case]()
    args = (torch.from_numpy(value), shapes, torch.from_numpy(loc),
            torch.from_numpy(attn))
    want = ms_deform_attn_torch(*args)
    for variant in VARIANT_FUNCS:
        if variant == "nocy":
            continue
        got = _port(variant)(*args, TQ=64)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=0)
        if case == "all_out_of_bounds":
            assert not got.any()


@pytest.mark.parametrize("case", ["q10", "all_out_of_bounds", "batch2"])
def test_nocy_plain_version_on_edge_cases_matches_pallas_interpret(
        jax_variants, case):
    """nocy computes another sum on purpose: it is held to its TPU kernel
    alone."""
    value, shapes, loc, attn = SAMPLER_CASES[case]()
    want = _interpret(jax_variants, "nocy", value, shapes, loc, attn, 64)
    got = _port("nocy")(torch.from_numpy(value), shapes,
                        torch.from_numpy(loc), torch.from_numpy(attn),
                        TQ=64)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    if case == "all_out_of_bounds":
        assert not got.any()


@pytest.mark.parametrize("name", ["v1", "v2", "v3", "v45", "nocy", "v6",
                                  "v7", "v8"])
def test_variant_wrappers_validate_before_launching(name):
    """What the kernels do not take raises before anything is built or
    launched; nothing falls back: `prepare_*` refuses a CPU tensor, a tile
    too large for shared memory raises (the study interface's rule, which
    nocy keeps), and so does a plain version's tile of no queries."""
    from mo_yolo_tpu_torch.ops import deform_attn_variants as dv
    value, shapes, loc, attn = (torch.from_numpy(a) if isinstance(
        a, np.ndarray) else a for a in SAMPLER_CASES["q10"]())
    wrapper = getattr(dv, f"fwd_{name}")
    before = wrapper.launches
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(dv, f"prepare_{name}")(value, shapes, loc, attn)
    with pytest.raises(ValueError, match="shared memory"):
        dv._check_tile(loc, 10 ** 6, heads_in_block=True)
    with pytest.raises(ValueError, match="TQ"):
        getattr(dv, f"fwd_{name}_torch")(value, shapes, loc, attn, TQ=0)
    assert wrapper.launches == before


def test_variant_row_rules():
    """The row rules the wrappers hold: the study interface's even D of
    at most 64 (nocy); the kernels on the main-path kernel's grid (v1-v3,
    v45, v6, v7, v8) take any D up to 128 with no row rule; v8 takes at
    most 8 points."""
    from mo_yolo_tpu_torch.ops import deform_attn_variants as dv
    for D, ok in ((8, True), (32, True), (64, True), (6, True), (7, False),
                  (66, False)):
        v = torch.zeros(1, 4, 2, D)
        if ok:
            dv._check_rows("k", v, "pairs")
        else:
            with pytest.raises(ValueError, match="even D"):
                dv._check_rows("k", v, "pairs")
    dv._check_rows("k", torch.zeros(1, 4, 2, 7), "")
    value, shapes, loc, attn = rand_sampler_inputs(Q=4, P=9)
    with pytest.raises(ValueError, match="at most 8 points"):
        dv.prepare_v8(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                      torch.from_numpy(attn))


# ---------------------------------------------------------------- (c) ----

@pytest.mark.parametrize("S,N,axis", [(8, 256, 0), (16, 128, 1)])
def test_take_along_axis_matches_jax_and_interpreted_kernels(jax_micro, S, N,
                                                             axis):
    """Exactly: a gather moves values and computes nothing."""
    from mo_yolo_tpu_torch.ops.gather import (take_along_axis,
                                              take_along_axis_torch)
    rng = np.random.default_rng(S + axis)
    v = rng.standard_normal((S, N)).astype(np.float32)
    idx = rng.integers(0, (S, N)[axis], (S, N)).astype(np.int32)
    got = take_along_axis_torch(torch.from_numpy(v), torch.from_numpy(idx),
                                axis)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.take_along_axis(v, idx, axis=axis)))
    kern = jax_micro._gather_kernel if axis == 0 else \
        jax_micro._gather_lane_kernel
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pl.pallas_call(
            kern, out_shape=jax.ShapeDtypeStruct((S, N), jnp.float32))(
                jnp.asarray(v), jnp.asarray(idx)))
    np.testing.assert_array_equal(got.numpy(), want)
    before = take_along_axis.launches
    assert torch.equal(take_along_axis(torch.from_numpy(v),
                                       torch.from_numpy(idx), axis), got)
    assert take_along_axis.launches == before


def test_take_along_axis_rejects_what_the_kernel_does_not_take():
    from mo_yolo_tpu_torch.ops.gather import _check, empty_launch
    v = torch.zeros(4, 6)
    idx = torch.zeros(4, 6, dtype=torch.int32)
    _check(v, idx, 1)
    with pytest.raises(ValueError):
        _check(v, idx, 2)
    with pytest.raises(TypeError):
        _check(v, idx.long(), 0)
    with pytest.raises(TypeError):
        _check(v.double(), idx, 0)
    with pytest.raises(ValueError):
        _check(v, idx[:, :3], 0)
    with pytest.raises(ValueError):
        _check(v.t(), idx.t(), 0)
    with pytest.raises(ValueError):
        empty_launch(torch.device("cpu"))


# ---------------------------------------------------------------- (d) ----

def test_onehot_stream_matches_jax_onehot():
    """Three stream_step frames with impl="onehot" in both packages from
    the same weights: identical ids, boxes to f32 tolerance. The score
    bias keeps scores off the tracker's thresholds, as in the stream
    test."""
    from mo_yolo_tpu.models.tracker import init_track_state
    from mo_yolo_tpu.models.tracker import unpack_outputs as j_unpack
    from mo_yolo_tpu_torch.models.tracker import unpack_outputs
    from mo_yolo_tpu_torch.ops.deform_attn import ms_deform_attn_onehot_torch
    jm, v, pm = build_pair(image_hw=(64, 96), score_bias=0.3, impl="onehot")
    assert jm.impl == "onehot"
    samplers = {m.impl for m in pm.modules() if hasattr(m, "impl")}
    assert samplers == {"onehot"}
    calls = []
    import mo_yolo_tpu_torch.models.transformer as tr
    spy = lambda *a: calls.append(1) or ms_deform_attn_onehot_torch(*a)
    tr.SAMPLERS["onehot"], saved = spy, tr.SAMPLERS["onehot"]
    try:
        step = jax.jit(lambda vv, s, x: jm.apply(vv, s, x,
                                                 method=jm.stream_step))
        js = init_track_state(1, TINY_NQ, jm.hd)
        ts = pm.init_state(1)
        rng = np.random.default_rng(0)
        base = rng.integers(0, 256, (64, 96, 3)).astype(np.int16)
        n_valid = 0
        for _ in range(3):
            x = np.clip(base + rng.integers(-3, 4, base.shape), 0,
                        255).astype(np.uint8)
            js, jo = step(v, js, jnp.asarray(x[None]))
            ts, to = pm.stream_step(ts, torch.from_numpy(x[None]))
            jo = {k: a[0] for k, a in j_unpack(np.asarray(jo)).items()}
            to = {k: a[0] for k, a in unpack_outputs(to).items()}
            assert np.abs(jo["score"] - 0.4).min() > 1e-3
            assert np.abs(jo["score"] - 0.5).min() > 1e-3
            np.testing.assert_array_equal(to["obj_id"], jo["obj_id"])
            np.testing.assert_array_equal(to["valid"], jo["valid"])
            np.testing.assert_allclose(to["box"], jo["box"], atol=ATOL)
            n_valid += int(jo["valid"].sum())
    finally:
        tr.SAMPLERS["onehot"] = saved
    assert n_valid > 0
    assert len(calls) == 3 * len(pm.head.decoder.decoder.layers)


# ---------------------------------------------------------------- (e) ----

def test_study_inputs_follow_the_jax_script(jax_variants):
    from mo_yolo_tpu_torch.scripts import kernel_variants_bench as kb
    for h, w in ((640, 640), (800, 1536), (320, 320)):
        assert kb.level_shapes(h, w) == jax_variants.level_shapes(h, w)
    assert kb.SIZES == ((640, 640), (800, 1536))
    want = jax_variants.make_inputs(320, 320)
    got = kb.make_inputs(320, 320, torch.Generator().manual_seed(0))
    assert got[1] == want[1]
    for g, w_ in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        assert tuple(g.shape) == tuple(w_.shape)
        assert str(g.dtype)[6:] == str(w_.dtype)
    loc, attn = got[2], got[3].float()
    assert 0.05 <= float(loc.min()) and float(loc.max()) <= 0.95
    assert float(loc.min()) < 0.06 and float(loc.max()) > 0.94
    # a softmax over the points of each level, rounded to bf16
    np.testing.assert_allclose(attn.sum(-1).numpy(), 1.0, atol=2e-2)
    np.testing.assert_allclose(np.asarray(want[3], np.float32).sum(-1), 1.0,
                               atol=2e-2)
    # the same generator state gives the same inputs
    again = kb.make_inputs(320, 320, torch.Generator().manual_seed(0))
    assert torch.equal(got[0], again[0]) and torch.equal(got[2], again[2])
    # every TPU kernel of the JAX script has its counterpart
    assert set(kb.VARIANTS) == set(jax_variants.VARIANTS)


def test_study_main_runs_on_the_cpu_with_the_plain_versions(capsys):
    """The study's entry point at 8 queries (its full Q=600 on the CPU
    would take the plain versions minutes)."""
    from mo_yolo_tpu_torch.scripts import kernel_variants_bench as kb
    recs = kb.main(["--device", "cpu", "--iters", "1", "--q", "8",
                    "--parity", "--variants", "v1,vx3"])
    assert [(r["size"], r["variant"]) for r in recs] == [
        ("640x640", "v1"), ("640x640", "vx3"), ("1536x800", "v1"),
        ("1536x800", "vx3")]
    for r in recs:
        assert r["device"] == {"platform": "cpu", "kind": "host"}
        assert r["ms_min"] <= r["ms"] <= r["ms_max"] and r["runs"] >= 5
        assert r["kernel_only_ms"] is None      # no kernel ran
    out = capsys.readouterr().out
    assert "parity v1 @320x320" in out and "parity vx3 @320x320" in out
    with pytest.raises(SystemExit):
        kb.main(["--device", "cpu", "--variants", "v9"])


def test_study_main_runs_the_new_variants_on_the_cpu(capsys):
    """v4 and v8 through the study's entry point at 8 queries."""
    from mo_yolo_tpu_torch.scripts import kernel_variants_bench as kb
    recs = kb.main(["--device", "cpu", "--iters", "1", "--q", "8",
                    "--parity", "--variants", "v4,v8,nocy"])
    assert [(r["size"], r["variant"]) for r in recs] == [
        (size, name) for size in ("640x640", "1536x800")
        for name in ("v4", "v8", "nocy")]
    assert all(r["kernel_only_ms"] is None for r in recs)
    out = capsys.readouterr().out
    assert "parity v4 @320x320" in out and "parity v8 @320x320" in out
    assert "parity nocy" not in out         # another sum, on purpose


def test_study_table_queries_a_block_follow_the_jax_script():
    """Each name's queries a block (the JAX table's TQ; v8 is 64 there,
    though `fwd_v8` defaults to 128) and v4/v5's compact_cy."""
    from mo_yolo_tpu_torch.scripts import kernel_variants_bench as kb
    for name, (fn, prepare) in kb.VARIANTS.items():
        if prepare is None:
            continue
        tq = 256 if name.endswith("t256") else \
            128 if name.endswith("t128") else 64
        assert fn.keywords["TQ"] == prepare.keywords["TQ"] == tq, name
    assert kb.VARIANTS["v4"][0].keywords["compact_cy"] is True
    assert kb.VARIANTS["v5"][0].keywords["compact_cy"] is False


@pytest.mark.parametrize("name", ["vx", "vx2", "vx3", "vh", "vh2", "v0"])
def test_study_plain_variants_match_the_jax_script(jax_variants, name):
    """The study's plain-code variants against the JAX script's at f32 (v0
    on the JAX side is the TPU kernel in the interpreter)."""
    from mo_yolo_tpu_torch.scripts import kernel_variants_bench as kb
    value, shapes, loc, attn = rand_sampler_inputs(seed=21)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_variants.VARIANTS[name](
            jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn)))
    got = kb.VARIANTS[name][0](torch.from_numpy(value), shapes,
                               torch.from_numpy(loc), torch.from_numpy(attn))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_micro_benchmarks_run_on_the_cpu():
    from mo_yolo_tpu_torch.scripts import (hbm_bw_bench, kernel_study_shapes,
                                           micro_peak_bench)
    cpu = torch.device("cpu")
    rec = micro_peak_bench.probe_gather(16, 24, 1, cpu, iters=1)
    assert rec["exact"] and rec["device"]["platform"] == "cpu"
    assert micro_peak_bench.bench_empty_launch(cpu)["us"] is None
    assert micro_peak_bench.bench_matmul(8, 8, 8, torch.float32, cpu,
                                         iters=1)["tflops"] > 0
    assert [s[:2] for s in micro_peak_bench.GATHER_SHAPES] == [
        (19200, 256), (8, 256), (256, 128), (256, 256)]
    rec = kernel_study_shapes.bench_size(64, 64, cpu, q=4, iters=1)
    assert set(kernel_study_shapes.IMPLS) <= set(rec) and rec["S"] == 84
    recs = hbm_bw_bench.main(["--device", "cpu", "--mb", "1"])
    assert [r["bench"] for r in recs] == ["read", "read", "read", "copy"]
    assert all(r["gb_per_s"] > 0 for r in recs)
