"""K2's design in plain tensor ops (`ms_deform_attn_backward_rows_torch`:
corner slots keyed by the d_value row they land on, the rows' counts, their
CSR starts, the slots sorted by row, one sum per row) against the sampler's
gradient three ways, on the CPU at f32: the port's plain gradient
(`ms_deform_attn_backward_torch`), `jax.vjp` of the JAX oracle
`ms_deform_attn_xla`, and the TPU kernel's `_backward` in the Pallas
interpreter. Inputs are made with numpy from a seed.

Tolerances, those of tests/test_torch_port_train_ops.py: 1e-5 absolute and
relative against the plain gradient and `jax.vjp` (f32 on both sides, sums
in another order; d_loc is ~10 in magnitude); 5e-4 absolute and 1e-2
relative against the interpreted TPU kernel (its one-hot products). With a
bf16 value, d_value is rounded to bf16 once: 1e-2 absolute and relative
against the f32 gradient on the same bf16 values."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_common import SAMPLER_CASES, rand_sampler_inputs

torch.set_num_threads(1)

F32_TOL = 1e-5
INTERP_ATOL, INTERP_RTOL = 5e-4, 1e-2
BF16_TOL = 1e-2


def _clustered():
    """Every point in [0.45, 0.55]: the corners pile onto a few rows, as
    training queries gather on a few objects."""
    value, shapes, loc, attn = rand_sampler_inputs(Q=96, H=2, D=16, seed=21)
    loc = np.random.default_rng(22).uniform(0.45, 0.55, loc.shape)
    return value, shapes, loc.astype(np.float32), attn


CASES = {
    "q70": SAMPLER_CASES["q70"],
    "batch2": SAMPLER_CASES["batch2"],
    "all_out_of_bounds": SAMPLER_CASES["all_out_of_bounds"],
    "clustered": _clustered,
    "d8_h3": lambda: rand_sampler_inputs(Q=77, H=3, D=8, seed=8),
    "bf16": lambda: rand_sampler_inputs(Q=40, H=2, D=32, seed=16),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(case):
    """Torch and numpy inputs and g; the bf16 case's value and g are
    rounded to bf16, and the references take those values in f32."""
    value, shapes, loc, attn = CASES[case]()
    g = np.random.default_rng(1).standard_normal(
        (value.shape[0], loc.shape[1], value.shape[2] * value.shape[3])
    ).astype(np.float32)
    tv, tg = _t(value), _t(g)
    if case == "bf16":
        tv, tg = tv.to(torch.bfloat16), tg.to(torch.bfloat16)
        value, g = tv.float().numpy(), tg.float().numpy()
    return tv, shapes, _t(loc), _t(attn), tg, (value, loc, attn, g)


def _rows(case):
    from mo_yolo_tpu_torch.ops.deform_attn import \
        ms_deform_attn_backward_rows_torch
    tv, shapes, loc, attn, g, np_in = _inputs(case)
    return ms_deform_attn_backward_rows_torch(tv, shapes, loc, attn, g), \
        shapes, np_in


def _hold(got, want, case, atol, rtol):
    for name, a, w in zip(("d_value", "d_loc", "d_attn"), got, want):
        w = np.asarray(w, np.float32)
        assert tuple(a.shape) == w.shape, name
        if case == "bf16":
            assert got[0].dtype == torch.bfloat16
            atol = rtol = max(atol, BF16_TOL)
        np.testing.assert_allclose(a.float().numpy(), w, atol=atol,
                                   rtol=rtol, err_msg=name)
    if case == "all_out_of_bounds":
        assert not any(a.any() for a in got[:3])


@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_form_matches_plain_gradient(case):
    from mo_yolo_tpu_torch.ops.deform_attn import ms_deform_attn_backward_torch
    (got, shapes, (value, loc, attn, g)) = _rows(case)
    want = ms_deform_attn_backward_torch(_t(value), shapes, _t(loc),
                                         _t(attn), _t(g))
    _hold(got, [w.numpy() for w in want], case, F32_TOL, F32_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_form_matches_jax_vjp(case):
    from mo_yolo_tpu.ops.deform_attn import ms_deform_attn_xla
    got, shapes, (value, loc, attn, g) = _rows(case)
    _, vjp = jax.vjp(lambda v, l, a: ms_deform_attn_xla(v, shapes, l, a),
                     jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    _hold(got, vjp(jnp.asarray(g)), case, F32_TOL, F32_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_form_matches_pallas_interpret(case):
    from jax.experimental.pallas import tpu as pltpu

    from mo_yolo_tpu.ops.deform_attn_pallas import _backward
    got, shapes, (value, loc, attn, g) = _rows(case)
    with pltpu.force_tpu_interpret_mode():
        want = _backward(jnp.asarray(value), shapes, jnp.asarray(loc),
                         jnp.asarray(attn), jnp.asarray(g))
    _hold(got, want, case, INTERP_ATOL, INTERP_RTOL)


@pytest.mark.parametrize("case", ["q70", "clustered", "batch2"])
def test_rows_form_intermediates_are_the_csr_lists(case):
    """key is the d_value row of each in-bounds corner and -1 elsewhere;
    counts count the keys; start is their exclusive prefix sum; ids lists
    every in-bounds slot once, grouped by row in start's order."""
    from mo_yolo_tpu_torch.ops.deform_attn import _corners
    (_, _, _, rows), shapes, (value, loc, attn, _) = _rows(case)
    B, S, H, _ = value.shape
    key, counts, start, ids = (rows[k] for k in ("key", "counts", "start",
                                                 "ids"))
    assert key.dtype == counts.dtype == start.dtype == torch.int32
    assert key.shape == loc.shape[:5] + (4,)
    off = 0
    for lvl, (h, w) in enumerate(shapes):
        idx, inb, _, _, _ = _corners(_t(loc)[:, :, :, lvl], h, w)
        k = key[:, :, :, lvl].long()
        assert torch.equal(k >= 0, inb)
        b = torch.arange(B)[:, None, None, None, None]
        hh = torch.arange(H)[None, None, :, None, None]
        want = (b * S + off + idx) * H + hh
        assert torch.equal(k[inb], want[inb])
        off += h * w
    flat = key.reshape(-1).long()
    assert torch.equal(counts.long(),
                       torch.bincount(flat[flat >= 0], minlength=B * S * H))
    assert start[0] == 0 and torch.equal(start[1:] - start[:-1], counts)
    assert ids.numel() == int(start[-1]) == int((flat >= 0).sum())
    assert torch.equal(ids.sort().values, torch.nonzero(flat >= 0)[:, 0])
    rows_of = flat[ids]
    assert bool((rows_of[1:] >= rows_of[:-1]).all())
    seg = torch.repeat_interleave(torch.arange(B * S * H), counts.long())
    assert torch.equal(rows_of, seg)


def test_rows_form_lists_ascend_by_slot_in_every_row():
    """Within each row's list the slots ascend: the order in which K2 sums
    a row, so that its d_value is the same in every run. On clustered
    points, where rows hold hundreds of corners; the slots of a row have
    distinct points u = q·P + p (a point's four corners are four pixels),
    which order them as the slots do."""
    (_, _, _, rows), _, (value, loc, _, _) = _rows("clustered")
    start, ids = rows["start"].long(), rows["ids"]
    Q, H, L, P = loc.shape[1], value.shape[2], loc.shape[3], loc.shape[4]
    assert int((start[1:] - start[:-1]).max()) > 100
    first = torch.zeros(ids.numel(), dtype=torch.bool)
    first[start[:-1][start[:-1] < ids.numel()]] = True
    step = ids[1:] - ids[:-1]
    assert bool((step[~first[1:]] > 0).all())
    pt = ids // 4
    u = (pt // (L * P) // H % Q) * P + pt % (L * P) % P
    assert bool((u[1:][~first[1:]] > u[:-1][~first[1:]]).all())


def test_rows_form_in_f64_passes_gradcheck():
    """The rows form is the sampler's gradient: in f64 against finite
    differences of the plain sampler, through the Function with the rows
    form as its backward."""
    from mo_yolo_tpu_torch.ops import deform_attn as da
    value, shapes, loc, attn = rand_sampler_inputs(Q=5, H=2, D=3, P=2,
                                                   shapes=((4, 5), (2, 3)),
                                                   seed=12)

    class Rows(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v, l, a):
            ctx.save_for_backward(v, l, a)
            return da.ms_deform_attn_torch(v, shapes, l, a)

        @staticmethod
        def backward(ctx, g):
            v, l, a = ctx.saved_tensors
            return da.ms_deform_attn_backward_rows_torch(v, shapes, l, a,
                                                         g)[:3]
    ins = tuple(_t(a).double().requires_grad_(True)
                for a in (value, loc, attn))
    assert torch.autograd.gradcheck(Rows.apply, ins, eps=1e-6, atol=1e-6,
                                    rtol=1e-5)
