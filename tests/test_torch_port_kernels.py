"""The port's CUDA kernels (K1 the sampler, K2 its gradient, the greedy
duplicate suppression, and the sampler study's S1 gather and S2-S7 forward
variants) and their wrappers (`mo_yolo_tpu_torch`), and the main paths'
freedom from host syncs on the card.

This file imports no JAX, so that its card tests also run on a machine
with a card and without JAX:

    python -m pytest tests/test_torch_port_kernels.py -q

Tests marked `gpu` skip where `torch.cuda.is_available()` is false."""

import numpy as np
import pytest
import torch

from tests.torch_port_common import SAMPLER_CASES, rand_sampler_inputs

torch.set_num_threads(1)

F32_ATOL = 1e-5           # same f32 arithmetic, other summation order
BF16_ATOL = BF16_RTOL = 1e-2   # one bf16 rounding of the output
# K2: d_loc/d_attn sum <g, v> over D in another order (warp shuffles) and
# are ~25 in magnitude, so 1e-5 is held relative as well as absolute;
# d_value sums each row in slot order, another order than `index_add_`'s
BWD_F32_TOL = 1e-5
DVALUE_RTOL = 1e-4


def _torch_inputs(case, device="cpu"):
    value, shapes, loc, attn = SAMPLER_CASES[case]()
    return (torch.from_numpy(value).to(device), shapes,
            torch.from_numpy(loc).to(device), torch.from_numpy(attn).to(device))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def test_wrapper_on_cpu_is_the_plain_version():
    """On a CPU tensor the wrapper computes the plain version and launches
    nothing."""
    from mo_yolo_tpu_torch.ops.deform_attn import (ms_deform_attn,
                                                   ms_deform_attn_torch)
    value, shapes, loc, attn = _torch_inputs("q70")
    before = ms_deform_attn.launches
    got = ms_deform_attn(value, shapes, loc, attn)
    assert ms_deform_attn.launches == before
    assert torch.equal(got, ms_deform_attn_torch(value, shapes, loc, attn))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    from mo_yolo_tpu_torch.ops.deform_attn import _check
    value, shapes, loc, attn = _torch_inputs("q10")
    _check(value, shapes, loc, attn)
    with pytest.raises(TypeError):
        _check(value.double(), shapes, loc, attn)
    with pytest.raises(TypeError):
        _check(value, shapes, loc.half(), attn)
    with pytest.raises(ValueError):
        _check(value, shapes[:2], loc, attn)
    with pytest.raises(ValueError):
        _check(value[:, :, :, ::2], shapes, loc, attn)
    with pytest.raises(ValueError):
        _check(value, ((12, 16), (6, 8), (3, 5)), loc, attn)


def test_kernel_source_has_its_c_entry_point():
    """The wrapper's argument list and the C entry point agree in arity:
    value, loc, attn, out, the shape block and the stream."""
    from mo_yolo_tpu_torch.ops.deform_attn import _FWD_ARGS
    from mo_yolo_tpu_torch.utils.cuda_build import CSRC
    src = (CSRC / "ms_deform_attn_fwd.cu").read_text()
    sig = src[src.index('extern "C" int ms_deform_attn_fwd('):]
    sig = sig[:sig.index(")")]
    assert sig.count(",") + 1 == len(_FWD_ARGS) == 6


def test_backward_kernel_source_has_its_c_entry_point():
    """K2's wrapper passes as many arguments as its C entry points take:
    the launch (value, loc, attn, grad, d_value, d_loc, d_attn, the
    workspace, the shape block, the stream) and the workspace layout (the
    shape block, the offsets)."""
    from mo_yolo_tpu_torch.ops.deform_attn import _BWD_ARGS
    from mo_yolo_tpu_torch.utils.cuda_build import CSRC
    src = (CSRC / "ms_deform_attn_bwd.cu").read_text()
    for entry, n_args in (('extern "C" int ms_deform_attn_bwd(',
                           len(_BWD_ARGS)),
                          ('extern "C" long long ms_deform_attn_bwd_workspace(',
                           2)):
        sig = src[src.index(entry):]
        sig = sig[:sig.index(")")]
        assert sig.count(",") + 1 == n_args, entry


def test_backward_kernel_sums_without_float_atomics():
    """K2 writes every d_value row once: its only atomics are integer ones
    (the row counts, the list cursors, and in the sort stage a block's
    count of long rows and the bits of their sets in shared memory), and
    there is no cast pass and no zeroed f32 buffer."""
    import re
    from mo_yolo_tpu_torch.ops import deform_attn as da
    from mo_yolo_tpu_torch.utils.cuda_build import CSRC
    src = (CSRC / "ms_deform_attn_bwd.cu").read_text()
    calls = re.findall(r"atomic\w+\(([^,]*),", src)
    assert calls == ["counts + r", "cursor + r", "&s_n_long",
                     "bits + row[k] * ROW_WORDS + (u >> 5)"]
    assert "int* __restrict__ counts" in src and \
        "int* __restrict__ cursor" in src
    assert "unsigned* bits = &s_bits[0][0].x;" in src and \
        "__shared__ uint4 s_bits[" in src and \
        re.search(r"__shared__ int [^;]*\bs_n_long;", src)
    assert "cast" not in src.split("#include")[1]
    import inspect
    assert "torch.zeros" not in inspect.getsource(da._launch_bwd)


def test_level_table_is_made_once_per_shape():
    """The C entry points' level table: the same ctypes array for the same
    level shapes, given as a tuple or a list; S is its sum."""
    from mo_yolo_tpu_torch.ops.deform_attn import _hw_array, _level_rows
    shapes = ((12, 16), (6, 8), (3, 4))
    hw = _hw_array(shapes)
    assert list(hw) == [12, 16, 6, 8, 3, 4]
    assert _hw_array(((12, 16), (6, 8), (3, 4))) is hw
    assert _hw_array([(12, 16), (6, 8), (3, 4)]) is hw
    assert _level_rows(shapes) == 12 * 16 + 6 * 8 + 3 * 4


def test_shape_block_is_checked_once_per_signature():
    """K1 and K2's shape block (dtype code, B, S, Q, H, D, L, P, the level
    pairs) is made once for each signature of shapes and dtypes; a
    non-contiguous or misplaced operand of a known signature still
    raises."""
    from mo_yolo_tpu_torch.ops.deform_attn import _plan
    value, shapes, loc, attn = _torch_inputs("q10")
    plan = _plan(value, shapes, loc, attn)
    assert list(plan[0]) == [0, 1, 252, 10, 2, 8, 3, 4,
                             12, 16, 6, 8, 3, 4]
    assert plan[1:] == (1, 252, 10, 2, 8, 3, 4)
    assert _plan(value.clone(), shapes, loc.clone(), attn.clone()) is plan
    assert _plan(value.to(torch.bfloat16), shapes, loc, attn)[0][0] == 1
    with pytest.raises(ValueError):
        _plan(value.transpose(1, 2).contiguous().transpose(1, 2), shapes,
              loc, attn)
    with pytest.raises(ValueError):
        _plan(value, shapes, loc[..., :1].expand(loc.shape), attn)


def test_kernels_reject_rows_and_points_they_do_not_carry():
    """K1 and K2 carry D <= 128 and L*P <= 64 in a warp; past that the
    wrapper raises before any launch."""
    from mo_yolo_tpu_torch.ops.deform_attn import _check_kernel
    value, _, loc, _ = _torch_inputs("q10")
    _check_kernel(value, loc)
    with pytest.raises(ValueError):
        _check_kernel(torch.zeros(1, 4, 2, 129), loc)
    with pytest.raises(ValueError):
        _check_kernel(value, torch.zeros(1, 10, 2, 3, 22, 2))


def test_backward_wrapper_on_cpu_is_the_plain_version():
    from mo_yolo_tpu_torch.ops.deform_attn import (
        ms_deform_attn_backward, ms_deform_attn_backward_torch)
    value, shapes, loc, attn = _torch_inputs("q70")
    g = torch.randn(1, 70, 16, generator=torch.Generator().manual_seed(0))
    before = ms_deform_attn_backward.launches
    got = ms_deform_attn_backward(value, shapes, loc, attn, g)
    assert ms_deform_attn_backward.launches == before
    for a, b in zip(got, ms_deform_attn_backward_torch(value, shapes, loc,
                                                       attn, g)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,n_args", [
    ("ms_deform_attn_fwd_v1", 15), ("ms_deform_attn_fwd_v2", 15),
    ("ms_deform_attn_fwd_v3", 15), ("take_along_axis", 7),
    ("ms_deform_attn_fwd_v45", 16), ("ms_deform_attn_fwd_nocy", 16),
    ("ms_deform_attn_fwd_v6", 15), ("ms_deform_attn_fwd_v7", 15),
    ("ms_deform_attn_fwd_v8", 15)])
def test_study_kernel_sources_have_their_c_entry_points(name, n_args):
    """Each study kernel's wrapper passes as many arguments as its C entry
    point takes, and each source names the TPU kernel it replaces."""
    from mo_yolo_tpu_torch.utils.cuda_build import CSRC
    src = (CSRC / f"{name}.cu").read_text()
    sig = src[src.index(f'extern "C" int {name}('):]
    sig = sig[:sig.index(")")]
    assert sig.count(",") + 1 == n_args
    assert "Replaces the TPU kernel" in src and "What bounds it" in src


@pytest.mark.parametrize("name,tpu_kernel", [
    ("ms_deform_attn_fwd_v45", "_kernel_v45"),
    ("ms_deform_attn_fwd_v6", "_kernel_v6")])
def test_s5_kernels_run_on_the_main_path_kernels_grid(name, tpu_kernel):
    """S5's v4/v5 and v6 kernels run the main-path kernel's skeleton
    (`walk_points`: a warp per (b, q, h), its points by shuffles, a point's
    corner rows in pieces), not the TPU's grid of a block per query tile
    with loc and attn in shared memory; each source names the TPU kernel it
    replaces and what bounds it."""
    from mo_yolo_tpu_torch.utils.cuda_build import CSRC

    def code(text):
        return "\n".join(ln.split("//")[0] for ln in text.splitlines())
    src = (CSRC / f"{name}.cu").read_text()
    assert "walk_pairs" not in code(src) and "__shared__" not in code(src)
    assert "walk_points<T, VEC>(" in code(src)
    header = code((CSRC / "sampler_common.cuh").read_text())
    skeleton = header[header.index("void walk_points("):]
    skeleton = skeleton[:skeleton.index("\n}\n")]
    assert "WarpPoints pts;" in skeleton and "load_corners<" in skeleton
    assert "__shared__" not in skeleton
    assert f"Replaces the TPU kernel `scripts/kernel_variants_bench.py:" \
        f"{tpu_kernel}`" in src
    assert "What bounds it on the card: bytes" in src


@pytest.mark.parametrize("name,tpu_kernel,layout", [
    ("ms_deform_attn_fwd_v1", "_kernel_v1", "walk_points<T, VEC>("),
    ("ms_deform_attn_fwd_v2", "_kernel_v2",
     "walk_points<T, VEC, HEAD_MAJOR>("),
    ("ms_deform_attn_fwd_v3", "_kernel_v3", "walk_points<T, VEC>(")])
def test_s2_to_s4_kernels_run_on_the_main_path_kernels_warp_grid(
        name, tpu_kernel, layout):
    """S2-S4 run the main-path kernel's warp grid through `walk_points`
    (v1 and v3 on the native layout, v2 on the head-major one), stage no
    tile in shared memory and launch through `warp_grid_entry`; v1 and v2
    share one hat-weight body (`HatPoint`), which neither file repeats."""
    from mo_yolo_tpu_torch.utils.cuda_build import CSRC

    def code(text):
        return "\n".join(ln.split("//")[0] for ln in text.splitlines())
    src = (CSRC / f"{name}.cu").read_text()
    body = code(src)
    assert "__shared__" not in body and "stage(" not in body
    assert layout in body and body.count("walk_points<") == 1
    assert f"warp_grid_entry<Fwd{name[-2:].upper()}>(" in body
    assert ("HatPoint()" in body) == (name[-2:] != "v3")
    assert "hat(" not in body and "hat_sample" not in body
    header = code((CSRC / "sampler_common.cuh").read_text())
    assert "struct HatPoint" in header and "hat_sample" not in header
    assert f"Replaces the TPU kernel `scripts/kernel_variants_bench.py:" \
        f"{tpu_kernel}`" in src
    assert "What bounds it on the card: bytes" in src


def test_s6_kernel_runs_on_the_main_path_kernels_warp_grid():
    """S6 (v7) runs K1's warp grid: no tile staged in shared memory, one
    launch through `warp_grid_entry`; the source names the TPU kernel it
    replaces, and the shared header no longer holds the staging helper."""
    from mo_yolo_tpu_torch.utils.cuda_build import CSRC

    def code(text):
        return "\n".join(ln.split("//")[0] for ln in text.splitlines())
    src = (CSRC / "ms_deform_attn_fwd_v7.cu").read_text()
    body = code(src)
    assert "__shared__" not in body and "stage(" not in body
    assert "warp_grid_entry<FwdV7>(" in body and "WarpPoints pts;" in body
    assert "Replaces the TPU kernel `scripts/kernel_variants_bench.py:" \
        "_kernel_v7`" in src
    assert "What bounds it on the card: bytes" in src
    assert "stage" not in code((CSRC / "sampler_common.cuh").read_text())


def test_shared_header_has_no_tpu_grid_skeleton():
    """No kernel runs the TPU's grid of two elements a lane any more, so
    the shared header holds neither its walk nor its two-element pieces."""
    from mo_yolo_tpu_torch.utils.cuda_build import CSRC
    header = (CSRC / "sampler_common.cuh").read_text()
    for gone in ("walk_pairs", "struct Pair", "pair_lanes"):
        assert gone not in header
    for src in CSRC.glob("*.cu"):
        text = src.read_text()
        assert "walk_pairs" not in text and "Pair<" not in text, src.name


def test_greedy_kernel_source_has_its_c_entry_point():
    """The greedy wrapper passes as many arguments as its C entry points
    take (conflict, valid, keep, B, M, the stream; M for the shared-memory
    size), and the source says what it replaces and what bounds it."""
    from mo_yolo_tpu_torch.ops.suppress import _ARGS
    from mo_yolo_tpu_torch.utils.cuda_build import CSRC
    src = (CSRC / "greedy_keep.cu").read_text()
    for entry, n_args in (('extern "C" int greedy_keep(', len(_ARGS)),
                          ('extern "C" long long greedy_keep_smem_bytes(', 1)):
        sig = src[src.index(entry):]
        sig = sig[:sig.index(")")]
        assert sig.count(",") + 1 == n_args, entry
    assert n_args == 1 and len(_ARGS) == 6
    assert "Replaces no TPU kernel" in src and "What bounds it" in src
    assert "__syncthreads_or" in src


def test_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    """A change to a header beside the sources changes the library name, so
    a stale build is never loaded."""
    from mo_yolo_tpu_torch.utils import cuda_build
    for f in cuda_build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    before = cuda_build.library_path("ms_deform_attn_fwd_v1")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    assert cuda_build.library_path("ms_deform_attn_fwd_v1") == before
    with open(tmp_path / "sampler_common.cuh", "a") as f:
        f.write("// changed\n")
    assert cuda_build.library_path("ms_deform_attn_fwd_v1") != before


def _grad_out(value, loc, seed=0):
    g = torch.Generator().manual_seed(seed)
    B, _, H, D = value.shape
    return torch.randn(B, loc.shape[1], H * D, generator=g).to(value.device)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_backward_kernel_matches_plain_on_card(card, case):
    """K2 against the plain gradient on the card, f32 and bf16."""
    from mo_yolo_tpu_torch.ops.deform_attn import (
        ms_deform_attn_backward, ms_deform_attn_backward_torch)
    value, shapes, loc, attn = _torch_inputs(case, card)
    g = _grad_out(value, loc)
    before = ms_deform_attn_backward.launches
    dv, dl, da = ms_deform_attn_backward(value, shapes, loc, attn, g)
    torch.cuda.synchronize()
    assert ms_deform_attn_backward.launches == before + 1
    wv, wl, wa = ms_deform_attn_backward_torch(value, shapes, loc, attn, g)
    torch.testing.assert_close(dl, wl, atol=BWD_F32_TOL, rtol=BWD_F32_TOL)
    torch.testing.assert_close(da, wa, atol=BWD_F32_TOL, rtol=BWD_F32_TOL)
    torch.testing.assert_close(dv, wv, atol=BWD_F32_TOL, rtol=DVALUE_RTOL)
    if case == "all_out_of_bounds":
        assert not dv.any() and not dl.any() and not da.any()
    vb, gb = value.to(torch.bfloat16), g.to(torch.bfloat16)
    dv, dl, da = ms_deform_attn_backward(vb, shapes, loc, attn, gb)
    assert dv.dtype == torch.bfloat16 and dl.dtype == da.dtype == \
        torch.float32
    wv, wl, wa = ms_deform_attn_backward_torch(vb.float(), shapes, loc, attn,
                                               gb.float())
    for got, want in ((dv.float(), wv), (dl, wl), (da, wa)):
        torch.testing.assert_close(got, want, atol=BF16_ATOL,
                                   rtol=BF16_RTOL)


@pytest.mark.gpu
def test_sampler_trains_through_both_kernels_on_card(card):
    """On a CUDA tensor that requires grad, the sampler's output has a
    grad_fn, its backward launches K2 once, and value, loc and attn get the
    plain version's gradients."""
    from mo_yolo_tpu_torch.ops.deform_attn import (ms_deform_attn,
                                                   ms_deform_attn_backward,
                                                   ms_deform_attn_torch)
    value, shapes, loc, attn = _torch_inputs("q70", card)
    g = _grad_out(value, loc, seed=1)
    grads = {}
    for name, fn in (("kernel", ms_deform_attn),
                     ("plain", ms_deform_attn_torch)):
        ins = [t.clone().requires_grad_(True) for t in (value, loc, attn)]
        out = fn(ins[0], shapes, ins[1], ins[2])
        assert out.grad_fn is not None
        before = ms_deform_attn_backward.launches
        out.backward(g)
        assert ms_deform_attn_backward.launches - before == \
            (1 if name == "kernel" else 0)
        grads[name] = [t.grad for t in ins]
    for got, want in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(got, want, atol=BWD_F32_TOL,
                                   rtol=DVALUE_RTOL)


def _clustered_inputs(device, Q=728, H=8, D=32, seed=5,
                      shapes=((80, 80), (40, 40), (20, 20))):
    """Every point in [0.45, 0.55], by default at 640x640's level shapes:
    the corners pile onto a few d_value rows, as training queries do."""
    value, shapes, loc, attn = rand_sampler_inputs(
        Q=Q, H=H, D=D, shapes=shapes, seed=seed)
    loc = np.random.default_rng(seed).uniform(0.45, 0.55, loc.shape)
    return (torch.from_numpy(value).to(device), shapes,
            torch.from_numpy(loc.astype(np.float32)).to(device),
            torch.from_numpy(attn).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["clustered", "d40_bf16"])
def test_backward_kernel_new_cases_on_card(card, case):
    """K2 on corners that pile onto few rows (hundreds of corners a row,
    rows that cross the reduce's chunks) and on D=40 bf16 rows (80 bytes:
    the element-a-lane kernels), against the plain gradient: f32 d_loc and
    d_attn 1e-5, d_value 1e-4 relative (each row summed in slot order,
    another order than the plain version's `index_add_`); bf16 1e-2."""
    from mo_yolo_tpu_torch.ops.deform_attn import (
        ms_deform_attn_backward, ms_deform_attn_backward_torch)
    if case == "clustered":
        value, shapes, loc, attn = _clustered_inputs(card)
        dtypes = (torch.float32, torch.bfloat16)
    else:
        value, shapes, loc, attn = rand_sampler_inputs(Q=33, H=2, D=40,
                                                       seed=40)
        value, loc, attn = (torch.from_numpy(a).to(card)
                            for a in (value, loc, attn))
        dtypes = (torch.bfloat16,)
    g = _grad_out(value, loc, seed=3)
    for dt in dtypes:
        v, gg = value.to(dt), g.to(dt)
        got = ms_deform_attn_backward(v, shapes, loc, attn, gg)
        want = ms_deform_attn_backward_torch(v.float(), shapes, loc, attn,
                                             gg.float())
        assert got[0].dtype == dt
        tols = (BWD_F32_TOL, DVALUE_RTOL) if dt == torch.float32 else \
            (BF16_ATOL, BF16_RTOL)
        for name, a, w in zip(("d_value", "d_loc", "d_attn"), got, want):
            tol = tols[1] if name == "d_value" else tols[0]
            scale = max(1.0, float(w.abs().max()))
            err = float((a.float() - w).abs().max())
            assert err <= tol * scale, (dt, name, err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["q70", "clustered"])
def test_backward_kernel_rows_equal_the_plain_rows_on_card(card, case):
    """K2's intermediates equal the plain rows form's exactly: the key of
    every corner slot, the row counts, their prefix sum start, and ids,
    every in-bounds slot once, by row and in ascending slot order within a
    row (the stable argsort's order, in which K2 sums each row)."""
    from mo_yolo_tpu_torch.ops.deform_attn import (
        _launch_bwd, ms_deform_attn_backward_rows_torch)
    if case == "clustered":
        value, shapes, loc, attn = _clustered_inputs(card, Q=96, H=2, D=16)
    else:
        value, shapes, loc, attn = _torch_inputs(case, card)
    g = _grad_out(value, loc, seed=4)
    *_, rows = _launch_bwd(value, shapes, loc, attn, g, rows=True)
    *_, want = ms_deform_attn_backward_rows_torch(value, shapes, loc, attn, g)
    assert torch.equal(rows["key"], want["key"])
    assert torch.equal(rows["counts"], want["counts"])
    assert torch.equal(rows["start"], want["start"])
    assert torch.equal(rows["ids"].long(), want["ids"])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["q70", "clustered"])
def test_backward_kernel_gives_the_same_gradient_every_call_on_card(card,
                                                                    case):
    """K2 sums each d_value row in slot order, so three calls on the same
    inputs give d_value, d_loc and d_attn equal bit for bit, in f32 and
    bf16, with corners spread out and piled onto a few rows."""
    from mo_yolo_tpu_torch.ops.deform_attn import ms_deform_attn_backward
    if case == "clustered":
        value, shapes, loc, attn = _clustered_inputs(card)
    else:
        value, shapes, loc, attn = _torch_inputs(case, card)
    g = _grad_out(value, loc, seed=6)
    for dt in (torch.float32, torch.bfloat16):
        v, gg = value.to(dt), g.to(dt)
        first, *again = [ms_deform_attn_backward(v, shapes, loc, attn, gg)
                         for _ in range(3)]
        torch.cuda.synchronize()
        for got in again:
            for a, b in zip(got, first):
                assert torch.equal(a, b), dt


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["unaligned_view", "d8", "d6"])
def test_kernel_other_rows_on_card(card, case):
    """K1 on rows the 16-byte pieces do not take (a value view one element
    off a 16-byte boundary, D=6) and on D=8, in f32 and bf16, against the
    plain version: f32 1e-5; bf16 1e-2."""
    from mo_yolo_tpu_torch.ops.deform_attn import (ms_deform_attn,
                                                   ms_deform_attn_torch)
    D = {"unaligned_view": 32, "d8": 8, "d6": 6}[case]
    value, shapes, loc, attn = rand_sampler_inputs(Q=50, H=3, D=D, seed=D)
    loc, attn = torch.from_numpy(loc).to(card), torch.from_numpy(attn).to(card)
    for dt in (torch.float32, torch.bfloat16):
        v = torch.from_numpy(value).to(card, dt)
        if case == "unaligned_view":
            flat = torch.empty(v.numel() + 1, dtype=dt, device=card)
            flat[1:] = v.reshape(-1)
            v = flat[1:].view(v.shape)
            assert v.is_contiguous() and v.data_ptr() % 16 != 0
        got = ms_deform_attn(v, shapes, loc, attn)
        want = ms_deform_attn_torch(v.float(), shapes, loc, attn)
        if dt == torch.float32:
            torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0)
        else:
            torch.testing.assert_close(got.float(), want, atol=BF16_ATOL,
                                       rtol=BF16_RTOL)


@pytest.mark.gpu
def test_no_grad_sampler_launches_k1_once_on_card(card):
    """Under `no_grad`, and with no input requiring grad, the sampler
    launches K1 once and builds no autograd node; with grad it still goes
    through the Function."""
    from mo_yolo_tpu_torch.ops.deform_attn import (ms_deform_attn,
                                                   ms_deform_attn_torch)
    value, shapes, loc, attn = _torch_inputs("q70", card)
    want = ms_deform_attn_torch(value, shapes, loc, attn)
    needs = value.clone().requires_grad_(True)
    for v, ctx in ((value, torch.enable_grad), (needs, torch.no_grad)):
        before = ms_deform_attn.launches
        with ctx():
            got = ms_deform_attn(v, shapes, loc, attn)
        assert ms_deform_attn.launches == before + 1
        assert got.grad_fn is None
        torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0)
    assert ms_deform_attn(needs, shapes, loc, attn).grad_fn is not None


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_kernel_matches_plain_on_card(card, case):
    """Kernel against the plain version on the card: f32 within 1e-5; bf16
    against the plain version in f32 on the same bf16 values."""
    from mo_yolo_tpu_torch.ops.deform_attn import (ms_deform_attn,
                                                   ms_deform_attn_torch)
    value, shapes, loc, attn = _torch_inputs(case, card)
    before = ms_deform_attn.launches
    got = ms_deform_attn(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert ms_deform_attn.launches == before + 1
    torch.testing.assert_close(got, ms_deform_attn_torch(value, shapes, loc,
                                                         attn),
                               atol=F32_ATOL, rtol=0)
    vb = value.to(torch.bfloat16)
    got = ms_deform_attn(vb, shapes, loc, attn)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), ms_deform_attn_torch(vb.float(), shapes, loc, attn),
        atol=BF16_ATOL, rtol=BF16_RTOL)


@pytest.mark.gpu
def test_kernel_main_path_shape_on_card(card):
    """B=1, Q=600, H=8, D=32 at 640x640's level shapes, bf16 value."""
    from mo_yolo_tpu_torch.ops.deform_attn import (ms_deform_attn,
                                                   ms_deform_attn_torch)
    value, shapes, loc, attn = rand_sampler_inputs(
        Q=600, H=8, D=32, shapes=((80, 80), (40, 40), (20, 20)), seed=7)
    value = torch.from_numpy(value).to(card, torch.bfloat16)
    loc, attn = torch.from_numpy(loc).to(card), torch.from_numpy(attn).to(card)
    got = ms_deform_attn(value, shapes, loc, attn)
    torch.testing.assert_close(
        got.float(), ms_deform_attn_torch(value.float(), shapes, loc, attn),
        atol=BF16_ATOL, rtol=BF16_RTOL)


@pytest.mark.gpu
def test_wrapper_raises_instead_of_falling_back(card):
    from mo_yolo_tpu_torch.ops.deform_attn import ms_deform_attn
    value, shapes, loc, attn = _torch_inputs("q10", card)
    with pytest.raises(ValueError):
        ms_deform_attn(value[:, :, :, ::2], shapes, loc, attn)
    with pytest.raises(TypeError):
        ms_deform_attn(value.double(), shapes, loc, attn)


@pytest.mark.gpu
def test_tiny_stream_kernel_against_plain_on_card(card):
    """tiny_track on the card: the stream through the kernel and through
    the plain sampler give the same ids and boxes within 1e-4."""
    from mo_yolo_tpu_torch.models.tracker import TrackerConfig, unpack_outputs
    from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
    from mo_yolo_tpu_torch.ops.deform_attn import ms_deform_attn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frames = np.random.default_rng(0).integers(0, 256, (4, 1, 64, 96, 3),
                                               dtype=np.uint8)
    outs = {}
    for impl in (None, "torch"):
        m = build_tracking_model("tiny_track", device=card, nq=32, impl=impl,
                                 tracker=TrackerConfig(n_slots=32))
        s = m.init_state(1)
        before = ms_deform_attn.launches
        outs[impl] = []
        for x in frames:
            s, o = m.stream_step(s, torch.from_numpy(x).to(card))
            outs[impl].append(unpack_outputs(o))
        launched = ms_deform_attn.launches - before
        assert launched == (6 * len(frames) if impl is None else 0)
    for k, p in zip(outs[None], outs["torch"]):
        np.testing.assert_allclose(k["box"], p["box"], atol=1e-4)
        near = (np.abs(p["score"] - 0.4) < 1e-3) | \
            (np.abs(p["score"] - 0.5) < 1e-3)
        if near.any():
            break
        np.testing.assert_array_equal(k["obj_id"], p["obj_id"])


# ------------------------------------------------- the study's kernels ----

# the study's variants: name -> (the port's wrapper, keywords)
VARIANTS = {"v1": ("v1", {}), "v2": ("v2", {}), "v3": ("v3", {}),
            "v4": ("v45", {"compact_cy": True}),
            "v5": ("v45", {"compact_cy": False}),
            "nocy": ("nocy", {}), "v6": ("v6", {}), "v7": ("v7", {}),
            "v8": ("v8", {})}
# S2-S4 compute in f32 inside; S5-S7 round where the TPU kernels do
F32_INSIDE = ("v1", "v2", "v3")
ROUNDING = tuple(v for v in VARIANTS if v not in F32_INSIDE)


def _no_plain_version(monkeypatch):
    """Make every plain version raise: a CUDA tensor must never reach one."""
    import mo_yolo_tpu_torch.ops.deform_attn_variants as dv
    import mo_yolo_tpu_torch.ops.gather as gather

    def forbidden(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")
    for name in ("fwd_v1_torch", "fwd_v2_torch", "fwd_v3_torch",
                 "_hat_sampler_torch", "fwd_v45_torch", "fwd_nocy_torch",
                 "fwd_v6_torch", "fwd_v7_torch", "fwd_v8_torch"):
        monkeypatch.setattr(dv, name, forbidden)
    monkeypatch.setattr(gather, "take_along_axis_torch", forbidden)
    monkeypatch.setattr(torch, "gather", forbidden)
    monkeypatch.setattr(torch, "index_select", forbidden)
    monkeypatch.setattr(torch.nn.functional, "grid_sample", forbidden)


@pytest.mark.gpu
@pytest.mark.parametrize("tq", [64, 128])
@pytest.mark.parametrize("variant", F32_INSIDE)
def test_variant_kernel_at_a_study_shape_on_card(card, monkeypatch, variant,
                                                 tq):
    """S2-S4 at the study's 640x640 inputs (Q=600, H=8, D=32), f32 within
    1e-5 of the plain sampler and of the variant's own plain version; bf16
    within the 1e-2 rule. The plain versions are computed first, then
    forbidden while the kernel runs."""
    import mo_yolo_tpu_torch.ops.deform_attn_variants as dv
    from mo_yolo_tpu_torch.ops.deform_attn import ms_deform_attn_torch
    from mo_yolo_tpu_torch.scripts.kernel_variants_bench import make_inputs
    value, shapes, loc, attn = make_inputs(
        640, 640, torch.Generator().manual_seed(0), dtype=torch.float32,
        device=card)
    want = ms_deform_attn_torch(value, shapes, loc, attn)
    own = getattr(dv, f"fwd_{variant}_torch")(value, shapes, loc, attn, TQ=tq)
    vb = value.to(torch.bfloat16)
    want_b = ms_deform_attn_torch(vb.float(), shapes, loc, attn)
    _no_plain_version(monkeypatch)
    fn = getattr(dv, f"fwd_{variant}")
    before = fn.launches
    got = fn(value, shapes, loc, attn, TQ=tq)
    got_b = fn(vb, shapes, loc, attn, TQ=tq)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0)
    torch.testing.assert_close(got, own, atol=F32_ATOL, rtol=0)
    assert got_b.dtype == torch.bfloat16
    torch.testing.assert_close(got_b.float(), want_b, atol=BF16_ATOL,
                               rtol=BF16_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
@pytest.mark.parametrize("variant", [v for v in VARIANTS if v != "nocy"])
def test_variant_kernel_edge_cases_on_card(card, monkeypatch, variant, case):
    """A partial last tile, nothing in bounds (exactly zero), a batch of
    two, D=8 rows, in f32 against the plain sampler (nocy computes another
    sum on purpose; its own test holds it to its plain version)."""
    import mo_yolo_tpu_torch.ops.deform_attn_variants as dv
    from mo_yolo_tpu_torch.ops.deform_attn import ms_deform_attn_torch
    name, kw = VARIANTS[variant]
    value, shapes, loc, attn = _torch_inputs(case, card)
    want = ms_deform_attn_torch(value, shapes, loc, attn)
    _no_plain_version(monkeypatch)
    got = getattr(dv, f"fwd_{name}")(value, shapes, loc, attn, TQ=64, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0)
    if case == "all_out_of_bounds":
        assert not got.any()


@pytest.mark.gpu
def test_variant_wrappers_raise_instead_of_falling_back(card, monkeypatch):
    import mo_yolo_tpu_torch.ops.deform_attn_variants as dv
    value, shapes, loc, attn = _torch_inputs("q10", card)
    _no_plain_version(monkeypatch)
    for fn in (dv.fwd_v1, dv.fwd_v2, dv.fwd_v3, dv.fwd_v45, dv.fwd_nocy,
               dv.fwd_v6, dv.fwd_v7, dv.fwd_v8):
        with pytest.raises(ValueError):
            fn(value[:, :, :, ::2], shapes, loc, attn)
        with pytest.raises(TypeError):
            fn(value.double(), shapes, loc, attn)
        with pytest.raises(ValueError):
            fn(value, shapes, loc, attn, TQ=0)
        if fn in (dv.fwd_v1, dv.fwd_v2, dv.fwd_v3, dv.fwd_v45, dv.fwd_v6,
                  dv.fwd_v7, dv.fwd_v8):
            # one warp per (b, q, h): no tile to stage, TQ is only checked
            assert torch.equal(fn(value, shapes, loc, attn, TQ=10 ** 6),
                               fn(value, shapes, loc, attn, TQ=64))
        else:
            with pytest.raises(ValueError):
                fn(value, shapes, loc, attn, TQ=10 ** 6)
    # a row that is no multiple of 16 bytes (24 bytes in f32): the kernels
    # on the main-path kernel's grid take it
    odd = torch.randn(1, value.shape[1], 2, 6, device=card)
    for fn in (dv.fwd_v1, dv.fwd_v2, dv.fwd_v3, dv.fwd_v7):
        assert fn(odd, shapes, loc, attn).shape == (1, 10, 12)
    # an odd D: nocy keeps the study interface's even D and raises; the
    # kernels on the main-path kernel's grid take it
    odd = torch.randn(1, value.shape[1], 2, 7, device=card)
    with pytest.raises(ValueError, match="even D"):
        dv.fwd_nocy(odd, shapes, loc, attn)
    for fn in (dv.fwd_v1, dv.fwd_v2, dv.fwd_v3, dv.fwd_v45, dv.fwd_v6,
               dv.fwd_v7, dv.fwd_v8):
        assert fn(odd, shapes, loc, attn).shape == (1, 10, 14)


@pytest.mark.gpu
@pytest.mark.parametrize("tq", [64, 128, 256])
@pytest.mark.parametrize("levels", ["1536x800", "small"])
@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v4", "v5", "v6",
                                     "v7", "v8"])
def test_warp_grid_kernels_on_clustered_points_on_card(card, monkeypatch,
                                                       variant, levels, tq):
    """The kernels on the main-path kernel's grid (v1-v3, v4/v5, v6-v8)
    with every point in [0.45, 0.55] at the study's 1536x800 levels and at
    the small ones (Q=600, H=8, D=32): at 6x8 every point of a level
    touches the same two rows, so v8's row groups have up to 2P members.
    f32 within 1e-5 of the plain sampler and of the variant's own plain
    version; bf16: v1-v3 (f32 inside) within the 1e-2 rule of both, the
    others (which round where the TPU kernels do) within one bf16 ulp at
    the output's scale of their own plain version on the same bf16
    operands. One launch a call."""
    import mo_yolo_tpu_torch.ops.deform_attn_variants as dv
    from mo_yolo_tpu_torch.ops.deform_attn import ms_deform_attn_torch
    from mo_yolo_tpu_torch.scripts.kernel_variants_bench import level_shapes
    shapes = level_shapes(800, 1536) if levels == "1536x800" else \
        ((12, 16), (6, 8), (3, 4))
    value, shapes, loc, attn = _clustered_inputs(card, Q=600, seed=7,
                                                 shapes=shapes)
    vb = value.to(torch.bfloat16)
    name, kw = VARIANTS[variant]
    plain = getattr(dv, f"fwd_{name}_torch")
    want = ms_deform_attn_torch(value, shapes, loc, attn)
    want_b = ms_deform_attn_torch(vb.float(), shapes, loc, attn)
    own = plain(value, shapes, loc, attn, TQ=tq, **kw)
    own_b = plain(vb if variant in ROUNDING else vb.float(), shapes, loc,
                  attn, TQ=tq, **kw).float()
    _no_plain_version(monkeypatch)
    fn = getattr(dv, f"fwd_{name}")
    before = fn.launches
    got = fn(value, shapes, loc, attn, TQ=tq, **kw)
    got_b = fn(vb, shapes, loc, attn, TQ=tq, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0)
    torch.testing.assert_close(got, own, atol=F32_ATOL, rtol=0)
    assert got_b.dtype == torch.bfloat16
    if variant in F32_INSIDE:
        for ref in (want_b, own_b):
            torch.testing.assert_close(got_b.float(), ref, atol=BF16_ATOL,
                                       rtol=BF16_RTOL)
    else:
        torch.testing.assert_close(
            got_b.float(), own_b, rtol=0,
            atol=2.0 ** -7 * max(1.0, float(own_b.abs().max())))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v4", "v5", "v6",
                                     "v7", "v8"])
def test_warp_grid_kernels_take_the_main_path_kernels_rows(card, variant):
    """v1-v3, v4/v5, v6, v7 and v8 carry a row and a warp's points as the
    main-path kernel does: D above 128 raises before any launch, and so
    does L*P above 64 (v8 takes at most 8 points, so at most 64 at 8
    levels)."""
    import mo_yolo_tpu_torch.ops.deform_attn_variants as dv
    name, kw = VARIANTS[variant]
    fn = getattr(dv, f"fwd_{name}")
    value, shapes, loc, attn = _torch_inputs("q10", card)
    before = fn.launches
    with pytest.raises(ValueError, match="D <= 128"):
        fn(torch.zeros(1, value.shape[1], 2, 136, device=card), shapes, loc,
           attn, **kw)
    wide = torch.rand(1, 10, 2, 3, 22, 2, device=card)
    with pytest.raises(ValueError, match="at most 8 points" if variant == "v8"
                       else "L\\*P <= 64"):
        fn(value, shapes, wide, wide[..., 0].contiguous(), **kw)
    assert fn.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_v4_and_v5_kernels_are_equal_bit_for_bit_on_card(card, monkeypatch,
                                                         dtype):
    """v4's compact y weights and v5's full-width ones are the same
    values, and the kernel runs one code path for both: equal outputs, bit
    for bit, at the study's 1536x800 inputs, on clustered points and with
    rows of one element a lane (D=6)."""
    import mo_yolo_tpu_torch.ops.deform_attn_variants as dv
    from mo_yolo_tpu_torch.scripts.kernel_variants_bench import (
        level_shapes, make_inputs)
    inputs = [make_inputs(800, 1536, torch.Generator().manual_seed(0),
                          dtype=dtype, device=card)]
    value, shapes, loc, attn = _clustered_inputs(
        card, Q=600, seed=7, shapes=level_shapes(800, 1536))
    inputs.append((value.to(dtype), shapes, loc, attn))
    value, shapes, loc, attn = _torch_inputs("q70", card)
    inputs.append((torch.randn(*value.shape[:3], 6, device=card).to(dtype),
                   shapes, loc, attn))
    _no_plain_version(monkeypatch)
    before = dv.fwd_v45.launches
    for value, shapes, loc, attn in inputs:
        v4 = dv.fwd_v45(value, shapes, loc, attn, compact_cy=True)
        v5 = dv.fwd_v45(value, shapes, loc, attn, compact_cy=False)
        torch.cuda.synchronize()
        assert v4.dtype == dtype and v4.abs().max() > 0
        assert torch.equal(v4, v5)
    assert dv.fwd_v45.launches == before + 2 * len(inputs)


@pytest.mark.gpu
@pytest.mark.parametrize("tq", [64, 128])
@pytest.mark.parametrize("variant", ROUNDING)
def test_new_variant_kernel_matches_its_plain_version_on_card(
        card, monkeypatch, variant, tq):
    """S5-S7 at Q=70, H=2, D=8 against their own plain versions: f32
    within 1e-5 (nocy's sums over whole columns: 1e-5 of max(1, its largest
    magnitude)); bf16 on the same bf16 operands within one bf16 ulp at the
    output's scale, 2^-7 of max(1, its largest magnitude), since kernel and
    plain version round to bf16 at the same places. Each call is one
    launch; nothing in bounds gives exactly zero."""
    import mo_yolo_tpu_torch.ops.deform_attn_variants as dv
    name, kw = VARIANTS[variant]
    plain, fn = getattr(dv, f"fwd_{name}_torch"), getattr(dv, f"fwd_{name}")
    value, shapes, loc, attn = _torch_inputs("q70", card)
    vb = value.to(torch.bfloat16)
    _, _, oloc, oattn = _torch_inputs("all_out_of_bounds", card)
    oval = torch.randn(1, value.shape[1], 2, 8, device=card)
    want = plain(value, shapes, loc, attn, TQ=tq, **kw)
    want_b = plain(vb, shapes, loc, attn, TQ=tq, **kw).float()
    _no_plain_version(monkeypatch)
    before = fn.launches
    got = fn(value, shapes, loc, attn, TQ=tq, **kw)
    got_b = fn(vb, shapes, loc, attn, TQ=tq, **kw)
    got_o = fn(oval, shapes, oloc, oattn, TQ=tq, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 3
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(
        got, want, rtol=0,
        atol=F32_ATOL * (scale if variant == "nocy" else 1.0))
    assert got_b.dtype == torch.bfloat16
    torch.testing.assert_close(
        got_b.float(), want_b, rtol=0,
        atol=2.0 ** -7 * max(1.0, float(want_b.abs().max())))
    assert got_o.shape == (1, 8, 16) and not got_o.any()


@pytest.mark.gpu
@pytest.mark.parametrize("S,N,axis,off", [
    (19200, 256, 0, 0), (8, 256, 0, 0), (256, 128, 1, 0), (256, 256, 1, 0),
    (19200, 250, 0, 0), (333, 250, 1, 0), (19200, 256, 0, 1),
    (257, 256, 1, 3)])
def test_take_along_axis_kernel_on_card(card, monkeypatch, S, N, axis, off):
    """S1 at the study's four shapes and in the forms without 16-byte
    groups: a row of 250 (S*N = 83,250 leaves a tail of two elements at
    [333, 250]) and views of v and idx `off` elements past a 16-byte
    boundary. Equal to the plain version and `torch.gather` exactly, one
    launch, no plain version or library gather on the way."""
    import mo_yolo_tpu_torch.ops.gather as gather
    from mo_yolo_tpu_torch.scripts.micro_peak_bench import gather_inputs
    v, idx = gather_inputs(S, N, axis, card)
    if off:
        v = torch.cat([v.new_zeros(off), v.flatten()])[off:].view(S, N)
        idx = torch.cat([idx.new_zeros(off), idx.flatten()])[off:].view(S, N)
        assert idx.data_ptr() % 16 != 0
    want = gather.take_along_axis_torch(v, idx, axis)
    assert torch.equal(want, torch.gather(v, axis, idx.long()))
    _no_plain_version(monkeypatch)
    before = gather.take_along_axis.launches
    got = gather.take_along_axis(v, idx, axis)
    torch.cuda.synchronize()
    assert gather.take_along_axis.launches == before + 1
    assert torch.equal(got, want)
    with pytest.raises(TypeError):
        gather.take_along_axis(v, idx.long(), axis)
    with pytest.raises(ValueError):
        gather.take_along_axis(v, idx[:, :8], axis)


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["640x640", "1536x800"])
def test_nocy_kernel_at_the_study_shapes_on_card(card, monkeypatch, size):
    """nocy's two launches (column sums, then the two-tap sampler over them)
    at the study's inputs against its own plain version: f32 within 1e-5 of
    max(1, its largest magnitude), bf16 on the same bf16 operands within one
    bf16 ulp at the output's scale (only the order of the f32 sums
    differs)."""
    import mo_yolo_tpu_torch.ops.deform_attn_variants as dv
    from mo_yolo_tpu_torch.scripts.kernel_variants_bench import make_inputs
    w, h = (int(n) for n in size.split("x"))
    for dt, ulp in ((torch.float32, F32_ATOL), (torch.bfloat16, 2.0 ** -7)):
        value, shapes, loc, attn = make_inputs(
            h, w, torch.Generator().manual_seed(0), dtype=dt, device=card)
        want = dv.fwd_nocy_torch(value, shapes, loc, attn).float()
        with monkeypatch.context() as m:
            _no_plain_version(m)
            got = dv.fwd_nocy(value, shapes, loc, attn)
            torch.cuda.synchronize()
        assert got.dtype == dt
        torch.testing.assert_close(
            got.float(), want, rtol=0,
            atol=ulp * max(1.0, float(want.abs().max())))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["frame", "random", "chain", "all_invalid",
                                  "any"])
def test_greedy_kernel_matches_plain_on_card(card, case):
    """The greedy-suppression kernel equals its plain version exactly at
    B=4, M=600 (yolo_track's 300 slots + 300 queries), in one launch, on
    `chip_smoke.greedy_inputs`' cases: a frame's duplicates, random
    conflicts, a chain of depth M, nothing valid, conflicts in both
    triangles."""
    from chip_smoke import greedy_inputs
    from mo_yolo_tpu_torch.ops.suppress import (
        greedy_keep_from_conflicts, greedy_keep_from_conflicts_torch)
    conflict, valid = greedy_inputs(case, device="cpu")
    want = greedy_keep_from_conflicts_torch(conflict, valid)
    before = greedy_keep_from_conflicts.launches
    got = greedy_keep_from_conflicts(conflict.to(card), valid.to(card))
    torch.cuda.synchronize()
    assert greedy_keep_from_conflicts.launches == before + 1
    assert got.dtype == torch.bool and torch.equal(got.cpu(), want)
    if case == "chain":
        assert torch.equal(got[0].cpu(), torch.arange(600) % 2 == 0)
    with pytest.raises(ValueError):      # too large for shared memory
        greedy_keep_from_conflicts(
            torch.zeros(1, 2000, 2000, dtype=torch.bool, device=card),
            torch.zeros(1, 2000, dtype=torch.bool, device=card))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 75, 1000])
def test_greedy_kernel_other_sizes_on_card(card, M):
    """The greedy kernel at sizes off the main path, exactly against its
    plain version: one element; M = 75 (no 4-byte rows: one column a thread
    while packing); M = 1000 (the rows staged in more than one round)."""
    from chip_smoke import greedy_inputs
    from mo_yolo_tpu_torch.ops.suppress import (
        greedy_keep_from_conflicts, greedy_keep_from_conflicts_torch)
    for case in ("random", "chain"):
        conflict, valid = greedy_inputs(case, b=2, m=M, device="cpu")
        want = greedy_keep_from_conflicts_torch(conflict, valid)
        got = greedy_keep_from_conflicts(conflict.to(card), valid.to(card))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), case


@pytest.mark.gpu
def test_stream_step_and_optimizer_step_make_no_host_sync_on_card(card):
    """A tiny_track stream (4 frames) and `ClipOptimizer.step` with the clip
    on (at half the gradients' norm) and off (at twice it) run with every
    host sync an error; the stream launches K1 six times and the greedy
    kernel once a frame."""
    import dataclasses

    from mo_yolo_tpu_torch.models.tracker import TrackerConfig
    from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
    from mo_yolo_tpu_torch.ops.deform_attn import ms_deform_attn
    from mo_yolo_tpu_torch.ops.suppress import greedy_keep_from_conflicts
    from mo_yolo_tpu_torch.train.train_step import (TrainConfig, global_norm,
                                                    make_optimizer)
    frames = np.random.default_rng(0).integers(0, 256, (4, 1, 64, 96, 3),
                                               dtype=np.uint8)
    m = build_tracking_model("tiny_track", device=card, nq=32,
                             tracker=TrackerConfig(n_slots=32))
    xs = [torch.from_numpy(x).to(card) for x in frames]
    s = m.init_state(1)
    s, _ = m.stream_step(s, xs[0])        # first use: builds, allocates
    k1, gk = ms_deform_attn.launches, greedy_keep_from_conflicts.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for x in xs:
            s, out = m.stream_step(s, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ms_deform_attn.launches - k1 == 6 * len(xs)
    assert greedy_keep_from_conflicts.launches - gk == len(xs)
    assert torch.isfinite(out).all()

    lin = torch.nn.Linear(8, 4).to(card)
    opt = make_optimizer(TrainConfig(), lin, nc=4)
    lin(torch.randn(16, 8, device=card)).pow(2).sum().mul(100).backward()
    norm = float(global_norm(p.grad for p in lin.parameters()))
    for clip in (norm / 2, norm * 2):
        opt.cfg = dataclasses.replace(opt.cfg, grad_clip=clip)
        count = opt.count
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            assert opt.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert opt.count == count + 1
    assert all(torch.isfinite(p).all() for p in lin.parameters())


@pytest.mark.gpu
def test_onehot_route_in_the_tiny_stream_on_card(card):
    """tiny_track on the card with impl="onehot": the plain sampler's ids
    and boxes within 1e-4, and no kernel launch."""
    from mo_yolo_tpu_torch.models.tracker import TrackerConfig, unpack_outputs
    from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
    from mo_yolo_tpu_torch.ops.deform_attn import ms_deform_attn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frames = np.random.default_rng(0).integers(0, 256, (4, 1, 64, 96, 3),
                                               dtype=np.uint8)
    outs = {}
    before = ms_deform_attn.launches
    for impl in ("onehot", "torch"):
        m = build_tracking_model("tiny_track", device=card, nq=32, impl=impl,
                                 tracker=TrackerConfig(n_slots=32))
        s = m.init_state(1)
        outs[impl] = []
        for x in frames:
            s, o = m.stream_step(s, torch.from_numpy(x).to(card))
            outs[impl].append(unpack_outputs(o))
    assert ms_deform_attn.launches == before
    for k, p in zip(outs["onehot"], outs["torch"]):
        np.testing.assert_allclose(k["box"], p["box"], atol=1e-4)
        near = (np.abs(p["score"] - 0.4) < 1e-3) | \
            (np.abs(p["score"] - 0.5) < 1e-3)
        if near.any():
            break
        np.testing.assert_array_equal(k["obj_id"], p["obj_id"])
