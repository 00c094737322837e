"""The port's SAM and MobileSAM (`models/sam.py`, `models/sam_tiny.py`,
`utils/sam_import.py`, `utils/convert.sam_state_dict_from_jax`) against
the JAX package, f32 on the CPU, at the JAX tests' tiny size (img 64,
dim 32, depth 2, 2 heads, block 1 global, the other windowed; TinyViT at
its published widths on 64x64). The JAX weights are drawn with numpy
from `jax.eval_shape` of the init (no init compiles), every leaf random
(norm scales, BatchNorm statistics, embeddings, position tables), and
converted with `sam_state_dict_from_jax`, loaded strictly.

Tolerances, f32: encoder embeddings, IoU predictions and mask logits
within 1e-4 of each output's largest magnitude (the two packages sum in
other orders; the errors seen are ~1e-6 of it). Keep sets, counts and
thresholded masks are equal; scores within 1e-5.

Two JAX faults show here, each in its own test and in ROADMAP Queue 3:
- `_RelAttention` adds the width term of the decomposed relative
  positions over the query's columns (`mo_yolo_tpu/models/sam.py:81`,
  `bw[:, :, :, None, :]` broadcasts [B,n,h,w,k] as [B,n,h,1,w,k]); the
  port adds it as upstream does. The other parity tests draw `rel_pos_w`
  as zeros, so they hold every other part of the encoder.
- the JAX checkpoint import maps upstream's `ConvTranspose2d` kernels to
  flax without the flip in space (`mo_yolo_tpu/utils/sam_import.py:32`),
  so its mask logits differ from the port's upstream-correct load.

The facade tests run each package's own letterbox (the port's resize is
PIL's arithmetic, tests/test_torch_port_resample.py). The mask NMS
tests use distinct scores: `np.argsort(-s)` (the JAX loop)
is not stable and the port's sort is, so equal scores could order
differently.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_common import _map_leaves

torch.set_num_threads(1)

TOL = 1e-4
TINY = dict(dim=32, depth=2, num_heads=2, global_idx=(1,), window=3)
IMG = 64


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _jax_model(encoder="vit", window=3):
    from mo_yolo_tpu.models.sam import SAMModel
    if encoder == "tiny":
        return SAMModel(img_size=IMG, encoder="tiny")
    return SAMModel(img_size=IMG, **{**TINY, "window": window})


def jax_variables(jm, seed=0, rel_pos_w=False):
    """Numpy variables of the shapes of `jm`'s init, every leaf random;
    `rel_pos_w` zero unless asked for."""
    from mo_yolo_tpu.models.sam import PAD
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, 4, 2)),
                            jnp.full((1, 4), PAD, jnp.int32))
    rng = np.random.default_rng(seed)

    def fn(path, s):
        leaf = path[-1]
        if leaf == "kernel":
            a = rng.normal(0, np.prod(s.shape[:-1]) ** -0.5, s.shape)
        elif leaf == "scale":
            a = rng.uniform(0.8, 1.2, s.shape)
        elif leaf == "var":
            a = rng.uniform(0.5, 1.5, s.shape)
        elif leaf in ("bias", "mean"):
            a = rng.normal(0, 0.1, s.shape)
        elif leaf == "rel_pos_w" and not rel_pos_w:
            a = np.zeros(s.shape)
        else:        # embeddings, PE matrix, position tables, biases
            a = rng.normal(0, 0.5, s.shape)
        return a.astype(np.float32)
    return _map_leaves(shapes, fn)


@functools.lru_cache(maxsize=None)
def pair(encoder="vit", window=3, seed=0):
    """(JAX SAMModel, numpy variables, port SAMModel) with one set of
    weights."""
    from mo_yolo_tpu_torch.models.sam import build_sam
    from mo_yolo_tpu_torch.utils.convert import sam_state_dict_from_jax
    jm = _jax_model(encoder, window)
    v = jax_variables(jm, seed)
    kw = dict(encoder="tiny") if encoder == "tiny" else \
        {**TINY, "window": window}
    pm = build_sam(img_size=IMG, device="cpu", **kw)
    pm.load_state_dict(sam_state_dict_from_jax(v, depth=2, encoder=encoder),
                       strict=True)
    return jm, v, pm


def _image(seed=0, hw=(IMG, IMG)):
    return np.random.default_rng(seed).uniform(0, 1, (1, *hw, 3)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _embeds(encoder="vit", window=3, seed=0):
    """(JAX embedding, port embedding) of `_image(seed)`."""
    jm, v, pm = pair(encoder, window)
    x = _image(seed)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, method=jm.embed))(
        v, jnp.asarray(x)))
    got = pm.embed(torch.from_numpy(x)).numpy()
    return want, got


# ------------------------------------------------------------ encoders

@pytest.mark.parametrize("window", [3, 4])
def test_vit_encoder_matches_jax(window):
    """One global and one window block; window 3 pads the 4x4 grid to
    6x6 after norm1 and crops it back, window 4 does not pad."""
    want, got = _embeds("vit", window)
    assert got.shape == (1, 4, 4, 256)
    _close(got, want, f"ViT embedding, window {window}")


def test_rel_pos_width_term_is_upstreams_where_jax_broadcasts_it():
    """The port's relative positions against upstream's formula in numpy
    (`encoders.py` `add_decomposed_rel_pos`), with random height and width
    tables; the JAX `_RelAttention` agrees on the height term alone and
    differs by O(1) once the width table is non-zero (Queue 3)."""
    from mo_yolo_tpu.models.sam import _RelAttention
    from mo_yolo_tpu_torch.models.sam import RelAttention
    B, s, C, nh = 2, 4, 8, 2
    hd = C // nh
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, s, s, C)).astype(np.float32)
    p = {"qkv": {"kernel": rng.normal(0, C ** -0.5, (C, 3 * C)),
                 "bias": rng.normal(0, 0.1, 3 * C)},
         "proj": {"kernel": rng.normal(0, C ** -0.5, (C, C)),
                  "bias": rng.normal(0, 0.1, C)},
         "rel_pos_h": rng.normal(size=(2 * s - 1, hd)),
         "rel_pos_w": rng.normal(size=(2 * s - 1, hd))}
    p = _map_leaves(p, lambda _, a: np.asarray(a, np.float32))

    def upstream(p):
        qkv = (x.reshape(B, s * s, C) @ p["qkv"]["kernel"] + p["qkv"]["bias"]
               ).reshape(B, s * s, 3, nh, hd).transpose(2, 0, 3, 1, 4)
        q, k, v = qkv
        attn = (q * hd ** -0.5) @ k.transpose(0, 1, 3, 2)
        idx = np.arange(s)[:, None] - np.arange(s)[None, :] + s - 1
        rq = q.reshape(B, nh, s, s, hd)
        rel_h = np.einsum("bnhwc,hkc->bnhwk", rq, p["rel_pos_h"][idx])
        rel_w = np.einsum("bnhwc,wkc->bnhwk", rq, p["rel_pos_w"][idx])
        attn = (attn.reshape(B, nh, s, s, s, s) + rel_h[..., :, None] +
                rel_w[..., None, :]).reshape(B, nh, s * s, s * s)
        attn = np.exp(attn - attn.max(-1, keepdims=True))
        attn /= attn.sum(-1, keepdims=True)
        o = (attn @ v).transpose(0, 2, 1, 3).reshape(B, s, s, C)
        return o @ p["proj"]["kernel"] + p["proj"]["bias"]

    m = RelAttention(C, nh, s)
    with torch.no_grad():
        m.qkv.weight.copy_(torch.from_numpy(p["qkv"]["kernel"].T))
        m.qkv.bias.copy_(torch.from_numpy(p["qkv"]["bias"]))
        m.proj.weight.copy_(torch.from_numpy(p["proj"]["kernel"].T))
        m.proj.bias.copy_(torch.from_numpy(p["proj"]["bias"]))
        m.rel_pos_h.copy_(torch.from_numpy(p["rel_pos_h"]))
        m.rel_pos_w.copy_(torch.from_numpy(p["rel_pos_w"]))
        got = m(torch.from_numpy(x)).numpy()
    want = upstream(p)
    _close(got, want, "port rel-pos attention against upstream's")
    jm = _RelAttention(C, nh, s)
    h_only = dict(p, rel_pos_w=np.zeros_like(p["rel_pos_w"]))
    _close(np.asarray(jm.apply({"params": h_only}, jnp.asarray(x))),
           upstream(h_only), "JAX, height term only")
    jax_out = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    assert np.abs(jax_out - want).max() > 0.1 * np.abs(want).max()


def test_tinyvit_matches_jax():
    want, got = _embeds("tiny")
    assert got.shape == (1, 4, 4, 256)
    _close(got, want, "TinyViT embedding")


@pytest.mark.parametrize("ws", [7, 14])
def test_tinyvit_bias_index_equals_jax(ws):
    from mo_yolo_tpu.models.sam_tiny import _bias_index
    from mo_yolo_tpu_torch.models.sam_tiny import bias_index
    (gi, gn), (wi, wn) = bias_index(ws), _bias_index(ws)
    assert gn == wn
    np.testing.assert_array_equal(gi, wi)


# ------------------------------------------------------ prompt and mask

def _prompts():
    pts = np.array([[[10, 20], [30, 40], [5, 5], [0, 0]],
                    [[1, 2], [60, 3], [0, 0], [0, 0]],
                    [[33, 33], [0, 0], [0, 0], [0, 0]]], np.float32)
    lab = np.array([[1, 0, 2, -1], [2, 3, -1, -1], [1, -1, -1, -1]],
                   np.int32)
    mask = np.random.default_rng(2).normal(size=(3, 16, 16, 1)).astype(
        np.float32)
    return pts, lab, mask


@pytest.mark.parametrize("with_mask", [False, True])
def test_prompt_encoder_matches_jax(with_mask):
    """Sparse and dense embeddings; with a mask input the gate picks the
    down-scaled mask for rows 0 and 2 and the no-mask embedding for row
    1, which then equals the no-mask path."""
    jm, v, pm = pair()
    pts, lab, mask = _prompts()
    has = np.array([True, False, True])
    jargs = (jnp.asarray(pts), jnp.asarray(lab)) + (
        (jnp.asarray(mask), jnp.asarray(has)) if with_mask else ())
    pargs = (torch.from_numpy(pts), torch.from_numpy(lab)) + (
        (torch.from_numpy(mask), torch.from_numpy(has)) if with_mask else ())
    want = jm.apply(v, *jargs,
                    method=lambda m, *a: m.prompt_encoder(*a))
    with torch.no_grad():
        got = [t.detach() for t in pm.prompt_encoder(*pargs)]
        no = pm.prompt_encoder(*pargs[:2])[1].detach().numpy()
    for g, w, what in zip(got, want, ("sparse", "dense")):
        _close(g.numpy(), np.asarray(w), what)
    if with_mask:
        np.testing.assert_array_equal(got[1][1].numpy(), no[1])
        assert np.abs(got[1][0].numpy() - no[0]).max() > 1e-3
    dpe = jm.apply(v, method=lambda m: m.prompt_encoder.dense_pe())
    _close(pm.prompt_encoder.dense_pe().detach().numpy(), np.asarray(dpe),
           "dense PE")


@pytest.mark.parametrize("encoder", ["vit", "tiny"])
def test_mask_decoder_matches_jax(encoder):
    """`decode` from the JAX embedding: the four mask slots' logits and
    the IoU predictions, with and without a gated mask input."""
    jm, v, pm = pair(encoder)
    pts, lab, mask = _prompts()
    emb = np.array(_embeds(encoder)[0][0])
    has = np.array([True, False, True])
    decode = jax.jit(lambda v, *a: jm.apply(v, *a, method=jm.decode))
    for extra in ((), (mask, has)):
        want = decode(v, jnp.asarray(emb), jnp.asarray(pts),
                      jnp.asarray(lab), *map(jnp.asarray, extra))
        got = pm.decode(torch.from_numpy(emb), torch.from_numpy(pts),
                        torch.from_numpy(lab), *map(torch.from_numpy, extra))
        assert got[0].shape == (3, 4, 16, 16) and got[1].shape == (3, 4)
        _close(got[0].numpy(), np.asarray(want[0]), "mask logits")
        _close(got[1].numpy(), np.asarray(want[1]), "IoU predictions")


# ------------------------------------------------------------- facades

@functools.lru_cache(maxsize=None)
def facades(encoder="vit"):
    """(JAX SAM, port SAM) on one set of weights, max_points 4."""
    from mo_yolo_tpu.models.sam import SAM as JSAM
    from mo_yolo_tpu_torch.models.sam import SAM
    jm, v, pm = pair(encoder)
    kw = dict(encoder="tiny") if encoder == "tiny" else TINY
    js = JSAM(img_size=IMG, max_points=4, variables=v, **kw)
    ps = SAM(img_size=IMG, max_points=4, device="cpu", **kw)
    ps.model.load_state_dict(pm.state_dict())
    return js, ps


def _uint8(seed, hw):
    return (np.random.default_rng(seed).uniform(0, 1, (*hw, 3)) * 255
            ).astype(np.uint8)


@pytest.mark.parametrize("prompt", ["points", "box", "mixed"])
def test_sam_call_matches_jax_on_a_letterboxed_image(prompt):
    """`SAM.__call__` on a 48x40 image (letterboxed with x padding):
    prompts mapped through the letterbox, the best multimask slot, its
    low-res logits, IoU and the bilinear up-scaled mask; then the cached
    embedding reused without an image; `multimask=False` takes slot 0."""
    js, ps = facades()
    img = _uint8(0, (48, 40))
    kw = {"points": dict(points=[[20, 20], [8, 30]], labels=[1, 0]),
          "box": dict(bboxes=[[4, 4, 30, 40], [10, 2, 38, 20]]),
          "mixed": dict(points=[[20, 20]], bboxes=[[4, 4, 30, 30]])}[prompt]
    for first in (True, False):
        for multimask in (True, False):
            im = img if first else None
            want = js(image=im, multimask=multimask, **kw)
            got = ps(image=im, multimask=multimask, **kw)
            _close(got["low_res"], want["low_res"], "low-res logits")
            _close(got["iou"], want["iou"], "IoU")
            assert got["meta"] == want["meta"]
            # the up-scaled mask, equal but where the port's own logit is
            # within tolerance of 0
            up = torch.nn.functional.interpolate(
                torch.from_numpy(got["low_res"])[:, None], size=(IMG, IMG),
                mode="bilinear", align_corners=False)[:, 0].numpy()
            sure = np.abs(up) > TOL * np.abs(up).max()
            np.testing.assert_array_equal(got["masks"][sure],
                                          want["masks"][sure])
    emb, _ = ps._emb_cache
    assert emb.shape == (4, 4, 256) and emb.device.type == "cpu"


def _distinct(scores):
    assert len(np.unique(scores)) == len(scores), "equal scores"


@pytest.mark.parametrize("crop_layers,nms_iou", [(0, 0.5), (1, 0.3)])
def test_generate_matches_jax(crop_layers, nms_iou):
    """Everything mode (grid 2, every mask kept by the filters): the same
    masks kept in the same order, scores within 1e-5; with crop layer 1
    the four crops' masks pasted back by the nearest resize."""
    js, ps = facades()
    img = _uint8(3, (64, 80))
    kw = dict(grid=2, iou_thresh=-10.0, stability_thresh=0.0,
              nms_iou=nms_iou, crop_layers=crop_layers)
    want, got = js.generate(img, **kw), ps.generate(img, **kw)
    _distinct(want["scores"])
    assert 0 < len(got["masks"]) < (4 if crop_layers else 1) * 12
    np.testing.assert_array_equal(got["masks"], want["masks"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5)
    # the same masks before suppression
    everything = ps.generate(img, **{**kw, "nms_iou": 1.1})
    assert len(everything["masks"]) == (5 if crop_layers else 1) * 12


def test_mask_nms_at_the_threshold_equals_the_jax_loop(monkeypatch):
    """Both `generate`s on the same masks (their grid pass replaced): a
    pair at IoU exactly 0.7 (kept), pairs just above it (suppressed), a
    chain A-B-C where B is suppressed so C survives, an empty mask, and
    random masks; the port's keep set equals the JAX host loop's, and the
    port's plain loop (`greedy_mask_nms_np`) too."""
    from mo_yolo_tpu_torch.models.sam import greedy_mask_nms_np, mask_nms
    js, ps = facades()
    rng = np.random.default_rng(0)
    m = np.zeros((12, 16, 16), bool)
    m[0, :7, 0] = True                      # inter 7 / union 10 = 0.7
    m[1, :10, 0] = True
    m[2, :8, 1] = True                      # 8 / 11 > 0.7 with m[3]
    m[3, :11, 1] = True
    m[4, 0:10, 2] = True                    # chain: 4 blocks 5, 5 would
    m[5, 2:12, 2] = True                    # block 6, so 6 survives
    m[6, 5:15, 2] = True
    m[8:] = rng.uniform(size=(4, 16, 16)) < 0.5     # m[7] stays empty
    s = rng.permutation(12).astype(np.float32) / 12 + 0.01
    meta = {"gain": (1.0, 1.0), "pad": (0, 0), "orig_shape": (IMG, IMG),
            "scale_fill": False}
    monkeypatch.setattr(js, "_grid_masks", lambda *a: (m, s, meta))
    monkeypatch.setattr(ps, "_grid_masks", lambda *a: (
        torch.from_numpy(m), torch.from_numpy(s), meta))
    img = np.zeros((IMG, IMG, 3), np.uint8)
    for thr in (0.7, 0.69, 0.5):
        want, got = js.generate(img, nms_iou=thr), ps.generate(img,
                                                              nms_iou=thr)
        np.testing.assert_array_equal(got["masks"], want["masks"])
        np.testing.assert_array_equal(got["scores"], want["scores"])
        kept = greedy_mask_nms_np(m, s, thr)
        np.testing.assert_array_equal(mask_nms(
            torch.from_numpy(m), torch.from_numpy(s), thr).numpy(), kept)
        np.testing.assert_array_equal(m[kept], want["masks"])


def test_text_prompt_matches_jax():
    """`text_prompt` end to end with the JAX tests' mock embedder (mean
    colour against colour words): the same best mask and text scores."""
    from tests.test_fastsam import MeanColorEmbedder
    js, ps = facades()
    img = np.zeros((IMG, IMG, 3), np.uint8)
    img[4:20, 4:20, 0] = 220
    img[36:60, 36:60, 1] = 220
    kw = dict(grid=2, iou_thresh=-10.0, stability_thresh=0.0, nms_iou=0.5)
    for text in ("red", "green"):
        want = js.text_prompt(img, text, embedder=MeanColorEmbedder(), **kw)
        got = ps.text_prompt(img, text, embedder=MeanColorEmbedder(), **kw)
        np.testing.assert_array_equal(got["masks"], want["masks"])
        np.testing.assert_allclose(got["text_scores"], want["text_scores"],
                                   atol=1e-6)
        assert got["masks"].shape[0] == 1


def test_text_prompt_without_an_embedder_names_what_it_needs(monkeypatch):
    import builtins
    from mo_yolo_tpu_torch.models.fastsam import clip_embedder
    real = builtins.__import__

    def no_transformers(name, *a, **kw):
        if name.startswith("transformers"):
            raise ImportError("No module named 'transformers'")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(RuntimeError, match="transformers.*CLIP"):
        clip_embedder()


# --------------------------------------------------- variants, import

def test_variant_table_and_aliases():
    """The b/l/h table equals the JAX one; every alias builds the encoder
    the JAX `build_sam` builds; SAM-B and MobileSAM at full width hold the
    keys and shapes of the JAX models' converted variables (strict)."""
    from mo_yolo_tpu.models import sam as jsam
    from mo_yolo_tpu_torch.models import sam as psam
    from mo_yolo_tpu_torch.utils.convert import sam_state_dict_from_jax
    assert psam._VARIANTS == jsam._VARIANTS
    for alias in ("b", "vit_b", "l", "h", "t", "tiny", "vit_t", "mobile",
                  "mobile_sam"):
        assert jsam.build_sam(alias, img_size=IMG).encoder == (
            "tiny" if alias in ("t", "tiny", "vit_t", "mobile", "mobile_sam")
            else "vit")
    for alias, enc in (("b", "vit"), ("mobile", "tiny")):
        jm = jsam.build_sam(alias, img_size=IMG)
        shapes = jax.eval_shape(
            jm.init, jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
            jnp.zeros((1, 4, 2)), jnp.full((1, 4), jsam.PAD, jnp.int32))
        sd = sam_state_dict_from_jax(
            _map_leaves(shapes, lambda _, s: np.zeros(s.shape, np.float32)),
            depth=jm.depth, encoder=enc)
        pm = psam.build_sam(alias, img_size=IMG, device="cpu")
        assert pm.encoder == enc
        pm.load_state_dict(sd, strict=True)
    with pytest.raises(ValueError, match="ViT blocks"):
        sam_state_dict_from_jax(pair()[1], depth=12)


def upstream_state_dict(model, seed=0, rel_pos_w=False):
    """A seeded upstream-keyed state_dict (numpy) of the port model's own
    keys, plus the buffers a real checkpoint carries that the import
    skips."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, t in model.state_dict().items():
        shape = tuple(t.shape)
        if k.endswith("num_batches_tracked"):
            a = np.array(7)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("rel_pos_w") and not rel_pos_w:
            a = np.zeros(shape)
        elif k.endswith(".weight") and len(shape) >= 2 and \
                "embed" not in k and "tokens" not in k:
            fan = np.prod(shape[1:]) if "upscaling" not in k else \
                shape[0] * np.prod(shape[2:])
            a = rng.normal(0, fan ** -0.5, shape)
        elif k.endswith(".weight") and len(shape) == 1:
            a = rng.uniform(0.8, 1.2, shape)
        else:
            a = rng.normal(0, 0.5 if "bias" not in k else 0.1, shape)
        sd[k] = a.astype(np.int64 if k.endswith("tracked") else np.float32)
    sd["pixel_mean"] = np.zeros((3, 1, 1), np.float32)
    sd["pixel_std"] = np.ones((3, 1, 1), np.float32)
    return sd


def test_sam_import_strict_and_its_errors(tmp_path):
    """A seeded upstream-keyed state_dict loads strictly from a dict, a
    path and a file:// URL (the skipped buffers aside); a missing key, an
    unused key and a wrong shape raise, naming the tensor."""
    from mo_yolo_tpu_torch.utils.sam_import import import_sam_torch_weights
    _, _, pm = pair("tiny")
    import copy
    m = copy.deepcopy(pm)
    sd = upstream_state_dict(m, seed=3)
    sd["image_encoder.layers.1.blocks.0.attn.attention_bias_idxs"] = \
        np.zeros((49, 49), np.int64)
    rep = import_sam_torch_weights(m, sd)
    assert not rep["missing"] and not rep["unused"]
    for k, t in m.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(t.numpy(), sd[k], err_msg=k)
    path = tmp_path / "mobile_sam.pt"
    torch.save({"model": {k: torch.from_numpy(np.asarray(a))
                          for k, a in sd.items()}}, str(path))
    for src in (str(path), f"file://{path}"):
        m2 = copy.deepcopy(pm)
        import_sam_torch_weights(m2, src)
        for k, t in m2.state_dict().items():
            assert torch.equal(t, m.state_dict()[k]), k
    missing = {k: a for k, a in sd.items() if "neck.3.bias" not in k}
    with pytest.raises(ValueError, match="neck.3.bias"):
        import_sam_torch_weights(copy.deepcopy(pm), missing)
    rep = import_sam_torch_weights(copy.deepcopy(pm), missing, strict=False)
    assert rep["missing"] == ["image_encoder.neck.3.bias"]
    with pytest.raises(ValueError, match="unused.*extra.weight"):
        import_sam_torch_weights(copy.deepcopy(pm),
                                 {**sd, "extra.weight": np.zeros(3)})
    bad = dict(sd, **{"mask_decoder.iou_token.weight": np.zeros((2, 256))})
    with pytest.raises(ValueError, match="shape mismatch.*iou_token"):
        import_sam_torch_weights(copy.deepcopy(pm), bad, strict=False)
    with pytest.raises(ValueError, match="local path"):
        import_sam_torch_weights(copy.deepcopy(pm), "https://x/sam.pt")


def test_jax_sam_import_mirrors_the_transposed_convs():
    """One seeded upstream-keyed state_dict into both packages: the JAX
    import (`import_sam_torch_weights`) and the port's agree on the image
    embedding and the IoU predictions, but not on the mask logits, since
    the JAX import leaves the two up-scaling kernels unflipped; converted
    back, the JAX variables hold exactly those kernels mirrored, and the
    port loaded from them agrees with JAX everywhere. (`rel_pos_w` is
    zero here: its own fault has the test above.)"""
    import copy

    from mo_yolo_tpu.utils.sam_import import import_sam_torch_weights as jimp
    from mo_yolo_tpu_torch.utils.convert import sam_state_dict_from_jax
    from mo_yolo_tpu_torch.utils.sam_import import import_sam_torch_weights
    jm, v, pm = pair()
    sd = upstream_state_dict(pm, seed=5)
    jv = jimp(v, sd, depth=2, strict=True)
    port = copy.deepcopy(pm)
    import_sam_torch_weights(port, sd)
    x = _image(2)
    pts, lab, _ = _prompts()
    je = np.array(jax.jit(lambda v, x: jm.apply(v, x, method=jm.embed))(
        jv, jnp.asarray(x)))
    pe = port.embed(torch.from_numpy(x)).numpy()
    _close(pe, je, "embedding")
    jmask, jiou = jax.jit(lambda v, *a: jm.apply(v, *a, method=jm.decode))(
        jv, jnp.asarray(je[0]), jnp.asarray(pts), jnp.asarray(lab))
    pmask, piou = port.decode(torch.from_numpy(je[0]), torch.from_numpy(pts),
                              torch.from_numpy(lab))
    _close(piou.numpy(), np.asarray(jiou), "IoU")
    jmask = np.asarray(jmask)
    assert np.abs(pmask.numpy() - jmask).max() > 0.05 * np.abs(jmask).max()
    back = sam_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jv),
                                   depth=2)
    ups = {f"mask_decoder.output_upscaling.{i}.weight" for i in (0, 3)}
    for k, t in back.items():
        want = np.flip(sd[k], (2, 3)) if k in ups else sd[k]
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(t.numpy(), want, err_msg=k)
    mirrored = copy.deepcopy(pm)
    mirrored.load_state_dict(back, strict=True)
    _close(mirrored.decode(torch.from_numpy(je[0]), torch.from_numpy(pts),
                           torch.from_numpy(lab))[0].numpy(), jmask,
           "mask logits, JAX's kernels")
