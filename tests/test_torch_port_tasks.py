"""The port's segment, pose and classify models and their data path
against the JAX package, at f32 on the CPU (tiny_track with nc=2 at 64x64,
random BatchNorm statistics; the JAX weights drawn with numpy from
`jax.eval_shape` of the init, so no init compiles):

- the graph rows SPP, ConvTranspose (k = s and flax's "SAME" k = 3, s = 2),
  Focus, GhostConv and C3, the taps' strides and the Segment head's
  width-scaled prototype channels, through a whole segmentation model;
- `predict_step` of each task (raw head outputs too): boxes within 1e-5
  of their scale, scores and keypoints within 1e-5, the same kept slots
  and classes; classify logits within 1e-6;
- `compose_masks` on both paths within 1e-5 (`jax.image.resize` bilinear
  against `F.interpolate(align_corners=False)`), and `nms_fixed` itself,
  class-aware and agnostic, past `max_det`;
- `SegDataset` (with and without `overlap_mask`, `mask_ratio` 4 and 2),
  `PoseDataset`, and the trainer's nearest resize of GT masks;
- the polygon rasterizer pixel for pixel against PIL, `decode_bmp`
  against PIL;
- the segment and pose metrics, and both validators end to end on a
  synthetic fixture (every metric within 1e-4).
"""

import functools
import struct
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_common import (ROOT, TINY_YAML, numpy_init,
                                     randomize_norms)

torch.set_num_threads(1)

NC = 2
HW = 64
MAX_DET = 20
SCALE_TOL = 1e-5


def _jax_model(task, spec, **kw):
    from mo_yolo_tpu.models import heads_extra as jh
    if task == "segment":
        return jh.SegmentationModel(spec=spec, max_det=MAX_DET, **kw)
    if task == "pose":
        return jh.PoseModel(spec=spec, max_det=MAX_DET, **kw)
    return jh.ClassifyModel(spec=spec, nc=spec.nc, **kw)


@functools.lru_cache(maxsize=None)
def pair(task, cfg=TINY_YAML, seed=0, **kw):
    """(JAX model, numpy variables, port model) of `task` on `cfg` with the
    same weights and random BatchNorm statistics."""
    from mo_yolo_tpu.models.graph import parse_model_yaml
    from mo_yolo_tpu_torch.models.heads_extra import build_task_model
    from mo_yolo_tpu_torch.utils.convert import state_dict_from_jax
    cfg_j = cfg if isinstance(cfg, str) else dict(cfg)
    spec = parse_model_yaml(cfg_j, nc=NC)
    jm = _jax_model(task, spec, **kw)
    v = randomize_norms(numpy_init(jax.eval_shape(
        jm.init, jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, 3))), seed),
        seed + 1)
    pkw = dict(kw)
    if task != "classify":
        pkw["max_det"] = MAX_DET
    pm = build_task_model(task, "tiny_track" if cfg == TINY_YAML else cfg,
                          nc=NC, device="cpu", **pkw)
    focus = tuple(n.index for n in pm.spec.nodes if n.module == "Focus")
    pm.load_state_dict(state_dict_from_jax(v, head_idx=pm.spec.head_index,
                                           focus_rows=focus), strict=True)
    return jm, v, pm


def _images(n=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, HW, HW, 3),
                                                dtype=np.uint8)


def _jax_in(x):
    return jnp.asarray(x.astype(np.float32) / 255.0)


def _close_scaled(got, want, what, tol=SCALE_TOL):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


# ------------------------------------------------------------------ rows

ROWS_CFG = {
    "nc": NC, "depth_multiple": 1.0, "width_multiple": 0.5,
    "backbone": [
        [-1, 1, "Focus", [32, 3]],                # 0  /2
        [-1, 1, "GhostConv", [48, 3, 2]],         # 1  /4
        [-1, 2, "C3", [48]],                      # 2  /4
        [-1, 1, "Conv", [64, 3, 2]],              # 3  /8
        [-1, 1, "SPP", [64, [3, 5, 7]]],          # 4  /8
        [-1, 1, "Conv", [64, 3, 2]],              # 5  /16
    ],
    "head": [
        [-1, 1, "ConvTranspose", [48, 2, 2]],     # 6  /8  (VALID)
        [[-1, 4], 1, "Concat", [1]],              # 7  /8
        [-1, 1, "ConvTranspose", [32, 3, 2]],     # 8  /4  (flax SAME)
        [[-1, 2], 1, "Concat", [1]],              # 9  /4
        [[9, 7, 5], 1, "Segment", ["nc", 8, 64]],  # 10
    ]}


def test_new_graph_rows_match_jax_through_a_segmentation_model():
    from mo_yolo_tpu.models.graph import parse_model_yaml as j_parse
    from mo_yolo_tpu_torch.models.graph import parse_model_yaml
    js, ps = j_parse(dict(ROWS_CFG)), parse_model_yaml(dict(ROWS_CFG))
    assert [(n.index, n.frm, n.module, n.repeats, n.out_channels)
            for n in ps.nodes] == [(n.index, n.frm, n.module, n.repeats,
                                    n.out_channels) for n in js.nodes]
    assert ps.out_strides == js.out_strides == (4, 8, 16)
    assert ps.head_args == js.head_args == (NC, 8, 32)   # 64 x 0.5
    jm, v, pm = pair.__wrapped__("segment", cfg=dict(ROWS_CFG))
    x = _images()
    want = jax.tree_util.tree_map(np.asarray, jm.apply(v, _jax_in(x)))
    with torch.no_grad():
        got = [t.numpy() for t in pm(torch.from_numpy(x))]
    for g, w, what in zip(got, want, ("boxes", "cls", "coef", "protos")):
        assert g.shape == w.shape, what
        _close_scaled(g, w, what)


# ---------------------------------------------------------- predict_step

@pytest.mark.parametrize("task", ["segment", "pose"])
def test_predict_step_matches_jax(task):
    jm, v, pm = pair(task)
    x = _images()
    raw_w = jax.tree_util.tree_map(np.asarray, jm.apply(v, _jax_in(x)))
    with torch.no_grad():
        raw_g = [t.numpy() for t in pm(torch.from_numpy(x))]
    for g, w in zip(raw_g, raw_w):
        _close_scaled(g, w, f"{task} raw")
    want = [np.asarray(a) for a in jax.jit(
        lambda v, x: jm.apply(v, x, method=jm.predict_step))(v, _jax_in(x))]
    got = [t.numpy() for t in pm.predict_step(torch.from_numpy(x))]
    wb, ws, wc, *wx = want
    gb, gs, gc, *gx = got
    kept = ws > 0
    assert 0 < kept.sum() and kept.sum(1).max() <= MAX_DET
    np.testing.assert_array_equal(gs > 0, kept)
    np.testing.assert_array_equal(gc[kept], wc[kept])
    assert (gc[~kept] == -1).all() and gc.dtype == np.int32
    _close_scaled(gb, wb, "boxes")
    np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)
    for g, w in zip(gx, wx):
        _close_scaled(g, w, f"{task} extras")


def test_classify_logits_match_jax():
    jm, v, pm = pair("classify")
    x = _images()
    want = np.asarray(jm.apply(v, _jax_in(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("retina", [False, True])
def test_compose_masks_match_jax(retina):
    jm, v, pm = pair("segment")
    jm = jm.clone(retina_masks=retina)
    x = _images()
    bb, ss, cc, cok, protos = pm.predict_step(torch.from_numpy(x))
    want = np.asarray(jm.apply(v, jnp.asarray(bb.numpy()),
                               jnp.asarray(cok.numpy()),
                               jnp.asarray(protos.numpy()),
                               method=jm.compose_masks))
    pm.retina_masks = retina
    try:
        got = pm.compose_masks(bb, cok, protos).numpy()
    finally:
        pm.retina_masks = False
    assert got.shape == want.shape == (2, MAX_DET, HW, HW)
    assert want.max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("agnostic", [False, True])
def test_nms_fixed_matches_jax(agnostic):
    """Past max_det, with ties in score and an extra payload."""
    from mo_yolo_tpu.models.detect import nms_fixed as j_nms
    from mo_yolo_tpu_torch.models.detect import nms_fixed
    rng = np.random.default_rng(5)
    N, max_det = 60, 8
    c = rng.uniform(10, 90, (2, N, 2))
    wh = rng.uniform(5, 30, (2, N, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, (2, N)), 1).astype(np.float32)
    cls = rng.integers(0, 3, (2, N)).astype(np.int32)
    extra = rng.normal(0, 1, (2, N, 5)).astype(np.float32)
    got = nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                    torch.from_numpy(cls), 0.3, 0.25, max_det,
                    (torch.from_numpy(extra),), agnostic)
    for b in range(2):
        want = j_nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                     jnp.asarray(cls[b]), 0.3, 0.25, max_det,
                     [jnp.asarray(extra[b])], agnostic)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
    assert got[3].sum(1).max() == max_det


# ------------------------------------------------------------- datasets

@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """Segment and pose fixtures at 64x64 (the input size, so no resize
    stands between the packages) and a classify tree."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    root = tmp_path_factory.mktemp("tasks")
    return {t: chip_smoke.task_fixture(root / t, t, n_train=3, n_val=3,
                                       hw=(HW, HW), nc=NC, n_obj=3)
            for t in ("segment", "pose", "classify")}


def _files(yaml_path, split="train"):
    from mo_yolo_tpu_torch.data.dataset import load_dataset_yaml
    return load_dataset_yaml(yaml_path)[split]


@pytest.mark.parametrize("overlap,ratio", [(True, 4), (False, 4),
                                           (True, 2)])
def test_seg_dataset_matches_jax(fixtures, overlap, ratio):
    from mo_yolo_tpu.train.task_trainers import SegDataset as JSeg
    from mo_yolo_tpu_torch.train.task_trainers import SegDataset
    files = _files(fixtures["segment"])
    js = JSeg(files, HW, max_gt=4, mask_ratio=ratio, overlap_mask=overlap)
    ps = SegDataset(files, HW, max_gt=4, mask_ratio=ratio,
                    overlap_mask=overlap)
    for i in range(len(files)):
        w, g = js.load(i), ps.load(i)
        np.testing.assert_array_equal(g[0], np.round(w[0] * 255))
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)
        assert g[4].shape[-1] == HW // ratio and g[4].sum() > 0


def test_pose_dataset_matches_jax(fixtures):
    from mo_yolo_tpu.train.task_trainers import PoseDataset as JPose
    from mo_yolo_tpu_torch.train.task_trainers import PoseDataset
    files = _files(fixtures["pose"])
    js, ps = JPose(files, HW, 17, max_gt=4), PoseDataset(files, HW, 17, 4)
    for i in range(len(files)):
        w, g = js.load(i), ps.load(i)
        np.testing.assert_array_equal(g[0], np.round(w[0] * 255))
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_allclose(a, b, atol=1e-5)


def test_gt_mask_resize_is_jax_nearest():
    """`mask_ratio` != 4: the trainer resizes GT masks to the prototypes'
    size as `jax.image.resize(..., "nearest")` does."""
    import torch.nn.functional as F
    m = (np.random.default_rng(0).uniform(size=(2, 3, 32, 32)) > 0.5
         ).astype(np.float32)
    for size in (16, 8, 64):
        want = np.asarray(jax.image.resize(jnp.asarray(m),
                                           (2, 3, size, size), "nearest"))
        got = F.interpolate(torch.from_numpy(m), size=(size, size),
                            mode="nearest-exact").numpy()
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------- rasterizer

def _pil_polygon(pts, size):
    from PIL import Image, ImageDraw
    img = Image.new("L", (size, size), 0)
    ImageDraw.Draw(img).polygon(pts, outline=1, fill=1)
    return np.asarray(img, bool)


@pytest.mark.parametrize("kind", ["star", "random", "integer", "repeat"])
def test_rasterizer_equals_pil(kind):
    """Star-shaped outlines (the labels' kind), random vertices (self-
    intersecting), integer vertices, in and out of the image, and integer
    vertices with one of them visited twice (where PIL pairs a sharp
    corner's edges by their order in its edge list), at sizes 8-63,
    every pixel equal to PIL's."""
    from mo_yolo_tpu.data.seg_pose_labels import rasterize_polygons as j_rast
    from mo_yolo_tpu_torch.data.seg_pose_labels import rasterize_polygons
    rng = np.random.default_rng(
        {"star": 0, "random": 1, "integer": 2, "repeat": 3}[kind])
    polys, sizes = [], []
    while len(polys) < 300:
        size = int(rng.integers(8, 64))
        n = int(rng.integers(3, 12))
        if kind == "star":
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            r = rng.uniform(0.05, 0.6, n)
            c = rng.uniform(0.1, 0.9, 2)
            p = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)
        elif kind == "random":
            p = rng.uniform(-0.1, 1.1, (n, 2))
        else:
            p = rng.integers(-2, size + 3, (n, 2)) / size
        if kind == "repeat":
            p = np.insert(p, int(rng.integers(0, n + 1)),
                          p[int(rng.integers(0, n))], 0)
        polys.append(p.astype(np.float32))
        sizes.append(size)
    for p, size in zip(polys, sizes):
        got = rasterize_polygons([p], size)[0]
        np.testing.assert_array_equal(got, j_rast([p], size)[0])
    pts = [(3.7, 2.2), (20.5, 4.9), (11.0, 18.0)]
    from mo_yolo_tpu_torch.data.seg_pose_labels import fill_polygon
    np.testing.assert_array_equal(
        fill_polygon(np.zeros((24, 24), bool), pts), _pil_polygon(pts, 24))


def test_label_parsers_match_jax(fixtures, tmp_path):
    from mo_yolo_tpu.data import seg_pose_labels as jl
    from mo_yolo_tpu_torch.data import seg_pose_labels as pl
    from mo_yolo_tpu_torch.data.dataset import img2label_path
    seg = img2label_path(_files(fixtures["segment"])[0])
    (tmp_path / "bad.txt").write_text("0 0.1 0.2\n1 0.1 0.2 0.3 0.4 0.5\n")
    for path in (seg, str(tmp_path / "bad.txt"), str(tmp_path / "none")):
        (wc, wp), (gc, gp) = jl.parse_seg_label(path), pl.parse_seg_label(path)
        np.testing.assert_array_equal(gc, wc)
        assert len(gp) == len(wp)
        for a, b in zip(gp, wp):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pl.polygons_to_boxes(gp),
                                      jl.polygons_to_boxes(wp))
    pose = img2label_path(_files(fixtures["pose"])[0])
    for path in (pose, str(tmp_path / "none")):
        for a, b in zip(pl.parse_pose_label(path, 17),
                        jl.parse_pose_label(path, 17)):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- BMP

def _bmp_bytes(img, bits, top_down=False, bitfields=False):
    """An uncompressed BMP of uint8 [H, W, 3] `img` (32-bit: X = 255)."""
    h, w, _ = img.shape
    step = bits // 8
    stride = (w * step + 3) // 4 * 4
    px = img[..., ::-1]
    if bits == 32:
        px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], -1)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * step] = px.reshape(h, -1)
    if not top_down:
        rows = rows[::-1]
    masks = struct.pack("<III", 0xFF0000, 0xFF00, 0xFF) if bitfields else b""
    offset = 54 + len(masks)
    header = struct.pack("<2sIHHI", b"BM", offset + rows.size, 0, 0, offset)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits,
                       3 if bitfields else 0, rows.size, 2835, 2835, 0, 0)
    return header + info + masks + rows.tobytes()


@pytest.mark.parametrize("w", [5, 6, 7, 8])
@pytest.mark.parametrize("bits,top_down,bitfields", [
    (24, False, False), (24, True, False), (32, False, False),
    (32, True, False), (32, False, True)])
def test_decode_bmp_matches_pil(tmp_path, w, bits, top_down, bitfields):
    from PIL import Image

    from mo_yolo_tpu_torch.data.decode import decode_bmp
    from mo_yolo_tpu_torch.data.loaders import load_image
    img = np.random.default_rng(w).integers(0, 256, (9, w, 3),
                                            dtype=np.uint8)
    path = tmp_path / "f.bmp"
    path.write_bytes(_bmp_bytes(img, bits, top_down, bitfields))
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(want, img)
    np.testing.assert_array_equal(decode_bmp(path.read_bytes()), want)
    np.testing.assert_array_equal(load_image(path), want)
    # and what PIL itself writes (24-bit RGB, 32-bit RGBA)
    Image.fromarray(img).save(tmp_path / "p.bmp")
    np.testing.assert_array_equal(load_image(tmp_path / "p.bmp"), img)


def test_other_bmp_and_webp_raise(tmp_path):
    """Palette BMPs and WebP frames decode to the JAX package's pixels
    (PIL's); a WebP whose chunks are cut short raises, as PIL refuses it."""
    from PIL import Image

    from mo_yolo_tpu.data.loaders import load_image as jax_load
    from mo_yolo_tpu_torch.data.loaders import load_image
    img = np.random.default_rng(1).integers(0, 256, (6, 7, 3), np.uint8)
    Image.fromarray(img).convert("P").save(tmp_path / "pal.bmp")
    Image.fromarray(img).save(tmp_path / "f.webp", quality=80)
    Image.fromarray(img).save(tmp_path / "l.webp", lossless=True)
    for name in ("pal.bmp", "f.webp", "l.webp"):
        np.testing.assert_array_equal(load_image(tmp_path / name),
                                      jax_load(str(tmp_path / name)))
    (tmp_path / "bad.webp").write_bytes(b"RIFF\0\0\0\0WEBPVP8 ")
    with pytest.raises(ValueError, match="WebP"):
        load_image(tmp_path / "bad.webp")


# --------------------------------------------------------------- metrics

def test_segment_and_pose_metrics_match_jax():
    from mo_yolo_tpu.metrics import segment_pose as jm
    from mo_yolo_tpu_torch.metrics import segment_pose as pm
    rng = np.random.default_rng(0)
    jseg, pseg = jm.SegmentMetrics(3), pm.SegmentMetrics(3)
    jpose, ppose = jm.PoseMetrics(3), pm.PoseMetrics(3)
    for _ in range(4):
        G, P = int(rng.integers(1, 5)), int(rng.integers(0, 7))
        c = rng.uniform(10, 50, (G, 2))
        gb = np.concatenate([c - 8, c + 8], 1)
        pb = np.concatenate([gb[rng.integers(0, G, P)] +
                             rng.normal(0, 3, (P, 4))])
        gcls, pcls = rng.integers(0, 3, G), rng.integers(0, 3, P)
        conf = rng.uniform(size=P)
        gm = rng.uniform(size=(G, 16, 16)) > 0.5
        pmk = np.concatenate([gm[rng.integers(0, G, P)] ^
                              (rng.uniform(size=(P, 16, 16)) > 0.9)])
        gk = np.concatenate([rng.uniform(0, 60, (G, 17, 2)),
                             rng.integers(0, 3, (G, 17, 1))], -1)
        pk = gk[rng.integers(0, G, P)] + rng.normal(0, 2, (P, 17, 3))
        np.testing.assert_allclose(pm.mask_iou_np(gm, pmk),
                                   jm.mask_iou_np(gm, pmk))
        areas = rng.uniform(50, 500, G)
        np.testing.assert_allclose(pm.oks_np(gk, pk, areas),
                                   jm.oks_np(gk, pk, areas))
        for j, p in ((jseg, pseg), (jpose, ppose)):
            extra = (pmk, gm) if j is jseg else (pk, gk)
            j.update(pb, extra[0], conf, pcls, gb, extra[1], gcls)
            p.update(pb, extra[0], conf, pcls, gb, extra[1], gcls)
    for j, p in ((jseg, pseg), (jpose, ppose)):
        w, g = j.compute(), p.compute()
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=1e-12, err_msg=k)


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_validator_matches_jax(fixtures, task):
    """The validators end to end on the fixture's val images, the same
    weights in both packages: every metric within 1e-4."""
    from mo_yolo_tpu.engine import validator as jv
    from mo_yolo_tpu_torch.engine import validator as pv
    jm, v, pm = pair(task)
    files = _files(fixtures[task], "val")
    jcls = jv.SegmentationValidator if task == "segment" \
        else jv.PoseValidator
    pcls = pv.SegmentationValidator if task == "segment" \
        else pv.PoseValidator
    want = jcls(jm, v, imgsz=HW)(files)
    got = pcls(pm, imgsz=HW)(files)
    assert set(got) == set(want)
    for k in want:
        if k != "fps":
            np.testing.assert_allclose(got[k], want[k], atol=1e-4,
                                       err_msg=k)
