"""Forwards of upstream's detector graphs (`tests/torch_port_zoo.py`) in
the port against the JAX package, f32 on the CPU, at narrow test widths:
the v3 graphs at depth 0.33 and width 0.25 (they have no `scales`), the
others at scale `n`, on 64x64 frames (128x128 for the stride-64 head of
v5-p6). The JAX variables are drawn with numpy from `jax.eval_shape` of
the init, with random BatchNorm statistics, converted with
`state_dict_from_jax` and loaded strictly.

Tolerances, f32: boxes, probabilities, mask coefficients and prototypes
within 1e-5 of each output's largest magnitude (as the YOLO-NAS tests);
classes and kept slots equal. The tracking step (a `tiny_track` capped by
a `scales` entry, nq 32: at 300 queries this input has fewer anchors than
queries and the JAX package returns NaN) holds the stream tests'
tolerances: obj_id, valid and cls equal, boxes and scores within 1e-5.

On the narrow v3 and v6 graphs the converter also equals the JAX
package's upstream-keyed export, and that export saved as a `.pt`
imports strictly (`utils/checkpoint.import_torch_weights`).

Also the port alone: `profile_layers` times the new row types, the v6
graph (raw ConvTranspose2d rows, ReLU) exports as `pt2` and loads equal
to the eager step, and the facades and the command line take a zoo
graph as a dict or a yaml path with `scale:`.
"""

import functools

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests.torch_port_common import (TINY_NQ, TINY_YAML, build_pair,
                                     numpy_init, randomize_norms)
from tests.torch_port_zoo import zoo

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def narrow(name, nc=3):
    """The graph at its test width."""
    if name.startswith("yolov3"):
        cfg = zoo(name, nc=nc)
        cfg.update(depth_multiple=0.33, width_multiple=0.25)
        return cfg
    return zoo(name, "n", nc=nc)


def _pair(cfg, hw, kind="detect", **kw):
    """(JAX model, numpy variables, port model) with one set of weights."""
    from mo_yolo_tpu.models.graph import parse_model_yaml as j_parse
    from mo_yolo_tpu.models.heads_extra import \
        SegmentationModel as JSegmentationModel
    from mo_yolo_tpu.models.nas import NASModel as JNASModel
    from mo_yolo_tpu_torch.models.heads_extra import build_task_model
    from mo_yolo_tpu_torch.models.nas import build_nas_model
    from mo_yolo_tpu_torch.utils.convert import state_dict_from_jax
    jcls = JNASModel if kind == "detect" else JSegmentationModel
    jm = jcls(spec=j_parse(cfg), **kw)
    v = randomize_norms(numpy_init(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3))), 0), 1)
    pm = build_nas_model(cfg, device="cpu", **kw) if kind == "detect" else \
        build_task_model(kind, cfg, device="cpu", **kw)
    pm.load_state_dict(state_dict_from_jax(v, head_idx=pm.spec.head_index),
                       strict=True)
    return jm, v, pm


@functools.lru_cache(maxsize=None)
def _era_pair(name):
    """`_pair` of an era's narrow graph, built once for the forward and
    the converter tests."""
    return _pair(narrow(name), 128 if "p6" in name else 64)


def _frames(hw, n=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, hw, hw, 3)).astype(np.float32)
    x[:, hw // 4:hw // 2, hw // 8:hw // 2, 0] = 1.0
    return x


# a graph of each era and row type: bare Bottleneck rows (v3), raw
# MaxPool2d and ZeroPad2d rows (v3-tiny), the padded k = 6 stem and a
# stride-64 level (v5-p6), ReLU, repeated Conv and raw ConvTranspose2d
# rows (v6), a stride-4 level (v8-p2)
ERAS = ["yolov3", "yolov3-tiny", "yolov5-p6", "yolov6", "yolov8-p2"]


def _jit(jm, method=None):
    return jax.jit(lambda v, x: jm.apply(v, x, method=method))


@pytest.mark.parametrize("name", ERAS)
def test_era_detector_forward_matches_jax(name):
    """`NASModel`'s boxes (xyxy pixels) and class probabilities over every
    level's anchors."""
    hw = 128 if "p6" in name else 64
    jm, v, pm = _era_pair(name)
    x = _frames(hw)
    jb, jc = _jit(jm)(v, jnp.asarray(x))
    with torch.no_grad():
        pb, pc = pm(torch.from_numpy(x))
    S = sum((hw // s) ** 2 for s in pm.spec.out_strides)
    assert pb.shape == (1, S, 4) and pc.shape == (1, S, 3)
    _close(pb.numpy(), np.asarray(jb), f"{name} boxes")
    _close(pc.numpy(), np.asarray(jc), f"{name} probabilities")


@pytest.mark.parametrize("name", ["yolov6", "yolov3"])
def test_converter_equals_the_jax_upstream_export_and_imports(name,
                                                              tmp_path):
    """On narrow v6 (raw ConvTranspose2d rows: their kernel flipped and
    laid out [in, out, kH, kW], their bias; repeated Conv rows at
    `model.{i}.{r}`) and v3 (bare Bottleneck rows, repeated and single)
    graphs: `state_dict_from_jax` gives the JAX package's
    `export_torch_state_dict`, key for key and value for value, and that
    export saved as an upstream `.pt` imports strictly into the port."""
    from mo_yolo_tpu.utils.checkpoint import export_torch_state_dict
    from mo_yolo_tpu_torch.utils.checkpoint import import_torch_weights
    from mo_yolo_tpu_torch.utils.convert import state_dict_from_jax
    _, v, pm = _era_pair(name)
    H = pm.spec.head_index
    got = {k: t for k, t in state_dict_from_jax(v, head_idx=H).items()
           if not k.endswith("num_batches_tracked")}
    want = export_torch_state_dict(v, head_idx=H)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    keys = set(pm.state_dict())
    if name == "yolov6":
        assert {"model.11.weight", "model.11.bias", "model.2.0.conv.weight",
                "model.2.1.bn.running_var"} <= keys
    elif name == "yolov3":
        assert {"model.2.cv1.conv.weight", "model.6.2.cv2.conv.weight",
                "model.11.cv1.conv.weight"} <= keys
    torch.save({"model": {k: torch.from_numpy(np.array(a)) for k, a in
                          want.items()}}, str(tmp_path / "up.pt"))
    rep = import_torch_weights(str(tmp_path / "up.pt"), pm, strict=True)
    assert not rep["missing"] and not rep["unexpected"]
    for k, t in pm.state_dict().items():
        if k in want:
            np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)


def _fake_outputs(xp, B, hi, wi, strides, nc):
    """Boxes and class probabilities that depend only on the anchor's
    index, its level and the input's size (`xp`: jnp or torch)."""
    counts = [(-(-hi // s)) * (-(-wi // s)) for s in strides]
    j = np.arange(sum(counts))
    lvl = np.repeat(np.arange(len(counts)), counts)
    cx = (j * 37 % 101) / 101 * wi
    cy = (j * 53 % 97) / 97 * hi
    half = (0.04 + 0.05 * lvl) * np.array([[wi], [hi]])
    box = np.stack([cx - half[0], cy - half[1], cx + half[0], cy + half[1]],
                   -1).astype(np.float32)
    cls = np.full((len(j), nc), 1e-6, np.float32)
    cls[j, j % nc] = 0.3 + 0.6 * (j * 29 % 89) / 89
    as_t = jnp.asarray if xp is jnp else torch.from_numpy
    return (as_t(np.broadcast_to(box, (B, *box.shape)).copy()),
            as_t(np.broadcast_to(cls, (B, *cls.shape)).copy()))


def test_four_level_tta_matches_jax():
    """`predict_step_tta` with four levels (v5-p6's strides 8-64) over a
    head whose outputs depend only on each anchor's index and level: the
    level counts drop the last level at full scale and the first at the
    smallest, as the JAX step does. The count of levels, not their
    strides, decides which the step drops. At 384² the port's sides
    (rounded to the largest stride, 64) and the JAX step's (rounded to 32)
    are the same, 320 and 256, so the two are held to each other; at other
    sizes the JAX step cannot run a stride-64 graph
    (`test_jax_tta_still_raises_on_a_stride64_graph`)."""
    from mo_yolo_tpu.models.graph import parse_model_yaml as j_parse
    from mo_yolo_tpu.models.nas import NASModel as JNASModel
    from mo_yolo_tpu_torch.models.graph import parse_model_yaml
    from mo_yolo_tpu_torch.models.nas import NASModel

    class JFake(JNASModel):
        def setup(self):
            pass

        def __call__(self, images, train=False, raw=False):
            B, hi, wi, _ = images.shape
            return _fake_outputs(jnp, B, hi, wi, self.spec.out_strides,
                                 self.spec.nc)

    class Fake(NASModel):
        def forward(self, images, raw=False):
            B, hi, wi, _ = images.shape
            return _fake_outputs(torch, B, hi, wi, self.spec.out_strides,
                                 self.spec.nc)

    cfg = narrow("yolov5-p6")
    jm = JFake(spec=j_parse(cfg), max_det=1000, conf=0.8)
    pm = Fake(parse_model_yaml(cfg), max_det=1000, conf=0.8)
    assert len(pm.spec.out_strides) == 4
    x = _frames(384, 2)
    want = jax.jit(lambda x: jm.apply({}, x, method=jm.predict_step_tta))(
        jnp.asarray(x))
    got = pm.predict_step_tta(torch.from_numpy(x))
    _close(got[0].numpy(), np.asarray(want[0]), "tta boxes")
    _close(got[1].numpy(), np.asarray(want[1]), "tta scores")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    kept = (got[1] > 0).sum(-1)
    assert 10 < int(kept.min()) and int(kept.max()) < 1000


# v5-p6's TTA sides at 640²: the scales 1, 0.83 and 0.67 rounded to its
# largest stride, 64 (531.2 -> 512, 428.8 -> 448); rounded to 32 the 0.83
# scale's 544 is no multiple of 64
P6_TTA_SIDES = (640, 512, 448)


def test_stride64_tta_is_the_union_of_the_plain_scales():
    """v5-p6's narrow graph (random weights) through `predict_step_tta` at
    640² on the CPU: equal to the union built here from the port's plain
    forward at each scale's side (P6_TTA_SIDES; bilinear antialiased
    resize, the 0.83 scale flipped and flipped back, boxes scaled back
    per axis, the full scale's last level and the smallest scale's first
    dropped), which the step then suppresses once (Queue 3 item 24)."""
    import torch.nn.functional as F
    _, _, pm = _era_pair("yolov5-p6")
    assert pm.spec.out_strides == (8, 16, 32, 64)
    x = torch.from_numpy(_frames(640))
    unions, nms = [], pm._nms_norm

    def spy(b, c, hw):
        unions.append((b, c, hw))
        return nms(b, c, hw)
    pm._nms_norm = spy
    try:
        got = pm.predict_step_tta(x)
    finally:
        del pm._nms_norm
    H = W = 640
    parts_b, parts_c = [], []
    for idx, (side, flip) in enumerate(zip(P6_TTA_SIDES,
                                           (False, True, False))):
        xi = x if side == H else F.interpolate(
            x.permute(0, 3, 1, 2), size=(side, side), mode="bilinear",
            align_corners=False, antialias=True).permute(0, 2, 3, 1)
        if flip:
            xi = torch.flip(xi, [2])
        with torch.no_grad():
            b, c = pm(xi)
        if flip:
            b = torch.stack([side - b[..., 2], b[..., 1], side - b[..., 0],
                             b[..., 3]], -1)
        b = b * (W / side)
        counts = [(side // s) ** 2 for s in pm.spec.out_strides]
        assert b.shape[1] == sum(counts)
        if idx == 0:
            b, c = b[:, :sum(counts[:-1])], c[:, :sum(counts[:-1])]
        if idx == len(P6_TTA_SIDES) - 1:
            b, c = b[:, counts[0]:], c[:, counts[0]:]
        parts_b.append(b)
        parts_c.append(c)
    (ub, uc, hw), = unions
    assert hw == (H, W)
    _close(ub.numpy(), torch.cat(parts_b, 1).numpy(), "p6 tta union boxes")
    _close(uc.numpy(), torch.cat(parts_c, 1).numpy(), "p6 tta union scores")
    assert got[0].shape == (1, pm.max_det, 4)
    assert np.isfinite(got[0].numpy()).all() and int((got[1] > 0).sum()) > 0


def test_jax_tta_still_raises_on_a_stride64_graph():
    """The JAX step rounds each TTA side to 32
    (`mo_yolo_tpu/models/nas.py:91-92`): at 640² the 0.83 scale's 544 px
    is no multiple of v5-p6's stride 64, and the graph's concatenation of
    an upsampled map (18²) with its lateral (17²) fails while the step is
    traced. The port rounds to the largest stride (Queue 3 item 24)."""
    jm, v, _ = _era_pair("yolov5-p6")
    with pytest.raises(TypeError, match="Cannot concatenate arrays"):
        jax.eval_shape(lambda v, x: jm.apply(v, x,
                                             method=jm.predict_step_tta),
                       v, jnp.zeros((1, 640, 640, 3)))


def test_segment_at_a_capped_width_matches_jax():
    """yolov8-seg at a test scale whose max_channels (128) caps the 256,
    512 and 1024 rows and the proto's 256 (to 32 at width 0.25): the
    four outputs of the head."""
    cfg = zoo("yolov8-seg", "t", nc=3)
    cfg["scales"]["t"] = [0.33, 0.25, 128]
    jm, v, pm = _pair(cfg, 64, "segment", max_det=8, conf=0.0)
    assert pm.spec.out_channels == (32, 32, 32)
    assert pm.spec.head_args == (3, 32, 32)
    x = _frames(64)
    want = _jit(jm)(v, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    for g, w, what in zip(got, want, ("boxes", "probabilities", "coef",
                                      "protos")):
        _close(g.numpy(), np.asarray(w), what)


def test_scaled_tiny_track_stream_step_matches_jax():
    """One `stream_step` of `tiny_track` under a `scales` entry whose
    max_channels (24) caps its 32-channel rows: the packed rows as the
    stream tests hold them."""
    from mo_yolo_tpu.models.tracker import init_track_state
    from mo_yolo_tpu.models.tracker import unpack_outputs as j_unpack
    from mo_yolo_tpu_torch.models.tracker import unpack_outputs
    with open(TINY_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg.update(scales={"t": [1.0, 1.5, 24]}, scale="t")
    jm, v, pm = build_pair(image_hw=(64, 96), score_bias=0.3, cfg=cfg,
                           compile_init=False)
    assert pm.spec.out_channels == (40, 40, 40)
    x = np.random.default_rng(0).integers(0, 256, (1, 64, 96, 3),
                                          dtype=np.uint8)
    _, jo = jax.jit(lambda v, s, x: jm.apply(v, s, x, method=jm.stream_step))(
        v, init_track_state(1, TINY_NQ, jm.hd), jnp.asarray(x))
    _, to = pm.stream_step(pm.init_state(1), torch.from_numpy(x))
    jo = {k: a[0] for k, a in j_unpack(np.asarray(jo)).items()}
    to = {k: a[0] for k, a in unpack_outputs(to).items()}
    assert jo["valid"].any()
    for k in ("obj_id", "valid", "cls"):
        np.testing.assert_array_equal(to[k], jo[k])
    np.testing.assert_allclose(to["box"], jo["box"], atol=1e-5)
    np.testing.assert_allclose(to["score"], jo["score"], atol=1e-5)


def test_profile_layers_times_the_new_rows():
    """`profile_layers` runs each row of v3-tiny (raw MaxPool2d and
    ZeroPad2d rows) and v6 (repeated Conv rows, raw ConvTranspose2d
    rows), with each row's output shape as the JAX spec has it."""
    from mo_yolo_tpu_torch.models.nas import build_nas_model
    from mo_yolo_tpu_torch.utils.profiling import profile_layers
    for name, mods in (("yolov3-tiny", {"MaxPool2d", "ZeroPad2d"}),
                       ("yolov6", {"ConvTranspose2dRaw", "Conv"})):
        pm = build_nas_model(narrow(name), device="cpu")
        rows = profile_layers(pm.model, torch.zeros((1, 64, 64, 3),
                                                    dtype=torch.uint8),
                              n_iter=1)
        assert [r["index"] for r in rows] == list(range(pm.spec.head_index))
        assert mods <= {r["module"] for r in rows}
        assert all(r["ms"] >= 0 and r["gflops"] >= 0 for r in rows)


def test_v6_pt2_export_equals_eager(tmp_path):
    """The v6 graph through `NAS`: `pt2` (one greedy op node) loads by
    `load_program` (`AutoBackend`'s loader of a `.pt2`) and equals the
    eager step bit for bit."""
    from mo_yolo_tpu_torch.models.nas import NAS
    from mo_yolo_tpu_torch.utils.program_export import (load_program,
                                                        op_counts)
    cfg = zoo("yolov6", "t", nc=3)          # depth 0.1: repeats 1-2
    cfg["scales"]["t"] = [0.1, 0.25, 1024]
    nas = NAS(cfg, imgsz=64, device="cpu")
    assert max(n.repeats for n in nas.model.spec.nodes) == 2
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (1, 64, 64, 3), dtype=np.uint8))
    eager = nas.model.predict_step(x)
    path = nas.export("pt2", path=str(tmp_path / "v6"))
    ep = load_program(path)
    assert op_counts(ep)["mo_yolo_tpu_torch.greedy_keep.default"] == 1
    for a, b in zip(ep.module()(x), eager):
        assert torch.equal(a, b)


def test_facades_and_cli_take_a_zoo_graph(tmp_path):
    """`NAS` and the `nas predict` command on a yaml path with `scale:`,
    `_TaskModel("segment")` on a dict, `MOTRTrack` on a dict and the
    `track predict` command on its yaml: each builds the parsed graph and
    predicts."""
    import logging

    from chip_smoke import write_png
    from mo_yolo_tpu_torch import MOTRTrack
    from mo_yolo_tpu_torch.api import _TaskModel
    from mo_yolo_tpu_torch.cli import main
    from mo_yolo_tpu_torch.models.graph import parse_model_yaml
    from mo_yolo_tpu_torch.models.nas import NAS
    from mo_yolo_tpu_torch.utils.logging import LOGGER
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(2):
        write_png(frames / f"{i:06d}.png", np.random.default_rng(i).integers(
            0, 256, (48, 64, 3), dtype=np.uint8))
    v5 = tmp_path / "yolov5.yaml"
    v5.write_text(yaml.safe_dump(zoo("yolov5", "n", nc=3)))
    nas = NAS(str(v5), imgsz=64, device="cpu")
    assert nas.model.spec == parse_model_yaml(zoo("yolov5", "n", nc=3))
    assert len(list(nas.predict(str(frames), conf=0.0))) == 2
    seg_cfg = zoo("yolov8-seg", "n", nc=3)
    seg = _TaskModel("segment", seg_cfg, imgsz=64, device="cpu")
    assert seg.model.spec == parse_model_yaml(seg_cfg)
    assert len(list(seg.predict(str(frames)))) == 2
    with open(TINY_YAML) as f:
        track_cfg = yaml.safe_load(f)
    track_cfg.update(scales={"t": [1.0, 1.5, 24]}, scale="t")
    tr = MOTRTrack(track_cfg, imgsz=192, device="cpu", dtype="float32")
    assert tr.model.spec.out_channels == (40, 40, 40)
    assert len(list(tr.predict(str(frames)))) == 2
    track_yaml = tmp_path / "track.yaml"
    track_yaml.write_text(yaml.safe_dump(track_cfg))
    lines = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    LOGGER.addHandler(handler)
    try:
        common = [f"source={frames}", "device=cpu", "conf=0.0"]
        assert main(["nas", "predict", f"model={v5}", "imgsz=64"] +
                    common) == 0
        assert main(["track", "predict", f"model={track_yaml}", "imgsz=192",
                     "amp=false", f"save_dir={tmp_path / 'run'}"] +
                    common) == 0
    finally:
        LOGGER.removeHandler(handler)
    assert sum("processed 2 frames" in m for m in lines) == 2
