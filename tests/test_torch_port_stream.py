"""PyTorch port vs the JAX package over a stream of frames: the
`stream_step` loop and the `TrackPredictor` (`mo_yolo_tpu_torch`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_common import TINY_NQ, build_pair

torch.set_num_threads(1)

# Shared score-head bias: random-init scores sit near the 0.4/0.5 tracker
# thresholds, where a 1e-6 difference could flip a birth or a drop. This
# bias puts every score in about 0.53-0.67 on these frames, so the margins
# asserted below hold by orders of magnitude over the f32 differences.
SCORE_BIAS = 0.3
SCORE_MARGIN = 1e-3   # from 0.4 and 0.5; frameworks differ by ~1e-6
IOU_MARGIN = 1e-4     # from the 0.8 duplicate threshold
BOX_ATOL = 1e-5       # f32, boxes in [0, 1]


@pytest.fixture(scope="module")
def pair():
    return build_pair(image_hw=(64, 96), score_bias=SCORE_BIAS)


def _static_scene(n, hw, seed=0):
    """A static scene: one random frame plus a little per-frame noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (*hw, 3)).astype(np.int16)
    return [np.clip(base + rng.integers(-3, 4, base.shape), 0,
                    255).astype(np.uint8) for _ in range(n)]


def _pairwise_iou(b):
    from mo_yolo_tpu_torch.ops.boxes import pairwise_iou, xywh2xyxy
    xy = xywh2xyxy(torch.tensor(b))
    return pairwise_iou(xy, xy).numpy()


def test_stream_step_loop_matches_jax(pair):
    """(f) ten stream_step frames on tiny_track with shared weights:
    obj_id sequences exactly equal, boxes within f32 tolerance."""
    from mo_yolo_tpu.models.tracker import init_track_state
    from mo_yolo_tpu.models.tracker import unpack_outputs as j_unpack
    from mo_yolo_tpu_torch.models.tracker import unpack_outputs
    jm, v, pm = pair
    step = jax.jit(lambda vv, s, x: jm.apply(vv, s, x, method=jm.stream_step))
    js = init_track_state(1, TINY_NQ, jm.hd)
    ts = pm.init_state(1)
    valid_per_frame, ids = [], []
    for x in _static_scene(10, (64, 96)):
        prev_active = np.asarray(js.obj_id[0]) >= 0
        js, jo = step(v, js, jnp.asarray(x[None]))
        ts, to = pm.stream_step(ts, torch.from_numpy(x[None]))
        jo = {k: a[0] for k, a in j_unpack(np.asarray(jo)).items()}
        to = {k: a[0] for k, a in unpack_outputs(to).items()}
        # margins first, so that a near-tie would fail here and not as a
        # mismatch below
        assert np.abs(jo["score"] - 0.4).min() > SCORE_MARGIN
        assert np.abs(jo["score"] - 0.5).min() > SCORE_MARGIN
        cand = np.concatenate([prev_active, jo["score"][TINY_NQ:] >= 0.4])
        iou = _pairwise_iou(jo["box"])[np.ix_(cand, cand)]
        assert np.abs(iou[np.triu_indices(cand.sum(), 1)] - 0.8).min() \
            > IOU_MARGIN
        np.testing.assert_array_equal(to["obj_id"], jo["obj_id"])
        np.testing.assert_array_equal(to["valid"], jo["valid"])
        np.testing.assert_array_equal(to["cls"], jo["cls"])
        np.testing.assert_allclose(to["box"], jo["box"], atol=BOX_ATOL)
        np.testing.assert_allclose(to["score"], jo["score"], atol=1e-5)
        valid_per_frame.append(int(jo["valid"].sum()))
        ids.append(set(jo["obj_id"][jo["valid"]].tolist()))
    for field in ("obj_id", "next_id", "disappear", "cls"):
        np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                      np.asarray(getattr(js, field)))
    np.testing.assert_allclose(ts.pred_box.numpy(), np.asarray(js.pred_box),
                               atol=BOX_ATOL)
    np.testing.assert_allclose(ts.embedding.numpy(), np.asarray(js.embedding),
                               atol=1e-4, rtol=1e-4)
    # tracks are born and carried: valid rows in most frames, and ids of
    # the first frame still alive at the last
    assert sum(n > 0 for n in valid_per_frame) >= 8
    assert len(ids[0] & ids[-1]) > 0


def test_track_predictor_matches_jax(pair, tmp_path):
    """(g) the port's TrackPredictor against the JAX TrackPredictor with
    device_preprocess=True on the same numpy frames. The frames are half
    the model input in each axis: an exact 2x bilinear upscale, where both
    letterboxes give the same bytes."""
    from mo_yolo_tpu.engine.predictor import TrackPredictor as JPredictor
    from mo_yolo_tpu_torch.engine.predictor import TrackPredictor
    jm, v, pm = pair
    frames = _static_scene(6, (32, 48), seed=2)
    jpred = JPredictor(jm, v, imgsz=(64, 96), conf=0.5,
                       device_preprocess=True)
    want = list(jpred.stream(frames, save_mot=str(tmp_path / "jax.txt")))
    tpred = TrackPredictor(pm, imgsz=(64, 96), conf=0.5, device="cpu")
    got = list(tpred.stream(frames, save_mot=str(tmp_path / "port.txt")))
    assert len(got) == len(want) == len(frames)
    assert sum(len(r) for r in want) > 0
    for g, w in zip(got, want):
        assert g.path == w.path and g.orig_shape == w.orig_shape
        np.testing.assert_array_equal(g.track_id, w.track_id)
        np.testing.assert_array_equal(g.cls, w.cls)
        # boxes in original pixels (48 wide): f32 box tolerance x 48
        np.testing.assert_allclose(g.boxes_xyxy, w.boxes_xyxy, atol=1e-3)
        np.testing.assert_allclose(g.conf, w.conf, atol=1e-5)
    rows = [np.loadtxt(tmp_path / n, delimiter=",", ndmin=2)
            for n in ("port.txt", "jax.txt")]
    assert rows[0].shape == rows[1].shape and len(rows[0]) > 0
    np.testing.assert_array_equal(rows[0][:, :2], rows[1][:, :2])
    np.testing.assert_allclose(rows[0], rows[1], atol=0.011)

    only_cls = list(TrackPredictor(pm, imgsz=(64, 96), conf=0.5,
                                   classes=[1], device="cpu").stream(frames))
    for g, r in zip(only_cls, got):
        np.testing.assert_array_equal(g.track_id, r.track_id[r.cls == 1])


def test_track_predictor_on_mixed_formats_matches_jax(pair, tmp_path):
    """The JAX TrackPredictor (device_preprocess=True) and the port's over
    one folder of 64x96 frames of the same static scene: CMYK JPEG (PIL's,
    quality 95), 16-bit big-endian Deflate TIFF with the predictor, and
    PIL's JPEG-compressed TIFF in turn, which the port decodes in its own
    C. Paths and frames equal, ids and classes equal, boxes within 1e-3,
    conf within 1e-5."""
    import importlib.util

    from PIL import Image

    from mo_yolo_tpu.engine.predictor import TrackPredictor as JPredictor
    from mo_yolo_tpu_torch.engine.predictor import TrackPredictor
    from tests.torch_port_common import ROOT
    spec = importlib.util.spec_from_file_location(
        "tiff_stream_fixtures", ROOT / "tests" / "data" / "tiff" /
        "make_fixtures.py")
    tf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tf)
    jm, v, pm = pair
    frames = _static_scene(6, (64, 96), seed=2)
    for i, img in enumerate(frames):
        if i % 3 == 0:
            cmyk = np.concatenate([255 - img, np.zeros_like(img[..., :1])],
                                  -1)
            Image.frombytes("CMYK", (96, 64), cmyk.tobytes()).save(
                tmp_path / f"{i:03d}.jpg", quality=95)
        elif i % 3 == 1:
            (tmp_path / f"{i:03d}.tif").write_bytes(tf.write_tiff(
                img.astype(np.int64) * 257 + 100, 2, bits=16, compression=8,
                predictor=2, order=">"))
        else:
            Image.fromarray(img).save(tmp_path / f"{i:03d}.tif",
                                      compression="jpeg")
    want = list(JPredictor(jm, v, imgsz=(64, 96), conf=0.5,
                           device_preprocess=True).stream(str(tmp_path)))
    got = list(TrackPredictor(pm, imgsz=(64, 96), conf=0.5,
                              device="cpu").stream(str(tmp_path)))
    assert len(got) == len(want) == len(frames)
    assert sum(len(r) for r in want) > 0
    for g, w in zip(got, want):
        assert g.path == w.path and g.orig_shape == w.orig_shape
        np.testing.assert_array_equal(g.orig_img, w.orig_img)
        np.testing.assert_array_equal(g.track_id, w.track_id)
        np.testing.assert_array_equal(g.cls, w.cls)
        np.testing.assert_allclose(g.boxes_xyxy, w.boxes_xyxy, atol=1e-3)
        np.testing.assert_allclose(g.conf, w.conf, atol=1e-5)


# the track configs beside yolo_track and tiny_track, each cut to YOLOv8-n
# multiples (its rows, class count and head row kept); yolo_mot ends in an
# RTDETRDecoder row and has one class, yolo_track_rare has a 1024-channel
# P5 (256 at this width)
OTHER_CONFIGS = ("yolo_track_n", "yolov8m_track", "yolo_track_rare",
                 "yolo_mot")


@pytest.mark.parametrize("name", OTHER_CONFIGS)
def test_other_track_configs_step_as_jax(name):
    """Three stream_step frames of each config at depth 0.33 and width
    0.25 (64x96 frames, nq and slots at TINY_NQ), weights drawn with numpy
    for both packages: ids, valid flags and classes equal, boxes within
    BOX_ATOL and scores within 1e-5, as the tiny_track loop above."""
    import yaml

    from mo_yolo_tpu.models.tracker import init_track_state
    from mo_yolo_tpu.models.tracker import unpack_outputs as j_unpack
    from mo_yolo_tpu_torch.models.tracker import unpack_outputs
    from tests.torch_port_common import ROOT
    with open(ROOT / "mo_yolo_tpu" / "cfg" / "models" / f"{name}.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["depth_multiple"], cfg["width_multiple"] = 0.33, 0.25
    # a single class takes no max over classes, so its scores sit ~0.06
    # lower: this bias lifts them over the 0.4 birth threshold, as
    # SCORE_BIAS does for five classes
    bias = SCORE_BIAS if cfg["nc"] > 1 else 0.6
    jm, v, pm = build_pair(image_hw=(64, 96), score_bias=bias, cfg=cfg,
                           compile_init=False)
    assert pm.spec.nc == cfg["nc"] == jm.spec.nc
    step = jax.jit(lambda vv, s, x: jm.apply(vv, s, x, method=jm.stream_step))
    js = init_track_state(1, TINY_NQ, jm.hd)
    ts = pm.init_state(1)
    n_valid = 0
    for x in _static_scene(3, (64, 96), seed=5):
        js, jo = step(v, js, jnp.asarray(x[None]))
        ts, to = pm.stream_step(ts, torch.from_numpy(x[None]))
        jo = {k: a[0] for k, a in j_unpack(np.asarray(jo)).items()}
        to = {k: a[0] for k, a in unpack_outputs(to).items()}
        assert np.isfinite(jo["box"]).all()
        assert np.abs(jo["score"] - 0.4).min() > SCORE_MARGIN
        assert np.abs(jo["score"] - 0.5).min() > SCORE_MARGIN
        np.testing.assert_array_equal(to["obj_id"], jo["obj_id"])
        np.testing.assert_array_equal(to["valid"], jo["valid"])
        np.testing.assert_array_equal(to["cls"], jo["cls"])
        np.testing.assert_allclose(to["box"], jo["box"], atol=BOX_ATOL)
        np.testing.assert_allclose(to["score"], jo["score"], atol=1e-5)
        n_valid += int(jo["valid"].sum())
    assert n_valid > 0
