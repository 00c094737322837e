"""The port's detection family (`models/detect.py`, `train/detect_trainer.py`,
`DetectionValidator`, the `Detector`/`YOLO` facades and the `detect`
task of the CLI) against the JAX package, at f32 on the CPU.

- `DetectionModel.predict_step` at the JAX test's sizes (`tiny_track`,
  hd 32, nq 16, two decoder layers, d_ffn 32, 64x64, random BatchNorm):
  boxes within BOX_ATOL, scores within 1e-5, classes equal wherever the
  top-2 logit gap is above 1e-4;
- one detection training step at the JAX slow test's sizes (nq 12, two
  layers, d_ffn 64, two GT boxes), and one of that image and a second
  with one GT box and one padded row, the CDN noise drawn once by the JAX
  package's key splits and handed to the port: every loss term, the
  gradient norm and the per-tensor gradients, then the updated
  parameters, BatchNorm statistics and EMA, within the tolerances of
  `test_torch_port_train_step.py`. The image is the slow test's squares
  on a noisy background: on its flat grey one the JAX BatchNorm's
  variance cancels (ROADMAP Queue 3 item 5), which a test of its own
  shows against an f64 evaluation;
- `DetectionValidator` on 160x160 PNG frames with the predict-step
  weights: every metric within 1e-4, the same COCO records and hybrid
  label rows (values within the last printed digit);
- the facade and the CLI on the CPU: save and load, the `params` and `pt`
  exports, the JAX formats naming the port's (`pt2`, `graph`), `track`,
  `YOLO` routing, `detect predict` on a saved model (and without a card
  the device message), a one-trial `detect tune`.
"""

import copy
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.test_torch_port_train_step import (GRAD_TOL, LOSS_RTOL,
                                              OFFSETS_GRAD_TOL, TENSOR_TOL)
from tests.torch_port_common import TINY_YAML, numpy_init, randomize_norms

torch.set_num_threads(1)

# the port's f32 gradient norm against its own f64 evaluation of the step
# (measured 3e-4 relative)
GRAD_NORM_RTOL = 1e-3

BOX_ATOL = 1e-5
HEAD_IDX = 21           # tiny_track's head row
HD, NDL = 32, 2
METRIC_ATOL = 1e-4
LR = 1e-4


def _pair(nq, d_ffn, hw=64, seed=0):
    """(JAX DetectionModel, numpy variables, port DetectionModel) of
    tiny_track with shared weights (drawn with numpy: no init compiles)
    and random BatchNorm."""
    from mo_yolo_tpu.models.detect import DetectionModel as JDetectionModel
    from mo_yolo_tpu.models.graph import parse_model_yaml
    from mo_yolo_tpu_torch.models.detect import build_detection_model
    from mo_yolo_tpu_torch.utils.convert import state_dict_from_jax
    jm = JDetectionModel(spec=parse_model_yaml(TINY_YAML), hd=HD, nq=nq,
                         ndl=NDL, d_ffn=d_ffn)
    v = randomize_norms(numpy_init(jax.eval_shape(
        jm.init, jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 3))), seed),
        seed + 1)
    pm = build_detection_model("tiny_track", device="cpu", hd=HD, nq=nq,
                               ndl=NDL, d_ffn=d_ffn)
    pm.load_state_dict(state_dict_from_jax(v, head_idx=HEAD_IDX,
                                           detect=True), strict=True)
    return jm, v, pm


@pytest.fixture(scope="module")
def pair():
    return _pair(nq=16, d_ffn=32)


def test_predict_step_matches_jax(pair):
    jm, v, pm = pair
    x = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                          dtype=np.uint8)
    want = jax.jit(lambda v, x: jm.apply(v, x, method=jm.predict_step))(
        v, jnp.asarray(x.astype(np.float32) / 255.0))
    got = pm.predict_step(torch.from_numpy(x))
    wb, ws, wc = (np.asarray(a) for a in want)
    gb, gs, gc = (t.numpy() for t in got)
    assert gb.shape == (2, 16, 4) and gs.shape == gc.shape == (2, 16)
    assert np.isfinite(wb).all() and ((wb >= 0) & (wb <= 1)).all()
    np.testing.assert_allclose(gb, wb, atol=BOX_ATOL, rtol=0)
    np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)
    with torch.no_grad():
        logits = pm(torch.from_numpy(x))["dec_scores"][-1].numpy()
    top2 = np.sort(logits, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(gc[clear], wc[clear])


# ------------------------------------------------------------ training step

def _batch(hw=64, noise=0.2, B=1):
    """The JAX slow test's batch: two coloured squares, both GT, on grey
    with uniform noise of +-`noise` (0: the slow test's flat grey). With
    B=2 a second image (its own noise) holds one square of another class
    at another place: one GT row and one padded row."""
    rng = np.random.default_rng(0)
    imgs = np.concatenate([np.clip(0.3 + rng.uniform(
        -noise, noise, (1, hw, hw, 3)), 0, 1) for _ in range(B)]
    ).astype(np.float32)
    boxes = np.zeros((B, 2, 4), np.float32)
    for i, k, (cx, cy) in [(0, 0, (20, 24)), (0, 1, (44, 40)),
                           (1, 2, (30, 46))][:2 + (B > 1)]:
        imgs[i, cy - 6:cy + 6, cx - 6:cx + 6, k] = 1.0
        boxes[i, k % 2] = [cx / hw, cy / hw, 12 / hw, 12 / hw]
    mask = np.ones((B, 2), bool)
    mask[1:, 1] = False
    return {"images": imgs, "gt_cls": np.array([[0, 1], [2, 0]][:B],
                                               np.int32),
            "gt_boxes": boxes, "gt_mask": mask}


def _recording(tx):
    """`tx` that also keeps the gradient it was given in its state."""
    def init(params):
        return {"inner": tx.init(params),
                "grads": jax.tree.map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        u, s = tx.update(grads, state["inner"], params)
        return u, {"inner": s, "grads": grads}
    return optax.GradientTransformation(init, update)


def _jax_noise(key, B, G, nc, num_denoising=100):
    """What `build_cdn_group(key, ...)` draws, by its key splits
    (`mo_yolo_tpu/ops/denoising.py:69`)."""
    from mo_yolo_tpu_torch.ops.denoising import CDNNoise, cdn_sizes
    _, num_dn = cdn_sizes(G, num_denoising)
    kcls, ksign, kpart, kflip = jax.random.split(key, 4)

    def t(a):
        return torch.from_numpy(np.array(a))
    return CDNNoise(
        flip=t(jax.random.uniform(kflip, (B, num_dn)) < 0.25),
        rand_cls=t(jax.random.randint(kcls, (B, num_dn), 0, nc)),
        sign=t(jnp.where(jax.random.uniform(ksign, (B, num_dn, 4)) < 0.5,
                         -1.0, 1.0)),
        part=t(jax.random.uniform(kpart, (B, num_dn, 4))))


@functools.lru_cache(maxsize=None)
def _step_runs(B):
    """The JAX step and the port's on `_batch(B=B)` from the same weights
    and CDN noise: (JAX results, the port's, the f32/f64 evaluations of the
    port's loss and gradient norm, the batch's GT count). The flat-grey
    evaluations are made for B=1 only."""
    from mo_yolo_tpu.train import train_step as jts
    from mo_yolo_tpu.train.detect_trainer import \
        make_detect_train_step as j_make
    from mo_yolo_tpu.train.losses import LossConfig as JLossConfig
    from mo_yolo_tpu_torch.train import detect_trainer as pdt
    from mo_yolo_tpu_torch.train import train_step as pts
    from mo_yolo_tpu_torch.train.losses import LossConfig
    from mo_yolo_tpu_torch.train.train_step import global_norm
    jm, v, pm = _pair(nq=12, d_ffn=64)
    nc = jm.spec.nc
    batch = _batch(B=B)
    key = jax.random.PRNGKey(3)
    images = {"noisy": batch}
    if B == 1:
        images["flat"] = _batch(noise=0.0)

    jt = jts.TrainConfig(lr=LR, warmup_steps=2, total_steps=10)
    init_fn, step_fn = j_make(jm, JLossConfig(nc=nc), jt,
                              tx=_recording(jts.make_optimizer(jt, nc=nc)))
    jstep = jax.jit(step_fn)
    f64 = {}
    if B == 1:
        _, m_flat = jstep(init_fn(v), {k: jnp.asarray(a) for k, a in
                                       images["flat"].items()}, key)
        f64["flat", "jax"] = (float(m_flat["loss"]),
                              float(m_flat["grad_norm"]))
    ts, m = jstep(init_fn(v), {k: jnp.asarray(a) for k, a in batch.items()},
                  key)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)    # noqa: E731
    want = {"metrics": {k: float(a) for k, a in m.items()},
            "grads": np_(ts.opt_state["grads"]), "params": np_(ts.params),
            "ema": np_(ts.ema_params), "batch_stats": np_(ts.batch_stats)}

    G = batch["gt_mask"].shape[1]
    noise = _jax_noise(key, B, G, nc, pm.num_denoising)
    # f32 and f64 evaluations of copies of the port model: the loss on
    # each image set, the gradient norm on the noisy one
    for dt in (torch.float32, torch.float64):
        nz = noise._replace(sign=noise.sign.to(dt), part=noise.part.to(dt))
        for name, b in images.items():
            m = copy.deepcopy(pm).to(dt).train()
            tb = {k: torch.from_numpy(a) for k, a in b.items()}
            tb["images"] = tb["images"].to(dt)
            loss = pdt.detect_loss_fn(m, LossConfig(nc=nc), tb, nz)[0]
            loss.backward()
            f64[name, dt] = (float(loss.detach()), float(global_norm(
                p.grad for p in m.parameters())))

    def jax_noise(generator, b, g, n_cls, num_denoising, device=None):
        assert (b, g, n_cls, num_denoising) == (B, G, nc, pm.num_denoising)
        return noise
    pt = pts.TrainConfig(lr=LR, warmup_steps=2, total_steps=10)
    p_init, p_step = pdt.make_detect_train_step(pm, LossConfig(nc=nc), pt)
    pts_ = p_init()
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pdt, "draw_cdn_noise", jax_noise)
        pts_, pm_ = p_step(pts_, tb, None)
    got = {"metrics": {k: float(a) for k, a in pm_.items()},
           "grads": {n: p.grad.clone() if p.grad is not None else
                     torch.zeros_like(p) for n, p in pm.named_parameters()},
           "params": {n: p.detach().clone()
                      for n, p in pm.named_parameters()},
           "ema": {n: e.clone() for n, e in pts_.ema.items()},
           "buffers": {n: b.clone() for n, b in pm.named_buffers()}}
    return want, got, f64, int(batch["gt_mask"].sum())


@pytest.fixture(scope="module", params=[1, 2], ids=["b1", "b2"])
def step_runs(request):
    """`_step_runs` of one image (the slow test's) and of two."""
    return _step_runs(request.param)


def _sd(tree, collection="params"):
    from mo_yolo_tpu_torch.utils.convert import state_dict_from_jax
    return state_dict_from_jax({collection: tree}, head_idx=HEAD_IDX,
                               detect=True)


def _close(got, want, what, tol, extra=0.0):
    assert set(got) == set(want), what
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        assert np.isfinite(g).all(), (what, k)
        t = tol(k) if callable(tol) else tol
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= t * scale + extra, f"{what} {k}: {err} > {t} x {scale}"


def _offsets(t):
    return lambda name: OFFSETS_GRAD_TOL if "sampling_offsets" in name else t


def test_detect_train_step_loss_terms_match_jax(step_runs):
    """Every loss term within LOSS_RTOL of the JAX step's. The gradient
    norm: the port's within GRAD_NORM_RTOL of its own f64 evaluation, the
    JAX one's within GRAD_TOL of the port's. The backbone's gradients carry
    most of the norm here, and the JAX BatchNorm's variance on the 2x2 P5
    map puts them ~2.4e-3 off (ROADMAP Queue 3 item 5; measured: the
    port's f32 norm 3e-4 from f64, the JAX one 2.1e-3), the same fault
    that sets GRAD_TOL for each gradient tensor."""
    (want, got), (f64, n_obj) = (r["metrics"] for r in step_runs[:2]), \
        step_runs[2:]
    assert set(got) == set(want)
    assert {"loss_class", "loss_bbox_aux", "loss_giou_enc",
            "loss_class_dn_aux", "num_objects", "grad_norm"} <= set(got)
    for k, w in want.items():
        if k != "grad_norm":
            np.testing.assert_allclose(got[k], w, rtol=LOSS_RTOL, atol=1e-6,
                                       err_msg=k)
    assert want["loss"] > 0 and want["num_objects"] == n_obj
    ref = f64["noisy", torch.float64]
    np.testing.assert_allclose(got["loss"], ref[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], ref[1], rtol=GRAD_NORM_RTOL)
    np.testing.assert_allclose(want["grad_norm"], got["grad_norm"],
                               rtol=GRAD_TOL)


def test_detect_train_step_gradients_and_update_match_jax(step_runs):
    want, got, *_ = step_runs
    _close(got["grads"], _sd(want["grads"]), "grad", _offsets(GRAD_TOL))
    # AdamW moves an element whose gradient is within noise of zero by up
    # to lr either way: 2 lr on top, as in the clip step's test
    for key in ("params", "ema"):
        _close(got[key], _sd(want[key]), key, _offsets(TENSOR_TOL),
               extra=2 * LR)
    stats = {n: t for n, t in _sd(want["batch_stats"], "batch_stats").items()
             if not n.endswith("num_batches_tracked")}
    _close({n: got["buffers"][n] for n in stats}, stats, "batch_stats",
           TENSOR_TOL)


def test_flat_image_shows_the_jax_batchnorm_variance_fault():
    """On the slow test's flat grey image (every channel near constant) the
    JAX package's batch variance E[x^2] - E[x]^2 (ROADMAP Queue 3 item 5)
    cancels: measured, its loss sits 9.7e-5 (relative) from an f64
    evaluation, the port's f32 1.6e-6. That is why the steps above add
    noise to the background."""
    f64 = _step_runs(1)[2]
    ref = f64["flat", torch.float64][0]
    port, jx = f64["flat", torch.float32][0], f64["flat", "jax"][0]
    assert abs(port - ref) <= LOSS_RTOL * ref
    assert abs(jx - ref) > 10 * abs(port - ref)


# ----------------------------------------------------------------- validator

@pytest.fixture(scope="module")
def fixture160(tmp_path_factory):
    """2 sequences x 3 PNG frames at 160x160, converted (its yaml)."""
    from scripts.make_synth_mot import make_mot_fixture

    from mo_yolo_tpu_torch.data.mot_challenge import convert_mot_to_yolo
    base = tmp_path_factory.mktemp("det")
    make_mot_fixture(str(base / "raw"), n_seq=2, size=160, n_frames=3)
    return base, convert_mot_to_yolo(str(base / "raw"), str(base / "yolo"))


def _rows(path):
    return [[float(x) for x in line.split()]
            for line in Path(path).read_text().splitlines()]


def test_detection_validator_matches_jax(pair, fixture160):
    from mo_yolo_tpu.engine.validator import \
        DetectionValidator as JDetectionValidator
    from mo_yolo_tpu_torch.data.dataset import load_dataset_yaml
    from mo_yolo_tpu_torch.engine.validator import DetectionValidator
    jm, v, pm = pair
    base, yaml_path = fixture160
    files = load_dataset_yaml(yaml_path)["train"]
    out = {}
    for name, make in (
            ("jax", lambda d: JDetectionValidator(
                jm, v, imgsz=160, save_json=True, save_dir=d,
                save_hybrid=True)),
            ("port", lambda d: DetectionValidator(
                pm, imgsz=160, save_json=True, save_dir=d,
                save_hybrid=True))):
        d = str(base / name)
        out[name] = (make(d)(files, max_gt=8), Path(d))
    (want, jdir), (got, pdir) = out["jax"], out["port"]
    assert got.keys() == want.keys() == {"mAP50", "mAP50-95", "precision",
                                         "recall", "fps"}
    for k in want:
        if k != "fps":
            assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])
    jrec = json.loads((jdir / "predictions.json").read_text())
    prec = json.loads((pdir / "predictions.json").read_text())
    assert len(prec) == len(jrec) > 0
    for g, w in zip(prec, jrec):
        assert (g["image_id"], g["category_id"]) == \
            (w["image_id"], w["category_id"])
        # printed to 1e-3 px and 1e-5: one step of the print apart at most
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1.001e-3)
        assert abs(g["score"] - w["score"]) <= 1.001e-5
    jl = sorted((jdir / "labels").iterdir())
    pl = sorted((pdir / "labels").iterdir())
    assert [p.name for p in pl] == [p.name for p in jl] and len(pl) == 3
    for p, j in zip(pl, jl):
        g, w = np.array(_rows(p)), np.array(_rows(j))
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1:], w[:, 1:], atol=1.001e-6)


# ------------------------------------------------------- facade and the CLI

@pytest.fixture(scope="module")
def saved(tmp_path_factory, fixture160):
    """A tiny Detector (nq 32) saved at 160x160, and its folder."""
    from mo_yolo_tpu_torch import Detector
    base = tmp_path_factory.mktemp("facade")
    det = Detector("tiny_track", imgsz=160, dtype="float32", device="cpu",
                   nq=32, hd=HD, ndl=NDL, d_ffn=64)
    det.save(str(base / "model"))
    return det, base


def test_facade_save_load_and_exports(saved):
    from mo_yolo_tpu_torch import Detector
    det, base = saved
    again = Detector(str(base / "model"), device="cpu")
    assert again.model_kw == {"nq": 32, "hd": HD, "ndl": NDL, "d_ffn": 64}
    want = det.model.state_dict()
    assert all(torch.equal(t, want[k])
               for k, t in again.model.state_dict().items())
    p = det.export(fmt="params", path=str(base / "exported"))
    assert all(torch.equal(t, want[k]) for k, t in
               Detector(p, device="cpu").model.state_dict().items())
    det.export(fmt="pt", path=str(base / "up"))
    other = Detector("tiny_track", imgsz=160, dtype="float32", device="cpu",
                     seed=5, nq=32, hd=HD, ndl=NDL, d_ffn=64)
    other.load_torch(str(base / "up.pt"), strict=True)
    assert all(torch.equal(t, want[k])
               for k, t in other.model.state_dict().items())
    for fmt, name in (("jaxexport", "'pt2'"), ("stablehlo", "'graph'")):
        with pytest.raises(ValueError, match=name):
            det.export(fmt=fmt, path=str(base / "x"))
    tracked = list(det.track(np.zeros((2, 32, 32, 3), np.uint8)))
    assert len(tracked) == 2 and all(r.track_id.dtype.kind == "i" and
                                     r.boxes_xyxy.shape == (len(r), 4)
                                     for r in tracked)
    info = det.info(flops=True, verbose=False)
    assert info["params"] == sum(p.numel() for p in det.model.parameters())
    assert info["gflops"] > 0


def test_facade_predict_maps_boxes_to_the_original_frame(saved):
    """Frames of another size are stretched to imgsz: the boxes come back
    in the frame's pixels, as `predict_step`'s boxes scaled per axis."""
    det, _ = saved
    frames = np.random.default_rng(1).integers(0, 256, (2, 80, 200, 3),
                                               dtype=np.uint8)
    res = list(det.predict(frames, conf=0.0))
    assert len(res) == 2
    from mo_yolo_tpu_torch.data.letterbox import letterbox
    x, _, _ = letterbox(frames[0], (160, 160), scale_fill=True)
    b, s, c = (t[0].numpy() for t in det.model.predict_step(
        torch.from_numpy(x[None])))
    r = res[0]
    assert len(r) == 32 and (r.track_id == -1).all()
    np.testing.assert_array_equal(r.cls, c)
    np.testing.assert_allclose(r.conf, s)
    want = np.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                     b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], 1) * \
        np.array([200, 80, 200, 80])
    np.testing.assert_allclose(r.boxes_xyxy, np.clip(want, 0, [200, 80,
                                                               200, 80]),
                               atol=1e-3)


def test_yolo_routes_tasks():
    from mo_yolo_tpu_torch import RTDETR, YOLO, Detector, MOTRTrack
    kw = dict(device="cpu", dtype="float32", nq=32, hd=HD, ndl=NDL,
              d_ffn=32)
    assert type(YOLO("tiny_track", task="detect", **kw)) is Detector
    assert type(YOLO("tiny_detr", task="rtdetr", **kw)) is RTDETR
    assert type(YOLO("tiny_track", device="cpu", dtype="float32")) is \
        MOTRTrack
    from mo_yolo_tpu_torch.api import _TaskModel
    for task in ("segment", "pose", "classify"):
        m = YOLO("tiny_track", task=task, device="cpu", imgsz=64)
        assert type(m) is _TaskModel and m.task == task
    with pytest.raises(NotImplementedError, match="not a task"):
        YOLO("tiny_track", task="sam", device="cpu")


def test_cli_detect_predict_tune_and_the_device_message(saved, fixture160,
                                                        tmp_path, caplog):
    import logging

    from mo_yolo_tpu_torch.cli import main
    from mo_yolo_tpu_torch.utils.logging import LOGGER
    _, base = saved
    _, yaml_path = fixture160
    src = sorted((fixture160[0] / "yolo" / "images" / "train").iterdir())[0]
    handler = logging.Handler()
    lines = []
    handler.emit = lambda rec: lines.append(rec.getMessage())
    LOGGER.addHandler(handler)
    try:
        assert main(["detect", "predict", f"model={base / 'model'}",
                     f"source={src}", "device=cpu", "conf=0.0"]) == 0
        assert sum("32 detections" in m for m in lines) == 3
        assert main(["detect", "tune", f"model={base / 'model'}",
                     f"data={yaml_path}", "device=cpu", "epochs=1",
                     "max_samples=1", "batch=2", "val=false",
                     "plots=false", f"save_dir={tmp_path / 'tune'}"]) == 0
    finally:
        LOGGER.removeHandler(handler)
    assert (tmp_path / "tune" / "tune_results.csv").is_file()
    assert any("tune best fitness" in m for m in lines)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="device='cpu'"):
            main(["detect", "predict", f"model={base / 'model'}",
                  f"source={src}"])


def test_yolo_mot_detection_model_full_width_matches_jax():
    """The single-class MOT detector `Detector("yolo_mot")` builds: the
    `DetectionModel` at full width against the JAX one (node lists,
    parameter count from `jax.eval_shape`, the converter's strict
    load)."""
    from tests.torch_port_common import check_full_width
    pm = check_full_width("yolo_mot", detect=True)
    assert pm.spec.nc == 1 and pm.decoder.dec_score_head[0].out_features == 1
