"""The port's segment, pose and classify facade (`api._TaskModel`) and
command line against the JAX package, at f32 on the CPU (tiny_track with
nc=2 at 64x64, random BatchNorm statistics, the fixtures of
`chip_smoke.task_fixture`):

- predict (raw, `masks=True` on both compositions, TrackResults) against
  the JAX facade's on the same weights: values within 1e-5 of their
  scale, kept slots and classes equal; segment and pose label rows;
- val, train, tune, export (`params`, `pt`, `torchscript`, whose traced
  forward equals the module's) and save/load;
- `YOLO` routing and the CLI's segment, pose and classify tasks (nas, sam
  and fastsam still exit naming ROADMAP Queue 1 item 8).
"""

import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_port_tasks import HW, MAX_DET, NC, pair
from tests.torch_port_common import ROOT

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    root = tmp_path_factory.mktemp("task_api")
    return {t: chip_smoke.task_fixture(root / t, t, n_train=4, n_val=2,
                                       hw=(HW, HW), nc=NC, n_obj=3)
            for t in ("segment", "pose", "classify")}


def _val_images(fixtures, task):
    if task == "classify":
        return str(fixtures["classify"]) + "/val"
    return str(fixtures[task]).rsplit("/", 1)[0] + "/images/val"


def _facade(task, **kw):
    """The port facade holding `pair(task)`'s weights, and the JAX facade
    made without its constructor (which would compile an init) holding the
    same."""
    from mo_yolo_tpu.api import _TaskModel as JTask
    from mo_yolo_tpu_torch.api import _TaskModel
    jm, v, pm = pair(task)
    extra = {} if task == "classify" else {"max_det": MAX_DET}
    m = _TaskModel(task, "tiny_track", nc=NC, imgsz=HW, device="cpu",
                   **extra, **kw)
    m.model.load_state_dict(pm.state_dict())
    jf = JTask.__new__(JTask)
    jf.task, jf.imgsz = task, HW
    jf.model = jm.clone(retina_masks=kw.get("retina_masks", False)) \
        if task == "segment" else jm
    jf.variables = jax.tree_util.tree_map(jnp.asarray, v)
    return m, jf


@pytest.mark.parametrize("task,kw", [
    ("segment", {}), ("segment", {"masks": True}),
    ("segment", {"masks": True, "retina_masks": True}), ("pose", {}),
    ("classify", {})], ids=["seg", "seg_masks", "seg_retina", "pose",
                            "classify"])
def test_facade_predict_matches_jax(fixtures, task, kw):
    kw = dict(kw)
    m, jf = _facade(task, **({"retina_masks": kw.pop("retina_masks")}
                             if "retina_masks" in kw else {}))
    src = _val_images(fixtures, task)
    got = list(m.predict(src, **kw))
    want = list(jf.predict(src, **kw))
    assert len(got) == len(want) == 2
    for (gp, g), (wp, w) in zip(got, want):
        assert gp == wp
        if task == "classify":          # the logits alone, not a tuple
            g, w = (g,), (w,)
        for a, b in zip(g, w):
            b = np.asarray(b)
            assert a.shape == b.shape
            if b.dtype.kind in "iub":
                keep = np.asarray(w[1]) > 0 if task != "classify" else ...
                np.testing.assert_array_equal(a[keep], b[keep])
            else:
                np.testing.assert_allclose(a, b, atol=1e-5 * max(
                    1.0, float(np.abs(b).max())))
    results = list(m.predict(src, as_results=True))
    jresults = list(jf.predict(src, as_results=True))
    for (_, r), (_, jr) in zip(results, jresults):
        np.testing.assert_allclose(r.boxes_xyxy, jr.boxes_xyxy, atol=1e-3)
        np.testing.assert_array_equal(r.cls, jr.cls)
        for a in ("masks", "keypoints", "probs"):
            x, y = getattr(r, a), getattr(jr, a)
            assert (x is None) == (y is None), a
            if x is not None:
                np.testing.assert_allclose(x, y, atol=1e-4, err_msg=a)
        assert r.plot().shape == (*r.orig_shape, 3)


def test_save_txt_rows_match_jax(fixtures, tmp_path):
    """Segment rows are a mask's polygon: the JAX package traces it with
    cv2 where cv2 imports, and otherwise writes the bounding box's corners,
    which is what the port writes (no cv2 on the card's machine)."""
    for task in ("segment", "pose"):
        m, jf = _facade(task)
        src = _val_images(fixtures, task)
        (_, r), = list(m.predict(src, as_results=True))[:1]
        (_, jr), = list(jf.predict(src, as_results=True))[:1]
        r.save_txt(tmp_path / f"{task}.txt", save_conf=True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, "cv2", None)
            jr.save_txt(tmp_path / f"{task}_jax.txt", save_conf=True)
        got = (tmp_path / f"{task}.txt").read_text().splitlines()
        want = (tmp_path / f"{task}_jax.txt").read_text().splitlines()
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.float64(g.split()),
                                       np.float64(w.split()), atol=2e-5)


@pytest.mark.parametrize("task", ["segment", "pose", "classify"])
def test_facade_val_train_tune_export_and_reload(fixtures, tmp_path, task):
    from mo_yolo_tpu_torch.api import _TaskModel
    m, _ = _facade(task)
    data = fixtures[task]
    metrics = m.val(data)
    key = "accuracy_top1" if task == "classify" else "mAP50(B)"
    assert key in metrics and all(np.isfinite(v) for v in metrics.values())
    out = m.train(data, epochs=2, batch=2, save_dir=str(tmp_path / "run"),
                  log_every=1)
    assert np.isfinite(out["final_loss"])
    assert (tmp_path / "run" / "last").is_file()
    assert (tmp_path / "run" / "best").is_file()
    tuned = m.tune(data, epochs=1, max_samples=1, batch=2,
                   save_dir=str(tmp_path / "tune"))
    assert np.isfinite(tuned["best_fitness"])
    assert set(tuned["best_hyp"]) == set(m._tune_space(None))
    path = m.export(fmt="params", path=str(tmp_path / "w"))
    again = _TaskModel(task, path, device="cpu")
    for k, t in m.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], t), k
    assert again.model_kw == m.model_kw
    from mo_yolo_tpu_torch.utils.checkpoint import export_torch_state_dict
    pt = torch.load(m.export(fmt="pt", path=str(tmp_path / "w")),
                    weights_only=True)
    want = export_torch_state_dict(m.model)
    assert set(pt["state_dict"]) == set(want)
    assert all(torch.equal(pt["state_dict"][k], t) for k, t in want.items())
    assert pt["train_args"]["task"] == task
    ts = m.export(fmt="torchscript", path=str(tmp_path / "w"))
    extra = {"config.txt": ""}
    loaded = torch.jit.load(ts, _extra_files=extra)
    assert json.loads(extra["config.txt"])["task"] == task
    x = torch.rand(1, 3, HW, HW)
    with torch.no_grad():
        want = m.model(x.permute(0, 2, 3, 1))
        got = loaded(x)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        torch.testing.assert_close(a, b)
    with pytest.raises(ValueError, match="item 9"):
        m.export(fmt="jaxexport", path=str(tmp_path / "w"))


def test_yolo_routes_every_task_and_the_cli_runs_them(fixtures, tmp_path):
    from mo_yolo_tpu_torch import YOLO
    from mo_yolo_tpu_torch.api import _TaskModel
    from mo_yolo_tpu_torch.cli import main
    for task in ("segment", "pose", "classify"):
        m = YOLO("tiny_track", task=task, device="cpu", imgsz=HW)
        assert type(m) is _TaskModel and m.task == task
        src = _val_images(fixtures, task)
        out = tmp_path / task
        common = ["model=tiny_track", f"imgsz={HW}", "device=cpu", "nc=2"]
        assert main([task, "predict", f"source={src}", "save=true",
                     "save_txt=true", f"save_dir={out}", *common]) == 0
        assert len(list(out.glob("*.png"))) == 2
        assert main([task, "val", f"data={fixtures[task]}", *common]) == 0
        assert main([task, "train", f"data={fixtures[task]}", "epochs=1",
                     "batch=2", f"save_dir={out / 'run'}", *common]) == 0
        assert (out / "run" / "best").is_file()
    for task in ("nas", "sam", "fastsam"):
        with pytest.raises(SystemExit, match="item 8"):
            main([task, "predict", "source=x"])
