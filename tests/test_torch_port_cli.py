"""The port's config and command line (`cfg/default.py`, `cli.py`) against
the JAX package's on the CPU.

Config: the port's default dict equals `yaml.safe_load` of the JAX
package's default.yaml, its flat parser reads that file to the same dict,
and `get_cfg` returns and raises what the JAX function does on a table of
overrides. CLI: `parse_kv` and `route_kwargs` equal the JAX ones on a
table of inputs; end to end, the same tiny_track weights (nq and slots at
TINY_NQ, random BatchNorm, f32, the val tests' score bias) are saved once
by each facade, and both CLIs run in process on the val tests' fixture
(2 sequences x 6 PNG frames at 96x96, the input size, so both
letterboxes are the identity):

- `track predict`: label files and MOT rows line for line, the same
  track ids and classes, boxes within 1e-4 normalized (the MOT file
  prints pixels to 0.01, so its boxes are held to that print's step plus
  1e-4 of the frame) and conf within 1e-4;
- `track val`: every metric within 1e-4 as a fraction (1e-2 of the
  dict's percentages), IDSW exactly;
- `track export format=params` then `track val model=<it>`: the port's
  metrics equal the live model's.
"""

import functools
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tests.torch_port_common import ROOT, TINY_NQ, build_pair, j_facade

torch.set_num_threads(1)

HW = 96
SCORE_BIAS = 0.3
BOX_ATOL = 1e-4
METRIC_ATOL = 1e-4      # as a fraction; the dict's percentages x 100
DEFAULT_YAML = ROOT / "mo_yolo_tpu" / "cfg" / "default.yaml"


# ------------------------------------------------------------------ config

def test_default_dict_equals_the_jax_default_yaml():
    from mo_yolo_tpu_torch.cfg.default import DEFAULT, load_default
    want = yaml.safe_load(DEFAULT_YAML.read_text())
    assert load_default() == want and list(DEFAULT) == list(want)
    assert len(DEFAULT) >= 120


def test_flat_parser_reads_the_jax_default_yaml():
    from mo_yolo_tpu_torch.cfg.datasets import parse_flat_yaml
    text = DEFAULT_YAML.read_text()
    assert parse_flat_yaml(text) == yaml.safe_load(text)


GET_CFG_CASES = [
    ({}, None),
    ({"epochs": 3, "lr0": 1, "plots": "false", "device": "cpu"}, None),
    ({"model": 5, "clip_len": [2, 3], "classes": [0, 2]}, None),
    ({"epoch": 3}, None),                     # unknown: KeyError + hint
    ({"zzz_unknown": 1}, None),               # unknown, no hint
    ({"epochs": "x"}, None),                  # TypeError
    ({"conf": [1]}, None),
    ({"batch": 2.5}, None),
    ({"batch": 4}, {"batch": 8, "epochs": 2}),   # cfg dict then override
]


@pytest.mark.parametrize("overrides,cfg", GET_CFG_CASES)
def test_get_cfg_equals_the_jax_one(overrides, cfg):
    from mo_yolo_tpu.cfg import get_cfg as j_get_cfg
    from mo_yolo_tpu_torch.cfg.default import get_cfg

    def run(fn):
        try:
            return "ok", vars(fn(overrides, cfg))
        except (KeyError, TypeError) as e:
            return type(e).__name__, str(e)
    assert run(get_cfg) == run(j_get_cfg)


def test_get_cfg_reads_a_cfg_file_as_the_jax_one(tmp_path):
    from mo_yolo_tpu.cfg import get_cfg as j_get_cfg
    from mo_yolo_tpu_torch.cfg.default import get_cfg
    f = tmp_path / "c.yaml"
    f.write_text("epochs: 7  # a comment\nimgsz: [320, 480]\nlr0: 0.002\n"
                 "name: 'my run'\nsave_mot:\nhalf: true\n")
    assert vars(get_cfg({"batch": 2}, str(f))) == \
        vars(j_get_cfg({"batch": 2}, str(f)))


def test_copy_cfg_writes_a_file_that_reads_back_equal(tmp_path, monkeypatch):
    from mo_yolo_tpu_torch.cfg.datasets import parse_flat_yaml
    from mo_yolo_tpu_torch.cfg.default import DEFAULT
    from mo_yolo_tpu_torch.cli import main
    monkeypatch.chdir(tmp_path)
    assert main(["copy-cfg"]) == 0
    text = (tmp_path / "default_copy.yaml").read_text()
    assert parse_flat_yaml(text) == DEFAULT == yaml.safe_load(text)


# ------------------------------------------------------------- CLI tables

PARSE_KV_CASES = [
    ["epochs=3", "lr0=0.01", "name=exp"],
    ["save=true", "rect=False", "imgsz=1536x800", "imgsz2=[800,1536]"],
    ["classes=(0,2)", "hyp={'hsv_h': 0.1}", "bad=[1,", "neg=-4", "e=1e-3"],
    ["source=a=b.png", "empty="],
]


@pytest.mark.parametrize("args", PARSE_KV_CASES)
def test_parse_kv_equals_the_jax_one(args):
    from mo_yolo_tpu.cli import parse_kv as j_parse_kv
    from mo_yolo_tpu_torch.cli import parse_kv
    assert parse_kv(args) == j_parse_kv(args)


def test_parse_kv_refuses_a_bare_word_as_the_jax_one():
    from mo_yolo_tpu.cli import parse_kv as j_parse_kv
    from mo_yolo_tpu_torch.cli import parse_kv
    for fn in (parse_kv, j_parse_kv):
        with pytest.raises(SystemExit, match="expected k=v"):
            fn(["predict"])


def _sig_a(data, lr=0.1, save_dir="runs", conf=0.5, epochs=1, hyp=None):
    pass


def _sig_b(self, batch=1, clip_len=5, **kw):
    pass


ROUTE_CASES = [
    ({"lr0": 0.01, "epochs": 2, "zzz": 1}, True),
    ({"lr": 0.2, "lr0": 0.01, "hsv_h": 0.2, "mosaic": 1.0, "batch": 4},
     True),
    ({"hsv_h": 0.2, "conf": 0.3, "hyp": {"degrees": 3.0}}, False),
    ({"hyp": {"degrees": 3.0}, "fliplr": 0.0, "clip_len": 2}, True),
    ({"project": "runs", "name": "exp", "epochs": 1}, True),
    ({"project": "runs", "name": "exp", "exist_ok": True}, True),
    ({"name": "only", "save_dir": "given"}, True),
]


@pytest.mark.parametrize("kv,allow_hyp", ROUTE_CASES)
def test_route_kwargs_equals_the_jax_one(kv, allow_hyp, tmp_path,
                                         monkeypatch):
    """The same result from the same signatures, with `runs/exp` already
    present so that `increment_path` steps to `runs/exp2`."""
    from mo_yolo_tpu.cli import route_kwargs as j_route
    from mo_yolo_tpu_torch.cli import route_kwargs
    monkeypatch.chdir(tmp_path)
    (tmp_path / "runs" / "exp").mkdir(parents=True)
    got = route_kwargs(dict(kv), _sig_a, _sig_b, allow_hyp=allow_hyp)
    assert got == j_route(dict(kv), _sig_a, _sig_b, allow_hyp=allow_hyp)
    if "project" in kv and not kv.get("exist_ok"):
        assert got["save_dir"] == "runs/exp2"


@pytest.mark.parametrize("arg,want", [("cpu", "cpu"), ("cuda", "cuda"),
                                      ("cuda:1", "cuda:1"), (0, "cuda:0"),
                                      ("2", "cuda:2")])
def test_device_argument(arg, want):
    from mo_yolo_tpu_torch.cli import device_arg
    assert device_arg(arg) == want


def test_other_tasks_and_bench_modes_exit_naming_the_roadmap():
    """sam and nas exit naming their ROADMAP item; segment, pose and
    classify are routed to the task facade, which (without device=cpu on
    a machine with no card) stops at the device check."""
    from mo_yolo_tpu_torch.cli import main
    for task, item in (("classify", "device='cpu'"),
                       ("segment", "device='cpu'"), ("pose", "device='cpu'"),
                       ("sam", "item 8"), ("nas", "item 8")):
        with pytest.raises(SystemExit, match=item):
            main([task, "train", "data=x.yaml"])
    for task in ("detect", "rtdetr"):   # the classic trackers
        with pytest.raises(SystemExit, match="item 8"):
            main([task, "track", "source=x", "device=cpu"])
    for mode in ("bench", "benchmark"):
        with pytest.raises(SystemExit, match="item 8"):
            main(["track", mode, "imgsz=640"])


@pytest.mark.parametrize("path,n,want", [
    ("seq/000007.png", 6, "000007"), ("", 3, "frame000003"),
    ("v/clip.mp4#000012", 12, "clip_000012"),
    ("v/clip.mp4#000013", 13, "clip_000013")])
def test_label_files_get_one_stem_per_video_frame(path, n, want):
    """The predictor's stems: a `#`-suffixed video frame gets its own
    (the JAX predictor's rule for saved frames), which the CLI also uses
    for label files, where the JAX CLI's `Path.stem` collapses a video's
    frames into one file."""
    from mo_yolo_tpu_torch.engine.predictor import frame_stem
    assert frame_stem(path, n) == want


# -------------------------------------------------------------- end to end

@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """One set of weights saved by the JAX facade and by the port's, the
    converted 2 x 6-frame fixture (yaml, the first sequence's folder) and
    the JAX facade that saved its weights."""
    from scripts.make_synth_mot import make_mot_fixture

    from mo_yolo_tpu.api import MOTRTrack as JMOTRTrack
    from mo_yolo_tpu_torch.api import MOTRTrack
    from mo_yolo_tpu_torch.data.dataset import load_dataset_yaml
    from mo_yolo_tpu_torch.data.mot_challenge import convert_mot_to_yolo
    from mo_yolo_tpu_torch.models.tracker import TrackerConfig

    base = tmp_path_factory.mktemp("cli")
    make_mot_fixture(str(base / "raw"), n_seq=2, size=HW, n_frames=6)
    yaml_path = convert_mot_to_yolo(str(base / "raw"), str(base / "yolo"))
    seq_dir = str(Path(load_dataset_yaml(yaml_path)["train"][0]).parent)
    jm, v, pm = build_pair(image_hw=(HW, HW), score_bias=SCORE_BIAS)
    jf = j_facade(JMOTRTrack, jm, v, HW)
    jf.save(str(base / "jax_model"))
    pf = MOTRTrack("tiny_track", imgsz=HW, dtype="float32", device="cpu",
                   nq=TINY_NQ, tracker=TrackerConfig(n_slots=TINY_NQ))
    pf.model.load_state_dict(pm.state_dict())
    pf.save(str(base / "port_model"))
    return base, yaml_path, seq_dir, jf


def _rows(path):
    return [[float(x) for x in line.replace(",", " ").split()]
            for line in Path(path).read_text().splitlines()]


def test_cli_predict_writes_the_jax_clis_labels_and_mot_rows(saved):
    from mo_yolo_tpu.cli import main as j_main
    from mo_yolo_tpu_torch.cli import main
    base, _, seq_dir, _ = saved
    common = [f"source={seq_dir}", "save_txt=true", "save_conf=true",
              "conf=0.0"]
    assert j_main(["track", "predict", f"model={base / 'jax_model'}",
                   f"save_dir={base / 'jp'}", f"save_mot={base / 'j.txt'}",
                   *common]) == 0
    assert main(["track", "predict", f"model={base / 'port_model'}",
                 f"save_dir={base / 'pp'}", f"save_mot={base / 'p.txt'}",
                 "device=cpu", "amp=false", *common]) == 0
    jl = sorted((base / "jp" / "labels").iterdir())
    pl = sorted((base / "pp" / "labels").iterdir())
    assert [p.name for p in pl] == [p.name for p in jl] and len(pl) == 6
    n_rows = 0
    for p, j in zip(pl, jl):
        got, want = np.array(_rows(p)), np.array(_rows(j))
        assert got.shape == want.shape
        n_rows += len(got)
        if not len(got):
            continue
        np.testing.assert_array_equal(got[:, :2], want[:, :2])   # id, cls
        np.testing.assert_allclose(got[:, 2:6], want[:, 2:6], atol=BOX_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(got[:, 6], want[:, 6], atol=1e-4, rtol=0)
    assert n_rows > 0
    got, want = np.array(_rows(base / "p.txt")), np.array(_rows(base /
                                                                "j.txt"))
    assert got.shape == want.shape and len(got) == n_rows
    np.testing.assert_array_equal(got[:, :2], want[:, :2])   # frame, id
    np.testing.assert_allclose(got[:, 2:6], want[:, 2:6],
                               atol=0.01 + BOX_ATOL * HW, rtol=0)
    np.testing.assert_array_equal(got[:, 6:], want[:, 6:])


def test_cli_predict_twice_writes_fresh_label_files(saved, tmp_path,
                                                   monkeypatch):
    """`track predict save_txt=true` run twice without a save_dir: the
    port writes the second run under runs/track/predict2, so each run's
    label files equal one run's, exactly; the JAX CLI, run twice, appends
    the second run's rows to the first's files."""
    from mo_yolo_tpu.cli import main as j_main
    from mo_yolo_tpu_torch.cli import main
    base, _, seq_dir, jf = saved
    args = [f"source={seq_dir}", "save_txt=true", "conf=0.0",
            "verbose=false"]
    monkeypatch.chdir(tmp_path / ".")
    for _ in range(2):
        assert main(["track", "predict", f"model={base / 'port_model'}",
                     "device=cpu", "amp=false", *args]) == 0
    runs = tmp_path / "runs" / "track"
    first, second = (sorted((runs / d / "labels").iterdir())
                     for d in ("predict", "predict2"))
    assert [p.name for p in first] == [p.name for p in second]
    assert len(first) == 6
    assert sum(len(p.read_text().splitlines()) for p in first) > 0
    for a, b in zip(first, second):
        assert a.read_text() == b.read_text()
    # the JAX CLI gets the facade that saved `jax_model` instead of
    # loading it again (an init compile a run); its save_dir and label
    # files are the CLI's own
    import mo_yolo_tpu.api as japi
    monkeypatch.setattr(japi, "MOTRTrack", lambda *a, **kw: jf)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    monkeypatch.chdir(jdir)
    texts = []
    for _ in range(2):
        assert j_main(["track", "predict", f"model={base / 'jax_model'}",
                       *args]) == 0
        texts.append([p.read_text() for p in sorted(
            (jdir / "runs" / "track" / "predict" / "labels").iterdir())])
    assert not (jdir / "runs" / "track" / "predict2").exists()
    assert [t + t for t in texts[0]] == texts[1]


def _spy_val(monkeypatch, cls, out):
    """Keep each `cls.val` result; `wraps` keeps its signature, which the
    CLI routes keys by."""
    orig = cls.val

    @functools.wraps(orig)
    def spy(self, *a, **kw):
        out.append(orig(self, *a, **kw))
        return out[-1]
    monkeypatch.setattr(cls, "val", spy)


def test_cli_val_and_export_params_give_the_jax_clis_metrics(saved,
                                                             monkeypatch):
    from mo_yolo_tpu.api import MOTRTrack as JMOTRTrack
    from mo_yolo_tpu.cli import main as j_main
    from mo_yolo_tpu_torch.api import MOTRTrack
    from mo_yolo_tpu_torch.cli import main
    base, yaml_path, _, _ = saved
    jout, pout = [], []
    _spy_val(monkeypatch, JMOTRTrack, jout)
    _spy_val(monkeypatch, MOTRTrack, pout)
    common = [f"data={yaml_path}", "split=train", "conf=0.0", "max_gt=8"]
    assert j_main(["track", "val", f"model={base / 'jax_model'}",
                   *common]) == 0
    assert main(["track", "val", f"model={base / 'port_model'}",
                 "device=cpu", "amp=false", *common]) == 0
    exported = base / "exported"
    assert main(["track", "export", f"model={base / 'port_model'}",
                 "device=cpu", "format=params", f"path={exported}"]) == 0
    assert main(["track", "val", f"model={exported}", "device=cpu",
                 *common]) == 0
    (j,), (p, again) = jout, pout
    assert p.keys() == j.keys() == again.keys()
    assert {"HOTA", "MOTA", "IDF1", "mAP50"} <= p.keys()
    assert p["HOTA"] > 0
    for k in j:
        if k == "fps":
            continue
        if k == "IDSW":
            assert p[k] == j[k] == again[k]
            continue
        assert abs(p[k] - j[k]) <= 100 * METRIC_ATOL, (k, p[k], j[k])
        assert p[k] == again[k] or (math.isnan(p[k]) and
                                    math.isnan(again[k])), k


def test_cli_without_a_card_exits_with_the_device_message(saved):
    """No device= on a machine without CUDA: a non-zero exit naming
    device='cpu' (resolve_device's message); nothing runs on the CPU."""
    from mo_yolo_tpu_torch.cli import main
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is it")
    base, _, seq_dir, _ = saved
    with pytest.raises(SystemExit, match="device='cpu'") as e:
        main(["track", "predict", f"model={base / 'port_model'}",
              f"source={seq_dir}", f"save_dir={base / 'none'}"])
    assert e.value.code != 0
    assert not (base / "none").exists()
