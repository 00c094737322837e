"""Multi-stream tracking and validation in the port (`engine/multistream.py`
`MultiStreamPredictor`, `engine/validator.py` `MultiStreamValidator`) and
its frame sources (`data/loaders.py` `make_source`, `TensorSource`), on the
CPU: the counterparts of tests/test_engine.py's multi-stream tests at
tiny_track, nq = 32, 64x64.

The same tiny_track weights go into both packages (random BatchNorm, f32,
the stream tests' score-head bias, which keeps scores off the tracker's
thresholds). Tolerances: ids exactly; boxes, normalised to the input,
within the stream tests' BOX_ATOL (f32; B streams in one batch against
one alone take their sums in another order), 1e-3 in the 64-pixel frames
of a `TrackResults`; metrics within 1e-4 as the JAX test holds them.
"""

import numpy as np
import pytest
import torch

from tests.torch_port_common import build_pair

torch.set_num_threads(1)

SCORE_BIAS = 0.3
BOX_ATOL = 1e-5
HW = 64


@pytest.fixture(scope="module")
def pair():
    return build_pair(image_hw=(HW, HW), score_bias=SCORE_BIAS)


def _frames(n, size=96, shift=0):
    """tests/test_engine.py's `_synthetic_frames`: two bright boxes moving
    over a flat background; `shift` moves the second box along."""
    frames = []
    for t in range(n):
        img = np.full((size, size, 3), 90, np.uint8)
        img[20 + 4 * t:40 + 4 * t, 10:30, 0] = 250
        x = 50 + 3 * t + shift
        img[60:80, x:x + 20, 2] = 250
        frames.append(img)
    return frames


def _tracks(o, size=HW):
    """A multi-stream result's live tracks as (ids, xyxy pixels), sorted by
    id, clipped to the frame as `TrackResults` is."""
    keep = o["valid"] & (o["obj_id"] >= 0)
    b = o["box"][keep]
    xyxy = np.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                     b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2],
                    1) * size if keep.any() else np.zeros((0, 4))
    order = np.argsort(o["obj_id"][keep])
    return o["obj_id"][keep][order].astype(int), \
        np.clip(xyxy[order], 0, size)


def test_streams_of_different_lengths(pair):
    """Six streams of 2-4 frames in one batch: a step per frame of the
    longest; an ended stream yields None; live ones give fixed-shape rows;
    each stream's results equal that stream's alone at B = 1."""
    from mo_yolo_tpu_torch.engine.multistream import MultiStreamPredictor
    _, _, pm = pair
    sources = [[f[16:80, 16:80] for f in _frames(2 + i % 3, shift=i)]
               for i in range(6)]
    ms = MultiStreamPredictor(pm, imgsz=HW, device="cpu")
    steps = list(ms.stream(sources))
    assert len(steps) == 4 and ms.raw_hw == (HW, HW)
    assert steps[0][0] is not None and steps[-1][0] is None
    live = [r for r in steps[-1] if r is not None]
    assert len(live) == 2 and live[0]["box"].shape == (2 * 32, 4)
    for i in (0, 2):
        alone = list(ms.stream([sources[i]]))
        assert len(alone) == len(sources[i])
        for t, (res,) in enumerate(alone):
            for k in ("obj_id", "valid", "cls"):
                np.testing.assert_array_equal(steps[t][i][k], res[k])
            np.testing.assert_allclose(steps[t][i]["box"], res["box"],
                                       atol=BOX_ATOL)


def test_u8_contract_matches_single_stream_of_both_packages(pair):
    """Equal 64x64 sources: raw uint8 frames in one batch (the card's
    letterbox the identity), each stream's tracks equal to that stream
    through the port's and the JAX package's single-stream
    `TrackPredictor` (device preprocessing): ids exactly, boxes within
    1e-3 pixels."""
    from mo_yolo_tpu.engine.predictor import TrackPredictor as JPredictor
    from mo_yolo_tpu_torch.engine.multistream import MultiStreamPredictor
    from mo_yolo_tpu_torch.engine.predictor import TrackPredictor
    jm, v, pm = pair
    sources = [[f[16:80, 16:80] for f in _frames(3, shift=s)]
               for s in (0, 4, 8)]
    ms = MultiStreamPredictor(pm, imgsz=HW, device="cpu")
    steps = list(ms.stream(sources))
    assert ms.raw_hw == (HW, HW) and len(steps) == 3
    jpred = JPredictor(jm, v, imgsz=HW, conf=0.0, device_preprocess=True)
    n_tracks = 0
    for b, frames in enumerate(sources):
        singles = [list(TrackPredictor(pm, imgsz=HW, conf=0.0,
                                       device="cpu").stream(frames))]
        if b == 0:
            singles.append(list(jpred.stream(frames)))
        for run in singles:
            for t, res in enumerate(run):
                ids, xyxy = _tracks(steps[t][b])
                so = np.argsort(res.track_id)
                np.testing.assert_array_equal(ids, res.track_id[so])
                np.testing.assert_allclose(xyxy, res.boxes_xyxy[so],
                                           atol=1e-3)
                n_tracks += len(ids)
    assert n_tracks > 0


def test_mixed_source_shapes_letterbox_on_the_host(pair):
    """Streams of 96x96 and 80x80 frames: each frame is letterboxed on the
    host in uint8 to the input size, and the batch crosses at 64x64."""
    from mo_yolo_tpu_torch.data.letterbox import letterbox
    from mo_yolo_tpu_torch.engine.multistream import MultiStreamPredictor
    _, _, pm = pair
    sources = [_frames(2, 96 if i % 2 else 80) for i in range(4)]
    ms = MultiStreamPredictor(pm, imgsz=HW, device="cpu")
    steps = list(ms.stream(sources))
    assert ms.raw_hw == (HW, HW) and len(steps) == 2
    assert all(r is not None and r["box"].shape[1] == 4 for r in steps[0])
    hosted = [[letterbox(f, (HW, HW), scale_fill=True)[0] for f in s]
              for s in sources[:2]]
    again = list(ms.stream(hosted))
    for t in range(2):
        for b in range(2):
            np.testing.assert_array_equal(again[t][b]["obj_id"],
                                          steps[t][b]["obj_id"])


def test_multistream_validator_matches_track_validator(pair, tmp_path):
    """Three sequences (one cut short) in waves of two: the metrics of the
    single-stream `TrackValidator` within 1e-4 (tests/test_engine.py's
    rule), and IDSW exactly."""
    from scripts.make_synth_mot import make_mot_fixture

    from mo_yolo_tpu_torch.data.dataset import load_dataset_yaml, video_key
    from mo_yolo_tpu_torch.data.mot_challenge import convert_mot_to_yolo
    from mo_yolo_tpu_torch.engine.validator import (MultiStreamValidator,
                                                    TrackValidator)
    _, _, pm = pair
    make_mot_fixture(str(tmp_path / "raw"), n_seq=3, size=HW, n_frames=4)
    files = load_dataset_yaml(convert_mot_to_yolo(
        str(tmp_path / "raw"), str(tmp_path / "yolo")))["train"]
    seqs = sorted({video_key(f) for f in files})
    files = [f for f in files if video_key(f) != seqs[1] or
             not f.endswith(("000003.png", "000004.png"))]
    single = TrackValidator(pm, imgsz=HW, conf=0.0)(files, max_gt=8)
    multi = MultiStreamValidator(pm, imgsz=HW, conf=0.0, streams=2)(
        files, max_gt=8)
    assert multi.keys() == single.keys()
    for k in single:
        if k != "fps":
            assert abs(single[k] - multi[k]) < 1e-4, (k, single[k], multi[k])
    assert multi["IDSW"] == single["IDSW"]
    with pytest.raises(ValueError):
        MultiStreamValidator(pm, streams=0)


def test_make_source_dispatch_and_what_it_refuses(tmp_path, monkeypatch):
    """`make_source` dispatches as the JAX package's does; a tensor's
    frames become HWC uint8, a PIL image's its RGB conversion; a webcam, a
    URL stream, `screen` and a video file go to their sources, which raise
    naming the tool they need where it is missing."""
    import sys

    from PIL import Image

    from mo_yolo_tpu_torch.data.loaders import (ArraySource,
                                                ImageFolderSource,
                                                TensorSource, make_source)
    frames = np.stack(_frames(3, 32))
    for i, f in enumerate(frames):
        Image.fromarray(f).save(tmp_path / f"{i:06d}.png")
    (tmp_path / "list.txt").write_text(
        "\n".join(str(tmp_path / f"{i:06d}.png") for i in range(3)))
    np.save(tmp_path / "stack.npy", frames)
    for src in (tmp_path, str(tmp_path / "*.png"), tmp_path / "list.txt",
                str(tmp_path / "000001.png"),
                [str(tmp_path / "000000.png")]):
        got = make_source(src)
        assert isinstance(got, ImageFolderSource)
        for _, img in got:
            assert img.dtype == np.uint8 and img.shape == (32, 32, 3)
    assert len(make_source(tmp_path)) == 3
    npy = make_source(str(tmp_path / "stack.npy"))
    assert isinstance(npy, ArraySource)
    np.testing.assert_array_equal(np.stack([f for _, f in npy]), frames)
    assert len(make_source(frames)) == 3 and len(make_source(frames[0])) == 1
    assert isinstance(make_source(list(frames)), ArraySource)
    chw = torch.from_numpy(frames).permute(0, 3, 1, 2).float() / 255
    src = make_source(chw)
    assert isinstance(src, TensorSource) and len(src) == 3
    name, img = next(iter(src))
    assert name == "tensor_000000" and img.dtype == np.uint8
    assert np.abs(img.astype(int) - frames[0]).max() <= 1
    gray = TensorSource(torch.zeros(1, 1, 8, 8))
    assert gray.frames.shape == (1, 8, 8, 3)
    pil = make_source(Image.fromarray(frames[0]).convert("L"))
    assert isinstance(pil, ArraySource)
    assert next(iter(pil))[1].shape == (32, 32, 3)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setitem(sys.modules, "mss", None)
    for bad, needs in ((0, "ffmpeg"), ("1", "ffmpeg"),
                       ("rtsp://host/cam", "ffmpeg"),
                       ("clip.mp4", "ffmpeg"), ("screen", "mss")):
        with pytest.raises(RuntimeError, match=needs):
            make_source(bad)
    with pytest.raises(TypeError):
        make_source(3.5)
    with pytest.raises(ValueError):
        TensorSource(torch.zeros(2, 2))
