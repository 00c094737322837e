"""The port's frame sources (`mo_yolo_tpu_torch/data/loaders.py`: video
files, URL streams, webcams, screenshots, PIL images) against the JAX
package's, fed by the same stand-in ffmpeg/ffprobe (`tests/ffmpeg_stub.py`)
and a stand-in `mss` module; and the port's `TrackPredictor` over a video
file at `vid_stride=2` against the JAX one."""

import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

from tests import ffmpeg_stub

torch.set_num_threads(1)

HW = (12, 16)


def _clip(n, hw=HW, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3),
                                                dtype=np.uint8)


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """The stand-in binaries first on PATH; their calls logged."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    ffmpeg_stub.install(bindir)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    log = tmp_path / "calls.jsonl"
    monkeypatch.setenv(ffmpeg_stub.LOG_ENV, str(log))
    monkeypatch.delenv(ffmpeg_stub.FPS_ENV, raising=False)

    def calls():
        return [json.loads(line) for line in log.read_text().splitlines()] \
            if log.exists() else []
    return calls


def _packages():
    from mo_yolo_tpu.data import loaders as jl
    from mo_yolo_tpu_torch.data import loaders as pl
    return jl, pl


def _ended(pid, timeout=10.0):
    """Whether process `pid` has exited (gone or a zombie) within
    `timeout` seconds."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    return True
        except FileNotFoundError:
            return True
        time.sleep(0.02)
    return False


@pytest.mark.parametrize("stride", [1, 3])
def test_video_source_matches_jax(stub, tmp_path, stride):
    """Frames, names and len of a 7-frame clip, every `stride`-th frame."""
    jl, pl = _packages()
    frames = _clip(7)
    path = str(tmp_path / "clip.mp4")
    with open(path, "wb") as f:
        np.save(f, frames)
    want = jl.make_source(path, vid_stride=stride)
    got = pl.make_source(path, vid_stride=stride)
    assert isinstance(got, pl.VideoSource)
    assert len(got) == len(want) == len(range(0, 7, stride))
    w, g = list(want), list(got)
    assert [n for n, _ in g] == [n for n, _ in w] == [
        f"{path}#{i:06d}" for i in range(0, 7, stride)]
    for (_, a), (_, b), i in zip(g, w, range(0, 7, stride)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, frames[i])


def test_webcam_command_and_size(stub, tmp_path, monkeypatch):
    """A webcam index (int or digit string) opens /dev/video<N> through
    v4l2 at 640x480, with the JAX package's command line."""
    jl, pl = _packages()
    cam = _clip(2, (480, 640), seed=1)
    np.save(tmp_path / "cam.npy", cam)
    monkeypatch.setenv(ffmpeg_stub.STREAM_ENV, str(tmp_path / "cam.npy"))
    for source in (0, "1"):
        runs = []
        for mod in (jl, pl):
            src = mod.make_source(source)
            assert (src.w, src.h) == (640, 480)
            runs.append(list(src))
            assert stub()[-1]["argv"] == [
                "-v", "error", "-f", "v4l2", "-i", f"/dev/video{source}",
                "-f", "rawvideo", "-pix_fmt", "rgb24", "-"]
        assert [n for n, _ in runs[0]] == [n for n, _ in runs[1]]
        for _, frame in runs[1]:       # each the last frame or one before
            assert any((frame == c).all() for c in cam)
    assert not any(c["tool"] == "ffprobe" for c in stub())


def test_stream_keeps_the_latest_frames(stub, tmp_path, monkeypatch):
    """A URL stream: probed for its size, read by a thread that keeps only
    the latest frame; a slow reader gets an ordered subset of the frames,
    `max_frames` of them, named as the JAX package names them."""
    jl, pl = _packages()
    served = _clip(40, seed=2)
    np.save(tmp_path / "s.npy", served)
    monkeypatch.setenv(ffmpeg_stub.STREAM_ENV, str(tmp_path / "s.npy"))
    monkeypatch.setenv(ffmpeg_stub.FPS_ENV, "400")
    url = "rtsp://camera.local/stream"
    names = []
    for mod in (jl, pl):
        src = mod.StreamSource(url, max_frames=5)
        assert (src.w, src.h) == (HW[1], HW[0])
        got = []
        for name, frame in src:
            got.append((name, frame))
            time.sleep(0.02)           # slower than the stream: drops
        names.append([n for n, _ in got])
        idx = [next(i for i, s in enumerate(served) if (s == f).all())
               for _, f in got]
        assert idx == sorted(set(idx)) and len(idx) == 5
        assert idx[-1] > 4             # frames were dropped, not queued
    assert names[0] == names[1] == [f"{url}#{i:06d}" for i in range(5)]
    assert isinstance(pl.make_source(url), pl.StreamSource)


@pytest.mark.parametrize("kind", ["video", "stream"])
def test_closed_source_leaves_no_ffmpeg(stub, tmp_path, monkeypatch, kind):
    """A generator closed after its first frame ends its ffmpeg process,
    in both packages."""
    jl, pl = _packages()
    frames = _clip(200, seed=3)
    path = str(tmp_path / "long.avi")
    with open(path, "wb") as f:
        np.save(f, frames)
    monkeypatch.setenv(ffmpeg_stub.STREAM_ENV, path)
    for mod in (jl, pl):
        src = mod.VideoSource(path) if kind == "video" else \
            mod.StreamSource("udp://0.0.0.0:5000")
        gen = iter(src)
        name, frame = next(gen)
        assert name.endswith("#000000")
        gen.close()
        pid = [c for c in stub() if c["tool"] == "ffmpeg"][-1]["pid"]
        assert _ended(pid), f"{mod.__name__}: ffmpeg {pid} still runs"


def _fake_mss(grabs):
    """A stand-in `mss` module: two monitors, grabs recorded, BGRA frames
    whose values encode the region."""
    class Shot:
        def __init__(self, mon):
            h, w = mon["height"], mon["width"]
            b = np.zeros((h, w, 4), np.uint8)
            b[..., 0] = mon["left"] % 256
            b[..., 1] = mon["top"] % 256
            b[..., 2] = np.arange(w, dtype=np.uint8)[None]
            b[..., 3] = 255
            self.b = b

        def __array__(self, dtype=None, copy=None):
            return self.b

    class Grabber:
        monitors = [{"left": 0, "top": 0, "width": 64, "height": 48},
                    {"left": 10, "top": 20, "width": 32, "height": 24}]

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def grab(self, mon):
            grabs.append(dict(mon))
            return Shot(mon)

    return types.SimpleNamespace(mss=Grabber)


def test_screenshot_region(monkeypatch):
    """`screen 1 3 4 8 6`: monitor 1, a region at (3, 4) of 8x6, BGRA to
    RGB; the JAX package grabs the same regions and frames."""
    jl, pl = _packages()
    runs = []
    for mod in (jl, pl):
        grabs = []
        monkeypatch.setitem(sys.modules, "mss", _fake_mss(grabs))
        src = mod.make_source("screen 1 3 4 8 6")
        src.max_frames = 2
        runs.append((grabs, list(src)))
    (jg, jf), (pg, pf) = runs
    assert pg == jg == [{"left": 13, "top": 24, "width": 8, "height": 6}] * 2
    assert [n for n, _ in pf] == [n for n, _ in jf] == ["screen_000000",
                                                         "screen_000001"]
    for (_, a), (_, b) in zip(pf, jf):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pf[0][1][0, :, 0], np.arange(8))
    assert (pf[0][1][..., 2] == 13).all()
    whole = pl.ScreenshotSource("screen", max_frames=1)
    assert whole.monitor == 0 and whole.region is None


def test_missing_tools_raise_as_jax(tmp_path, monkeypatch):
    """Without ffmpeg/ffprobe on PATH, or without `mss`, both packages
    raise the same exception type for each source."""
    jl, pl = _packages()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setitem(sys.modules, "mss", None)
    for source in ("clip.mp4", "rtsp://h/s", "http://h/s.m3u8", 0, "2",
                   "screen", "screen 0 1 2 3 4"):
        kinds = []
        for mod in (jl, pl):
            with pytest.raises(Exception) as e:
                mod.make_source(source)
            kinds.append(type(e.value))
        assert kinds[0] is kinds[1] is RuntimeError, (source, kinds)


def test_pil_images_as_jax():
    """A PIL image and a list of them: frames as the JAX package's."""
    from PIL import Image
    jl, pl = _packages()
    frames = _clip(3, seed=4)
    ims = [Image.fromarray(f) for f in frames]
    ims[1] = ims[1].convert("L")
    for source in (ims[0], ims):
        got, want = list(pl.make_source(source)), list(jl.make_source(source))
        assert isinstance(pl.make_source(source), pl.ArraySource)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_video_track_predictor_matches_jax(stub, tmp_path):
    """The port's TrackPredictor over a video file at vid_stride=2 against
    the JAX one (device_preprocess=True) over the same file: the same
    paths, ids and classes, boxes within 1e-3 and conf within 1e-5 (the
    tolerances of test_torch_port_stream's predictor test; the frames are
    half the 64x96 input, an exact 2x upscale in both letterboxes)."""
    from mo_yolo_tpu.engine.predictor import TrackPredictor as JPredictor
    from mo_yolo_tpu_torch.engine.predictor import TrackPredictor, frame_stem
    from tests.torch_port_common import build_pair
    jm, v, pm = build_pair(image_hw=(64, 96), score_bias=0.3,
                           compile_init=False)
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (32, 48, 3)).astype(np.int16)
    frames = np.stack([np.clip(base + rng.integers(-3, 4, base.shape), 0,
                               255).astype(np.uint8) for _ in range(7)])
    path = str(tmp_path / "clip.mp4")
    with open(path, "wb") as f:
        np.save(f, frames)
    want = list(JPredictor(jm, v, imgsz=(64, 96), conf=0.5, vid_stride=2,
                           device_preprocess=True).stream(path))
    got = list(TrackPredictor(pm, imgsz=(64, 96), conf=0.5, vid_stride=2,
                              device="cpu").stream(path))
    assert [g.path for g in got] == [w.path for w in want] == [
        f"{path}#{i:06d}" for i in range(0, 7, 2)]
    assert sum(len(r) for r in want) > 0
    for g, w, i in zip(got, want, range(0, 7, 2)):
        np.testing.assert_array_equal(g.orig_img, frames[i])
        np.testing.assert_array_equal(g.track_id, w.track_id)
        np.testing.assert_array_equal(g.cls, w.cls)
        np.testing.assert_allclose(g.boxes_xyxy, w.boxes_xyxy, atol=1e-3)
        np.testing.assert_allclose(g.conf, w.conf, atol=1e-5)
    assert [frame_stem(g.path, n) for n, g in enumerate(got)] == [
        f"clip_{n:06d}" for n in range(4)]


def test_cli_track_predict_routes_vid_stride(monkeypatch, tmp_path):
    """`track predict vid_stride=3` reaches `MOTRTrack.predict` (through
    `route_kwargs` and the facade's own signature)."""
    import functools

    from mo_yolo_tpu_torch import api, cli
    seen = {}
    real = api.MOTRTrack.predict

    @functools.wraps(real)
    def predict(self, source, **kw):
        seen.update(kw, source=source)
        return iter(())
    monkeypatch.setattr(api.MOTRTrack, "__init__",
                        lambda self, *a, **kw: None)
    monkeypatch.setattr(api.MOTRTrack, "predict", predict)
    assert cli.main(["track", "predict", "source=clip.mp4", "vid_stride=3",
                     f"save_dir={tmp_path}", "device=cpu"]) == 0
    assert seen["source"] == "clip.mp4" and seen["vid_stride"] == 3
