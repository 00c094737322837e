"""The port's host resize (`data/letterbox.resample`, `csrc/resample.c`)
against PIL's `Image.resize` and against its plain version
(`resize_plain`, the same arithmetic in numpy), on the CPU.

Tolerance: none. Every value equals PIL's, byte for byte, for BILINEAR
(the letterbox and mosaic) and BICUBIC (the mask overlays), at 1 and 3
channels, on shrinks, stretches and mixed resizes, down to 1x1 and up from
one row. Where the C cannot be built, `letterbox` raises naming what is
missing and resizes no other way.

This file imports no JAX, so it also runs on the card's machine, which has
no PIL: the PIL cases skip there, in their fixture.
"""

import types

import numpy as np
import pytest
import torch

from mo_yolo_tpu_torch.data import letterbox as lb

torch.set_num_threads(1)

# (source h, w) -> (h, w): shrinks on both axes, a stretch, a resize that
# shrinks one axis by a pixel, extreme shrinks and stretches, and a 1080p
# frame at the 1536x800 letterbox's size
PAIRS = [((150, 211), (64, 96)), ((480, 640), (333, 444)),
         ((40, 60), (160, 240)), ((97, 131), (96, 96)), ((300, 5), (1, 1)),
         ((1, 7), (3, 20)), ((64, 64), (480, 640)),
         ((1080, 1920), (800, 1422))]
# the 1080p frame only where the dataset meets it: bilinear, 3 channels
CASES = [(src, dst, f, c) for src, dst in PAIRS
         for f in ("bilinear", "bicubic") for c in (1, 3)
         if src != (1080, 1920) or (f, c) == ("bilinear", 3)]


def _ids(case):
    (h, w), (oh, ow), f, c = case
    return f"{h}x{w}-{oh}x{ow}-{f}-c{c}"


def _image(hw, c, seed=0):
    shape = hw if c == 1 else (*hw, c)
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.fixture
def pil_image():
    return pytest.importorskip("PIL.Image")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_resample_equals_pil(case, pil_image):
    src, dst, filt, c = case
    img = _image(src, c, seed=src[0])
    want = np.asarray(pil_image.fromarray(img).resize(
        dst[::-1], {"bilinear": pil_image.BILINEAR,
                    "bicubic": pil_image.BICUBIC}[filt]))
    got = lb.resample(img, dst, filt)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES + [
    ((57, 83), (20, 31), "bilinear", 2), ((57, 83), (100, 170), "bicubic", 4),
    ((57, 83), (57, 83), "bicubic", 3), ((57, 83), (57, 40), "bilinear", 3),
    ((57, 83), (90, 83), "bicubic", 1),
    ((160, 160), (1080, 1920), "bicubic", 1)], ids=_ids)
def test_resample_equals_its_plain_version(case):
    """Also at 2 and 4 channels, with neither axis or only one resized, and
    a mask brought to a 1080p frame (both passes split among threads)."""
    src, dst, filt, c = case
    img = _image(src, c, seed=src[1])
    got = lb.resample(img, dst, filt)
    np.testing.assert_array_equal(got, lb.resize_plain(img, dst, filt))
    if src == dst:
        np.testing.assert_array_equal(got, img)


def _no_fallback(monkeypatch):
    """Make F.interpolate and the plain version fail loudly if called."""
    def refuse(*a, **kw):
        raise AssertionError("a resize fell back")
    monkeypatch.setattr(torch.nn.functional, "interpolate", refuse)
    monkeypatch.setattr(lb, "resize_plain", refuse)


@pytest.mark.parametrize("missing", ["compiler", "libm"])
def test_letterbox_without_the_c_raises_naming_what_is_missing(
        monkeypatch, tmp_path, missing):
    """No host compiler (and nothing built before), or a library the
    build needs: `letterbox` raises naming it, and never resizes another
    way."""
    from mo_yolo_tpu_torch.utils import cuda_build
    monkeypatch.setattr(cuda_build, "_loaded_c", {})
    monkeypatch.setattr(cuda_build, "HOST_BUILD_DIR", tmp_path)
    if missing == "compiler":
        monkeypatch.setattr(cuda_build, "shutil",
                            types.SimpleNamespace(which=lambda name: None))
        match = r"no host C compiler \(cc, gcc or clang\)"
    else:
        monkeypatch.setattr(cuda_build, "missing_c_deps",
                            lambda headers=(), libs=(): ["libm"])
        match = "resample.c needs libm"
    _no_fallback(monkeypatch)
    img = _image((48, 64), 3)
    with pytest.raises(RuntimeError, match=match):
        lb.letterbox(img, (32, 32))
    with pytest.raises(RuntimeError, match=match):
        lb.letterbox(img, (32, 40), scale_fill=True)
    # no resize, no C: the input size letterboxes as before
    out, gain, pad = lb.letterbox(img, (48, 64))
    assert gain == (1.0, 1.0) and pad == (0, 0)
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("img", [np.zeros((8, 9, 3), np.float32),
                                 np.zeros((2, 8, 9, 3), np.uint8)],
                         ids=["float32", "batched"])
def test_resample_refuses_what_is_not_uint8_hw_or_hwc(img):
    with pytest.raises(ValueError, match="uint8 HW or HWC"):
        lb.resample(img, (4, 4))
