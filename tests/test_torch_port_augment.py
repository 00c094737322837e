"""The port's training augmentations (`data/augment.py`, `csrc/augment.c`)
and the dataset's augmentation paths against the JAX package's on the CPU.

The same uint8 images, labels and seeded `np.random.Generator` go into both
packages. Tolerances:

- sampled parameters and the draws' order: equal (the generators' states
  are equal afterwards);
- labels within 1e-6 (both compute in float64 / float32 numpy alike:
  measured equal);
- the HSV, L and YCbCr conversions: equal to PIL's on all 2^24 inputs;
- the warp (`Image.transform(AFFINE | PERSPECTIVE, BILINEAR)` in PIL):
  equal, pixel for pixel, at scale < 1 and > 1, with rotation, shear and
  perspective (measured: 0 pixels differ);
- box blur, median filter, CLAHE and the JPEG round trip: equal;
- mosaic: the quadrants are resized with the dataset letterbox's
  `_resize`, PIL's `resize(BILINEAR)` arithmetic in C
  (`csrc/resample.c`), where the JAX package calls PIL: equal, and so is
  the whole pipeline (mosaic, copy-paste, mixup, then the clip
  augmenter's HSV jitter and affine) through `clip_loader`.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _img(h=97, w=131, seed=1):
    """Random pixels with blocks of one colour: edges for the filters."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    for _ in range(20):
        y0, x0 = rng.integers(0, h - 5), rng.integers(0, w - 5)
        img[y0:y0 + rng.integers(3, h // 2),
            x0:x0 + rng.integers(3, w // 2)] = rng.integers(0, 256, 3)
    return img


LAB = np.array([[0, .5, .5, .3, .4, 7], [1, .2, .3, .1, .1, 3],
                [2, .9, .85, .15, .2, 11], [0, .05, .5, .08, .3, 4]],
               np.float32)


def _cube():
    c = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255],
                    -1).astype(np.uint8).reshape(4096, 4096, 3)


@pytest.mark.parametrize("name,src_mode,dst_mode", [
    ("rgb_to_hsv", "RGB", "HSV"), ("hsv_to_rgb", "HSV", "RGB"),
    ("rgb_to_l", "RGB", "L"), ("rgb_to_ycbcr", "RGB", "YCbCr"),
    ("ycbcr_to_rgb", "YCbCr", "RGB")])
def test_colour_conversions_equal_pil_on_every_input(name, src_mode,
                                                     dst_mode):
    """Each conversion on all 2^24 byte triples equals PIL's `convert`."""
    from PIL import Image

    from mo_yolo_tpu_torch.data.augment import _convert
    cube = _cube()
    want = np.asarray(Image.fromarray(cube, src_mode).convert(dst_mode))
    got = _convert(name, cube)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def _equal_draws(a: np.random.Generator, b: np.random.Generator):
    assert a.bit_generator.state == b.bit_generator.state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_hsv_equals_jax(seed):
    from mo_yolo_tpu.data import augment as J
    from mo_yolo_tpu_torch.data import augment as P
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    img = _img(seed=seed)
    got, want = P.random_hsv(img, ra), J.random_hsv(img, rb)
    _equal_draws(ra, rb)
    assert np.array_equal(got, want)


AFFINE_CASES = {
    "shrink": dict(scale=0.5, translate=0.1),           # seed 0: s 0.77
    "grow": dict(scale=0.5, translate=0.1, seed=1),     # s 1.45
    "translate": dict(scale=0.0, translate=0.2),
    "rotate_shear": dict(degrees=30, scale=0.5, shear=10),
    "perspective": dict(degrees=10, scale=0.3, shear=5, perspective=0.001),
    "perspective_grow": dict(perspective=0.002, scale=0.4, seed=1),
}


@pytest.mark.parametrize("case", list(AFFINE_CASES))
def test_random_affine_equals_jax(case):
    """Parameters and draws equal, labels within 1e-6, pixels equal to
    PIL's transform; the returned params re-apply the same warp."""
    from mo_yolo_tpu.data import augment as J
    from mo_yolo_tpu_torch.data import augment as P
    kw = dict(AFFINE_CASES[case])
    seed = kw.pop("seed", 0)
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    img = _img()
    got = P.random_affine(img, LAB, ra, **kw)
    want = J.random_affine(img, LAB, rb, **kw)
    _equal_draws(ra, rb)
    assert got[2] == want[2]
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    assert got[1].shape == want[1].shape
    assert np.array_equal(got[0], want[0])
    again = P.random_affine(img, LAB, None, params=got[2])
    assert np.array_equal(again[0], got[0])


def test_affine_cases_cover_both_scales():
    """The warp cases shrink and grow the image (PIL's transform does not
    widen its filter when it shrinks, so both sides are checked)."""
    from mo_yolo_tpu_torch.data import augment as P
    scales = []
    for kw in AFFINE_CASES.values():
        kw = dict(kw)
        seed = kw.pop("seed", 0)
        scales.append(P.random_affine(_img(), LAB, np.random.default_rng(
            seed), **kw)[2]["s"])
    assert min(scales) < 1 < max(scales)


@pytest.mark.parametrize("fn,k", [("blur", 3), ("blur", 5), ("blur", 7),
                                  ("median_blur", 3), ("median_blur", 5)])
def test_blur_and_median_equal_pil(fn, k):
    from mo_yolo_tpu.data import augment as J
    from mo_yolo_tpu_torch.data import augment as P
    for img in (_img(), _img(9, 8, seed=3)):
        assert np.array_equal(getattr(P, fn)(img, k), getattr(J, fn)(img, k))


def test_gray_clahe_brightness_gamma_equal_jax():
    from mo_yolo_tpu.data import augment as J
    from mo_yolo_tpu_torch.data import augment as P
    img = _img()
    assert np.array_equal(P.to_gray(img), J.to_gray(img))
    assert np.array_equal(P.clahe(img), J.clahe(img))
    assert np.array_equal(P.clahe(_img(40, 23, 4), tiles=4),
                          J.clahe(_img(40, 23, 4), tiles=4))
    assert np.array_equal(P.brightness_contrast(img, 0.1, -0.15),
                          J.brightness_contrast(img, 0.1, -0.15))
    assert np.array_equal(P.gamma(img, 0.85), J.gamma(img, 0.85))


@pytest.mark.parametrize("quality", [75, 90, 100])
def test_jpeg_compression_equals_pil(quality):
    from mo_yolo_tpu.data import augment as J
    from mo_yolo_tpu_torch.data import augment as P
    img = _img()
    assert np.array_equal(P.jpeg_compression(img, quality),
                          J.jpeg_compression(img, quality))


@pytest.mark.parametrize("quality", [1, 50, 95])
def test_jpeg_compression_needs_no_libjpeg(quality, monkeypatch, tmp_path):
    """Where jpeglib.h and libjpeg are missing (the card's machine), the
    JPEG round trip runs all the same, through the port's own codec built
    afresh, and equals the JAX package's."""
    from mo_yolo_tpu.data import augment as J
    from mo_yolo_tpu_torch.data import augment as P
    from tests.torch_port_common import hide_libjpeg
    hide_libjpeg(monkeypatch, tmp_path)
    img = _img()
    assert np.array_equal(P.jpeg_compression(img, quality),
                          J.jpeg_compression(img, quality))


def test_photometrics_sample_and_apply_equal_jax():
    """Every transform on (each probability 1), and the shipped
    probabilities: the same draws, the same image."""
    from mo_yolo_tpu.data import augment as J
    from mo_yolo_tpu_torch.data import augment as P
    on = dict(blur_p=1, median_p=1, gray_p=1, clahe_p=1, bc_p=1, gamma_p=1,
              compression_p=1)
    img = _img()
    for kw in (on, {}):
        for seed in range(3):
            ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
            got, want = P.Photometrics(**kw).sample(ra), \
                J.Photometrics(**kw).sample(rb)
            _equal_draws(ra, rb)
            assert got == want
            assert np.array_equal(P.Photometrics.apply(img, got),
                                  J.Photometrics.apply(img, want))


def test_mixup_and_copy_paste_equal_jax():
    from mo_yolo_tpu.data import augment as J
    from mo_yolo_tpu_torch.data import augment as P
    a, b = _img(seed=1), _img(seed=2)
    ra, rb = np.random.default_rng(5), np.random.default_rng(5)
    got, want = P.mixup(a, LAB, b, LAB[:2], ra), J.mixup(a, LAB, b, LAB[:2],
                                                         rb)
    _equal_draws(ra, rb)
    assert np.array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for p in (0.5, 1.0):
        ra, rb = np.random.default_rng(3), np.random.default_rng(3)
        got, want = P.copy_paste(a, LAB, ra, p=p), J.copy_paste(a, LAB, rb,
                                                                p=p)
        _equal_draws(ra, rb)
        assert np.array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
        assert (got[1][len(LAB):, 5] == -1).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_mosaic_equals_jax_within_a_level(seed):
    """The same centre and placements, labels within 1e-6, the pixels
    equal (the quadrants' resize is PIL's arithmetic)."""
    from mo_yolo_tpu.data import augment as J
    from mo_yolo_tpu_torch.data import augment as P
    imgs = [_img(97, 131, s) for s in range(3)] + [_img(60, 40, 9)]
    labs = [LAB, LAB[:2], np.zeros((0, 6), np.float32), LAB[1:]]
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    got, want = P.mosaic4(imgs, labs, ra, size=96), \
        J.mosaic4(imgs, labs, rb, size=96)
    _equal_draws(ra, rb)
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    assert got[1].shape == want[1].shape


def test_clip_augmenter_freezes_its_parameters_for_a_clip():
    """A 3-frame clip: the same photometric draw, flip, HSV gains and
    affine on every frame in both packages; images equal, labels within
    1e-6, and each frame's track ids the input's, in order, where its box
    survives."""
    from mo_yolo_tpu.data import augment as J
    from mo_yolo_tpu_torch.data import augment as P
    kw = dict(degrees=5.0, translate=0.1, scale=0.3, shear=2.0, seed=4,
              photometrics=None)
    for clip_index in range(4):
        pa, ja = P.ClipAugmenter(**kw), J.ClipAugmenter(**kw)
        pa.begin_clip(clip_index)
        ja.begin_clip(clip_index)
        assert (pa._flip, pa._flipud, pa._hsv_rng_state) == \
            (ja._flip, ja._flipud, ja._hsv_rng_state)
        params = None
        for t in range(3):
            img = _img(seed=10 + t)
            lab = LAB.copy()
            lab[:, 1] += 0.01 * t
            got, want = pa(img, lab), ja(img, lab)
            assert np.array_equal(got[0], want[0])
            np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
            assert set(got[1][:, 5]) <= set(LAB[:, 5])
            order = [list(LAB[:, 5]).index(i) for i in got[1][:, 5]]
            assert order == sorted(order)
            if params is None:
                params = dict(pa._affine_params)
            assert pa._affine_params == params == ja._affine_params
        # the photometric block: its own draw on the clip's generator
        pa2, ja2 = P.ClipAugmenter(seed=4), J.ClipAugmenter(seed=4)
        pa2.begin_clip(clip_index)
        ja2.begin_clip(clip_index)
        assert pa2._photo == ja2._photo


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    from scripts.make_synth_mot import make_mot_fixture

    from mo_yolo_tpu_torch.data.dataset import load_dataset_yaml
    from mo_yolo_tpu_torch.data.mot_challenge import convert_mot_to_yolo
    base = tmp_path_factory.mktemp("augment")
    make_mot_fixture(str(base / "raw"), n_seq=2, size=96, n_frames=6)
    return load_dataset_yaml(convert_mot_to_yolo(str(base / "raw"),
                                                 str(base / "yolo")))["train"]


@pytest.mark.parametrize("multi", [
    dict(), dict(mosaic_p=1.0, copy_paste_p=0.5, mixup_p=1.0, aug_seed=3)])
def test_augmented_clips_and_loader_equal_jax(fixture_files, multi):
    """`TrackDataset(augmenter=..., mosaic_p, mixup_p, copy_paste_p)`
    through `clip_loader` (two epochs' seeds): the JAX clip order and
    batches, labels (cls, ids, mask exactly, boxes within 1e-6) and images
    equal, mosaic's resized quadrants included."""
    from mo_yolo_tpu.data.augment import ClipAugmenter as JAug
    from mo_yolo_tpu.data.dataset import TrackDataset as JDataset
    from mo_yolo_tpu.data.dataset import clip_loader as j_loader
    from mo_yolo_tpu_torch.data.augment import ClipAugmenter
    from mo_yolo_tpu_torch.data.dataset import TrackDataset, clip_loader
    aug = dict(degrees=3.0, translate=0.1, scale=0.3, seed=2)
    kw = dict(imgsz=96, max_gt=12, clip_len=3, **multi)
    ds = TrackDataset(fixture_files, augmenter=ClipAugmenter(**aug), **kw)
    jds = JDataset(fixture_files, augmenter=JAug(**aug), **kw)
    n = 0
    for seed in (5, 6):
        for got, want in zip(clip_loader(ds, 2, seed=seed),
                             j_loader(jds, 2, seed=seed)):
            n += 1
            assert got.keys() == want.keys()
            want_img = np.round(want["images"] * 255).astype(np.uint8)
            np.testing.assert_array_equal(got["images"], want_img)
            for k in ("gt_cls", "gt_track_id", "gt_mask"):
                np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_allclose(got["gt_boxes"], want["gt_boxes"],
                                       atol=1e-6, rtol=0)
    assert n == 2 * (len(ds.clips) // 2) and n > 0
    # the augmenter changed the frames: the plain clip differs
    plain = TrackDataset(fixture_files, imgsz=96, max_gt=12, clip_len=3)
    assert not np.array_equal(plain.load_clip(plain.clips[0])["images"],
                              ds.load_clip(ds.clips[0], 0)["images"])
