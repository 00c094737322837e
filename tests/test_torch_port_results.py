"""The port's `TrackResults` (`engine/results.py`), its drawing
(`utils/draw.py`) and image writer (`data/encode.py`) against the JAX
package's `TrackResults`, which draws with PIL, on the CPU.

- `save_txt`: the same bytes, with and without conf, appended twice;
- `plot(show_labels=False)`: the same pixels for line widths 1, 2 and 3,
  boxes across and on the image's borders, thin and empty boxes included;
- `plot()` with labels: the pixels differ only inside the label bands
  (PIL's default font against the port's bitmap font);
- segment mask overlays, masks upscaled, downscaled or at the frame's
  size: the same pixels (both resize by PIL's BICUBIC arithmetic);
- `save_crop`: the same file names and crop shapes;
- the PNG writer: read back equal by the port's decoder and by PIL; with
  libjpeg hidden, `stream(save=True)` writes PIL's JPEG bytes a frame.
"""

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

torch.set_num_threads(1)

H, W = 72, 100


def _results(seed=0, n=12, names=None, dtype=np.float64, hw=(H, W)):
    """Both packages' TrackResults of the same boxes: random ones, some
    across the borders, one on each border, a 1-pixel and an empty box,
    one plain detection (id -1)."""
    from mo_yolo_tpu.engine.results import TrackResults as JResults
    from mo_yolo_tpu_torch.engine.results import TrackResults
    H, W = hw
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-15, W - 5, n)
    y0 = rng.uniform(-15, H - 5, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(1, 40, n),
                      y0 + rng.uniform(1, 30, n)], 1)
    edge = np.array([[0, 0, W - 1, H - 1], [0.0, 10.5, 20.2, 30.7],
                     [W - 20.5, 5.0, W + 0.0, 25.0], [30.3, 40.0, 31.2, 41.1],
                     [50.0, 50.0, 50.0, 50.0], [-3.7, H - 8.2, 12.0, H + 4.0]])
    boxes = np.concatenate([boxes, edge]).astype(dtype)
    m = len(boxes)
    kw = dict(boxes_xyxy=boxes, conf=rng.uniform(0, 1, m).astype(np.float32),
              cls=rng.integers(0, 3, m), track_id=np.r_[rng.integers(
                  0, 40, m - 1), -1], orig_shape=(H, W), path="seq/0007.png",
              names=names, orig_img=rng.integers(0, 256, (H, W, 3),
                                                 dtype=np.uint8))
    return JResults(**kw), TrackResults(**kw)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_save_txt_writes_the_jax_bytes(tmp_path, dtype):
    j, p = _results(dtype=dtype)
    for save_conf in (False, True):
        for name, r in (("j", j), ("p", p)):
            for _ in range(2):          # appends, as the JAX one does
                r.save_txt(tmp_path / f"{name}{save_conf}.txt",
                           save_conf=save_conf)
        got = (tmp_path / f"p{save_conf}.txt").read_bytes()
        assert got == (tmp_path / f"j{save_conf}.txt").read_bytes()
        assert got.count(b"\n") == 2 * len(p)
    np.testing.assert_array_equal(p.boxes_xywhn, j.boxes_xywhn)


def test_save_txt_of_no_boxes_writes_nothing(tmp_path):
    from mo_yolo_tpu_torch.engine.results import TrackResults
    r = TrackResults(np.zeros((0, 4)), np.zeros(0), np.zeros(0, int),
                     np.zeros(0, int), (H, W))
    r.save_txt(tmp_path / "e.txt")
    assert (tmp_path / "e.txt").read_bytes() == b""


@pytest.mark.parametrize("line_width", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_box_plot_is_the_jax_plot_pixel_for_pixel(line_width, seed):
    j, p = _results(seed)
    kw = dict(line_width=line_width, show_labels=False)
    got, want = p.plot(**kw), j.plot(**kw)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)
    assert (got != p.orig_img).any()
    np.testing.assert_array_equal(p.plot(show_labels=False, boxes=False),
                                  p.orig_img)


def _band_mask(r, font_box):
    """Where any box's label may be drawn: PIL's text box and the port's,
    each clipped to the image."""
    mask = np.zeros(r.orig_shape, bool)
    for i, b in enumerate(r.boxes_xyxy):
        x, y = float(b[0]), max(0.0, float(b[1]) - 12)
        for x0, y0, x1, y1 in font_box(i, x, y):
            mask[max(int(y0), 0):max(int(np.ceil(y1)), 0),
                 max(int(x0), 0):max(int(np.ceil(x1)), 0)] = True
    return mask


def test_labelled_plot_differs_only_in_the_label_bands():
    from mo_yolo_tpu_torch.utils import draw
    j, p = _results(2, n=6, names={0: "person", 1: "car"}, hw=(240, 320))
    got, want = p.plot(line_width=2), j.plot(line_width=2)
    probe = ImageDraw.Draw(Image.new("RGB", (320, 240)))

    def label(i):
        tid = int(p.track_id[i])
        name = p._name(i)
        return (f"id:{tid} {name}" if tid >= 0 else name) + \
            f" {p.conf[i]:.2f}"

    def boxes(i, x, y):
        h, w = draw.text_mask(label(i)).shape
        return [probe.textbbox((x, y), label(i)),
                (int(x), int(y), int(x) + w, int(y) + h)]
    mask = _band_mask(p, boxes)
    assert mask.mean() < 0.3
    np.testing.assert_array_equal(got[~mask], want[~mask])
    assert (got[mask] != p.orig_img[mask]).any()   # the labels are drawn


def _soft_masks(n, hw, seed):
    """n float masks in [0, 1]: soft ellipses with some values flipped, so
    that the threshold at 0.5 and the resize both meet edges."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]] / np.asarray(hw, float)[:, None, None]
    out = []
    for _ in range(n):
        cy, cx, ry, rx = rng.uniform([0.2, 0.2, 0.1, 0.1], [0.8, 0.8, 0.5,
                                                            0.5])
        d = np.hypot((yy - cy) / ry, (xx - cx) / rx)
        m = np.clip(1.5 - d, 0.0, 1.0)
        flip = rng.uniform(size=hw) < 0.03
        m[flip] = 1.0 - m[flip]
        out.append(m)
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("mask_hw,hw", [((40, 60), (160, 240)),
                                        ((160, 160), (120, 200)),
                                        ((120, 200), (120, 200))],
                         ids=["upscaled", "downscaled", "same"])
def test_mask_overlay_is_the_jax_plot_pixel_for_pixel(mask_hw, hw):
    """`plot(boxes=False, show_labels=False)` of a segment result: every
    mask thresholded, brought to the frame's size and blended exactly as
    the JAX plot does."""
    j, p = _results(4, n=4, hw=hw)
    masks = _soft_masks(len(p), mask_hw, seed=mask_hw[0])
    j.masks, p.masks = masks, masks
    kw = dict(boxes=False, show_labels=False)
    got, want = p.plot(**kw), j.plot(**kw)
    assert got.dtype == np.uint8 and got.shape == (*hw, 3)
    np.testing.assert_array_equal(got, want)
    assert (got != p.orig_img).mean() > 0.05       # the overlays are drawn


def test_save_crop_names_and_shapes_equal_the_jax_ones(tmp_path):
    j, p = _results(3, names={0: "person", 1: "car", 2: "bike"})
    j.save_crop(tmp_path / "j", file_name="f7")
    p.save_crop(tmp_path / "p", file_name="f7")

    def listing(root):
        return {str(f.relative_to(root)): np.asarray(Image.open(f)).shape
                for f in sorted(root.rglob("*.jpg"))}
    got, want = listing(tmp_path / "p"), listing(tmp_path / "j")
    assert got == want and len(got) > 5


@pytest.mark.parametrize("shape", [(37, 53, 3), (1, 1, 3), (20, 31)])
def test_png_writer_round_trips_through_the_decoder_and_pil(tmp_path, shape):
    from mo_yolo_tpu_torch.data.decode import decode_png
    from mo_yolo_tpu_torch.data.encode import write_image
    img = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    path = write_image(tmp_path / "a.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    rgb = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
    np.testing.assert_array_equal(
        decode_png((tmp_path / "a.png").read_bytes()), rgb)


def test_save_writes_the_plot_and_refuses_other_suffixes(tmp_path):
    from mo_yolo_tpu_torch.data.loaders import load_image
    _, p = _results(5)
    out = p.save(tmp_path / "f" / "x.png", line_width=3)
    np.testing.assert_array_equal(load_image(out), p.plot(line_width=3))
    with pytest.raises(ValueError, match="written as"):
        p.save(tmp_path / "x.bmp")
    jpg = np.asarray(Image.open(p.save(tmp_path / "x.jpg")))
    assert jpg.shape == (H, W, 3)


def test_jpeg_save_without_libjpeg_writes_every_frame(monkeypatch,
                                                     tmp_path):
    """Where jpeglib.h and libjpeg are missing (the card's machine),
    `stream(save=True)` at the default format writes one JPEG a frame
    through the port's own codec: PIL's bytes for the plotted frame, read
    back by the port's decoder as PIL reads them; crops are JPEGs too."""
    import io

    from mo_yolo_tpu_torch.data.loaders import load_image
    from mo_yolo_tpu_torch.engine.predictor import TrackPredictor
    from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
    from tests.torch_port_common import hide_libjpeg
    hide_libjpeg(monkeypatch, tmp_path / "build")
    model = build_tracking_model("tiny_track", device="cpu", nq=8)
    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                               np.uint8)
    pred = TrackPredictor(model, imgsz=64, device="cpu", conf=0.0)
    out = tmp_path / "pred"
    results = list(pred.stream(frames, save=True, save_crop=True,
                               save_dir=str(out)))
    assert len(results) == len(sorted(out.glob("*.jpg"))) == len(frames)
    for res in results:
        path = out / f"{res.path}.jpg"
        buf = io.BytesIO()
        Image.fromarray(res.plot(line_width=2)).save(buf, "JPEG")
        assert path.read_bytes() == buf.getvalue()
        np.testing.assert_array_equal(
            load_image(path), np.asarray(Image.open(path).convert("RGB")))
    crops = sorted((out / "crops").rglob("*.jpg"))
    assert crops and all(load_image(c).ndim == 3 for c in crops)
