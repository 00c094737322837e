"""The port's frame decoding and data modules (`mo_yolo_tpu_torch.data`,
`cfg/datasets.py`) against PIL and the JAX package's data modules, on the
CPU.

- The decoder (`data/loaders.load_image` over `data/decode.py` and
  `data/csrc/decode.c`, built with the host compiler) against PIL's
  `.convert("RGB")`: PNGs PIL wrote (RGB, RGBA, L,
  LA, P at 8 and 4 bits, 1-bit), PNGs this file encodes with each row
  filter, and JPEGs PIL wrote, exactly (the system libjpeg and PIL's
  give the same pixels); 16-bit and interlaced PNGs too
  (`tests/test_torch_port_formats.py` covers every PNG format), and JPEGs
  decode where libjpeg is hidden.
- The host letterbox against the JAX package's (PIL BILINEAR): equal,
  byte for byte, at the input size, on downscales, upscales and
  scale-fill (the resize is PIL's arithmetic in C,
  tests/test_torch_port_resample.py).
- `convert_mot_to_yolo`, `TrackDataset`, `load_dataset_yaml` and the rest
  against the JAX package on `scripts/make_synth_mot.py`'s fixtures.
"""

import os
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_port_common import ROOT

torch.set_num_threads(1)

PNG_MODES = ("RGB", "RGBA", "L", "LA", "P", "P16", "1")
FILTERS = (0, 1, 2, 3, 4, "each")


def _frame(h=37, w=53, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _pil_rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _png_chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body +
            struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def encode_png(img, filters, interlace=0, depth=8):
    """An 8-bit RGB (or gray, for a 2-d array) PNG of `img` whose row y is
    filtered with filters[y % len(filters)]."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    ctype = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1).astype(np.int64)
    out = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            pred = np.array([_paeth(a, b, c) for a, b, c in zip(left, up, ul)])
        out.append(f)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header) +
            _png_chunk(b"IDAT", zlib.compress(bytes(out))) +
            _png_chunk(b"IEND", b""))


# --------------------------------------------------------------- decoder

@pytest.mark.parametrize("mode", PNG_MODES)
def test_png_written_by_pil_decodes_as_pil_converts_it(mode, tmp_path):
    from mo_yolo_tpu_torch.data.loaders import load_image
    a = _frame()
    if mode == "RGBA":
        im = Image.fromarray(np.concatenate([a, a[..., :1]], -1))
    elif mode == "P16":        # a 16-colour palette: PIL writes 4 bits
        im = Image.fromarray(a).quantize(16)
    else:
        im = Image.fromarray(a).convert(mode)
    path = tmp_path / "frame.png"
    im.save(path)
    got = load_image(path)
    assert got.dtype == np.uint8 and got.shape == a.shape
    np.testing.assert_array_equal(got, _pil_rgb(path))


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("gray", [False, True])
def test_png_with_each_row_filter_decodes_exactly(filt, gray, tmp_path):
    """Rows filtered with None, Sub, Up, Average or Paeth, or each in turn,
    decode to the array that was written, as PIL decodes them."""
    from mo_yolo_tpu_torch.data.loaders import load_image
    a = _frame(23, 31, seed=3)
    img = a[..., 1] if gray else a
    path = tmp_path / "frame.png"
    path.write_bytes(encode_png(img, (0, 1, 2, 3, 4) if filt == "each"
                                else (filt,)))
    got = load_image(path)
    want = np.repeat(img[..., None], 3, -1) if gray else img
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _pil_rgb(path))


@pytest.mark.parametrize("quality,subsampling", [(75, 2), (75, 0), (95, 2),
                                                 (95, 0)])
def test_jpeg_written_by_pil_decodes_as_pil_does(quality, subsampling,
                                                 tmp_path):
    """4:2:0 (subsampling 2) and 4:4:4 (0): the port's codec gives PIL's
    pixels."""
    from mo_yolo_tpu_torch.data.loaders import load_image
    path = tmp_path / "frame.jpg"
    Image.fromarray(_frame(45, 61, seed=quality + subsampling)).save(
        path, quality=quality, subsampling=subsampling)
    got = load_image(path)
    np.testing.assert_array_equal(got, _pil_rgb(path))


@pytest.mark.parametrize("what", ["16bit", "interlaced"])
def test_png_the_decoder_does_not_take_raises(what, tmp_path):
    """16-bit and Adam7-interlaced PNGs, once refused, decode to PIL's
    pixels (16-bit grey opens as I;16, whose RGB conversion clips to 255);
    interlaced data too short for its passes raises where PIL raises."""
    from mo_yolo_tpu_torch.data.loaders import load_image
    from tests.test_torch_port_formats import _png
    path = tmp_path / "frame.png"
    if what == "16bit":
        Image.fromarray((_frame()[..., 0].astype(np.uint16) * 129)).save(path)
    else:
        rng = np.random.default_rng(0)
        path.write_bytes(_png(_frame(8, 8), 8, 2, 1, rng))
    np.testing.assert_array_equal(load_image(path), _pil_rgb(path))
    if what == "interlaced":     # rows of a plain image, flagged interlaced
        path.write_bytes(encode_png(_frame(8, 8), (0,), interlace=1))
        with pytest.raises(OSError):
            _pil_rgb(path)
        with pytest.raises(ValueError, match="PNG"):
            load_image(path)


def test_jpeg_decodes_without_libjpeg(tmp_path, monkeypatch):
    """Where libjpeg and jpeglib.h cannot be found (the card's machine), a
    JPEG decodes all the same, through the port's codec built afresh, to
    PIL's pixels; PNG decoding is untouched."""
    from mo_yolo_tpu_torch.data.loaders import load_image
    from tests.torch_port_common import hide_libjpeg
    path = tmp_path / "frame.jpg"
    Image.fromarray(_frame()).save(path)
    Image.fromarray(_frame()).save(tmp_path / "frame.png")
    hide_libjpeg(monkeypatch, tmp_path / "build")
    np.testing.assert_array_equal(load_image(path), _pil_rgb(path))
    assert any((tmp_path / "build").glob("libjpeg-*.so"))
    np.testing.assert_array_equal(load_image(tmp_path / "frame.png"),
                                  _frame())


def test_decoder_builds_once_with_the_host_compiler(tmp_path):
    """The C file is built into build/host_libs under a name keyed by its
    source and flags, and loaded once a process; `.npy` frames load
    through numpy, and BMP and TIFF frames decode to PIL's pixels (TIFF
    through `data/tiff.py`, whose C is built the same way)."""
    from mo_yolo_tpu_torch.data import decode
    from mo_yolo_tpu_torch.data.loaders import load_image
    from mo_yolo_tpu_torch.utils import cuda_build
    a = _frame()
    Image.fromarray(a).save(tmp_path / "frame.png")
    load_image(tmp_path / "frame.png")
    lib = cuda_build.load_c(decode.SRC)
    assert lib is cuda_build.load_c(decode.SRC)
    built = list(cuda_build.HOST_BUILD_DIR.glob("libdecode-*.so"))
    assert Path(lib._name) in built
    np.save(tmp_path / "frame.npy", a)
    np.testing.assert_array_equal(load_image(tmp_path / "frame.npy"), a)
    Image.fromarray(a).save(tmp_path / "frame.bmp")
    np.testing.assert_array_equal(load_image(tmp_path / "frame.bmp"), a)
    Image.fromarray(a).save(tmp_path / "frame.tif")
    np.testing.assert_array_equal(load_image(tmp_path / "frame.tif"), a)
    Image.fromarray(a).save(tmp_path / "lzw.tif", compression="tiff_lzw")
    np.testing.assert_array_equal(load_image(tmp_path / "lzw.tif"), a)
    from mo_yolo_tpu_torch.data import tiff
    assert any(cuda_build.HOST_BUILD_DIR.glob("libtiff-*.so"))
    assert cuda_build.load_c(tiff.SRC) is cuda_build.load_c(tiff.SRC)


# ------------------------------------------------------------- letterbox

@pytest.mark.parametrize("src_hw,new_hw,scale_fill,scaleup", [
    ((96, 96), (96, 96), False, False),    # the input size: identity
    ((96, 128), (64, 64), False, False),   # downscale, padded
    ((120, 90), (64, 96), False, False),
    ((40, 60), (64, 64), False, True),     # upscale
    ((40, 60), (64, 64), False, False),    # no upscale: pad only
    ((72, 100), (48, 64), True, True),     # scale-fill
])
def test_letterbox_matches_the_jax_package(src_hw, new_hw, scale_fill,
                                           scaleup):
    """Gain, padding and every pixel exactly."""
    from mo_yolo_tpu.data.letterbox import letterbox as j_letterbox
    from mo_yolo_tpu_torch.data.letterbox import letterbox
    a = _frame(*src_hw, seed=src_hw[0])
    got, gain, pad = letterbox(a, new_hw, scale_fill=scale_fill,
                               scaleup=scaleup)
    want, j_gain, j_pad = j_letterbox(a, new_hw, scale_fill=scale_fill,
                                      scaleup=scaleup)
    assert gain == j_gain and pad == j_pad
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,imgsz", [((1080, 1920), "1536x800"),
                                      ((480, 640), 640), ((96, 96), 64),
                                      ((100, 37), (64, 96))])
def test_rect_hw_matches_the_jax_package(hw, imgsz):
    from mo_yolo_tpu.data.letterbox import rect_hw as j_rect_hw
    from mo_yolo_tpu_torch.data.letterbox import rect_hw
    assert rect_hw(*hw, imgsz) == j_rect_hw(*hw, imgsz)


# --------------------------------------------------- datasets and yamls

def _tree(root):
    """{relative path: bytes, or the symlink's target name} of a tree."""
    out = {}
    for p in sorted(Path(root).rglob("*")):
        rel = str(p.relative_to(root))
        if p.is_symlink():
            out[rel] = ("link", Path(os.readlink(p)).name)
        elif p.is_file():
            out[rel] = p.read_bytes().replace(str(root).encode(), b"<root>")
    return out


@pytest.fixture(scope="module")
def mot(tmp_path_factory):
    """The MOT-layout fixture (2 sequences x 6 frames, 96x96), converted by
    both packages. Returns (raw root, JAX yaml, port yaml)."""
    from scripts.make_synth_mot import make_mot_fixture

    from mo_yolo_tpu.data.mot_challenge import convert_mot_to_yolo as j_conv
    from mo_yolo_tpu_torch.data.mot_challenge import convert_mot_to_yolo
    base = tmp_path_factory.mktemp("mot")
    make_mot_fixture(str(base / "raw"), n_seq=2, size=96, n_frames=6)
    j_yaml = j_conv(str(base / "raw"), str(base / "jax"))
    p_yaml = convert_mot_to_yolo(str(base / "raw"), str(base / "port"))
    return base, j_yaml, p_yaml


def test_convert_mot_to_yolo_writes_the_jax_tree(mot):
    """The same file tree, the same label bytes, the same lists and yaml
    (with each tree's root in its own paths)."""
    base, _, p_yaml = mot
    jax_tree, port_tree = _tree(base / "jax"), _tree(base / "port")
    assert jax_tree == port_tree
    assert sum(k.startswith("labels/") for k in port_tree) == 12
    assert Path(p_yaml) == base / "port" / "mot_challenge.yaml"


def test_mot_challenge_parsers_match_the_jax_package(mot, tmp_path):
    """parse_seqinfo (with its ini, and without: the sizes then come from
    the first frame, through the port's decoder), read_mot_gt,
    find_sequences and write_mot_gt."""
    import shutil

    from mo_yolo_tpu.data import mot_challenge as jmc
    from mo_yolo_tpu_torch.data import mot_challenge as pmc
    base = mot[0]
    seqs = pmc.find_sequences(str(base / "raw"), "train")
    assert seqs == jmc.find_sequences(str(base / "raw"), "train")
    bare = tmp_path / "bare"
    shutil.copytree(seqs[0], bare)
    (bare / "seqinfo.ini").unlink()
    for seq in (seqs[0], str(bare)):
        assert pmc.parse_seqinfo(seq) == jmc.parse_seqinfo(seq)
    gt = os.path.join(seqs[1], "gt", "gt.txt")
    got, want = pmc.read_mot_gt(gt), jmc.read_mot_gt(gt)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    rows = [[1, 2, 3.5, 4.0, 10, 20, 1, 1, 0.5], [2, 7, 0, 0, 1, 1]]
    pmc.write_mot_gt(str(tmp_path / "p" / "gt.txt"), rows)
    jmc.write_mot_gt(str(tmp_path / "j" / "gt.txt"), rows)
    assert (tmp_path / "p" / "gt.txt").read_bytes() == \
        (tmp_path / "j" / "gt.txt").read_bytes()


def test_write_mot_gt_takes_a_bare_file_name(tmp_path, monkeypatch):
    """A path with no folder writes in the working directory; the JAX
    function still raises on `os.makedirs('')`."""
    from mo_yolo_tpu.data import mot_challenge as jmc
    from mo_yolo_tpu_torch.data import mot_challenge as pmc
    monkeypatch.chdir(tmp_path)
    rows = [[1, 2, 3.5, 4.0, 10, 20, 1, 1, 0.5]]
    pmc.write_mot_gt("gt.txt", rows)
    assert (tmp_path / "gt.txt").read_text() == "1,2,3.5,4,10,20,1,1,0.5\n"
    with pytest.raises(FileNotFoundError):
        jmc.write_mot_gt("jax_gt.txt", rows)


def test_convert_refuses_a_val_split_it_did_not_convert(mot, tmp_path):
    """`val_split` names a split that was not converted: the port raises
    ValueError; the JAX function falls back to the train split's last
    sequence without a word."""
    from mo_yolo_tpu.data.mot_challenge import convert_mot_to_yolo as j_conv
    from mo_yolo_tpu_torch.data.mot_challenge import convert_mot_to_yolo
    raw = str(mot[0] / "raw")
    with pytest.raises(ValueError, match="'tset'"):
        convert_mot_to_yolo(raw, str(tmp_path / "port"), val_split="tset")
    j_yaml = j_conv(raw, str(tmp_path / "jax"), val_split="tset")
    assert "val: val.txt" in Path(j_yaml).read_text()


@pytest.mark.parametrize("rename", ["prefixed", "jpeg"])
def test_convert_takes_prefixed_and_jpeg_frame_names(mot, tmp_path, rename):
    """Frames named `img000001.png` convert to the labels of `000001.png`;
    in flat mode a `.jpeg` frame is named `.jpg`, so that every name is
    15 characters and `name[-15:-4]` is `VVVV_FFFFFF`. The JAX function
    raises on the prefixed names and keeps `.jpeg` (16 characters)."""
    import shutil

    from mo_yolo_tpu.data.mot_challenge import convert_mot_to_yolo as j_conv
    from mo_yolo_tpu_torch.data.mot_challenge import convert_mot_to_yolo
    raw = tmp_path / "raw"
    shutil.copytree(mot[0] / "raw", raw)
    for p in sorted(raw.glob("images/train/*/img1/*.png")):
        p.rename(p.with_name(f"img{p.name}") if rename == "prefixed"
                 else p.with_suffix(".jpeg"))
    flat = rename == "jpeg"
    p_yaml = convert_mot_to_yolo(str(raw), str(tmp_path / "port"), flat=flat)
    want = convert_mot_to_yolo(str(mot[0] / "raw"), str(tmp_path / "orig"),
                               flat=flat)
    got_files = [Path(f) for f in load_list(p_yaml, "train")]
    want_files = [Path(f) for f in load_list(want, "train")]
    assert len(got_files) == len(want_files) == 12
    for g, w in zip(got_files, want_files):
        assert g.with_suffix("").name == w.with_suffix("").name
        assert label_of(g).read_text() == label_of(w).read_text()
        if flat:
            assert g.suffix == ".jpg" and len(g.name) == 15
            vid, frame = g.name[-15:-4].split("_")
            assert len(vid) == 4 and len(frame) == 6
    if rename == "prefixed":
        with pytest.raises(ValueError):
            j_conv(str(raw), str(tmp_path / "jax"), flat=flat)
    else:
        j_yaml = j_conv(str(raw), str(tmp_path / "jax"), flat=flat)
        names = [Path(f).name for f in load_list(j_yaml, "train")]
        assert all(n.endswith(".jpeg") and len(n) == 16 for n in names)


def load_list(yaml_path, split):
    """The image paths of a converted tree's `<split>.txt`."""
    return (Path(yaml_path).parent / f"{split}.txt").read_text().split()


def label_of(img: Path) -> Path:
    """The label file of a converted image (`images/` -> `labels/`)."""
    parts = list(img.parts)
    parts[len(parts) - 1 - parts[::-1].index("images")] = "labels"
    return Path(*parts).with_suffix(".txt")


@pytest.mark.parametrize("imgsz,max_gt,clip_len", [(96, 8, 3), (96, 2, 1),
                                                   ((96, 128), 8, 2)])
def test_track_dataset_gives_the_jax_clips(mot, imgsz, max_gt, clip_len):
    """Same videos, clips and files; cls, track_id and mask exactly, boxes
    within 1e-6, and the uint8 image / 255 equal to the JAX package's
    float image (the fixture's frames need no resize at these sizes)."""
    from mo_yolo_tpu.data.dataset import TrackDataset as JDataset
    from mo_yolo_tpu.data.dataset import load_dataset_yaml as j_load
    from mo_yolo_tpu_torch.data.dataset import TrackDataset, load_dataset_yaml
    files = load_dataset_yaml(mot[2])["train"]
    j_files = j_load(mot[1])["train"]
    assert [Path(f).relative_to(mot[0] / "port") for f in files] == \
        [Path(f).relative_to(mot[0] / "jax") for f in j_files]
    ds = TrackDataset(files, imgsz=imgsz, max_gt=max_gt, clip_len=clip_len)
    jds = JDataset(files, imgsz=imgsz, max_gt=max_gt, clip_len=clip_len)
    assert ds.clips == jds.clips and ds.files == jds.files
    assert list(ds.videos) == list(jds.videos)
    assert len(ds.clips) == 2 * (6 // clip_len)
    for clip in ds.clips:
        got, want = ds.load_clip(clip), jds.load_clip(clip)
        assert got["images"].dtype == np.uint8
        np.testing.assert_array_equal(
            got["images"].astype(np.float32) / 255.0, want["images"])
        for k in ("gt_cls", "gt_track_id", "gt_mask"):
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_allclose(got["gt_boxes"], want["gt_boxes"],
                                   atol=1e-6, rtol=0)
    s, js = ds.load_frame(0), jds.load_frame(0)
    assert (s.orig_hw, s.gain, s.pad, s.path) == \
        (js.orig_hw, js.gain, js.pad, js.path)


def test_track_dataset_options_and_loader_match_the_jax_package(mot):
    """single_cls, the caches, verify and clip_loader's batches; the
    augmentation options are taken, and a clip loaded without a clip index
    is not augmented (tests/test_torch_port_augment.py holds augmented
    clips to the JAX package's)."""
    from mo_yolo_tpu.data.dataset import TrackDataset as JDataset
    from mo_yolo_tpu.data.dataset import clip_loader as j_loader
    from mo_yolo_tpu_torch.data.dataset import (TrackDataset, clip_loader,
                                                load_dataset_yaml)
    files = load_dataset_yaml(mot[2])["train"]
    kw = dict(imgsz=96, max_gt=4, clip_len=2, single_cls=True,
              cache_images=True, verify=True)
    ds, jds = TrackDataset(files, **kw), JDataset(files, **kw)
    for got, want in zip(clip_loader(ds, 2, seed=3),
                         j_loader(jds, 2, seed=3)):
        assert got.keys() == want.keys()
        for k in got:
            if k == "images":
                np.testing.assert_array_equal(got[k] / np.float32(255),
                                              want[k])
            else:
                np.testing.assert_allclose(got[k], want[k], atol=1e-6)
    assert ds._cache_used > 0
    plain = TrackDataset(files, imgsz=96, max_gt=4, clip_len=2)
    want = plain.load_clip(plain.clips[0])
    for opt in (dict(augmenter=object()), dict(mosaic_p=0.5),
                dict(mixup_p=0.5), dict(copy_paste_p=0.5)):
        aug = TrackDataset(files, imgsz=96, max_gt=4, clip_len=2, **opt)
        got = aug.load_clip(aug.clips[0])
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_label_helpers_match_the_jax_package(mot, tmp_path):
    from mo_yolo_tpu.data import dataset as jd
    from mo_yolo_tpu.data.loaders import list_images as j_list
    from mo_yolo_tpu_torch.data import dataset as pd
    from mo_yolo_tpu_torch.data.loaders import list_images
    images = mot[0] / "port" / "images"
    for src in (images, str(images / "train" / "*" / "*.png"),
                mot[0] / "port" / "train.txt"):
        assert list_images(src) == j_list(src)
    for f in list_images(images)[:3] + ["a/images/b/v_000012.jpg", "x.png"]:
        assert pd.img2label_path(f) == jd.img2label_path(f)
        assert pd.video_key(f) == jd.video_key(f)
    lab = tmp_path / "l.txt"
    lab.write_text("0 0.5 0.5 0.1 0.2 3\n1 0.1 0.1 0.05 0.05\n\n")
    for path in (lab, tmp_path / "missing.txt"):
        np.testing.assert_array_equal(pd.load_track_label(str(path)),
                                      jd.load_track_label(str(path)))
    good = list_images(images)[0]
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\nbroken")
    small = tmp_path / "small.png"
    Image.fromarray(_frame(8, 8)).save(small)
    for f in (good, str(bad), str(small)):
        assert pd.verify_image(f) == jd.verify_image(f)


@pytest.mark.parametrize("name", ["MOT", "KITTI", "dancetracker"])
def test_bundled_dataset_configs_equal_the_yaml_files(name):
    """cfg/datasets.py's data equals the JAX package's yaml (read with
    PyYAML), and the flat parser reads the same from the file."""
    import yaml

    from mo_yolo_tpu_torch.cfg.datasets import DATASETS, parse_flat_yaml
    text = (ROOT / "mo_yolo_tpu" / "cfg" / "datasets" /
            f"{name}.yaml").read_text()
    assert DATASETS[name] == yaml.safe_load(text)
    assert parse_flat_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("name", ["MOT", "KITTI", "dancetracker", "synth"])
def test_load_dataset_yaml_matches_the_jax_package(name, tmp_path,
                                                   monkeypatch):
    """The three dataset yamls (their relative `path` resolved from a
    working directory that holds the lists), and `make_dataset`'s yaml;
    the bundled name gives the same as the yaml file."""
    from mo_yolo_tpu.data.dataset import load_dataset_yaml as j_load
    from mo_yolo_tpu_torch.data.dataset import load_dataset_yaml
    monkeypatch.chdir(tmp_path)
    if name == "synth":
        from scripts.make_synth_mot import make_dataset
        path = make_dataset(str(tmp_path / "synth"), size=32, n_frames=2,
                            n_train_seq=1, n_val_seq=1, n_obj=1, nc=2)
        bundled = None
    else:
        path = str(ROOT / "mo_yolo_tpu" / "cfg" / "datasets" / f"{name}.yaml")
        from mo_yolo_tpu_torch.cfg.datasets import DATASETS
        root = tmp_path / DATASETS[name]["path"]
        root.mkdir(parents=True)
        for split in ("train", "val"):
            (root / f"{split}.txt").write_text(
                f"images/{split}/a/000001.jpg\nimages/{split}/a/000002.jpg\n")
        bundled = name
    got = load_dataset_yaml(path)
    assert got == j_load(path)
    assert len(got["train"]) == 2
    if bundled:
        assert load_dataset_yaml(bundled) == got


@pytest.mark.parametrize("text", [
    "path: a\nnames:\n  0:\n    inner: 1\n",     # a map inside `names`
    "a:\n  b:\n    c: 1\n",
    "a: {b: 1}\n",
    "names:\n- person\n",
    "a: [1, [2, 3]]\n",
    "just text\n",
])
def test_flat_yaml_parser_raises_outside_its_subset(text):
    from mo_yolo_tpu_torch.cfg.datasets import parse_flat_yaml
    with pytest.raises(ValueError):
        parse_flat_yaml(text)


def test_flat_yaml_parser_reads_its_subset_as_pyyaml_does():
    import yaml

    from mo_yolo_tpu_torch.cfg.datasets import parse_flat_yaml
    text = ("# a comment\npath: /data/x  # trailing\ntrain: train.txt\n"
            "val: 'v #1.txt'\nnc: 2\nscale: 0.5\nflag: true\nnone:\n"
            "names: [a, b]\nalso:\n  0: person\n  1: \"car\"\n")
    assert parse_flat_yaml(text) == yaml.safe_load(text)
