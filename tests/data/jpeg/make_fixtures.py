"""Write the JPEG fixtures of this folder with PIL, and `manifest.json`:
for each file, its size and the SHA-1 of PIL's decode of it
(`Image.open(path).convert("RGB")`, the JAX package's `load_image`).

    python tests/data/jpeg/make_fixtures.py

`chip_smoke.py`'s `jpeg` phase holds the port's decoder to the manifest on
the card's host, which has no PIL; `tests/test_torch_port_jpeg.py` holds
the manifest to PIL. The frames are integer patterns (gradients, boxes, a
checkerboard and a hashed texture), so they need no random generator."""

import hashlib
import json
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent


def frame(h, w, seed=0):
    y, x = np.mgrid[0:h, 0:w].astype(np.int64)
    img = np.stack([(x * 255) // max(w - 1, 1), (y * 255) // max(h - 1, 1),
                    np.full_like(x, 40 + 50 * (seed % 4))], -1)
    img += (((x * 73856093) ^ (y * 19349663) ^ (seed * 83492791)) % 23 -
            11)[..., None]
    k = (seed % 3) + 2
    img[(x // k + y // k) % 2 == 0] //= 2                 # a checkerboard
    img[h // 4:h // 2, w // 3:w // 2] = (200, 30 + seed, 90)
    img[h // 2:3 * h // 4, w // 2:w - 2] = (20, 220, 255 - seed)
    return np.clip(img, 0, 255).astype(np.uint8)


# name -> (height, width, mode, save options)
FIXTURES = {
    "baseline_444.jpg": (48, 64, "RGB", dict(quality=90, subsampling=0)),
    "baseline_422.jpg": (45, 61, "RGB", dict(quality=75, subsampling=1)),
    "baseline_420.jpg": (37, 53, "RGB", dict(quality=75, subsampling=2)),
    "grey.jpg": (40, 50, "L", dict(quality=85)),
    "odd_1x1.jpg": (1, 1, "RGB", dict(quality=75)),
    "odd_2x3.jpg": (2, 3, "RGB", dict(quality=50)),
    "odd_17x9.jpg": (17, 9, "RGB", dict(quality=95, subsampling=1)),
    "q100_444.jpg": (24, 40, "RGB", dict(quality=100, subsampling=0)),
    "optimized.jpg": (48, 64, "RGB", dict(quality=80, optimize=True)),
    "restart_blocks.jpg": (40, 56, "RGB",
                           dict(quality=85, restart_marker_blocks=3)),
    "restart_rows.jpg": (40, 56, "RGB",
                         dict(quality=85, restart_marker_rows=1)),
    "progressive.jpg": (48, 64, "RGB", dict(quality=85, progressive=True)),
    "progressive_optimized.jpg": (41, 59, "RGB",
                                  dict(quality=70, progressive=True,
                                       optimize=True)),
    "progressive_grey.jpg": (33, 47, "L", dict(quality=90,
                                               progressive=True)),
}


def main():
    manifest = {}
    for i, (name, (h, w, mode, opts)) in enumerate(FIXTURES.items()):
        im = Image.fromarray(frame(h, w, i))
        if mode == "L":
            im = im.convert("L")
        im.save(HERE / name, "JPEG", **opts)
        rgb = np.asarray(Image.open(HERE / name).convert("RGB"))
        manifest[name] = {"shape": list(rgb.shape),
                          "bytes": (HERE / name).stat().st_size,
                          "sha1": hashlib.sha1(rgb.tobytes()).hexdigest()}
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1) +
                                        "\n")


if __name__ == "__main__":
    main()
