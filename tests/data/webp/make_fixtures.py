"""Write the WebP fixtures of this folder with PIL (libwebp's encoder), and
`manifest.json`: for each file, its size and the SHA-1 of PIL's decode of
it (`Image.open(path).convert("RGB")`, the JAX package's `load_image`).

    python tests/data/webp/make_fixtures.py

Lossy files at several qualities, methods and sizes (odd ones among them),
lossless ones, both with alpha (transparent pixels too), an animation
whose first frame sits at an offset on its canvas (assembled here from a
lossless frame's bitstream, as PIL writes no such file), a still VP8X file
with ICCP, EXIF and XMP chunks, and two 1080p frames (lossy and lossless)
that `chip_smoke.py`'s `formats` phase times. That phase holds the port's
decoder to the manifest on the card's host, which has no PIL;
`tests/test_torch_port_formats.py` holds the manifest to PIL."""

import hashlib
import io
import json
import struct
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def frame(h, w, seed=0):
    """Gradients, a hashed texture and two boxes (no random generator)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.int64)
    img = np.stack([(x * 255) // max(w - 1, 1), (y * 255) // max(h - 1, 1),
                    ((x * 73856093) ^ (y * 19349663) ^ (seed * 83492791))
                    % 256], -1)
    img[h // 4:h // 2, w // 3:w // 2] = (200, 30 + seed, 90)
    img[h // 2:3 * h // 4, w // 2:w - 1] = (20, 220, 255 - seed)
    return img.astype(np.uint8)


def scene(h=1080, w=1920, seed=0):
    """A MOT-like 1080p scene: smooth background, 20 flat boxes, a fine
    texture and a band of low-amplitude hashed noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.int64)
    img = np.stack([(x * 255) // (w - 1), (y * 255) // (h - 1),
                    ((x + y) * 255) // (w + h)], -1)
    for k in range(20):
        y0, x0 = (k * 977 + seed * 31) % (h - 200), (k * 1543) % (w - 120)
        bh, bw = 60 + (k * 37) % 140, 30 + (k * 53) % 90
        img[y0:y0 + bh, x0:x0 + bw] = ((k * 71) % 256, (k * 113) % 256,
                                       (k * 29) % 256)
    img += (((x // 4) * 7 + (y // 4) * 13) % 9 - 4)[..., None]
    band = slice(h // 2, h // 2 + 64)
    img[band] += (((x[band] * 2654435761) ^ (y[band] * 40503)) % 9 - 4
                  )[..., None]
    return np.clip(img, 0, 255).astype(np.uint8)


def _encode(img, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(body)) + body + b"\x00" * (
        len(body) & 1)


def _riff(chunks: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WEBP" + chunks


def _u24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def _bitstream(webp: bytes):
    """The (fourcc, payload) of a simple WebP file's image chunk."""
    return webp[12:16], webp[20:20 + struct.unpack("<I", webp[16:20])[0]]


def animated_at_offset(canvas=(40, 56), at=(6, 10), seed=3) -> bytes:
    """An animation of two frames on a `canvas` (h, w); the first, smaller
    frame at `at` (y, x, both even), the second the whole canvas."""
    ch, cw = canvas
    f1 = frame(ch - at[0] - 4, cw - at[1] - 6, seed)
    kind1, bits1 = _bitstream(_encode(f1, lossless=True))
    kind2, bits2 = _bitstream(_encode(frame(ch, cw, seed + 1), quality=80))

    def anmf(y, x, h, w, kind, bits):
        return _chunk(b"ANMF", _u24(x // 2) + _u24(y // 2) + _u24(w - 1) +
                      _u24(h - 1) + _u24(100) + b"\x00" +
                      _chunk(kind, bits))
    vp8x = _chunk(b"VP8X", bytes([0x02, 0, 0, 0]) + _u24(cw - 1) +
                  _u24(ch - 1))
    anim = _chunk(b"ANIM", b"\x00\x00\x00\x00" + struct.pack("<H", 0))
    return _riff(vp8x + anim + anmf(*at, *f1.shape[:2], kind1, bits1) +
                 anmf(0, 0, ch, cw, kind2, bits2))


def with_metadata(seed=4) -> bytes:
    """A still VP8X file: ICCP, the VP8 frame, EXIF and XMP chunks."""
    img = frame(23, 31, seed)
    kind, bits = _bitstream(_encode(img, quality=70))
    vp8x = _chunk(b"VP8X", bytes([0x2C, 0, 0, 0]) + _u24(30) + _u24(22))
    return _riff(vp8x + _chunk(b"ICCP", b"\x00" * 13) + _chunk(kind, bits) +
                 _chunk(b"EXIF", b"II*\x00" + b"\x00" * 5) +
                 _chunk(b"XMP ", b"<x:xmpmeta/>"))


def cases():
    """name -> WebP bytes of the fixtures."""
    out = {}
    for q in (5, 50, 75, 95, 100):
        out[f"lossy_q{q}_48x64.webp"] = _encode(frame(48, 64, q), quality=q)
    for (h, w) in ((1, 1), (2, 3), (17, 9), (33, 47), (65, 130)):
        out[f"lossy_q80_{h}x{w}.webp"] = _encode(frame(h, w, h), quality=80)
    for m in (0, 3, 6):
        out[f"lossy_m{m}_40x72.webp"] = _encode(frame(40, 72, m), quality=60,
                                               method=m)
    for (h, w) in ((1, 1), (3, 2), (29, 37)):
        out[f"lossless_{h}x{w}.webp"] = _encode(frame(h, w, w), lossless=True)
    for m, q in ((0, 0), (4, 50), (6, 100)):
        out[f"lossless_m{m}_q{q}_36x52.webp"] = _encode(
            frame(36, 52, m), lossless=True, method=m, quality=q)
    rgba = np.concatenate([frame(30, 44, 7), np.zeros((30, 44, 1), np.uint8)],
                          -1)
    rgba[..., 3] = (np.arange(44) * 6)[None] % 256
    rgba[8:14, 10:30, 3] = 0
    out["alpha_lossy.webp"] = _encode(rgba, quality=85)
    out["alpha_lossless.webp"] = _encode(rgba, lossless=True)
    out["alpha_lossless_exact.webp"] = _encode(rgba, lossless=True,
                                               exact=True)
    out["animated_offset.webp"] = animated_at_offset()
    out["still_vp8x_metadata.webp"] = with_metadata()
    big = scene()
    out["scene_1080p_q90.webp"] = _encode(big, quality=90)
    out["scene_1080p_lossless.webp"] = _encode(big, lossless=True, method=4)
    return out


def main():
    from PIL import Image
    manifest = {}
    for name, blob in cases().items():
        path = HERE / name
        path.write_bytes(blob)
        rgb = np.asarray(Image.open(path).convert("RGB"))
        manifest[name] = {"shape": list(rgb.shape), "bytes": len(blob),
                          "sha1": hashlib.sha1(rgb.tobytes()).hexdigest()}
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1))


if __name__ == "__main__":
    main()
