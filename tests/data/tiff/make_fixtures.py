"""Write the TIFF fixtures of this folder with the small TIFF writer below,
and `manifest.json`: for each file, its size and the SHA-1 of PIL's decode
of it (`Image.open(path).convert("RGB")`, the JAX package's `load_image`).

    python tests/data/tiff/make_fixtures.py

PIL writes few of the layouts a TIFF may hold (tiles, planar
configuration 2, the predictor, fill order 2, both byte orders), so
`write_tiff` writes them: strips or tiles, chunky or planar, uncompressed,
PackBits, LZW (TIFF 6.0, early change) or Deflate, any of the photometric
interpretations the port takes. `chip_smoke.py`'s `formats` phase holds
the port's decoder to the manifest on the card's host, which has no PIL;
`tests/test_torch_port_formats.py` holds the manifest to PIL and writes
more cases with `write_tiff`."""

import hashlib
import json
import struct
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def frame(h, w, c=3, seed=0):
    """An integer pattern: gradients, a hashed texture and two boxes."""
    y, x = np.mgrid[0:h, 0:w].astype(np.int64)
    chans = [(x * 255) // max(w - 1, 1), (y * 255) // max(h - 1, 1),
             ((x * 73856093) ^ (y * 19349663) ^ (seed * 83492791)) % 256,
             (x + 2 * y + 17 * seed) % 256]
    img = np.stack(chans[:c] if c <= 4 else chans * 2, -1)[..., :c]
    img[h // 4:h // 2, w // 3:w // 2] = (np.arange(c) * 60 + seed) % 256
    return img.astype(np.uint8)


def lzw(data: bytes) -> bytes:
    """TIFF LZW: MSB-first codes of 9-12 bits, early change, a Clear code
    first and whenever the table fills."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, bits):
        nonlocal acc, nacc
        acc, nacc = (acc << bits) | code, nacc + bits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)

    table, nxt, bits = {bytes([i]): i for i in range(256)}, 258, 9
    put(256, bits)
    cur = b""
    for b in data:
        s = cur + bytes([b])
        if s in table:
            cur = s
            continue
        put(table[cur], bits)
        table[s] = nxt
        nxt += 1
        if nxt >= 4094:
            put(256, bits)
            table, nxt, bits = {bytes([i]): i for i in range(256)}, 258, 9
        elif nxt > (1 << bits) - 1:
            bits += 1
        cur = bytes([b])
    if cur:
        put(table[cur], bits)
        nxt += 1
        if nxt >= 4094:
            put(256, bits)
            bits = 9
        elif nxt > (1 << bits) - 1:
            bits += 1
    put(257, bits)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:                                   # a run of j - i + 1
            out += bytes([(257 - (j - i + 1)) & 0xFF, data[i]])
            i = j + 1
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and
                                             data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _pack(samples: np.ndarray, bits: int) -> bytes:
    """[rows, n] samples -> rows packed MSB first, each to whole bytes."""
    if bits == 8:
        return samples.astype(np.uint8).tobytes()
    b = np.unpackbits(samples.astype(np.uint8)[..., None], axis=-1)
    b = b[..., 8 - bits:].reshape(samples.shape[0], -1)
    return np.packbits(b, axis=1).tobytes()


def write_tiff(px, photometric, bits=8, compression=1, order="<",
               tile=None, rows_per_strip=None, planar=1, predictor=1,
               fill=1, extra=None, colormap=None, orientation=None,
               sample_format=None, extra_tags=()):
    """The bytes of a TIFF of `px` (uint8 [h, w, samples] sample values
    below 2**bits): one IFD, its data after it."""
    h, w, spp = px.shape
    tw, th = tile if tile else (w, rows_per_strip or h)
    across, down = -(-w // tw), -(-h // th)
    planes = spp if planar == 2 else 1
    per = 1 if planar == 2 else spp
    chunks = []
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                sub = np.zeros((th, tw, per), np.int64)
                part = px[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw,
                          p:p + per] if planar == 2 else \
                    px[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
                sub[:part.shape[0], :part.shape[1]] = part
                if not tile:
                    sub = sub[:part.shape[0]]
                if predictor == 2:
                    d = sub.copy()
                    d[:, 1:] = sub[:, 1:] - sub[:, :-1]
                    sub = d % 256
                raw = _pack(sub.reshape(sub.shape[0], -1), bits)
                if compression == 1:
                    if fill == 2:
                        raw = REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
                    chunks.append(raw)
                    continue
                coded = {5: lzw, 32773: packbits,
                         8: zlib.compress, 32946: zlib.compress}[
                    compression](raw)
                if fill == 2:
                    coded = REVERSE[np.frombuffer(coded, np.uint8)].tobytes()
                chunks.append(coded)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if fill != 1:
        tags[266] = (3, [fill])
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra is not None:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, list(colormap))
    if orientation is not None:
        tags[274] = (3, [orientation])
    if sample_format is not None:
        tags[339] = (3, list(sample_format))
    for tag, typ, vals in extra_tags:
        tags[tag] = (typ, list(vals))
    counts = [len(c) for c in chunks]
    if tile:
        tags[322], tags[323] = (3, [tw]), (3, [th])
        off_tag, cnt_tag = 324, 325
    else:
        tags[278] = (4, [th])
        off_tag, cnt_tag = 273, 279
    tags[off_tag] = (4, [0] * len(chunks))
    tags[cnt_tag] = (4, counts)
    size = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8}
    code = {1: "B", 2: "B", 3: "H", 4: "I"}
    n = len(tags)
    ifd_len = 2 + 12 * n + 4
    extra_at = 8 + ifd_len
    blobs = []
    for tag in sorted(tags):
        typ, vals = tags[tag]
        nbytes = size[typ] * len(vals)
        if nbytes > 4:
            blobs.append((tag, extra_at))
            extra_at += nbytes + (nbytes & 1)
    data_at = extra_at
    offsets = []
    for c in chunks:
        offsets.append(data_at)
        data_at += len(c)
    tags[off_tag] = (4, offsets)
    out = bytearray((b"II*\x00" if order == "<" else b"MM\x00*") +
                    struct.pack(order + "I", 8))
    out += struct.pack(order + "H", n)
    tail = bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        body = struct.pack(order + code[typ] * len(vals), *vals)
        if len(body) > 4:
            out += struct.pack(order + "HHII", tag, typ, len(vals),
                               8 + ifd_len + len(tail))
            tail += body + b"\x00" * (len(body) & 1)
        else:
            out += struct.pack(order + "HHI", tag, typ, len(vals)) + \
                body.ljust(4, b"\x00")
    out += struct.pack(order + "I", 0) + tail
    for c in chunks:
        out += c
    return bytes(out)


def colormap(bits, seed=0):
    n = 1 << bits
    rng = np.random.default_rng(seed)
    return rng.integers(0, 65536, 3 * n).tolist()


def cases():
    """name -> TIFF bytes of the committed fixtures: each compression with
    strips, several strips, tiles and planar configuration 2, each
    photometric interpretation, both byte orders, the predictor, fill
    order 2 and an orientation."""
    rgb = frame(37, 45)
    out = {}
    for comp, cname in ((1, "raw"), (32773, "packbits"), (5, "lzw"),
                        (8, "deflate"), (32946, "deflate_old")):
        out[f"rgb_{cname}_strip.tif"] = write_tiff(rgb, 2, compression=comp)
        out[f"rgb_{cname}_strips7_mm.tif"] = write_tiff(
            rgb, 2, compression=comp, rows_per_strip=7, order=">")
        out[f"rgb_{cname}_tiles16.tif"] = write_tiff(
            rgb, 2, compression=comp, tile=(16, 16))
        out[f"rgb_{cname}_planar.tif"] = write_tiff(
            rgb, 2, compression=comp, planar=2, rows_per_strip=10)
    for comp, cname in ((5, "lzw"), (8, "deflate")):
        out[f"rgb_{cname}_predictor.tif"] = write_tiff(
            rgb, 2, compression=comp, predictor=2, rows_per_strip=9)
        out[f"rgba_{cname}_predictor_tiles.tif"] = write_tiff(
            frame(29, 35, 4, seed=1), 2, compression=comp, predictor=2,
            tile=(16, 32), extra=[2])
    g = frame(33, 41, 1, seed=2)
    out["grey8_biz_lzw.tif"] = write_tiff(g, 1, compression=5)
    out["grey8_wiz_raw.tif"] = write_tiff(g, 0)
    out["grey4_biz_packbits.tif"] = write_tiff(g >> 4, 1, bits=4,
                                               compression=32773)
    out["grey2_wiz_deflate.tif"] = write_tiff(g >> 6, 0, bits=2,
                                              compression=8)
    out["bilevel_wiz_packbits.tif"] = write_tiff(g >> 7, 0, bits=1,
                                                 compression=32773)
    out["bilevel_biz_raw_fill2.tif"] = write_tiff(g >> 7, 1, bits=1,
                                                  fill=2)
    out["grey8_lzw_fill2.tif"] = write_tiff(g, 1, compression=5, fill=2)
    out["la_deflate.tif"] = write_tiff(frame(21, 19, 2, seed=3), 1,
                                       compression=8, extra=[2])
    out["rgbx_raw.tif"] = write_tiff(frame(21, 19, 4, seed=4), 2,
                                     extra=[0])
    out["rgba_assoc_lzw.tif"] = write_tiff(frame(21, 19, 4, seed=5), 2,
                                           compression=5, extra=[1])
    out["rgba_noextra_raw.tif"] = write_tiff(frame(21, 19, 4, seed=6), 2)
    for bits in (1, 4, 8):
        out[f"palette{bits}_lzw.tif"] = write_tiff(
            g >> (8 - bits), 3, bits=bits, compression=5,
            colormap=colormap(bits, bits))
    out["palette8_extra_raw.tif"] = write_tiff(
        frame(21, 19, 2, seed=7), 3, extra=[2], colormap=colormap(8, 9))
    for o in (3, 6, 8):
        out[f"rgb_orientation{o}.tif"] = write_tiff(
            frame(13, 22, seed=o), 2, compression=8, orientation=o)
    return out


def tiff_1080p() -> bytes:
    """A 1080p RGB frame as Deflate strips of 64 rows with the predictor,
    for timing (written at run time, not committed)."""
    return write_tiff(frame(1080, 1920, seed=8), 2, compression=8,
                      predictor=2, rows_per_strip=64)


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
