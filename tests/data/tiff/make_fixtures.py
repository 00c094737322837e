"""Write the TIFF fixtures of this folder with the small TIFF writer below,
and `manifest.json`: for each file, its size and the SHA-1 of PIL's decode
of it (`Image.open(path).convert("RGB")`, the JAX package's `load_image`).

    python tests/data/tiff/make_fixtures.py

PIL writes few of the layouts a TIFF may hold (tiles, planar
configuration 2, the predictors, fill order 2, both byte orders, BigTIFF),
so `write_tiff` writes them: strips or tiles, chunky or planar,
uncompressed, PackBits, LZW (TIFF 6.0, early change), Deflate, LZMA or
ZSTD (the system libzstd, `zstd`), 1- to 32-bit integer and float
samples, any photometric interpretation; JPEG and CCITT strips and tiles
it takes coded from PIL (`pil_coded`, `ycbcr_jpeg`), and `pil_cases` are
the files PIL codes. `chip_smoke.py`'s `formats` phase holds the port's
decoder to the manifest on the card's host, which has no PIL;
`tests/test_torch_port_formats.py` holds the manifest to PIL and writes
more cases with `write_tiff`."""

import hashlib
import json
import lzma
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


def _sample_bytes(sub: np.ndarray, bits: int, order: str,
                  float_samples: bool) -> bytes:
    """[rows, n] samples -> the rows' bytes: packed MSB first below 8 bits,
    else `bits`-bit integers (two's complement) or floats in `order`."""
    if bits <= 8:
        return _pack(sub, bits)
    if float_samples:
        return sub.astype(f"{order}f{bits // 8}").tobytes()
    return (sub.astype(np.int64) % (1 << bits)).astype(
        f"{order}u{bits // 8}").tobytes()


def _float_predict(sub: np.ndarray, per: int, bits: int) -> bytes:
    """libtiff's fpDiff: each row's values as byte planes (most significant
    first), then the bytes differenced with a stride of `per`."""
    rows = sub.shape[0]
    b = sub.reshape(rows, -1).astype(f">f{bits // 8}").view(np.uint8)
    b = b.reshape(rows, -1, bits // 8).transpose(0, 2, 1).reshape(rows, -1)
    d = b.astype(np.int64)
    d[:, per:] = d[:, per:] - d[:, :-per]
    return (d % 256).astype(np.uint8).tobytes()


def xz(data: bytes) -> bytes:
    """libtiff's tif_lzma.c: one xz stream a strip or tile."""
    return lzma.compress(data, format=lzma.FORMAT_XZ, check=lzma.CHECK_NONE)


def zstd(data: bytes, level=3, checksum=False) -> bytes:
    """A Zstandard frame of `data` from the system libzstd (ctypes; only
    the test machine has it): `level` 1-22, the content checksum or not."""
    import ctypes
    import ctypes.util
    lib = ctypes.CDLL(ctypes.util.find_library("zstd"))
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_size_t, ctypes.c_char_p,
                                   ctypes.c_size_t]
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    cctx = lib.ZSTD_createCCtx()
    lib.ZSTD_CCtx_setParameter(cctx, 100, level)          # compressionLevel
    lib.ZSTD_CCtx_setParameter(cctx, 201, int(checksum))  # checksumFlag
    out = ctypes.create_string_buffer(len(data) * 2 + 1024)
    n = lib.ZSTD_compress2(cctx, out, len(out), data, len(data))
    lib.ZSTD_freeCCtx(cctx)
    return out.raw[:n]


def write_tiff(px, photometric, bits=8, compression=1, order="<",
               tile=None, rows_per_strip=None, planar=1, predictor=1,
               fill=1, extra=None, colormap=None, orientation=None,
               sample_format=None, extra_tags=(), encode=None, big=False):
    """The bytes of a TIFF (a BigTIFF where `big`) of `px` ([h, w, samples]
    sample values below 2**bits, or floats where `sample_format` is 3): one
    IFD, its data after it. `encode(chunk)`, given, codes each strip or
    tile ([rows, tw, samples]) for the compressions written elsewhere
    (JPEG and CCITT, by the tests with PIL)."""
    h, w, spp = px.shape
    tw, th = tile if tile else (w, rows_per_strip or h)
    across, down = -(-w // tw), -(-h // th)
    planes = spp if planar == 2 else 1
    per = 1 if planar == 2 else spp
    floats = sample_format is not None and sample_format[0] == 3
    chunks = []
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                sub = np.zeros((th, tw, per), np.float64 if floats else
                               np.int64)
                part = px[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw,
                          p:p + per] if planar == 2 else \
                    px[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
                sub[:part.shape[0], :part.shape[1]] = part
                if not tile:
                    sub = sub[:part.shape[0]]
                if encode is not None:
                    coded = encode(sub)
                    if fill == 2:
                        coded = REVERSE[np.frombuffer(coded,
                                                      np.uint8)].tobytes()
                    chunks.append(coded)
                    continue
                if predictor == 3 and floats:
                    raw = _float_predict(sub, per, bits)
                else:
                    if predictor == 2:
                        d = sub.copy()
                        d[:, 1:] = sub[:, 1:] - sub[:, :-1]
                        sub = d % (1 << max(bits, 8))
                    raw = _sample_bytes(sub.reshape(sub.shape[0], -1), bits,
                                        order, floats)
                if compression == 1:
                    if fill == 2:
                        raw = REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
                    chunks.append(raw)
                    continue
                coded = {5: lzw, 32773: packbits, 34925: xz,
                         8: zlib.compress, 32946: zlib.compress,
                         50000: zstd}[compression](raw)
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
    size = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 16: 8}
    code = {1: "B", 2: "B", 3: "H", 4: "I", 7: "B", 16: "Q"}
    if big:                       # offsets and counts as LONG8
        tags[off_tag] = (16, tags[off_tag][1])
        tags[cnt_tag] = (16, counts)
    n = len(tags)
    entry, inline = (20, 8) if big else (12, 4)
    ifd_at = 16 if big else 8
    ifd_len = (8 if big else 2) + entry * n + (8 if big else 4)
    extra_at = ifd_at + ifd_len
    for tag in sorted(tags):
        typ, vals = tags[tag]
        nbytes = size[typ] * len(vals)
        if nbytes > inline:
            extra_at += nbytes + (nbytes & 1)
    offsets = []
    for c in chunks:
        offsets.append(extra_at)
        extra_at += len(c)
    tags[off_tag] = (tags[off_tag][0], offsets)
    magic = (b"II" if order == "<" else b"MM") + struct.pack(
        order + "H", 43 if big else 42)
    out = bytearray(magic + (struct.pack(order + "HHQ", 8, 0, 16) if big
                             else struct.pack(order + "I", 8)))
    out += struct.pack(order + ("Q" if big else "H"), n)
    tail = bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        body = struct.pack(order + code[typ] * len(vals), *vals)
        head = struct.pack(order + ("HHQ" if big else "HHI"), tag, typ,
                           len(vals))
        if len(body) > inline:
            out += head + struct.pack(order + ("Q" if big else "I"),
                                      ifd_at + ifd_len + len(tail))
            tail += body + b"\x00" * (len(body) & 1)
        else:
            out += head + body.ljust(inline, b"\x00")
    out += struct.pack(order + ("Q" if big else "I"), 0) + tail
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
    out.update(deep_cases())
    return out


def samples16(h, w, c, seed=0):
    """16-bit samples that reach PIL's clip at 255 and keep a high byte."""
    f = frame(h, w, c, seed).astype(np.int64)
    return (f * 257 + (f % 7) * 31 - 300) % 65536


def floats(h, w, seed=0):
    """Float samples about PIL's truncation and clip: halves, negatives,
    values past 255, NaN and the infinities."""
    f = frame(h, w, 1, seed).astype(np.float64) * 1.13 - 20.5
    f[0, :6, 0] = (np.nan, np.inf, -np.inf, 254.99, 255.5, -0.5)
    return f


def deep_cases():
    """name -> TIFF bytes of the layouts past 8-bit RGB (ZSTD strips from
    the system libzstd): 16- and 32-bit integer and float samples with both
    predictors, 16-bit colour, CMYK, CIELab, YCbCr, LZMA, ZSTD and
    BigTIFF."""
    out = {}
    g16 = samples16(23, 29, 1, 1)
    out["grey16_raw.tif"] = write_tiff(g16, 1, bits=16)
    out["grey16_lzw_pred2_tiles_mm.tif"] = write_tiff(
        g16, 1, bits=16, compression=5, predictor=2, tile=(16, 16),
        order=">")
    out["int16_deflate.tif"] = write_tiff(
        g16 - 32768, 1, bits=16, compression=8, sample_format=[2])
    out["int32_lzma_mm.tif"] = write_tiff(
        g16 * 40000 - 2 ** 31, 1, bits=32, compression=34925,
        sample_format=[2], order=">", rows_per_strip=8)
    out["uint32_pred2_deflate.tif"] = write_tiff(
        g16 * 3, 1, bits=32, compression=8, predictor=2)
    out["float32_pred3_lzma.tif"] = write_tiff(
        floats(21, 26, 2), 1, bits=32, compression=34925, predictor=3,
        sample_format=[3], rows_per_strip=5)
    out["float32_pred3_deflate_tiles_mm.tif"] = write_tiff(
        floats(21, 26, 3), 1, bits=32, compression=8, predictor=3,
        sample_format=[3], tile=(16, 16), order=">")
    out["float32_raw_mm.tif"] = write_tiff(
        floats(11, 13, 4), 1, bits=32, sample_format=[3], order=">")
    out["rgb16_lzw_pred2_mm.tif"] = write_tiff(
        samples16(19, 22, 3, 5), 2, bits=16, compression=5, predictor=2,
        order=">")
    out["rgba16_deflate_planar.tif"] = write_tiff(
        samples16(19, 22, 4, 6), 2, bits=16, compression=8, extra=[2],
        planar=2, rows_per_strip=7)
    out["rgba16_assoc_raw.tif"] = write_tiff(
        samples16(13, 17, 4, 7), 2, bits=16, extra=[1])
    out["cmyk8_lzw.tif"] = write_tiff(frame(21, 27, 4, 8), 5, compression=5)
    out["cmyk8_raw_planar.tif"] = write_tiff(frame(21, 27, 4, 9), 5,
                                             planar=2, rows_per_strip=6)
    out["cmykx8_lzma_tiles.tif"] = write_tiff(
        frame(21, 27, 5, 10), 5, compression=34925, extra=[0],
        tile=(16, 16))
    out["cmyk16_raw_mm.tif"] = write_tiff(samples16(15, 18, 4, 11), 5,
                                          bits=16, order=">")
    out["rgb_lzma_pred2_tiles.tif"] = write_tiff(
        frame(29, 35, seed=12), 2, compression=34925, predictor=2,
        tile=(16, 32))
    out["grey8_lzma_strips_mm.tif"] = write_tiff(
        frame(29, 35, 1, seed=13), 1, compression=34925, rows_per_strip=6,
        order=">")
    out["bigtiff_rgb_deflate_tiles.tif"] = write_tiff(
        frame(29, 35, seed=14), 2, compression=8, tile=(16, 16), big=True)
    out["cielab_lzw.tif"] = write_tiff(frame(23, 29, 3, 16), 8,
                                       compression=5)
    out["cielab_raw_planar_mm.tif"] = write_tiff(
        frame(17, 20, 3, 17), 8, planar=2, rows_per_strip=6, order=">")
    out["ycbcr_22_lzw.tif"] = ycbcr_coded(frame(23, 29, 3, 18), 2, 2)
    out["ycbcr_44_deflate_tiles.tif"] = ycbcr_coded(
        frame(23, 29, 3, 19), 4, 4, 8, tile=(16, 16))
    out["zstd_grey16_pred2_tiles_mm.tif"] = write_tiff(
        samples16(23, 29, 1, 21), 1, bits=16, compression=50000,
        predictor=2, tile=(16, 16), order=">")
    out["zstd_float32_pred3_strips.tif"] = write_tiff(
        floats(21, 26, 22), 1, bits=32, compression=50000, predictor=3,
        sample_format=[3], rows_per_strip=8)
    out["zstd_rgb_checksum.tif"] = write_tiff(
        frame(29, 35, seed=23), 2, compression=50000, rows_per_strip=10,
        encode=lambda c: zstd(c.astype(np.uint8).tobytes(), 19, True))
    out["bigtiff_grey16_lzw.tif"] = write_tiff(
        samples16(17, 19, 1, 15), 1, bits=16, compression=5, big=True)
    return out


def _pil_chunk(chunk, compression, info=None):
    """(strip bytes, JPEGTables) of PIL's TIFF of one uint8 [rows, w, c]
    chunk as a single strip: how the tests code JPEG and CCITT strips and
    tiles (PIL writes strips only)."""
    import io

    from PIL import Image
    a = chunk.astype(np.uint8)
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "CMYK"}[a.shape[2]]
    if compression in ("group3", "group4", "tiff_ccitt"):
        im = Image.fromarray(a[..., 0] * 255).convert("1")
    else:
        im = Image.frombytes(mode, (a.shape[1], a.shape[0]), a.tobytes())
    buf = io.BytesIO()
    im.save(buf, "TIFF", compression=compression,
            tiffinfo={278: a.shape[0], **(info or {})})
    data = buf.getvalue()
    tags = Image.open(io.BytesIO(data)).tag_v2
    return data[tags[273][0]:tags[273][0] + tags[279][0]], tags.get(347)


def pil_coded(px, photometric, compression, info=None, **kw):
    """write_tiff with each strip or tile coded by PIL (JPEG or CCITT),
    JPEGTables from PIL for JPEG."""
    extra_tags = list(kw.pop("extra_tags", ()))
    if compression == "jpeg":
        tables = _pil_chunk(np.zeros((8, 8, px.shape[2])), "jpeg")[1]
        extra_tags.append((347, 7, tables))
    number = {"jpeg": 7, "tiff_ccitt": 2, "group3": 3, "group4": 4}
    bits = 1 if number[compression] in (2, 3, 4) else 8
    if info and 292 in info:
        extra_tags.append((292, 4, [info[292]]))
    return write_tiff(px, photometric, bits=bits,
                      compression=number[compression],
                      encode=lambda c: _pil_chunk(c, compression, info)[0],
                      extra_tags=extra_tags, **kw)


def ycbcr_jpeg(px, sampling, quality=80, **kw):
    """A YCbCr (photometric 6) JPEG TIFF whose strips or tiles are whole
    JFIF streams from PIL at `sampling` (h, v) for the chroma, no
    JPEGTables."""
    import io

    from PIL import Image

    def code(chunk):
        buf = io.BytesIO()
        Image.fromarray(chunk.astype(np.uint8)).save(
            buf, "JPEG", quality=quality,
            subsampling={(1, 1): 0, (2, 1): 1, (2, 2): 2}[sampling])
        return buf.getvalue()
    return write_tiff(px, 6, compression=7, encode=code,
                      extra_tags=[(530, 3, list(sampling))], **kw)


def ycbcr_units(chunk, hs, vs) -> bytes:
    """[rows, w, 3] Y, Cb, Cr -> the subsampled layout: blocks of hs x vs
    Y values row by row, then the block's first Cb and Cr (the edges
    repeated to whole blocks)."""
    rows, w, _ = chunk.shape
    ur, uc = -(-rows // vs), -(-w // hs)
    pad = np.zeros((ur * vs, uc * hs, 3), np.int64)
    pad[:rows, :w] = chunk
    pad[rows:, :w] = chunk[-1:]
    pad[:, w:] = pad[:, w - 1:w]
    blocks = pad.reshape(ur, vs, uc, hs, 3).transpose(0, 2, 1, 3, 4)
    y = blocks[..., 0].reshape(ur, uc, vs * hs)
    return np.concatenate([y, blocks[:, :, 0, 0, 1:]], -1).astype(
        np.uint8).tobytes()


def ycbcr_coded(px, hs, vs, compression=5, **kw):
    """A YCbCr TIFF of [h, w, 3] Y, Cb, Cr, subsampled hs x vs, through
    LZW, Deflate or none."""
    code = {5: lzw, 8: zlib.compress, 1: bytes}[compression]
    return write_tiff(px, 6, compression=compression,
                      encode=lambda c: code(ycbcr_units(c, hs, vs)),
                      extra_tags=[(530, 3, [hs, vs])], **kw)


def bilevel(h, w, seed=0):
    """A bilevel scene: stripes, a disc and sparse dots, 1 for black."""
    y, x = np.mgrid[0:h, 0:w]
    b = ((x // 7 + y // 5) % 3 == 0) | ((x - w / 2) ** 2 + (y - h / 2) ** 2
                                         < (min(h, w) / 3) ** 2)
    b ^= ((x * 73856093) ^ (y * 19349663) ^ seed) % 53 == 0
    return b.astype(np.uint8)[..., None]


def pil_cases():
    """name -> TIFF bytes whose strips or tiles PIL codes: JPEG (RGB, grey,
    CMYK, RGBA, YCbCr at 4:2:0 and 4:2:2) and CCITT (RLE, Group 3 1-D and
    2-D with fill bits, Group 4; FillOrder 2, WhiteIsZero, tiles)."""
    import io

    from PIL import Image
    out = {}
    rgb = frame(37, 45, seed=20)

    def pil_tiff(im, **kw):
        buf = io.BytesIO()
        im.save(buf, "TIFF", **kw)
        return buf.getvalue()
    out["jpeg_rgb_pil.tif"] = pil_tiff(Image.fromarray(rgb),
                                       compression="jpeg")
    out["zstd_rgba_pil.tif"] = pil_tiff(Image.fromarray(
        frame(37, 45, 4, seed=25), "RGBA"), compression="zstd")
    out["jpeg_grey_strips_pil.tif"] = pil_tiff(
        Image.fromarray(rgb[..., 0]), compression="jpeg",
        tiffinfo={278: 16})
    out["jpeg_cmyk_pil.tif"] = pil_tiff(Image.frombytes(
        "CMYK", (45, 37), frame(37, 45, 4, seed=21).tobytes()),
        compression="jpeg")
    out["jpeg_rgba_pil.tif"] = pil_tiff(Image.fromarray(
        frame(37, 45, 4, seed=22), "RGBA"), compression="jpeg")
    out["jpeg_rgb_tiles_mm.tif"] = pil_coded(rgb, 2, "jpeg", tile=(16, 16),
                                             order=">")
    out["jpeg_ycbcr_420_tiles.tif"] = ycbcr_jpeg(rgb, (2, 2), tile=(32, 16))
    out["jpeg_ycbcr_422_strips.tif"] = ycbcr_jpeg(rgb, (2, 1),
                                                  rows_per_strip=16)
    b = bilevel(37, 45, 23)
    for comp, name in (("tiff_ccitt", "ccitt_rle"), ("group3", "g3_1d"),
                       ("group4", "g4")):
        out[f"{name}_pil.tif"] = pil_tiff(Image.fromarray(
            b[..., 0] * 255).convert("1"), compression=comp)
    out["g3_2d_fill_strips.tif"] = pil_coded(b, 1, "group3",
                                             info={292: 5},
                                             rows_per_strip=10)
    out["g4_tiles_wiz.tif"] = pil_coded(b, 0, "group4", tile=(32, 16))
    out["g4_fill2_mm.tif"] = pil_coded(b, 1, "group4", fill=2, order=">")
    out["ccitt_rle_fill2_strips.tif"] = pil_coded(b, 0, "tiff_ccitt",
                                                  fill=2, rows_per_strip=9)
    out["g4_1080p.tif"] = g4_1080p()
    return out


def g4_1080p() -> bytes:
    """A 1080p Group 4 page (PIL's writer, one strip), for timing."""
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(bilevel(1080, 1920, 24)[..., 0] * 255).convert("1").save(
        buf, "TIFF", compression="group4")
    return buf.getvalue()


def tiff_1080p() -> bytes:
    """A 1080p RGB frame as Deflate strips of 64 rows with the predictor,
    for timing (written at run time, not committed)."""
    return write_tiff(frame(1080, 1920, seed=8), 2, compression=8,
                      predictor=2, rows_per_strip=64)


def jpeg_tiff_1080p(encode) -> bytes:
    """A 1080p YCbCr JPEG TIFF whose strips of 64 rows are whole JFIF
    streams, 4:2:0, coded by `encode` (uint8 [rows, w, 3] -> JPEG bytes:
    PIL's quality-75 save, or the port's `encode_jpeg`, its bytes), for
    timing (written at run time)."""
    return write_tiff(frame(1080, 1920, seed=26), 6, compression=7,
                      encode=lambda c: encode(c.astype(np.uint8)),
                      extra_tags=[(530, 3, [2, 2])], rows_per_strip=64)


def tiff16_1080p() -> bytes:
    """A 1080p 16-bit RGB frame as Deflate strips of 32 rows with the
    predictor, for timing (written at run time)."""
    return write_tiff(samples16(1080, 1920, 3, 25), 2, bits=16,
                      compression=8, predictor=2, rows_per_strip=32)


LAB_TABLE = HERE.parents[2] / "mo_yolo_tpu_torch" / "data" / \
    "lab_srgb_clut.u16"


def lab_table() -> bytes:
    """The 33^3 x 3 16-bit RGB table (little-endian, L slowest) of the
    LittleCMS transform PIL's `convert("RGB")` builds for mode LAB (a D50
    Lab profile to sRGB, perceptual, as `ImageCms.buildTransform`), read
    from PIL's own LittleCMS through ctypes: the transform evaluated
    without optimisation at the grid's nodes, as its 8-bit path samples
    them. Only the test machine, which has PIL, runs it."""
    import ctypes
    from pathlib import Path as P

    import PIL
    libs = sorted((P(PIL.__file__).parent.parent / "pillow.libs").glob(
        "liblcms2*"))
    lib = ctypes.CDLL(str(libs[0]))
    lib.cmsCreateLab2Profile.restype = ctypes.c_void_p
    lib.cmsCreateLab2Profile.argtypes = [ctypes.c_void_p]
    lib.cmsCreate_sRGBProfile.restype = ctypes.c_void_p
    lib.cmsCreateTransform.restype = ctypes.c_void_p
    lib.cmsCreateTransform.argtypes = [ctypes.c_void_p, ctypes.c_uint32] * 2 \
        + [ctypes.c_uint32] * 2
    lib.cmsDoTransform.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_uint32]
    lab16 = (10 << 16) | (3 << 3) | 2                   # TYPE_Lab_16
    rgb16 = (4 << 16) | (3 << 3) | 2                    # TYPE_RGB_16
    t = lib.cmsCreateTransform(lib.cmsCreateLab2Profile(None), lab16,
                               lib.cmsCreate_sRGBProfile(), rgb16, 0,
                               0x0100 | 0x0040)       # NOOPTIMIZE, NOCACHE
    q = np.floor(np.arange(33) * 65535.0 / 32 + 0.5).astype(np.uint16)
    nodes = np.ascontiguousarray(np.stack(np.meshgrid(
        q, q, q, indexing="ij"), -1).reshape(-1, 3))
    out = np.zeros_like(nodes)
    lib.cmsDoTransform(t, nodes.ctypes.data, out.ctypes.data, len(nodes))
    return out.astype("<u2").tobytes()


def main():
    from PIL import Image
    manifest = {}
    for name, blob in {**cases(), **pil_cases()}.items():
        path = HERE / name
        path.write_bytes(blob)
        rgb = np.asarray(Image.open(path).convert("RGB"))
        manifest[name] = {"shape": list(rgb.shape), "bytes": len(blob),
                          "sha1": hashlib.sha1(rgb.tobytes()).hexdigest()}
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1))
    LAB_TABLE.write_bytes(lab_table())


if __name__ == "__main__":
    main()
