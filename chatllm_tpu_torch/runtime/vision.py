"""Image input for the vision models (counterpart of the JAX package's
`runtime/vision.py`, InternVL's part): load an image, resize it, normalize
it, and InternVL's dynamic tiling (closest-aspect-ratio grid + thumbnail).

The JAX package reads and resizes images with PIL; this module uses numpy and
the standard library only.  An image is a uint8 array [H, W, 3].

  - `load_image` decodes PNG (8-bit, not interlaced, grey, RGB, palette, grey
    + alpha, RGBA) and binary PPM (P6) with `zlib` and `struct`, converted to
    RGB as PIL's `convert("RGB")` does (alpha dropped, palette looked up, grey
    replicated).  The format is read from the magic bytes, not the file name.
    Any other format raises ValueError naming it: the port has no decoder for
    JPEG, GIF, BMP, WebP, or 16-bit or interlaced PNG.
  - `resize_bicubic` is PIL's BICUBIC resampling of 8-bit images
    (libImaging/Resample.c): separable passes, horizontal then vertical; the
    cubic kernel with a = -0.5 and support 2, widened by the shrink factor when
    downscaling; source centres at (x + 0.5) * scale; coefficients normalized
    per output pixel, then fixed point with 22 fraction bits; each pass rounds
    and clips to uint8.  An unchanged size returns a copy.
"""
from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Iterable

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_OTHER_FORMATS = ((b"\xff\xd8\xff", "JPEG"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
                  (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


def _no_decoder(what: str):
    raise ValueError(f"{what}: chatllm_tpu_torch has no decoder for this image format "
                     "(it reads 8-bit non-interlaced PNG and binary PPM); convert the "
                     "image to PNG")


def load_image(src) -> np.ndarray:
    """A file's path or a uint8 array [H, W, 3] -> the RGB image as a uint8
    array [H, W, 3]."""
    if isinstance(src, np.ndarray):
        if src.dtype != np.uint8 or src.ndim != 3 or src.shape[2] != 3:
            raise ValueError(f"an image array must be uint8 [H, W, 3], got {src.dtype} "
                             f"{list(src.shape)}")
        return src
    with open(os.fspath(src), "rb") as f:
        data = f.read()
    if data.startswith(PNG_MAGIC):
        return decode_png(data)
    if data.startswith(b"P6"):
        return decode_ppm(data)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        _no_decoder("WebP")
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic):
            _no_decoder(name)
    _no_decoder(f"unknown image format (first bytes {data[:8]!r})")


def decode_ppm(data: bytes) -> np.ndarray:
    """Binary PPM (P6) with maxval 255."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":                 # a comment runs to the line's end
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise ValueError("PPM: malformed header")
        fields.append(int(data[start:pos]))
    w, h, maxval = fields
    if maxval != 255:
        _no_decoder(f"PPM with maxval {maxval}")
    pos += 1                                          # one whitespace byte
    n = w * h * 3
    if len(data) < pos + n:
        raise ValueError("PPM: truncated pixel data")
    return np.frombuffer(data, np.uint8, n, pos).reshape(h, w, 3).copy()


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def decode_png(data: bytes) -> np.ndarray:
    """8-bit, non-interlaced PNG of colour type 0, 2, 3, 4 or 6 -> RGB."""
    pos, ihdr, plte, idat = len(PNG_MAGIC), None, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("PNG: truncated chunk")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG: bad CRC in chunk {ctype!r}")
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color, _comp, _filt, interlace = ihdr
    if depth != 8:
        _no_decoder(f"{depth}-bit PNG")
    if interlace:
        _no_decoder("interlaced (Adam7) PNG")
    if color not in _PNG_CHANNELS:
        raise ValueError(f"PNG: invalid colour type {color}")
    if color == 3 and plte is None:
        raise ValueError("PNG: palette image without a PLTE chunk")
    bpp = _PNG_CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    stride = w * bpp
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG: truncated image data")
    px = _unfilter(raw, h, stride, bpp).reshape(h, w, bpp)
    if color == 2:
        return px
    if color == 6:
        return px[..., :3].copy()
    if color == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte
        return pal[px[..., 0]]
    return np.repeat(px[..., :1], 3, axis=2)          # grey, grey + alpha


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (None, Sub, Up, Average, Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        off = y * (stride + 1)
        ftype = raw[off]
        line = np.frombuffer(raw, np.uint8, stride, off + 1)
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:                              # Sub: running sums per byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:                              # Up
            cur = line + prev
        elif ftype in (3, 4):
            cur = _unfilter_left(line, prev, bpp, ftype)
        else:
            raise ValueError(f"PNG: invalid filter type {ftype} in row {y}")
        out[y] = cur
        prev = cur
    return out


def _unfilter_left(line: np.ndarray, prev: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Average (3) and Paeth (4): each byte depends on its reconstructed
    left neighbour, so the row runs byte by byte."""
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


# ------------------------------------------------------------------ resize
_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """The cubic kernel with a = -0.5, evaluated in the C code's order."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Per output pixel: the first source index [out] and the fixed-point
    coefficients [out, ksize] (zero past each pixel's window)."""
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _bicubic((np.arange(xmax, dtype=np.float64) + xmin - center + 0.5) * ss)
        ww = 0.0
        for v in w:                                   # the C loop's summation order
            ww += v
        if ww != 0.0:
            w = w / ww
        kk[xx, :xmax] = w
        first[xx] = xmin
    scaled = kk * float(1 << _PRECISION_BITS)
    fixed = np.where(kk < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled))
    return first, fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of the 8-bit resampler along `axis` (1: horizontal, 0:
    vertical) of a uint8 [H, W, C] image."""
    in_size = img.shape[axis]
    first, k = _coeffs(in_size, out_size)
    # int32 as in the C code: |sum| <= 255 * sum(|k|) < 2^31 for this kernel
    k = k.astype(np.int32)
    src = np.moveaxis(img, axis, 0).astype(np.int32)       # [in, other, C]
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int32)
    for j in range(k.shape[1]):
        idx = np.minimum(first + j, in_size - 1)
        acc += src[idx] * k[:, j, None, None]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def resize_bicubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """PIL's `Image.resize(size, BICUBIC)` of a uint8 [H, W, C] image; `size`
    is (width, height), as PIL takes it."""
    w, h = size
    if (w, h) == (img.shape[1], img.shape[0]):
        return img.copy()
    out = img
    if w != img.shape[1]:
        out = _resample_axis(out, w, 1)
    if h != img.shape[0]:
        out = _resample_axis(out, h, 0)
    return out


def to_array(img: np.ndarray, size: int | tuple[int, int], mean, std) -> np.ndarray:
    """Resize to `size` (width, height) and normalize -> [H, W, 3] f32."""
    if isinstance(size, int):
        size = (size, size)
    arr = np.asarray(resize_bicubic(img, size), np.float32) / 255.0
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (arr - mean) / std


def find_closest_aspect_ratio(aspect: float, ratios: Iterable[tuple[int, int]],
                              width: int, height: int, image_size: int):
    """InternVL dynamic_preprocess ratio selection."""
    best_diff = float("inf")
    best = (1, 1)
    area = width * height
    for r in ratios:
        target = r[0] / r[1]
        diff = abs(aspect - target)
        if diff < best_diff:
            best_diff = diff
            best = r
        elif diff == best_diff:
            if area > 0.5 * image_size * image_size * r[0] * r[1]:
                best = r
    return best


def internvl_tiles(img: np.ndarray, *, image_size: int = 448, min_num: int = 1,
                   max_num: int = 12, use_thumbnail: bool = True,
                   mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)):
    """InternVL dynamic preprocessing: split into up to max_num image_size²
    tiles matching the closest grid aspect ratio, plus a thumbnail when there
    is more than one tile.  Returns (tiles [N, S, S, 3] f32, grid (gw, gh))."""
    h, w = img.shape[:2]
    aspect = w / h
    ratios = sorted(
        {(i, j) for n in range(min_num, max_num + 1)
         for i in range(1, n + 1) for j in range(1, n + 1)
         if min_num <= i * j <= max_num},
        key=lambda r: r[0] * r[1])
    gw, gh = find_closest_aspect_ratio(aspect, ratios, w, h, image_size)
    resized = resize_bicubic(img, (image_size * gw, image_size * gh))
    tiles = []
    for idx in range(gw * gh):
        x = (idx % gw) * image_size
        y = (idx // gw) * image_size
        tile = resized[y:y + image_size, x:x + image_size]
        tiles.append(np.asarray(tile, np.float32) / 255.0)
    if use_thumbnail and len(tiles) != 1:
        thumb = resize_bicubic(img, (image_size, image_size))
        tiles.append(np.asarray(thumb, np.float32) / 255.0)
    arr = np.stack(tiles)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (arr - mean) / std, (gw, gh)
