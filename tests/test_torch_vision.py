"""The port's image input (runtime/vision.py) and LayerNorm (ops/norm.py)
against PIL and the JAX package:

  - the PNG and PPM decoder bit-equal to PIL's `convert("RGB")` for every
    supported colour type (grey, RGB, palette with and without
    transparency, grey + alpha, RGBA) at odd sizes, with PIL's writer
    choosing the filters and with every filter type; the format read from
    the magic bytes; JPEG,
    16-bit and interlaced PNG raise ValueError naming the format;
  - the numpy bicubic resize bit-equal to PIL's BICUBIC, shrinking,
    enlarging and both at once, at odd sizes; the same size is a copy;
  - `find_closest_aspect_ratio`, `internvl_tiles` and `to_array` equal to
    the JAX functions on the same images;
  - `layer_norm` within 1e-6 of the JAX function in f32, with and without a
    bias, and within one bf16 ulp of it in bf16."""
import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import conftest  # noqa: F401
import torch_one_thread  # noqa: F401  (one intra-op thread: see its docstring)

import jax.numpy as jnp

import chatllm_tpu.ops.norm as jnorm
import chatllm_tpu.runtime.vision as jvis
import chatllm_tpu_torch.runtime.vision as tvis
from chatllm_tpu_torch.ops.norm import layer_norm

RNG = np.random.default_rng(21)


def _rgb(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _smooth(h, w, seed=0):
    """A gradient with a little noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256, (xx * yy) % 256], -1)
    return np.clip(img + rng.integers(-3, 4, img.shape), 0, 255).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_filtered(img: np.ndarray) -> bytes:
    """An RGB PNG whose row y is written under filter type y % 5 (None,
    Sub, Up, Average, Paeth), so that every filter is decoded."""
    h, w, _ = img.shape
    rows, prev = [], bytes(3 * w)
    for y in range(h):
        cur, ft = img[y].tobytes(), y % 5
        out = bytearray([ft])
        for i, x in enumerate(cur):
            a = cur[i - 3] if i >= 3 else 0
            b, c = prev[i], prev[i - 3] if i >= 3 else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ft]
            out.append((x - pred) & 0xFF)
        rows.append(bytes(out))
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I",
                                                                        zlib.crc32(kind + body))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def _images():
    rgb = Image.fromarray(_smooth(37, 53, 1))
    pal = rgb.quantize(colors=50)
    pal_t = pal.copy()
    pal_t.info["transparency"] = 3
    rgba = Image.fromarray(np.concatenate([_smooth(29, 31, 2), _rgb(29, 31, 3)[..., :1]], -1),
                           "RGBA")
    return {"grey": rgb.convert("L"), "rgb": rgb, "rgb_noise": Image.fromarray(_rgb(17, 23)),
            "palette": pal, "palette_transparency": pal_t, "grey_alpha": rgba.convert("LA"),
            "rgba": rgba, "one_pixel": Image.fromarray(_rgb(1, 1, 4))}


IMAGES = _images()


def _filters(data: bytes) -> set:
    """The filter types of a PNG's rows."""
    pos, ihdr, idat = 8, None, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, _, color = ihdr[:4]
    stride = w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color] + 1
    raw = zlib.decompress(idat)
    return {raw[y * stride] for y in range(h)}


def _data(name: str) -> bytes:
    return _png_filtered(_smooth(23, 17, 6)) if name == "every_filter" else _png(IMAGES[name])


def test_fixtures_use_every_filter():
    assert _filters(_data("every_filter")) == {0, 1, 2, 3, 4}
    assert len(set().union(*(_filters(_data(n)) for n in IMAGES))) >= 3


@pytest.mark.parametrize("name", list(IMAGES) + ["every_filter"])
def test_png_decodes_as_pil_converts(tmp_path, name):
    data = _data(name)
    path = tmp_path / "x.jpg"                  # the suffix does not decide the format
    path.write_bytes(data)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    for src in (path, str(path)):
        got = tvis.load_image(src)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want)


def test_ppm_decodes_as_pil_converts(tmp_path):
    img = Image.fromarray(_rgb(13, 19, 5))
    buf = io.BytesIO()
    img.save(buf, format="PPM")
    data = buf.getvalue()
    assert data.startswith(b"P6")
    (tmp_path / "x.png").write_bytes(data)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(tvis.load_image(tmp_path / "x.png"), want)
    (tmp_path / "c.ppm").write_bytes(b"P6\n# a comment\n19 13\n255\n" + data.split(b"255\n", 1)[1])
    assert np.array_equal(tvis.load_image(tmp_path / "c.ppm"), want)


def test_an_array_passes_through():
    a = _rgb(5, 7)
    assert tvis.load_image(a) is a
    with pytest.raises(ValueError, match="uint8"):
        tvis.load_image(a.astype(np.float32))


def _with_ihdr(data: bytes, **change) -> bytes:
    """The PNG with IHDR fields changed and its CRC made right again."""
    fields = list(struct.unpack(">IIBBBBB", data[16:29]))
    for i, key in enumerate(("w", "h", "depth", "color", "comp", "filter", "interlace")):
        if key in change:
            fields[i] = change[key]
    body = b"IHDR" + struct.pack(">IIBBBBB", *fields)
    return data[:12] + body + struct.pack(">I", zlib.crc32(body)) + data[33:]


def _jpeg() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_rgb(8, 8)).save(buf, format="JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("what,data,named", [
    ("jpeg", _jpeg(), "JPEG"),
    ("png16", _png(Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 900)),
     "16-bit PNG"),
    ("interlaced", _with_ihdr(_png(IMAGES["rgb"]), interlace=1), "interlaced"),
    ("gif", b"GIF89a" + bytes(20), "GIF"),
    ("unknown", b"hello world, not an image", "unknown image format"),
])
def test_unsupported_formats_raise_naming_them(tmp_path, what, data, named):
    (tmp_path / "x.png").write_bytes(data)
    with pytest.raises(ValueError, match=named) as e:
        tvis.load_image(tmp_path / "x.png")
    assert "no decoder" in str(e.value)


def test_a_bad_crc_raises(tmp_path):
    data = bytearray(_png(IMAGES["rgb"]))
    data[30] ^= 0xFF                               # inside the first chunk after IHDR
    (tmp_path / "x.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        tvis.load_image(tmp_path / "x.png")


RESIZES = [((37, 53), (17, 29)), ((37, 53), (91, 71)), ((48, 64), (32, 32)),
           ((100, 7), (13, 200)), ((5, 5), (5, 9)), ((301, 211), (448, 448)),
           ((211, 301), (1, 1)), ((64, 64), (64, 64))]


@pytest.mark.parametrize("src,size", RESIZES)
def test_resize_is_bit_equal_to_pil_bicubic(src, size):
    img = _rgb(*src, seed=src[0] * 7 + size[0])
    want = np.asarray(Image.fromarray(img).resize(size, Image.BICUBIC))
    got = tvis.resize_bicubic(img, size)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    if tuple(size) == (src[1], src[0]):
        assert got is not img and np.shares_memory(got, img) is False


def test_closest_aspect_ratio_matches_jax():
    ratios = sorted({(i, j) for n in range(1, 13) for i in range(1, n + 1)
                     for j in range(1, n + 1) if 1 <= i * j <= 12}, key=lambda r: r[0] * r[1])
    for w, h in [(2000, 1500), (448, 448), (100, 900), (1000, 1), (640, 480), (1344, 896),
                 (896, 448), (450, 900), (3000, 1000)]:
        for size in (448, 224):
            assert tvis.find_closest_aspect_ratio(w / h, ratios, w, h, size) == \
                jvis.find_closest_aspect_ratio(w / h, ratios, w, h, size)


@pytest.mark.parametrize("hw,kw", [((90, 120), {}), ((50, 40), dict(max_num=6)),
                                   ((33, 200), dict(use_thumbnail=False)),
                                   ((64, 64), dict(image_size=32)),
                                   ((45, 91), dict(image_size=28, min_num=2, max_num=4,
                                                   mean=(0.5, 0.5, 0.5), std=(0.3, 0.2, 0.1)))])
def test_internvl_tiles_match_jax(hw, kw):
    kw = dict(dict(image_size=56), **kw)
    img = _smooth(*hw, seed=hw[0])
    jt, jg = jvis.internvl_tiles(Image.fromarray(img), **kw)
    tt, tg = tvis.internvl_tiles(img, **kw)
    assert tg == jg and tt.dtype == np.float32 and np.array_equal(tt, jt)


def test_to_array_matches_jax():
    img = _smooth(41, 57, 3)
    mean, std = (0.48, 0.45, 0.4), (0.27, 0.26, 0.28)
    assert np.array_equal(tvis.to_array(img, (30, 20), mean, std),
                          jvis.to_array(Image.fromarray(img), (30, 20), mean, std))


@pytest.mark.parametrize("dtype,bias", [("float32", True), ("float32", False),
                                        ("bfloat16", True)])
def test_layer_norm_matches_jax(dtype, bias):
    x = (RNG.standard_normal((3, 5, 96)) * 3 + 1.5).astype(np.float32)
    w = RNG.standard_normal(96).astype(np.float32)
    b = RNG.standard_normal(96).astype(np.float32) if bias else None
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = layer_norm(tx, torch.from_numpy(w), None if b is None else torch.from_numpy(b),
                     eps=1e-6)
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype))
    want = jnorm.layer_norm(jx, jnp.asarray(w), None if b is None else jnp.asarray(b), eps=1e-6)
    assert got.dtype == tx.dtype
    g, r = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        assert np.abs(g - r).max() <= 1e-6 * np.abs(r).max()
    else:                                            # at most one bf16 ulp apart
        assert np.all(np.abs(g - r) <= 2.0 ** -7 * np.abs(r) + 1e-30)
