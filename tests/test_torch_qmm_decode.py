"""K5's plain version (what the CUDA kernel is held against on the card)
against the JAX package's qmm_decode_pallas in interpret mode, its
difference from K2's rounding, and the CHATLLM_TPU_QMM_V2 route in both
packages."""
import functools

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax.numpy as jnp

import chatllm_tpu.ops.qmm as jqmm
from chatllm_tpu.ops.pallas.qmm_decode import qmm_decode_pallas
from chatllm_tpu.ops.qtensor import QuantLinear as JQuantLinear
from chatllm_tpu_torch.ops import qmm as tqmm
from chatllm_tpu_torch.ops.cuda.qmm_decode import qmm_decode, qmm_decode_plain, split_lo_hi
from chatllm_tpu_torch.ops.cuda.qmm_kernel import qmm_plain
from chatllm_tpu_torch.ops.qtensor import QuantLinear
from test_torch_qmm import _classic, _jax_args, _superblock, _torch_args

K, N = 512, 256
WEIGHTS = {
    "q4_k": lambda r: _superblock(r, K, N),
    "q8_0": lambda r: _classic(r, K, N, 32, False, False, f16=True),
    "q4_0": lambda r: _classic(r, K, N, 32, True, False, f16=True),
    "q4_1": lambda r: _classic(r, K, N, 32, True, True, f16=True),
}


def _case(fmt, B, with_bias):
    rng = np.random.default_rng(B + len(fmt))
    w = WEIGHTS[fmt](rng)
    x = rng.standard_normal((B, K)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32) if with_bias else None
    return w, x, bias


@pytest.mark.parametrize("B", [2, 5, 64])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("fmt", list(WEIGHTS))
def test_qmm_decode_plain_matches_pallas(fmt, with_bias, B):
    w, x, bias = _case(fmt, B, with_bias)
    ja, jkw = _jax_args(w)
    ref = np.asarray(qmm_decode_pallas(
        jnp.asarray(x), *ja, None if bias is None else jnp.asarray(bias),
        tile_n=128, tile_k=256, interpret=True, **jkw))
    ta, tkw = _torch_args(w)
    y = qmm_decode(torch.from_numpy(x), *ta,
                   None if bias is None else torch.from_numpy(bias), **tkw)
    assert y.shape == (B, N) and y.dtype == torch.float32
    # the same bf16 roundings at the same points, exact bf16 x bf16 products:
    # only the order of the f32 sums differs
    assert np.abs(y.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_array_equal(
        y.numpy(), qmm_decode_plain(torch.from_numpy(x), *ta,
                                    None if bias is None else torch.from_numpy(bias),
                                    **tkw).numpy())


def _sb_unpacked(rng, K, N, G, with_m):
    """q5_k / q6_k-shaped superblock arrays: int8 values (0..31 with a min,
    -32..31 without), sc (signed without a min), f16 d / dmin."""
    SB = 256 // G
    lo, hi = (0, 32) if with_m else (-32, 32)
    q = rng.integers(lo, hi, size=(K, N)).astype(np.int8)
    sc = rng.integers(0 if with_m else -128, 64 if with_m else 128,
                      size=(K // G, N)).astype(np.int8)
    d = (rng.random((K // (G * SB), N)) * 0.002 + 1e-4).astype(np.float16)
    w = dict(q=q, s=sc, b=None, d=d, dm=None, sb=SB, group=G, packed=False, zero_point=0)
    if with_m:
        w["b"] = rng.integers(0, 64, size=(K // G, N)).astype(np.int8)
        w["dm"] = (rng.random((K // (G * SB), N)) * 0.001 + 1e-4).astype(np.float16)
    return w


# Every layout K5 takes: the four of the main path, the G 16 and int8
# superblock layouts, and classic f32 scales with a b
ONE_HOT_WEIGHTS = {
    **WEIGHTS,
    "q2_k": lambda r: _superblock(r, K, N, G=16, SB=16),
    "q5_k": lambda r: _sb_unpacked(r, K, N, 32, True),
    "q6_k": lambda r: _sb_unpacked(r, K, N, 16, False),
    "q8_f32b": lambda r: _classic(r, K, N, 32, False, True),
}


def _one_hot(rows):
    """Row r is 1 at column r * (K // rows) + r % 7 (chip_smoke.one_hot_rows)."""
    x = np.zeros((rows, K), np.float32)
    r = np.arange(rows)
    x[r, r * (K // rows) + r % 7] = 1.0
    return x


@pytest.mark.parametrize("rows", [1, 8, 17])
@pytest.mark.parametrize("fmt", list(ONE_HOT_WEIGHTS))
def test_plain_equals_pallas_bitwise_on_one_hot_rows(fmt, rows):
    """On one-hot rows every output is one dequantized weight (plus the bias
    and a classic b): K5's plain version, which the card's kernel must equal
    bit for bit on such rows, forms each weight with the Pallas kernel's
    roundings exactly, so the two agree bit for bit on every layout."""
    rng = np.random.default_rng(rows + 3 * len(fmt))
    w = ONE_HOT_WEIGHTS[fmt](rng)
    x = _one_hot(rows)
    bias = rng.standard_normal(N).astype(np.float32) if rows == 8 else None
    ja, jkw = _jax_args(w)
    ref = np.asarray(qmm_decode_pallas(
        jnp.asarray(x), *ja, None if bias is None else jnp.asarray(bias),
        tile_n=128, tile_k=256, interpret=True, **jkw))
    ta, tkw = _torch_args(w)
    y = qmm_decode_plain(torch.from_numpy(x), *ta,
                         None if bias is None else torch.from_numpy(bias), **tkw)
    np.testing.assert_array_equal(y.numpy(), ref)


def test_rounding_differs_from_k2_on_q4_k():
    """K5 rounds the superblock min term into every bf16 weight; K2 adds it
    in f32 from group sums of x.  On q4_k the two plain versions differ by
    ~1e-3 of the output scale, so neither can stand in for the other; on a
    classic layout (no min term in the weight) they agree."""
    w, x, _ = _case("q4_k", 5, False)
    ta, tkw = _torch_args(w)
    xt = torch.from_numpy(x)
    k5, k2 = qmm_decode_plain(xt, *ta, None, **tkw), qmm_plain(xt, *ta, None, **tkw)
    rel = ((k5 - k2).abs().max() / k2.abs().max()).item()
    assert 1e-4 < rel < 2e-2, rel
    w, x, _ = _case("q8_0", 5, False)
    ta, tkw = _torch_args(w)
    xt = torch.from_numpy(x)
    torch.testing.assert_close(qmm_decode_plain(xt, *ta, None, **tkw),
                               qmm_plain(xt, *ta, None, **tkw), rtol=0, atol=0)


@pytest.mark.parametrize("group", [16, 32])
def test_split_lo_hi_matches_nibble_pairing(group):
    """x_lo . w_lo + x_hi . w_hi over the un-interleaved halves equals the
    product over the unpacked weight."""
    rng = np.random.default_rng(group)
    w = _classic(rng, 256, 128, group, True, False)
    x = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
    q = torch.from_numpy(w["q"])
    x_lo, x_hi = split_lo_hi(x, group)
    # views of x (the kernel reads x through their strides), no copies
    assert x_lo.data_ptr() == x.data_ptr() and x_lo.stride() == (256, group, 1)
    assert x_hi.data_ptr() == x.data_ptr() + group // 2 * x.element_size()
    x_lo, x_hi = x_lo.flatten(1), x_hi.flatten(1)
    lo, hi = (q & 0xF).float() - w["zero_point"], (q >> 4).float() - w["zero_point"]
    full = tqmm.unpack_nibbles(q, group, w["zero_point"])
    torch.testing.assert_close(x_lo @ lo + x_hi @ hi, x @ full, rtol=1e-5, atol=1e-4)


def _linears(w):
    ta, tkw = _torch_args(w)
    ja, jkw = _jax_args(w)
    t = QuantLinear(q=ta[0], s=ta[1], b=ta[2], d=tkw["d"], dm=tkw["dm"], sb=tkw["sb"],
                    packed=w["packed"], zero_point=w["zero_point"], group_size=w["group"])
    j = JQuantLinear(q=ja[0], s=ja[1], b=ja[2], d=jkw["d"], dm=jkw["dm"], sb=jkw["sb"],
                     packed=w["packed"], zero_point=w["zero_point"], group_size=w["group"])
    return t, j


@pytest.mark.parametrize("switch,rows,route", [
    ("1", 5, "qmm_decode"), ("1", 64, "qmm_decode"), ("1", 1, "qgemv"),
    ("1", 65, "dequant_matmul"), ("0", 5, "qmm"), (None, 5, "qmm")])
def test_route_under_the_switch_in_both_packages(monkeypatch, switch, rows, route):
    """CHATLLM_TPU_QMM_V2=1 (read at call time, default "0") sends 2..64
    rows to K5 in both packages; one row still goes to K1 first."""
    if switch is None:
        monkeypatch.delenv("CHATLLM_TPU_QMM_V2", raising=False)
    else:
        monkeypatch.setenv("CHATLLM_TPU_QMM_V2", switch)
    w, _, _ = _case("q4_k", 2, False)
    t, j = _linears(w)
    x = np.random.default_rng(rows).standard_normal((rows, K)).astype(np.float32)
    tqmm.reset_kernel_dispatch_stats()
    y = tqmm.matmul(torch.from_numpy(x), t)
    assert tqmm.kernel_dispatch_stats() == {route: 1}
    # the JAX package under its TPU routing, kernels in interpret mode
    called = []
    import chatllm_tpu.ops.pallas.gemv_kernel as jgemv
    import chatllm_tpu.ops.pallas.qmm_decode as jdec
    import chatllm_tpu.ops.pallas.qmm_kernel as jk2

    def spy(name, fn):
        def wrapped(*a, **kw):
            called.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(jgemv, "qgemv_pallas", spy("qgemv", jgemv.qgemv_pallas))
    monkeypatch.setattr(jdec, "qmm_decode_pallas", spy("qmm_decode", jdec.qmm_decode_pallas))
    monkeypatch.setattr(jk2, "qmm_pallas", spy("qmm", jk2.qmm_pallas))
    monkeypatch.setattr(jqmm, "use_pallas_qmm", lambda: True)
    monkeypatch.setattr(jqmm, "_pallas_local",
                        functools.partial(jqmm._pallas_local, interpret=True))
    ref = np.asarray(jqmm.matmul(jnp.asarray(x), j))
    assert called == ([] if route == "dequant_matmul" else [route])
    assert np.abs(y.numpy() - ref).max() <= 2e-2 * np.abs(ref).max()
