"""The JAX package's quantized-matmul switches, set for both packages: the
route each takes (the port's KERNEL_DISPATCH against the Pallas kernel the
JAX package calls, or none) and the outputs.

  CHATLLM_TPU_QMM=0|1|auto     0: every quantized matmul dequantizes first;
                               1 and auto (on a TPU, on the card) take the
                               kernels
  CHATLLM_TPU_QMM_MAX_ROWS=n   the kernels take up to n rows (default 64)
  CHATLLM_TPU_GEMV=0|1         0: one row goes to K2 instead of K1
  CHATLLM_TPU_SB=0|1           0: k-quants load into the classic layout

The JAX package runs as it does on a TPU (its `auto` means Pallas there),
its kernels in interpret mode; the port runs its kernels' plain versions.
Tolerance: 2e-2 of the output scale where either side's kernel rounds to
bf16 (K2, the dequant path's bf16 weights), 1e-5 where both sides compute
in f32 (K1 against the GEMV kernel); the repacked arrays bit-exact."""
import functools

import jax
import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax.numpy as jnp

import chatllm_tpu.ops.pallas.gemv_kernel as jgemv
import chatllm_tpu.ops.pallas.qmm_decode as jdec
import chatllm_tpu.ops.pallas.qmm_kernel as jk2
import chatllm_tpu.ops.qmm as jqmm
from chatllm_tpu.ggmm.quants import GGMLType
from chatllm_tpu.ops import qtensor as jqt
from chatllm_tpu.ops.qtensor import QuantLinear as JQuantLinear
from chatllm_tpu_torch.ops import qmm as tqmm
from chatllm_tpu_torch.ops import qtensor as tqt
from chatllm_tpu_torch.ops.qtensor import QuantLinear
from test_torch_qmm import _classic, _jax_args, _superblock, _torch_args
from test_torch_qtensor import _bits, _raw

SWITCHES = ("CHATLLM_TPU_QMM", "CHATLLM_TPU_QMM_MAX_ROWS", "CHATLLM_TPU_GEMV",
            "CHATLLM_TPU_QMM_V2", "CHATLLM_TPU_SB")
K, N = 512, 256


@pytest.fixture
def env(monkeypatch):
    """Clears the switches, runs the JAX package as on a TPU with its
    kernels in interpret mode, records which Pallas kernel it calls;
    returns (set, called)."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    called = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            called.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(jgemv, "qgemv_pallas", spy("qgemv", jgemv.qgemv_pallas))
    monkeypatch.setattr(jdec, "qmm_decode_pallas", spy("qmm_decode", jdec.qmm_decode_pallas))
    monkeypatch.setattr(jk2, "qmm_pallas", spy("qmm", jk2.qmm_pallas))
    real = jqmm.use_pallas_qmm

    def on_tpu():
        # the JAX package's own reading of CHATLLM_TPU_QMM, on a TPU backend
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "default_backend", lambda: "tpu")
            return real()

    monkeypatch.setattr(jqmm, "use_pallas_qmm", on_tpu)
    monkeypatch.setattr(jqmm, "_pallas_local",
                        functools.partial(jqmm._pallas_local, interpret=True))
    return (lambda **kv: [monkeypatch.setenv(k, v) for k, v in kv.items()]), called


def _linears(w):
    ta, tkw = _torch_args(w)
    ja, jkw = _jax_args(w)
    common = dict(packed=w["packed"], zero_point=w["zero_point"], group_size=w["group"])
    t = QuantLinear(q=ta[0], s=ta[1], b=ta[2], d=tkw["d"], dm=tkw["dm"], sb=tkw["sb"], **common)
    j = JQuantLinear(q=ja[0], s=ja[1], b=ja[2], d=jkw["d"], dm=jkw["dm"], sb=jkw["sb"],
                     **common)
    return t, j


WEIGHTS = {
    "q4_k": lambda r: _superblock(r, K, N),
    "q8_affine": lambda r: _classic(r, K, N, 32, False, True, f16=True),
}


def _run(called, fmt, rows, seed=0):
    """(port out, jax out, port route, jax kernels called)."""
    rng = np.random.default_rng(seed + rows)
    t, j = _linears(WEIGHTS[fmt](rng))
    x = rng.standard_normal((rows, K)).astype(np.float32)
    tqmm.reset_kernel_dispatch_stats()
    called.clear()
    out = tqmm.matmul(torch.from_numpy(x), t).numpy()
    ref = np.asarray(jqmm.matmul(jnp.asarray(x), j))
    routes = tqmm.kernel_dispatch_stats()
    assert len(routes) == 1 and sum(routes.values()) == 1, routes
    return out, ref, next(iter(routes)), list(called)


def _check(out, ref, route, called, want):
    """The port's route is `want` and the JAX package called the same kernel
    (none for the dequant path); outputs within their tolerance."""
    assert route == want
    assert called == ([] if want == "dequant_matmul" else [want])
    tol = 1e-5 if want == "qgemv" else 2e-2
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("rows", [1, 5, 64])
@pytest.mark.parametrize("value", ["0", "1", "auto"])
def test_qmm_switch(env, value, rows):
    """CHATLLM_TPU_QMM=0 sends every row count to the dequant path in both
    packages; 1 and auto take K1 (one row) or K2."""
    setenv, called = env
    setenv(CHATLLM_TPU_QMM=value)
    out, ref, route, jcalled = _run(called, "q4_k", rows)
    want = "dequant_matmul" if value == "0" else ("qgemv" if rows == 1 else "qmm")
    _check(out, ref, route, jcalled, want)


# (value, rows, route): above 64 rows K2 runs on blocks of 64 rows, the
# Pallas kernel on the whole; at 0 even one row dequantizes
MAX_ROWS_CASES = [("0", 1, "dequant_matmul"), ("1", 1, "qgemv"), ("1", 2, "dequant_matmul"),
                  ("8", 8, "qmm"), ("8", 9, "dequant_matmul"), ("64", 64, "qmm"),
                  ("64", 65, "dequant_matmul"), ("128", 65, "qmm"), ("128", 128, "qmm"),
                  ("128", 129, "dequant_matmul")]


@pytest.mark.parametrize("value,rows,route", MAX_ROWS_CASES)
def test_qmm_max_rows_switch(env, value, rows, route):
    setenv, called = env
    setenv(CHATLLM_TPU_QMM_MAX_ROWS=value)
    out, ref, got, jcalled = _run(called, "q8_affine", rows)
    _check(out, ref, got, jcalled, route)


@pytest.mark.parametrize("v2", [None, "1"])
@pytest.mark.parametrize("value", ["0", "1"])
def test_gemv_switch(env, value, v2):
    """CHATLLM_TPU_GEMV=0 sends one row past K1: to K2, or to K5 under
    CHATLLM_TPU_QMM_V2=1, in both packages; 5 rows never take K1."""
    setenv, called = env
    setenv(CHATLLM_TPU_GEMV=value)
    if v2:
        setenv(CHATLLM_TPU_QMM_V2=v2)
    for rows in (1, 5):
        out, ref, route, jcalled = _run(called, "q4_k", rows)
        want = ("qgemv" if value == "1" and rows == 1
                else "qmm_decode" if v2 else "qmm")
        _check(out, ref, route, jcalled, want)


SB_FORMATS = [GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q2_K]
SB_SHAPE = (128, 512)     # [out, in]: in % 256 == 0 allows the superblock, out % 128 the kernels


@pytest.mark.parametrize("t", SB_FORMATS, ids=lambda t: t.name)
@pytest.mark.parametrize("value", ["0", "1"])
def test_sb_switch(env, value, t):
    """CHATLLM_TPU_SB, read at load time: =0 repacks the k-quants into the
    classic layout (f16 s and b, G 32 or 16, q4_k and q2_k nibble-packed),
    =1 into the superblock one, bit-exact in both packages; the two layers
    then give the same outputs through K1 and K2."""
    setenv, called = env
    setenv(CHATLLM_TPU_SB=value)
    raw = _raw(t, SB_SHAPE)
    j = jqt.linear_from_ggml(raw, t, SB_SHAPE)
    p = tqt.linear_from_ggml(raw, t, SB_SHAPE, device="cpu")
    assert (p.sb > 0) == (value == "1")
    for f in ("group_size", "packed", "zero_point", "sb"):
        assert getattr(p, f) == getattr(j, f), f
    for f in ("q", "s", "b", "d", "dm"):
        a, b = getattr(j, f), getattr(p, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape), f
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()), err_msg=f)
    rng = np.random.default_rng(int(t))
    for rows in (1, 5):
        x = rng.standard_normal((rows, SB_SHAPE[1])).astype(np.float32)
        tqmm.reset_kernel_dispatch_stats()
        called.clear()
        out = tqmm.matmul(torch.from_numpy(x), p).numpy()
        ref = np.asarray(jqmm.matmul(jnp.asarray(x), j))
        _check(out, ref, next(iter(tqmm.kernel_dispatch_stats())), list(called),
               "qgemv" if rows == 1 else "qmm")
