"""K4's plain version (the port's `flash_decode` on CPU tensors) against the
JAX package's Pallas `flash_decode` in interpret mode, on the cases of
tests/test_flash_decode.py.

Tolerances, relative to the output scale max|ref|: f32 dots 1e-5
(summation order only).  bf16 dots: both sides round q, the int8 or bf16
cache values (exactly) and p * v_scale to bf16, but the Pallas kernel
rounds each p against its 256-key block's running max and the port's plain
version against the row's max, so the roundings of p differ, each by at
most 2^-9 of p.  Measured on these cases: at most 1.8e-3 of the output
scale; the bound is 4e-3.  The Pallas per-head kernel (D % 128 != 0 with
more than one kv head) always dots in f32, so bf16 dots are held against
it only where it takes its batched kernel."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax.numpy as jnp

from chatllm_tpu.ops.attention import quantize_kv as jquantize
from chatllm_tpu.ops.pallas.flash_decode import flash_decode as jflash_decode
from chatllm_tpu_torch.ops.attention import quantize_kv
from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode

TOL = {"float32": 1e-5, "bfloat16": 4e-3}


def _mk(B=2, T=1, Hq=8, Hkv=4, D=64, S=1024, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return q, k, v


def _run(q, k, v, n_past, T, *, quant, qk_dtype, sinks=None, **kw):
    """(port, jax) outputs as numpy for the same inputs."""
    jkw, tkw = dict(kw), dict(kw)
    jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k), torch.from_numpy(v)
    if quant:
        jk, jks = jquantize(jk)
        jv, jvs = jquantize(jv)
        jkw.update(k_scale=jks, v_scale=jvs)
        (tk, tks), (tv, tvs) = quantize_kv(tk), quantize_kv(tv)
        tkw.update(k_scale=tks, v_scale=tvs)
    if sinks is not None:
        jkw["sinks"] = jnp.asarray(sinks)
        tkw["sinks"] = torch.from_numpy(sinks)
    jnp_past = jnp.asarray(n_past, jnp.int32) if isinstance(n_past, list) else n_past
    tnp_past = torch.tensor(n_past, dtype=torch.int64) if isinstance(n_past, list) else n_past
    ref = jflash_decode(jnp.asarray(q), jk, jv, jnp_past, T, interpret=True, block_k=256,
                        qk_dtype=qk_dtype, **jkw)
    out = flash_decode(torch.from_numpy(q), tk, tv, tnp_past, T, qk_dtype=qk_dtype, **tkw)
    return out.numpy(), np.asarray(ref)


def _check(out, ref, qk_dtype):
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= TOL[qk_dtype], err


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("D,qk_dtype", [(64, "float32"), (128, "float32"), (128, "bfloat16")])
def test_matches_pallas(D, qk_dtype, T, quant):
    q, k, v = _mk(T=T, D=D)
    out, ref = _run(q, k, v, 700, T, quant=quant, qk_dtype=qk_dtype, scale=D ** -0.5)
    _check(out, ref, qk_dtype)


CASES = {
    "per_row_npast": dict(mk=dict(B=4), n_past=[10, 700, 256, 1022], T=1, quant=True),
    "window_softcap": dict(mk=dict(T=2, seed=3), n_past=700, T=2, quant=False,
                           kw=dict(sliding_window=128, logit_softcap=30.0)),
    "window_softcap_d128": dict(mk=dict(T=2, D=128, seed=4), n_past=700, T=2, quant=True,
                                kw=dict(sliding_window=128, logit_softcap=30.0)),
    "sinks": dict(mk=dict(seed=5), n_past=700, T=1, quant=False, sinks=True),
    "sinks_d128": dict(mk=dict(D=128, seed=6), n_past=700, T=1, quant=True, sinks=True),
    "uneven_rows": dict(mk=dict(B=1, Hq=6, Hkv=2, S=512, seed=9), n_past=300, T=1,
                        quant=False),
    "uneven_rows_d128": dict(mk=dict(B=1, T=4, Hq=6, Hkv=2, D=128, S=512, seed=10),
                             n_past=300, T=4, quant=True),
    "batched_variants": dict(mk=dict(B=8, Hkv=4, D=128, S=512, seed=21),
                             n_past=[10, 500, 256, 511, 64, 300, 128, 1], T=1, quant=True,
                             sinks=True, kw=dict(sliding_window=192, logit_softcap=30.0)),
    "scalar_npast_t2": dict(mk=dict(B=4, T=2, D=128, seed=37), n_past=1000, T=2, quant=True),
}


def _batched_kernel_shape(c) -> bool:
    mk = c["mk"]
    return mk.get("D", 64) % 128 == 0 or mk.get("Hkv", 4) == 1


@pytest.mark.parametrize("case,qk_dtype", [
    (name, dt) for name, c in CASES.items()
    for dt in (("float32", "bfloat16") if _batched_kernel_shape(c) else ("float32",))])
def test_cases_match_pallas(case, qk_dtype):
    c = CASES[case]
    q, k, v = _mk(**c["mk"])
    sinks = (np.random.default_rng(7).standard_normal(q.shape[2]).astype(np.float32)
             if c.get("sinks") else None)
    out, ref = _run(q, k, v, c["n_past"], c["T"], quant=c["quant"], qk_dtype=qk_dtype,
                    sinks=sinks, scale=0.125, **c.get("kw", {}))
    _check(out, ref, qk_dtype)


def test_default_dot_dtype_follows_the_pallas_kernels():
    """bf16 dots where the JAX package takes its batched kernel (D % 128 == 0
    or one kv head), f32 dots in its per-head kernel (D = 64 here)."""
    for D, Hkv in ((128, 4), (64, 4), (64, 1)):
        q, k, v = _mk(B=1, Hkv=Hkv, D=D, seed=D + Hkv)
        kq, ks = quantize_kv(torch.from_numpy(k))
        vq, vs = quantize_kv(torch.from_numpy(v))
        args = (torch.from_numpy(q), kq, vq, 500, 1)
        kw = dict(scale=0.1, k_scale=ks, v_scale=vs)
        want = "bfloat16" if D % 128 == 0 or Hkv == 1 else "float32"
        assert torch.equal(flash_decode(*args, **kw), flash_decode(*args, qk_dtype=want, **kw))


def test_rejects_unknown_dot_dtype():
    # int8 is a dot dtype (tests/test_torch_flash_decode_int8.py); float16 is not
    q, k, v = _mk(B=1)
    with pytest.raises(ValueError, match="qk_dtype"):
        flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 5, 1,
                     scale=0.1, qk_dtype="float16")
