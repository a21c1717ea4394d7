"""K4's int8-dot mode: the port's plain version (`flash_decode` on CPU
tensors, qk_dtype="int8") against the JAX package's batched Pallas kernel
with qk_dtype="int8" in interpret mode, on a q8 cache.

Both quantize each query row and, per block of block_k keys aligned at
multiples of block_k, each row of p * v_scale; the integer dots are exact
on both sides.  They can differ where float rounding (exp, the division by
psc) moves a quantized value by one step, which moves an output by at most
one step of `chip_smoke.int8_step` (max_i(P_i * v_scale_i) * max|v8| / 127,
P the row's probabilities).  The limit is one such step per element (the
card's is two, DECODE_INT8_STEPS); measured on these cases: at most 3.4e-4
of a step (8.3e-6 of the output scale), so no value moved.  Quantizing p
over 256-key blocks where the Pallas kernel's block is 512 keys computes
another function, 9.7 steps away at most
(test_quantizing_over_a_smaller_block_is_another_function)."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax.numpy as jnp

import chip_smoke

from chatllm_tpu.ops.attention import quantize_kv as jquantize
from chatllm_tpu.ops.pallas.flash_decode import flash_decode as jflash_decode
from chatllm_tpu_torch.ops.attention import quantize_kv
from chatllm_tpu_torch.ops.cuda.flash_decode import (batched_block_k, default_qk_dtype,
                                                     flash_decode, flash_decode_plain)

STEPS = 1.0


def _case(B, T, Hq, Hkv, S, seed, D=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    sinks = rng.standard_normal(Hq).astype(np.float32)
    return q, k, v, sinks


def _both(q, k, v, n_past, T, *, block_k, port_block_k=None, sinks=None, **kw):
    """(port, jax, one step of pq per row) for the same inputs."""
    jk, jks = jquantize(jnp.asarray(k))
    jv, jvs = jquantize(jnp.asarray(v))
    (tk, tks), (tv, tvs) = quantize_kv(torch.from_numpy(k)), quantize_kv(torch.from_numpy(v))
    jnp_past = jnp.asarray(n_past, jnp.int32) if isinstance(n_past, list) else n_past
    tnp_past = torch.tensor(n_past, dtype=torch.int64) if isinstance(n_past, list) else n_past
    jsk = None if sinks is None else jnp.asarray(sinks)
    tsk = None if sinks is None else torch.from_numpy(sinks)
    ref = jflash_decode(jnp.asarray(q), jk, jv, jnp_past, T, k_scale=jks, v_scale=jvs,
                        sinks=jsk, interpret=True, block_k=block_k, qk_dtype="int8", **kw)
    out = flash_decode(torch.from_numpy(q), tk, tv, tnp_past, T, k_scale=tks, v_scale=tvs,
                       sinks=tsk, qk_dtype="int8", block_k=port_block_k or block_k, **kw)
    step = chip_smoke.int8_step(torch.from_numpy(q), tk, tv, tnp_past, T, k_scale=tks,
                                v_scale=tvs, sinks=tsk, **kw)
    return out.numpy(), np.asarray(ref), step.numpy()


# (B, T, Hq, Hkv, S, n_past, extra)
CASES = {
    "hkv8_one_row": (1, 1, 32, 8, 1024, 700, {}),
    "hkv4_per_row": (3, 1, 16, 4, 1024, [5, 511, 1000], {}),
    "hkv1_mqa": (2, 2, 8, 1, 1024, [300, 900], {}),
    "t2_across_block_edge": (2, 2, 8, 4, 1024, [510, 767], {}),
    "window_softcap": (2, 1, 8, 4, 1024, [900, 1000],
                       {"sliding_window": 300, "logit_softcap": 30.0}),
    "sinks": (2, 1, 8, 4, 1024, [100, 800], {"sinks": True}),
}


@pytest.mark.parametrize("block_k", [256, 512])
@pytest.mark.parametrize("case", list(CASES))
def test_int8_dots_match_pallas(case, block_k):
    B, T, Hq, Hkv, S, n_past, extra = CASES[case]
    q, k, v, sinks = _case(B, T, Hq, Hkv, S, seed=len(case) + block_k)
    kw = dict(scale=128 ** -0.5, sliding_window=extra.get("sliding_window", 0),
              logit_softcap=extra.get("logit_softcap", 0.0))
    out, ref, step = _both(q, k, v, n_past, T, block_k=block_k,
                           sinks=sinks if extra.get("sinks") else None, **kw)
    assert out.shape == ref.shape == (B, T, Hq, 128) and np.isfinite(out).all()
    assert (np.abs(out - ref) / step).max() <= STEPS


def test_quantizing_over_a_smaller_block_is_another_function():
    """p quantized per row over 256-key blocks (the float dots' split) is
    not the Pallas kernel's 512-key quantization: several steps away, more
    than the card's limit."""
    q, k, v, _ = _case(1, 1, 32, 8, 1024, seed=3)
    kw = dict(scale=128 ** -0.5)
    same, ref, step = _both(q, k, v, 1000, 1, block_k=512, **kw)
    other, _, _ = _both(q, k, v, 1000, 1, block_k=512, port_block_k=256, **kw)
    assert (np.abs(same - ref) / step).max() <= STEPS
    assert (np.abs(other - ref) / step).max() > 2 * chip_smoke.DECODE_INT8_STEPS


def test_int8_without_scales_falls_back_to_bf16():
    """As the Pallas wrapper does (flash_decode.py:428-429)."""
    q, k, v, _ = _case(1, 1, 8, 4, 512, seed=4)
    args = (torch.from_numpy(q), torch.from_numpy(k).to(torch.bfloat16),
            torch.from_numpy(v).to(torch.bfloat16), 300, 1)
    torch.testing.assert_close(flash_decode(*args, scale=0.1, qk_dtype="int8"),
                               flash_decode_plain(*args, scale=0.1, qk_dtype="bfloat16"),
                               rtol=0, atol=0)


@pytest.mark.parametrize("env,D,Hkv,quant,want", [
    (None, 128, 8, True, "bfloat16"), ("int8", 128, 8, True, "int8"),
    ("int8", 128, 8, False, "bfloat16"), ("f32", 128, 8, True, "float32"),
    ("bf16", 64, 1, True, "bfloat16"), ("int8", 64, 2, True, "float32")])
def test_qk_env_read_where_the_batched_kernel_runs(monkeypatch, env, D, Hkv, quant, want):
    """CHATLLM_TPU_FLASH_QK picks the dots only where the JAX package takes
    its batched kernel (D % 128 == 0, or one kv head); its per-head kernel
    (Qwen2.5-0.5B's D 64 over 2 kv heads) always dots in f32."""
    if env is None:
        monkeypatch.delenv("CHATLLM_TPU_FLASH_QK", raising=False)
    else:
        monkeypatch.setenv("CHATLLM_TPU_FLASH_QK", env)
    assert default_qk_dtype(D, D, Hkv, quant) == want


@pytest.mark.parametrize("S,Hkv,D,itemsize,want", [
    (8192, 8, 128, 1, 512), (8192, 8, 128, 2, 512), (8192, 8, 128, 4, 256),
    (8192, 16, 128, 4, 128), (256, 8, 128, 1, 256)])
def test_block_k_capped_as_the_batched_kernel_caps_it(S, Hkv, D, itemsize, want):
    """A [block_k, Hkv * D] tile of at most 1 MB, not below 128, at most S."""
    assert batched_block_k(512, S, Hkv, D, D, itemsize) == want
