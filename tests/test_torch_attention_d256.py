"""K3 and K4 at head_dim 256 (the Gemma family's heads) on the CPU:

  - K3's plain version against the JAX package's Pallas flash kernel in
    interpret mode, with a window across key tiles, the softcap and a
    chunk deep in the cache (2e-5, as at the other head dims,
    tests/test_torch_attention.py);
  - K4's plain version against the Pallas flash_decode in interpret mode
    over int8 / bf16 / f32 caches, f32 and bf16 dots, scalar and per-row
    n_past, window, softcap and sinks (tests/test_torch_flash_decode.py's
    tolerances: 1e-5 of the output scale for f32 dots, 4e-3 for bf16), and
    its int8 dots within one quantization step of pq
    (tests/test_torch_flash_decode_int8.py);
  - the routes of attention_with_cache at D 256 against the JAX package's;
  - the kernels' schedules at D 256 (64-key tiles of the bf16 kernel, 32-key
    tiles of the f32 one): every visible pair visited once, the shared
    memory within the H100's (tests/test_torch_flash_geometry.py's checks)."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax.numpy as jnp

import chip_smoke
from chatllm_tpu.ops import attention as jatt
from chatllm_tpu.ops.attention import quantize_kv as jquantize
from chatllm_tpu.ops.pallas.flash import flash_attention as jflash
from chatllm_tpu.ops.pallas.flash_decode import flash_decode as jflash_decode
from chatllm_tpu_torch.ops import attention as tatt
from chatllm_tpu_torch.ops.attention import quantize_kv
from chatllm_tpu_torch.ops.cuda import flash as tflash
from chatllm_tpu_torch.ops.cuda import flash_decode as tfd
from test_torch_flash_geometry import _check as geometry_check

D = 256


def _qkv(rng, B, T, S, Hq, Hkv):
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))


# (T, S, n_past, n_tokens, window, softcap, Hq, Hkv): Gemma-3-12B's heads
# (16 over 8, narrowed to 4 over 2), Gemma-3-1B's 4 over 1
K3_CASES = {
    "prefill": (128, 256, 0, 128, 0, 0.0, 4, 2),
    "padded_chunk": (128, 256, 0, 100, 0, 0.0, 4, 2),
    "window_across_tiles": (128, 384, 200, 128, 100, 0.0, 4, 2),
    "softcap_50": (128, 256, 64, 128, 0, 50.0, 4, 2),
    "window_softcap_g4": (96, 512, 300, 96, 160, 50.0, 4, 1),
    "deep_n_past": (64, 1024, 960, 64, 0, 0.0, 4, 2),
}


@pytest.mark.parametrize("case", list(K3_CASES))
def test_flash_plain_matches_pallas_d256(case):
    T, S, n_past, n_tok, win, cap, Hq, Hkv = K3_CASES[case]
    q, k, v = _qkv(np.random.default_rng(len(case)), 1, T, S, Hq, Hkv)
    kw = dict(scale=D ** -0.5, causal=True, sliding_window=win, logit_softcap=cap)
    ref = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_past, n_tok,
                            block_q=32, block_k=64, interpret=True, **kw))
    out = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), n_past, n_tok, **kw)
    assert out.shape == (1, T, Hq, D)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


def _decode_both(q, k, v, n_past, T, *, cache, qk_dtype, sinks=None, block_k=256, **kw):
    """(port, jax) K4 outputs for the same inputs over a cache of `cache`
    (int8 with scales, or bf16 / f32 values)."""
    jkw, tkw = dict(kw), dict(kw)
    jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k), torch.from_numpy(v)
    if cache == "int8":
        (jk, jks), (jv, jvs) = jquantize(jk), jquantize(jv)
        jkw.update(k_scale=jks, v_scale=jvs)
        (tk, tks), (tv, tvs) = quantize_kv(tk), quantize_kv(tv)
        tkw.update(k_scale=tks, v_scale=tvs)
    elif cache == "bfloat16":
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    if sinks is not None:
        jkw["sinks"], tkw["sinks"] = jnp.asarray(sinks), torch.from_numpy(sinks)
    per_row = isinstance(n_past, list)
    jnp_past = jnp.asarray(n_past, jnp.int32) if per_row else n_past
    tnp_past = torch.tensor(n_past, dtype=torch.int64) if per_row else n_past
    ref = jflash_decode(jnp.asarray(q), jk, jv, jnp_past, T, interpret=True, block_k=block_k,
                        qk_dtype=qk_dtype, **jkw)
    out = tfd.flash_decode(torch.from_numpy(q), tk, tv, tnp_past, T, qk_dtype=qk_dtype,
                           block_k=block_k, **tkw)
    return out.numpy(), np.asarray(ref, np.float32), (q, tk, tv, tnp_past, tkw)


DECODE_TOL = {"float32": 1e-5, "bfloat16": 4e-3}
# (B, T, Hq, Hkv, S, n_past, cache, extra)
K4_CASES = {
    "q8_one_row": (1, 1, 4, 2, 1024, 700, "int8", {}),
    "q8_per_row_b2": (2, 1, 4, 2, 1024, [10, 900], "int8", {}),
    "q8_window_softcap": (1, 2, 4, 2, 1024, 800, "int8",
                          {"sliding_window": 300, "logit_softcap": 50.0}),
    "bf16_cache_sinks": (2, 1, 4, 2, 512, [100, 400], "bfloat16", {"sinks": True}),
    "f32_cache_t4": (1, 4, 4, 2, 512, 300, "float32", {}),
    "g4_t8_32_rows": (1, 8, 4, 1, 512, 200, "int8", {"logit_softcap": 50.0}),
}


@pytest.mark.parametrize("qk_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(K4_CASES))
def test_flash_decode_plain_matches_pallas_d256(case, qk_dtype):
    B, T, Hq, Hkv, S, n_past, cache, extra = K4_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = _qkv(rng, B, T, S, Hq, Hkv)
    sinks = rng.standard_normal(Hq).astype(np.float32) if extra.get("sinks") else None
    kw = {n: x for n, x in extra.items() if n != "sinks"}
    out, ref, _ = _decode_both(q, k, v, n_past, T, cache=cache, qk_dtype=qk_dtype,
                               sinks=sinks, scale=D ** -0.5, **kw)
    assert out.shape == ref.shape == (B, T, Hq, D) and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= DECODE_TOL[qk_dtype] * np.abs(ref).max()


@pytest.mark.parametrize("case", [c for c, x in K4_CASES.items() if x[6] == "int8"])
def test_flash_decode_int8_dots_match_pallas_d256(case):
    """K4's int8 dots: 256 products of |q8 k8| <= 127^2 per score, exact in
    int32 as in the s8 MXU dots; within one step of pq of the Pallas kernel
    (its block_k 256 here)."""
    B, T, Hq, Hkv, S, n_past, cache, extra = K4_CASES[case]
    q, k, v = _qkv(np.random.default_rng(len(case) + 1), B, T, S, Hq, Hkv)
    out, ref, (tq, tk, tv, tnp, tkw) = _decode_both(
        q, k, v, n_past, T, cache=cache, qk_dtype="int8", scale=D ** -0.5, block_k=256,
        **extra)
    step = chip_smoke.int8_step(torch.from_numpy(q), tk, tv, tnp, T, **tkw).numpy()
    assert out.shape == ref.shape == (B, T, Hq, D) and np.isfinite(out).all()
    assert (np.abs(out - ref) / step).max() <= 1.0


def test_int8_block_k_at_gemma_widths():
    """The batched kernel's key block at Gemma-3-12B's 8 kv heads of 256:
    a 512-key int8 tile is 1 MB, kept; bf16 halves it (flash_decode.py:421)."""
    assert tfd.batched_block_k(512, 8192, 8, D, D, 1) == 512
    assert tfd.batched_block_k(512, 8192, 8, D, D, 2) == 256
    assert D in tfd.HEAD_DIMS and D in tflash.HEAD_DIMS and tfd.D256_MAX_ROWS == 32


# (T, S, n_past, n_tokens, window, softcap, cache): the routes at D 256
ROUTE_CASES = {
    "k3_bf16_cache_window": (128, 1024, 200, 128, 300, 0.0, "bfloat16"),
    "k3_softcap": (128, 1024, 0, 128, 0, 50.0, "float32"),
    "k4_q8_decode": (1, 4096, 3000, 1, 1024, 50.0, "int8"),
    "dense_short": (7, 64, 20, 7, 16, 50.0, "float32"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_attention_routes_match_jax_d256(case):
    """attention_with_cache at D 256 takes the same route as the JAX package
    (K3 for long chunks over a float cache, K4 for q8 decode over >= 4096
    slots, else dense) and agrees with its result: f32 routes 2e-5; K3 over
    a bf16 cache rounds p to bf16 (3e-2, tests/test_torch_attention.py); K4
    with bf16 dots over the q8 cache 4e-3 of the output scale."""
    T, S, n_past, n_tok, win, cap, cache = ROUTE_CASES[case]
    q, k, v = _qkv(np.random.default_rng(len(case)), 1, T, S, 4, 2)
    k[:, n_past + n_tok:] = 0
    v[:, n_past + n_tok:] = 0
    kw = dict(scale=D ** -0.5, causal=True, sliding_window=win, logit_softcap=cap)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if cache == "int8":
        (tk, tks), (tv, tvs) = quantize_kv(tk), quantize_kv(tv)
        (jk, jks), (jv, jvs) = jquantize(jk), jquantize(jv)
        tkw, jkw = dict(kw, k_scale=tks, v_scale=tvs), dict(kw, k_scale=jks, v_scale=jvs)
        tol = 4e-3
    else:
        if cache == "bfloat16":
            tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
            jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tkw, jkw = kw, kw
        tol = 3e-2 if cache == "bfloat16" else 2e-5
    ref = np.asarray(jatt.attention_with_cache(jnp.asarray(q), jk, jv, n_past, n_tok, **jkw),
                     np.float32)
    out = tatt.attention_with_cache(torch.from_numpy(q), tk, tv, n_past, n_tok, **tkw)
    assert out.shape == (1, T, 4, D)
    assert np.abs(out.float().numpy() - ref).max() <= tol * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("case", [
    (128, 1024, 0, 128, 0), (512, 8192, 1000, 512, 0), (128, 1024, 0, 100, 0),
    (512, 8192, 1001, 512, 1024), (200, 2048, 37, 180, 300), (512, 8192, 7000, 512, 0),
    (464, 8192, 1536, 464, 0)])
def test_geometry_d256(case, mode):
    """The kernels' schedules at D 256 on chip_smoke's Gemma cases."""
    T, S, n_past, n_tok, win = case
    g = geometry_check(T, S, n_past, n_tok, D, True, win, mode=mode, heads=16)
    assert g["bk"] == (64 if mode == 0 else 32) and g["stages"] == 2
    assert g["smem"] <= tflash.SMEM_LIMIT
