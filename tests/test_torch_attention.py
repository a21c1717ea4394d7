"""K3's plain version against the JAX package's Pallas flash kernel in
interpret mode (tests/test_flash.py's cases), and the port's
attention_with_cache / update_kv_cache against the JAX package's."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax.numpy as jnp

from chatllm_tpu.ops import attention as jatt
from chatllm_tpu.ops.pallas.flash import flash_attention as jflash
from chatllm_tpu_torch.ops import attention as tatt
from chatllm_tpu_torch.ops.cuda.flash import flash_attention, flash_attention_plain


def _qkv(rng, B, T, S, Hq, Hkv, D):
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return q, k, v


FLASH_CASES = {   # tests/test_flash.py
    "basic_gqa": dict(),
    "padded_prefill": dict(n_tokens=100, n_past=0),
    "sliding_window": dict(sliding_window=96, seed=1),
    "softcap": dict(softcap=30.0, seed=2),
    "fresh_prefill_full_causal": dict(n_past=0, T=256, S=256, seed=3),
    "mqa_uneven_blocks": dict(Hq=4, Hkv=1, T=96, S=192, n_past=96, seed=4),
    # the CUDA kernel's tile edges: n_past off the key tiles, a window across
    # them, Qwen2.5-0.5B's 7 query heads per kv head at head dim 64
    "n_past_off_tiles": dict(n_past=37, seed=5),
    "window_across_tiles": dict(sliding_window=100, seed=6),
    "gqa_7_heads_d64": dict(Hq=7, Hkv=1, D=64, seed=7),
    # a chunk at the cache's end (n_past = S - T), where the f32 kernel
    # splits its long key walks over a cluster
    "chunk_at_cache_end": dict(n_past=128, seed=8),
    "chunk_at_cache_end_7_heads_d64": dict(Hq=7, Hkv=1, D=64, T=64, S=320, n_past=256, seed=9),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_matches_pallas(case):
    c = dict(B=1, T=128, S=256, Hq=4, Hkv=2, D=32, n_past=64, n_tokens=None,
             sliding_window=0, softcap=0.0, seed=0)
    c.update(FLASH_CASES[case])
    rng = np.random.default_rng(c["seed"])
    q, k, v = _qkv(rng, c["B"], c["T"], c["S"], c["Hq"], c["Hkv"], c["D"])
    n_tokens = c["T"] if c["n_tokens"] is None else c["n_tokens"]
    kw = dict(scale=c["D"] ** -0.5, causal=True, sliding_window=c["sliding_window"],
              logit_softcap=c["softcap"])
    ref = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            c["n_past"], n_tokens, block_q=32, block_k=64,
                            interpret=True, **kw))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          c["n_past"], n_tokens, **kw)
    np.testing.assert_array_equal(
        out.numpy(), flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), c["n_past"], n_tokens,
                                           **kw).numpy())
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


ATTN_CASES = {
    "prefill_gqa": dict(T=7, S=32, n_past=0),
    "chunk_after_past": dict(T=5, S=32, n_past=9),
    "decode": dict(T=1, S=48, n_past=20),
    "padded_chunk": dict(T=16, S=64, n_past=3, n_tokens=11),
    "sliding_window": dict(T=8, S=40, n_past=12, window=6),
    "softcap": dict(T=6, S=32, n_past=4, softcap=20.0),
    "mha": dict(T=4, S=16, n_past=2, Hkv=4),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_with_cache_matches_jax(case):
    c = dict(B=1, Hq=4, Hkv=2, D=16, n_tokens=None, window=0, softcap=0.0)
    c.update(ATTN_CASES[case])
    rng = np.random.default_rng(len(case))
    q, k, v = _qkv(rng, c["B"], c["T"], c["S"], c["Hq"], c["Hkv"], c["D"])
    n_tokens = c["T"] if c["n_tokens"] is None else c["n_tokens"]
    kw = dict(scale=c["D"] ** -0.5, causal=True, logit_softcap=c["softcap"],
              sliding_window=c["window"])
    ref = np.asarray(jatt.attention_with_cache(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v), c["n_past"], n_tokens, **kw))
    out = tatt.attention_with_cache(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), c["n_past"], n_tokens, **kw)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_long_prefill_routes_to_flash():
    """T >= 128 over a >= 1024-slot bf16 cache takes K3 (its plain version on
    the CPU) with the f32 query as it is; the result agrees with the JAX
    package's dense path."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 1, 128, 1024, 4, 2, 64)
    n_past = 200
    k[:, n_past + 128:] = 0
    v[:, n_past + 128:] = 0
    kb = torch.from_numpy(k).to(torch.bfloat16)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    kw = dict(scale=64 ** -0.5, causal=True)
    out = tatt.attention_with_cache(torch.from_numpy(q), kb, vb, n_past, 128, **kw)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(
        out.numpy(),
        flash_attention_plain(torch.from_numpy(q), kb, vb, n_past, 128, **kw).numpy())
    ref = np.asarray(jatt.attention_with_cache(
        jnp.asarray(q), jnp.asarray(kb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(vb.float().numpy()).astype(jnp.bfloat16), n_past, 128, **kw))
    # the kernel route rounds the probabilities to bf16
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-2)


# n_past 0: 1e-5 of the output scale (measured 1.2e-7 to 1.9e-7 over eight
# seeds).  n_past 200: more keys per row, and now and then a probability
# lies within the two sides' f32 score differences of a bf16 rounding
# boundary and rounds the other way, moving one output by up to
# 2^-8 p_j |v_j| / l (measured up to 1.3e-4 over eight seeds).  The
# parent tree's bf16 query and output differ by ~2e-3 in both.
@pytest.mark.parametrize("n_past,tol", [(0, 1e-5), (200, 5e-4)])
def test_flash_f32_query_over_bf16_cache_matches_pallas(n_past, tol):
    """--compute_dtype f32 --cache_dtype bf16: K3 gets the f32 query as it
    is, dots it with the bf16 keys in f32, rounds the probabilities to bf16
    and writes f32, as the Pallas kernel does (flash.py:75, :83-86, :151).
    Every live key lies in the Pallas kernel's first 512-key block, so both
    round each probability against the same row max."""
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 1, 128, 1024, 8, 2, 64)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    kw = dict(scale=64 ** -0.5, causal=True, sliding_window=0, logit_softcap=0.0)
    out = tatt.attention_with_cache(torch.from_numpy(q), kb, vb, n_past, 128,
                                    scale=kw["scale"])
    ref = np.asarray(jflash(jnp.asarray(q), jnp.asarray(kb.float().numpy()).astype(jnp.bfloat16),
                            jnp.asarray(vb.float().numpy()).astype(jnp.bfloat16), n_past, 128,
                            block_q=128, block_k=512, interpret=True, **kw))
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    assert np.abs(out.numpy() - ref).max() <= tol * np.abs(ref).max()


def test_long_prefill_f32_cache_routes_to_flash(monkeypatch):
    """An f32 cache takes K3 under the same conditions (its f32 variant on
    the card); f32 throughout, so it agrees with the JAX package at 2e-5."""
    calls = []

    def spy(*a, **kw):
        calls.append(a[1].dtype)
        return flash_attention(*a, **kw)

    monkeypatch.setattr(tatt, "flash_attention", spy)
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 1, 256, 1024, 4, 2, 64)
    n_past = 300
    k[:, n_past + 200:] = 0
    v[:, n_past + 200:] = 0
    kw = dict(scale=64 ** -0.5, causal=True, sliding_window=128)
    out = tatt.attention_with_cache(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), n_past, 200, **kw)
    assert calls == [torch.float32] and out.dtype == torch.float32
    ref = np.asarray(jatt.attention_with_cache(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v), n_past, 200, **kw))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_update_kv_cache_matches_jax():
    rng = np.random.default_rng(6)
    kc = rng.standard_normal((1, 16, 2, 8)).astype(np.float32)
    vc = rng.standard_normal((1, 16, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, 5, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 5, 2, 8)).astype(np.float32)
    jk, jv, _, _ = jatt.update_kv_cache(jnp.asarray(kc), jnp.asarray(vc),
                                        jnp.asarray(k), jnp.asarray(v), 7)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tatt.update_kv_cache(tk, tv, torch.from_numpy(k), torch.from_numpy(v), 7)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_quantize_kv_bit_exact():
    """Same rounding (half to even), clip and zero-scale rule as the JAX
    package's q8 cache."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    x[0, 1, 2] = 0.0                                  # zero scale -> zero values
    x[1, 0, 0, :4] = [127.0, -63.5, 0.5, -0.5]        # ties at the scale 1
    x[1, 0, 0, 4:] = 0.25
    jq, js = jatt.quantize_kv(jnp.asarray(x))
    tq, ts = tatt.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("quant", [False, True])
def test_update_kv_cache_per_row_npast_matches_jax(quant):
    """A [B] n_past writes each row at its own offset; the row of slot 3,
    whose second token lies past the cache, drops that token instead of
    clamping it onto the last slot."""
    rng = np.random.default_rng(13)
    B, S, T = 4, 16, 2
    kc = rng.standard_normal((B, S, 2, 8)).astype(np.float32)
    vc = rng.standard_normal((B, S, 2, 8)).astype(np.float32)
    k = rng.standard_normal((B, T, 2, 8)).astype(np.float32)
    v = rng.standard_normal((B, T, 2, 8)).astype(np.float32)
    n_past = np.array([0, 5, 14, 15])
    jargs = [jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(n_past, jnp.int32)]
    targs = [torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), torch.from_numpy(k),
             torch.from_numpy(v), torch.from_numpy(n_past)]
    if quant:
        jks, jvs = (jnp.asarray(rng.standard_normal((B, S, 2)).astype(np.float32))
                    for _ in range(2))
        jargs[:2] = [jatt.quantize_kv(a)[0] for a in jargs[:2]]
        targs[:2] = [torch.from_numpy(np.array(a)) for a in jargs[:2]]
        jargs += [jks, jvs]
        targs += [torch.from_numpy(np.asarray(jks).copy()),
                  torch.from_numpy(np.asarray(jvs).copy())]
    jout = jatt.update_kv_cache(*jargs)
    tatt.update_kv_cache(*targs)
    tout = targs[:2] + targs[5:]
    for t, j in zip(tout, [o for o in jout if o is not None]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    first = torch.from_numpy(k)
    if quant:
        first = tatt.quantize_kv(first)[0]
    assert torch.equal(tout[0][3, S - 1], first[3, 0])


def _q8_case(rng, B, T, S, Hq, Hkv, D):
    q, k, v = _qkv(rng, B, T, S, Hq, Hkv, D)
    jk, jks = jatt.quantize_kv(jnp.asarray(k))
    jv, jvs = jatt.quantize_kv(jnp.asarray(v))
    jaxa = (jnp.asarray(q), jk, jv, dict(k_scale=jks, v_scale=jvs))
    ta = (torch.from_numpy(q), *(torch.from_numpy(np.array(a)) for a in (jk, jv)),
          dict(k_scale=torch.from_numpy(np.array(jks)),
               v_scale=torch.from_numpy(np.array(jvs))))
    return jaxa, ta


# (B, T, Hq, Hkv, S, n_past, takes K4): the JAX package's conditions are
# T <= 8, S >= 4096, B*G*T <= 16 and a q8 cache
ROUTE_CASES = {
    "decode_q8": (1, 1, 8, 2, 4096, 3000, True),
    "four_slots": (4, 1, 8, 2, 4096, [5, 4000, 100, 2048], True),
    "t4": (1, 4, 8, 2, 4096, 1000, True),
    "too_many_rows": (2, 4, 8, 2, 4096, 1000, False),     # B*G*T = 32
    "short_cache": (1, 1, 8, 2, 2048, 1000, False),
    "t9": (1, 9, 4, 2, 4096, 100, False),
    "bf16_cache": (1, 1, 8, 2, 4096, 3000, False),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_flash_decode_route_matches_jax_routing(case, monkeypatch):
    """The port takes K4 exactly where the JAX package under its TPU routing
    does (its flash_decode in interpret mode), and both agree."""
    from chatllm_tpu.ops import qmm as jqmm
    from chatllm_tpu_torch.ops import qmm as tqmm

    B, T, Hq, Hkv, S, n_past, k4 = ROUTE_CASES[case]
    monkeypatch.setattr(jatt, "_flash_decode_enabled", lambda: True)
    rng = np.random.default_rng(len(case))
    (jq, jk, jv, jkw), (tq, tk, tv, tkw) = _q8_case(rng, B, T, S, Hq, Hkv, 64)
    if case == "bf16_cache":
        k, v = (rng.standard_normal((B, S, Hkv, 64)).astype(np.float32) for _ in range(2))
        tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
        jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (tk, tv))
        jkw, tkw = {}, {}
    jnp_past = jnp.asarray(n_past, jnp.int32) if isinstance(n_past, list) else n_past
    tnp_past = torch.tensor(n_past) if isinstance(n_past, list) else n_past
    jqmm.reset_kernel_dispatch_stats()
    tqmm.reset_kernel_dispatch_stats()
    ref = np.asarray(jatt.attention_with_cache(jq, jk, jv, jnp_past, T, scale=0.125, **jkw))
    out = tatt.attention_with_cache(tq, tk, tv, tnp_past, T, scale=0.125, **tkw).numpy()
    took_jax = any(r.startswith("flash_decode") for r in jqmm.kernel_dispatch_stats())
    took_port = tqmm.kernel_dispatch_stats().get("flash_decode:q8kv", 0) == 1
    assert took_jax == took_port == k4
    # D = 64: f32 dots on both sides (the Pallas per-head kernel)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 300])
def test_chunked_attention_matches_jax(quant, window):
    """A prefill chunk over a >= 4096-slot cache (and K3 off: a q8 cache,
    or T < 128) takes the online-softmax chunks on both sides."""
    rng = np.random.default_rng(20 + window)
    T, n_past = 64, 2500
    if quant:
        (jq, jk, jv, jkw), (tq, tk, tv, tkw) = _q8_case(rng, 1, T, 4096, 4, 2, 32)
    else:
        q, k, v = _qkv(rng, 1, T, 4096, 4, 2, 32)
        (jq, jk, jv), jkw = (jnp.asarray(a) for a in (q, k, v)), {}
        (tq, tk, tv), tkw = (torch.from_numpy(a) for a in (q, k, v)), {}
    kw = dict(scale=32 ** -0.5, causal=True, sliding_window=window)
    ref = np.asarray(jatt.attention_with_cache(jq, jk, jv, n_past, T, **kw, **jkw))
    out = tatt.attention_with_cache(tq, tk, tv, n_past, T, **kw, **tkw).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_batched_npast_attention_matches_jax(quant):
    """More slots than K4 takes (or a float cache): dense attention with
    per-row masks on both sides."""
    rng = np.random.default_rng(30)
    n_past = [3, 60, 17, 0, 45, 1]
    if quant:
        (jq, jk, jv, jkw), (tq, tk, tv, tkw) = _q8_case(rng, 6, 1, 64, 4, 2, 16)
    else:
        q, k, v = _qkv(rng, 6, 1, 64, 4, 2, 16)
        (jq, jk, jv), jkw = (jnp.asarray(a) for a in (q, k, v)), {}
        (tq, tk, tv), tkw = (torch.from_numpy(a) for a in (q, k, v)), {}
    kw = dict(scale=0.25, causal=True, logit_softcap=20.0)
    ref = np.asarray(jatt.attention_with_cache(jq, jk, jv, jnp.asarray(n_past, jnp.int32),
                                               1, **kw, **jkw))
    out = tatt.attention_with_cache(tq, tk, tv, torch.tensor(n_past), 1, **kw, **tkw)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_bf16_dots_over_int8_cache_match_jax():
    """bf16 compute over a q8 cache: bf16 dots, as in the JAX package (the
    int8 values are exact in bf16; q and p round)."""
    rng = np.random.default_rng(40)
    (jq, jk, jv, jkw), (tq, tk, tv, tkw) = _q8_case(rng, 1, 3, 48, 4, 2, 16)
    jq, tq = jq.astype(jnp.bfloat16), tq.to(torch.bfloat16)
    ref = np.asarray(jatt.attention_with_cache(jq, jk, jv, 20, 3, scale=0.25, **jkw)
                     .astype(jnp.float32))
    out = tatt.attention_with_cache(tq, tk, tv, 20, 3, scale=0.25, **tkw).float().numpy()
    # both round the same operands; the outputs are bf16 (2^-8 relative)
    np.testing.assert_allclose(out, ref, atol=1e-2 * np.abs(ref).max())
