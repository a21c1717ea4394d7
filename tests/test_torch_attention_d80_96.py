"""K3 and K4 at head dims 80 and 96 (Phi-2's and Phi-3's heads) on the CPU:

  - K3's plain version against the JAX package's Pallas flash kernel in
    interpret mode, with a window across key tiles, the softcap, a chunk
    that ends at the cache's last slot, and Hkv 2 with G 1 and G 4 (2e-5,
    as at the other head dims, tests/test_torch_attention.py);
  - K4's plain version against the Pallas flash_decode in interpret mode
    (its per-head kernel, which the JAX package takes at these widths with
    more than one kv head, and its batched one over a single kv head) over
    int8 / bf16 / f32 caches, f32 and bf16 dots, scalar and per-row n_past,
    window, softcap and sinks (tests/test_torch_flash_decode.py's
    tolerances: 1e-5 of the output scale for f32 dots, 4e-3 for bf16), and
    its int8 dots against the batched Pallas kernel within one quantization
    step of pq (tests/test_torch_flash_decode_int8.py);
  - the routes of attention_with_cache at D 80 / 96 against the JAX
    package's, the dot dtype the JAX route picks there (f32: its per-head
    kernel), the wrappers' head dims and row limits;
  - the kernels' schedules at D 80 and 96 (D 128's 128-key tiles in the bf16
    kernel, 4 stages of 64-key tiles in the f32 one): every visible pair
    visited once, the shared memory within the H100's
    (tests/test_torch_flash_geometry.py's checks)."""
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
from chatllm_tpu_torch.ops import qmm as tqmm
from chatllm_tpu_torch.ops.attention import quantize_kv
from chatllm_tpu_torch.ops.cuda import flash as tflash
from chatllm_tpu_torch.ops.cuda import flash_decode as tfd
from test_torch_flash_geometry import _check as geometry_check

HEAD_DIMS = (80, 96)


def _qkv(rng, D, B, T, S, Hq, Hkv):
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))


# (T, S, n_past, n_tokens, window, softcap, Hq, Hkv)
K3_CASES = {
    "prefill_g1": (128, 256, 0, 128, 0, 0.0, 2, 2),
    "padded_chunk_g4": (128, 256, 0, 100, 0, 0.0, 8, 2),
    "window_across_tiles": (128, 384, 200, 128, 100, 0.0, 2, 2),
    "softcap_50": (128, 256, 64, 128, 0, 50.0, 8, 2),
    "ends_at_last_slot": (64, 512, 448, 64, 0, 0.0, 2, 2),
    "window_softcap_one_kv_head": (96, 512, 300, 96, 160, 50.0, 4, 1),
}


@pytest.mark.parametrize("case", list(K3_CASES))
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_plain_matches_pallas(D, case):
    T, S, n_past, n_tok, win, cap, Hq, Hkv = K3_CASES[case]
    q, k, v = _qkv(np.random.default_rng(len(case) + D), D, 1, T, S, Hq, Hkv)
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
# (B, T, Hq, Hkv, S, n_past, cache, extra): Hkv 2 takes the JAX package's
# per-head kernel (f32 dots whatever qk_dtype says), Hkv 1 its batched one
K4_CASES = {
    "q8_one_row_mha": (1, 1, 2, 2, 1024, 700, "int8", {}),
    "q8_per_row_b2_g4": (2, 1, 8, 2, 1024, [10, 900], "int8", {}),
    "q8_window_softcap": (1, 2, 2, 2, 1024, 800, "int8",
                          {"sliding_window": 300, "logit_softcap": 50.0}),
    "bf16_cache_sinks": (2, 1, 8, 2, 512, [100, 400], "bfloat16", {"sinks": True}),
    "f32_cache_t4": (1, 4, 2, 2, 512, 300, "float32", {}),
    "one_kv_head_t8": (1, 8, 4, 1, 512, 200, "int8", {"logit_softcap": 50.0}),
    "one_kv_head_bf16_sinks": (2, 1, 4, 1, 512, [50, 500], "bfloat16", {"sinks": True}),
}


@pytest.mark.parametrize("qk_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(K4_CASES))
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_decode_plain_matches_pallas(D, case, qk_dtype):
    B, T, Hq, Hkv, S, n_past, cache, extra = K4_CASES[case]
    rng = np.random.default_rng(len(case) + D)
    q, k, v = _qkv(rng, D, B, T, S, Hq, Hkv)
    sinks = rng.standard_normal(Hq).astype(np.float32) if extra.get("sinks") else None
    kw = {n: x for n, x in extra.items() if n != "sinks"}
    # the port takes the JAX route's dots: per-head kernel -> f32
    qk = qk_dtype if tfd.batched_kernel(D, D, Hkv) else "float32"
    out, ref, _ = _decode_both(q, k, v, n_past, T, cache=cache, qk_dtype=qk, sinks=sinks,
                               scale=D ** -0.5, **kw)
    assert out.shape == ref.shape == (B, T, Hq, D) and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= DECODE_TOL[qk] * np.abs(ref).max()


@pytest.mark.parametrize("case", [c for c, x in K4_CASES.items() if x[6] == "int8"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_decode_int8_dots_match_pallas(D, case):
    """K4's int8 dots against the batched Pallas kernel's (the JAX package
    takes it at these widths over one kv head; with more, the port's int8
    dots are held to the batched kernel run on each kv head alone): D
    products of |q8 k8| <= 127^2 per score, exact in int32; within one step
    of pq."""
    B, T, Hq, Hkv, S, n_past, cache, extra = K4_CASES[case]
    q, k, v = _qkv(np.random.default_rng(len(case) + D + 1), D, B, T, S, Hq, Hkv)
    G = Hq // Hkv
    outs, refs = [], []
    for h in range(Hkv):
        qh, kh, vh = (np.ascontiguousarray(x[:, :, h * n:(h + 1) * n])
                      for x, n in ((q, G), (k, 1), (v, 1)))
        out, ref, (tq, tk, tv, tnp, tkw) = _decode_both(
            qh, kh, vh, n_past, T, cache=cache, qk_dtype="int8", scale=D ** -0.5, block_k=256,
            **extra)
        step = chip_smoke.int8_step(torch.from_numpy(qh), tk, tv, tnp, T, **tkw).numpy()
        assert (np.abs(out - ref) / step).max() <= 1.0
        outs.append(out)
        refs.append(ref)
    # the port's int8 dots over all kv heads at once equal the per-head runs
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    (tk, tks), (tv, tvs) = quantize_kv(tk), quantize_kv(tv)
    tnp = torch.tensor(n_past, dtype=torch.int64) if isinstance(n_past, list) else n_past
    whole = tfd.flash_decode(torch.from_numpy(q), tk, tv, tnp, T, scale=D ** -0.5,
                             qk_dtype="int8", block_k=256, k_scale=tks, v_scale=tvs,
                             **extra).numpy()
    assert np.isfinite(whole).all()
    np.testing.assert_array_equal(whole, np.concatenate(outs, axis=2))


def test_wrappers_take_d80_96():
    """Both wrappers list the new widths; the q8 cache's 64 rows a kv head
    hold at both (the D 256 limit is 32); the int8 block at Phi-3.5-mini's
    32 kv heads of 96 is the batched kernel's cap of a 1 MB tile."""
    for D in HEAD_DIMS:
        assert D in tfd.HEAD_DIMS and D in tflash.HEAD_DIMS
        assert tflash.BK[D] == 128 and tflash.TILE_D[D] == 128 and tflash.FBK[D] == 64
    assert tfd.MAX_ROWS == 64 and tfd.D256_MAX_ROWS == 32
    assert tfd.batched_block_k(512, 8192, 32, 96, 96, 1) == 256
    assert not tfd.batched_kernel(96, 96, 32) and tfd.batched_kernel(80, 80, 1)
    assert tfd.default_qk_dtype(96, 96, 32) == "float32"


# (T, S, n_past, n_tokens, window, softcap, cache, Hq, Hkv): the routes at D 80 / 96
ROUTE_CASES = {
    "k3_bf16_cache_window": (128, 1024, 200, 128, 300, 0.0, "bfloat16", 4, 4),
    "k3_softcap_g4": (128, 1024, 0, 128, 0, 50.0, "float32", 8, 2),
    "k4_q8_decode_mha": (1, 4096, 3000, 1, 1024, 50.0, "int8", 4, 4),
    "dense_short": (7, 64, 20, 7, 16, 50.0, "float32", 4, 4),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_attention_routes_match_jax(D, case):
    """attention_with_cache at D 80 / 96 takes the JAX package's route (K3
    for long chunks over a float cache, K4 for q8 decode over >= 4096
    slots, else dense) and agrees with its result: f32 routes 2e-5; K3 over
    a bf16 cache rounds p to bf16 (3e-2, tests/test_torch_attention.py); K4
    over the q8 cache with the per-head kernel's f32 dots 1e-4 of the output
    scale."""
    T, S, n_past, n_tok, win, cap, cache, Hq, Hkv = ROUTE_CASES[case]
    q, k, v = _qkv(np.random.default_rng(len(case) + D), D, 1, T, S, Hq, Hkv)
    k[:, n_past + n_tok:] = 0
    v[:, n_past + n_tok:] = 0
    kw = dict(scale=D ** -0.5, causal=True, sliding_window=win, logit_softcap=cap)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if cache == "int8":
        (tk, tks), (tv, tvs) = quantize_kv(tk), quantize_kv(tv)
        (jk, jks), (jv, jvs) = jquantize(jk), jquantize(jv)
        tkw, jkw = dict(kw, k_scale=tks, v_scale=tvs), dict(kw, k_scale=jks, v_scale=jvs)
        tol = 1e-4
    else:
        if cache == "bfloat16":
            tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
            jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tkw, jkw = kw, kw
        tol = 3e-2 if cache == "bfloat16" else 2e-5
    ref = np.asarray(jatt.attention_with_cache(jnp.asarray(q), jk, jv, n_past, n_tok, **jkw),
                     np.float32)
    tqmm.reset_kernel_dispatch_stats()
    out = tatt.attention_with_cache(torch.from_numpy(q), tk, tv, n_past, n_tok, **tkw)
    routes = {k for k, n in tqmm.KERNEL_DISPATCH.items() if n}
    want = ({"flash_attention"} if case.startswith("k3") else
            {"flash_decode:q8kv"} if case.startswith("k4") else set())
    assert routes == want
    assert out.shape == (1, T, Hq, D)
    assert np.abs(out.float().numpy() - ref).max() <= tol * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("case", [
    (1000, 8192, 0, 1000, 0), (128, 1024, 0, 100, 0), (512, 8192, 1001, 512, 1024),
    (200, 4000, 3800, 200, 0), (1000, 2048, 0, 1000, 300), (1024, 4096, 0, 1000, 0)])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_geometry_d80_96(D, case, mode):
    """The kernels' schedules at D 80 / 96 on chip_smoke's and the card
    tests' Phi cases, Phi-3.5-mini's 32 heads."""
    T, S, n_past, n_tok, win = case
    g = geometry_check(T, S, n_past, n_tok, D, True, win, mode=mode, heads=32)
    assert g["bk"] == (128 if mode == 0 else 64) and g["stages"] == (2 if mode == 0 else 4)
    assert g["smem"] <= tflash.SMEM_LIMIT
