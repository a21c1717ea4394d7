"""The JAX package's attention switches, set for both packages: the route
each takes (the port's KERNEL_DISPATCH against the JAX package's dispatch
counters, `flash_decode:pallas[:q8kv]` being the port's
`flash_decode[:q8kv]`, and a spy on its K3) and the outputs.

  CHATLLM_TPU_FLASH=0/1         K3 (and K4 while CHATLLM_TPU_FLASH_DECODE is unset)
  CHATLLM_TPU_FLASH_DECODE=0/1  K4; 1 is the forced mode (S >= 512, any cache,
                                any B * G * T)
  CHATLLM_TPU_FLASH_QK          K4's dots where the JAX package takes its
                                batched kernel: f32, bf16 or int8
  CHATLLM_TPU_FLASH_GROUP       accepted and ignored (exact zeros only)

The JAX package runs its kernels in interpret mode, the port its plain
versions.  Tolerances, relative to the output scale: f32 dots 1e-5 (sums in
another order); bf16 dots 4e-3 (p rounded against another running max,
tests/test_torch_flash_decode.py); int8 dots one quantization step per
element (tests/test_torch_flash_decode_int8.py)."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax.numpy as jnp

import chip_smoke
from chatllm_tpu.ops import attention as jatt
from chatllm_tpu.ops import qmm as jqmm
from chatllm_tpu.ops.pallas import flash as jflash
from chatllm_tpu_torch.ops import attention as tatt
from chatllm_tpu_torch.ops import qmm as tqmm

SWITCHES = ("CHATLLM_TPU_FLASH", "CHATLLM_TPU_FLASH_DECODE", "CHATLLM_TPU_FLASH_QK",
            "CHATLLM_TPU_FLASH_GROUP")
TOL = {"float32": 1e-5, "bfloat16": 4e-3}


@pytest.fixture
def env(monkeypatch):
    """Clears the four switches, runs the JAX package's K3 in interpret mode
    and records its calls; returns (set, k3_calls)."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    calls = []
    k3 = jflash.flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return k3(*a, **{**kw, "interpret": True})

    monkeypatch.setattr(jflash, "flash_attention", spy)
    return (lambda **kv: [monkeypatch.setenv(k, v) for k, v in kv.items()]), calls


def _inputs(B, T, S, Hq, Hkv, D, cache, seed, n_past):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    jkw, tkw = {}, {}
    if cache == "int8":
        (jk, jks), (jv, jvs) = jatt.quantize_kv(jnp.asarray(k)), jatt.quantize_kv(jnp.asarray(v))
        tk, tv = (torch.from_numpy(np.array(a)) for a in (jk, jv))
        jkw = dict(k_scale=jks, v_scale=jvs)
        tkw = {n: torch.from_numpy(np.array(a)) for n, a in jkw.items()}
    elif cache == "bfloat16":
        tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
        jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (tk, tv))
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    jnp_past = jnp.asarray(n_past, jnp.int32) if isinstance(n_past, list) else n_past
    tnp_past = torch.tensor(n_past) if isinstance(n_past, list) else n_past
    return ((jnp.asarray(q), jk, jv, jnp_past, jkw), (torch.from_numpy(q), tk, tv, tnp_past, tkw))


def _run(args, T, **kw):
    """(port out, jax out, port routes, jax routes, jax took K3)."""
    (jq, jk, jv, jn, jkw), (tq, tk, tv, tn, tkw) = args
    jqmm.reset_kernel_dispatch_stats()
    tqmm.reset_kernel_dispatch_stats()
    ref = np.asarray(jatt.attention_with_cache(jq, jk, jv, jn, T, **kw, **jkw), np.float32)
    out = tatt.attention_with_cache(tq, tk, tv, tn, T, **kw, **tkw).float().numpy()
    jroutes = {r.replace(":pallas", ""): n for r, n in jqmm.kernel_dispatch_stats().items()}
    return out, ref, tqmm.kernel_dispatch_stats(), jroutes


def _rel(out, ref):
    return np.abs(out - ref).max() / np.abs(ref).max()


PREFILL = dict(B=1, T=128, S=1024, Hq=4, Hkv=2, D=64, cache="float32", seed=1, n_past=300)
DECODE_Q8 = dict(B=1, T=1, S=4096, Hq=8, Hkv=2, D=64, cache="int8", seed=2, n_past=3000)


@pytest.mark.parametrize("value", ["0", "1"])
def test_flash_switch(env, value):
    """CHATLLM_TPU_FLASH gates K3 on a 128-token chunk and, with
    CHATLLM_TPU_FLASH_DECODE unset, K4 on a q8 decode step."""
    setenv, k3 = env
    setenv(CHATLLM_TPU_FLASH=value)
    out, ref, troutes, jroutes = _run(_inputs(**PREFILL), 128, scale=0.125, sliding_window=96)
    assert (troutes.get("flash_attention", 0) == 1) == bool(k3) == (value == "1")
    assert _rel(out, ref) <= TOL["float32"]
    k3.clear()
    out, ref, troutes, jroutes = _run(_inputs(**DECODE_Q8), 1, scale=0.125)
    assert troutes == jroutes == ({"flash_decode:q8kv": 1} if value == "1" else {})
    assert _rel(out, ref) <= TOL["float32"]          # D 64: f32 dots in either route


# (case, B, T, S, Hq, Hkv, D, cache, n_past, route under CHATLLM_TPU_FLASH_DECODE=1)
DECODE_CASES = {
    "q8_long": (1, 1, 4096, 8, 2, 64, "int8", 3000, "flash_decode:q8kv"),
    "q8_rows_per_slot": (4, 1, 4096, 8, 2, 64, "int8", [5, 4000, 100, 2048],
                         "flash_decode:q8kv"),
    "bf16_short_cache": (2, 1, 512, 8, 2, 64, "bfloat16", [100, 500], "flash_decode"),
    "f32_many_rows": (4, 2, 1024, 8, 2, 64, "float32", 600, "flash_decode"),
    "qwen_g7_t8": (1, 8, 1024, 14, 2, 64, "bfloat16", 700, "flash_decode"),
    "qwen_g7_t8_q8": (2, 8, 512, 14, 2, 64, "int8", [0, 400], "flash_decode:q8kv"),
    "too_short": (1, 1, 256, 8, 2, 64, "int8", 100, None),
    "t9": (1, 9, 1024, 8, 2, 64, "int8", 100, None),
}


@pytest.mark.parametrize("value", ["0", "1"])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_flash_decode_switch(env, case, value):
    """=0 takes no K4; =1 is the forced mode: any cache, any B * G * T
    (Qwen2.5-0.5B's 7 heads per kv head at T = 8: 56 rows), S >= 512."""
    setenv, _ = env
    setenv(CHATLLM_TPU_FLASH_DECODE=value)
    B, T, S, Hq, Hkv, D, cache, n_past, route = DECODE_CASES[case]
    args = _inputs(B, T, S, Hq, Hkv, D, cache, len(case), n_past)
    out, ref, troutes, jroutes = _run(args, T, scale=D ** -0.5)
    want = {route: 1} if value == "1" and route else {}
    assert troutes == jroutes == want
    # D 64 over 2 kv heads: the per-head Pallas kernel, f32 dots; the dense
    # paths dot in f32 too (an f32 query)
    assert out.shape == (B, T, Hq, D) and _rel(out, ref) <= TOL["float32"]


@pytest.mark.parametrize("value", ["f32", "bf16", "int8", None])
@pytest.mark.parametrize("Hkv,D", [(8, 128), (2, 64)])
def test_flash_qk_switch(env, value, Hkv, D):
    """CHATLLM_TPU_FLASH_QK sets K4's dots where the JAX package takes its
    batched kernel (D 128); its per-head kernel (D 64 over 2 kv heads)
    ignores it and dots in f32."""
    setenv, _ = env
    setenv(CHATLLM_TPU_FLASH="1")
    if value is not None:
        setenv(CHATLLM_TPU_FLASH_QK=value)
    args = _inputs(1, 1, 4096, 4 * Hkv, Hkv, D, "int8", 5 + D, 2500)
    out, ref, troutes, jroutes = _run(args, 1, scale=D ** -0.5)
    assert troutes == jroutes == {"flash_decode:q8kv": 1}
    dots = {"f32": "float32", "int8": "int8"}.get(value, "bfloat16") if D == 128 else "float32"
    if dots == "int8":
        (_, _, _, _, _), (tq, tk, tv, tn, tkw) = args
        step = chip_smoke.int8_step(tq, tk, tv, tn, 1, scale=D ** -0.5, **tkw).numpy()
        assert (np.abs(out - ref) / step).max() <= 1.0
    else:
        assert _rel(out, ref) <= TOL[dots]


@pytest.mark.parametrize("value", ["1", "2", "8"])
def test_flash_group_switch_changes_nothing(env, value):
    """The JAX package packs CHATLLM_TPU_FLASH_GROUP heads into one
    block-diagonal q; the extra entries are exact zeros, so its output does
    not move, and the port, which ignores the switch, gives the same bits."""
    setenv, _ = env
    setenv(CHATLLM_TPU_FLASH="1", CHATLLM_TPU_FLASH_QK="f32")
    args = _inputs(2, 1, 4096, 32, 8, 128, "int8", 9, [1000, 3000])
    base_out, base_ref, _, _ = _run(args, 1, scale=128 ** -0.5)
    setenv(CHATLLM_TPU_FLASH_GROUP=value)
    out, ref, troutes, jroutes = _run(args, 1, scale=128 ** -0.5)
    assert troutes == jroutes == {"flash_decode:q8kv": 1}
    np.testing.assert_array_equal(out, base_out)
    assert _rel(ref, base_ref) <= TOL["float32"]
    assert _rel(out, ref) <= TOL["float32"]


def test_unset_switches_keep_the_routes(env):
    """Unset, a switch means what the JAX package's TPU default means: K3 on
    a long chunk, K4 on a q8 decode step with few rows, none on a bf16 one."""
    for kw, T, want in ((PREFILL, 128, {"flash_attention": 1}),
                        (DECODE_Q8, 1, {"flash_decode:q8kv": 1}),
                        (dict(DECODE_Q8, cache="bfloat16"), 1, {})):
        (_, (tq, tk, tv, tn, tkw)) = _inputs(**kw)
        tqmm.reset_kernel_dispatch_stats()
        tatt.attention_with_cache(tq, tk, tv, tn, T, scale=0.125, **tkw)
        assert tqmm.kernel_dispatch_stats() == want


def test_int8_route_passes_the_jax_block(env, monkeypatch):
    """The K4 route hands the JAX route's block (`_pick_block(S, 512, 128)`)
    to the kernel, which quantizes p over it."""
    setenv, _ = env
    setenv(CHATLLM_TPU_FLASH="1", CHATLLM_TPU_FLASH_QK="int8")
    seen = []
    real = tatt.flash_decode

    def spy(*a, **kw):
        seen.append(kw["block_k"])
        return real(*a, **kw)

    monkeypatch.setattr(tatt, "flash_decode", spy)
    for S in (4096, 5376):                  # 5376 = 10.5 x 512: blocks of 256
        (_, (tq, tk, tv, tn, tkw)) = _inputs(1, 1, S, 8, 2, 128, "int8", 3, 2000)
        tatt.attention_with_cache(tq, tk, tv, tn, 1, scale=0.1, **tkw)
    assert seen == [512, 256]
