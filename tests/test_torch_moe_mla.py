"""The DeepSeek family's building blocks in the port against the JAX
package, on the CPU, from the same seeded numpy inputs (f32 throughout):

  - `moe_mlp` in every ported routing mode: the expert picks equal, the
    outputs within 1e-5 of their scale; the modes of other families raise;
  - `_moe_combine` on the same picks without a shared expert (Qwen3-MoE),
    with one (DeepSeek) and with Qwen2-MoE's sigmoid-gated one, in f32
    (1e-5) and bf16 (2^-7 of the output scale);
  - `mla_attention_block` (expanded cache) and `_mla_compressed_block`
    (latent cache), prefill then decode, with a scalar and a per-row
    n_past: outputs within 1e-5 of their scale, caches within 1e-6 (q8
    values within one int8 step);
  - `init_cache`'s MLA shapes;
  - the YaRN rope table of DeepSeek-V2-Lite (factor 40, original context
    4096) within 16 f32 ulps of its scale;
  - K4's plain twin at MLA's (D, Dv) = (192, 128) against the JAX
    `flash_decode` (its per-head Pallas kernel, interpret mode) over q8 and
    bf16 caches: 1e-5 of the output scale (f32 dots on both sides).
"""
import dataclasses

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp
import torch

import chatllm_tpu.nn.transformer as jt
import chatllm_tpu.ops.qtensor as jq
import chatllm_tpu.ops.rope as jr
import chatllm_tpu_torch.nn.transformer as tt
import chatllm_tpu_torch.ops.qtensor as tq
import chatllm_tpu_torch.ops.rope as tr
from chatllm_tpu_torch.models.synthetic import deepseek_v2_lite_config

TOL = 1e-5
H, E, F, FS = 64, 8, 32, 48


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _configs(**kw):
    """The same config in both packages (the port's fields are a subset)."""
    base = dict(vocab_size=64, hidden_size=H, num_hidden_layers=1, num_attention_heads=4,
                num_key_value_heads=4, intermediate_size=FS, max_length=64)
    base.update(kw)
    tk = {k: v for k, v in base.items() if k != "mla"}
    tcfg = tt.TransformerConfig(**tk, mla=_port_mla(base.get("mla")))
    return jt.TransformerConfig(**base), tcfg


def _port_mla(m):
    return None if m is None else tt.MLAConfig(**dataclasses.asdict(m))


def _dense(rng, i, o, scale=0.2):
    w = (rng.standard_normal((i, o)) * scale).astype(np.float32)
    return jq.DenseLinear(w=jnp.asarray(w)), tq.DenseLinear(w=torch.from_numpy(w))


def _moe_params(rng, gate_bias=False):
    jp, tp = {}, {}
    jp["gate"], tp["gate"] = _dense(rng, H, E, 1.0)
    ex = {n: (rng.standard_normal(shape) * 0.2).astype(np.float32)
          for n, shape in (("gate", (E, H, F)), ("up", (E, H, F)), ("down", (E, F, H)))}
    jp["experts"] = {n: jnp.asarray(v) for n, v in ex.items()}
    tp["experts"] = {n: torch.from_numpy(v) for n, v in ex.items()}
    jp["shared"], tp["shared"] = {}, {}
    for n, (i, o) in (("gate", (H, FS)), ("up", (H, FS)), ("down", (FS, H))):
        jp["shared"][n], tp["shared"][n] = _dense(rng, i, o)
    if gate_bias:
        b = (rng.standard_normal(E) * 0.05).astype(np.float32)
        jp["gate_bias"], tp["gate_bias"] = jnp.asarray(b), torch.from_numpy(b)
    return jp, tp


# (score func, gate_bias, n_group, topk_group, group select, norm, routed scale)
MOE_MODES = {
    "softmax": ("softmax", False, 1, 1, "sum2", False, 1.0),
    "softmax_norm_scaled": ("softmax", False, 1, 1, "sum2", True, 2.5),
    "softmax_max_groups": ("softmax", False, 4, 2, "sum2", False, 1.0),
    "sigmoid_bias_sum2": ("sigmoid", True, 4, 2, "sum2", True, 2.5),
    "sigmoid_bias_per_group_topk": ("sigmoid", True, 2, 1, "per_group_topk", True, 1.0),
    "sigmoid_bias_ungrouped": ("sigmoid", True, 1, 1, "sum2", False, 1.0),
}


@pytest.mark.parametrize("mode", list(MOE_MODES))
def test_moe_mlp_matches_the_jax_package(mode, monkeypatch):
    score, bias, ng, tg, sel, norm, scale = MOE_MODES[mode]
    rng = np.random.default_rng(len(mode))
    jcfg, tcfg = _configs(moe_num_experts=E, moe_top_k=3, moe_norm_topk_prob=norm,
                          moe_n_group=ng, moe_topk_group=tg, moe_group_select=sel,
                          moe_routed_scale=scale, moe_score_func=score)
    jp, tp = _moe_params(rng, bias)
    x = rng.standard_normal((2, 7, H)).astype(np.float32)
    picks = {}
    combine = jt._moe_combine

    def spy(cfg, p, xt, topi, topv, x_):
        picks["topi"], picks["topv"] = np.asarray(topi), np.asarray(topv)
        return combine(cfg, p, xt, topi, topv, x_)

    monkeypatch.setattr(jt, "_moe_combine", spy)
    want = np.asarray(jt.moe_mlp(jcfg, jp, jnp.asarray(x)))
    got = tt.moe_mlp(tcfg, tp, torch.from_numpy(x)).numpy()
    topi, topv = tt.moe_route(tcfg, tp, torch.from_numpy(x.reshape(-1, H)))
    np.testing.assert_array_equal(np.sort(topi.numpy(), -1), np.sort(picks["topi"], -1))
    order_t, order_j = np.argsort(topi.numpy(), -1), np.argsort(picks["topi"], -1)
    np.testing.assert_allclose(np.take_along_axis(topv.numpy(), order_t, -1),
                               np.take_along_axis(picks["topv"], order_j, -1),
                               rtol=TOL, atol=1e-6)
    # the picks vary across tokens
    assert len({tuple(sorted(r)) for r in picks["topi"]}) > 1
    assert got.dtype == np.float32 and _rel(got, want) <= TOL


def test_moe_mlp_in_bf16_keeps_the_jax_packages_picks():
    """bf16 activations and expert stacks (the chat path's dtypes): the
    router runs in f32 on both sides, so the picks are equal; the outputs
    agree to bf16's rounding (2^-7 of their scale)."""
    rng = np.random.default_rng(9)
    jcfg, tcfg = _configs(moe_num_experts=E, moe_top_k=3, moe_norm_topk_prob=False)
    jp, tp = _moe_params(rng)
    jp["experts"] = {n: v.astype(jnp.bfloat16) for n, v in jp["experts"].items()}
    tp["experts"] = {n: v.to(torch.bfloat16) for n, v in tp["experts"].items()}
    x = rng.standard_normal((1, 5, H)).astype(np.float32)
    want = np.asarray(jt.moe_mlp(jcfg, jp, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = tt.moe_mlp(tcfg, tp, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= 2.0 ** -7


# GPT-OSS's modes (softmax_topk, gate_linear_bias, the expert biases,
# swiglu_oai) run since they were ported: tests/test_torch_gpt_oss.py holds
# them against the JAX package
OTHER_MODES = {
    "sparsemixer": ("cfg", dict(moe_score_func="sparsemixer"), "Phi-3.5-MoE"),
    "grouped_argmax": ("cfg", dict(moe_grouped_argmax=True), "Pangu-MoE"),
    "pre_weighting": ("cfg", dict(moe_pre_weighting=True), "Llama-4"),
    "router_scale": ("param", "router_scale", "Pangu-MoE"),
    "small_experts": ("param", "small_experts", "GroveMoE"),
}


# shared expert of _moe_combine: None (Qwen3-MoE), plain (DeepSeek), gated
# by a sigmoid of x @ shared_gate (Qwen2-MoE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", ["none", "plain", "gated"])
def test_moe_combine_matches_the_jax_package(shared, dtype):
    rng = np.random.default_rng(21)
    jcfg, tcfg = _configs(moe_num_experts=E, moe_top_k=3)
    jp, tp = _moe_params(rng)
    if shared == "none":
        del jp["shared"], tp["shared"]
    elif shared == "gated":
        jp["shared_gate"], tp["shared_gate"] = _dense(rng, H, 1, 0.5)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    for k in ("gate", "up", "down"):
        jp["experts"][k] = jp["experts"][k].astype(jdt)
        tp["experts"][k] = tp["experts"][k].to(tdt)
    x = rng.standard_normal((2, 5, H)).astype(np.float32)
    topi = np.stack([rng.permutation(E)[:3] for _ in range(10)])
    topv = rng.random((10, 3)).astype(np.float32)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    want = np.asarray(jt._moe_combine(jcfg, jp, jx.reshape(10, H), jnp.asarray(topi),
                                      jnp.asarray(topv), jx).astype(jnp.float32))
    got = tt._moe_combine(tcfg, tp, tx.reshape(10, H), torch.from_numpy(topi),
                          torch.from_numpy(topv), tx)
    assert got.dtype == tdt
    assert _rel(got.float().numpy(), want) <= (TOL if dtype == "float32" else 2.0 ** -7)
    if shared == "gated":      # the gate moves the output
        del tp["shared_gate"]
        other = tt._moe_combine(tcfg, tp, tx.reshape(10, H), torch.from_numpy(topi),
                                torch.from_numpy(topv), tx)
        assert _rel(other.float().numpy(), want) > 1e-2


@pytest.mark.parametrize("mode", list(OTHER_MODES))
def test_moe_modes_of_other_families_raise(mode):
    kind, what, family = OTHER_MODES[mode]
    rng = np.random.default_rng(1)
    _, tcfg = _configs(moe_num_experts=E, moe_top_k=2)
    _, tp = _moe_params(rng)
    if kind == "cfg":
        tcfg = dataclasses.replace(tcfg, **what)
    else:
        tp[what] = torch.zeros(E)
    with pytest.raises(NotImplementedError, match=family):
        tt.moe_mlp(tcfg, tp, torch.zeros(1, 2, H))


def test_router_x_raises():
    _, tcfg = _configs(moe_num_experts=E, moe_top_k=2)
    with pytest.raises(NotImplementedError, match="Megrez2"):
        tt.mlp_dispatch(tcfg, tt.LayerSpec(is_moe=True), {}, torch.zeros(1, 1, H),
                        router_x=torch.zeros(1, 1, H))


# ------------------------------------------------------------------- MLA
MLA = jt.MLAConfig(q_lora_rank=0, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                   v_head_dim=16)
HEADS = 4


def _mla_params(rng, m, q_lora: bool):
    jp, tp = {}, {}
    dk = m.qk_nope_head_dim + m.qk_rope_head_dim
    shapes = {"d_kv": (H, m.kv_lora_rank), "k_pe": (H, m.qk_rope_head_dim),
              "u_k_nope": (m.kv_lora_rank, HEADS * m.qk_nope_head_dim),
              "u_v": (m.kv_lora_rank, HEADS * m.v_head_dim), "o": (HEADS * m.v_head_dim, H)}
    if q_lora:
        shapes.update(d_q=(H, 24), u_q=(24, HEADS * dk))
    else:
        shapes["q"] = (H, HEADS * dk)
    for n, (i, o) in shapes.items():
        jp[n], tp[n] = _dense(rng, i, o)
    norms = {"kv_norm": m.kv_lora_rank, **({"q_norm": 24} if q_lora else {})}
    for n, size in norms.items():
        w = (1.0 + 0.1 * rng.standard_normal(size)).astype(np.float32)
        jp[n], tp[n] = {"w": jnp.asarray(w)}, {"w": torch.from_numpy(w)}
    return jp, tp


def _absorb(jp, tp, m):
    wk = np.asarray(jp["u_k_nope"].w).reshape(m.kv_lora_rank, HEADS, m.qk_nope_head_dim)
    wv = np.asarray(jp["u_v"].w).reshape(m.kv_lora_rank, HEADS, m.v_head_dim)
    jp.update(wk_abs=jnp.asarray(wk), wv_abs=jnp.asarray(wv))
    tp.update(wk_abs=torch.from_numpy(wk.copy()), wv_abs=torch.from_numpy(wv.copy()))


def _rope_tables(rope, positions):
    pj = jnp.asarray(positions)
    jc, js = jr.precompute_rope_cache(pj, rope)
    tc, ts = tr.precompute_rope_cache(torch.from_numpy(positions), _port_rope(rope))
    return (jc, js), (tc, ts)


def _port_rope(rope):
    return tr.RopeConfig(**{f.name: getattr(rope, f.name) for f in dataclasses.fields(tr.RopeConfig)})


@pytest.mark.parametrize("q_lora", [False, True], ids=["q", "q_lora"])
@pytest.mark.parametrize("compressed,cache", [(False, "float32"), (False, "int8"),
                                              (True, "float32")],
                         ids=["expanded-float32", "expanded-int8", "latent-float32"])
def test_mla_blocks_prefill_then_decode(compressed, q_lora, cache):
    """A 9-token prefill at n_past 0, then a decode step at n_past 9 (an
    int on the JAX side; an int and a 0-d tensor on the port's), through
    both packages' blocks on the same cache contents.  (The latent cache
    takes no q8 cache: test_mla_latent_block_refuses_what_the_jax_package_refuses.)"""
    rng = np.random.default_rng(7 + q_lora + 2 * compressed)
    m = dataclasses.replace(MLA, q_lora_rank=24 if q_lora else 0)
    rope = jr.RopeConfig(head_dim=8, rot_dim=8, layout=jr.ROPE_NORMAL)
    jcfg, tcfg = _configs(num_attention_heads=HEADS, num_key_value_heads=HEADS, rope=rope,
                          mla=m, mla_compressed=compressed, cache_dtype=cache,
                          attention_scale=0.3)
    tcfg = dataclasses.replace(tcfg, rope=_port_rope(rope))
    jp, tp = _mla_params(rng, m, q_lora)
    if compressed:
        _absorb(jp, tp, m)
    jc, tc = jt.init_cache(jcfg, 1, 32), tt.init_cache(tcfg, 1, 32)
    spec = tt.LayerSpec()
    steps = [(0, 9), (9, 1)]
    for n_past, T in steps:
        x = rng.standard_normal((1, T, H)).astype(np.float32)
        pos = (n_past + np.arange(T))[None, :]
        (jcos, jsin), (tcos, tsin) = _rope_tables(rope, pos)
        js = (jc.k_scale[0], jc.v_scale[0]) if cache == "int8" else (None, None)
        ts = (tc.k_scale[0], tc.v_scale[0]) if cache == "int8" else (None, None)
        want, jk, jv, jks, jvs = jt.mla_attention_block(
            jcfg, jt.LayerSpec(), jp, jnp.asarray(x), jcos, jsin, jc.k[0], jc.v[0], n_past, *js)
        jc = jt.KVCache(k=(jk,), v=(jv,), k_scale=(jks,) if jks is not None else None,
                        v_scale=(jvs,) if jvs is not None else None)
        outs = []
        for np_ in (n_past, torch.tensor(n_past)):
            c = tt.KVCache(k=[t.clone() for t in tc.k], v=[t.clone() for t in tc.v],
                           k_scale=[t.clone() for t in tc.k_scale] if tc.k_scale else None,
                           v_scale=[t.clone() for t in tc.v_scale] if tc.v_scale else None)
            cs = (c.k_scale[0], c.v_scale[0]) if cache == "int8" else (None, None)
            outs.append((tt.mla_attention_block(tcfg, spec, tp, torch.from_numpy(x), tcos, tsin,
                                                c.k[0], c.v[0], np_, *cs), c))
        (got, tc), (got_dev, c_dev) = outs
        assert _rel(got.numpy(), want) <= TOL, (n_past, T)
        assert _rel(got_dev.numpy(), got.numpy()) <= 1e-6
        for name in ("k", "v") + (("k_scale", "v_scale") if cache == "int8" else ()):
            a = getattr(tc, name)[0].float().numpy()
            b = np.asarray(getattr(jc, name)[0], np.float32)
            if name in ("k", "v") and cache == "int8":
                assert np.abs(a - b).max() <= 1, name       # one rounding step of int8
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)
            assert torch.equal(getattr(c_dev, name)[0], getattr(tc, name)[0]), name


def test_mla_expanded_decode_with_per_row_n_past():
    """The continuous-batching step: 3 rows at their own n_past over one
    expanded q8 cache, against the JAX package's block (which takes the
    same vector)."""
    rng = np.random.default_rng(21)
    rope = jr.RopeConfig(head_dim=8, rot_dim=8, layout=jr.ROPE_NORMAL)
    jcfg, tcfg = _configs(num_attention_heads=HEADS, num_key_value_heads=HEADS, rope=rope,
                          mla=MLA, cache_dtype="int8")
    tcfg = dataclasses.replace(tcfg, rope=_port_rope(rope))
    jp, tp = _mla_params(rng, MLA, False)
    B, S = 3, 64
    jc, tc = jt.init_cache(jcfg, B, S), tt.init_cache(tcfg, B, S)
    for i, name in enumerate(("k", "v")):       # the same earlier keys on both sides
        q8 = rng.integers(-127, 128, size=tuple(tc.__dict__[name][0].shape)).astype(np.int8)
        sc = (rng.random(tuple(tc.k_scale[0].shape)) * 0.02).astype(np.float32)
        tc.__dict__[name][0].copy_(torch.from_numpy(q8))
        tc.__dict__[name + "_scale"][0].copy_(torch.from_numpy(sc))
        jc = dataclasses.replace(jc, **{name: (jnp.asarray(q8),),
                                        name + "_scale": (jnp.asarray(sc),)})
    n_past = np.array([3, 40, 63])
    x = rng.standard_normal((B, 1, H)).astype(np.float32)
    (jcos, jsin), (tcos, tsin) = _rope_tables(rope, n_past[:, None])
    want = jt.mla_attention_block(jcfg, jt.LayerSpec(), jp, jnp.asarray(x), jcos, jsin,
                                  jc.k[0], jc.v[0], jnp.asarray(n_past), jc.k_scale[0],
                                  jc.v_scale[0])[0]
    got = tt.mla_attention_block(tcfg, tt.LayerSpec(), tp, torch.from_numpy(x), tcos, tsin,
                                 tc.k[0], tc.v[0], torch.from_numpy(n_past), tc.k_scale[0],
                                 tc.v_scale[0])
    assert _rel(got.numpy(), want) <= TOL


def test_mla_latent_block_refuses_what_the_jax_package_refuses():
    rope = tr.RopeConfig(head_dim=8, rot_dim=8, layout=tr.ROPE_NORMAL)
    _, tcfg = _configs(num_attention_heads=HEADS, num_key_value_heads=HEADS, mla=MLA,
                       mla_compressed=True)
    tcfg = dataclasses.replace(tcfg, rope=rope)
    _, tp = _mla_params(np.random.default_rng(0), MLA, False)
    c = tt.init_cache(tcfg, 2, 16)
    cos, sin = tr.precompute_rope_cache(torch.zeros(2, 1, dtype=torch.int64), rope)
    x = torch.zeros(2, 1, H)
    with pytest.raises(ValueError, match="per-slot n_past"):
        tt.mla_attention_block(tcfg, tt.LayerSpec(), tp, x, cos, sin, c.k[0], c.v[0],
                               torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="q8 cache"):
        tt.mla_attention_block(tcfg, tt.LayerSpec(), tp, x, cos, sin, c.k[0], c.v[0], 0,
                               torch.zeros(2, 16, 1), torch.zeros(2, 16, 1))


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_init_cache_mla_shapes_match(compressed, cache):
    cfg = deepseek_v2_lite_config(256, mla_cache="memory" if compressed else "speed")
    cfg = dataclasses.replace(cfg, cache_dtype=cache, num_hidden_layers=2)
    jcfg = jt.TransformerConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, num_hidden_layers=2,
        num_attention_heads=16, num_key_value_heads=16, intermediate_size=64, max_length=256,
        mla=jt.MLAConfig(**dataclasses.asdict(cfg.mla)), mla_compressed=compressed,
        cache_dtype=cache)
    jc, tc = jt.init_cache(jcfg, 2, 256), tt.init_cache(cfg, 2, 256)
    for name in ("k", "v", "k_scale", "v_scale"):
        js, ts = getattr(jc, name), getattr(tc, name)
        assert (js is None) == (ts is None), name
        for a, b in zip(js or (), ts or ()):
            assert tuple(a.shape) == tuple(b.shape) and str(a.dtype) == str(b.dtype).split(".")[1]
    n_kv, dk, dv = tt.cache_dims(cfg)
    assert (n_kv, dk, dv) == ((1, 576, 1) if compressed else (16, 192, 128))


def test_yarn_table_matches_the_jax_package():
    """DeepSeek-V2-Lite's rope (YaRN factor 40 over an original context of
    4096, mscale 0.707 in both places) at positions across 0..16383."""
    from chatllm_tpu.models.deepseek import yarn_get_mscale
    from chatllm_tpu_torch.models import deepseek as td

    cfg = deepseek_v2_lite_config()
    m, ma = yarn_get_mscale(40.0, 0.707), yarn_get_mscale(40.0, 0.707)
    jrope = jr.RopeConfig(head_dim=64, rot_dim=64, freq_base=10000.0, freq_scale=1 / 40,
                          layout=jr.ROPE_NORMAL, ext_factor=1.0, attn_factor=m / ma,
                          beta_fast=32.0, beta_slow=1.0, orig_ctx=4096)
    assert cfg.attention_scale == pytest.approx(ma * ma / 192 ** 0.5, rel=1e-12)
    assert td.yarn_get_mscale(40.0, 0.707) == m
    pos = np.array([[0, 1, 17, 1000, 4095, 4096, 8191, 16383]])
    jc, js = jr.precompute_rope_cache(jnp.asarray(pos), jrope)
    tc, ts = tr.precompute_rope_cache(torch.from_numpy(pos), cfg.rope)
    # 16 f32 ulps of the table's scale (1 + 0.1 ln 40 = 1.37): at position
    # 16383 the angles reach ~1.6e4 rad, which the two libraries' cos / sin
    # reduce differently in the last bits
    tol = 16 * np.finfo(np.float32).eps * float(np.abs(np.asarray(jc)).max())
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=tol, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=tol, rtol=0)


# ------------------------------------------------------ K4 at (192, 128)
@pytest.mark.parametrize("cache", ["int8", "bfloat16"])
@pytest.mark.parametrize("B,T,n_past", [(1, 1, [700]), (3, 1, [0, 300, 1023]), (1, 4, [500])])
def test_flash_decode_plain_at_mla_dims_matches_the_pallas_kernel(cache, B, T, n_past):
    """K4's plain twin (what the wrapper runs on the CPU) at Dk 192 / Dv 128
    with 16 kv heads against the JAX flash_decode, which takes its per-head
    kernel there (f32 dots) in interpret mode."""
    from chatllm_tpu.ops.attention import quantize_kv as jquant
    from chatllm_tpu.ops.pallas.flash_decode import flash_decode as jfd
    from chatllm_tpu_torch.ops.cuda.flash_decode import (default_qk_dtype, flash_decode,
                                                         flash_decode_plain)

    rng = np.random.default_rng(B * 10 + T)
    S, Hh, Dk, Dv = 1024, 16, 192, 128
    q = rng.standard_normal((B, T, Hh, Dk)).astype(np.float32)
    k = rng.standard_normal((B, S, Hh, Dk)).astype(np.float32)
    v = rng.standard_normal((B, S, Hh, Dv)).astype(np.float32)
    jk, jv, kw_j, kw_t = jnp.asarray(k), jnp.asarray(v), {}, {}
    if cache == "int8":
        (jk, ks), (jv, vs) = jquant(jk), jquant(jv)
        kw_j = dict(k_scale=ks, v_scale=vs)
        kw_t = dict(k_scale=torch.from_numpy(np.asarray(ks)),
                    v_scale=torch.from_numpy(np.asarray(vs)))
        tk, tv = torch.from_numpy(np.asarray(jk)), torch.from_numpy(np.asarray(jv))
    else:
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(v).to(torch.bfloat16)
    assert default_qk_dtype(Dk, Dv, Hh, cache == "int8") == "float32"
    npv = np.array(n_past)
    want = np.asarray(jfd(jnp.asarray(q), jk, jv, jnp.asarray(npv), T, scale=Dk ** -0.5,
                          interpret=True, **kw_j))
    got = flash_decode_plain(torch.from_numpy(q), tk, tv, torch.from_numpy(npv), T,
                             scale=Dk ** -0.5, **kw_t)
    assert tuple(got.shape) == (B, T, Hh, Dv)
    assert _rel(got.numpy(), want) <= TOL
    via_wrapper = flash_decode(torch.from_numpy(q), tk, tv, torch.from_numpy(npv), T,
                               scale=Dk ** -0.5, **kw_t)
    assert torch.equal(via_wrapper, got)
