"""E7: the port's experiments/bhsd_decode.py against the JAX probe file as
it stands (its Pallas kernel and the JAX package's K2 in interpret mode).

Tolerances, relative to the output scale: `pallas_decode_bhsd` (K4's plain
version, f32 dots, on the head-major cache) 1e-5, f32 sums in another
order; `einsum_decode` 1e-5 (the same bf16 roundings, f32 sums in another
order); a 2-layer narrow `forward` on the same seeded q4_k weights 1e-3 of
the logit scale with the same greedy tokens (K2's bf16 roundings are the
same on both sides, but an f32-level difference can flip one and the flips
compound over layers, which the model tests bound by 2e-2; measured 3.1e-7),
and its caches: a q8 value may move by one step where a rounding flips, so
they are held to one step, the rest to 1e-5 (measured: the q8 values equal,
the scales within 2.4e-7)."""
import ast
import functools
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax.numpy as jnp

import chatllm_tpu.ops.qmm as jqmm
from chatllm_tpu.models.synthetic import tiny_config as jtiny_config
from chatllm_tpu.ops.attention import quantize_kv as jquantize
from chatllm_tpu.ops.qtensor import QuantLinear as JQuantLinear
from chatllm_tpu_torch.experiments import bhsd_decode as te7
from chatllm_tpu_torch.models.synthetic import tiny_config
from chatllm_tpu_torch.ops.attention import quantize_kv
from chatllm_tpu_torch.ops.qtensor import QuantLinear

ROOT = Path(__file__).resolve().parents[1]
PATH = ROOT / "experiments" / "bhsd_decode.py"
TOL = 1e-5


class _CpuJnp(types.ModuleType):
    """jax.numpy for the probe file on the CPU, where XLA has no bf16 x bf16
    -> f32 dot: einsum takes bf16 operands as f32, which is exact (a bf16
    product is exact in f32; the sums stay f32)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(sub, *ops, preferred_element_type=None, **kw):
        ops = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o for o in ops]
        return jnp.einsum(sub, *ops, preferred_element_type=preferred_element_type, **kw)


@pytest.fixture(scope="module")
def e7():
    """experiments/bhsd_decode.py executed as a module with sys.argv set to
    the file's name and its own sys.path.insert dropped; its pallas_call in
    interpret mode, its einsums through _CpuJnp, and the JAX package's
    matmul through its Pallas K2 in interpret mode (the port's matmul takes
    K2 at these rows)."""
    from jax.experimental import pallas as pl

    tree = ast.parse(PATH.read_text(), str(PATH))
    tree.body = [n for n in tree.body
                 if not (isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
                         and ast.unparse(n.value.func) == "sys.path.insert")]
    mod = types.ModuleType("_jax_bhsd_decode")
    mod.__file__ = str(PATH)
    saved = list(sys.argv)
    try:
        sys.argv = [str(PATH)]
        exec(compile(tree, str(PATH), "exec"), mod.__dict__)
    finally:
        sys.argv[:] = saved
    mod.jnp = _CpuJnp("jnp")
    with pytest.MonkeyPatch.context() as mp:
        call = pl.pallas_call
        mp.setattr(pl, "pallas_call", lambda *a, **kw: call(*a, **{**kw, "interpret": True}))
        mp.setattr(jqmm, "use_pallas_qmm", lambda: True)
        mp.setattr(jqmm, "_pallas_local", functools.partial(jqmm._pallas_local, interpret=True))
        yield mod


def _cache(rng, B, Hkv, S, D, q8):
    """Head-major caches [B, Hkv, S, D] (and [B, Hkv, S] scales) for both."""
    k, v = (rng.standard_normal((B, Hkv, S, D)).astype(np.float32) for _ in range(2))
    if q8:
        (jk, jks), (jv, jvs) = jquantize(jnp.asarray(k)), jquantize(jnp.asarray(v))
        j = (jk, jv, dict(k_scale=jks, v_scale=jvs))
        t = (*(torch.from_numpy(np.array(a)) for a in (jk, jv)),
             dict(k_scale=torch.from_numpy(np.array(jks)), v_scale=torch.from_numpy(np.array(jvs))))
        return j, t
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
    j = tuple(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (tk, tv))
    return (*j, {}), (tk, tv, {})


def _rel(out, ref):
    return np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32)).max() / \
        np.abs(np.asarray(ref, np.float32)).max()


@pytest.mark.parametrize("q8", [True, False], ids=["q8", "bf16"])
def test_pallas_decode_bhsd_matches_jax(e7, q8):
    """Two new tokens at n_past 511, across the first 512-key block's edge."""
    rng = np.random.default_rng(3 + q8)
    B, T, Hq, Hkv, S, D = 2, 2, 8, 2, 1024, 128
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    (jk, jv, jkw), (tk, tv, tkw) = _cache(rng, B, Hkv, S, D, q8)
    ref = e7.pallas_decode_bhsd(jnp.asarray(q), jk, jv, 511, scale=D ** -0.5, **jkw)
    out = te7.pallas_decode_bhsd(torch.from_numpy(q), tk, tv, 511, scale=D ** -0.5, **tkw)
    assert out.shape == (B, T, Hq, D) and out.dtype == torch.float32
    assert _rel(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("q8", [True, False], ids=["q8", "bf16"])
def test_einsum_decode_matches_jax(e7, layout, q8):
    rng = np.random.default_rng(7 + q8)
    B, T, Hq, Hkv, S, D = 2, 1, 8, 2, 512, 64
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    (jk, jv, jkw), (tk, tv, tkw) = _cache(rng, B, Hkv, S, D, q8)
    if layout == "bshd":
        jk, jv = (jnp.transpose(a, (0, 2, 1, 3)) for a in (jk, jv))
        tk, tv = (a.permute(0, 2, 1, 3).contiguous() for a in (tk, tv))
        jkw = {k: jnp.transpose(a, (0, 2, 1)) for k, a in jkw.items()}
        tkw = {k: a.permute(0, 2, 1).contiguous() for k, a in tkw.items()}
    ref = e7.einsum_decode(jnp.asarray(q), jk, jv, 300, scale=D ** -0.5, layout=layout, **jkw)
    out = te7.einsum_decode(torch.from_numpy(q), tk, tv, 300, scale=D ** -0.5, layout=layout,
                            **tkw)
    assert _rel(out.numpy(), ref) <= TOL


def _params(cfg, seed):
    """The same seeded narrow q4_k weights as numpy, in both packages'
    parameter trees (QuantLinear per projection, bf16 embedding)."""
    rng = np.random.default_rng(seed)
    H, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    d = cfg.rope.head_dim

    def lin(k, n):
        a = dict(q=rng.integers(0, 256, (k // 2, n), dtype=np.uint8),
                 s=rng.integers(0, 64, (k // 32, n), dtype=np.int8),
                 b=rng.integers(0, 64, (k // 32, n), dtype=np.int8),
                 d=(rng.random((k // 256, n)) * 0.02 / np.sqrt(k) * 16).astype(np.float16),
                 dm=(rng.random((k // 256, n)) * 0.01 / np.sqrt(k) * 16).astype(np.float16))
        return (JQuantLinear(**{k_: jnp.asarray(v) for k_, v in a.items()}, packed=True, sb=8),
                QuantLinear(**{k_: torch.from_numpy(v) for k_, v in a.items()}, packed=True,
                            sb=8))

    def norm():
        w = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
        return {"w": jnp.asarray(w)}, {"w": torch.from_numpy(w)}

    emb = torch.from_numpy(rng.standard_normal((V, H)).astype(np.float32)).to(torch.bfloat16)
    jp = {"embed": jnp.asarray(emb.float().numpy()).astype(jnp.bfloat16), "layers": []}
    tp = {"embed": emb, "layers": []}
    shapes = {"q": (H, cfg.num_attention_heads * d), "k": (H, cfg.num_key_value_heads * d),
              "v": (H, cfg.num_key_value_heads * d), "o": (cfg.num_attention_heads * d, H)}
    for _ in range(cfg.num_hidden_layers):
        att = {n: lin(*s) for n, s in shapes.items()}
        mlp = {n: lin(*s) for n, s in (("gate", (H, F)), ("up", (H, F)), ("down", (F, H)))}
        an, fn = norm(), norm()
        jp["layers"].append({"attn_norm": an[0], "ffn_norm": fn[0],
                             "attn": {n: p[0] for n, p in att.items()},
                             "mlp": {n: p[0] for n, p in mlp.items()}})
        tp["layers"].append({"attn_norm": an[1], "ffn_norm": fn[1],
                             "attn": {n: p[1] for n, p in att.items()},
                             "mlp": {n: p[1] for n, p in mlp.items()}})
    fnorm = norm()
    jp["final_norm"], tp["final_norm"] = fnorm
    jp["lm_head"], tp["lm_head"] = lin(H, V)
    return jp, tp


@pytest.mark.parametrize("cache_q8,variant", te7.COMBOS,
                         ids=[f"{v}-{'q8' if q else 'bf16'}" for q, v in te7.COMBOS])
def test_forward_matches_jax(e7, cache_q8, variant):
    """Three greedy decode steps of a 2-layer narrow Llama (hidden 256, 4
    heads over 2 kv heads, head dim 64) at B = 2 over a 512-slot cache."""
    kw = dict(vocab=512, hidden=256, layers=2, heads=4, kv_heads=2, inter=512, max_length=512)
    cfg, jcfg = tiny_config(**kw), jtiny_config(**kw)
    assert (cfg.rope.head_dim, cfg.rope.freq_base, cfg.rope.layout) == \
        (jcfg.rope.head_dim, jcfg.rope.freq_base, jcfg.rope.layout)
    jp, tp = _params(cfg, seed=11)
    layout = te7.layout_of(variant)
    jc = e7.init_caches(jcfg, 2, 512, layout=layout, q8=cache_q8)
    tc = te7.init_caches(cfg, 2, 512, layout=layout, q8=cache_q8)
    jtok = jnp.asarray([[3], [400]], jnp.int32)
    ttok = torch.tensor([[3], [400]])
    for step in range(3):
        jl, jc = e7.forward(jcfg, jp, jtok, jc, step, variant=variant, cache_q8=cache_q8)
        tl = te7.forward(cfg, tp, ttok, tc, step, variant=variant, cache_q8=cache_q8)
        jl = np.asarray(jl, np.float32)
        assert tl.shape == jl.shape == (2, 1, 512)
        assert _rel(tl.float().numpy(), jl) <= 1e-3
        jtok = jnp.argmax(jnp.asarray(jl)[:, -1], axis=-1).astype(jnp.int32)[:, None]
        ttok = tl[:, -1].argmax(dim=-1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    if variant != "no_attn":
        for j, t in zip(jc[0], tc[0]):
            j, t = np.asarray(j.astype(jnp.float32)), t.float().numpy()
            step = 1.0 if t.dtype == np.float32 and cache_q8 and j.ndim == 4 else 0.0
            assert np.abs(t - j).max() <= max(step, 1e-5 * np.abs(j).max())


def test_rope_table_equals_per_step_rope():
    """main's precomputed table gives the positions precompute_rope_cache
    gives one step at a time (the original's way), bit for bit."""
    cfg = tiny_config(hidden=256, heads=4)
    cos, sin = te7.precompute_rope_cache(torch.arange(64), cfg.rope)
    c1, s1 = te7.precompute_rope_cache(37 + torch.arange(1), cfg.rope)
    assert torch.equal(cos[37:38], c1) and torch.equal(sin[37:38], s1)


def test_main_runs_every_combination_on_the_cpu(capsys):
    cfg = tiny_config(vocab=256, hidden=256, layers=2, heads=4, kv_heads=2, inter=512,
                      max_length=512)
    res = te7.main([], device="cpu", b=2, ctx=512, steps=2, cfg=cfg)
    assert len(res) == len(te7.COMBOS) == 8
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 8
    for (q8, variant), ln in zip(te7.COMBOS, lines):
        import json

        rec = json.loads(ln)
        assert rec["variant"] == variant and rec["cache"] == ("q8_0" if q8 else "bfloat16")
        assert rec["B"] == 2 and rec["ctx"] == 512 and rec["tok_s"] > 0
        assert "graph_tok_s" not in rec                 # a CUDA graph needs the card


def test_main_reads_b_ctx_and_steps_from_argv(monkeypatch):
    seen = {}
    monkeypatch.setattr(te7, "build_synthetic_params", lambda cfg, *a, **kw: None)
    monkeypatch.setattr(te7, "run_variant",
                        lambda cfg, p, v, q8, *, b, ctx, steps, **kw:
                        seen.update(b=b, ctx=ctx, steps=steps, L=cfg.max_length)
                        or {"eager_s": 1.0, "tokens": []})
    te7.main(["4", "2048", "5"], device="cpu")
    assert seen == {"b": 4, "ctx": 2048, "steps": 5, "L": 2048}
