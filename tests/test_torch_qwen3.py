"""The port's Qwen3 (models/qwen.py::Qwen3, the per-head RMS qk-norm in
nn/transformer.py::attention_block) against the JAX package on tiny QWEN3
GGMMs written with the JAX package's writer (`chip_smoke.write_internvl_ggmm`
with `tower=False`: byte-level vocab plus ChatML's tokens, hidden 256, 4
heads of 64 over 2 kv heads, 2 layers):

  - the parsed config (qk-norm, NEOX rope, head_dim, the tie flag, YaRN)
    equals the JAX package's, and the weights load bit-exact;
  - prefill logits within 1e-4 of the logit scale with f32 weights and
    activations, within 2e-2 with q4_k weights and bf16 activations (the
    bound of the other q4_k model tests: bf16 rounding flips compound over
    the layers), over bf16, f32 and q8 caches, a tied head too; the greedy
    tokens of each are identical;
  - the other qk-norm modes raise, naming their families (Qwen3-MoE and
    the DeepSeek-R1 distill load: tests/test_torch_qwen3_moe.py,
    tests/test_torch_families.py)."""
import dataclasses

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import torch_one_thread  # noqa: F401  (one intra-op thread: see its docstring)

import chip_smoke
import chatllm_tpu.models as jm
from chatllm_tpu.ggmm.quants import GGMLType
from chatllm_tpu.ggmm.writer import GGMMWriter
from chatllm_tpu.runtime.generate import GenerationConfig as JGen
import chatllm_tpu_torch.models as tm
from chatllm_tpu_torch.nn.transformer import (LayerSpec, attention_block, init_cache,
                                              transformer_forward)
from chatllm_tpu_torch.runtime.generate import GenerationConfig as TGen

PROMPT = np.random.default_rng(4).integers(0, 380, 40).tolist()
NEW = 8
# name -> (writer kwargs, compute dtype, cache dtype, logits bound)
CASES = {
    "f32-f32": (dict(dtype=GGMLType.F32), "float32", "float32", 1e-4),
    "f32-bf16": (dict(dtype=GGMLType.F32), "float32", "bfloat16", 1e-4),
    "f32-q8": (dict(dtype=GGMLType.F32), "float32", "int8", 1e-4),
    "f32-tied": (dict(dtype=GGMLType.F32, tie=True), "float32", "float32", 1e-4),
    "q4k-bf16": ({}, "bfloat16", "bfloat16", 2e-2),
    "q4k-f32": ({}, "bfloat16", "float32", 2e-2),
    "q4k-q8": ({}, "bfloat16", "int8", 2e-2),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("qwen3")
    out = {}
    for name, kw in (("f32", dict(dtype=GGMLType.F32)), ("f32-tied", dict(dtype=GGMLType.F32,
                                                                           tie=True)),
                     ("q4k", {}), ("yarn", dict(dtype=GGMLType.F32, yarn=(4.0, 128)))):
        out[name] = str(chip_smoke.write_internvl_ggmm(d / f"{name}.bin", tower=False, seed=3,
                                                       writer_cls=GGMMWriter, max_len=512,
                                                       **kw))
    return out


def _file(case: str) -> str:
    return "f32-tied" if case == "f32-tied" else case.split("-")[0]


_PAIRS: dict = {}


def pair(files, case):
    """The same file in both packages, loaded once per case."""
    if case not in _PAIRS:
        _, compute, cache, _ = CASES[case]
        rt = dict(compute_dtype=compute, cache_dtype=cache)
        path = files[_file(case)]
        _PAIRS[case] = (jm.load_model(path, jm.RuntimeConfig(**rt)),
                        tm.load_model(path, tm.RuntimeConfig(**rt), device="cpu"))
    return _PAIRS[case]


@pytest.mark.parametrize("name", ["f32", "f32-tied", "q4k", "yarn"])
def test_config_matches_jax(files, name):
    j = jm.load_model(files[name], jm.RuntimeConfig())
    t = tm.load_model(files[name], tm.RuntimeConfig(), device="cpu")
    jc, tc = j.cfg, t.cfg
    for f in ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "head_dim", "intermediate_size", "max_length",
              "norm_eps", "qk_norm", "tie_lm_head", "qkv_bias", "cache_dtype"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.qk_norm == "rmsnorm" and tc.rope.layout == "neox"
    for f in ("head_dim", "freq_base", "freq_scale", "ext_factor", "orig_ctx", "attn_factor",
              "beta_fast", "beta_slow", "layout"):
        assert getattr(tc.rope, f) == getattr(jc.rope, f), f
    if name == "yarn":
        assert (tc.rope.freq_scale, tc.rope.ext_factor, tc.rope.orig_ctx) == (0.25, 1.0, 128)
    assert ("lm_head" in t.params) == (name != "f32-tied")
    assert t.tokenizer.encode("<|im_start|>user\nhi") == j.tokenizer.encode("<|im_start|>user\nhi")


def test_weights_bit_exact(files):
    j, t = pair(files, "q4k-bf16")
    for i in range(2):
        ja, ta = j.params["layers"][i]["attn"], t.params["layers"][i]["attn"]
        for name in ("q_norm", "k_norm"):
            assert np.array_equal(np.asarray(ja[name]["w"]), ta[name]["w"].numpy())
        for f in ("q", "s", "b", "d", "dm"):
            jv, tv = getattr(ja["q"], f), getattr(ta["q"], f)
            assert np.array_equal(np.asarray(jv).astype(np.float32), tv.float().numpy()), f


_JAX_OUT: dict = {}


def _run(model, gen_cls, cache_len=512):
    """(prefill logits of PROMPT as f32 numpy, greedy tokens)."""
    eng = model.engine
    logits = eng.prefill(PROMPT, eng.new_cache(1, cache_len), 0)[0]
    logits = np.asarray(logits.float() if isinstance(logits, torch.Tensor) else logits,
                        np.float32)
    out = eng.generate(PROMPT, gen_cls(do_sample=False, max_new_tokens=NEW))[0]
    return logits, list(out)


@pytest.mark.parametrize("case", list(CASES))
def test_logits_and_greedy_tokens_match_jax(files, case):
    j, t = pair(files, case)
    if case not in _JAX_OUT:
        _JAX_OUT[case] = _run(j, JGen)
    jl, jt = _JAX_OUT[case]
    with torch.inference_mode():
        tl, tt = _run(t, TGen)
    tol = CASES[case][3]
    assert np.isfinite(tl).all() and tl.shape == jl.shape
    assert np.abs(tl - jl).max() <= tol * np.abs(jl).max()
    assert tt == jt and len(tt) == NEW


@pytest.mark.parametrize("mode,family", [("rmsnorm_full", "OLMo2"), ("layernorm", "Persimmon"),
                                         ("rmsnorm_halves", "NeoChat"),
                                         ("rmsnorm_post", "Hunyuan"),
                                         ("l2norm_post", "Llama-4")])
def test_other_qk_norm_modes_raise(files, mode, family):
    _, t = pair(files, "f32-f32")
    cfg = dataclasses.replace(t.cfg, qk_norm=mode)
    layer = t.params["layers"][0]
    x = torch.zeros(1, 2, cfg.hidden_size)
    cache = t.engine.new_cache(1, 16)
    with pytest.raises(NotImplementedError, match=family):
        attention_block(cfg, LayerSpec(), layer["attn"], x, None, None, cache.k[0],
                        cache.v[0], 0)


def test_qk_norm_moves_the_logits(files):
    """The norm is applied: unit q/k norm weights give other logits."""
    _, t = pair(files, "f32-f32")
    ids = torch.tensor([PROMPT[:8]])
    base = t.forward_logits(PROMPT[:8])[0]
    params = dict(t.params, layers=tuple(
        dict(l, attn=dict(l["attn"], q_norm={"w": torch.ones_like(l["attn"]["q_norm"]["w"])}))
        for l in t.params["layers"]))
    other = transformer_forward(t.cfg, params, ids, init_cache(t.cfg, 1, 8), 0)[0]
    assert not torch.allclose(base, other)
