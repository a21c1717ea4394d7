"""The port's Qwen3-MoE (models/qwen.py::Qwen3 with `layer_is_sparse`, the
softmax top-k MoE FFN without a shared expert) against the JAX package on
narrow QWEN3 GGMMs with mixed sparse and dense layers, written with the JAX
package's writer (`chip_smoke.write_internvl_ggmm(tower=False, experts=8,
sparse=(True, False, True))`: hidden 256, 4 heads of 64 over 2 kv heads, 3
layers, 8 experts of width 128, top-2, norm_topk_prob):

  - the parsed config (the sparse layers, experts, top-k, norm_topk_prob)
    equals the JAX package's, and every weight loads bit-exact, the expert
    stacks (f32 and bf16, from f32 and q4_k files) included;
  - prefill logits within 1e-4 of the logit scale with f32 weights and
    activations, within 2e-2 with q4_k weights and bf16 activations (the
    bound of the other q4_k model tests), over f32, bf16 and q8 caches; the
    greedy tokens of each are identical;
  - a BatchedEngine of 3 slots over a q8 cache answers 3 prompts with the
    JAX BatchedEngine's greedy tokens;
  - Qwen3-30B-A3B's published config (`qwen3_30b_a3b_config`) builds
    synthetic params with no shared expert, and at 2 layers its MoE FFN
    runs on the CPU."""
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
from chatllm_tpu.ops.sampling import SamplerConfig as JSampler
from chatllm_tpu.runtime.batching import BatchedEngine as JBatched
from chatllm_tpu.runtime.generate import GenerationConfig as JGen
import chatllm_tpu_torch.models as tm
from chatllm_tpu_torch.ops.sampling import SamplerConfig
from chatllm_tpu_torch.runtime.batching import BatchedEngine
from chatllm_tpu_torch.runtime.generate import GenerationConfig as TGen

SPARSE = (True, False, True)
PROMPT = np.random.default_rng(6).integers(0, 380, 40).tolist()
NEW = 8
# name -> (file, compute dtype, cache dtype, logits bound)
CASES = {
    "f32-f32": ("f32", "float32", "float32", 1e-4),
    "f32-bf16": ("f32", "float32", "bfloat16", 1e-4),
    "f32-q8": ("f32", "float32", "int8", 1e-4),
    "q4k-bf16": ("q4k", "bfloat16", "bfloat16", 2e-2),
    "q4k-f32": ("q4k", "bfloat16", "float32", 2e-2),
    "q4k-q8": ("q4k", "bfloat16", "int8", 2e-2),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("qwen3moe")
    return {name: str(chip_smoke.write_internvl_ggmm(
        d / f"{name}.bin", tower=False, seed=5, writer_cls=GGMMWriter, max_len=512, layers=3,
        experts=8, sparse=SPARSE, **kw))
        for name, kw in (("f32", dict(dtype=GGMLType.F32)), ("q4k", {}))}


_PAIRS: dict = {}


def pair(files, case):
    """The case's file in both packages, loaded once per case."""
    if case not in _PAIRS:
        name, compute, cache, _ = CASES[case]
        rt = dict(compute_dtype=compute, cache_dtype=cache)
        _PAIRS[case] = (jm.load_model(files[name], jm.RuntimeConfig(**rt)),
                        tm.load_model(files[name], tm.RuntimeConfig(**rt), device="cpu"))
    return _PAIRS[case]


def test_config_matches_jax(files):
    j, t = pair(files, "f32-f32")
    for f in ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "head_dim", "intermediate_size", "norm_eps", "qk_norm",
              "tie_lm_head", "moe_num_experts", "moe_top_k", "moe_norm_topk_prob",
              "moe_n_group", "moe_topk_group", "moe_routed_scale", "moe_score_func",
              "moe_shared_intermediate"):
        assert getattr(t.cfg, f) == getattr(j.cfg, f), f
    assert [s.is_moe for s in t.cfg.layer_specs] == [s.is_moe for s in j.cfg.layer_specs]
    assert [s.is_moe for s in t.cfg.layer_specs] == list(SPARSE)
    assert (t.cfg.moe_num_experts, t.cfg.moe_top_k, t.cfg.moe_intermediate_size) == (8, 2, 128)
    assert t.cfg.moe_norm_topk_prob and t.cfg.moe_score_func == "softmax"


@pytest.mark.parametrize("case", ["f32-f32", "q4k-bf16"])
def test_weights_bit_exact(files, case):
    j, t = pair(files, case)
    for i, sparse in enumerate(SPARSE):
        jm_, tm_ = j.params["layers"][i]["mlp"], t.params["layers"][i]["mlp"]
        assert set(tm_) == set(jm_) == ({"gate", "experts"} if sparse else {"gate", "up", "down"})
        if not sparse:
            continue
        for k in ("gate", "up", "down"):
            jv, tv = np.asarray(jm_["experts"][k]), tm_["experts"][k]
            assert str(tv.dtype).split(".")[1] == str(jv.dtype)
            assert np.array_equal(jv.astype(np.float32), tv.float().numpy()), k
        jr, tr = jm_["gate"], t.params["layers"][i]["mlp"]["gate"]
        for f in ("w",) if case == "f32-f32" else ("q", "s", "b", "d", "dm"):
            assert np.array_equal(np.asarray(getattr(jr, f)).astype(np.float32),
                                  getattr(tr, f).float().numpy()), f


_JAX_OUT: dict = {}


def _run(model, gen_cls):
    """(prefill logits of PROMPT as f32 numpy, greedy tokens)."""
    eng = model.engine
    logits = eng.prefill(PROMPT, eng.new_cache(1, 512), 0)[0]
    logits = np.asarray(logits.float() if isinstance(logits, torch.Tensor) else logits,
                        np.float32)
    return logits, list(eng.generate(PROMPT, gen_cls(do_sample=False, max_new_tokens=NEW))[0])


@pytest.mark.parametrize("case", list(CASES))
def test_logits_and_greedy_tokens_match_jax(files, case):
    j, t = pair(files, case)
    if case not in _JAX_OUT:
        _JAX_OUT[case] = _run(j, JGen)
    jl, jt = _JAX_OUT[case]
    with torch.inference_mode():
        tl, tt = _run(t, TGen)
    assert np.isfinite(tl).all() and tl.shape == jl.shape
    assert np.abs(tl - jl).max() <= CASES[case][3] * np.abs(jl).max()
    assert tt == jt and len(tt) == NEW


def test_batched_engine_matches_jax(files):
    j, t = pair(files, "f32-q8")
    prompts = [PROMPT[:12], PROMPT[5:30], PROMPT[::2]]
    jeng = JBatched(j.cfg, j.params, max_slots=3, decode_block=4,
                    scfg=JSampler(do_sample=False, sampling="greedy"))
    try:
        want = [list(h) for h in [jeng.submit(q, max_new=8) for q in prompts]]
    finally:
        jeng.shutdown()
    eng = BatchedEngine(t.cfg, t.params, max_slots=3, decode_block=4,
                        scfg=SamplerConfig(do_sample=False, sampling="greedy"), device="cpu")
    try:
        got = [list(h) for h in [eng.submit(q, max_new=8) for q in prompts]]
    finally:
        eng.shutdown()
    assert got == want and all(len(g) == 8 for g in got)


def test_qwen3_30b_a3b_config_builds_without_a_shared_expert():
    from chatllm_tpu_torch.models.synthetic import build_synthetic_params, qwen3_30b_a3b_config
    from chatllm_tpu_torch.nn.transformer import init_cache, transformer_forward

    cfg = qwen3_30b_a3b_config()
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.num_key_value_heads, cfg.resolved_head_dim()) == (2048, 48, 32, 4, 128)
    assert (cfg.moe_num_experts, cfg.moe_top_k, cfg.moe_intermediate_size,
            cfg.moe_shared_intermediate) == (128, 8, 768, 0)
    assert all(s.is_moe for s in cfg.layer_specs) and cfg.qk_norm == "rmsnorm"
    # two layers at a narrow width and 16 experts: the layout the full build has
    small = dataclasses.replace(cfg, hidden_size=256, num_hidden_layers=2, vocab_size=512,
                                num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                                moe_num_experts=16, moe_intermediate_size=64,
                                layer_specs=cfg.layer_specs[:2],
                                rope=dataclasses.replace(cfg.rope, head_dim=64))
    params = build_synthetic_params(small, "q4k", zeros=False, centered=True)
    mlp = params["layers"][0]["mlp"]
    assert set(mlp) == {"gate", "experts"}
    assert tuple(mlp["experts"]["gate"].shape) == (16, 256, 64)
    logits = transformer_forward(small, params, torch.tensor([[1, 2, 3, 4]]),
                                 init_cache(small, 1, 8), 0)[0]
    assert logits.shape == (1, 4, 512) and torch.isfinite(logits).all()
