"""The families that run on blocks already ported (LLAMA3_2 tied and untied,
DEEPSEEK_R1_DISTILL_LLAMA, DEEPSEEK_R1_DISTILL_QWEN, DEEPSEEK_R1_DISTILL_QWEN3,
QWEN2MoE, QWEN3 with a sparse and a dense layer, DEEPSEEK, DEEPSEEK_V1_MoE,
DEEPSEEK_V3 with a low-rank q and grouped routing, MOONLIGHT and
DEEPSEEK_V3_LIGHT) in the port against the JAX package, on the CPU, over
narrow f32 GGMMs written with the JAX package's writer
(`chip_smoke.write_family_ggmm`: byte-level vocab plus each family's control
tokens, hidden 256, 8 experts):

  - the loader is the family's, the config's fields equal the JAX
    package's, and every parameter loads bit-exact;
  - prefill logits within 1e-4 of the logit scale, and 8 greedy tokens
    identical, over an f32 cache;
  - the chat template's ids (two rounds, a system prompt for the R1
    families) and their decoding equal;
  - the DeepSeek-R1 tokenizers (Qwen's split and Llama's digit triples)
    against the JAX ones on digits, the special pieces and non-ASCII text;
  - model types this port does not register (Phi-3.5-MoE, Kimi-VL; Mixtral
    loads since the Mistral family landed, Gemma 2 since the Gemma family
    did, Phi-3 since the Phi family did) still fail to load."""
import dataclasses

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import torch_one_thread  # noqa: F401  (one intra-op thread: see its docstring)

import chip_smoke
import chatllm_tpu.models as jm
import chatllm_tpu.ops.qtensor as jq
import chatllm_tpu_torch.models as tm
import chatllm_tpu_torch.ops.qtensor as tq
from chatllm_tpu.ggmm.quants import GGMLType
from chatllm_tpu.ggmm.writer import GGMMWriter
from chatllm_tpu.runtime.chat import Messages as JMessages, MsgRole as JRole
from chatllm_tpu.runtime.generate import GenerationConfig as JGen
from chatllm_tpu_torch.models.model_types import ModelType
from chatllm_tpu_torch.runtime.chat import Messages as TMessages, MsgRole as TRole
from chatllm_tpu_torch.runtime.generate import GenerationConfig as TGen

# case -> (chip_smoke.FAMILIES name, tie flag, the port's loader)
CASES = {
    "llama3_2": ("llama3_2", False, "Llama32"),
    "llama3_2_tied": ("llama3_2", True, "Llama32"),
    "ds_r1_llama": ("ds_r1_llama", False, "DSR1DistillLlama"),
    "ds_r1_qwen": ("ds_r1_qwen", False, "Qwen2DSR1Distill"),
    "ds_r1_qwen3": ("ds_r1_qwen3", False, "Qwen3"),
    "qwen3_moe": ("qwen3_moe", False, "Qwen3"),
    "qwen2_moe": ("qwen2_moe", False, "Qwen2MoE"),
    "deepseek": ("deepseek", False, "DeepSeekV1"),
    "deepseek_v1_moe": ("deepseek_v1_moe", False, "DeepSeekV1MoE"),
    "deepseek_v3": ("deepseek_v3", False, "DeepSeekV3"),
    "moonlight": ("moonlight", False, "DeepSeekV3"),
    "deepseek_v3_light": ("deepseek_v3_light", False, "DeepSeekV3"),
}
F32 = dict(compute_dtype="float32", cache_dtype="float32")
PROMPT = np.random.default_rng(5).integers(0, 380, 24).tolist()
NEW = 8
CFG_FIELDS = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "head_dim", "intermediate_size", "max_length", "norm_eps",
              "qkv_bias", "qk_norm", "tie_lm_head", "attention_scale", "cache_dtype",
              "moe_num_experts", "moe_top_k", "moe_norm_topk_prob", "moe_n_group",
              "moe_topk_group", "moe_routed_scale", "moe_score_func")
ROPE_FIELDS = ("head_dim", "rot_dim", "freq_base", "freq_scale", "layout", "ext_factor",
               "attn_factor", "beta_fast", "beta_slow", "orig_ctx", "freq_factors")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("families")
    return {case: str(chip_smoke.write_family_ggmm(d / f"{case}.bin", fam, tie=tie, seed=7,
                                                   dtype=GGMLType.F32, writer_cls=GGMMWriter))
            for case, (fam, tie, _) in CASES.items()}


_PAIRS: dict = {}


def pair(files, case):
    """The case's file in both packages (f32 activations and cache), loaded
    once per module."""
    if case not in _PAIRS:
        _PAIRS[case] = (jm.load_model(files[case], jm.RuntimeConfig(**F32)),
                        tm.load_model(files[case], tm.RuntimeConfig(**F32), device="cpu"))
    return _PAIRS[case]


def _same(a, b, where):
    """The port's parameter tree `a` equals the JAX package's `b` bit for bit."""
    if isinstance(b, dict):
        assert set(a) == set(b), (where, set(a) ^ set(b))
        for k in b:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(b, jq.DenseLinear):
        assert isinstance(a, tq.DenseLinear) and (a.bias is None) == (b.bias is None), where
        _same(a.w, b.w, where + ".w")
        if b.bias is not None:
            _same(a.bias, b.bias, where + ".bias")
    else:
        want = np.asarray(b)
        assert str(a.dtype).split(".")[1] == str(want.dtype), where
        np.testing.assert_array_equal(a.numpy(), want, err_msg=where)


@pytest.mark.parametrize("case", list(CASES))
def test_config_and_weights_match_jax(files, case):
    j, t = pair(files, case)
    assert type(t).__name__ == CASES[case][2]
    assert t.model_type == j.model_type == int(ModelType[chip_smoke.FAMILIES[CASES[case][0]][0]])
    for f in CFG_FIELDS:
        assert getattr(t.cfg, f) == getattr(j.cfg, f), f
    for f in ROPE_FIELDS:
        assert getattr(t.cfg.rope, f) == getattr(j.cfg.rope, f), f
    assert [s.is_moe for s in t.cfg.layer_specs] == [s.is_moe for s in j.cfg.layer_specs]
    assert (t.cfg.mla is None) == (j.cfg.mla is None)
    if t.cfg.mla is not None:
        assert dataclasses.asdict(t.cfg.mla) == dataclasses.asdict(j.cfg.mla)
    assert t.cfg.tie_lm_head == CASES[case][1]
    _same(t.params, j.params, "params")


_JAX_OUT: dict = {}


def _run(model, gen_cls):
    """(prefill logits of PROMPT as f32 numpy, greedy tokens)."""
    eng = model.engine
    logits = eng.prefill(PROMPT, eng.new_cache(1, 64), 0)[0]
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
    assert np.abs(tl - jl).max() <= 1e-4 * np.abs(jl).max()
    assert tt == jt and len(tt) == NEW


@pytest.mark.parametrize("case", list(CASES))
def test_chat_template_ids_match_jax(files, case):
    j, t = pair(files, case)
    r1 = CASES[case][0].startswith("ds_r1")
    if r1:
        j.tokenizer.sys_prompt = t.tokenizer.sys_prompt = "Think first."
    jh, th = JMessages(), TMessages()
    for text in ("Hello, wörld! 12345", "中文 µ ½ 2024 <｜User｜>"):
        jh.push_back(JRole.USER, text)
        th.push_back(TRole.USER, text)
        ji = j.tokenizer.encode_history(jh, 512, incremental=False)
        ti = t.tokenizer.encode_history(th, 512, incremental=False)
        assert ti == ji
        jh.push_back(JRole.ASSISTANT, text[::-1])
        th.push_back(TRole.ASSISTANT, text[::-1])
    assert t.tokenizer.decode(ti) == j.tokenizer.decode(ji)
    if r1:
        tok = t.tokenizer
        assert ti[0] == tok.bos_token_id == 256 and (tok.user_token_id,
                                                     tok.assistant_token_id) == (258, 259)
        # two turns and the piece in the second text
        assert ti.count(tok.user_token_id) == 3 and tok.is_terminate_token(tok.eos_token_id)


R1_TEXTS = ["12345 67 8", "<｜User｜>hi<｜Assistant｜>ok<｜end▁of▁sentence｜>",
            "wörld 中文 Ａ！ ½ µ\n\n  x", "<｜begin▁of▁sentence｜>a 1234567"]


@pytest.mark.parametrize("case", ["ds_r1_qwen", "ds_r1_llama"])
@pytest.mark.parametrize("text", range(len(R1_TEXTS)))
def test_r1_tokenizers_match_jax(files, case, text):
    from chatllm_tpu.models.qwen import DS_R1_LLAMA_REGEX as JL, DS_R1_REGEX as JQ
    from chatllm_tpu_torch.models.qwen import DS_R1_LLAMA_REGEX, DS_R1_REGEX

    assert (DS_R1_REGEX, DS_R1_LLAMA_REGEX) == (JQ, JL)
    j, t = pair(files, case)
    s = R1_TEXTS[text]
    ids = t.tokenizer.encode(s)
    assert ids == j.tokenizer.encode(s)
    assert t.tokenizer.decode(ids) == j.tokenizer.decode(ids)
    # the pre-split (the byte vocab has no merges to show it in the ids):
    # Llama's groups digits by three, Qwen's takes them one by one
    split = t.tokenizer.tp._regex_split(s)
    assert split == j.tokenizer.tp._regex_split(s)
    if text == 0:
        assert split[:2] == (["123", "45"] if case == "ds_r1_llama" else ["1", "2"])


@pytest.mark.parametrize("mtype", ["PHI3_MOE", "KIMI_VL"])
def test_unregistered_model_types_still_fail_to_load(tmp_path, mtype):
    path = chip_smoke.write_internvl_ggmm(tmp_path / "m.bin", tower=False, layers=1,
                                          dtype=GGMLType.F32, model_type=ModelType[mtype])
    with pytest.raises(ValueError, match="unsupported model_type"):
        tm.load_model(str(path), device="cpu")
