"""Qwen2 and Qwen3 families (counterpart of the JAX package's
`models/qwen.py`: QWEN2, QWEN2TIE and the models that share their loader;
QWEN3, the dense models).

Qwen uses the NeoX (half-split) rope lane layout: the converter does not
permute q/k.  Qwen2's q/k/v carry a bias, and its lm_head is tied to the
embedding when the file holds no `lm_head.weight`.  Qwen3 has no biases, a
per-head RMS norm of q and k before RoPE, and a tie flag in its config.
"""
from __future__ import annotations

from dataclasses import replace

from ..ops.rope import ROPE_NEOX
from ..runtime.chat import ChatMLEncoder, ChatTokenizer
from ..tokenizer.processor import BPEProcessor2
from .base import (BaseConfig, BaseLLM, ParamBuilder, RuntimeConfig,
                   load_llama_family_params, register_model)
from .llama import build_dense_config
from .model_types import ModelType

# chatllm.cpp models/qwen.cpp v1 do_load regex
QWEN_REGEX = [
    r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
]


def make_qwen_tokenizer(gf, base: BaseConfig) -> ChatTokenizer:
    """chatllm.cpp models/qwen.cpp v1 Tokenizer::load."""
    tp = BPEProcessor2(QWEN_REGEX)
    tp.load(gf.tokenizer_reader(), base.vocab_size)
    tp.enable_return_special_token(True)
    tok = ChatTokenizer(tp, ChatMLEncoder(), sys_prompt="You are a helpful assistant.")
    eot = tp.piece_to_id("<|endoftext|>")
    tok.pad_token_id = tok.eos_token_id = tok.bos_token_id = eot
    tok.im_start_token_id = tp.piece_to_id("<|im_start|>")
    tok.im_end_token_id = tp.piece_to_id("<|im_end|>")
    tok.nl_token_id = tp.encode("\n")[0]
    if tok.im_end_token_id >= 0:
        tok.terminate_ids.add(tok.im_end_token_id)
    tok.is_special_id = lambda i: i in (tok.pad_token_id, tok.im_start_token_id,
                                        tok.im_end_token_id)
    return tok


@register_model(ModelType.QWEN2, ModelType.QWEN2TIE, ModelType.MARCO_O1,
                ModelType.QWQ, ModelType.READERLM2)
class Qwen2(BaseLLM):
    # Config: BaseConfig + {num_key_value_heads, sliding_window} + rope_theta
    # (chatllm.cpp models/qwen.h:76-81); the window is parsed and unused, as
    # in the JAX package
    EXTRA_FMT = "2if"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, (n_kv, _sliding_window, rope_theta) = BaseConfig.parse(gf, cls.EXTRA_FMT)
        tie = not gf.has_tensor("lm_head.weight")
        cfg = build_dense_config(
            base, num_key_value_heads=n_kv, rope_theta=rope_theta,
            rope_layout=ROPE_NEOX, tie_lm_head=tie, norm_eps=1e-6,
            qkv_bias=True, max_length=rt.max_length, cache_dtype=rt.cache_dtype)
        tok = make_qwen_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = load_llama_family_params(pb, base.num_hidden_layers, tie_lm_head=tie)
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.QWEN3, ModelType.DEEPSEEK_R1_DISTILL_QWEN3)
class Qwen3(BaseLLM):
    # chatllm.cpp models/qwen.h:746-760 v3 Config: BaseConfig +
    # {num_key_value_heads, head_dim, rope_theta:f, yarn_factor:f, yarn_orig,
    # decoder_sparse_step, moe_intermediate_size, num_experts_per_tok,
    # num_experts, norm_topk_prob, tie_word_embeddings, layer_is_sparse[128]}
    EXTRA_FMT = "2iff" + "i" * 6 + "i" + "128i"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        if gf.model_type == int(ModelType.DEEPSEEK_R1_DISTILL_QWEN3):
            raise NotImplementedError(
                "DEEPSEEK_R1_DISTILL_QWEN3 (the DeepSeek-R1 tokenizer and template over "
                "Qwen3) is not ported to chatllm_tpu_torch yet (ROADMAP.md section 1, M12)")
        base, extra = BaseConfig.parse(gf, cls.EXTRA_FMT)
        (n_kv, head_dim, rope_theta, yarn_factor, yarn_orig,
         _sparse_step, _moe_inter, _n_active, n_experts, _norm_topk, tie_flag) = extra[:11]
        if n_experts > 0 and any(extra[11:11 + base.num_hidden_layers]):
            raise NotImplementedError(
                "Qwen3-MoE (sparse layers) is not ported to chatllm_tpu_torch yet "
                "(ROADMAP.md section 1, item 2 and M12)")
        tie = bool(tie_flag)
        cfg = build_dense_config(
            base, num_key_value_heads=n_kv, head_dim=head_dim, rope_theta=rope_theta,
            rope_layout=ROPE_NEOX, tie_lm_head=tie, norm_eps=1e-6,
            max_length=rt.max_length, cache_dtype=rt.cache_dtype)
        cfg = replace(cfg, qk_norm="rmsnorm")
        if yarn_factor > 0 and yarn_orig > 0:
            cfg = replace(cfg, rope=replace(cfg.rope, freq_scale=1.0 / yarn_factor,
                                            ext_factor=1.0, orig_ctx=yarn_orig))
        tok = make_qwen_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = load_llama_family_params(pb, base.num_hidden_layers, tie_lm_head=tie)
        for i, layer in enumerate(params["layers"]):
            pfx = f"model.layers.{i}.self_attn"
            layer["attn"]["q_norm"] = pb.norm(f"{pfx}.q_norm")
            layer["attn"]["k_norm"] = pb.norm(f"{pfx}.k_norm")
        return cls(gf.model_type, cfg, params, tok, device)
