"""Qwen2 and Qwen3 families (counterpart of the JAX package's
`models/qwen.py`: QWEN2, QWEN2TIE and the models that share their loader;
DEEPSEEK_R1_DISTILL_QWEN; QWEN2MoE; QWEN3 with its MoE layers, and
DEEPSEEK_R1_DISTILL_QWEN3), and the DeepSeek-R1 distills' tokenizer and
chat template, which the Llama distill shares.

Qwen uses the NeoX (half-split) rope lane layout: the converter does not
permute q/k.  Qwen2's q/k/v carry a bias, and its lm_head is tied to the
embedding when the file holds no `lm_head.weight`.  Qwen3 has no biases, a
per-head RMS norm of q and k before RoPE, and a tie flag in its config;
its sparse layers (`layer_is_sparse`) route softmax top-k over experts
with no shared expert.  Qwen2-MoE gates its shared expert with a sigmoid.
"""
from __future__ import annotations

from dataclasses import replace

from ..nn.transformer import LayerSpec
from ..ops.rope import ROPE_NEOX
from ..runtime.chat import ChatMLEncoder, ChatTokenizer, HistoryEncoder
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


# chatllm.cpp qwen.cpp ds_r1_distill::Tokenizer::load regex (qwen.cpp:840);
# the Llama distill's (llama.cpp:630) groups digits {1,3}
DS_R1_REGEX = [
    r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
]
DS_R1_LLAMA_REGEX = [
    r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
]


class DeepSeekR1Encoder(HistoryEncoder):
    """[bos]{sys}<｜User｜>{user}<｜Assistant｜>{ai}[eos] (chatllm.cpp qwen.cpp
    ds_r1_distill ChatHistoryEncoder:866-896, llama.cpp ds_r1_distill:657-690)."""

    def append_sys_prompt(self, ids):
        tok = self.tokenizer
        ids.append(tok.bos_token_id)
        if tok.sys_prompt:
            ids.extend(tok.encode(tok.sys_prompt))

    def append_user(self, round_idx, user, ids):
        tok = self.tokenizer
        ids.append(tok.user_token_id)
        ids.extend(tok.encode(user))

    def append_ai(self, round_idx, ai, ids):
        tok = self.tokenizer
        ids.append(tok.assistant_token_id)
        ids.extend(tok.encode(ai))
        ids.append(tok.eos_token_id)

    def append_ai_opening(self, round_idx, ids):
        ids.append(self.tokenizer.assistant_token_id)


def make_ds_r1_tokenizer(gf, base: BaseConfig, *, llama: bool = False) -> ChatTokenizer:
    """The DeepSeek-R1 distills' tokenizer: byte BPE with Qwen's split (or
    Llama-3's under `llama`) and the full-width-bar special pieces."""
    tp = BPEProcessor2(DS_R1_LLAMA_REGEX if llama else DS_R1_REGEX)
    tp.load(gf.tokenizer_reader(), base.vocab_size)
    tp.enable_return_special_token(True)
    tok = ChatTokenizer(tp, DeepSeekR1Encoder(), sys_prompt="")
    tok.user_token_id = tp.piece_to_id("<｜User｜>")
    tok.assistant_token_id = tp.piece_to_id("<｜Assistant｜>")
    tok.bos_token_id = tp.piece_to_id("<｜begin▁of▁sentence｜>")
    tok.eos_token_id = tp.piece_to_id("<｜end▁of▁sentence｜>")
    nl = tp.encode("\n")
    tok.nl_token_id = nl[0] if len(nl) == 1 else -1
    tok.is_special_id = lambda i: i in (tok.user_token_id, tok.assistant_token_id,
                                        tok.bos_token_id, tok.eos_token_id)
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


@register_model(ModelType.DEEPSEEK_R1_DISTILL_QWEN)
class Qwen2DSR1Distill(BaseLLM):
    """DeepSeek-R1-Distill-Qwen: the Qwen2 block with an explicit tie flag
    and the DeepSeek-R1 chat template (chatllm.cpp qwen.h:330-335 Config {v2
    + int tie}, qwen.cpp ds_r1_distill:821-901)."""
    EXTRA_FMT = "2ifi"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, (n_kv, _sliding_window, rope_theta, tie_flag) = BaseConfig.parse(
            gf, cls.EXTRA_FMT)
        tie = bool(tie_flag)
        cfg = build_dense_config(
            base, num_key_value_heads=n_kv, rope_theta=rope_theta,
            rope_layout=ROPE_NEOX, tie_lm_head=tie, norm_eps=1e-6,
            qkv_bias=True, max_length=rt.max_length, cache_dtype=rt.cache_dtype)
        tok = make_ds_r1_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = load_llama_family_params(pb, base.num_hidden_layers, tie_lm_head=tie)
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.QWEN2MoE)
class Qwen2MoE(BaseLLM):
    # BaseConfig + {n_kv, moe_intermediate, shared_expert_intermediate,
    # sliding_window, n_active, n_experts, norm_topk} + rope_theta
    # (chatllm.cpp models/qwen.h:121-131); every layer is sparse, with one
    # shared expert under a sigmoid gate
    EXTRA_FMT = "7if"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, extra = BaseConfig.parse(gf, cls.EXTRA_FMT)
        (n_kv, moe_inter, _shared_inter, _sliding_window, n_active, n_experts,
         norm_topk, rope_theta) = extra
        n_layers = base.num_hidden_layers
        cfg = build_dense_config(
            base, num_key_value_heads=n_kv, rope_theta=rope_theta,
            rope_layout=ROPE_NEOX, norm_eps=1e-6, qkv_bias=True,
            max_length=rt.max_length, cache_dtype=rt.cache_dtype)
        cfg = replace(cfg, layer_specs=tuple(LayerSpec(is_moe=True) for _ in range(n_layers)),
                      moe_num_experts=n_experts, moe_top_k=n_active,
                      moe_norm_topk_prob=bool(norm_topk), moe_intermediate_size=moe_inter)
        tok = make_qwen_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = load_llama_family_params(pb, n_layers, sparse=[True] * n_layers,
                                          n_experts=n_experts, shared="shared_expert")
        for i, layer in enumerate(params["layers"]):
            layer["mlp"]["shared_gate"] = pb.linear(f"model.layers.{i}.mlp.shared_expert_gate")
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
        base, extra = BaseConfig.parse(gf, cls.EXTRA_FMT)
        (n_kv, head_dim, rope_theta, yarn_factor, yarn_orig,
         _sparse_step, moe_inter, n_active, n_experts, norm_topk, tie_flag) = extra[:11]
        n_layers = base.num_hidden_layers
        sparse = [n_experts > 0 and bool(s) for s in extra[11:11 + n_layers]]
        tie = bool(tie_flag)
        cfg = build_dense_config(
            base, num_key_value_heads=n_kv, head_dim=head_dim, rope_theta=rope_theta,
            rope_layout=ROPE_NEOX, tie_lm_head=tie, norm_eps=1e-6,
            max_length=rt.max_length, cache_dtype=rt.cache_dtype)
        cfg = replace(cfg, qk_norm="rmsnorm")
        if any(sparse):
            cfg = replace(cfg, layer_specs=tuple(LayerSpec(is_moe=s) for s in sparse),
                          moe_num_experts=n_experts, moe_top_k=n_active,
                          moe_norm_topk_prob=bool(norm_topk), moe_intermediate_size=moe_inter)
        if yarn_factor > 0 and yarn_orig > 0:
            cfg = replace(cfg, rope=replace(cfg.rope, freq_scale=1.0 / yarn_factor,
                                            ext_factor=1.0, orig_ctx=yarn_orig))
        if gf.model_type == int(ModelType.DEEPSEEK_R1_DISTILL_QWEN3):
            # the v3 Config with the DeepSeek-R1 tokenizer and template
            # (chatllm.cpp qwen.h:797-808)
            tok = make_ds_r1_tokenizer(gf, base)
        else:
            tok = make_qwen_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = load_llama_family_params(pb, n_layers, tie_lm_head=tie,
                                          sparse=sparse, n_experts=n_experts)
        for i, layer in enumerate(params["layers"]):
            pfx = f"model.layers.{i}.self_attn"
            layer["attn"]["q_norm"] = pb.norm(f"{pfx}.q_norm")
            layer["attn"]["k_norm"] = pb.norm(f"{pfx}.k_norm")
        return cls(gf.model_type, cfg, params, tok, device)
