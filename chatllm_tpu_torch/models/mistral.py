"""Mistral family (counterpart of the JAX package's `models/mistral.py`:
MISTRAL, MIXTRAL and WIZARDLM2_MOE, MISTRAL2).

Every layer attends over a sliding window; with a context longer than
window + SWA_EXTRA its cache is a ring (nn/transformer.py).  The converter
permutes q/k into ggml's interleaved rope layout (chatllm.cpp convert.py
MistralConverter), so RoPE uses the interleaved ("normal") layout.  MISTRAL3
waits for the pixtral tower (ROADMAP.md section 1, M17).
"""
from __future__ import annotations

from dataclasses import replace

from ..nn.transformer import LayerSpec
from ..runtime.chat import ChatTokenizer, HistoryEncoder
from ..tokenizer.processor import BPEProcessor1, BPEProcessor2
from .base import (BaseConfig, BaseLLM, ParamBuilder, RuntimeConfig, load_llama_family_params,
                   load_moe_experts, register_model)
from .llama import build_dense_config
from .model_types import ModelType


class MistralEncoder(HistoryEncoder):
    """[INST] ... [/INST] (chatllm.cpp models/mistral.cpp ChatHistoryEncoder;
    the v3 / v7 tool tags as plain text, as in the JAX package)."""

    def append_sys_prompt(self, ids):
        if self.tokenizer.bos_token_id >= 0:
            ids.append(self.tokenizer.bos_token_id)

    def append_user(self, round_idx, user, ids):
        tok = self.tokenizer
        sys = tok.sys_prompt
        if sys and round_idx == 0:
            ids.extend(tok.encode(f"[INST] {sys}\n{user} [/INST]"))
        else:
            ids.extend(tok.encode(f"[INST] {user} [/INST]"))

    def append_ai(self, round_idx, ai, ids):
        tok = self.tokenizer
        ids.extend(tok.encode(ai))
        ids.append(tok.eos_token_id)

    def append_ai_opening(self, round_idx, ids):
        pass


def _chat_tokenizer(tp, base: BaseConfig) -> ChatTokenizer:
    tok = ChatTokenizer(tp, MistralEncoder(), sys_prompt="")
    tok.bos_token_id = base.bos_token_id
    tok.eos_token_id = base.eos_token_id
    tok.pad_token_id = base.pad_token_id
    return tok


def make_mistral_tokenizer(gf, base: BaseConfig) -> ChatTokenizer:
    """SentencePiece-score vocab (BPEProcessor1) + the [INST] template."""
    tp = BPEProcessor1()
    tp.load(gf.tokenizer_reader(), base.vocab_size)
    return _chat_tokenizer(tp, base)


def make_mistral2_tokenizer(gf, base: BaseConfig) -> ChatTokenizer:
    """Tekken (BPEProcessor2) vocab + the [INST] template (chatllm.cpp
    mistral2::Tokenizer, models/mistral.cpp:259-283)."""
    tp = BPEProcessor2()
    tp.load(gf.tokenizer_reader(), base.vocab_size)
    tp.enable_return_special_token(True)
    return _chat_tokenizer(tp, base)


@register_model(ModelType.MISTRAL)
class Mistral(BaseLLM):
    # BaseConfig + {num_key_value_heads, sliding_window} + rope_theta
    # (chatllm.cpp models/mistral.h:5-10)
    EXTRA_FMT = "2if"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, (n_kv, sliding_window, rope_theta) = BaseConfig.parse(gf, cls.EXTRA_FMT)
        cfg = build_dense_config(
            base, num_key_value_heads=n_kv, rope_theta=rope_theta,
            sliding_window=max(0, sliding_window), norm_eps=1e-6,
            max_length=rt.max_length, cache_dtype=rt.cache_dtype)
        tok = make_mistral_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = load_llama_family_params(pb, base.num_hidden_layers)
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.MIXTRAL, ModelType.WIZARDLM2_MOE)
class Mixtral(BaseLLM):
    """Mistral's attention over a sparse FFN in every layer: softmax top-k
    routing renormalized over the picks, no shared expert; the experts are
    `block_sparse_moe.experts.{j}.w1/w3/w2` (gate / up / down), stacked in
    the compute dtype (models/base.py::load_moe_experts)."""
    # the Mistral config + {num_experts_per_tok, num_local_experts}
    # (chatllm.cpp models/mistral.h:45-49)
    EXTRA_FMT = "2if2i"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, (n_kv, sliding_window, rope_theta, n_active, n_experts) = BaseConfig.parse(
            gf, cls.EXTRA_FMT)
        sw = max(0, sliding_window)
        cfg = build_dense_config(
            base, num_key_value_heads=n_kv, rope_theta=rope_theta, sliding_window=sw,
            max_length=rt.max_length, cache_dtype=rt.cache_dtype)
        cfg = replace(cfg, layer_specs=tuple(LayerSpec(sliding_window=sw, is_moe=True)
                                             for _ in range(base.num_hidden_layers)),
                      moe_num_experts=n_experts, moe_top_k=n_active, moe_norm_topk_prob=True)
        tok = make_mistral_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = {
            "embed": pb.embedding("model.embed_tokens.weight"),
            "final_norm": pb.norm("model.norm"),
            "lm_head": pb.linear("lm_head"),
            "layers": [],
        }
        for i in range(base.num_hidden_layers):
            pfx = f"model.layers.{i}"
            params["layers"].append({
                "attn_norm": pb.norm(f"{pfx}.input_layernorm"),
                "attn": {n: pb.linear(f"{pfx}.self_attn.{n}_proj") for n in "qkvo"},
                "ffn_norm": pb.norm(f"{pfx}.post_attention_layernorm"),
                "mlp": {
                    "gate": pb.linear(f"{pfx}.block_sparse_moe.gate"),
                    "experts": load_moe_experts(pb, f"{pfx}.block_sparse_moe", n_experts,
                                                names=("w1", "w3", "w2")),
                },
            })
        params["layers"] = tuple(params["layers"])
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.MISTRAL2)
class Mistral2(BaseLLM):
    """Mistral-v3-tokenizer models (tekken BPE2) with a head_dim of their own,
    e.g. Mistral-Nemo's 128 over a hidden of 5120 and 32 heads (chatllm.cpp
    models/mistral.h:151-176)."""
    EXTRA_FMT = "3if"   # n_kv, head_dim, sliding_window, rope_theta

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, (n_kv, head_dim, sliding_window, rope_theta) = BaseConfig.parse(
            gf, cls.EXTRA_FMT)
        cfg = build_dense_config(
            base, num_key_value_heads=n_kv, head_dim=head_dim, rope_theta=rope_theta,
            sliding_window=max(0, sliding_window), norm_eps=1e-6,
            max_length=rt.max_length, cache_dtype=rt.cache_dtype)
        tok = make_mistral2_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = load_llama_family_params(pb, base.num_hidden_layers)
        return cls(gf.model_type, cfg, params, tok, device)
