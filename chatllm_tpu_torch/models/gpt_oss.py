"""GPT-OSS (counterpart of the JAX package's `models/gpt_oss.py`: GPT_OSS).

Layers alternate a sliding window of 128 keys with full attention (the
file's `layer_type` array), every layer has learned attention sinks, rope is
YaRN's, and every FFN is a MoE with a biased router (the softmax over the
top k of the biased logits) and biased experts under the clamped
`swiglu_oai`.  YaRN's attention factor is HF's single 0.1 ln(factor) + 1,
as in the JAX package.  The experts are stacked dense in the compute dtype,
as the JAX loader stacks them, one expert at a time onto the device.
"""
from __future__ import annotations

import datetime

import numpy as np
import torch

from ..nn.transformer import LayerSpec, TransformerConfig
from ..ops.rope import ROPE_NEOX, RopeConfig
from ..runtime.chat import ChatTokenizer, HistoryEncoder
from ..tokenizer.processor import BPEProcessor2
from .base import (BaseConfig, BaseLLM, ParamBuilder, RuntimeConfig, load_moe_experts,
                   register_model)
from .model_types import ModelType

MAX_LAYERS = 128  # layer_type entries stored in the config (chatllm.cpp models/gpt.cpp)

# o200k_harmony pre-split regexes (chatllm.cpp models/gpt.cpp Tokenizer::load)
GPT_OSS_REGEX = [
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])?",
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])?",
    r"\p{N}{1,3}",
    r" ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+",
    r"\s+(?!\S)|\s+",
]


class HarmonyEncoder(HistoryEncoder):
    """<|start|>{role}<|message|>{content}<|end|> turns (chatllm.cpp
    models/gpt.cpp ChatHistoryEncoder)."""

    def _item(self, tag: str, ids: list[int], content: str | None = None):
        tok = self.tokenizer
        ids.append(tok.start_token_id)
        ids.extend(tok.encode(tag))
        ids.append(tok.message_token_id)
        if content is not None:
            ids.extend(tok.encode(content))
            ids.append(tok.end_token_id)

    def append_sys_prompt(self, ids):
        self._item("system", ids, self.tokenizer.sys_prompt)

    def append_user(self, round_idx, user, ids):
        self._item("user", ids, user)

    def append_ai(self, round_idx, ai, ids):
        self._item("assistant", ids, ai)

    def append_ai_opening(self, round_idx, ids):
        self._item("assistant", ids)

    def append_user_opening(self, round_idx, ids):
        self._item("user", ids)


def default_sys_prompt() -> str:
    """The harmony system prompt with today's date (chatllm.cpp models/gpt.cpp
    Tokenizer)."""
    today = datetime.date.today().isoformat()
    return ("You are ChatGPT, a large language model trained by OpenAI.\n"
            "Knowledge cutoff: 2024-06\n"
            f"Current date: {today}\n\n"
            "Reasoning: medium\n")


@register_model(ModelType.GPT_OSS)
class GPTOSS(BaseLLM):
    # BaseConfig + 6i {n_kv, head_dim, experts_per_token, num_experts_per_tok,
    # num_local_experts, sliding_window} + 128i layer_type + 7f
    # {router_aux_loss_coef, swiglu_limit, rope_theta, orig_max_pos,
    # beta_fast, beta_slow, factor}  (the converter's GPTOSSConverter.dump_config)
    EXTRA_FMT = f"{6 + MAX_LAYERS}i7f"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, extra = BaseConfig.parse(gf, cls.EXTRA_FMT)
        n_kv, head_dim, _experts_per_token, top_k, n_experts, sliding_window = extra[:6]
        layer_type = extra[6:6 + MAX_LAYERS]
        (_aux_loss, swiglu_limit, rope_theta, orig_max_pos,
         beta_fast, beta_slow, factor) = extra[6 + MAX_LAYERS:]
        specs = tuple(LayerSpec(sliding_window=sliding_window if layer_type[i] else 0,
                                is_moe=True)
                      for i in range(base.num_hidden_layers))
        rope = RopeConfig(head_dim=head_dim, freq_base=rope_theta, layout=ROPE_NEOX,
                          freq_scale=1.0 / factor if factor > 1.0 else 1.0,
                          ext_factor=1.0 if factor > 1.0 else 0.0,
                          beta_fast=beta_fast, beta_slow=beta_slow, orig_ctx=int(orig_max_pos))
        cfg = TransformerConfig(
            vocab_size=base.vocab_size, hidden_size=base.hidden_size,
            num_hidden_layers=base.num_hidden_layers,
            num_attention_heads=base.num_attention_heads, num_key_value_heads=n_kv,
            head_dim=head_dim, intermediate_size=base.intermediate_size,
            max_length=rt.max_length if rt.max_length > 0 else base.max_length,
            rope=rope, layer_specs=specs, qkv_bias=True, o_bias=True,
            moe_num_experts=n_experts, moe_top_k=top_k, moe_score_func="softmax_topk",
            moe_act="swiglu_oai", moe_swiglu_limit=swiglu_limit, cache_dtype=rt.cache_dtype)
        tok = cls.make_tokenizer(gf, base)
        params = cls.load_params(ParamBuilder(gf, rt, device), base.num_hidden_layers,
                                 n_experts)
        return cls(gf.model_type, cfg, params, tok, device)

    @staticmethod
    def load_params(pb: ParamBuilder, n_layers: int, n_experts: int) -> dict:
        """The JAX loader's map: biased q/k/v/o, the sinks, the router and
        its bias, and each layer's experts stacked with their biases in the
        compute dtype (the file's values as f32, then the compute dtype),
        placed on the device before the next layer is read."""
        params = {"embed": pb.embedding("model.embed_tokens.weight"),
                  "final_norm": pb.norm("model.norm"), "lm_head": pb.linear("lm_head"),
                  "layers": []}
        for i in range(n_layers):
            pfx = f"model.layers.{i}"
            attn = {k: pb.linear(f"{pfx}.self_attn.{k}_proj") for k in "qkvo"}
            attn["sinks"] = pb.array(f"{pfx}.self_attn.sinks")
            experts = load_moe_experts(pb, f"{pfx}.mlp", n_experts)
            for key, name in (("gate_b", "gate_proj"), ("up_b", "up_proj"),
                              ("down_b", "down_proj")):
                experts[key] = torch.from_numpy(np.stack(
                    [pb.raw_f32(f"{pfx}.mlp.experts.{j}.{name}.bias") for j in range(n_experts)]
                )).to(device=pb.device, dtype=pb.compute_dtype)
            params["layers"].append({
                "attn_norm": pb.norm(f"{pfx}.input_layernorm"),
                "attn": attn,
                "ffn_norm": pb.norm(f"{pfx}.post_attention_layernorm"),
                "mlp": {"gate": pb.linear(f"{pfx}.mlp.router", bias=False),
                        "gate_linear_bias": pb.array(f"{pfx}.mlp.router.bias"),
                        "experts": experts},
            })
        params["layers"] = tuple(params["layers"])
        return params

    @classmethod
    def make_tokenizer(cls, gf, base: BaseConfig) -> ChatTokenizer:
        """o200k_harmony's pre-split on BPEProcessor2, the harmony template
        and its special ids; <|end|> and <|return|> end a reply."""
        tp = BPEProcessor2(GPT_OSS_REGEX)
        tp.load(gf.tokenizer_reader(), base.vocab_size)
        tp.enable_return_special_token(True)
        tok = ChatTokenizer(tp, HarmonyEncoder(), sys_prompt=default_sys_prompt())
        tok.start_token_id = tp.piece_to_id("<|start|>")
        tok.message_token_id = tp.piece_to_id("<|message|>")
        tok.end_token_id = tp.piece_to_id("<|end|>")
        tok.channel_token_id = tp.piece_to_id("<|channel|>")
        tok.return_token_id = tp.piece_to_id("<|return|>")
        tok.bos_token_id = tp.piece_to_id("<|startoftext|>")
        tok.eos_token_id = tok.end_token_id
        for t in (tok.end_token_id, tok.return_token_id):
            if t >= 0:
                tok.terminate_ids.add(t)
        return tok
