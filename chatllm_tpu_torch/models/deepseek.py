"""DeepSeek family (counterpart of the JAX package's `models/deepseek.py`:
DEEPSEEK, the dense v1; DEEPSEEK_V1_MoE; DEEPSEEK_V2_LIGHT and DEEPSEEK_V2;
DEEPSEEK_V3, MOONLIGHT and DEEPSEEK_V3_LIGHT): multi-head latent attention,
grouped MoE with shared experts (V3: sigmoid scores with a selection-only
bias), YaRN rope, and the DeepSeek v1 tokenizer and chat template that the
whole family shares.

On-disk note: the converter splits the kv projections (d_kv, k_pe,
u_k_nope, u_v) and re-lays the rope dims of q and k_pe pairwise, so RoPE
takes the interleaved ("normal") layout and the weights load unmodified.
DeepSeek Coder and the GigaChat reuse of V1-MoE are not ported yet.
"""
from __future__ import annotations

import math

import torch

from dataclasses import replace

from ..nn.transformer import LayerSpec, MLAConfig, TransformerConfig
from ..ops.qmm import dequant_weight
from ..ops.qtensor import DenseLinear
from ..ops.rope import ROPE_NORMAL, RopeConfig
from ..runtime.chat import ChatTokenizer, HistoryEncoder
from ..tokenizer.processor import BPEProcessor2
from .base import (BaseConfig, BaseLLM, ParamBuilder, RuntimeConfig, load_llama_family_params,
                   load_moe_mlp, register_model)
from .llama import build_dense_config
from .model_types import ModelType


class DeepSeekV1Encoder(HistoryEncoder):
    """User:/Assistant: template (chatllm.cpp models/deepseek.cpp v1:38-84)."""

    def append_sys_prompt(self, ids):
        tok = self.tokenizer
        ids.append(tok.bos_token_id)
        if tok.sys_prompt:
            ids.extend(tok.encode(tok.sys_prompt + "\n\n"))

    def append_user(self, round_idx, user, ids):
        tok = self.tokenizer
        ids.extend(tok.encode("User:"))
        ids.extend(tok.encode(" " + user + "\n\n"))

    def append_ai(self, round_idx, ai, ids):
        tok = self.tokenizer
        self.append_ai_opening(round_idx, ids)
        ids.extend(tok.encode(" " + ai))     # leading space: deepseek.cpp:44
        ids.append(tok.eos_token_id)

    def append_ai_opening(self, round_idx, ids):
        ids.extend(self.tokenizer.encode("Assistant:"))


# chatllm.cpp deepseek::v1 Tokenizer::load regex set (models/deepseek.cpp:24-33),
# shared by the V2/V3 MLA family
DEEPSEEK_V1_REGEX = [
    "[\r\n]",
    "\\s?[A-Za-z\\u00B5\\u00C0-\\u00D6\\u00D8-\\u00F6\\u00F8-\\u01BA\\u01BC-\\u01BF\\u01C4-\\u0293\\u0295-\\u02AF\\u0370-\\u0373\\u0376\\u0377\\u037B-\\u037D\\u037F\\u0386\\u0388-\\u038A\\u038C\\u038E-\\u03A1\\u03A3-\\u03F5\\u03F7-\\u0481\\u048A-\\u052F\\u0531-\\u0556\\u10A0-\\u10C5\\u13A0-\\u13F5\\u13F8-\\u13FD\\u1C90-\\u1CBA\\u1CBD-\\u1CBF\\u1D00-\\u1D2B\\u1D6B-\\u1D77\\u1D79-\\u1D9A\\u1E00-\\u1F15\\u1F18-\\u1F1D\\u1F20-\\u1F45\\u1F48-\\u1F4D\\u1F50-\\u1F57\\u1F59\\u1F5B\\u1F5D\\u1F5F-\\u1F7D\\u1F80-\\u1FB4\\u1FB6-\\u1FBC\\u1FBE\\u1FC2-\\u1FC4\\u1FC6-\\u1FCC\\u1FD0-\\u1FD3\\u1FD6-\\u1FDB\\u1FE0-\\u1FEC\\u1FF2-\\u1FF4\\u1FF6-\\u1FFC\\u2102\\u2107\\u210A-\\u2113\\u2115\\u2119-\\u211D\\u2124\\u2126\\u2128\\u212A-\\u212D\\u212F-\\u2134\\u2139\\u213C-\\u213F\\u2145-\\u2149\\u214E\\u2183\\u2184\\u2C00-\\u2C7B\\u2C7E-\\u2CE4\\u2CEB-\\u2CEE\\u2CF2\\u2CF3\\uA640-\\uA66D\\uA680-\\uA69B\\uA722-\\uA76F\\uA771-\\uA787\\uA78B-\\uA78E\\uAB70-\\uABBF\\uFB00-\\uFB06\\uFB13-\\uFB17\\uFF21-\\uFF3A\\uFF41-\\uFF5A\\U00010400-\\U0001044F\\U000104B0-\\U000104D3\\U000104D8-\\U000104FB\\U00010C80-\\U00010CB2\\U00010CC0-\\U00010CF2\\U000118A0-\\U000118DF\\U0001E900-\\U0001E943]+",
    "\\s?[!-/:-~！-／：-～‘-‟　-。]+",
    "\\s+$",
    "[一-龥ࠀ-一가-퟿]+",
    "\\p{N}+",
]


def make_deepseek_v1_tokenizer(gf, base: BaseConfig) -> ChatTokenizer:
    """Byte BPE with merges (chatllm.cpp models/deepseek.cpp:22-36)."""
    tp = BPEProcessor2(DEEPSEEK_V1_REGEX)
    tp.load(gf.tokenizer_reader(), base.vocab_size)
    tok = ChatTokenizer(tp, DeepSeekV1Encoder(), sys_prompt="")
    tok.bos_token_id = base.bos_token_id
    tok.eos_token_id = base.eos_token_id
    tok.pad_token_id = base.pad_token_id
    return tok


@register_model(ModelType.DEEPSEEK)
class DeepSeekV1(BaseLLM):
    """The dense DeepSeek v1: a Llama-family block under the plain BaseConfig
    (chatllm.cpp models/deepseek.h:9-11)."""

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, _ = BaseConfig.parse(gf)
        cfg = build_dense_config(base, max_length=rt.max_length, norm_eps=1e-6,
                                 cache_dtype=rt.cache_dtype)
        tok = make_deepseek_v1_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = load_llama_family_params(pb, base.num_hidden_layers)
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.DEEPSEEK_V1_MoE)
class DeepSeekV1MoE(BaseLLM):
    # v1 config + {n_kv, first_k_dense, moe_inter, moe_layer_freq, n_routed,
    # n_shared, norm_topk, n_active} + rope_theta (chatllm.cpp
    # models/deepseek.h:83-95): softmax top-k with shared experts on the
    # layers from first_k_dense on, every moe_layer_freq-th
    EXTRA_FMT = "8if"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, extra = BaseConfig.parse(gf, cls.EXTRA_FMT)
        (n_kv, first_k_dense, moe_inter, moe_freq, n_routed, _n_shared,
         norm_topk, n_active, rope_theta) = extra
        n_layers = base.num_hidden_layers
        sparse = [i >= first_k_dense and i % max(moe_freq, 1) == 0 for i in range(n_layers)]
        cfg = build_dense_config(base, num_key_value_heads=n_kv, rope_theta=rope_theta,
                                 norm_eps=1e-6, max_length=rt.max_length,
                                 cache_dtype=rt.cache_dtype)
        cfg = replace(cfg, layer_specs=tuple(LayerSpec(is_moe=s) for s in sparse),
                      moe_num_experts=n_routed, moe_top_k=n_active,
                      moe_norm_topk_prob=bool(norm_topk), moe_intermediate_size=moe_inter)
        tok = make_deepseek_v1_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = load_llama_family_params(pb, n_layers, sparse=sparse, n_experts=n_routed,
                                          shared="shared_experts")
        return cls(gf.model_type, cfg, params, tok, device)


def yarn_get_mscale(scale: float, mscale: float) -> float:
    """chatllm.cpp models/deepseek.h:329."""
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_rope(qk_nope: int, qk_rope: int, rope_theta: float, factor: float, mscale: float,
              mscale_all: float, beta_fast: float, beta_slow: float,
              orig_max_pos: int) -> tuple[RopeConfig, float]:
    """The rope table over the qk_rope dims and the attention scale, with
    DeepSeek's YaRN when factor > 1: attn_factor = mscale(factor, mscale) /
    mscale(factor, mscale_all), scale = mscale(factor, mscale_all)^2 /
    sqrt(qk_nope + qk_rope)."""
    yarn = factor > 1.0
    m = yarn_get_mscale(factor, mscale) / yarn_get_mscale(factor, mscale_all) if yarn else 1.0
    mscale_ad = yarn_get_mscale(factor, mscale_all) if yarn else 1.0
    rope = RopeConfig(head_dim=qk_rope, rot_dim=qk_rope, freq_base=rope_theta,
                      freq_scale=1.0 / factor if yarn else 1.0, layout=ROPE_NORMAL,
                      ext_factor=1.0 if yarn else 0.0, attn_factor=m, beta_fast=beta_fast,
                      beta_slow=beta_slow, orig_ctx=orig_max_pos)
    return rope, mscale_ad * mscale_ad / (qk_nope + qk_rope) ** 0.5


def absorb_mla(attn: dict, cfg: TransformerConfig, dtype) -> dict:
    """The latent mode's absorbed up-projections, from the dense or
    dequantized u_k_nope / u_v in f32, then `dtype`: wk_abs [rank, h, nope],
    wv_abs [rank, h, dv]."""
    m, h = cfg.mla, cfg.num_attention_heads

    def dense(lin):
        return lin.w.float() if isinstance(lin, DenseLinear) else dequant_weight(lin, torch.float32)

    return {"wk_abs": dense(attn["u_k_nope"]).reshape(m.kv_lora_rank, h,
                                                      m.qk_nope_head_dim).to(dtype),
            "wv_abs": dense(attn["u_v"]).reshape(m.kv_lora_rank, h, m.v_head_dim).to(dtype)}


@register_model(ModelType.DEEPSEEK_V2_LIGHT, ModelType.DEEPSEEK_V2)
class DeepSeekV2(BaseLLM):
    """MLA + grouped MoE (chatllm.cpp models/deepseek.h:299-490)."""

    # v1 config + 14i (n_kv..v_head_dim) + 7f (beta_fast..routed_scaling)
    # [+ 2i q_lora_rank, topk_group for non-light files]
    EXTRA_FMT = "14i7f"
    SCORE_FUNC = "softmax"
    HAS_GATE_BIAS = False
    # "light" files carry no q_lora_rank / topk_group: V2-Lite and the
    # v3_light-derived types (the V3 converter writes the two ints only when
    # q_lora_rank is set; chatllm.cpp deepseek.h:513, moonshot.cpp:524).
    # KIMI_VL joins them with its model (M17).
    LIGHT = (ModelType.DEEPSEEK_V2_LIGHT, ModelType.DEEPSEEK_V3_LIGHT, ModelType.MOONLIGHT)

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        light = gf.model_type in [int(t) for t in cls.LIGHT]
        base, extra = BaseConfig.parse(gf, cls.EXTRA_FMT + ("" if light else "2i"))
        (_n_kv, first_k_dense, kv_lora_rank, moe_inter, moe_freq, n_group,
         n_routed, _n_shared, norm_topk, n_active, qk_nope, qk_rope,
         orig_max_pos, v_head_dim) = extra[:14]
        (beta_fast, beta_slow, factor, mscale, mscale_all, rope_theta,
         routed_scale) = extra[14:21]
        q_lora_rank, topk_group = (0, 1) if light else extra[21:23]
        n_layers = base.num_hidden_layers

        def is_moe(i):
            return i >= first_k_dense and i % max(moe_freq, 1) == 0

        rope, attn_scale = yarn_rope(qk_nope, qk_rope, rope_theta, factor, mscale, mscale_all,
                                     beta_fast, beta_slow, orig_max_pos)
        cfg = TransformerConfig(
            vocab_size=base.vocab_size, hidden_size=base.hidden_size,
            num_hidden_layers=n_layers, num_attention_heads=base.num_attention_heads,
            num_key_value_heads=base.num_attention_heads,
            intermediate_size=base.intermediate_size,
            max_length=rt.max_length if rt.max_length > 0 else base.max_length,
            norm_eps=1e-6, rope=rope, attention_scale=attn_scale,
            layer_specs=tuple(LayerSpec(is_moe=is_moe(i)) for i in range(n_layers)),
            moe_num_experts=n_routed, moe_top_k=n_active, moe_intermediate_size=moe_inter,
            moe_norm_topk_prob=bool(norm_topk), moe_n_group=max(1, n_group),
            moe_topk_group=max(1, topk_group), moe_routed_scale=routed_scale,
            moe_score_func=cls.SCORE_FUNC,
            mla=MLAConfig(q_lora_rank=q_lora_rank, kv_lora_rank=kv_lora_rank,
                          qk_nope_head_dim=qk_nope, qk_rope_head_dim=qk_rope,
                          v_head_dim=v_head_dim),
            mla_compressed=rt.mla_cache == "memory", cache_dtype=rt.cache_dtype)

        tok = make_deepseek_v1_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = {"embed": pb.embedding("model.embed_tokens.weight"),
                  "final_norm": pb.norm("model.norm"),
                  "lm_head": pb.linear("lm_head"),
                  "layers": []}
        for i in range(n_layers):
            pfx = f"model.layers.{i}"
            attn = {"d_kv": pb.linear(f"{pfx}.self_attn.d_kv_proj"),
                    "k_pe": pb.linear(f"{pfx}.self_attn.k_pe_proj"),
                    "kv_norm": pb.norm(f"{pfx}.self_attn.kv_norm"),
                    "u_k_nope": pb.linear(f"{pfx}.self_attn.u_k_nope_proj"),
                    "u_v": pb.linear(f"{pfx}.self_attn.u_v_proj"),
                    "o": pb.linear(f"{pfx}.self_attn.o_proj")}
            if cfg.mla_compressed:
                attn.update(absorb_mla(attn, cfg, pb.compute_dtype))
            if q_lora_rank > 0:
                attn["d_q"] = pb.linear(f"{pfx}.self_attn.d_q_proj")
                attn["q_norm"] = pb.norm(f"{pfx}.self_attn.q_norm")
                attn["u_q"] = pb.linear(f"{pfx}.self_attn.u_q_proj")
            else:
                attn["q"] = pb.linear(f"{pfx}.self_attn.q_proj")
            if is_moe(i):
                mlp = load_moe_mlp(pb, f"{pfx}.mlp", n_routed, "shared_experts")
                if cls.HAS_GATE_BIAS:
                    # V3's e_score_correction_bias: selects, does not weigh
                    mlp["gate_bias"] = pb.array(f"{pfx}.mlp.gate.e_score_correction_bias")
            else:
                mlp = {"gate": pb.linear(f"{pfx}.mlp.gate_proj"),
                       "up": pb.linear(f"{pfx}.mlp.up_proj"),
                       "down": pb.linear(f"{pfx}.mlp.down_proj")}
            params["layers"].append({"attn_norm": pb.norm(f"{pfx}.input_layernorm"),
                                     "attn": attn,
                                     "ffn_norm": pb.norm(f"{pfx}.post_attention_layernorm"),
                                     "mlp": mlp})
        params["layers"] = tuple(params["layers"])
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.DEEPSEEK_V3, ModelType.MOONLIGHT, ModelType.DEEPSEEK_V3_LIGHT)
class DeepSeekV3(DeepSeekV2):
    """DeepSeek-V3 and Moonlight: V2's MLA layout with sigmoid scores and the
    selection-only e_score_correction_bias (chatllm.cpp convert.py:8127)."""
    SCORE_FUNC = "sigmoid"
    HAS_GATE_BIAS = True
