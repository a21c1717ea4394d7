"""Phi family (counterpart of the JAX package's `models/phi.py`: PHI2 /
DOLPHINPHI2, PHI2_V2 / DOLPHINPHI2_V2, PHI3, PHI3_SU / SU2 / SU3, PHI4_MINI
and PHI4).

Phi-2 is a LayerNorm decoder with biases on every projection and on the
head, a parallel residual (attention and the plain GELU MLP both read the
same normed input) and NeoX rope on the first 32 of its 80 head dims.
Phi-3 and Phi-4 are llama-like blocks once the converter has split
qkv_proj / gate_up_proj and permuted q/k to the interleaved rope layout;
Phi-3-SU adds LongRoPE's per-dim factors (always the long ones, as the JAX
loader takes them) and their attention factor.  PHI3_MOE waits for
sparsemixer routing and quantized expert stacks (ROADMAP.md section 1), and
loading it fails naming its type.
"""
from __future__ import annotations

import math
from dataclasses import replace

from ..nn.transformer import TransformerConfig
from ..ops.rope import ROPE_NEOX, RopeConfig
from ..runtime.chat import ChatMLEncoder, ChatTokenizer, HistoryEncoder
from ..tokenizer.processor import BPEProcessor1, BPEProcessor2
from .base import (BaseConfig, BaseLLM, ParamBuilder, RuntimeConfig, load_llama_family_params,
                   register_model)
from .llama import build_dense_config
from .model_types import ModelType

MAX_FACTOR_LEN = 128  # LongRoPE factors stored per list (chatllm.cpp models/phi.h:189)


class Phi3Encoder(HistoryEncoder):
    """<|user|>\\n ... <|end|>\\n template (chatllm.cpp models/phi.cpp
    Phi3Tokenizer)."""

    add_bos = True

    def _msg(self, ids, text, type_tok, end_tok=True):
        tok = self.tokenizer
        if type_tok >= 0:
            ids.append(type_tok)
            if tok.nl_token_id >= 0:
                ids.append(tok.nl_token_id)
        ids.extend(tok.encode(text))
        if end_tok:
            ids.append(tok.end_token_id)
            ids.append(tok.nl_token_id)

    def append_sys_prompt(self, ids):
        tok = self.tokenizer
        if self.add_bos and tok.bos_token_id >= 0:
            ids.append(tok.bos_token_id)
        if tok.sys_prompt:
            self._msg(ids, tok.sys_prompt, tok.system_token_id)

    def append_user(self, round_idx, user, ids):
        self._msg(ids, user, self.tokenizer.user_token_id)

    def append_ai(self, round_idx, ai, ids):
        self.append_ai_opening(round_idx, ids)
        tok = self.tokenizer
        ids.extend(tok.encode(ai))
        ids.append(tok.end_token_id)
        ids.append(tok.nl_token_id)

    def append_ai_opening(self, round_idx, ids):
        tok = self.tokenizer
        ids.append(tok.assistant_token_id)
        if tok.nl_token_id >= 0:
            ids.append(tok.nl_token_id)


def make_phi3_tokenizer(gf, base: BaseConfig) -> ChatTokenizer:
    """SentencePiece-score vocab (BPEProcessor1) + the Phi-3 template; a
    32000-piece vocab without the role pieces takes Phi-3's fixed ids."""
    tp = BPEProcessor1()
    tp.load(gf.tokenizer_reader(), base.vocab_size)
    tok = ChatTokenizer(tp, Phi3Encoder(), sys_prompt="")
    tok.bos_token_id = base.bos_token_id
    tok.eos_token_id = base.eos_token_id
    tok.system_token_id = tp.piece_to_id("<|system|>")
    tok.user_token_id = tp.piece_to_id("<|user|>")
    tok.assistant_token_id = tp.piece_to_id("<|assistant|>")
    tok.end_token_id = tp.piece_to_id("<|end|>")
    tok.nl_token_id = tp.piece_to_id("\n")
    if tok.system_token_id < 0 and tp.get_piece_size() == 32000:
        tok.system_token_id, tok.user_token_id = 32006, 32010
        tok.assistant_token_id, tok.end_token_id = 32001, 32007
    tok.pad_token_id = tok.eos_token_id
    if tok.end_token_id >= 0:
        tok.terminate_ids.add(tok.end_token_id)
    tok.is_special_id = lambda i: i in (tok.system_token_id, tok.user_token_id,
                                        tok.assistant_token_id, tok.end_token_id)
    return tok


def _phi2_config(base: BaseConfig, rt: RuntimeConfig, rot_dim: int,
                 rope_theta: float) -> TransformerConfig:
    """Phi-2's blocks: LayerNorm with biases, NeoX rope on `rot_dim` of each
    head, biased projections, the GELU-tanh MLP, a parallel residual."""
    return TransformerConfig(
        vocab_size=base.vocab_size, hidden_size=base.hidden_size,
        num_hidden_layers=base.num_hidden_layers,
        num_attention_heads=base.num_attention_heads,
        num_key_value_heads=base.num_attention_heads,
        intermediate_size=base.intermediate_size,
        max_length=rt.max_length if rt.max_length > 0 else base.max_length,
        act="gelu_tanh", norm_type="layernorm", norm_eps=1e-5,
        rope=RopeConfig(head_dim=base.hidden_size // base.num_attention_heads,
                        rot_dim=rot_dim, freq_base=rope_theta, layout=ROPE_NEOX),
        qkv_bias=True, o_bias=True, parallel_residual=True,
        cache_dtype=rt.cache_dtype)


def _phi2_params(pb: ParamBuilder, n_layers: int, names: dict) -> dict:
    """Phi-2's weight map; `names` gives each part's tensor prefix (the v2
    HF names or the v1 GPT-style ones), `{i}` the layer."""
    params = {"embed": pb.embedding(names["embed"]), "final_norm": pb.norm(names["final_norm"]),
              "lm_head": pb.linear(names["lm_head"]), "layers": []}
    for i in range(n_layers):
        pfx = names["layer"].format(i=i)
        params["layers"].append({
            "attn_norm": pb.norm(f"{pfx}.{names['norm']}"),
            "attn": {k: pb.linear(f"{pfx}.{names['attn']}.{n}")
                     for k, n in zip("qkvo", ("q_proj", "k_proj", "v_proj", names["o"]))},
            "mlp": {"up": pb.linear(f"{pfx}.mlp.fc1"), "down": pb.linear(f"{pfx}.mlp.fc2")},
        })
    params["layers"] = tuple(params["layers"])
    return params


PHI2_V2_NAMES = {"embed": "model.embed_tokens.weight", "final_norm": "model.final_layernorm",
                 "lm_head": "lm_head", "layer": "model.layers.{i}", "norm": "input_layernorm",
                 "attn": "self_attn", "o": "dense"}
PHI2_V1_NAMES = {"embed": "transformer.embd.wte.weight", "final_norm": "lm_head.ln",
                 "lm_head": "lm_head.linear", "layer": "transformer.h.{i}", "norm": "ln",
                 "attn": "mixer", "o": "out_proj"}


@register_model(ModelType.PHI2_V2, ModelType.DOLPHINPHI2_V2)
class Phi2(BaseLLM):
    """Phi-2 in HF-format names (chatllm.cpp models/phi.h v2 namespace), with
    no chat template (the whole prompt is the last message)."""
    # BaseConfig + rope_dim + rope_theta (models/phi.h:85-89)
    EXTRA_FMT = "if"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, (rope_dim, rope_theta) = BaseConfig.parse(gf, cls.EXTRA_FMT)
        cfg = _phi2_config(base, rt, rope_dim, rope_theta)
        tp = BPEProcessor2()
        tp.load(gf.tokenizer_reader(), base.vocab_size)
        tok = ChatTokenizer(tp, None, sys_prompt="")
        tok.bos_token_id = base.bos_token_id
        tok.eos_token_id = base.eos_token_id
        params = _phi2_params(ParamBuilder(gf, rt, device), base.num_hidden_layers,
                              PHI2_V2_NAMES)
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.PHI2, ModelType.DOLPHINPHI2)
class Phi2V1(BaseLLM):
    """The Phi-2 v1 file layout (models/phi.h v1 namespace): v2's blocks
    under GPT-style names (transformer.h.{i}.mixer.* / lm_head.ln) and a
    fixed rotary_dim of 32; Dolphin-Phi-2 chats in ChatML."""

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, _ = BaseConfig.parse(gf)
        cfg = _phi2_config(base, rt, 32, 10000.0)
        tp = BPEProcessor2()
        tp.load(gf.tokenizer_reader(), base.vocab_size)
        is_dolphin = gf.model_type == int(ModelType.DOLPHINPHI2)
        tok = ChatTokenizer(tp, ChatMLEncoder() if is_dolphin else None,
                            sys_prompt="You are Dolphin, a helpful AI assistant."
                            if is_dolphin else "")
        tok.bos_token_id = base.bos_token_id
        tok.eos_token_id = base.eos_token_id
        if is_dolphin:
            tok.im_start_token_id = tp.piece_to_id("<|im_start|>")
            tok.im_end_token_id = tp.piece_to_id("<|im_end|>")
            if tok.im_end_token_id >= 0:
                tok.terminate_ids.add(tok.im_end_token_id)
        params = _phi2_params(ParamBuilder(gf, rt, device), base.num_hidden_layers,
                              PHI2_V1_NAMES)
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.PHI3)
class Phi3(BaseLLM):
    # BaseConfig + {n_kv, orig_max_pos, sliding_window} + rope_theta
    # (models/phi.h:110-116); the window counts the query's own key
    EXTRA_FMT = "3if"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, (n_kv, _orig_max, sliding_window, rope_theta) = BaseConfig.parse(
            gf, cls.EXTRA_FMT)
        cfg = build_dense_config(
            base, num_key_value_heads=n_kv, rope_theta=rope_theta,
            sliding_window=max(0, sliding_window + 1),
            max_length=rt.max_length, cache_dtype=rt.cache_dtype)
        tok = make_phi3_tokenizer(gf, base)
        params = load_llama_family_params(ParamBuilder(gf, rt, device), base.num_hidden_layers)
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.PHI3_SU, ModelType.PHI3_SU2, ModelType.PHI3_SU3,
                ModelType.PHI4_MINI)
class Phi3SU(BaseLLM):
    """Phi-3 with SU (LongRoPE) per-dim factors (models/phi.h:191-201): the
    long factors of the first rot / 2 dims, and the attention factor
    `mscale` (SU3 and PHI4_MINI store it; else sqrt(1 + ln(scale) /
    ln(original context)))."""

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        # {max_position_embeddings, n_kv, original_max_pos, sliding_window,
        # rope_scaling} i + rope_theta f + short_factor[128] + long_factor[128]
        fmt = "5if" + f"{MAX_FACTOR_LEN}f{MAX_FACTOR_LEN}f"
        if gf.model_type in (ModelType.PHI3_SU3, ModelType.PHI4_MINI):
            fmt += "ff"   # short_mscale, long_mscale (models/phi.h:230-234)
        base, extra = BaseConfig.parse(gf, fmt)
        max_pos, n_kv, orig_max, sliding_window, _rope_scaling = extra[:5]
        rope_theta = float(extra[5])
        long_factor = extra[6 + MAX_FACTOR_LEN:6 + 2 * MAX_FACTOR_LEN]
        half = base.hidden_size // base.num_attention_heads // 2
        ff = tuple(float(f) for f in long_factor[:half])
        scale = max_pos / max(orig_max, 1)
        if len(extra) > 6 + 2 * MAX_FACTOR_LEN:
            mscale = float(extra[6 + 2 * MAX_FACTOR_LEN + 1])     # long_mscale
        else:
            mscale = (1.0 if scale <= 1.0
                      else math.sqrt(1.0 + math.log(scale) / math.log(max(orig_max, 2))))
        cfg = build_dense_config(
            base, num_key_value_heads=n_kv, rope_theta=rope_theta,
            freq_factors=ff, sliding_window=max(0, sliding_window + 1),
            max_length=rt.max_length, cache_dtype=rt.cache_dtype)
        cfg = replace(cfg, rope=replace(cfg.rope, mscale_all=mscale))
        tok = make_phi3_tokenizer(gf, base)
        params = load_llama_family_params(ParamBuilder(gf, rt, device), base.num_hidden_layers)
        return cls(gf.model_type, cfg, params, tok, device)


class Phi4Encoder(HistoryEncoder):
    """<|im_start|>{role}<|im_sep|>{content}<|im_end|> (chatllm.cpp
    models/phi.cpp v4 ChatHistoryEncoder:536-570)."""

    def _role(self, role, ids):
        tok = self.tokenizer
        ids.append(tok.im_start_token_id)
        ids.extend(tok.encode(role))
        ids.append(tok.im_sep_token_id)

    def append_sys_prompt(self, ids):
        tok = self.tokenizer
        if tok.sys_prompt:
            self._role("system", ids)
            ids.extend(tok.encode(tok.sys_prompt))
            ids.append(tok.im_end_token_id)

    def append_user(self, round_idx, user, ids):
        self._role("user", ids)
        ids.extend(self.tokenizer.encode(user))
        ids.append(self.tokenizer.im_end_token_id)

    def append_ai(self, round_idx, ai, ids):
        self.append_ai_opening(round_idx, ids)
        ids.extend(self.tokenizer.encode(ai))
        ids.append(self.tokenizer.im_end_token_id)

    def append_ai_opening(self, round_idx, ids):
        self._role("assistant", ids)


def make_phi4_tokenizer(gf, base: BaseConfig) -> ChatTokenizer:
    tp = BPEProcessor2()
    tp.load(gf.tokenizer_reader(), base.vocab_size)
    tp.enable_return_special_token(True)
    tok = ChatTokenizer(tp, Phi4Encoder(), sys_prompt="")
    tok.bos_token_id = base.bos_token_id
    tok.eos_token_id = base.eos_token_id
    tok.pad_token_id = base.eos_token_id
    tok.im_start_token_id = tp.piece_to_id("<|im_start|>")
    tok.im_sep_token_id = tp.piece_to_id("<|im_sep|>")
    tok.im_end_token_id = tp.piece_to_id("<|im_end|>")
    if tok.im_end_token_id >= 0:
        tok.terminate_ids.add(tok.im_end_token_id)
    return tok


@register_model(ModelType.PHI4)
class Phi4(BaseLLM):
    """Phi-4: the Llama-3 blocks and config + the ChatML-with-<|im_sep|>
    template (chatllm.cpp models/phi.cpp v4:492-573)."""
    EXTRA_FMT = "if"    # n_kv, rope_theta (the llama v3 config, models/llama.h:103)

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, (n_kv, rope_theta) = BaseConfig.parse(gf, cls.EXTRA_FMT)
        cfg = build_dense_config(base, num_key_value_heads=n_kv, rope_theta=rope_theta,
                                 max_length=rt.max_length, cache_dtype=rt.cache_dtype)
        tok = make_phi4_tokenizer(gf, base)
        params = load_llama_family_params(ParamBuilder(gf, rt, device), base.num_hidden_layers)
        return cls(gf.model_type, cfg, params, tok, device)
