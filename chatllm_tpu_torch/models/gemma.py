"""Gemma family (counterpart of the JAX package's `models/gemma.py`: GEMMA,
GEMMA2 and GEMMA3).

The converter bakes Gemma's quirks into the file (chatllm.cpp convert.py
GemmaConverter): embeddings times sqrt(hidden), norm weights stored as
1 + w, Gemma-1/2's q/k permuted to the interleaved ("normal") rope layout.
So loading is llama-like, with gated GELU (tanh) MLPs and a tied head whose
logits are scaled back by 1/sqrt(hidden).  Gemma-2 adds the sandwich norms,
the attention and final logit softcaps and a sliding window on its even
layers; Gemma-3 the per-head q/k RMS norms, a 5:1 pattern of sliding and
global layers whose sliding ones rotate by a second rope table, and NeoX
rope.  Most Gemma models have head_dim 256, which K3 and K4 take.
GEMMA3Vis waits for the SigLIP tower (ROADMAP.md section 1, M17).
"""
from __future__ import annotations

from ..nn.transformer import LayerSpec, TransformerConfig
from ..ops.rope import ROPE_NEOX, ROPE_NORMAL, RopeConfig
from ..runtime.chat import ChatTokenizer, HistoryEncoder
from ..tokenizer.processor import BPEProcessor1
from .base import (BaseConfig, BaseLLM, ParamBuilder, RuntimeConfig,
                   load_llama_family_params, register_model)
from .model_types import ModelType


class GemmaEncoder(HistoryEncoder):
    """<start_of_turn>user\\n...<end_of_turn>\\n (chatllm.cpp models/gemma.cpp v1)."""

    def _turn(self, role, text, ids, close=True):
        tok = self.tokenizer
        ids.append(tok.start_of_turn_token_id)
        ids.extend(tok.encode(f"{role}\n{text}" if text else f"{role}\n"))
        if close:
            ids.append(tok.end_of_turn_token_id)
            ids.extend(tok.encode("\n"))

    def append_sys_prompt(self, ids):
        if self.tokenizer.bos_token_id >= 0:
            ids.append(self.tokenizer.bos_token_id)

    def append_user(self, round_idx, user, ids):
        sys = self.tokenizer.sys_prompt
        self._turn("user", f"{sys}\n\n{user}" if sys and round_idx == 0 else user, ids)

    def append_ai(self, round_idx, ai, ids):
        self._turn("model", ai, ids)

    def append_ai_opening(self, round_idx, ids):
        self._turn("model", "", ids, close=False)


def make_gemma_tokenizer(gf, base: BaseConfig) -> ChatTokenizer:
    """SentencePiece-score vocab (BPEProcessor1), <end_of_turn> terminates."""
    tp = BPEProcessor1()
    tp.load(gf.tokenizer_reader(), base.vocab_size)
    tok = ChatTokenizer(tp, GemmaEncoder(), sys_prompt="")
    tok.bos_token_id = base.bos_token_id
    tok.eos_token_id = base.eos_token_id
    pad = tp.piece_to_id("<pad>")
    tok.pad_token_id = pad if pad >= 0 else base.pad_token_id
    tok.start_of_turn_token_id = tp.piece_to_id("<start_of_turn>")
    tok.end_of_turn_token_id = tp.piece_to_id("<end_of_turn>")
    tok.terminate_ids.add(tok.end_of_turn_token_id)
    tok.is_special_id = lambda i: i in (tok.pad_token_id, tok.start_of_turn_token_id,
                                        tok.end_of_turn_token_id)
    return tok


def _gemma_config(base: BaseConfig, rt: RuntimeConfig, *, n_kv: int, head_dim: int,
                  rope: RopeConfig, **kw) -> TransformerConfig:
    """What every Gemma shares: gated GELU (tanh), RMS eps 1e-6, the tied
    head scaled by 1/sqrt(hidden) (the converter bakes sqrt(hidden) into the
    embedding, which the unembedding must not carry)."""
    return TransformerConfig(
        vocab_size=base.vocab_size, hidden_size=base.hidden_size,
        num_hidden_layers=base.num_hidden_layers,
        num_attention_heads=base.num_attention_heads, num_key_value_heads=n_kv,
        intermediate_size=base.intermediate_size,
        max_length=rt.max_length if rt.max_length > 0 else base.max_length,
        head_dim=head_dim, act="gelu_tanh", norm_eps=1e-6, rope=rope, tie_lm_head=True,
        logit_scale=base.hidden_size ** -0.5, cache_dtype=rt.cache_dtype, **kw)


def load_sandwich_params(pb: ParamBuilder, n_layers: int, *, qk_norm: bool) -> dict:
    """Gemma-2/3's weights: pre- and post-norms around attention and the
    FFN (converter names input / post_attention / pre_feedforward /
    post_feedforward_layernorm), Gemma-3's q / k norms, no lm_head."""
    params = {
        "embed": pb.embedding("model.embed_tokens.weight"),
        "final_norm": pb.norm("model.norm"),
        "layers": [],
    }
    for i in range(n_layers):
        pfx = f"model.layers.{i}"
        attn = {n: pb.linear(f"{pfx}.self_attn.{n}_proj") for n in "qkvo"}
        if qk_norm:
            attn["q_norm"] = pb.norm(f"{pfx}.self_attn.q_norm")
            attn["k_norm"] = pb.norm(f"{pfx}.self_attn.k_norm")
        params["layers"].append({
            "attn_norm": pb.norm(f"{pfx}.input_layernorm"),
            "attn": attn,
            "post_attn_norm": pb.norm(f"{pfx}.post_attention_layernorm"),
            "ffn_norm": pb.norm(f"{pfx}.pre_feedforward_layernorm"),
            "post_ffn_norm": pb.norm(f"{pfx}.post_feedforward_layernorm"),
            "mlp": {n: pb.linear(f"{pfx}.mlp.{n}_proj") for n in ("gate", "up", "down")},
        })
    params["layers"] = tuple(params["layers"])
    return params


@register_model(ModelType.GEMMA)
class Gemma(BaseLLM):
    # BaseConfig + {num_key_value_heads, head_dim} + rope_theta
    # (chatllm.cpp models/gemma.h:9-14)
    EXTRA_FMT = "2if"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, (n_kv, head_dim, rope_theta) = BaseConfig.parse(gf, cls.EXTRA_FMT)
        cfg = _gemma_config(base, rt, n_kv=n_kv, head_dim=head_dim,
                            rope=RopeConfig(head_dim=head_dim, freq_base=rope_theta,
                                            layout=ROPE_NORMAL))
        tok = make_gemma_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = load_llama_family_params(pb, base.num_hidden_layers, tie_lm_head=True)
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.GEMMA2)
class Gemma2(BaseLLM):
    # BaseConfig + {n_kv, head_dim, query_pre_attn_scalar, sliding_window}
    # + {rope_theta, final_softcap, attn_softcap} (chatllm.cpp models/gemma.h:59-69)
    EXTRA_FMT = "4i3f"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, extra = BaseConfig.parse(gf, cls.EXTRA_FMT)
        (n_kv, head_dim, query_pre_attn_scalar, sliding_window,
         rope_theta, final_softcap, attn_softcap) = extra
        # the even layers slide (HF Gemma2Config.layer_types, as the JAX
        # package reads it: chatllm.cpp's `layer_id % 2` has the parity inverted)
        specs = tuple(LayerSpec(sliding_window=sliding_window if i % 2 == 0 else 0)
                      for i in range(base.num_hidden_layers))
        cfg = _gemma_config(
            base, rt, n_kv=n_kv, head_dim=head_dim,
            rope=RopeConfig(head_dim=head_dim, freq_base=rope_theta, layout=ROPE_NORMAL),
            attention_scale=float(query_pre_attn_scalar) ** -0.5,
            logit_softcap=attn_softcap, final_logit_softcap=final_softcap,
            post_norms=True, layer_specs=specs)
        tok = make_gemma_tokenizer(gf, base)
        params = load_sandwich_params(ParamBuilder(gf, rt, device), base.num_hidden_layers,
                                      qk_norm=False)
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.GEMMA3)
class Gemma3(BaseLLM):
    """Gemma-3 text (chatllm.cpp models/gemma.h:255-266): qk-norm, layer i
    global iff (i + 1) % sliding_window_pattern == 0 (models/gemma.cpp:833),
    the sliding layers on the local rope table (base rope_local_base, no
    scaling), the global ones on rope_theta with linear rope_factor;
    sandwich norms; no softcaps; no q/k permutation, so NeoX rope."""

    # BaseConfig + {n_kv, head_dim, query_pre_attn_scalar, sliding_window,
    # sliding_window_pattern} + {rope_local_base, rope_theta, rope_factor}
    EXTRA_FMT = "5i3f"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, extra = BaseConfig.parse(gf, cls.EXTRA_FMT)
        (n_kv, head_dim, query_pre_attn_scalar, sliding_window, swa_pattern,
         rope_local_base, rope_theta, rope_factor) = extra[:8]
        specs = tuple(
            LayerSpec(sliding_window=sliding_window, local_rope=True)
            if (i + 1) % max(swa_pattern, 1) != 0 else LayerSpec()
            for i in range(base.num_hidden_layers))
        cfg = _gemma_config(
            base, rt, n_kv=n_kv, head_dim=head_dim,
            rope=RopeConfig(head_dim=head_dim, freq_base=rope_theta,
                            freq_scale=1.0 / rope_factor if rope_factor > 0 else 1.0,
                            layout=ROPE_NEOX),
            rope_local=RopeConfig(head_dim=head_dim, freq_base=rope_local_base,
                                  layout=ROPE_NEOX),
            attention_scale=float(query_pre_attn_scalar) ** -0.5, qk_norm="rmsnorm",
            post_norms=True, layer_specs=specs)
        tok = make_gemma_tokenizer(gf, base)
        params = load_sandwich_params(ParamBuilder(gf, rt, device), base.num_hidden_layers,
                                      qk_norm=True)
        return cls(gf.model_type, cfg, params, tok, device)
