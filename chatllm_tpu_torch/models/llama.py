"""Llama family (counterpart of the JAX package's `models/llama.py`, LLAMA2,
LLAMA3, LLAMA3_1, LLAMA3_2 and DEEPSEEK_R1_DISTILL_LLAMA, and of CODELLAMA
from its `models/aliases.py`).

On-disk note: the converter permutes q/k projection rows into ggml's
interleaved rope layout, so RoPE uses the interleaved ("normal") layout and
weights load unmodified.
"""
from __future__ import annotations

import math

from ..nn.transformer import LayerSpec, TransformerConfig
from ..ops.rope import ROPE_NORMAL, RopeConfig
from ..runtime.chat import ChatTokenizer, HistoryEncoder
from ..tokenizer.processor import BPEProcessor1, BPEProcessor2
from .base import (BaseConfig, BaseLLM, ParamBuilder, RuntimeConfig,
                   load_llama_family_params, register_model)
from .model_types import ModelType

LLAMA3_REGEX = [
    r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
]

DEFAULT_V2_SYS_PROMPT = (
    "You are a helpful, respectful and honest assistant. Always answer as "
    "helpfully as possible, while being safe.  Your answers should not include"
    " any harmful, unethical, racist, sexist, toxic, dangerous, or illegal "
    "content. Please ensure that your responses are socially unbiased and "
    "positive in nature.\n\nIf a question does not make any sense, or is not "
    "factually coherent, explain why instead of answering something not "
    "correct. If you don't know the answer to a question, please don't share "
    "false information.")


class Llama2Encoder(HistoryEncoder):
    """[INST] ... [/INST] template (chatllm.cpp models/llama.cpp:53-85)."""

    def append_sys_prompt(self, ids):
        tok = self.tokenizer
        if tok.sys_prompt:
            ids.append(tok.bos_token_id)
            ids.extend(tok.encode(f"<<SYS>>\n{tok.sys_prompt}\n<</SYS>>\n\n"))

    def append_user(self, round_idx, user, ids):
        tok = self.tokenizer
        ids.append(tok.bos_token_id)
        ids.extend(tok.encode(f"[INST] {user}[/INST] "))

    def append_ai(self, round_idx, ai, ids):
        tok = self.tokenizer
        ids.extend(tok.encode(ai))
        ids.append(tok.eos_token_id)

    def append_ai_opening(self, round_idx, ids):
        pass


class Llama3Encoder(HistoryEncoder):
    """<|start_header_id|>role<|end_header_id|> template
    (chatllm.cpp models/llama.cpp:143-215)."""

    def _header(self, role, ids):
        tok = self.tokenizer
        if tok.start_header_id >= 0:
            ids.append(tok.start_header_id)
            ids.extend(tok.encode(role))
            ids.append(tok.end_header_id)
            ids.append(tok.nl_token_id)
        else:
            ids.append(tok.bos_token_id)
            ids.extend(tok.encode(role))
            ids.append(tok.nl_token_id)

    def _content(self, text, ids):
        tok = self.tokenizer
        ids.extend(tok.encode(text))
        ids.append(tok.eot_id if tok.eot_id >= 0 else tok.eos_token_id)

    def append_sys_prompt(self, ids):
        tok = self.tokenizer
        ids.append(tok.bos_token_id)
        if tok.sys_prompt:
            self._header("system", ids)
            self._content(tok.sys_prompt, ids)

    def append_user(self, round_idx, user, ids):
        self._header("user", ids)
        self._content(user, ids)

    def append_ai(self, round_idx, ai, ids):
        self.append_ai_opening(round_idx, ids)
        ids.extend(self.tokenizer.encode(ai))
        ids.append(self.tokenizer.eot_id)

    def append_ai_opening(self, round_idx, ids):
        self._header("assistant", ids)

    def append_user_opening(self, round_idx, ids):
        self._header("user", ids)

    def append_tool(self, round_idx, content, ids):
        self._header("ipython", ids)
        self._content(content, ids)


def make_llama2_tokenizer(gf, base: BaseConfig) -> ChatTokenizer:
    tp = BPEProcessor1()
    tp.load(gf.tokenizer_reader(), base.vocab_size)
    tok = ChatTokenizer(tp, Llama2Encoder(), sys_prompt=DEFAULT_V2_SYS_PROMPT)
    tok.bos_token_id = base.bos_token_id
    tok.eos_token_id = base.eos_token_id
    tok.pad_token_id = tp.piece_to_id("<pad>")
    return tok


def make_llama3_tokenizer(gf, base: BaseConfig) -> ChatTokenizer:
    tp = BPEProcessor2(LLAMA3_REGEX)
    tp.load(gf.tokenizer_reader(), base.vocab_size)
    tok = ChatTokenizer(tp, Llama3Encoder(), sys_prompt="")
    tok.bos_token_id = base.bos_token_id
    tok.eos_token_id = base.eos_token_id
    tok.start_header_id = tp.piece_to_id("<|start_header_id|>")
    tok.end_header_id = tp.piece_to_id("<|end_header_id|>")
    tok.eot_id = tp.piece_to_id("<|eot_id|>")
    tok.nl_token_id = tp.encode("\n")[0]
    if tok.eot_id >= 0:
        tok.terminate_ids.add(tok.eot_id)
    tok.is_special_id = lambda i: i in (tok.start_header_id, tok.end_header_id, tok.eot_id)
    return tok


def _llama31_factors(rot: int, base: float, factor: float, low_f: float,
                     high_f: float, orig_ctx: int) -> tuple:
    """Llama-3.1 'llama3' rope scaling as per-dim frequency divisors
    (inv_freq / factor_i); same formula as HF `_compute_llama3_parameters`."""
    factors = []
    low_wavelen = orig_ctx / low_f
    high_wavelen = orig_ctx / high_f
    for i in range(rot // 2):
        freq = base ** (-2.0 * i / rot)
        wavelen = 2.0 * math.pi / freq
        if wavelen < high_wavelen:
            factors.append(1.0)
        elif wavelen > low_wavelen:
            factors.append(factor)
        else:
            smooth = (orig_ctx / wavelen - low_f) / (high_f - low_f)
            factors.append(1.0 / ((1.0 - smooth) / factor + smooth))
    return tuple(factors)


def build_dense_config(base: BaseConfig, *, num_key_value_heads=None,
                       rope_theta=10000.0, rope_layout=ROPE_NORMAL,
                       head_dim=-1, tie_lm_head=False, norm_eps=1e-5,
                       freq_factors=None, qkv_bias=False, max_length=-1,
                       sliding_window=0, cache_dtype="bfloat16") -> TransformerConfig:
    """The llama-family config; `sliding_window` > 0 gives every layer that
    window (Mistral), whose cache is then a ring when window + SWA_EXTRA is
    shorter than the context (nn/transformer.py)."""
    rope = RopeConfig(
        head_dim=(head_dim if head_dim > 0 else base.hidden_size // base.num_attention_heads),
        freq_base=rope_theta, layout=rope_layout, freq_factors=freq_factors)
    specs = ()
    if sliding_window > 0:
        specs = tuple(LayerSpec(sliding_window=sliding_window)
                      for _ in range(base.num_hidden_layers))
    return TransformerConfig(
        vocab_size=base.vocab_size,
        hidden_size=base.hidden_size,
        num_hidden_layers=base.num_hidden_layers,
        num_attention_heads=base.num_attention_heads,
        num_key_value_heads=num_key_value_heads or base.num_attention_heads,
        intermediate_size=base.intermediate_size,
        max_length=max_length if max_length > 0 else base.max_length,
        head_dim=head_dim,
        norm_eps=norm_eps,
        rope=rope,
        qkv_bias=qkv_bias,
        tie_lm_head=tie_lm_head,
        layer_specs=specs,
        cache_dtype=cache_dtype,
    )


@register_model(ModelType.LLAMA2)
class Llama2(BaseLLM):
    EXTRA_FMT = ""      # the BaseConfig alone: rope theta 10000, kv heads = heads

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, extra = BaseConfig.parse(gf, cls.EXTRA_FMT)
        cfg = build_dense_config(base, rope_theta=extra[0] if extra else 10000.0,
                                 max_length=rt.max_length, cache_dtype=rt.cache_dtype)
        tok = make_llama2_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = load_llama_family_params(pb, base.num_hidden_layers)
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.CODELLAMA)
class CodeLlama(Llama2):
    """Llama-2 with the file's rope theta (CodeLlama's 1e6; chatllm.cpp
    models/codellama.h:5-8): the JAX package's CODELLAMA loader is
    `models/aliases.py::CodeLlama`, whose registration replaces the one in
    its `models/llama.py`."""
    EXTRA_FMT = "f"


@register_model(ModelType.LLAMA3, ModelType.LLAMA3_GROQ_TOOL)
class Llama3(BaseLLM):
    EXTRA_FMT = "if"   # num_key_value_heads, rope_theta (models/llama.h:103)

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, (n_kv, rope_theta) = BaseConfig.parse(gf, cls.EXTRA_FMT)
        cfg = build_dense_config(base, num_key_value_heads=n_kv,
                                 rope_theta=rope_theta, max_length=rt.max_length,
                                 cache_dtype=rt.cache_dtype)
        tok = make_llama3_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = load_llama_family_params(pb, base.num_hidden_layers)
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.LLAMA3_1)
class Llama31(BaseLLM):
    # v3 config + rope_scaling {orig_max_pos, factor, low_freq, high_freq}
    # (models/llama.h:154-160)
    EXTRA_FMT = "ififff"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, extra = BaseConfig.parse(gf, cls.EXTRA_FMT)
        n_kv, rope_theta, orig_ctx, factor, low_f, high_f = extra
        rot = base.hidden_size // base.num_attention_heads
        ff = _llama31_factors(rot, rope_theta, factor, low_f, high_f, orig_ctx)
        cfg = build_dense_config(base, num_key_value_heads=n_kv,
                                 rope_theta=rope_theta, freq_factors=ff,
                                 max_length=rt.max_length, cache_dtype=rt.cache_dtype)
        tok = make_llama3_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = load_llama_family_params(pb, base.num_hidden_layers)
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.LLAMA3_2)
class Llama32(BaseLLM):
    # v3_1 fields + tie_word_embeddings (chatllm.cpp models/llama.h:211-214)
    EXTRA_FMT = "ififffi"

    @classmethod
    def make_tokenizer(cls, gf, base):
        return make_llama3_tokenizer(gf, base)

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, extra = BaseConfig.parse(gf, cls.EXTRA_FMT)
        n_kv, rope_theta, orig_ctx, factor, low_f, high_f, tie_flag = extra
        rot = base.hidden_size // base.num_attention_heads
        ff = _llama31_factors(rot, rope_theta, factor, low_f, high_f, orig_ctx)
        tie = bool(tie_flag) or not gf.has_tensor("lm_head.weight")
        cfg = build_dense_config(base, num_key_value_heads=n_kv,
                                 rope_theta=rope_theta, freq_factors=ff,
                                 tie_lm_head=tie, max_length=rt.max_length,
                                 cache_dtype=rt.cache_dtype)
        tok = cls.make_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = load_llama_family_params(pb, base.num_hidden_layers, tie_lm_head=tie)
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.DEEPSEEK_R1_DISTILL_LLAMA)
class DSR1DistillLlama(Llama32):
    """DeepSeek-R1-Distill-Llama: the Llama-3.2 config with the DeepSeek-R1
    tokenizer and chat template (chatllm.cpp llama.cpp ds_r1_distill:611-700)."""

    @classmethod
    def make_tokenizer(cls, gf, base):
        from .qwen import make_ds_r1_tokenizer

        return make_ds_r1_tokenizer(gf, base, llama=True)
