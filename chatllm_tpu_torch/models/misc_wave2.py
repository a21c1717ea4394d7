"""Models of the JAX package's `models/misc_wave2.py` that run on blocks the
port has: RNJ_1 so far (Gemma-3 with YaRN and both logit softcaps).  The
file's other types (Reka, JiuTian, ...) come with their families.
"""
from __future__ import annotations

from dataclasses import replace

from .base import BaseConfig, BaseLLM, RuntimeConfig, register_model
from .gemma import Gemma3
from .model_types import ModelType


@register_model(ModelType.RNJ_1)
class RNJ1(BaseLLM):
    """RNJ-1 (Essential AI): the Gemma-3 architecture, YaRN on the global
    rope table and the attention / final logit softcaps (chatllm.cpp
    models/rnj.cpp)."""
    # Gemma-3's "5i3f" + {attn_factor, beta_fast, beta_slow,
    # extrapolation_factor, factor} 5f + orig_max i + {final_cap, attn_cap} 2f
    EXTRA_FMT = "5i3f5fi2f"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        _, extra = BaseConfig.parse(gf, cls.EXTRA_FMT)
        attn_factor, beta_fast, beta_slow, ext_factor, factor = extra[8:13]
        orig_max = extra[13]
        final_cap, attn_cap = extra[14:16]
        model = Gemma3.load(gf, rt, device)
        cfg = model.cfg
        if factor > 1.0 and orig_max > 0:
            cfg = replace(cfg, rope=replace(
                cfg.rope, freq_scale=1.0 / factor, ext_factor=ext_factor,
                attn_factor=attn_factor, beta_fast=beta_fast, beta_slow=beta_slow,
                orig_ctx=orig_max))
        cfg = replace(cfg, logit_softcap=max(0.0, attn_cap),
                      final_logit_softcap=max(0.0, final_cap))
        tok = model.tokenizer
        tok.sys_prompt = "You are rnj-1, a foundation model trained by Essential AI.\n"
        return cls(gf.model_type, cfg, model.params, tok, device)
