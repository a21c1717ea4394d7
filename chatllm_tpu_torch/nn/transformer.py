"""Decoder-only transformer core, main-path subset of the JAX package's
`nn/transformer.py`: config, KV cache, pre-norm decoder layer (separate
q/k/v projections, RoPE, GQA attention, SwiGLU MLP) and the model forward.

Parameters are a plain dict: "embed" [V, H] in the compute dtype,
"final_norm" {"w"}, "layers" (a tuple of per-layer dicts) and "lm_head";
linears are DenseLinear/QuantLinear from ops/qtensor.py.  The KV cache is
written in place.  `n_past` is an int (one stream's prefill), a 0-d int64
device tensor (rows sharing one position read on the device: the decode
block a CUDA graph captures, runtime/decode_graph.py, with `kv_len` its
static bound on the keys read) or an int64 [B] tensor of per-slot offsets
(the continuous-batching decode, runtime/batching.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.attention import attention_with_cache, update_kv_cache
from ..ops.norm import rms_norm
from ..ops.qmm import dot_f32, matmul
from ..ops.rope import RopeConfig, apply_rope, precompute_rope_cache


@dataclass(frozen=True)
class LayerSpec:
    """Static per-layer variation; this slice supports plain full-attention
    rope layers only (the JAX package's other fields come with their ports)."""
    sliding_window: int = 0        # 0 = full attention
    use_rope: bool = True


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    intermediate_size: int
    max_length: int
    head_dim: int = -1                      # defaults to hidden/heads
    act: str = "silu"
    norm_eps: float = 1e-5
    rms_norm_offset: float = 0.0
    rope: RopeConfig = None
    qkv_bias: bool = False
    tie_lm_head: bool = False
    attention_scale: float = -1.0           # -1 = 1/sqrt(head_dim)
    causal: bool = True
    layer_specs: tuple = ()                 # per-layer LayerSpec; () = uniform
    cache_dtype: str = "bfloat16"

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim > 0 else self.hidden_size // self.num_attention_heads

    def layer_spec(self, i: int) -> LayerSpec:
        if self.layer_specs:
            return self.layer_specs[i]
        return LayerSpec()


QUANTIZED_CACHE_DTYPES = ("int8", "q8_0", "q8")


@dataclass
class KVCache:
    """Per-layer K/V tensors, [n_layers][B, S, H_kv, D], written in place.

    Quantized mode (`--cache_dtype q8_0`): k/v are int8 with per-(token,
    head) f32 scales in k_scale/v_scale [n_layers][B, S, H_kv]; attention
    folds the scales into the scores and probabilities, so the dequantized
    cache is never materialized."""
    k: list = field(default_factory=list)
    v: list = field(default_factory=list)
    k_scale: Optional[list] = None
    v_scale: Optional[list] = None


def init_cache(cfg: TransformerConfig, batch: int, max_len: int | None = None,
               *, device="cpu") -> KVCache:
    from ..device import torch_dtype

    max_len = max_len or cfg.max_length
    quantized = cfg.cache_dtype in QUANTIZED_CACHE_DTYPES
    dtype = torch.int8 if quantized else torch_dtype(cfg.cache_dtype)
    d = cfg.resolved_head_dim()
    shape = (batch, max_len, cfg.num_key_value_heads, d)
    n = cfg.num_hidden_layers

    def zeros(shp, dt):
        return [torch.zeros(shp, dtype=dt, device=device) for _ in range(n)]

    if not quantized:
        return KVCache(k=zeros(shape, dtype), v=zeros(shape, dtype))
    return KVCache(k=zeros(shape, dtype), v=zeros(shape, dtype),
                   k_scale=zeros(shape[:3], torch.float32),
                   v_scale=zeros(shape[:3], torch.float32))


_ACTS = {"silu": F.silu}          # the Llama family's; others come with theirs


def _norm(cfg: TransformerConfig, x, p):
    return rms_norm(x, p["w"], eps=cfg.norm_eps, offset=cfg.rms_norm_offset)


def gated_mlp(cfg: TransformerConfig, p, x):
    """down(act(gate(x)) * up(x)).  Quantized matmuls compute in bf16 at any
    activation dtype, as the JAX package's do."""
    g = matmul(x, p["gate"])
    u = matmul(x, p["up"])
    h = (_ACTS[cfg.act](g) * u).to(x.dtype)
    return matmul(h, p["down"]).to(x.dtype)


def attention_block(cfg: TransformerConfig, spec: LayerSpec, p, x, cos, sin,
                    k_cache, v_cache, n_past, k_scale=None, v_scale=None, kv_len=None):
    B, T, _ = x.shape
    d = cfg.resolved_head_dim()
    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    q = matmul(x, p["q"]).reshape(B, T, hq, d)
    k = matmul(x, p["k"]).reshape(B, T, hkv, d)
    v = matmul(x, p["v"]).reshape(B, T, hkv, d)
    if spec.use_rope:
        rc = cfg.rope
        q = apply_rope(q, cos, sin, layout=rc.layout, rot_dim=rc.resolved_rot_dim())
        k = apply_rope(k, cos, sin, layout=rc.layout, rot_dim=rc.resolved_rot_dim())
    update_kv_cache(k_cache, v_cache, k, v, n_past, k_scale, v_scale)
    scale = cfg.attention_scale if cfg.attention_scale > 0 else d ** -0.5
    out = attention_with_cache(q, k_cache, v_cache, n_past, T, scale=scale,
                               causal=cfg.causal, sliding_window=spec.sliding_window,
                               k_scale=k_scale, v_scale=v_scale, kv_len=kv_len)
    out = out.reshape(B, T, hq * d)
    return matmul(out, p["o"]).to(x.dtype)


def decoder_layer(cfg: TransformerConfig, spec: LayerSpec, p, x, cos, sin,
                  k_cache, v_cache, n_past, k_scale=None, v_scale=None, kv_len=None):
    """Pre-norm decoder layer (reference LMBlock1)."""
    h = _norm(cfg, x, p["attn_norm"])
    x = x + attention_block(cfg, spec, p["attn"], h, cos, sin, k_cache, v_cache, n_past,
                            k_scale, v_scale, kv_len)
    h = _norm(cfg, x, p["ffn_norm"])
    return x + gated_mlp(cfg, p["mlp"], h)


def embed_tokens(cfg: TransformerConfig, params, ids):
    return params["embed"][ids]


def lm_logits(cfg: TransformerConfig, params, x):
    if cfg.tie_lm_head:
        w = params["embed"]
        return dot_f32(x.to(w.dtype), w.t())
    return matmul(x, params["lm_head"])


def transformer_forward(cfg: TransformerConfig, params, ids: torch.Tensor,
                        cache: KVCache, n_past, *, last_index: int | None = None,
                        kv_len: int | None = None):
    """ids: [B, T] int64 -> (logits [B, T|1, V] f32, cache updated in place).

    `last_index` slices the hidden state at one position before the lm_head
    (bucketed prefill: the last real token sits at n_valid - 1 inside the
    right-padded chunk), so the vocab projection runs on one row.  With a
    tensor `n_past`, `kv_len` bounds the keys attention reads (None: the
    whole cache)."""
    B, T = ids.shape
    x = embed_tokens(cfg, params, ids)
    steps = torch.arange(T, device=ids.device)
    if isinstance(n_past, torch.Tensor) and n_past.dim() == 1:   # per-slot offsets [B]
        positions = n_past[:, None] + steps[None, :]
    else:
        positions = (n_past + steps)[None, :].expand(B, T)
    cos, sin = precompute_rope_cache(positions, cfg.rope)
    quant = cache.k_scale is not None
    for i in range(cfg.num_hidden_layers):
        x = decoder_layer(cfg, cfg.layer_spec(i), params["layers"][i], x, cos, sin,
                          cache.k[i], cache.v[i], n_past,
                          cache.k_scale[i] if quant else None,
                          cache.v_scale[i] if quant else None, kv_len)
    x = _norm(cfg, x, params["final_norm"])
    if last_index is not None:
        x = x[:, last_index:last_index + 1, :]
    return lm_logits(cfg, params, x), cache
