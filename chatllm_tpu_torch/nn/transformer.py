"""Decoder-only transformer core, main-path subset of the JAX package's
`nn/transformer.py`: config, KV cache, pre-norm decoder layer (separate or
consolidated q/k/v projections, RoPE, GQA attention, SwiGLU MLP with
separate or fused gate/up, or the plain up/down MLP), the Phi family's
LayerNorm decoder and parallel residual, the DeepSeek family's
multi-head latent attention (both cache modes) and sparse MoE FFN, the
sliding-window ring cache, the Gemma family's pieces (sandwich norms, the
attention and final logit softcaps, the tied head's logit scale, a second
rope table for local layers, gated GELU), GPT-OSS's pieces (attention sinks
on every route, the biased softmax-top-k router, biased experts with the
clamped `swiglu_oai`), and the model forward.

Parameters are a plain dict: "embed" [V, H] in the compute dtype,
"final_norm" {"w"} (and "b" for LayerNorm), "layers" (a tuple of per-layer
dicts) and "lm_head"; linears are DenseLinear/QuantLinear from
ops/qtensor.py.  The KV cache is
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

from ..ops.attention import (NEG_INF, _key_bound, _rows_write, _softmax, attention_with_cache,
                             quantize_kv, update_kv_cache)
from ..ops.norm import layer_norm, rms_norm
from ..ops.qmm import dot_f32, matmul
from ..ops.rope import RopeConfig, apply_rope, precompute_rope_cache


@dataclass(frozen=True)
class LayerSpec:
    """Static per-layer variation: rope layers with full or sliding-window
    attention, dense or MoE FFN (the JAX package's other fields come with
    their ports)."""
    sliding_window: int = 0        # 0 = full attention
    use_rope: bool = True
    is_moe: bool = False           # sparse MoE FFN (moe_mlp) instead of the dense one
    local_rope: bool = False       # use cfg.rope_local's table (Gemma-3's sliding layers)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention dims (chatllm.cpp BaseMLAttention,
    models/deepseek.h:251-327)."""
    q_lora_rank: int = 0            # 0 = direct q projection (V2-Lite)
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


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
    act: str = "silu"                       # silu | gelu_tanh
    norm_type: str = "rmsnorm"              # rmsnorm | layernorm (Phi)
    norm_eps: float = 1e-5
    rms_norm_offset: float = 0.0
    rope: RopeConfig = None
    qkv_bias: bool = False
    o_bias: bool = False                    # the o projection carries a bias (Phi-2; the
    #                                         linear holds it, as in the JAX package;
    #                                         models/synthetic.py builds it from this)
    qk_norm: str = "none"                   # "rmsnorm": per-head RMS norm of q and k
    #                                         before RoPE (Qwen3); other modes raise
    tie_lm_head: bool = False
    attention_scale: float = -1.0           # -1 = 1/sqrt(head_dim)
    logit_softcap: float = 0.0              # attention score softcap (Gemma-2)
    final_logit_softcap: float = 0.0        # output logit softcap (Gemma-2)
    post_norms: bool = False                # sandwich norms after attention and FFN (Gemma-2/3)
    parallel_residual: bool = False         # x + attn(norm(x)) + mlp(norm(x)) (Phi-2)
    logit_scale: float = 1.0                # logits times this (Gemma's tied head: 1/sqrt(hidden))
    rope_local: Optional[RopeConfig] = None  # second rope table (Gemma-3's local layers)
    causal: bool = True
    layer_specs: tuple = ()                 # per-layer LayerSpec; () = uniform
    # MoE (layers whose LayerSpec has is_moe); the DeepSeek family's modes
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_norm_topk_prob: bool = True
    moe_intermediate_size: int = 0  # a routed expert's width
    moe_shared_intermediate: int = 0
    moe_n_group: int = 1            # grouped top-k routing
    moe_topk_group: int = 1
    moe_routed_scale: float = 1.0
    moe_score_func: str = "softmax"  # softmax | sigmoid | softmax_topk (GPT-OSS: the top k
    #   of the raw logits, then a softmax over those k); sparsemixer (Phi-3.5-MoE) raises
    moe_act: str = ""               # "" = act | "swiglu_oai" (GPT-OSS: min(g, L) sigmoid(a g)
    #   (clamp(u, -L, L) + 1), L = moe_swiglu_limit, a = moe_swiglu_alpha)
    moe_swiglu_limit: float = 7.0
    moe_swiglu_alpha: float = 1.702
    moe_grouped_argmax: bool = False  # Pangu-MoE routing, not ported
    moe_pre_weighting: bool = False   # Llama-4 routing, not ported
    moe_group_select: str = "sum2"  # grouped top-k group scoring: "sum2" ranks
    #   groups by the sum of their top-2 scores (sigmoid) or their max
    #   (softmax) and keeps moe_topk_group groups; "per_group_topk" keeps the
    #   top moe_topk_group experts inside every group
    mla: Optional[MLAConfig] = None
    mla_compressed: bool = False    # latent ("memory") MLA cache: [c_kv | k_pe]
    #   per token, the up-projections absorbed into q and the output
    cache_dtype: str = "bfloat16"

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim > 0 else self.hidden_size // self.num_attention_heads

    def layer_spec(self, i: int) -> LayerSpec:
        if self.layer_specs:
            return self.layer_specs[i]
        return LayerSpec()


QUANTIZED_CACHE_DTYPES = ("int8", "q8_0", "q8")

# Ring headroom of sliding-window layers (chatllm.cpp allocates
# sliding_window_len + extra_len, default 512, src/layers.h:1973): a layer of
# window w holds min(max_len, w + SWA_EXTRA) slots.  Without it, a prefill
# chunk written into a ring of exactly w slots would overwrite keys that its
# own earlier queries still see; the engines cap prefill chunks of such
# models to SWA_EXTRA tokens (runtime/generate.py, runtime/batching.py), so a
# chunk never does.  Read at call time, as the JAX package reads it.
SWA_EXTRA = 512


@dataclass
class KVCache:
    """Per-layer K/V tensors, [n_layers][B, S_layer, H_kv, D], written in
    place.  A sliding-window layer shorter than the model's context is a
    ring (`is_ring`): position p lives in slot p mod S_layer.

    Quantized mode (`--cache_dtype q8_0`): k/v are int8 with per-(token,
    head) f32 scales in k_scale/v_scale [n_layers][B, S, H_kv]; attention
    folds the scales into the scores and probabilities, so the dequantized
    cache is never materialized."""
    k: list = field(default_factory=list)
    v: list = field(default_factory=list)
    k_scale: Optional[list] = None
    v_scale: Optional[list] = None


def cache_dims(cfg: TransformerConfig) -> tuple[int, int, int]:
    """(kv heads, K width, V width) of a layer's cache.  Expanded MLA caches
    every head's K (nope + rope dims) and V; the latent one a single shared
    head [c_kv | k_pe] and a 1-wide V that nothing reads."""
    if cfg.mla is not None and cfg.mla_compressed:
        return 1, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim, 1
    if cfg.mla is not None:
        return (cfg.num_attention_heads, cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
                cfg.mla.v_head_dim)
    d = cfg.resolved_head_dim()
    return cfg.num_key_value_heads, d, d


def layer_slots(spec: LayerSpec, max_len: int) -> int:
    """Slots of a layer's cache: `max_len`, or a sliding-window layer's
    window + SWA_EXTRA when that is shorter."""
    if spec.sliding_window <= 0:
        return max_len
    return min(max_len, spec.sliding_window + SWA_EXTRA)


def is_ring(cfg: TransformerConfig, spec: LayerSpec, slots: int) -> bool:
    """A sliding-window layer whose cache is shorter than the model's
    context: ring-written, as in the JAX package's attention_block."""
    return spec.sliding_window > 0 and slots < cfg.max_length


def init_cache(cfg: TransformerConfig, batch: int, max_len: int | None = None,
               *, device="cpu") -> KVCache:
    from ..device import torch_dtype

    max_len = max_len or cfg.max_length
    quantized = cfg.cache_dtype in QUANTIZED_CACHE_DTYPES
    dtype = torch.int8 if quantized else torch_dtype(cfg.cache_dtype)
    n_kv, dk, dv = cache_dims(cfg)
    slots = [layer_slots(cfg.layer_spec(i), max_len) for i in range(cfg.num_hidden_layers)]

    def zeros(width, dt):
        return [torch.zeros((batch, s, n_kv, *width), dtype=dt, device=device) for s in slots]

    k, v = zeros((dk,), dtype), zeros((dv,), dtype)
    if not quantized:
        return KVCache(k=k, v=v)
    return KVCache(k=k, v=v, k_scale=zeros((), torch.float32), v_scale=zeros((), torch.float32))


# the Llama family's SiLU, the Gemma family's tanh-approximated GELU (the JAX
# package's jax.nn.gelu(approximate=True)); others come with their families
_ACTS = {"silu": F.silu, "gelu_tanh": lambda x: F.gelu(x, approximate="tanh")}


def _norm(cfg: TransformerConfig, x, p):
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p["w"], p.get("b"), eps=cfg.norm_eps)
    return rms_norm(x, p["w"], eps=cfg.norm_eps, offset=cfg.rms_norm_offset)


def gated_mlp(cfg: TransformerConfig, p, x):
    """down(act(gate(x)) * up(x)).  Quantized matmuls compute in bf16 at any
    activation dtype, as the JAX package's do.  A fused `gate_up` weight
    (GLM2's dense_h_to_4h, or runtime/fuse.py) is one projection split in
    halves: act(h[:F]) * h[F:]."""
    if "gate_up" in p:
        h2 = matmul(x, p["gate_up"])
        F = h2.shape[-1] // 2
        g, u = h2[..., :F], h2[..., F:]
    else:
        g = matmul(x, p["gate"])
        u = matmul(x, p["up"])
    h = (_ACTS[cfg.act](g) * u).to(x.dtype)
    return matmul(h, p["down"]).to(x.dtype)


def simple_mlp(cfg: TransformerConfig, p, x):
    """down(act(up(x))), the biases (Phi-2's fc1 / fc2) inside the linears.
    Apertus's xIELU activation is not ported."""
    if "xielu" in p:
        raise NotImplementedError("the xIELU MLP (Apertus) is not ported to "
                                  "chatllm_tpu_torch yet")
    h = _ACTS[cfg.act](matmul(x, p["up"])).to(x.dtype)
    return matmul(h, p["down"]).to(x.dtype)


# Routing modes of the JAX package's moe_mlp that belong to families not
# ported yet (Phi-3.5-MoE, Pangu-MoE, GroveMoE; Megrez2's pre-gate routing and
# Llama-4's pre-weighting below): they raise, naming the family.
_OTHER_SCORE_FUNCS = {"sparsemixer": "Phi-3.5-MoE"}
_OTHER_PARAMS = {"router_scale": "Pangu-MoE", "small_experts": "GroveMoE"}


def _not_ported(what: str, family: str):
    raise NotImplementedError(f"MoE {what} ({family}) is not ported to chatllm_tpu_torch yet")


def mlp_dispatch(cfg: TransformerConfig, spec: LayerSpec, p, x, router_x=None):
    if router_x is not None:
        _not_ported("pre-gate routing (router_x)", "Megrez2")
    if spec.is_moe:
        return moe_mlp(cfg, p, x)
    if "gate" in p or "gate_up" in p:
        return gated_mlp(cfg, p, x)
    return simple_mlp(cfg, p, x)


def moe_route(cfg: TransformerConfig, p, xt):
    """The router of the JAX package's moe_mlp.  The logits carry
    `gate_linear_bias` when there is one (GPT-OSS's router bias).
    softmax_topk: the top k of those logits, then a softmax over the k.
    softmax and sigmoid: scores, the selection-only `gate_bias`, grouped
    top-k in both `moe_group_select` modes, then the top-k experts and
    their weights (from the unbiased scores, normalized with + 1e-20 under
    moe_norm_topk_prob, times moe_routed_scale).  Among equal values the
    lower index comes first (XLA's top_k).  xt: [N, H] -> (topi int64 [N,
    K], topv f32 [N, K]), all on the device."""
    if cfg.moe_score_func in _OTHER_SCORE_FUNCS:
        _not_ported(f"score function {cfg.moe_score_func!r}",
                    _OTHER_SCORE_FUNCS[cfg.moe_score_func])
    if cfg.moe_grouped_argmax:
        _not_ported("grouped-argmax routing", "Pangu-MoE")
    logits = matmul(xt, p["gate"]).float()                            # [N, E]
    if "gate_linear_bias" in p:
        logits = logits + p["gate_linear_bias"].float()
    if cfg.moe_score_func == "softmax_topk":
        topl, topi = _topk(logits, cfg.moe_top_k)
        return topi, torch.softmax(topl, dim=-1)
    if cfg.moe_score_func == "sigmoid":
        probs = torch.sigmoid(logits)
    elif cfg.moe_score_func == "softmax":
        probs = torch.softmax(logits, dim=-1)
    else:
        raise ValueError(f"moe_score_func {cfg.moe_score_func!r}")
    sel = probs
    if "gate_bias" in p:
        sel = probs + p["gate_bias"].float()
    if cfg.moe_n_group > 1:
        N, G = sel.shape[0], cfg.moe_n_group
        gsel = sel.reshape(N, G, -1)
        if cfg.moe_group_select == "per_group_topk":
            kth = torch.topk(gsel, cfg.moe_topk_group, dim=-1).values[..., -1:]
            sel = torch.where(gsel >= kth, gsel, 0.0).reshape(N, -1)
        else:
            if cfg.moe_score_func == "sigmoid":
                gscore = torch.topk(gsel, 2, dim=-1).values.sum(dim=-1)      # [N, G]
            else:
                gscore = gsel.amax(dim=-1)
            gtop = torch.topk(gscore, cfg.moe_topk_group, dim=-1).values
            gmask = gscore >= gtop[..., -1:]
            sel = torch.where(gmask[:, :, None], gsel, float("-inf")).reshape(N, -1)
    topi = _topk(sel, cfg.moe_top_k)[1]
    topv = torch.gather(probs, -1, topi)
    if cfg.moe_norm_topk_prob:
        topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-20)
    if cfg.moe_routed_scale != 1.0:
        topv = topv * cfg.moe_routed_scale
    return topi, topv


def _topk(x, k: int):
    """(values, indices) of the k largest of each row, the lower index
    first among equal values (XLA's top_k: a stable descending sort)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def moe_mlp(cfg: TransformerConfig, p, x):
    """Sparse MoE FFN (chatllm.cpp GenericSparseMLP): router -> top-k experts
    -> weighted sum, plus the shared expert.  x: [B, T, H]."""
    for key, family in _OTHER_PARAMS.items():
        if key in p:
            _not_ported(f"parameter {key!r}", family)
    B, T, H = x.shape
    xt = x.reshape(B * T, H)
    topi, topv = moe_route(cfg, p, xt)
    return _moe_combine(cfg, p, xt, topi, topv, x)


def _experts_out(cfg: TransformerConfig, ex, xt, topi, topv, n_experts: int):
    """The selected experts' outputs weighed and summed, as the JAX package
    computes it: combine weights [N, E] (one-hot rows of topv rounded to the
    activation dtype) and a dense product over all experts of the stacked
    weights gate/up [E, H, F] and down [E, F, H], with GPT-OSS's expert
    biases gate_b / up_b [E, F] and down_b [E, H] when they are there and
    its `swiglu_oai` under cfg.moe_act (in f32, cast back to the product's
    dtype).  The products are batched matmuls over the stacks as they lie
    (x broadcast over E, never a copy or a transpose of the weights);
    routing stays on the device."""
    if cfg.moe_act not in ("", "swiglu_oai"):
        raise ValueError(f"moe_act {cfg.moe_act!r}")
    N = xt.shape[0]
    combine = torch.zeros(N, n_experts, dtype=xt.dtype, device=xt.device)
    combine.scatter_(1, topi, topv.to(xt.dtype))                       # [N, E]
    g = torch.matmul(xt, ex["gate"])                                   # [E, N, F]
    u = torch.matmul(xt, ex["up"])
    if "gate_b" in ex:
        g = g + ex["gate_b"][:, None, :]
        u = u + ex["up_b"][:, None, :]
    if cfg.moe_act == "swiglu_oai":
        lim, alpha = cfg.moe_swiglu_limit, cfg.moe_swiglu_alpha
        gf = torch.clamp(g.float(), max=lim)
        uf = torch.clamp(u.float(), -lim, lim)
        hidden = (gf * torch.sigmoid(alpha * gf) * (uf + 1.0)).to(g.dtype)
    else:
        hidden = _ACTS[cfg.act](g) * u
    out = torch.matmul(hidden, ex["down"])                             # [E, N, H]
    if "down_b" in ex:
        out = out + ex["down_b"][:, None, :]
    return torch.einsum("enh,ne->nh", out, combine)


def _moe_combine(cfg: TransformerConfig, p, xt, topi, topv, x):
    if cfg.moe_pre_weighting:
        _not_ported("pre-weighting", "Llama-4")
    B, T, H = x.shape
    y = _experts_out(cfg, p["experts"], xt, topi, topv, cfg.moe_num_experts)
    if "shared" in p:
        sh = gated_mlp(cfg, p["shared"], xt)
        if "shared_gate" in p:
            # the sigmoid-gated shared expert (Qwen2-MoE's shared_expert_gate)
            gate = torch.sigmoid(matmul(xt, p["shared_gate"]).float())
            sh = (sh.float() * gate).to(sh.dtype)
        y = y + sh
    return y.reshape(B, T, H).to(x.dtype)


# qk-norm modes of the JAX package's attention_block whose families are not
# ported yet: they raise, naming the family
_OTHER_QK_NORMS = {"rmsnorm_full": "OLMo2", "layernorm": "Persimmon",
                   "rmsnorm_halves": "NeoChat", "rmsnorm_post": "Hunyuan",
                   "l2norm_post": "Llama-4"}


def attention_block(cfg: TransformerConfig, spec: LayerSpec, p, x, cos, sin,
                    k_cache, v_cache, n_past, k_scale=None, v_scale=None, kv_len=None,
                    rope_cfg: RopeConfig | None = None):
    """GQA attention over the layer's cache; `rope_cfg` is the rope table
    cos / sin were made from (cfg.rope unless the layer takes cfg.rope_local)."""
    B, T, _ = x.shape
    d = cfg.resolved_head_dim()
    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    if "qkv" in p:
        # one consolidated projection, columns [q | k | v] (GLM2's
        # query_key_value, or runtime/fuse.py); slices of its output, on the
        # device, so a captured block replays them
        fused = matmul(x, p["qkv"])
        qo, kvo = hq * d, hkv * d
        q = fused[..., :qo].reshape(B, T, hq, d)
        k = fused[..., qo:qo + kvo].reshape(B, T, hkv, d)
        v = fused[..., qo + kvo:].reshape(B, T, hkv, d)
    else:
        q = matmul(x, p["q"]).reshape(B, T, hq, d)
        k = matmul(x, p["k"]).reshape(B, T, hkv, d)
        v = matmul(x, p["v"]).reshape(B, T, hkv, d)
    if cfg.qk_norm == "rmsnorm":
        # per-head RMS norm over head_dim (chatllm.cpp QKNormedAttention)
        q = rms_norm(q, p["q_norm"]["w"], eps=cfg.norm_eps, offset=cfg.rms_norm_offset)
        k = rms_norm(k, p["k_norm"]["w"], eps=cfg.norm_eps, offset=cfg.rms_norm_offset)
    elif cfg.qk_norm != "none":
        raise NotImplementedError(
            f"qk_norm {cfg.qk_norm!r} ({_OTHER_QK_NORMS.get(cfg.qk_norm, 'unknown family')}) "
            "is not ported to chatllm_tpu_torch yet")
    if spec.use_rope:
        rc = rope_cfg or cfg.rope
        q = apply_rope(q, cos, sin, layout=rc.layout, rot_dim=rc.resolved_rot_dim())
        k = apply_rope(k, cos, sin, layout=rc.layout, rot_dim=rc.resolved_rot_dim())
    scale = cfg.attention_scale if cfg.attention_scale > 0 else d ** -0.5
    if is_ring(cfg, spec, k_cache.shape[1]):
        # ring cache (chatllm.cpp's partial cache, src/layers.h:1973): every
        # offset form writes modulo the ring, and the whole ring is read
        ring_write(k_cache, v_cache, k, v, n_past, k_scale, v_scale)
        out = _ring_attention(cfg, spec, q, k_cache, v_cache, n_past, T, scale,
                              k_scale, v_scale, sinks=p.get("sinks"))
    else:
        update_kv_cache(k_cache, v_cache, k, v, n_past, k_scale, v_scale)
        out = attention_with_cache(q, k_cache, v_cache, n_past, T, scale=scale,
                                   causal=cfg.causal, logit_softcap=cfg.logit_softcap,
                                   sliding_window=spec.sliding_window, sinks=p.get("sinks"),
                                   k_scale=k_scale, v_scale=v_scale, kv_len=kv_len)
    out = out.reshape(B, T, hq * d)
    return matmul(out, p["o"]).to(x.dtype)


def _offsets(n_past, B: int, device) -> torch.Tensor:
    """Each row's offset as an int64 [B] tensor on `device` (from an int, a
    0-d or a [B] tensor; a device one is never read back)."""
    if isinstance(n_past, torch.Tensor):
        return n_past.reshape(-1).expand(B)
    return torch.full((B,), n_past, dtype=torch.int64, device=device)


def ring_write(k_cache, v_cache, k, v, n_past, k_scale=None, v_scale=None):
    """Write new K/V ([B, T, H, D]) into a ring at positions n_past + t
    modulo its S slots, in place (and their scales, for a q8 cache): the JAX
    package's `jnp.mod(n_past + t, S)` scatter.  Unlike update_kv_cache no
    row is dropped: a decode block's speculative steps past the frontier
    wrap too, onto slots whose keys have left every window (the SWA_EXTRA
    headroom).  `n_past` is an int, a 0-d or an int64 [B] tensor."""
    B, T = k.shape[:2]
    S = k_cache.shape[1]
    dev = k_cache.device
    if k_scale is not None:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, T)
    pos = (_offsets(n_past, B, dev)[:, None] + torch.arange(T, device=dev)) % S     # [B, T]
    k_cache[b_idx, pos] = k.to(k_cache.dtype)
    v_cache[b_idx, pos] = v.to(v_cache.dtype)
    if k_scale is not None:
        k_scale[b_idx, pos] = ks
        v_scale[b_idx, pos] = vs


def _ring_attention(cfg: TransformerConfig, spec: LayerSpec, q, k_cache, v_cache, n_past,
                    T: int, scale: float, k_scale=None, v_scale=None, sinks=None):
    """Attention over a ring of S slots (the JAX package's _ring_attention):
    each slot's absolute position is rebuilt from its index and the row's
    n_past + T (the latest write to slot j, -1 while unwritten), and masks
    the causal window; keys carry their absolute-position rope.  Scores and
    values in f32 over the whole ring; the q8 scales fold into the scores
    (before cfg.logit_softcap) and the probabilities.  `sinks` (one logit
    per query head) joins the softmax denominator.  Everything is computed on the device, so a captured decode
    block replays with the positions of its device n_past."""
    B, _, hq, d = q.shape
    S, hkv = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    npv = _offsets(n_past, B, dev)[:, None]                               # [B, 1]
    slot = torch.arange(S, device=dev)[None, :]                          # [1, S]
    k_pos = slot + torch.div(npv + T - 1 - slot, S, rounding_mode="floor") * S
    k_pos = torch.where(k_pos < 0, -1, k_pos)[:, None, :]                # [B, 1, S]
    q_pos = (npv + torch.arange(T, device=dev)[None, :])[..., None]      # [B, T, 1]
    valid = (k_pos >= 0) & (k_pos <= q_pos)
    if spec.sliding_window > 0:
        valid = valid & (k_pos > q_pos - spec.sliding_window)
    mask = torch.where(valid, 0.0, NEG_INF)                              # [B, T, S]
    qg = q.reshape(B, T, hkv, hq // hkv, d).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k_cache.float()) * scale
    if k_scale is not None:
        scores = scores * k_scale.transpose(1, 2)[:, :, None, None, :]
    if cfg.logit_softcap > 0:
        scores = torch.tanh(scores / cfg.logit_softcap) * cfg.logit_softcap
    p = _softmax(scores + mask[:, None, None], sinks)
    if v_scale is not None:
        p = p * v_scale.transpose(1, 2)[:, :, None, None, :]
    out = torch.einsum("bhgts,bshd->bthgd", p, v_cache.float())
    return out.reshape(B, T, hq, d).to(q.dtype)


def _mla_query(cfg: TransformerConfig, p, x):
    """The MLA query [B, T, h * (nope + rope)] in f32: direct, or through the
    q lora (down projection, RMS norm, up projection)."""
    if cfg.mla.q_lora_rank > 0:
        cq = rms_norm(matmul(x, p["d_q"]), p["q_norm"]["w"], eps=cfg.norm_eps)
        return matmul(cq, p["u_q"])
    return matmul(x, p["q"])


def mla_attention_block(cfg: TransformerConfig, spec: LayerSpec, p, x, cos, sin,
                        k_cache, v_cache, n_past, k_scale=None, v_scale=None, kv_len=None):
    """Multi-head latent attention, expanded ("speed") mode: the kv lora is
    up-projected to every head's K (nope dims + the shared rope tail) and V,
    which are cached (chatllm.cpp BaseMLAttention::forward_speed; weights
    pre-split by the converter).  RoPE rotates the rope tail of q and the
    shared k_pe, in the config's layout.  K is nope + rope wide and V
    v_head_dim wide: the caches' widths differ."""
    if cfg.mla_compressed:
        return _mla_compressed_block(cfg, spec, p, x, cos, sin, k_cache, v_cache, n_past,
                                     k_scale, v_scale, kv_len)
    B, T, _ = x.shape
    m = cfg.mla
    h = cfg.num_attention_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    q = _mla_query(cfg, p, x).reshape(B, T, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, cos, sin, layout=cfg.rope.layout)
    kv_lora = matmul(x, p["d_kv"])                                    # [B, T, rank]
    k_pe = apply_rope(matmul(x, p["k_pe"]).reshape(B, T, 1, dr), cos, sin,
                      layout=cfg.rope.layout)
    c = rms_norm(kv_lora, p["kv_norm"]["w"], eps=cfg.norm_eps)
    k_nope = matmul(c, p["u_k_nope"]).reshape(B, T, h, dn)
    v = matmul(c, p["u_v"]).reshape(B, T, h, dv)
    q = torch.cat([q_nope, q_pe], dim=-1).to(x.dtype)
    k = torch.cat([k_nope, k_pe.expand(B, T, h, dr)], dim=-1).to(x.dtype)
    update_kv_cache(k_cache, v_cache, k, v, n_past, k_scale, v_scale)
    scale = cfg.attention_scale if cfg.attention_scale > 0 else (dn + dr) ** -0.5
    out = attention_with_cache(q, k_cache, v_cache, n_past, T, scale=scale, causal=True,
                               k_scale=k_scale, v_scale=v_scale, kv_len=kv_len)
    return matmul(out.reshape(B, T, h * dv), p["o"]).to(x.dtype)


def _mla_compressed_block(cfg: TransformerConfig, spec: LayerSpec, p, x, cos, sin,
                          k_cache, v_cache, n_past, k_scale=None, v_scale=None, kv_len=None):
    """Latent-cache MLA (chatllm.cpp "memory" mode, forward_memory) with the
    up-projections absorbed into the query and the output (p["wk_abs"]
    [rank, h, nope], p["wv_abs"] [rank, h, dv], made at load): attention
    runs in the latent space as MQA over cache rows [c | k_pe].

        q_lat  = q_nope . Wk            [B, T, h, rank]
        scores = [q_lat | q_pe] . cache
        ctx    = probs . c              [B, T, h, rank]
        out    = ctx . Wv               [B, T, h, dv]

    The row is written at n_past in place (with a device n_past by an index
    write, rows past the cache dropped, as update_kv_cache does).  Keys at
    or past n_past + T weigh exactly 0, so an int n_past reads the written
    keys only and a device one up to `kv_len`.  As in the JAX package, a q8
    cache and a per-row n_past raise."""
    if k_scale is not None:
        raise ValueError("compressed MLA cache incompatible with q8 cache")
    if isinstance(n_past, torch.Tensor) and n_past.dim() == 1:
        raise ValueError("per-slot n_past not supported with the compressed MLA cache; "
                         "use --mla_cache speed for serving")
    B, T, _ = x.shape
    m = cfg.mla
    h = cfg.num_attention_heads
    dn, dr, rank = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    q = _mla_query(cfg, p, x).reshape(B, T, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, cos, sin, layout=cfg.rope.layout)
    c = rms_norm(matmul(x, p["d_kv"]), p["kv_norm"]["w"], eps=cfg.norm_eps)
    k_pe = apply_rope(matmul(x, p["k_pe"]).reshape(B, T, 1, dr), cos, sin,
                      layout=cfg.rope.layout)
    row = torch.cat([c[:, :, None, :], k_pe], dim=-1)                # [B, T, 1, rank + dr]
    if isinstance(n_past, torch.Tensor):
        _rows_write(k_cache, row, n_past.reshape(1).expand(B))
    else:
        k_cache[:, n_past:n_past + T] = row.to(k_cache.dtype)

    q_lat = torch.einsum("bthd,rhd->bthr", q_nope.float(), p["wk_abs"].float())
    q_full = torch.cat([q_lat, q_pe.float()], dim=-1)
    S = _key_bound(k_cache.shape[1], n_past, T, kv_len)
    cache = k_cache[:, :S, 0, :].float()                              # [B, S, rank + dr]
    scale = cfg.attention_scale if cfg.attention_scale > 0 else (dn + dr) ** -0.5
    scores = torch.einsum("bthr,bsr->bhts", q_full, cache) * scale
    q_pos = n_past + torch.arange(T, device=x.device)[:, None]
    k_pos = torch.arange(S, device=x.device)[None, :]
    valid = (k_pos < n_past + T) & (k_pos <= q_pos)
    probs = torch.softmax(scores + torch.where(valid, 0.0, NEG_INF)[None, None], dim=-1)
    ctx = torch.einsum("bhts,bsr->bthr", probs, cache[..., :rank])
    out = torch.einsum("bthr,rhd->bthd", ctx, p["wv_abs"].float())
    out = out.reshape(B, T, h * m.v_head_dim).to(x.dtype)
    return matmul(out, p["o"]).to(x.dtype)


def decoder_layer(cfg: TransformerConfig, spec: LayerSpec, p, x, cos, sin,
                  k_cache, v_cache, n_past, k_scale=None, v_scale=None, kv_len=None,
                  rope_cfg: RopeConfig | None = None):
    """Pre-norm decoder layer (reference LMBlock1): GQA or MLA attention,
    dense or MoE FFN; with cfg.post_norms the attention and FFN outputs are
    normed before their residual adds (LMBlock4, Gemma-2/3's sandwich); with
    cfg.parallel_residual the FFN takes the same normed input as attention
    and both outputs join the residual together, (x + attn) + mlp (LMBlock2,
    Phi-2: no ffn_norm)."""
    h = _norm(cfg, x, p["attn_norm"])
    if cfg.mla is not None:
        a = mla_attention_block(cfg, spec, p["attn"], h, cos, sin, k_cache, v_cache, n_past,
                                k_scale, v_scale, kv_len)
    else:
        a = attention_block(cfg, spec, p["attn"], h, cos, sin, k_cache, v_cache, n_past,
                            k_scale, v_scale, kv_len, rope_cfg)
    if cfg.post_norms:
        a = _norm(cfg, a, p["post_attn_norm"])
    if cfg.parallel_residual:
        return x + a + mlp_dispatch(cfg, spec, p["mlp"], h)
    x = x + a
    h = _norm(cfg, x, p["ffn_norm"])
    m = mlp_dispatch(cfg, spec, p["mlp"], h)
    if cfg.post_norms:
        m = _norm(cfg, m, p["post_ffn_norm"])
    return x + m


def embed_tokens(cfg: TransformerConfig, params, ids):
    return params["embed"][ids]


def lm_logits(cfg: TransformerConfig, params, x):
    """The head (tied: the embedding's transpose), then cfg.logit_scale and
    the final softcap, in f32 as the JAX package applies them."""
    if cfg.tie_lm_head:
        w = params["embed"]
        logits = dot_f32(x.to(w.dtype), w.t())
    else:
        logits = matmul(x, params["lm_head"])
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap > 0:
        logits = torch.tanh(logits / cfg.final_logit_softcap) * cfg.final_logit_softcap
    return logits


def transformer_forward(cfg: TransformerConfig, params, ids: torch.Tensor | None,
                        cache: KVCache, n_past, *, last_index: int | None = None,
                        kv_len: int | None = None, input_embeds: torch.Tensor | None = None):
    """ids: [B, T] int64 -> (logits [B, T|1, V] f32, cache updated in place).

    `last_index` slices the hidden state at one position before the lm_head
    (bucketed prefill: the last real token sits at n_valid - 1 inside the
    right-padded chunk), so the vocab projection runs on one row.  With a
    tensor `n_past`, `kv_len` bounds the keys attention reads (None: the
    whole cache); ring layers are always read whole.  `input_embeds`
    [B, T, H] replaces the token lookup (multimodal prompts splice projected
    media embeddings between the text embeddings); positions stay
    n_past + arange(T)."""
    if input_embeds is not None:
        x = input_embeds
        B, T = x.shape[:2]
    else:
        B, T = ids.shape
        x = embed_tokens(cfg, params, ids)
    steps = torch.arange(T, device=x.device)
    if isinstance(n_past, torch.Tensor) and n_past.dim() == 1:   # per-slot offsets [B]
        positions = n_past[:, None] + steps[None, :]
    else:
        positions = (n_past + steps)[None, :].expand(B, T)
    cos, sin = precompute_rope_cache(positions, cfg.rope)
    cos_l = sin_l = None
    if cfg.rope_local is not None:
        # Gemma-3's local layers rotate by a second table of the same positions
        cos_l, sin_l = precompute_rope_cache(positions, cfg.rope_local)
    quant = cache.k_scale is not None
    for i in range(cfg.num_hidden_layers):
        spec = cfg.layer_spec(i)
        local = spec.local_rope and cos_l is not None
        c, s, rc = (cos_l, sin_l, cfg.rope_local) if local else (cos, sin, cfg.rope)
        x = decoder_layer(cfg, spec, params["layers"][i], x, c, s,
                          cache.k[i], cache.v[i], n_past,
                          cache.k_scale[i] if quant else None,
                          cache.v_scale[i] if quant else None, kv_len, rc)
    x = _norm(cfg, x, params["final_norm"])
    if last_index is not None:
        x = x[:, last_index:last_index + 1, :]
    return lm_logits(cfg, params, x), cache
