"""Load-time weight-stream fusion for the decode path (counterpart of the
JAX package's `runtime/fuse.py`).

The projections of a layer that share an input are concatenated along
their output dimension: q|k|v after attn_norm into "qkv", gate|up after
ffn_norm into "gate_up".  A dense layer then reads 2 weight streams
instead of 5, through 2 kernel launches instead of 5.  The forward pass
already takes the fused keys (nn/transformer.py `attention_block`,
`gated_mlp`), so this is a pure parameter transform: every output column's
dot product is unchanged; only the column order of the concatenated weight
is new.  It is not necessarily bit-identical: a kernel may split a wider
product differently (K1 picks its split of K from N), so the f32 sums can
round in another order.

Opt-in: no engine calls it.  Layers that do not qualify (MLA, MoE layers,
qk-norm modes the fused path does not take, unequal gate / up widths) and
linears of mixed classes or formats pass through unfused.
"""
from __future__ import annotations

import torch

from ..nn.transformer import TransformerConfig
from ..ops.qtensor import DenseLinear, QuantLinear

# the qk-norm modes the JAX package fuses; the port runs "none" and "rmsnorm"
# (the others raise in attention_block whether fused or not)
FUSED_QK_NORMS = ("none", "rmsnorm", "rmsnorm_post", "l2norm_post")


def _concat_out(lins):
    """The linears concatenated along the output dimension, or None when
    they cannot be (mixed classes, input widths, dtypes or quant formats)."""
    if all(isinstance(l, DenseLinear) for l in lins):
        if len({l.w.shape[0] for l in lins}) != 1 or len({l.w.dtype for l in lins}) != 1:
            return None
        bias = _concat_bias(lins, [l.w.shape[1] for l in lins], lins[0].w.device)
        return DenseLinear(w=torch.cat([l.w for l in lins], dim=1), bias=bias)
    if not all(isinstance(l, QuantLinear) for l in lins):
        return None
    ref = lins[0]
    for l in lins[1:]:
        if (l.q.shape[0] != ref.q.shape[0]
                or l.group_size != ref.group_size or l.packed != ref.packed
                or l.zero_point != ref.zero_point or l.sb != ref.sb
                or (l.b is None) != (ref.b is None)
                or (l.d is None) != (ref.d is None)
                or l.q.dtype != ref.q.dtype or l.s.dtype != ref.s.dtype):
            return None

    def cat(name):
        parts = [getattr(l, name) for l in lins]
        return None if parts[0] is None else torch.cat(parts, dim=1)

    bias = _concat_bias(lins, [l.q.shape[1] for l in lins], ref.q.device)
    return QuantLinear(q=cat("q"), s=cat("s"), b=cat("b"), bias=bias,
                       group_size=ref.group_size, packed=ref.packed,
                       zero_point=ref.zero_point, d=cat("d"), dm=cat("dm"), sb=ref.sb)


def _concat_bias(lins, widths, device):
    """The linears' f32 biases end to end, zeros where one has none; None
    when none has a bias."""
    if all(l.bias is None for l in lins):
        return None
    return torch.cat([l.bias if l.bias is not None
                      else torch.zeros(n, dtype=torch.float32, device=device)
                      for l, n in zip(lins, widths)])


def fuse_decode_streams(cfg: TransformerConfig, params: dict) -> dict:
    """Fuse q|k|v -> "qkv" and gate|up -> "gate_up" wherever the layer's
    shape allows; other layers, and trees without "layers", pass through.
    The fused tensors are new; the unfused ones are not kept."""
    if not isinstance(params, dict) or "layers" not in params:
        return params
    out = dict(params)
    layers = []
    for i, lp in enumerate(params["layers"]):
        spec = cfg.layer_spec(i)
        lp = dict(lp)
        attn = lp.get("attn")
        if (isinstance(attn, dict) and all(k in attn for k in ("q", "k", "v"))
                and cfg.mla is None and cfg.qk_norm in FUSED_QK_NORMS):
            fused = _concat_out([attn["q"], attn["k"], attn["v"]])
            if fused is not None:
                attn = {k: v for k, v in attn.items() if k not in ("q", "k", "v")}
                attn["qkv"] = fused
                lp["attn"] = attn
        mlp = lp.get("mlp")
        if (isinstance(mlp, dict) and "gate" in mlp and "up" in mlp
                and "experts" not in mlp and not spec.is_moe and "gate_up" not in mlp
                # gated_mlp splits the fused output at its midpoint
                and mlp["gate"].shape_in_out[1] == mlp["up"].shape_in_out[1]):
            fused = _concat_out([mlp["gate"], mlp["up"]])
            if fused is not None:
                mlp = {k: v for k, v in mlp.items() if k not in ("gate", "up")}
                mlp["gate_up"] = fused
                lp["mlp"] = mlp
        layers.append(lp)
    out["layers"] = tuple(layers)
    return out
