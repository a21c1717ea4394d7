"""Normalization ops (counterpart of the JAX package's `ops/norm.py`).

All reductions run in f32 regardless of the activation dtype, as ggml does.
"""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-5,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm; `offset=1.0` gives the Gemma-style (1 + w) variant."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (weight.float() + offset)).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
               *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm: mean and variance in f32 (the variance as mean((x - mean)^2)),
    an optional bias, the result in x's dtype."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    c = xf - mean
    var = torch.mean(c * c, dim=-1, keepdim=True)
    y = c * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
