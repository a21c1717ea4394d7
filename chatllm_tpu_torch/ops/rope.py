"""Rotary position embeddings (counterpart of the JAX package's `ops/rope.py`,
main-path subset): plain RoPE with freq_base/freq_scale, Llama-3.1 per-dim
`freq_factors`, YaRN, partial rotary dims, NEOX (half-split) and NORMAL
(adjacent pairs, ggml mode 0) layouts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

ROPE_NEOX = "neox"        # rotate halves (HF convention)
ROPE_NORMAL = "normal"    # rotate adjacent pairs (ggml mode 0)


@dataclass(frozen=True)
class RopeConfig:
    head_dim: int
    rot_dim: int = -1                    # rotary dims (defaults to head_dim)
    freq_base: float = 10000.0
    freq_scale: float = 1.0              # 1/linear-scaling factor
    layout: str = ROPE_NEOX
    # YaRN (0 disables):
    ext_factor: float = 0.0
    attn_factor: float = 1.0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    orig_ctx: int = 0                    # n_ctx_orig for the YaRN ramp
    # per-dim frequency divisors (LongRoPE, Llama-3.1), length rot_dim/2
    freq_factors: Optional[tuple] = None
    mscale_all: float = 1.0              # explicit attn-scale multiplier

    def resolved_rot_dim(self) -> int:
        return self.head_dim if self.rot_dim <= 0 else self.rot_dim


def _yarn_corr_dim(n_dims: int, n_ctx_orig: int, beta: float, base: float) -> float:
    return n_dims * math.log(n_ctx_orig / (beta * 2 * math.pi)) / (2 * math.log(base))


def rope_mscale(cfg: RopeConfig) -> float:
    """The attention magnitude scale folded into the cos/sin tables."""
    m = cfg.attn_factor * cfg.mscale_all
    if cfg.ext_factor != 0.0 and cfg.orig_ctx > 0:
        m *= 1.0 + 0.1 * math.log(1.0 / cfg.freq_scale)
    return m


_INV_FREQ: dict = {}


def _inv_freq(cfg: RopeConfig, dev: torch.device) -> torch.Tensor:
    """freq_base^(-2i/rot) / freq_factors on `dev`, made once per config and
    device: the table holds host constants, so a forward captured in a CUDA
    graph reads it instead of copying them to the card."""
    key = (cfg, dev)
    if key not in _INV_FREQ:
        rot = cfg.resolved_rot_dim()
        with torch.inference_mode(False):        # a normal tensor, usable in any mode
            dim_i = torch.arange(rot // 2, dtype=torch.float32, device=dev)
            inv = torch.pow(torch.tensor(cfg.freq_base, dtype=torch.float32, device=dev),
                            -2.0 * dim_i / rot)
            if cfg.freq_factors is not None:
                inv = inv / torch.tensor(cfg.freq_factors, dtype=torch.float32, device=dev)
        _INV_FREQ[key] = inv
    return _INV_FREQ[key]


def precompute_rope_cache(positions: torch.Tensor, cfg: RopeConfig):
    """positions: int tensor [...]; returns (cos, sin): f32 [..., rot/2]."""
    rot = cfg.resolved_rot_dim()
    half = rot // 2
    dev = positions.device
    inv_freq = _inv_freq(cfg, dev)
    theta_extrap = positions.float()[..., None] * inv_freq
    if cfg.ext_factor != 0.0 and cfg.orig_ctx > 0:
        low = max(0.0, math.floor(_yarn_corr_dim(rot, cfg.orig_ctx, cfg.beta_fast, cfg.freq_base)))
        high = min(rot - 1.0, math.ceil(_yarn_corr_dim(rot, cfg.orig_ctx, cfg.beta_slow, cfg.freq_base)))
        denom = max(0.001, high - low)
        dim_i = torch.arange(half, dtype=torch.float32, device=dev)
        ramp = torch.clamp((dim_i - low) / denom, 0.0, 1.0)
        ramp_mix = (1.0 - ramp) * cfg.ext_factor
        theta_interp = cfg.freq_scale * theta_extrap
        theta = theta_interp * (1.0 - ramp_mix) + theta_extrap * ramp_mix
    else:
        theta = cfg.freq_scale * theta_extrap
    mscale = rope_mscale(cfg)
    return torch.cos(theta) * mscale, torch.sin(theta) * mscale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
               layout: str = ROPE_NEOX, rot_dim: int = -1) -> torch.Tensor:
    """x: [B, T, H, D]; cos/sin: [B, T, rot/2] (or [T, rot/2])."""
    d = x.shape[-1]
    rot = d if rot_dim <= 0 else rot_dim
    xr, xp = x[..., :rot], x[..., rot:]
    if cos.dim() == x.dim() - 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].float()
    sin = sin[:, :, None, :].float()
    xf = xr.float()
    if layout == ROPE_NEOX:
        x1, x2 = xf[..., : rot // 2], xf[..., rot // 2:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    elif layout == ROPE_NORMAL:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(xf.shape)
    else:
        raise ValueError(f"rope layout {layout}")
    out = out.to(x.dtype)
    if rot < d:
        out = torch.cat([out, xp], dim=-1)
    return out
