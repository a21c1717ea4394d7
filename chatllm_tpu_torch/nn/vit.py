"""Vision transformer tower of the SigLIP / InternViT family and InternVL's
pixel shuffle (counterpart of the JAX package's `nn/vit.py`: `ViTConfig`,
`patch_embed`, `vit_attention`, `vit_layer`, `vit_forward`, `pixel_shuffle`;
its other towers come with their models).

Pure functions over param dicts, like nn/transformer.py.  The tower keeps
the JAX package's numerics: activations in f32 (the patch embedding is an f32
product), bf16 or f32 weights in the linears with f32 results, and an f32
attention (einsum and softmax over all tokens).  The patch convolution is
written as an unfold and a matmul: the same function, and it never takes
cuDNN's TF32 path on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.norm import layer_norm
from ..ops.qmm import matmul


@dataclass(frozen=True)
class ViTConfig:
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    intermediate_size: int
    patch_size: int
    image_size: int
    act: str = "gelu_tanh"          # siglip: gelu_pytorch_tanh; internvit: gelu
    cls_token: bool = False         # InternViT prepends a class token
    layer_scale: bool = False       # InternViT ls1/ls2
    norm_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


def _act(cfg: ViTConfig):
    if cfg.act == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    return lambda x: F.gelu(x, approximate="none")


def patch_embed(cfg: ViTConfig, p, pixels: torch.Tensor) -> torch.Tensor:
    """pixels: [B, H, W, 3] (normalized f32) -> [B, N(+1 cls), hidden].
    p["proj_w"] is the convolution's [ph, pw, 3, hidden] (HWIO) weight; each
    patch, read in (row, column, channel) order, meets its rows."""
    w = p["proj_w"].float()
    ph, pw, c, H = w.shape
    B, h, wd, _ = pixels.shape
    gh, gw = h // ph, wd // pw
    x = pixels.float()[:, :gh * ph, :gw * pw]
    x = x.reshape(B, gh, ph, gw, pw, c).permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, -1)
    x = torch.matmul(x, w.reshape(ph * pw * c, H))
    if "proj_b" in p:
        x = x + p["proj_b"]
    if cfg.cls_token:
        x = torch.cat([p["cls"].expand(B, 1, H).to(x.dtype), x], dim=1)
    return x + p["pos"][None, :x.shape[1]]


def vit_attention(cfg: ViTConfig, p, x: torch.Tensor) -> torch.Tensor:
    B, N, H = x.shape
    nh = cfg.num_attention_heads
    d = H // nh
    q = matmul(x, p["q"]).reshape(B, N, nh, d)
    k = matmul(x, p["k"]).reshape(B, N, nh, d)
    v = matmul(x, p["v"]).reshape(B, N, nh, d)
    scores = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * (d ** -0.5)
    pr = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", pr, v.float())
    out = out.reshape(B, N, H).to(x.dtype)
    return matmul(out, p["o"]).to(x.dtype)


def vit_layer(cfg: ViTConfig, p, x: torch.Tensor) -> torch.Tensor:
    h = layer_norm(x, p["norm1"]["w"], p["norm1"].get("b"), eps=cfg.norm_eps)
    attn = vit_attention(cfg, p["attn"], h)
    if cfg.layer_scale:
        attn = attn * p["ls1"]
    x = x + attn
    h = layer_norm(x, p["norm2"]["w"], p["norm2"].get("b"), eps=cfg.norm_eps)
    h = _act(cfg)(matmul(h, p["mlp"]["fc0"]).float()).to(x.dtype)
    h = matmul(h, p["mlp"]["fc1"]).to(x.dtype)
    if cfg.layer_scale:
        h = h * p["ls2"]
    return x + h


def vit_forward(cfg: ViTConfig, params, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, H, W, 3] -> hidden states [B, N(+cls), hidden]."""
    x = patch_embed(cfg, params["embed"], pixels)
    for lp in params["layers"]:
        x = vit_layer(cfg, lp, x)
    if "post_norm" in params:
        x = layer_norm(x, params["post_norm"]["w"], params["post_norm"].get("b"),
                       eps=cfg.norm_eps)
    return x


def pixel_shuffle(x: torch.Tensor, grid_h: int, grid_w: int, scale: float) -> torch.Tensor:
    """InternVL pixel-shuffle downsample: [B, gh*gw, H] ->
    [B, (gh*s)*(gw*s), H/s²] with s = downsample_ratio (0.5), in the JAX
    package's reshape and transpose order."""
    B, N, H = x.shape
    fac = int(round(1 / scale))
    x = x.reshape(B, grid_h, grid_w // fac, H * fac)
    x = x.transpose(1, 2)
    x = x.reshape(B, grid_w // fac, grid_h // fac, H * fac * fac)
    x = x.transpose(1, 2)
    return x.reshape(B, (grid_h // fac) * (grid_w // fac), H * fac * fac)
