"""K3: flash attention for prefill over the KV cache (csrc/flash_attention.cu).

Replaces chatllm_tpu/ops/pallas/flash.py::flash_attention.  `flash_attention`
launches the CUDA kernel for CUDA tensors and runs `flash_attention_plain`,
its plain PyTorch version, for CPU tensors.  `prefill_geometry` is the bf16
kernel's schedule (which key tiles each query tile visits, which of them
skip the mask, the launch order), which the kernel computes on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .build import FLASH, ptr, stream_ptr

NEG_INF = -1e30
HEAD_DIMS = (64, 128)     # head dims the CUDA kernel is instantiated for
# The bf16 kernel's tiles (csrc/flash_attention.cu): a block owns BQ query
# rows of one head, WG_ROWS per consumer warpgroup, and walks BK-key tiles
# of the cache through a ring of STAGES[D] shared-memory stages.
BQ, WG_ROWS, BK = 128, 64, 128
STAGES = {64: 4, 128: 2}
SMEM_LIMIT = 232448       # dynamic shared memory one block may use on the H100
# (q dtype, cache dtype) -> the kernel variant (csrc/flash_attention.cu)
MODES = {(torch.bfloat16, torch.bfloat16): 0, (torch.float32, torch.float32): 1,
         (torch.float32, torch.bfloat16): 2}


def tile_keys(qt: int, T: int, S: int, n_past: int, n_tokens: int, causal: bool,
              window: int) -> tuple[int, int]:
    """The key tiles [first, end) that query tile `qt` (rows qt*BQ .. of the
    T) visits (csrc `tile_keys`): those that meet the keys some real row of
    the tile may see, from the window's start for its first row to the last
    written key, or its last row's position when causal.  (0, 0) when the
    tile's rows see no key at all."""
    t0 = qt * BQ
    lo = max(0, n_past + t0 - window + 1) if window > 0 else 0
    hi = min(n_past + n_tokens, S)
    if causal:
        hi = min(hi, n_past + min(T, t0 + BQ))
    if hi <= lo:
        return 0, 0
    return lo // BK, -(-hi // BK)


def tile_interior(qt: int, kt: int, half: int, n_past: int, n_tokens: int, causal: bool,
                  window: int) -> bool:
    """Whether every key of tile kt is visible to every row of consumer
    warpgroup `half` of query tile qt (csrc `tile_interior`): those tiles skip
    the mask arithmetic."""
    k0, q_lo = kt * BK, n_past + qt * BQ + half * WG_ROWS
    ok = k0 + BK <= n_past + n_tokens
    if causal:
        ok = ok and k0 + BK - 1 <= q_lo
    if window > 0:
        ok = ok and k0 > q_lo + WG_ROWS - 1 - window
    return ok


def prefill_geometry(T: int, S: int, n_past: int, n_tokens: int, D: int, *,
                     causal: bool = True, window: int = 0) -> dict:
    """The bf16 kernel's schedule, which the kernel computes on the card:
    per query tile its key tiles [first, end) and, per visited tile, whether
    each consumer warpgroup's rows take it unmasked; the launch order (slot
    r of the grid's slowest dimension runs query tile order[r]: the tiles
    that walk the most key tiles first, later tiles first among equals); the
    ring's stages and the block's dynamic shared memory (Q, the K/V ring, a
    1024-byte alignment pad, the barriers and the tile index)."""
    n_qt = -(-T // BQ)
    tiles = [tile_keys(qt, T, S, n_past, n_tokens, causal, window) for qt in range(n_qt)]
    interior = [[tuple(tile_interior(qt, kt, h, n_past, n_tokens, causal, window)
                       for h in range(BQ // WG_ROWS)) for kt in range(a, b)]
                for qt, (a, b) in enumerate(tiles)]
    order = sorted(range(n_qt), key=lambda i: (tiles[i][0] - tiles[i][1], -i))
    stages = STAGES[D]
    smem = 2 * D * (BQ + 2 * stages * BK) + 1024 + 8 * (1 + 4 * stages) + 8
    return {"tiles": tiles, "interior": interior, "order": order, "stages": stages,
            "smem": smem}


def flash_attention_plain(q, k, v, n_past: int, n_tokens: int, *, scale: float,
                          causal: bool = True, sliding_window: int = 0,
                          logit_softcap: float = 0.0) -> torch.Tensor:
    """Same function in plain PyTorch: dense f32 scores, the same mask
    contract (-1e30 for masked keys), softmax, f32 product.  Over a bf16
    cache the unnormalized probabilities are rounded to bf16 before the
    P.V product and the denominator sums them unrounded, as in the kernel
    (and the Pallas kernel, flash.py:75)."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, T, Hkv, G, D)
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * scale
    if logit_softcap > 0.0:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    q_pos = n_past + torch.arange(T, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    valid = k_pos < n_past + n_tokens
    if causal:
        valid = valid & (k_pos <= q_pos)
    if sliding_window > 0:
        valid = valid & (k_pos > q_pos - sliding_window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    if v.dtype == torch.bfloat16:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        p = p.to(torch.bfloat16).float() / torch.clamp(l, min=1e-30)
    else:
        p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return out.reshape(B, T, Hq, v.shape[-1]).to(q.dtype)


def flash_attention(q, k, v, n_past: int, n_tokens: int, *, scale: float,
                    causal: bool = True, sliding_window: int = 0,
                    logit_softcap: float = 0.0) -> torch.Tensor:
    """q: [B, T, Hq, D]; k/v: [B, S, Hkv, D] (cache layout, already holding
    this step's keys) -> [B, T, Hq, D] in q's dtype.  The CUDA kernel takes
    q, k and v all bf16 (tensor-core dots, read through TMA), all f32 (f32
    dots), or an f32 q over a bf16 cache (f32 dots, probabilities rounded to
    bf16), with unit stride along D, 16-byte aligned rows and D in
    HEAD_DIMS."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, n_past, n_tokens, scale=scale,
                                     causal=causal, sliding_window=sliding_window,
                                     logit_softcap=logit_softcap)
    B, T, Hq, D = q.shape
    Bk, S, Hkv, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if D not in HEAD_DIMS or Hq % Hkv:
        raise ValueError(f"flash_attention: D={D} (need {HEAD_DIMS}), Hq={Hq}, Hkv={Hkv}")
    if not (0 <= n_past and 0 < n_tokens and n_past + n_tokens <= S):
        raise ValueError(f"flash_attention: n_past {n_past} + n_tokens {n_tokens} "
                         f"outside the cache of {S}")
    mode = MODES.get((q.dtype, k.dtype))
    if mode is None or v.dtype != k.dtype:
        raise TypeError(f"flash_attention: q {q.dtype}, k {k.dtype}, v {v.dtype}; "
                        f"need one of {sorted(MODES, key=str)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        vec = 16 // t.element_size()           # elements per 16-byte vector
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, need {q.device}")
        if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} strides {t.stride()} not "
                             "16-byte aligned with unit stride along D")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_long * 12)(*(q.stride()[:3] + k.stride()[:3]
                                     + v.stride()[:3] + o.stride()[:3]))
    FLASH.launch(ptr(q), ptr(k), ptr(v), ptr(o), ctypes.cast(strides, ctypes.c_void_p),
                 B, T, S, Hq, Hkv, D, int(n_past), int(n_tokens), float(scale),
                 int(causal), int(sliding_window), float(logit_softcap), mode,
                 stream_ptr(q.device))
    return o
