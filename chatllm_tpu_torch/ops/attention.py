"""Attention over a static-shape KV cache (counterpart of the JAX package's
`ops/attention.py`: bf16/f32 and q8 caches, a scalar n_past or a per-slot
[B] n_past vector).

The cache is a pair of [B, S_max, H_kv, D] tensors written in place; a q8
cache holds int8 values with f32 [B, S_max, H_kv] scales beside them.
Routing follows the JAX package's conditions:

  - long prefill chunks over a float cache -> K3, flash attention
    (`ops/cuda/flash.py`);
  - decode steps over a long q8 cache with few rows -> K4, flash decode
    (`ops/cuda/flash_decode.py`);
  - a per-slot n_past vector -> `_batched_npast_attention` (dense, per-row
    masks);
  - caches of >= 4096 slots -> `_chunked_attention` (online softmax over
    1024-key chunks, no [T, S] score tensor);
  - otherwise the dense path below, which is the reference semantics.

The JAX package's switches are read at call time, as it reads them:
CHATLLM_TPU_FLASH=0/1 gates K3, CHATLLM_TPU_FLASH_DECODE=0/1 gates K4
(unset: as CHATLLM_TPU_FLASH), and CHATLLM_TPU_FLASH_DECODE=1 is its forced
mode, which sends every decode step of T <= 8 over a cache of >= 512 slots
to K4, whatever the cache dtype and B * G * T.  K4's dot dtype
(CHATLLM_TPU_FLASH_QK) and CHATLLM_TPU_FLASH_GROUP are read by
`ops/cuda/flash_decode.py`.  Unset, a switch means what it means on the
JAX package's TPU: the kernels are on.  The JAX package takes the kernels
on the CPU only when a switch says so; the port always takes them, and
each kernel wrapper runs its plain PyTorch version for CPU tensors (that is
what the CPU tests compare) and launches its CUDA kernel for tensors on the
card.
"""
from __future__ import annotations

import os

import torch

from .cuda.flash import flash_attention
from .cuda.flash_decode import flash_decode
from .qmm import _count

NEG_INF = -1e30
CHUNKED_ATTN_THRESHOLD = 4096   # online-softmax KV chunks from this cache size
FLASH_MIN_Q = 128               # min query tokens for the flash path
FLASH_MIN_KV = 1024             # min cache length for the flash path
DECODE_MAX_Q = 8                # max query tokens for the flash-decode path
DECODE_MIN_KV = 4096            # min cache length for the flash-decode path
DECODE_FORCED_MIN_KV = 512      # ... under CHATLLM_TPU_FLASH_DECODE=1
DECODE_MAX_ROWS = 16            # max B * G * T for the flash-decode path


def _switch(name: str):
    """An environment switch "0"/"1" as a bool; None when unset or other."""
    env = os.environ.get(name, "").strip()
    return env == "1" if env in ("0", "1") else None


def flash_enabled() -> bool:
    """K3 (CHATLLM_TPU_FLASH; on unless it is 0)."""
    return _switch("CHATLLM_TPU_FLASH") is not False


def flash_decode_enabled() -> bool:
    """K4 (CHATLLM_TPU_FLASH_DECODE, else as CHATLLM_TPU_FLASH)."""
    env = _switch("CHATLLM_TPU_FLASH_DECODE")
    return flash_enabled() if env is None else env


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization of K/V vectors (the q8
    cache mode).  x: [B, T, H, D] -> (int8 [B, T, H, D], scale f32 [B, T, H]);
    bit for bit the JAX package's: round half to even, clip to +-127, and a
    zero scale gives zero values.  The max is divided by a 0-d tensor: on the
    card PyTorch turns a division by a Python scalar into a multiplication by
    its reciprocal, which rounds differently in the last bit."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / xf.new_full((), 127.0)
    inv = torch.where(scale > 0, 1.0 / torch.where(scale == 0, 1.0, scale), 0.0)
    q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _rows_write(cache: torch.Tensor, val: torch.Tensor, n_past: torch.Tensor):
    """cache[b, n_past[b] + t] = val[b, t] in place, dropping the rows whose
    position is past the cache (the JAX package's scatter mode="drop").

    Positions are taken mod S: for T <= S the T positions of a row are then
    distinct, and a dropped row rewrites the value it finds, so no write
    lands twice and none is lost."""
    B, T = val.shape[:2]
    S = cache.shape[1]
    pos = n_past[:, None] + torch.arange(T, device=cache.device)       # [B, T]
    b_idx = torch.arange(B, device=cache.device)[:, None].expand(B, T)
    posm = pos % S
    keep = (pos < S).reshape(B, T, *([1] * (val.dim() - 2)))
    cache[b_idx, posm] = torch.where(keep, val.to(cache.dtype), cache[b_idx, posm])


def update_kv_cache(k_cache, v_cache, k, v, n_past, k_scale=None, v_scale=None):
    """Write new K/V ([B, T, H, D]) at position n_past, in place (and their
    scales, for a q8 cache).

    `n_past` is an int (all rows share one write offset: the chat path) or
    an int64 [B] tensor on the cache's device (per-slot offsets: the
    continuous-batching decode, runtime/batching.py); rows past capacity
    are dropped, not clamped onto the last slot."""
    if k_scale is not None:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    if isinstance(n_past, torch.Tensor):
        _rows_write(k_cache, k, n_past)
        _rows_write(v_cache, v, n_past)
        if k_scale is not None:
            _rows_write(k_scale, ks, n_past)
            _rows_write(v_scale, vs, n_past)
        return
    T = k.shape[1]
    k_cache[:, n_past:n_past + T] = k.to(k_cache.dtype)
    v_cache[:, n_past:n_past + T] = v.to(v_cache.dtype)
    if k_scale is not None:
        k_scale[:, n_past:n_past + T] = ks
        v_scale[:, n_past:n_past + T] = vs


def _pick_block(dim: int, want: int, lo: int = 16) -> int:
    b = min(want, dim)
    while b > lo and dim % b != 0:
        b //= 2
    return b if dim % b == 0 else 0


def _dot(sub: str, a, b, bf16_dots: bool):
    """Attention einsum in f32.  With `bf16_dots` both operands are rounded
    to bf16 first: the JAX package's bf16 MXU dots with f32 accumulation
    (a bf16 x bf16 product is exact in f32; int8 values are exact in bf16)."""
    a, b = a.float(), b.float()
    if bf16_dots:
        a, b = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    return torch.einsum(sub, a, b)


def _scale_rows(x, scale):
    """Multiply [B, Hkv, G, T, S] by per-(key, head) scales [B, S, Hkv]."""
    return x * scale.float().transpose(1, 2)[:, :, None, None, :]


def _mask(n_past, T: int, k_pos, n_tokens: int, causal: bool, sliding_window: int):
    """Valid (query, key) pairs: [T, S] for an int n_past, [B, T, S] for a
    per-row vector."""
    if isinstance(n_past, torch.Tensor):
        q_pos = n_past[:, None, None] + torch.arange(T, device=k_pos.device)[None, :, None]
        kv_end = n_past[:, None, None] + n_tokens
    else:
        q_pos = n_past + torch.arange(T, device=k_pos.device)[:, None]
        kv_end = n_past + n_tokens
    valid = k_pos < kv_end
    if causal:
        valid = valid & (k_pos <= q_pos)
    if sliding_window > 0:
        valid = valid & (k_pos > q_pos - sliding_window)
    return valid


def attention_with_cache(q, k_cache, v_cache, n_past, n_tokens=None, *,
                         scale: float, causal: bool = True,
                         logit_softcap: float = 0.0, sliding_window: int = 0,
                         k_scale=None, v_scale=None) -> torch.Tensor:
    """q: [B, T, Hq, D]; caches [B, S, Hkv, D] already holding this step's
    keys (int8 with [B, S, Hkv] scales for a q8 cache).  A key at position p
    is visible to query t of row b iff p < n_past[b] + n_tokens (and
    p <= n_past[b] + t when causal, and p > n_past[b] + t - sliding_window
    with a window).  `n_past` is an int or an int64 [B] tensor."""
    B, T, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    G = Hq // Hkv
    if n_tokens is None:
        n_tokens = T

    # K3 under the JAX package's conditions.  The query keeps its dtype (a
    # bf16 one is promoted over an f32 cache, exactly), as the Pallas
    # kernel's mixed-dtype dots do; the output is q's dtype.
    if (T >= FLASH_MIN_Q and S >= FLASH_MIN_KV and k_scale is None and Dv == D
            and not isinstance(n_past, torch.Tensor) and flash_enabled()
            and _pick_block(T, 512) >= 128 and _pick_block(S, 512) >= 256):
        _count("flash_attention")
        qf = q.to(torch.promote_types(q.dtype, k_cache.dtype))
        out = flash_attention(qf, k_cache, v_cache, n_past, n_tokens, scale=scale,
                              causal=causal, sliding_window=sliding_window,
                              logit_softcap=logit_softcap)
        return out.to(q.dtype)

    # K4 under the JAX package's conditions (attention.py:334-364, its TPU
    # routing): decode steps over a long q8 cache with few rows, or under
    # the forced mode any decode step over a cache of >= 512 slots.  The
    # key block is the JAX route's (the int8 dots quantize p over it).
    forced = _switch("CHATLLM_TPU_FLASH_DECODE") is True
    block_k = _pick_block(S, 512, lo=128)
    if (T <= DECODE_MAX_Q and S >= (DECODE_FORCED_MIN_KV if forced else DECODE_MIN_KV)
            and causal and (forced or (B * G * T <= DECODE_MAX_ROWS and k_scale is not None))
            and flash_decode_enabled() and block_k >= 128):
        _count("flash_decode" + (":q8kv" if k_scale is not None else ""))
        return flash_decode(q, k_cache, v_cache, n_past, n_tokens, scale=scale,
                            sliding_window=sliding_window, logit_softcap=logit_softcap,
                            k_scale=k_scale, v_scale=v_scale, block_k=block_k)

    qg = q.reshape(B, T, Hkv, G, D)
    # bf16 dots only when the cache carries no extra precision to lose: int8
    # values are exact in bf16, and a bf16 cache is already bf16.
    bf16_dots = (q.dtype == torch.bfloat16
                 and k_cache.dtype in (torch.int8, torch.bfloat16))
    kw = dict(scale=scale, causal=causal, logit_softcap=logit_softcap,
              sliding_window=sliding_window, k_scale=k_scale, v_scale=v_scale,
              bf16_dots=bf16_dots)

    if isinstance(n_past, torch.Tensor):
        out = _batched_npast_attention(qg, k_cache, v_cache, n_past, n_tokens, **kw)
        return out.reshape(B, T, Hq, Dv).to(q.dtype)

    if S >= CHUNKED_ATTN_THRESHOLD and S % 1024 == 0:
        out = _chunked_attention(qg, k_cache, v_cache, n_past, n_tokens, **kw)
        return out.reshape(B, T, Hq, Dv).to(q.dtype)

    # Keys at or past n_past + n_tokens are masked for every row; dropping
    # them leaves each row with a visible key unchanged (its masked scores
    # weigh exp(-1e30 - max) = 0) and keeps decode off the unwritten cache.
    kv_len = min(S, n_past + n_tokens)
    kc, vc = k_cache[:, :kv_len], v_cache[:, :kv_len]
    scores = _dot("bthgd,bshd->bhgts", qg, kc, bf16_dots) * scale
    if k_scale is not None:
        scores = _scale_rows(scores, k_scale[:, :kv_len])
    if logit_softcap > 0.0:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    k_pos = torch.arange(kv_len, device=q.device)[None, :]
    valid = _mask(n_past, T, k_pos, n_tokens, causal, sliding_window)
    p = torch.softmax(scores + torch.where(valid, 0.0, NEG_INF), dim=-1)
    if v_scale is not None:
        p = _scale_rows(p, v_scale[:, :kv_len])
    out = _dot("bhgts,bshd->bthgd", p, vc, bf16_dots)
    return out.reshape(B, T, Hq, Dv).to(q.dtype)


def _chunked_attention(qg, k_cache, v_cache, n_past: int, n_tokens: int, *, scale,
                       causal, logit_softcap, sliding_window, k_scale=None,
                       v_scale=None, bf16_dots=False, chunk: int = 1024):
    """Flash-style attention over KV chunks with a running softmax, so the
    [T, S] score matrix never materializes (long-context prefill).  Exact,
    with the dense path's masking.  Chunks that no row can see are skipped:
    in the JAX package's scan they change nothing (a chunk past the written
    keys adds p = 0 with corr = 1; one before every window is wiped by
    corr = 0 once a visible key arrives).  Returns [B, T, Hkv, G, Dv]."""
    B, T, Hkv, G, D = qg.shape
    S = k_cache.shape[1]
    Dv = v_cache.shape[-1]
    dev = qg.device
    m = torch.full((B, Hkv, G, T), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, T), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, T, Dv), dtype=torch.float32, device=dev)
    k_end = min(S, n_past + n_tokens)
    k_begin = max(0, n_past - sliding_window + 1) if sliding_window > 0 else 0
    for c0 in range(k_begin // chunk * chunk, k_end, chunk):
        sl = slice(c0, c0 + chunk)
        s = _dot("bthgd,bshd->bhgts", qg, k_cache[:, sl], bf16_dots) * scale
        if k_scale is not None:
            s = _scale_rows(s, k_scale[:, sl])
        if logit_softcap > 0.0:
            s = torch.tanh(s / logit_softcap) * logit_softcap
        k_pos = c0 + torch.arange(chunk, device=dev)[None, :]
        valid = _mask(n_past, T, k_pos, n_tokens, causal, sliding_window)
        s = s + torch.where(valid, 0.0, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        if v_scale is not None:
            p = _scale_rows(p, v_scale[:, sl])
        acc = acc * corr[..., None] + _dot("bhgts,bshd->bhgtd", p, v_cache[:, sl],
                                           bf16_dots)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4)                  # [B, T, Hkv, G, Dv]


def _batched_npast_attention(qg, k_cache, v_cache, n_past: torch.Tensor, n_tokens: int,
                             *, scale, causal, logit_softcap, sliding_window,
                             k_scale=None, v_scale=None, bf16_dots=False):
    """Dense attention with a per-row n_past vector [B]: each batch slot
    sees its own causal frontier (the continuous-batching decode over one
    shared [B, S] cache).  Returns [B, T, Hkv, G, Dv]."""
    B, T, Hkv, G, D = qg.shape
    S = k_cache.shape[1]
    scores = _dot("bthgd,bshd->bhgts", qg, k_cache, bf16_dots) * scale
    if k_scale is not None:
        scores = _scale_rows(scores, k_scale)
    if logit_softcap > 0.0:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    k_pos = torch.arange(S, device=qg.device)[None, None, :]
    valid = _mask(n_past, T, k_pos, n_tokens, causal, sliding_window)     # [B, T, S]
    p = torch.softmax(scores + torch.where(valid, 0.0, NEG_INF)[:, None, None], dim=-1)
    if v_scale is not None:
        p = _scale_rows(p, v_scale)
    return _dot("bhgts,bshd->bthgd", p, v_cache, bf16_dots)
