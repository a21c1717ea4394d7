"""K4: flash decode, small-T attention over the whole KV cache
(csrc/flash_decode.cu).

Replaces chatllm_tpu/ops/pallas/flash_decode.py::flash_decode (its batched
all-heads kernel `_batched_kernel` and its per-head kernel `_decode_kernel`).
`flash_decode` launches the CUDA kernel for CUDA tensors and runs
`flash_decode_plain`, its plain PyTorch version, for CPU tensors.

The contract, as in the Pallas kernels: the G*T query rows of each kv head
are folded together, row r = g*T + t at position n_past[b] + t.  A key at
position p is valid iff p < n_past[b] + n_tokens, p <= q_pos and, with a
window, p > q_pos - window; masked scores are -1e30.  For a q8 cache the
k scale multiplies the scores after q.k and the v scale multiplies the
probabilities after their row sum is taken, so the denominator sums the
unscaled p.  Sinks join the denominator at the end and emit no value; the
denominator is clamped at 1e-30.  Dots run in `qk_dtype`: "bfloat16" rounds
q and p * v_scale (and an f32 cache's K/V) to bf16 with f32 accumulation,
"float32" rounds nothing.
"""
from __future__ import annotations

import ctypes

import torch

from .build import FLASH_DECODE, ptr, stream_ptr
from .checks import KIND_BF16, KIND_F32, KIND_I8

NEG_INF = -1e30
HEAD_DIMS = (64, 128)     # head dims the CUDA kernel is instantiated for
MAX_ROWS = 32             # G * T query rows per kv head the kernel holds
SPLIT_K = 256             # keys per block of the split-K grid (csrc SPLIT)
QK_DTYPES = ("bfloat16", "float32")
_CACHE_KINDS = {torch.int8: KIND_I8, torch.bfloat16: KIND_BF16, torch.float32: KIND_F32}


def default_qk_dtype(D: int, Dv: int, Hkv: int) -> str:
    """The JAX package's dot dtype: bf16 where it takes its batched kernel
    (lane-aligned head dims, or one kv head), f32 in its per-head kernel."""
    return "bfloat16" if (D % 128 == 0 and Dv % 128 == 0) or Hkv == 1 else "float32"


def npast_vector(n_past, B: int, device) -> torch.Tensor:
    """An int or an int [B] tensor as an int64 [B] tensor on `device`."""
    if isinstance(n_past, torch.Tensor):
        return n_past.to(device=device, dtype=torch.int64).reshape(-1).expand(B)
    return torch.full((B,), int(n_past), dtype=torch.int64, device=device)


def decode_scores(q, k_cache, n_past, n_tokens: int, *, scale: float,
                  sliding_window: int = 0, logit_softcap: float = 0.0,
                  k_scale=None, qk_dtype: str | None = None) -> torch.Tensor:
    """The masked scores [B, Hkv, G, T, S] in f32 (-1e30 where masked)."""
    B, T, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    qk_dtype = qk_dtype or default_qk_dtype(D, D, Hkv)
    qg = _round(q.float(), qk_dtype).reshape(B, T, Hkv, Hq // Hkv, D)
    s = torch.einsum("bthgd,bshd->bhgts", qg, _round(k_cache.float(), qk_dtype)) * scale
    if k_scale is not None:
        s = s * k_scale.float().transpose(1, 2)[:, :, None, None, :]
    if logit_softcap > 0.0:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    npv = npast_vector(n_past, B, q.device)
    q_pos = npv[:, None, None] + torch.arange(T, device=q.device)[None, :, None]
    k_pos = torch.arange(S, device=q.device)[None, None, :]
    valid = (k_pos < npv[:, None, None] + n_tokens) & (k_pos <= q_pos)
    if sliding_window > 0:
        valid = valid & (k_pos > q_pos - sliding_window)
    return torch.where(valid[:, None, None], s, NEG_INF)


def _round(x: torch.Tensor, qk_dtype: str) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if qk_dtype == "bfloat16" else x


def flash_decode_plain(q, k_cache, v_cache, n_past, n_tokens: int, *, scale: float,
                       sliding_window: int = 0, logit_softcap: float = 0.0,
                       k_scale=None, v_scale=None, sinks=None,
                       qk_dtype: str | None = None) -> torch.Tensor:
    """Same function in plain PyTorch: dense scores over the whole cache,
    one max and one denominator per row, the same roundings."""
    B, T, Hq, D = q.shape
    Hkv, Dv = k_cache.shape[2], v_cache.shape[-1]
    G = Hq // Hkv
    qk_dtype = qk_dtype or default_qk_dtype(D, Dv, Hkv)
    s = decode_scores(q, k_cache, n_past, n_tokens, scale=scale,
                      sliding_window=sliding_window, logit_softcap=logit_softcap,
                      k_scale=k_scale, qk_dtype=qk_dtype)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float().transpose(1, 2)[:, :, None, None, :]
    acc = torch.einsum("bhgts,bshd->bhgtd", _round(p, qk_dtype),
                       _round(v_cache.float(), qk_dtype))
    if sinks is not None:
        sk = sinks.float().reshape(Hkv, G)[None, :, :, None, None]
        m_f = torch.maximum(m, sk)
        l = l * torch.exp(m - m_f) + torch.exp(sk - m_f)
        out = acc * (torch.exp(m - m_f) / torch.clamp(l, min=1e-30))
    else:
        out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, Dv).to(q.dtype)


def _check_vec_rows(name: str, t: torch.Tensor):
    vec = 16 // t.element_size()
    if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"flash_decode: {name} strides {t.stride()} not 16-byte "
                         "aligned with unit stride along D")


def flash_decode(q, k_cache, v_cache, n_past, n_tokens: int, *, scale: float,
                 sliding_window: int = 0, logit_softcap: float = 0.0,
                 k_scale=None, v_scale=None, sinks=None,
                 qk_dtype: str | None = None) -> torch.Tensor:
    """q: [B, T, Hq, D] (T small); k/v_cache: [B, S, Hkv, D] — int8 when
    k_scale/v_scale (f32 [B, S, Hkv]) are given, bf16 or f32 otherwise.
    n_past: an int or an int64 [B] tensor of per-row frontiers; sinks: f32
    [Hq] or None.  Returns [B, T, Hq, D] in q's dtype.

    The CUDA kernel takes bf16 or f32 q, D in HEAD_DIMS, G * T <= MAX_ROWS,
    16-byte aligned cache rows with unit stride along D, contiguous scales."""
    B, T, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    qk_dtype = qk_dtype or default_qk_dtype(D, Dv, Hkv)
    if qk_dtype not in QK_DTYPES:
        raise ValueError(f"flash_decode: qk_dtype {qk_dtype!r}, need one of {QK_DTYPES}")
    kw = dict(scale=scale, sliding_window=sliding_window, logit_softcap=logit_softcap,
              k_scale=k_scale, v_scale=v_scale, sinks=sinks, qk_dtype=qk_dtype)
    if not q.is_cuda:
        return flash_decode_plain(q, k_cache, v_cache, n_past, n_tokens, **kw)

    dev = q.device
    G = Hq // Hkv
    if (tuple(v_cache.shape) != tuple(k_cache.shape) or k_cache.shape[0] != B
            or Dv != D or Hq % Hkv):
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    if D not in HEAD_DIMS or G * T > MAX_ROWS:
        raise ValueError(f"flash_decode: D={D} (need {HEAD_DIMS}), G*T={G * T} "
                         f"(at most {MAX_ROWS})")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_decode: q {q.dtype}, need bfloat16 or float32")
    kind = _CACHE_KINDS.get(k_cache.dtype)
    quant = k_scale is not None
    if (kind is None or v_cache.dtype != k_cache.dtype
            or (kind == KIND_I8) != quant or (v_scale is not None) != quant):
        raise TypeError(f"flash_decode: cache {k_cache.dtype}/{v_cache.dtype} with"
                        f"{'' if quant else 'out'} scales; need int8 with scales, "
                        "or bf16/f32 without")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != dev:
            raise ValueError(f"flash_decode: {name} on {t.device}, need {dev}")
    _check_vec_rows("k_cache", k_cache)
    _check_vec_rows("v_cache", v_cache)
    for name, t, shape in (("k_scale", k_scale, (B, S, Hkv)), ("v_scale", v_scale, (B, S, Hkv)),
                           ("sinks", sinks, (Hq,))):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"flash_decode: {name} must be contiguous f32 {shape} on {dev}")
    np_vec, np_scalar = None, 0
    if isinstance(n_past, torch.Tensor):
        if n_past.device != dev or n_past.dtype != torch.int64 or tuple(n_past.shape) != (B,):
            raise ValueError("flash_decode: a per-row n_past must be int64 [B] on "
                             f"{dev}, got {n_past.dtype} {tuple(n_past.shape)} on "
                             f"{n_past.device}")
        np_vec = n_past.contiguous()
    else:
        np_scalar = int(n_past)

    n_splits = -(-S // SPLIT_K)
    R = G * T
    part_ml = torch.empty(B, Hkv, n_splits, R, 2, dtype=torch.float32, device=dev)
    part_acc = torch.empty(B, Hkv, n_splits, R, D, dtype=torch.float32, device=dev)
    o = torch.empty(B, T, Hq, D, dtype=q.dtype, device=dev)
    strides = (ctypes.c_long * 12)(*(q.stride()[:3] + k_cache.stride()[:3]
                                     + v_cache.stride()[:3] + o.stride()[:3]))
    FLASH_DECODE.launch(
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(k_scale), ptr(v_scale), ptr(sinks),
        ptr(np_vec), np_scalar, ptr(o), ptr(part_ml), ptr(part_acc),
        ctypes.cast(strides, ctypes.c_void_p), B, T, S, Hq, Hkv, D, int(n_tokens),
        float(scale), int(sliding_window), float(logit_softcap),
        KIND_F32 if q.dtype == torch.float32 else KIND_BF16, kind,
        int(qk_dtype == "bfloat16"), stream_ptr(dev))
    return o
