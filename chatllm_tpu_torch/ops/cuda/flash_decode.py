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
"float32" rounds nothing, "int8" (a q8 cache only; without scales it falls
back to bf16, as the JAX package does) quantizes each query row and, per
block of `block_k` keys aligned at multiples of `block_k`, each row of
p * v_scale to int8 and takes exact integer dots (its own launcher,
`flash_decode_int8`, with its own launch count).  Unset, `qk_dtype` is the
JAX package's: where it takes its batched kernel (lane-aligned head dims,
or one kv head) CHATLLM_TPU_FLASH_QK=f32|bf16|int8, read at call time,
default bf16; elsewhere (its per-head kernel) f32.  `block_k` is capped as
the batched kernel caps it (a K/V tile of at most 1 MB).
CHATLLM_TPU_FLASH_GROUP is accepted and ignored: it sets how many heads
the batched Pallas kernel packs into one block-diagonal q, whose extra
entries are exact zeros, so it changes no result.
"""
from __future__ import annotations

import ctypes
import os

import torch

from .build import FLASH_DECODE, FLASH_DECODE_INT8, ptr, stream_ptr
from .checks import KIND_BF16, KIND_F32, KIND_I8

NEG_INF = -1e30
HEAD_DIMS = (64, 128)     # head dims the CUDA kernel is instantiated for
MAX_ROWS = 64             # G * T query rows per kv head the kernel holds (csrc MAX_ROWS)
SPLIT_K = 256             # keys per split of the bf16 / f32 dots' split-K grid
MAX_BLOCK_K = 512         # keys per split of the int8 dots at most (csrc MAX_SPLIT)
QK_DTYPES = ("bfloat16", "float32", "int8")
_QK_ENV = {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}
_CACHE_KINDS = {torch.int8: KIND_I8, torch.bfloat16: KIND_BF16, torch.float32: KIND_F32}


def batched_kernel(D: int, Dv: int, Hkv: int) -> bool:
    """Where the JAX package takes its batched kernel (flash_decode.py:136)."""
    return (D % 128 == 0 and Dv % 128 == 0) or Hkv == 1


def default_qk_dtype(D: int, Dv: int, Hkv: int, quantized: bool = True) -> str:
    """The JAX package's dot dtype: in its batched kernel the one
    CHATLLM_TPU_FLASH_QK names (default bf16; int8 needs a q8 cache, else
    bf16), in its per-head kernel f32."""
    if not batched_kernel(D, Dv, Hkv):
        return "float32"
    qk = _QK_ENV.get(os.environ.get("CHATLLM_TPU_FLASH_QK", "").strip(), "bfloat16")
    return "bfloat16" if qk == "int8" and not quantized else qk


def batched_block_k(block_k: int, S: int, Hkv: int, D: int, Dv: int, itemsize: int) -> int:
    """The batched Pallas kernel's key block: halved (not below 128) while a
    [block_k, Hkv * D] tile exceeds 1 MB, then at most S
    (flash_decode.py:421-424)."""
    while block_k > 128 and block_k * Hkv * max(D, Dv) * itemsize > (1 << 20):
        block_k //= 2
    return min(block_k, S)


def npast_vector(n_past, B: int, device) -> torch.Tensor:
    """An int or an int [B] tensor as an int64 [B] tensor on `device`."""
    if isinstance(n_past, torch.Tensor):
        return n_past.to(device=device, dtype=torch.int64).reshape(-1).expand(B)
    return torch.full((B,), int(n_past), dtype=torch.int64, device=device)


def _div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127, correctly rounded on every device (PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal instead, one rounding
    more; the kernel and the Pallas kernel divide)."""
    return x / x.new_full((), 127.0)


def quantize_rows(q: torch.Tensor, scale: float):
    """Per-row symmetric int8 quantization of the query (the batched Pallas
    wrapper's, flash_decode.py:438-444): qrow = max|q| / 127 (1 where 0),
    q8 = round-half-even(q / qrow) clipped to +-127, as f32 values, and
    qrow * scale.  Rows are (b, t, head) of q [B, T, Hq, D]."""
    qf = q.float()
    amax = qf.abs().amax(dim=-1, keepdim=True)
    qrow = torch.where(amax > 0, _div127(amax), 1.0)
    return torch.clamp(torch.round(qf / qrow), -127, 127), qrow * scale


def decode_scores(q, k_cache, n_past, n_tokens: int, *, scale: float,
                  sliding_window: int = 0, logit_softcap: float = 0.0,
                  k_scale=None, qk_dtype: str | None = None) -> torch.Tensor:
    """The masked scores [B, Hkv, G, T, S] in f32 (-1e30 where masked)."""
    B, T, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qk_dtype = qk_dtype or default_qk_dtype(D, D, Hkv, k_scale is not None)
    if qk_dtype == "int8":
        # integer dots, exact in f32: f32(q8 . k8) * (qrow * scale) * k_scale
        q8, qsc = quantize_rows(q, scale)
        s = torch.einsum("bthgd,bshd->bhgts", q8.reshape(B, T, Hkv, G, D), k_cache.float())
        s = s * qsc.reshape(B, T, Hkv, G).permute(0, 2, 3, 1)[..., None]
    else:
        qg = _round(q.float(), qk_dtype).reshape(B, T, Hkv, G, D)
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


def _resolve(qk_dtype, D: int, Dv: int, Hkv: int, quantized: bool) -> str:
    qk_dtype = qk_dtype or default_qk_dtype(D, Dv, Hkv, quantized)
    if qk_dtype not in QK_DTYPES:
        raise ValueError(f"flash_decode: qk_dtype {qk_dtype!r}, need one of {QK_DTYPES}")
    # s8 dots only on a quantized cache (flash_decode.py:428-429)
    return "bfloat16" if qk_dtype == "int8" and not quantized else qk_dtype


def _int8_blocks(s, v_cache, v_scale, n_past, n_tokens: int, sliding_window: int,
                 block_k: int):
    """The int8-dot accumulation of `_batched_kernel`, block by block in
    key order: per block of `block_k` keys live for row b, the running max
    m, l += sum p, p * v_scale quantized per row over the block, acc = acc *
    corr + f32(pq . v8) * psc.  Returns (m, l, acc)."""
    B, Hkv, G, T, S = s.shape
    dev = s.device
    m = torch.full((B, Hkv, G, T, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, T, v_cache.shape[-1]), dtype=torch.float32, device=dev)
    npv = npast_vector(n_past, B, dev)
    vs = v_scale.float().transpose(1, 2)[:, :, None, None, :]              # [B, Hkv, 1, 1, S]
    for k_lo in range(0, S, block_k):
        blk = slice(k_lo, k_lo + block_k)
        live = k_lo < npv + n_tokens
        if sliding_window > 0:
            live = live & (k_lo + block_k - 1 > npv - sliding_window)
        sb = s[..., blk]
        m_new = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
        p = torch.exp(sb - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1, keepdim=True)
        p = p * vs[..., blk]
        pmax = p.amax(dim=-1, keepdim=True)
        psc = torch.where(pmax > 0, _div127(pmax), 1.0)
        pv = torch.einsum("bhgts,bshd->bhgtd", torch.round(p / psc),
                          v_cache[:, blk].float()) * psc
        sel = live[:, None, None, None, None]
        m = torch.where(sel, m_new, m)
        l = torch.where(sel, l_new, l)
        acc = torch.where(sel, acc * corr + pv, acc)
    return m, l, acc


def flash_decode_plain(q, k_cache, v_cache, n_past, n_tokens: int, *, scale: float,
                       sliding_window: int = 0, logit_softcap: float = 0.0,
                       k_scale=None, v_scale=None, sinks=None,
                       qk_dtype: str | None = None, block_k: int = 512) -> torch.Tensor:
    """Same function in plain PyTorch, with the same roundings: for bf16 or
    f32 dots dense scores over the whole cache, one max and one denominator
    per row; for int8 dots the Pallas kernel's block order
    (`_int8_blocks`).  `block_k` matters only to the int8 dots."""
    B, T, Hq, D = q.shape
    S, Hkv, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    G = Hq // Hkv
    qk_dtype = _resolve(qk_dtype, D, Dv, Hkv, k_scale is not None)
    s = decode_scores(q, k_cache, n_past, n_tokens, scale=scale,
                      sliding_window=sliding_window, logit_softcap=logit_softcap,
                      k_scale=k_scale, qk_dtype=qk_dtype)
    if qk_dtype == "int8":
        bk = batched_block_k(block_k, S, Hkv, D, Dv, k_cache.element_size())
        m, l, acc = _int8_blocks(s, v_cache, v_scale, n_past, n_tokens, sliding_window, bk)
    else:
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
                 qk_dtype: str | None = None, block_k: int = 512) -> torch.Tensor:
    """q: [B, T, Hq, D] (T small); k/v_cache: [B, S, Hkv, D] — int8 when
    k_scale/v_scale (f32 [B, S, Hkv]) are given, bf16 or f32 otherwise.
    n_past: an int or an int64 [B] tensor of per-row frontiers; sinks: f32
    [Hq] or None; qk_dtype "bfloat16", "float32" or "int8" (module
    docstring), block_k the int8 dots' quantization block before the
    batched kernel's cap.  Returns [B, T, Hq, D] in q's dtype.

    The CUDA kernel takes bf16 or f32 q, D in HEAD_DIMS, G * T <= MAX_ROWS
    (64), cache rows 16-byte aligned with unit stride along D (a permuted
    [B, Hkv, S, D] cache passes), scales of any strides (so do [B, Hkv, S]
    ones, permuted), and for int8 dots a capped block_k of at most 512."""
    B, T, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    quant = k_scale is not None
    qk_dtype = _resolve(qk_dtype, D, Dv, Hkv, quant)
    kw = dict(scale=scale, sliding_window=sliding_window, logit_softcap=logit_softcap,
              k_scale=k_scale, v_scale=v_scale, sinks=sinks, qk_dtype=qk_dtype)
    if not q.is_cuda:
        return flash_decode_plain(q, k_cache, v_cache, n_past, n_tokens, block_k=block_k, **kw)

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
                              or tuple(t.shape) != shape):
            raise ValueError(f"flash_decode: {name} must be f32 {shape} (any strides) on {dev}")
    if sinks is not None and not sinks.is_contiguous():
        raise ValueError("flash_decode: sinks must be contiguous")
    np_vec, np_scalar = None, 0
    if isinstance(n_past, torch.Tensor):
        if n_past.device != dev or n_past.dtype != torch.int64 or tuple(n_past.shape) != (B,):
            raise ValueError("flash_decode: a per-row n_past must be int64 [B] on "
                             f"{dev}, got {n_past.dtype} {tuple(n_past.shape)} on "
                             f"{n_past.device}")
        np_vec = n_past.contiguous()
    else:
        np_scalar = int(n_past)

    int8_dots = qk_dtype == "int8"
    split = batched_block_k(block_k, S, Hkv, D, Dv, 1) if int8_dots else SPLIT_K
    if not 0 < split <= MAX_BLOCK_K:
        raise ValueError(f"flash_decode: int8 dots over blocks of {split} keys "
                         f"(1..{MAX_BLOCK_K})")
    n_splits = -(-S // split)
    R = G * T
    part_ml = torch.empty(B, Hkv, n_splits, R, 2, dtype=torch.float32, device=dev)
    part_acc = torch.empty(B, Hkv, n_splits, R, D, dtype=torch.float32, device=dev)
    o = torch.empty(B, T, Hq, D, dtype=q.dtype, device=dev)
    sc_strides = k_scale.stride() + v_scale.stride() if quant else (0,) * 6
    strides = (ctypes.c_long * 18)(*(q.stride()[:3] + k_cache.stride()[:3]
                                     + v_cache.stride()[:3] + o.stride()[:3] + sc_strides))
    args = (ptr(q), ptr(k_cache), ptr(v_cache), ptr(k_scale), ptr(v_scale), ptr(sinks),
            ptr(np_vec), np_scalar, ptr(o), ptr(part_ml), ptr(part_acc),
            ctypes.cast(strides, ctypes.c_void_p), B, T, S, Hq, Hkv, D, int(n_tokens),
            float(scale), int(sliding_window), float(logit_softcap),
            KIND_F32 if q.dtype == torch.float32 else KIND_BF16)
    if int8_dots:
        FLASH_DECODE_INT8.launch(*args, split, stream_ptr(dev))
    else:
        FLASH_DECODE.launch(*args, kind, int(qk_dtype == "bfloat16"), split, stream_ptr(dev))
    return o
