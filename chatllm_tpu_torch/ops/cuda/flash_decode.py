"""K4: flash decode, small-T attention over the whole KV cache
(csrc/flash_decode.cu).

Replaces chatllm_tpu/ops/pallas/flash_decode.py::flash_decode (its batched
all-heads kernel `_batched_kernel` and its per-head kernel `_decode_kernel`).
`flash_decode` launches the CUDA kernel for CUDA tensors and runs
`flash_decode_plain`, its plain PyTorch version, for CPU tensors.  A call
is one launch: a cluster of `decode_geometry` blocks per (batch row, kv
head), each taking its share of the row's live keys (`live_range`): with
bf16 or f32 dots 64-key tiles (32 over an f32 cache at D 256:
`float_tile`; `decode_share`), with int8 dots whole
quantization blocks or, where a row has fewer live blocks than the cluster
has ranks, tiles of one block (`int8_share`); merged inside the cluster.
The wrapper allocates nothing but the output.

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
DeepSeek-V2's expanded MLA cache (K 192 wide, V 128, one query head per kv
head) takes the per-head kernel's f32 dots (MLA_DIMS), with K and V tiles
of their own widths and the output V wide.
CHATLLM_TPU_FLASH_GROUP is accepted and ignored: it sets how many heads
the batched Pallas kernel packs into one block-diagonal q, whose extra
entries are exact zeros, so it changes no result.
"""
from __future__ import annotations

import ctypes
import os

import torch

from .build import FLASH_DECODE, FLASH_DECODE_INT8, FLASH_DECODE_WIDE, num_sms, ptr, stream_ptr
from .checks import KIND_BF16, KIND_F32, KIND_I8

NEG_INF = -1e30
HEAD_DIMS = (64, 80, 96, 128, 256)   # head dims (K = V) the CUDA kernel is instantiated for
MLA_DIMS = (192, 128)     # ... and MLA's K / V widths, float dots only
WIDE_DIMS = (80, 96, 256)  # the float dots' head dims built in their own library
MAX_ROWS = 64             # G * T query rows per kv head the kernel holds (csrc MAX_ROWS)
D256_MAX_ROWS = 32        # ... at D 256 (csrc `max_rows`: 64 rows' buffers pass the
#                           shared memory): Gemma-3-1B's 4 query heads a kv head at T 8;
#                           Gemma-2B's 8 at T > 4 (only under CHATLLM_TPU_FLASH_DECODE=1) raise
MLA_MAX_ROWS = 8          # ... at MLA_DIMS (one query head per kv head, T <= 8)
TILE_K = 64               # keys per tile of the bf16 / f32 dots (csrc FTK)
F32_D256_TILE_K = 32      # ... over an f32 cache at D 256 (csrc FGeom::TK: two stages fit)
MAX_CLUSTER = 16          # their blocks per (batch row, kv head) at most (csrc MAX_CLUSTER)
PORTABLE_CLUSTER = 8      # above it the launcher sets the non-portable cluster attribute
MAX_BLOCK_K = 512         # keys per quantization block of the int8 dots at most (csrc MAX_BLOCK_K)
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


def decode_geometry(B: int, Hkv: int, S: int, sms: int) -> int:
    """Blocks per (batch row, kv head), for every dot dtype: each (b, kv
    head) is one thread-block cluster of C blocks, C about two blocks per
    SM over the B * Hkv clusters, at least 1 and at most MAX_CLUSTER (above
    PORTABLE_CLUSTER the launcher allows a non-portable cluster) and at most
    one block per 64-key tile of the cache.  The grid is (C, Hkv, B)."""
    return max(1, min(MAX_CLUSTER, 2 * sms // (B * Hkv), -(-S // TILE_K)))


def live_range(n_past: int, n_tokens: int, S: int, sliding_window: int = 0) -> tuple[int, int]:
    """The keys [lo, hi) some query row of a batch row may see, as the
    kernel takes them from its n_past (csrc `live_keys`)."""
    lo = n_past - sliding_window + 1 if sliding_window > 0 else 0
    return min(max(lo, 0), S), min(max(n_past + n_tokens, 0), S)


def float_tile(D: int, cache_dtype: torch.dtype) -> int:
    """Keys per tile of the bf16 / f32 dots over a cache of `cache_dtype`
    at head dim D (csrc FGeom::TK)."""
    return F32_D256_TILE_K if D == 256 and cache_dtype == torch.float32 else TILE_K


def decode_share(lo: int, hi: int, rank: int, ctas: int,
                 tile: int = TILE_K) -> tuple[int, int]:
    """The keys [begin, end) that block `rank` of a cluster of `ctas` takes
    of the live keys [lo, hi) (csrc `decode_kernel`): the `tile`-key tiles
    (`float_tile`) aligned at multiples of the tile that meet [lo, hi), split
    into `ctas` contiguous runs in rank order, clipped to [lo, hi); empty
    when begin >= end."""
    t0 = lo // tile
    nt = -(-hi // tile) - t0 if hi > lo else 0
    ta, tb = t0 + rank * nt // ctas, t0 + (rank + 1) * nt // ctas
    return max(ta * tile, lo), min(tb * tile, hi)


def block_tiles(j: int, lo: int, hi: int, block_k: int) -> tuple[int, int]:
    """The live tiles [u0, u1) of quantization block j (keys [j block_k,
    (j + 1) block_k)): its TILE_K-key tiles, aligned at the block's first
    key, that meet [lo, hi) (csrc `block_tiles`)."""
    base = j * block_k
    a, e = max(base, lo), min(base + block_k, hi)
    u0 = (a - base) // TILE_K
    return u0, (-(-(e - base) // TILE_K) if e > a else u0)


def int8_share(lo: int, hi: int, rank: int, ctas: int,
               block_k: int) -> tuple[int, int, int, int]:
    """What block `rank` of a cluster of `ctas` takes of the live keys [lo,
    hi) with int8 dots (csrc `int8_share`), as (begin, end, first, count):
    the keys [begin, end) (empty when begin >= end) and the ranks [first,
    first + count) that take its quantization block.  The nb blocks of
    `block_k` keys aligned at multiples of block_k that meet [lo, hi): with
    nb >= ctas each rank takes a contiguous run of whole blocks (count 1);
    with fewer, block j goes to the ranks [j ctas // nb, (j + 1) ctas //
    nb), which split its live TILE_K-key tiles, aligned at the block's
    start, into contiguous runs in rank order."""
    if hi <= lo:
        return lo, lo, rank, 1
    q0 = lo // block_k
    nb = -(-hi // block_k) - q0
    if nb >= ctas:
        j0, j1 = q0 + rank * nb // ctas, q0 + (rank + 1) * nb // ctas
        return max(j0 * block_k, lo), min(j1 * block_k, hi), rank, 1
    j = ((rank + 1) * nb - 1) // ctas
    first = j * ctas // nb
    count = (j + 1) * ctas // nb - first
    base = (q0 + j) * block_k
    u0, u1 = block_tiles(q0 + j, lo, hi, block_k)
    i, n = rank - first, u1 - u0
    ta, tb = u0 + i * n // count, u0 + (i + 1) * n // count
    return (max(base + ta * TILE_K, lo), min(base + tb * TILE_K, base + block_k, hi),
            first, count)


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
    """q: [B, T, Hq, D] (T small); k_cache: [B, S, Hkv, D], v_cache: [B, S,
    Hkv, Dv] — int8 when k_scale/v_scale (f32 [B, S, Hkv]) are given, bf16 or
    f32 otherwise.
    n_past: an int or an int64 [B] tensor of per-row frontiers; sinks: f32
    [Hq] or None; qk_dtype "bfloat16", "float32" or "int8" (module
    docstring), block_k the int8 dots' quantization block before the
    batched kernel's cap.  Returns [B, T, Hq, Dv] in q's dtype.

    The CUDA kernel takes bf16 or f32 q, D = Dv in HEAD_DIMS with G * T <=
    MAX_ROWS (64; D256_MAX_ROWS, 32, at D 256), or with bf16 or f32 dots
    (D, Dv) = MLA_DIMS with G * T <= MLA_MAX_ROWS (8), cache rows 16-byte aligned with unit stride along D (a permuted
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
    if (tuple(v_cache.shape[:3]) != tuple(k_cache.shape[:3]) or k_cache.shape[0] != B
            or k_cache.shape[-1] != D or Hq % Hkv):
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    mla = (D, Dv) == MLA_DIMS and qk_dtype != "int8"
    most = MLA_MAX_ROWS if mla else D256_MAX_ROWS if D == 256 else MAX_ROWS
    if not (mla or (D == Dv and D in HEAD_DIMS)) or G * T > most:
        raise ValueError(f"flash_decode: (D, Dv)=({D}, {Dv}) with {qk_dtype} dots, G*T={G * T} "
                         f"(need D = Dv in {HEAD_DIMS} with G*T <= {MAX_ROWS}, "
                         f"{D256_MAX_ROWS} at D 256, or {MLA_DIMS} with float dots and "
                         f"G*T <= {MLA_MAX_ROWS})")
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

    o = torch.empty(B, T, Hq, Dv, dtype=q.dtype, device=dev)
    sc_strides = k_scale.stride() + v_scale.stride() if quant else (0,) * 6
    strides = (ctypes.c_long * 18)(*(q.stride()[:3] + k_cache.stride()[:3]
                                     + v_cache.stride()[:3] + o.stride()[:3] + sc_strides))
    head = (ptr(q), ptr(k_cache), ptr(v_cache), ptr(k_scale), ptr(v_scale), ptr(sinks),
            ptr(np_vec), np_scalar, ptr(o))
    dims = (ctypes.cast(strides, ctypes.c_void_p), B, T, S, Hq, Hkv, D)
    rest = (int(n_tokens), float(scale), int(sliding_window), float(logit_softcap),
            KIND_F32 if q.dtype == torch.float32 else KIND_BF16)
    if qk_dtype != "int8":
        lib = FLASH_DECODE_WIDE if D in WIDE_DIMS else FLASH_DECODE
        lib.launch(*head, *dims, Dv, *rest, kind, int(qk_dtype == "bfloat16"),
                            decode_geometry(B, Hkv, S, num_sms(dev)), stream_ptr(dev))
        return o
    bk = batched_block_k(block_k, S, Hkv, D, Dv, 1)
    if not 0 < bk <= MAX_BLOCK_K:
        raise ValueError(f"flash_decode: int8 dots over blocks of {bk} keys "
                         f"(1..{MAX_BLOCK_K})")
    FLASH_DECODE_INT8.launch(*head, *dims, *rest, bk, decode_geometry(B, Hkv, S, num_sms(dev)),
                             stream_ptr(dev))
    return o
