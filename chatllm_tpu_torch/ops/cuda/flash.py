"""K3: flash attention for prefill over the KV cache (csrc/flash_attention.cu).

Replaces chatllm_tpu/ops/pallas/flash.py::flash_attention.  `flash_attention`
launches the CUDA kernel for CUDA tensors and runs `flash_attention_plain`,
its plain PyTorch version, for CPU tensors.  `prefill_geometry` is the
kernels' schedule (which key tiles each query tile visits, which of them
skip the mask, the launch order and, in the f32 modes, the split of each
walk over a cluster), which the kernels compute on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .build import FLASH, ptr, stream_ptr

NEG_INF = -1e30
HEAD_DIMS = (64, 80, 96, 128, 256)   # head dims the CUDA kernel is instantiated for
# The bf16 kernel's tiles (csrc/flash_attention.cu): a block owns BQ query
# rows of one head, WG_ROWS per consumer warpgroup, and walks BK[D]-key tiles
# of the cache through a ring of STAGES[D] shared-memory stages (64-key
# tiles at D 256, where 128-key ones pass the registers and the shared
# memory).  Its tiles are TILE_D[D] columns wide: D 80 and 96 run on D 128's
# tiles, the columns past D zero-filled by TMA.
BQ, WG_ROWS = 128, 64
BK = {64: 128, 80: 128, 96: 128, 128: 128, 256: 64}
STAGES = {64: 4, 80: 2, 96: 2, 128: 2, 256: 2}
TILE_D = {64: 64, 80: 128, 96: 128, 128: 128, 256: 256}
# The f32 kernel's (modes 1 and 2): a block of 256 threads owns 128 or 64
# query rows of one head (`f32_rows`) and walks FBK[D]-key tiles through
# F_STAGES[D] stages; a walk is split over a cluster of up to MAX_SPLIT
# blocks, each taking at least MIN_SHARE tiles of the longest walk, where
# the card holds all the grid's clusters at once.
FBK = {64: 64, 80: 64, 96: 64, 128: 64, 256: 32}
F_STAGES = {64: 4, 80: 4, 96: 4, 128: 2, 256: 2}
MAX_SPLIT, MIN_SHARE = 8, 4
# Clusters of C blocks of the f32 kernel that one H100 holds at once, the
# same for every D, mode and row count (one block an SM):
# cudaOccupancyMaxActiveClusters on the card, which `cluster_slots` reads
# there.
H100_CLUSTER_SLOTS = {1: 132, 2: 66, 4: 30, 8: 15}
H100_SMS = 132
SMEM_LIMIT = 232448       # dynamic shared memory one block may use on the H100
# (q dtype, cache dtype) -> the kernel variant (csrc/flash_attention.cu)
MODES = {(torch.bfloat16, torch.bfloat16): 0, (torch.float32, torch.float32): 1,
         (torch.float32, torch.bfloat16): 2}
# the wrapper's launches by mode, beside FLASH.launches (all modes)
MODE_LAUNCHES = {mode: 0 for mode in MODES.values()}


def reset_mode_launches():
    for mode in MODE_LAUNCHES:
        MODE_LAUNCHES[mode] = 0


def tile_keys(qt: int, T: int, S: int, n_past: int, n_tokens: int, causal: bool,
              window: int, *, bq: int = BQ, bk: int = BK[128]) -> tuple[int, int]:
    """The key tiles [first, end) that query tile `qt` (rows qt*bq .. of the
    T) visits (csrc `tile_keys`, `f32_tile_keys`): those that meet the keys
    some real row of the tile may see, from the window's start for its first
    row to the last written key, or its last row's position when causal.
    (0, 0) when the tile's rows see no key at all."""
    t0 = qt * bq
    lo = max(0, n_past + t0 - window + 1) if window > 0 else 0
    hi = min(n_past + n_tokens, S)
    if causal:
        hi = min(hi, n_past + min(T, t0 + bq))
    if hi <= lo:
        return 0, 0
    return lo // bk, -(-hi // bk)


def tile_interior(qt: int, kt: int, half: int, n_past: int, n_tokens: int, causal: bool,
                  window: int, *, bq: int = BQ, bk: int = BK[128], rows: int = WG_ROWS) -> bool:
    """Whether every key of tile kt is visible to every row of group `half`
    (`rows` rows: a consumer warpgroup of the bf16 kernel, the whole block of
    the f32 one) of query tile qt (csrc `tile_interior`, and the f32 kernel's
    `interior`): those tiles skip the mask arithmetic."""
    k0, q_lo = kt * bk, n_past + qt * bq + half * rows
    ok = k0 + bk <= n_past + n_tokens
    if causal:
        ok = ok and k0 + bk - 1 <= q_lo
    if window > 0:
        ok = ok and k0 > q_lo + rows - 1 - window
    return ok


def f32_rows(D: int, T: int, heads: int, batch: int, sms: int = H100_SMS) -> int:
    """The query rows of an f32 block (csrc `f32_rows`): 128 at D 128 where
    the grid of 128-row tiles fills the SMs, else 64."""
    return 128 if D == 128 and -(-T // 128) * heads * batch >= sms else 64


def f32_smem(D: int, kv_bytes: int, bq: int) -> int:
    """The f32 kernel's dynamic shared memory (csrc `FGeo::SMEM`): Q [bq][D +
    4] f32 and F_STAGES[D] stages of K and V tiles of FBK[D] keys as the
    cache's raw bytes (kv_bytes per value; an f32 K row padded to D + 4), and
    over a bf16 cache the tiles widened to f32 (K [FBK][D + 4], V [FBK][D]);
    P takes the f32 K tile's place."""
    k_row = 2 * D if kv_bytes == 2 else 4 * (D + 4)
    ring = F_STAGES[D] * FBK[D] * (k_row + D * kv_bytes)
    widened = 4 * FBK[D] * (2 * D + 4) if kv_bytes == 2 else 0
    return 4 * bq * (D + 4) + ring + widened


def f32_splits(blocks: int, longest: int, slots: dict) -> int:
    """The blocks C of a cluster that split each query tile's key walk (csrc
    `launch_f32`): the largest power of two <= MAX_SPLIT such that the card
    holds the grid's `blocks` clusters of C at once (`slots[C]` of them) and
    the `longest` walk gives each block at least MIN_SHARE key tiles."""
    c = 1
    while 2 * c <= MAX_SPLIT and longest >= 2 * c * MIN_SHARE and blocks <= slots[2 * c]:
        c *= 2
    return c


def prefill_geometry(T: int, S: int, n_past: int, n_tokens: int, D: int, *,
                     causal: bool = True, window: int = 0, mode: int = 0, heads: int = 1,
                     batch: int = 1, sms: int = H100_SMS, slots: dict | None = None) -> dict:
    """The kernel's schedule in `mode` (MODES), which the kernel computes on
    the card: per query tile its key tiles [first, end) and, per visited
    tile, whether each row group (the bf16 kernel's two consumer
    warpgroups, the f32 kernel's whole block) takes it unmasked; the launch
    order (slot r of the grid's slowest dimension runs query tile order[r]:
    the tiles that walk the most key tiles first, later tiles first among
    equals); the f32 kernel's rows a block (`f32_rows`) and the split C of
    every walk over a cluster (`heads` x `batch` blocks per query tile, the
    card's `slots`, H100_CLUSTER_SLOTS by default; always 1 in mode 0) and
    each rank's contiguous share [a, b) of the tiles; the ring's stages and
    the block's dynamic shared memory (mode 0: Q, the K/V ring, a 1024-byte
    alignment pad, the barriers and the tile index)."""
    f32 = mode != 0
    bq, bk = (f32_rows(D, T, heads, batch, sms), FBK[D]) if f32 else (BQ, BK[D])
    rows = bq if f32 else WG_ROWS
    n_qt = -(-T // bq)
    tiles = [tile_keys(qt, T, S, n_past, n_tokens, causal, window, bq=bq, bk=bk)
             for qt in range(n_qt)]
    interior = [[tuple(tile_interior(qt, kt, h, n_past, n_tokens, causal, window, bq=bq,
                                     bk=bk, rows=rows) for h in range(bq // rows))
                 for kt in range(a, b)] for qt, (a, b) in enumerate(tiles)]
    order = sorted(range(n_qt), key=lambda i: (tiles[i][0] - tiles[i][1], -i))
    if f32:
        longest = max(b - a for a, b in tiles)
        slots = slots or H100_CLUSTER_SLOTS
        splits = f32_splits(n_qt * heads * batch, longest, slots)
        stages, smem = F_STAGES[D], f32_smem(D, 4 if mode == 1 else 2, bq)
    else:
        splits, stages = 1, STAGES[D]
        smem = 2 * TILE_D[D] * (BQ + 2 * stages * BK[D]) + 1024 + 8 * (1 + 4 * stages) + 8
    shares = [[(a + r * (b - a) // splits, a + (r + 1) * (b - a) // splits)
               for r in range(splits)] for a, b in tiles]
    return {"tiles": tiles, "interior": interior, "order": order, "splits": splits,
            "shares": shares, "stages": stages, "smem": smem, "bq": bq, "bk": bk,
            "rows": rows}


def last_splits() -> int:
    """The split C of the last mode 1 or 2 launch, as the kernel chose it on
    the card (csrc `launch_f32`); `prefill_geometry(...)["splits"]` is its
    twin."""
    return FLASH.symbol("flash_attention_last_splits", [])()


def cluster_slots(D: int, mode: int, bq: int) -> dict:
    """{C: clusters of C blocks that the card holds at once} for the f32
    kernel of `mode` with bq-row blocks, asked of the card (csrc
    `cluster_slots`)."""
    fn = FLASH.symbol("flash_attention_cluster_slots", [ctypes.c_int] * 4)
    slots = {c: fn(D, mode, bq, c) for c in (1, 2, 4, 8)}
    if min(slots.values()) < 0:
        raise RuntimeError(f"flash_attention_cluster_slots({D}, {mode}, {bq}): {slots}")
    return slots


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
    HEAD_DIMS.  In the f32 modes the kernel may split each key walk over a
    cluster; `last_splits()` reads the split it chose."""
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
    MODE_LAUNCHES[mode] += 1
    return o
