"""E3: model-scale decode-GEMV bench at Llama-3-8B's shapes, q4 packed
weights with f16 scales (3.93 GB).  Each token chains all 7 projections x
32 layers, so the bench measures what a decode loop pays per token for the
linear layers.

    python -m chatllm_tpu_torch.experiments.gemv_model_bench vpu [tile_n tile_k]
    python -m chatllm_tpu_torch.experiments.gemv_model_bench sweep vpu stream:1024:2048 vpu_bf16 mxu

Counterpart of experiments/gemv_model_bench.py.  Variants: `vpu` runs K1
(csrc/qgemv.cu; packed, zero point 8, f16 scales), `mxu` K2 (csrc/qmm.cu)
on one row, and `stream` and `vpu_bf16` the two hand-written kernels of
csrc/gemv_model.cu (`stream_read`, `qgemv_bf16`), each with a plain PyTorch
version here that CPU tensors take.  The original times one compiled
program over 32 tokens; here the 32-token loop is timed twice: run eagerly
(the host issues every launch) and replayed from one CUDA graph captured
from it (no host work between kernels), so the two lines split the
kernels' per-token time from the host's dispatch.  `tile_k` is part of
`stream_read`'s and `qgemv_bf16`'s functions (the tile boundaries decide
which rows `stream_read` reads and where `qgemv_bf16` leaves bf16);
`tile_n` and `vmem_mb` change nothing here and are only printed.
"""
from __future__ import annotations

import math
import sys

import torch

from ..device import resolve_device
from ..ops.cuda.build import QGEMV_BF16, STREAM_READ, num_sms, ptr, stream_ptr
from .timing import eager_and_graph_s, sync

L = 32
H, KV, F = 4096, 1024, 14336
G = 32
TOKENS = 32
# (K, N) per projection, in forward order
SHAPES = [("q", H, H), ("k", H, KV), ("v", H, KV), ("o", H, H),
          ("gate", H, F), ("up", H, F), ("down", F, H)]
TILE_N, TILE_K = 1024, 2048
VARIANTS = ("vpu", "stream", "vpu_bf16", "mxu")
STREAM_COLS = 512          # columns per stream_read block (csrc/gemv_model.cu)


def _check(x, q, s, tile_k: int, n_mult: int):
    k2, n = q.shape
    k = 2 * k2
    if q.dtype != torch.uint8 or s.dtype != torch.float16 or tuple(s.shape) != (k // G, n):
        raise TypeError(f"q must be uint8 [K/2, N] and s f16 [K/32, N], got q {q.dtype} "
                        f"{tuple(q.shape)}, s {s.dtype} {tuple(s.shape)}")
    if tile_k <= 0 or tile_k % G or k % tile_k:
        raise ValueError(f"tile_k={tile_k} must be a multiple of {G} dividing K={k}")
    if x.numel() != k:
        raise ValueError(f"x has {x.numel()} values, expected K={k}")
    if n % n_mult or not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError(f"N={n} must be a multiple of {n_mult}, q and s contiguous")
    if x.device != q.device or s.device != q.device:
        raise ValueError(f"x, q and s must share a device: {x.device}, {q.device}, {s.device}")
    if q.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError("q and s must be 16-byte aligned")


def stream_read_plain(x, q, s, *, tile_k: int = TILE_K):
    """x: [1, K] or [K] float; q: uint8 [K/2, N]; s: f16 [K/32, N].  Returns
    (y f32 [1, N], digest int32 [N/4]): y[n] = sum over r < 8 (in order) of
    sum over k-tiles kt (in order) of f32(q[kt * tile_k/2 + r, n]) *
    x[kt * tile_k]; digest[j] = XOR of every 32-bit word of q and s over
    columns 4j..4j+3."""
    _check(x, q, s, tile_k, 16)
    k2, n = q.shape
    n_kt = 2 * k2 // tile_k
    xf = x.reshape(-1).float()
    heads = q.reshape(n_kt, tile_k // 2, n)[:, :8].float()       # [n_kt, 8, N]
    acc = torch.zeros(8, n, dtype=torch.float32, device=q.device)
    for kt in range(n_kt):
        acc = acc + heads[kt] * xf[kt * tile_k]
    y = acc[0]
    for r in range(1, 8):
        y = y + acc[r]
    dq = _xor_rows(q.view(torch.int32))                          # [N/4]
    ds = _xor_rows(s.view(torch.int32)).reshape(n // 4, 2)       # [N/2] -> pairs
    return y.reshape(1, n), dq ^ ds[:, 0] ^ ds[:, 1]


def _xor_rows(a: torch.Tensor) -> torch.Tensor:
    """XOR of the rows of an integer [R, C] tensor."""
    while a.shape[0] > 1:
        h = a.shape[0] // 2
        a = torch.cat([a[:h] ^ a[h:2 * h], a[2 * h:]])
    return a[0]


def stream_read(x, q, s, *, tile_k: int = TILE_K):
    """The function of `stream_read_plain`; the `stream_read` kernel on the
    card, which loads every byte of q and s."""
    if not q.is_cuda:
        return stream_read_plain(x, q, s, tile_k=tile_k)
    _check(x, q, s, tile_k, 16)
    k2, n = q.shape
    k = 2 * k2
    xc = x.reshape(k).to(torch.float32).contiguous()
    y = torch.empty(n, dtype=torch.float32, device=q.device)
    digest = torch.empty(n // 4, dtype=torch.int32, device=q.device)
    n_g = k // G
    splits = max(1, min(math.ceil(4 * num_sms(q.device) / math.ceil(n / STREAM_COLS)),
                        n_g // 8))
    STREAM_READ.launch(ptr(xc), ptr(q), ptr(s), ptr(y), ptr(digest), k, n, tile_k, splits,
                       stream_ptr(q.device))
    return y.reshape(1, n), digest


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16)


def qgemv_bf16_plain(x, q, s, *, tile_k: int = TILE_K) -> torch.Tensor:
    """x: [1, K] or [K] float; q: uint8 [K/2, N]; s: f16 [K/32, N].  Returns
    f32 [1, N]: per k-tile, in bf16 (every product and sum rounded), p =
    lo * x_lo + hi * x_hi per group, halved from 16 rows to 8, times the
    scale rounded to bf16, the tile's groups halved pairwise while their
    count is even and the rest added in order; the tiles' [8, N] rows then
    add in f32 in tile order, and the 8 rows in order."""
    _check(x, q, s, tile_k, 32)
    k2, n = q.shape
    n_kt, gs = 2 * k2 // tile_k, tile_k // G
    xb = _bf(x.reshape(n_kt, gs, G, 1).float())
    qi = q.reshape(n_kt, gs, G // 2, n).to(torch.int32)
    lo, hi = _bf(qi & 15), _bf(qi >> 4)
    p = lo * xb[:, :, :G // 2] + hi * xb[:, :, G // 2:]          # [n_kt, gs, 16, N]
    t = p[:, :, :8] + p[:, :, 8:]
    t = t * _bf(s.reshape(n_kt, gs, 1, n))
    g = gs
    while g > 1 and g % 2 == 0:
        t = t[:, :g // 2] + t[:, g // 2:]
        g //= 2
    r = t[:, 0]
    for i in range(1, g):
        r = r + t[:, i]                                          # [n_kt, 8, N] bf16
    acc = torch.zeros(8, n, dtype=torch.float32, device=q.device)
    for kt in range(n_kt):
        acc = acc + r[kt].float()
    y = acc[0]
    for i in range(1, 8):
        y = y + acc[i]
    return y.reshape(1, n)


def qgemv_bf16(x, q, s, *, tile_k: int = TILE_K) -> torch.Tensor:
    """The function of `qgemv_bf16_plain`; the `qgemv_bf16` kernel on the
    card."""
    if not q.is_cuda:
        return qgemv_bf16_plain(x, q, s, tile_k=tile_k)
    _check(x, q, s, tile_k, 32)
    if tile_k > 8192:
        raise ValueError(f"qgemv_bf16: tile_k {tile_k} > 8192 does not fit shared memory")
    k2, n = q.shape
    k = 2 * k2
    xc = x.reshape(k).to(torch.float32).contiguous()
    part = torch.empty(k // tile_k * 8 * n, dtype=torch.float32, device=q.device)
    y = torch.empty(n, dtype=torch.float32, device=q.device)
    QGEMV_BF16.launch(ptr(xc), ptr(q), ptr(s), ptr(part), ptr(y), k, n, tile_k,
                      stream_ptr(q.device))
    return y.reshape(1, n)


def make_weights(l: int = L, shapes=SHAPES, device=None):
    """The original's iota pseudo-weights, bit for bit: for projection idx,
    q[l, c, r] = uint8(int32(r * 1103515245 + c * 12345 + idx) >> 7) (int32
    products wrap, the shift is arithmetic, the cast keeps the low byte)
    and s[l, g, r] = f16(0.005 + 1e-5 * cos(r + idx)) in f32, where r is the
    column and c the byte row.  Every layer holds its own copy.  Returns
    ({name: (q uint8 [l, K/2, N], s f16 [l, K/32, N])}, total bytes)."""
    dev = resolve_device(device)
    ws, total = {}, 0
    for idx, (name, k, n) in enumerate(shapes):
        r = torch.arange(n, dtype=torch.int64, device=dev)
        c = torch.arange(k // 2, dtype=torch.int64, device=dev)[:, None]
        # bits 7..14 of the int32 value are those of the unwrapped int64 sum
        q1 = ((r * 1103515245 + c * 12345 + idx) >> 7 & 255).to(torch.uint8)
        q = q1.expand(l, k // 2, n).contiguous()
        del q1
        rf = torch.arange(n, dtype=torch.float32, device=dev)
        s1 = (0.005 + 0.00001 * torch.cos(rf + idx)).to(torch.float16)
        s = s1.expand(l, k // G, n).contiguous()
        ws[name] = (q, s)
        total += q.numel() + s.numel() * s.element_size()
    sync(dev)
    print(f"weights on device: {total / 1e9:.2f} GB", flush=True)
    return ws, total


def _proj_fn(kernel_name: str, tile_k: int):
    if kernel_name == "vpu":
        from ..ops.cuda.gemv_kernel import qgemv
        return lambda x, q, s: qgemv(x, q, s, None, None, group=G, packed=True, zero_point=8)
    if kernel_name == "stream":
        return lambda x, q, s: stream_read(x, q, s, tile_k=tile_k)[0]
    if kernel_name == "vpu_bf16":
        return lambda x, q, s: qgemv_bf16(x, q, s, tile_k=tile_k)
    if kernel_name == "mxu":
        from ..ops.cuda.qmm_kernel import qmm
        return lambda x, q, s: qmm(x, q, s, None, None, group=G, packed=True, zero_point=8)
    raise ValueError(f"unknown kernel {kernel_name!r}; choose from {VARIANTS}")


def decode_fn(kernel_name: str, ws: dict, tile_k: int = TILE_K, tokens: int = TOKENS):
    """The original's decode loop: `tokens` tokens, each through every
    layer's 7 projections, the activation carried throughout."""
    proj = _proj_fn(kernel_name, tile_k)
    n_layers = ws["q"][0].shape[0]
    hidden = ws["q"][0].shape[2]
    device = ws["q"][0].device

    def layer(x, lw):
        qo = proj(x, *lw["q"])
        ko = proj(x, *lw["k"])
        vo = proj(x, *lw["v"])
        oo = proj(torch.tanh(qo * 1e-3), *lw["o"])
        h = torch.tanh(oo * 1e-3)
        g = proj(h, *lw["gate"])
        u = proj(h, *lw["up"])
        d = proj(torch.tanh(g * u * 1e-4), *lw["down"])
        return torch.tanh(d * 1e-3) + (torch.sum(ko) + torch.sum(vo)) * 1e-9

    layers = [{name: (q[i], s[i]) for name, (q, s) in ws.items()} for i in range(n_layers)]

    def decode():
        x = torch.ones(1, hidden, dtype=torch.float32, device=device)
        for _ in range(tokens):
            for lw in layers:
                x = layer(x, lw)
        return x
    return decode


def run(kernel_name: str, tile_n: int = TILE_N, tile_k: int = TILE_K, vmem_mb: int = 0,
        ws_total=None, *, device=None, tokens: int = TOKENS) -> dict:
    """Time one variant over `tokens` tokens, eagerly and (on the card) by
    a CUDA-graph replay; prints one line for each."""
    dev = resolve_device(device)
    ws, total = ws_total or make_weights(device=dev)
    decode = decode_fn(kernel_name, ws, tile_k, tokens)
    nparams = sum(q.numel() * 2 for q, _ in ws.values())
    print(f"[{kernel_name} tn={tile_n} tk={tile_k} vm={vmem_mb}] warming up "
          "(tile_n and vm change nothing in this port)...", flush=True)
    times = eager_and_graph_s(decode, dev)
    print(f"compile+warm {times['warm']:.1f}s", flush=True)
    res = {}
    for mode in ("eager", "graph"):
        if mode not in times:
            continue
        dt = times[mode] / tokens
        res[f"{mode}_ms_per_token"] = dt * 1e3
        res[f"{mode}_gb_s"] = total / dt / 1e9
        print(f"[{kernel_name} {mode}] {dt * 1e3:.2f} ms/token -> {1 / dt:.1f} tok/s "
              f"({total / dt / 1e9:.0f} GB/s eff, {nparams / 1e9:.1f}B params)", flush=True)
    return res


def main(argv=None, *, device=None, l: int = L, shapes=SHAPES, tokens: int = TOKENS) -> dict:
    """`<kernel> [tn tk]` or `sweep <kernel:tn:tk:vm> ...`, as the original;
    returns each run's result by its spec."""
    args = list(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    out = {}
    if args and args[0] == "sweep":
        wt = make_weights(l, shapes, dev)
        for spec in args[1:]:
            parts = spec.split(":")
            tn = int(parts[1]) if len(parts) > 1 else TILE_N
            tk = int(parts[2]) if len(parts) > 2 else TILE_K
            vm = int(parts[3]) if len(parts) > 3 else 0
            out[spec] = run(parts[0], tn, tk, vm, ws_total=wt, device=dev, tokens=tokens)
    else:
        name = args[0] if args else "vpu"
        tn = int(args[1]) if len(args) > 1 else TILE_N
        tk = int(args[2]) if len(args) > 2 else TILE_K
        out[name] = run(name, tn, tk, ws_total=make_weights(l, shapes, dev), device=dev,
                        tokens=tokens)
    return out


if __name__ == "__main__":
    main()
