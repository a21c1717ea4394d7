"""E5: why does the fused dequant-matmul (K2) at M = 32 rows stream fewer
bytes per second than the GEMV (K1) at M = 1?  Times K2 at M rows for the
q4k, q8 and q4 formats against a copy-only pass over the same bytes.

    python -m chatllm_tpu_torch.experiments.qmm_m32 [M] [reps]

Counterpart of experiments/qmm_m32.py.  Every measurement chains `reps`
calls (a carry threaded through a tiny operand, so nothing hoists), as the
original's one jitted scan does; on the card the chain is replayed from one
CUDA graph, so no host work sits between the calls.  The copy-only pass is
a hand-written CUDA kernel (csrc/qmm_dma.cu) with a plain PyTorch version,
`dma_sums_plain`, which CPU tensors take.  K2's tiles are fixed in
csrc/qmm.cu, so the original's tile sweep prints the tiles it would set
and times nothing.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..models.synthetic import synth_linear
from ..ops.cuda.build import QMM_DMA, ptr, stream_ptr
from .timing import chain_s

M = 32
REPS = 2048
K, N = 4096, 14336
DMA_TILE_K, DMA_TILE_N = 1024, 512
FORMATS = ("q4k", "q8", "q4")
SWEEP = (("tile_k", 512), ("tile_k", 2048), ("tile_k", 4096),
         ("tile_n", 256), ("tile_n", 1024), ("tile_n", 2048))


def _check_dma(q, c, tile_k: int, tile_n: int):
    r, n = q.shape
    if q.dtype != torch.uint8 or not q.is_contiguous() or q.data_ptr() % 16:
        raise TypeError(f"q must be contiguous 16-byte aligned uint8 [R, N], got {q.dtype}")
    if tile_k <= 0 or tile_k % 8 or r % tile_k or tile_n <= 0 or tile_n % 16 or n % tile_n:
        raise ValueError(f"tiles ({tile_k}, {tile_n}) must divide q's {tuple(q.shape)} "
                         "(tile_k a multiple of 8, tile_n of 16)")
    if c.dtype != torch.float32 or c.numel() != 1 or c.device != q.device:
        raise TypeError("c must be one f32 on q's device")


def dma_sums_plain(q, c, *, tile_k: int = DMA_TILE_K, tile_n: int = DMA_TILE_N):
    """q: uint8 [R, N]; c: f32 [1].  Returns f32 [N / tile_n, R / tile_k]:
    the exact integer sum of each tile's bytes, converted to f32, plus c."""
    _check_dma(q, c, tile_k, tile_n)
    r, n = q.shape
    t = q.reshape(r // tile_k, tile_k, n // tile_n, tile_n).to(torch.int64).sum(dim=(1, 3))
    return t.t().float() + c.float().reshape(())


def dma_sums(q, c, *, tile_k: int = DMA_TILE_K, tile_n: int = DMA_TILE_N):
    """The function of `dma_sums_plain`; the `qmm_dma` kernel on the card,
    which loads every byte of q."""
    if not q.is_cuda:
        return dma_sums_plain(q, c, tile_k=tile_k, tile_n=tile_n)
    _check_dma(q, c, tile_k, tile_n)
    r, n = q.shape
    shape = (n // tile_n, r // tile_k)
    totals = torch.empty(shape, dtype=torch.int64, device=q.device)
    out = torch.empty(shape, dtype=torch.float32, device=q.device)
    QMM_DMA.launch(ptr(q), ptr(c), ptr(totals), ptr(out), r, n, tile_k, tile_n,
                   stream_ptr(q.device))
    return out


def timeit(mkfn, *args, reps: int, device) -> float:
    """Seconds per call of mkfn(c, *args) (a scalar contribution; c is an f32
    carry) over a chain of `reps` calls: c += mkfn(c, ...) * 1e-20."""
    c = torch.zeros((), dtype=torch.float32, device=device)
    return chain_s(lambda: c.add_(mkfn(c, *args) * 1e-20), reps, device)


def qbytes(lin) -> int:
    return sum(a.numel() * a.element_size() for a in (lin.q, lin.s, lin.b, lin.d, lin.dm)
               if a is not None)


def bench_fmt(fmt: str, K: int = K, N: int = N, *, m: int = M, reps: int = REPS,
              device=None, **tiles) -> dict:
    """K2 at `m` rows on a zero `fmt` weight; x = 0 but x[0, 0] = the carry."""
    from ..ops.cuda.qmm_kernel import qmm

    dev = resolve_device(device)
    tag = "+".join(f"{k}={v}" for k, v in tiles.items()) or "default"
    if tiles:
        print(f"qmm {fmt:4s} M={m} K={K} N={N} {tag:22s}: not timed: K2 (csrc/qmm.cu) fixes "
              "its tiles and takes no such argument", flush=True)
        return {}
    lin = synth_linear(K, N, fmt, zeros=True, device=dev)
    x = torch.zeros(m, K, dtype=torch.float32, device=dev)

    def call(c, x):
        x[0, 0] = c
        return qmm(x, lin.q, lin.s, lin.b, None, group=lin.group_size, packed=lin.packed,
                   zero_point=lin.zero_point, d=lin.d, dm=lin.dm, sb=lin.sb).sum()

    t = timeit(call, x, reps=reps, device=dev)
    gbs = qbytes(lin) / t / 1e9
    print(f"qmm {fmt:4s} M={m} K={K} N={N} {tag:22s}: {t * 1e3:7.3f} ms  {gbs:6.1f} GB/s",
          flush=True)
    return {"ms": t * 1e3, "gb_s": gbs}


def bench_dma(K: int = K, N: int = N, tile_k: int = DMA_TILE_K, tile_n: int = DMA_TILE_N,
              *, reps: int = REPS, device=None) -> dict:
    """The copy-only pass over a zero uint8 [K/2, N] array; each call's
    result is the last tile's sum plus the carry."""
    dev = resolve_device(device)
    q = torch.zeros(K // 2, N, dtype=torch.uint8, device=dev)

    def call(c, q):
        return dma_sums(q, c.reshape(1), tile_k=tile_k, tile_n=tile_n)[-1, -1]

    t = timeit(call, q, reps=reps, device=dev)
    gbs = q.numel() / t / 1e9
    print(f"DMA-only        K={K} N={N} tk={tile_k} tn={tile_n}: "
          f"{t * 1e3:7.3f} ms  {gbs:6.1f} GB/s", flush=True)
    return {"ms": t * 1e3, "gb_s": gbs}


def main(*, device=None, m: int = M, reps: int = REPS, k: int = K, n: int = N) -> dict:
    dev = resolve_device(device)
    out = {"dma": bench_dma(k, n, reps=reps, device=dev)}
    for fmt in FORMATS:
        out[fmt] = bench_fmt(fmt, k, n, m=m, reps=reps, device=dev)
    for key, val in SWEEP:
        bench_fmt("q4k", k, n, m=m, reps=reps, device=dev, **{key: val})
    return out


if __name__ == "__main__":
    import sys

    main(m=int(sys.argv[1]) if len(sys.argv) > 1 else M,
         reps=int(sys.argv[2]) if len(sys.argv) > 2 else REPS)
