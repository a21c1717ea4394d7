"""E6: cheaper q4_k dequant arithmetic for K2's M <= 64 body.

  v0_current      production unpack (widen, & 0xF, (>> 4) & 0xF), the
                  affine term rounded into every bf16 weight
  v4_biasdot      v1's unpack (no mask after >> 4); the affine term as an
                  f32 dot of the per-group sums of x with -(m * dmin)
  v5_f32+biasdot  v3's unpack (one conversion, hi = floor(q / 16)) + biasdot
  diag_*          five diagnostic bodies (noscale, nounpack, storeonly,
                  splitstore, splitstore_bias) whose numerics serve the
                  bench only

    python -m chatllm_tpu_torch.experiments.qmm_unpack_variants [M] [reps]

Counterpart of experiments/qmm_unpack_variants.py.  Two hand-written CUDA
kernels (csrc/qmm_unpack.cu) compute the Pallas bodies: `qmm_unpack`
(template (a), over the unpack mode and biasdot) and `qmm_unpack_diag`
(template (b), over the diagnostic mode); `qmm_unpack_plain` and
`qmm_unpack_diag_plain` are their plain PyTorch versions, which CPU tensors
take.  `check_correct` holds a variant against K2 (the port's `qmm`) on
the original's seeded 512 x 256 weight; `bench_variant` times `reps`
chained calls on the original's zero weight (x = 0 but x[0, 0] = the
carry), replayed from one CUDA graph on the card as the original times one
compiled scan.  Unlike the original, which prints an exception and goes on,
every failure raises.  The storeonly body leaves half of its weight tile
unwritten in the Pallas scratch; here those rows are zero.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..device import resolve_device
from ..models.synthetic import synth_linear
from ..ops.cuda.build import QMM_UNPACK, QMM_UNPACK_DIAG, ptr, stream_ptr
from .timing import chain_s

M = 32
REPS = 2048
K, N = 4096, 14336
GROUP, SB = 32, 8
TILE_K, TILE_N = 2048, 512
CHECK_K, CHECK_N = 512, 256
CHECK_TOL = 1e-3
UNPACK_MODES = ("v0", "v1", "v2", "v3")
VARIANTS = (("v0_current", "v0", False), ("v4_biasdot", "v1", True),
            ("v5_f32+biasdot", "v3", True))
DIAG_MODES = ("noscale", "nounpack", "storeonly", "splitstore", "splitstore_bias")
TN = 64                  # columns per block of the CUDA kernels


def _grouped(q: torch.Tensor) -> torch.Tensor:
    half = GROUP // 2
    return q.reshape(q.shape[0] // half, half, q.shape[1])


def unpack_v0(q, compute_dtype):
    """uint8 [K/2, N] -> [K/32, 32, N]: widen to i32, & 0xF, (>> 4) & 0xF."""
    qi = _grouped(q).to(torch.int32)
    return torch.cat([(qi & 0xF).to(compute_dtype), ((qi >> 4) & 0xF).to(compute_dtype)], dim=1)


def unpack_v1(q, compute_dtype):
    """v0 without the mask after the shift (a widened byte's high bits are 0)."""
    qi = _grouped(q).to(torch.int32)
    return torch.cat([(qi & 0xF).to(compute_dtype), (qi >> 4).to(compute_dtype)], dim=1)


def unpack_v2(q, compute_dtype):
    """v1 widened to i16."""
    qi = _grouped(q).to(torch.int16)
    return torch.cat([(qi & 0xF).to(compute_dtype), (qi >> 4).to(compute_dtype)], dim=1)


def unpack_v3(q, compute_dtype):
    """One conversion: qf = f32(q), hi = floor(qf / 16), lo = qf - 16 hi."""
    qf = _grouped(q).to(torch.int32).float()
    hi = torch.floor(qf * 0.0625)
    lo = qf - hi * 16.0
    return torch.cat([lo, hi], dim=1).to(compute_dtype)


def unpack_v6_split(q, compute_dtype):
    """Tile-global pairing: byte row j holds rows j and j + TK/2 of a k tile
    of TK rows, so lo and hi are the two half tiles.  Bench-only: the
    production layout pairs rows within each group."""
    qi = q.to(torch.int32)
    return (qi & 0xF).to(compute_dtype), (qi >> 4).to(compute_dtype)


UNPACK = {"v0": unpack_v0, "v1": unpack_v1, "v2": unpack_v2, "v3": unpack_v3}


def _check(x, q, sc, m, d, dm, tile_k: int):
    mrows, k = x.shape
    k2, n = q.shape
    want = {"q": (q, torch.uint8, (k // 2, n)), "sc": (sc, torch.int8, (k // GROUP, n)),
            "m": (m, torch.int8, (k // GROUP, n)), "d": (d, torch.float16, (k // 256, n)),
            "dm": (dm, torch.float16, (k // 256, n))}
    if k2 * 2 != k or not 1 <= mrows <= 64:
        raise ValueError(f"x {tuple(x.shape)} against q {tuple(q.shape)}: need [M <= 64, K]")
    if tile_k <= 0 or tile_k % (GROUP * SB) or k % tile_k or n % TN:
        raise ValueError(f"tile_k={tile_k} must be a multiple of {GROUP * SB} dividing K={k}, "
                         f"and N={n} a multiple of {TN}")
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != x.device:
            raise TypeError(f"{name}: expected {dtype} {shape} on {x.device}, got {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be f32, got {x.dtype}")


def _scales(sc, d) -> torch.Tensor:
    """f32 sc * d per (group, column)."""
    gs, n = sc.shape
    return (sc.float().reshape(gs // SB, SB, n) * d.float()[:, None, :]).reshape(gs, n)


def _bias(m, dm) -> torch.Tensor:
    """f32 -(m * dmin) per (group, column)."""
    return -_scales(m, dm)


def dequant(q, sc, m, d, dm, *, unpack: str, biasdot: bool) -> torch.Tensor:
    """The template-(a) bf16 weight [K, N]: bf16(wq * bf16(sc * d)), then,
    without biasdot, bf16(w + bf16(-(m * dmin)))."""
    bf = torch.bfloat16
    wq = UNPACK[unpack](q, bf)                                   # [K/32, 32, N]
    w = wq * _scales(sc, d).to(bf)[:, None, :]
    if not biasdot:
        w = w + _bias(m, dm).to(bf)[:, None, :]
    return w.reshape(-1, q.shape[1])


def dequant_diag(q, sc, m, d, dm, *, mode: str, tile_k: int) -> torch.Tensor:
    """The template-(b) bf16 weight [K, N], built k tile by k tile."""
    bf = torch.bfloat16
    k2, n = q.shape
    half = tile_k // 2
    tiles = []
    for t0 in range(0, k2, half):
        qt = q[t0:t0 + half]
        g = slice(t0 // (GROUP // 2), (t0 + half) // (GROUP // 2))
        if mode == "noscale":
            w = unpack_v1(qt, bf).reshape(tile_k, n)
        elif mode in ("nounpack", "storeonly"):
            qb = qt.to(torch.int32).to(bf)
            w = torch.cat([qb, qb if mode == "nounpack" else torch.zeros_like(qb)], dim=0)
        elif mode in ("splitstore", "splitstore_bias"):
            lo, hi = unpack_v6_split(qt, bf)
            s = _scales(sc[g], d[g.start // SB:g.stop // SB]).to(bf)
            w = torch.cat([lo, hi], dim=0).reshape(-1, GROUP, n) * s[:, None, :]
            if mode == "splitstore_bias":
                w = w + _bias(m[g], dm[g.start // SB:g.stop // SB]).to(bf)[:, None, :]
            w = w.reshape(tile_k, n)
        else:
            raise ValueError(f"unknown mode {mode!r}; choose from {DIAG_MODES}")
        tiles.append(w)
    return torch.cat(tiles, dim=0)


def _tile_sum(x, w, tile_k: int, affine=None) -> torch.Tensor:
    """sum over k tiles, in order, of x_bf16[:, tile] @ w[tile] in f32 (plus
    `affine(tile)`, the tile's f32 biasdot term)."""
    xb = x.to(torch.bfloat16).float()
    out = None
    for k0 in range(0, x.shape[1], tile_k):
        part = xb[:, k0:k0 + tile_k] @ w[k0:k0 + tile_k].float()
        if affine is not None:
            part = part + affine(k0)
        out = part if out is None else out + part
    return out


def qmm_unpack_plain(x, xs, q, sc, m, d, dm, *, unpack: str, biasdot: bool,
                     tile_k: int = TILE_K) -> torch.Tensor:
    """x: f32 [M, K]; xs: f32 [K/32, M], the per-group sums of x (read only
    with biasdot); the q4_k arrays.  Returns f32 [M, N]."""
    _check(x, q, sc, m, d, dm, tile_k)
    w = dequant(q, sc, m, d, dm, unpack=unpack, biasdot=biasdot)
    affine = None
    if biasdot:
        bb = _bias(m, dm)
        gt = tile_k // GROUP

        def affine(k0):
            g = slice(k0 // GROUP, k0 // GROUP + gt)
            return xs[g].float().t() @ bb[g]
    return _tile_sum(x, w, tile_k, affine)


def qmm_unpack_diag_plain(x, q, sc, m, d, dm, *, mode: str, tile_k: int = TILE_K) -> torch.Tensor:
    """A diagnostic body: x: f32 [M, K], the q4_k arrays; f32 [M, N]."""
    _check(x, q, sc, m, d, dm, tile_k)
    return _tile_sum(x, dequant_diag(q, sc, m, d, dm, mode=mode, tile_k=tile_k), tile_k)


def _check_cuda(*ts):
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("qmm_unpack: arrays must be contiguous and 16-byte aligned")


def _outputs(x, n: int, tile_k: int):
    mrows, k = x.shape
    n_kt = k // tile_k
    part = (torch.empty(n_kt, mrows, n, dtype=torch.float32, device=x.device)
            if n_kt > 1 else None)
    return part, torch.empty(mrows, n, dtype=torch.float32, device=x.device)


def qmm_unpack(x, xs, q, sc, m, d, dm, *, unpack: str, biasdot: bool,
               tile_k: int = TILE_K) -> torch.Tensor:
    """The function of `qmm_unpack_plain`; the `qmm_unpack` kernel on the card."""
    if not q.is_cuda:
        return qmm_unpack_plain(x, xs, q, sc, m, d, dm, unpack=unpack, biasdot=biasdot,
                                tile_k=tile_k)
    if unpack not in UNPACK_MODES:
        raise ValueError(f"unknown unpack {unpack!r}; choose from {UNPACK_MODES}")
    _check(x, q, sc, m, d, dm, tile_k)
    mrows, k = x.shape
    n = q.shape[1]
    if xs.dtype != torch.float32 or tuple(xs.shape) != (k // GROUP, mrows):
        raise TypeError(f"xs must be f32 [{k // GROUP}, {mrows}], got {xs.dtype} "
                        f"{tuple(xs.shape)}")
    _check_cuda(x, xs, q, sc, m, d, dm)
    part, y = _outputs(x, n, tile_k)
    QMM_UNPACK.launch(ptr(x), ptr(xs), ptr(q), ptr(sc), ptr(m), ptr(d), ptr(dm), ptr(part),
                      ptr(y), mrows, k, n, tile_k, UNPACK_MODES.index(unpack), int(biasdot),
                      stream_ptr(x.device))
    return y


def qmm_unpack_diag(x, q, sc, m, d, dm, *, mode: str, tile_k: int = TILE_K) -> torch.Tensor:
    """The function of `qmm_unpack_diag_plain`; the `qmm_unpack_diag`
    kernel on the card."""
    if not q.is_cuda:
        return qmm_unpack_diag_plain(x, q, sc, m, d, dm, mode=mode, tile_k=tile_k)
    if mode not in DIAG_MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {DIAG_MODES}")
    _check(x, q, sc, m, d, dm, tile_k)
    _check_cuda(x, q, sc, m, d, dm)
    mrows, k = x.shape
    n = q.shape[1]
    part, y = _outputs(x, n, tile_k)
    QMM_UNPACK_DIAG.launch(ptr(x), ptr(q), ptr(sc), ptr(m), ptr(d), ptr(dm), ptr(part), ptr(y),
                           mrows, k, n, tile_k, DIAG_MODES.index(mode), stream_ptr(x.device))
    return y


def group_sums(x: torch.Tensor) -> torch.Tensor:
    """Per-group sums of x [M, K], transposed and contiguous: f32 [K/32, M]."""
    mrows, k = x.shape
    return x.reshape(mrows, k // GROUP, GROUP).sum(dim=2).t().contiguous()


def _arrays(lin):
    return lin.q, lin.s, lin.b, lin.d, lin.dm


def bench_variant(name: str, unpack: str | None, biasdot: bool, tile_k: int = TILE_K,
                  tile_n: int = TILE_N, *, mode: str | None = None, m: int = M,
                  reps: int = REPS, k: int = K, n: int = N, device=None) -> dict:
    """Seconds per call of one variant (template (a): `unpack`, `biasdot`;
    template (b): `mode`) over `reps` chained calls on the original's zero
    q4_k weight: x = 0 but x[0, 0] = the carry c, c += sum(out) * 1e-20.
    The CUDA kernels' column tile is fixed at 64, so `tile_n` changes
    nothing but must divide N, as the original's does."""
    dev = resolve_device(device)
    if n % tile_n:
        raise ValueError(f"tile_n={tile_n} must divide N={n}")
    arrays = _arrays(synth_linear(k, n, "q4k", zeros=True, device=dev))
    x = torch.zeros(m, k, dtype=torch.float32, device=dev)
    c = torch.zeros(1, dtype=torch.float32, device=dev)

    def step():
        x[0, :1].copy_(c)
        if mode is None:
            out = qmm_unpack(x, group_sums(x), *arrays, unpack=unpack, biasdot=biasdot,
                             tile_k=tile_k)
        else:
            out = qmm_unpack_diag(x, *arrays, mode=mode, tile_k=tile_k)
        c.add_(out.sum() * 1e-20)

    t = chain_s(step, reps, dev)
    qb = sum(a.numel() * a.element_size() for a in arrays)
    print(f"{name:14s}: {t * 1e3:7.3f} ms  {qb / t / 1e9:6.1f} GB/s", flush=True)
    return {"ms": t * 1e3, "gb_s": qb / t / 1e9}


def check_weight(m: int = M):
    """The original check's seeded draw (numpy default_rng(0), the JAX
    package's synth_linear(512, 256, "q4k", zeros=False), then x [m, 512]),
    as numpy arrays: q, sc, m, d, dm, x."""
    rng = np.random.default_rng(0)
    k, n = CHECK_K, CHECK_N
    q = rng.integers(0, 255, (k // 2, n), dtype=np.uint8)
    sc = rng.integers(0, 64, (k // GROUP, n), dtype=np.int8)
    mm = rng.integers(0, 64, (k // GROUP, n), dtype=np.int8)
    d = rng.random((k // (GROUP * SB), n)).astype(np.float16) * np.float16(0.002)
    dm = rng.random((k // (GROUP * SB), n)).astype(np.float16) * np.float16(0.001)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return q, sc, mm, d, dm, x


def check_correct(unpack: str, biasdot: bool, *, m: int = M, device=None) -> float:
    """max |variant - K2| / (max |K2| + 1e-9) on the original's 512 x 256
    weight, one k tile of 512 rows."""
    from ..ops.cuda.qmm_kernel import qmm

    dev = resolve_device(device)
    *arrays, x = (torch.from_numpy(a).to(dev) for a in check_weight(m))
    q, sc, mm, d, dm = arrays
    ref = qmm(x, q, sc, mm, None, group=GROUP, packed=True, zero_point=0, d=d, dm=dm, sb=SB)
    out = qmm_unpack(x, group_sums(x), *arrays, unpack=unpack, biasdot=biasdot, tile_k=CHECK_K)
    return ((out - ref).abs().max() / (ref.abs().max() + 1e-9)).item()


def main(argv=None, *, device=None, m: int | None = None, reps: int | None = None,
         k: int = K, n: int = N) -> dict:
    """The five diagnostic bodies, then each variant checked against K2 and
    timed; `argv` [M] [reps] (the original reads them from the command
    line), or `m` and `reps`."""
    args = list(sys.argv[1:3] if argv is None else argv)
    m = m or (int(args[0]) if args else M)
    reps = reps or (int(args[1]) if len(args) > 1 else REPS)
    dev = resolve_device(device)
    out = {}
    for mode in DIAG_MODES:
        out["diag_" + mode] = bench_variant("diag_" + mode, None, False, mode=mode, m=m,
                                            reps=reps, k=k, n=n, device=dev)
    for name, unpack, biasdot in VARIANTS:
        err = check_correct(unpack, biasdot, m=m, device=dev)
        label = name + (f" (err {err:.1e})" if err > CHECK_TOL else "")
        out[name] = {"err": err, **bench_variant(label, unpack, biasdot, m=m, reps=reps, k=k,
                                                 n=n, device=dev)}
    return out


if __name__ == "__main__":
    main()
