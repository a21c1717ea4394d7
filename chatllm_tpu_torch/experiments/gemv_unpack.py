"""E4: B=1 GEMV nibble-unpack variants of K1's superblock q4_k body.

  v0  production chain: widen, & 0xF, (>> 4) & 0xF, two conversions
  v1  no mask after >> 4
  v2  one conversion: qf = f32(q); hi = floor(qf / 16); lo = qf - 16 hi
  v3  v2 + algebraic MAC: hi*xh + lo*xl = qf*(xh/16) + lo*(xl - xh/16)
      (one multiply fewer per byte)

    python -m chatllm_tpu_torch.experiments.gemv_unpack [reps]

Counterpart of experiments/gemv_unpack.py.  One hand-written CUDA kernel
templated on the mode (csrc/gemv_unpack.cu) computes the Pallas body's
[8, N] output; `unpack_gemv_plain` is its plain PyTorch version, which CPU
tensors take.  For each mode, `check` compares it with K1 (the port's
`qgemv`) on a 2048 x 256 q4_k weight; a mode within 1e-4 of K1's output
scale is timed by `bench` at 4096 x 14336 over `reps` chained calls (each
call's input depends on the previous output), replayed from one CUDA graph
on the card as the original times one compiled scan; a mode that misses
prints its error instead.
"""
from __future__ import annotations

import math
import sys

import torch

from ..device import resolve_device
from ..models.synthetic import synth_linear
from ..ops.cuda.build import UNPACK_GEMV, num_sms, ptr, stream_ptr
from .timing import chain_s

REPS = 2048
K, N = 4096, 14336
GROUP, SB = 32, 8
MODES = ("v0", "v1", "v2", "v3")
TILE_N = 128            # columns per block (csrc/gemv_unpack.cu)
CHECK_TOL = 1e-4


def _check(x, q, sc, m, d, dm):
    k2, n = q.shape
    k = 2 * k2
    ng = k // GROUP
    want = {"q": (q, torch.uint8, (k2, n)), "sc": (sc, torch.int8, (ng, n)),
            "m": (m, torch.int8, (ng, n)), "d": (d, torch.float16, (ng // SB, n)),
            "dm": (dm, torch.float16, (ng // SB, n))}
    if k % (GROUP * SB) or n % 16:
        raise ValueError(f"K={k} must be a multiple of {GROUP * SB}, N={n} of 16")
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != x.device:
            raise TypeError(f"{name}: expected {dtype} {shape} on {x.device}, got {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if x.numel() != k:
        raise ValueError(f"x has {x.numel()} values, expected K={k}")


def unpack_gemv_plain(x, q, sc, m, d, dm, *, mode: str) -> torch.Tensor:
    """x: [K] or [K, 1] float; q: uint8 [K/2, N]; sc, m: int8 [K/32, N]; d,
    dm: f16 [K/256, N].  Returns f32 [8, N]: row r = sum_g s_g * (p[g, r] +
    p[g, r + 8]), row 0 less sum_g m_g * dmin_g * sum(x over group g), with
    p[g, j] = lo * x[32g + j] + hi * x[32g + 16 + j] computed as `mode` says."""
    _check(x, q, sc, m, d, dm)
    k2, n = q.shape
    gs = 2 * k2 // GROUP
    xf = x.reshape(-1).float()
    xg = xf.reshape(gs, GROUP, 1)
    xl, xh = xg[:, :GROUP // 2], xg[:, GROUP // 2:]
    qi = q.reshape(gs, GROUP // 2, n).to(torch.int32)
    if mode == "v0":
        p = (qi & 0xF).float() * xl + ((qi >> 4) & 0xF).float() * xh
    elif mode == "v1":
        p = (qi & 0xF).float() * xl + (qi >> 4).float() * xh
    elif mode in ("v2", "v3"):
        qf = qi.float()
        hi = torch.floor(qf * 0.0625)
        lo = qf - hi * 16.0
        p = lo * xl + hi * xh if mode == "v2" else qf * (xh * 0.0625) + lo * (xl - xh * 0.0625)
    else:
        raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
    t = p[:, :8] + p[:, 8:]                                          # [gs, 8, N]
    s = (sc.float().reshape(gs // SB, SB, n) * d.float()[:, None, :]).reshape(gs, n)
    out = (t * s[:, None, :]).sum(dim=0)
    bb = (m.float().reshape(gs // SB, SB, n) * dm.float()[:, None, :]).reshape(gs, n)
    out[0] -= (bb * xf.reshape(gs, GROUP).sum(dim=1)[:, None]).sum(dim=0)
    return out


def unpack_gemv(x, q, sc, m, d, dm, *, mode: str) -> torch.Tensor:
    """The function of `unpack_gemv_plain`; the `unpack_gemv` kernel,
    instantiated for `mode`, on the card."""
    if not q.is_cuda:
        return unpack_gemv_plain(x, q, sc, m, d, dm, mode=mode)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
    _check(x, q, sc, m, d, dm)
    k2, n = q.shape
    k = 2 * k2
    xc = x.reshape(k).to(torch.float32).contiguous()
    splits = max(1, min(math.ceil(2 * num_sms(q.device) / math.ceil(n / TILE_N)),
                        k // GROUP // 8))
    part = (torch.empty(splits * 8 * n, dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    out = torch.empty(8, n, dtype=torch.float32, device=q.device)
    UNPACK_GEMV.launch(ptr(xc), ptr(q), ptr(sc), ptr(m), ptr(d), ptr(dm), ptr(part), ptr(out),
                       k, n, MODES.index(mode), splits, stream_ptr(q.device))
    return out


def _lin_arrays(lin):
    return lin.q, lin.s, lin.b, lin.d, lin.dm


def check(mode: str, *, device=None) -> float:
    """max |sum of the 8 rows - K1| / max |K1| on a random 2048 x 256 q4_k
    weight and a normal x."""
    from ..ops.cuda.gemv_kernel import qgemv

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    lin = synth_linear(2048, 256, "q4k", gen=gen, zeros=False, device=dev)
    x = torch.randn(1, 2048, generator=gen, device=dev)
    ref = qgemv(x, lin.q, lin.s, lin.b, None, group=GROUP, packed=True, zero_point=0,
                d=lin.d, dm=lin.dm, sb=SB)
    y = unpack_gemv(x, *_lin_arrays(lin), mode=mode).sum(dim=0, keepdim=True)
    return ((y - ref).abs().max() / (ref.abs().max() + 1e-9)).item()


def bench(mode: str, *, device=None, reps: int = REPS, k: int = K, n: int = N) -> dict:
    """Seconds per call over `reps` chained calls on a zero q4_k weight
    (x = 0 but x[0] = the carry c; c += sum(out) * 1e-20).  The kernel's
    tiles are fixed (csrc/gemv_unpack.cu), so it takes no tile arguments."""
    dev = resolve_device(device)
    lin = synth_linear(k, n, "q4k", zeros=True, device=dev)
    arrays = _lin_arrays(lin)
    x = torch.zeros(k, dtype=torch.float32, device=dev)
    c = torch.zeros(1, dtype=torch.float32, device=dev)

    def body():
        x[:1].copy_(c)
        c.add_(unpack_gemv(x, *arrays, mode=mode).sum() * 1e-20)

    t = chain_s(body, reps, dev)
    qb = sum(a.numel() * a.element_size() for a in arrays)
    print(f"{mode}: {t * 1e3:7.3f} ms  {qb / t / 1e9:6.1f} GB/s", flush=True)
    return {"ms": t * 1e3, "gb_s": qb / t / 1e9}


def main(argv=None, *, device=None, reps: int | None = None, k: int = K,
         n: int = N) -> dict:
    """Check and time every mode; `argv[0]`, or `reps`, sets the number of
    chained calls (the original reads it from the command line)."""
    args = list(sys.argv[1:] if argv is None else argv)
    reps = reps or (int(args[0]) if args else REPS)
    dev = resolve_device(device)
    out = {}
    for mode in MODES:
        err = check(mode, device=dev)
        if err < CHECK_TOL:
            out[mode] = {"err": err, **bench(mode, device=dev, reps=reps, k=k, n=n)}
        else:
            print(f"{mode}(ERR {err:.1e}): not timed", flush=True)
            out[mode] = {"err": err}
    return out


if __name__ == "__main__":
    main()
