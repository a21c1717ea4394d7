"""E2: GEMV design probe over ONE [K, N] int8 weight (64 MB at the default
size: beyond the L2 cache, so every iteration streams device memory).

    python -m chatllm_tpu_torch.experiments.gemv_probe2 [stream|vpu|mxu_int8|mxu_bf16|dequant|pallas_qmm]

Counterpart of experiments/gemv_probe2.py.  `stream_once` and `vpu_once`
are hand-written CUDA kernels (csrc/gemv_probe.cu), each with a plain
PyTorch version that CPU tensors take; `mxu_int8`, `mxu_bf16` and `dequant`
are the library's products (yardsticks: the original leaves them to the
compiler outside any kernel), and `pallas_qmm` keeps its name and runs K2.
Each variant prints ms per iteration and the GB/s of weight bytes it moved.
"""
from __future__ import annotations

import math
import sys
import time

import torch

from ..device import resolve_device
from ..ops.cuda.build import GEMV_STREAM, GEMV_VPU, num_sms, ptr, stream_ptr

K, N = 4096, 16384            # 64 MB int8
ITERS = 64
GROUP = 32
TILE_N = 512                  # columns per block (csrc/gemv_probe.cu)
INT_MM_ROWS = 32              # torch._int_mm takes more than 16 rows


def _check(w: torch.Tensor, mult: int):
    if w.dtype != torch.int8 or w.dim() != 2 or not w.is_contiguous():
        raise TypeError(f"w must be contiguous int8 [K, N], got {w.dtype} {tuple(w.shape)}")
    if w.shape[0] % mult or w.shape[1] % 16 or w.data_ptr() % 16:
        raise ValueError(f"w {tuple(w.shape)}: need K % {mult} == 0, N % 16 == 0, 16-byte aligned")


def _splits(units: int, n: int, sms: int) -> int:
    """K splits: about four blocks per SM, at least 8 units of K each."""
    return max(1, min(math.ceil(4 * sms / math.ceil(n / TILE_N)), units // 8))


def stream_once_plain(w: torch.Tensor) -> torch.Tensor:
    """int8 [K, N] -> int32 [8, N]: the max over the rows k with k % 8 == r,
    and 0 where that is below 0 (the Pallas kernel's accumulator starts at 0)."""
    k, n = w.shape
    return w.reshape(k // 8, 8, n).to(torch.int32).amax(dim=0).clamp_min(0)


def stream_once(w: torch.Tensor) -> torch.Tensor:
    if not w.is_cuda:
        return stream_once_plain(w)
    _check(w, 8)
    k, n = w.shape
    out = torch.empty(8, n, dtype=torch.int32, device=w.device)
    GEMV_STREAM.launch(ptr(w), ptr(out), k, n, _splits(k // 8, n, num_sms(w.device)),
                       stream_ptr(w.device))
    return out


def vpu_once_plain(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """y[n] = sum_g s[g, n] * sum_{k in g} w[k, n] * x[k], all in f32."""
    k, n = w.shape
    t = (w.float() * x.reshape(k, 1).float()).reshape(k // GROUP, GROUP, n).sum(dim=1)
    return (t * s.float()).sum(dim=0)


def vpu_once(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x: f32 [K, 1] or [K]; w: int8 [K, N]; s: f32 [K/32, N].  Returns f32 [N]."""
    if not w.is_cuda:
        return vpu_once_plain(x, w, s)
    _check(w, GROUP)
    k, n = w.shape
    if x.dtype != torch.float32 or x.numel() != k or x.device != w.device:
        raise TypeError(f"x must be {k} f32 values on {w.device}")
    if (s.dtype != torch.float32 or tuple(s.shape) != (k // GROUP, n) or s.device != w.device
            or not s.is_contiguous() or s.data_ptr() % 16):
        raise TypeError(f"s must be contiguous f32 [{k // GROUP}, {n}] on {w.device}")
    xc = x.reshape(k).contiguous()
    y = torch.empty(n, dtype=torch.float32, device=w.device)
    n_splits = _splits(k // GROUP, n, num_sms(w.device))
    part = (torch.empty(n_splits * n, dtype=torch.float32, device=w.device)
            if n_splits > 1 else None)
    GEMV_VPU.launch(ptr(xc), ptr(w), ptr(s), ptr(part), ptr(y), k, n, n_splits,
                    stream_ptr(w.device))
    return y


def weights(k: int, n: int, device):
    gen = torch.Generator(device=device).manual_seed(0)
    wq = torch.randint(-127, 127, (k, n), generator=gen, device=device,
                       dtype=torch.int32).to(torch.int8)
    ws = torch.rand(k // GROUP, n, generator=gen, device=device) * 0.01
    return wq, ws


# Each run_* returns a function that chains `iters` iterations: an iteration's
# input depends on the previous output, as in the original's fori_loop.

def run_stream(wq, ws, iters):
    def fn():
        c = torch.zeros((), dtype=torch.int32, device=wq.device)
        for i in range(iters):
            c = c + stream_once(wq)[0, 0] + i
        return c
    return fn


def run_vpu(wq, ws, iters):
    k = wq.shape[0]

    def fn():
        x = torch.ones(k, 1, dtype=torch.float32, device=wq.device)
        for _ in range(iters):
            x = torch.tanh(vpu_once(x, wq, ws)[:k] * 1e-3).reshape(k, 1)
        return x
    return fn


def run_mxu_int8(wq, ws, iters):
    k = wq.shape[0]

    def fn():
        x = torch.ones(INT_MM_ROWS, k, dtype=torch.int8, device=wq.device)
        for _ in range(iters):
            y = torch._int_mm(x, wq)
            x = torch.clamp(y[:, :k] >> 8, -127, 127).to(torch.int8)
        return x
    return fn


def run_mxu_bf16(wq, ws, iters):
    k = wq.shape[0]
    wb = wq.to(torch.bfloat16) * 0.01

    def fn():
        x = torch.ones(8, k, dtype=torch.bfloat16, device=wq.device)
        for _ in range(iters):
            x = torch.tanh(torch.matmul(x, wb).float()[:, :k] * 1e-3).to(torch.bfloat16)
        return x
    return fn


def run_dequant(wq, ws, iters):
    k, n = wq.shape

    def fn():
        x = torch.ones(8, k, dtype=torch.bfloat16, device=wq.device)
        for _ in range(iters):
            wf = (wq.to(torch.bfloat16).reshape(k // GROUP, GROUP, n)
                  * ws[:, None, :].to(torch.bfloat16)).reshape(k, n)
            x = torch.tanh(torch.matmul(x, wf).float()[:, :k] * 1e-3).to(torch.bfloat16)
        return x
    return fn


def run_pallas_qmm(wq, ws, iters):
    from ..ops.cuda.qmm_kernel import qmm

    k = wq.shape[0]

    def fn():
        x = torch.ones(1, k, dtype=torch.float32, device=wq.device)
        for _ in range(iters):
            x = torch.tanh(qmm(x, wq, ws)[:, :k] * 1e-3)
        return x
    return fn


VARIANTS = {  # name -> (runner, weight bytes moved per iteration / (K * N))
    "stream": (run_stream, 1), "vpu": (run_vpu, 1), "mxu_int8": (run_mxu_int8, 1),
    "mxu_bf16": (run_mxu_bf16, 2), "dequant": (run_dequant, 1),
    "pallas_qmm": (run_pallas_qmm, 1),
}


def bench(fn, bytes_per_iter: int, weights_per_iter: int, name: str, iters: int,
          device) -> dict:
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    fn()
    sync()
    print(f"[{name}] build+warm {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    fn()
    sync()
    dt = (time.perf_counter() - t0) / iters
    gbs = bytes_per_iter / dt / 1e9
    toks = 1.0 / (dt * (8e9 / weights_per_iter))     # an 8e9-weight model at this rate
    print(f"[{name}] {dt * 1e3:7.3f} ms/iter  {gbs:7.1f} GB/s  -> {toks:6.1f} tok/s @8B",
          flush=True)
    return {"ms_per_iter": dt * 1e3, "gb_s": gbs}


def main(argv=None, *, device=None, k: int = K, n: int = N, iters: int = ITERS) -> dict:
    """Run the named variants (all of them by default); returns their
    results by name."""
    names = list(sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    dev = resolve_device(device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
          flush=True)
    wq, ws = weights(k, n, dev)
    print("weights ready", flush=True)
    out = {}
    for name in names:
        runner, mult = VARIANTS[name]
        out[name] = bench(runner(wq, ws, iters), mult * k * n, k * n, name, iters, dev)
    return out


if __name__ == "__main__":
    main()
