"""E1: decode-GEMV strategy probe.  Every variant streams L = 16 layers of
[K, N] = [4096, 14336] weights per step with the activation carried from
layer to layer (so nothing can be hoisted), over STEPS = 8 steps.

    python -m chatllm_tpu_torch.experiments.gemv_probe [stream vpu mxu_int8 mxu_dequant pallas_qmm mxu_bf16 mxu_bf16_b8]

Counterpart of experiments/gemv_probe.py.  Its two Pallas kernels compute
the functions of E2's (experiments/gemv_probe2.py), so they run on E2's
hand-written CUDA kernels (csrc/gemv_probe.cu, through gemv_probe2's
wrappers): `stream_max` on `gemv_stream`, `vpu_gemv` on `gemv_vpu`.
`mxu_int8`, `mxu_dequant`, `mxu_bf16` and `mxu_bf16_b8` are the library's
products (yardsticks: the original leaves them to the compiler outside any
kernel), and `pallas_qmm` keeps its name and runs K2 on one row.  Each
variant prints the original's line: ms per step, the GB/s of weight bytes
it moved, and the tok/s an 8e9-weight model would reach at that rate.  It
prints it once for an eager call (the host issues every launch) and, on
the card, once for a replay of one CUDA graph captured from the same loop:
the counterpart of the original's one jitted program, with no host step
between the layers.
"""
from __future__ import annotations

import sys

import torch

from ..device import resolve_device
from ..ops.qmm import dot_f32
from . import gemv_probe2 as e2
from .timing import eager_and_graph_s, sync

L, K, N = 16, 4096, 14336
STEPS = 8
GROUP = 32
INT_MM_ROWS = e2.INT_MM_ROWS     # torch._int_mm takes more than 16 rows
VARIANTS = ("stream", "vpu", "mxu_int8", "mxu_dequant", "pallas_qmm", "mxu_bf16",
            "mxu_bf16_b8")


def stream_max(w: torch.Tensor) -> torch.Tensor:
    """int8 [K, N] -> int32 [8, N]: max(0, the max over the rows k with
    k % 8 == r).  E2's `stream_once`: the `gemv_stream` kernel on the card."""
    return e2.stream_once(w)


def stream_max_plain(w: torch.Tensor) -> torch.Tensor:
    return e2.stream_once_plain(w)


def vpu_gemv(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x: f32 [K, 1]; w: int8 [K, N]; s: f32 [K/32, N].  Returns f32 [1, N]
    = sum_g s[g] * sum_{k in g} w[k] x[k].  E2's `vpu_once`: the `gemv_vpu`
    kernel on the card."""
    return e2.vpu_once(x, w, s).reshape(1, -1)


def vpu_gemv_plain(x, w, s) -> torch.Tensor:
    return e2.vpu_once_plain(x, w, s).reshape(1, -1)


def chain(y: torch.Tensor, k: int) -> torch.Tensor:
    """y: [B, N] -> the next x [B, K], data-dependent."""
    return torch.tanh(y[:, :k].float() * 1e-3)


def weights(l: int, k: int, n: int, device):
    """int8 [l, k, n] in [-127, 127) and f32 [l, k/32, n] scales in [0, 0.01),
    drawn on the device from a seeded generator, one layer at a time."""
    gen = torch.Generator(device=device).manual_seed(0)
    wq = torch.empty(l, k, n, dtype=torch.int8, device=device)
    for i in range(l):
        wq[i] = torch.randint(-127, 127, (k, n), generator=gen, device=device,
                              dtype=torch.int32)
    ws = torch.rand(l, k // GROUP, n, generator=gen, device=device) * 0.01
    return wq, ws


# Each run_* returns a function that runs `steps` steps over every layer and
# returns the last carry.

def run_mxu(W, B: int, int8: bool, steps: int):
    k = W.shape[1]

    def fn():
        x = torch.ones(B, k, dtype=torch.float32, device=W.device)
        xp = torch.zeros(INT_MM_ROWS, k, dtype=torch.int8, device=W.device) if int8 else None
        for _ in range(steps):
            for w in W:
                if int8:          # f32 -> int8 truncates, as the original's astype
                    xp[:B] = x.to(torch.int8)
                    y = torch._int_mm(xp, w)[:B]
                else:
                    y = dot_f32(x.to(torch.bfloat16), w)
                x = chain(y, k)
        return x
    return fn


def run_mxu_dequant(Wq, Ws, B: int, steps: int):
    _, k, n = Wq.shape

    def fn():
        x = torch.ones(B, k, dtype=torch.float32, device=Wq.device)
        for _ in range(steps):
            for w, s in zip(Wq, Ws):
                wf = (w.to(torch.bfloat16).reshape(k // GROUP, GROUP, n)
                      * s[:, None, :].to(torch.bfloat16)).reshape(k, n)
                x = chain(dot_f32(x.to(torch.bfloat16), wf), k)
        return x
    return fn


def run_pallas_qmm(Wq, Ws, B: int, steps: int):
    from ..ops.cuda.qmm_kernel import qmm

    k = Wq.shape[1]

    def fn():
        x = torch.ones(B, k, dtype=torch.float32, device=Wq.device)
        for _ in range(steps):
            for w, s in zip(Wq, Ws):
                x = chain(qmm(x, w, s), k)
        return x
    return fn


def run_vpu(Wq, Ws, steps: int):
    k = Wq.shape[1]

    def fn():
        x = torch.ones(1, k, dtype=torch.float32, device=Wq.device)
        for _ in range(steps):
            for w, s in zip(Wq, Ws):
                x = chain(vpu_gemv(x.reshape(k, 1), w, s), k)
        return x
    return fn


def run_stream(Wq, steps: int):
    def fn():
        c = torch.zeros((), dtype=torch.int32, device=Wq.device)
        for _ in range(steps):
            for w in Wq:
                c = c + stream_max(w).max()
        return c
    return fn


def timed(fn, steps: int, device) -> dict:
    """Seconds per step by mode: "eager" (after a warm-up call) and, on the
    card, "graph" (the best replay of one CUDA graph captured from `fn`)."""
    print("  compiling...", flush=True)
    t = eager_and_graph_s(fn, device)
    return {mode: t[mode] / steps for mode in ("eager", "graph") if mode in t}


def report(name: str, dt_steps: dict, bytes_per_step: int, weights_per_step: int,
           note: str = "") -> dict:
    """The original's line for each timing mode, tagged with the mode."""
    res = {}
    for mode, dt in dt_steps.items():
        gbs = bytes_per_step / dt / 1e9
        toks = 1.0 / (dt * (8e9 / weights_per_step))      # scaled to an 8B model
        print(f"{name:14s} {mode:5s} {dt * 1e3:8.2f} ms/step  {gbs:7.1f} GB/s  "
              f"-> {toks:6.1f} tok/s @8B{note}", flush=True)
        res |= {f"{mode}_ms_per_step": dt * 1e3, f"{mode}_gb_s": gbs,
                f"{mode}_tok_s_8b": toks}
    return res


def main(argv=None, *, device=None, l: int = L, k: int = K, n: int = N,
         steps: int = STEPS) -> dict:
    """Run the named variants (all seven by default) over `l` layers of
    [k, n] (k <= n) for `steps` steps; returns their results by name."""
    which = list(sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    unknown = [w for w in which if w not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; choose from {VARIANTS}")
    dev = resolve_device(device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
          flush=True)
    Wq, Ws = weights(l, k, n, dev)
    sync(dev)
    print("weights ready", flush=True)
    int8_bytes = l * k * n
    out = {}
    if "stream" in which:
        out["stream"] = report("stream_max", timed(run_stream(Wq, steps), steps, dev),
                               int8_bytes, int8_bytes)
    if "vpu" in which:
        out["vpu"] = report("vpu_gemv", timed(run_vpu(Wq, Ws, steps), steps, dev),
                            int8_bytes, int8_bytes)
    if "mxu_int8" in which:
        out["mxu_int8"] = report(
            "mxu_int8", timed(run_mxu(Wq, 1, True, steps), steps, dev), int8_bytes,
            int8_bytes, f"  (x padded to {INT_MM_ROWS} rows: torch._int_mm takes more than 16)")
    if "mxu_dequant" in which:
        out["mxu_dequant"] = report("mxu_dequant",
                                    timed(run_mxu_dequant(Wq, Ws, 1, steps), steps, dev),
                                    int8_bytes, int8_bytes)
    if "pallas_qmm" in which:
        out["pallas_qmm"] = report("pallas_qmm",
                                   timed(run_pallas_qmm(Wq, Ws, 1, steps), steps, dev),
                                   int8_bytes, int8_bytes)
    if "mxu_bf16" in which or "mxu_bf16_b8" in which:
        Wb = Wq.to(torch.bfloat16) * 0.01
        del Wq
        for name, B in (("mxu_bf16", 1), ("mxu_bf16_b8", 8)):
            if name in which:
                out[name] = report(name, timed(run_mxu(Wb, B, False, steps), steps, dev),
                                   2 * int8_bytes, int8_bytes)
    return out


if __name__ == "__main__":
    main()
