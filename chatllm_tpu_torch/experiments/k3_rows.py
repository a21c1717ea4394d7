"""K3's f32 block height at D 128: blocks of 128 query rows (8 x 4 register
tiles of S a thread) against blocks of 64 (4 x 4), at the shapes where
csrc/flash_attention.cu's `f32_rows` picks 128.

    python -m chatllm_tpu_torch.experiments.k3_rows [rounds]

Builds a second copy of the K3 library whose `f32_rows` always returns 64
and launches both libraries, through the same call, on the same inputs in
mode 1 (f32 cache) and mode 2 (f32 query over a bf16 cache).  Each round
times both in the order A B (B A in odd rounds), each as the median of 20
launches with the L2 flushed before every launch, as chip_smoke.py's timer
does.  Prints one JSON object: per shape and variant, each round's median
ms, their mean, and their spread (the largest minus the smallest), and the
largest difference between the two variants' outputs.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

from ..ops.cuda.build import BUILD_DIR, CSRC, FLASH, CudaKernel, ptr, stream_ptr
from ..ops.cuda.flash import MODES

ROWS_LINE = "return D == 128 && (T + 127) / 128 * Hq * B >= sms ? 128 : 64;"
L3 = (32, 8, 128)                 # Llama-3-8B: query heads, kv heads, head dim
SHAPES = {  # name: (T, S, n_past, n_tokens)
    "prefill_1000": (1024, 8192, 0, 1000),        # the 1000-token chunk
    "chunk_1024_at_4096": (1024, 8192, 4096, 1024),
}


def rows64_kernel() -> CudaKernel:
    """The K3 library with every f32 launch on 64-row blocks."""
    src = (CSRC / FLASH.source).read_text()
    if src.count(ROWS_LINE) != 1:
        raise RuntimeError(f"f32_rows' choice not found in {FLASH.source}")
    out = BUILD_DIR / "k3_rows" / "flash_attention_rows64.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src.replace(ROWS_LINE, "return 64;"))
    return CudaKernel(str(out), FLASH.fn, FLASH.argtypes, name="k3_rows64")


def launch(kern: CudaKernel, q, k, v, n_past: int, n_tokens: int) -> torch.Tensor:
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    strides = (ctypes.c_long * 12)(*(q.stride()[:3] + k.stride()[:3]
                                     + v.stride()[:3] + o.stride()[:3]))
    kern.launch(ptr(q), ptr(k), ptr(v), ptr(o), ctypes.cast(strides, ctypes.c_void_p),
                B, T, S, Hq, Hkv, D, n_past, n_tokens, D ** -0.5, 1, 0, 0.0,
                MODES[(q.dtype, k.dtype)], stream_ptr(q.device))
    return o


def median_ms(fn, flush: torch.Tensor, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("k3_rows: needs a CUDA card", file=sys.stderr)
        return 2
    rounds = int(argv[0]) if argv else 4
    dev = torch.device("cuda", 0)
    variants = {"rows_128": FLASH, "rows_64": rows64_kernel()}
    flush = torch.empty(2 ** 30, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    Hq, Hkv, D = L3
    res = {}
    for name, (T, S, n_past, n_tok) in SHAPES.items():
        for tag, cache in (("_f32", torch.float32), ("_f32q", torch.bfloat16)):
            q = torch.randn(1, T, Hq, D, generator=gen, device=dev)
            k = torch.randn(1, S, Hkv, D, generator=gen, device=dev).to(cache)
            v = torch.randn(1, S, Hkv, D, generator=gen, device=dev).to(cache)
            outs = {var: launch(kern, q, k, v, n_past, n_tok) for var, kern in variants.items()}
            times = {var: [] for var in variants}
            for r in range(rounds):
                order = list(variants) if r % 2 == 0 else list(variants)[::-1]
                for var in order:
                    times[var].append(median_ms(
                        lambda: launch(variants[var], q, k, v, n_past, n_tok), flush))
            res[name + tag] = {
                "T": T, "S": S, "n_past": n_past, "n_tokens": n_tok,
                "max_abs_diff": float((outs["rows_128"] - outs["rows_64"]).abs().max()),
                **{var: {"round_ms": t, "mean_ms": float(np.mean(t)),
                         "spread_ms": max(t) - min(t)} for var, t in times.items()}}
            print(f"{name + tag}: {res[name + tag]}", file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
