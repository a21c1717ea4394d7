"""K4's tile copy (csrc/flash_decode.cu, float dots): one pass over a key
row's 16-byte chunks that copies its K chunk and, for the first VNCH chunks,
its V chunk, against the same copy as two passes, one over K's chunks and
one over V's.

    python -m chatllm_tpu_torch.experiments.k4_copy [rounds]

Builds a second copy of the K4 library with the copy split into the two
passes and launches both libraries through the wrapper (`flash_decode`) on
the same inputs: Llama-3-8B's q8 decode shapes (bf16 dots; n_past 1000,
8000, four rows of the server, one live key) and DeepSeek-V2-Lite's at (192,
128) (f32 dots, n_past 1000).  Each round times both in the order A B (B A
in odd rounds), each as the median of 20 launches with the L2 flushed before
every launch (`k3_rows.median_ms`).  Prints one JSON object: per shape and
variant, each round's median ms, their mean and their spread, and whether
the two variants' outputs are bit-equal.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops.attention import quantize_kv
from ..ops.cuda.build import BUILD_DIR, CSRC, FLASH_DECODE, CudaKernel
from ..ops.cuda.flash_decode import flash_decode
from .k3_rows import median_ms

ONE_PASS = """\
            if (c < Gm::VNCH)
                cp16(st + Gm::VOFF + j * Gm::VROWB + c * 16,
                     ok ? vb + kp * p.vst.t + c * Gm::VEC : vb, ok);
        }
"""
TWO_PASSES = """\
        }
        for (int idx = tid; idx < TK * Gm::VNCH; idx += FTHREADS) {
            const int j = idx / Gm::VNCH, c = idx - j * Gm::VNCH, kp = t * TK + j;
            const bool ok = kp >= lo && kp < hi;
            cp16(st + Gm::VOFF + j * Gm::VROWB + c * 16,
                 ok ? vb + kp * p.vst.t + c * Gm::VEC : vb, ok);
        }
"""
SHAPES = {  # name: (B, Hq, Hkv, Dk, Dv, n_past, dots)
    "decode_1000": (1, 32, 8, 128, 128, [1000], "bfloat16"),
    "decode_8000": (1, 32, 8, 128, 128, [8000], "bfloat16"),
    "serve_4": (4, 32, 8, 128, 128, [10, 1000, 4095, 8000], "bfloat16"),
    "decode_floor": (1, 32, 8, 128, 128, [0], "bfloat16"),
    "mla_decode_1000": (1, 16, 16, 192, 128, [1000], "float32"),
}
S = 8192


def two_pass_kernel() -> CudaKernel:
    """The K4 library with K's and V's chunks copied in two passes."""
    src = (CSRC / FLASH_DECODE.source).read_text()
    if src.count(ONE_PASS) != 1:
        raise RuntimeError(f"the tile copy's V chunk not found in {FLASH_DECODE.source}")
    out = BUILD_DIR / "k4_copy" / "flash_decode_two_pass.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src.replace(ONE_PASS, TWO_PASSES))
    return CudaKernel(str(out), FLASH_DECODE.fn, FLASH_DECODE.argtypes, name="k4_two_pass")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("k4_copy: needs a CUDA card", file=sys.stderr)
        return 2
    rounds = int(argv[0]) if argv else 4
    dev = torch.device("cuda", 0)
    libs = {}
    for var, kern in (("one_pass", FLASH_DECODE), ("two_passes", two_pass_kernel())):
        kern._load()
        libs[var] = (kern._call, kern._lib)
    own = libs["one_pass"]

    def call(var, *args, **kw):
        FLASH_DECODE._call, FLASH_DECODE._lib = libs[var]
        try:
            return flash_decode(*args, **kw)
        finally:
            FLASH_DECODE._call, FLASH_DECODE._lib = own

    flush = torch.empty(2 ** 30, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for name, (B, Hq, Hkv, Dk, Dv, n_past, dots) in SHAPES.items():
        q = torch.randn(B, 1, Hq, Dk, generator=gen, device=dev).to(getattr(torch, dots))
        (k, ks), (v, vs) = (quantize_kv(torch.randn(B, S, Hkv, d, generator=gen, device=dev))
                            for d in (Dk, Dv))
        npv = torch.tensor(n_past, dtype=torch.int64, device=dev)
        args = (q, k, v, npv, 1)
        kw = dict(scale=Dk ** -0.5, k_scale=ks, v_scale=vs, qk_dtype=dots)
        outs = {var: call(var, *args, **kw) for var in libs}
        times = {var: [] for var in libs}
        for r in range(rounds):
            for var in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                times[var].append(median_ms(lambda: call(var, *args, **kw), flush))
        res[name] = {"B": B, "Dk": Dk, "Dv": Dv, "n_past": n_past, "dots": dots,
                     "bit_equal": torch.equal(outs["one_pass"], outs["two_passes"]),
                     **{var: {"round_ms": t, "mean_ms": float(np.mean(t)),
                              "spread_ms": max(t) - min(t)} for var, t in times.items()}}
        print(f"{name}: {res[name]}", file=sys.stderr)
    print(json.dumps(res))
    return 0 if all(r["bit_equal"] for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
