"""Chip smoke test of the PyTorch/CUDA port (chatllm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. build   nvcc-build every kernel library from csrc/, print the card.
  2. kernels hold K1 qgemv, K2 qmm, K3 flash_attention and K4 flash_decode
             against their plain PyTorch versions at the Llama-3-8B shapes
             (K1: rel 1e-4 of the output scale; K2: 2e-2 of it; K3: atol
             2e-2, and per element 2^-7 (bf16 cache, or an f32 query over
             one) or 1e-4 (f32 cache) of |o| + 4 sqrt(sum_j p_j^2 v_j^2),
             see FLASH_SCALED_TOL; K4: the same measure, 2^-7 with bf16
             dots and 1e-4 with f32 ones, see DECODE_SCALED_TOL), and time
             the kernel, the plain version and one library call (a
             yardstick the port never calls).
  3. llama3_8b  full-width Llama-3-8B (32 layers, vocab 128256, random q4_k
             weights from a seed, max_length 8192) through InferenceEngine: a
             40-token and a 1000-token prompt, 64 greedy tokens each, over a
             bf16 cache (K1-K3 must launch), then the 1000-token prompt over
             a q8 cache (K4 launches 32 times per decode step).
  4. serve   the same model with a q8 cache behind the HTTP server with 4
             slots: 8 chat requests of ~30 to ~1000 tokens, 32 greedy tokens
             each, sent one at a time and then all at once; the replies must
             be identical, and K2 and K4 must launch.
  5. two_layer  2-layer cuts at full width against a CPU run of the same
             weights (1e-3 of the logit scale, same argmax): a 40-token
             prefill, and one batched decode step of 4 slots at per-row
             n_past over a q8 cache.
  6. cli     write narrow LLAMA3 GGMMs with the port's writer and chat
             through `python -m chatllm_tpu_torch.main` twice over a bf16
             cache and twice with --cache_dtype q8_0 (greedy).
Then it prints the kernels line, the card line and, last, the result line.
Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import struct
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM (NVIDIA data sheet)
BF16_TC_FLOPS = 989e12             # dense bf16 tensor cores
F32_FLOPS = 67e12                  # f32 outside the tensor cores

# Llama-3-8B projections (K, N) and their count per decode token / layer
SHAPES_8B = {"q_o": (4096, 4096), "k_v": (4096, 1024), "gate_up": (4096, 14336),
             "down": (14336, 4096), "lm_head": (4096, 128256)}
PER_LAYER = {"q_o": 2, "k_v": 2, "gate_up": 2, "down": 1}
N_LAYERS = 32


def log(msg: str):
    print(msg, flush=True)


def write_llama3_ggmm(path, *, vocab_pad: int = 384, hidden: int = 256, heads: int = 4,
                      kv_heads: int = 2, layers: int = 2, inter: int = 512,
                      max_len: int = 512, dtype=None, seed: int = 0, writer_cls=None,
                      rope_theta: float = 500000.0, rope_scaling=None,
                      visible_reserved: bool = False):
    """A narrow random-weight LLAMA3 GGMM: byte-level vocab (every byte a
    token, no merges) plus the Llama-3 chat control tokens, padded to
    `vocab_pad` entries with reserved tokens.  `rope_scaling` = (orig_ctx,
    factor, low_freq, high_freq) writes a LLAMA3_1 file instead.
    `writer_cls` defaults to the port's GGMMWriter (the tests pass the JAX
    package's).  The reserved tokens are control tokens, which decode to
    nothing; `visible_reserved` writes them as normal pieces that decode to
    their names (no merge ever forms them, so encoding is unchanged)."""
    from chatllm_tpu_torch.ggmm.quants import GGMLType
    from chatllm_tpu_torch.ggmm.writer import GGMMWriter
    from chatllm_tpu_torch.models.model_types import ModelType
    from chatllm_tpu_torch.tokenizer.processor import TokenType, byte_level_encode

    writer_cls = writer_cls or GGMMWriter
    dtype = GGMLType.Q4_K if dtype is None else GGMLType(int(dtype))
    pieces = [(byte_level_encode(bytes([b])), TokenType.NORMAL) for b in range(256)]
    specials = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
                "<|end_header_id|>", "<|eot_id|>"]
    pieces += [(s.encode(), TokenType.CONTROL) for s in specials]
    reserved = TokenType.NORMAL if visible_reserved else TokenType.CONTROL
    pieces += [(f"<|reserved_{i}|>".encode(), reserved)
               for i in range(vocab_pad - len(pieces))]
    bos, eos = 256, 257
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = shape[-1] ** -0.5 if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    d = hidden // heads
    with open(path, "wb") as f:
        mtype = ModelType.LLAMA3 if rope_scaling is None else ModelType.LLAMA3_1
        wr = writer_cls(f, int(mtype), 1, meta={"model_name": "tiny-llama3"})
        wr.write_config([int(dtype), vocab_pad, hidden, heads, layers, inter, max_len,
                         bos, eos, -1, -1, kv_heads], fmt="12i")
        f.write(struct.pack("<f", rope_theta))
        if rope_scaling is not None:
            orig_ctx, factor, low_f, high_f = rope_scaling
            f.write(struct.pack("<ifff", orig_ctx, factor, low_f, high_f))
        wr._patch_offset(12)
        wr.write_vocab_bpe([(p, int(t)) for p, t in pieces], [])
        wr.write_tensor("model.embed_tokens.weight", w(vocab_pad, hidden, scale=1.0),
                        GGMLType.F32)
        for i in range(layers):
            p = f"model.layers.{i}"
            wr.write_tensor(f"{p}.input_layernorm.weight",
                            1.0 + 0.1 * w(hidden, scale=1.0), GGMLType.F32)
            wr.write_tensor(f"{p}.self_attn.q_proj.weight", w(heads * d, hidden), dtype)
            wr.write_tensor(f"{p}.self_attn.k_proj.weight", w(kv_heads * d, hidden), dtype)
            wr.write_tensor(f"{p}.self_attn.v_proj.weight", w(kv_heads * d, hidden), dtype)
            wr.write_tensor(f"{p}.self_attn.o_proj.weight", w(hidden, heads * d), dtype)
            wr.write_tensor(f"{p}.post_attention_layernorm.weight",
                            1.0 + 0.1 * w(hidden, scale=1.0), GGMLType.F32)
            wr.write_tensor(f"{p}.mlp.gate_proj.weight", w(inter, hidden), dtype)
            wr.write_tensor(f"{p}.mlp.up_proj.weight", w(inter, hidden), dtype)
            wr.write_tensor(f"{p}.mlp.down_proj.weight", w(hidden, inter), dtype)
        wr.write_tensor("model.norm.weight", 1.0 + 0.1 * w(hidden, scale=1.0), GGMLType.F32)
        wr.write_tensor("lm_head.weight", w(vocab_pad, hidden), dtype)
    return path


# ---------------------------------------------------------------- timing
class Timer:
    """Per-launch CUDA-event timing with the L2 flushed before every
    launch (decode and prefill find their weights cold); median in ms."""

    def __init__(self, device):
        self.flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(nb: int, flops: float, peak: float):
    t_b, t_f = nb / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ------------------------------------------------------------ kernels phase
def quant_weight(fmt: str, K: int, N: int, gen, dev):
    from chatllm_tpu_torch.models.synthetic import synth_linear
    from chatllm_tpu_torch.ops.qtensor import QuantLinear

    if fmt == "q4_k":
        return synth_linear(K, N, "q4k", gen=gen, zeros=False, device=dev)
    G = 32
    s = (torch.rand(K // G, N, generator=gen, device=dev) * 0.01 + 1e-4).half()
    if fmt == "q8_0":
        q = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
        return QuantLinear(q=q, s=s)
    q = torch.randint(0, 256, (K // 2, N), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.uint8)
    if fmt == "q4_0":
        return QuantLinear(q=q, s=s, packed=True, zero_point=8)
    b = -(torch.rand(K // G, N, generator=gen, device=dev) * 0.08).half()
    return QuantLinear(q=q, s=s, b=b, packed=True)            # q4_1


def lin_args(lin):
    return ((lin.q, lin.s, lin.b, lin.bias),
            dict(group=lin.group_size, packed=lin.packed, zero_point=lin.zero_point,
                 d=lin.d, dm=lin.dm, sb=lin.sb))


def rel_err(y, ref) -> tuple[float, float]:
    diff = (y.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-30)


def kernels_phase(dev, timer) -> dict:
    from chatllm_tpu_torch.ops.cuda.gemv_kernel import qgemv, qgemv_plain
    from chatllm_tpu_torch.ops.cuda.qmm_kernel import qmm, qmm_plain
    from chatllm_tpu_torch.ops.qmm import dequant_weight

    gen = torch.Generator(device=dev).manual_seed(1)
    res = {"qgemv": {"cases": [], "shapes": {}}, "qmm": {"cases": [], "shapes": {}}}
    for fmt in ("q4_k", "q8_0", "q4_0", "q4_1"):
        for sname, (K, N) in SHAPES_8B.items():
            lin = quant_weight(fmt, K, N, gen, dev)
            arrays, kw = lin_args(lin)
            timed = fmt == "q4_k"
            w_bf16 = dequant_weight(lin, torch.bfloat16) if timed else None
            wbytes = nbytes(lin.q, lin.s, lin.b, lin.d, lin.dm)
            # K1
            x = torch.randn(1, K, generator=gen, device=dev).to(torch.bfloat16)
            y = qgemv(x, *arrays, **kw)
            ref = qgemv_plain(x, *arrays, **kw)
            torch.cuda.synchronize()
            err, rel = rel_err(y, ref)
            log(f"  qgemv {fmt:5s} K={K:5d} N={N:6d}  max_abs_err={err:.3e} rel={rel:.2e}")
            if not (torch.isfinite(y).all() and rel <= 1e-4):
                raise AssertionError(f"qgemv {fmt} {K}x{N}: rel err {rel} > 1e-4")
            res["qgemv"]["cases"].append({"fmt": fmt, "K": K, "N": N, "max_abs_err": err,
                                          "rel": rel})
            if timed:
                b_ms, b_by = bound(wbytes + nbytes(x, y), 2.0 * K * N, F32_FLOPS)
                res["qgemv"]["shapes"][sname] = {
                    "K": K, "N": N,
                    "ms": timer(lambda: qgemv(x, *arrays, **kw)),
                    "plain_ms": timer(lambda: qgemv_plain(x, *arrays, **kw), iters=5),
                    "library_ms": timer(lambda: torch.matmul(x, w_bf16)),
                    "bound_ms": b_ms, "bound_by": b_by}
                log(f"    timing {res['qgemv']['shapes'][sname]}")
            # K2
            for B in (2, 8, 37, 64):
                xb = torch.randn(B, K, generator=gen, device=dev).to(torch.bfloat16)
                yb = qmm(xb, *arrays, **kw)
                refb = qmm_plain(xb, *arrays, **kw)
                torch.cuda.synchronize()
                err, rel = rel_err(yb, refb)
                log(f"  qmm   {fmt:5s} K={K:5d} N={N:6d} B={B:2d}  max_abs_err={err:.3e} rel={rel:.2e}")
                if not (torch.isfinite(yb).all() and rel <= 2e-2):
                    raise AssertionError(f"qmm {fmt} {K}x{N} B={B}: rel err {rel} > 2e-2")
                res["qmm"]["cases"].append({"fmt": fmt, "K": K, "N": N, "B": B,
                                            "max_abs_err": err, "rel": rel})
                if timed and B == 64 and sname != "lm_head":
                    b_ms, b_by = bound(wbytes + nbytes(xb, yb), 2.0 * B * K * N,
                                       BF16_TC_FLOPS)
                    res["qmm"]["shapes"][sname] = {
                        "K": K, "N": N, "B": B,
                        "ms": timer(lambda: qmm(xb, *arrays, **kw)),
                        "plain_ms": timer(lambda: qmm_plain(xb, *arrays, **kw), iters=5),
                        "library_ms": timer(lambda: torch.matmul(xb, w_bf16)),
                        "bound_ms": b_ms, "bound_by": b_by}
                    log(f"    timing {res['qmm']['shapes'][sname]}")
            del lin, arrays, w_bf16
    res["flash_attention"] = flash_cases(dev, timer, gen)
    res["flash_decode"] = decode_cases(dev, timer, gen)
    return res


# K3's limit on |o - plain| / (|plain| + 4 sqrt(sum_j p_j^2 v_j^2)) per
# element, p the attention probabilities.  bf16: the kernel rounds its
# output (at most 2^-8 of |o|) and each probability (2^-8) to bf16; the
# probability roundings add errors of random sign, whose sum has a standard
# deviation of 2^-8 / sqrt(3) * sqrt(sum_j p_j^2 v_j^2), so 4 * 2^-8 * that
# root is ~7 deviations (and the worst case up to 16 visible keys).  Both
# terms can sit near their bounds in one element, so the limit is twice
# 2^-8.  f32: summation order only.
FLASH_SCALED_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}
FLASH_ATOL = 2e-2


def attention_probs(q, k, n_past: int, n_tokens: int, *, scale: float, causal: bool = True,
                    sliding_window: int = 0, logit_softcap: float = 0.0) -> torch.Tensor:
    """The K3 mask contract's probabilities in f32, [B, Hkv, G, T, S]."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    s = torch.einsum("bthgd,bshd->bhgts", q.float().reshape(B, T, Hkv, Hq // Hkv, D),
                     k.float()) * scale
    if logit_softcap > 0.0:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    q_pos = n_past + torch.arange(T, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    valid = k_pos < n_past + n_tokens
    if causal:
        valid = valid & (k_pos <= q_pos)
    if sliding_window > 0:
        valid = valid & (k_pos > q_pos - sliding_window)
    return torch.softmax(s.masked_fill(~valid, -1e30), dim=-1)


def flash_errors(o, q, k, v, n_past: int, n_tokens: int, **kw) -> tuple[float, float]:
    """(max abs error, max scaled error as in FLASH_SCALED_TOL) of a K3
    output against its plain version on the same inputs."""
    from chatllm_tpu_torch.ops.cuda.flash import flash_attention_plain

    B, T, Hq, D = q.shape
    ref = flash_attention_plain(q, k, v, n_past, n_tokens, **kw).float()
    p2 = attention_probs(q, k, n_past, n_tokens, **kw).square_()
    rms = torch.einsum("bhgts,bshd->bthgd", p2, v.float().square()).sqrt_()
    del p2
    diff = (o.float() - ref).abs()
    denom = ref.abs() + 4.0 * rms.reshape(B, T, Hq, D) + 1e-6
    return diff.max().item(), (diff / denom).max().item()


# K4's limits, per element as for K3: the kernel rounds each probability
# to bf16 against its 32-key tile's running max, the plain version against
# the row's max, so with bf16 dots the two round p * v_scale differently
# (each at most 2^-9 relative) and the output once each (q's dtype).  f32
# dots over an f32 query round nothing: summation order only.
DECODE_SCALED_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-4}
DECODE_ATOL = 2e-2


def flash_decode_errors(o, q, k, v, n_past, n_tokens: int, *, sinks=None, v_scale=None,
                        **kw) -> tuple[float, float]:
    """(max abs error, max scaled error as in DECODE_SCALED_TOL) of a K4
    output against its plain version on the same inputs."""
    from chatllm_tpu_torch.ops.cuda.flash_decode import decode_scores, flash_decode_plain

    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    ref = flash_decode_plain(q, k, v, n_past, n_tokens, sinks=sinks, v_scale=v_scale,
                             **kw).float()
    s = decode_scores(q, k, n_past, n_tokens, scale=kw["scale"],
                      sliding_window=kw.get("sliding_window", 0),
                      logit_softcap=kw.get("logit_softcap", 0.0),
                      k_scale=kw.get("k_scale"), qk_dtype=kw.get("qk_dtype"))
    m = s.amax(dim=-1, keepdim=True)
    if sinks is not None:
        sk = sinks.float().reshape(Hkv, Hq // Hkv)[None, :, :, None, None]
        m = torch.maximum(m, sk)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        den = den + torch.exp(sk - m)
    p2 = (p / den).square_()
    del s, p
    vf = v.float() if v_scale is None else v.float() * v_scale[..., None]
    rms = torch.einsum("bhgts,bshd->bthgd", p2, vf.square()).sqrt_()
    del p2, vf
    diff = (o.float() - ref).abs()
    denom = ref.abs() + 4.0 * rms.reshape(B, T, Hq, D) + 1e-6
    return diff.max().item(), (diff / denom).max().item()


def flash_cases(dev, timer, gen) -> dict:
    from chatllm_tpu_torch.ops.cuda.flash import flash_attention, flash_attention_plain

    Hq, Hkv, D = 32, 8, 128
    cases = [  # (T, S, n_past, n_tokens, window, softcap, timed as)
        (128, 1024, 0, 128, 0, 0.0, None),
        (512, 8192, 1000, 512, 0, 0.0, None),
        (128, 1024, 0, 100, 0, 0.0, None),         # padded prefill chunk
        (512, 8192, 1000, 512, 256, 0.0, None),    # sliding window
        (128, 1024, 64, 128, 0, 30.0, None),       # softcap
        (1024, 8192, 0, 1000, 0, 0.0, "prefill_1000"),   # the 1000-token chunk
    ]
    out = {"cases": [], "shapes": {}}
    # --cache_dtype bf16 / f32, and --compute_dtype f32 over a bf16 cache
    for qdt, dtype, tag in ((torch.bfloat16, torch.bfloat16, ""),
                            (torch.float32, torch.float32, "_f32"),
                            (torch.float32, torch.bfloat16, "_f32q")):
        for T, S, n_past, n_tok, win, cap, timed in cases:
            q = torch.randn(1, T, Hq, D, generator=gen, device=dev).to(qdt)
            k = torch.zeros(1, S, Hkv, D, device=dev, dtype=dtype)
            v = torch.zeros_like(k)
            kv_len = n_past + n_tok
            k[:, :kv_len] = torch.randn(1, kv_len, Hkv, D, generator=gen, device=dev).to(dtype)
            v[:, :kv_len] = torch.randn(1, kv_len, Hkv, D, generator=gen, device=dev).to(dtype)
            kw = dict(scale=D ** -0.5, causal=True, sliding_window=win, logit_softcap=cap)
            o = flash_attention(q, k, v, n_past, n_tok, **kw)
            err, scaled = flash_errors(o, q, k, v, n_past, n_tok, **kw)
            name = f"{str(qdt)[6:]}/{str(dtype)[6:]}"
            log(f"  flash {name:17s} T={T:4d} S={S:5d} n_past={n_past:4d} "
                f"n_tokens={n_tok:4d} window={win} softcap={cap}  max_abs_err={err:.3e} "
                f"scaled={scaled:.2e}")
            lim = FLASH_SCALED_TOL[dtype]
            if not (o.dtype == qdt and torch.isfinite(o).all() and err <= FLASH_ATOL
                    and scaled <= lim):
                raise AssertionError(f"flash {name} case {(T, S, n_past, n_tok, win, cap)}: "
                                     f"{o.dtype}, err {err} (limit {FLASH_ATOL}), scaled "
                                     f"{scaled} (limit {lim})")
            out["cases"].append({"dtype": str(dtype), "q_dtype": str(qdt), "T": T, "S": S,
                                 "n_past": n_past, "n_tokens": n_tok, "window": win,
                                 "softcap": cap, "max_abs_err": err, "scaled_err": scaled})
            if timed and tag != "_f32q":
                # visible (query, key) pairs: causal rows; padded rows see all keys
                qpos = n_past + np.arange(T)
                pairs = int(np.minimum(qpos + 1, kv_len).sum())
                peak = BF16_TC_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
                b_ms, b_by = bound(nbytes(q, o) + 2 * kv_len * Hkv * D * k.element_size(),
                                   4.0 * D * Hq * pairs, peak)
                G = Hq // Hkv
                qt = q.transpose(1, 2)
                kt = k.transpose(1, 2).repeat_interleave(G, dim=1)
                vt = v.transpose(1, 2).repeat_interleave(G, dim=1)
                qp = torch.arange(T, device=dev)[:, None] + n_past
                kp = torch.arange(S, device=dev)[None, :]
                mask = (kp < kv_len) & (kp <= qp)
                sdpa = torch.nn.functional.scaled_dot_product_attention
                out["shapes"][timed + tag] = {
                    "T": T, "S": S, "n_tokens": n_tok, "dtype": str(dtype),
                    "ms": timer(lambda: flash_attention(q, k, v, n_past, n_tok, **kw)),
                    "plain_ms": timer(lambda: flash_attention_plain(q, k, v, n_past, n_tok,
                                                                    **kw), iters=5),
                    "library_ms": timer(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                                     scale=kw["scale"])),
                    "bound_ms": b_ms, "bound_by": b_by}
                log(f"    timing {out['shapes'][timed + tag]}")
            del q, k, v, o
    return out


DECODE_S = 8192
DECODE_CASES = [  # (B, T, Hq, Hkv, D, n_past, cache, dots, extra, timed as)
    (1, 1, 32, 8, 128, [1000], "int8", "bfloat16", {}, "decode_1000"),
    (1, 1, 32, 8, 128, [8000], "int8", "bfloat16", {}, "decode_8000"),
    (4, 1, 32, 8, 128, [10, 1000, 4095, 8000], "int8", "bfloat16", {}, "serve_4"),
    (2, 2, 32, 8, 128, [3000, 6000], "int8", "bfloat16", {}, None),
    (1, 1, 32, 8, 128, [5000], "int8", "bfloat16",
     {"sliding_window": 256, "logit_softcap": 30.0}, None),
    (1, 1, 32, 8, 128, [3000], "int8", "bfloat16", {"sinks": True}, None),
    (1, 1, 32, 8, 128, [6000], "bfloat16", "bfloat16", {}, None),
    (1, 1, 8, 4, 64, [5000], "int8", "float32", {}, None),    # the per-head case
    (1, 1, 32, 8, 128, [5000], "int8", "float32", {}, None),
]


def decode_cases(dev, timer, gen) -> dict:
    """K4 at Llama-3-8B's attention shapes over an 8192-slot cache."""
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_plain

    out = {"cases": [], "shapes": {}}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for B, T, Hq, Hkv, D, n_past, cache, dots, extra, timed in DECODE_CASES:
        S, G = DECODE_S, Hq // Hkv
        # bf16 dots take the model's bf16 query; f32 dots an f32 one
        q = torch.randn(B, T, Hq, D, generator=gen, device=dev).to(getattr(torch, dots))
        k = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
        v = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
        kw = dict(scale=D ** -0.5, qk_dtype=dots, sliding_window=extra.get("sliding_window", 0),
                  logit_softcap=extra.get("logit_softcap", 0.0))
        if extra.get("sinks"):
            kw["sinks"] = torch.randn(Hq, generator=gen, device=dev)
        if cache == "int8":
            (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_kv(k), quantize_kv(v)
        else:
            k, v = k.to(getattr(torch, cache)), v.to(getattr(torch, cache))
        npv = torch.tensor(n_past, dtype=torch.int64, device=dev)
        o = flash_decode(q, k, v, npv, T, **kw)
        err, scaled = flash_decode_errors(o, q, k, v, npv, T, **kw)
        name = (f"B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} n_past={n_past} {cache} {dots} dots "
                f"{extra}")
        log(f"  flash_decode {name}  max_abs_err={err:.3e} scaled={scaled:.2e}")
        lim = DECODE_SCALED_TOL[dots]
        if not (o.dtype == q.dtype and torch.isfinite(o).all() and err <= DECODE_ATOL
                and scaled <= lim):
            raise AssertionError(f"flash_decode {name}: err {err} (limit {DECODE_ATOL}), "
                                 f"scaled {scaled} (limit {lim})")
        out["cases"].append({"B": B, "T": T, "Hq": Hq, "Hkv": Hkv, "D": D, "n_past": n_past,
                             "cache": cache, "dots": dots, "extra": str(extra),
                             "max_abs_err": err, "scaled_err": scaled})
        if timed:
            live = [min(n + T, S) for n in n_past]
            per_key = Hkv * (2 * D * k.element_size() + (8 if cache == "int8" else 0))
            b_ms, b_by = bound(nbytes(q, o) + sum(live) * per_key,
                               4.0 * D * Hq * T * sum(live),
                               BF16_TC_FLOPS if dots == "bfloat16" else F32_FLOPS)
            # yardstick: SDPA over the cache dequantized to bf16 beforehand
            kd, vd = ((t.float() * sc[..., None]).to(torch.bfloat16)
                      for t, sc in ((k, kw["k_scale"]), (v, kw["v_scale"])))
            kt = kd.transpose(1, 2).repeat_interleave(G, dim=1)
            vt = vd.transpose(1, 2).repeat_interleave(G, dim=1)
            qt = q.transpose(1, 2)
            qp = npv[:, None, None, None] + torch.arange(T, device=dev)[None, None, :, None]
            mask = torch.arange(S, device=dev)[None, None, None, :] <= qp
            out["shapes"][timed] = {
                "B": B, "T": T, "S": S, "n_past": n_past, "live_keys": live,
                "ms": timer(lambda: flash_decode(q, k, v, npv, T, **kw)),
                "plain_ms": timer(lambda: flash_decode_plain(q, k, v, npv, T, **kw), iters=5),
                "library_ms": timer(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                                 scale=kw["scale"])),
                "bound_ms": b_ms, "bound_by": b_by}
            log(f"    timing {out['shapes'][timed]}")
            del kd, vd, kt, vt, mask
        del q, k, v, o
    return out


# --------------------------------------------------------- llama3_8b phase
def llama3_8b_phase(dev, cfg, params) -> dict:
    """The chat path at full width: bf16 cache (K1-K3), then a q8 cache
    (K4 on every decode step), each path's launches counted from 0."""
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine, PerfInfo

    eng = InferenceEngine(cfg, params, device=dev)
    rng = np.random.default_rng(0)
    prompts = {"prompt_40": rng.integers(0, cfg.vocab_size, 40).tolist(),
               "prompt_1000": rng.integers(0, cfg.vocab_size, 1000).tolist()}
    gcfg = GenerationConfig(do_sample=False, max_new_tokens=64)
    eng.generate(prompts["prompt_40"][:8], replace(gcfg, max_new_tokens=4))   # warm-up

    def run(engine, name, ids, before):
        perf = PerfInfo()
        out, _, n_past = engine.generate(ids, gcfg, perf=perf)
        torch.cuda.synchronize()
        after = launch_counts()
        # the first token comes out of the prefill; gen_ms times the
        # len(out) - 1 decode steps after it
        steps = len(out) - 1
        r = {"prompt_tokens": len(ids), "prefill_ms": perf.prompt_ms,
             "gen_tokens": perf.gen_tokens, "decode_steps": steps,
             "decode_ms": perf.gen_ms, "decode_tok_s": steps / perf.gen_ms * 1e3,
             "launches": {k: after[k] - before[k] for k in after}}
        log(f"  {name}: {r}")
        if len(out) != gcfg.max_new_tokens or n_past != len(ids) + len(out) - 1:
            raise AssertionError(f"{name}: {len(out)} tokens, n_past {n_past}")
        return r, after

    res = {}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    before = launch_counts()
    for name, ids in prompts.items():
        res[name], before = run(eng, name, ids, before)
    res["launches"] = launch_counts()
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"  main-path launches {res['launches']}, peak memory "
        f"{res['peak_mem_gib']:.2f} GiB")
    for k in ("qgemv", "qmm", "flash_attention"):
        if res["launches"][k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    del eng
    torch.cuda.empty_cache()

    # --cache_dtype q8_0: the 1000-token prompt, 64 greedy tokens
    eng = InferenceEngine(replace(cfg, cache_dtype="int8"), params, device=dev)
    eng.generate(prompts["prompt_40"][:8], replace(gcfg, max_new_tokens=4))   # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    r, _ = run(eng, "q8_prompt_1000", prompts["prompt_1000"], launch_counts())
    r["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    r["flash_decode_per_step"] = r["launches"]["flash_decode"] / r["decode_steps"]
    res["q8_prompt_1000"] = r
    log(f"  q8 cache: prefill {r['prefill_ms']:.1f} ms, {r['decode_tok_s']:.2f} decode "
        f"steps/s, peak memory {r['peak_mem_gib']:.2f} GiB, K4 launches "
        f"{r['launches']['flash_decode']} ({r['flash_decode_per_step']:.0f} per step)")
    want = cfg.num_hidden_layers * (gcfg.max_new_tokens - 1)
    if r["launches"]["flash_decode"] != want:
        raise AssertionError(f"q8 run: K4 launched {r['launches']['flash_decode']} times, "
                             f"expected {want}")
    return res


def _cut(params, n_layers: int, device) -> dict:
    """The first n_layers of the parameters, on `device`."""
    return {"embed": params["embed"].to(device),
            "final_norm": {"w": params["final_norm"]["w"].to(device)},
            "lm_head": params["lm_head"].to(device),
            "layers": tuple({"attn_norm": {"w": L["attn_norm"]["w"].to(device)},
                             "ffn_norm": {"w": L["ffn_norm"]["w"].to(device)},
                             "attn": {n: lin.to(device) for n, lin in L["attn"].items()},
                             "mlp": {n: lin.to(device) for n, lin in L["mlp"].items()}}
                            for L in params["layers"][:n_layers])}


def _compare_logits(name: str, g, c) -> dict:
    g, c = g.float().cpu(), c.float()
    if g.shape != c.shape or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: logits shape {tuple(g.shape)} or not finite")
    err, rel = rel_err(g, c)
    r = {"max_abs_err": err, "rel_to_logit_scale": rel,
         "argmax_equal": bool(torch.equal(g.argmax(-1), c.argmax(-1))),
         "logit_scale": c.abs().max().item()}
    log(f"  {name}: {r}")
    if rel > 1e-3 or not r["argmax_equal"]:
        raise AssertionError(f"{name}: logits differ from the CPU run: rel {rel} > 1e-3, "
                             "or an argmax differs")
    return r


def two_layer_phase(dev, cfg, params) -> dict:
    """2-layer cuts at full width, the card (kernels) against the CPU (plain
    versions): a 40-token prefill over a bf16 cache, and one batched decode
    step of 4 slots at per-row n_past over a q8 cache (K4)."""
    from chatllm_tpu_torch.nn.transformer import init_cache, transformer_forward
    from chatllm_tpu_torch.runtime.generate import InferenceEngine

    cfg2 = replace(cfg, num_hidden_layers=2)
    p2, p2_cpu = _cut(params, 2, dev), _cut(params, 2, "cpu")
    res = {}
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, 40).tolist()
    outs = []
    for p, d in ((p2, dev), (p2_cpu, "cpu")):
        eng = InferenceEngine(cfg2, p, device=d)
        outs.append(eng.prefill(ids, eng.new_cache(1, 1024), 0)[0])
    res["two_layer_vs_cpu"] = _compare_logits("2-layer prefill card vs cpu", *outs)

    cfg_q8 = replace(cfg2, cache_dtype="int8")
    gen = torch.Generator().manual_seed(5)
    caches = [init_cache(cfg_q8, 4, 8192, device=d) for d in (dev, "cpu")]
    for i in range(2):           # random q8 contents, the same on both sides
        for name in ("k", "v"):
            q8 = torch.randint(-127, 128, caches[1].k[i].shape, generator=gen,
                               dtype=torch.int32).to(torch.int8)
            sc = torch.rand(caches[1].k_scale[i].shape, generator=gen) * 0.02 + 1e-3
            for c in caches:
                getattr(c, name)[i].copy_(q8)
                getattr(c, name + "_scale")[i].copy_(sc)
    toks = torch.tensor([[11], [2024], [77777], [128000]]) % cfg.vocab_size
    n_past = torch.tensor([5, 1000, 4095, 8000])
    outs = [transformer_forward(cfg_q8, p, toks.to(d), c, n_past.to(d))[0][:, 0]
            for p, c, d in ((p2, caches[0], dev), (p2_cpu, caches[1], "cpu"))]
    res["batched_decode_vs_cpu"] = _compare_logits(
        "2-layer batched q8 decode step (4 slots) card vs cpu", *outs)
    return res


# ------------------------------------------------------------- serve phase
SERVE_PROMPT_BYTES = (20, 80, 150, 260, 400, 560, 760, 980)


def serve_phase(dev, cfg, params) -> dict:
    """Full-width Llama-3-8B (q8 cache, max_length 8192) behind the HTTP
    server with 4 slots: 8 chat requests of ~30 to ~1000 tokens, 32 greedy
    tokens each, first one at a time, then all at once from 8 threads."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from chatllm_tpu_torch.models import load_model
    from chatllm_tpu_torch.models.base import BaseLLM
    from chatllm_tpu_torch.models.model_types import ModelType
    from chatllm_tpu_torch.ops.cuda.build import BUILD_DIR, launch_counts, reset_launch_counts
    from chatllm_tpu_torch.runtime.generate import GenerationConfig
    from chatllm_tpu_torch.serve.server import ApiServer, _make_handler

    # the tokenizer of a narrow GGMM with Llama-3's vocab size, so that every
    # id the random model emits decodes, to visible text; its weights stay
    # unused
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = write_llama3_ggmm(BUILD_DIR / "smoke_vocab128256.bin", vocab_pad=cfg.vocab_size,
                             hidden=64, heads=2, kv_heads=1, layers=1, inter=128,
                             dtype=0, visible_reserved=True)           # GGMLType.F32
    tok = load_model(str(path), device="cpu").tokenizer
    model = BaseLLM(int(ModelType.LLAMA3), replace(cfg, cache_dtype="int8"), params, tok, dev)
    api = ApiServer(model, model_name="llama3-8b-synthetic", max_slots=4, device=dev,
                    gen_config=GenerationConfig(do_sample=False, max_new_tokens=32))
    produced = []                 # token ids per request, in submission order
    submit = api.batch.submit

    def counting_submit(ids, **kw):
        h, toks = submit(ids, **kw), []
        produced.append((tuple(ids), toks))

        class Counted:
            def __iter__(self):
                for t in h:
                    toks.append(t)
                    yield t
        return Counted()

    api.batch.submit = counting_submit
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(api))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}/v1/chat/completions"
    rng = np.random.default_rng(3)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    prompts = ["".join(rng.choice(letters, n)) for n in SERVE_PROMPT_BYTES]

    def request(text, rec):
        body = json.dumps({"messages": [{"role": "user", "content": text}],
                           "stream": True}).encode()
        t0 = time.perf_counter()
        req = urllib.request.Request(url, body, {"Content-Type": "application/json"})
        parts, first = [], None
        with urllib.request.urlopen(req, timeout=600) as r:
            for line in r:
                line = line.strip()
                if not line.startswith(b"data: ") or line == b"data: [DONE]":
                    continue
                if first is None:
                    first = time.perf_counter() - t0
                parts.append(json.loads(line[6:])["choices"][0]["delta"].get("content", ""))
        rec.update(text="".join(parts), ttfb_s=first, total_s=time.perf_counter() - t0)

    request(prompts[0][:10], {})                            # warm-up
    produced.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    seq = [{} for _ in prompts]
    t0 = time.perf_counter()
    for text, rec in zip(prompts, seq):
        request(text, rec)
    seq_s = time.perf_counter() - t0
    seq_tokens = dict(produced)
    produced.clear()
    conc = [{} for _ in prompts]
    threads = [threading.Thread(target=request, args=(text, rec))
               for text, rec in zip(prompts, conc)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    conc_s = time.perf_counter() - t0
    launches = launch_counts()
    httpd.shutdown()
    api.batch.shutdown()
    conc_tokens = dict(produced)          # prompt ids -> generated ids
    n_seq = sum(map(len, seq_tokens.values()))
    n_conc = sum(map(len, conc_tokens.values()))
    res = {"prompt_tokens": [len(api._encode_chat([{"role": "user", "content": t}]))
                             for t in prompts],
           "sequential": {"wall_s": seq_s, "gen_tokens": n_seq,
                          "decode_tok_s": n_seq / seq_s, "requests": seq},
           "concurrent": {"wall_s": conc_s, "gen_tokens": n_conc,
                          "decode_tok_s": n_conc / conc_s, "requests": conc},
           "launches": launches,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    for name in ("sequential", "concurrent"):
        r = res[name]
        log(f"  serve {name}: {r['gen_tokens']} tokens in {r['wall_s']:.2f} s "
            f"({r['decode_tok_s']:.2f} tok/s aggregate); ttfb s "
            f"{[round(x['ttfb_s'], 3) for x in r['requests']]}, last byte s "
            f"{[round(x['total_s'], 3) for x in r['requests']]}")
    log(f"  serve launches {launches}, peak memory {res['peak_mem_gib']:.2f} GiB, "
        f"prompt tokens {res['prompt_tokens']}")
    if [r["text"] for r in conc] != [r["text"] for r in seq] or not all(
            r["text"] for r in seq):
        raise AssertionError("concurrent replies differ from the sequential ones:\n"
                             f"{[r['text'] for r in seq]}\n{[r['text'] for r in conc]}")
    if conc_tokens != seq_tokens or len(seq_tokens) != len(prompts) or n_seq == 0:
        raise AssertionError("concurrent token ids differ from the sequential ones")
    for k in ("qmm", "flash_decode"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the server")
    res["replies"] = [r["text"] for r in seq]
    return res


# --------------------------------------------------------------- cli phase
def cli_phase() -> dict:
    """Two greedy CLI chats over a bf16 cache, and two with `--cache_dtype
    q8_0` at a 4096-token context (K4 on every decode step): each pair's
    transcripts must be byte-identical."""
    from chatllm_tpu_torch.ops.cuda.build import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = write_llama3_ggmm(BUILD_DIR / "smoke_llama3_q4k.bin")
    path_q8 = write_llama3_ggmm(BUILD_DIR / "smoke_llama3_q4k_4096.bin", max_len=4096)
    cmd = [sys.executable, "-m", "chatllm_tpu_torch.main", "-p", "Hello from the H100!",
           "-t", "0", "--max_new_tokens", "8"]

    def chat(s):
        return [ln for ln in s.splitlines() if "eval time:" not in ln]

    res = {}
    for name, extra in (("transcript", ["-m", str(path)]),
                        ("transcript_q8", ["-m", str(path_q8), "--cache_dtype", "q8_0"])):
        runs = []
        for _ in range(2):
            r = subprocess.run(cmd + extra, cwd=ROOT, capture_output=True, text=True,
                               timeout=300)
            if r.returncode != 0:
                raise AssertionError(f"cli exit {r.returncode}:\n{r.stdout}\n{r.stderr}")
            runs.append(r.stdout)
        log(f"  {name}:\n" + runs[0].rstrip())
        for s in runs:
            if sum("eval time:" in ln for ln in s.splitlines()) != 2:
                raise AssertionError(f"perf lines missing:\n{s}")
        if chat(runs[0]) != chat(runs[1]):
            raise AssertionError(f"greedy transcripts differ:\n{runs[0]}\n---\n{runs[1]}")
        res[name] = runs[0]
    return res


# ---------------------------------------------------------------- report
KERNEL_META = {
    "qgemv": ("chatllm_tpu_torch/csrc/qgemv.cu",
              "chatllm_tpu/ops/pallas/gemv_kernel.py:161"),
    "qmm": ("chatllm_tpu_torch/csrc/qmm.cu", "chatllm_tpu/ops/pallas/qmm_kernel.py:141"),
    "flash_attention": ("chatllm_tpu_torch/csrc/flash_attention.cu",
                        "chatllm_tpu/ops/pallas/flash.py:113"),
    "flash_decode": ("chatllm_tpu_torch/csrc/flash_decode.cu",
                     "chatllm_tpu/ops/pallas/flash_decode.py:114"),
}


def kernels_line(kres: dict, launches: dict) -> dict:
    """One entry per kernel, its times summed over the main path's calls of
    one unit of work: qgemv = one decode token (32 x 7 projections + the
    lm_head), qmm = one <=64-token prefill chunk (32 x 7 at 64 rows),
    flash_attention = the 1000-token prompt's chunk (32 layers), flash_decode
    = one decode step after the 1000-token prompt over a q8 cache (32
    layers).  `launches` counts each kernel on its own path: K1-K3 on the
    bf16-cache chat path, K4 on the q8-cache one."""
    mult = {"qgemv": {**{k: N_LAYERS * v for k, v in PER_LAYER.items()}, "lm_head": 1},
            "qmm": {k: N_LAYERS * v for k, v in PER_LAYER.items()},
            "flash_attention": {"prefill_1000": N_LAYERS},
            "flash_decode": {"decode_1000": N_LAYERS}}
    entries = []
    for name, (src, rep) in KERNEL_META.items():
        shapes = kres[name]["shapes"]
        tot = {f: sum(mult[name][s] * shapes[s][f] for s in mult[name])
               for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
        # what bounds the shape that contributes most to the bound
        top = max(mult[name], key=lambda s: mult[name][s] * shapes[s]["bound_ms"])
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in kres[name]["cases"]),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": shapes[top]["bound_by"],
            "library_ms": tot["library_ms"]})
    return {"kernels": entries}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    from chatllm_tpu_torch.ops.cuda.build import build_all

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"torch": torch.__version__, "cuda": torch.version.cuda}

    log("== build")
    t0 = time.perf_counter()
    logs = build_all()
    report["build_s"] = time.perf_counter() - t0
    for name, text in logs.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  {name}: {ln.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    report["card"] = smi
    log(f"  built in {report['build_s']:.1f} s on {smi} (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda})")

    log("== kernels")
    timer = Timer(dev)
    report["kernels"] = kernels_phase(dev, timer)
    del timer
    torch.cuda.empty_cache()

    from chatllm_tpu_torch.models.synthetic import build_synthetic_params, llama3_8b_config

    cfg = llama3_8b_config(max_length=8192)
    t0 = time.perf_counter()
    params = build_synthetic_params(cfg, "q4k", zeros=False, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"== llama3_8b: built {cfg.num_hidden_layers}-layer synthetic q4_k params in "
        f"{time.perf_counter() - t0:.1f} s")
    report["llama3_8b"] = llama3_8b_phase(dev, cfg, params)
    torch.cuda.empty_cache()

    log("== serve")
    report["serve"] = serve_phase(dev, cfg, params)
    torch.cuda.empty_cache()

    log("== two_layer")
    report["two_layer"] = two_layer_phase(dev, cfg, params)
    del params
    torch.cuda.empty_cache()

    log("== cli")
    report["cli"] = cli_phase()

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    launches = dict(report["llama3_8b"]["launches"],
                    flash_decode=report["llama3_8b"]["q8_prompt_1000"]["launches"]["flash_decode"])
    print(json.dumps(kernels_line(report["kernels"], launches)))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
