"""Chip smoke test of the PyTorch/CUDA port (chatllm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. build   nvcc-build every kernel library from csrc/, print the card.
  2. kernels hold K1 qgemv, K2 qmm, K3 flash_attention, K4 flash_decode
             (also its int8 dots, its 64-row shapes, and E7's head-major
             cache at B 32), K5 qmm_decode, K6 the read probe, E2's
             stream_once / vpu_once (also at E1's 4096 x 14336), E3's
             stream_read / qgemv_bf16, E4's unpack_gemv (modes v0-v3), E5's
             qmm_dma and E6's qmm_unpack (three variants) and
             qmm_unpack_diag (five modes)
             against their plain PyTorch versions at the Llama-3-8B shapes,
             and K1-K5 at the Qwen2.5-0.5B shapes too (q8_0 with a bias, head
             dim 64, 14 query heads over 2 kv heads); K1 and K2 also on every
             layout they take (q4_k, q5_k, q6_k, q2_k, q8_0, q4_0, q4_1, f32
             scales with b, q8_0 with a bias), bf16 and f32 x, 1-64 rows on
             both sides of every tile edge, N that are not multiples of K2's
             128 or 256 columns and a K that ends a tile part way, each
             launch twice and bit-identical, and K2 bit-equal to its plain
             version on one-hot rows (COVER_*); `quantize_kv` on the card
             bit-equal to the CPU
             (K1: rel 1e-4 of the output scale; K2, K5: 2e-2 of it; K6 and
             stream_once: exact; vpu_once: 1e-5 of the output scale; K3: atol
             2e-2, and per element 2^-7 (bf16 cache, or an f32 query over
             one) or 1e-4 (f32 cache) of |o| + 4 sqrt(sum_j p_j^2 v_j^2),
             see FLASH_SCALED_TOL; K4: the same measure, 2^-7 with bf16
             dots and 1e-4 with f32 ones, see DECODE_SCALED_TOL; its int8
             dots: two quantization steps, see DECODE_INT8_STEPS;
             stream_read, qgemv_bf16 and qmm_dma: exact; unpack_gemv: 1e-5
             of the output scale, and 1e-4 against K1; qmm_unpack and
             qmm_unpack_diag: 1e-5 of the output scale), and time
             the kernel, the plain version and one library call (a
             yardstick the port never calls).
  3. llama3_8b  full-width Llama-3-8B (32 layers, vocab 128256, random q4_k
             weights from a seed, max_length 8192) through InferenceEngine: a
             40-token and a 1000-token prompt, 64 greedy tokens each, over a
             bf16 cache (K1-K3 must launch), then the 1000-token prompt over
             a q8 cache (K4 launches 32 times per decode step).
  4. bench   `chatllm_tpu_torch.bench.run_bench` on the same full-width
             params (TTFT at 512 and 2048 tokens, single-stream and batched
             decode, the K6 read-bandwidth probe), its JSON line printed; then
             the B=8 batched decode once more with CHATLLM_TPU_QMM_V2=1 (K5
             launches 225 times per step, K2 not at all) and K5's tokens and
             last-step logits held against K2's on the same token history
             (0.9 of the tokens equal, logits within 5e-3 of their scale);
             then `python -m chatllm_tpu_torch.bench` as a user runs it, with
             a short BENCH_STEPS, over the bf16 and the q8 cache.
  5. serve   the same model with a q8 cache behind the HTTP server with 4
             slots: 8 chat requests of ~30 to ~1000 tokens, 32 greedy tokens
             each, sent one at a time and then all at once; the replies must
             be identical, and K2 and K4 must launch.
  6. two_layer  2-layer cuts at full width against a CPU run of the same
             weights (1e-3 of the logit scale, same argmax): a 40-token
             prefill, and one batched decode step of 4 slots at per-row
             n_past over a q8 cache.
     int8_engine  the same model over a q8 cache under
             CHATLLM_TPU_FLASH_QK=int8: the first decode step after the
             1000-token prompt against the bf16-dot run (INT8_LOGIT_TOL, same
             argmax), then 16 greedy tokens, K4's int8 dots launched 32
             times per decode step.
     switches  CHATLLM_TPU_FLASH_DECODE=1 (forced) and =0 on a bf16 cache at
             B = 8 through BatchedEngine (K4 32 times per batched step, or
             never), CHATLLM_TPU_FLASH=0 on the 1000-token prefill (no K3).
  7. qwen2   full-width Qwen2.5-0.5B (24 layers, vocab 151936, random q8_0
             weights with non-zero q/k/v biases, tied lm_head, max_length
             8192) through InferenceEngine over bf16 and q8 caches with exact
             launch counts (168 quantized projections per token), and its
             2-layer cuts against the CPU (1e-2 of the logit scale, same
             argmax).
  8. cli     write narrow LLAMA3 and Qwen2 GGMMs with the port's writer and
             chat through `python -m chatllm_tpu_torch.main` twice each
             (bf16 cache; --cache_dtype q8_0; Qwen2 with ChatML and a tied
             head), greedy: each pair's transcripts are byte-identical.
  9. e2      `chatllm_tpu_torch.experiments.gemv_probe2.main`, all six
             variants.
 10. e1      `chatllm_tpu_torch.experiments.gemv_probe.main`, all seven
             variants (16 layers of 4096 x 14336 x 8 steps; E2's kernels),
             each timed eagerly and by a CUDA-graph replay.
 11. e3      `chatllm_tpu_torch.experiments.gemv_model_bench.main`, the
             sweep of vpu (K1), stream (stream_read), vpu_bf16 (qgemv_bf16)
             and mxu (K2) over 3.93 GB of Llama-3-8B-shaped q4 weights, each
             timed eagerly and by a CUDA-graph replay (ms/token of both).
 12. e4      `chatllm_tpu_torch.experiments.gemv_unpack.main`: each unpack
             mode checked against K1, then timed over 2048 chained calls.
 13. e5      `chatllm_tpu_torch.experiments.qmm_m32.main`: the copy-only
             pass and K2 at M = 32 (q4k, q8, q4), 2048 chained calls each.
 14. e6      `chatllm_tpu_torch.experiments.qmm_unpack_variants.main`: the
             five diagnostic bodies and the three variants at M 32, K 4096,
             N 14336, each checked against K2, 2048 chained calls each.
 15. e7      `chatllm_tpu_torch.experiments.bhsd_decode.main`: the 8
             variant/cache combinations of a Llama-3-8B decode step at B 32
             over 1024 slots, 48 steps eagerly and as a CUDA-graph replay.
             Phases 9-15 count every kernel's launches exactly.
Then it prints the kernels line, the card line and, last, the result line.
Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import gc
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
        _write_dense_tensors(wr, w, dtype, vocab_pad, hidden, heads, kv_heads, layers, inter)
    return path


def _write_dense_tensors(wr, w, dtype, vocab: int, hidden: int, heads: int, kv_heads: int,
                         layers: int, inter: int, *, qkv_bias: bool = False,
                         tie: bool = False):
    """The llama-family tensors of a narrow model, drawn from `w`; norm
    weights, biases and the embedding stay f32, as the converter leaves them."""
    from chatllm_tpu_torch.ggmm.quants import GGMLType

    d = hidden // heads
    wr.write_tensor("model.embed_tokens.weight", w(vocab, hidden, scale=1.0), GGMLType.F32)
    for i in range(layers):
        p = f"model.layers.{i}"
        wr.write_tensor(f"{p}.input_layernorm.weight",
                        1.0 + 0.1 * w(hidden, scale=1.0), GGMLType.F32)
        for name, n_out in (("q", heads * d), ("k", kv_heads * d), ("v", kv_heads * d)):
            wr.write_tensor(f"{p}.self_attn.{name}_proj.weight", w(n_out, hidden), dtype)
            if qkv_bias:
                wr.write_tensor(f"{p}.self_attn.{name}_proj.bias", w(n_out, scale=0.5),
                                GGMLType.F32)
        wr.write_tensor(f"{p}.self_attn.o_proj.weight", w(hidden, heads * d), dtype)
        wr.write_tensor(f"{p}.post_attention_layernorm.weight",
                        1.0 + 0.1 * w(hidden, scale=1.0), GGMLType.F32)
        wr.write_tensor(f"{p}.mlp.gate_proj.weight", w(inter, hidden), dtype)
        wr.write_tensor(f"{p}.mlp.up_proj.weight", w(inter, hidden), dtype)
        wr.write_tensor(f"{p}.mlp.down_proj.weight", w(hidden, inter), dtype)
    wr.write_tensor("model.norm.weight", 1.0 + 0.1 * w(hidden, scale=1.0), GGMLType.F32)
    if not tie:
        wr.write_tensor("lm_head.weight", w(vocab, hidden), dtype)


def write_qwen2_ggmm(path, *, vocab_pad: int = 384, hidden: int = 256, heads: int = 4,
                     kv_heads: int = 2, layers: int = 2, inter: int = 512,
                     max_len: int = 512, dtype=None, seed: int = 0, writer_cls=None,
                     rope_theta: float = 1000000.0, tie: bool = True):
    """A narrow random-weight Qwen2 GGMM: byte-level vocab plus the ChatML
    control tokens, biased q/k/v, and no `lm_head.weight` when `tie` (the
    loader then ties the head to the embedding; the file says QWEN2TIE).
    `dtype` defaults to q8_0."""
    from chatllm_tpu_torch.ggmm.quants import GGMLType
    from chatllm_tpu_torch.ggmm.writer import GGMMWriter
    from chatllm_tpu_torch.models.model_types import ModelType
    from chatllm_tpu_torch.tokenizer.processor import TokenType, byte_level_encode

    writer_cls = writer_cls or GGMMWriter
    dtype = GGMLType.Q8_0 if dtype is None else GGMLType(int(dtype))
    pieces = [(byte_level_encode(bytes([b])), TokenType.NORMAL) for b in range(256)]
    pieces += [(s.encode(), TokenType.CONTROL)
               for s in ("<|endoftext|>", "<|im_start|>", "<|im_end|>")]
    pieces += [(f"<|extra_{i}|>".encode(), TokenType.NORMAL)
               for i in range(vocab_pad - len(pieces))]
    eot = 256
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = shape[-1] ** -0.5 if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    with open(path, "wb") as f:
        mtype = ModelType.QWEN2TIE if tie else ModelType.QWEN2
        wr = writer_cls(f, int(mtype), 1, meta={"model_name": "tiny-qwen2"})
        # BaseConfig + {num_key_value_heads, sliding_window} + rope_theta
        wr.write_config([int(dtype), vocab_pad, hidden, heads, layers, inter, max_len,
                         eot, eot, eot, -1, kv_heads, max_len], fmt="13i")
        f.write(struct.pack("<f", rope_theta))
        wr._patch_offset(12)
        wr.write_vocab_bpe([(p, int(t)) for p, t in pieces], [])
        _write_dense_tensors(wr, w, dtype, vocab_pad, hidden, heads, kv_heads, layers, inter,
                             qkv_bias=True, tie=tie)
    return path


# ---------------------------------------------------------------- timing
class Timer:
    """Per-launch CUDA-event timing with the L2 flushed before every
    launch (decode and prefill find their weights cold); median in ms.  The
    flush writes 1 GiB, about 0.4 ms of work on the card, behind which the
    host issues the wrapper's launches: the events then bracket the kernels'
    time on the card and not the host's time in the wrapper."""

    def __init__(self, device):
        self.flush = torch.empty(2 ** 30, dtype=torch.uint8, device=device)

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
    """A random quantized weight in one of the layouts K1 and K2 take:
    q4_k (superblock, packed, with m), q5_k (superblock, int8 0..31, with
    m), q6_k (superblock G 16, int8 -32..31, signed sc, no m), q2_k
    (superblock G 16, packed 0..3, with m), q8_0 (classic f16), q4_0
    (packed, zero point 8), q4_1 (packed, f16 b) and q8_f32b (classic f32
    scales with b)."""
    from chatllm_tpu_torch.models.synthetic import synth_linear
    from chatllm_tpu_torch.ops.qtensor import QuantLinear

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(dtype)

    def halfs(shape, scale):
        return (torch.rand(shape, generator=gen, device=dev) * scale + 1e-4).half()

    if fmt == "q4_k":
        return synth_linear(K, N, "q4k", gen=gen, zeros=False, device=dev)
    if fmt in ("q5_k", "q6_k", "q2_k"):
        G = 32 if fmt == "q5_k" else 16
        sb, ng = 256 // G, K // G
        d = halfs((ng // sb, N), 0.002)
        if fmt == "q5_k":
            return QuantLinear(q=ints(0, 32, (K, N), torch.int8), s=ints(0, 64, (ng, N), torch.int8),
                               b=ints(0, 64, (ng, N), torch.int8), group_size=G, d=d,
                               dm=halfs((ng // sb, N), 0.001), sb=sb)
        if fmt == "q6_k":
            return QuantLinear(q=ints(-32, 32, (K, N), torch.int8),
                               s=ints(-128, 128, (ng, N), torch.int8), group_size=G, d=d, sb=sb)
        q = ints(0, 4, (K // 2, N), torch.uint8) | (ints(0, 4, (K // 2, N), torch.uint8) << 4)
        return QuantLinear(q=q, s=ints(0, 16, (ng, N), torch.int8),
                           b=ints(0, 16, (ng, N), torch.int8), group_size=G, packed=True, d=d,
                           dm=halfs((ng // sb, N), 0.001), sb=sb)
    G = 32
    s = halfs((K // G, N), 0.01)
    if fmt == "q8_0":
        return QuantLinear(q=ints(-127, 128, (K, N), torch.int8), s=s)
    if fmt == "q8_f32b":
        b = -(torch.rand(K // G, N, generator=gen, device=dev) * 0.08)
        return QuantLinear(q=ints(-127, 128, (K, N), torch.int8), s=s.float(), b=b)
    q = ints(0, 256, (K // 2, N), torch.uint8)
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


def _check_matmul(res, name, kern, plain, x, lin, tol, tag, quiet=False) -> torch.Tensor:
    """Hold one quantized-matmul kernel against its plain version."""
    arrays, kw = lin_args(lin)
    y = kern(x, *arrays, **kw)
    ref = plain(x, *arrays, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(y, ref)
    K, N = lin.shape_in_out
    if not quiet:
        log(f"  {name:10s} {tag:5s} K={K:5d} N={N:6d} B={x.shape[0]:2d}  max_abs_err={err:.3e} "
            f"rel={rel:.2e}")
    if not (torch.isfinite(y).all() and rel <= tol):
        raise AssertionError(f"{name} {tag} {K}x{N} B={x.shape[0]}: rel err {rel} > {tol}")
    res[name]["cases"].append({"fmt": tag, "K": K, "N": N, "B": x.shape[0],
                               "max_abs_err": err, "rel": rel})
    return y


def _time_matmul(timer, kern, plain, x, lin, y, w_bf16, peak) -> dict:
    arrays, kw = lin_args(lin)
    K, N = lin.shape_in_out
    wbytes = nbytes(lin.q, lin.s, lin.b, lin.d, lin.dm, lin.bias)
    b_ms, b_by = bound(wbytes + nbytes(x, y), 2.0 * x.shape[0] * K * N, peak)
    r = {"K": K, "N": N, "B": x.shape[0],
         "ms": timer(lambda: kern(x, *arrays, **kw)),
         "plain_ms": timer(lambda: plain(x, *arrays, **kw), iters=5),
         "library_ms": timer(lambda: torch.matmul(x, w_bf16)),
         "bound_ms": b_ms, "bound_by": b_by}
    log(f"    timing {r}")
    return r


# Everything K1 and K2 take, at row counts either side of every tile edge of
# K2 (8-row mma tiles, instantiations for 8/16/32/64 rows) and at N that are
# not multiples of K2's column tiles (400: 128 columns; 4112: 256 columns
# above 16 rows); K 544 ends K2's last 128-deep tile part way (classic
# layouts only: a superblock needs K % 256 == 0).
COVER_FMTS = ("q4_k", "q5_k", "q6_k", "q2_k", "q8_0", "q4_0", "q4_1", "q8_f32b", "q8+b")
COVER_ROWS = (1, 2, 7, 8, 9, 16, 17, 31, 32, 33, 37, 63, 64)
COVER_SHAPES = ((512, 400), (544, 128), (512, 4112))


def coverage_cases(dev, gen, res) -> int:
    """K1 (one row, 1e-4 of the output scale) and K2 (every row count, 2e-2)
    against their plain versions on every layout, bf16 and f32 x; each
    kernel launched twice on the same inputs must give the same bits.
    Returns the number of kernel calls checked."""
    from chatllm_tpu_torch.ops.cuda.gemv_kernel import qgemv, qgemv_plain
    from chatllm_tpu_torch.ops.cuda.qmm_kernel import qmm, qmm_plain

    n = 0
    for fmt in COVER_FMTS:
        for K, N in COVER_SHAPES:
            if fmt in ("q4_k", "q5_k", "q6_k", "q2_k") and K % 256:
                continue
            lin = quant_weight("q8_0" if fmt == "q8+b" else fmt, K, N, gen, dev)
            if fmt == "q8+b":
                lin = replace(lin, bias=torch.randn(N, generator=gen, device=dev))
            for xdt in (torch.bfloat16, torch.float32):
                tag = f"{fmt}/{'bf16' if xdt == torch.bfloat16 else 'f32'}"
                for rows in COVER_ROWS:
                    x = torch.randn(rows, K, generator=gen, device=dev).to(xdt)
                    pairs = [("qmm", qmm, qmm_plain, 2e-2)]
                    if rows == 1:
                        pairs.append(("qgemv", qgemv, qgemv_plain, 1e-4))
                    for name, kern, plain, tol in pairs:
                        y = _check_matmul(res, name, kern, plain, x, lin, tol, tag, quiet=True)
                        arrays, kw = lin_args(lin)
                        again = kern(x, *arrays, **kw)
                        if not torch.equal(y, again):
                            raise AssertionError(f"{name} {tag} {K}x{N} B={rows}: two launches "
                                                 "differ")
                        n += 2
                # one-hot rows: each output is one dequantized weight plus its
                # affine term, so K2 must equal its plain version bit for bit
                # (its bf16 unpack, subtract and multiply round q * bf16(s_eff)
                # once, as the Pallas kernel's f32 product rounded to bf16)
                for rows in (8, 64):
                    x = torch.zeros(rows, K, device=dev)
                    x[torch.arange(rows, device=dev), torch.arange(rows, device=dev) * (K // rows)
                      + torch.arange(rows, device=dev) % 7] = 1.0
                    x = x.to(xdt)
                    arrays, kw = lin_args(lin)
                    y, ref = qmm(x, *arrays, **kw), qmm_plain(x, *arrays, **kw)
                    if not torch.equal(y, ref):
                        raise AssertionError(f"qmm {tag} {K}x{N} one-hot B={rows}: the dequantized "
                                             f"weights differ from the plain version's by "
                                             f"{(y - ref).abs().max().item()}")
                    n += 1
    log(f"  coverage: {n} K1/K2 launches on {len(COVER_FMTS)} layouts x bf16/f32 x rows "
        f"{COVER_ROWS} x (K, N) {COVER_SHAPES}: all within tolerance, every pair bit-identical, "
        f"K2 bit-equal to its plain version on one-hot rows")
    return n


def quantize_kv_case(dev, gen) -> dict:
    """`ops/attention.py::quantize_kv` on the card against the CPU on the same
    K/V rows (one 1000-token prompt of Llama-3-8B's 8 kv heads, f32 and
    bf16): int8 values and f32 scales must be bit-equal.  Also counts the
    scales that a division by the Python scalar 127.0 (a multiplication by
    its reciprocal on the card) would have moved."""
    from chatllm_tpu_torch.ops.attention import quantize_kv

    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.randn(1, 1000, 8, 128, generator=gen, device=dev) * 3).to(dt)
        q, sc = quantize_kv(x)
        qc, scc = quantize_kv(x.cpu())
        torch.cuda.synchronize()
        scalar = (x.float().abs().amax(dim=-1) / 127.0).cpu()
        moved = int((scalar != scc).sum())
        name = str(dt).split(".")[-1]
        log(f"  quantize_kv {name}: card == CPU values {torch.equal(q.cpu(), qc)}, scales "
            f"{torch.equal(sc.cpu(), scc)}; a division by the scalar 127.0 would move {moved} of "
            f"{scc.numel()} scales")
        if not (torch.equal(q.cpu(), qc) and torch.equal(sc.cpu(), scc)):
            raise AssertionError(f"quantize_kv {name}: the card differs from the CPU")
        out[name] = {"scales": scc.numel(), "moved_by_scalar_division": moved}
    return out


K5_ROWS = 8          # K5 is timed at the rows of the bench's batched section
SHAPES_QWEN = {"q_o": (896, 896), "k_v": (896, 128), "gate_up": (896, 4864),
               "down": (4864, 896)}
QWEN_LAYERS = 24


def kernels_phase(dev, timer) -> dict:
    from chatllm_tpu_torch.ops.cuda.gemv_kernel import qgemv, qgemv_plain
    from chatllm_tpu_torch.ops.cuda.qmm_decode import qmm_decode, qmm_decode_plain
    from chatllm_tpu_torch.ops.cuda.qmm_kernel import qmm, qmm_plain
    from chatllm_tpu_torch.ops.qmm import dequant_weight

    gen = torch.Generator(device=dev).manual_seed(1)
    res = {k: {"cases": [], "shapes": {}, "qwen_shapes": {}}
           for k in ("qgemv", "qmm", "qmm_decode")}
    res["qmm"]["shapes_b8"] = {}

    def run(lin, fmt, sname, timed, shapes_key):
        K, N = lin.shape_in_out
        w_bf16 = dequant_weight(lin, torch.bfloat16) if timed else None
        x = torch.randn(1, K, generator=gen, device=dev).to(torch.bfloat16)
        y = _check_matmul(res, "qgemv", qgemv, qgemv_plain, x, lin, 1e-4, fmt)
        if timed:
            res["qgemv"][shapes_key][sname] = _time_matmul(
                timer, qgemv, qgemv_plain, x, lin, y, w_bf16, F32_FLOPS)
        for B in (2, 8, 32, 37, 64):
            xb = torch.randn(B, K, generator=gen, device=dev).to(torch.bfloat16)
            yb = _check_matmul(res, "qmm", qmm, qmm_plain, xb, lin, 2e-2, fmt)
            if timed and B == 64 and sname != "lm_head":
                res["qmm"][shapes_key][sname] = _time_matmul(
                    timer, qmm, qmm_plain, xb, lin, yb, w_bf16, BF16_TC_FLOPS)
            if timed and B == K5_ROWS and shapes_key == "shapes":
                res["qmm"]["shapes_b8"][sname] = _time_matmul(
                    timer, qmm, qmm_plain, xb, lin, yb, w_bf16, BF16_TC_FLOPS)
            yb = _check_matmul(res, "qmm_decode", qmm_decode, qmm_decode_plain, xb, lin,
                               2e-2, fmt)
            if timed and B == K5_ROWS:
                res["qmm_decode"][shapes_key][sname] = _time_matmul(
                    timer, qmm_decode, qmm_decode_plain, xb, lin, yb, w_bf16, BF16_TC_FLOPS)

    for fmt in ("q4_k", "q8_0", "q4_0", "q4_1"):
        for sname, (K, N) in SHAPES_8B.items():
            run(quant_weight(fmt, K, N, gen, dev), fmt, sname, fmt == "q4_k", "shapes")
    # Qwen2.5-0.5B: q8_0 (unpacked int8) with a bias, K = 896 and 4864
    for sname, (K, N) in SHAPES_QWEN.items():
        lin = replace(quant_weight("q8_0", K, N, gen, dev),
                      bias=torch.randn(N, generator=gen, device=dev))
        run(lin, "q8+b", sname, True, "qwen_shapes")
    coverage_cases(dev, gen, res)
    res["quantize_kv"] = quantize_kv_case(dev, gen)
    res["flash_attention"] = flash_cases(dev, timer, gen)
    res["flash_decode"] = decode_cases(dev, timer, gen)
    res["bw_probe"] = probe_case(dev, timer, gen)
    res.update(gemv_probe_cases(dev, timer, gen))
    res.update(gemv_model_cases(dev, timer, gen))
    res["unpack_gemv"] = unpack_cases(dev, timer, gen)
    res["qmm_dma"] = dma_case(dev, timer, gen)
    res["flash_decode_int8"] = decode_int8_cases(dev, timer, gen)
    res["flash_decode_e7"] = e7_cases(dev, timer, gen)
    res.update(e6_cases(dev, timer, gen))
    return res


def probe_case(dev, timer, gen) -> dict:
    """K6's sum on a seeded random 256 MB buffer against its plain version
    (exact), and the time of one pass."""
    from chatllm_tpu_torch.ops.cuda.bw_probe import read_sum, read_sum_plain

    q = torch.randint(0, 256, (256 << 20,), generator=gen, device=dev, dtype=torch.uint8)
    c = torch.tensor([1.5], device=dev)
    got, want = read_sum(q, c), read_sum_plain(q, c)
    torch.cuda.synchronize()
    err = (got - want).abs().item()
    log(f"  bw_probe 256 MiB: sum {got.item():.9g}, plain {want.item():.9g}, "
        f"max_abs_err={err:.1e}")
    if not torch.equal(got, want):
        raise AssertionError(f"bw_probe: {got.item()} != {want.item()}")
    b_ms, b_by = bound(nbytes(q, c, got), float(q.numel()), F32_FLOPS)
    r = {"bytes": q.numel(),
         "ms": timer(lambda: read_sum(q, c)),
         "plain_ms": timer(lambda: read_sum_plain(q, c), iters=5),
         "library_ms": timer(lambda: torch.sum(q, dtype=torch.int64)),
         "bound_ms": b_ms, "bound_by": b_by}
    r["gb_s"] = q.numel() / r["ms"] / 1e6
    log(f"    timing {r}")
    return {"cases": [{"bytes": q.numel(), "max_abs_err": err}], "shapes": {"pass_256mb": r}}


def gemv_probe_cases(dev, timer, gen) -> dict:
    """E2's two kernels against their plain versions at E2's 4096 x 16384
    and at E1's 4096 x 14336 (E1's `stream_max` and `vpu_gemv` run on them):
    stream_once exact, vpu_once 1e-5 of the output scale (f32 sums in
    another order)."""
    from chatllm_tpu_torch.experiments import gemv_probe as e1
    from chatllm_tpu_torch.experiments import gemv_probe2 as e2

    out = {name: {"cases": [], "shapes": {}} for name in ("gemv_stream", "gemv_vpu")}
    for K, N in ((e2.K, e2.N), (e1.K, e1.N)):
        key = f"{K}x{N}"
        wq, ws = e2.weights(K, N, dev)
        x = torch.randn(K, 1, generator=gen, device=dev)
        w_bf16 = (wq.float().reshape(K // e2.GROUP, e2.GROUP, N) * ws[:, None, :]).reshape(
            K, N).to(torch.bfloat16)
        xb = x.reshape(1, K).to(torch.bfloat16)
        m, mref = e2.stream_once(wq), e2.stream_once_plain(wq)
        y, yref = e2.vpu_once(x, wq, ws), e2.vpu_once_plain(x, wq, ws)
        torch.cuda.synchronize()
        s_err = (m - mref).abs().max().item()
        v_err, v_rel = rel_err(y, yref)
        log(f"  gemv_stream K={K} N={N}  max_abs_err={s_err}")
        log(f"  gemv_vpu    K={K} N={N}  max_abs_err={v_err:.3e} rel={v_rel:.2e}")
        if not torch.equal(m, mref):
            raise AssertionError(f"gemv_stream differs from its plain version by {s_err}")
        if not (torch.isfinite(y).all() and v_rel <= 1e-5):
            raise AssertionError(f"gemv_vpu: rel err {v_rel} > 1e-5")
        b_ms, b_by = bound(nbytes(wq, m), float(K * N), F32_FLOPS)
        r = {"K": K, "N": N,
             "ms": timer(lambda: e2.stream_once(wq)),
             "plain_ms": timer(lambda: e2.stream_once_plain(wq), iters=5),
             "library_ms": timer(lambda: torch.amax(wq.view(K // 8, 8, N), dim=0)),
             "bound_ms": b_ms, "bound_by": b_by}
        log(f"    timing stream {r}")
        out["gemv_stream"]["cases"].append({"K": K, "N": N, "max_abs_err": float(s_err)})
        out["gemv_stream"]["shapes"][key] = r
        b_ms, b_by = bound(nbytes(wq, ws, x, y), 2.0 * K * N, F32_FLOPS)
        r = {"K": K, "N": N,
             "ms": timer(lambda: e2.vpu_once(x, wq, ws)),
             "plain_ms": timer(lambda: e2.vpu_once_plain(x, wq, ws), iters=5),
             # a yardstick over other inputs: the weight dequantized to bf16 beforehand
             "library_ms": timer(lambda: torch.matmul(xb, w_bf16)),
             "bound_ms": b_ms, "bound_by": b_by}
        log(f"    timing vpu {r}")
        out["gemv_vpu"]["cases"].append({"K": K, "N": N, "max_abs_err": v_err, "rel": v_rel})
        out["gemv_vpu"]["shapes"][key] = r
        del wq, ws, w_bf16
    return out


def gemv_model_cases(dev, timer, gen) -> dict:
    """E3's two kernels at the five Llama-3-8B projection shapes (q4 packed,
    f16 scales, tile_k 2048), both exact: stream_read's value and digest,
    and qgemv_bf16, which rounds to bf16 in its plain version's order (an
    H100 gives equal bits at every shape)."""
    from chatllm_tpu_torch.experiments import gemv_model_bench as e3
    from chatllm_tpu_torch.ops.qmm import dequant_arrays

    out = {name: {"cases": [], "shapes": {}} for name in ("stream_read", "qgemv_bf16")}
    for sname, (K, N) in SHAPES_8B.items():
        q = torch.randint(0, 256, (K // 2, N), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
        s = (torch.rand(K // 32, N, generator=gen, device=dev) * 0.01 + 1e-3).half()
        x = torch.randn(1, K, generator=gen, device=dev)
        (y, dg), (yr, dgr) = e3.stream_read(x, q, s), e3.stream_read_plain(x, q, s)
        b, br = e3.qgemv_bf16(x, q, s), e3.qgemv_bf16_plain(x, q, s)
        torch.cuda.synchronize()
        s_err = (y - yr).abs().max().item()
        b_err, b_rel = rel_err(b, br)
        log(f"  stream_read K={K:5d} N={N:6d}  max_abs_err={s_err} digest_equal="
            f"{torch.equal(dg, dgr)}")
        log(f"  qgemv_bf16  K={K:5d} N={N:6d}  max_abs_err={b_err:.3e} rel={b_rel:.2e}")
        if not (torch.equal(y, yr) and torch.equal(dg, dgr)):
            raise AssertionError(f"stream_read {K}x{N} differs from its plain version")
        if not (torch.isfinite(b).all() and torch.equal(b, br)):
            raise AssertionError(f"qgemv_bf16 {K}x{N} differs from its plain version: rel "
                                 f"err {b_rel}")
        out["stream_read"]["cases"].append({"K": K, "N": N, "max_abs_err": s_err})
        out["qgemv_bf16"]["cases"].append({"K": K, "N": N, "max_abs_err": b_err, "rel": b_rel})
        b_ms, b_by = bound(nbytes(q, s, x, y, dg), K * N / 8.0, F32_FLOPS)
        r = {"K": K, "N": N,
             "ms": timer(lambda: e3.stream_read(x, q, s)),
             "plain_ms": timer(lambda: e3.stream_read_plain(x, q, s), iters=5),
             "library_ms": timer(lambda: torch.sum(q, dtype=torch.int64)),
             "bound_ms": b_ms, "bound_by": b_by}
        log(f"    timing stream_read {r}")
        out["stream_read"]["shapes"][sname] = r
        w_bf16 = dequant_arrays(q, s, None, group=32, packed=True, zero_point=0,
                                dtype=torch.bfloat16)
        xb = x.to(torch.bfloat16)
        b_ms, b_by = bound(nbytes(q, s, x, b), 2.0 * K * N, F32_FLOPS)
        r = {"K": K, "N": N,
             "ms": timer(lambda: e3.qgemv_bf16(x, q, s)),
             "plain_ms": timer(lambda: e3.qgemv_bf16_plain(x, q, s), iters=5),
             # a yardstick over other inputs: the weight dequantized to bf16 beforehand
             "library_ms": timer(lambda: torch.matmul(xb, w_bf16)),
             "bound_ms": b_ms, "bound_by": b_by}
        log(f"    timing qgemv_bf16 {r}")
        out["qgemv_bf16"]["shapes"][sname] = r
        del q, s, w_bf16
    return out


def unpack_cases(dev, timer, gen) -> dict:
    """E4's kernel in its four modes at 4096 x 14336 on a random q4_k
    weight: 1e-5 of the output scale against its plain version, 1e-4 against
    K1 (the sum of its 8 rows), and each mode's own check (2048 x 256)."""
    from chatllm_tpu_torch.experiments import gemv_unpack as e4
    from chatllm_tpu_torch.models.synthetic import synth_linear
    from chatllm_tpu_torch.ops.cuda.gemv_kernel import qgemv
    from chatllm_tpu_torch.ops.qmm import dequant_weight

    K, N = e4.K, e4.N
    lin = synth_linear(K, N, "q4k", gen=gen, zeros=False, device=dev)
    arrays = (lin.q, lin.s, lin.b, lin.d, lin.dm)
    x = torch.randn(K, generator=gen, device=dev)
    k1 = qgemv(x[None], lin.q, lin.s, lin.b, None, group=32, packed=True, zero_point=0,
               d=lin.d, dm=lin.dm, sb=8)
    w_bf16 = dequant_weight(lin, torch.bfloat16)
    xb = x[None].to(torch.bfloat16)
    res = {"cases": [], "shapes": {}}
    for mode in e4.MODES:
        out, ref = e4.unpack_gemv(x, *arrays, mode=mode), e4.unpack_gemv_plain(x, *arrays,
                                                                               mode=mode)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        _, rel_k1 = rel_err(out.sum(dim=0, keepdim=True), k1)
        chk = e4.check(mode, device=dev)
        log(f"  unpack_gemv {mode} K={K} N={N}  max_abs_err={err:.3e} rel={rel:.2e} "
            f"vs K1 rel={rel_k1:.2e}; check {chk:.2e}")
        if not (torch.isfinite(out).all() and rel <= 1e-5 and rel_k1 <= 1e-4
                and chk < e4.CHECK_TOL):
            raise AssertionError(f"unpack_gemv {mode}: rel {rel} (limit 1e-5), against K1 "
                                 f"{rel_k1} (limit 1e-4), check {chk} (limit 1e-4)")
        res["cases"].append({"mode": mode, "K": K, "N": N, "max_abs_err": err, "rel": rel,
                             "rel_vs_k1": rel_k1, "check": chk})
        b_ms, b_by = bound(nbytes(*arrays, x, out), 8.0 * K * N, F32_FLOPS)
        r = {"K": K, "N": N,
             "ms": timer(lambda: e4.unpack_gemv(x, *arrays, mode=mode)),
             "plain_ms": timer(lambda: e4.unpack_gemv_plain(x, *arrays, mode=mode), iters=5),
             # a yardstick over other inputs: the weight dequantized to bf16 beforehand
             "library_ms": timer(lambda: torch.matmul(xb, w_bf16)),
             "bound_ms": b_ms, "bound_by": b_by}
        log(f"    timing {mode} {r}")
        res["shapes"][mode] = r
    return res


def dma_case(dev, timer, gen) -> dict:
    """E5's copy-only pass over a random uint8 [2048, 14336] (K2's q4
    weight at 4096 x 14336) in 1024 x 512 tiles, exact against its plain
    version."""
    from chatllm_tpu_torch.experiments import qmm_m32 as e5

    q = torch.randint(0, 256, (e5.K // 2, e5.N), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.uint8)
    c = torch.tensor([0.25], device=dev)
    got, want = e5.dma_sums(q, c), e5.dma_sums_plain(q, c)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    log(f"  qmm_dma K={e5.K} N={e5.N} tiles {e5.DMA_TILE_K}x{e5.DMA_TILE_N}: "
        f"max_abs_err={err}, last tile {got[-1, -1].item():.9g}")
    if not torch.equal(got, want):
        raise AssertionError(f"qmm_dma differs from its plain version by {err}")
    b_ms, b_by = bound(nbytes(q, c, got), float(q.numel()), F32_FLOPS)
    r = {"bytes": q.numel(),
         "ms": timer(lambda: e5.dma_sums(q, c)),
         "plain_ms": timer(lambda: e5.dma_sums_plain(q, c), iters=5),
         "library_ms": timer(lambda: torch.sum(q, dtype=torch.int64)),
         "bound_ms": b_ms, "bound_by": b_by}
    log(f"    timing {r}")
    return {"cases": [{"bytes": q.numel(), "max_abs_err": err}], "shapes": {"4096x14336": r}}


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


# The first decode step's logits with K4's int8 dots against the bf16-dot
# run's: 0.03 of the logit scale, the JAX package's own bound on the
# int8-dot attention output (0.03 of its row max,
# tests/test_flash_decode.py::test_flash_decode_batched_int8_dots) carried
# to the logits row, and the same argmax (PERF.md section 6).
INT8_LOGIT_TOL = 0.03

# K4's int8 dots against their plain version: both quantize q and p * v_scale
# to int8 and sum integer products exactly, so they differ only where float
# rounding (exp, the division by psc) moves a quantized q or p by one step.
# One step of pq in key j's block moves an output by psc * |v8_j| / l <=
# max_i(P_i * v_scale_i) * max_j |v8_j| / 127, P the row's probabilities
# (`int8_step`).  The limit is DECODE_INT8_STEPS such steps per element,
# beside the output's rounding to q's dtype: both round to bf16, and a
# rounding on either side of a boundary differs by one bf16 ulp, at most
# 2^-7 of the larger value.
DECODE_INT8_STEPS = 2.0


def int8_step(q, k, v, n_past, n_tokens: int, *, k_scale, v_scale, sinks=None,
              **kw) -> torch.Tensor:
    """One quantization step of pq as an output difference, per row: [B, T, Hq, 1]."""
    from chatllm_tpu_torch.ops.cuda.flash_decode import decode_scores

    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    s = decode_scores(q, k, n_past, n_tokens, scale=kw["scale"],
                      sliding_window=kw.get("sliding_window", 0),
                      logit_softcap=kw.get("logit_softcap", 0.0), k_scale=k_scale,
                      qk_dtype="int8")
    m = s.amax(dim=-1, keepdim=True)
    if sinks is not None:
        sk = sinks.float().reshape(Hkv, Hq // Hkv)[None, :, :, None, None]
        m = torch.maximum(m, sk)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        den = den + torch.exp(sk - m)
    pv = (p / den * v_scale.float().transpose(1, 2)[:, :, None, None, :]).amax(dim=-1)
    vmax = v.float().abs().amax(dim=(1, 3))[:, :, None, None]                # [B, Hkv, 1, 1]
    return (pv * vmax / 127.0).permute(0, 3, 1, 2).reshape(B, T, Hq, 1)


def flash_decode_int8_errors(o, q, k, v, n_past, n_tokens: int, **kw) -> tuple[float, float]:
    """(max abs error, max error in steps as in DECODE_INT8_STEPS) of a K4
    int8-dot output against its plain version on the same inputs."""
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode_plain

    ref = flash_decode_plain(q, k, v, n_past, n_tokens, qk_dtype="int8", **kw).float()
    step = int8_step(q, k, v, n_past, n_tokens, **kw)
    diff = (o.float() - ref).abs()
    if o.dtype == torch.bfloat16:
        diff = (diff - 2.0 ** -7 * torch.maximum(o.float().abs(), ref.abs())).clamp_(min=0.0)
    return (o.float() - ref).abs().max().item(), (diff / (step + 1e-30)).max().item()


def flash_cases(dev, timer, gen) -> dict:
    from chatllm_tpu_torch.ops.cuda.flash import flash_attention, flash_attention_plain

    L3, QW = (32, 8, 128), (14, 2, 64)     # Llama-3-8B; Qwen2.5-0.5B (7 heads per kv head)
    cases = [  # (heads, T, S, n_past, n_tokens, window, softcap, timed as)
        (L3, 128, 1024, 0, 128, 0, 0.0, None),
        (L3, 512, 8192, 1000, 512, 0, 0.0, None),
        (L3, 128, 1024, 0, 100, 0, 0.0, None),         # padded prefill chunk
        (L3, 512, 8192, 1000, 512, 256, 0.0, None),    # sliding window
        (L3, 128, 1024, 64, 128, 0, 30.0, None),       # softcap
        (L3, 1024, 8192, 0, 1000, 0, 0.0, "prefill_1000"),   # the 1000-token chunk
        (QW, 128, 1024, 0, 100, 0, 0.0, None),
        (QW, 512, 8192, 1000, 512, 0, 0.0, None),
        (QW, 1024, 8192, 0, 1000, 0, 0.0, "prefill_1000_qwen"),
    ]
    out = {"cases": [], "shapes": {}}
    # --cache_dtype bf16 / f32, and --compute_dtype f32 over a bf16 cache
    for qdt, dtype, tag in ((torch.bfloat16, torch.bfloat16, ""),
                            (torch.float32, torch.float32, "_f32"),
                            (torch.float32, torch.bfloat16, "_f32q")):
        for (Hq, Hkv, D), T, S, n_past, n_tok, win, cap, timed in cases:
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
            log(f"  flash {name:17s} Hq={Hq} Hkv={Hkv} D={D} T={T:4d} S={S:5d} n_past={n_past:4d} "
                f"n_tokens={n_tok:4d} window={win} softcap={cap}  max_abs_err={err:.3e} "
                f"scaled={scaled:.2e}")
            lim = FLASH_SCALED_TOL[dtype]
            if not (o.dtype == qdt and torch.isfinite(o).all() and err <= FLASH_ATOL
                    and scaled <= lim):
                case = (Hq, Hkv, D, T, S, n_past, n_tok, win, cap)
                raise AssertionError(f"flash {name} case {case}: "
                                     f"{o.dtype}, err {err} (limit {FLASH_ATOL}), scaled "
                                     f"{scaled} (limit {lim})")
            out["cases"].append({"dtype": str(dtype), "q_dtype": str(qdt), "Hq": Hq, "Hkv": Hkv,
                                 "D": D, "T": T, "S": S,
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
    # Qwen2.5-0.5B: head dim 64, 7 query heads per kv head
    (1, 1, 14, 2, 64, [1000], "int8", "bfloat16", {}, "decode_1000_qwen"),
    (2, 1, 14, 2, 64, [10, 8000], "int8", "bfloat16", {}, None),
    (1, 2, 14, 2, 64, [4000], "int8", "float32", {}, None),
    # CHATLLM_TPU_FLASH_DECODE=1 sends T <= 8 over any cache: up to 64 rows
    (1, 8, 14, 2, 64, [1000], "bfloat16", "float32", {}, None),   # Qwen, G*T = 56
    (2, 8, 32, 8, 128, [500, 3000], "bfloat16", "bfloat16", {}, None),
    (1, 8, 32, 4, 128, [7000], "int8", "bfloat16", {}, None),     # G*T = 64
]

# K4's int8 dots at Llama-3-8B's q8 shapes, S 8192, block_k 512 (the route's)
# (B, T, Hq, Hkv, D, n_past, extra, timed as)
DECODE_INT8_CASES = [
    (1, 1, 32, 8, 128, [1000], {}, "decode_1000"),
    (1, 1, 32, 8, 128, [8000], {}, None),
    (4, 1, 32, 8, 128, [10, 1000, 4095, 8000], {}, None),
    (2, 2, 32, 8, 128, [3000, 6000], {}, None),
    (1, 1, 32, 8, 128, [5000], {"sliding_window": 256, "logit_softcap": 30.0}, None),
    (1, 1, 32, 8, 128, [3000], {"sinks": True}, None),
    (1, 1, 32, 8, 128, [1000], {"q": torch.float32}, None),
    (1, 1, 32, 8, 128, [2500], {"block_k": 256}, None),
    (2, 8, 32, 4, 128, [100, 7000], {}, None),                     # G*T = 64
    (1, 1, 8, 1, 128, [2000], {}, None),                           # one kv head
]


def decode_cases(dev, timer, gen) -> dict:
    """K4 at Llama-3-8B's attention shapes over an 8192-slot cache."""
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_plain

    out = {"cases": [], "shapes": {}}
    for B, T, Hq, Hkv, D, n_past, cache, dots, extra, timed in DECODE_CASES:
        S = DECODE_S
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
            out["shapes"][timed] = {
                "B": B, "T": T, "S": S, "n_past": n_past, "live_keys": live,
                "ms": timer(lambda: flash_decode(q, k, v, npv, T, **kw)),
                "plain_ms": timer(lambda: flash_decode_plain(q, k, v, npv, T, **kw), iters=5),
                "library_ms": timer(_sdpa_over_dequantized(q, k, v, npv, T, kw["scale"],
                                                           kw["k_scale"], kw["v_scale"])),
                "bound_ms": b_ms, "bound_by": b_by}
            log(f"    timing {out['shapes'][timed]}")
        del q, k, v, o
    return out


def _sdpa_over_dequantized(q, k, v, npv, T: int, scale: float, k_scale=None, v_scale=None,
                           head_major: bool = False):
    """The library yardstick of K4: SDPA over the cache dequantized to bf16
    beforehand, causal mask by position (returns a zero-argument call)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, _, Hq, _ = q.shape
    if k_scale is not None:
        k, v = ((t.float() * sc[..., None]).to(torch.bfloat16)
                for t, sc in ((k, k_scale), (v, v_scale)))
    # [B, Hkv, S, D]
    kt, vt = (t if head_major else t.transpose(1, 2) for t in (k, v))
    G = Hq // kt.shape[1]
    kt, vt = kt.repeat_interleave(G, dim=1), vt.repeat_interleave(G, dim=1)
    qt = q.transpose(1, 2).to(kt.dtype)
    S = kt.shape[2]
    qp = npv[:, None, None, None] + torch.arange(T, device=q.device)[None, None, :, None]
    mask = torch.arange(S, device=q.device)[None, None, None, :] <= qp
    return lambda: sdpa(qt, kt, vt, attn_mask=mask, scale=scale)


def decode_int8_cases(dev, timer, gen) -> dict:
    """K4's int8 dots against their plain version (DECODE_INT8_STEPS) at
    Llama-3-8B's q8 shapes over an 8192-slot cache."""
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_plain

    out = {"cases": [], "shapes": {}}
    for B, T, Hq, Hkv, D, n_past, extra, timed in DECODE_INT8_CASES:
        S = DECODE_S
        q = torch.randn(B, T, Hq, D, generator=gen, device=dev).to(extra.get("q", torch.bfloat16))
        (k, ks), (v, vs) = (quantize_kv(torch.randn(B, S, Hkv, D, generator=gen, device=dev))
                            for _ in range(2))
        kw = dict(scale=D ** -0.5, k_scale=ks, v_scale=vs, block_k=extra.get("block_k", 512),
                  sliding_window=extra.get("sliding_window", 0),
                  logit_softcap=extra.get("logit_softcap", 0.0))
        if extra.get("sinks"):
            kw["sinks"] = torch.randn(Hq, generator=gen, device=dev)
        npv = torch.tensor(n_past, dtype=torch.int64, device=dev)
        o = flash_decode(q, k, v, npv, T, qk_dtype="int8", **kw)
        err, steps = flash_decode_int8_errors(o, q, k, v, npv, T, **kw)
        name = f"B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} n_past={n_past} q {q.dtype} {extra}"
        log(f"  flash_decode int8 {name}  max_abs_err={err:.3e} steps={steps:.3f}")
        if not (o.dtype == q.dtype and torch.isfinite(o).all() and steps <= DECODE_INT8_STEPS):
            raise AssertionError(f"flash_decode int8 {name}: {steps} steps (limit "
                                 f"{DECODE_INT8_STEPS}), err {err}")
        out["cases"].append({"B": B, "T": T, "Hq": Hq, "Hkv": Hkv, "D": D, "n_past": n_past,
                             "extra": str(extra), "max_abs_err": err, "steps": steps})
        if timed:
            live = [min(n + T, S) for n in n_past]
            b_ms, b_by = bound(nbytes(q, o) + sum(live) * Hkv * (2 * D + 8),
                               4.0 * D * Hq * T * sum(live), BF16_TC_FLOPS)
            out["shapes"][timed] = {
                "B": B, "T": T, "S": S, "n_past": n_past, "live_keys": live,
                "ms": timer(lambda: flash_decode(q, k, v, npv, T, qk_dtype="int8", **kw)),
                "plain_ms": timer(lambda: flash_decode_plain(q, k, v, npv, T, qk_dtype="int8",
                                                             **kw), iters=5),
                "library_ms": timer(_sdpa_over_dequantized(q, k, v, npv, T, kw["scale"], ks, vs)),
                "bound_ms": b_ms, "bound_by": b_by}
            log(f"    timing {out['shapes'][timed]}")
        del q, k, v, o
    return out


# E7's attention on K4: B 32, Llama-3-8B's heads, a head-major [B, Hkv, S, D]
# cache of 1024 slots read as a permuted view, f32 dots, an f32 query
E7_CASES = [(47, "int8", "e7_step_q8"), (47, "bfloat16", "e7_step_bf16"), (0, "int8", None),
            (700, "int8", None), (511, "bfloat16", None)]


def e7_cases(dev, timer, gen) -> dict:
    """K4 under experiments/bhsd_decode.py's call site, against its plain
    version on the same views (DECODE_SCALED_TOL, f32)."""
    from chatllm_tpu_torch.experiments import bhsd_decode as e7
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode_plain

    B, T, Hq, Hkv, D, S = e7.B, 1, 32, 8, 128, e7.CTX
    out = {"cases": [], "shapes": {}}
    for n_past, cache, timed in E7_CASES:
        q = torch.randn(B, T, Hq, D, generator=gen, device=dev)
        k, v = (torch.randn(B, Hkv, S, D, generator=gen, device=dev) for _ in range(2))
        kw = {}
        if cache == "int8":
            (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_kv(k), quantize_kv(v)
        else:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        o = e7.pallas_decode_bhsd(q, k, v, n_past, scale=D ** -0.5, **kw)
        views = dict(k_scale=kw["k_scale"].permute(0, 2, 1),
                     v_scale=kw["v_scale"].permute(0, 2, 1)) if kw else {}
        kv, vv = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        npv = torch.full((B,), n_past, dtype=torch.int64, device=dev)
        err, scaled = flash_decode_errors(o, q, kv, vv, npv, T, scale=D ** -0.5,
                                          qk_dtype="float32", **views)
        log(f"  flash_decode (E7, head-major) B={B} n_past={n_past} {cache}  "
            f"max_abs_err={err:.3e} scaled={scaled:.2e}")
        lim = DECODE_SCALED_TOL["float32"]
        if not (torch.isfinite(o).all() and err <= DECODE_ATOL and scaled <= lim):
            raise AssertionError(f"flash_decode E7 n_past={n_past} {cache}: err {err}, "
                                 f"scaled {scaled} (limit {lim})")
        out["cases"].append({"B": B, "n_past": n_past, "cache": cache, "max_abs_err": err,
                             "scaled_err": scaled})
        if timed:
            live = n_past + T
            per_key = Hkv * (2 * D * k.element_size() + (8 if cache == "int8" else 0))
            b_ms, b_by = bound(nbytes(q, o) + B * live * per_key, 4.0 * D * Hq * T * live * B,
                               F32_FLOPS)
            out["shapes"][timed] = {
                "B": B, "S": S, "n_past": n_past, "cache": cache,
                "ms": timer(lambda: e7.pallas_decode_bhsd(q, k, v, n_past, scale=D ** -0.5,
                                                          **kw)),
                "plain_ms": timer(lambda: flash_decode_plain(q, kv, vv, n_past, T,
                                                             scale=D ** -0.5,
                                                             qk_dtype="float32", **views),
                                  iters=5),
                "library_ms": timer(_sdpa_over_dequantized(
                    q, k, v, npv, T, D ** -0.5, kw.get("k_scale"), kw.get("v_scale"),
                    head_major=True)),
                "bound_ms": b_ms, "bound_by": b_by}
            log(f"    timing {out['shapes'][timed]}")
        del q, k, v, o
    return out


E6_TOL = 1e-5       # of the output scale: the same bf16 roundings, f32 sums in another order


def e6_cases(dev, timer, gen) -> dict:
    """E6's two kernels at M 32, K 4096, N 14336 on a random q4_k weight:
    each template-(a) variant and each diagnostic mode against its plain
    version (E6_TOL), timed (the weight fits the 50 MB L2: the timer
    flushes it before every launch)."""
    from chatllm_tpu_torch.experiments import qmm_unpack_variants as e6
    from chatllm_tpu_torch.models.synthetic import synth_linear
    from chatllm_tpu_torch.ops.qmm import dequant_weight

    lin = synth_linear(e6.K, e6.N, "q4k", gen=gen, zeros=False, device=dev)
    arrays = (lin.q, lin.s, lin.b, lin.d, lin.dm)
    x = torch.randn(e6.M, e6.K, generator=gen, device=dev)
    xs = e6.group_sums(x)
    xb, w_bf16 = x.to(torch.bfloat16), dequant_weight(lin, torch.bfloat16)
    out = {name: {"cases": [], "shapes": {}} for name in ("qmm_unpack", "qmm_unpack_diag")}
    runs = [("qmm_unpack", name, dict(unpack=u, biasdot=b)) for name, u, b in e6.VARIANTS]
    runs += [("qmm_unpack_diag", f"diag_{m}", dict(mode=m)) for m in e6.DIAG_MODES]
    for kernel, name, kw in runs:
        if kernel == "qmm_unpack":
            def fn(kw=kw):
                return e6.qmm_unpack(x, xs, *arrays, **kw)

            def plain(kw=kw):
                return e6.qmm_unpack_plain(x, xs, *arrays, **kw)
        else:
            def fn(kw=kw):
                return e6.qmm_unpack_diag(x, *arrays, **kw)

            def plain(kw=kw):
                return e6.qmm_unpack_diag_plain(x, *arrays, **kw)
        y, ref = fn(), plain()
        torch.cuda.synchronize()
        err, rel = rel_err(y, ref)
        log(f"  {kernel} {name:16s} M={e6.M} K={e6.K} N={e6.N}  max_abs_err={err:.3e} "
            f"rel={rel:.2e}")
        if not (torch.isfinite(y).all() and rel <= E6_TOL):
            raise AssertionError(f"{kernel} {name}: rel err {rel} > {E6_TOL}")
        out[kernel]["cases"].append({"variant": name, "max_abs_err": err, "rel": rel})
        b_ms, b_by = bound(nbytes(*arrays, x, y) + (nbytes(xs) if kw.get("biasdot") else 0),
                           2.0 * e6.M * e6.K * e6.N, BF16_TC_FLOPS)
        r = {"M": e6.M, "K": e6.K, "N": e6.N, "ms": timer(fn), "plain_ms": timer(plain, iters=5),
             # a yardstick over other inputs: the weight dequantized to bf16 beforehand
             "library_ms": timer(lambda: torch.matmul(xb, w_bf16)),
             "bound_ms": b_ms, "bound_by": b_by}
        log(f"    timing {name} {r}")
        out[kernel]["shapes"][name] = r
    return out


# --------------------------------------------------------- llama3_8b phase
def chat_phase(dev, cfg, params) -> dict:
    """The chat path at full width (Llama-3-8B, and Qwen2.5-0.5B from
    qwen2_phase): bf16 cache (K1-K3), then a q8 cache (K4 on every decode
    step), each path's launches counted from 0."""
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
    head = {"lm_head": params["lm_head"].to(device)} if "lm_head" in params else {}
    return {"embed": params["embed"].to(device),
            "final_norm": {"w": params["final_norm"]["w"].to(device)},
            **head,
            "layers": tuple({"attn_norm": {"w": L["attn_norm"]["w"].to(device)},
                             "ffn_norm": {"w": L["ffn_norm"]["w"].to(device)},
                             "attn": {n: lin.to(device) for n, lin in L["attn"].items()},
                             "mlp": {n: lin.to(device) for n, lin in L["mlp"].items()}}
                            for L in params["layers"][:n_layers])}


def _compare_logits(name: str, g, c, tol: float = 1e-3) -> dict:
    """Card logits g against the CPU's c: within `tol` of the logit scale,
    and the same argmax."""
    g, c = g.float().cpu(), c.float()
    if g.shape != c.shape or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: logits shape {tuple(g.shape)} or not finite")
    err, rel = rel_err(g, c)
    r = {"max_abs_err": err, "rel_to_logit_scale": rel,
         "argmax_equal": bool(torch.equal(g.argmax(-1), c.argmax(-1))),
         "logit_scale": c.abs().max().item()}
    log(f"  {name}: {r}")
    if rel > tol or not r["argmax_equal"]:
        raise AssertionError(f"{name}: logits differ from the CPU run: rel {rel} > {tol}, "
                             "or an argmax differs")
    return r


def two_layer_phase(dev, cfg, params, tol: float = 1e-3) -> dict:
    """2-layer cuts at full width, the card (kernels) against the CPU (plain
    versions): a 40-token prefill over a bf16 cache, and one batched decode
    step of 4 slots at per-row n_past over a q8 cache (K4), both within
    `tol` of the logit scale and with the same argmax."""
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
    res["two_layer_vs_cpu"] = _compare_logits("2-layer prefill card vs cpu", *outs, tol)

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
        "2-layer batched q8 decode step (4 slots) card vs cpu", *outs, tol)
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
    """Greedy CLI chats, two per model, whose transcripts must be
    byte-identical: a narrow Llama-3 over a bf16 cache, the same with
    `--cache_dtype q8_0` at a 4096-token context (K4 on every decode step),
    and a narrow Qwen2 (ChatML control tokens, biased q/k/v, tied head,
    q8_0 weights)."""
    from chatllm_tpu_torch.ops.cuda.build import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = write_llama3_ggmm(BUILD_DIR / "smoke_llama3_q4k.bin")
    path_q8 = write_llama3_ggmm(BUILD_DIR / "smoke_llama3_q4k_4096.bin", max_len=4096)
    path_qwen = write_qwen2_ggmm(BUILD_DIR / "smoke_qwen2_q8_0.bin")
    cmd = [sys.executable, "-m", "chatllm_tpu_torch.main", "-p", "Hello from the H100!",
           "-t", "0", "--max_new_tokens", "8"]

    def chat(s):
        return [ln for ln in s.splitlines() if "eval time:" not in ln]

    res = {}
    for name, extra in (("transcript", ["-m", str(path)]),
                        ("transcript_q8", ["-m", str(path_q8), "--cache_dtype", "q8_0"]),
                        ("transcript_qwen2", ["-m", str(path_qwen)])):
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


# -------------------------------------------------------------- bench phase
BENCH_KEYS = ("value", "ttft_ms_512", "ttft_ms_2048", "batched8_tok_s", "batched32_tok_s",
              "batched32_q8kv_tok_s", "bw_measured_gb_s", "bw_achieved_gb_s",
              "roofline_tok_s", "vs_baseline", "prefill_mfu")


def _forced_decode(cfg, params, cache, feed):
    """Feed `feed[:, i]` at position i; returns (the argmax after every
    step [B, steps], the last step's logits [B, V])."""
    from chatllm_tpu_torch.nn.transformer import transformer_forward

    toks = []
    with torch.inference_mode():
        for i in range(feed.shape[1]):
            logits, _ = transformer_forward(cfg, params, feed[:, i:i + 1], cache, i)
            toks.append(logits[:, -1, :].argmax(dim=-1))
    return torch.stack(toks, dim=1), logits[:, -1, :].float()


def bench_phase(dev, cfg, params) -> dict:
    """The bench entry point on the full-width params already on the card,
    launches counted from 0; then the batched section under
    CHATLLM_TPU_QMM_V2=1 (K5 in place of K2), and K5 against K2 on one
    token history."""
    import os

    from chatllm_tpu_torch import bench
    from chatllm_tpu_torch.nn.transformer import init_cache
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    steps, ctx, B = 48, 2048, 8
    per_step = cfg.num_hidden_layers * 7 + 1       # quantized projections + lm_head
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    line = bench.run_bench(cfg, params, dev, ctx=ctx, steps=steps, batch=B)
    res = {"line": line, "seconds": time.perf_counter() - t0, "launches": launch_counts(),
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    log("  bench " + json.dumps(line))
    log(f"  bench took {res['seconds']:.1f} s, launches {res['launches']}, peak memory "
        f"{res['peak_mem_gib']:.2f} GiB")
    for k in BENCH_KEYS:
        if not (np.isfinite(line[k]) and line[k] > 0):
            raise AssertionError(f"bench: {k} = {line[k]}")
    if not 1000 <= line["bw_measured_gb_s"] <= 3350:
        raise AssertionError(f"bench: measured read bandwidth {line['bw_measured_gb_s']} GB/s "
                             "is outside 1000..3350 (above the H100's peak is an error)")
    # every section runs twice (warm, timed): 4 prefills (K3 on each layer, K1
    # for the one-row lm_head), 2 single-stream decodes (K1), 3 batched
    # sections (K2), and the probe (K6)
    L = cfg.num_hidden_layers
    want = {"flash_attention": 4 * L, "qgemv": 2 * steps * per_step + 4,
            "qmm": 3 * 2 * steps * per_step, "qmm_decode": 0, "flash_decode": 0}
    got = res["launches"]
    if any(got[k] != v for k, v in want.items()) or got["bw_probe"] <= 0:
        raise AssertionError(f"bench launches {got}, expected {want} and bw_probe > 0")

    os.environ["CHATLLM_TPU_QMM_V2"] = "1"
    try:
        reset_launch_counts()
        v2_rate = bench.batched_decode_rate(cfg, params, dev, B, ctx, steps)
        v2 = launch_counts()
        log(f"  bench B={B} under CHATLLM_TPU_QMM_V2=1: {v2_rate:.1f} tok/s (K2: "
            f"{line['batched8_tok_s']}), launches {v2}")
        if v2["qmm_decode"] != 2 * steps * per_step or v2["qmm"] != 0:
            raise AssertionError(f"V2 run: launches {v2}, expected K5 {2 * steps * per_step} "
                                 "and K2 0")
        # K5 against K2 on K2's own token history (so a flipped argmax does
        # not send the two runs down different paths)
        first = (torch.arange(B, device=dev) * 1009 + 17) % cfg.vocab_size
        del os.environ["CHATLLM_TPU_QMM_V2"]
        # the host's speed drifts within a call: K2's section once more, so
        # that K5's rate lies between two of K2's
        k2_after = bench.batched_decode_rate(cfg, params, dev, B, ctx, steps)
        log(f"  bench B={B} with K2 again, after the K5 run: {k2_after:.1f} tok/s")
        k2_toks = bench.greedy_decode(cfg, params, init_cache(cfg, B, ctx, device=dev),
                                      first, 0, steps)
        feed = torch.cat([first[:, None], k2_toks[:, :-1]], dim=1)
        again, k2_logits = _forced_decode(cfg, params, init_cache(cfg, B, ctx, device=dev), feed)
        os.environ["CHATLLM_TPU_QMM_V2"] = "1"
        k5_toks, k5_logits = _forced_decode(cfg, params, init_cache(cfg, B, ctx, device=dev),
                                            feed)
    finally:
        os.environ.pop("CHATLLM_TPU_QMM_V2", None)
    torch.cuda.synchronize()
    if not torch.equal(again, k2_toks):
        raise AssertionError("K2's decode does not repeat on its own token history")
    err, rel = rel_err(k5_logits, k2_logits)
    same = (k5_toks == k2_toks).float().mean().item()
    res["v2"] = {"batched8_tok_s": v2_rate, "k2_batched8_tok_s_after": k2_after,
                 "launches": v2, "tokens_equal_share": same,
                 "last_logits_max_abs_err": err, "last_logits_rel": rel,
                 "logit_scale": k2_logits.abs().max().item()}
    log(f"  K5 vs K2 over {steps} steps x {B} rows: {same:.3f} of the tokens equal, last-step "
        f"logits differ by {err:.3e} ({rel:.2e} of the logit scale)")
    # K5 rounds the affine term into each bf16 weight, K2 adds it in f32:
    # 5e-3 of the logit scale, and at least 0.9 of the tokens equal
    if not (torch.isfinite(k5_logits).all() and rel <= 5e-3 and same >= 0.9):
        raise AssertionError(f"K5 against K2: last-step logits differ by {rel} of the logit "
                             f"scale (limit 5e-3), {same} of the tokens equal (limit 0.9)")
    res["entry_point"] = bench_entry_point()
    return res


def bench_entry_point() -> dict:
    """`python -m chatllm_tpu_torch.bench` as a user runs it (its own
    constant-weight Llama-3-8B params, the BENCH_* knobs from the
    environment), with 8 steps per section: over the bf16 cache, and with
    BENCH_CACHE=q8_0, which sends every section over the q8 cache (the long
    prefill through the chunked attention, single-stream decode through
    K4).  Each must exit 0 and print one JSON line of positive rates."""
    import os

    res = {}
    for name, extra in (("bf16", {}), ("q8_0", {"BENCH_CACHE": "q8_0"})):
        env = dict(os.environ, BENCH_STEPS="8", **extra)
        env.pop("CHATLLM_TPU_QMM_V2", None)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "chatllm_tpu_torch.bench"], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise AssertionError(f"bench exit {r.returncode}:\n{r.stdout}\n{r.stderr}")
        lines = r.stdout.strip().splitlines()
        if len(lines) != 1:
            raise AssertionError(f"bench printed {len(lines)} lines, expected one:\n{r.stdout}")
        line = json.loads(lines[0])
        log(f"  python -m chatllm_tpu_torch.bench, BENCH_STEPS=8, {name} cache, "
            f"{time.perf_counter() - t0:.1f} s: {lines[0]}")
        for k in BENCH_KEYS:
            if not (np.isfinite(line[k]) and line[k] > 0):
                raise AssertionError(f"bench entry point ({name}): {k} = {line[k]}")
        if not 1000 <= line["bw_measured_gb_s"] <= 3350:
            raise AssertionError(f"bench entry point ({name}): measured read bandwidth "
                                 f"{line['bw_measured_gb_s']} GB/s is outside 1000..3350")
        res[name] = line
    return res


# -------------------------------------------------------------- qwen2 phase
def qwen2_phase(dev) -> dict:
    """Full-width Qwen2.5-0.5B: q8_0 weights (unpacked int8) with non-zero
    q/k/v biases, head dim 64, 14 query heads over 2 kv heads, a tied
    lm_head (a dense product, not a kernel).  The chat path over bf16 and q8
    caches with exact launch counts, then the 2-layer cuts against the CPU."""
    from chatllm_tpu_torch.models.synthetic import build_synthetic_params, qwen2_5_0_5b_config

    cfg = qwen2_5_0_5b_config(max_length=8192)
    params = build_synthetic_params(cfg, "q8", zeros=False, seed=0, device=dev)
    torch.cuda.synchronize()
    res = chat_phase(dev, cfg, params)
    L, steps = cfg.num_hidden_layers, 63
    per_token = 7 * L                       # 168 quantized projections
    # bf16: two prompts x 63 decode steps (K1); the 40-token prompt is one
    # 64-row chunk (K2); the 1000-token prompt one 1024-row chunk (K3)
    want = {"qgemv": 2 * steps * per_token, "qmm": per_token, "flash_attention": L,
            "flash_decode": 0}
    got = res["launches"]
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"qwen2 bf16 launches {got}, expected {want}")
    want = {"qgemv": steps * per_token, "qmm": 0, "flash_attention": 0,
            "flash_decode": steps * L}
    got = res["q8_prompt_1000"]["launches"]
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"qwen2 q8 launches {got}, expected {want}")
    # 1e-2 of the logit scale, where Llama-3-8B's cut is held to 1e-3: these
    # logits are O(1) (a tied head over a small embedding, no outlier to
    # measure against), and on the CPU alone an f32-level perturbation moves
    # them by 7e-3 to 9e-3 of their scale, because the quantized matmuls round
    # their input to bf16 and the flips compound
    # (tests/test_torch_qwen.py::test_two_layer_cut_logits_move_with_an_f32_level_perturbation).
    # The card read 2.1e-3 (prefill) and 4.5e-3 (batched q8 step), same argmax.
    res["two_layer"] = two_layer_phase(dev, cfg, params, tol=1e-2)
    return res


def e2_phase() -> dict:
    """The E2 probe's own entry point, every variant, launches counted."""
    from chatllm_tpu_torch.experiments import gemv_probe2
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = gemv_probe2.main([])
    res["launches"] = launch_counts()
    want = 2 * gemv_probe2.ITERS
    got = res["launches"]
    if got["gemv_stream"] != want or got["gemv_vpu"] != want or got["qmm"] != want:
        raise AssertionError(f"e2 launches {got}, expected {want} of stream, vpu and qmm")
    return res


def e1_phase() -> dict:
    """The E1 probe's own entry point, all seven variants (16 layers x 8
    steps, each run three times through the wrappers: warm-up, eager and
    the CUDA-graph capture, whose replays go through no wrapper), launches
    counted."""
    from chatllm_tpu_torch.experiments import gemv_probe
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = gemv_probe.main([])
    res["launches"] = launch_counts()
    want = 3 * gemv_probe.L * gemv_probe.STEPS
    got = res["launches"]
    if any(got[k] != want for k in ("gemv_stream", "gemv_vpu", "qmm")):
        raise AssertionError(f"e1 launches {got}, expected {want} of stream, vpu and qmm")
    for name in gemv_probe.VARIANTS:
        r = res[name]
        log(f"  e1 {name:11s} eager {r['eager_ms_per_step']:.3f} ms/step, graph "
            f"{r['graph_ms_per_step']:.3f} ms/step")
    return res


def e3_phase() -> dict:
    """The E3 bench's own entry point over its 3.93 GB of Llama-3-8B-shaped
    q4 weights, all four variants in one sweep: each 32-token loop run
    eagerly twice (warm-up, timed) and captured once into a CUDA graph,
    whose replays go through no wrapper."""
    from chatllm_tpu_torch.experiments import gemv_model_bench as e3
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = e3.main(["sweep", *e3.VARIANTS])
    gc.collect()
    torch.cuda.empty_cache()
    res["launches"] = got = launch_counts()
    want = 3 * e3.TOKENS * e3.L * len(e3.SHAPES)
    kernels = {"vpu": "qgemv", "stream": "stream_read", "vpu_bf16": "qgemv_bf16", "mxu": "qmm"}
    if any(got[k] != want for k in kernels.values()):
        raise AssertionError(f"e3 launches {got}, expected {want} of {list(kernels.values())}")
    for name in e3.VARIANTS:
        r = res[name]
        log(f"  e3 {name:8s} eager {r['eager_ms_per_token']:.3f} ms/token, graph "
            f"{r['graph_ms_per_token']:.3f} ms/token (host dispatch "
            f"{r['eager_ms_per_token'] - r['graph_ms_per_token']:.3f} ms/token)")
    return res


def e4_phase() -> dict:
    """The E4 probe's own entry point: each mode checked against K1, then
    REPS chained calls captured once into a CUDA graph and replayed."""
    from chatllm_tpu_torch.experiments import gemv_unpack as e4
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = e4.main([])
    res["launches"] = got = launch_counts()
    want = len(e4.MODES) * (e4.REPS + 2)          # check, warm-up, capture
    if got["unpack_gemv"] != want or got["qgemv"] != len(e4.MODES):
        raise AssertionError(f"e4 launches {got}, expected {want} of unpack_gemv and "
                             f"{len(e4.MODES)} of qgemv")
    if any("ms" not in res[m] for m in e4.MODES):
        raise AssertionError(f"e4: a mode missed its check against K1: {res}")
    return res


def e5_phase() -> dict:
    """The E5 probe's own entry point: the copy-only pass and K2 at M = 32
    for q4k, q8 and q4, each REPS chained calls replayed from a CUDA graph."""
    from chatllm_tpu_torch.experiments import qmm_m32 as e5
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = e5.main()
    res["launches"] = got = launch_counts()
    want = e5.REPS + 1                            # warm-up, capture
    if got["qmm_dma"] != want or got["qmm"] != len(e5.FORMATS) * want:
        raise AssertionError(f"e5 launches {got}, expected {want} of qmm_dma and "
                             f"{len(e5.FORMATS) * want} of qmm")
    return res


def e6_phase(dev) -> dict:
    """The E6 probe's own entry point at the original's sizes: the five
    diagnostic bodies and the three variants, each checked against K2 and
    timed over REPS chained calls replayed from a CUDA graph.  K2 adds the
    affine term in f32 from group sums of x, as biasdot does, so the biasdot
    variants are held to the original's 1e-3; v0 rounds it into every bf16
    weight and misses 1e-3 by design, so its error is held to the plain
    versions' on the CPU (the same check, 1.84e-3) within 1e-4."""
    from chatllm_tpu_torch.experiments import qmm_unpack_variants as e6
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = e6.main([])
    res["launches"] = got = launch_counts()
    want = {"qmm_unpack": len(e6.VARIANTS) * (e6.REPS + 2),       # check, warm-up, capture
            "qmm_unpack_diag": len(e6.DIAG_MODES) * (e6.REPS + 1), "qmm": len(e6.VARIANTS)}
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"e6 launches {got}, expected {want}")
    for name, unpack, biasdot in e6.VARIANTS:
        err, cpu = res[name]["err"], e6.check_correct(unpack, biasdot, device="cpu")
        res[name]["err_cpu"] = cpu
        log(f"  e6 {name:15s} check against K2 {err:.3e} (plain versions on the CPU "
            f"{cpu:.3e}); {res[name]['ms']:.4f} ms, {res[name]['gb_s']:.1f} GB/s")
        if (biasdot and err > e6.CHECK_TOL) or abs(err - cpu) > 1e-4:
            raise AssertionError(f"e6 {name}: check against K2 {err}, on the CPU {cpu}")
    return res


def e7_phase() -> dict:
    """The E7 probe's own entry point at B 32, ctx 1024, 48 steps: all 8
    combinations, each 48-step loop run eagerly 4 times (warm-up, 3 timed)
    and captured once into a CUDA graph, whose replays go through no
    wrapper."""
    from chatllm_tpu_torch.experiments import bhsd_decode as e7
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = e7.main([])
    gc.collect()
    torch.cuda.empty_cache()
    res["launches"] = got = launch_counts()
    passes = 5 * e7.STEPS                        # warm-up, 3 eager, capture
    per_step = N_LAYERS * 7 + 1                  # K2 projections + the lm_head
    n_k4 = sum(v == "pallas_bhsd" for _, v in e7.COMBOS)
    want = {"qmm": len(e7.COMBOS) * passes * per_step, "flash_decode": n_k4 * passes * N_LAYERS,
            "flash_decode_int8": 0, "qgemv": 0}
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"e7 launches {got}, expected {want}")
    for key, r in res.items():
        if key != "launches":
            log(f"  e7 {key:22s} eager {r['tok_s']:8.1f} tok/s, graph {r['graph_tok_s']:8.1f} "
                f"tok/s")
    return res


def int8_engine_phase(dev, cfg, params) -> dict:
    """Llama-3-8B at full width over a q8 cache under CHATLLM_TPU_FLASH_QK=int8:
    the first decode step after the 1000-token prompt against the bf16-dot
    run's (INT8_LOGIT_TOL of the logit scale, the same argmax), then 16
    greedy tokens with K4's int8 dots on every layer of every decode step."""
    import os

    from chatllm_tpu_torch.nn.transformer import transformer_forward
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine

    eng = InferenceEngine(replace(cfg, cache_dtype="int8"), params, device=dev)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, 1000).tolist()
    first, res = {}, {}
    try:
        for mode in ("bf16", "int8"):
            os.environ["CHATLLM_TPU_FLASH_QK"] = mode
            cache = eng.new_cache(1)
            reset_launch_counts()
            with torch.inference_mode():
                logits, cache, n = eng.prefill(ids, cache, 0)
                tok = logits[0].argmax().reshape(1, 1)
                step, _ = transformer_forward(eng.cfg, params, tok, cache, n)
            first[mode] = step[0, -1].float()
            res[f"first_step_launches_{mode}"] = launch_counts()
            del cache
        cmp = _compare_logits("first decode step, int8 dots vs bf16 dots", first["int8"],
                              first["bf16"].cpu(), INT8_LOGIT_TOL)
        res["first_step"] = cmp
        want = {"flash_decode_int8": N_LAYERS, "flash_decode": 0}
        got = res["first_step_launches_int8"]
        if any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"int8 first step launches {got}, expected {want}")
        reset_launch_counts()
        gcfg = GenerationConfig(do_sample=False, max_new_tokens=16)
        out, _, _ = eng.generate(ids, gcfg)
        torch.cuda.synchronize()
        res["launches"] = got = launch_counts()
        res["tokens_int8"] = out
    finally:
        os.environ.pop("CHATLLM_TPU_FLASH_QK", None)
    steps = len(out) - 1
    log(f"  int8 dots: 16 greedy tokens {out}, launches {got}")
    if len(out) != 16 or got["flash_decode_int8"] != N_LAYERS * steps or got["flash_decode"]:
        raise AssertionError(f"int8 run: {len(out)} tokens, K4 int8 launched "
                             f"{got['flash_decode_int8']} times (expected {N_LAYERS * steps}), "
                             f"bf16-dot K4 {got['flash_decode']}")
    res["flash_decode_int8_per_step"] = got["flash_decode_int8"] / steps
    return res


def switch_phase(dev, cfg, params) -> dict:
    """The attention switches on the card: CHATLLM_TPU_FLASH_DECODE=1 (the
    forced mode) on a bf16 cache at B = 8 through BatchedEngine takes K4 on
    every layer of every batched decode step, =0 none; CHATLLM_TPU_FLASH=0
    takes no K3 on the 1000-token prefill."""
    import os

    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.ops.sampling import SamplerConfig
    from chatllm_tpu_torch.runtime import batching
    from chatllm_tpu_torch.runtime.generate import InferenceEngine

    calls = []
    forward = batching.transformer_forward

    def counted(cfg_, params_, x, *a, **kw):
        calls.append(x.shape[0])
        return forward(cfg_, params_, x, *a, **kw)

    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, 20 + 7 * i).tolist() for i in range(8)]
    res = {}
    batching.transformer_forward = counted
    try:
        for value in ("1", "0"):
            os.environ["CHATLLM_TPU_FLASH_DECODE"] = value
            calls.clear()
            reset_launch_counts()
            eng = batching.BatchedEngine(cfg, params, max_slots=8, max_length=2048,
                                         decode_block=4, scfg=SamplerConfig(do_sample=False),
                                         device=dev)
            try:
                toks = [list(h) for h in [eng.submit(p, max_new=16) for p in prompts]]
            finally:
                eng.shutdown()
            torch.cuda.synchronize()
            got = launch_counts()
            steps = sum(b == 8 for b in calls)
            res[f"flash_decode_{value}"] = {"launches": got, "batched_steps": steps,
                                           "tokens": toks}
            log(f"  CHATLLM_TPU_FLASH_DECODE={value}, bf16 cache, B=8: {steps} batched steps, "
                f"K4 launches {got['flash_decode']}")
            want = N_LAYERS * steps if value == "1" else 0
            if got["flash_decode"] != want or steps == 0 or any(len(t) != 16 for t in toks):
                raise AssertionError(f"CHATLLM_TPU_FLASH_DECODE={value}: K4 {got['flash_decode']} "
                                     f"(expected {want}), {steps} steps, {toks}")
    finally:
        batching.transformer_forward = forward
        os.environ.pop("CHATLLM_TPU_FLASH_DECODE", None)
    a, b = res["flash_decode_1"]["tokens"], res["flash_decode_0"]["tokens"]
    res["tokens_equal_share"] = float(np.mean([x == y for s, t in zip(a, b) for x, y in zip(s, t)]))
    log(f"  forced K4 against the dense path: {res['tokens_equal_share']:.3f} of the tokens equal")

    eng = InferenceEngine(cfg, params, device=dev)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, 1000).tolist()
    logits = {}
    for value in ("0", None):
        if value is not None:
            os.environ["CHATLLM_TPU_FLASH"] = value
        try:
            reset_launch_counts()
            logits[value] = eng.prefill(ids, eng.new_cache(1, 8192), 0)[0]
            torch.cuda.synchronize()
            got = launch_counts()
        finally:
            os.environ.pop("CHATLLM_TPU_FLASH", None)
        want = 0 if value == "0" else N_LAYERS
        log(f"  CHATLLM_TPU_FLASH={value}: 1000-token prefill, K3 launches "
            f"{got['flash_attention']}")
        if got["flash_attention"] != want:
            raise AssertionError(f"CHATLLM_TPU_FLASH={value}: K3 launched "
                                 f"{got['flash_attention']} times, expected {want}")
    err, rel = rel_err(logits["0"], logits[None])
    res["flash_off_vs_on"] = {"max_abs_err": err, "rel": rel}
    log(f"  prefill logits without K3 against K3's: {rel:.2e} of the logit scale")
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
    "qmm_decode": ("chatllm_tpu_torch/csrc/qmm_decode.cu",
                   "chatllm_tpu/ops/pallas/qmm_decode.py:150"),
    "bw_probe": ("chatllm_tpu_torch/csrc/bw_probe.cu",
                 "chatllm_tpu/ops/pallas/bw_probe.py:29"),
    "gemv_stream": ("chatllm_tpu_torch/csrc/gemv_probe.cu",
                    "experiments/gemv_probe2.py:69, experiments/gemv_probe.py:211"),
    "gemv_vpu": ("chatllm_tpu_torch/csrc/gemv_probe.cu",
                 "experiments/gemv_probe2.py:117, experiments/gemv_probe.py:147"),
    "stream_read": ("chatllm_tpu_torch/csrc/gemv_model.cu",
                    "experiments/gemv_model_bench.py:46"),
    "qgemv_bf16": ("chatllm_tpu_torch/csrc/gemv_model.cu",
                   "experiments/gemv_model_bench.py:223"),
    "unpack_gemv": ("chatllm_tpu_torch/csrc/gemv_unpack.cu",
                    "experiments/gemv_unpack.py:99, experiments/gemv_unpack.py:146"),
    "qmm_dma": ("chatllm_tpu_torch/csrc/qmm_dma.cu", "experiments/qmm_m32.py:83"),
    "flash_decode_int8": ("chatllm_tpu_torch/csrc/flash_decode.cu",
                          "chatllm_tpu/ops/pallas/flash_decode.py:409"),
    "flash_decode_e7": ("chatllm_tpu_torch/csrc/flash_decode.cu", "experiments/bhsd_decode.py:51"),
    "qmm_unpack": ("chatllm_tpu_torch/csrc/qmm_unpack.cu",
                   "experiments/qmm_unpack_variants.py:230, experiments/qmm_unpack_variants.py:283"),
    "qmm_unpack_diag": ("chatllm_tpu_torch/csrc/qmm_unpack.cu",
                        "experiments/qmm_unpack_variants.py:230"),
}


def _per_token(n_layers: int, lm_head: bool) -> dict:
    m = {k: n_layers * v for k, v in PER_LAYER.items()}
    return {**m, "lm_head": 1} if lm_head else m


def kernels_line(kres: dict, launches: dict) -> dict:
    """One entry per kernel, its times summed over the main path's calls of
    one unit of work: qgemv = one decode token (32 x 7 projections + the
    lm_head), qmm = one <=64-token prefill chunk (32 x 7 at 64 rows),
    flash_attention = the 1000-token prompt's chunk (32 layers), flash_decode
    = one decode step after the 1000-token prompt over a q8 cache (32
    layers), qmm_decode = one batched decode step of 8 rows (32 x 7 + the
    lm_head), bw_probe = one pass over 256 MiB, gemv_stream / gemv_vpu = one
    call at 4096 x 16384 (E2's shape), stream_read / qgemv_bf16 = one decode
    token of E3 (32 x 7 projections), unpack_gemv = one call of each of its
    four modes at 4096 x 14336, qmm_dma = one pass over 4096 x 14336,
    flash_decode_int8 = one decode step after the 1000-token prompt (32
    layers), flash_decode_e7 = one E7 decode step over the q8 cache at
    n_past 47 (32 layers), qmm_unpack = one call of each of E6's three
    variants and qmm_unpack_diag of each of its five modes at M 32, K 4096,
    N 14336.  `launches` counts each kernel on its own path: K1-K3 on the
    bf16-cache chat path, K4 on the q8-cache one (its int8 dots on the
    int8 engine run, and under E7's call site in E7's main), K5 on the
    bench's batched section under CHATLLM_TPU_QMM_V2=1, K6 in the bench,
    E2's two in E2's and E1's mains together, the others in their probe's
    main."""
    mult = {"qgemv": _per_token(N_LAYERS, True), "qmm": _per_token(N_LAYERS, False),
            "flash_attention": {"prefill_1000": N_LAYERS},
            "flash_decode": {"decode_1000": N_LAYERS},
            "qmm_decode": _per_token(N_LAYERS, True),
            "bw_probe": {"pass_256mb": 1},
            "gemv_stream": {"4096x16384": 1}, "gemv_vpu": {"4096x16384": 1},
            "stream_read": _per_token(N_LAYERS, False),
            "qgemv_bf16": _per_token(N_LAYERS, False),
            "unpack_gemv": {"v0": 1, "v1": 1, "v2": 1, "v3": 1},
            "qmm_dma": {"4096x14336": 1},
            "flash_decode_int8": {"decode_1000": N_LAYERS},
            "flash_decode_e7": {"e7_step_q8": N_LAYERS},
            "qmm_unpack": {name: 1 for name in ("v0_current", "v4_biasdot", "v5_f32+biasdot")},
            "qmm_unpack_diag": {f"diag_{m}": 1 for m in ("noscale", "nounpack", "storeonly",
                                                         "splitstore", "splitstore_bias")}}
    entries = []
    for name, (src, rep) in KERNEL_META.items():
        entries.append(_line_entry(name, src, rep, kres[name]["shapes"], mult[name],
                                   kres[name]["cases"], launches[name]))
    return {"kernels": entries}


def _line_entry(name, src, rep, shapes, mult, cases, launches) -> dict:
    tot = {f: sum(mult[s] * shapes[s][f] for s in mult)
           for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
    # what bounds the shape that contributes most to the bound
    top = max(mult, key=lambda s: mult[s] * shapes[s]["bound_ms"])
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": shapes[top]["bound_by"], "library_ms": tot["library_ms"]}


def qwen_totals(kres: dict) -> dict:
    """K1-K5 summed over one unit of Qwen2.5-0.5B's path (24 layers, no
    quantized lm_head): per decode token, per 64-row chunk, per 1000-token
    chunk, per decode step after 1000 tokens, per 8-row batched step."""
    m = _per_token(QWEN_LAYERS, False)
    units = {"qgemv": (kres["qgemv"]["qwen_shapes"], m),
             "qmm": (kres["qmm"]["qwen_shapes"], m),
             "qmm_decode": (kres["qmm_decode"]["qwen_shapes"], m),
             "flash_attention": (kres["flash_attention"]["shapes"],
                                 {"prefill_1000_qwen": QWEN_LAYERS}),
             "flash_decode": (kres["flash_decode"]["shapes"],
                              {"decode_1000_qwen": QWEN_LAYERS})}
    return {name: {f: sum(mult[s] * shapes[s][f] for s in mult)
                   for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
            for name, (shapes, mult) in units.items()}


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
    t_start = time.perf_counter()

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
    report["qwen_kernel_totals"] = qwen_totals(report["kernels"])
    log(f"  Qwen2.5-0.5B totals per unit of its path: {report['qwen_kernel_totals']}")
    b8 = {n: sum(_per_token(N_LAYERS, True)[s] * report["kernels"][n][key][s]["ms"]
                 for s in _per_token(N_LAYERS, True))
          for n, key in (("qmm", "shapes_b8"), ("qmm_decode", "shapes"))}
    report["batched_step_b8_ms"] = b8
    log(f"  one 8-row batched step of Llama-3-8B (225 launches), kernel time: K2 "
        f"{b8['qmm']:.2f} ms, K5 {b8['qmm_decode']:.2f} ms")
    del timer
    torch.cuda.empty_cache()

    from chatllm_tpu_torch.models.synthetic import build_synthetic_params, llama3_8b_config

    cfg = llama3_8b_config(max_length=8192)
    t0 = time.perf_counter()
    params = build_synthetic_params(cfg, "q4k", zeros=False, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"== llama3_8b: built {cfg.num_hidden_layers}-layer synthetic q4_k params in "
        f"{time.perf_counter() - t0:.1f} s")
    report["llama3_8b"] = chat_phase(dev, cfg, params)
    torch.cuda.empty_cache()

    log("== bench")
    report["bench"] = bench_phase(dev, cfg, params)
    torch.cuda.empty_cache()

    log("== serve")
    report["serve"] = serve_phase(dev, cfg, params)
    torch.cuda.empty_cache()

    log("== two_layer")
    report["two_layer"] = two_layer_phase(dev, cfg, params)
    torch.cuda.empty_cache()

    log("== int8_engine")
    report["int8_engine"] = int8_engine_phase(dev, cfg, params)
    torch.cuda.empty_cache()

    log("== switches")
    report["switches"] = switch_phase(dev, cfg, params)
    del params
    gc.collect()              # the server's objects held the params in cycles
    torch.cuda.empty_cache()

    log("== qwen2")
    report["qwen2"] = qwen2_phase(dev)
    torch.cuda.empty_cache()

    log("== cli")
    report["cli"] = cli_phase()

    log("== e2")
    report["e2"] = e2_phase()

    log("== e1")
    report["e1"] = e1_phase()
    torch.cuda.empty_cache()

    log("== e3")
    report["e3"] = e3_phase()

    log("== e4")
    report["e4"] = e4_phase()

    log("== e5")
    report["e5"] = e5_phase()
    torch.cuda.empty_cache()

    log("== e6")
    report["e6"] = e6_phase(dev)
    torch.cuda.empty_cache()

    log("== e7")
    report["e7"] = e7_phase()
    report["seconds"] = time.perf_counter() - t_start
    log(f"== all phases passed in {report['seconds']:.0f} s")

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    launches = dict(report["llama3_8b"]["launches"],
                    flash_decode=report["llama3_8b"]["q8_prompt_1000"]["launches"]["flash_decode"],
                    qmm_decode=report["bench"]["v2"]["launches"]["qmm_decode"],
                    bw_probe=report["bench"]["launches"]["bw_probe"],
                    gemv_stream=report["e2"]["launches"]["gemv_stream"]
                    + report["e1"]["launches"]["gemv_stream"],
                    gemv_vpu=report["e2"]["launches"]["gemv_vpu"]
                    + report["e1"]["launches"]["gemv_vpu"],
                    stream_read=report["e3"]["launches"]["stream_read"],
                    qgemv_bf16=report["e3"]["launches"]["qgemv_bf16"],
                    unpack_gemv=report["e4"]["launches"]["unpack_gemv"],
                    qmm_dma=report["e5"]["launches"]["qmm_dma"],
                    flash_decode_int8=report["int8_engine"]["launches"]["flash_decode_int8"],
                    flash_decode_e7=report["e7"]["launches"]["flash_decode"],
                    qmm_unpack=report["e6"]["launches"]["qmm_unpack"],
                    qmm_unpack_diag=report["e6"]["launches"]["qmm_unpack_diag"])
    print(json.dumps(kernels_line(report["kernels"], launches)))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
