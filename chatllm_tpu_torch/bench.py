"""Headline benchmark: Llama-3-8B-shaped q4-layout decode on one card.

    python -m chatllm_tpu_torch.bench [--device cpu]

Counterpart of the root bench.py: the same sections in the same order, the
same environment knobs (BENCH_CTX, BENCH_STEPS, BENCH_CACHE, BENCH_FMT,
BENCH_BATCH, BENCH_BATCH_CTX, BENCH_B32_CTX), ONE JSON line with the same
keys:

  - TTFT of a 512-token and a min(2048, ctx)-token prompt (lm_head on the
    last position only, as the production prefill);
  - single-stream greedy decode of BENCH_STEPS tokens;
  - batched greedy decode at B = BENCH_BATCH (8) and B = 32, and B = 32 over
    the q8 KV cache;
  - the card's sustained pure-read bandwidth from the K6 probe, and what
    the decode rate is worth against it.

vs_baseline compares the decode rate with the weight-bandwidth roofline for
the ideal q4_k footprint (4.5 bits per weight) at the card's device-memory
rate: 1.0 means decode runs as fast as a perfectly packed model can be read.

The original keeps the whole decode loop on the device in one compiled
scan (`decode_n`, `decode_n_b`).  Here decode runs through the engine's
block decoder (runtime/decode_graph.py): blocks of DECODE_BLOCK greedy
steps, each a CUDA graph on the card, replayed back to back with the
tokens read back once, after the last block, so the host neither waits nor
launches a kernel inside the loop.  Every section is warmed once (which
captures its graphs) and the second call is timed, between two device
synchronisations.  A section that fails makes the run fail: nothing is
caught.

Not carried over from the original: its tables of TPU memory rates and
peaks and its `mxu_floor_tok_s` (a constant of the TPU's matrix unit).
`DEVICE_PEAKS` holds the card's own published figures instead; on a device
that is not in it (the CPU of the tests) the fields derived from a peak are
-1.0.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import torch

from .device import resolve_device
from .models.synthetic import build_synthetic_params, llama3_8b_config, param_bytes
from .nn.transformer import TransformerConfig, init_cache, transformer_forward
from .ops.cuda.bw_probe import measure_read_bw
from .ops.sampling import SamplerConfig
from .runtime.decode_graph import BlockDecoder, kv_bucket

DECODE_BLOCK = 16          # steps per captured block (the engine's default)
GREEDY = SamplerConfig(do_sample=False, sampling="greedy")

# device name -> published peaks (NVIDIA H100 SXM data sheet, dense rates)
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12},
}


def power_limit_w(device: torch.device) -> float | None:
    """The card's power limit as nvidia-smi reports it; None on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                          "-i", str(device.index or 0)], capture_output=True, text=True,
                         check=True).stdout
    return float(out.strip().splitlines()[0])


def count_params(cfg: TransformerConfig) -> int:
    """Weights of the dense decoder: projections, embedding and (untied)
    lm_head; 8.03e9 for Llama-3-8B."""
    d = cfg.resolved_head_dim()
    H, F = cfg.hidden_size, cfg.intermediate_size
    qo, kvo = cfg.num_attention_heads * d, cfg.num_key_value_heads * d
    per_layer = 2 * H * qo + 2 * H * kvo + 3 * H * F
    head = 0 if cfg.tie_lm_head else cfg.vocab_size * H
    return cfg.num_hidden_layers * per_layer + cfg.vocab_size * H + head


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device: torch.device):
    """(seconds, result on the host) of the second of two calls."""
    fn().cpu()                                  # warm: builds, allocator, caches
    _sync(device)
    t0 = time.perf_counter()
    out = fn().cpu()                            # the one read-back
    _sync(device)
    return time.perf_counter() - t0, out


@torch.inference_mode()
def prefill_token(cfg, params, ids, cache, n_past: int = 0) -> torch.Tensor:
    """Greedy first token [B] of a prompt: lm_head on the last position."""
    logits, _ = transformer_forward(cfg, params, ids, cache, n_past,
                                    last_index=ids.shape[1] - 1)
    return logits[:, -1, :].argmax(dim=-1)


@torch.inference_mode()
def greedy_decode(cfg, params, cache, tok, n_past: int, steps: int, *,
                  decoder: BlockDecoder | None = None) -> torch.Tensor:
    """`steps` greedy tokens after `tok` ([B] ids at position n_past), all
    rows at the same position, in blocks of DECODE_BLOCK steps (the last
    block's steps past `steps` are speculative and dropped).  Returns int64
    [B, steps] on the device; the host reads nothing inside the loop.  Pass
    the same `decoder` to replay its graphs on a later call."""
    decoder = decoder or BlockDecoder(cfg, params, tok.device)
    B = tok.shape[0]
    st = decoder.state(B)
    st.tok.copy_(tok.reshape(B, 1))
    st.n_past.fill_(n_past)
    block = min(DECODE_BLOCK, steps)
    cache_len = cache.k[0].shape[1]
    out = [decoder.run(st, cache, GREEDY, block, kv_bucket(n_past + i + block, cache_len)).clone()
           for i in range(0, steps, block)]
    return torch.cat(out)[:steps].t()


def batched_decode_rate(cfg, params, device, batch: int, ctx: int, steps: int) -> float:
    """Aggregate tokens/s of `batch` streams decoding `steps` greedy tokens
    from an empty cache of `ctx` slots (the continuous-batching shape)."""
    cache = init_cache(cfg, batch, ctx, device=device)
    tok = torch.zeros(batch, dtype=torch.int64, device=device)
    dec = BlockDecoder(cfg, params, device)
    dt, _ = _timed(lambda: greedy_decode(cfg, params, cache, tok, 0, steps, decoder=dec), device)
    del cache
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return batch * steps / dt


def run_bench(cfg: TransformerConfig, params, device, *, ctx: int | None = None,
              steps: int = 48, prompt_len: int = 512, batch: int = 8,
              batch_ctx: int | None = None, b32_ctx: int = 1024, read_bw=None) -> dict:
    """Run every section on `device` and return the result line as a dict.
    `read_bw() -> bytes/s` replaces the K6 probe at its default size (the
    tests pass a small one)."""
    device = resolve_device(device)
    ctx = ctx or cfg.max_length
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    peaks = DEVICE_PEAKS.get(name)
    pbytes = param_bytes(params)
    n_params = count_params(cfg)

    # TTFT and single-stream decode
    cache = init_cache(cfg, 1, ctx, device=device)
    ids = torch.zeros(1, prompt_len, dtype=torch.int64, device=device)
    dt, tok = _timed(lambda: prefill_token(cfg, params, ids, cache), device)
    ttft_ms = dt * 1000
    tok = tok.to(device)
    dec = BlockDecoder(cfg, params, device)
    dt, _ = _timed(lambda: greedy_decode(cfg, params, cache, tok, prompt_len, steps,
                                         decoder=dec), device)
    tok_s = steps / dt

    # long-context TTFT: the prompt fills the cache (K3 on a float cache)
    long_len = min(2048, ctx)
    cache2 = init_cache(cfg, 1, ctx, device=device)
    ids2 = torch.zeros(1, long_len, dtype=torch.int64, device=device)
    dt, _ = _timed(lambda: prefill_token(cfg, params, ids2, cache2), device)
    ttft2k_ms = dt * 1000
    del cache, cache2, dec
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # batched decode: each section frees its cache before the next
    if batch_ctx is None:
        batch_ctx = min(ctx, 2048 if batch <= 8 else 1024)
    tok_s_batched = batched_decode_rate(cfg, params, device, batch, batch_ctx, steps)
    tok_s_b32 = batched_decode_rate(cfg, params, device, 32, b32_ctx, steps)
    cfg_q8 = replace(cfg, cache_dtype="q8_0")
    tok_s_b32_q8 = batched_decode_rate(cfg_q8, params, device, 32, b32_ctx, steps)

    # roofline for ideal q4_k packing (4.5 bits per weight)
    ideal_bytes = n_params * 4.5 / 8
    roofline = peaks["hbm_bytes_per_s"] / ideal_bytes if peaks else -1.0

    # attainable bound: the card's sustained pure-read rate from the probe,
    # over the bytes decode reads per token.  The embedding is left out (one
    # row is gathered per token); with a tied lm_head that also leaves the
    # head's product over the embedding out of the bytes read, as in the
    # original's formula.
    bw_meas = read_bw() if read_bw is not None else measure_read_bw(device=device)
    embed_bytes = param_bytes(params["embed"])
    read_bytes = pbytes - embed_bytes
    # achieved_bw is the rate the decode loop itself demonstrates.  The
    # ceiling comes from the probe only: if the probe reads below what decode
    # achieved, the two are inconsistent and vs_attainable is -1 rather than
    # a ceiling derived from the number under judgment.
    achieved_bw = read_bytes * tok_s
    probe_ok = bw_meas >= achieved_bw * 0.95
    attainable = bw_meas / read_bytes if (bw_meas > 0 and probe_ok) else -1.0

    # prefill_mfu: model flops (2 N T; attention adds ~2% at 2048) over the
    # card's dense bf16 peak
    prefill_mfu = (2.0 * n_params * long_len / (ttft2k_ms / 1000) / peaks["bf16_flops"]
                   if (ttft2k_ms > 0 and peaks) else -1.0)
    decode_bw_util = achieved_bw / bw_meas if (bw_meas > 0 and probe_ok) else -1.0

    return {
        "metric": "llama3_8b_q4_decode",
        "value": round(tok_s, 2),
        "unit": "tok/s",
        "vs_baseline": round(tok_s / roofline, 4) if roofline > 0 else -1.0,
        "ttft_ms_512": round(ttft_ms, 1),
        "ttft_ms_2048": round(ttft2k_ms, 1),
        "prefill_mfu": round(prefill_mfu, 4),
        "decode_bw_util": round(decode_bw_util, 4),
        "batched8_tok_s": round(tok_s_batched, 1),
        "batched32_tok_s": round(tok_s_b32, 1),
        "batched32_q8kv_tok_s": round(tok_s_b32_q8, 1),
        "device": name,
        "power_limit_w": power_limit_w(device),
        "param_bytes_actual": pbytes,
        "read_bytes_per_token": read_bytes,
        "bw_measured_gb_s": round(bw_meas / 1e9, 1),
        "bw_achieved_gb_s": round(achieved_bw / 1e9, 1),
        "probe_consistent": bool(probe_ok),
        "attainable_tok_s": round(attainable, 1),
        "vs_attainable": round(tok_s / attainable, 4) if attainable > 0 else -1.0,
        "roofline_tok_s": round(roofline, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    env = os.environ
    max_len = int(env.get("BENCH_CTX", "2048"))
    cfg = llama3_8b_config(max_length=max_len)
    # BENCH_CACHE=q8_0 runs the whole bench over the quantized KV cache
    cache_env = env.get("BENCH_CACHE", "").strip()
    if cache_env:
        cfg = replace(cfg, cache_dtype=cache_env)
    params = build_synthetic_params(cfg, env.get("BENCH_FMT", "q4k"), zeros=True, device=device)
    batch = int(env.get("BENCH_BATCH", "8"))
    batch_ctx = env.get("BENCH_BATCH_CTX")
    res = run_bench(cfg, params, device, ctx=max_len, steps=int(env.get("BENCH_STEPS", "48")),
                    batch=batch, batch_ctx=int(batch_ctx) if batch_ctx else None,
                    b32_ctx=int(env.get("BENCH_B32_CTX", "1024")))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
