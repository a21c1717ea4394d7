"""E7: decode attention over a [B, Hkv, S, D] cache, in a minimal Llama-3-8B
decode step at B rows (q4_k weights, K2 projections).

  no_attn       the projections only: the weights-only floor
  noscale       the q8 cache written and read, no scale multiplies
  einsum_bshd   plain attention over the production [B, S, Hkv, D] cache
  einsum_bhsd   plain attention over a [B, Hkv, S, D] cache
  pallas_bhsd   K4 over the [B, Hkv, S, D] cache
per cache dtype in {q8_0, bfloat16} for the last three.

    python -m chatllm_tpu_torch.experiments.bhsd_decode [B] [ctx] [steps]

Counterpart of experiments/bhsd_decode.py.  `pallas_decode_bhsd` runs K4
(ops/cuda/flash_decode.py, f32 dots, as the original's per-head Pallas
kernel) on the head-major cache, passed as a permuted [B, S, Hkv, D] view
with its [B, Hkv, S] scales permuted likewise: K4 reads both through their
strides, so no copy is made and no kernel of its own is needed.  The einsum
variants are plain PyTorch yardsticks with the original's bf16 roundings of
q, k, p and v.  `forward` runs the port's `ops/qmm.py::matmul` (K2 at B
rows), `ops/rope.py` and `ops/attention.py::quantize_kv`, and writes the
caches in place where the original returns new ones.  `main` times each
variant's `steps`-step loop eagerly (the best of 3 passes after a warm-up)
and, on the card, as the best of 3 replays of one CUDA graph captured from
it, the counterpart of the original's one jitted scan; like the original,
every pass restarts at position 0 and feeds the last pass's tokens.  The
original's weights are zeros, so are these: the tokens mean nothing.
"""
from __future__ import annotations

import json
import sys

import torch

from ..device import resolve_device
from ..models.synthetic import build_synthetic_params, llama3_8b_config
from ..ops.attention import quantize_kv
from ..ops.cuda.flash_decode import flash_decode
from ..ops.norm import rms_norm
from ..ops.qmm import matmul
from ..ops.rope import apply_rope, precompute_rope_cache
from .timing import best_replay_s, capture, run_s

NEG_INF = -1e30
B, CTX, STEPS = 32, 1024, 48
BLOCK_K = 512
COMBOS = ((False, "no_attn"), (True, "noscale"),
          (True, "einsum_bshd"), (True, "einsum_bhsd"), (True, "pallas_bhsd"),
          (False, "einsum_bshd"), (False, "einsum_bhsd"), (False, "pallas_bhsd"))


def pallas_decode_bhsd(q, k_cache, v_cache, n_past, *, scale: float, k_scale=None,
                       v_scale=None, block_k: int = BLOCK_K) -> torch.Tensor:
    """q [B, T, Hq, D]; caches [B, Hkv, S, D]; scales [B, Hkv, S] (q8) or
    None (bf16).  Causal attention of the T new tokens at n_past over the
    cache, f32 dots, in q's dtype: K4 on permuted views."""
    T = q.shape[1]
    S = k_cache.shape[2]
    if S % block_k:
        raise ValueError(f"cache of {S} slots is not a multiple of block_k={block_k}")
    ks = None if k_scale is None else k_scale.permute(0, 2, 1)
    vs = None if v_scale is None else v_scale.permute(0, 2, 1)
    return flash_decode(q, k_cache.permute(0, 2, 1, 3), v_cache.permute(0, 2, 1, 3), n_past, T,
                        scale=scale, k_scale=ks, v_scale=vs, qk_dtype="float32",
                        block_k=block_k)


def einsum_decode(q, k_cache, v_cache, n_past: int, *, scale: float, layout: str,
                  k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain attention, bf16-rounded q, k, p and v with f32 sums: caches
    [B, S, Hkv, D] ("bshd", scales [B, S, Hkv]) or [B, Hkv, S, D] ("bhsd",
    scales [B, Hkv, S])."""
    Bq, T, Hq, D = q.shape
    if layout == "bshd":
        sub_k, sub_v = "bthgd,bshd->bhgts", "bhgts,bshd->bthgd"
        S, Hkv = k_cache.shape[1], k_cache.shape[2]

        def tr(sc):
            return sc.transpose(1, 2)[:, :, None, None, :]
    else:
        sub_k, sub_v = "bthgd,bhsd->bhgts", "bhgts,bhsd->bthgd"
        Hkv, S = k_cache.shape[1], k_cache.shape[2]

        def tr(sc):
            return sc[:, :, None, None, :]

    def bf16(a):
        return a.to(torch.bfloat16).float()

    qg = q.reshape(Bq, T, Hkv, Hq // Hkv, D).float()
    scores = torch.einsum(sub_k, bf16(qg), bf16(k_cache)) * scale
    if k_scale is not None:
        scores = scores * tr(k_scale)
    q_pos = n_past + torch.arange(T, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    valid = (k_pos < n_past + T) & (k_pos <= q_pos)
    p = torch.softmax(scores + torch.where(valid, 0.0, NEG_INF), dim=-1)
    if v_scale is not None:
        p = p * tr(v_scale)
    out = torch.einsum(sub_v, bf16(p), bf16(v_cache))
    return out.reshape(Bq, T, Hq, v_cache.shape[-1]).to(q.dtype)


def _write(cache, val, n_past: int, dim: int):
    """cache[..., n_past:n_past + T along dim] = val, in place."""
    cache.narrow(dim, n_past, val.shape[dim]).copy_(val)


def forward(cfg, params, tok, caches, n_past: int, *, variant: str, cache_q8: bool,
            rope=None):
    """Minimal Llama decode step; caches: a list of (k, v[, ks, vs]) per
    layer, written in place.  `rope` = (cos, sin) tables over the cache's
    positions, or None to compute this step's.  Returns the logits [B, 1, V]."""
    d = cfg.rope.head_dim
    Hq, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    x = params["embed"][tok[:, 0]][:, None, :]
    Bx, T = x.shape[:2]
    if rope is None:
        cos, sin = precompute_rope_cache(n_past + torch.arange(T, device=x.device), cfg.rope)
    else:
        cos, sin = rope[0][n_past:n_past + T], rope[1][n_past:n_past + T]
    for lp, c in zip(params["layers"], caches):
        h = rms_norm(x, lp["attn_norm"]["w"])
        a = lp["attn"]
        qp = matmul(h, a["q"]).reshape(Bx, T, Hq, d)
        kp = matmul(h, a["k"]).reshape(Bx, T, Hkv, d)
        vp = matmul(h, a["v"]).reshape(Bx, T, Hkv, d)
        qp = apply_rope(qp, cos, sin, layout=cfg.rope.layout)
        kp = apply_rope(kp, cos, sin, layout=cfg.rope.layout)
        kw = dict(scale=d ** -0.5)
        if variant == "no_attn":
            # weights-only floor: the projections still stream, no attention
            attn = qp + kp.mean(dim=2, keepdim=True) + vp.mean(dim=2, keepdim=True)
        elif variant in ("noscale", "einsum_bshd"):
            if cache_q8:
                (kq, ks1), (vq, vs1) = quantize_kv(kp), quantize_kv(vp)
                for t, val in zip(c, (kq, vq, ks1, vs1)):
                    _write(t, val, n_past, 1)
                if variant == "einsum_bshd":
                    kw.update(k_scale=c[2], v_scale=c[3])
            else:
                _write(c[0], kp.to(c[0].dtype), n_past, 1)
                _write(c[1], vp.to(c[1].dtype), n_past, 1)
            attn = einsum_decode(qp, c[0], c[1], n_past, layout="bshd", **kw)
        else:
            # [B, Hkv, S, D] cache: write at (:, :, n_past, :)
            kt, vt = kp.transpose(1, 2), vp.transpose(1, 2)                  # [B, Hkv, T, D]
            if cache_q8:
                (kq, ks1), (vq, vs1) = quantize_kv(kt), quantize_kv(vt)     # scales [B, Hkv, T]
                for t, val in zip(c, (kq, vq, ks1, vs1)):
                    _write(t, val, n_past, 2)
                kw.update(k_scale=c[2], v_scale=c[3])
            else:
                _write(c[0], kt.to(c[0].dtype), n_past, 2)
                _write(c[1], vt.to(c[1].dtype), n_past, 2)
            if variant == "pallas_bhsd":
                attn = pallas_decode_bhsd(qp, c[0], c[1], n_past, **kw)
            else:
                attn = einsum_decode(qp, c[0], c[1], n_past, layout="bhsd", **kw)
        x = x + matmul(attn.reshape(Bx, T, Hq * d), a["o"]).to(x.dtype)
        h = rms_norm(x, lp["ffn_norm"]["w"])
        m = lp["mlp"]
        g = torch.nn.functional.silu(matmul(h, m["gate"]).float())
        u = matmul(h, m["up"]).float()
        x = x + matmul((g * u).to(x.dtype), m["down"]).to(x.dtype)
    x = rms_norm(x, params["final_norm"]["w"])
    if "lm_head" in params:
        return matmul(x, params["lm_head"])
    return x @ params["embed"].t()


def init_caches(cfg, Bc: int, S: int, *, layout: str, q8: bool, device="cpu") -> list:
    """Zero caches per layer: (k, v, k_scale, v_scale) int8 + f32, or (k, v)
    bf16; [B, S, Hkv, D] for "bshd", [B, Hkv, S, D] for "bhsd"."""
    Hkv, d = cfg.num_key_value_heads, cfg.rope.head_dim
    shape = (Bc, S, Hkv, d) if layout == "bshd" else (Bc, Hkv, S, d)
    sshape = shape[:3]
    out = []
    for _ in range(cfg.num_hidden_layers):
        if q8:
            out.append((torch.zeros(shape, dtype=torch.int8, device=device),
                        torch.zeros(shape, dtype=torch.int8, device=device),
                        torch.zeros(sshape, dtype=torch.float32, device=device),
                        torch.zeros(sshape, dtype=torch.float32, device=device)))
        else:
            out.append((torch.zeros(shape, dtype=torch.bfloat16, device=device),
                        torch.zeros(shape, dtype=torch.bfloat16, device=device)))
    return out


def layout_of(variant: str) -> str:
    return "bshd" if variant in ("einsum_bshd", "no_attn", "noscale") else "bhsd"


def run_variant(cfg, params, variant: str, cache_q8: bool, *, b: int, ctx: int, steps: int,
                device, rope=None) -> dict:
    """Eager and (on the card) graph seconds of one `steps`-step pass, and
    its final tokens."""
    caches = init_caches(cfg, b, ctx, layout=layout_of(variant), q8=cache_q8, device=device)
    tok = torch.zeros((b, 1), dtype=torch.int64, device=device)

    def decode_n():
        t = tok
        for i in range(steps):
            logits = forward(cfg, params, t, caches, i, variant=variant, cache_q8=cache_q8,
                             rope=rope)
            t = logits[:, -1, :].argmax(dim=-1)[:, None]
        tok.copy_(t)

    run_s(decode_n, device)                                  # warm-up (builds the kernels)
    res = {"eager_s": min(run_s(decode_n, device) for _ in range(3))}
    if device.type == "cuda":
        graph = capture(decode_n, device)
        res["graph_s"] = best_replay_s(graph, device)
        del graph
    res["tokens"] = tok[:, 0].tolist()
    return res


def main(argv=None, *, device=None, b: int = B, ctx: int = CTX, steps: int = STEPS,
         cfg=None) -> dict:
    """Every variant of COMBOS; `argv` [B] [ctx] [steps] (the original
    reads them from the command line) overrides `b`, `ctx` and `steps`.
    `cfg` defaults to Llama-3-8B at max_length ctx.  Prints one JSON line
    of tok/s per variant."""
    args = list(sys.argv[1:4] if argv is None else argv)
    b = int(args[0]) if len(args) > 0 else b
    ctx = int(args[1]) if len(args) > 1 else ctx
    steps = int(args[2]) if len(args) > 2 else steps
    dev = resolve_device(device)
    cfg = cfg or llama3_8b_config(max_length=ctx)
    params = build_synthetic_params(cfg, "q4k", zeros=True, device=dev)
    rope = precompute_rope_cache(torch.arange(ctx, device=dev), cfg.rope)
    out = {}
    for cache_q8, variant in COMBOS:
        cache = "q8_0" if cache_q8 else "bfloat16"
        r = run_variant(cfg, params, variant, cache_q8, b=b, ctx=ctx, steps=steps, device=dev,
                        rope=rope)
        line = {"variant": variant, "cache": cache, "B": b, "ctx": ctx,
                "tok_s": round(b * steps / r["eager_s"], 1)}
        if "graph_s" in r:
            line["graph_tok_s"] = round(b * steps / r["graph_s"], 1)
        print(json.dumps(line), flush=True)
        out[f"{variant}/{cache}"] = {**line, **r}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
