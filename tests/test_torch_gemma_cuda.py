"""K3 and K4 at head_dim 256 and the narrow Gemmas on the card, against
their plain versions and the CPU.  Marked `cuda`: they skip where no GPU is
present.  This file imports no JAX (the GPU machine has none), and the
kernel sources are built only inside the tests.  On a GPU machine:

    python -m pytest -q --noconftest -m cuda tests/test_torch_gemma_cuda.py

  - K3 in its three modes (bf16; f32 cache; f32 query over a bf16 cache) at
    D 256 with Gemma-3-12B's and Gemma-3-1B's heads: a window across key
    tiles, the softcap 50, a chunk deep in the cache; held to chip_smoke's
    limits (FLASH_ATOL and FLASH_SCALED_TOL), a second launch bit-identical;
  - K4 at D 256 with float dots over int8 / bf16 / f32 caches and with
    int8 dots, scalar and per-row n_past, window, softcap 50, sinks, and
    32 rows per kv head (DECODE_ATOL / DECODE_SCALED_TOL; int8 dots within
    DECODE_INT8_STEPS); 64 rows raise, naming the limit;
  - the narrow Gemma-3 (local and global layers over a wrapped ring) and
    Gemma-2 (softcaps) loaded on the card: bit-equal parameters and logits
    within 1e-4 (f32) / 2e-2 (q4_k) of the CPU's logit scale."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

D = 256


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


# (heads, T, S, n_past, n_tokens, window, softcap)
G3, G1 = (16, 8), (4, 1)
K3_CASES = [
    (G3, 128, 1024, 0, 128, 0, 0.0),
    (G3, 128, 1024, 0, 100, 0, 0.0),
    (G3, 512, 8192, 1001, 512, 1024, 0.0),
    (G3, 128, 1024, 64, 128, 0, 50.0),
    (G3, 256, 8192, 7000, 256, 0, 0.0),
    (G1, 200, 2048, 37, 180, 300, 50.0),
]


@pytest.mark.parametrize("dtypes", ["bf16", "f32", "f32q"])
@pytest.mark.parametrize("case", range(len(K3_CASES)))
def test_flash_attention_d256_matches_plain(dev, case, dtypes):
    import chip_smoke
    from chatllm_tpu_torch.ops.cuda.flash import flash_attention

    qdt, dt = {"bf16": (torch.bfloat16, torch.bfloat16), "f32": (torch.float32, torch.float32),
               "f32q": (torch.float32, torch.bfloat16)}[dtypes]
    (Hq, Hkv), T, S, n_past, n_tok, win, cap = K3_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(case)
    q = torch.randn(1, T, Hq, D, generator=gen, device=dev).to(qdt)
    k = torch.zeros(1, S, Hkv, D, device=dev, dtype=dt)
    v = torch.zeros_like(k)
    kv_len = n_past + n_tok
    k[:, :kv_len] = torch.randn(1, kv_len, Hkv, D, generator=gen, device=dev).to(dt)
    v[:, :kv_len] = torch.randn(1, kv_len, Hkv, D, generator=gen, device=dev).to(dt)
    kw = dict(scale=D ** -0.5, causal=True, sliding_window=win, logit_softcap=cap)
    o = flash_attention(q, k, v, n_past, n_tok, **kw)
    assert torch.equal(flash_attention(q, k, v, n_past, n_tok, **kw), o)
    err, scaled = chip_smoke.flash_errors(o, q, k, v, n_past, n_tok, **kw)
    assert o.dtype == qdt and torch.isfinite(o).all()
    assert err <= chip_smoke.FLASH_ATOL and scaled <= chip_smoke.FLASH_SCALED_TOL[dt]


# (B, T, Hq, Hkv, n_past, cache, extra); S 8192
K4_CASES = [
    (1, 1, 16, 8, [5000], "int8", {}),
    (2, 1, 16, 8, [100, 6000], "int8", {}),
    (1, 1, 16, 8, [8000], "int8", {"sliding_window": 4096, "logit_softcap": 50.0}),
    (1, 2, 16, 8, [3000], "int8", {"sinks": True}),
    (1, 1, 16, 8, [3000], "bfloat16", {}),
    (2, 4, 16, 8, [33, 7000], "float32", {"logit_softcap": 50.0}),
    (1, 8, 4, 1, [2000], "float32", {"sliding_window": 1024}),   # 32 rows, 32-key tiles
    (1, 8, 4, 1, [1000], "int8", {}),                       # 32 rows per kv head
    (1, 8, 4, 1, [4095], "bfloat16", {"sinks": True}),
    (1, 1, 16, 8, [0], "int8", {}),                         # one live key
]


def _k4_inputs(dev, case, dots):
    from chatllm_tpu_torch.ops.attention import quantize_kv

    B, T, Hq, Hkv, n_past, cache, extra = K4_CASES[case]
    S = 8192
    gen = torch.Generator(device=dev).manual_seed(100 + case)
    q = torch.randn(B, T, Hq, D, generator=gen, device=dev).to(
        torch.float32 if dots == "float32" else torch.bfloat16)
    k = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
    v = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
    kw = dict(scale=D ** -0.5, sliding_window=extra.get("sliding_window", 0),
              logit_softcap=extra.get("logit_softcap", 0.0))
    if extra.get("sinks"):
        kw["sinks"] = torch.randn(Hq, generator=gen, device=dev)
    if cache == "int8":
        (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_kv(k), quantize_kv(v)
    else:
        k, v = k.to(getattr(torch, cache)), v.to(getattr(torch, cache))
    return q, k, v, torch.tensor(n_past, dtype=torch.int64, device=dev), T, kw


@pytest.mark.parametrize("dots", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", range(len(K4_CASES)))
def test_flash_decode_d256_matches_plain(dev, case, dots):
    import chip_smoke
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode

    q, k, v, npv, T, kw = _k4_inputs(dev, case, dots)
    o = flash_decode(q, k, v, npv, T, qk_dtype=dots, **kw)
    assert torch.equal(flash_decode(q, k, v, npv, T, qk_dtype=dots, **kw), o)
    err, scaled = chip_smoke.flash_decode_errors(o, q, k, v, npv, T, qk_dtype=dots, **kw)
    assert o.dtype == q.dtype and torch.isfinite(o).all()
    assert err <= chip_smoke.DECODE_ATOL and scaled <= chip_smoke.DECODE_SCALED_TOL[dots]


@pytest.mark.parametrize("case", [i for i, c in enumerate(K4_CASES) if c[5] == "int8"])
def test_flash_decode_d256_int8_dots_match_plain(dev, case):
    import chip_smoke
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode

    q, k, v, npv, T, kw = _k4_inputs(dev, case, "bfloat16")
    o = flash_decode(q, k, v, npv, T, qk_dtype="int8", **kw)
    assert torch.equal(flash_decode(q, k, v, npv, T, qk_dtype="int8", **kw), o)
    _, steps = chip_smoke.flash_decode_int8_errors(o, q, k, v, npv, T, **kw)
    assert torch.isfinite(o).all() and steps <= chip_smoke.DECODE_INT8_STEPS


def test_flash_decode_d256_refuses_64_rows(dev):
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode

    q = torch.randn(1, 8, 8, D, device=dev, dtype=torch.bfloat16)        # G 8 x T 8
    (k, ks), (v, vs) = (quantize_kv(torch.randn(1, 1024, 1, D, device=dev)) for _ in range(2))
    with pytest.raises(ValueError, match="32 at D 256"):
        flash_decode(q, k, v, 500, 8, scale=0.0625, k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("fmt", ["f32", "q4_k"])
@pytest.mark.parametrize("fam", ["gemma3", "gemma2"])
def test_narrow_gemma_card_matches_cpu(dev, tmp_path, fam, fmt):
    """The narrow GGMM on the card and on the CPU: bit-equal parameters, the
    logits of a prompt that wraps the local layer's 576-slot ring (in chunks
    of SWA_EXTRA) and of one decode step within 1e-4 (f32) / 2e-2 (q4_k) of
    the CPU's logit scale, the argmax equal where clear."""
    import chip_smoke
    from chatllm_tpu_torch.models import RuntimeConfig, load_model

    path = chip_smoke.write_family_ggmm(tmp_path / f"{fam}.bin", fam,
                                        dtype=0 if fmt == "f32" else None, seed=11)
    compute = "float32" if fmt == "f32" else "bfloat16"
    rt = RuntimeConfig(compute_dtype=compute, cache_dtype=compute)
    card, cpu = load_model(str(path), rt, device=dev), load_model(str(path), rt, device="cpu")
    assert card.cfg == cpu.cfg and card.cfg.resolved_head_dim() == D
    chip_smoke.same_params(card.params, cpu.params)
    ids = np.random.default_rng(2).integers(0, 380, chip_smoke.FAMILY_RING_PROMPT).tolist()
    (gf, gs, _), (cf, cs, _) = (chip_smoke._family_logits(m, ids) for m in (card, cpu))
    g, c = torch.cat([gf, gs[None]]), torch.cat([cf, cs[None]])
    tol = chip_smoke.FAMILY_TOL[fmt]
    r = chip_smoke.row_logit_errors(g, c, tol)
    assert torch.isfinite(g).all() and r["rel_to_logit_scale"] <= tol
    assert r["argmax_equal_where_clear"]
