"""K3 and K4 at head dims 80 and 96 (Phi-2's and Phi-3's heads) and the
narrow Phi families on the card, against their plain versions and the CPU.
Marked `cuda`: they skip where no GPU is present.  This file imports no JAX
(the GPU machine has none), and the kernel sources are built only inside the
tests.  On a GPU machine:

    python -m pytest -q --noconftest -m cuda tests/test_torch_phi_cuda.py

  - K3 in its three modes (bf16; f32 cache; f32 query over a bf16 cache) at
    D 80 and 96 with Phi-3.5-mini's 32 heads over 32, G 4 over 1 and 2 kv
    heads: a window across key tiles, the softcap 50, a chunk that ends at
    the cache's last slot, T off the 128-row grid; held to chip_smoke's
    limits (FLASH_ATOL and FLASH_SCALED_TOL), a second launch bit-identical;
  - K4 at D 80 and 96 with float dots over int8 / bf16 / f32 caches and
    with int8 dots, scalar and per-row n_past, window, softcap 50, sinks, 64
    rows per kv head (DECODE_ATOL / DECODE_SCALED_TOL; int8 dots within
    DECODE_INT8_STEPS), a second launch bit-identical;
  - head bleed: every kv head's K / V distinct, and the caches views of a
    tensor with one more head after the last whose values are NaN (int8:
    127 with scales of 1e3), so a read past a head's D columns poisons or
    moves the output;
  - any other head dim still raises;
  - the narrow Phi families loaded on the card: bit-equal parameters and
    logits within 1e-4 (f32) / 2e-2 (q4_k) of the CPU's logit scale."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

HEAD_DIMS = (80, 96)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _offsets(n, dev):
    """Each head's own offset, 0 to 0.7 (neighbouring heads differ; the
    values stay O(1), where the limits' absolute term is set)."""
    return (torch.arange(n, device=dev) % 8).view(1, 1, -1, 1) * 0.1


def _heads(hkv, D, gen, dev, S):
    """[1, S, hkv + 1, D] f32 values, head h drawn around its own offset
    (distinct heads; the last is poisoned by `_poisoned`)."""
    full = torch.randn(1, S, hkv + 1, D, generator=gen, device=dev)
    return full + _offsets(hkv + 1, dev)


def _poisoned(full, dt, n_valid):
    """The first heads of `full` in `dt`, rows past n_valid zero, the last
    head NaN: a view with the poisoned head beside each row."""
    x = full.to(dt)
    x[:, n_valid:] = 0
    x[:, :, -1] = float("nan")
    return x[:, :, :-1]


# (heads, T, S, n_past, n_tokens, window, softcap)
PHI35, G4, G4_1 = (32, 32), (8, 2), (4, 1)
K3_CASES = [
    (PHI35, 128, 1024, 0, 128, 0, 0.0),
    (G4, 128, 1024, 0, 100, 0, 0.0),
    (G4, 512, 8192, 1001, 512, 1024, 0.0),
    (G4, 128, 1024, 64, 128, 0, 50.0),
    (PHI35, 200, 4000, 3800, 200, 0, 0.0),
    (G4_1, 1000, 2048, 0, 1000, 300, 50.0),
]


@pytest.mark.parametrize("dtypes", ["bf16", "f32", "f32q"])
@pytest.mark.parametrize("case", range(len(K3_CASES)))
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_attention_d80_96_matches_plain(dev, D, case, dtypes):
    """K3 against its plain twin, the caches views beside a poisoned head."""
    import chip_smoke
    from chatllm_tpu_torch.ops.cuda.flash import flash_attention

    qdt, dt = {"bf16": (torch.bfloat16, torch.bfloat16), "f32": (torch.float32, torch.float32),
               "f32q": (torch.float32, torch.bfloat16)}[dtypes]
    (Hq, Hkv), T, S, n_past, n_tok, win, cap = K3_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(case + D)
    q = torch.randn(1, T, Hq, D, generator=gen, device=dev).to(qdt)
    kv_len = n_past + n_tok
    k = _poisoned(_heads(Hkv, D, gen, dev, S), dt, kv_len)
    v = _poisoned(_heads(Hkv, D, gen, dev, S), dt, kv_len)
    kw = dict(scale=D ** -0.5, causal=True, sliding_window=win, logit_softcap=cap)
    o = flash_attention(q, k, v, n_past, n_tok, **kw)
    assert torch.equal(flash_attention(q, k, v, n_past, n_tok, **kw), o)
    assert o.dtype == qdt and torch.isfinite(o).all()
    err, scaled = chip_smoke.flash_errors(o, q, k.contiguous(), v.contiguous(), n_past, n_tok,
                                          **kw)
    assert err <= chip_smoke.FLASH_ATOL and scaled <= chip_smoke.FLASH_SCALED_TOL[dt]


# (B, T, Hq, Hkv, n_past, cache, extra); S 8192
K4_CASES = [
    (1, 1, 32, 32, [1000], "int8", {}),
    (2, 1, 32, 32, [100, 6000], "int8", {}),
    (1, 1, 8, 2, [8000], "int8", {"sliding_window": 4096, "logit_softcap": 50.0}),
    (1, 2, 8, 2, [3000], "int8", {"sinks": True}),
    (1, 1, 32, 32, [3000], "bfloat16", {}),
    (2, 4, 8, 2, [33, 7000], "float32", {"logit_softcap": 50.0}),
    (1, 8, 8, 1, [2000], "float32", {"sliding_window": 1024}),      # 64 rows a kv head
    (1, 8, 8, 1, [1000], "int8", {}),                                # 64 rows a kv head
    (1, 8, 4, 1, [4095], "bfloat16", {"sinks": True}),               # 32 rows
    (1, 1, 4, 2, [0], "int8", {}),                                   # one live key
]


def _k4_inputs(dev, D, case, dots):
    """q, the caches (views beside a poisoned head: NaN for a float cache,
    127 with scales of 1e3 for the q8 one), per-row n_past, T, kwargs."""
    from chatllm_tpu_torch.ops.attention import quantize_kv

    B, T, Hq, Hkv, n_past, cache, extra = K4_CASES[case]
    S = 8192
    gen = torch.Generator(device=dev).manual_seed(100 + case + D)
    q = torch.randn(B, T, Hq, D, generator=gen, device=dev).to(
        torch.float32 if dots == "float32" else torch.bfloat16)
    kw = dict(scale=D ** -0.5, sliding_window=extra.get("sliding_window", 0),
              logit_softcap=extra.get("logit_softcap", 0.0))
    if extra.get("sinks"):
        kw["sinks"] = torch.randn(Hq, generator=gen, device=dev)
    caches = []
    for name in ("k", "v"):
        full = torch.randn(B, S, Hkv + 1, D, generator=gen, device=dev) + _offsets(Hkv + 1, dev)
        if cache == "int8":
            x, sc = quantize_kv(full)
            x[:, :, -1], sc[:, :, -1] = 127, 1e3
            caches.append(x[:, :, :-1])
            kw[f"{name}_scale"] = sc[:, :, :-1]
        else:
            x = full.to(getattr(torch, cache))
            x[:, :, -1] = float("nan")
            caches.append(x[:, :, :-1])
    return q, caches[0], caches[1], torch.tensor(n_past, dtype=torch.int64, device=dev), T, kw


def _dense(kw):
    return {n: (x.contiguous() if isinstance(x, torch.Tensor) else x) for n, x in kw.items()}


@pytest.mark.parametrize("dots", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", range(len(K4_CASES)))
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_decode_d80_96_matches_plain(dev, D, case, dots):
    import chip_smoke
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode

    q, k, v, npv, T, kw = _k4_inputs(dev, D, case, dots)
    o = flash_decode(q, k, v, npv, T, qk_dtype=dots, **kw)
    assert torch.equal(flash_decode(q, k, v, npv, T, qk_dtype=dots, **kw), o)
    assert o.dtype == q.dtype and torch.isfinite(o).all()
    err, scaled = chip_smoke.flash_decode_errors(o, q, k.contiguous(), v.contiguous(), npv, T,
                                                 qk_dtype=dots, **_dense(kw))
    assert err <= chip_smoke.DECODE_ATOL and scaled <= chip_smoke.DECODE_SCALED_TOL[dots]


@pytest.mark.parametrize("case", [i for i, c in enumerate(K4_CASES) if c[5] == "int8"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_decode_d80_96_int8_dots_match_plain(dev, D, case):
    import chip_smoke
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode

    q, k, v, npv, T, kw = _k4_inputs(dev, D, case, "bfloat16")
    o = flash_decode(q, k, v, npv, T, qk_dtype="int8", **kw)
    assert torch.equal(flash_decode(q, k, v, npv, T, qk_dtype="int8", **kw), o)
    assert torch.isfinite(o).all()
    _, steps = chip_smoke.flash_decode_int8_errors(o, q, k.contiguous(), v.contiguous(), npv, T,
                                                   **_dense(kw))
    assert steps <= chip_smoke.DECODE_INT8_STEPS


@pytest.mark.parametrize("D", [72, 112, 160])
def test_other_head_dims_still_raise(dev, D):
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.flash import flash_attention
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode

    q = torch.randn(1, 128, 4, D, device=dev, dtype=torch.bfloat16)
    k = torch.randn(1, 1024, 2, D, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D="):
        flash_attention(q, k, k, 0, 128, scale=D ** -0.5)
    (k8, ks), (v8, vs) = (quantize_kv(torch.randn(1, 1024, 2, D, device=dev)) for _ in range(2))
    with pytest.raises(ValueError, match="need D = Dv in"):
        flash_decode(q[:, :1], k8, v8, 500, 1, scale=D ** -0.5, k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("fmt", ["f32", "q4_k"])
@pytest.mark.parametrize("fam", ["phi2", "phi2_v1", "phi3", "phi3_su2", "phi4"])
def test_narrow_phi_card_matches_cpu(dev, tmp_path, fam, fmt):
    """The narrow GGMM on the card and on the CPU: bit-equal parameters, the
    logits of a 32-token prompt and of one decode step within 1e-4 (f32) /
    2e-2 (q4_k) of the CPU's logit scale, the argmax equal where clear."""
    import chip_smoke
    from chatllm_tpu_torch.models import RuntimeConfig, load_model

    path = chip_smoke.write_family_ggmm(tmp_path / f"{fam}.bin", fam,
                                        dtype=0 if fmt == "f32" else None, seed=11)
    compute = "float32" if fmt == "f32" else "bfloat16"
    rt = RuntimeConfig(compute_dtype=compute, cache_dtype=compute)
    card, cpu = load_model(str(path), rt, device=dev), load_model(str(path), rt, device="cpu")
    assert card.cfg == cpu.cfg and type(card) is type(cpu)
    chip_smoke.same_params(card.params, cpu.params)
    ids = np.random.default_rng(2).integers(0, 379, chip_smoke.FAMILY_PROMPT).tolist()
    (gf, gs, _), (cf, cs, _) = (chip_smoke._family_logits(m, ids) for m in (card, cpu))
    g, c = torch.cat([gf, gs[None]]), torch.cat([cf, cs[None]])
    tol = chip_smoke.FAMILY_TOL[fmt]
    r = chip_smoke.row_logit_errors(g, c, tol)
    assert torch.isfinite(g).all() and r["rel_to_logit_scale"] <= tol
    assert r["argmax_equal_where_clear"]
