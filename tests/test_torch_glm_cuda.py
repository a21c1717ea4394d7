"""K1-K4 at GLM-4-9B's shapes and the narrow GLM families on the card,
against their plain versions and the CPU.  Marked `cuda`: they skip where no
GPU is present.  This file imports no JAX (the GPU machine has none), and
the kernel sources are built only inside the tests.  On a GPU machine:

    python -m pytest -q --noconftest -m cuda tests/test_torch_glm_cuda.py

  - K1 and K2 at GLM-4-9B's projections: the q8_0 down at K 13696 (428
    groups, 107 of K2's 128-row stages), the fused qkv N 4608 and gate_up N
    27392 and the 151552-row head in q4_k; K1 within 1e-4 and K2 within
    2e-2 of the output scale (chip_smoke's limits), a second launch
    bit-identical;
  - K3 in mode 2 (an f32 query over a bf16 cache, the chat path's) and K4
    (bf16 and f32 dots over a q8 cache) at 32 query heads over 2 kv heads
    (FLASH_* / DECODE_* limits), a second launch bit-identical;
  - the narrow GLM-4 and GLM-4-0414 loaded on the card: bit-equal
    parameters and logits within 1e-4 (f32) / 2e-2 (q4_k) of the CPU's
    logit scale."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rows", [1, 2, 37, 64])
@pytest.mark.parametrize("shape", ["qkv", "gate_up", "down", "lm_head"])
def test_glm_projections_match_plain(dev, shape, rows):
    import chip_smoke
    from chatllm_tpu_torch.ops.cuda.gemv_kernel import qgemv, qgemv_plain
    from chatllm_tpu_torch.ops.cuda.qmm_kernel import qmm, qmm_plain

    K, N, fmt = chip_smoke.SHAPES_GLM[shape]
    gen = torch.Generator(device=dev).manual_seed(rows)
    lin = chip_smoke.quant_weight(fmt, K, N, gen, dev)
    x = torch.randn(rows, K, generator=gen, device=dev).to(torch.bfloat16)
    kern, plain, tol = (qgemv, qgemv_plain, 1e-4) if rows == 1 else (qmm, qmm_plain, 2e-2)
    res = {"qgemv": {"cases": []}, "qmm": {"cases": []}}
    y = chip_smoke._check_matmul(res, kern.__name__, kern, plain, x, lin, tol, fmt)
    args, kw = chip_smoke.lin_args(lin)
    assert torch.equal(kern(x, *args, **kw), y)


GL = (32, 2)
K3_CASES = [  # (T, S, n_past, n_tokens)
    (1024, 8192, 0, 1000),
    (512, 8192, 1001, 500),
    (128, 8192, 8064, 128),
]


@pytest.mark.parametrize("case", range(len(K3_CASES)))
def test_flash_attention_g16_matches_plain(dev, case):
    import chip_smoke
    from chatllm_tpu_torch.ops.cuda.flash import flash_attention

    (Hq, Hkv), D = GL, 128
    T, S, n_past, n_tok = K3_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(case)
    q = torch.randn(1, T, Hq, D, generator=gen, device=dev)
    k = torch.zeros(1, S, Hkv, D, device=dev, dtype=torch.bfloat16)
    v = torch.zeros_like(k)
    kv_len = n_past + n_tok
    k[:, :kv_len] = torch.randn(1, kv_len, Hkv, D, generator=gen, device=dev).to(k.dtype)
    v[:, :kv_len] = torch.randn(1, kv_len, Hkv, D, generator=gen, device=dev).to(v.dtype)
    kw = dict(scale=D ** -0.5, causal=True)
    o = flash_attention(q, k, v, n_past, n_tok, **kw)
    assert torch.equal(flash_attention(q, k, v, n_past, n_tok, **kw), o)
    err, scaled = chip_smoke.flash_errors(o, q, k, v, n_past, n_tok, **kw)
    assert o.dtype == q.dtype and torch.isfinite(o).all()
    assert err <= chip_smoke.FLASH_ATOL and scaled <= chip_smoke.FLASH_SCALED_TOL[torch.bfloat16]


K4_CASES = [  # (B, T, n_past)
    (1, 1, [1064]),
    (1, 1, [0]),
    (2, 1, [1000, 2100]),
    (1, 2, [6000]),
]


@pytest.mark.parametrize("dots", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", range(len(K4_CASES)))
def test_flash_decode_g16_matches_plain(dev, case, dots):
    import chip_smoke
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode

    (Hq, Hkv), D, S = GL, 128, 8192
    B, T, n_past = K4_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(200 + case)
    q = torch.randn(B, T, Hq, D, generator=gen, device=dev).to(getattr(torch, dots))
    (k, ks), (v, vs) = (quantize_kv(torch.randn(B, S, Hkv, D, generator=gen, device=dev))
                        for _ in range(2))
    npv = torch.tensor(n_past, dtype=torch.int64, device=dev)
    kw = dict(scale=D ** -0.5, qk_dtype=dots, k_scale=ks, v_scale=vs)
    o = flash_decode(q, k, v, npv, T, **kw)
    assert torch.equal(flash_decode(q, k, v, npv, T, **kw), o)
    err, scaled = chip_smoke.flash_decode_errors(o, q, k, v, npv, T, **kw)
    assert o.dtype == q.dtype and torch.isfinite(o).all()
    assert err <= chip_smoke.DECODE_ATOL and scaled <= chip_smoke.DECODE_SCALED_TOL[dots]


@pytest.mark.parametrize("fmt", ["f32", "q4_k"])
@pytest.mark.parametrize("fam", ["glm4", "glm4_0414"])
def test_narrow_glm_card_matches_cpu(dev, tmp_path, fam, fmt):
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
    ids = np.random.default_rng(2).integers(0, 380, chip_smoke.FAMILY_PROMPT).tolist()
    (gf, gs, _), (cf, cs, _) = (chip_smoke._family_logits(m, ids) for m in (card, cpu))
    g, c = torch.cat([gf, gs[None]]), torch.cat([cf, cs[None]])
    tol = chip_smoke.FAMILY_TOL[fmt]
    r = chip_smoke.row_logit_errors(g, c, tol)
    assert torch.isfinite(g).all() and r["rel_to_logit_scale"] <= tol
    assert r["argmax_equal_where_clear"]
