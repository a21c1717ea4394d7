"""K1, K2 and K4 at GPT-OSS-20B's shapes, attention's sinks route and the
narrow GPT_OSS GGMM on the card, against their plain versions and the CPU.  Marked
`cuda`: they skip where no GPU is present.  This file imports no JAX (the
GPU machine has none), and the kernel sources are built only inside the
tests.  On a GPU machine:

    python -m pytest -q --noconftest -m cuda tests/test_torch_gpt_oss_cuda.py

  - K1 and K2 at GPT-OSS-20B's q8_0 projections (K 2880: q N 4096, k / v
    N 512, the 201088-row head); K1 within 1e-4 and K2 within 2e-2 of the
    output scale (chip_smoke's limits), a second launch bit-identical;
  - K4 with sinks at 64 query heads over 8 kv heads of 64 (the f32 dots of
    the route, and bf16 dots) over a q8 and a bf16 cache, once and per row
    (DECODE_* limits), a second launch bit-identical, and the sinks moving
    the output below 4096 live keys;
  - `attention_with_cache` with sinks on the card taking K4 over a long q8
    cache and never K3 over a long prefill chunk, within the card's plain
    routes;
  - the narrow GPT_OSS loaded on the card: bit-equal parameters and logits
    of a prompt that wraps the ring within 1e-4 (f32) / 2e-2 (q4_k) of the
    CPU's logit scale where the expert picks agree."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

GO = (64, 8, 64)                   # query heads, kv heads, head dim


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rows", [1, 2, 37, 64])
@pytest.mark.parametrize("shape", ["q", "k_v", "lm_head"])
def test_gpt_oss_projections_match_plain(dev, shape, rows):
    import chip_smoke
    from chatllm_tpu_torch.ops.cuda.gemv_kernel import qgemv, qgemv_plain
    from chatllm_tpu_torch.ops.cuda.qmm_kernel import qmm, qmm_plain

    K, N, fmt = chip_smoke.SHAPES_GO[shape]
    gen = torch.Generator(device=dev).manual_seed(rows)
    lin = chip_smoke.quant_weight(fmt, K, N, gen, dev)
    x = torch.randn(rows, K, generator=gen, device=dev).to(torch.bfloat16)
    kern, plain, tol = (qgemv, qgemv_plain, 1e-4) if rows == 1 else (qmm, qmm_plain, 2e-2)
    res = {"qgemv": {"cases": []}, "qmm": {"cases": []}}
    y = chip_smoke._check_matmul(res, kern.__name__, kern, plain, x, lin, tol, fmt)
    args, kw = chip_smoke.lin_args(lin)
    assert torch.equal(kern(x, *args, **kw), y)


K4_CASES = [  # (B, T, n_past, cache)
    (1, 1, [1064], "int8"),
    (1, 1, [0], "int8"),
    (1, 1, [8191], "int8"),
    (2, 1, [1000, 1100], "int8"),
    (1, 1, [3000], "bfloat16"),
]


@pytest.mark.parametrize("dots", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(K4_CASES)))
def test_flash_decode_with_sinks_matches_plain(dev, case, dots):
    import chip_smoke
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode

    (Hq, Hkv, D), S = GO, 8192
    B, T, n_past, cache = K4_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(300 + case)
    q = torch.randn(B, T, Hq, D, generator=gen, device=dev).to(getattr(torch, dots))
    k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev) for _ in range(2))
    kw = dict(scale=D ** -0.5, qk_dtype=dots,
              sinks=2.0 * torch.randn(Hq, generator=gen, device=dev))
    if cache == "int8":
        (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_kv(k), quantize_kv(v)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    npv = torch.tensor(n_past, dtype=torch.int64, device=dev)
    o = flash_decode(q, k, v, npv, T, **kw)
    assert torch.equal(flash_decode(q, k, v, npv, T, **kw), o)
    err, scaled = chip_smoke.flash_decode_errors(o, q, k, v, npv, T, **kw)
    assert o.dtype == q.dtype and torch.isfinite(o).all()
    assert err <= chip_smoke.DECODE_ATOL and scaled <= chip_smoke.DECODE_SCALED_TOL[dots]
    if max(n_past) < 4096:
        # the sinks weigh against up to a few thousand keys: the output moves
        # (over 8192 keys a sink's share of the denominator is ~1e-3)
        bare = flash_decode(q, k, v, npv, T, **dict(kw, sinks=None))
        assert (bare.float() - o.float()).abs().max() > 1e-3


def test_attention_with_sinks_routes_on_the_card(dev):
    """A q8 decode step over 8192 slots takes K4 with the sinks; a 512-row
    prefill chunk over a bf16 cache of 8192 slots does not take K3 (the
    einsum, as in the JAX package); both agree with the plain routes of
    the same inputs on the card within the K4 / einsum roundings."""
    from chatllm_tpu_torch.ops import attention as A
    from chatllm_tpu_torch.ops.cuda.build import KERNELS, launch_counts, reset_launch_counts
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode_plain

    (Hq, Hkv, D), S = GO, 8192
    gen = torch.Generator(device=dev).manual_seed(7)
    sinks = torch.randn(Hq, generator=gen, device=dev)
    q = torch.randn(1, 1, Hq, D, generator=gen, device=dev)
    (k, ks), (v, vs) = (A.quantize_kv(torch.randn(1, S, Hkv, D, generator=gen, device=dev))
                        for _ in range(2))
    KERNELS["flash_decode"]._load()
    reset_launch_counts()
    o = A.attention_with_cache(q, k, v, 3000, 1, scale=0.125, sinks=sinks, k_scale=ks,
                               v_scale=vs)
    assert launch_counts()["flash_decode"] == 1
    ref = flash_decode_plain(q, k, v, 3000, 1, scale=0.125, sinks=sinks, k_scale=ks, v_scale=vs)
    assert (o - ref).abs().max() <= 1e-4 * ref.abs().max()
    T = 512
    qp = torch.randn(1, T, Hq, D, generator=gen, device=dev)
    kb = torch.randn(1, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    vb = torch.randn(1, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    reset_launch_counts()
    out = A.attention_with_cache(qp, kb, vb, 488, T, scale=0.125, sinks=sinks)
    assert launch_counts()["flash_attention"] == 0
    cpu = A.attention_with_cache(qp.cpu(), kb.cpu(), vb.cpu(), 488, T, scale=0.125,
                                 sinks=sinks.cpu())
    assert (out.cpu() - cpu).abs().max() <= 1e-4 * cpu.abs().max()


@pytest.mark.parametrize("fmt", ["f32", "q4_k"])
def test_narrow_gpt_oss_card_matches_cpu(dev, tmp_path, fmt):
    """The narrow GGMM on the card and on the CPU: bit-equal parameters, the
    logits of a 640-token prompt (which wraps the 576-slot ring) and of one
    decode step within 1e-4 (f32) / 2e-2 (q4_k) of the CPU's logit scale at
    the positions whose expert picks agree (all of them in f32, at least
    FAMILY_PICKS_AGREE_MIN in q4_k), the argmax equal where clear."""
    import chip_smoke
    from chatllm_tpu_torch.models import RuntimeConfig, load_model

    path = chip_smoke.write_family_ggmm(tmp_path / f"go_{fmt}.bin", "gpt_oss",
                                        dtype=0 if fmt == "f32" else None, seed=11)
    compute = "float32" if fmt == "f32" else "bfloat16"
    rt = RuntimeConfig(compute_dtype=compute, cache_dtype=compute)
    card, cpu = load_model(str(path), rt, device=dev), load_model(str(path), rt, device="cpu")
    assert card.cfg == cpu.cfg and type(card) is type(cpu)
    chip_smoke.same_params(card.params, cpu.params)
    ids = np.random.default_rng(2).integers(0, 380, chip_smoke.FAMILY_RING_PROMPT).tolist()
    (gf, gs, gp), (cf, cs, cp) = (chip_smoke._family_logits(m, ids) for m in (card, cpu))
    agree = torch.ones(len(ids), dtype=torch.bool)
    for a, b in zip(gp, cp):
        agree &= (a == b).all(dim=-1)
    assert agree.float().mean() >= (1.0 if fmt == "f32" else chip_smoke.FAMILY_PICKS_AGREE_MIN)
    g, c = torch.cat([gf[agree], gs[None]]), torch.cat([cf[agree], cs[None]])
    tol = chip_smoke.FAMILY_TOL[fmt]
    r = chip_smoke.row_logit_errors(g, c, tol)
    assert torch.isfinite(g).all() and r["rel_to_logit_scale"] <= tol
    assert r["argmax_equal_where_clear"]
