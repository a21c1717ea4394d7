"""The port's CUDA kernels on the card, against their plain versions, at
small shapes.  Marked `cuda`: they skip where no GPU is present (the
kernels have no CPU mode).  On a GPU machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _weights(fmt, K, N, gen, dev):
    import chip_smoke

    return chip_smoke.quant_weight(fmt, K, N, gen, dev)


@pytest.mark.parametrize("fmt", ["q4_k", "q8_0", "q4_0", "q4_1"])
@pytest.mark.parametrize("rows", [1, 2, 17, 37, 64])
def test_quantized_matmul_kernels(dev, fmt, rows):
    from chatllm_tpu_torch.ops.cuda.build import KERNELS
    from chatllm_tpu_torch.ops.cuda.gemv_kernel import qgemv, qgemv_plain
    from chatllm_tpu_torch.ops.cuda.qmm_kernel import qmm, qmm_plain

    gen = torch.Generator(device=dev).manual_seed(rows)
    lin = _weights(fmt, 512, 384, gen, dev)
    kw = dict(group=lin.group_size, packed=lin.packed, zero_point=lin.zero_point,
              d=lin.d, dm=lin.dm, sb=lin.sb)
    x = torch.randn(rows, 512, generator=gen, device=dev).to(torch.bfloat16)
    kern, plain, name = (qgemv, qgemv_plain, "qgemv") if rows == 1 else (qmm, qmm_plain, "qmm")
    before = KERNELS[name].launches
    y = kern(x, lin.q, lin.s, lin.b, lin.bias, **kw)
    ref = plain(x, lin.q, lin.s, lin.b, lin.bias, **kw)
    torch.cuda.synchronize()
    assert KERNELS[name].launches == before + 1
    tol = 1e-4 if rows == 1 else 2e-2       # K1 computes in f32, K2 in bf16
    assert (y - ref).abs().max().item() <= tol * ref.abs().max().item()
    if rows > 1:   # the kernel computes in bf16 only: another dtype raises
        with pytest.raises(TypeError):
            qmm(x, lin.q, lin.s, lin.b, lin.bias, compute_dtype=torch.float32, **kw)


@pytest.mark.parametrize("T,S,n_past,n_tokens,window,softcap", [
    (128, 1024, 0, 128, 0, 0.0), (128, 1024, 0, 100, 0, 0.0),
    (192, 1024, 300, 192, 64, 0.0), (128, 1024, 64, 128, 0, 30.0)])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_kernel(dev, T, S, n_past, n_tokens, window, softcap, D, dtype):
    import chip_smoke
    from chatllm_tpu_torch.ops.cuda.build import KERNELS
    from chatllm_tpu_torch.ops.cuda.flash import flash_attention

    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(T + D)
    q = torch.randn(1, T, 8, D, generator=gen, device=dev).to(dt)
    k = torch.randn(1, S, 2, D, generator=gen, device=dev).to(dt)
    v = torch.randn(1, S, 2, D, generator=gen, device=dev).to(dt)
    kw = dict(scale=D ** -0.5, causal=True, sliding_window=window, logit_softcap=softcap)
    before = KERNELS["flash_attention"].launches
    o = flash_attention(q, k, v, n_past, n_tokens, **kw)
    assert KERNELS["flash_attention"].launches == before + 1 and o.dtype == dt
    err, scaled = chip_smoke.flash_errors(o, q, k, v, n_past, n_tokens, **kw)
    assert err <= chip_smoke.FLASH_ATOL and scaled <= chip_smoke.FLASH_SCALED_TOL[dt]


# card vs CPU logits, relative to the logit scale: the quantized matmuls
# take bf16 inputs in both modes, so summation-order differences flip some
# bf16 roundings of activations and compound over the layers
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 2e-2)])
def test_tiny_model_card_matches_cpu(dev, tmp_path, dtype, tol):
    import chip_smoke
    from chatllm_tpu_torch.models import RuntimeConfig, load_model

    path = chip_smoke.write_llama3_ggmm(tmp_path / "m.bin")
    rt = RuntimeConfig(compute_dtype=dtype, cache_dtype=dtype)
    card = load_model(str(path), rt, device=dev)
    cpu = load_model(str(path), rt, device="cpu")
    ids = card.tokenizer.encode("Hello from the card")
    lc = card.engine.prefill(ids, card.engine.new_cache(1, 64), 0)[0].float().cpu()
    lp = cpu.engine.prefill(ids, cpu.engine.new_cache(1, 64), 0)[0].float()
    np.testing.assert_allclose(lc.numpy(), lp.numpy(), atol=tol * lp.abs().max().item())


@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_f32_query_bf16_cache(dev, D):
    """An f32 query over a bf16 cache (--compute_dtype f32 --cache_dtype
    bf16): f32 scores, probabilities rounded to bf16, f32 output."""
    import chip_smoke
    from chatllm_tpu_torch.ops.cuda.build import KERNELS
    from chatllm_tpu_torch.ops.cuda.flash import flash_attention

    gen = torch.Generator(device=dev).manual_seed(D)
    q = torch.randn(1, 128, 8, D, generator=gen, device=dev)
    k = torch.randn(1, 1024, 2, D, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(1, 1024, 2, D, generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(scale=D ** -0.5, causal=True, sliding_window=0, logit_softcap=0.0)
    before = KERNELS["flash_attention"].launches
    o = flash_attention(q, k, v, 700, 128, **kw)
    assert KERNELS["flash_attention"].launches == before + 1 and o.dtype == torch.float32
    err, scaled = chip_smoke.flash_errors(o, q, k, v, 700, 128, **kw)
    assert err <= chip_smoke.FLASH_ATOL and scaled <= chip_smoke.FLASH_SCALED_TOL[torch.bfloat16]


FLASH_DECODE_CASES = {   # B, T, Hq, Hkv, D, S, n_past, cache, extra
    "q8_t1": (1, 1, 32, 8, 128, 4096, [1000], "int8", {}),
    "q8_rows": (4, 1, 32, 8, 128, 4096, [10, 1000, 4095, 2000], "int8", {}),
    "q8_t2": (2, 2, 32, 8, 128, 4096, [300, 4000], "int8", {}),
    "window_softcap": (1, 4, 8, 2, 128, 2048, [1500], "int8",
                       dict(sliding_window=256, logit_softcap=30.0)),
    "sinks": (2, 1, 8, 2, 64, 1024, [700, 5], "int8", {"sinks": True}),
    "bf16_cache": (1, 1, 32, 8, 128, 4096, [3000], "bfloat16", {}),
    "f32_cache": (1, 2, 8, 4, 64, 1024, [600], "float32", {}),
    "uneven_rows": (1, 4, 6, 2, 64, 1024, [900], "int8", {}),
}


@pytest.mark.parametrize("qk_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", list(FLASH_DECODE_CASES))
def test_flash_decode_kernel(dev, case, qk_dtype):
    import chip_smoke
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.build import KERNELS
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode

    B, T, Hq, Hkv, D, S, n_past, cache, extra = FLASH_DECODE_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(len(case))
    # bf16 dots take the model's bf16 query; f32 dots an f32 one
    q = torch.randn(B, T, Hq, D, generator=gen, device=dev).to(getattr(torch, qk_dtype))
    k = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
    v = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
    kw = dict(scale=D ** -0.5, qk_dtype=qk_dtype,
              sliding_window=extra.get("sliding_window", 0),
              logit_softcap=extra.get("logit_softcap", 0.0))
    if extra.get("sinks"):
        kw["sinks"] = torch.randn(Hq, generator=gen, device=dev)
    if cache == "int8":
        (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_kv(k), quantize_kv(v)
    else:
        k, v = k.to(getattr(torch, cache)), v.to(getattr(torch, cache))
    npv = torch.tensor(n_past, dtype=torch.int64, device=dev)
    before = KERNELS["flash_decode"].launches
    o = flash_decode(q, k, v, npv, T, **kw)
    assert KERNELS["flash_decode"].launches == before + 1 and o.dtype == q.dtype
    err, scaled = chip_smoke.flash_decode_errors(o, q, k, v, npv, T, **kw)
    assert err <= chip_smoke.DECODE_ATOL and scaled <= chip_smoke.DECODE_SCALED_TOL[qk_dtype]
    if B == 1:   # a scalar n_past takes the same path
        o1 = flash_decode(q, k, v, n_past[0], T, **kw)
        torch.cuda.synchronize()
        assert torch.equal(o1, o)
