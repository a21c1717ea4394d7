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
@pytest.mark.parametrize("rows", [1, 2, 17, 32, 37, 64])
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


QWEN_SHAPES = [(896, 896), (896, 128), (896, 4864), (4864, 896)]


@pytest.mark.parametrize("fmt", ["q4_k", "q8_0", "q4_0", "q4_1"])
@pytest.mark.parametrize("rows", [2, 17, 32, 37, 64])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_qmm_decode_kernel(dev, fmt, rows, with_bias):
    """K5 against its plain version (the same roundings; summation order
    and the bf16 rounding of sums that land on a tie differ): 2e-2 of the
    output scale, as for K2."""
    from chatllm_tpu_torch.ops.cuda.build import KERNELS
    from chatllm_tpu_torch.ops.cuda.qmm_decode import qmm_decode, qmm_decode_plain

    gen = torch.Generator(device=dev).manual_seed(rows)
    lin = _weights(fmt, 512, 384, gen, dev)
    kw = dict(group=lin.group_size, packed=lin.packed, zero_point=lin.zero_point,
              d=lin.d, dm=lin.dm, sb=lin.sb)
    bias = torch.randn(384, generator=gen, device=dev) if with_bias else None
    x = torch.randn(rows, 512, generator=gen, device=dev).to(torch.bfloat16)
    before = KERNELS["qmm_decode"].launches
    y = qmm_decode(x, lin.q, lin.s, lin.b, bias, **kw)
    ref = qmm_decode_plain(x, lin.q, lin.s, lin.b, bias, **kw)
    torch.cuda.synchronize()
    assert KERNELS["qmm_decode"].launches == before + 1
    assert (y - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()
    with pytest.raises(TypeError):
        qmm_decode(x, lin.q, lin.s, lin.b, bias, compute_dtype=torch.float32, **kw)


@pytest.mark.parametrize("K,N", QWEN_SHAPES)
@pytest.mark.parametrize("rows", [1, 7, 64])
def test_quantized_matmuls_at_qwen_shapes(dev, K, N, rows):
    """K1, K2 and K5 at the Qwen2.5-0.5B projection shapes: q8_0 (unpacked
    int8), a bias, K = 896 and 4864 (28 and 152 groups)."""
    from chatllm_tpu_torch.ops.cuda.gemv_kernel import qgemv, qgemv_plain
    from chatllm_tpu_torch.ops.cuda.qmm_decode import qmm_decode, qmm_decode_plain
    from chatllm_tpu_torch.ops.cuda.qmm_kernel import qmm, qmm_plain

    gen = torch.Generator(device=dev).manual_seed(K + rows)
    lin = _weights("q8_0", K, N, gen, dev)
    kw = dict(group=lin.group_size, packed=lin.packed, zero_point=lin.zero_point,
              d=lin.d, dm=lin.dm, sb=lin.sb)
    bias = torch.randn(N, generator=gen, device=dev)
    x = torch.randn(rows, K, generator=gen, device=dev).to(torch.bfloat16)
    pairs = [(qgemv, qgemv_plain, 1e-4)] if rows == 1 else [(qmm, qmm_plain, 2e-2),
                                                            (qmm_decode, qmm_decode_plain, 2e-2)]
    for kern, plain, tol in pairs:
        y = kern(x, lin.q, lin.s, lin.b, bias, **kw)
        ref = plain(x, lin.q, lin.s, lin.b, bias, **kw)
        torch.cuda.synchronize()
        assert (y - ref).abs().max().item() <= tol * ref.abs().max().item(), kern.__name__


def test_read_sum_kernel(dev):
    """K6: the byte sum is exact (integer adds, one conversion to f32)."""
    from chatllm_tpu_torch.ops.cuda.build import KERNELS
    from chatllm_tpu_torch.ops.cuda.bw_probe import read_sum, read_sum_plain

    gen = torch.Generator(device=dev).manual_seed(6)
    for nbytes in (16, 4096 + 16, 8 << 20):
        q = torch.randint(0, 256, (nbytes,), generator=gen, device=dev, dtype=torch.uint8)
        c = torch.tensor([3.5], device=dev)
        before = KERNELS["bw_probe"].launches
        got = read_sum(q, c, reps=3)
        assert KERNELS["bw_probe"].launches == before + 1
        assert torch.equal(got, read_sum_plain(q, c))
        assert torch.equal(read_sum(q, c), got)          # the scratch was left zeroed


def test_measure_read_bw_on_the_card(dev):
    from chatllm_tpu_torch.ops.cuda.bw_probe import measure_read_bw

    bw = measure_read_bw(device=dev)
    assert 0.3e12 < bw < 3.35e12, bw     # below the H100's peak, above a third of it


@pytest.mark.parametrize("K,N", [(64, 512), (256, 1024), (4096, 16384), (96, 48)])
def test_gemv_probe_kernels(dev, K, N):
    """E2: stream_once is exact; vpu_once sums in f32 in another order than
    its plain version: 1e-5 of the output scale."""
    from chatllm_tpu_torch.experiments.gemv_probe2 import (stream_once, stream_once_plain,
                                                           vpu_once, vpu_once_plain, weights)
    from chatllm_tpu_torch.ops.cuda.build import KERNELS

    wq, ws = weights(K, N, dev)
    before = KERNELS["gemv_stream"].launches, KERNELS["gemv_vpu"].launches
    assert torch.equal(stream_once(wq), stream_once_plain(wq))
    x = torch.randn(K, 1, generator=torch.Generator(device=dev).manual_seed(K), device=dev)
    y, ref = vpu_once(x, wq, ws), vpu_once_plain(x, wq, ws)
    torch.cuda.synchronize()
    assert (KERNELS["gemv_stream"].launches, KERNELS["gemv_vpu"].launches) == (
        before[0] + 1, before[1] + 1)
    assert y.shape == (N,) and (y - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_dot_f32_keeps_f32_on_the_card(dev):
    """bf16 operands, f32 accumulation, an f32 result that was never
    rounded to bf16 (the tied lm_head, dense linears, the wide dequant
    path); also through a transposed weight, as the tied head passes it."""
    from chatllm_tpu_torch.ops.qmm import dot_f32

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 5, 896, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(1024, 896, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    y = dot_f32(x, w.t())
    ref = x.float() @ w.float().t()
    assert y.dtype == torch.float32 and y.shape == (2, 5, 1024)
    assert (y - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert (y - y.to(torch.bfloat16).float()).abs().max().item() > 0


@pytest.mark.parametrize("K,N,tile_k", [(256, 64, 128), (512, 160, 256), (4096, 1024, 2048),
                                        (14336, 4096, 2048), (8192, 256, 4096)])
def test_gemv_model_kernels(dev, K, N, tile_k):
    """E3, both exact against their plain versions: stream_read's value and
    digest, and qgemv_bf16, which rounds to bf16 in its plain version's
    order."""
    from chatllm_tpu_torch.experiments import gemv_model_bench as e3
    from chatllm_tpu_torch.ops.cuda.build import KERNELS

    gen = torch.Generator(device=dev).manual_seed(K + N)
    q = torch.randint(0, 256, (K // 2, N), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.uint8)
    s = (torch.rand(K // 32, N, generator=gen, device=dev) * 0.01 + 1e-3).half()
    x = torch.randn(1, K, generator=gen, device=dev)
    before = KERNELS["stream_read"].launches, KERNELS["qgemv_bf16"].launches
    (y, dg), (yr, dgr) = e3.stream_read(x, q, s, tile_k=tile_k), e3.stream_read_plain(
        x, q, s, tile_k=tile_k)
    b, br = e3.qgemv_bf16(x, q, s, tile_k=tile_k), e3.qgemv_bf16_plain(x, q, s, tile_k=tile_k)
    torch.cuda.synchronize()
    assert (KERNELS["stream_read"].launches, KERNELS["qgemv_bf16"].launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(y, yr) and torch.equal(dg, dgr)
    assert b.shape == (1, N) and torch.isfinite(b).all() and torch.equal(b, br)


@pytest.mark.parametrize("mode", ["v0", "v1", "v2", "v3"])
@pytest.mark.parametrize("K,N", [(2048, 256), (4096, 14336), (512, 48)])
def test_unpack_gemv_kernel(dev, mode, K, N):
    """E4: 1e-5 of the output scale against its plain version (f32 sums in
    another order), and its check against K1 within 1e-4."""
    from chatllm_tpu_torch.experiments import gemv_unpack as e4
    from chatllm_tpu_torch.models.synthetic import synth_linear
    from chatllm_tpu_torch.ops.cuda.build import KERNELS

    gen = torch.Generator(device=dev).manual_seed(K + N)
    lin = synth_linear(K, N, "q4k", gen=gen, zeros=False, device=dev)
    x = torch.randn(K, generator=gen, device=dev)
    arrays = (lin.q, lin.s, lin.b, lin.d, lin.dm)
    before = KERNELS["unpack_gemv"].launches
    out, ref = e4.unpack_gemv(x, *arrays, mode=mode), e4.unpack_gemv_plain(x, *arrays, mode=mode)
    torch.cuda.synchronize()
    assert KERNELS["unpack_gemv"].launches == before + 1 and out.shape == (8, N)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    if (K, N) == (2048, 256):
        assert e4.check(mode, device=dev) < e4.CHECK_TOL


@pytest.mark.parametrize("R,N,tile_k,tile_n", [(2048, 14336, 1024, 512), (256, 256, 64, 128),
                                               (64, 48, 8, 16)])
def test_qmm_dma_kernel(dev, R, N, tile_k, tile_n):
    """E5: the tile sums are exact (integer adds, one conversion to f32)."""
    from chatllm_tpu_torch.experiments import qmm_m32 as e5
    from chatllm_tpu_torch.ops.cuda.build import KERNELS

    gen = torch.Generator(device=dev).manual_seed(R)
    q = torch.randint(0, 256, (R, N), generator=gen, device=dev, dtype=torch.int32).to(torch.uint8)
    c = torch.tensor([2.5], device=dev)
    before = KERNELS["qmm_dma"].launches
    got = e5.dma_sums(q, c, tile_k=tile_k, tile_n=tile_n)
    assert KERNELS["qmm_dma"].launches == before + 1
    assert torch.equal(got, e5.dma_sums_plain(q, c, tile_k=tile_k, tile_n=tile_n))
    assert torch.equal(e5.dma_sums(q, c, tile_k=tile_k, tile_n=tile_n), got)


def test_stream_max_starts_at_zero(dev):
    """E1/E2: a residue class whose values are all negative gives 0, as the
    Pallas kernel's zeroed accumulator does."""
    from chatllm_tpu_torch.experiments.gemv_probe import stream_max, stream_max_plain

    w = -torch.randint(1, 127, (4096, 14336), device=dev, dtype=torch.int32).to(torch.int8)
    w[:, 16:] = w[:, 16:].abs()
    got = stream_max(w)
    assert torch.equal(got, stream_max_plain(w)) and (got[:, :16] == 0).all()


def test_probe_mains_at_a_small_size(dev):
    """E1 and E3 (eager and CUDA-graph timing), E4 and E5 through their
    mains on the card at small sizes, with exact launch counts."""
    from chatllm_tpu_torch.experiments import gemv_model_bench as e3
    from chatllm_tpu_torch.experiments import gemv_probe as e1
    from chatllm_tpu_torch.experiments import gemv_unpack as e4
    from chatllm_tpu_torch.experiments import qmm_m32 as e5
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = e1.main(["stream", "vpu", "pallas_qmm"], device=dev, l=2, k=512, n=1024, steps=2)
    got = launch_counts()
    per_run = 3 * 2 * 2                     # (warm, eager, capture) x steps x layers
    assert (got["gemv_stream"], got["gemv_vpu"], got["qmm"]) == (per_run,) * 3
    assert all(r["graph_ms_per_step"] > 0 for r in res.values())
    shapes = [("q", 512, 512), ("k", 512, 128), ("v", 512, 128), ("o", 512, 512),
              ("gate", 512, 1024), ("up", 512, 1024), ("down", 1024, 512)]
    reset_launch_counts()
    res = e3.main(["sweep", "vpu", "stream:1024:256", "vpu_bf16:1024:256", "mxu"], device=dev,
                  l=2, shapes=shapes, tokens=2)
    per_run = 3 * 2 * 2 * 7                 # (warm, eager, capture) x tokens x layers x 7
    got = launch_counts()
    assert (got["qgemv"], got["stream_read"], got["qgemv_bf16"], got["qmm"]) == (per_run,) * 4
    assert all(r["graph_ms_per_token"] > 0 for r in res.values())
    reset_launch_counts()
    e4.main(["3"], device=dev, k=512, n=256)
    assert launch_counts()["unpack_gemv"] == 4 * (1 + 1 + 3)     # check, warm-up, capture
    reset_launch_counts()
    e5.main(device=dev, m=32, reps=3, k=2048, n=1024)
    got = launch_counts()
    assert (got["qmm_dma"], got["qmm"]) == (1 + 3, 3 * (1 + 3))


@pytest.mark.parametrize("B,T,Hq,Hkv,n_past,block_k,extra", [
    (1, 1, 32, 8, [1000], 512, {}), (3, 2, 16, 4, [5, 600, 2047], 256, {}),
    (2, 8, 32, 4, [100, 1500], 512, {}), (1, 1, 8, 1, [900], 512, {"sinks": True}),
    (1, 1, 32, 8, [1800], 512, {"sliding_window": 300, "logit_softcap": 30.0})])
@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
def test_flash_decode_int8_kernel(dev, B, T, Hq, Hkv, n_past, block_k, extra, q_dtype):
    """K4's int8 dots against their plain version: chip_smoke's
    DECODE_INT8_STEPS, its own launch count."""
    import chip_smoke
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.build import KERNELS
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode

    gen = torch.Generator(device=dev).manual_seed(B * 10 + T)
    S, D = 2048, 128
    q = torch.randn(B, T, Hq, D, generator=gen, device=dev).to(getattr(torch, q_dtype))
    (k, ks), (v, vs) = (quantize_kv(torch.randn(B, S, Hkv, D, generator=gen, device=dev))
                        for _ in range(2))
    kw = dict(scale=D ** -0.5, k_scale=ks, v_scale=vs, block_k=block_k,
              sliding_window=extra.get("sliding_window", 0),
              logit_softcap=extra.get("logit_softcap", 0.0))
    if extra.get("sinks"):
        kw["sinks"] = torch.randn(Hq, generator=gen, device=dev)
    npv = torch.tensor(n_past, dtype=torch.int64, device=dev)
    before = (KERNELS["flash_decode_int8"].launches, KERNELS["flash_decode"].launches)
    o = flash_decode(q, k, v, npv, T, qk_dtype="int8", **kw)
    assert (KERNELS["flash_decode_int8"].launches, KERNELS["flash_decode"].launches) == \
        (before[0] + 1, before[1])
    _, steps = chip_smoke.flash_decode_int8_errors(o, q, k, v, npv, T, **kw)
    assert o.dtype == q.dtype and steps <= chip_smoke.DECODE_INT8_STEPS


@pytest.mark.parametrize("cache", ["int8", "bfloat16"])
@pytest.mark.parametrize("n_past", [0, 47, 700])
def test_flash_decode_on_a_head_major_cache(dev, cache, n_past):
    """E7's call: K4 on a [B, Hkv, S, D] cache and [B, Hkv, S] scales, read
    through their strides, against its plain version (f32 dots)."""
    import chip_smoke
    from chatllm_tpu_torch.experiments import bhsd_decode as e7
    from chatllm_tpu_torch.ops.attention import quantize_kv

    gen = torch.Generator(device=dev).manual_seed(n_past)
    B, Hq, Hkv, S, D = 4, 32, 8, 1024, 128
    q = torch.randn(B, 1, Hq, D, generator=gen, device=dev)
    k, v = (torch.randn(B, Hkv, S, D, generator=gen, device=dev) for _ in range(2))
    kw = {}
    if cache == "int8":
        (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_kv(k), quantize_kv(v)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    o = e7.pallas_decode_bhsd(q, k, v, n_past, scale=D ** -0.5, **kw)
    views = {n: t.permute(0, 2, 1) for n, t in kw.items()}
    err, scaled = chip_smoke.flash_decode_errors(o, q, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                                                 n_past, 1, scale=D ** -0.5, qk_dtype="float32",
                                                 **views)
    assert err <= chip_smoke.DECODE_ATOL and scaled <= chip_smoke.DECODE_SCALED_TOL["float32"]


@pytest.mark.parametrize("M,K,N,tile_k", [(32, 512, 256, 512), (32, 4096, 1024, 2048),
                                          (5, 1024, 128, 256), (64, 2048, 192, 1024)])
def test_qmm_unpack_kernels(dev, M, K, N, tile_k):
    """E6's two templates against their plain versions (chip_smoke.E6_TOL)."""
    import chip_smoke
    from chatllm_tpu_torch.experiments import qmm_unpack_variants as e6
    from chatllm_tpu_torch.models.synthetic import synth_linear

    gen = torch.Generator(device=dev).manual_seed(M + K)
    lin = synth_linear(K, N, "q4k", gen=gen, zeros=False, device=dev)
    arrays = (lin.q, lin.s, lin.b, lin.d, lin.dm)
    x = torch.randn(M, K, generator=gen, device=dev)
    xs = e6.group_sums(x)
    for unpack in e6.UNPACK_MODES:
        for biasdot in (False, True):
            kw = dict(unpack=unpack, biasdot=biasdot, tile_k=tile_k)
            _, rel = chip_smoke.rel_err(e6.qmm_unpack(x, xs, *arrays, **kw),
                                        e6.qmm_unpack_plain(x, xs, *arrays, **kw))
            assert rel <= chip_smoke.E6_TOL, (unpack, biasdot, rel)
    for mode in e6.DIAG_MODES:
        _, rel = chip_smoke.rel_err(e6.qmm_unpack_diag(x, *arrays, mode=mode, tile_k=tile_k),
                                    e6.qmm_unpack_diag_plain(x, *arrays, mode=mode, tile_k=tile_k))
        assert rel <= chip_smoke.E6_TOL, (mode, rel)


def test_e6_and_e7_mains_at_a_small_size(dev):
    from chatllm_tpu_torch.experiments import bhsd_decode as e7
    from chatllm_tpu_torch.experiments import qmm_unpack_variants as e6
    from chatllm_tpu_torch.models.synthetic import tiny_config

    res = e6.main([], m=4, reps=4, k=2048, n=512)
    assert res["v4_biasdot"]["err"] <= e6.CHECK_TOL and res["v0_current"]["ms"] > 0
    cfg = tiny_config(vocab=256, hidden=512, layers=2, heads=4, kv_heads=2, inter=512,
                      max_length=512)
    res = e7.main([], b=4, ctx=512, steps=3, cfg=cfg)
    assert len(res) == 8 and all(r["graph_tok_s"] > 0 for r in res.values())
