"""The port's CUDA kernels on the card, against their plain versions, at
small shapes.  Marked `cuda`: they skip where no GPU is present (the
kernels have no CPU mode).  On a GPU machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

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


# K3's card cases (T, S, n_past, n_tokens, window, softcap), at 8 query heads
# over 2 kv heads
FLASH_CASES = [
    (128, 1024, 0, 128, 0, 0.0), (128, 1024, 0, 100, 0, 0.0),
    (192, 1024, 300, 192, 64, 0.0), (128, 1024, 64, 128, 0, 30.0),
    (128, 1024, 700, 128, 0, 0.0),   # the f32 query's first card case
    # the bf16 kernel's 128 x 128 tiles: n_past off the tile grid, T off it
    # with padded rows, a window crossing key tiles with a softcap, and the
    # cache's last tile
    (128, 1024, 37, 128, 0, 0.0), (200, 1024, 37, 180, 0, 0.0),
    (320, 2048, 700, 320, 300, 30.0), (128, 8192, 8064, 128, 0, 0.0),
    # the f32 kernel's tiles (128 or 64 rows) and its split walks (clusters
    # of 2-8 blocks, as ops/cuda/flash.py::prefill_geometry chooses for each
    # D and mode): n_past off the 64-row grid, T off it with padded rows, a
    # window crossing a split boundary, softcap over a split, a one-tile
    # query at the cache's end; (128, 8192, 8064) above splits too
    (256, 4096, 1001, 256, 0, 0.0), (100, 8192, 3000, 90, 0, 0.0),
    (128, 4096, 2000, 128, 700, 0.0), (128, 8192, 5000, 128, 0, 30.0),
    (64, 8192, 8128, 64, 0, 0.0)]


def _flash_case(dev, T, S, n_past, n_tokens, window, softcap, D, qdt, kvdt, heads=(8, 2)):
    """One K3 launch on seeded inputs, held to chip_smoke's limits, its second
    launch bit-identical, and in the f32 modes the kernel's split equal to
    its schedule's."""
    import chip_smoke
    from chatllm_tpu_torch.ops.cuda.build import KERNELS
    from chatllm_tpu_torch.ops.cuda.flash import (MODES, cluster_slots, f32_rows,
                                                  flash_attention, last_splits,
                                                  prefill_geometry)

    Hq, Hkv = heads
    gen = torch.Generator(device=dev).manual_seed(T + D + n_past)
    q = torch.randn(1, T, Hq, D, generator=gen, device=dev).to(qdt)
    k = torch.randn(1, S, Hkv, D, generator=gen, device=dev).to(kvdt)
    v = torch.randn(1, S, Hkv, D, generator=gen, device=dev).to(kvdt)
    kw = dict(scale=D ** -0.5, causal=True, sliding_window=window, logit_softcap=softcap)
    before = KERNELS["flash_attention"].launches
    o = flash_attention(q, k, v, n_past, n_tokens, **kw)
    assert KERNELS["flash_attention"].launches == before + 1 and o.dtype == qdt
    mode = MODES[(qdt, kvdt)]
    if mode:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        slots = cluster_slots(D, mode, f32_rows(D, T, Hq, 1, sms))
        g = prefill_geometry(T, S, n_past, n_tokens, D, mode=mode, heads=Hq, window=window,
                             sms=sms, slots=slots)
        assert last_splits() == g["splits"]
    err, scaled = chip_smoke.flash_errors(o, q, k, v, n_past, n_tokens, **kw)
    assert err <= chip_smoke.FLASH_ATOL and scaled <= chip_smoke.FLASH_SCALED_TOL[kvdt]
    # a second launch is bit-identical (no atomics, a fixed order of sums)
    assert torch.equal(flash_attention(q, k, v, n_past, n_tokens, **kw), o)
    return g["splits"] if mode else 1


@pytest.mark.parametrize("T,S,n_past,n_tokens,window,softcap", FLASH_CASES)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_kernel(dev, T, S, n_past, n_tokens, window, softcap, D, dtype):
    dt = getattr(torch, dtype)
    _flash_case(dev, T, S, n_past, n_tokens, window, softcap, D, dt, dt)


@pytest.mark.parametrize("heads,D,T,n_past,n_tok,window,want", [
    ((32, 8), 128, 128, 8064, 128, 0, 2), ((14, 2), 64, 128, 8064, 128, 0, 4),
    ((32, 8), 128, 1024, 0, 1000, 0, 1), ((14, 2), 64, 1024, 0, 1000, 0, 1),
    ((32, 8), 128, 1000, 37, 1000, 0, 1), ((32, 8), 128, 1024, 500, 1000, 300, 1)])
@pytest.mark.parametrize("qdt,kvdt", [("float32", "float32"), ("float32", "bfloat16")])
def test_flash_attention_f32_model_heads(dev, heads, D, T, n_past, n_tok, window, want, qdt,
                                         kvdt):
    """The f32 modes at the models' head counts: the 128-token chunk at
    n_past 8064 splits over 2 blocks for Llama-3-8B (64 blocks of 64 rows)
    and over 4 for Qwen2.5-0.5B (7 query heads per kv head); the 1000-token
    chunk is not
    split, and Llama-3-8B's takes 128-row blocks, here also with T and
    n_past off their grid and with a window.  The counts are an H100's (132
    SMs)."""
    got = _flash_case(dev, T, 8192, n_past, n_tok, window, 0.0, D, getattr(torch, qdt),
                      getattr(torch, kvdt), heads=heads)
    if torch.cuda.get_device_properties(dev).multi_processor_count == 132:
        assert got == want


@pytest.mark.parametrize("T,n_past,n_tok", [(512, 0, 512), (2048, 0, 2048), (512, 1001, 500),
                                             (128, 8064, 128)])
@pytest.mark.parametrize("qdt,kvdt", [("bfloat16", "bfloat16"), ("float32", "float32"),
                                      ("float32", "bfloat16")])
def test_flash_attention_at_qwen3_a3b_heads(dev, T, n_past, n_tok, qdt, kvdt):
    """K3 in its three modes at Qwen3-30B-A3B's heads (32 query heads over 4
    kv heads of 128: a GQA group of 8) over an 8192-slot cache: its prefill
    chunks of 512 and 2048 tokens, a chunk after a prompt off the row grid,
    and a chunk at the cache's end."""
    _flash_case(dev, T, 8192, n_past, n_tok, 0, 0.0, 128, getattr(torch, qdt),
                getattr(torch, kvdt), heads=(32, 4))


def test_moe_route_and_experts_at_qwen3_a3b_width(dev):
    """One Qwen3-30B-A3B MoE layer (hidden 2048, 128 experts of 768, top-8,
    normalized softmax weights, no shared expert; a zero-centred q4_k router
    and bf16 stacks) on the card against the CPU: 32 prefill rows (the
    router through K2) and 4 single rows (through K1).  Router scores within
    1e-2, at least 0.9 of the rows pick the CPU's experts, and where they
    agree the weights within 1e-2 and the output within 2e-2 of its scale."""
    from dataclasses import replace

    from chatllm_tpu_torch.models.synthetic import build_synthetic_params, qwen3_30b_a3b_config
    from chatllm_tpu_torch.nn import transformer as T
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.ops.qmm import matmul

    cfg = replace(qwen3_30b_a3b_config(), num_hidden_layers=1,
                  layer_specs=qwen3_30b_a3b_config().layer_specs[:1])
    p = build_synthetic_params(cfg, "q4k", zeros=False, seed=3, device=dev,
                               centered=True)["layers"][0]["mlp"]
    p_cpu = {"gate": p["gate"].to("cpu"), "experts": {k: v.cpu() for k, v in
                                                      p["experts"].items()}}
    assert set(p) == {"gate", "experts"} and tuple(p["experts"]["down"].shape) == (128, 768, 2048)
    gen = torch.Generator().manual_seed(0)
    for rows, kern in ((32, "qmm"), (1, "qgemv"), (1, "qgemv"), (1, "qgemv"), (1, "qgemv")):
        x = torch.randn(1, rows, 2048, generator=gen).to(torch.bfloat16)
        reset_launch_counts()
        with torch.inference_mode():
            gi, gv = T.moe_route(cfg, p, x[0].to(dev))
            g_out = T.moe_mlp(cfg, p, x.to(dev))
            torch.cuda.synchronize()
            launched = launch_counts()[kern]
            ci, cv = T.moe_route(cfg, p_cpu, x[0])
            c_out = T.moe_mlp(cfg, p_cpu, x)
            gs = torch.softmax(matmul(x[0].to(dev), p["gate"]).float(), -1).cpu()
            cs = torch.softmax(matmul(x[0], p_cpu["gate"]).float(), -1)
        assert launched == 2      # the router in moe_route and in moe_mlp
        assert (gs - cs).abs().max() <= 1e-2
        gi, ci = gi.cpu(), ci
        agree = (torch.sort(gi, -1).values == torch.sort(ci, -1).values).all(-1)
        assert agree.float().mean() >= 0.9, agree
        order_g, order_c = torch.argsort(gi, -1), torch.argsort(ci, -1)
        wg = torch.gather(gv.cpu(), -1, order_g)[agree]
        wc = torch.gather(cv, -1, order_c)[agree]
        assert (wg - wc).abs().max() <= 1e-2 and torch.allclose(wc.sum(-1), torch.ones(1))
        go, co = g_out[0].float().cpu()[agree], c_out[0].float()[agree]
        assert torch.isfinite(go).all() and (go - co).abs().max() <= 2e-2 * co.abs().max()


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


@pytest.mark.parametrize("T,S,n_past,n_tokens,window,softcap", FLASH_CASES)
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_f32_query_bf16_cache(dev, T, S, n_past, n_tokens, window, softcap, D):
    """An f32 query over a bf16 cache (--compute_dtype f32, and the chat
    path's f32 projections over a bf16 cache): f32 scores, probabilities
    rounded to bf16, f32 output."""
    _flash_case(dev, T, S, n_past, n_tokens, window, softcap, D, torch.float32,
                torch.bfloat16)


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
    # Qwen3-30B-A3B's heads: 32 query heads over 4 kv heads (G 8), 8 and 16
    # rows per kv head, one and two streams
    "a3b_t1": (1, 1, 32, 4, 128, 8192, [1000], "int8", {}),
    "a3b_t2": (1, 2, 32, 4, 128, 8192, [3000], "int8", {}),
    "a3b_b2": (2, 1, 32, 4, 128, 8192, [1000, 7000], "int8", {}),
    "a3b_b2_t2": (2, 2, 32, 4, 128, 8192, [40, 8000], "int8", {}),
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
    """K5 against its plain version (the same roundings; only the order of
    the f32 sums differs): 2e-2 of the output scale, as for K2; a second
    launch gives the same bits (the cluster sums its splits in rank
    order); on one-hot rows, where each output is one dequantized weight,
    the kernel equals its plain version bit for bit."""
    import chip_smoke
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
    assert torch.equal(qmm_decode(x, lin.q, lin.s, lin.b, bias, **kw), y)
    x1 = chip_smoke.one_hot_rows(rows, 512, dev).to(torch.bfloat16)
    assert torch.equal(qmm_decode(x1, lin.q, lin.s, lin.b, bias, **kw),
                       qmm_decode_plain(x1, lin.q, lin.s, lin.b, bias, **kw))
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
    DECODE_INT8_STEPS, its own launch count, a second launch bit-identical."""
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
    assert torch.equal(flash_decode(q, k, v, npv, T, qk_dtype="int8", **kw), o)


@pytest.mark.parametrize("B,n_past,new_n_past", [(1, [1000], [5000]), (4, [0, 600, 4095, 700],
                                                                       [8000, 1, 511, 3000])])
def test_flash_decode_int8_replays_in_a_cuda_graph(dev, B, n_past, new_n_past):
    """One int8-dot call captured in a CUDA graph reads n_past on the card:
    replayed after the n_past tensor's values change, it gives the eager
    call's bits at the new values (the wrapper allocates nothing but the
    output, and the launch reads nothing back)."""
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode

    gen = torch.Generator(device=dev).manual_seed(B)
    T, Hq, Hkv, D, S = 1, 32, 8, 128, 8192
    q = torch.randn(B, T, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    (k, ks), (v, vs) = (quantize_kv(torch.randn(B, S, Hkv, D, generator=gen, device=dev))
                        for _ in range(2))
    kw = dict(scale=D ** -0.5, k_scale=ks, v_scale=vs, qk_dtype="int8")
    npv = torch.tensor(n_past, dtype=torch.int64, device=dev)
    flash_decode(q, k, v, npv, T, **kw)          # first launch sets the kernel's attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o = flash_decode(q, k, v, npv, T, **kw)
    for values in (new_n_past, n_past):
        npv.copy_(torch.tensor(values, dtype=torch.int64))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(o, flash_decode(q, k, v, npv.clone(), T, **kw)), values


def _replays_as_eager(dev, call, refill):
    """`call()` captured in a CUDA graph after one eager call; `refill()`
    writes new values into its inputs.  Each replay after a refill gives
    the bits of an eager call on the same inputs."""
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for i in range(2):
        refill(i)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call()), i


@pytest.mark.parametrize("qk_dtype", ["bfloat16", "float32"])
def test_flash_decode_float_dots_replay_in_a_cuda_graph(dev, qk_dtype):
    """K4's float dots over a bf16 cache, captured: a replay after q and the
    n_past vector change gives the eager call's bits."""
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode

    gen = torch.Generator(device=dev).manual_seed(3)
    B, T, Hq, Hkv, D, S = 2, 1, 32, 8, 128, 8192
    q = torch.randn(B, T, Hq, D, generator=gen, device=dev).to(getattr(torch, qk_dtype))
    k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    npv = torch.tensor([1000, 40], dtype=torch.int64, device=dev)

    def refill(i):
        q.copy_(torch.randn(q.shape, generator=gen, device=dev))
        npv.copy_(torch.tensor([[5000, 8191], [3, 2048]][i]))

    _replays_as_eager(dev, lambda: flash_decode(q, k, v, npv, T, scale=D ** -0.5,
                                                qk_dtype=qk_dtype), refill)


@pytest.mark.parametrize("rows", [1, 8])
def test_quantized_matmul_kernels_replay_in_a_cuda_graph(dev, rows):
    """K1 (one row) and K2 (8 rows) on a q4_k weight at Llama-3-8B's
    gate shape, captured: a replay after x changes gives the eager bits."""
    from chatllm_tpu_torch.ops.cuda.gemv_kernel import qgemv
    from chatllm_tpu_torch.ops.cuda.qmm_kernel import qmm

    gen = torch.Generator(device=dev).manual_seed(rows)
    lin = _weights("q4_k", 4096, 14336, gen, dev)
    kw = dict(group=lin.group_size, packed=lin.packed, zero_point=lin.zero_point,
              d=lin.d, dm=lin.dm, sb=lin.sb)
    x = torch.randn(rows, 4096, generator=gen, device=dev).to(torch.bfloat16)
    kern = qgemv if rows == 1 else qmm
    _replays_as_eager(dev, lambda: kern(x, lin.q, lin.s, lin.b, lin.bias, **kw),
                      lambda i: x.copy_(torch.randn(x.shape, generator=gen, device=dev)))


def test_multinomial_draws_under_capture(dev):
    """torch.multinomial from a generator registered with the graph makes no
    host sync under capture, and a replay after a reseed draws what an eager
    call of that seed draws."""
    probs = torch.softmax(torch.randn(128256, generator=torch.Generator(device=dev)
                                      .manual_seed(0), device=dev) * 3, dim=-1)
    gen = torch.Generator(device=dev)
    torch.multinomial(probs, 1, generator=gen)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        tok = torch.multinomial(probs, 1, generator=gen)
    for seed in (1, 2):
        gen.manual_seed(seed)
        graph.replay()
        got = tok.clone()
        gen.manual_seed(seed)
        assert torch.equal(got, torch.multinomial(probs, 1, generator=gen)), seed


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
@pytest.mark.parametrize("sampled", [False, True])
def test_engine_decode_blocks_replay_as_the_uncaptured_run(dev, cache, sampled):
    """A 2-layer cut of Llama-3-8B (random q4_k weights, max_length 8192):
    InferenceEngine replaying its decode blocks from CUDA graphs gives the
    uncaptured run's tokens and cache bits, greedy and sampled, over a bf16
    cache (the chunked attention over the KV bucket) and a q8 one (K4).  A 1000-token
    prompt and 40 tokens: 39 decode steps in blocks of 16, so 3 blocks over
    the buckets 1024, 2048, 2048 (2 captures, each after one warm-up
    block).  The launch counts are exact: each step launches K1 15 times (2
    x 7 projections + the lm_head) and K4 2 times over the q8 cache, and a
    second run on the same cache replays every block."""
    from dataclasses import replace

    from chatllm_tpu_torch.models.synthetic import build_synthetic_params, llama3_8b_config
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine

    cfg = replace(llama3_8b_config(max_length=8192), num_hidden_layers=2, cache_dtype=cache)
    params = build_synthetic_params(cfg, "q4k", zeros=False, seed=0, device=dev)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, 1000).tolist()
    g = GenerationConfig(do_sample=sampled, max_new_tokens=40, temperature=1.2, top_k=50,
                         top_p=0.95, repeat_penalty=1.2, seed=5)
    ref = InferenceEngine(cfg, params, device=dev, cuda_graphs=False).generate(ids, g)
    eng = InferenceEngine(cfg, params, device=dev)
    kv = eng.new_cache(1)
    k4 = 2 if cache == "int8" else 0
    for run, (eager_steps, replayed) in enumerate(((32, 48), (32, 96))):
        reset_launch_counts()
        out, _, n_past = eng.generate(ids, g, cache=kv)
        torch.cuda.synchronize()
        got = launch_counts()
        assert out == ref[0] and n_past == ref[2] == 1000 + 39, run
        for name in ("k", "v", "k_scale", "v_scale"):
            for got_t, want_t in zip(getattr(kv, name) or (), getattr(ref[1], name) or ()):
                assert torch.equal(got_t, want_t), (run, name)
        assert (eng.decoder.num_graphs(), eng.decoder.eager_steps,
                eng.decoder.replayed_steps) == (2, eager_steps, replayed), run
        steps = 48 + (32 if run == 0 else 0)     # replayed, and warm-up blocks in run 0
        assert got["qgemv"] == 15 * steps + 1, (run, got)   # + the prefill's lm_head
        assert got["flash_decode"] == k4 * steps, (run, got)


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


MLA_DECODE_CASES = {   # B, T, n_past, cache, qk_dtype over S 4096, 16 heads, K 192 / V 128
    "q8_t1": (1, 1, [1000], "int8", "float32"),
    "q8_rows": (4, 1, [10, 1000, 4095, 2000], "int8", "float32"),
    "q8_t8": (1, 8, [3000], "int8", "float32"),
    "bf16_cache": (2, 1, [0, 4000], "bfloat16", "float32"),
    "f32_cache": (1, 2, [64], "float32", "float32"),
    "bf16_dots": (1, 1, [2047], "int8", "bfloat16"),
}


@pytest.mark.parametrize("case", list(MLA_DECODE_CASES))
def test_flash_decode_kernel_at_mla_dims(dev, case):
    """K4 at DeepSeek-V2's expanded MLA cache, (D, Dv) = (192, 128), against
    its plain version (chip_smoke.DECODE_SCALED_TOL); output [B, T, 16, 128]."""
    import chip_smoke
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.build import KERNELS
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode

    B, T, n_past, cache, qk_dtype = MLA_DECODE_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(len(case))
    q = torch.randn(B, T, 16, 192, generator=gen, device=dev).to(getattr(torch, qk_dtype))
    k = torch.randn(B, 4096, 16, 192, generator=gen, device=dev)
    v = torch.randn(B, 4096, 16, 128, generator=gen, device=dev)
    kw = dict(scale=192 ** -0.5, qk_dtype=qk_dtype)
    if cache == "int8":
        (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_kv(k), quantize_kv(v)
    else:
        k, v = k.to(getattr(torch, cache)), v.to(getattr(torch, cache))
    npv = torch.tensor(n_past, dtype=torch.int64, device=dev)
    before = KERNELS["flash_decode"].launches
    o = flash_decode(q, k, v, npv, T, **kw)
    assert KERNELS["flash_decode"].launches == before + 1
    assert o.dtype == q.dtype and tuple(o.shape) == (B, T, 16, 128)
    err, scaled = chip_smoke.flash_decode_errors(o, q, k, v, npv, T, **kw)
    assert err <= chip_smoke.DECODE_ATOL and scaled <= chip_smoke.DECODE_SCALED_TOL[qk_dtype]


def test_flash_decode_at_mla_dims_replays_in_a_cuda_graph(dev):
    """K4 at (192, 128) over a q8 cache with f32 dots, captured: a replay
    after q and the n_past vector change gives the eager call's bits."""
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode

    gen = torch.Generator(device=dev).manual_seed(4)
    B, S = 2, 8192
    q = torch.randn(B, 1, 16, 192, generator=gen, device=dev)
    (k, ks), (v, vs) = (quantize_kv(torch.randn(B, S, 16, d, generator=gen, device=dev))
                        for d in (192, 128))
    npv = torch.tensor([1000, 40], dtype=torch.int64, device=dev)

    def refill(i):
        q.copy_(torch.randn(q.shape, generator=gen, device=dev))
        npv.copy_(torch.tensor([[5000, 8191], [3, 2048]][i]))

    _replays_as_eager(dev, lambda: flash_decode(q, k, v, npv, 1, scale=192 ** -0.5,
                                                k_scale=ks, v_scale=vs), refill)


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_moe_decode_step_replays_as_the_eager_step(dev, cache):
    """A 2-layer cut of DeepSeek-V2-Lite at full width (layer 0 dense, layer
    1 MoE over 64 experts, random weights) at max_length 8192: one decode
    step captured in a CUDA graph and replayed gives the eager step's logits
    and cache bits, and the replay launches K4 once per layer over the q8
    cache (K1 for the B=1 projections)."""
    from dataclasses import replace

    from chatllm_tpu_torch.models.synthetic import (build_synthetic_params,
                                                    deepseek_v2_lite_config)
    from chatllm_tpu_torch.nn.transformer import init_cache, transformer_forward
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    cfg = replace(deepseek_v2_lite_config(8192), num_hidden_layers=2, cache_dtype=cache,
                  layer_specs=deepseek_v2_lite_config().layer_specs[:2])
    params = build_synthetic_params(cfg, "q4k", zeros=False, seed=0, device=dev, centered=True)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 300))).to(dev)
    caches = [init_cache(cfg, 1, device=dev) for _ in range(2)]
    with torch.inference_mode():
        for c in caches:
            transformer_forward(cfg, params, ids, c, 0)
        tok = torch.tensor([[77]], device=dev)
        n_past = torch.tensor(300, device=dev)
        eager = transformer_forward(cfg, params, tok, caches[0], n_past.clone(), kv_len=1024)[0]
        transformer_forward(cfg, params, tok, caches[1], n_past, kv_len=1024)      # warm-up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        reset_launch_counts()
        with torch.cuda.graph(graph):       # the wrappers count what the graph will launch
            out = transformer_forward(cfg, params, tok, caches[1], n_past, kv_len=1024)[0]
        captured = launch_counts()
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)
    for a, b in zip(caches[0].k + caches[0].v, caches[1].k + caches[1].v):
        assert torch.equal(a, b)
    assert captured["flash_decode"] == (2 if cache == "int8" else 0), captured
    # q, d_kv, u_k_nope, u_v, o x 2 layers, layer 0's down (its gate / up of
    # 10944 columns and k_pe and the router take the dequant route), the
    # shared expert's gate, up, down, the lm_head
    assert captured["qgemv"] == 5 * 2 + 1 + 3 + 1, captured


@pytest.mark.parametrize("case", ["f32", "f32_q8", "f32_latent", "q4k", "q4k_q8", "q4k_latent"])
def test_deepseek_v2_loads_on_the_card_as_on_the_cpu(dev, tmp_path, case):
    """`load_model` of chip_smoke.write_deepseek_v2_ggmm's DEEPSEEK_V2_LIGHT
    file on the card against the CPU, in each of chip_smoke.DSV2_TINY_CASES
    (f32 and q4_k weights, both MLA cache modes, f32 / bf16 and q8 caches):
    the same config and every parameter bit-equal (the expert stacks filled
    on the card, the latent mode's wk_abs / wv_abs absorbed there); the
    logits after the prompt and after each of 15 tokens fed to both (the
    CPU's greedy ones) within the case's tolerance of the logit scale, with
    the same argmax wherever the CPU's top two logits are further apart
    than twice it; the card's greedy tokens replayed from CUDA graphs equal
    to the uncaptured run's, and to the CPU's up to the first step whose top
    two are that close; over the q8 cache of 4096 slots every decode step
    launches K4 at (192, 128) once a layer."""
    import chip_smoke
    from chatllm_tpu_torch.ggmm.quants import GGMLType
    from chatllm_tpu_torch.models import RuntimeConfig, load_model
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine

    fmt, compute, cache, mla_cache, max_len, tol = chip_smoke.DSV2_TINY_CASES[case]
    path = chip_smoke.write_deepseek_v2_ggmm(tmp_path / "m.bin", max_len=max_len,
                                             dtype=GGMLType.F32 if fmt == "f32" else None)
    rt = RuntimeConfig(compute_dtype=compute, cache_dtype=cache, mla_cache=mla_cache)
    card, cpu = load_model(str(path), rt, device=dev), load_model(str(path), rt, device="cpu")
    assert card.cfg == cpu.cfg and card.cfg.mla_compressed == (mla_cache == "memory")
    chip_smoke.same_params(card.params, cpu.params)

    new = 16
    ids = cpu.tokenizer.encode("Hello from the card")
    want, rows = [], {}
    for name, m in (("cpu", cpu), ("card", card)):
        lg, kv, n = m.engine.prefill(ids, m.engine.new_cache(1), 0)
        rows[name] = []
        for i in range(new):
            rows[name].append(lg[0].float().cpu())
            if name == "cpu":
                want.append(int(lg[0].argmax()))
            if i + 1 < new:
                lg, kv, n = m.engine.prefill([want[i]], kv, n)
    c, g = torch.stack(rows["cpu"]), torch.stack(rows["card"])
    scale = c.abs().amax(-1)
    assert torch.isfinite(g).all()
    assert ((g - c).abs().amax(-1) <= tol * scale).all(), ((g - c).abs().amax(-1) / scale)
    top2 = c.topk(2, dim=-1).values
    clear = top2[:, 0] - top2[:, 1] > 2 * tol * scale
    assert clear[0] and (g.argmax(-1) == c.argmax(-1))[clear].all()

    gcfg = GenerationConfig(do_sample=False, max_new_tokens=new)
    out, k4 = {}, {}
    for graphs in (True, False):
        reset_launch_counts()
        eng = InferenceEngine(card.cfg, card.params, device=dev, cuda_graphs=graphs)
        out[graphs] = eng.generate(ids, gcfg)[0]
        k4[graphs] = launch_counts()["flash_decode"]
    assert out[True] == out[False] and len(out[True]) == new
    agree = int(clear.int().cumprod(0).sum())      # the steps before the first close one
    assert out[True][:agree] == want[:agree], (out[True], want, clear)
    # a q8 cache: one block of 16 decode steps, K4 once a layer each (the
    # replayed run also counts its uncaptured warm-up block)
    steps = chip_smoke.decode_launches(new) * card.cfg.num_hidden_layers if cache == "q8_0" else 0
    assert (k4[True], k4[False]) == (2 * steps, steps), k4


# ------------------------------------------------- the chat pipeline's pieces
def _tiny_cfg(tmp_path, kind: str):
    """The config of a narrow GGMM: Llama-3.1 (NORMAL rope with the llama3
    frequency factors) or Qwen2 (NEOX)."""
    import chip_smoke
    from chatllm_tpu_torch.models import RuntimeConfig, load_model

    if kind == "llama31_normal":
        path = chip_smoke.write_llama3_ggmm(tmp_path / "l.bin", rope_scaling=(8192, 8.0, 1.0, 4.0))
    else:
        path = chip_smoke.write_qwen2_ggmm(tmp_path / "q.bin")
    cfg = load_model(str(path), RuntimeConfig(), device="cpu").cfg
    assert (cfg.rope.layout, cfg.rope.freq_factors is not None) == \
        (("normal", True) if kind == "llama31_normal" else ("neox", False))
    return cfg


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kind", ["llama31_normal", "qwen2_neox"])
def test_shift_cache_card_matches_cpu(dev, tmp_path, kind, cache):
    """shift_cache on the card against the CPU on the same cache contents,
    in place: V, the kept rows and V's scales bit-equal; K within 1e-6 of
    its scale (f32), one bf16 ulp (bf16), or one int8 step in at most 1e-3
    of the entries with scales within 1e-6 relative (q8)."""
    from chatllm_tpu_torch.nn.transformer import init_cache
    from chatllm_tpu_torch.runtime.generate import shift_cache

    cfg = dataclasses.replace(_tiny_cfg(tmp_path, kind), cache_dtype=cache)
    S, n_past, keep = 1024, 1000, 37
    shift = (n_past - keep) // 2
    gen = torch.Generator().manual_seed(3)
    cpu = init_cache(cfg, 1, S)
    for t in [*cpu.k, *cpu.v]:
        if cache == "int8":
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, dtype=torch.int32))
        else:
            t.copy_(torch.randn(t.shape, generator=gen))
    for t in [*(cpu.k_scale or ()), *(cpu.v_scale or ())]:
        t.copy_(torch.rand(t.shape, generator=gen) * 0.02 + 1e-3)
    card = init_cache(cfg, 1, S, device=dev)
    planes = lambda c: [*c.k, *c.v, *(c.k_scale or ()), *(c.v_scale or ())]  # noqa: E731
    for d, s in zip(planes(card), planes(cpu)):
        d.copy_(s)
    ptrs = [t.data_ptr() for t in planes(card)]
    assert shift_cache(cfg, card, shift, keep) is card
    torch.cuda.synchronize()
    assert ptrs == [t.data_ptr() for t in planes(card)]
    shift_cache(cfg, cpu, shift, keep)
    for i in range(len(cpu.k)):
        assert torch.equal(card.v[i].cpu(), cpu.v[i])
        kg, kc = card.k[i].cpu(), cpu.k[i]
        assert torch.equal(kg[:, :keep], kc[:, :keep])
        if cache == "float32":
            torch.testing.assert_close(kg, kc, rtol=1e-6, atol=1e-6 * kc.abs().max().item())
        elif cache == "bfloat16":
            d = (kg.view(torch.int16).int() - kc.view(torch.int16).int()).abs()
            assert d.max().item() <= 1
        else:
            d = (kg.int() - kc.int()).abs()
            assert d.max().item() <= 1 and (d > 0).float().mean().item() <= 1e-3
            assert torch.equal(card.v_scale[i].cpu(), cpu.v_scale[i])
            torch.testing.assert_close(card.k_scale[i].cpu(), cpu.k_scale[i], rtol=1e-6,
                                       atol=0)


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_session_crosses_card_and_cpu(dev, tmp_path, cache):
    """A session written on the card loads bit-equal on the CPU, and one
    written on the CPU loads bit-equal on the card."""
    import chip_smoke
    from chatllm_tpu_torch.models import RuntimeConfig, load_model
    from chatllm_tpu_torch.runtime.generate import GenerationConfig
    from chatllm_tpu_torch.runtime.pipeline import ExtendingMethod, Pipeline

    path = chip_smoke.write_llama3_ggmm(tmp_path / "m.bin")
    rt = RuntimeConfig(cache_dtype=cache, max_length=256)
    models = {"card": load_model(str(path), rt, device=dev),
              "cpu": load_model(str(path), rt, device="cpu")}
    for src, dst in (("card", "cpu"), ("cpu", "card")):
        pipe = Pipeline(models[src], extending=ExtendingMethod.SHIFT)
        pipe.gen_config = GenerationConfig(do_sample=False, max_new_tokens=8)
        models[src].tokenizer.sys_prompt = "You are terse."
        pipe.eval_sys_prompt()
        for turn in ("Hello there.", "Tell me more about the sea, please."):
            pipe.chat(turn)
        f = str(tmp_path / f"{src}.session")
        pipe.save_session(f)
        other = Pipeline(models[dst], extending=ExtendingMethod.SHIFT)
        other.load_session(f)
        assert (other.n_past, other.initial_n_past) == (pipe.n_past, pipe.initial_n_past)
        a, b = pipe._cache, other._cache
        n = pipe.n_past
        for x, y in zip([*a.k, *a.v, *(a.k_scale or ())], [*b.k, *b.v, *(b.k_scale or ())]):
            assert x.dtype == y.dtype and torch.equal(x[:, :n].cpu(), y[:, :n].cpu())


@pytest.mark.parametrize("target", ["q8_0", "q4_k"])
def test_re_quantize_loads_on_the_card_as_on_the_cpu(dev, tmp_path, target):
    import chip_smoke
    from chatllm_tpu_torch.ggmm.quants import GGMLType
    from chatllm_tpu_torch.models import RuntimeConfig, load_model

    src = GGMLType.F32 if target == "q4_k" else None       # f32 -> q4_k, q4_k -> q8_0
    path = chip_smoke.write_llama3_ggmm(tmp_path / "m.bin", dtype=src)
    rt = RuntimeConfig(re_quantize=target)
    chip_smoke.same_params(load_model(str(path), rt, device=dev).params,
                           load_model(str(path), rt, device="cpu").params)


# --------------------------------------------------------------- InternVL
def _ivl_pair(tmp_path, dev, **rt):
    """The narrow INTERN_VL file (q4_k Qwen3 behind a 2-layer InternViT)
    loaded on the card and on the CPU."""
    import chip_smoke
    from chatllm_tpu_torch.models import RuntimeConfig, load_model

    path = str(chip_smoke.write_internvl_ggmm(tmp_path / "ivl.bin"))
    return (load_model(path, RuntimeConfig(**rt), device=dev),
            load_model(path, RuntimeConfig(**rt), device="cpu"))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_internvl_tower_and_encode_images_on_the_card(dev, tmp_path, compute):
    """The tower (the unfolded patch product in f32, never TF32) and the
    projector on the card against the CPU: the tower within 1e-5 of its
    output scale in f32, 1e-3 with bf16 linears; the projected embeddings
    within 1e-5 / 1e-2 (fc1 takes bf16 input with a bf16 embedding)."""
    from chatllm_tpu_torch.nn.vit import vit_forward

    card, cpu = _ivl_pair(tmp_path, dev, compute_dtype=compute)
    tiles = np.random.default_rng(0).standard_normal((3, 56, 56, 3)).astype(np.float32)
    tol = (1e-5, 1e-5) if compute == "float32" else (1e-3, 1e-2)
    with torch.inference_mode():
        h = vit_forward(card.vis_cfg, card.vis_params, torch.from_numpy(tiles).to(dev))
        h_ref = vit_forward(cpu.vis_cfg, cpu.vis_params, torch.from_numpy(tiles))
        e, e_ref = card.encode_images(tiles), cpu.encode_images(tiles)
    for got, ref, t in ((h, h_ref, tol[0]), (e, e_ref, tol[1])):
        got = got.float().cpu()
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert (got - ref).abs().max().item() <= t * ref.abs().max().item()


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_internvl_chat_image_replays_its_decode_graphs(dev, tmp_path, cache):
    """Two images on one model: the second captures no graph and runs no
    warm-up step, every decode block replays, and its reply equals an
    uncaptured run's on the same weights."""
    import chip_smoke
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine

    card, _ = _ivl_pair(tmp_path, dev, cache_dtype=cache)
    pngs = [chip_smoke.write_png(tmp_path / f"{i}.png", chip_smoke.ivl_image(i, (90, 120)))
            for i in range(2)]
    g = GenerationConfig(do_sample=False, max_new_tokens=20)
    card.chat_image(str(pngs[0]), "What is it?", g)
    dec = card.engine.decoder
    was = (dec.num_graphs(), dec.eager_steps, dec.replayed_steps)
    got = card.chat_image(str(pngs[1]), "What is it?", g)
    assert (dec.num_graphs(), dec.eager_steps) == was[:2]
    assert dec.replayed_steps - was[2] == chip_smoke.decode_launches(20)
    card._engine = InferenceEngine(card.cfg, card.params, device=dev, cuda_graphs=False)
    assert card.chat_image(str(pngs[1]), "What is it?", g) == got
