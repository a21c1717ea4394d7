"""The port's DeepSeek-V2 loader, tokenizer and engines against the JAX
package, on the CPU.

  - DEEPSEEK_V1_REGEX is the JAX package's, and its splits through the
    standard `re` equal the JAX processor's (`regex`) over a seeded fuzz of
    mixed-script strings;
  - the tiny DeepSeek-V2-Lite GGMM of tests/test_mla.py (f32, written from a
    random Hugging Face DeepseekV2ForCausalLM): config and every weight
    bit-exact against the JAX loader in both MLA cache modes; f32 logits
    within 1e-4 of the JAX package's and 3e-3 of HF's (test_mla.py's
    tolerance); greedy tokens identical to the JAX engine's over 16 steps
    at decode blocks 1 and 16, over bf16 and q8 caches, in both modes (the
    latent mode takes no q8 cache); at a 4096-slot q8 cache every decode
    step takes K4 (its plain twin here, at the fixture's K 24 / V 16
    widths; the JAX package's per-head Pallas kernel in interpret mode);
  - BatchedEngine's greedy replies equal the JAX BatchedEngine's (expanded
    mode, f32 and q8 caches); with the latent cache both refuse;
  - a q4_k GGMM converted by the shared tools/convert.py from a tiny
    DeepseekV2Config at hidden 256: prefill logits within 2e-2 of the JAX
    package's logit scale (as the other q4_k tests), the chat template's
    ids equal, and the CLI transcripts of `main.py --device cpu` equal the
    JAX CLI's in both MLA modes;
  - why chip_smoke.py's full-width 2-layer cut holds the card to 2e-2 of
    the CPU's logit scale and lets near-tied expert picks differ (an
    f32-level perturbation on the CPU alone).
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import chatllm_tpu.main as jmain
import chatllm_tpu.models as jm
import chatllm_tpu.ops.qtensor as jq
import chatllm_tpu_torch.main as tmain
import chatllm_tpu_torch.models as tm
import chatllm_tpu_torch.ops.qtensor as tq
from chatllm_tpu.ops.sampling import SamplerConfig as JSampler
from chatllm_tpu.runtime.batching import BatchedEngine as JBatched
from chatllm_tpu.runtime.chat import Messages as JMessages, MsgRole as JRole
from chatllm_tpu.runtime.generate import GenerationConfig as JGen
from chatllm_tpu_torch.models.deepseek import DEEPSEEK_V1_REGEX
from chatllm_tpu_torch.ops import qmm as tqmm
from chatllm_tpu_torch.ops.sampling import SamplerConfig
from chatllm_tpu_torch.runtime.batching import BatchedEngine
from chatllm_tpu_torch.runtime.chat import Messages as TMessages, MsgRole as TRole
from chatllm_tpu_torch.runtime.generate import GenerationConfig as TGen
from test_convert_wave2 import _save_dir
from test_mla import make_tiny_dsv2
from test_torch_model import _run

transformers = pytest.importorskip("transformers")

F32 = dict(weight_dtype="float32", compute_dtype="float32", cache_dtype="float32")
IDS = [3, 17, 42, 99, 7, 200, 11, 4, 5, 66, 130, 9]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("dsv2")
    short, long = str(d / "dsv2_128.bin"), str(d / "dsv2_4096.bin")
    hf = make_tiny_dsv2(short)
    make_tiny_dsv2(long, max_len=4096)
    return {"hf": hf, "short": short, "long": long}


def _load(path, mla_cache="speed", **rt):
    rt = {**F32, **rt, "mla_cache": mla_cache}
    return (jm.load_model(path, jm.RuntimeConfig(**rt)),
            tm.load_model(path, tm.RuntimeConfig(**rt), device="cpu"))


# ---------------------------------------------------------------- tokenizer
def test_regex_is_the_jax_packages():
    from chatllm_tpu.models.deepseek import DEEPSEEK_V1_REGEX as J

    assert DEEPSEEK_V1_REGEX == J


ALPHABET = (list("The quick brown fox 0123456789 ") + list("'.,!?-_$+<=>^~|()[]{}\t\n\r")
            + ["µ", "À", "×", "÷", "ø", "ǅ", "ʔ", "Ω", "ά", "ж", "Ӂ", "Ա", "ა", "Ꭰ", "ᏸ",
               "ᲀ", "ᴀ", "ḁ", "ἀ", "ℂ", "ℵ", "Ⰰ", "Ⲁ", "ꙁ", "ꜣ", "ꭰ", "ﬀ", "Ａ", "ｚ",
               "！", "／", "：", "～", "‘", "’", "“", "‟", "　", "、", "。", "中", "文",
               "龥", "ࠀ", "가", "힣", "٣", "½", "²", "Ⅻ", "৩", "\U00010400", "\U000104B0",
               "\U00010C80", "\U000118A0", "\U0001E900", "\U0001F600", "́", "א", "​",
               "\x85", " ", " ", "\x0b", "\x0c"])


@pytest.mark.parametrize("seed", range(6))
def test_regex_splits_match_the_jax_processor(seed):
    from chatllm_tpu.tokenizer.processor import BPEProcessor2 as JBPE
    from chatllm_tpu_torch.tokenizer.processor import BPEProcessor2

    j, t = JBPE(DEEPSEEK_V1_REGEX), BPEProcessor2(DEEPSEEK_V1_REGEX)
    rng = random.Random(seed)
    for _ in range(300):
        s = "".join(rng.choice(ALPHABET) for _ in range(rng.randint(0, 48)))
        assert t._regex_split(s) == j._regex_split(s), repr(s)


# ------------------------------------------------------------------ loader
@pytest.mark.parametrize("mla_cache", ["speed", "memory"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_config_and_weights_match(tiny, mla_cache, compute):
    j, p = _load(tiny["short"], mla_cache, weight_dtype="auto", compute_dtype=compute)
    assert type(p).__name__ == type(j).__name__ == "DeepSeekV2"
    for f in ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "intermediate_size", "max_length", "norm_eps",
              "attention_scale", "moe_num_experts", "moe_top_k", "moe_norm_topk_prob",
              "moe_n_group", "moe_topk_group", "moe_routed_scale", "moe_score_func",
              "mla_compressed", "cache_dtype"):
        assert getattr(p.cfg, f) == getattr(j.cfg, f), f
    assert dataclasses.asdict(p.cfg.mla) == dataclasses.asdict(j.cfg.mla)
    assert [s.is_moe for s in p.cfg.layer_specs] == [s.is_moe for s in j.cfg.layer_specs]
    for f in ("head_dim", "rot_dim", "freq_base", "freq_scale", "layout", "ext_factor",
              "attn_factor", "beta_fast", "beta_slow", "orig_ctx"):
        assert getattr(p.cfg.rope, f) == getattr(j.cfg.rope, f), f

    def same(a, b, where):
        if isinstance(b, dict):
            assert set(a) == set(b), where
            for k in b:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(b, (tuple, list)):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        elif isinstance(b, jq.DenseLinear):
            assert isinstance(a, tq.DenseLinear) and a.bias is None and b.bias is None, where
            same(a.w, b.w, where + ".w")
        else:                                        # an array: dtype and bits
            want = np.asarray(b)
            got = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
            assert str(a.dtype).split(".")[1] == str(want.dtype), where
            np.testing.assert_array_equal(got, want.astype(np.float32)
                                          if a.dtype == torch.bfloat16 else want, err_msg=where)

    same(p.params, j.params, "params")


@pytest.mark.parametrize("mla_cache", ["speed", "memory"])
def test_logits_match_jax_and_hf(tiny, mla_cache):
    j, p = _load(tiny["short"], mla_cache)
    ids = np.array([IDS[:8]])
    lj = np.asarray(j.forward_logits(ids.astype(np.int32))[0])
    lp = p.forward_logits(ids)[0].numpy()
    np.testing.assert_allclose(lp, lj, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        ref = tiny["hf"](torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(lp, ref, atol=3e-3, rtol=3e-3)


GREEDY_KEYS = [("speed", "bfloat16"), ("speed", "int8"), ("memory", "bfloat16"),
               ("memory", "float32")]


@pytest.mark.parametrize("block", [1, 16])
@pytest.mark.parametrize("mla_cache,cache", GREEDY_KEYS)
def test_greedy_tokens_match(tiny, mla_cache, cache, block):
    j, p = _load(tiny["short"], mla_cache, cache_dtype=cache)
    p.engine.decode_block = block
    jout, _, jn = j.engine.generate(IDS, JGen(do_sample=False, max_new_tokens=16))
    pout, _, pn = p.engine.generate(IDS, TGen(do_sample=False, max_new_tokens=16))
    assert len(pout) == 16 and pout == jout and pn == jn


def test_q8_cache_takes_k4_at_the_mla_widths(tiny, monkeypatch):
    """A 4096-slot q8 cache: every decode step takes K4 on both sides, at
    the expanded cache's different K and V widths (24 / 16 here)."""
    import chatllm_tpu.ops.attention as jatt

    monkeypatch.setattr(jatt, "_flash_decode_enabled", lambda: True)
    j, p = _load(tiny["long"], cache_dtype="int8")
    assert (p.engine.new_cache(1).k[0].shape[-1], p.engine.new_cache(1).v[0].shape[-1]) == (24, 16)
    tqmm.reset_kernel_dispatch_stats()
    pout, _, pn = p.engine.generate(IDS, TGen(do_sample=False, max_new_tokens=12))
    # 11 decode steps in one block of 12 (its last step speculative), 3 layers
    assert tqmm.kernel_dispatch_stats()["flash_decode:q8kv"] == 3 * 12
    jout, _, jn = j.engine.generate(IDS, JGen(do_sample=False, max_new_tokens=12))
    assert len(pout) == 12 and pout == jout and pn == jn


def test_q8_latent_cache_raises(tiny):
    _, p = _load(tiny["short"], "memory", cache_dtype="int8")
    with pytest.raises(ValueError, match="q8 cache"):
        p.engine.generate(IDS, TGen(do_sample=False, max_new_tokens=2))


# ---------------------------------------------------------------- batching
@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_batched_replies_match_jax_batched_engine(tiny, cache):
    j, p = _load(tiny["long" if cache == "int8" else "short"], cache_dtype=cache)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).tolist() for n in (17, 6, 30, 12)]
    jeng = JBatched(j.cfg, j.params, max_slots=3, decode_block=4,
                    scfg=JSampler(do_sample=False, sampling="greedy"))
    try:
        jout = [list(h) for h in [jeng.submit(q, max_new=10) for q in prompts]]
    finally:
        jeng.shutdown()
    tqmm.reset_kernel_dispatch_stats()
    eng = BatchedEngine(p.cfg, p.params, max_slots=3, decode_block=4,
                        scfg=SamplerConfig(do_sample=False, sampling="greedy"), device="cpu")
    try:
        got = [list(h) for h in [eng.submit(q, max_new=10) for q in prompts]]
    finally:
        eng.shutdown()
    assert got == jout
    # 3 slots x 1 row of one head each: K4 over the 4096-slot q8 cache
    assert (tqmm.kernel_dispatch_stats().get("flash_decode:q8kv", 0) > 0) == (cache == "int8")


def test_batched_engine_refuses_the_latent_cache(tiny):
    j, p = _load(tiny["short"], "memory")
    with pytest.raises(ValueError) as je:
        JBatched(j.cfg, j.params, max_slots=2)
    with pytest.raises(ValueError) as te:
        BatchedEngine(p.cfg, p.params, max_slots=2, device="cpu")
    assert str(te.value) == str(je.value)


# ------------------------------------------------- q4_k through the converter
@pytest.fixture(scope="module")
def q4k(tmp_path_factory):
    from chatllm_tpu.tools.convert import convert

    torch.manual_seed(15)
    d = tmp_path_factory.mktemp("dsv2q4k")
    cfg = transformers.DeepseekV2Config(
        vocab_size=260, hidden_size=256, num_attention_heads=4, num_key_value_heads=4,
        num_hidden_layers=2, intermediate_size=512, moe_intermediate_size=256,
        kv_lora_rank=256, q_lora_rank=None, qk_nope_head_dim=32, qk_rope_head_dim=16,
        v_head_dim=32, n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2,
        first_k_dense_replace=1, moe_layer_freq=1, n_group=1, topk_group=1,
        routed_scaling_factor=1.0, norm_topk_prob=False, scoring_func="softmax",
        topk_method="greedy", max_position_embeddings=512, rope_theta=10000.0,
        rms_norm_eps=1e-6, tie_word_embeddings=False, attention_bias=False,
        rope_scaling=None, aux_loss_alpha=0.0, seq_aux=False, attention_dropout=0.0,
        bos_token_id=256, eos_token_id=257, pad_token_id=257)
    hf = transformers.DeepseekV2ForCausalLM(cfg).eval()
    src = _save_dir(d, hf, cfg, "DeepseekV2ForCausalLM",
                    ["<｜begin▁of▁sentence｜>", "<｜end▁of▁sentence｜>"])
    out = str(d / "dsv2_q4k.bin")
    convert(src, out, "q4_k")
    return out


def test_q4k_prefill_logits_match(q4k):
    rt = dict(compute_dtype="float32", cache_dtype="float32")
    j = jm.load_model(q4k, jm.RuntimeConfig(**rt))
    p = tm.load_model(q4k, tm.RuntimeConfig(**rt), device="cpu")
    assert isinstance(p.params["layers"][1]["attn"]["q"], tq.QuantLinear)
    h = JMessages()
    h.push_back(JRole.USER, "Hello, wörld! 123")
    ids = j.tokenizer.encode_history(h, 256)
    lj = np.asarray(j.forward_logits(np.array([ids], np.int32))[0])
    lp = p.forward_logits(np.array([ids]))[0].numpy()
    scale = np.abs(lj).max()
    assert np.abs(lp - lj).max() <= 2e-2 * scale
    assert (lp.argmax(-1) == lj.argmax(-1)).mean() >= 0.9


@pytest.mark.parametrize("prompt", ["hi", "Hello, wörld! 123 ab  cd\n\nxyz", "中文 µ ½ Ａ！ 2024"])
def test_chat_ids_match(q4k, prompt):
    j = jm.load_model(q4k, jm.RuntimeConfig())
    p = tm.load_model(q4k, tm.RuntimeConfig(), device="cpu")
    jh, th = JMessages(), TMessages()
    for _ in range(2):
        jh.push_back(JRole.USER, prompt)
        th.push_back(TRole.USER, prompt)
        ji = j.tokenizer.encode_history(jh, 512, incremental=False)
        ti = p.tokenizer.encode_history(th, 512, incremental=False)
        assert ti == ji
        jh.push_back(JRole.ASSISTANT, prompt[::-1])
        th.push_back(TRole.ASSISTANT, prompt[::-1])
    assert ti[0] == p.tokenizer.bos_token_id == 256
    assert p.tokenizer.decode(ti) == j.tokenizer.decode(ji)


@pytest.mark.parametrize("mla_cache", ["speed", "memory"])
def test_cli_transcript_matches(q4k, mla_cache):
    argv = ["-m", q4k, "-p", "Tell me a story.", "-t", "0", "--max_new_tokens", "10",
            "--compute_dtype", "f32", "--cache_dtype", "f32", "--mla_cache", mla_cache]
    jlines, _ = _run(jmain, argv)
    tlines, raw = _run(tmain, argv + ["--device", "cpu"])
    assert tlines == jlines
    assert tlines[0] == "You  > Tell me a story." and tlines[1].startswith("A.I. > ")
    assert raw.count("eval time:") == 2


def test_two_layer_cut_moves_with_an_f32_level_perturbation():
    """Why chip_smoke.py holds the 2-layer DeepSeek-V2-Lite cut on the card
    to 2e-2 of the logit scale of the CPU run (DSV2_CUT_TOL) at the
    positions whose expert picks agree, and lets near-tied picks differ: on
    the CPU alone, norm weights of 1 + 1e-6 * randn (a difference of the
    size another f32 summation order makes) move the full-width cut's
    router scores by ~3e-3 and its logits by more than 1e-3 of their scale,
    and flip the picks of some tokens, each between two experts whose
    scores are closer than twice the largest score difference
    (chip_smoke._moe_picks's rule).  The bf16 roundings of the activations
    flip with such differences, and random weights amplify them."""
    import chip_smoke
    import chatllm_tpu_torch.nn.transformer as T
    from chatllm_tpu_torch.models.synthetic import (build_synthetic_params,
                                                    deepseek_v2_lite_config)
    from chatllm_tpu_torch.ops.qmm import matmul

    cfg = deepseek_v2_lite_config(1024)
    cfg = dataclasses.replace(cfg, num_hidden_layers=2, layer_specs=cfg.layer_specs[:2])
    params = build_synthetic_params(cfg, "q4k", zeros=False, seed=0, device="cpu", centered=True)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 64)))
    route = T.moe_route

    def run(p):
        rec = []

        def recorded(c, p_, xt):
            topi, topv = route(c, p_, xt)
            rec.append((torch.sort(topi, dim=-1).values,
                        torch.softmax(matmul(xt, p_["gate"]).float(), dim=-1)))
            return topi, topv

        T.moe_route = recorded
        try:
            with torch.inference_mode():
                lg = T.transformer_forward(cfg, p, ids, T.init_cache(cfg, 1, 1024), 0)[0][0]
        finally:
            T.moe_route = route
        return lg, rec[0]

    base, base_picks = run(params)
    gen = torch.Generator().manual_seed(0)

    def moved(norm):
        return {"w": norm["w"] * (1 + 1e-6 * torch.randn(norm["w"].shape, generator=gen))}

    layers = tuple(dict(L, attn_norm=moved(L["attn_norm"]), ffn_norm=moved(L["ffn_norm"]))
                   for L in params["layers"])
    other, other_picks = run(dict(params, layers=layers))
    agree, r = chip_smoke._moe_picks("perturbed", other_picks, base_picks)
    assert r["picks_differ"] >= 1 and r["max_score_diff"] > 1e-4, r
    rel = ((other[agree] - base[agree]).abs().max() / base.abs().max()).item()
    assert 1e-3 < rel < chip_smoke.DSV2_CUT_TOL, rel


@pytest.mark.parametrize("case", ["f32", "f32_q8", "f32_latent", "q4k", "q4k_q8", "q4k_latent"])
def test_tiny_fixture_moves_with_an_f32_level_perturbation(tmp_path, case):
    """Why tests/test_torch_cuda.py holds chip_smoke.write_deepseek_v2_ggmm's
    model on the card to the CPU within each case's tolerance of
    chip_smoke.DSV2_TINY_CASES: on the CPU alone, norm weights of 1 + 1e-6 *
    randn (a difference of the size another f32 summation order makes) move
    the logits of a prompt and 10 more tokens by less than it; over a q8
    cache by more than 1e-4 (the perturbation flips int8 roundings of the
    cache), so that case cannot be held to the f32 cache's 1e-4."""
    import chip_smoke
    from chatllm_tpu_torch.ggmm.quants import GGMLType

    fmt, compute, cache, mla_cache, max_len, tol = chip_smoke.DSV2_TINY_CASES[case]
    path = chip_smoke.write_deepseek_v2_ggmm(tmp_path / "m.bin", max_len=max_len,
                                             dtype=GGMLType.F32 if fmt == "f32" else None)
    m = tm.load_model(str(path), tm.RuntimeConfig(compute_dtype=compute, cache_dtype=cache,
                                                  mla_cache=mla_cache), device="cpu")
    ids = np.array([m.tokenizer.encode("Hello from the card") + [70, 357, 57, 141, 91, 362,
                                                                 133, 227, 20, 324]])
    base = m.forward_logits(ids)[0].float()
    gen = torch.Generator().manual_seed(0)

    def moved(norm):
        return {"w": norm["w"] * (1 + 1e-6 * torch.randn(norm["w"].shape, generator=gen))}

    m.params = dict(m.params, layers=tuple(
        dict(L, attn_norm=moved(L["attn_norm"]), ffn_norm=moved(L["ffn_norm"]))
        for L in m.params["layers"]))
    rel = ((m.forward_logits(ids)[0].float() - base).abs().max() / base.abs().max()).item()
    assert rel < tol, rel
    if cache == "q8_0" and fmt == "f32":
        assert rel > 1e-4, rel
