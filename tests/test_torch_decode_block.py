"""The port's decode block (runtime/decode_graph.py) on the CPU, where it runs
uncaptured: the engine's greedy tokens and n_past against the JAX
`InferenceEngine.generate` at decode_block 1, 4 and 16 over bf16, f32 and
q8 caches, on tiny Llama-3 and Qwen2 GGMMs written with the JAX package's
writer (f32 weights and compute); the device-n_past attention routes
against the int routes at the KV bucket edges; the device-side penalty ring
against JAX `penalty_accept`; and a chi-square test of the sampled draw.

The JAX engine's consumed tokens do not depend on its block (a block's
steps past the budget are speculative), so its reference runs at block 1,
one compiled decode block for every scenario: where `should_stop` ends the
port's run after one block of b steps, the reference stops after b blocks
of one step."""
import numpy as np
import pytest
import scipy.stats
import torch

import conftest  # noqa: F401
import torch_one_thread  # noqa: F401  (one intra-op thread: see its docstring)

import chip_smoke
import chatllm_tpu.models as jm
import chatllm_tpu.ops.sampling as jsamp
import chatllm_tpu_torch.models as tm
import chatllm_tpu_torch.ops.sampling as tsamp
from chatllm_tpu.ggmm.quants import GGMLType
from chatllm_tpu.ggmm.writer import GGMMWriter
from chatllm_tpu.runtime.generate import GenerationConfig as JGen
from chatllm_tpu.runtime.generate import InferenceEngine as JEngine
from chatllm_tpu_torch.ops.attention import attention_with_cache, quantize_kv
from chatllm_tpu_torch.runtime.decode_graph import kv_bucket
from chatllm_tpu_torch.runtime.generate import GenerationConfig as TGen
from chatllm_tpu_torch.runtime.generate import InferenceEngine as TEngine

MAX_LEN = 256
CACHES = ["bfloat16", "float32", "int8"]
BLOCKS = [1, 4, 16]
# Qwen2 untied at seed 2: its greedy run does not settle on one token
WRITERS = {"llama3": (chip_smoke.write_llama3_ggmm, dict(seed=3)),
           "qwen2": (chip_smoke.write_qwen2_ggmm, dict(seed=2, tie=False))}
PROMPT = np.random.default_rng(1).integers(0, 300, 20).tolist()
LONG_PROMPT = np.random.default_rng(2).integers(0, 300, MAX_LEN - 3).tolist()
SCENARIOS = ["max_new_11", "near_max_length", "terminator_mid_block", "completion_limit",
             "should_stop_after_one_block"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    out = {}
    for name, (write, kw) in WRITERS.items():
        path = str(tmp_path_factory.mktemp("ggmm") / f"{name}.bin")
        write(path, dtype=GGMLType.F32, writer_cls=GGMMWriter, max_len=MAX_LEN, **kw)
        for cache in CACHES:
            rt = dict(compute_dtype="float32", cache_dtype=cache)
            out[name, cache] = (jm.load_model(path, jm.RuntimeConfig(**rt)),
                                tm.load_model(path, tm.RuntimeConfig(**rt), device="cpu"))
    return out


_JAX_RUNS: dict = {}
_JAX_ENGINES: dict = {}


def _jax_run(models, name, cache, scenario, stop_after=1):
    """The JAX engine's run of a scenario at block 1, once per module (one
    engine per model and cache, so its compiled functions serve every
    run)."""
    key = (name, cache, scenario, stop_after)
    if key not in _JAX_RUNS:
        if (name, cache) not in _JAX_ENGINES:
            j = models[name, cache][0]
            _JAX_ENGINES[name, cache] = JEngine(j.cfg, j.params, decode_block=1)
        _JAX_RUNS[key] = _generate(_JAX_ENGINES[name, cache], JGen, scenario, models, name,
                                   cache, stop_after)
    return _JAX_RUNS[key]


def _terminator(models, name, cache):
    """A token the plain greedy run first emits mid-block (index k >= 5,
    k % 4 != 0), and k."""
    out = _jax_run(models, name, cache, "plain")[0]
    k = next(i for i in range(5, len(out)) if i % 4 and out[i] not in out[:i])
    return out[k], k


def _generate(eng, gen_cls, scenario, models, name, cache, stop_after=1):
    """Run one scenario; returns (tokens, n_past, cache, should_stop calls).
    `should_stop` lets `stop_after` blocks run."""
    calls = []
    kw, ids, max_new = {}, PROMPT, 16
    if scenario == "max_new_11":
        max_new = 11
    elif scenario == "near_max_length":
        ids = LONG_PROMPT
    elif scenario == "terminator_mid_block":
        tok, _ = _terminator(models, name, cache)
        kw["is_terminator"] = lambda t: t == tok
    elif scenario == "completion_limit":
        kw["completion_limit"] = 5
    elif scenario == "should_stop_after_one_block":
        max_new = 40
        kw["should_stop"] = lambda: bool(calls.append(1)) or len(calls) > stop_after
    out, c, n = eng.generate(ids, gen_cls(do_sample=False, max_new_tokens=max_new), **kw)
    return out, n, c, len(calls)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("name", list(WRITERS))
def test_greedy_tokens_and_n_past_match_the_jax_engine(models, name, cache, scenario, block):
    p = models[name, cache][1]
    eng = TEngine(p.cfg, p.params, decode_block=block, device="cpu")
    pout, pn, pcache, calls = _generate(eng, TGen, scenario, models, name, cache)
    jout, jn, _, _ = _jax_run(models, name, cache, scenario,
                              block if scenario == "should_stop_after_one_block" else 1)
    assert pout == jout and pn == jn
    if scenario == "max_new_11":
        assert len(pout) == 11 and pn == len(PROMPT) + 10
    elif scenario == "near_max_length":
        # room for two decode steps: a block of 4 or 16 runs steps past the
        # cache, which must write nothing (a wrapped write would land on the
        # prompt's first slots)
        assert len(pout) == 3 and pn == MAX_LEN - 1
        ref = eng.prefill(LONG_PROMPT, eng.new_cache(1, MAX_LEN), 0)[1]
        n = len(LONG_PROMPT)
        for got, want in zip(pcache.k + pcache.v, ref.k + ref.v):
            assert torch.equal(got[:, :n], want[:, :n])
    elif scenario == "terminator_mid_block":
        assert len(pout) == _terminator(models, name, cache)[1]
    elif scenario == "completion_limit":
        assert len(pout) == 5
    else:
        assert calls == 2 and len(pout) == 1 + block


@pytest.fixture(scope="module")
def q8_k4(tmp_path_factory):
    """A q8 cache of 4096 slots: the file in the port and the JAX engine's
    greedy run of it (its flash_decode in interpret mode under its TPU
    routing), made once for every block."""
    import chatllm_tpu.ops.attention as jatt

    path = chip_smoke.write_llama3_ggmm(tmp_path_factory.mktemp("q8") / "q8.bin",
                                        dtype=GGMLType.F32, writer_cls=GGMMWriter, max_len=4096,
                                        seed=11)
    rt = dict(compute_dtype="float32", cache_dtype="int8")
    j = jm.load_model(str(path), jm.RuntimeConfig(**rt))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jatt, "_flash_decode_enabled", lambda: True)
        jout, _, jn = j.engine.generate(PROMPT, JGen(do_sample=False, max_new_tokens=11))
    return tm.load_model(str(path), tm.RuntimeConfig(**rt), device="cpu"), jout, jn


@pytest.mark.parametrize("block", BLOCKS)
def test_q8_cache_k4_route_matches_the_jax_engine(q8_k4, block):
    """A q8 cache of 4096 slots: every decode step takes K4 on both sides
    (the port's plain version, fed the device n_past; the JAX package's
    flash_decode in interpret mode under its TPU routing)."""
    from chatllm_tpu_torch.ops import qmm as tqmm

    p, jout, jn = q8_k4
    tqmm.reset_kernel_dispatch_stats()
    eng = TEngine(p.cfg, p.params, decode_block=block, device="cpu")
    pout, _, pn = eng.generate(PROMPT, TGen(do_sample=False, max_new_tokens=11))
    # 10 decode steps in blocks of b = min(block, max_new): ceil(10 / b)
    # blocks of b steps, each step one K4 call per layer
    b = min(block, 11)
    assert tqmm.kernel_dispatch_stats()["flash_decode:q8kv"] == 2 * -(-10 // b) * b
    assert len(pout) == 11 and pout == jout and pn == jn


@pytest.mark.parametrize("cache", ["bfloat16", "float32"])
def test_sampled_tokens_do_not_depend_on_the_block(models, cache):
    """Sampled decoding with penalties: the draws of one seed come from one
    generator in step order and the penalty ring lives on the device, so
    the tokens are the same at every block size."""
    p = models["llama3", cache][1]
    g = TGen(do_sample=True, max_new_tokens=21, temperature=1.5, top_k=40, top_p=0.95,
             repeat_penalty=1.3, presence_penalty=0.2, penalty_window=8, seed=7)
    runs = [TEngine(p.cfg, p.params, decode_block=b, device="cpu").generate(PROMPT, g)
            for b in BLOCKS]
    assert all(r[0] == runs[0][0] and r[2] == runs[0][2] for r in runs)
    assert len(runs[0][0]) == 21 and len(set(runs[0][0])) > 3


# --------------------------------------------------- attention routes
def _attention_inputs(cache: str, S: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    B, T, Hq, Hkv, D = 1, 1, 8, 2, 64
    q = torch.randn(B, T, Hq, D, generator=gen)
    k, v = (torch.randn(B, S, Hkv, D, generator=gen) for _ in range(2))
    if cache == "int8":
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return q, k, v, dict(k_scale=ks, v_scale=vs)
    return q, k.to(getattr(torch, cache)), v.to(getattr(torch, cache)), {}


# (n_past, block): each block's bucket edge, from both sides
EDGES = [(0, 1), (1007, 16), (1008, 16), (1009, 16), (1023, 1), (1024, 1), (2040, 16),
         (2047, 1), (3000, 4)]


@pytest.mark.parametrize("n_past,block", EDGES)
@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("S", [4096, 3072])
def test_device_n_past_route_equals_the_int_route(monkeypatch, S, cache, n_past, block):
    """Every step j of a block at n_past + j with the block's KV bucket:
    at S 4096 the chunked path (K4 off, so a q8 cache takes it too) is the
    int route bit for bit; at S 3072 the dense path reads the bucket, masked
    past n_past + 1, within 1e-6 of the output scale."""
    monkeypatch.setenv("CHATLLM_TPU_FLASH_DECODE", "0")
    q, k, v, kw = _attention_inputs(cache, S, n_past)
    kv_len = kv_bucket(n_past + block, S)
    for j in range(block):
        pos = n_past + j
        want = attention_with_cache(q, k, v, pos, scale=0.125, **kw)
        got = attention_with_cache(q, k, v, torch.tensor(pos), scale=0.125, kv_len=kv_len, **kw)
        if S >= 4096:
            assert torch.equal(got, want), (pos, kv_len)
        else:
            assert (got - want).abs().max() <= 1e-6 * want.abs().max(), (pos, kv_len)


def test_device_n_past_k4_route_equals_the_int_route():
    """A q8 cache of 4096 slots under the default routing takes K4 (its
    plain version here) with the device n_past as its [B] vector."""
    from chatllm_tpu_torch.ops import qmm as tqmm

    q, k, v, kw = _attention_inputs("int8", 4096, 5)
    tqmm.reset_kernel_dispatch_stats()
    for pos in (0, 1023, 4095):
        want = attention_with_cache(q, k, v, pos, scale=0.125, **kw)
        got = attention_with_cache(q, k, v, torch.tensor(pos), scale=0.125, kv_len=1024, **kw)
        assert torch.equal(got, want)
    assert tqmm.kernel_dispatch_stats()["flash_decode:q8kv"] == 6


# ------------------------------------------------------ sampling state
@pytest.mark.parametrize("batched", [False, True])
def test_device_penalty_ring_matches_jax(batched):
    """300 accepted tokens through a 256-slot ring (it wraps): the count
    vector, the history and the device write position equal the JAX
    package's after every 50 tokens."""
    import jax.numpy as jnp

    V, window, B = 300, 256, 3
    toks = np.random.default_rng(0).integers(0, V, (300, B))
    if batched:
        js = jsamp.PenaltyState(jnp.zeros((B, V), jnp.int32), jnp.full((B, window), -1, jnp.int32),
                                jnp.zeros(B, jnp.int32))
        ts = tsamp.PenaltyState(torch.zeros(B, V, dtype=torch.int32),
                                torch.full((B, window), -1, dtype=torch.int64),
                                torch.zeros(B, dtype=torch.int64))
    else:
        js, ts = jsamp.PenaltyState.init(V, window), tsamp.PenaltyState.init(V, window)
    for i, row in enumerate(toks, 1):
        if batched:
            js = jsamp.penalty_accept_batched(js, jnp.asarray(row, jnp.int32))
            tsamp.penalty_accept_batched(ts, torch.from_numpy(row))
        else:
            js = jsamp.penalty_accept(js, jnp.int32(row[0]))
            tsamp.penalty_accept(ts, torch.tensor(row[0]))
        if i % 50 == 0 or i == len(toks):
            for f in ("token_count", "history", "write_pos"):
                np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    assert ts.write_pos.dim() == (1 if batched else 0)


def test_sampled_draw_passes_a_chi_square_test():
    """6000 draws of one seed over fixed logits, against the probabilities
    left after temperature, top-k and top-p: the chi-square statistic stays
    below its 0.999 quantile (p = 1e-3), and no filtered token is drawn."""
    cfg = tsamp.SamplerConfig(do_sample=True, temperature=0.9, top_k=8, top_p=0.95)
    logits = torch.from_numpy(np.random.default_rng(3).normal(0, 2, 64).astype(np.float32))
    probs = torch.softmax(tsamp.filter_logits(logits, cfg), dim=-1).double().numpy()
    kept = np.flatnonzero(probs > 0)
    gen = torch.Generator().manual_seed(0)
    n = 6000
    draws = np.array([int(tsamp.sample_token(logits, cfg, gen)[0]) for _ in range(n)])
    assert set(draws) <= set(kept) and len(kept) > 2
    obs = np.bincount(draws, minlength=64)[kept]
    exp = probs[kept] * n
    stat = ((obs - exp) ** 2 / exp).sum()
    assert stat < scipy.stats.chi2.ppf(0.999, len(kept) - 1), (stat, obs, exp)
