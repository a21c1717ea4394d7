"""The port's continuous-batching engine: each stream's greedy tokens equal
the port's single-stream engine's (f32 and q8 caches; at max_length 4096 a
q8 cache takes K4, its plain version here), slots are freed and reused,
requests beyond the slots queue, and the tokens equal the JAX package's
BatchedEngine's on the same weights (pattern: tests/test_batching.py)."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import chip_smoke
import chatllm_tpu.models as jm
import chatllm_tpu_torch.models as tm
from chatllm_tpu.ggmm.quants import GGMLType
from chatllm_tpu.ops.sampling import SamplerConfig as JSampler
from chatllm_tpu.runtime.batching import BatchedEngine as JBatched
from chatllm_tpu_torch.ops import qmm as tqmm
from chatllm_tpu_torch.ops.sampling import SamplerConfig
from chatllm_tpu_torch.runtime.batching import BatchedEngine
from chatllm_tpu_torch.runtime.generate import GenerationConfig

GREEDY = SamplerConfig(do_sample=False, sampling="greedy")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("batching")
    long_ctx = chip_smoke.write_llama3_ggmm(d / "m4096.bin", dtype=GGMLType.F32,
                                            max_len=4096, seed=3)
    out = {cache: tm.load_model(str(long_ctx), tm.RuntimeConfig(
        compute_dtype="float32", cache_dtype=cache), device="cpu")
        for cache in ("float32", "int8")}
    short = chip_smoke.write_llama3_ggmm(d / "m256.bin", dtype=GGMLType.F32,
                                         max_len=256, seed=4)
    return out, str(short)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in lengths]


def _single(model, ids, max_new):
    out, _, _ = model.engine.generate(
        ids, GenerationConfig(do_sample=False, max_new_tokens=max_new))
    return out


def _batched(cfg, params, prompts, max_new, *, slots, **kw):
    eng = BatchedEngine(cfg, params, max_slots=slots, decode_block=4, scfg=GREEDY,
                        device="cpu", **kw)
    try:
        handles = [eng.submit(p, max_new=max_new) for p in prompts]
        return [list(h) for h in handles]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_concurrent_streams_match_single(models, cache):
    """Five prompts over three slots: two queue behind the first three."""
    model = models[0][cache]
    prompts = _prompts(7, (9, 23, 40, 5, 31))
    expect = [_single(model, p, 12) for p in prompts]
    tqmm.reset_kernel_dispatch_stats()
    got = _batched(model.cfg, model.params, prompts, 12, slots=3)
    assert got == expect
    # a q8 cache of 4096 slots with B*G*T = 3*2*1 rows takes K4
    assert (tqmm.kernel_dispatch_stats().get("flash_decode:q8kv", 0) > 0) == (cache == "int8")


def test_early_termination_frees_slot(models):
    model = models[0]["int8"]
    p1 = _prompts(8, (12,))[0]
    full = _single(model, p1, 20)
    k = next(i for i in range(3, len(full)) if full[i] not in full[:i])
    stop_tok = full[k]
    eng = BatchedEngine(model.cfg, model.params, max_slots=2, decode_block=4, scfg=GREEDY,
                        device="cpu")
    try:
        h = eng.submit(p1, max_new=20, is_terminator=lambda t: t == stop_tok)
        assert list(h) == full[:k]
        h2 = eng.submit(p1, max_new=8)          # the slot is reused, same result
        assert list(h2) == full[:8]
        assert all(s["state"] == 0 for s in eng.active_slots())
    finally:
        eng.shutdown()


def test_more_requests_than_slots_queue(models):
    """Six requests on one slot run one after another, each whole."""
    model = models[0]["float32"]
    prompts = _prompts(9, (4, 7, 3, 11, 6, 5))
    expect = [_single(model, p, 5) for p in prompts]
    assert _batched(model.cfg, model.params, prompts, 5, slots=1) == expect


def test_batched_tokens_match_jax_batched_engine(models):
    """The same GGMM in both packages, f32 compute and cache, 3 slots."""
    path = models[1]
    rt = dict(compute_dtype="float32", cache_dtype="float32")
    j = jm.load_model(path, jm.RuntimeConfig(**rt))
    p = tm.load_model(path, tm.RuntimeConfig(**rt), device="cpu")
    prompts = _prompts(10, (17, 6, 30, 12))
    jeng = JBatched(j.cfg, j.params, max_slots=3, decode_block=4,
                    scfg=JSampler(do_sample=False, sampling="greedy"))
    try:
        jh = [jeng.submit(q, max_new=10) for q in prompts]
        jout = [list(h) for h in jh]
    finally:
        jeng.shutdown()
    assert _batched(p.cfg, p.params, prompts, 10, slots=3) == jout


def test_sampled_streams_follow_their_seed(models):
    """Sampled decoding draws each slot's tokens from its own generator,
    seeded by its request: the same request gives the same tokens in any
    slot and next to any neighbours."""
    model = models[0]["float32"]
    scfg = SamplerConfig(do_sample=True, sampling="top_p", temperature=1.0, top_k=50,
                         top_p=0.95)
    prompts = _prompts(11, (8, 15, 8))

    def run(order, slots):
        eng = BatchedEngine(model.cfg, model.params, max_slots=slots, decode_block=4,
                            scfg=scfg, device="cpu")
        try:
            hs = {i: eng.submit(prompts[i], max_new=10, seed=100 + i) for i in order}
            return {i: list(h) for i, h in hs.items()}
        finally:
            eng.shutdown()

    a, b = run([0, 1, 2], 3), run([2, 1, 0], 2)
    assert a == b and a[0] != a[2]


def test_engine_defaults_to_the_card(models):
    model = models[0]["float32"]
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchedEngine(model.cfg, model.params, max_slots=2)
