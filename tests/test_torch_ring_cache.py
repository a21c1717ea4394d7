"""The port's sliding-window ring cache against the JAX package's, on the CPU,
with SWA_EXTRA shrunk to 16 in both packages (as tests/test_batching.py
does) over a narrow Mistral GGMM of window 8 written with the JAX package's
writer: rings of 24 slots in a context of 1024, so that test-sized prompts
and decodes wrap them.

  - the ring write and `_ring_attention` inside `attention_block`, over
    f32, bf16 and q8 caches, with an int offset (a prefill chunk), a 0-d
    offset (the captured decode block's) and per-slot [B] offsets (the
    batched decode), past the wrap, with and without attention sinks: the
    block's output within 1e-5 of the JAX one's scale, the slots written
    (and only they) equal to the JAX cache's;
  - the engines' ring rules: prefill chunks capped to SWA_EXTRA, rings not
    bounding a prompt's room, each ring read whole by a decode block;
  - InferenceEngine's greedy tokens across the wrap equal to the JAX
    engine's over each cache, for rings alone and for layers alternating
    between a ring and full attention;
  - BatchedEngine with staggered arrivals (tests/test_batching.py's
    scenario) equal to the single-stream engine, slot by slot;
  - the dense windowed route (no ring: a 4608-slot cache, window 4096)
    through the port's K3 and K4 routes (their plain versions) and its
    dense route, against `chatllm_tpu/ops/attention.py` (the JAX package's
    K3 in interpret mode), route for route."""
import dataclasses

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import torch_one_thread  # noqa: F401  (one intra-op thread: see its docstring)

import jax.numpy as jnp

import chip_smoke
import chatllm_tpu.models as jm
import chatllm_tpu.nn.transformer as jtr
import chatllm_tpu_torch.models as tm
import chatllm_tpu_torch.nn.transformer as ttr
from chatllm_tpu.ggmm.quants import GGMLType
from chatllm_tpu.ggmm.writer import GGMMWriter
from chatllm_tpu.ops.rope import precompute_rope_cache as j_rope
from chatllm_tpu.ops.sampling import SamplerConfig as JSampler
from chatllm_tpu.runtime.generate import GenerationConfig as JGen, InferenceEngine as JEngine
from chatllm_tpu_torch.ops.rope import precompute_rope_cache as t_rope
from chatllm_tpu_torch.ops.sampling import SamplerConfig
from chatllm_tpu_torch.runtime.batching import BatchedEngine
from chatllm_tpu_torch.runtime.generate import GenerationConfig as TGen, InferenceEngine
from test_torch_attention_switches import _inputs, _rel, _run, env  # noqa: F401

WINDOW, EXTRA, RING = 8, 16, 24
CACHES = {"f32": "float32", "bf16": "bfloat16", "q8": "int8"}
F32 = dict(compute_dtype="float32", cache_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def small_ring():
    """Rings of WINDOW + EXTRA slots in both packages; both read SWA_EXTRA
    when a cache or an engine is made."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "SWA_EXTRA", EXTRA)
        mp.setattr(ttr, "SWA_EXTRA", EXTRA)
        yield


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return str(chip_smoke.write_family_ggmm(tmp_path_factory.mktemp("ring") / "mistral_w8.bin",
                                            "mistral", dtype=GGMLType.F32, seed=11,
                                            writer_cls=GGMMWriter, window=WINDOW))


_PAIRS: dict = {}


def pair(path, cache="float32"):
    """The file in both packages, f32 activations, the given cache."""
    if cache not in _PAIRS:
        rt = dict(F32, cache_dtype=cache)
        _PAIRS[cache] = (jm.load_model(path, jm.RuntimeConfig(**rt)),
                         tm.load_model(path, tm.RuntimeConfig(**rt), device="cpu"))
    return _PAIRS[cache]


def mixed(j, t):
    """Both configs with layer 0 a window-8 ring and layer 1 full attention."""
    return (dataclasses.replace(j.cfg, layer_specs=(jtr.LayerSpec(sliding_window=WINDOW),
                                                    jtr.LayerSpec())),
            dataclasses.replace(t.cfg, layer_specs=(ttr.LayerSpec(sliding_window=WINDOW),
                                                    ttr.LayerSpec())))


def test_ring_slots_and_engine_rules(path):
    j, t = pair(path)
    assert t.cfg.layer_spec(0).sliding_window == j.cfg.layer_spec(0).sliding_window == WINDOW
    assert t.cfg.max_length == 1024
    kv = t.engine.new_cache(1)
    assert [k.shape[1] for k in kv.k] == [np.shape(k)[1] for k in j.engine.new_cache(1).k] \
        == [RING, RING]
    assert t.engine._chunk_cap == j.engine._chunk_cap == EXTRA
    # rings do not bound a prompt's room; a ring-only model has no KV bucket
    assert t.engine._write_capacity(kv) == j.engine._write_capacity(j.engine.new_cache(1)) == 1024
    assert t.engine.decode_kv_len(kv, 100) is None
    jm_cfg, tm_cfg = mixed(j, t)
    eng = InferenceEngine(tm_cfg, t.params, device="cpu")
    kv = eng.new_cache(1)
    assert [k.shape[1] for k in kv.k] == [RING, 1024]
    assert eng._write_capacity(kv) == JEngine(jm_cfg, j.params)._write_capacity(
        JEngine(jm_cfg, j.params).new_cache(1)) == 1024
    assert eng.decode_kv_len(kv, 100) == 1024      # the full-attention layer's bucket
    # a context that a ring does not undercut: no ring, no cap
    eng = InferenceEngine(dataclasses.replace(t.cfg, max_length=RING), t.params, device="cpu")
    assert [k.shape[1] for k in eng.new_cache(1).k] == [RING, RING] and not eng._chunk_cap
    assert not ttr.is_ring(eng.cfg, eng.cfg.layer_spec(0), RING)


def _caches(j, t, B: int, cache: str, seed: int):
    """Random ring contents, the same in a JAX and a port cache of B rows."""
    gen = torch.Generator().manual_seed(seed)
    tc = t.engine.new_cache(B)
    spec = {"k": tc.k, "v": tc.v}
    jc = {}
    for name, planes in spec.items():
        dst = planes[0]
        if cache == "int8":
            x = torch.randint(-127, 128, dst.shape, generator=gen, dtype=torch.int32).to(torch.int8)
            sc = torch.rand(dst.shape[:3], generator=gen) * 0.02 + 1e-3
            getattr(tc, name + "_scale")[0].copy_(sc)
            jc[name + "_scale"] = jnp.asarray(sc.numpy())
            jc[name] = jnp.asarray(x.numpy())
        else:
            x = torch.randn(dst.shape, generator=gen).to(dst.dtype)
            jc[name] = jnp.asarray(x.float().numpy()).astype(
                jnp.bfloat16 if cache == "bfloat16" else jnp.float32)
        dst.copy_(x)
    return jc, tc


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


# (offset form, B, T, offsets): an int (a prefill chunk of 5 rows, wrapping
# from slot 22), a 0-d offset (the captured decode block), per-slot offsets
OFFSETS = {"int": (1, 5, 46), "0d": (1, 1, 61), "per_slot": (2, 1, [27, 50])}


@pytest.mark.parametrize("sinks", [False, True], ids=["", "sinks"])
@pytest.mark.parametrize("form", list(OFFSETS))
@pytest.mark.parametrize("cache", list(CACHES))
def test_attention_block_ring_matches_jax(path, cache, form, sinks):
    j, t = pair(path, CACHES[cache])
    B, T, off = OFFSETS[form]
    jc, tc = _caches(j, t, B, CACHES[cache], seed=len(form) + len(cache))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T, t.cfg.hidden_size)).astype(np.float32)
    offs = np.broadcast_to(np.asarray(off), (B,))
    pos = offs[:, None] + np.arange(T)[None, :]
    jp, tp = dict(j.params["layers"][0]["attn"]), dict(t.params["layers"][0]["attn"])
    if sinks:
        s = rng.standard_normal(t.cfg.num_attention_heads).astype(np.float32)
        jp["sinks"], tp["sinks"] = jnp.asarray(s), torch.from_numpy(s)
    jcos, jsin = j_rope(jnp.asarray(pos, jnp.int32), j.cfg.rope)
    tcos, tsin = t_rope(torch.from_numpy(pos), t.cfg.rope)
    jn = {"int": off, "0d": jnp.int32(off), "per_slot": jnp.asarray(off, jnp.int32)}[form]
    tn = {"int": off, "0d": torch.tensor(off), "per_slot": torch.tensor(off)}[form]
    jout, jk, jv, jks, jvs = jtr.attention_block(
        j.cfg, j.cfg.layer_spec(0), jp, jnp.asarray(x), jcos, jsin, jc["k"], jc["v"], jn,
        jc.get("k_scale"), jc.get("v_scale"))
    tk0 = tc.k[0].clone()
    tout = ttr.attention_block(t.cfg, t.cfg.layer_spec(0), tp, torch.from_numpy(x), tcos, tsin,
                               tc.k[0], tc.v[0], tn,
                               tc.k_scale[0] if tc.k_scale else None,
                               tc.v_scale[0] if tc.v_scale else None)
    ref = _np(jout)
    assert np.abs(tout.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    written = np.zeros((B, RING), bool)
    written[np.arange(B)[:, None], pos % RING] = True
    # the slots not written keep their values; the written ones hold the
    # JAX cache's (q8: at most one int8 step apart, scales within 1e-6)
    assert torch.equal(tc.k[0][~torch.from_numpy(written)], tk0[~torch.from_numpy(written)])
    for tp_, jp_, name in ((tc.k[0], jk, "k"), (tc.v[0], jv, "v")):
        a, b = _np(tp_), _np(jp_)
        if cache == "q8":
            assert np.abs(a - b).max() <= 1
            ts = (tc.k_scale if name == "k" else tc.v_scale)[0].numpy()
            js = np.asarray(jks if name == "k" else jvs)
            np.testing.assert_allclose(ts, js, rtol=1e-6)
        else:
            tol = 1e-5 if cache == "f32" else 2 ** -7
            assert np.abs(a - b).max() <= tol * np.abs(b).max()


_JAX_TOKENS: dict = {}


def _generate(eng, ids, new, gen_cls, cache=None):
    return list(eng.generate(ids, gen_cls(do_sample=False, max_new_tokens=new),
                             cache=cache)[0])


PROMPT = np.random.default_rng(3).integers(3, 380, 30).tolist()
NEW = 40


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("layers", ["rings", "mixed"])
def test_engine_tokens_across_the_wrap_match_jax(path, cache, layers):
    """A 30-token prompt (two chunks of at most 16) and 40 greedy tokens:
    decode wraps the 24-slot rings twice, in blocks of 16 whose speculative
    steps wrap too."""
    j, t = pair(path, CACHES[cache])
    if layers == "rings":
        jeng, teng = j.engine, t.engine
    else:
        jc, tc_ = mixed(j, t)
        jeng, teng = JEngine(jc, j.params), InferenceEngine(tc_, t.params, device="cpu")
    key = (cache, layers)
    if key not in _JAX_TOKENS:
        logits = np.asarray(jeng.prefill(PROMPT, jeng.new_cache(1), 0)[0], np.float32)
        _JAX_TOKENS[key] = logits, _generate(jeng, PROMPT, NEW, JGen)
    jl, jt = _JAX_TOKENS[key]
    with torch.inference_mode():
        tl = teng.prefill(PROMPT, teng.new_cache(1), 0)[0].float().numpy()
        tt = _generate(teng, PROMPT, NEW, TGen)
    assert np.abs(tl - jl).max() <= 1e-4 * np.abs(jl).max()
    assert tt == jt and len(tt) == NEW


@pytest.mark.parametrize("block", [1, 4])
def test_decode_blocks_across_the_wrap(path, block):
    """Blocks of 1 and 4 steps give the default block's tokens (the block's
    speculative steps wrap onto slots outside every window)."""
    j, t = pair(path)
    eng = InferenceEngine(t.cfg, t.params, device="cpu", decode_block=block)
    with torch.inference_mode():
        got = _generate(eng, PROMPT, NEW, TGen)
        want = _generate(t.engine, PROMPT, NEW, TGen)
    assert got == want


PROMPTS = [np.random.default_rng(11).integers(3, 380, n).tolist() for n in (15, 30, 7, 22)]


@pytest.mark.parametrize("cache", ["bf16", "q8"])
@pytest.mark.parametrize("layers", ["rings", "mixed"])
def test_batched_staggered_arrivals_match_single(path, cache, layers):
    """Four streams over two slots (tests/test_batching.py:121-160): later
    streams are admitted while earlier ones sit mid-ring at another phase;
    every stream decodes past the wrap."""
    j, t = pair(path, CACHES[cache])
    cfg = t.cfg if layers == "rings" else mixed(j, t)[1]
    single = InferenceEngine(cfg, t.params, device="cpu")
    with torch.inference_mode():
        expect = [_generate(single, p, 25, TGen) for p in PROMPTS]
    eng = BatchedEngine(cfg, t.params, max_slots=2, decode_block=4,
                        scfg=SamplerConfig(do_sample=False, sampling="greedy"), device="cpu")
    assert eng._chunk_cap == EXTRA
    try:
        got = [list(h) for h in [eng.submit(p, max_new=25) for p in PROMPTS]]
    finally:
        eng.shutdown()
    assert got == expect


def test_batched_tokens_match_jax_batched(path):
    """The port's and the JAX package's BatchedEngine give the same streams
    over q8 rings."""
    from chatllm_tpu.runtime.batching import BatchedEngine as JBatched

    j, t = pair(path, "int8")
    engines = (JBatched(j.cfg, j.params, max_slots=2, decode_block=4,
                        scfg=JSampler(do_sample=False, sampling="greedy")),
               BatchedEngine(t.cfg, t.params, max_slots=2, decode_block=4,
                             scfg=SamplerConfig(do_sample=False, sampling="greedy"),
                             device="cpu"))
    outs = []
    for eng in engines:
        try:
            outs.append([list(h) for h in [eng.submit(p, max_new=25) for p in PROMPTS]])
        finally:
            eng.shutdown()
    assert outs[0] == outs[1]


# (case, B, T, S, Hq, Hkv, D, cache, n_past, the port's route): a 4608-slot
# cache without a ring and window 4096, at Mistral-7B's GQA of 4
DENSE_WINDOWED = {
    "k3_chunk_past_window": (1, 128, 4608, 8, 2, 64, "float32", 4200, {"flash_attention": 1}),
    "k4_q8_step": (1, 1, 4608, 8, 2, 64, "int8", 4500, {"flash_decode:q8kv": 1}),
    "k4_q8_slots": (2, 1, 4608, 8, 2, 64, "int8", [4300, 4600], {"flash_decode:q8kv": 1}),
    "dense_bf16_step": (1, 1, 4608, 8, 2, 64, "bfloat16", 4500, {}),
    "dense_f32_rows": (1, 4, 4608, 8, 2, 64, "float32", 4400, {}),
}


@pytest.mark.parametrize("case", list(DENSE_WINDOWED))
def test_dense_windowed_routes_match_jax(env, case):  # noqa: F811
    """With max_length <= window + SWA_EXTRA the model keeps full-length
    caches and attends through the windowed routes: K3 on a chunk past the
    window, K4 on q8 decode steps (one row and per-slot rows), the dense
    route otherwise; the JAX package takes the same route (its K3 in
    interpret mode) and agrees within f32 (D 64: f32 dots in every route)."""
    setenv, k3 = env
    setenv(CHATLLM_TPU_FLASH="1")
    B, T, S, Hq, Hkv, D, cache, n_past, route = DENSE_WINDOWED[case]
    args = _inputs(B, T, S, Hq, Hkv, D, cache, len(case), n_past)
    out, ref, troutes, jroutes = _run(args, T, scale=D ** -0.5, sliding_window=4096)
    assert troutes == route and bool(k3) == ("flash_attention" in route)
    assert jroutes == {k: v for k, v in route.items() if k != "flash_attention"}
    assert out.shape == (B, T, Hq, D) and _rel(out, ref) <= 1e-5
