"""The families this slice ports (LLAMA2, CODELLAMA, MISTRAL, MIXTRAL,
MISTRAL2) against the JAX package on the CPU, over narrow GGMMs written with
the JAX package's writer (`chip_smoke.write_family_ggmm`: hidden 256, 2
layers; the SentencePiece-score vocab of `chip_smoke._sp_pieces` for the
first four, a tekken-style byte-level vocab for MISTRAL2, whose heads are
128 wide over a hidden of 256 and 4 heads; Mistral and Mixtral attend over
a window of 64 in rings of 64 + SWA_EXTRA = 576 slots):

  - the loader is the family's, the config's fields equal the JAX
    package's, and every parameter (Mixtral's expert stacks included)
    loads bit-exact;
  - prefill logits within 1e-4 of the logit scale (f32) and greedy tokens
    identical over a FAMILY_RING_PROMPT-token prompt, which wraps the rings
    (q4_k Mistral: 2e-2 of the logit scale, the JAX side's Pallas kernels
    in interpret mode, as on a TPU);
  - BatchedEngine with staggered arrivals equal to the single-stream engine;
  - the chat templates' ids and the CLI's `--test` transcript equal to the
    JAX package's (the ring families' turns wrap their rings);
  - Shift over a ring: the JAX package's `shift_cache` moves a wrapped ring
    slot by slot, so its kept slots and its clamped tail hold the wrong
    positions (its next logits are far from a from-scratch prefill of the
    kept tokens, while the same Shift over a full-length cache matches
    that prefill); the port refuses a wrapped ring and shifts an unwrapped
    one as the JAX package does;
  - HF golden: Mistral against `transformers.MistralForCausalLM` with
    sliding_window 16 over 48 tokens, across the wrap of a 32-slot ring, and
    in one forward over a 48-slot cache.
  - MISTRAL3 is not registered (it waits for the pixtral tower)."""
import contextlib
import dataclasses
import io
import struct
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import torch_one_thread  # noqa: F401  (one intra-op thread: see its docstring)

import jax.numpy as jnp

import chip_smoke
import chatllm_tpu.main as jmain
import chatllm_tpu.models as jm
import chatllm_tpu.nn.transformer as jtr
import chatllm_tpu_torch.main as tmain
import chatllm_tpu_torch.models as tm
import chatllm_tpu_torch.nn.transformer as ttr
from chatllm_tpu.ggmm.quants import GGMLType
from chatllm_tpu.ggmm.writer import GGMMWriter
from chatllm_tpu.runtime.chat import Messages as JMessages, MsgRole as JRole
from chatllm_tpu.runtime.generate import GenerationConfig as JGen, InferenceEngine as JEngine
from chatllm_tpu_torch.models.model_types import ModelType
from chatllm_tpu_torch.ops.sampling import SamplerConfig
from chatllm_tpu_torch.runtime.batching import BatchedEngine
from chatllm_tpu_torch.runtime.chat import Messages as TMessages, MsgRole as TRole
from chatllm_tpu_torch.runtime.generate import GenerationConfig as TGen, shift_cache
from chatllm_tpu_torch.runtime.pipeline import ExtendingMethod as TExt, Pipeline as TPipe
from test_torch_families import CFG_FIELDS, ROPE_FIELDS, _same

# family -> the port's loader
CASES = {"llama2": "Llama2", "codellama": "CodeLlama", "mistral": "Mistral",
         "mixtral": "Mixtral", "mistral2": "Mistral2"}
F32 = dict(compute_dtype="float32", cache_dtype="float32")
NEW = 8


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mistral")
    return {fam: str(chip_smoke.write_family_ggmm(d / f"{fam}.bin", fam, seed=7,
                                                  dtype=GGMLType.F32, writer_cls=GGMMWriter))
            for fam in CASES}


_PAIRS: dict = {}


def pair(files, fam):
    if fam not in _PAIRS:
        _PAIRS[fam] = (jm.load_model(files[fam], jm.RuntimeConfig(**F32)),
                       tm.load_model(files[fam], tm.RuntimeConfig(**F32), device="cpu"))
    return _PAIRS[fam]


def prompt(fam):
    n = chip_smoke.FAMILY_RING_PROMPT if fam in chip_smoke.RING_FAMILIES else 24
    return np.random.default_rng(5).integers(3, 380, n).tolist()


@pytest.mark.parametrize("fam", list(CASES))
def test_config_and_weights_match_jax(files, fam):
    j, t = pair(files, fam)
    assert type(t).__name__ == CASES[fam]
    assert t.model_type == j.model_type == int(ModelType[chip_smoke.FAMILIES[fam][0]])
    for f in CFG_FIELDS:
        assert getattr(t.cfg, f) == getattr(j.cfg, f), f
    for f in ROPE_FIELDS:
        assert getattr(t.cfg.rope, f) == getattr(j.cfg.rope, f), f
    assert [(s.sliding_window, s.is_moe) for s in t.cfg.layer_specs] == \
        [(s.sliding_window, s.is_moe) for s in j.cfg.layer_specs]
    ring = fam in chip_smoke.RING_FAMILIES
    assert t.cfg.layer_spec(0).sliding_window == (chip_smoke.FAMILY_WINDOW if ring else 0)
    assert [k.shape[1] for k in t.engine.new_cache(1).k] == [576 if ring else 512] * 2
    if fam == "mistral2":
        assert t.cfg.resolved_head_dim() == chip_smoke.MISTRAL2_HEAD_DIM != t.cfg.hidden_size // 4
    _same(t.params, j.params, "params")


_JAX_OUT: dict = {}


def _run(model, gen_cls, ids):
    """(prefill logits as f32 numpy, greedy tokens)."""
    eng = model.engine
    logits = eng.prefill(ids, eng.new_cache(1), 0)[0]
    logits = np.asarray(logits.float() if isinstance(logits, torch.Tensor) else logits,
                        np.float32)
    return logits, list(eng.generate(ids, gen_cls(do_sample=False, max_new_tokens=NEW))[0])


@pytest.mark.parametrize("fam", list(CASES))
def test_logits_and_greedy_tokens_match_jax(files, fam):
    j, t = pair(files, fam)
    ids = prompt(fam)
    if fam not in _JAX_OUT:
        _JAX_OUT[fam] = _run(j, JGen, ids)
    jl, jt = _JAX_OUT[fam]
    with torch.inference_mode():
        tl, tt = _run(t, TGen, ids)
    assert np.isfinite(tl).all() and tl.shape == jl.shape
    assert np.abs(tl - jl).max() <= 1e-4 * np.abs(jl).max()
    assert tt == jt and len(tt) == NEW


def test_q4k_mistral_matches_jax(tmp_path, monkeypatch):
    """q4_k weights: the JAX side's quantized matmuls through its Pallas
    kernels in interpret mode, as on a TPU; bf16 activations and cache."""
    import functools

    import chatllm_tpu.ops.qmm as jqmm

    monkeypatch.setattr(jqmm, "use_pallas_qmm", lambda: True)
    monkeypatch.setattr(jqmm, "_pallas_local", functools.partial(jqmm._pallas_local,
                                                                 interpret=True))
    path = str(chip_smoke.write_family_ggmm(tmp_path / "m.bin", "mistral", seed=3,
                                            writer_cls=GGMMWriter))
    j, t = jm.load_model(path), tm.load_model(path, device="cpu")
    _same_bits(t.params, j.params, "params")
    ids = prompt("mistral")[:40]
    jl = np.asarray(j.engine.prefill(ids, j.engine.new_cache(1), 0)[0], np.float32)
    with torch.inference_mode():
        tl = t.engine.prefill(ids, t.engine.new_cache(1), 0)[0].float().numpy()
    assert np.abs(tl - jl).max() <= 2e-2 * np.abs(jl).max()


def _same_bits(a, b, where):
    """The port's parameter tree `a` equals the JAX package's `b` bit for
    bit: dicts, tuples, the linears' fields, arrays of any dtype (bf16
    compared as its 16-bit patterns)."""
    if isinstance(b, dict):
        assert set(a) == set(b), where
        for k in b:
            _same_bits(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_bits(x, y, f"{where}[{i}]")
    elif hasattr(b, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__, where
        for f in b.__dataclass_fields__:
            if hasattr(a, f):
                _same_bits(getattr(a, f), getattr(b, f), f"{where}.{f}")
    elif b is None or isinstance(b, (int, float, bool)):
        assert a == b, where
    else:
        want = np.asarray(b)
        got = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
        if want.dtype.name == "bfloat16":
            want = want.view(np.int16)
        np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize("fam", list(CASES))
def test_batched_staggered_matches_single(files, fam):
    """Three streams over two slots, the third admitted while the others
    decode; the ring families' prompts wrap their rings at other phases."""
    _, t = pair(files, fam)
    base = prompt(fam)
    prompts = [base, base[7:], base[:13]] if fam in chip_smoke.RING_FAMILIES else [
        base, base[:9], base[3:20]]
    with torch.inference_mode():
        expect = [list(t.engine.generate(p, TGen(do_sample=False, max_new_tokens=NEW))[0])
                  for p in prompts]
    eng = BatchedEngine(t.cfg, t.params, max_slots=2, decode_block=4,
                        scfg=SamplerConfig(do_sample=False, sampling="greedy"), device="cpu")
    try:
        got = [list(h) for h in [eng.submit(p, max_new=NEW) for p in prompts]]
    finally:
        eng.shutdown()
    assert got == expect


@pytest.mark.parametrize("fam", list(CASES))
def test_chat_template_ids_match_jax(files, fam):
    j, t = pair(files, fam)
    for tok in (j.tokenizer, t.tokenizer):
        tok.sys_prompt = "Be brief."
    jh, th = JMessages(), TMessages()
    for text in ("Hello, wörld! 12345 [INST]", "中文 µ ½ 2024 😀 <s>"):
        jh.push_back(JRole.USER, text)
        th.push_back(TRole.USER, text)
        ji = j.tokenizer.encode_history(jh, 512, incremental=False)
        ti = t.tokenizer.encode_history(th, 512, incremental=False)
        assert ti == ji
        jh.push_back(JRole.ASSISTANT, text[::-1])
        th.push_back(TRole.ASSISTANT, text[::-1])
    assert t.tokenizer.decode(ti) == j.tokenizer.decode(ji)
    assert t.tokenizer.pad_token_id == j.tokenizer.pad_token_id
    if fam in ("llama2", "codellama"):
        assert ti[0] == t.tokenizer.bos_token_id == 1


@pytest.fixture(scope="module")
def shared_jax_engines():
    """Each JAX CLI load of one file with the same options gets the engine of
    the first, so its compiled stages serve every call of the module."""
    load, engines = jm.load_model, {}

    def shared(path, *args, **kw):
        model = load(path, *args, **kw)
        model._engine = engines.setdefault((str(path), repr(args), repr(kw)), model.engine)
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, "load_model", shared)
        yield


def _cli(mod, argv):
    buf = io.StringIO()
    old, sys.stdin = sys.stdin, io.StringIO("")
    try:
        with contextlib.redirect_stdout(buf):
            assert mod.main(argv) == 0
    finally:
        sys.stdin = old
    return [ln for ln in buf.getvalue().splitlines() if "eval time:" not in ln]


@pytest.mark.parametrize("fam", list(CASES))
def test_cli_transcript_matches_jax(files, fam, tmp_path, shared_jax_engines):
    """`--test` with chip_smoke's two turns (the ring families': ~350 tokens
    each, which wrap the 576-slot rings), greedy, f32."""
    turns = tmp_path / "turns.txt"
    turns.write_text("\n".join(chip_smoke.family_turns(fam)) + "\n")
    argv = ["-m", files[fam], "--test", str(turns), "-t", "0", "--max_new_tokens", "6",
            "--compute_dtype", "f32", "--cache_dtype", "f32"]
    jt, tt = _cli(jmain, argv), _cli(tmain, argv + ["--device", "cpu"])
    assert tt == jt and sum(ln.startswith("A.I.") for ln in tt) == 2


# --------------------------------------------------------------- Shift
@pytest.fixture(scope="module")
def small_ring(tmp_path_factory):
    """A window-8 Mistral with SWA_EXTRA 16 in both packages: rings of 24."""
    path = str(chip_smoke.write_family_ggmm(tmp_path_factory.mktemp("shift") / "w8.bin",
                                            "mistral", dtype=GGMLType.F32, seed=13,
                                            writer_cls=GGMMWriter, window=8))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "SWA_EXTRA", 16)
        mp.setattr(ttr, "SWA_EXTRA", 16)
        yield (jm.load_model(path, jm.RuntimeConfig(**F32)),
               tm.load_model(path, tm.RuntimeConfig(**F32), device="cpu"))


SHIFT_IDS = np.random.default_rng(9).integers(3, 380, 41).tolist()


def _jax_next_logits(j, cache, n_past, tok):
    logits, _ = jtr.transformer_forward(j.cfg, j.params, jnp.asarray([[tok]], jnp.int32),
                                        cache, n_past)
    return np.asarray(logits[0, -1], np.float32)


@pytest.mark.parametrize("context", ["ring", "full"])
def test_jax_shift_over_a_wrapped_ring_is_wrong(small_ring, context, monkeypatch):
    """40 tokens in, keep 4 and drop 8, then one more token at position 32.
    Over a full-length cache (SWA_EXTRA 64: window + SWA_EXTRA is past the
    64-slot context) the JAX Shift gives a from-scratch prefill of the kept
    tokens' next logits; over a wrapped 24-slot ring it does not: its kept
    slots 0-3 hold the ring's latest keys, not the first tokens'."""
    j, _ = small_ring
    if context == "full":
        monkeypatch.setattr(jtr, "SWA_EXTRA", 64)
    cfg = dataclasses.replace(j.cfg, max_length=64)
    eng = JEngine(cfg, j.params)
    ids, tok, keep, shift = SHIFT_IDS[:40], SHIFT_IDS[40], 4, 8
    cache = eng.new_cache(1, 64)
    assert np.shape(cache.k[0])[1] == (24 if context == "ring" else 64)
    _, cache, n_past = eng.prefill(ids, cache, 0)
    shifted = _jax_next_logits(j, eng.shift_cache(cache, shift, keep, n_past),
                               n_past - shift, tok)
    kept = ids[:keep] + ids[keep + shift:]
    fresh = np.asarray(eng.prefill(kept + [tok], eng.new_cache(1, 64), 0)[0][0], np.float32)
    rel = np.abs(shifted - fresh).max() / np.abs(fresh).max()
    if context == "full":
        assert rel <= 1e-4
    else:
        assert rel > 1e-2


def test_port_refuses_shift_over_a_wrapped_ring(small_ring):
    j, t = small_ring
    eng = t.engine
    cache = eng.new_cache(1, 64)
    with torch.inference_mode():
        _, cache, n_past = eng.prefill(SHIFT_IDS[:40], cache, 0)
        with pytest.raises(NotImplementedError, match="wrapped sliding-window ring"):
            eng.shift_cache(cache, 8, 4, n_past)
        with pytest.raises(NotImplementedError, match="wrapped"):
            shift_cache(t.cfg, cache, 8, 4)                # n_past unknown
        # the Pipeline's Shift extending raises too; Restart keeps chatting
        pipe = TPipe(t, extending=TExt.SHIFT)
        pipe._cache = eng.new_cache(1)
        pipe.n_past = eng.max_length - 2                   # the next round must shift
        with pytest.raises(NotImplementedError, match="ring"):
            pipe.chat("hello", gen_config=TGen(do_sample=False, max_new_tokens=2))


def test_port_shift_over_an_unwrapped_ring_matches_jax(small_ring):
    """20 tokens in a 24-slot ring (not wrapped): the port shifts it as the
    JAX package does (the full-length cache's rule)."""
    j, t = small_ring
    ids, keep, shift = SHIFT_IDS[:20], 4, 6
    jeng = j.engine
    _, jc, n = jeng.prefill(ids, jeng.new_cache(1, 64), 0)
    jc = jeng.shift_cache(jc, shift, keep, n)
    with torch.inference_mode():
        _, tc, n2 = t.engine.prefill(ids, t.engine.new_cache(1, 64), 0)
        tc = t.engine.shift_cache(tc, shift, keep, n2)
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        for x, y in zip(a, b):
            y = np.asarray(y, np.float32)
            assert np.abs(x.numpy() - y).max() <= 1e-5 * np.abs(y).max()


# --------------------------------------------------------------- HF golden
def test_mistral_matches_hf_across_the_ring(tmp_path, monkeypatch):
    """The port's Mistral against transformers' MistralForCausalLM (eager
    attention, sliding_window 16, rms_norm_eps 1e-6) over 48 tokens: the
    engine's chunks of SWA_EXTRA = 16 into rings of 32 slots (wrapped at
    token 32), and one forward into a 48-slot cache."""
    transformers = pytest.importorskip("transformers")
    from test_model_golden import _permute

    monkeypatch.setattr(ttr, "SWA_EXTRA", 16)
    vocab, hidden, heads, kv, layers, inter, max_len, win = 384, 64, 4, 2, 2, 96, 128, 16
    torch.manual_seed(21)
    hf = transformers.MistralForCausalLM(transformers.MistralConfig(
        vocab_size=vocab, hidden_size=hidden, num_attention_heads=heads,
        num_key_value_heads=kv, num_hidden_layers=layers, intermediate_size=inter,
        max_position_embeddings=max_len, rope_theta=10000.0, sliding_window=win,
        rms_norm_eps=1e-6, tie_word_embeddings=False, attn_implementation="eager")).eval()
    sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
    path = str(tmp_path / "mistral.bin")
    with open(path, "wb") as f:
        w = GGMMWriter(f, int(ModelType.MISTRAL), 1, meta={})
        w.write_config([int(GGMLType.F32), vocab, hidden, heads, layers, inter, max_len,
                        1, 2, -1, -1, kv, win], fmt="13i")
        f.write(struct.pack("<f", 10000.0))
        w._patch_offset(12)
        w.write_vocab_sp(chip_smoke._sp_pieces(vocab))
        names = ["model.embed_tokens.weight", "model.norm.weight", "lm_head.weight"]
        for i in range(layers):
            names += [f"model.layers.{i}.{n}.weight" for n in (
                "input_layernorm", "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                "self_attn.o_proj", "post_attention_layernorm", "mlp.gate_proj",
                "mlp.up_proj", "mlp.down_proj")]
        for n in names:
            a = sd[n]
            if n.endswith("q_proj.weight"):
                a = _permute(a, heads)
            elif n.endswith("k_proj.weight"):
                a = _permute(a, kv)
            w.write_tensor(n, a, GGMLType.F32)
    model = tm.load_model(path, tm.RuntimeConfig(weight_dtype="float32", **F32), device="cpu")
    assert model.cfg.norm_eps == 1e-6 and model.cfg.layer_spec(0).sliding_window == win
    ids = np.random.default_rng(4).integers(3, vocab, 48)
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids[None].astype(np.int64))).logits[0].numpy()
    eng = model.engine
    assert eng._chunk_cap == 16
    kv_ring = eng.new_cache(1)
    assert kv_ring.k[0].shape[1] == 32
    got = []
    with torch.inference_mode():
        for n in range(0, 48, 16):
            x = torch.from_numpy(ids[None, n:n + 16].astype(np.int64))
            got.append(ttr.transformer_forward(model.cfg, model.params, x, kv_ring, n)[0][0])
        # with the default SWA_EXTRA a 48-slot cache holds every position
        monkeypatch.setattr(ttr, "SWA_EXTRA", 512)
        whole = model.forward_logits(ids)[0][0].numpy()
    np.testing.assert_allclose(torch.cat(got).numpy(), ref, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(whole, ref, atol=2e-3, rtol=2e-3)


def test_mistral3_is_not_registered(tmp_path):
    path = chip_smoke.write_internvl_ggmm(tmp_path / "m.bin", tower=False, layers=1,
                                          dtype=GGMLType.F32, model_type=ModelType.MISTRAL3)
    with pytest.raises(ValueError, match="unsupported model_type"):
        tm.load_model(str(path), device="cpu")
