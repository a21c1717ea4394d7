"""The Gemma family (GEMMA, GEMMA2, GEMMA3) and RNJ_1 in the port against the
JAX package on the CPU, over narrow GGMMs written with the JAX package's
writer (`chip_smoke.write_family_ggmm`: hidden 256, 2 layers, heads of 256
(4 over 2 kv heads; Gemma-3: over 1), the SentencePiece-score vocab of
`chip_smoke._sp_pieces` with Gemma's turn tokens; Gemma-2's layer 0 and
Gemma-3's / RNJ-1's local layer 0 attend over a window of 64 in rings of
64 + SWA_EXTRA = 576 slots, their layer 1 over the whole context):

  - the loader is the family's, the config's fields (softcaps, post-norms,
    the tied head's logit_scale, both rope tables, the layer pattern) equal
    the JAX package's, and every parameter loads bit-exact, in f32 and q4_k;
  - prefill logits within 1e-4 of the logit scale (f32) and greedy tokens
    identical over a FAMILY_RING_PROMPT-token prompt, which wraps the rings
    of the local layers (Gemma-3: on the local rope table) beside a full
    layer; q4_k logits within 2e-2 of the logit scale and greedy tokens
    identical, the JAX side's Pallas kernels in interpret mode;
  - BatchedEngine with staggered arrivals equal to the single-stream engine;
  - the chat template's ids and the CLI's `--test` transcript equal to the
    JAX package's (the ring families' turns wrap their rings);
  - Shift over Gemma-3's local layers: the JAX package's `shift_cache`
    re-rotates every rope layer with the global table, so a local layer's
    moved keys end far from a from-scratch prefill's of the kept tokens
    (with one table for both layers they match); the port refuses;
  - HF golden: Gemma-3 against `transformers.Gemma3ForCausalLM` (the JAX
    package's tests/test_model_golden2.py case) and Gemma-2 against
    `Gemma2ForCausalLM` with both softcaps;
  - GEMMA3Vis still fails to load, naming itself (it waits for SigLIP)."""
import contextlib
import dataclasses
import functools
import io
import struct
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import torch_one_thread  # noqa: F401  (one intra-op thread: see its docstring)

import chip_smoke
import chatllm_tpu.main as jmain
import chatllm_tpu.models as jm
import chatllm_tpu.ops.qmm as jqmm
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
from test_torch_mistral import _same_bits

# family -> the port's loader
CASES = {"gemma": "Gemma", "gemma2": "Gemma2", "gemma3": "Gemma3", "rnj_1": "RNJ1"}
GEMMA_FIELDS = ("act", "logit_softcap", "final_logit_softcap", "post_norms", "logit_scale")
F32 = dict(compute_dtype="float32", cache_dtype="float32")
NEW = 8


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gemma")
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


def _same_config(t, j):
    for f in CFG_FIELDS + GEMMA_FIELDS:
        assert getattr(t.cfg, f) == getattr(j.cfg, f), f
    for rope in ("rope", "rope_local"):
        tr, jr = getattr(t.cfg, rope), getattr(j.cfg, rope)
        assert (tr is None) == (jr is None), rope
        for f in ROPE_FIELDS if tr is not None else ():
            assert getattr(tr, f) == getattr(jr, f), (rope, f)
    assert [(s.sliding_window, s.local_rope) for s in t.cfg.layer_specs] == \
        [(s.sliding_window, s.local_rope) for s in j.cfg.layer_specs]


@pytest.mark.parametrize("fam", list(CASES))
def test_config_and_weights_match_jax(files, fam):
    j, t = pair(files, fam)
    assert type(t).__name__ == CASES[fam]
    assert t.model_type == j.model_type == int(ModelType[chip_smoke.FAMILIES[fam][0]])
    _same_config(t, j)
    assert t.cfg.resolved_head_dim() == chip_smoke.GEMMA_HEAD_DIM == 256
    assert t.cfg.tie_lm_head and t.cfg.logit_scale == 256 ** -0.5
    ring = fam in chip_smoke.RING_FAMILIES
    assert [k.shape[1] for k in t.engine.new_cache(1).k] == ([576, 1024] if ring else [512] * 2)
    if fam in ("gemma3", "rnj_1"):
        assert [s.local_rope for s in t.cfg.layer_specs] == [True, False]
        assert t.cfg.rope_local.freq_base == 10000.0 and t.cfg.rope.freq_base == 1e6
    _same(t.params, j.params, "params")


@pytest.fixture(scope="module")
def q4k_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gemma_q4k")
    return {fam: str(chip_smoke.write_family_ggmm(d / f"{fam}.bin", fam, seed=3,
                                                  writer_cls=GGMMWriter)) for fam in CASES}


@pytest.mark.parametrize("fam", list(CASES))
def test_q4k_config_and_weights_bit_exact(q4k_files, fam):
    j, t = jm.load_model(q4k_files[fam]), tm.load_model(q4k_files[fam], device="cpu")
    _same_config(t, j)
    _same_bits(t.params, j.params, "params")


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
    assert tt == jt and len(tt) == NEW and len(set(tt)) > 1


@pytest.mark.parametrize("fam", list(CASES))
def test_q4k_logits_and_tokens_match_jax(q4k_files, fam, monkeypatch):
    """q4_k weights, bf16 activations and cache: the JAX side's quantized
    matmuls through its Pallas kernels in interpret mode, as on a TPU."""
    monkeypatch.setattr(jqmm, "use_pallas_qmm", lambda: True)
    monkeypatch.setattr(jqmm, "_pallas_local", functools.partial(jqmm._pallas_local,
                                                                 interpret=True))
    j, t = jm.load_model(q4k_files[fam]), tm.load_model(q4k_files[fam], device="cpu")
    ids = prompt(fam)[:40]
    jl, jt = _run(j, JGen, ids)
    with torch.inference_mode():
        tl, tt = _run(t, TGen, ids)
    assert np.abs(tl - jl).max() <= 2e-2 * np.abs(jl).max()
    assert tt == jt


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
    for text in ("Hello, wörld! 12345 <start_of_turn>", "中文 µ ½ 2024 😀 <end_of_turn>"):
        jh.push_back(JRole.USER, text)
        th.push_back(TRole.USER, text)
        ji = j.tokenizer.encode_history(jh, 512, incremental=False)
        ti = t.tokenizer.encode_history(th, 512, incremental=False)
        assert ti == ji
        jh.push_back(JRole.ASSISTANT, text[::-1])
        th.push_back(TRole.ASSISTANT, text[::-1])
    assert t.tokenizer.decode(ti) == j.tokenizer.decode(ji)
    tok = t.tokenizer
    assert ti[0] == tok.bos_token_id and ti[1] == tok.start_of_turn_token_id
    assert tok.end_of_turn_token_id in tok.terminate_ids
    assert (tok.pad_token_id, tok.start_of_turn_token_id, tok.end_of_turn_token_id) == \
        (j.tokenizer.pad_token_id, j.tokenizer.start_of_turn_token_id,
         j.tokenizer.end_of_turn_token_id) == (381, 382, 383)


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
SHIFT_IDS = np.random.default_rng(9).integers(3, 380, 41).tolist()


@pytest.fixture(scope="module")
def dense_gemma3(tmp_path_factory):
    """A Gemma-3 in a 64-slot context: window 64 + SWA_EXTRA is past it, so
    its local layer is no ring (the dense windowed route)."""
    path = str(chip_smoke.write_family_ggmm(tmp_path_factory.mktemp("shift") / "g3.bin",
                                            "gemma3", dtype=GGMLType.F32, seed=13,
                                            writer_cls=GGMMWriter))
    rt = dict(F32, max_length=64)
    return jm.load_model(path, jm.RuntimeConfig(**rt)), tm.load_model(
        path, tm.RuntimeConfig(**rt), device="cpu")


@pytest.mark.parametrize("tables", ["local_and_global", "one_table"])
def test_jax_shift_over_gemma3_local_layers_is_wrong(dense_gemma3, tables):
    """40 tokens in, keep 4 and drop 8.  Layer 0 (local) takes the token
    embeddings, so after a right Shift its 32 keys are those of a
    from-scratch prefill of the kept tokens.  The JAX Shift re-rotates every
    rope layer's moved keys with cfg.rope, but the local layer's were
    rotated with cfg.rope_local (base 1e4, no scaling, against 1e6 / 8):
    they end far from the prefill's.  With the local table set to the
    global one (`one_table`) the same Shift gives the prefill's keys."""
    j, _ = dense_gemma3
    cfg = j.cfg if tables == "local_and_global" else dataclasses.replace(
        j.cfg, rope_local=j.cfg.rope)
    assert cfg.layer_spec(0).local_rope and not cfg.layer_spec(1).local_rope
    eng = JEngine(cfg, j.params)
    ids, keep, shift = SHIFT_IDS[:40], 4, 8
    cache = eng.new_cache(1, 64)
    assert [np.shape(k)[1] for k in cache.k] == [64, 64]
    _, cache, n_past = eng.prefill(ids, cache, 0)
    cache = eng.shift_cache(cache, shift, keep, n_past)
    kept = ids[:keep] + ids[keep + shift:]
    _, fresh, _ = eng.prefill(kept, eng.new_cache(1, 64), 0)
    got, want = (np.asarray(c.k[0], np.float32)[:, :len(kept)] for c in (cache, fresh))
    rel = np.abs(got - want).max() / np.abs(want).max()
    if tables == "one_table":
        assert rel <= 1e-5
    else:
        assert rel > 1e-2


def test_port_refuses_shift_over_gemma3_local_layers(dense_gemma3):
    _, t = dense_gemma3
    eng = t.engine
    with torch.inference_mode():
        _, cache, n_past = eng.prefill(SHIFT_IDS[:40], eng.new_cache(1, 64), 0)
        with pytest.raises(NotImplementedError, match="Gemma-3's local layers"):
            eng.shift_cache(cache, 8, 4, n_past)
        # the Pipeline's Shift extending raises too
        pipe = TPipe(t, extending=TExt.SHIFT)
        pipe._cache = eng.new_cache(1)
        pipe.n_past = eng.max_length - 2                   # the next round must shift
        with pytest.raises(NotImplementedError, match="local"):
            pipe.chat("hello", gen_config=TGen(do_sample=False, max_new_tokens=2))


def test_port_shift_with_one_table_matches_jax(dense_gemma3):
    """Without a second table (cfg.rope_local None: every layer on cfg.rope)
    the port shifts as the JAX package does."""
    j, t = dense_gemma3
    jcfg = dataclasses.replace(j.cfg, rope_local=None)
    tcfg = dataclasses.replace(t.cfg, rope_local=None)
    ids, keep, shift = SHIFT_IDS[:30], 4, 6
    jeng = JEngine(jcfg, j.params)
    _, jc, n = jeng.prefill(ids, jeng.new_cache(1, 64), 0)
    jc = jeng.shift_cache(jc, shift, keep, n)
    with torch.inference_mode():
        kv = ttr.init_cache(tcfg, 1, 64)
        ttr.transformer_forward(tcfg, t.params, torch.tensor([ids]), kv, 0)
        tc = shift_cache(tcfg, kv, shift, keep, n_past=len(ids))
    # the rows the shifted prompt holds (the JAX engine's bucket padding
    # leaves other rows past them)
    rows = len(ids) - shift
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        for x, y in zip(a, b):
            y = np.asarray(y, np.float32)[:, :rows]
            assert np.abs(x.numpy()[:, :rows] - y).max() <= 1e-5 * np.abs(y).max()


# --------------------------------------------------------------- HF golden
IDS = np.array([[5, 77, 101, 32, 9, 200]], dtype=np.int64)


def _base_cfg_vals(vocab, hidden, heads, layers, inter, max_len):
    return [int(GGMLType.F32), vocab, hidden, heads, layers, inter, max_len, -1, 0, -1, -1]


def _write_gemma_hf(path, mtype, cfg_ints, cfg_floats, sd, layers, hidden, vocab, names):
    """A GGMM of an HF Gemma state dict after the converter's folds
    (Gemma3Converter.pp): the embedding times sqrt(hidden), norms as 1 + w."""
    with open(path, "wb") as f:
        w = GGMMWriter(f, int(mtype), 1, meta={})
        w.write_config(cfg_ints, fmt=f"{len(cfg_ints)}i")
        f.write(struct.pack(f"<{len(cfg_floats)}f", *cfg_floats))
        w._patch_offset(12)
        w.write_vocab_sp([(f"w{i}".encode(), -float(i)) for i in range(vocab)])
        for n in ["model.embed_tokens.weight"] + [
                f"model.layers.{i}.{n}" for i in range(layers) for n in names] + [
                "model.norm.weight"]:
            arr = sd[n]
            if n == "model.embed_tokens.weight":
                arr = arr * (hidden ** 0.5)
            elif n.endswith("norm.weight"):
                arr = 1 + arr
            w.write_tensor(n, arr, GGMLType.F32)


SANDWICH = ["input_layernorm.weight", "mlp.down_proj.weight", "mlp.gate_proj.weight",
            "mlp.up_proj.weight", "post_attention_layernorm.weight",
            "post_feedforward_layernorm.weight", "pre_feedforward_layernorm.weight",
            "self_attn.k_proj.weight", "self_attn.o_proj.weight", "self_attn.q_proj.weight",
            "self_attn.v_proj.weight"]


def test_gemma3_matches_hf(tmp_path):
    """tests/test_model_golden2.py::test_gemma3_matches_hf for the port:
    6 layers of heads 16 wide, sliding window 32 with pattern 3, both rope
    tables, q/k norms, the sandwich."""
    transformers = pytest.importorskip("transformers")
    if not hasattr(transformers, "Gemma3ForCausalLM"):
        pytest.skip("no Gemma3")
    vocab, hidden, heads, kv, layers, inter, max_len, hd = 256, 64, 4, 2, 6, 96, 128, 16
    torch.manual_seed(36)
    hf = transformers.Gemma3ForCausalLM(transformers.Gemma3TextConfig(
        vocab_size=vocab, hidden_size=hidden, num_attention_heads=heads,
        num_key_value_heads=kv, num_hidden_layers=layers, intermediate_size=inter,
        head_dim=hd, max_position_embeddings=max_len, rope_theta=1000000.0,
        rope_local_base_freq=10000.0, sliding_window=32, sliding_window_pattern=3,
        query_pre_attn_scalar=hd, rms_norm_eps=1e-6, tie_word_embeddings=True,
        attention_bias=False, rope_scaling=None, pad_token_id=0, eos_token_id=1,
        bos_token_id=2)).eval()
    sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
    path = str(tmp_path / "g3.bin")
    _write_gemma_hf(path, ModelType.GEMMA3,
                    _base_cfg_vals(vocab, hidden, heads, layers, inter, max_len)
                    + [kv, hd, hd, 32, 3], (10000.0, 1000000.0, 1.0), sd, layers, hidden, vocab,
                    SANDWICH + ["self_attn.k_norm.weight", "self_attn.q_norm.weight"])
    model = tm.load_model(path, tm.RuntimeConfig(weight_dtype="float32", **F32), device="cpu")
    assert [s.local_rope for s in model.cfg.layer_specs] == [True, True, False] * 2
    with torch.no_grad():
        ref = hf(torch.from_numpy(IDS)).logits[0].numpy()
        got = model.forward_logits(IDS[0].tolist())[0][0].numpy()
    np.testing.assert_allclose(got, ref, atol=4e-3, rtol=4e-3)


def test_gemma2_matches_hf(tmp_path):
    """Gemma-2 against `Gemma2ForCausalLM`: sliding window 4 on the even
    layers over 6 tokens, attention softcap 50 and final softcap 30 (HF
    eager attention applies both), query_pre_attn_scalar 24, interleaved
    rope (the converter permutes q / k rows)."""
    transformers = pytest.importorskip("transformers")
    from test_model_golden import _permute

    vocab, hidden, heads, kv, layers, inter, max_len, hd = 256, 64, 4, 2, 4, 96, 128, 16
    torch.manual_seed(38)
    hf = transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
        vocab_size=vocab, hidden_size=hidden, num_attention_heads=heads,
        num_key_value_heads=kv, num_hidden_layers=layers, intermediate_size=inter,
        head_dim=hd, max_position_embeddings=max_len, rope_theta=10000.0, sliding_window=4,
        query_pre_attn_scalar=24, attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        rms_norm_eps=1e-6, tie_word_embeddings=True, attention_bias=False,
        hidden_activation="gelu_pytorch_tanh", attn_implementation="eager", pad_token_id=0,
        eos_token_id=1, bos_token_id=2)).eval()
    sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
    for i in range(layers):
        for n, h in (("q_proj", heads), ("k_proj", kv)):
            key = f"model.layers.{i}.self_attn.{n}.weight"
            sd[key] = _permute(sd[key], h)
    path = str(tmp_path / "g2.bin")
    _write_gemma_hf(path, ModelType.GEMMA2,
                    _base_cfg_vals(vocab, hidden, heads, layers, inter, max_len)
                    + [kv, hd, 24, 4], (10000.0, 30.0, 50.0), sd, layers, hidden, vocab, SANDWICH)
    model = tm.load_model(path, tm.RuntimeConfig(weight_dtype="float32", **F32), device="cpu")
    assert (model.cfg.logit_softcap, model.cfg.final_logit_softcap) == (50.0, 30.0)
    with torch.no_grad():
        ref = hf(torch.from_numpy(IDS)).logits[0].numpy()
        got = model.forward_logits(IDS[0].tolist())[0][0].numpy()
    np.testing.assert_allclose(got, ref, atol=4e-3, rtol=4e-3)


def test_gemma3vis_still_fails_to_load_naming_itself(tmp_path):
    path = chip_smoke.write_internvl_ggmm(tmp_path / "m.bin", tower=False, layers=1,
                                          dtype=GGMLType.F32, model_type=ModelType.GEMMA3Vis)
    with pytest.raises(ValueError, match=r"unsupported model_type .*\(GEMMA3Vis\)"):
        tm.load_model(str(path), device="cpu")
