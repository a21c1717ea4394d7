"""The Phi family (PHI2, DOLPHINPHI2, PHI2_V2, DOLPHINPHI2_V2, PHI3, PHI3_SU,
PHI3_SU2, PHI3_SU3, PHI4_MINI, PHI4) and its blocks (the LayerNorm decoder,
the parallel residual, the plain MLP) in the port against the JAX package on
the CPU, over narrow GGMMs written with the JAX package's writer
(`chip_smoke.write_family_ggmm`: hidden 256, 2 layers, 4 heads of 64;
Phi-2's biases everywhere, its v1 and v2 tensor names; Phi-3's
SentencePiece-score vocab, a 2048-key window in a 4096 context, LongRoPE's
factors; Phi-4's byte-level vocab), and against `transformers` through the
JAX package's converter:

  - the loader is the family's, the config's fields equal the JAX
    package's, and every parameter loads bit-exact, in f32 and q4_k;
  - prefill logits within 1e-4 of the logit scale (f32) and 2e-2 (q4_k,
    the JAX side's Pallas kernels in interpret mode), and 8 greedy tokens
    identical;
  - the chat template's ids over two rounds and a system prompt equal
    (Phi-2's whole-prompt encoding without a template, Dolphin's ChatML,
    Phi-3's role pieces, Phi-4's <|im_sep|>), Phi-3's fixed role ids in a
    32000-piece vocab, and the CLI's `--test` transcripts of Phi-2 and
    Dolphin-Phi-2 equal to the JAX CLI's;
  - HF goldens: tiny `PhiForCausalLM` (-> PHI2_V2) and `Phi3ForCausalLM`
    (-> PHI3 with a window, PHI3_SU2 with LongRoPE, PHI4) models through
    the JAX converter, both packages within 2e-3 of `transformers`; the
    LongRoPE model beyond `original_max_position_embeddings`, where
    `transformers` takes the long factors that the JAX loader always takes
    (on a shorter prompt it takes the short ones: a known difference of the
    JAX package, pinned below);
  - `simple_mlp`, `mlp_dispatch`, the LayerNorm `_norm` and a
    parallel-residual `decoder_layer` against their JAX functions on seeded
    numpy inputs;
  - PHI3_MOE still fails to load, naming its type, and an MLP with
    `xielu` parameters raises, naming Apertus."""
import contextlib
import functools
import io
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
import chatllm_tpu.nn.transformer as jT
import chatllm_tpu.ops.qmm as jqmm
import chatllm_tpu.ops.qtensor as jq
import chatllm_tpu.ops.rope as jrope
import chatllm_tpu_torch.main as tmain
import chatllm_tpu_torch.models as tm
import chatllm_tpu_torch.nn.transformer as tT
import chatllm_tpu_torch.ops.qtensor as tq
import chatllm_tpu_torch.ops.rope as trope
from chatllm_tpu.ggmm.quants import GGMLType
from chatllm_tpu.ggmm.writer import GGMMWriter
from chatllm_tpu.runtime.chat import Messages as JMessages, MsgRole as JRole
from chatllm_tpu.runtime.generate import GenerationConfig as JGen
from chatllm_tpu_torch.models.model_types import ModelType
from chatllm_tpu_torch.ops.qtensor import QuantLinear
from chatllm_tpu_torch.runtime.chat import Messages as TMessages, MsgRole as TRole
from chatllm_tpu_torch.runtime.generate import GenerationConfig as TGen
from test_torch_families import CFG_FIELDS, ROPE_FIELDS
from test_torch_mistral import _same_bits

# family -> the port's loader
CASES = {"phi2": "Phi2", "dolphinphi2_v2": "Phi2", "phi2_v1": "Phi2V1",
         "dolphinphi2": "Phi2V1", "phi3": "Phi3", "phi3_su": "Phi3SU", "phi3_su2": "Phi3SU",
         "phi3_su3": "Phi3SU", "phi4_mini": "Phi3SU", "phi4": "Phi4"}
F32 = dict(compute_dtype="float32", cache_dtype="float32")
PROMPT = np.random.default_rng(13).integers(0, 379, 24).tolist()
NEW = 8
PHI_FIELDS = CFG_FIELDS + ("act", "norm_type", "o_bias", "parallel_residual")


def _files(d, dtype):
    return {fam: str(chip_smoke.write_family_ggmm(d / f"{fam}.bin", fam, seed=5, dtype=dtype,
                                                  writer_cls=GGMMWriter)) for fam in CASES}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _files(tmp_path_factory.mktemp("phi"), GGMLType.F32)


@pytest.fixture(scope="module")
def q4k_files(tmp_path_factory):
    return _files(tmp_path_factory.mktemp("phi_q4k"), None)


_PAIRS: dict = {}


def pair(files, fam):
    """The family's f32 file in both packages (f32 activations and cache),
    loaded once per module."""
    if fam not in _PAIRS:
        _PAIRS[fam] = (jm.load_model(files[fam], jm.RuntimeConfig(**F32)),
                       tm.load_model(files[fam], tm.RuntimeConfig(**F32), device="cpu"))
    return _PAIRS[fam]


def _same_config(t, j):
    for f in PHI_FIELDS:
        assert getattr(t.cfg, f) == getattr(j.cfg, f), f
    for f in ROPE_FIELDS + ("mscale_all",):
        assert getattr(t.cfg.rope, f) == getattr(j.cfg.rope, f), f
    assert [t.cfg.layer_spec(i).sliding_window for i in range(t.cfg.num_hidden_layers)] == \
        [j.cfg.layer_spec(i).sliding_window for i in range(j.cfg.num_hidden_layers)]


@pytest.mark.parametrize("fam", list(CASES))
def test_config_and_weights_match_jax(files, fam):
    j, t = pair(files, fam)
    assert type(t).__name__ == CASES[fam]
    assert t.model_type == j.model_type == int(ModelType[chip_smoke.FAMILIES[fam][0]])
    _same_config(t, j)
    phi2 = fam in chip_smoke.PHI2_FAMILIES
    assert t.cfg.parallel_residual == t.cfg.o_bias == phi2
    assert t.cfg.norm_type == ("layernorm" if phi2 else "rmsnorm")
    layer = t.params["layers"][0]
    if phi2:
        assert set(layer) == {"attn_norm", "attn", "mlp"} and set(layer["mlp"]) == {"up", "down"}
        assert "b" in layer["attn_norm"] and t.params["lm_head"].bias is not None
        assert all(layer["attn"][k].bias is not None for k in "qkvo")
        assert t.cfg.rope.resolved_rot_dim() == (chip_smoke.PHI2_ROPE_DIM if fam in
                                                 ("phi2", "dolphinphi2_v2") else 32)
    if fam == "phi3":
        slots = tT.layer_slots(t.cfg.layer_spec(0), t.cfg.max_length)
        assert t.cfg.layer_spec(0).sliding_window == chip_smoke.PHI3_WINDOW + 1
        assert tT.is_ring(t.cfg, t.cfg.layer_spec(0), slots) and slots == 2048 + tT.SWA_EXTRA
    if fam in ("phi3_su", "phi3_su2", "phi3_su3", "phi4_mini"):
        assert len(t.cfg.rope.freq_factors) == 32 and t.cfg.rope.freq_factors[1] == 1.25
        assert t.cfg.rope.mscale_all == (1.25 if fam in ("phi3_su3", "phi4_mini")
                                         else pytest.approx(1.25 ** 0.5))
    _same_bits(t.params, j.params, "params")


@pytest.mark.parametrize("fam", list(CASES))
def test_q4k_config_and_weights_bit_exact(q4k_files, fam):
    j, t = jm.load_model(q4k_files[fam]), tm.load_model(q4k_files[fam], device="cpu")
    _same_config(t, j)
    mlp = t.params["layers"][1]["mlp"]
    assert isinstance(mlp.get("gate") or mlp["up"], QuantLinear)
    _same_bits(t.params, j.params, "params")


_JAX_OUT: dict = {}


def _run(model, gen_cls, ids):
    """(prefill logits as f32 numpy, greedy tokens)."""
    eng = model.engine
    logits = eng.prefill(ids, eng.new_cache(1, 64), 0)[0]
    logits = np.asarray(logits.float() if isinstance(logits, torch.Tensor) else logits,
                        np.float32)
    return logits, list(eng.generate(ids, gen_cls(do_sample=False, max_new_tokens=NEW))[0])


@pytest.mark.parametrize("fam", list(CASES))
def test_logits_and_greedy_tokens_match_jax(files, fam):
    j, t = pair(files, fam)
    if fam not in _JAX_OUT:
        _JAX_OUT[fam] = _run(j, JGen, PROMPT)
    jl, jt = _JAX_OUT[fam]
    with torch.inference_mode():
        tl, tt = _run(t, TGen, PROMPT)
    assert np.isfinite(tl).all() and tl.shape == jl.shape
    assert np.abs(tl - jl).max() <= 1e-4 * np.abs(jl).max()
    assert tt == jt and len(tt) == NEW and len(set(tt)) > 1


def _interpret(monkeypatch):
    """The JAX side's quantized matmuls through its Pallas kernels in
    interpret mode, as on a TPU."""
    monkeypatch.setattr(jqmm, "use_pallas_qmm", lambda: True)
    monkeypatch.setattr(jqmm, "_pallas_local", functools.partial(jqmm._pallas_local,
                                                                 interpret=True))


@pytest.mark.parametrize("fam", list(CASES))
def test_q4k_logits_and_tokens_match_jax(q4k_files, fam, monkeypatch):
    """q4_k weights, bf16 activations and cache."""
    _interpret(monkeypatch)
    j, t = jm.load_model(q4k_files[fam]), tm.load_model(q4k_files[fam], device="cpu")
    jl, jt = _run(j, JGen, PROMPT)
    with torch.inference_mode():
        tl, tt = _run(t, TGen, PROMPT)
    assert np.abs(tl - jl).max() <= 2e-2 * np.abs(jl).max()
    assert tt == jt


TEMPLATE_TEXTS = ("Hello, wörld! 12345 <|user|>", "中文 µ ½ 2024 \r\n\r\n  x <|im_end|>")


@pytest.mark.parametrize("fam", list(CASES))
def test_chat_template_ids_match_jax(files, fam):
    j, t = pair(files, fam)
    for tok in (j.tokenizer, t.tokenizer):
        tok.sys_prompt = "Be brief."
    jh, th = JMessages(), TMessages()
    for text in TEMPLATE_TEXTS:
        jh.push_back(JRole.USER, text)
        th.push_back(TRole.USER, text)
        ji = j.tokenizer.encode_history(jh, 512, incremental=False)
        ti = t.tokenizer.encode_history(th, 512, incremental=False)
        assert ti == ji
        jh.push_back(JRole.ASSISTANT, text[::-1])
        th.push_back(TRole.ASSISTANT, text[::-1])
    assert t.tokenizer.encode_sys_prompt() == j.tokenizer.encode_sys_prompt()
    assert t.tokenizer.decode(ti) == j.tokenizer.decode(ji)
    assert t.tokenizer.terminate_ids == j.tokenizer.terminate_ids
    tok = t.tokenizer
    if fam in ("phi2", "dolphinphi2_v2", "phi2_v1"):
        # no template: the last message alone
        assert tok.chat_encoder is None and ti == tok.encode(TEMPLATE_TEXTS[-1])
    elif fam == "dolphinphi2":
        assert ti[0] == tok.im_start_token_id == 257 and tok.im_end_token_id in tok.terminate_ids
    elif fam == "phi4":
        # system, two users, the reply and the opening of the next
        assert ti.count(tok.im_sep_token_id) == 5 and tok.im_sep_token_id == 258
    else:
        roles = (tok.system_token_id, tok.user_token_id, tok.assistant_token_id,
                 tok.end_token_id)
        assert roles == (381, 383, 380, 382) and ti[:3] == [1, 381, tok.nl_token_id]
        assert tok.end_token_id in tok.terminate_ids and tok.is_special_id(383)


def test_phi3_fallback_role_ids(tmp_path):
    """A 32000-piece vocab without the role pieces (the first Phi-3 files)
    takes Phi-3's fixed ids, in both packages, and encodes the same chat."""
    path = str(chip_smoke.write_phi_ggmm(tmp_path / "phi3.bin", "phi3", dtype=GGMLType.F32,
                                         writer_cls=GGMMWriter, phi3_fallback=True))
    j, t = jm.load_model(path), tm.load_model(path, device="cpu")
    tok = t.tokenizer
    assert tok.tp.get_piece_size() == 32000 and t.cfg.vocab_size == 32064
    assert (tok.system_token_id, tok.user_token_id, tok.assistant_token_id,
            tok.end_token_id) == (32006, 32010, 32001, 32007)
    jh, th = JMessages(), TMessages()
    for h, role in ((jh, JRole), (th, TRole)):
        h.push_back(role.USER, "hello there")
        h.push_back(role.ASSISTANT, "hi")
        h.push_back(role.USER, "once more")
    ji = j.tokenizer.encode_history(jh, 512, incremental=False)
    ti = tok.encode_history(th, 512, incremental=False)
    assert ti == ji and ti.count(32010) == 2 and ti.count(32007) == 3


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


@pytest.mark.parametrize("fam", ["phi2", "dolphinphi2"])
def test_cli_transcript_matches_jax(files, fam, tmp_path, shared_jax_engines):
    """`--test` over two turns, greedy, f32: Phi-2 without a chat template
    (each turn's text alone), Dolphin-Phi-2 in ChatML with its system
    prompt."""
    turns = tmp_path / "turns.txt"
    turns.write_text("\n".join(chip_smoke.family_turns(fam)) + "\n")
    argv = ["-m", files[fam], "--test", str(turns), "-t", "0", "--max_new_tokens", "6",
            "--compute_dtype", "f32", "--cache_dtype", "f32"]
    jt, tt = _cli(jmain, argv), _cli(tmain, argv + ["--device", "cpu"])
    assert tt == jt and sum(ln.startswith("A.I.") for ln in tt) == 2


# ------------------------------------------------------------ HF goldens
HF_IDS = [7, 30, 102, 89, 5, 41, 77, 150]
V = 260


def _hf_convert(tmp_path, hf, cfg, arch, specials, unigram=False):
    from chatllm_tpu.tools.convert import convert
    from test_convert_wave2 import _save_dir

    out = str(tmp_path / "m.bin")
    convert(_save_dir(tmp_path, hf, cfg, arch, list(specials), unigram), out, "f32")
    return out


def _golden(path, hf, loader, ids=HF_IDS, tol=2e-3):
    """Both packages' logits of `ids` against `transformers`' (2e-3, abs and
    rel); returns the port's model and its logits."""
    rt = dict(weight_dtype="float32", **F32)
    t = tm.load_model(path, tm.RuntimeConfig(**rt), device="cpu")
    j = jm.load_model(path, jm.RuntimeConfig(**rt))
    assert type(t).__name__ == loader
    a = np.array([ids], dtype=np.int64)
    with torch.no_grad():
        ref = hf(torch.from_numpy(a)).logits[0].numpy()
        got = t.forward_logits(ids)[0][0].numpy()
    jl = np.asarray(j.forward_logits(a.astype(np.int32))[0])[0]
    np.testing.assert_allclose(got, jl, atol=1e-4, rtol=1e-4)
    if tol is not None:
        np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)
        np.testing.assert_allclose(jl, ref, atol=tol, rtol=tol)
    return t, got, ref


def test_phi2_matches_hf(tmp_path):
    """`PhiForCausalLM` (tests/test_convert_wave3.py's fixture): LayerNorm
    with biases, partial NeoX rope, the parallel residual, gelu_new."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(30)
    cfg = transformers.PhiConfig(
        vocab_size=V, hidden_size=64, num_attention_heads=4, num_hidden_layers=2,
        intermediate_size=96, max_position_embeddings=128, partial_rotary_factor=0.5,
        rope_theta=10000.0, hidden_act="gelu_new", bos_token_id=1, eos_token_id=2)
    hf = transformers.PhiForCausalLM(cfg).eval()
    path = _hf_convert(tmp_path, hf, cfg, "PhiForCausalLM", ["<|endoftext|>"])
    t = _golden(path, hf, "Phi2")[0]
    assert t.cfg.parallel_residual and t.cfg.norm_type == "layernorm"


def _phi3_cfg(transformers, **kw):
    base = dict(vocab_size=V, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                num_hidden_layers=2, intermediate_size=96, max_position_embeddings=128,
                original_max_position_embeddings=128, rope_theta=10000.0, rms_norm_eps=1e-5,
                tie_word_embeddings=False, pad_token_id=0, eos_token_id=1, bos_token_id=2)
    return transformers.Phi3Config(**{**base, **kw})


PHI3_ROLES = ["<|system|>", "<|user|>", "<|assistant|>", "<|end|>"]


def test_phi3_matches_hf(tmp_path):
    """`Phi3ForCausalLM` with a sliding window (tests/test_convert_wave2.py's
    fixture): the converter splits qkv_proj / gate_up_proj."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(28)
    cfg = _phi3_cfg(transformers, sliding_window=256, rope_scaling=None)
    hf = transformers.Phi3ForCausalLM(cfg).eval()
    t = _golden(_hf_convert(tmp_path, hf, cfg, "Phi3ForCausalLM", PHI3_ROLES, unigram=True),
                hf, "Phi3")[0]
    assert t.cfg.layer_spec(0).sliding_window == 257


LONG_HALF = 8      # head_dim 16: rot / 2 factors


def _longrope_model(tmp_path):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(32)
    cfg = _phi3_cfg(transformers, max_position_embeddings=256, sliding_window=None,
                    rope_scaling={"type": "longrope", "short_factor": [1.0] * LONG_HALF,
                                  "long_factor": [float(1 + i / 8) for i in range(LONG_HALF)]})
    hf = transformers.Phi3ForCausalLM(cfg).eval()
    return hf, _hf_convert(tmp_path, hf, cfg, "Phi3ForCausalLM", PHI3_ROLES, unigram=True)


def test_phi3_longrope_matches_hf_beyond_original_context(tmp_path):
    """LongRoPE (PHI3_SU2) on 160 tokens, past original_max_position_embeddings
    (128): `transformers` takes the long factors, as the loader always does;
    both apply mscale sqrt(1 + ln 2 / ln 128)."""
    hf, path = _longrope_model(tmp_path)
    ids = np.random.default_rng(3).integers(0, V, 160).tolist()
    t = _golden(path, hf, "Phi3SU", ids=ids)[0]
    assert t.model_type == int(ModelType.PHI3_SU2)
    assert t.cfg.rope.freq_factors == tuple(1 + i / 8 for i in range(LONG_HALF))
    assert t.cfg.rope.mscale_all == pytest.approx((1 + np.log(2) / np.log(128)) ** 0.5)


def test_phi3_longrope_short_prompt_differs_from_hf(tmp_path):
    """The known difference: on a prompt within the original context (120
    of 128 positions) `transformers` takes the short factors and the JAX
    loader (so the port) the long ones; the port equals the JAX package
    there (1e-4) and both part from `transformers` beyond the goldens' 2e-3
    (abs and rel)."""
    hf, path = _longrope_model(tmp_path)
    ids = np.random.default_rng(4).integers(0, V, 120).tolist()
    _, got, ref = _golden(path, hf, "Phi3SU", ids=ids, tol=None)
    assert not np.allclose(got, ref, atol=2e-3, rtol=2e-3)


def test_phi4_matches_hf(tmp_path):
    """`Phi3ForCausalLM` without rope scaling or a window: the converter
    writes PHI4 (the Llama-3 config; tests/test_convert_wave5.py)."""
    transformers = pytest.importorskip("transformers")
    from test_convert_wave5 import _save_named, _sd

    torch.manual_seed(89)
    cfg = _phi3_cfg(transformers, sliding_window=None, rope_scaling=None, bos_token_id=1,
                    eos_token_id=2)
    hf = transformers.Phi3ForCausalLM(cfg).eval()
    from chatllm_tpu.tools.convert import convert

    d = _save_named(tmp_path, _sd(hf), {**cfg.to_dict(), "architectures": ["Phi3ForCausalLM"]},
                    unigram=False, specials=["<|im_start|>", "<|im_sep|>", "<|im_end|>"])
    out = str(tmp_path / "m.bin")
    convert(d, out, "f32")
    t = _golden(out, hf, "Phi4")[0]
    assert t.tokenizer.im_sep_token_id >= 0


# ------------------------------------------------------------ blocks
def _block_cfgs(**kw):
    """The same narrow LayerNorm / parallel-residual config in both packages
    (Phi-2's blocks: hidden 64, 4 heads of 16, rope on 8 of them)."""
    common = dict(vocab_size=32, hidden_size=64, num_hidden_layers=1, num_attention_heads=4,
                  num_key_value_heads=4, intermediate_size=96, max_length=16, act="gelu_tanh",
                  norm_type="layernorm", norm_eps=1e-5, qkv_bias=True, o_bias=True,
                  parallel_residual=True)
    common.update(kw)
    rope = dict(head_dim=16, rot_dim=8, freq_base=10000.0, layout="neox")
    return (tT.TransformerConfig(rope=trope.RopeConfig(**rope), **common),
            jT.TransformerConfig(rope=jrope.RopeConfig(**rope), **common))


def _linears(rng, n_in, n_out):
    w = (rng.standard_normal((n_in, n_out)) * n_in ** -0.5).astype(np.float32)
    b = (rng.standard_normal(n_out) * 0.5).astype(np.float32)
    return (tq.DenseLinear(w=torch.from_numpy(w), bias=torch.from_numpy(b)),
            jq.DenseLinear(w=jnp.asarray(w), bias=jnp.asarray(b)))


def _norm_pair(rng, n):
    w = (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return ({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
            {"w": jnp.asarray(w), "b": jnp.asarray(b)})


def _x(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def _close(t, j, tol=1e-5):
    t, j = t.detach().float().numpy(), np.asarray(j, np.float32)
    assert t.shape == j.shape and np.abs(t - j).max() <= tol * max(1.0, np.abs(j).max())


def test_simple_mlp_and_dispatch_match_jax():
    """down(gelu_tanh(up(x))) with biases; mlp_dispatch takes it for an
    up / down MLP and the gated one for gate / up / down (or gate_up)."""
    rng = np.random.default_rng(40)
    tc, jc = _block_cfgs()
    (tu, ju), (td, jd), (tg, jg) = _linears(rng, 64, 96), _linears(rng, 96, 64), \
        _linears(rng, 64, 96)
    xt, xj = _x(rng, 1, 5, 64)
    plain_t, plain_j = {"up": tu, "down": td}, {"up": ju, "down": jd}
    _close(tT.simple_mlp(tc, plain_t, xt), jT.simple_mlp(jc, plain_j, xj))
    spec_t, spec_j = tT.LayerSpec(), jT.LayerSpec()
    _close(tT.mlp_dispatch(tc, spec_t, plain_t, xt), jT.mlp_dispatch(jc, spec_j, plain_j, xj))
    gated_t, gated_j = dict(plain_t, gate=tg), dict(plain_j, gate=jg)
    _close(tT.mlp_dispatch(tc, spec_t, gated_t, xt), jT.mlp_dispatch(jc, spec_j, gated_j, xj))
    _close(tT.mlp_dispatch(tc, spec_t, gated_t, xt), tT.gated_mlp(tc, gated_t, xt), 0.0)


def test_layernorm_norm_matches_jax():
    """_norm of a LayerNorm config: mean and variance in f32, the weight and
    the bias; without "b" the weight alone; bf16 in, bf16 out."""
    rng = np.random.default_rng(41)
    tc, jc = _block_cfgs()
    (pt, pj), (xt, xj) = _norm_pair(rng, 64), _x(rng, 2, 3, 64)
    _close(tT._norm(tc, xt, pt), jT._norm(jc, xj, pj))
    _close(tT._norm(tc, xt, {"w": pt["w"]}), jT._norm(jc, xj, {"w": pj["w"]}))
    got = tT._norm(tc, xt.to(torch.bfloat16), pt)
    want = jT._norm(jc, xj.astype(jnp.bfloat16), pj)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("parallel", [True, False])
def test_decoder_layer_matches_jax(parallel):
    """One Phi-2 layer (LayerNorm, biased q/k/v/o, partial rope, the plain
    MLP) with the parallel residual, and the same weights as a sequential
    layer with an ffn_norm, over 6 tokens into an f32 cache, against the JAX
    decoder_layer; the parallel one is (x + attn(h)) + mlp(h), h the one
    norm."""
    rng = np.random.default_rng(42 + parallel)
    tc, jc = _block_cfgs(parallel_residual=parallel)
    attn_t, attn_j = {}, {}
    for k in "qkvo":
        attn_t[k], attn_j[k] = _linears(rng, 64, 64)
    (ut, uj), (dt, dj) = _linears(rng, 64, 96), _linears(rng, 96, 64)
    (nt, nj), (ft, fj) = _norm_pair(rng, 64), _norm_pair(rng, 64)
    pt = {"attn_norm": nt, "attn": attn_t, "mlp": {"up": ut, "down": dt}}
    pj = {"attn_norm": nj, "attn": attn_j, "mlp": {"up": uj, "down": dj}}
    if not parallel:
        pt["ffn_norm"], pj["ffn_norm"] = ft, fj
    xt, xj = _x(rng, 1, 6, 64)
    pos = np.arange(6)[None]
    ct, st = trope.precompute_rope_cache(torch.from_numpy(pos), tc.rope)
    cj, sj = jrope.precompute_rope_cache(jnp.asarray(pos), jc.rope)
    kt, vt = torch.zeros(1, 16, 4, 16), torch.zeros(1, 16, 4, 16)
    kj, vj = jnp.zeros((1, 16, 4, 16)), jnp.zeros((1, 16, 4, 16))
    got = tT.decoder_layer(tc, tT.LayerSpec(), pt, xt, ct, st, kt, vt, 0)
    want = jT.decoder_layer(jc, jT.LayerSpec(), pj, xj, cj, sj, kj, vj, 0)[0]
    _close(got, want)
    if parallel:
        h = tT._norm(tc, xt, nt)
        kt2, vt2 = torch.zeros_like(kt), torch.zeros_like(vt)
        a = tT.attention_block(tc, tT.LayerSpec(), attn_t, h, ct, st, kt2, vt2, 0)
        torch.testing.assert_close(got, (xt + a) + tT.simple_mlp(tc, pt["mlp"], h),
                                   rtol=0, atol=0)


# ------------------------------------------------------------ refusals
def test_phi3_moe_still_fails_naming_itself(tmp_path):
    path = chip_smoke.write_internvl_ggmm(tmp_path / "m.bin", tower=False, layers=1,
                                          dtype=GGMLType.F32, model_type=ModelType.PHI3_MOE)
    with pytest.raises(ValueError, match=r"unsupported model_type .*\(PHI3_MOE\)"):
        tm.load_model(str(path), device="cpu")


def test_xielu_mlp_still_refused():
    rng = np.random.default_rng(43)
    tc, _ = _block_cfgs()
    (tu, _), (td, _) = _linears(rng, 64, 96), _linears(rng, 96, 64)
    p = {"up": tu, "down": td, "xielu": {"alpha_n": 0.8, "alpha_p": 0.8, "beta": 0.5,
                                         "eps": -1e-6}}
    with pytest.raises(NotImplementedError, match="Apertus"):
        tT.mlp_dispatch(tc, tT.LayerSpec(), p, torch.zeros(1, 2, 64))
