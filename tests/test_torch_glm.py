"""The GLM family (CHATGLM2, CHATGLM3, CODEGEEX2, CHARACTERGLM, GLM4, CODEGEEX4,
GLM4_0414) and the opt-in `runtime/fuse.py::fuse_decode_streams` in the port
against the JAX package on the CPU, over narrow GGMMs written with the JAX
package's writer (`chip_smoke.write_family_ggmm`: hidden 256, 2 layers, 4
heads of 64 over 2 kv heads; the GLM2 architecture's fused `qkv` with its
bias and fused `gate_up`; ChatGLM2's SentencePiece-score vocab with its
special ids past the pieces, GLM-4's byte-level one with its specials):

  - the loader is the family's, the config's fields (the half-head
    interleaved rope and its base, GLM-4-0414's sandwich norms) equal the
    JAX package's, and every parameter loads bit-exact, in f32 and q4_k;
  - prefill logits within 1e-4 of the logit scale (f32) and 2e-2 (q4_k,
    the JAX side's Pallas kernels in interpret mode), and 8 greedy tokens
    identical;
  - the chat template's ids over two rounds and a system prompt equal
    (CharacterGLM under `--set user_name / bot_name`), and the CLI's
    `--test` transcript of GLM-4 and CharacterGLM equal to the JAX CLI's;
  - GLM-4's and ChatGLM2's tokenizers byte-identical on digits, CJK, \\r\\n
    runs and the special pieces, GLM-4's over a vocab with merges;
  - HF goldens: a tiny `GlmForCausalLM` (-> GLM4) and `Glm4ForCausalLM`
    (-> GLM4_0414) through the JAX package's converter, both packages
    within 2e-3 of `transformers`;
  - `fuse_decode_streams` on a narrow Llama-3 and Qwen2: the fused tree
    bit-exact to the JAX package's, logits within 1e-5 of the unfused
    port's and the JAX fused model's scale (f32) or 2e-2 (q4_k), greedy
    tokens identical; MoE, MLA and mixed-format layers pass through;
  - ChatGLM-6B (CHATGLM) still fails to load, naming its type."""
import contextlib
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
from chatllm_tpu.ggmm.quants import GGMLType
from chatllm_tpu.ggmm.reader import SpanReader as JReader
from chatllm_tpu.ggmm.writer import GGMMWriter
from chatllm_tpu.runtime.chat import Messages as JMessages, MsgRole as JRole
from chatllm_tpu.runtime.fuse import fuse_decode_streams as jfuse
from chatllm_tpu.runtime.generate import GenerationConfig as JGen, InferenceEngine as JEngine
from chatllm_tpu_torch.ggmm.reader import SpanReader as TReader
from chatllm_tpu_torch.models.model_types import ModelType
from chatllm_tpu_torch.ops.qtensor import QuantLinear
from chatllm_tpu_torch.runtime.chat import Messages as TMessages, MsgRole as TRole
from chatllm_tpu_torch.runtime.fuse import fuse_decode_streams
from chatllm_tpu_torch.runtime.generate import GenerationConfig as TGen, InferenceEngine
from test_torch_families import CFG_FIELDS, ROPE_FIELDS
from test_torch_mistral import _same_bits

# family -> the port's loader
CASES = {"chatglm2": "ChatGLM2", "chatglm3": "ChatGLM2", "codegeex2": "ChatGLM2",
         "characterglm": "CharacterGLM", "glm4": "GLM4", "codegeex4": "GLM4",
         "glm4_0414": "GLM40414"}
F32 = dict(compute_dtype="float32", cache_dtype="float32")
PROMPT = np.random.default_rng(11).integers(0, 379, 24).tolist()
NEW = 8


def _files(d, dtype):
    return {fam: str(chip_smoke.write_family_ggmm(d / f"{fam}.bin", fam, seed=4, dtype=dtype,
                                                  writer_cls=GGMMWriter)) for fam in CASES}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _files(tmp_path_factory.mktemp("glm"), GGMLType.F32)


@pytest.fixture(scope="module")
def q4k_files(tmp_path_factory):
    return _files(tmp_path_factory.mktemp("glm_q4k"), None)


_PAIRS: dict = {}


def pair(files, fam):
    """The family's f32 file in both packages (f32 activations and cache),
    loaded once per module."""
    if fam not in _PAIRS:
        _PAIRS[fam] = (jm.load_model(files[fam], jm.RuntimeConfig(**F32)),
                       tm.load_model(files[fam], tm.RuntimeConfig(**F32), device="cpu"))
    return _PAIRS[fam]


def _same_config(t, j):
    for f in CFG_FIELDS + ("post_norms", "act", "rms_norm_offset"):
        assert getattr(t.cfg, f) == getattr(j.cfg, f), f
    for f in ROPE_FIELDS:
        assert getattr(t.cfg.rope, f) == getattr(j.cfg.rope, f), f


@pytest.mark.parametrize("fam", list(CASES))
def test_config_and_weights_match_jax(files, fam):
    j, t = pair(files, fam)
    assert type(t).__name__ == CASES[fam]
    assert t.model_type == j.model_type == int(ModelType[chip_smoke.FAMILIES[fam][0]])
    _same_config(t, j)
    rope = t.cfg.rope
    assert rope.resolved_rot_dim() == 32 and rope.layout == "normal"
    assert rope.freq_base == (5e6 if fam in chip_smoke.GLM4_FAMILIES else 1e4)
    assert t.cfg.post_norms == (fam == "glm4_0414") and not t.cfg.tie_lm_head
    attn = t.params["layers"][0]["attn"]
    assert set(attn) == ({"q", "k", "v", "o"} if fam == "glm4_0414" else {"qkv", "o"})
    assert attn["o"].bias is None and (attn.get("qkv") or attn["q"]).bias is not None
    _same_bits(t.params, j.params, "params")


@pytest.mark.parametrize("fam", list(CASES))
def test_q4k_config_and_weights_bit_exact(q4k_files, fam):
    j, t = jm.load_model(q4k_files[fam]), tm.load_model(q4k_files[fam], device="cpu")
    _same_config(t, j)
    mlp = t.params["layers"][1]["mlp"]
    assert isinstance(mlp.get("gate_up") or mlp["gate"], QuantLinear)
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


TEMPLATE_TEXTS = ("Hello, wörld! 12345 [gMASK]<|user|>", "中文 µ ½ 2024 \r\n\r\n  x <sop>")


@pytest.mark.parametrize("fam", list(CASES))
def test_chat_template_ids_match_jax(files, fam):
    j, t = pair(files, fam)
    for tok in (j.tokenizer, t.tokenizer):
        tok.sys_prompt = "Be brief."
    if fam == "characterglm":
        for m in (j, t):
            m.set_additional_args({"user_name": "Ann", "bot_name": "Bo", "bot_info": "一只猫"})
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
    tok = t.tokenizer
    names = ("mask", "gmask", "smask", "sop", "eop")
    ids = [getattr(tok, f"{n}_token_id") for n in names]
    assert ids == [getattr(j.tokenizer, f"{n}_token_id") for n in names]
    if fam in chip_smoke.GLM2_FAMILIES:
        assert ids == list(range(379, 384)) and all(tok.is_special_id(i) for i in ids)
        if fam == "characterglm":
            assert tok.decode(ti).startswith("以下是一段Ann和Bo之间的对话。\n关于Bo的信息：一只猫")
        else:
            assert ti.count(tok.gmask_token_id) == 4      # every piece opens [gMASK] sop
    else:
        assert ids == list(range(257, 262)) and ti[:2] == ids[1:4:2]
        assert {256, tok.user_token_id, tok.observation_token_id} <= tok.terminate_ids
        assert tok.nl_token_id == ord("\n") and tok.user_token_id == 263


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


@pytest.mark.parametrize("fam", ["glm4", "characterglm"])
def test_cli_transcript_matches_jax(files, fam, tmp_path, shared_jax_engines):
    """`--test` over two turns with a system prompt, greedy, f32 (CharacterGLM
    with its persona through `--set`)."""
    turns = tmp_path / "turns.txt"
    turns.write_text("\n".join(chip_smoke.family_turns(fam)) + "\n")
    argv = ["-m", files[fam], "--test", str(turns), "-t", "0", "--max_new_tokens", "6",
            "-s", "Be brief.", "--compute_dtype", "f32", "--cache_dtype", "f32"]
    if fam == "characterglm":
        argv += ["--set", "user_name", "Ann", "--set", "bot_name", "Bo"]
    jt, tt = _cli(jmain, argv), _cli(tmain, argv + ["--device", "cpu"])
    assert tt == jt and sum(ln.startswith("A.I.") for ln in tt) == 2


# ------------------------------------------------------------ tokenizers
GLM4_WORDS = ["12", "123", "the", " the", "Hello", " wor", "ld", "中文", " 中", "\r\n", "\r\n\r\n",
              " !!", "ö"]
TOKEN_TEXTS = ["12345 67 8 1234567", "中文 Ａ！ ½ µ 2024年", "a\r\n\r\n  b\r\r\n\n \r\n x",
               "<|user|>\nhi<|assistant|>ok<|endoftext|>[gMASK]<sop>", "wörld  !!  \t\n  ",
               "Hello world ١٢٣ Ⅷ ²³ 😀"]


def _glm4_blob() -> bytes:
    """GLM-4's layout: byte-level alphabet, merged pieces (each built left to
    right by the merge list), then GLM4_SPECIALS as control tokens."""
    from chatllm_tpu_torch.tokenizer.processor import byte_level_encode

    pieces = [byte_level_encode(bytes([b])) for b in range(256)]
    merges = []
    for word in GLM4_WORDS:
        units = [byte_level_encode(bytes([b])) for b in word.encode()]
        cur = units[0]
        for u in units[1:]:
            merges.append(cur + b" " + u)
            cur = cur + u
            if cur not in pieces:
                pieces.append(cur)
    out = bytearray()
    for p in pieces:
        out += struct.pack("<i", len(p)) + p + bytes([1])
    for s in chip_smoke.GLM4_SPECIALS:
        out += struct.pack("<i", len(s)) + s.encode() + bytes([3])
    out += struct.pack("<i", -1)
    for m in merges:
        out += struct.pack("<i", len(m)) + m
    out += struct.pack("<i", -1)
    return bytes(out)


@pytest.fixture(scope="module")
def glm4_processors():
    from chatllm_tpu.models.glm import GLM4_REGEX as J_REGEX
    from chatllm_tpu.tokenizer.processor import BPEProcessor2 as JBPE
    from chatllm_tpu_torch.models.glm import GLM4_REGEX
    from chatllm_tpu_torch.tokenizer.processor import BPEProcessor2

    assert GLM4_REGEX == J_REGEX
    blob = memoryview(_glm4_blob())
    j, t = JBPE(J_REGEX), BPEProcessor2(GLM4_REGEX)
    j.load(JReader(blob, 0), 0)
    t.load(TReader(blob, 0), 0)
    for p in (j, t):
        p.enable_return_special_token(True)
    return j, t


@pytest.mark.parametrize("text", range(len(TOKEN_TEXTS)))
def test_glm4_tokenizer_matches_jax(glm4_processors, text):
    j, t = glm4_processors
    s = TOKEN_TEXTS[text]
    ids = t.encode(s)
    assert ids == j.encode(s)
    assert t.decode(ids) == j.decode(ids)
    split = t._regex_split(s)
    assert split == j._regex_split(s)
    if text == 0:
        # digits go in threes, and the merges show it in the ids
        assert split[:3] == ["123", "45", " "] and ids[0] == t.piece_to_id("123")
    if text == 2:
        # a run of line breaks is one piece of the split, merged as far as
        # the merge list goes
        assert "\r\n\r\n" in split and len(ids) < len(s.encode())


@pytest.mark.parametrize("text", range(len(TOKEN_TEXTS)))
def test_glm2_tokenizer_matches_jax(files, text):
    """ChatGLM2's BPEProcessor1, and the ChatTokenizer's view of the special
    ids at and above the piece count (they decode to nothing)."""
    j, t = pair(files, "chatglm2")
    s = TOKEN_TEXTS[text]
    ids = t.tokenizer.encode(s)
    assert ids == j.tokenizer.encode(s)
    assert t.tokenizer.decode(ids) == j.tokenizer.decode(ids)
    mixed = ids + list(range(377, 384))
    assert t.tokenizer.decode(mixed) == j.tokenizer.decode(mixed) == t.tokenizer.decode(ids + [377, 378])
    assert t.tokenizer.tp.decode(mixed) == j.tokenizer.tp.decode(mixed)
    assert t.tokenizer.tp.get_piece_size() == 379


# ------------------------------------------------------------ HF goldens
HF_IDS = np.array([[7, 30, 102, 89, 5, 41, 77, 150]], dtype=np.int64)


def _hf_convert(tmp_path, hf, cfg, arch, specials):
    from chatllm_tpu.tools.convert import convert
    from test_convert_wave2 import _save_dir

    out = str(tmp_path / "m.bin")
    convert(_save_dir(tmp_path, hf, cfg, arch, list(specials)), out, "f32")
    return out


def _golden(path, hf, loader):
    rt = dict(weight_dtype="float32", **F32)
    t = tm.load_model(path, tm.RuntimeConfig(**rt), device="cpu")
    j = jm.load_model(path, jm.RuntimeConfig(**rt))
    assert type(t).__name__ == loader
    with torch.no_grad():
        ref = hf(torch.from_numpy(HF_IDS)).logits[0].numpy()
        got = t.forward_logits(HF_IDS[0].tolist())[0][0].numpy()
    jl = np.asarray(j.forward_logits(HF_IDS.astype(np.int32))[0])[0]
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(jl, ref, atol=2e-3, rtol=2e-3)
    return t


def test_glm4_matches_hf(tmp_path):
    """`GlmForCausalLM` (GLM-4's architecture in `transformers`): biased
    fused q/k/v, half-head rope, fused gate/up (tests/test_convert_wave3.py's
    fixture)."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(50)
    cfg = transformers.GlmConfig(
        vocab_size=260, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
        num_hidden_layers=2, intermediate_size=96, head_dim=16, partial_rotary_factor=0.5,
        attention_bias=True, max_position_embeddings=128, rope_theta=10000.0,
        rms_norm_eps=1e-5, tie_word_embeddings=False, pad_token_id=0, eos_token_id=1,
        bos_token_id=2)
    hf = transformers.GlmForCausalLM(cfg).eval()
    path = _hf_convert(tmp_path, hf, cfg, "GlmForCausalLM",
                       ["<|endoftext|>", "[MASK]", "[gMASK]", "[sMASK]", "<sop>", "<eop>",
                        "<|user|>", "<|assistant|>"])
    t = _golden(path, hf, "GLM4")
    assert set(t.params["layers"][0]["attn"]) == {"qkv", "o"}


def test_glm4_0414_matches_hf(tmp_path):
    """`Glm4ForCausalLM` (GLM-4-0414): separate q/k/v, the sandwich norms
    (tests/test_convert_wave2.py's fixture)."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(23)
    cfg = transformers.Glm4Config(
        vocab_size=260, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
        num_hidden_layers=2, intermediate_size=96, partial_rotary_factor=0.5, head_dim=16,
        attention_bias=False, max_position_embeddings=128, rope_theta=10000.0,
        rms_norm_eps=1e-5, tie_word_embeddings=False, pad_token_id=0, eos_token_id=1,
        bos_token_id=None)
    hf = transformers.Glm4ForCausalLM(cfg).eval()
    path = _hf_convert(tmp_path, hf, cfg, "Glm4ForCausalLM",
                       ["<|user|>", "<|assistant|>", "<|system|>", "<|observation|>"])
    t = _golden(path, hf, "GLM40414")
    assert t.cfg.post_norms


# ------------------------------------------------------- fuse_decode_streams
FUSE_PROMPT = np.random.default_rng(12).integers(0, 256, 20).tolist()


def _fuse_file(tmp_path, name, dtype):
    path = tmp_path / f"{name}.bin"
    if name == "llama3":
        return str(chip_smoke.write_llama3_ggmm(path, dtype=dtype, seed=6, writer_cls=GGMMWriter))
    return str(chip_smoke.write_qwen2_ggmm(path, dtype=dtype, seed=6, writer_cls=GGMMWriter,
                                           tie=False))


def _engine_run(eng, gen_cls):
    logits = eng.prefill(FUSE_PROMPT, eng.new_cache(1, 64), 0)[0]
    logits = np.asarray(logits.float() if isinstance(logits, torch.Tensor) else logits,
                        np.float32)
    return logits, list(eng.generate(FUSE_PROMPT, gen_cls(do_sample=False,
                                                          max_new_tokens=NEW))[0])


@pytest.mark.parametrize("dtype", ["f32", "q4_k"])
@pytest.mark.parametrize("name", ["llama3", "qwen2"])
def test_fuse_decode_streams_matches_unfused_and_jax(tmp_path, name, dtype, monkeypatch):
    """The fused tree is the JAX package's bit for bit; the fused port's
    logits stay within 1e-5 of the unfused port's and the JAX fused model's
    logit scale over f32 weights (2e-2 over q4_k: the quantized matmuls round
    their inputs to bf16), with the same greedy tokens."""
    q4k = dtype == "q4_k"
    if q4k:
        _interpret(monkeypatch)
    path = _fuse_file(tmp_path, name, GGMLType.Q4_K if q4k else GGMLType.F32)
    rt = {} if q4k else F32
    j = jm.load_model(path, jm.RuntimeConfig(**rt))
    t = tm.load_model(path, tm.RuntimeConfig(**rt), device="cpu")
    tf, jf = fuse_decode_streams(t.cfg, t.params), jfuse(j.cfg, j.params)
    for lp in tf["layers"]:
        assert set(lp["attn"]) == {"qkv", "o"} and set(lp["mlp"]) == {"gate_up", "down"}
    assert (tf["layers"][0]["attn"]["qkv"].bias is not None) == (name == "qwen2")
    _same_bits(tf, jf, "fused")
    tol = 2e-2 if q4k else 1e-5
    with torch.inference_mode():
        ul, ut = _engine_run(t.engine, TGen)
        fl, ft = _engine_run(InferenceEngine(t.cfg, tf, device="cpu"), TGen)
    jl, jt = _engine_run(JEngine(j.cfg, jf), JGen)
    scale = np.abs(ul).max()
    assert np.abs(fl - ul).max() <= tol * scale
    assert np.abs(fl - jl).max() <= tol * np.abs(jl).max()
    assert ft == ut == jt and len(set(ft)) > 1


def test_fuse_passes_through_what_it_cannot_fuse(tmp_path):
    """MoE layers keep their experts and router; MLA layers their
    projections; linears of mixed formats stay separate; a tree without
    layers comes back as it was."""
    ds = str(chip_smoke.write_family_ggmm(tmp_path / "ds.bin", "deepseek_v1_moe",
                                          dtype=GGMLType.F32, writer_cls=GGMMWriter))
    t = tm.load_model(ds, tm.RuntimeConfig(**F32), device="cpu")
    f = fuse_decode_streams(t.cfg, t.params)
    assert set(f["layers"][0]["mlp"]) == {"gate_up", "down"}          # layer 0 is dense
    assert f["layers"][1]["mlp"] is t.params["layers"][1]["mlp"]
    assert set(f["layers"][1]["attn"]) == {"qkv", "o"}
    mla = tm.load_model(str(chip_smoke.write_deepseek_v2_ggmm(tmp_path / "v2.bin",
                                                                dtype=GGMLType.F32)),
                        tm.RuntimeConfig(**F32), device="cpu")
    fm = fuse_decode_streams(mla.cfg, mla.params)
    assert fm["layers"][0]["attn"] is mla.params["layers"][0]["attn"]
    l3 = tm.load_model(_fuse_file(tmp_path, "llama3", GGMLType.Q4_K), device="cpu")
    attn = dict(l3.params["layers"][0]["attn"])
    attn["v"] = tm.load_model(_fuse_file(tmp_path, "qwen2", GGMLType.Q8_0),
                              device="cpu").params["layers"][0]["attn"]["v"]
    mixed = dict(l3.params, layers=(dict(l3.params["layers"][0], attn=attn),))
    fl = fuse_decode_streams(l3.cfg, mixed)["layers"][0]
    assert fl["attn"] is attn and set(fl["mlp"]) == {"gate_up", "down"}
    assert fuse_decode_streams(l3.cfg, {"embed": 1}) == {"embed": 1}


def test_chatglm1_still_fails_to_load_naming_itself(tmp_path):
    path = chip_smoke.write_internvl_ggmm(tmp_path / "m.bin", tower=False, layers=1,
                                          dtype=GGMLType.F32, model_type=ModelType.CHATGLM)
    with pytest.raises(ValueError, match=r"unsupported model_type .*\(CHATGLM\)"):
        tm.load_model(str(path), device="cpu")
