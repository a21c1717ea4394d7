"""GPT-OSS (GPT_OSS) and its blocks in the port against the JAX package on
the CPU: attention sinks on every route of `attention_with_cache`, the
biased softmax-top-k router, the biased experts under `swiglu_oai`, and the
model over GGMMs that both packages load:

  - tiny `transformers.GptOssForCausalLM` models through the JAX package's
    converter (tests/test_gpt_oss.py's fixture: hidden 64, a window of 8 on
    layer 0; and one of hidden 256 in q4_k and q8_0): every parameter
    bit-exact, f32 logits within 1e-4 of the logit scale, quantized ones
    within 2e-2 (the JAX side's Pallas kernels in interpret mode), greedy
    tokens identical, and both packages within 3e-3 (abs and rel) of
    `transformers` on the dense windowed route, on a 24-slot ring, and on a
    ring that the prompt wraps (SWA_EXTRA shrunk to 16 in both packages);
  - the narrow file of `chip_smoke.write_family_ggmm(..., "gpt_oss")`
    (written with the JAX package's writer: a ring of 576 slots that a
    640-token prompt wraps, byte-level merges, the harmony specials): the
    same checks, the template's ids with the dated default system prompt,
    the tokenizer's ids on Unicode text (accents, combining marks,
    title-case letters, CJK, long digit runs, contractions, \\r\\n), a
    2-slot BatchedEngine against single runs, the CLI's `--test` transcript
    and a 2-slot server's replies against the JAX package's;
  - `attention_with_cache` with sinks on every route (the einsum with and
    without a window, per-row n_past over float and q8 caches, K4's plain
    twin at GPT-OSS's D 64 and 8 query heads a kv head, once and per row,
    and the sizes of K3 and of the chunked route, which sinks keep out);
  - `moe_route`, `_experts_out` and `moe_mlp` in GPT-OSS's modes, f32 and
    bf16;
  - `models/synthetic.py::gpt_oss_20b_config` and GPT_OSS_OPTS."""
import contextlib
import functools
import io
import json
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

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
import chatllm_tpu.ops.attention as jatt
import chatllm_tpu.ops.qmm as jqmm
import chatllm_tpu.ops.qtensor as jq
import chatllm_tpu_torch.main as tmain
import chatllm_tpu_torch.models as tm
import chatllm_tpu_torch.nn.transformer as tT
import chatllm_tpu_torch.ops.attention as tatt
import chatllm_tpu_torch.ops.qmm as tqmm
import chatllm_tpu_torch.ops.qtensor as tq
from chatllm_tpu.ggmm.quants import GGMLType
from chatllm_tpu.ggmm.writer import GGMMWriter
from chatllm_tpu.runtime.chat import Messages as JMessages, MsgRole as JRole
from chatllm_tpu.runtime.generate import GenerationConfig as JGen
from chatllm_tpu.serve import server as jserver
from chatllm_tpu_torch.models import gpt_oss as tgo
from chatllm_tpu_torch.models import synthetic
from chatllm_tpu_torch.models.model_types import ModelType
from chatllm_tpu_torch.ops.sampling import SamplerConfig
from chatllm_tpu_torch.runtime.batching import BatchedEngine
from chatllm_tpu_torch.runtime.chat import Messages as TMessages, MsgRole as TRole
from chatllm_tpu_torch.runtime.generate import GenerationConfig as TGen
from chatllm_tpu_torch.serve import server as tserver
from test_torch_families import CFG_FIELDS, ROPE_FIELDS
from test_torch_mistral import _same_bits

F32 = dict(compute_dtype="float32", cache_dtype="float32")
RT32 = dict(weight_dtype="float32", **F32)
NEW = 8
HF_SPECIALS = ["<|start|>", "<|message|>", "<|end|>", "<|channel|>", "<|return|>",
               "<|startoftext|>", "<|endoftext|>", "<pad7>"]
GO_FIELDS = CFG_FIELDS + ("o_bias", "moe_act", "moe_swiglu_limit", "moe_swiglu_alpha")
HF_IDS = [7, 30, 102, 89, 5, 200, 41, 77, 3, 9, 150, 66]


def _hf_model(tmp, quant: str, *, hidden: int = 64, head_dim: int = 16, inter: int = 48,
              seed: int = 11):
    """A tiny GptOssForCausalLM (layer 0 windowed over 8 keys, layer 1 full,
    YaRN factor 2 over 128) converted by the JAX package to `quant`."""
    transformers = pytest.importorskip("transformers")
    from chatllm_tpu.tools.convert import convert
    from test_convert import _save_hf_dir

    torch.manual_seed(seed)
    cfg = transformers.GptOssConfig(
        vocab_size=264, hidden_size=hidden, num_attention_heads=4, num_key_value_heads=2,
        head_dim=head_dim, num_hidden_layers=2, intermediate_size=inter, num_local_experts=4,
        num_experts_per_tok=2, experts_per_token=2, sliding_window=8,
        layer_types=["sliding_attention", "full_attention"], max_position_embeddings=256,
        rope_theta=150000.0,
        rope_scaling={"rope_type": "yarn", "factor": 2.0,
                      "original_max_position_embeddings": 128, "beta_fast": 32.0,
                      "beta_slow": 1.0},
        tie_word_embeddings=False, swiglu_limit=7.0)
    hf = transformers.GptOssForCausalLM(cfg).eval()
    d = _save_hf_dir(tmp, hf, {**cfg.to_dict(), "architectures": ["GptOssForCausalLM"]},
                     HF_SPECIALS)
    out = str(tmp / f"oss_{quant}.bin")
    convert(d, out, quant)
    return hf, out


@pytest.fixture(scope="module")
def hf_pair(tmp_path_factory):
    return _hf_model(tmp_path_factory.mktemp("gptoss_hf"), "f32")


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """The narrow GPT_OSS file (f32) in both packages, f32 activations and
    cache."""
    path = str(chip_smoke.write_family_ggmm(tmp_path_factory.mktemp("gptoss") / "m.bin",
                                            "gpt_oss", seed=7, dtype=GGMLType.F32,
                                            writer_cls=GGMMWriter))
    return (path, jm.load_model(path, jm.RuntimeConfig(**F32)),
            tm.load_model(path, tm.RuntimeConfig(**F32), device="cpu"))


def _same_config(t, j):
    for f in GO_FIELDS:
        assert getattr(t.cfg, f) == getattr(j.cfg, f), f
    for f in ROPE_FIELDS:
        assert getattr(t.cfg.rope, f) == getattr(j.cfg.rope, f), f
    assert [(s.sliding_window, s.is_moe) for s in t.cfg.layer_specs] == \
        [(s.sliding_window, s.is_moe) for s in j.cfg.layer_specs]


# ------------------------------------------------------------ loader
@pytest.mark.parametrize("which", ["hf_f32", "narrow_f32", "narrow_q4k"])
def test_config_and_weights_match_jax(which, hf_pair, narrow, tmp_path):
    if which == "hf_f32":
        path = hf_pair[1]
    elif which == "narrow_f32":
        path = narrow[0]
    else:
        path = str(chip_smoke.write_family_ggmm(tmp_path / "q4k.bin", "gpt_oss", seed=7,
                                                writer_cls=GGMMWriter))
    rt = RT32 if which == "hf_f32" else {}
    j = jm.load_model(path, jm.RuntimeConfig(**rt))
    t = tm.load_model(path, tm.RuntimeConfig(**rt), device="cpu")
    assert type(t) is tgo.GPTOSS and t.model_type == j.model_type == int(ModelType.GPT_OSS)
    _same_config(t, j)
    assert t.cfg.moe_score_func == "softmax_topk" and t.cfg.moe_act == "swiglu_oai"
    assert [s.sliding_window for s in t.cfg.layer_specs] == [8 if which == "hf_f32" else 64, 0]
    layer = t.params["layers"][1]
    assert layer["attn"]["sinks"].dtype == torch.float32
    assert layer["mlp"]["gate"].bias is None and "gate_linear_bias" in layer["mlp"]
    assert set(layer["mlp"]["experts"]) == {"gate", "up", "down", "gate_b", "up_b", "down_b"}
    if which == "narrow_q4k":
        assert isinstance(layer["attn"]["q"], tq.QuantLinear)
        assert layer["mlp"]["experts"]["gate"].dtype == torch.bfloat16
    _same_bits(t.params, j.params, "params")


# ------------------------------------------------------------ logits and tokens
def _prefill_logits(model, ids, chunk):
    """Logits at every prompt position, fed in chunks of `chunk` (a ring
    takes at most SWA_EXTRA tokens a call, as the engines feed it)."""
    if isinstance(model, tm.BaseLLM):
        kv = model.engine.new_cache(1)
        with torch.inference_mode():
            return np.concatenate([model.forward_logits(ids[n:n + chunk], n, cache=kv)[0][0]
                                   .float().numpy() for n in range(0, len(ids), chunk)])
    kv, out = model.engine.new_cache(1), []
    for n in range(0, len(ids), chunk):
        lg, kv = model.forward_logits(ids[n:n + chunk], n, cache=kv)
        out.append(np.asarray(lg[0], np.float32))
    return np.concatenate(out)


def _greedy(model, gen_cls, ids):
    return list(model.engine.generate(ids, gen_cls(do_sample=False, max_new_tokens=NEW))[0])


LONG = np.random.default_rng(5).integers(3, 270, chip_smoke.FAMILY_RING_PROMPT).tolist()


def test_narrow_logits_and_greedy_tokens_match_jax(narrow):
    """640 positions over the 576-slot ring (in chunks of SWA_EXTRA) and the
    full layer: 1e-4 of the logit scale; 8 greedy tokens identical."""
    _, j, t = narrow
    jl, tl = _prefill_logits(j, LONG, 512), _prefill_logits(t, LONG, 512)
    assert np.isfinite(tl).all() and tl.shape == jl.shape == (len(LONG), 384)
    assert np.abs(tl - jl).max() <= 1e-4 * np.abs(jl).max()
    with torch.inference_mode():
        tt = _greedy(t, TGen, LONG)
    assert tt == _greedy(j, JGen, LONG) and len(set(tt)) > 1


def test_hf_logits_and_greedy_tokens_match_jax(hf_pair):
    _, path = hf_pair
    j = jm.load_model(path, jm.RuntimeConfig(**RT32))
    t = tm.load_model(path, tm.RuntimeConfig(**RT32), device="cpu")
    ids = HF_IDS * 2
    jl, tl = _prefill_logits(j, ids, 512), _prefill_logits(t, ids, 512)
    assert np.abs(tl - jl).max() <= 1e-4 * np.abs(jl).max()
    with torch.inference_mode():
        assert _greedy(t, TGen, ids) == _greedy(j, JGen, ids)


@pytest.mark.parametrize("quant", ["q4_k", "q8_0"])
def test_quantized_logits_and_tokens_match_jax(quant, tmp_path, monkeypatch):
    """Hidden 256 (so that q4_k is reached: K a multiple of 256), bf16
    activations and cache, the JAX side's quantized matmuls through its
    Pallas kernels in interpret mode: 2e-2 of the logit scale, the same
    greedy tokens."""
    monkeypatch.setattr(jqmm, "use_pallas_qmm", lambda: True)
    monkeypatch.setattr(jqmm, "_pallas_local", functools.partial(jqmm._pallas_local,
                                                                 interpret=True))
    _, path = _hf_model(tmp_path, quant, hidden=256, head_dim=64, inter=256, seed=12)
    j, t = jm.load_model(path), tm.load_model(path, device="cpu")
    _same_bits(t.params, j.params, "params")
    assert isinstance(t.params["layers"][0]["attn"]["q"], tq.QuantLinear)
    ids = HF_IDS * 2
    jl, tl = _prefill_logits(j, ids, 512), _prefill_logits(t, ids, 512)
    assert np.abs(tl - jl).max() <= 2e-2 * np.abs(jl).max()
    with torch.inference_mode():
        assert _greedy(t, TGen, ids) == _greedy(j, JGen, ids)


@pytest.mark.parametrize("route", ["dense_window", "ring", "wrapped_ring"])
def test_matches_hf(hf_pair, route, monkeypatch):
    """Both packages within 3e-3 (abs and rel, the JAX test's tolerance) of
    `transformers`: 24 tokens past the window of 8 in one chunk over the
    dense windowed route (a 256-slot cache), the same into a cache of 24
    slots (a ring of 24), and 40 tokens in chunks of 16 through rings of 24
    slots (SWA_EXTRA 16 in both packages) that they wrap."""
    hf, path = hf_pair
    if route == "wrapped_ring":
        monkeypatch.setattr(jT, "SWA_EXTRA", 16)
        monkeypatch.setattr(tT, "SWA_EXTRA", 16)
    j = jm.load_model(path, jm.RuntimeConfig(**RT32))
    t = tm.load_model(path, tm.RuntimeConfig(**RT32), device="cpu")
    n = 40 if route == "wrapped_ring" else 24
    ids = np.random.default_rng(0).integers(0, 256, n).tolist()
    if route == "ring":
        got = t.forward_logits(ids)[0][0].numpy()
        want = np.asarray(j.forward_logits(np.array([ids], np.int32))[0])[0]
        assert t.engine.new_cache(1, 24).k[0].shape[1] == 24
    else:
        chunk = 16 if route == "wrapped_ring" else n
        got, want = _prefill_logits(t, ids, chunk), _prefill_logits(j, ids, chunk)
        slots = t.engine.new_cache(1).k[0].shape[1]
        assert slots == (24 if route == "wrapped_ring" else 256)
    with torch.no_grad():
        ref = hf(torch.tensor([ids])).logits[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=3e-3, rtol=3e-3)
    np.testing.assert_allclose(want, ref, atol=3e-3, rtol=3e-3)


# ------------------------------------------------------------ tokenizer and template
def test_template_ids_match_jax(narrow):
    """The harmony template over two rounds with each package's dated
    default system prompt, built in this one test (the same day)."""
    _, j, t = narrow
    assert t.tokenizer.sys_prompt == j.tokenizer.sys_prompt
    assert "Current date: " in t.tokenizer.sys_prompt
    jh, th = JMessages(), TMessages()
    for text in ("Hello, wörld! 12345 <|start|>", "中文 µ ½ 2024 \r\n\r\n  x"):
        jh.push_back(JRole.USER, text)
        th.push_back(TRole.USER, text)
        ji = j.tokenizer.encode_history(jh, 1024, incremental=False)
        ti = t.tokenizer.encode_history(th, 1024, incremental=False)
        assert ti == ji
        jh.push_back(JRole.ASSISTANT, text[::-1])
        th.push_back(TRole.ASSISTANT, text[::-1])
    tok = t.tokenizer
    assert t.tokenizer.encode_sys_prompt() == j.tokenizer.encode_sys_prompt()
    assert t.tokenizer.decode(ti) == j.tokenizer.decode(ji)
    assert tok.terminate_ids == j.tokenizer.terminate_ids == {tok.end_token_id,
                                                               tok.return_token_id}
    # system, two users, one reply and the opening: five <|start|> and four
    # <|end|>, besides the special piece that the first text spells out
    assert ti.count(tok.start_token_id) == 6 and ti.count(tok.end_token_id) == 4
    assert ti[-1] == tok.message_token_id and tok.eos_token_id == tok.end_token_id


UNICODE_TEXTS = {
    "accents": "Café naïve résumé — ÉCOLE Ünïcode, the theater",
    "combining": "été café ÅA ño",
    "title_case": "ǅungla ǈj ǋa Ǉ ǲ and MacDonald O'Neil HTTPServer iPhone",
    "cjk": "中文字符 中中 日本語のテキスト 한국어 ʰmodifier ˈstress",
    "digits": "1234567 12 123456789 ٣٤٥٦٧ ⅧⅨ ²³ 2024-10-18",
    "contractions": "I'm you're they've we'll he'd it's DON'T SHE'LL isn't 'tis",
    "crlf": "line1\r\nline2\r\n\r\n  spaced\ttab \n.\r\nend!!  !!",
}


@pytest.mark.parametrize("case", list(UNICODE_TEXTS))
def test_tokenizer_ids_match_jax(narrow, case):
    """o200k_harmony's pre-split on the standard `re` (the port) against
    `regex` (the JAX package): the same pieces, and the same ids over a
    vocab whose merges cross the pre-split's boundaries."""
    _, j, t = narrow
    text = UNICODE_TEXTS[case]
    assert t.tokenizer.tp._regex_split(text) == j.tokenizer.tp._regex_split(text)
    ids = t.tokenizer.encode(text)
    assert ids == j.tokenizer.encode(text)
    assert any(i >= 256 for i in ids) or case == "title_case"
    assert t.tokenizer.decode(ids) == j.tokenizer.decode(ids) == text


# ------------------------------------------------------------ attention with sinks
def _qkv(rng, B, T, S, Hq, Hkv, D):
    return (rng.standard_normal((B, T, Hq, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


# (B, T, Hq, Hkv, D, S, n_past, window, q8, route): "k4" is K4's plain twin
# in the port and the Pallas kernel in interpret mode on the JAX side (D 64,
# 8 query heads a kv head: its per-head kernel); "k3_sized" and
# "chunk_sized" are shapes that would take K3 or the chunked route without
# sinks and take the einsum with them, on both sides
SINK_ROUTES = {
    "einsum": (1, 5, 16, 2, 64, 64, 20, 0, False, "einsum"),
    "einsum_window": (1, 5, 16, 2, 64, 64, 30, 8, False, "einsum"),
    "per_row": (3, 1, 16, 2, 64, 64, [3, 40, 0], 0, False, "per_row"),
    "per_row_q8": (3, 1, 16, 2, 64, 64, [3, 40, 17], 0, True, "per_row"),
    "k4": (1, 1, 16, 2, 64, 4096, 3000, 0, True, "k4"),
    "k4_per_row": (2, 1, 16, 2, 64, 4096, [1000, 4000], 0, True, "k4"),
    "k3_sized": (1, 128, 16, 2, 64, 1024, 200, 0, False, "einsum"),
    "chunk_sized": (1, 64, 16, 2, 64, 4096, 2500, 0, False, "einsum"),
}


@pytest.mark.parametrize("case", list(SINK_ROUTES))
def test_attention_with_sinks_matches_jax(case, monkeypatch):
    B, T, Hq, Hkv, D, S, n_past, window, q8, route = SINK_ROUTES[case]
    monkeypatch.setattr(jatt, "_flash_decode_enabled", lambda: True)
    chunked = tatt._chunked_attention

    def no_chunks(*a, **kw):
        raise AssertionError("the chunked route took sinks")

    monkeypatch.setattr(tatt, "_chunked_attention", no_chunks)
    rng = np.random.default_rng(len(case))
    q, k, v = _qkv(rng, B, T, S, Hq, Hkv, D)
    sinks = (2.0 * rng.standard_normal(Hq)).astype(np.float32)
    jkw, tkw = {}, {}
    jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k), torch.from_numpy(v)
    if q8:
        (jk, jks), (jv, jvs) = jatt.quantize_kv(jk), jatt.quantize_kv(jv)
        tk, tv = (torch.from_numpy(np.array(a)) for a in (jk, jv))
        jkw = dict(k_scale=jks, v_scale=jvs)
        tkw = {n: torch.from_numpy(np.array(a)) for n, a in jkw.items()}
    per_row = isinstance(n_past, list)
    jnp_past = jnp.asarray(n_past, jnp.int32) if per_row else n_past
    tnp_past = torch.tensor(n_past) if per_row else n_past
    kw = dict(scale=D ** -0.5, causal=True, sliding_window=window)
    jqmm.reset_kernel_dispatch_stats()
    tqmm.reset_kernel_dispatch_stats()
    ref = np.asarray(jatt.attention_with_cache(jnp.asarray(q), jk, jv, jnp_past, T,
                                               sinks=jnp.asarray(sinks), **kw, **jkw))
    out = tatt.attention_with_cache(torch.from_numpy(q), tk, tv, tnp_past, T,
                                    sinks=torch.from_numpy(sinks), **kw, **tkw).numpy()
    took = tqmm.kernel_dispatch_stats()
    jax_k4 = any(r.startswith("flash_decode") for r in jqmm.kernel_dispatch_stats())
    assert jax_k4 == (took.get("flash_decode:q8kv", 0) == 1) == (route == "k4")
    assert "flash_attention" not in took
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    # the sinks move the output: without them (and the chunked route back,
    # which a chunk-sized call then takes) it differs
    monkeypatch.setattr(tatt, "_chunked_attention", chunked)
    no_sink = tatt.attention_with_cache(torch.from_numpy(q), tk, tv, tnp_past, T, **kw,
                                        **tkw).numpy()
    assert np.abs(no_sink - out).max() > 1e-3 * np.abs(out).max()


def test_k4_plain_twin_with_sinks_matches_pallas_per_head_kernel():
    """K4's plain twin at GPT-OSS's decode shape (64 query heads over 8 kv
    heads of 64, q8 cache, sinks; the JAX route's per-head kernel, f32
    dots) against the Pallas kernel in interpret mode, at two frontiers."""
    from chatllm_tpu.ops.pallas.flash_decode import flash_decode as jfd
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode_plain

    rng = np.random.default_rng(64)
    q, k, v = _qkv(rng, 2, 1, 1024, 64, 8, 64)
    sinks = rng.standard_normal(64).astype(np.float32)
    (jk, jks), (jv, jvs) = jatt.quantize_kv(jnp.asarray(k)), jatt.quantize_kv(jnp.asarray(v))
    npv = [300, 1000]
    ref = np.asarray(jfd(jnp.asarray(q), jk, jv, jnp.asarray(npv, jnp.int32), 1, scale=0.125,
                         k_scale=jks, v_scale=jvs, sinks=jnp.asarray(sinks), block_k=512,
                         interpret=True))
    t = (torch.from_numpy(np.array(a)) for a in (jk, jv, jks, jvs))
    tk, tv, tks, tvs = t
    out = flash_decode_plain(torch.from_numpy(q), tk, tv, torch.tensor(npv), 1, scale=0.125,
                             k_scale=tks, v_scale=tvs, sinks=torch.from_numpy(sinks)).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


# ------------------------------------------------------------ MoE modes
H, E, FE, K = 64, 8, 32, 4


def _moe_cfgs():
    common = dict(vocab_size=32, hidden_size=H, num_hidden_layers=1, num_attention_heads=4,
                  num_key_value_heads=4, intermediate_size=FE, max_length=16,
                  moe_num_experts=E, moe_top_k=K, moe_score_func="softmax_topk",
                  moe_act="swiglu_oai", moe_swiglu_limit=7.0)
    return tT.TransformerConfig(**common), jT.TransformerConfig(**common)


def _moe_params(rng, dtype):
    """The router (dense f32, no bias of its own) with gate_linear_bias, and
    the expert stacks and biases in `dtype`."""
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16,
                                                                        jnp.bfloat16)
    w = (rng.standard_normal((H, E)) * H ** -0.5).astype(np.float32)
    bias = rng.standard_normal(E).astype(np.float32)
    ex = {"gate": (E, H, FE), "up": (E, H, FE), "down": (E, FE, H), "gate_b": (E, FE),
          "up_b": (E, FE), "down_b": (E, H)}
    ex = {n: (rng.standard_normal(s) * (s[1] ** -0.5 if len(s) == 3 else 0.5))
          .astype(np.float32) for n, s in ex.items()}
    tp = {"gate": tq.DenseLinear(w=torch.from_numpy(w)), "gate_linear_bias": torch.from_numpy(bias),
          "experts": {n: torch.from_numpy(a).to(tdt) for n, a in ex.items()}}
    jp = {"gate": jq.DenseLinear(w=jnp.asarray(w)), "gate_linear_bias": jnp.asarray(bias),
          "experts": {n: jnp.asarray(a).astype(jdt) for n, a in ex.items()}}
    return tp, jp, tdt, jdt


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["route", "experts", "moe_mlp"])
def test_moe_modes_match_jax(mode, dtype, monkeypatch):
    """route: the top 4 of the biased logits (the lower index first among
    equal ones) and the softmax over them, picks equal and weights within
    1e-6; experts: the biased experts under swiglu_oai (in f32, cast back)
    on the same picks, with inputs large enough that both clamps act;
    moe_mlp: the whole FFN.  f32 within 1e-5 of the output scale, bf16
    within 2^-7."""
    rng = np.random.default_rng(70 + len(mode))
    tc, jc = _moe_cfgs()
    tp, jp, tdt, jdt = _moe_params(rng, dtype)
    x = (4.0 * rng.standard_normal((2, 6, H))).astype(np.float32)
    tx, jx = torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    picks = {}
    combine = jT._moe_combine

    def spy(cfg, p, xt, topi, topv, x_):
        picks["topi"], picks["topv"] = np.asarray(topi), np.asarray(topv)
        return combine(cfg, p, xt, topi, topv, x_)

    monkeypatch.setattr(jT, "_moe_combine", spy)
    want = jT.moe_mlp(jc, jp, jx)
    if mode == "route":
        topi, topv = tT.moe_route(tc, tp, tx.reshape(-1, H))
        np.testing.assert_array_equal(topi.numpy(), picks["topi"])
        np.testing.assert_allclose(topv.numpy(), picks["topv"], rtol=1e-6, atol=1e-6)
        assert len({tuple(sorted(r)) for r in picks["topi"]}) > 1
        return
    if mode == "experts":
        xt, jxt = tx.reshape(-1, H), jx.reshape(-1, H)
        topi, topv = np.array(picks["topi"]), np.array(picks["topv"])
        g = np.asarray((jxt.astype(jnp.float32) @ jp["experts"]["gate"].astype(jnp.float32)))
        assert (g > 7.0).any() and (g < -7.0).any()
        want = jT._experts_out(jc, jp["experts"], jxt, jnp.asarray(topi), jnp.asarray(topv), E)
        got = tT._experts_out(tc, tp["experts"], xt, torch.from_numpy(topi),
                              torch.from_numpy(topv), E)
    else:
        got = tT.moe_mlp(tc, tp, tx)
    assert got.dtype == tdt
    assert _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) <= tol


def test_topk_ties_take_the_lower_index():
    """Equal biased logits: the picks are the lower indices (XLA's top_k)."""
    tc, _ = _moe_cfgs()
    w = torch.zeros(H, E)
    p = {"gate": tq.DenseLinear(w=w), "gate_linear_bias": torch.tensor([0., 1, 1, 0, 1, 1, 0, 1])}
    topi, topv = tT.moe_route(tc, p, torch.ones(3, H))
    assert topi.tolist() == [[1, 2, 4, 5]] * 3 and torch.allclose(topv, torch.full((3, 4), .25))


# ------------------------------------------------------------ engines and entry points
def test_batched_two_slots_match_single_runs(narrow):
    """Three requests over two slots, the third admitted while the others
    decode; the long one wraps the 576-slot ring, the full layer takes the
    sinks on the per-slot route."""
    _, _, t = narrow
    prompts = [LONG, LONG[7:40], LONG[100:113]]
    with torch.inference_mode():
        expect = [_greedy(t, TGen, p) for p in prompts]
    eng = BatchedEngine(t.cfg, t.params, max_slots=2, decode_block=4,
                        scfg=SamplerConfig(do_sample=False, sampling="greedy"), device="cpu")
    try:
        got = [list(h) for h in [eng.submit(p, max_new=NEW) for p in prompts]]
    finally:
        eng.shutdown()
    assert got == expect


def _cli(mod, argv):
    buf = io.StringIO()
    old, sys.stdin = sys.stdin, io.StringIO("")
    try:
        with contextlib.redirect_stdout(buf):
            assert mod.main(argv) == 0
    finally:
        sys.stdin = old
    return [ln for ln in buf.getvalue().splitlines() if "eval time:" not in ln]


def test_cli_transcript_matches_jax(narrow, tmp_path):
    """`main.py --test` over two turns, greedy, f32, with the dated default
    system prompt."""
    path = narrow[0]
    turns = tmp_path / "turns.txt"
    turns.write_text("\n".join(chip_smoke.family_turns("gpt_oss")) + "\n")
    argv = ["-m", path, "--test", str(turns), "-t", "0", "--max_new_tokens", "6",
            "--compute_dtype", "f32", "--cache_dtype", "f32"]
    jt, tt = _cli(jmain, argv), _cli(tmain, argv + ["--device", "cpu"])
    assert tt == jt and sum(ln.startswith("A.I.") for ln in tt) == 2


def _post(url, obj):
    req = urllib.request.Request(url, json.dumps(obj).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_server_replies_match_jax(narrow):
    """The port's 2-slot server and the JAX package's server, both over the
    narrow file: the same greedy chat replies, two requests at once on the
    port."""
    _, j, t = narrow
    gen = dict(do_sample=False, max_new_tokens=6)
    apis = {"jax": (jserver, jserver.ApiServer(j, model_name="tiny", gen_config=JGen(**gen))),
            "port": (tserver, tserver.ApiServer(t, model_name="tiny", max_slots=2,
                                                gen_config=TGen(**gen), device="cpu"))}
    servers = {}
    for name, (mod, api) in apis.items():
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), mod._make_handler(api))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers[name] = (httpd, f"http://127.0.0.1:{httpd.server_port}")
    texts = ["Hello from the H100!", "Café 中文 12345"]

    def chat(name, text):
        out = _post(servers[name][1] + "/v1/chat/completions",
                    {"messages": [{"role": "user", "content": text}]})
        return out["choices"][0]["message"]["content"]

    try:
        want = [chat("jax", s) for s in texts]
        got = [None, None]
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(i, chat("port", texts[i])))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        assert got == want
    finally:
        for httpd, _ in servers.values():
            httpd.shutdown()
        apis["port"][1].batch.shutdown()


# ------------------------------------------------------------ synthetic
def test_gpt_oss_20b_config_and_synthetic_layout():
    """The published widths, the sliding layers even, YaRN 32 over 4096;
    GPT_OSS_OPTS on a cut of its shape (2 layers, 4 experts, a short vocab):
    sinks, the router's and the experts' biases, biased q/k/v/o, no head
    bias, q/k/v, the router and the head (K 2880) in q8_0, o in q4_k, and a
    forward pass of finite logits through both ring and full layers.  The
    layout follows from the config alone: built without GPT_OSS_OPTS, the
    cut has the same sinks and biases."""
    from dataclasses import replace

    from chatllm_tpu_torch.ops.qmm import dequant_weight

    cfg = synthetic.gpt_oss_20b_config()
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.num_key_value_heads, cfg.resolved_head_dim(), cfg.vocab_size) == \
        (2880, 24, 64, 8, 64, 201088)
    assert (cfg.moe_num_experts, cfg.moe_top_k, cfg.moe_intermediate_size) == (32, 4, 2880)
    assert [s.sliding_window for s in cfg.layer_specs] == [128, 0] * 12
    assert (cfg.rope.freq_scale, cfg.rope.orig_ctx, cfg.rope.freq_base) == (1 / 32, 4096, 150000)
    small = replace(cfg, num_hidden_layers=2, layer_specs=cfg.layer_specs[:2], vocab_size=512,
                    moe_num_experts=4, moe_top_k=2, moe_intermediate_size=256, max_length=1024)
    p = synthetic.build_synthetic_params(small, "q4k", zeros=False, centered=True,
                                         **synthetic.GPT_OSS_OPTS)
    layer = p["layers"][0]
    assert layer["attn"]["sinks"].shape == (64,) and layer["attn"]["o"].bias is not None
    assert all(layer["attn"][k].bias is not None for k in "qkv")
    assert p["lm_head"].bias is None and layer["mlp"]["gate_linear_bias"].shape == (4,)
    assert layer["mlp"]["experts"]["down_b"].shape == (4, 2880)
    assert not layer["attn"]["q"].packed and layer["attn"]["o"].sb      # q8_0 / q4_k
    # centred: every quantized weight about n_in^-0.5 in spread
    for lin in (layer["attn"]["q"], layer["attn"]["o"], p["lm_head"]):
        std = dequant_weight(lin, torch.float32).std().item()
        assert 0.5 < std * lin.shape_in_out[0] ** 0.5 < 2.0
    ids = torch.tensor([[5, 9, 300, 7] * 40])
    with torch.inference_mode():
        eng_cache = tT.init_cache(small, 1)
        logits = tT.transformer_forward(small, p, ids, eng_cache, 0)[0]
    assert torch.isfinite(logits).all() and logits.shape == (1, 160, 512)
    assert [k.shape[1] for k in eng_cache.k] == [640, 1024]
    bare = synthetic.build_synthetic_params(small, "q4k", zeros=False)
    lb = bare["layers"][1]
    assert lb["attn"]["sinks"].shape == (64,) and lb["mlp"]["gate_linear_bias"].shape == (4,)
    assert {"gate_b", "up_b", "down_b"} <= set(lb["mlp"]["experts"])
    assert bare["lm_head"].bias is None and lb["attn"]["o"].bias is not None
