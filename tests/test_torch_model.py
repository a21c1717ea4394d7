"""A tiny Llama-3 GGMM, written with the JAX package's GGMMWriter, loaded into
both packages (f32 compute and cache): same config, same chat-rendered ids,
same prefill logits, same greedy tokens, same CLI transcript.

Both packages keep q4_k quantized, and their quantized matmuls compute in
bf16 at any activation dtype.  The port's CPU path runs its kernels' plain
versions, so the JAX side here runs its Pallas kernels in interpret mode
(the routing it takes on a TPU) instead of its CPU dequant path."""
import contextlib
import functools
import io

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import chip_smoke
import chatllm_tpu.main as jmain
import chatllm_tpu.models as jm
import chatllm_tpu.ops.qmm as jqmm
import chatllm_tpu_torch.main as tmain
import chatllm_tpu_torch.models as tm
from chatllm_tpu.ggmm.quants import GGMLType
from chatllm_tpu.ggmm.writer import GGMMWriter
from chatllm_tpu.runtime.chat import Messages as JMessages, MsgRole as JRole
from chatllm_tpu.runtime.generate import GenerationConfig as JGen
from chatllm_tpu_torch.ops.qtensor import QuantLinear
from chatllm_tpu_torch.runtime.chat import Messages as TMessages, MsgRole as TRole
from chatllm_tpu_torch.runtime.generate import GenerationConfig as TGen

# logit tolerance: f32 at atol = rtol; q4_k relative to the logit scale.
# With bf16 matmul inputs, the ~1e-6 differences of two f32 attention sums
# flip some bf16 roundings of the next projection's input (one flip moves
# an output by ~2^-8 |x_i w_i|), and the flips compound over the layers:
# ~8e-3 of the logit scale measured on these models, at 2 layers.
DTYPES = {"f32": (GGMLType.F32, 1e-4), "q4_k": (GGMLType.Q4_K, 2e-2)}
LLAMA31 = (8192, 8.0, 1.0, 4.0)


@pytest.fixture(scope="module", autouse=True)
def jax_pallas_interpret():
    """Route the JAX package's quantized matmuls to its Pallas kernels in
    interpret mode, as on a TPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqmm, "use_pallas_qmm", lambda: True)
        mp.setattr(jqmm, "_pallas_local",
                   functools.partial(jqmm._pallas_local, interpret=True))
        yield


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    out = {}
    for name, (t, _) in DTYPES.items():
        for scaling in (None, LLAMA31):
            key = (name, scaling is not None)
            path = tmp_path_factory.mktemp("ggmm") / f"{name}_{int(key[1])}.bin"
            chip_smoke.write_llama3_ggmm(path, dtype=t, writer_cls=GGMMWriter,
                                         rope_scaling=scaling, seed=len(out))
            j = jm.load_model(str(path), jm.RuntimeConfig(
                compute_dtype="float32", cache_dtype="float32"))
            p = tm.load_model(str(path), tm.RuntimeConfig(
                compute_dtype="float32", cache_dtype="float32"), device="cpu")
            out[key] = (str(path), j, p)
    return out


KEYS = [(n, s) for n in DTYPES for s in (False, True)]
IDS = [f"{n}{'-llama31' if s else ''}" for n, s in KEYS]


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_config_matches(models, key):
    _, j, p = models[key]
    assert type(p).__name__ == type(j).__name__
    for f in ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "intermediate_size", "max_length", "head_dim",
              "norm_eps", "tie_lm_head"):
        assert getattr(p.cfg, f) == getattr(j.cfg, f), f
    for f in ("head_dim", "freq_base", "layout", "freq_factors", "freq_scale"):
        assert getattr(p.cfg.rope, f) == getattr(j.cfg.rope, f), f
    lin = p.params["layers"][0]["mlp"]["gate"]
    assert isinstance(lin, QuantLinear) == (key[0] == "q4_k")


PROMPTS = ["hi", "Hello, wörld! 123 ab  cd\n\nxyz", "中文 résumé — ½ ₂ don't I'LL",
           "<|eot_id|> inside text\t\r\n  trailing   "]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_chat_ids_match(models, prompt):
    _, j, p = models[("f32", False)]
    jh, th = JMessages(), TMessages()
    for _ in range(2):
        jh.push_back(JRole.USER, prompt)
        th.push_back(TRole.USER, prompt)
        ji = j.tokenizer.encode_history(jh, 512, incremental=False)
        ti = p.tokenizer.encode_history(th, 512, incremental=False)
        assert ti == ji
        jh.push_back(JRole.ASSISTANT, prompt[::-1])
        th.push_back(TRole.ASSISTANT, prompt[::-1])
    assert p.tokenizer.decode(ti) == j.tokenizer.decode(ji)


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_prefill_logits_match(models, key):
    _, j, p = models[key]
    h = JMessages()
    h.push_back(JRole.USER, PROMPTS[1])
    ids = j.tokenizer.encode_history(h, 512)
    lj = np.asarray(j.forward_logits(np.array([ids]))[0])
    lp = p.forward_logits(np.array([ids]))[0].numpy()
    tol = DTYPES[key[0]][1]
    # the bucketed-prefill path: last real token only
    eng = p.engine
    last, _, n_past = eng.prefill(ids, eng.new_cache(1, 128), 0)
    assert n_past == len(ids)
    if key[0] == "f32":
        np.testing.assert_allclose(lp, lj, atol=tol, rtol=tol)
        np.testing.assert_allclose(last.numpy()[0], lj[0, -1], atol=tol, rtol=tol)
    else:
        scale = np.abs(lj).max()
        assert np.abs(lp - lj).max() <= tol * scale
        assert np.abs(last.numpy()[0] - lj[0, -1]).max() <= tol * scale
        assert (lp.argmax(-1) == lj.argmax(-1)).mean() >= 0.9


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_greedy_tokens_match(models, key):
    _, j, p = models[key]
    ids = j.tokenizer.encode(PROMPTS[2])
    jout, _, jn = j.engine.generate(ids, JGen(do_sample=False, max_new_tokens=16))
    pout, _, pn = p.engine.generate(ids, TGen(do_sample=False, max_new_tokens=16))
    assert len(pout) == 16
    assert pout == jout and pn == jn


def _run(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(argv) == 0
    return [ln for ln in buf.getvalue().splitlines() if "eval time:" not in ln], buf.getvalue()


@pytest.mark.parametrize("name", list(DTYPES))
def test_cli_transcript_matches(models, name):
    path = models[(name, False)][0]
    argv = ["-m", path, "-p", "Tell me a story.", "-t", "0", "--max_new_tokens", "12",
            "--compute_dtype", "f32", "--cache_dtype", "f32"]
    jlines, _ = _run(jmain, argv)
    tlines, raw = _run(tmain, argv + ["--device", "cpu"])
    assert tlines == jlines
    assert tlines[0] == "You  > Tell me a story." and tlines[1].startswith("A.I. > ")
    assert raw.count("eval time:") == 2


def test_q8_cache_greedy_tokens_match(tmp_path, monkeypatch):
    """--cache_dtype q8_0 at a 4096-token context: the prefill takes the
    online-softmax chunks and every decode step K4 on both sides (the JAX
    package under its TPU routing, its flash_decode in interpret mode; the
    port's plain version of K4), and the greedy tokens agree."""
    import chatllm_tpu.ops.attention as jatt
    from chatllm_tpu_torch.ops import qmm as tqmm

    monkeypatch.setattr(jatt, "_flash_decode_enabled", lambda: True)
    path = chip_smoke.write_llama3_ggmm(tmp_path / "q8.bin", dtype=GGMLType.F32,
                                        writer_cls=GGMMWriter, max_len=4096, seed=11)
    rt = dict(compute_dtype="float32", cache_dtype="int8")
    j = jm.load_model(str(path), jm.RuntimeConfig(**rt))
    p = tm.load_model(str(path), tm.RuntimeConfig(**rt), device="cpu")
    ids = j.tokenizer.encode(PROMPTS[1])
    tqmm.reset_kernel_dispatch_stats()
    pout, _, pn = p.engine.generate(ids, TGen(do_sample=False, max_new_tokens=12))
    # layers x steps run: the 11 decode steps go in one block of 12 (the
    # block is min(decode_block, max_new)), whose last step is speculative
    assert tqmm.kernel_dispatch_stats()["flash_decode:q8kv"] == 2 * 12
    jout, _, jn = j.engine.generate(ids, JGen(do_sample=False, max_new_tokens=12))
    assert len(pout) == 12 and pout == jout and pn == jn


def test_cli_q8_cache_flag(models):
    """`--cache_dtype q8_0` maps to the int8 cache, as in the JAX CLI, and
    greedy transcripts repeat."""
    path = models[("f32", False)][0]
    argv = ["-m", path, "-p", "hi", "-t", "0", "--max_new_tokens", "6",
            "--cache_dtype", "q8_0", "--device", "cpu"]
    assert tmain.parse_args(argv).cache_dtype == "int8"
    assert jmain.parse_args(argv[:-2]).cache_dtype == "int8"
    first, _ = _run(tmain, argv)
    again, _ = _run(tmain, argv)
    assert first == again and first[1].startswith("A.I. > ")
