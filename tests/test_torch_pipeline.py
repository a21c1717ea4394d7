"""The port's chat Pipeline and the engine functions under it, held against
the JAX package on tiny GGMMs written with the JAX package's writer (f32
weights unless stated; q4_k runs the JAX side's Pallas kernels in interpret
mode, as on a TPU):

  - `rope_mscale` and `InferenceEngine.shift_cache` on the same cache
    contents, for Llama-3 (NORMAL, with and without the llama3 scaling) and
    Qwen2 (NEOX) over f32, bf16 and q8 caches; the port shifts in place;
  - multi-round greedy chats under each extending method and cache dtype:
    the same replies and n_past round by round;
  - eval_sys_prompt, restart, chat_continue, rewind, the AI prefix,
    reversed roles, the QA format and text completion;
  - Shift over MLA: the port refuses it, and the JAX package's shifted
    cache shows why (k_pe is moved but not re-rotated);
  - `generate_from_logits`, `--re_quantize`'s repacked weights and
    `--layer_spec`.

Tolerances: a shifted f32 key within 1e-6 of the key scale; a bf16 key
bit-equal or one bf16 ulp apart; a q8 key at most one int8 step apart, in
at most 1e-3 of the entries (a requantization tie that the two rotations'
last-bit differences round apart), its scale within 1e-6 relative."""
import functools

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import torch_one_thread  # noqa: F401  (one intra-op thread: see its docstring)

import jax.numpy as jnp

import chip_smoke
import chatllm_tpu.models as jm
import chatllm_tpu.ops.qmm as jqmm
import chatllm_tpu_torch.models as tm
from chatllm_tpu.ggmm.quants import GGMLType
from chatllm_tpu.ggmm.writer import GGMMWriter
from chatllm_tpu.nn.transformer import KVCache as JKV
from chatllm_tpu.ops.rope import rope_mscale as j_mscale
from chatllm_tpu.runtime.generate import GenerationConfig as JGen
from chatllm_tpu.runtime.pipeline import ExtendingMethod as JExt, Pipeline as JPipe
from chatllm_tpu_torch.ops.rope import RopeConfig as TRope, rope_mscale as t_mscale
from chatllm_tpu_torch.runtime.generate import GenerationConfig as TGen
from chatllm_tpu_torch.runtime.pipeline import ExtendingMethod as TExt, Pipeline as TPipe

LLAMA31 = (8192, 8.0, 1.0, 4.0)
CACHES = {"f32": "float32", "bf16": "bfloat16", "q8": "int8"}
Q8_SHARE = 1e-3           # q8 keys one step apart, at most this share
SYS = "You are a terse assistant. Answer in one line."
TURNS = ["Hello there, how are you today?", "Tell me about the weather in Paris.",
         "Name three prime numbers and a colour.", "What did I ask first? Be brief.",
         "Write one line of a poem about rivers.", "Count from one to five in words."]


@pytest.fixture(scope="module", autouse=True)
def jax_pallas_interpret():
    """Route the JAX package's quantized matmuls to its Pallas kernels in
    interpret mode, as on a TPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqmm, "use_pallas_qmm", lambda: True)
        mp.setattr(jqmm, "_pallas_local",
                   functools.partial(jqmm._pallas_local, interpret=True))
        yield


def write(kind: str, path, **kw) -> str:
    """A tiny GGMM of `kind` (llama3, llama31, qwen2, llama3_q4k, dsv2)."""
    if kind == "qwen2":
        return str(chip_smoke.write_qwen2_ggmm(path, dtype=GGMLType.F32, writer_cls=GGMMWriter,
                                               **kw))
    if kind == "dsv2":
        return str(chip_smoke.write_deepseek_v2_ggmm(path, dtype=GGMLType.F32,
                                                     writer_cls=GGMMWriter, **kw))
    dtype = GGMLType.Q4_K if kind == "llama3_q4k" else GGMLType.F32
    return str(chip_smoke.write_llama3_ggmm(
        path, dtype=dtype, writer_cls=GGMMWriter,
        rope_scaling=LLAMA31 if kind == "llama31" else None, **kw))


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    return {k: write(k, d / f"{k}.bin") for k in ("llama3", "llama31", "qwen2", "llama3_q4k")}


_JAX_ENGINES: dict = {}


def load_pair(path, **rt):
    """The same file in both packages (f32 activations unless given).  Every
    JAX load of one file with the same options gets the engine of the first,
    so that its compiled prefill buckets and decode blocks serve every test
    of the module; the engine holds the same parameters' values and keeps no
    state between its calls."""
    rt = {"compute_dtype": "float32", **rt}
    j = jm.load_model(path, jm.RuntimeConfig(**rt))
    j._engine = _JAX_ENGINES.setdefault((path, tuple(sorted(rt.items()))), j.engine)
    return j, tm.load_model(path, tm.RuntimeConfig(**rt), device="cpu")


# ------------------------------------------------------------------- rope
@pytest.mark.parametrize("kw", [
    {}, {"freq_factors": (1.0, 2.0, 4.0, 8.0)},
    {"ext_factor": 1.0, "freq_scale": 1 / 40, "orig_ctx": 4096, "mscale_all": 0.707},
    {"attn_factor": 0.5, "mscale_all": 1.3},
], ids=["plain", "llama31", "yarn", "attn_factor"])
def test_rope_mscale_matches(kw):
    from chatllm_tpu.ops.rope import RopeConfig as JRope

    assert t_mscale(TRope(head_dim=64, **kw)) == j_mscale(JRope(head_dim=64, **kw))


# ------------------------------------------------------------- shift_cache
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def same_caches(j, p, S: int, seed: int):
    """Random cache contents, identical in a JAX cache and a port cache."""
    gen = torch.Generator().manual_seed(seed)
    pc = p.engine.new_cache(1, S)
    quant = pc.k_scale is not None
    planes = {"k": [], "v": [], "k_scale": [], "v_scale": []}
    for i in range(len(pc.k)):
        for name in ("k", "v"):
            dst = getattr(pc, name)[i]
            if quant:
                x = torch.randint(-127, 128, dst.shape, generator=gen,
                                  dtype=torch.int32).to(torch.int8)
                sc = torch.rand(dst.shape[:3], generator=gen) * 0.02 + 1e-3
                getattr(pc, name + "_scale")[i].copy_(sc)
                planes[name + "_scale"].append(jnp.asarray(sc.numpy()))
            else:
                x = torch.randn(dst.shape, generator=gen).to(dst.dtype)
            dst.copy_(x)
            planes[name].append(jnp.asarray(x.numpy()) if quant else jnp.asarray(
                x.float().numpy(), dtype=JDT[dst.dtype]))
    jc = JKV(k=tuple(planes["k"]), v=tuple(planes["v"]),
             k_scale=tuple(planes["k_scale"]) if quant else None,
             v_scale=tuple(planes["v_scale"]) if quant else None)
    return jc, pc


def _bits16(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.int16).astype(np.int32)


def assert_shifted_equal(jc, pc, cache: str, keep: int):
    """The port's shifted cache against the JAX package's (module
    docstring's tolerances); returns the share of q8 keys one step apart."""
    share = 0.0
    for i in range(len(pc.k)):
        pv, jv = pc.v[i], np.asarray(jc.v[i])
        pk, jk = pc.k[i], np.asarray(jc.k[i])
        if cache == "bf16":
            np.testing.assert_array_equal(_bits16(pv.view(torch.int16).numpy()), _bits16(jv))
            d = np.abs(_bits16(pk.view(torch.int16).numpy()) - _bits16(jk))
            assert d.max() <= 1, f"layer {i}: bf16 keys more than one ulp apart"
            continue
        np.testing.assert_array_equal(pv.numpy(), jv)
        np.testing.assert_array_equal(pk[:, :keep].numpy(), jk[:, :keep])
        if cache == "f32":
            scale = np.abs(jk).max()
            np.testing.assert_allclose(pk.numpy(), jk, rtol=1e-6, atol=1e-6 * scale)
            continue
        d = np.abs(pk.numpy().astype(np.int32) - jk.astype(np.int32))
        assert d.max() <= 1, f"layer {i}: q8 keys more than one step apart"
        share = max(share, float((d > 0).mean()))
        np.testing.assert_array_equal(pc.v_scale[i].numpy(), np.asarray(jc.v_scale[i]))
        np.testing.assert_allclose(pc.k_scale[i].numpy(), np.asarray(jc.k_scale[i]), rtol=1e-6)
    assert share <= Q8_SHARE, share
    return share


SHIFT_MODELS = ["llama3", "llama31", "qwen2"]


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("kind", SHIFT_MODELS)
def test_shift_cache_matches_jax(paths, kind, cache):
    j, p = load_pair(paths[kind], cache_dtype=CACHES[cache])
    S, n_past, keep = 96, 90, 7
    shift = (n_past - keep) // 2
    jc, pc = same_caches(j, p, S, seed=len(kind) + len(cache))
    ptrs = [t.data_ptr() for t in pc.k + pc.v + (pc.k_scale or []) + (pc.v_scale or [])]
    out = p.engine.shift_cache(pc, shift, keep, n_past)
    assert out is pc
    assert ptrs == [t.data_ptr() for t in pc.k + pc.v + (pc.k_scale or []) + (pc.v_scale or [])]
    jc = j.engine.shift_cache(jc, shift, keep, n_past)
    assert_shifted_equal(jc, pc, cache, keep)


def test_shift_cache_mechanics(paths):
    """The port's own shift (mirrors the JAX package's test): the kept rows
    stay, V moves verbatim, moved K is rope(-shift) of the old K."""
    from chatllm_tpu_torch.ops.rope import apply_rope, precompute_rope_cache, rope_mscale

    _, p = load_pair(paths["qwen2"], cache_dtype="float32")
    eng, cfg = p.engine, p.cfg
    cache = eng.new_cache(1, 64)
    _, cache, n_past = eng.prefill(list(range(2, 34)), cache, 0)
    keep, shift = 4, 8
    k_old, v_old = cache.k[0].clone(), cache.v[0].clone()
    eng.shift_cache(cache, shift, keep, n_past)
    k_new, v_new = cache.k[0], cache.v[0]
    assert torch.equal(k_new[:, :keep], k_old[:, :keep])
    assert torch.equal(v_new[:, :keep], v_old[:, :keep])
    assert torch.equal(v_new[:, keep:n_past - shift], v_old[:, keep + shift:n_past])
    seg = k_old[:, keep + shift:n_past]
    cos, sin = precompute_rope_cache(torch.full((1, seg.shape[1]), -shift), cfg.rope)
    m = rope_mscale(cfg.rope)
    expect = apply_rope(seg, cos / m, sin / m, layout=cfg.rope.layout)
    torch.testing.assert_close(k_new[:, keep:n_past - shift], expect, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("moved,ok", [(0, True), (2, True), (40, False)])
def test_chip_smoke_shift_check_bounds_the_share(paths, moved, ok):
    """chip_smoke's card-vs-CPU shift check passes keys one int8 step apart
    up to SHIFT_OFF_SHARE of the entries and refuses more."""
    _, p = load_pair(paths["qwen2"], cache_dtype="int8")
    eng = p.engine
    cache = eng.new_cache(1, 64)
    _, cache, _ = eng.prefill(list(range(2, 34)), cache, 0)
    other = chip_smoke._cache_copy(cache, "cpu")
    n = sum(k.numel() for k in cache.k)
    share = chip_smoke.SHIFT_OFF_SHARE
    k = other.k[0].view(-1)
    idx = torch.nonzero(k.abs() < 100).view(-1)[:moved]
    k[idx] += 1                                 # one step, away from the int8 edge
    with pytest.MonkeyPatch.context() as mp:
        # the fixture's cache is small: scale the bound to its entries so
        # that 2 keys stay inside it and 40 fall outside
        mp.setattr(chip_smoke, "SHIFT_OFF_SHARE", 10 / n)
        if ok:
            r = chip_smoke.shift_vs_cpu(cache, other, 0)
            assert r["int8_off_by_one"] == moved and r["int8_entries"] == n
        else:
            with pytest.raises(AssertionError, match="one step from the CPU shift"):
                chip_smoke.shift_vs_cpu(cache, other, 0)
    assert share == 1e-5


# --------------------------------------------------------- multi-round chats
def chat_rounds(pipe, gen, turns, sys_prompt=True):
    """Greedy rounds: (reply, n_past) after each."""
    pipe.gen_config = gen
    if sys_prompt:
        pipe.tokenizer.sys_prompt = SYS
        pipe.eval_sys_prompt()
    return [(pipe.chat(t), pipe.n_past) for t in turns]


CHAT_CASES = [(m, c) for m in ("shift", "restart") for c in CACHES] + \
             [("none", c) for c in CACHES]


@pytest.mark.parametrize("method,cache", CHAT_CASES, ids=[f"{m}-{c}" for m, c in CHAT_CASES])
def test_chat_rounds_match_jax(paths, method, cache, monkeypatch):
    # 256 slots: Shift and Restart fire within six rounds; None's rounds fit
    j, p = load_pair(paths["llama3"], cache_dtype=CACHES[cache], max_length=256)
    turns = TURNS if method != "none" else TURNS[:2]
    shifts = []
    orig = p.engine.shift_cache
    monkeypatch.setattr(p.engine, "shift_cache",
                        lambda *a: shifts.append(a[1:]) or orig(*a))
    jr = chat_rounds(JPipe(j, extending=JExt(method)), JGen(do_sample=False, max_new_tokens=10),
                     turns)
    pr = chat_rounds(TPipe(p, extending=TExt(method)), TGen(do_sample=False, max_new_tokens=10),
                     turns)
    assert pr == jr
    fell = [b[1] < a[1] for a, b in zip(pr, pr[1:])]
    if method == "shift":
        assert len(shifts) >= 2 and all(s[1] > 0 for s in shifts), shifts
    if method == "restart":
        assert any(fell), pr
    if method == "none":
        assert not any(fell)


def test_q4k_shift_chat_matches_jax(paths):
    """q4_k weights (the JAX side's Pallas kernels in interpret mode) over a
    q8 cache with Shift."""
    j, p = load_pair(paths["llama3_q4k"], cache_dtype="int8", max_length=256)
    gen = dict(do_sample=False, max_new_tokens=8)
    assert chat_rounds(TPipe(p, extending=TExt.SHIFT), TGen(**gen), TURNS[:4]) == \
        chat_rounds(JPipe(j, extending=JExt.SHIFT), JGen(**gen), TURNS[:4])


# ------------------------------------------ system prompt and history control
def _sys_restart_keep(pipe, g):
    pipe.tokenizer.sys_prompt = SYS
    pipe.eval_sys_prompt()
    out = [pipe.initial_n_past, pipe.chat(TURNS[0], gen_config=g)]
    pipe.restart(keep_sys_prompt=True)
    out += [pipe.n_past, pipe.chat(TURNS[1], gen_config=g), pipe.n_past]
    return out


def _sys_restart_drop(pipe, g):
    pipe.tokenizer.sys_prompt = SYS
    pipe.eval_sys_prompt()
    out = [pipe.chat(TURNS[0], gen_config=g)]
    pipe.restart(keep_sys_prompt=False)
    pipe.history.clear()
    out += [pipe.n_past, pipe.initial_n_past, pipe.chat(TURNS[1], gen_config=g), pipe.n_past]
    return out


def _chat_continue(pipe, g):
    out = [pipe.chat(TURNS[0], gen_config=g)]
    out += [pipe.chat_continue(gen_config=g), pipe.history.items[-1].content, pipe.n_past]
    return out


def _rewind(pipe, g):
    out = [pipe.chat(TURNS[0], gen_config=g), pipe.chat(TURNS[1], gen_config=g)]
    pipe.rewind(2)
    pipe.restart()
    out += [len(pipe.history), pipe.chat(TURNS[2], gen_config=g), pipe.n_past]
    return out


def _ai_prefix(pipe, g):
    pipe.ai_prefix = "Sure! "
    return [pipe.chat(TURNS[0], gen_config=g), pipe.chat(TURNS[1], gen_config=g),
            pipe.history.items[-1].content, pipe.n_past]


def _reversed_role(pipe, g):
    pipe.reversed_role = True
    return [pipe.chat(TURNS[0], gen_config=g), pipe.chat(TURNS[1], gen_config=g),
            [int(m.role) for m in pipe.history.items], pipe.n_past]


def _qa_format(pipe, g):
    pipe.qa_format = True
    out = [pipe.chat(TURNS[0], gen_config=g), pipe.chat(TURNS[1], gen_config=g)]
    return out + [len(pipe.history), pipe.history[0].content, pipe.n_past]


def _text_completion(pipe, g):
    return [pipe.text_completion("Once upon a time", gen_config=g), pipe.n_past]


CONTROLS = {"sys_prompt_restart_keep": _sys_restart_keep,
            "sys_prompt_restart_drop": _sys_restart_drop, "chat_continue": _chat_continue,
            "rewind": _rewind, "ai_prefix": _ai_prefix, "reversed_role": _reversed_role,
            "qa_format": _qa_format, "text_completion": _text_completion}


@pytest.mark.parametrize("name", list(CONTROLS))
def test_history_controls_match_jax(paths, name):
    j, p = load_pair(paths["llama3"], cache_dtype="float32")
    jo = CONTROLS[name](JPipe(j), JGen(do_sample=False, max_new_tokens=6))
    po = CONTROLS[name](TPipe(p), TGen(do_sample=False, max_new_tokens=6))
    assert po == jo


def test_reversed_role_opens_a_user_turn(paths):
    """Mirrors the JAX package's test: the incoming text is the ASSISTANT
    turn and the prompt ends with a USER opening."""
    from chatllm_tpu_torch.runtime.chat import MsgRole

    _, p = load_pair(paths["llama3"], cache_dtype="float32")
    pipe = TPipe(p)
    pipe.reversed_role = True
    assert isinstance(pipe.chat("Hello", gen_config=TGen(do_sample=False, max_new_tokens=4)),
                      str)
    assert [m.role for m in pipe.history.items] == [MsgRole.ASSISTANT, MsgRole.USER]
    ids = []
    pipe.tokenizer.chat_encoder.append_user_opening(0, ids)
    full = pipe.tokenizer.encode_history(pipe.history, 256, reversed_role=True)
    assert full[-len(ids):] == ids


def test_qa_format_keeps_one_round(paths):
    """Mirrors the JAX package's test: history is dropped between rounds."""
    _, p = load_pair(paths["llama3"], cache_dtype="float32")
    pipe = TPipe(p)
    pipe.qa_format = True
    g = TGen(do_sample=False, max_new_tokens=3)
    pipe.chat("first question", gen_config=g)
    pipe.chat("second question", gen_config=g)
    assert len(pipe.history) == 2 and pipe.history[0].content == "second question"


# -------------------------------------------------------------- MLA shift
@pytest.fixture(scope="module")
def dsv2(tmp_path_factory):
    return write("dsv2", tmp_path_factory.mktemp("dsv2") / "dsv2.bin")


def test_shift_refused_over_mla(dsv2):
    _, p = load_pair(dsv2, cache_dtype="float32")
    cache = p.engine.new_cache(1, 64)
    with pytest.raises(NotImplementedError, match="k_pe"):
        p.engine.shift_cache(cache, 8, 0, 40)
    pipe = TPipe(p, extending=TExt.SHIFT)
    pipe.n_past = p.engine.max_length - 2       # the next round must shift
    pipe._cache = p.engine.new_cache(1)
    with pytest.raises(NotImplementedError, match="MLA"):
        pipe.chat("hello", gen_config=TGen(do_sample=False, max_new_tokens=2))


def test_jax_mla_shift_leaves_k_pe_unrotated(dsv2):
    """Why the port refuses: the JAX package rotates the first rot_dim (64)
    channels of an MLA key row, which are no-rope channels, and moves the
    row's rope part (the last 64, k_pe) without rotating it."""
    j = jm.load_model(dsv2, jm.RuntimeConfig(compute_dtype="float32", cache_dtype="float32"))
    cfg, eng = j.cfg, j.engine
    rot, rope = cfg.rope.resolved_rot_dim(), cfg.mla.qk_rope_head_dim
    assert rot == rope == 64 and cfg.mla.qk_nope_head_dim == 128
    cache = eng.new_cache(1, 64)
    _, cache, n_past = eng.prefill(list(range(2, 42)), cache, 0)
    keep, shift = 4, 8
    k_old = np.asarray(cache.k[0])
    k_new = np.asarray(eng.shift_cache(cache, shift, keep, n_past).k[0])
    moved_old, moved_new = k_old[:, keep + shift:n_past], k_new[:, keep:n_past - shift]
    # k_pe moved verbatim: a key at its old position's rotation
    np.testing.assert_array_equal(moved_new[..., -rope:], moved_old[..., -rope:])
    # ... while the first 64 no-rope channels were rotated
    assert np.abs(moved_new[..., :rot] - moved_old[..., :rot]).max() > 1e-3


# ------------------------------------------------------ generate_from_logits
def test_generate_from_logits_matches_jax(paths):
    j, p = load_pair(paths["llama3"], cache_dtype="float32")
    ids = j.tokenizer.encode("Tell me something about the sea.")
    logits, jc, n_past = j.engine.prefill(ids, j.engine.new_cache(1, 256), 0)
    pc = p.engine.new_cache(1, 256)
    for dst, src in zip(pc.k + pc.v, jc.k + jc.v):
        dst.copy_(torch.from_numpy(np.array(src)))
    lp = torch.from_numpy(np.asarray(logits))
    jout, _, jn = j.engine.generate_from_logits(logits, jc, n_past,
                                                JGen(do_sample=False, max_new_tokens=12))
    pout, _, pn = p.engine.generate_from_logits(lp, pc, n_past,
                                                TGen(do_sample=False, max_new_tokens=12))
    assert len(pout) == 12 and pout == jout and pn == jn


# ------------------------------------------------------------- re_quantize
def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


@pytest.mark.parametrize("src,target", [("llama3_q4k", "q8_0"), ("llama3", "q4_k")])
def test_re_quantize_weights_bit_exact(paths, src, target):
    from chatllm_tpu_torch.ops.qtensor import QuantLinear

    j, p = load_pair(paths[src], re_quantize=target)
    pairs = [(j.params["lm_head"], p.params["lm_head"])]
    for jl, pl in zip(j.params["layers"], p.params["layers"]):
        pairs += [(jl["attn"][k], pl["attn"][k]) for k in ("q", "k", "v", "o")]
        pairs += [(jl["mlp"][k], pl["mlp"][k]) for k in ("gate", "up", "down")]
    for jw, pw in pairs:
        assert isinstance(pw, QuantLinear)
        for f in ("group_size", "packed", "zero_point", "sb"):
            assert getattr(pw, f) == getattr(jw, f), f
        for f in ("q", "s", "b", "d", "dm"):
            ja, pa = getattr(jw, f), getattr(pw, f)
            assert (ja is None) == (pa is None), f
            if ja is not None:
                ja, pa = np.asarray(ja), pa.numpy()
                assert pa.dtype == ja.dtype and pa.shape == ja.shape, f
                np.testing.assert_array_equal(_bits(pa), _bits(ja), err_msg=f)


# -------------------------------------------------------------- layer_spec
def test_layer_spec_logits_match_jax(paths):
    j, p = load_pair(paths["llama3"], cache_dtype="float32", layer_spec="0:2,1:2")
    assert p.cfg.num_hidden_layers == j.cfg.num_hidden_layers == 3
    assert p.params["layers"][1] is p.params["layers"][2]
    assert len(p.engine.new_cache(1, 16).k) == 3
    ids = j.tokenizer.encode("Layer specs alias weights.")
    lj = np.asarray(j.forward_logits(np.array([ids]))[0])
    lp = p.forward_logits(np.array([ids]))[0].numpy()
    np.testing.assert_allclose(lp, lj, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("spec", ["0:2,1:2", "all", "1,0", "0:5", "7", "x:2", "1:2:3", ""])
def test_parse_layer_spec_matches_jax(spec):
    from chatllm_tpu.models.base import parse_layer_spec as jparse
    from chatllm_tpu_torch.models.base import parse_layer_spec as tparse

    def run(f):
        try:
            return f(spec, 2)
        except Exception as e:          # noqa: BLE001 - the error is the result
            return type(e), str(e)
    assert run(tparse) == run(jparse)
