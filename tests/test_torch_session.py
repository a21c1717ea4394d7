"""Sessions cross between the packages: a session the port saves loads in the
JAX package and one the JAX package saves loads in the port, over f32, bf16
and q8 caches, with the same npz keys and meta, and the continuation's
greedy tokens are identical.  A bad magic and a model mismatch raise as in
the JAX package."""
import json

import numpy as np
import pytest

import conftest  # noqa: F401

from chatllm_tpu.runtime.generate import GenerationConfig as JGen
from chatllm_tpu.runtime.pipeline import ExtendingMethod as JExt, Pipeline as JPipe
from chatllm_tpu_torch.runtime.generate import GenerationConfig as TGen
from chatllm_tpu_torch.runtime.pipeline import (SESSION_MAGIC, ExtendingMethod as TExt,
                                                Pipeline as TPipe)
from test_torch_pipeline import CACHES, SYS, TURNS, load_pair, write

GEN = dict(do_sample=False, max_new_tokens=8)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("sess")
    return {k: write(k, d / f"{k}.bin") for k in ("llama3", "qwen2")}


def two_rounds(pipe, gen):
    """A Shift pipeline with its system prompt evaluated, after two rounds."""
    pipe.gen_config = gen
    pipe.tokenizer.sys_prompt = SYS
    pipe.eval_sys_prompt()
    return [pipe.chat(t) for t in TURNS[:2]]


def npz(path):
    with np.load(path, allow_pickle=False) as d:
        return json.loads(str(d["__meta__"])), {k: d[k] for k in d.files if k != "__meta__"}


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_session_crosses_packages(paths, tmp_path, cache, direction):
    j, p = load_pair(paths["llama3"], cache_dtype=CACHES[cache], max_length=256)
    jp, tp = JPipe(j, extending=JExt.SHIFT), TPipe(p, extending=TExt.SHIFT)
    assert two_rounds(tp, TGen(**GEN)) == two_rounds(jp, JGen(**GEN))
    jf, tf = str(tmp_path / "jax.session"), str(tmp_path / "port.session")
    jp.save_session(jf)
    tp.save_session(tf)
    (jm, ja), (tm_, ta) = npz(jf), npz(tf)
    assert tm_ == jm and sorted(ta) == sorted(ja)
    # the two packages' own prefills: f32 planes and scales within 1e-5, bf16
    # planes within 2^-7 of the plane's scale (a bf16 rounding that flips in
    # layer 0 moves layer 1's keys by more than an ulp), int8 planes one step
    for k in ja:
        assert ta[k].dtype == ja[k].dtype and ta[k].shape == ja[k].shape, k
        if cache == "bf16":
            np.testing.assert_allclose(ta[k], ja[k], rtol=2 ** -7,
                                       atol=2 ** -7 * np.abs(ja[k]).max(), err_msg=k)
        elif ta[k].dtype == np.int8:
            assert np.abs(ta[k].astype(np.int32) - ja[k]).max() <= 1, k
        else:
            np.testing.assert_allclose(ta[k], ja[k], rtol=1e-5, atol=1e-5, err_msg=k)
    # bf16 planes are stored as f32; int8 planes with both scale planes
    want = {"f32": np.float32, "bf16": np.float32, "q8": np.int8}[cache]
    assert ta["k0"].dtype == want and ("ks0" in ta and "vs0" in ta) == (cache == "q8")

    # the other package's file, loaded into a fresh pipeline of each
    src = tf if direction == "port_to_jax" else jf
    j2, p2 = load_pair(paths["llama3"], cache_dtype=CACHES[cache], max_length=256)
    jl, tl = JPipe(j2, extending=JExt.SHIFT), TPipe(p2, extending=TExt.SHIFT)
    jl.gen_config, tl.gen_config = JGen(**GEN), TGen(**GEN)
    jl.load_session(src)
    tl.load_session(src)
    assert (tl.n_past, tl.initial_n_past) == (jl.n_past, jl.initial_n_past) == \
        (tp.n_past, tp.initial_n_past)
    assert [(int(m.role), m.content, m.round) for m in tl.history.items] == \
        [(int(m.role), m.content, m.round) for m in jl.history.items]
    assert tl.tokenizer.chat_encoder.skip_sys_prompt
    # the loaded rows are the file's, bit for bit
    loaded = npz(src)[1]
    for i in range(len(tl._cache.k)):
        for name, plane in (("k", tl._cache.k[i]), ("v", tl._cache.v[i])):
            got = plane[:, :tl.n_past].float().numpy()
            np.testing.assert_array_equal(got, loaded[f"{name}{i}"].astype(np.float32))
        if cache == "q8":
            np.testing.assert_array_equal(tl._cache.k_scale[i][:, :tl.n_past].numpy(),
                                          loaded[f"ks{i}"])
            np.testing.assert_array_equal(tl._cache.v_scale[i][:, :tl.n_past].numpy(),
                                          loaded[f"vs{i}"])
    # the continuation: the same greedy tokens in the loaded pipelines and
    # in the uninterrupted ones (four more rounds, Shift firing on the way)
    rest = TURNS[2:]
    want = [(tp.chat(t), tp.n_past) for t in rest]
    assert [(tl.chat(t), tl.n_past) for t in rest] == want
    assert [(jl.chat(t), jl.n_past) for t in rest] == want


@pytest.mark.parametrize("cache", list(CACHES))
def test_session_save_load_round_trip(paths, tmp_path, cache):
    """The port alone (mirrors the JAX package's test): a loaded pipeline
    continues as the one that saved it."""
    _, p = load_pair(paths["llama3"], cache_dtype=CACHES[cache])
    pipe = TPipe(p)
    pipe.gen_config = TGen(do_sample=False, max_new_tokens=4)
    pipe.chat("hello")
    path = str(tmp_path / "sess.npz")
    pipe.save_session(path)
    pipe2 = TPipe(p)
    pipe2.load_session(path)
    assert pipe2.n_past == pipe.n_past and len(pipe2.history) == len(pipe.history)
    pipe.gen_config.seed = 7
    pipe2.gen_config = pipe.gen_config
    assert pipe.chat("more") == pipe2.chat("more")


def _raises(pipe, path):
    try:
        pipe.load_session(path)
    except Exception as e:               # noqa: BLE001 - the error is the result
        return type(e), str(e)
    return None


def test_bad_magic_raises_as_in_jax(paths, tmp_path):
    j, p = load_pair(paths["llama3"], cache_dtype="float32")
    pipe = TPipe(p)
    pipe.gen_config = TGen(**GEN)
    pipe.chat("hi")
    good = str(tmp_path / "good.session")
    pipe.save_session(good)
    meta, arrays = npz(good)
    bad = str(tmp_path / "bad.session")
    with open(bad, "wb") as f:
        np.savez(f, __meta__=json.dumps(dict(meta, magic="NOT-A-SESSION")), **arrays)
    got = _raises(TPipe(p), bad)
    assert got is not None and got[0] is AssertionError
    assert got == _raises(JPipe(j), bad)


def test_model_mismatch_raises_as_in_jax(paths, tmp_path):
    _, p = load_pair(paths["llama3"], cache_dtype="float32")
    jq, pq = load_pair(paths["qwen2"], cache_dtype="float32")
    pipe = TPipe(p)
    pipe.gen_config = TGen(**GEN)
    pipe.chat("hi")
    path = str(tmp_path / "llama.session")
    pipe.save_session(path)
    got = _raises(TPipe(pq), path)
    assert got is not None and got[0] is AssertionError and "mismatch" in got[1]
    assert got == _raises(JPipe(jq), path)


def test_npz_suffix_fallback(paths, tmp_path):
    """A session saved as `name.npz` loads from `name`, in both packages."""
    j, p = load_pair(paths["llama3"], cache_dtype="float32")
    pipe = TPipe(p)
    pipe.gen_config = TGen(**GEN)
    pipe.chat("hi")
    pipe.save_session(str(tmp_path / "s.npz"))
    for other in (TPipe(p), JPipe(j)):
        other.load_session(str(tmp_path / "s"))
        assert other.n_past == pipe.n_past
    assert json.loads(str(np.load(tmp_path / "s.npz")["__meta__"]))["magic"] == SESSION_MAGIC
