"""The port's InternVL chain against the JAX package on the CPU, on tiny
INTERN_VL GGMMs written with the JAX package's writer
(`chip_smoke.write_internvl_ggmm`: a 2-layer Qwen3 of hidden 256 behind a
2-layer InternViT of hidden 64, patch 14, 56-pixel tiles; f32 or q4_k LLM
weights, f16 tower linears):

  - the tower's parameters load bit-exact;
  - `patch_embed`, `vit_forward` and `encode_images` within 1e-5 of the
    output scale (f32 weights and activations); `pixel_shuffle` exact on a
    non-square grid of distinct values, where a transposed grid gives the
    same shape and other tokens;
  - `prefill_embeds` equal to `prefill` on the same tokens' embeddings,
    within 1e-5 of the JAX function's logits (also fed in chunks when the
    prompt is longer than the room left), and its unported arguments raise;
  - `chat_image`'s greedy tokens identical to the JAX package's (f32; q4_k
    with bf16 activations over a q8 cache), also for a second image on the
    same model;
  - the CLI's `{{image:...}}` transcript byte-identical to the JAX CLI's, a
    video tag exits naming its module;
  - an OpenAI `image_url` request with a data URI returns chat_image's reply
    through the port's server; an http URL is refused."""
import base64
import contextlib
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

import conftest  # noqa: F401
import torch_one_thread  # noqa: F401  (one intra-op thread: see its docstring)

import jax.numpy as jnp

import chip_smoke
import chatllm_tpu.main as jmain
import chatllm_tpu.models as jm
import chatllm_tpu.nn.vit as jvit
import chatllm_tpu_torch.main as tmain
import chatllm_tpu_torch.models as tm
import chatllm_tpu_torch.nn.vit as tvit
from chatllm_tpu.ggmm.quants import GGMLType
from chatllm_tpu.ggmm.writer import GGMMWriter
from chatllm_tpu.runtime.generate import GenerationConfig as JGen
from chatllm_tpu_torch.runtime.generate import GenerationConfig as TGen

QUESTION = "What is in this picture?"
NEW = 8


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ivl")
    out = {"f32": str(chip_smoke.write_internvl_ggmm(d / "f32.bin", dtype=GGMLType.F32,
                                                     writer_cls=GGMMWriter, seed=1)),
           "q4k": str(chip_smoke.write_internvl_ggmm(d / "q4k.bin", writer_cls=GGMMWriter,
                                                     seed=2))}
    for i in range(2):       # two images of one size: the JAX side compiles once
        path = d / f"img{i}.png"
        Image.fromarray(chip_smoke.ivl_image(i, (90, 120))).save(path)
        out[f"img{i}"] = str(path)
    return out


_PAIRS: dict = {}

RTS = {"f32": ("f32", dict(compute_dtype="float32", cache_dtype="float32")),
       "q4k-bf16": ("q4k", dict(compute_dtype="bfloat16", cache_dtype="bfloat16")),
       "q4k-q8": ("q4k", dict(compute_dtype="bfloat16", cache_dtype="int8"))}


def pair(files, name):
    """The same file in both packages, loaded once per module."""
    if name not in _PAIRS:
        f, rt = RTS[name]
        _PAIRS[name] = (jm.load_model(files[f], jm.RuntimeConfig(**rt)),
                        tm.load_model(files[f], tm.RuntimeConfig(**rt), device="cpu"))
    return _PAIRS[name]


def _close(got: torch.Tensor, want, tol: float):
    g, w = got.detach().float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape and np.isfinite(g).all()
    assert np.abs(g - w).max() <= tol * np.abs(w).max()


def _tiles(n=3, size=56, seed=0):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def test_tower_weights_bit_exact(files):
    j, t = pair(files, "f32")
    tc = dataclasses.asdict(t.vis_cfg)
    assert tc == {f: getattr(j.vis_cfg, f) for f in tc} and not j.vis_cfg.qk_norm
    assert (t.downsample_ratio, t.use_thumbnail, t.image_mean, t.image_std) == \
        (j.downsample_ratio, j.use_thumbnail, list(j.image_mean), list(j.image_std))
    assert t.image_token_count() == j.image_token_count() == 4

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}.{k}")
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}.{i}")
        elif hasattr(tree, "w"):
            yield f"{prefix}.w", tree.w
            yield f"{prefix}.bias", tree.bias
        else:
            yield prefix, tree

    jl, tl = dict(leaves(j.vis_params)), dict(leaves(t.vis_params))
    assert jl.keys() == tl.keys()
    for k in jl:
        assert np.array_equal(np.asarray(jnp.asarray(jl[k], jnp.float32)), tl[k].float().numpy()), k


def test_patch_embed_and_tower_match_jax(files):
    j, t = pair(files, "f32")
    x = _tiles()
    _close(tvit.patch_embed(t.vis_cfg, t.vis_params["embed"], torch.from_numpy(x)),
           jvit.patch_embed(j.vis_cfg, j.vis_params["embed"], jnp.asarray(x)), 1e-5)
    _close(tvit.vit_forward(t.vis_cfg, t.vis_params, torch.from_numpy(x)),
           jvit.vit_forward(j.vis_cfg, j.vis_params, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("name", ["f32", "q4k-bf16"])
def test_encode_images_matches_jax(files, name):
    j, t = pair(files, name)
    x = _tiles(seed=1)
    _close(t.encode_images(x), j.encode_images(x), 1e-5 if name == "f32" else 1e-2)


@pytest.mark.parametrize("gh,gw", [(4, 6), (6, 4), (2, 2)])
def test_pixel_shuffle_exact(gh, gw):
    H = 3
    x = np.arange(2 * gh * gw * H, dtype=np.float32).reshape(2, gh * gw, H)
    got = tvit.pixel_shuffle(torch.from_numpy(x), gh, gw, 0.5).numpy()
    want = np.asarray(jvit.pixel_shuffle(jnp.asarray(x), gh, gw, 0.5))
    assert got.shape == want.shape == (2, gh * gw // 4, 4 * H)
    assert np.array_equal(got, want)
    if gh != gw:     # the transposed grid: same shape, other tokens
        other = tvit.pixel_shuffle(torch.from_numpy(x), gw, gh, 0.5).numpy()
        assert other.shape == want.shape and not np.array_equal(other, want)


def _embeds(model, ids):
    return model.params["embed"][torch.as_tensor(ids)][None]


def test_prefill_embeds_equals_prefill_and_jax(files):
    j, t = pair(files, "f32")
    ids = np.random.default_rng(3).integers(0, 380, 37).tolist()
    eng = t.engine
    a, _, na = eng.prefill(ids, eng.new_cache(1, 256), 0)
    b, _, nb = eng.prefill_embeds(_embeds(t, ids), eng.new_cache(1, 256), 0)
    assert na == nb == len(ids) and torch.equal(a, b)
    je = j.engine
    want, _, nj = je.prefill_embeds(jnp.asarray(_embeds(t, ids).numpy()), je.new_cache(1, 256), 0)
    assert nj == len(ids)
    _close(b, want, 1e-5)


def test_prefill_embeds_in_chunks_matches_jax(files):
    """A prompt longer than the room left is fed in chunks of that room."""
    j, t = pair(files, "f32")
    ids = np.random.default_rng(5).integers(0, 380, 50).tolist()
    e = _embeds(t, ids)
    got, cache, n = t.engine.prefill_embeds(e[:, :20], t.engine.new_cache(1, 64), 0)
    got, _, n = t.engine.prefill_embeds(e[:, 20:], cache, n)
    je = j.engine
    want, jc, jn = je.prefill_embeds(jnp.asarray(e[:, :20].numpy()), je.new_cache(1, 64), 0)
    want, _, jn = je.prefill_embeds(jnp.asarray(e[:, 20:].numpy()), jc, jn)
    assert n == jn == 50
    _close(got, want, 1e-5)


@pytest.mark.parametrize("arg", ["positions", "extra_residuals", "ple_ids"])
def test_prefill_embeds_refuses_unported_arguments(files, arg):
    _, t = pair(files, "f32")
    e = _embeds(t, [1, 2, 3])
    with pytest.raises(NotImplementedError, match="not ported"):
        t.engine.prefill_embeds(e, t.engine.new_cache(1, 64), 0, **{arg: np.zeros(3)})


_JAX_REPLIES: dict = {}


@pytest.mark.parametrize("name", ["f32", "q4k-q8"])
def test_chat_image_tokens_match_jax(files, name):
    """Greedy replies to two images, one after the other on one model."""
    j, t = pair(files, name)
    for img in ("img0", "img1"):
        key = (name, img)
        if key not in _JAX_REPLIES:
            _JAX_REPLIES[key] = j.chat_image(files[img], QUESTION,
                                             JGen(do_sample=False, max_new_tokens=NEW))
        toks = chip_smoke._Tokens()
        got = t.chat_image(files[img], QUESTION, TGen(do_sample=False, max_new_tokens=NEW),
                           toks)
        assert got == _JAX_REPLIES[key] and t.tokenizer.decode(toks.ids) == got


def _run_cli(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(argv) == 0
    return buf.getvalue()


def test_cli_image_transcript_matches_jax(files, monkeypatch):
    """The JAX CLI's model gets the engine of the "f32" pair (the same file
    and options), whose compiled functions it reuses."""
    j, _ = pair(files, "f32")
    load = jm.load_model

    def shared(*args, **kw):
        model = load(*args, **kw)
        model._engine = j.engine
        return model

    monkeypatch.setattr(jm, "load_model", shared)
    argv = ["-m", files["f32"], "--multimedia_file_tags", "{{", "}}", "-p",
            f"Look: {{{{image:{files['img0']}}}}} {QUESTION}", "-t", "0",
            "--max_new_tokens", str(NEW), "--compute_dtype", "f32", "--cache_dtype", "f32"]
    want = _run_cli(jmain, argv)
    got = _run_cli(tmain, argv + ["--device", "cpu"])
    assert got == want and "A.I. > " in got


def test_cli_video_tag_exits_naming_its_module(files):
    with pytest.raises(SystemExit) as e:
        tmain.main(["-m", files["f32"], "--multimedia_file_tags", "{{", "}}", "-p",
                    "{{video:clip.mp4}} what happens?", "--device", "cpu"])
    assert "chat_video" in str(e.value) and "ROADMAP.md" in str(e.value)


def test_server_image_url_returns_chat_images_reply(files):
    from chatllm_tpu_torch.serve.server import ApiServer, _make_handler

    _, t = pair(files, "q4k-q8")
    g = TGen(do_sample=False, max_new_tokens=NEW)
    want = t.chat_image(files["img1"], QUESTION, g)
    api = ApiServer(t, model_name="tiny-internvl", max_slots=1, device="cpu", gen_config=g)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(api))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}/v1/chat/completions"

    def ask(ref):
        body = json.dumps({"messages": [{"role": "user", "content": [
            {"type": "text", "text": QUESTION},
            {"type": "image_url", "image_url": {"url": ref}}]}]}).encode()
        req = urllib.request.Request(url, body, {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())["choices"][0]["message"]["content"]

    try:
        with open(files["img1"], "rb") as f:
            uri = "data:image/png;base64," + base64.b64encode(f.read()).decode()
        assert ask(uri) == want
        with pytest.raises(urllib.error.HTTPError) as e:
            ask("http://localhost:1/x.png")
        assert e.value.code == 400 and b"not fetched" in e.value.read()
    finally:
        httpd.shutdown()
        httpd.server_close()
