"""The port's HTTP server against the JAX package's, both loading the same
narrow Llama-3 GGMM (f32): the routes answer, greedy replies are
byte-identical to the JAX server's, and concurrent chats on a 4-slot port
server equal its single-slot replies (pattern: tests/test_server.py,
tests/test_server_batched.py)."""
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import pytest
import torch

import conftest  # noqa: F401

import chip_smoke
import chatllm_tpu.models as jm
import chatllm_tpu_torch.models as tm
from chatllm_tpu.ggmm.quants import GGMLType
from chatllm_tpu.runtime.generate import GenerationConfig as JGen
from chatllm_tpu.serve import server as jserver
from chatllm_tpu_torch.runtime.generate import GenerationConfig as TGen
from chatllm_tpu_torch.serve import server as tserver

RT32 = dict(compute_dtype="float32", cache_dtype="float32")


def _start(api, module):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), module._make_handler(api))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_port}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    path = str(chip_smoke.write_llama3_ggmm(tmp_path_factory.mktemp("srv") / "m.bin",
                                            dtype=GGMLType.F32, seed=5))
    jmodel = jm.load_model(path, jm.RuntimeConfig(**RT32))
    tmodel = tm.load_model(path, tm.RuntimeConfig(**RT32), device="cpu")
    apis = {"jax": jserver.ApiServer(jmodel, model_name="tiny",
                                     gen_config=JGen(do_sample=False, max_new_tokens=8))}
    for name, slots in (("port", 1), ("port4", 4)):
        apis[name] = tserver.ApiServer(tmodel, model_name="tiny", max_slots=slots,
                                       gen_config=TGen(do_sample=False, max_new_tokens=8),
                                       device="cpu")
    started = {name: _start(api, jserver if name == "jax" else tserver)
               for name, api in apis.items()}
    yield {name: url for name, (_, url) in started.items()}, apis
    for httpd, _ in started.values():
        httpd.shutdown()
    apis["port4"].batch.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _post(url, obj):
    req = urllib.request.Request(url, json.dumps(obj).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def _chat(url, text, **extra):
    out = json.loads(_post(url + "/v1/chat/completions",
                           {"messages": [{"role": "user", "content": text}], **extra}))
    return out["choices"][0]["message"]["content"]


def _sse_text(raw: bytes, key: str) -> str:
    parts = []
    for line in raw.decode().splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            choice = json.loads(line[6:])["choices"][0]
            parts.append(choice["delta"].get("content", "") if key == "delta"
                         else choice["text"])
    return "".join(parts)


def test_info_routes(servers):
    urls, _ = servers
    for name in ("port", "port4"):
        url = urls[name]
        assert _get(url + "/v1/models")["data"][0]["id"] == "tiny"
        assert _get(url + "/health")["status"] == "ok"
        assert _get(url + "/api/version")["version"].endswith("chatllm_tpu_torch")
        assert _get(url + "/api/tags")["models"][0]["name"] == "tiny"
        assert _get(url + "/api/ps") == {"models": []}
        assert _get(url + "/props")["default_generation_settings"]["n_ctx"] == 512
        assert "endpoints" in _get(url + "/about")
    assert _get(urls["port4"] + "/props")["total_slots"] == 4
    assert len(_get(urls["port4"] + "/slots")) == 4
    assert _get(urls["port"] + "/slots") == [{"id": 0, "state": 0}]
    with urllib.request.urlopen(urls["port"] + "/", timeout=60) as r:
        assert r.headers.get("Content-Type", "").startswith("text/html")
        body = r.read().decode()
    assert "<!DOCTYPE html>" in body and "/v1/chat/completions" in body


PROMPTS = ["hi", "Tell me a story about a fox.", "中文 résumé"]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_chat_matches_jax_server(servers, prompt):
    urls, _ = servers
    ref = _chat(urls["jax"], prompt)
    assert _chat(urls["port"], prompt) == ref
    assert _chat(urls["port4"], prompt) == ref
    raw = _post(urls["port4"] + "/v1/chat/completions",
                {"messages": [{"role": "user", "content": prompt}], "stream": True})
    assert raw.decode().rstrip().endswith("data: [DONE]")
    assert _sse_text(raw, "delta") == ref


def test_completion_routes_match_jax_server(servers):
    urls, _ = servers
    body = {"prompt": "Once upon a time"}
    ref = json.loads(_post(urls["jax"] + "/v1/completions", body))["choices"][0]["text"]
    for name in ("port", "port4"):
        out = json.loads(_post(urls[name] + "/v1/completions", body))
        assert out["object"] == "text_completion" and out["choices"][0]["text"] == ref
        raw = _post(urls[name] + "/v1/completions", dict(body, stream=True))
        assert _sse_text(raw, "text") == ref
    msgs = {"messages": [{"role": "user", "content": "hi"}]}
    jchat = json.loads(_post(urls["jax"] + "/api/chat", msgs))["message"]["content"]
    jgen = json.loads(_post(urls["jax"] + "/api/generate", body))["response"]
    for name in ("port", "port4"):
        out = json.loads(_post(urls[name] + "/api/chat", msgs))
        assert out["done"] is True and out["message"]["content"] == jchat
        assert json.loads(_post(urls[name] + "/api/generate", body))["response"] == jgen


def test_infill_without_fim_tokens_is_a_client_error(servers):
    """The byte-level vocab has no FIM tokens: a 400, as from the JAX
    server; with an empty suffix /infill is a plain completion."""
    urls, _ = servers
    for name in ("jax", "port4"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(urls[name] + "/infill", {"input_prefix": "a", "input_suffix": "b"})
        assert e.value.code == 400
    ref = json.loads(_post(urls["jax"] + "/infill", {"input_prefix": "abc"}))["content"]
    assert json.loads(_post(urls["port4"] + "/infill", {"input_prefix": "abc"}))["content"] == ref


def test_unported_routes_fail_as_in_jax(servers):
    """/v1/embeddings and /v1/rerank without such a model: the JAX server's
    500; a media content part to a text-only model: the JAX server's 400
    (images reach models with a `chat_image`, tests/test_torch_internvl.py)."""
    urls, _ = servers
    part = {"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}}
    for route, body in (("/v1/embeddings", {"input": "x"}),
                        ("/v1/rerank", {"query": "q", "documents": ["a"]}),
                        ("/v1/chat/completions",
                         {"messages": [{"role": "user", "content": [part]}]})):
        codes = []
        for name in ("jax", "port", "port4"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(urls[name] + route, body)
            codes.append((e.value.code, json.loads(e.value.read())["error"]["message"]))
        assert codes[0] == codes[1] == codes[2], codes


def test_concurrent_chats_match_single_slot(servers):
    urls, _ = servers
    prompts = [f"tale number {i} about a fox" for i in range(6)]
    expect = [_chat(urls["port"], p) for p in prompts]
    got, errs = [None] * len(prompts), []

    def worker(i):
        try:
            got[i] = _chat(urls["port4"], prompts[i])
        except Exception as e:          # pragma: no cover
            errs.append((i, e))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not errs and got == expect


def test_sections_and_device(servers):
    _, apis = servers
    secs, srv = tserver.split_model_sections(
        ["--port", "9", "--device", "cpu", "---chat", "-m", "a.bin", "---fim", "-m", "b.bin"])
    assert srv == ["--port", "9", "--device", "cpu"]
    assert secs == {"chat": ["-m", "a.bin"], "fim": ["-m", "b.bin"]}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserver.ApiServer(apis["port"].model)
