"""OpenAI/Ollama/llama.cpp-compatible HTTP server (stdlib http.server);
counterpart of the JAX package's `serve/server.py` with its text routes.

Routes (parity with chatllm.cpp bindings/server.nim:849-870):
  POST /v1/chat/completions    (stream + non-stream)
  POST /v1/completions         (prompt completion; FIM via `suffix` or a
                                fim-named model — reference
                                scripts/openai_api.py:188,510-531)
  POST /infill                 (llama.cpp FIM: input_prefix/input_suffix)
  POST /v1/embeddings
  GET  /v1/models
  GET  /props  /slots  /health (llama.cpp)
  GET  /api/tags /api/version /api/ps ; POST /api/show /api/chat /api/generate (ollama)

With `max_slots > 1` requests interleave through the continuous-batching
scheduler (runtime/batching.py); at 1 slot generation serializes behind a
lock like the reference's one-slot server.  Streaming uses SSE chunks in the
OpenAI format.  Multi-model serving (`---chat m1 ---emb m2 ---rerank m3`
sections, reference server.nim:849-866) via `python -m
chatllm_tpu_torch.serve.server`.  The server runs on the card unless it is
given `device="cpu"` (`--device cpu`).  Media content parts (images, audio,
video) are refused with a 400: multimodal input is not ported yet.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..runtime.chat import MsgRole
from ..runtime.generate import GenerationConfig
from ..runtime.pipeline import Pipeline


class _BadRequest(Exception):
    """Client error surfaced as an OpenAI-style 400 JSON body."""


# FIM special-token triples (prefix, suffix, middle), probed against the
# model vocab in order; composition is PSM: [pre] prefix [suf] suffix [mid]
# with the middle generated (llama.cpp /infill convention — the reference
# instead relies on the client composing these, scripts/openai_api.py:188)
_FIM_FAMILIES = (
    ("<|fim_prefix|>", "<|fim_suffix|>", "<|fim_middle|>"),  # qwen/starcoder2
    ("<fim_prefix>", "<fim_suffix>", "<fim_middle>"),        # starcoder
    ("<fim-prefix>", "<fim-suffix>", "<fim-middle>"),        # refact
    ("<|fim▁begin|>", "<|fim▁hole|>", "<|fim▁end|>"),        # deepseek-coder
    ("<PRE>", "<SUF>", "<MID>"),                              # codellama
)


class ApiServer:
    def __init__(self, model, *, model_name: str = "default",
                 emb_model=None, rerank_model=None, fim_model=None,
                 gen_config: GenerationConfig | None = None,
                 max_slots: int = 1, ui: str | None = None, device=None):
        from ..device import resolve_device

        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, server on {self.device}")
        self.model = model
        self.model_name = model_name
        self.ui = ui                    # --ui FILE override (server.nim:629)
        self.emb_model = emb_model
        self.rerank_model = rerank_model
        self.fim_model = fim_model
        self.fim_lock = threading.Lock()
        self.gen_config = gen_config or GenerationConfig()
        self.lock = threading.Lock()
        self.busy = False
        self.max_slots = max_slots
        self.batch = None
        if max_slots > 1:
            # continuous batching: N interleaved streams over one shared
            # batched KV cache (runtime/batching.py); requests no longer
            # serialize behind the lock
            from ..runtime.batching import BatchedEngine

            try:
                self.batch = BatchedEngine(
                    model.cfg, model.params, max_slots=max_slots,
                    scfg=self.gen_config.sampler_config(), device=self.device)
            except ValueError as e:
                # model outside BatchedEngine's scope -> serve single-slot
                # behind the lock
                print(f"[serve] continuous batching disabled: {e}")
                self.batch = None

    # ------------------------------------------------------------------
    def _fresh_pipeline(self) -> Pipeline:
        pipe = Pipeline(self.model)
        pipe.gen_config = self.gen_config
        return pipe

    def _apply_sampling(self, body: dict) -> GenerationConfig:
        import dataclasses

        g = dataclasses.replace(self.gen_config)
        if "temperature" in body:
            g.temperature = float(body["temperature"])
        if "top_p" in body:
            g.top_p = float(body["top_p"])
        if "top_k" in body:
            g.top_k = int(body["top_k"])
        if "max_tokens" in body:
            g.max_new_tokens = int(body["max_tokens"])
        if "max_completion_tokens" in body:
            g.max_new_tokens = int(body["max_completion_tokens"])
        if "seed" in body and body["seed"] is not None:
            g.seed = int(body["seed"])
        if "frequency_penalty" in body:
            g.frequency_penalty = float(body["frequency_penalty"])
        if "presence_penalty" in body:
            g.presence_penalty = float(body["presence_penalty"])
        return g

    def _encode_chat(self, messages: list[dict]) -> list[int]:
        """Encode an OpenAI-style message list with the model's template."""
        from ..runtime.chat import Messages

        tok = self.model.tokenizer
        hist = Messages()
        sys_prompt = None
        for m in messages:
            role = m.get("role", "user")
            content = m.get("content", "") or ""
            if isinstance(content, list):
                content = "".join(p.get("text", "") for p in content
                                  if isinstance(p, dict))
            if role == "system":
                sys_prompt = content
            elif role == "user":
                hist.push_back(MsgRole.USER, content)
            elif role == "assistant":
                hist.push_back(MsgRole.ASSISTANT, content)
            elif role == "tool":
                hist.push_back(MsgRole.TOOL, content)
        old_sys = tok.sys_prompt
        if sys_prompt is not None:
            tok.sys_prompt = sys_prompt
        try:
            return tok.encode_history(hist, self.model.cfg.max_length,
                                      ai_opening=True)
        finally:
            tok.sys_prompt = old_sys

    def _run_batched(self, ids: list[int], gen_config, on_chunk=None) -> str:
        tok = self.model.tokenizer
        h = self.batch.submit(
            ids, max_new=gen_config.max_new_tokens,
            is_terminator=tok.is_terminate_token,
            seed=gen_config.seed or 0)
        from ..runtime.streamer import CallbackStreamer

        parts: list[str] = []

        def collect(first, chunk):
            parts.append(chunk)
            if on_chunk is not None:
                on_chunk(chunk)

        streamer = CallbackStreamer(tok, on_chunk=collect)
        for t in h:
            streamer.put([t])
        streamer.end()
        return "".join(parts)

    # -- multimodal chat ------------------------------------------------
    @staticmethod
    def _extract_media(messages: list[dict]):
        """Pull image/audio/video refs out of OpenAI content-part arrays
        (reference bindings/server.nim:229 handles image_url parts) and
        ollama per-message base64 `images` lists.  Returns
        [(kind, ref), ...] in message order; refs are data: URIs, file://
        or bare base64."""
        media = []
        for m in messages:
            c = m.get("content")
            if isinstance(c, list):
                for p in c:
                    if not isinstance(p, dict):
                        continue
                    t = p.get("type", "")
                    if t == "image_url" or (t == "" and "image_url" in p):
                        u = p.get("image_url")
                        u = u.get("url", "") if isinstance(u, dict) else u
                        if u:
                            media.append(("image", u))
                    elif t in ("input_audio", "audio_url"):
                        u = p.get(t) or {}
                        u = (u.get("data") or u.get("url", "")
                             if isinstance(u, dict) else u)
                        if u:
                            media.append(("audio", u))
                    elif t == "video_url":
                        u = p.get("video_url")
                        u = u.get("url", "") if isinstance(u, dict) else u
                        if u:
                            media.append(("video", u))
            for b64 in m.get("images") or []:     # ollama /api/chat
                media.append(("image", b64))
        return media

    @staticmethod
    def _decode_media_ref(ref: str, kind: str) -> bytes:
        """A data: URI, a file:// path or bare base64 -> the media's bytes;
        http(s) URLs are not fetched."""
        import base64
        import binascii

        if ref.startswith("data:"):
            _head, sep, b64 = ref.partition(",")
            if not sep:
                raise _BadRequest("malformed data: URI")
            try:
                return base64.b64decode(b64)
            except (binascii.Error, ValueError) as e:
                raise _BadRequest(f"bad base64 in data URI: {e}")
        if ref.startswith("file://"):
            try:
                with open(ref[7:], "rb") as f:
                    return f.read()
            except OSError as e:
                raise _BadRequest(f"cannot read {ref}: {e}")
        if ref.startswith("http://") or ref.startswith("https://"):
            raise _BadRequest("remote media URLs are not fetched; send a data: URI, "
                              "file:// path, or base64")
        try:        # bare base64 (ollama images)
            return base64.b64decode(ref, validate=True)
        except (binascii.Error, ValueError):
            raise _BadRequest(f"unrecognized media reference for {kind}")

    def _media_chat(self, messages, media, gen_config, on_chunk=None) -> str:
        """Route a chat-with-media request through the model's one-shot
        multimodal path (chat_image; chat_audio / chat_video on models that
        have them): the newest media piece and the last user message's text."""
        import os
        import tempfile

        kind, ref = media[-1]
        fn_name = {"image": "chat_image", "audio": "chat_audio", "video": "chat_video"}[kind]
        fn = getattr(self.model, fn_name, None)
        if fn is None:
            raise _BadRequest(f"model cannot accept {kind} input")
        text = ""
        for m in reversed(messages):
            if m.get("role") == "user":
                c = m.get("content", "") or ""
                if isinstance(c, list):
                    c = "".join(p.get("text", "") for p in c if isinstance(p, dict))
                text = c
                break
        data = self._decode_media_ref(ref, kind)
        f = tempfile.NamedTemporaryFile(
            suffix={"image": ".png", "audio": ".wav", "video": ".mp4"}[kind], delete=False)
        f.write(data)
        f.close()
        streamer = None
        if on_chunk is not None:
            from ..runtime.streamer import CallbackStreamer

            streamer = CallbackStreamer(self.model.tokenizer,
                                        on_chunk=lambda first, c: on_chunk(c))
        try:
            with self.lock:
                return fn(f.name, text, gen_config, streamer)
        finally:
            try:
                os.unlink(f.name)
            except OSError:
                pass

    def chat(self, messages: list[dict], gen_config, on_chunk=None) -> str:
        """Run one chat request on a fresh pipeline (stateless server)."""
        media = self._extract_media(messages)
        if media:
            # media requests bypass the batched text engine: the tower's
            # embeddings need the single-slot one-shot path
            return self._media_chat(messages, media, gen_config, on_chunk)
        if self.batch is not None:
            return self._run_batched(self._encode_chat(messages), gen_config,
                                     on_chunk)
        with self.lock:
            self.busy = True
            try:
                pipe = self._fresh_pipeline()
                sys_prompt = None
                last_user = ""
                for m in messages:
                    role = m.get("role", "user")
                    content = m.get("content", "") or ""
                    if isinstance(content, list):  # OAI content-part arrays
                        content = "".join(p.get("text", "") for p in content
                                          if isinstance(p, dict))
                    if role == "system":
                        sys_prompt = content
                    elif role == "user":
                        last_user = content
                        if m is not messages[-1]:
                            pipe.history.push_back(MsgRole.USER, content)
                    elif role == "assistant":
                        pipe.history.push_back(MsgRole.ASSISTANT, content)
                    elif role == "tool":
                        pipe.history.push_back(MsgRole.TOOL, content)
                if sys_prompt is not None:
                    pipe.tokenizer.sys_prompt = sys_prompt
                streamer = None
                if on_chunk is not None:
                    from ..runtime.streamer import CallbackStreamer

                    streamer = CallbackStreamer(
                        pipe.tokenizer,
                        on_chunk=lambda first, c: on_chunk(c))
                return pipe.chat(last_user, streamer, gen_config)
            finally:
                self.busy = False

    def completion(self, prompt: str, gen_config, on_chunk=None) -> str:
        if self.batch is not None:
            return self._run_batched(self.model.tokenizer.encode(prompt),
                                     gen_config, on_chunk)
        with self.lock:
            self.busy = True
            try:
                pipe = self._fresh_pipeline()
                streamer = None
                if on_chunk is not None:
                    from ..runtime.streamer import CallbackStreamer

                    streamer = CallbackStreamer(
                        pipe.tokenizer, on_chunk=lambda first, c: on_chunk(c))
                return pipe.text_completion(prompt, streamer, gen_config)
            finally:
                self.busy = False

    # -- FIM (fill-in-the-middle) --------------------------------------
    @staticmethod
    def is_fim_name(model: str | None) -> bool:
        """Model-name FIM routing (reference scripts/openai_api.py:188:
        names starting or ending with 'fim' hit the ---fim section)."""
        return bool(model) and (model.startswith("fim") or model.endswith("fim"))

    def _fim_token_ids(self, model):
        """(pre, suf, mid) token ids, probed from the vocab; None when the
        model has no FIM tokens."""
        tp = model.tokenizer.tp

        def lookup(s):
            # piece_to_id returns the UNK id for misses — verify by
            # round-tripping the piece
            tid = tp.piece_to_id(s)
            if tid is None or tid < 0:
                return None
            try:
                return tid if tp.id_to_piece(tid) == s else None
            except Exception:
                return None

        for pre, suf, mid in _FIM_FAMILIES:
            ids = [lookup(s) for s in (pre, suf, mid)]
            if all(i is not None for i in ids):
                return tuple(ids)
        return None

    def fim_completion(self, prefix: str, suffix: str, gen_config,
                       on_chunk=None) -> str:
        """Complete between prefix and suffix.  With a ---fim model loaded,
        generation runs there (completion format, reference
        scripts/openai_api.py:531); otherwise the chat model is used.  An
        empty suffix degrades to plain completion."""
        model = self.fim_model or self.model
        if not suffix:
            if model is self.model:
                return self.completion(prefix, gen_config, on_chunk)
            ids = model.tokenizer.encode(prefix)
        else:
            toks = self._fim_token_ids(model)
            if toks is None:
                raise _BadRequest(
                    "model has no fill-in-middle tokens; send a pre-composed "
                    "FIM prompt without 'suffix' instead")
            pre_t, suf_t, mid_t = toks
            tok = model.tokenizer
            ids = ([pre_t] + tok.encode(prefix)
                   + [suf_t] + tok.encode(suffix) + [mid_t])
        return self._raw_completion(model, ids, gen_config, on_chunk)

    def _raw_completion(self, model, ids: list[int], gen_config,
                        on_chunk=None) -> str:
        """Generate from raw ids on `model` (no chat template)."""
        if model is self.model and self.batch is not None:
            return self._run_batched(ids, gen_config, on_chunk)
        lock = self.lock if model is self.model else self.fim_lock
        with lock:
            pipe = Pipeline(model)
            pipe.gen_config = gen_config
            streamer = None
            if on_chunk is not None:
                from ..runtime.streamer import CallbackStreamer

                streamer = CallbackStreamer(
                    model.tokenizer, on_chunk=lambda first, c: on_chunk(c))
            out = pipe._gen(ids, streamer, gen_config)
            if streamer is not None:
                streamer.end()
            return model.tokenizer.decode(out)

    def embed(self, texts: list[str]):
        model = self.emb_model or self.model
        if not hasattr(model, "embed"):
            raise AssertionError("no embedding model loaded")
        return [model.embed(t).tolist() for t in texts]

    def rerank(self, query: str, documents: list[str]):
        """Jina-style rerank scores (reference server.nim ---rerank model;
        qa_rank through the reranker head)."""
        model = self.rerank_model or self.model
        if not hasattr(model, "qa_rank"):
            raise AssertionError("no reranker model loaded")
        return [float(model.qa_rank(query, d)) for d in documents]


def _make_handler(api: ApiServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        # -- helpers -----------------------------------------------------
        def _json(self, obj, code=200):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            if n == 0:
                return {}
            try:
                return json.loads(self.rfile.read(n) or b"{}")
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                raise _BadRequest(f"invalid JSON body: {e}")

        def _sse_start(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

        def _sse(self, obj):
            data = b"data: " + json.dumps(obj).encode() + b"\n\n"
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

        def _sse_done(self):
            data = b"data: [DONE]\n\n"
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")

        # -- GET ---------------------------------------------------------
        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/v1/models":
                models = [{"id": api.model_name, "object": "model",
                           "created": int(time.time()),
                           "owned_by": "chatllm_tpu_torch"}]
                if api.fim_model is not None:
                    models.append({"id": "fim", "object": "model",
                                   "created": int(time.time()),
                                   "owned_by": "chatllm_tpu_torch"})
                self._json({"object": "list", "data": models})
            elif path == "/health":
                self._json({"status": "ok"})
            elif path == "/props":
                self._json({"total_slots": api.max_slots,
                            "default_generation_settings": {"n_ctx": api.model.cfg.max_length},
                            "model_path": api.model_name})
            elif path == "/slots":
                if api.batch is not None:
                    self._json(api.batch.active_slots())
                else:
                    self._json([{"id": 0, "state": 1 if api.busy else 0}])
            elif path == "/api/tags":
                self._json({"models": [{"name": api.model_name,
                                        "model": api.model_name,
                                        "size": 0, "digest": ""}]})
            elif path == "/api/version":
                self._json({"version": "0.1.0-chatllm_tpu_torch"})
            elif path == "/api/ps":
                self._json({"models": ([{"name": api.model_name}] if api.busy else [])})
            elif path in ("/", "/index.html"):
                # chat web UI (reference server.nim handle_index :622-632);
                # --ui FILE serves a custom page, .gz passed through encoded
                headers = [("Content-Type", "text/html; charset=utf-8")]
                if api.ui:
                    with open(api.ui, "rb") as f:
                        body = f.read()
                    if api.ui.endswith(".gz"):
                        headers.append(("Content-Encoding", "gzip"))
                else:
                    from .chat_ui import CHAT_UI_HTML

                    body = CHAT_UI_HTML.encode("utf-8")
                self.send_response(200)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/about":
                self._json({"service": "chatllm_tpu_torch", "endpoints": [
                    "/v1/chat/completions", "/v1/completions", "/v1/embeddings",
                    "/v1/models", "/api/chat", "/api/generate", "/health"]})
            else:
                self._json({"error": "not found"}, 404)

        # -- POST --------------------------------------------------------
        def do_POST(self):
            try:
                self._do_POST()
            except _BadRequest as e:
                self._json({"error": {"message": str(e), "type": "invalid_request_error"}}, 400)
            except BrokenPipeError:
                pass                       # client went away mid-stream
            except Exception as e:         # keep the worker thread alive
                import traceback

                traceback.print_exc()
                try:
                    self._json({"error": {"message": f"{type(e).__name__}: {e}",
                                          "type": "server_error"}}, 500)
                except Exception:
                    pass

        def _do_POST(self):
            path = self.path.split("?")[0]
            body = self._body()
            if path == "/v1/chat/completions":
                self._chat_completions(body)
            elif path == "/v1/completions":
                self._completions(body)
            elif path == "/v1/embeddings":
                inputs = body.get("input", [])
                if isinstance(inputs, str):
                    inputs = [inputs]
                embs = api.embed(inputs)
                self._json({"object": "list", "model": api.model_name,
                            "data": [{"object": "embedding", "index": i,
                                      "embedding": e} for i, e in enumerate(embs)],
                            "usage": {"prompt_tokens": 0, "total_tokens": 0}})
            elif path == "/v1/rerank":
                docs = body.get("documents", [])
                scores = api.rerank(body.get("query", ""), docs)
                order = sorted(range(len(docs)), key=lambda i: -scores[i])
                top_n = int(body.get("top_n", len(docs)))
                self._json({"model": api.model_name, "results": [
                    {"index": i, "relevance_score": scores[i],
                     "document": {"text": docs[i]}} for i in order[:top_n]]})
            elif path == "/api/chat":
                self._ollama_chat(body)
            elif path == "/api/generate":
                self._ollama_generate(body)
            elif path == "/infill":
                self._infill(body)
            elif path == "/api/show":
                self._json({"details": {"family": "chatllm_tpu_torch"},
                            "model_info": {"name": api.model_name}})
            else:
                self._json({"error": "not found"}, 404)

        def _chat_completions(self, body):
            msgs = body.get("messages")
            if not msgs or not isinstance(msgs, list):
                raise _BadRequest("'messages' must be a non-empty array")
            if api.is_fim_name(body.get("model")) and api.fim_model is not None:
                # FIM-named model in a chat request: the reference feeds the
                # aggregated trailing user text to the fim streamer in
                # completion format (scripts/openai_api.py:188,340-345)
                parts = []
                for m in reversed(msgs):
                    if m.get("role") != "user":
                        break
                    c = m.get("content", "") or ""
                    if isinstance(c, list):
                        c = "".join(p.get("text", "") for p in c
                                    if isinstance(p, dict))
                    parts.append(c)
                prompt = "".join(reversed(parts))
                body = dict(body, prompt=prompt)
                self._completions(body)
                return
            gen = api._apply_sampling(body)
            rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
            created = int(time.time())
            if body.get("stream"):
                self._sse_start()

                def on_chunk(text):
                    self._sse({"id": rid, "object": "chat.completion.chunk",
                               "created": created, "model": api.model_name,
                               "choices": [{"index": 0,
                                            "delta": {"content": text},
                                            "finish_reason": None}]})

                api.chat(body.get("messages", []), gen, on_chunk)
                self._sse({"id": rid, "object": "chat.completion.chunk",
                           "created": created, "model": api.model_name,
                           "choices": [{"index": 0, "delta": {},
                                        "finish_reason": "stop"}]})
                self._sse_done()
            else:
                text = api.chat(body.get("messages", []), gen)
                perf = api.model.perf
                self._json({"id": rid, "object": "chat.completion",
                            "created": created, "model": api.model_name,
                            "choices": [{"index": 0,
                                         "message": {"role": "assistant",
                                                     "content": text},
                                         "finish_reason": "stop"}],
                            "usage": {"prompt_tokens": perf.prompt_tokens,
                                      "completion_tokens": perf.gen_tokens,
                                      "total_tokens": perf.prompt_tokens + perf.gen_tokens}})

        def _completions(self, body):
            gen = api._apply_sampling(body)
            rid = f"cmpl-{uuid.uuid4().hex[:12]}"
            created = int(time.time())
            prompt = body.get("prompt", "")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
            suffix = body.get("suffix") or ""
            use_fim = (suffix
                       or (api.is_fim_name(body.get("model"))
                           and api.fim_model is not None))

            def run(on_chunk=None):
                if use_fim:
                    return api.fim_completion(prompt, suffix, gen, on_chunk)
                return api.completion(prompt, gen, on_chunk)

            if body.get("stream"):
                self._sse_start()

                def on_chunk(text):
                    self._sse({"id": rid, "object": "text_completion",
                               "created": created, "model": api.model_name,
                               "choices": [{"index": 0, "text": text,
                                            "finish_reason": None}]})

                run(on_chunk)
                self._sse_done()
            else:
                text = run()
                self._json({"id": rid, "object": "text_completion",
                            "created": created, "model": api.model_name,
                            "choices": [{"index": 0, "text": text,
                                         "finish_reason": "stop"}]})

        def _infill(self, body):
            """llama.cpp /infill: {input_prefix, input_suffix} -> content."""
            gen = api._apply_sampling(body)
            text = api.fim_completion(body.get("input_prefix", ""),
                                      body.get("input_suffix", ""), gen)
            self._json({"content": text, "stop": True,
                        "model": api.model_name})

        def _ollama_chat(self, body):
            gen = api._apply_sampling(body.get("options", {}))
            text = api.chat(body.get("messages", []), gen)
            self._json({"model": api.model_name,
                        "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ"),
                        "message": {"role": "assistant", "content": text},
                        "done": True})

        def _ollama_generate(self, body):
            gen = api._apply_sampling(body.get("options", {}))
            suffix = body.get("suffix") or ""
            if suffix or api.fim_model is not None:
                # the reference routes /generate to the fim streamer
                # (scripts/openai_api.py:344-345); ollama's suffix field is
                # its FIM form
                text = api.fim_completion(body.get("prompt", ""), suffix, gen)
            else:
                text = api.completion(body.get("prompt", ""), gen)
            self._json({"model": api.model_name,
                        "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ"),
                        "response": text, "done": True})

    return Handler


def serve(model, host: str = "127.0.0.1", port: int = 11434, **kw):
    api = ApiServer(model, **kw)
    httpd = ThreadingHTTPServer((host, port), _make_handler(api))
    print(f"chatllm_tpu_torch serving on http://{host}:{port}")
    httpd.serve_forever()


def split_model_sections(argv: list[str]) -> tuple[dict, list[str]]:
    """Split `---chat ... ---emb ... ---rerank ...` sections (reference
    server.nim multi-model syntax).  Args before the first `---` marker are
    server-level; each section's args configure that model's loader."""
    sections: dict[str, list[str]] = {}
    server_args: list[str] = []
    cur = None
    for a in argv:
        if a.startswith("---"):
            cur = a[3:]
            sections[cur] = []
        elif cur is None:
            server_args.append(a)
        else:
            sections[cur].append(a)
    return sections, server_args


def main(argv=None):
    import sys

    from ..models import RuntimeConfig, load_model

    argv = list(sys.argv[1:] if argv is None else argv)
    sections, server_args = split_model_sections(argv)

    host, port, slots, ui, device = "127.0.0.1", 11434, 1, None, None
    i = 0
    model_path = ""
    while i < len(server_args):
        a = server_args[i]
        if a == "--host":
            i += 1; host = server_args[i]
        elif a == "--port":
            i += 1; port = int(server_args[i])
        elif a in ("--slots", "--max_slots"):
            i += 1; slots = int(server_args[i])
        elif a == "--ui":
            i += 1; ui = server_args[i]
        elif a == "--device":
            i += 1; device = server_args[i]
        elif a == "-m":
            i += 1; model_path = server_args[i]
        i += 1

    def load_section(name):
        args = sections.get(name)
        if not args:
            return None
        path = args[args.index("-m") + 1] if "-m" in args else args[0]
        return load_model(path, RuntimeConfig(), device=device)

    chat = load_section("chat")
    if chat is None and model_path:
        chat = load_model(model_path, RuntimeConfig(), device=device)
    if chat is None:
        print("usage: python -m chatllm_tpu_torch.serve.server [-m model.bin] "
              "[--host H] [--port P] [--slots N] [--device cuda|cpu] "
              "[---chat -m m1.bin] [---fim -m m2.bin] [---emb -m m3.bin] "
              "[---rerank -m m4.bin]")
        return 1
    serve(chat, host=host, port=port, max_slots=slots, ui=ui, device=device,
          emb_model=load_section("emb"),
          rerank_model=load_section("rerank"),
          fim_model=load_section("fim"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
