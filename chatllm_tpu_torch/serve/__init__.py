"""HTTP serving: OpenAI / Ollama / llama.cpp compatible API server
(counterpart of the JAX package's `serve/`).

Reference analog: bindings/server.nim (routes at server.nim:849-870) and
scripts/openai_api.py.
"""
from .server import ApiServer, serve

__all__ = ["ApiServer", "serve"]
