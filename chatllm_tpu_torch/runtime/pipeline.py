"""Pipeline: model + tokenizer orchestration for multi-round chat
(counterpart of the JAX package's `runtime/pipeline.py` with the Restart
context-extending method, text completion and `abort_generation`; Shift and
sessions come later).
"""
from __future__ import annotations

from typing import Optional

from .chat import ChatTokenizer, Messages, MsgRole
from .generate import GenerationConfig
from .streamer import BaseStreamer


class Pipeline:
    def __init__(self, model):
        self.model = model
        self.tokenizer: ChatTokenizer = model.tokenizer
        self.history = Messages()
        self.gen_config = GenerationConfig()
        self._cache = None
        self.n_past = 0
        self.aborted = False
        self.perf = model.perf

    def abort_generation(self):
        """Stop the running generation after its current decode block."""
        self.aborted = True

    def _gen(self, ids, streamer: Optional[BaseStreamer], gen_config):
        self.aborted = False
        eng = self.model.engine
        max_len = eng.max_length

        def on_token(t):
            if streamer is not None:
                streamer.put([t])

        if self._cache is None:
            self._cache = eng.new_cache(1, max_len)
        out, self._cache, self.n_past = eng.generate(
            ids, gen_config,
            is_terminator=self.tokenizer.is_terminate_token,
            on_token=on_token,
            perf=self.perf,
            cache=self._cache,
            n_past=self.n_past,
            should_stop=lambda: self.aborted,
            terminate_seq=getattr(self.tokenizer, "terminate_seq", None),
        )
        return out

    def chat(self, user_input: str, streamer: Optional[BaseStreamer] = None,
             gen_config: Optional[GenerationConfig] = None) -> str:
        """One chat round: appends the user message, generates, appends the
        AI reply to history.  Returns the reply text."""
        self.history.push_back(MsgRole.USER, user_input)
        if streamer is not None:
            streamer.tokenizer = self.tokenizer
        gen_config = gen_config or self.gen_config
        ids = self.tokenizer.encode_history(self.history, self.model.cfg.max_length,
                                            incremental=True)
        if not self._needed_budget(ids):
            # chatllm.cpp src/chat.cpp:1810: if the context would overflow,
            # re-encode a truncated history from scratch
            self.restart()
            ids = self.tokenizer.encode_history(self.history, self.model.cfg.max_length,
                                                incremental=False)
        text = self.tokenizer.decode(self._gen(ids, streamer, gen_config))
        self.history.push_back(MsgRole.ASSISTANT, text)
        if streamer is not None:
            streamer.end()
        return text

    def text_completion(self, prompt: str, streamer: Optional[BaseStreamer] = None,
                        gen_config: Optional[GenerationConfig] = None) -> str:
        """Continue `prompt` as raw text (no chat template)."""
        if streamer is not None:
            streamer.tokenizer = self.tokenizer
        out = self._gen(self.tokenizer.encode(prompt), streamer,
                        gen_config or self.gen_config)
        if streamer is not None:
            streamer.end()
        return self.tokenizer.decode(out)

    def _needed_budget(self, ids) -> bool:
        return self.n_past + len(ids) + 4 < self.model.engine.max_length

    def restart(self):
        """Return to the start of the context (chatllm_restart semantics;
        this slice has no pre-evaluated system prompt to keep)."""
        self.n_past = 0
        self.history.cursor = 0

    def show_statistics(self) -> str:
        return self.perf.summary()
