"""Pipeline: model + tokenizer orchestration for multi-round chat
(counterpart of the JAX package's `runtime/pipeline.py`): the
context-extending methods (Restart / Shift / None), incremental history
encoding, AI continuation and prefix, reversed roles, the QA format,
system-prompt pre-evaluation, session save/load and abort.
"""
from __future__ import annotations

import enum
import io
import json
import os
from typing import Optional

import numpy as np
import torch

from .chat import ChatTokenizer, Messages, MsgRole
from .generate import GenerationConfig
from .streamer import BaseStreamer


class ExtendingMethod(enum.Enum):
    # chatllm.cpp src/chat.h:1418-1423
    RESTART = "restart"
    SHIFT = "shift"
    NONE = "none"


# the JAX package's session format: sessions cross between the packages
SESSION_MAGIC = "CHATLLM-TPU-SESSION-v1"


class Pipeline:
    def __init__(self, model, *, extending: ExtendingMethod = ExtendingMethod.RESTART):
        self.model = model
        self.tokenizer: ChatTokenizer = model.tokenizer
        self.extending = extending
        self.history = Messages()
        self.gen_config = GenerationConfig()
        self._cache = None
        self.n_past = 0
        self.initial_n_past = 0      # set after eval_sys_prompt / load_session
        self.aborted = False
        self.perf = model.perf
        self.ai_prefix = ""          # streamed before each reply and prefixed to it
        self.reversed_role = False   # the user plays the assistant
        self.qa_format = False       # each round encodes only the last user message
        self._inject_ai_prefix = False

    # ------------------------------------------------------------------ chat
    def abort_generation(self):
        """Stop the running generation after its current decode block."""
        self.aborted = True

    def _gen(self, ids, streamer: Optional[BaseStreamer], gen_config=None):
        gen_config = gen_config or self.gen_config
        self.aborted = False
        eng = self.model.engine
        prefix = self.ai_prefix if self._inject_ai_prefix else ""
        self._inject_ai_prefix = False
        if prefix:
            # seed the AI turn with the prefix tokens and stream them like
            # generated text (chatllm.cpp src/chat.cpp:1970)
            pids = list(self.tokenizer.encode(prefix))
            ids = list(ids) + pids
            if streamer is not None:
                streamer.tokenizer = self.tokenizer
                streamer.put(pids)

        def on_token(t):
            if streamer is not None:
                streamer.put([t])

        if self._cache is None:
            self._cache = eng.new_cache(1, eng.max_length)
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
        AI reply to history.  Returns the reply text.

        With `reversed_role` the roles swap: the incoming text is recorded
        as the ASSISTANT turn and the model generates the USER side."""
        rev = self.reversed_role
        if self.qa_format and len(self.history) > 0:
            # QA format (chatllm.cpp ChatFormat::QA): every round stands alone
            self.history.clear()
            self.restart(keep_sys_prompt=False)
        self.history.push_back(MsgRole.ASSISTANT if rev else MsgRole.USER, user_input)
        if streamer is not None:
            streamer.tokenizer = self.tokenizer
        gen_config = gen_config or self.gen_config
        self._inject_ai_prefix = True

        if self.extending == ExtendingMethod.NONE:
            out_ids = self._chat_without_extending(streamer, gen_config)
        elif self.extending == ExtendingMethod.SHIFT:
            out_ids = self._chat_with_shift(streamer, gen_config)
        else:
            out_ids = self._chat_with_restart(streamer, gen_config)

        text = self.tokenizer.decode(out_ids)
        prefix = self.ai_prefix
        if prefix:
            # the AI reply was seeded with this text (injected in _gen)
            text = prefix + text
        self.history.push_back(MsgRole.USER if rev else MsgRole.ASSISTANT, text)
        if streamer is not None:
            streamer.end()
        return text

    def _needed_budget(self, ids) -> bool:
        return self.n_past + len(ids) + 4 < self.model.engine.max_length

    def _encode(self, incremental: bool):
        return self.tokenizer.encode_history(self.history, self.model.cfg.max_length,
                                             incremental=incremental,
                                             reversed_role=self.reversed_role)

    def _chat_with_restart(self, streamer, gen_config):
        # chatllm.cpp src/chat.cpp:1810: if the context would overflow,
        # re-encode a truncated history after the system prompt
        ids = self._encode(incremental=True)
        if not self._needed_budget(ids):
            self.restart(keep_sys_prompt=True)
            ids = self._encode(incremental=False)
        return self._gen(ids, streamer, gen_config)

    def _chat_with_shift(self, streamer, gen_config):
        # chatllm.cpp src/chat.cpp:1870: drop half the context after the
        # system prompt until the round fits
        ids = self._encode(incremental=True)
        eng = self.model.engine
        while not self._needed_budget(ids):
            keep = self.initial_n_past
            shift = (self.n_past - keep) // 2
            if shift <= 0:
                break
            self._cache = eng.shift_cache(self._cache, shift, keep, self.n_past)
            self.n_past -= shift
        return self._gen(ids, streamer, gen_config)

    def _chat_without_extending(self, streamer, gen_config):
        return self._gen(self._encode(incremental=True), streamer, gen_config)

    def chat_continue(self, streamer: Optional[BaseStreamer] = None,
                      gen_config: Optional[GenerationConfig] = None) -> str:
        """Continue the last AI message (chatllm.cpp src/chat.cpp:2008)."""
        assert len(self.history) > 0 and \
            self.history[len(self.history) - 1].role == MsgRole.ASSISTANT
        if streamer is not None:
            streamer.tokenizer = self.tokenizer
        last = self.history.items[-1]
        out = self._gen(self.tokenizer.encode(last.content), streamer, gen_config)
        text = self.tokenizer.decode(out)
        last.content += text
        if streamer is not None:
            streamer.end()
        return text

    def eval_sys_prompt(self, gen_config: Optional[GenerationConfig] = None):
        """Prefill the system prompt once so later rounds reuse it
        (chatllm.cpp src/chat.cpp:1904)."""
        ids = self.tokenizer.encode_sys_prompt()
        if not ids:
            return
        eng = self.model.engine
        if self._cache is None:
            self._cache = eng.new_cache(1, eng.max_length)
        _, self._cache, self.n_past = eng.prefill(ids, self._cache, self.n_past)
        self.initial_n_past = self.n_past
        self.tokenizer.chat_encoder.skip_sys_prompt = True

    def restart(self, keep_sys_prompt: bool = True):
        """Return to the initial point (chatllm_restart semantics,
        chatllm.cpp bindings/libchatllm.h:144-156)."""
        self.n_past = self.initial_n_past if keep_sys_prompt else 0
        if not keep_sys_prompt:
            self.initial_n_past = 0
            if self.tokenizer.chat_encoder:
                self.tokenizer.chat_encoder.skip_sys_prompt = False
        self.history.cursor = 0

    def rewind(self, n_msgs: int = 1):
        for _ in range(n_msgs):
            self.history.pop()

    # -------------------------------------------------------------- sessions
    def save_session(self, path: str):
        """History, n_past and the cache's first n_past rows, as an npz
        written to the exact path (the JAX package's format: bf16 planes
        stored as f32, int8 planes and their f32 scales as they are)."""
        meta = {
            "magic": SESSION_MAGIC,
            "model_type": int(self.model.model_type),
            "n_past": self.n_past,
            "initial_n_past": self.initial_n_past,
            "history": [{"role": int(m.role), "content": m.content, "round": m.round}
                        for m in self.history.items],
        }

        def host(x):             # one copy to the host per plane
            x = x[:, : self.n_past]
            if x.dtype not in (torch.float32, torch.int8):
                x = x.float()
            return x.cpu().numpy()

        arrays = {}
        c = self._cache
        if c is not None:
            for i, (k, v) in enumerate(zip(c.k, c.v)):
                arrays[f"k{i}"] = host(k)
                arrays[f"v{i}"] = host(v)
            if c.k_scale is not None:
                for i, (ks, vs) in enumerate(zip(c.k_scale, c.v_scale)):
                    arrays[f"ks{i}"] = host(ks)
                    arrays[f"vs{i}"] = host(vs)
        buf = io.BytesIO()
        np.savez(buf, __meta__=json.dumps(meta), **arrays)
        with open(path, "wb") as f:
            f.write(buf.getvalue())

    def load_session(self, path: str):
        """Restore a session saved by either package into a new cache."""
        if not os.path.isfile(path) and os.path.isfile(path + ".npz"):
            path = path + ".npz"   # sessions saved by np.savez's own naming
        data = np.load(path, allow_pickle=False)
        meta = json.loads(str(data["__meta__"]))
        if meta["magic"] != SESSION_MAGIC:
            raise AssertionError("bad session file")
        if meta["model_type"] != int(self.model.model_type):
            raise AssertionError("session/model mismatch")
        self.n_past = meta["n_past"]
        self.initial_n_past = meta["initial_n_past"]
        self.history.clear()
        for m in meta["history"]:
            msg = self.history.push_back(MsgRole(m["role"]), m["content"])
            msg.round = m["round"]
        self.history.move_cursor_to_end()
        eng = self.model.engine
        c = self._cache = eng.new_cache(1, eng.max_length)
        if "k0" in data:
            quant = c.k_scale is not None
            for i in range(len(c.k)):
                planes = [(c.k[i], "k"), (c.v[i], "v")]
                if quant and f"ks{i}" in data:
                    planes += [(c.k_scale[i], "ks"), (c.v_scale[i], "vs")]
                for dst, name in planes:
                    a = torch.from_numpy(data[f"{name}{i}"])
                    dst[:, : a.shape[1]].copy_(a.to(dst.dtype))
        if self.initial_n_past > 0 and self.tokenizer.chat_encoder:
            self.tokenizer.chat_encoder.skip_sys_prompt = True

    # ----------------------------------------------------------- other modes
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

    def show_statistics(self) -> str:
        return self.perf.summary()
