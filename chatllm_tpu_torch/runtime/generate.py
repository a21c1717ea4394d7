"""Generation loop: bucketed prefill + block decode over an in-place KV
cache (counterpart of the JAX package's `runtime/generate.py`).

  - Prompt chunks are right-padded to power-of-two buckets; attention masks
    by `n_past + n_tokens`, so padded positions never leak into real rows
    (the next write overwrites their cache slots), and the lm_head runs on
    the last real position only.
  - Decode runs in blocks of `decode_block` steps (forward, draw, penalty
    update, n_past += 1) on the device, with n_past a device tensor, and the
    host reads each block's tokens back once: on the card a block replays a
    CUDA graph, on the CPU it runs uncaptured (runtime/decode_graph.py).
    The bookkeeping is the JAX loop's: a block's steps past `max_new` or the
    context are speculative (their cache writes past the cache are dropped,
    the others are overwritten by the next block), terminators are checked
    on the host after each block, and `should_stop()` between blocks.
  - Sliding-window models keep their windowed layers in rings of window +
    SWA_EXTRA slots (nn/transformer.py) when that is shorter than the
    context: prefill chunks are then capped to SWA_EXTRA tokens, rings do not
    bound the room a prompt has (only full-attention layers do), and ring
    layers are read whole by every decode block.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..nn import transformer as tr
from ..nn.transformer import (KVCache, TransformerConfig, init_cache, is_ring,
                              transformer_forward)
from ..ops.attention import quantize_kv
from ..ops.rope import apply_rope, precompute_rope_cache, rope_mscale
from ..ops.sampling import SamplerConfig, penalty_accept, sample_token
from .decode_graph import BlockDecoder, kv_bucket


@dataclass
class GenerationConfig:
    """Mirrors the reference GenerationConfig (chatllm.cpp src/chat.h:875-919)."""
    max_length: int = -1            # total context; -1 = model max
    max_new_tokens: int = -1
    max_context_length: int = 4096
    do_sample: bool = True
    top_k: int = 20
    top_p: float = 0.7
    temperature: float = 0.7
    tfs_z: float = 0.95
    sampling: str = "top_p"
    repeat_penalty: float = 1.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    penalty_window: int = 256
    seed: int = 0
    batch_size: int = 4096          # prefill chunk (reference src/main.cpp:100)

    def sampler_config(self) -> SamplerConfig:
        return SamplerConfig(
            do_sample=self.do_sample, sampling=self.sampling if self.do_sample else "greedy",
            temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
            tfs_z=self.tfs_z, repeat_penalty=self.repeat_penalty,
            frequency_penalty=self.frequency_penalty,
            presence_penalty=self.presence_penalty,
            penalty_window=self.penalty_window,
        )


@dataclass
class PerfInfo:
    """ModelPerfInfo analog (chatllm.cpp src/chat.h:921-951)."""
    prompt_tokens: int = 0
    prompt_ms: float = 0.0
    gen_tokens: int = 0
    gen_ms: float = 0.0

    def summary(self) -> str:
        pt = self.prompt_tokens / self.prompt_ms * 1000 if self.prompt_ms else 0.0
        gt = self.gen_tokens / self.gen_ms * 1000 if self.gen_ms else 0.0
        return (f"prompt eval time: {self.prompt_ms:8.2f} ms / {self.prompt_tokens:5d} tokens ({pt:8.2f} tok/s)\n"
                f"       eval time: {self.gen_ms:8.2f} ms / {self.gen_tokens:5d} tokens ({gt:8.2f} tok/s)")


def _bucket(n: int, lo: int = 16, hi: int = 4096) -> int:
    b = lo
    while b < n and b < hi:
        b *= 2
    return b


def _fit_bucket(n: int, room: int, hi: int) -> int:
    """Largest bucket that holds `n` tokens without exceeding `room` cache
    slots.  Falls back to an exact-size pad when fewer than one minimum
    bucket of room remains near the context limit — padding past `room`
    would write past the cache."""
    tpad = _bucket(n, hi=hi)
    if tpad <= room:
        return tpad
    b = 16
    while b * 2 <= room:
        b *= 2
    return b if b <= room else room


def swa_chunk_cap(cfg: TransformerConfig, max_length: int) -> int:
    """The prefill chunk cap of a model with ring layers: SWA_EXTRA when a
    layer's window + SWA_EXTRA is shorter than `max_length` (its ring then
    wraps), else 0 (no cap).  A chunk of at most SWA_EXTRA tokens, bucket
    padding included, overwrites only keys that have left every window of
    its queries."""
    for i in range(cfg.num_hidden_layers):
        w = cfg.layer_spec(i).sliding_window
        if 0 < w and w + tr.SWA_EXTRA < max_length:
            return tr.SWA_EXTRA
    return 0


class _Emitter:
    """Streams accepted tokens while supporting multi-token terminator
    sequences: the last len(seq)-1 tokens are held back until they can no
    longer complete the terminator; on a match the sequence is removed
    from `out`."""

    def __init__(self, on_token, terminate_seq=None):
        self.on_token = on_token
        self.seq = list(terminate_seq) if terminate_seq else None
        self.hold = len(self.seq) - 1 if self.seq else 0
        self.emitted = 0

    def step(self, out: list) -> bool:
        """Called after appending a token.  Returns True when the terminator
        sequence completed (it is popped from `out`)."""
        if self.seq and len(out) >= len(self.seq) and out[-len(self.seq):] == self.seq:
            del out[-len(self.seq):]
            return True
        while self.emitted < len(out) - self.hold:
            if self.on_token:
                self.on_token(out[self.emitted])
            self.emitted += 1
        return False

    def flush(self, out: list):
        while self.emitted < len(out):
            if self.on_token:
                self.on_token(out[self.emitted])
            self.emitted += 1


class InferenceEngine:
    """Runs one model (parameters + static config) on one device.

    `cuda_graphs=False` runs the decode blocks uncaptured on the card too:
    the reference a replay is held against, not a fallback."""

    def __init__(self, cfg: TransformerConfig, params, *, max_length: int = -1,
                 decode_block: int = 16, device=None, cuda_graphs: bool = True):
        from ..device import resolve_device

        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.max_length = max_length if max_length > 0 else cfg.max_length
        self.decode_block = decode_block
        self.prefill_chunk = 4096       # the CLI's -Os sets 512
        self._chunk_cap = swa_chunk_cap(cfg, cfg.max_length)
        self.decoder = BlockDecoder(cfg, params, self.device, graphs=cuda_graphs)

    def new_cache(self, batch: int = 1, max_len: int | None = None) -> KVCache:
        return init_cache(self.cfg, batch, max_len or self.max_length, device=self.device)

    def _dense_slots(self, cache: KVCache) -> Optional[int]:
        """The smallest full-attention layer's slots, None when every layer is
        a ring."""
        sizes = [t.shape[1] for i, t in enumerate(cache.k)
                 if not is_ring(self.cfg, self.cfg.layer_spec(i), t.shape[1])]
        return min(sizes) if sizes else None

    def _write_capacity(self, cache: KVCache) -> int:
        """Positions a prompt may fill: the smallest full-attention layer's
        slots.  Rings wrap and do not bound it."""
        dense = self._dense_slots(cache)
        return self.max_length if dense is None else dense

    def decode_kv_len(self, cache: KVCache, end: int) -> Optional[int]:
        """The KV bucket of a decode block whose last step sees keys below
        `end` (runtime/decode_graph.py::kv_bucket over the full-attention
        layers); None when every layer is a ring, which is read whole."""
        dense = self._dense_slots(cache)
        return None if dense is None else kv_bucket(end, dense)

    def shift_cache(self, cache: KVCache, shift: int, keep: int, n_past: int) -> KVCache:
        """Context-extension Shift in place (`shift_cache` below); returns the
        same cache."""
        return shift_cache(self.cfg, cache, shift, keep, n_past=n_past)

    @torch.inference_mode()
    def prefill(self, ids, cache: KVCache, n_past: int, *, chunk: int | None = None):
        """Feed prompt ids ([T] or [B, T]) through the model in chunks.
        Returns (last-token logits [B, V] f32 on the device, cache, n_past).
        The chunk defaults to `prefill_chunk`: `generate` passes the
        config's batch_size, so only `Pipeline.eval_sys_prompt` reads it."""
        chunk = chunk or self.prefill_chunk
        if self._chunk_cap:
            chunk = min(chunk, self._chunk_cap)
        ids = np.atleast_2d(np.asarray(ids, dtype=np.int64))
        B, T = ids.shape
        cache_len = self._write_capacity(cache)
        if n_past + T > cache_len:
            # keep the most recent tokens that fit (callers normally truncate
            # upstream via encode_history; this is the last-resort guard)
            ids = ids[:, n_past + T - cache_len:]
            T = ids.shape[1]
        logits = None
        done = 0
        while done < T:
            n = min(chunk, T - done, cache_len - n_past)
            tpad = _fit_bucket(n, cache_len - n_past, hi=max(16, min(chunk, cache_len)))
            n = min(n, tpad)
            buf = np.zeros((B, tpad), np.int64)
            buf[:, :n] = ids[:, done:done + n]
            x = torch.from_numpy(buf).to(self.device)
            logits, cache = transformer_forward(self.cfg, self.params, x, cache, n_past,
                                                last_index=n - 1)
            logits = logits[:, 0, :]
            n_past += n
            done += n
        return logits, cache, n_past

    @torch.inference_mode()
    def prefill_embeds(self, embeds: torch.Tensor, cache: KVCache, n_past: int, *,
                       positions=None, extra_residuals=None, ple_ids=None):
        """Prefill from given input embeddings [1, T, H] (multimodal prompts
        with spliced media embeddings).  Returns (last-token logits [1, V]
        f32, cache, n_past).  A prompt longer than the room left (or than the
        ring chunk cap) is fed in chunks of that size; a chunk is zero-padded
        to its bucket and the lm_head runs on its last real row.  Explicit
        positions (M-RoPE), DeepStack residuals and per-layer-embedding ids
        belong to models not ported yet: they raise, naming them."""
        for arg, what in ((positions, "explicit positions (Qwen-VL's M-RoPE)"),
                          (extra_residuals, "extra_residuals (Qwen3-VL's DeepStack)"),
                          (ple_ids, "ple_ids (Gemma4's per-layer embeddings)")):
            if arg is not None:
                raise NotImplementedError(f"prefill_embeds: {what} are not ported to "
                                          "chatllm_tpu_torch yet (ROADMAP.md section 1, M17)")
        T = embeds.shape[1]
        room = max(1, self._write_capacity(cache) - n_past)
        cap = min(self._chunk_cap or T, room)
        if T > cap:
            logits, done = None, 0
            while done < T:
                n = min(cap, T - done)
                logits, cache, n_past = self.prefill_embeds(embeds[:, done:done + n], cache,
                                                            n_past)
                done += n
            return logits, cache, n_past
        tpad = _fit_bucket(T, room, hi=max(16, self.max_length))
        x = embeds.to(self.device)
        if tpad != T:
            x = torch.nn.functional.pad(x, (0, 0, 0, tpad - T))
        logits, cache = transformer_forward(self.cfg, self.params, None, cache, n_past,
                                            last_index=T - 1, input_embeds=x)
        return logits[:, 0, :], cache, n_past + T

    @torch.inference_mode()
    def generate(
        self,
        input_ids: list[int],
        gen_cfg: GenerationConfig,
        *,
        is_terminator: Callable[[int], bool] = lambda t: False,
        on_token: Optional[Callable[[int], None]] = None,
        perf: Optional[PerfInfo] = None,
        cache: Optional[KVCache] = None,
        n_past: int = 0,
        completion_limit: int = -1,
        should_stop: Callable[[], bool] = lambda: False,
        terminate_seq: Optional[list] = None,
    ):
        """Autoregressive generation.  Returns (generated ids, cache, n_past)."""
        scfg = gen_cfg.sampler_config()
        max_len = self.max_length if gen_cfg.max_length <= 0 else min(gen_cfg.max_length, self.max_length)
        max_new = completion_limit if completion_limit > 0 else (
            gen_cfg.max_new_tokens if gen_cfg.max_new_tokens > 0 else max_len)
        if cache is None:
            cache = self.new_cache(1, max_len)

        t0 = time.perf_counter()
        logits, cache, n_past = self.prefill(input_ids, cache, n_past, chunk=gen_cfg.batch_size)
        st, tok, first = self._first_token(logits, gen_cfg, scfg)
        if perf:                # `first` was read back: the prefill has ended
            perf.prompt_tokens += len(input_ids)
            perf.prompt_ms += (time.perf_counter() - t0) * 1000
        t1 = time.perf_counter()
        out, n_past = self._decode(st, tok, first, cache, n_past, scfg, max_new, max_len,
                                   is_terminator, on_token, should_stop, terminate_seq)
        if perf:
            perf.gen_tokens += len(out)
            perf.gen_ms += (time.perf_counter() - t1) * 1000
        return out, cache, n_past

    @torch.inference_mode()
    def generate_from_logits(self, logits, cache: KVCache, n_past: int,
                             gen_cfg: GenerationConfig, *,
                             is_terminator: Callable[[int], bool] = lambda t: False,
                             on_token: Optional[Callable[[int], None]] = None,
                             should_stop: Callable[[], bool] = lambda: False,
                             max_new: int = -1, terminate_seq: Optional[list] = None):
        """Continue decoding from given last-token logits [B, V] (after a
        prefill the caller ran).  Returns (generated ids, cache, n_past)."""
        scfg = gen_cfg.sampler_config()
        max_len = self.max_length if gen_cfg.max_length <= 0 else min(gen_cfg.max_length, self.max_length)
        if max_new <= 0:
            max_new = gen_cfg.max_new_tokens if gen_cfg.max_new_tokens > 0 else max_len
        st, tok, first = self._first_token(logits, gen_cfg, scfg)
        out, n_past = self._decode(st, tok, first, cache, n_past, scfg, max_new, max_len,
                                   is_terminator, on_token, should_stop, terminate_seq)
        return out, cache, n_past

    def _first_token(self, logits, gen_cfg: GenerationConfig, scfg: SamplerConfig):
        """The decode state for one row, and the first token drawn on the
        device from the prefill's logits, as a tensor and read back."""
        sampled = scfg.do_sample and scfg.sampling != "greedy"
        st = self.decoder.state(1, window=scfg.penalty_window if sampled else 0, sampled=sampled)
        gen = st.gens[0] if sampled else None
        if sampled:
            gen.manual_seed(gen_cfg.seed or 0)
            st.penalty.reset()
        tok, _ = sample_token(logits[0], scfg, gen, st.penalty)
        if st.penalty is not None:
            penalty_accept(st.penalty, tok)
        return st, tok, int(tok)

    def _decode(self, st, tok, first: int, cache: KVCache, n_past: int,
                scfg: SamplerConfig, max_new: int, max_len: int, is_terminator,
                on_token, should_stop, terminate_seq) -> tuple[list, int]:
        """Decode blocks after the first token (`tok` on the device, `first`
        on the host) until a terminator, `max_new` tokens, the context's end or
        `should_stop()`."""
        out: list[int] = []
        emit = _Emitter(on_token, terminate_seq)
        done = is_terminator(first)
        if not done:
            out.append(first)
            done = emit.step(out)
        block = max(1, min(self.decode_block, max_new))
        st.tok.copy_(tok.reshape(1, 1))
        st.n_past.fill_(n_past)
        while not done and len(out) < max_new and n_past + 1 < max_len and not should_stop():
            steps = min(block, max_new - len(out), max_len - 1 - n_past)
            toks = self.decoder.run(st, cache, scfg, block,
                                    self.decode_kv_len(cache, n_past + block))
            toks = toks[:, 0].cpu().tolist()            # one read-back per block
            for t in toks[:steps]:
                n_past += 1
                if is_terminator(t):
                    done = True
                    break
                out.append(t)
                if emit.step(out):
                    done = True
                    break
            # steps past `steps` were speculative: n_past counts only the
            # consumed ones, so the next block (or prefill) overwrites them
        emit.flush(out)
        return out, n_past


@torch.inference_mode()
def shift_cache(cfg: TransformerConfig, cache: KVCache, shift: int, keep: int,
                n_past: Optional[int] = None) -> KVCache:
    """Context-extension Shift, in place (the JAX package's
    `InferenceEngine.shift_cache`): rows below `keep` stay, row p >= keep
    takes row min(p + shift, S - 1), V moves verbatim and the moved keys of
    a rope layer are re-rotated by -shift positions (cos and sin divided by
    the attention mscale, which the stored keys already carry).  Over a q8
    cache the moved keys are dequantized in f32, rotated and requantized;
    the kept rows keep their scales.

    The result is written into the cache's own tensors (gather, then copy),
    so the decoder's CUDA graphs, keyed by the cache's storage, replay on it.
    Returns the same cache.

    A ring that has wrapped (`n_past` past its slots, or unknown) is refused:
    its slots no longer hold positions in order, and the JAX package's
    slot-by-slot move leaves the kept slots and the clamped tail holding the
    wrong positions (ROADMAP.md section 3, "Shift over a ring").  A ring that
    has not wrapped is shifted as a full-attention cache, as there.  Refused
    too: a model with layers on a second rope table (Gemma-3's local layers,
    `cfg.rope_local`), which the JAX package re-rotates with the first
    (ROADMAP.md section 3, "Shift over Gemma-3's local layers")."""
    for i, k in enumerate(cache.k):
        S = k.shape[1]
        if is_ring(cfg, cfg.layer_spec(i), S) and (n_past is None or n_past > S):
            raise NotImplementedError(
                f"Shift extending over a wrapped sliding-window ring (layer {i}: {S} slots, "
                f"n_past {n_past}): the slots no longer hold positions in order; use "
                "--extending restart or none")
    if cfg.rope_local is not None and any(cfg.layer_spec(i).local_rope
                                          for i in range(cfg.num_hidden_layers)):
        raise NotImplementedError(
            "Shift extending over Gemma-3's local layers: their keys carry the local rope "
            "table (cfg.rope_local), but the reference re-rotates every rope layer by "
            "cfg.rope, which leaves them at the wrong positions (ROADMAP.md section 3); "
            "use --extending restart or none")
    if cfg.mla is not None:
        raise NotImplementedError(
            "Shift extending over an MLA cache: the reference re-rotates the first "
            f"rot_dim ({cfg.rope.resolved_rot_dim()}) channels of a cached key, but an "
            f"MLA key row keeps its rope part (k_pe) in the last {cfg.mla.qk_rope_head_dim} "
            "channels; use --extending restart or none")
    quant = cache.k_scale is not None
    if cfg.rope is not None:
        # moved keys carry rope for their old position: rotate by -shift
        delta = torch.full((1, 1), -shift, dtype=torch.int64, device=cache.k[0].device)
        cos, sin = precompute_rope_cache(delta, cfg.rope)
        m = rope_mscale(cfg.rope)
        if m != 1.0:
            m = cos.new_full((), m)           # a true division, as on the CPU
            cos, sin = cos / m, sin / m
    for i in range(len(cache.k)):
        k, v = cache.k[i], cache.v[i]
        S = k.shape[1]
        if keep >= S:
            continue
        src = torch.clamp(torch.arange(keep, S, device=k.device) + shift, max=S - 1)
        k_new = k.index_select(1, src)
        v[:, keep:].copy_(v.index_select(1, src))
        ks = None
        if quant:
            ks = cache.k_scale[i].index_select(1, src)
            cache.v_scale[i][:, keep:].copy_(cache.v_scale[i].index_select(1, src))
        if cfg.layer_spec(i % cfg.num_hidden_layers).use_rope and cfg.rope is not None:
            kf = k_new.float() * ks[..., None] if quant else k_new
            k_rot = apply_rope(kf, cos, sin, layout=cfg.rope.layout,
                               rot_dim=cfg.rope.resolved_rot_dim())
            if quant:
                k_new, ks = quantize_kv(k_rot)
            else:
                k_new = k_rot.to(k.dtype)
        k[:, keep:].copy_(k_new)
        if quant:
            cache.k_scale[i][:, keep:].copy_(ks)
    return cache
