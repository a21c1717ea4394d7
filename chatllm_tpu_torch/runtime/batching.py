"""Continuous batching: N concurrent generation streams over one shared
batched KV cache (counterpart of the JAX package's `runtime/batching.py`).

  - every slot has its own causal frontier: a per-slot `n_past` int64 [B]
    tensor on the device drives per-row RoPE positions, per-row cache
    writes (rows past capacity are dropped; a sliding-window ring wraps
    them, nn/transformer.py::ring_write) and per-row attention masks
    (ops/attention.py: K4 over a q8 cache, `_batched_npast_attention`
    otherwise; a ring rebuilds each row's key positions from its own
    n_past, `_ring_attention`);
  - prefill runs slot by slot between decode blocks: the new prompt goes
    through a B=1 forward against a [slot:slot+1] view of each layer's
    cache, so it is written in place and running streams are never
    re-padded or interrupted; with ring layers a chunk is at most SWA_EXTRA
    tokens (runtime/generate.py::swa_chunk_cap), bucket padding included,
    so its writes never wrap onto keys a query of the chunk still sees;
  - decode runs `decode_block` batched steps on the device and reads the
    block's tokens back once (the JAX package scans the block on the
    device): the scheduler writes each slot's token, n_past and whether it
    is active into the decoder's static buffers, and on the card the block
    replays a CUDA graph captured over the shared cache
    (runtime/decode_graph.py); slots that finish mid-block waste at most
    block-1 speculative rows, which are overwritten when the slot is reused;
  - attention reads the whole cache in every block (no KV bucket), so a
    slot's result does not depend on where the other slots stand;
  - sampling: greedy is one batched argmax; sampled decoding draws each
    slot's token from that slot's `torch.Generator` (seeded by its
    request, registered with every graph) with that slot's penalty ring.

The device mesh of the JAX engine is not ported.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..nn.transformer import KVCache, TransformerConfig, init_cache, transformer_forward
from ..ops.sampling import PenaltyState, SamplerConfig, penalty_accept, sample_token
from .decode_graph import BlockDecoder
from .generate import _fit_bucket, swa_chunk_cap

PREFILL_CHUNK = 1024


@dataclass
class _Slot:
    req_id: int
    out: "queue.Queue[int | None]"
    n_past: int = 0
    produced: int = 0
    max_new: int = 0
    is_terminator: Callable[[int], bool] = lambda t: False
    done: bool = False


class StreamHandle:
    """Consumer side of one request: iterate to receive token ids."""

    def __init__(self, req_id: int):
        self.req_id = req_id
        self._q: "queue.Queue[int | None]" = queue.Queue()
        self.cancelled = False

    def __iter__(self):
        while True:
            t = self._q.get()
            if t is None:
                return
            yield t

    def cancel(self):
        self.cancelled = True


class BatchedEngine:
    """Slot scheduler + batched decode for one model on one device.

    Scope: causal text models with full attention or sliding-window rings
    (the port's decoder, MLA in its expanded mode), one SamplerConfig per
    engine (per-request max_new and seed are honoured)."""

    def __init__(self, cfg: TransformerConfig, params, *, max_slots: int = 4,
                 max_length: int | None = None, decode_block: int = 8,
                 scfg: SamplerConfig | None = None, device=None):
        from ..device import resolve_device

        self._validate_config(cfg)
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.max_slots = max_slots
        self.max_length = max_length or cfg.max_length
        self.decode_block = decode_block
        self.scfg = scfg or SamplerConfig()
        self.sampled = self.scfg.do_sample and self.scfg.sampling != "greedy"
        self._chunk_cap = swa_chunk_cap(cfg, self.max_length)
        B, dev = max_slots, self.device
        self.cache = init_cache(cfg, B, self.max_length, device=dev)
        self.n_past = np.zeros(B, np.int64)
        self.toks = np.zeros(B, np.int64)
        self.slots: list[Optional[_Slot]] = [None] * B
        self._handles: list[Optional[StreamHandle]] = [None] * B
        self.decoder = BlockDecoder(cfg, params, dev)
        self._st = self.decoder.state(B, per_row=True, window=self.scfg.penalty_window,
                                      sampled=self.sampled)
        self.penalty = self._st.penalty
        self.gens = self._st.gens

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: list[tuple[StreamHandle, list[int], int, Callable, int]] = []
        self._next_id = 0
        self._stop = False
        self._failed: Optional[BaseException] = None     # what stopped the worker
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    @staticmethod
    def _validate_config(cfg: TransformerConfig):
        """Reject configs the batched decode cannot serve up front, so the
        server falls back to one slot instead of failing in the worker."""
        if not cfg.causal:
            raise ValueError("BatchedEngine decodes causal models only; serve this "
                             "model single-slot")
        if cfg.mla_compressed:
            # the latent MLA cache takes no per-slot n_past, as in the JAX package
            raise ValueError("BatchedEngine v1 supports dense full-attention models only; "
                             "unsupported: compressed-MLA cache. Serve this model "
                             "single-slot (serve/server.py falls back).")

    # -- public ------------------------------------------------------------
    def submit(self, ids: list[int], *, max_new: int = -1,
               is_terminator: Callable[[int], bool] = lambda t: False,
               seed: int = 0) -> StreamHandle:
        with self._cv:
            if self._failed is not None:
                raise RuntimeError("the batching worker stopped") from self._failed
            h = StreamHandle(self._next_id)
            self._next_id += 1
            ids = list(ids)[-(self.max_length - 1):]   # keep the newest that fit
            room = self.max_length - len(ids) - 1
            mn = min(max_new if max_new > 0 else room, room)
            self._pending.append((h, ids, mn, is_terminator, seed))
            self._cv.notify()
            return h

    def active_slots(self) -> list[dict]:
        with self._lock:
            return [{"id": i, "state": 0 if s is None else 1,
                     "n_past": int(self.n_past[i]) if s else 0}
                    for i, s in enumerate(self.slots)]

    def shutdown(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._worker.join(timeout=5)

    # -- scheduler loop ------------------------------------------------------
    def _free_slot(self) -> int:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return -1

    def _slot_penalty(self, slot: int) -> PenaltyState:
        """Views of one slot's penalty rows (written in place)."""
        p = self.penalty
        return PenaltyState(p.token_count[slot], p.history[slot], p.write_pos[slot])

    @torch.inference_mode()
    def _admit(self, h: StreamHandle, ids, max_new, is_term, seed, slot: int):
        cfg, dev = self.cfg, self.device
        ids = np.asarray(ids, np.int64)[None, :]
        T = ids.shape[1]
        # a request's draws depend on its seed only, not on its slot
        pen = None
        if self.sampled:
            self.gens[slot].manual_seed(seed)
            pen = self._slot_penalty(slot)
            pen.reset()
        # chunked prefill into the slot's cache row, a view written in place
        row = KVCache(k=[t[slot:slot + 1] for t in self.cache.k],
                      v=[t[slot:slot + 1] for t in self.cache.v])
        if self.cache.k_scale is not None:
            row.k_scale = [t[slot:slot + 1] for t in self.cache.k_scale]
            row.v_scale = [t[slot:slot + 1] for t in self.cache.v_scale]
        n_past, logits = 0, None
        chunk = min(PREFILL_CHUNK, self._chunk_cap or PREFILL_CHUNK)
        while n_past < T:
            n = min(chunk, T - n_past)
            tpad = _fit_bucket(n, self.max_length - n_past, hi=chunk)
            n = min(n, tpad)
            buf = np.zeros((1, tpad), np.int64)
            buf[:, :n] = ids[:, n_past:n_past + n]
            logits, _ = transformer_forward(cfg, self.params, torch.from_numpy(buf).to(dev),
                                            row, n_past, last_index=n - 1)
            n_past += n
        # the first token comes from the slot's generator and penalty ring
        tok0, _ = sample_token(logits[0, 0], self.scfg,
                               self.gens[slot] if self.sampled else None, pen)
        if pen is not None:
            penalty_accept(pen, tok0)
        tok0 = int(tok0)
        s = _Slot(req_id=h.req_id, out=h._q, n_past=n_past, max_new=max_new,
                  is_terminator=is_term)
        if is_term(tok0) or max_new <= 0:
            h._q.put(None)
            return
        s.produced = 1
        h._q.put(tok0)
        self._handles[slot] = h
        self.slots[slot] = s
        self.n_past[slot] = n_past
        self.toks[slot] = tok0

    def _run(self):
        while True:
            with self._cv:
                while not self._stop and not self._pending and not any(self.slots):
                    self._cv.wait()
                if self._stop:
                    for s in self.slots:
                        if s is not None:
                            s.out.put(None)
                    return
                # admit pending requests into free slots
                while self._pending:
                    slot = self._free_slot()
                    if slot < 0:
                        break
                    h, ids, mn, it, seed = self._pending.pop(0)
                    if h.cancelled:
                        h._q.put(None)
                        continue
                    try:
                        self._admit(h, ids, mn, it, seed, slot)
                    except Exception:
                        h._q.put(None)
                        raise
                active_any = any(s is not None for s in self.slots)
            if not active_any:
                continue
            try:
                self._decode_block_once()
            except Exception as e:
                # drain every in-flight consumer before the worker dies, so
                # no StreamHandle blocks forever on its queue, and refuse
                # later requests
                with self._cv:
                    self._failed = e
                    for b, s in enumerate(self.slots):
                        if s is not None:
                            s.out.put(None)
                            self.slots[b] = None
                            self._handles[b] = None
                    for h, *_ in self._pending:
                        h._q.put(None)
                    self._pending.clear()
                raise

    def _decode_block_once(self):
        st = self._st
        with self._lock:
            st.active.copy_(torch.tensor([s is not None for s in self.slots]))
            st.n_past.copy_(torch.from_numpy(self.n_past))
            st.tok.copy_(torch.from_numpy(self.toks)[:, None])
        # the block's ids [block, B], read back once
        hist = self.decoder.run(st, self.cache, self.scfg, self.decode_block).cpu().numpy()
        with self._cv:
            for b, s in enumerate(self.slots):
                if s is None:
                    continue
                h = self._handles[b]
                for j in range(self.decode_block):
                    t = int(hist[j, b])
                    s.n_past += 1
                    if s.is_terminator(t) or h.cancelled:
                        s.done = True
                        break
                    s.produced += 1
                    s.out.put(t)
                    if s.produced >= s.max_new or s.n_past + 1 >= self.max_length:
                        s.done = True
                        break
                if s.done:
                    s.out.put(None)
                    self.slots[b] = None
                    self._handles[b] = None
                    self.n_past[b] = 0
                    self.toks[b] = 0
                else:
                    self.n_past[b] = s.n_past
                    self.toks[b] = int(hist[-1, b])   # next step's input
            self._cv.notify()
