"""Blocks of decode steps, replayed from CUDA graphs on the card: the port of
the JAX package's on-device decode block (`runtime/generate.py::_decode_fn`
and `runtime/batching.py::_decode_fn`, a jitted `lax.scan` over
`decode_block` steps with one host round trip per block).

A block is `block` steps of forward, draw, penalty update and n_past += 1
over the static buffers of a `DecodeState`: the input tokens, n_past (a 0-d
tensor when the rows share one position, [B] per serving slot), the penalty
rings, the generators and, per slot, which rows are active.  The buffers
carry over from one block to the next as the scan's carry does; the host
writes them only where a request starts (or, in the batching scheduler,
between blocks) and reads the block's tokens back once.

`BlockDecoder.run` keeps one `torch.cuda.CUDAGraph` per key: the sampler
config, the block, the KV bucket (`kv_bucket`: the keys attention reads, in
multiples of KV_BUCKET slots), the storage of the cache and of the buffers
(addresses, shapes and dtypes: a graph replays on the memory it was
captured on) and the routing switches read at call time (SWITCHES).  A new
cache object gets its own captures; one allocated where a freed one lay
replays that one's graphs.  (Copying each request's cache into one the
decoder owns would move up to a whole cache per request; a capture is paid
once per bucket and storage.)  Each key is first run once eagerly on copies
of the buffers with fresh generators (the kernel libraries load, each
launcher sets its attributes, the allocator warms up); the cache slots that
run writes are written again by every replay from the same position, so it
leaves no trace.  Then the block is captured into the decoder's memory pool
(`torch.cuda.graph_pool_handle()`, shared by all its graphs), with every
generator registered with the graph, and replayed.  A capture that fails
raises: nothing falls back to the eager loop on the card.

On the CPU, and with `graphs=False` (the uncaptured reference a replay is
held against), `run` calls the same block function as it is.

Launch counts: a kernel wrapper counts its launch when it is called, so
during a capture it counts launches that run only at replay.  The decoder
takes what the capture counted (each kernel's `launches`, K3's launches by
mode and the routes' `KERNEL_DISPATCH`), restores the counts to what they
were before it, and adds that much at every replay.  The warm-up run's
launches are real and stay counted.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from functools import partial
from typing import Optional

import torch

from ..nn.transformer import KVCache, TransformerConfig, transformer_forward
from ..ops.sampling import (PenaltyState, SamplerConfig, penalty_accept,
                            penalty_accept_batched, sample_token)

KV_BUCKET = 1024          # a graph's keys, in multiples of this many slots

# the switches the forward reads at call time (ops/qmm.py, ops/attention.py,
# ops/cuda/flash_decode.py): a graph replays the routes its capture took
SWITCHES = ("CHATLLM_TPU_QMM", "CHATLLM_TPU_QMM_MAX_ROWS", "CHATLLM_TPU_GEMV",
            "CHATLLM_TPU_QMM_V2", "CHATLLM_TPU_FLASH", "CHATLLM_TPU_FLASH_DECODE",
            "CHATLLM_TPU_FLASH_QK", "CHATLLM_TPU_FLASH_GROUP")


def kv_bucket(end: int, cache_len: int) -> int:
    """Slots a block whose last step sees keys below `end` reads: `end`
    rounded up to KV_BUCKET, at most the cache."""
    return min(cache_len, -(-end // KV_BUCKET) * KV_BUCKET)


@dataclass
class DecodeState:
    """The static buffers a decode block reads and updates in place."""
    tok: torch.Tensor                          # int64 [B, 1], the next input
    n_past: torch.Tensor                       # int64 0-d (shared) or [B] (per slot)
    penalty: Optional[PenaltyState] = None     # sampled decoding only
    gens: tuple = ()                           # one generator per row, sampled only
    active: Optional[torch.Tensor] = None      # bool [B], per-slot decoding only

    def tensors(self) -> list:
        pen = [] if self.penalty is None else [self.penalty.token_count, self.penalty.history,
                                               self.penalty.write_pos]
        return [self.tok, self.n_past, *pen] + ([] if self.active is None else [self.active])

    def scratch(self) -> "DecodeState":
        """Copies of the buffers and fresh generators: a warm-up run's."""
        pen = self.penalty
        if pen is not None:
            pen = PenaltyState(pen.token_count.clone(), pen.history.clone(),
                               pen.write_pos.clone())
        gens = tuple(torch.Generator(device=g.device).manual_seed(0) for g in self.gens)
        return DecodeState(self.tok.clone(), self.n_past.clone(), pen, gens,
                           None if self.active is None else self.active.clone())


def _row_penalty(pen: Optional[PenaltyState], b: int) -> Optional[PenaltyState]:
    if pen is None or pen.token_count.dim() == 1:
        return pen
    return PenaltyState(pen.token_count[b], pen.history[b], pen.write_pos[b])


def decode_steps(cfg: TransformerConfig, params, cache: KVCache, scfg: SamplerConfig,
                 st: DecodeState, *, block: int, kv_len: int | None = None) -> torch.Tensor:
    """`block` decode steps from `st.tok` at `st.n_past`: greedy argmax, or
    each row's draw from its own generator and penalty ring.  Inactive rows
    keep their token and position.  Every buffer of `st` is updated in place
    (a per-slot penalty state as a whole, a shared one for its one row);
    returns the drawn ids [block, B]."""
    sampled = scfg.do_sample and scfg.sampling != "greedy"
    B = st.tok.shape[0]
    advance = 1 if st.active is None else st.active.to(torch.int64)
    hist = []
    for _ in range(block):
        logits, _ = transformer_forward(cfg, params, st.tok, cache, st.n_past, kv_len=kv_len)
        lf = logits[:, -1, :]
        if sampled:
            nxt = torch.stack([sample_token(lf[b], scfg, st.gens[b],
                                            _row_penalty(st.penalty, b))[0] for b in range(B)])
        else:
            nxt = torch.argmax(lf.float(), dim=-1)
        if st.active is not None:
            nxt = torch.where(st.active, nxt, st.tok[:, 0])
        if st.penalty is not None:
            if st.penalty.token_count.dim() == 2:
                penalty_accept_batched(st.penalty, nxt)
            else:
                penalty_accept(st.penalty, nxt[0])
        st.n_past.add_(advance)
        st.tok.copy_(nxt[:, None])
        hist.append(nxt)
    return torch.stack(hist)


def _storage(tensors) -> tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


def _cache_tensors(cache: KVCache) -> list:
    return [*cache.k, *cache.v, *(cache.k_scale or ()), *(cache.v_scale or ())]


def _counts() -> tuple:
    from ..ops.cuda.build import KERNELS
    from ..ops.cuda.flash import MODE_LAUNCHES
    from ..ops.qmm import KERNEL_DISPATCH

    return ({k: v.launches for k, v in KERNELS.items()}, dict(MODE_LAUNCHES),
            dict(KERNEL_DISPATCH))


def _add_counts(delta: tuple, sign: int = 1):
    from ..ops.cuda.build import KERNELS
    from ..ops.cuda.flash import MODE_LAUNCHES
    from ..ops.qmm import KERNEL_DISPATCH

    kern, modes, routes = delta
    for k, n in kern.items():
        KERNELS[k].launches += sign * n
    for m, n in modes.items():
        MODE_LAUNCHES[m] += sign * n
    for r, n in routes.items():
        KERNEL_DISPATCH[r] = KERNEL_DISPATCH.get(r, 0) + sign * n
        if not KERNEL_DISPATCH[r]:
            del KERNEL_DISPATCH[r]


def _diff(after: tuple, before: tuple) -> tuple:
    return tuple({k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)}
                 for a, b in zip(after, before))


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    out: torch.Tensor          # the drawn ids [block, B], rewritten by each replay
    counts: tuple              # what one replay launches (see the module docstring)
    block: int


class BlockDecoder:
    """Decode blocks of one model (config + parameters) on one device."""

    def __init__(self, cfg: TransformerConfig, params, device: torch.device, *,
                 graphs: bool = True):
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.graphs = graphs and self.device.type == "cuda"
        self._graphs: dict = {}
        self._states: dict = {}
        self._pool = None
        self.capture_ms = 0.0       # warm-up runs and captures, all keys
        self.eager_steps = 0        # steps run uncaptured (warm-ups included)
        self.replayed_steps = 0     # steps run by graph replays

    def num_graphs(self) -> int:
        return len(self._graphs)

    def state(self, B: int, *, per_row: bool = False, window: int = 0,
              sampled: bool = False) -> DecodeState:
        """The decoder's buffers for B rows (one set per shape, kept for its
        lifetime, so that its graphs replay on them): n_past shared or per
        row (with an active mask), penalty rings of `window` slots and one
        generator per row when sampled."""
        key = (B, per_row, window, sampled)
        if key not in self._states:
            with torch.inference_mode(False):      # normal tensors: writable anywhere
                self._states[key] = self._new_state(B, per_row, window, sampled)
        return self._states[key]

    def _new_state(self, B: int, per_row: bool, window: int, sampled: bool) -> DecodeState:
        dev, V = self.device, self.cfg.vocab_size
        pen = None
        if sampled and per_row:
            pen = PenaltyState(torch.zeros(B, V, dtype=torch.int32, device=dev),
                               torch.full((B, window), -1, dtype=torch.int64, device=dev),
                               torch.zeros(B, dtype=torch.int64, device=dev))
        elif sampled:
            pen = PenaltyState.init(V, window, dev)
        return DecodeState(
            tok=torch.zeros(B, 1, dtype=torch.int64, device=dev),
            n_past=torch.zeros(B if per_row else (), dtype=torch.int64, device=dev),
            penalty=pen,
            gens=tuple(torch.Generator(device=dev) for _ in range(B if sampled else 0)),
            active=torch.zeros(B, dtype=torch.bool, device=dev) if per_row else None)

    @torch.inference_mode()
    def run(self, st: DecodeState, cache: KVCache, scfg: SamplerConfig, block: int,
            kv_len: int | None = None) -> torch.Tensor:
        """One block from the buffers' current values; returns the drawn
        ids [block, B] on the device (on the card, the graph's output: read
        it before the next replay of the same key)."""
        fn = partial(decode_steps, self.cfg, self.params, cache, scfg, block=block,
                     kv_len=kv_len)
        if not self.graphs:
            self.eager_steps += block
            return fn(st)
        key = (scfg, block, kv_len, _storage(_cache_tensors(cache)), _storage(st.tensors()),
               tuple(os.environ.get(name) for name in SWITCHES))
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(fn, st, block)
        g.graph.replay()
        _add_counts(g.counts)
        self.replayed_steps += g.block
        return g.out

    def _capture(self, fn, st: DecodeState, block: int) -> _Graph:
        t0 = time.perf_counter()
        fn(st.scratch())                        # warm-up, on copies of the buffers
        self.eager_steps += block
        torch.cuda.synchronize(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        for gen in st.gens:
            graph.register_generator_state(gen)
        try:
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                out = fn(st)
        finally:
            counts = _diff(_counts(), before)
            _add_counts(counts, -1)             # the capture launched nothing
        torch.cuda.synchronize(self.device)
        self.capture_ms += (time.perf_counter() - t0) * 1000
        return _Graph(graph, out, counts, block)
