"""Samplers on the device (counterpart of the JAX package's `ops/sampling.py`).

Same filter order as the reference: temperature -> penalties -> top-k ->
(top-p | tfs) -> draw.  Draws use an explicit `torch.Generator` on the
logits' device, so they match the JAX package in distribution, not bit for
bit.  Penalty state is a token-count vector [V] plus a ring history, with
its write position on the device, as the JAX state's.

Nothing here reads a value back to the host, so a decode block that samples
runs inside a CUDA graph (runtime/decode_graph.py): indices are tensors
taken by `index_select` / `gather` / `index_add_` (indexing with a 0-d
tensor would call `.item()`), and `torch.multinomial` draws from a generator
that the graph registers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class SamplerConfig:
    do_sample: bool = False
    sampling: str = "top_p"          # top_p | tfs | greedy
    temperature: float = 0.7
    top_k: int = 20
    top_p: float = 0.7
    tfs_z: float = 0.95
    repeat_penalty: float = 1.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    penalty_window: int = 256


@dataclass
class PenaltyState:
    token_count: torch.Tensor    # int32 [V] ([B, V] per serving slot)
    history: torch.Tensor        # int64 [window] ([B, window])
    write_pos: torch.Tensor      # int64 0-d ([B]), updated in place

    @classmethod
    def init(cls, vocab_size: int, window: int, device="cpu"):
        return cls(torch.zeros(vocab_size, dtype=torch.int32, device=device),
                   torch.full((window,), -1, dtype=torch.int64, device=device),
                   torch.zeros((), dtype=torch.int64, device=device))

    def reset(self):
        """Back to the empty window, in place (the buffers a captured
        decode block reads stay where they are)."""
        self.token_count.zero_()
        self.history.fill_(-1)
        self.write_pos.zero_()


def penalty_accept(state: PenaltyState, token_id: torch.Tensor) -> PenaltyState:
    """Ring-buffer accept (reference src/models.cpp:617-638); updates the
    state in place and returns it.  `token_id` is a 0-d device tensor."""
    window = state.history.shape[0]
    pos = state.write_pos.reshape(1)
    old = state.history.index_select(0, pos)
    state.token_count.index_add_(0, old.clamp(min=0), -(old >= 0).to(torch.int32))
    tok = token_id.reshape(1).to(torch.int64)
    state.token_count.index_add_(0, tok, torch.ones_like(tok, dtype=torch.int32))
    state.history.index_copy_(0, pos, tok)
    state.write_pos.add_(1).remainder_(window)
    return state


def penalty_accept_batched(state: PenaltyState, token_ids: torch.Tensor) -> PenaltyState:
    """Accept over a [B]-leading state (one ring per serving slot,
    runtime/batching.py): token_count [B, V], history [B, window] and
    write_pos an int64 [B] tensor.  Same semantics per row as
    `penalty_accept`; updates in place and returns the state."""
    B, window = state.history.shape
    V = state.token_count.shape[-1]
    b = torch.arange(B, device=token_ids.device)
    hist_at = b * window + state.write_pos                      # flat ring slots [B]
    old = state.history.view(-1).index_select(0, hist_at)
    counts = state.token_count.view(-1)
    counts.index_add_(0, b * V + old.clamp(min=0), -(old >= 0).to(torch.int32))
    tok = token_ids.to(torch.int64)
    counts.index_add_(0, b * V + tok, torch.ones_like(tok, dtype=torch.int32))
    state.history.view(-1).index_copy_(0, hist_at, tok)
    state.write_pos.add_(1).remainder_(window)
    return state


def apply_penalties(logits: torch.Tensor, state: PenaltyState,
                    cfg: SamplerConfig) -> torch.Tensor:
    """Reference LogitsPenalty::process (src/models.cpp:640-671)."""
    lf = logits.float()
    cnt = state.token_count.float()
    seen = cnt > 0
    if cfg.repeat_penalty != 1.0 and cfg.repeat_penalty > 0:
        rp = cfg.repeat_penalty
        lf = torch.where(seen, torch.where(lf > 0, lf / rp, lf * rp), lf)
    if cfg.frequency_penalty != 0.0 or cfg.presence_penalty != 0.0:
        lf = lf - cnt * cfg.frequency_penalty - seen.float() * cfg.presence_penalty
    return lf


def _topk_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= thresh, logits, torch.full_like(logits, NEG_INF))


def _topp_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    if not (0.0 < p < 1.0):
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens until cumsum >= p (inclusive) — reference src/models.cpp:800
    n_keep = torch.sum((cum - probs) < p, dim=-1)
    thresh = torch.gather(sorted_logits, -1, (n_keep - 1).clamp(min=0)[..., None])
    return torch.where(logits >= thresh, logits, torch.full_like(logits, NEG_INF))


def _tfs_filter(logits: torch.Tensor, z: float, top_k: int) -> torch.Tensor:
    """Tail-free sampling over the top-k candidates (src/models.cpp:828-877)."""
    V = logits.shape[-1]
    k = top_k if 0 < top_k < V else V
    vals = torch.topk(logits, k, dim=-1).values
    probs = torch.softmax(vals, dim=-1)
    d2 = torch.abs(probs[..., :-2] + probs[..., 2:] - 2.0 * probs[..., 1:-1])
    d2 = d2 / (torch.sum(d2, dim=-1, keepdim=True) + 1e-6)
    cdf = torch.cumsum(d2, dim=-1)
    n_keep = torch.sum(cdf <= z, dim=-1) + 1
    thresh = torch.gather(vals, -1, (n_keep - 1).clamp(min=0)[..., None])
    return torch.where(logits >= thresh, logits, torch.full_like(logits, NEG_INF))


def filter_logits(logits: torch.Tensor, cfg: SamplerConfig,
                  penalty: Optional[PenaltyState] = None) -> torch.Tensor:
    """The logits a sampled draw is taken from, after every filter."""
    lf = logits.float()
    if abs(cfg.temperature) > 1e-5 and abs(cfg.temperature - 1.0) > 1e-5:
        lf = lf / cfg.temperature
    if penalty is not None:
        lf = apply_penalties(lf, penalty, cfg)
    lf = _topk_filter(lf, cfg.top_k)
    if cfg.sampling == "top_p":
        lf = _topp_filter(lf, cfg.top_p)
    elif cfg.sampling == "tfs":
        lf = _tfs_filter(lf, cfg.tfs_z, cfg.top_k)
    return lf


def sample_token(logits: torch.Tensor, cfg: SamplerConfig,
                 generator: Optional[torch.Generator] = None,
                 penalty: Optional[PenaltyState] = None):
    """logits: [V] f32 -> (token id, confidence), both 0-d device tensors."""
    lf = logits.float()
    if not cfg.do_sample or cfg.sampling == "greedy":
        tok = torch.argmax(lf, dim=-1)
        return tok, _at(torch.softmax(lf, dim=-1), tok)
    lf = filter_logits(lf, cfg, penalty)
    probs = torch.softmax(lf, dim=-1)
    tok = torch.multinomial(probs, 1, generator=generator)[0]
    return tok, _at(probs, tok)


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, read on the device."""
    return x.gather(-1, i.reshape(1))[0]
