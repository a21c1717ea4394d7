"""The schedule of K3's bf16 kernel (ops/cuda/flash.py::prefill_geometry,
which csrc/flash_attention.cu computes on the card) against the mask
contract itself: every visible (query, key) pair lies in exactly one visited
(query tile, key tile), no visited tile is wholly masked for its query tile,
a tile marked interior for a warpgroup holds no masked pair of its rows,
the launch order puts no query tile before a heavier one, and the block's
shared memory fits the H100."""
import numpy as np
import pytest

from chatllm_tpu_torch.ops.cuda.flash import (BK, BQ, SMEM_LIMIT, WG_ROWS,
                                              prefill_geometry)

# chip_smoke.py's K3 cases and the card tests' (T, S, n_past, n_tokens, window)
CHIP_CASES = [
    (128, 1024, 0, 128, 0), (512, 8192, 1000, 512, 0), (128, 1024, 0, 100, 0),
    (512, 8192, 1000, 512, 256), (128, 1024, 64, 128, 0), (1024, 8192, 0, 1000, 0),
    (128, 1024, 37, 128, 0), (512, 8192, 1001, 512, 0), (128, 8192, 8064, 128, 0),
    (512, 8192, 1001, 512, 300), (320, 2048, 700, 320, 300), (200, 1024, 37, 180, 0),
    (1024, 8192, 37, 1024, 0), (192, 1024, 300, 192, 64),
]


def _visible(T, S, n_past, n_tokens, causal, window):
    """[T, S] booleans: key p visible to query row t (the K3 mask contract)."""
    qpos = n_past + np.arange(T)[:, None]
    kpos = np.arange(S)[None, :]
    vis = kpos < n_past + n_tokens
    if causal:
        vis = vis & (kpos <= qpos)
    if window > 0:
        vis = vis & (kpos > qpos - window)
    return np.broadcast_to(vis, (T, S))


def _check(T, S, n_past, n_tokens, D, causal, window):
    g = prefill_geometry(T, S, n_past, n_tokens, D, causal=causal, window=window)
    vis = _visible(T, S, n_past, n_tokens, causal, window)
    n_qt, n_kt = -(-T // BQ), -(-S // BK)
    assert len(g["tiles"]) == n_qt and g["smem"] <= SMEM_LIMIT
    visits = np.zeros((n_qt, n_kt), dtype=np.int64)
    for qt, (first, end) in enumerate(g["tiles"]):
        assert 0 <= first <= end <= n_kt
        visits[qt, first:end] += 1
        rows = slice(qt * BQ, min(T, (qt + 1) * BQ))
        for i, kt in enumerate(range(first, end)):
            keys = slice(kt * BK, min(S, (kt + 1) * BK))
            assert vis[rows, keys].any(), (qt, kt)            # not wholly masked
            for half, interior in enumerate(g["interior"][qt][i]):
                lo = qt * BQ + half * WG_ROWS
                if interior and lo < T:
                    assert vis[lo:min(T, lo + WG_ROWS), keys].all(), (qt, kt, half)
    # each visible pair in exactly one visited (query tile, key tile)
    t_idx, p_idx = np.nonzero(vis)
    assert (visits[t_idx // BQ, p_idx // BK] == 1).all()
    # heaviest query tiles first
    counts = [end - first for first, end in g["tiles"]]
    assert sorted(g["order"]) == list(range(n_qt))
    ordered = [counts[qt] for qt in g["order"]]
    assert all(a >= b for a, b in zip(ordered, ordered[1:]))
    return g


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", CHIP_CASES, ids=[str(c) for c in CHIP_CASES])
def test_geometry_chip_cases(case, D):
    _check(*case[:4], D, True, case[4])


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("seed", range(6))
def test_geometry_seeded_sweep(seed, D):
    rng = np.random.default_rng(1000 * seed + D)
    for _ in range(20):
        T = int(rng.integers(1, 700))
        n_tokens = int(rng.integers(1, T + 1))
        n_past = int(rng.integers(0, 1500))
        S = n_past + n_tokens + int(rng.integers(0, 600))
        causal = bool(rng.integers(0, 4))          # mostly causal, as the model calls it
        window = int(rng.integers(1, 500)) if rng.integers(0, 2) else 0
        _check(T, S, n_past, n_tokens, D, causal, window)


def test_geometry_prefill_1000():
    """The 1000-token chunk (T 1024 over 8192 slots): eight query tiles walk
    1..8 key tiles, launched from the last (heaviest) down; only the last
    key tile of each query tile is masked, for both warpgroups."""
    g = _check(1024, 8192, 0, 1000, 128, True, 0)
    assert g["tiles"] == [(0, qt + 1) for qt in range(8)]
    assert g["order"] == list(range(7, -1, -1))
    assert all(ints[-1] == (False, False) and all(i == (True, True) for i in ints[:-1])
               for ints in g["interior"])
    assert g["stages"] == 2 and prefill_geometry(1024, 8192, 0, 1000, 64)["stages"] == 4


def test_geometry_no_visible_key():
    """Padding rows past the window's reach see no key: their tile visits
    nothing (the kernel writes zeros there, as the Pallas kernel's skipped
    blocks leave them)."""
    g = prefill_geometry(256, 1024, 0, 10, 64, causal=True, window=5)
    assert g["tiles"][1] == (0, 0) and g["order"][-1] == 1
