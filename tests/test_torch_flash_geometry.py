"""The schedule of K3's kernels (ops/cuda/flash.py::prefill_geometry,
which csrc/flash_attention.cu computes on the card): the bf16 kernel's
128 x 128 tiles and the f32 kernel's tiles of 128 or 64 query rows by 64
keys with each key walk split over a cluster, against the mask contract itself: every visible (query,
key) pair lies in exactly one visited (query tile, split rank, key tile),
no visited tile is wholly masked for its query tile, a tile marked interior
for a row group holds no masked pair of its rows, the launch order puts no
query tile before a heavier one, and the block's shared memory fits the
H100."""
import numpy as np
import pytest

from chatllm_tpu_torch.experiments import k3_rows
from chatllm_tpu_torch.ops.cuda.build import CSRC, FLASH
from chatllm_tpu_torch.ops.cuda.flash import (MAX_SPLIT, SMEM_LIMIT, f32_rows, f32_splits,
                                              prefill_geometry)

SM_SMEM = 233472          # shared memory of one H100 SM, 1 KB of it reserved per block

# chip_smoke.py's K3 cases and the card tests' (T, S, n_past, n_tokens, window)
CHIP_CASES = [
    (128, 1024, 0, 128, 0), (512, 8192, 1000, 512, 0), (128, 1024, 0, 100, 0),
    (512, 8192, 1000, 512, 256), (128, 1024, 64, 128, 0), (1024, 8192, 0, 1000, 0),
    (128, 1024, 37, 128, 0), (512, 8192, 1001, 512, 0), (128, 8192, 8064, 128, 0),
    (512, 8192, 1001, 512, 300), (320, 2048, 700, 320, 300), (200, 1024, 37, 180, 0),
    (1024, 8192, 37, 1024, 0), (192, 1024, 300, 192, 64), (128, 1024, 700, 128, 0),
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


def _check(T, S, n_past, n_tokens, D, causal, window, mode=0, heads=1):
    g = prefill_geometry(T, S, n_past, n_tokens, D, causal=causal, window=window, mode=mode,
                         heads=heads)
    bq, bk, rows, C = g["bq"], g["bk"], g["rows"], g["splits"]
    vis = _visible(T, S, n_past, n_tokens, causal, window)
    n_qt, n_kt = -(-T // bq), -(-S // bk)
    assert len(g["tiles"]) == n_qt and g["smem"] <= SMEM_LIMIT
    if mode:
        assert g["smem"] + 1024 <= SM_SMEM
        assert C in (1, 2, 4, 8) and C <= MAX_SPLIT
    else:
        assert C == 1
    visits = np.zeros((n_qt, n_kt), dtype=np.int64)
    for qt, (first, end) in enumerate(g["tiles"]):
        assert 0 <= first <= end <= n_kt
        shares = g["shares"][qt]
        # the ranks' shares: contiguous, in rank order, covering the walk
        assert len(shares) == C and shares[0][0] == first and shares[-1][1] == end
        assert all(a <= b == a2 for (a, b), (a2, _) in zip(shares, shares[1:]))
        for a, b in shares:
            visits[qt, a:b] += 1
        rows_qt = slice(qt * bq, min(T, (qt + 1) * bq))
        for i, kt in enumerate(range(first, end)):
            keys = slice(kt * bk, min(S, (kt + 1) * bk))
            assert vis[rows_qt, keys].any(), (qt, kt)            # not wholly masked
            for half, interior in enumerate(g["interior"][qt][i]):
                lo = qt * bq + half * rows
                if interior and lo < T:
                    assert vis[lo:min(T, lo + rows), keys].all(), (qt, kt, half)
    # each visible pair in exactly one visited (query tile, split rank, key tile)
    t_idx, p_idx = np.nonzero(vis)
    assert (visits[t_idx // bq, p_idx // bk] == 1).all()
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


# The f32 kernel (modes 1 and 2) over the same cases, at the head counts that
# chip_smoke.py and the card tests launch: Llama-3-8B's 32, the card tests'
# 8, Qwen2.5-0.5B's 14 (fewer blocks, longer splits).
F32_CASES = CHIP_CASES + [
    (256, 4096, 1001, 256, 0), (100, 8192, 3000, 90, 0), (128, 4096, 2000, 128, 700),
    (128, 8192, 5000, 128, 0), (128, 8192, 5000, 128, 1000), (64, 8192, 8128, 64, 0),
]


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("heads,D", [(32, 128), (8, 128), (8, 64), (14, 64)])
@pytest.mark.parametrize("case", F32_CASES, ids=[str(c) for c in F32_CASES])
def test_geometry_f32_chip_cases(case, heads, D, mode):
    _check(*case[:4], D, True, case[4], mode=mode, heads=heads)


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("seed", range(6))
def test_geometry_f32_seeded_sweep(seed, D, mode):
    rng = np.random.default_rng(2000 * seed + D + mode)
    for _ in range(20):
        T = int(rng.integers(1, 700))
        n_tokens = int(rng.integers(1, T + 1))
        n_past = int(rng.integers(0, 6000))
        S = n_past + n_tokens + int(rng.integers(0, 600))
        causal = bool(rng.integers(0, 4))
        window = int(rng.integers(1, 1500)) if rng.integers(0, 2) else 0
        heads = int(rng.choice([1, 2, 7, 8, 14, 32]))
        _check(T, S, n_past, n_tokens, D, causal, window, mode=mode, heads=heads)


def test_geometry_f32_splits():
    """The split of each walk: one block per query tile where the grid fills
    the card (the 1000-token chunk, Llama-3-8B and Qwen2.5-0.5B); for the
    128-token chunk at n_past 8064 (128 key tiles a walk), 64-row blocks and
    a cluster of 2 for Llama-3-8B (64 clusters, 66 fit an H100 at once), of
    4 for Qwen2.5-0.5B (28 clusters, 30 fit) and for the card tests' 8 heads
    (16 clusters, 15 fit in eights); never a share under MIN_SHARE tiles of
    the longest walk."""
    def splits(T, S, n_past, n_tok, D, heads, window=0, mode=1):
        return prefill_geometry(T, S, n_past, n_tok, D, mode=mode, heads=heads,
                                window=window)["splits"]
    assert splits(1024, 8192, 0, 1000, 128, 32) == 1
    assert splits(1024, 8192, 0, 1000, 64, 14) == 1
    assert splits(128, 8192, 8064, 128, 128, 32) == 2
    assert splits(128, 8192, 8064, 128, 64, 14) == 4
    assert splits(128, 8192, 8064, 128, 64, 14, mode=2) == 4
    assert splits(128, 8192, 8064, 128, 128, 8) == 4
    assert splits(128, 4096, 2000, 128, 128, 8, window=700) == 2
    assert splits(128, 1024, 0, 128, 128, 8) == 1          # two key tiles: no split
    g = prefill_geometry(128, 8192, 8064, 128, 128, mode=1, heads=32)
    assert g["bq"] == 64 and g["tiles"] == [(0, 127), (0, 128)] and g["order"] == [1, 0]
    assert g["shares"] == [[(0, 63), (63, 127)], [(0, 64), (64, 128)]]
    assert prefill_geometry(1024, 8192, 0, 1000, 128, mode=1, heads=32)["bq"] == 128
    slots = {1: 132, 2: 66, 4: 30, 8: 15}
    assert f32_splits(64, 128, slots) == 2 and f32_splits(256, 16, slots) == 1
    assert f32_splits(1, 1000, slots) == MAX_SPLIT and f32_splits(1, 7, slots) == 1


def test_geometry_f32_prefill_1000():
    """The 1000-token chunk in the f32 modes: at D 128, 8 query tiles of 128
    rows walk 2..16 key tiles of 64, launched from the last down, only the
    two diagonal tiles of each masked; at D 64, 16 query tiles of 64 rows
    walk 1..16.  Shared memory: 200704 bytes at D 128 over an f32 cache,
    199680 over a bf16 one (its tiles widened to f32 beside the ring); at D
    64, with four stages in the ring, 152576."""
    g = _check(1024, 8192, 0, 1000, 128, True, 0, mode=1, heads=32)
    assert g["tiles"] == [(0, 2 * qt + 2) for qt in range(8)]
    assert g["order"] == list(range(7, -1, -1)) and g["splits"] == 1
    assert all(ints[-2:] == [(False,), (False,)] and all(i == (True,) for i in ints[:-2])
               for ints in g["interior"])
    assert g["smem"] == 200704
    g = _check(1024, 8192, 0, 1000, 64, True, 0, mode=1, heads=14)
    assert g["tiles"] == [(0, qt + 1) for qt in range(16)] and g["splits"] == 1
    assert g["smem"] == 152576
    assert prefill_geometry(1024, 8192, 0, 1000, 128, mode=2, heads=32)["smem"] == 199680


def test_geometry_f32_no_visible_key():
    """As test_geometry_no_visible_key at the f32 tiles: the query tiles past
    the window's reach visit nothing and launch last (the kernel writes
    zeros there)."""
    g = _check(256, 1024, 0, 10, 64, True, 5, mode=1)
    assert g["tiles"][1:] == [(0, 0)] * 3 and g["order"] == [0, 3, 2, 1]
    assert all(s == [(0, 0)] * g["splits"] for s in g["shares"][1:])


def test_f32_rows_probe_patches_the_kernel():
    """experiments/k3_rows.py builds its 64-row copy by replacing the one
    line of the kernel's `f32_rows` that chooses the rows; that line is the
    Python twin's rule: 128 at D 128 where 128-row tiles fill the SMs."""
    src = (CSRC / FLASH.source).read_text()
    assert src.count(k3_rows.ROWS_LINE) == 1
    assert f32_rows(128, 1024, 32, 1) == 128 and f32_rows(128, 128, 32, 1) == 64
    assert f32_rows(128, 512, 32, 1) == 64 and f32_rows(128, 513, 32, 1) == 128
    assert f32_rows(64, 8192, 32, 1) == 64
