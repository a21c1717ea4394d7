"""K4's launch geometry for bf16 / f32 dots (ops/cuda/flash_decode.py):
blocks per (batch row, kv head), the cluster they form, the grid, and the
64-key tiles each block takes of a row's live keys.  The kernel computes
the same shares on the card (csrc/flash_decode.cu `block_share`); these
hold the rules at the Llama-3-8B (8 kv heads) and Qwen2.5-0.5B (2 kv heads)
shapes on a 132-SM H100, over every n_past of an 8192-slot cache."""
from pathlib import Path

import numpy as np
import pytest
import torch

from chatllm_tpu_torch.ops.cuda import flash_decode as fd

SMS = 132
S = 8192
GRID_YZ = 65535                      # CUDA's limit on gridDim.y and gridDim.z
SRC = Path(fd.__file__).resolve().parents[2] / "csrc" / "flash_decode.cu"

# (model, B, Hkv, blocks per (b, kv head) expected at 132 SMs)
SHAPES = [("llama", 1, 8, 16), ("llama", 4, 8, 8), ("llama", 32, 8, 1),
          ("qwen", 1, 2, 16), ("qwen", 2, 2, 16)]


@pytest.mark.parametrize("model,B,Hkv,want", SHAPES)
def test_blocks_per_head(model, B, Hkv, want):
    C = fd.decode_geometry(B, Hkv, S, SMS)
    assert C == want
    assert 1 <= C <= fd.MAX_CLUSTER
    # about two blocks per SM over the whole grid, unless a bound holds C
    assert B * Hkv * C <= 2 * SMS or C == 1
    assert C == fd.MAX_CLUSTER or B * Hkv * (C + 1) > 2 * SMS


@pytest.mark.parametrize("model,B,Hkv,want", SHAPES)
def test_grid_within_limits(model, B, Hkv, want):
    C = fd.decode_geometry(B, Hkv, S, SMS)
    grid = (C, Hkv, B)               # one cluster of C blocks along x per (b, kv head)
    assert grid[0] % C == 0 and grid[1] <= GRID_YZ and grid[2] <= GRID_YZ


def test_cluster_size_limits():
    """Clusters above 8 blocks are not portable: the launcher sets the
    attribute that allows them, and none exceeds 16."""
    assert fd.PORTABLE_CLUSTER == 8 and fd.MAX_CLUSTER == 16
    src = SRC.read_text()
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in src
    assert "constexpr int MAX_CLUSTER = 16;" in src and "constexpr int FTK = 64;" in src
    for B in (1, 2, 3, 8, 64, 1024):
        for Hkv in (1, 2, 4, 8):
            for s in (64, 100, 512, 1024, 8192):
                C = fd.decode_geometry(B, Hkv, s, SMS)
                assert 1 <= C <= min(fd.MAX_CLUSTER, -(-s // fd.TILE_K))


def _check_shares(lo, hi, C):
    shares = [fd.decode_share(lo, hi, r, C) for r in range(C)]
    live = [(a, b) for a, b in shares if a < b]
    if hi <= lo:
        assert not live
        return
    # in rank order, they cover [lo, hi) exactly once
    assert live[0][0] == lo and live[-1][1] == hi
    for (_, b0), (a1, _) in zip(live, live[1:]):
        assert a1 == b0
    assert sum(b - a for a, b in live) == hi - lo
    # tile-aligned, and balanced to one tile
    tiles = []
    for a, b in live:
        assert a == lo or a % fd.TILE_K == 0
        assert b == hi or b % fd.TILE_K == 0
        tiles.append(-(-b // fd.TILE_K) - a // fd.TILE_K)
    assert max(tiles) - min(tiles) <= 1 or len(tiles) == 1
    n_tiles = -(-hi // fd.TILE_K) - lo // fd.TILE_K
    assert sum(tiles) == n_tiles
    assert len(live) == min(C, n_tiles)


@pytest.mark.parametrize("window", [0, 64, 256, 4096])
@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("model,B,Hkv,want", SHAPES)
def test_shares_cover_the_live_keys(model, B, Hkv, want, T, window):
    C = fd.decode_geometry(B, Hkv, S, SMS)
    for n_past in range(0, S - T + 1):
        lo, hi = fd.live_range(n_past, T, S, window)
        _check_shares(lo, hi, C)


@pytest.mark.parametrize("window", [0, 5, 40])
@pytest.mark.parametrize("T", [1, 3])
def test_live_range_bounds_the_mask(T, window):
    """[lo, hi) holds every key some row may see, and its ends are seen."""
    B, Hq, Hkv, D, s = 5, 4, 2, 8, 96
    rng = np.random.default_rng(0)
    n_past = [0, 1, 33, 64, s - T]
    q = torch.from_numpy(rng.standard_normal((B, T, Hq, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, s, Hkv, D)).astype(np.float32))
    sc = fd.decode_scores(q, k, torch.tensor(n_past), T, scale=1.0, sliding_window=window,
                          qk_dtype="float32")
    seen = (sc > fd.NEG_INF).flatten(1, 3).any(dim=1)           # [B, S]
    for b, n in enumerate(n_past):
        lo, hi = fd.live_range(n, T, s, window)
        keys = torch.nonzero(seen[b]).flatten().tolist()
        assert keys and min(keys) == lo and max(keys) == hi - 1


def test_shares_of_a_short_cache():
    """A cache shorter than C tiles: every tile is one block's."""
    C = fd.decode_geometry(1, 8, 200, SMS)
    assert C == 4
    for n_past in range(0, 200):
        lo, hi = fd.live_range(n_past, 1, 200)
        _check_shares(lo, hi, C)
