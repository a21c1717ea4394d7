"""K4's launch geometry (ops/cuda/flash_decode.py): blocks per (batch row,
kv head), the cluster they form, the grid, and what each block takes of a
row's live keys: 64-key tiles with bf16 / f32 dots, whole quantization
blocks or tiles of one block with int8 dots.  The kernel computes the same
shares on the card (csrc/flash_decode.cu `block_share`, `int8_share`);
these hold the rules at the Llama-3-8B (8 kv heads) and Qwen2.5-0.5B (2 kv
heads) shapes on a 132-SM H100, over every n_past of an 8192-slot cache."""
import inspect
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


def _check_shares(lo, hi, C, tile=fd.TILE_K):
    shares = [fd.decode_share(lo, hi, r, C, tile) for r in range(C)]
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
        assert a == lo or a % tile == 0
        assert b == hi or b % tile == 0
        tiles.append(-(-b // tile) - a // tile)
    assert max(tiles) - min(tiles) <= 1 or len(tiles) == 1
    n_tiles = -(-hi // tile) - lo // tile
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


@pytest.mark.parametrize("window", [0, 1024])
@pytest.mark.parametrize("B,Hkv", [(1, 8), (2, 8), (1, 1)])
def test_f32_cache_d256_shares_cover_the_live_keys(B, Hkv, window):
    """Over an f32 cache at D 256 the float dots take 32-key tiles (two
    stages of 64 keys would not fit the shared memory); their shares keep
    the rules of the 64-key ones at Gemma-3's kv heads."""
    assert fd.float_tile(256, torch.float32) == fd.F32_D256_TILE_K == 32
    assert {fd.float_tile(D, dt) for D in (64, 128, 256)
            for dt in (torch.int8, torch.bfloat16)} == {fd.TILE_K}
    assert fd.float_tile(128, torch.float32) == fd.TILE_K
    C = fd.decode_geometry(B, Hkv, S, SMS)
    for n_past in range(0, S, 7):
        lo, hi = fd.live_range(n_past, 1, S, window)
        _check_shares(lo, hi, C, fd.F32_D256_TILE_K)


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


# The int8 dots at the Llama-3-8B shapes: (B, blocks per (b, kv head))
INT8_SHAPES = [(1, 16), (4, 8), (32, 1)]


def _check_int8_shares(lo, hi, C, bk):
    shares = [fd.int8_share(lo, hi, r, C, bk) for r in range(C)]
    live = [(a, b) for a, b, _, _ in shares if a < b]
    if hi <= lo:
        assert not live
        return
    # disjoint, in rank order, covering [lo, hi) exactly
    assert live[0][0] == lo and live[-1][1] == hi
    for (_, b0), (a1, _) in zip(live, live[1:]):
        assert a1 == b0
    assert sum(b - a for a, b in live) == hi - lo
    q0 = lo // bk
    nb = -(-hi // bk) - q0
    groups = sorted({(first, n) for _, _, first, n in shares})
    if nb >= C:
        # each rank a contiguous run of whole blocks, balanced to one block
        assert groups == [(r, 1) for r in range(C)] and len(live) == C
        runs = []
        for a, b in live:
            assert (a == lo or a % bk == 0) and (b == hi or b % bk == 0)
            runs.append(-(-b // bk) - a // bk)
        assert max(runs) - min(runs) <= 1 and sum(runs) == nb
        return
    # fewer live blocks than ranks: block q0 + j goes to the j-th of nb
    # contiguous groups that cover the ranks in order
    assert len(groups) == nb and groups[0][0] == 0
    for (f0, n0), (f1, _) in zip(groups, groups[1:]):
        assert f1 == f0 + n0
    assert groups[-1][0] + groups[-1][1] == C
    for r, (a, b, first, n) in enumerate(shares):
        assert first <= r < first + n
        j = q0 + groups.index((first, n))
        base = j * bk
        if a < b:
            # inside its block, in whole tiles aligned at the block's start
            assert max(base, lo) <= a < b <= min(base + bk, hi)
            assert a == max(base, lo) or (a - base) % fd.TILE_K == 0
            assert b == min(base + bk, hi) or (b - base) % fd.TILE_K == 0
    # a group's ranks cover their block's live keys, balanced to one tile
    for g, (first, n) in enumerate(groups):
        base = (q0 + g) * bk
        mine = [shares[r][:2] for r in range(first, first + n)]
        keys = [(a, b) for a, b in mine if a < b]
        assert keys[0][0] == max(base, lo) and keys[-1][1] == min(base + bk, hi)
        u0, u1 = fd.block_tiles(q0 + g, lo, hi, bk)
        tiles = [(u0 + i * (u1 - u0) // n, u0 + (i + 1) * (u1 - u0) // n) for i in range(n)]
        assert max(t1 - t0 for t0, t1 in tiles) - min(t1 - t0 for t0, t1 in tiles) <= 1


@pytest.mark.parametrize("window", [0, 200, 4096])
@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("block_k", [512, 256])
@pytest.mark.parametrize("B,want", INT8_SHAPES)
def test_int8_shares_cover_the_live_keys(B, want, block_k, T, window):
    """Over every n_past of an 8192-slot cache: the ranks' shares are
    disjoint, in rank order and cover live_range exactly; ranks that share
    a quantization block are contiguous; C is decode_geometry's."""
    C = fd.decode_geometry(B, 8, S, SMS)
    assert C == want
    bk = fd.batched_block_k(block_k, S, 8, 128, 128, 1)
    assert bk == block_k
    for n_past in range(0, S - T + 1):
        lo, hi = fd.live_range(n_past, T, S, window)
        _check_int8_shares(lo, hi, C, bk)


@pytest.mark.parametrize("block_k", [1, 37, 63, 64, 100, 200])
def test_int8_shares_of_a_short_cache(block_k):
    """Blocks shorter than a tile, or not a whole number of tiles, on a
    200-slot cache (batched_block_k gives block_k as it is there)."""
    C = fd.decode_geometry(1, 8, 200, SMS)
    for n_past in range(0, 200):
        for window in (0, 30):
            lo, hi = fd.live_range(n_past, 1, 200, window)
            _check_int8_shares(lo, hi, C, block_k)


def test_int8_share_rule_is_the_kernels():
    """The kernel's share rule and constants are the Python ones, and the
    wrapper sizes the int8 dots' cluster by decode_geometry and allocates
    nothing but the output."""
    src = SRC.read_text()
    assert f"constexpr int MAX_BLOCK_K = {fd.MAX_BLOCK_K};" in src
    assert f"constexpr int FTK = {fd.TILE_K};" in src
    for line in ("const int q0 = lo / bk, nb = (hi + bk - 1) / bk - q0;",
                 "if (nb >= C) {",
                 "const int j = ((rank + 1) * nb - 1) / C;",
                 "s.g0 = j * C / nb;",
                 "s.gn = (j + 1) * C / nb - s.g0;",
                 "s.u0 = u0 + i * n / s.gn;",
                 "s.u1 = u0 + (i + 1) * n / s.gn;",
                 "u0 = (a - base) / FTK;",
                 "u1 = e > a ? (e - base + FTK - 1) / FTK : u0;"):
        assert line in src, line
    for gone in ("decode_split_int8_kernel", "decode_combine_kernel", "part_ml", "part_acc"):
        assert gone not in src
    wrapper = inspect.getsource(fd.flash_decode)
    assert "decode_geometry(B, Hkv, S, num_sms(dev))" in wrapper
    assert wrapper.count("torch.empty(") == 1 and "torch.zeros" not in wrapper


def test_k4_copy_probe_patches_the_kernel():
    """experiments/k4_copy.py builds its two-pass copy by replacing the float
    kernel's V chunk inside the one pass over a key row's chunks, which the
    kernel holds once, with a second pass over V's chunks; without a card
    its main refuses."""
    from chatllm_tpu_torch.experiments import k4_copy

    src = SRC.read_text()
    assert src.count(k4_copy.ONE_PASS) == 1
    two = src.replace(k4_copy.ONE_PASS, k4_copy.TWO_PASSES)
    assert two.count("idx < TK * Gm::KNCH") == two.count("idx < TK * Gm::VNCH") == 1
    assert "if (c < Gm::VNCH)" not in two
    if not torch.cuda.is_available():
        assert k4_copy.main([]) == 2
