"""K1/K2 plain versions (what the CUDA kernels are held against on the card)
against the JAX package's Pallas kernels in interpret mode, on the cases of
tests/test_gemv_kernel.py and tests/test_pallas_qmm.py, plus the port's
matmul routing."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax.numpy as jnp

from chatllm_tpu.ops.pallas.gemv_kernel import qgemv_pallas
from chatllm_tpu.ops.pallas.qmm_kernel import qmm_pallas
from chatllm_tpu.ops.qtensor import pack_nibbles
from chatllm_tpu_torch.ops import qmm as tqmm
from chatllm_tpu_torch.ops.cuda.gemv_kernel import qgemv, qgemv_plain
from chatllm_tpu_torch.ops.cuda.qmm_kernel import qmm, qmm_plain
from chatllm_tpu_torch.ops.qtensor import DenseLinear, QuantLinear


def _classic(rng, K, N, G, packed, use_b, f16=False):
    qv = rng.integers(-8, 8, size=(K, N)).astype(np.int8)
    s = rng.random((K // G, N)).astype(np.float32) * 0.1 + 0.01
    b = (rng.random((K // G, N)).astype(np.float32) * 0.05) if use_b else None
    if f16:
        s = s.astype(np.float16)
        b = None if b is None else b.astype(np.float16)
    zero = 0
    q = qv
    if packed:
        q, zero = pack_nibbles(qv, G)
    return dict(q=q, s=s, b=b, group=G, packed=packed, zero_point=zero)


def _superblock(rng, K, N, G=32, SB=8):
    """q4_k-shaped superblock arrays (tests/test_gemv_kernel.py fixture)."""
    qv = rng.integers(0, 16, size=(K, N)).astype(np.int8)
    sc = rng.integers(0, 64, size=(K // G, N)).astype(np.int8)
    m = rng.integers(0, 64, size=(K // G, N)).astype(np.int8)
    d = (rng.random((K // (G * SB), N)) * 0.02 + 1e-4).astype(np.float16)
    dm = (rng.random((K // (G * SB), N)) * 0.01 + 1e-4).astype(np.float16)
    q, _ = pack_nibbles(qv, G)
    return dict(q=q, s=sc, b=m, d=d, dm=dm, sb=SB, group=G, packed=True, zero_point=0)


def _jax_args(w):
    arr = {k: (None if w.get(k) is None else jnp.asarray(w[k]))
           for k in ("q", "s", "b", "d", "dm")}
    kw = dict(group=w["group"], packed=w["packed"], zero_point=w["zero_point"],
              d=arr["d"], dm=arr["dm"], sb=w.get("sb", 0))
    return (arr["q"], arr["s"], arr["b"]), kw


def _torch_args(w):
    arr = {k: (None if w.get(k) is None else torch.from_numpy(np.asarray(w[k])))
           for k in ("q", "s", "b", "d", "dm")}
    kw = dict(group=w["group"], packed=w["packed"], zero_point=w["zero_point"],
              d=arr["d"], dm=arr["dm"], sb=w.get("sb", 0))
    return (arr["q"], arr["s"], arr["b"]), kw


GEMV_CASES = {
    "int8": lambda r: (256, _classic(r, 256, 384, 32, False, False)),
    "int8_affine": lambda r: (256, _classic(r, 256, 384, 32, False, True)),
    "packed": lambda r: (512, _classic(r, 512, 256, 32, True, False)),
    "packed_affine": lambda r: (512, _classic(r, 512, 256, 32, True, True)),
    "g16_affine": lambda r: (256, _classic(r, 256, 128, 16, False, True)),
    "odd_group_count": lambda r: (96 * 32, _classic(r, 96 * 32, 128, 32, False, False)),
    "f16_scales": lambda r: (256, _classic(r, 256, 256, 32, False, False, f16=True)),
    "f16_packed_zero_point": lambda r: (256, _classic(r, 256, 256, 32, True, True, f16=True)),
    "superblock": lambda r: (1024, _superblock(r, 1024, 256)),
}


@pytest.mark.parametrize("case", list(GEMV_CASES))
def test_qgemv_plain_matches_pallas(case):
    rng = np.random.default_rng(len(case))
    K, w = GEMV_CASES[case](rng)
    N = w["q"].shape[1]
    x = rng.standard_normal((1, K)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    ja, jkw = _jax_args(w)
    ref = np.asarray(qgemv_pallas(jnp.asarray(x), *ja, jnp.asarray(bias),
                                  tile_n=128, interpret=True, **jkw))
    ta, tkw = _torch_args(w)
    y = qgemv(torch.from_numpy(x), *ta, torch.from_numpy(bias), **tkw)
    assert y.shape == (1, N) and y.dtype == torch.float32
    # f32 throughout, only the summation order differs: 1e-5 relative to
    # each element, and to the output scale near zero
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(
        y.numpy(), qgemv_plain(torch.from_numpy(x), *ta, torch.from_numpy(bias), **tkw).numpy())


QMM_WEIGHTS = {
    "superblock": lambda r: _superblock(r, 1024, 256),
    "f16_affine": lambda r: _classic(r, 1024, 256, 32, False, True, f16=True),
    "packed_zero_point": lambda r: _classic(r, 1024, 256, 32, True, False, f16=True),
}


@pytest.mark.parametrize("B", [2, 5, 64])
@pytest.mark.parametrize("weights", list(QMM_WEIGHTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qmm_plain_matches_pallas(dtype, weights, B):
    rng = np.random.default_rng(B)
    w = QMM_WEIGHTS[weights](rng)
    K = w["q"].shape[0] * (2 if w["packed"] else 1)
    x = rng.standard_normal((B, K)).astype(np.float32)
    ja, jkw = _jax_args(w)
    ref = np.asarray(qmm_pallas(jnp.asarray(x), *ja, None, tile_n=128, tile_k=256,
                                compute_dtype=getattr(jnp, dtype), interpret=True, **jkw))
    ta, tkw = _torch_args(w)
    y = qmm(torch.from_numpy(x), *ta, None, compute_dtype=getattr(torch, dtype), **tkw)
    assert y.shape == (B, ref.shape[1]) and y.dtype == torch.float32
    rel = np.linalg.norm(y.numpy() - ref) / np.linalg.norm(ref)
    # f32: same math, summation order only.  bf16: x, s and each dequantized
    # weight are rounded to bf16 at the same points in both, but XLA may
    # keep a bf16 product in higher precision before its f32 accumulation.
    assert rel < (1e-5 if dtype == "float32" else 1e-2), rel


def test_matmul_routing_counts():
    rng = np.random.default_rng(0)
    w = _superblock(rng, 256, 256)
    ta, _ = _torch_args(w)
    lin = QuantLinear(q=ta[0], s=ta[1], b=ta[2], d=torch.from_numpy(w["d"]),
                      dm=torch.from_numpy(w["dm"]), sb=8, packed=True)
    odd = QuantLinear(q=ta[0][:, :200].contiguous(), s=ta[1][:, :200].contiguous(),
                      b=ta[2][:, :200].contiguous(), d=torch.from_numpy(w["d"][:, :200]),
                      dm=torch.from_numpy(w["dm"][:, :200]), sb=8, packed=True)
    torch.manual_seed(0)
    dense = DenseLinear(w=torch.randn(256, 64))
    tqmm.reset_kernel_dispatch_stats()
    wf = tqmm.dequant_weight(lin, torch.float32)
    for rows, lin_, route in ((1, lin, "qgemv"), (5, lin, "qmm"), (64, lin, "qmm"),
                              (65, lin, "dequant_matmul"), (3, odd, "dequant_matmul"),
                              (4, dense, "dense")):
        before = tqmm.kernel_dispatch_stats().get(route, 0)
        x = torch.randn(1, rows, 256)
        y = tqmm.matmul(x, lin_, compute_dtype=torch.float32)
        assert tqmm.kernel_dispatch_stats()[route] == before + 1, (rows, route)
        assert y.shape == (1, rows, lin_.shape_in_out[1])
        if lin_ is lin:
            ref = x[0] @ wf
            torch.testing.assert_close(y[0], ref, rtol=1e-5,
                                       atol=1e-5 * ref.abs().max().item())
    assert tqmm.kernel_dispatch_stats() == {"qgemv": 1, "qmm": 2, "dequant_matmul": 2,
                                            "dense": 1}


# The main path's projection shapes (K, N) and group sizes: Llama-3-8B q4_k
# (G 32) with its lm_head, Qwen2.5-0.5B q8_0 (G 32), and the G 16 k-quants.
GEOMETRY_SHAPES = [(4096, 4096, 32), (4096, 1024, 32), (4096, 14336, 32), (14336, 4096, 32),
                   (4096, 128256, 32), (896, 896, 32), (896, 128, 32), (896, 4864, 32),
                   (4864, 896, 32), (4096, 4096, 16), (512, 400, 16), (544, 128, 32)]
MAX_GRID_Y = 65535


@pytest.mark.parametrize("rows", [1, 8, 64])
@pytest.mark.parametrize("K,N,G", GEOMETRY_SHAPES)
def test_qmm_geometry(K, N, G, rows):
    """K2's split-K factor at 132 SMs: a power of two within the cluster
    limit of 8, every split owns at least one 128-deep K tile, and the grid
    fits gridDim."""
    from chatllm_tpu_torch.ops.cuda import qmm_kernel as k2

    splits = k2.qmm_splits(K, N, rows, 132)
    n_kt = -(-K // k2.TK)
    assert 1 <= splits <= k2.MAX_SPLITS and splits & (splits - 1) == 0
    assert all((s + 1) * n_kt // splits > s * n_kt // splits for s in range(splits))
    assert k2.qmm_tile_n(rows, N) in (128, 256)
    assert -(-N // k2.qmm_tile_n(rows, N)) < 2 ** 31 and splits <= MAX_GRID_Y


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("K,N,G", GEOMETRY_SHAPES)
def test_gemv_geometry(K, N, G, packed):
    """K1's (column lanes, splits) at 132 SMs: lanes the kernel takes, a
    power-of-two split count within the cluster limit, every split owns at
    least one unit (8 byte rows of a group), and the grid fits gridDim."""
    from chatllm_tpu_torch.ops.cuda import gemv_kernel as k1

    cl, splits = k1.gemv_geometry(K, N, G, packed, 132)
    units = K // G * (G // 2 if packed else G) // k1.UNIT_ROWS
    assert cl in k1.CL_LANES and k1.THREADS % cl == 0
    assert 1 <= splits <= k1.MAX_SPLITS and splits & (splits - 1) == 0
    assert all((s + 1) * units // splits > s * units // splits for s in range(splits))
    assert -(-N // (k1.CPT * cl)) < 2 ** 31 and splits <= MAX_GRID_Y


@pytest.mark.parametrize("rows", [1, 8, 64])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("K,N,G", GEOMETRY_SHAPES)
def test_qmm_decode_geometry(K, N, G, packed, rows):
    """K5's split-K factor at 132 SMs, bf16 and f32 x: within the portable
    cluster limit of 8, every split owns at least one 128-deep K tile, the
    blocks fit the SMs in one wave (as many as their shared memory lets
    one SM hold, at most two) unless one split per column tile already
    exceeds them, the block's shared memory fits an SM, and the grid fits
    gridDim."""
    from chatllm_tpu_torch.ops.cuda import qmm_decode as k5

    for x_bytes in (2, 4):
        smem = k5.qmm_decode_smem(rows, packed, G, x_bytes)
        per_sm = min(2, k5.SM_SMEM // (smem + 1024))
        splits = k5.qmm_decode_splits(K, N, rows, 132, packed=packed, group=G, x_bytes=x_bytes)
        n_kt = -(-K // k5.TK)
        n_tiles = -(-N // k5.TN)
        assert smem <= 227 * 1024 and per_sm >= 1
        assert 1 <= splits <= k5.MAX_SPLITS == 8
        assert all((s + 1) * n_kt // splits > s * n_kt // splits for s in range(splits))
        assert splits == 1 or n_tiles * splits <= per_sm * 132
        assert n_tiles < 2 ** 31 and splits <= MAX_GRID_Y


@pytest.mark.parametrize("rows,packed,G,x_bytes,splits", [
    (8, True, 32, 2, {"q_o": 6, "k_v": 8, "gate_up": 2, "down": 6, "lm_head": 1}),
    (64, True, 32, 2, {"q_o": 6, "k_v": 8, "gate_up": 2, "down": 6}),
    (64, False, 32, 2, {"qwen_gate_up": 3, "qwen_down": 8})])
def test_qmm_decode_splits_at_model_shapes(rows, packed, G, x_bytes, splits):
    """The split factors of the Llama-3-8B projections (q4_k) and of two
    Qwen2.5-0.5B ones (q8_0, whose block at 64 rows takes a whole SM's
    shared memory) on 132 SMs, pinned: chip_smoke times K5 at these
    shapes, and a change of the rule changes those times."""
    from chatllm_tpu_torch.ops.cuda import qmm_decode as k5

    shapes = {"q_o": (4096, 4096), "k_v": (4096, 1024), "gate_up": (4096, 14336),
              "down": (14336, 4096), "lm_head": (4096, 128256),
              "qwen_gate_up": (896, 4864), "qwen_down": (4864, 896)}
    got = {name: k5.qmm_decode_splits(*shapes[name], rows, 132, packed=packed, group=G,
                                      x_bytes=x_bytes) for name in splits}
    assert got == splits
