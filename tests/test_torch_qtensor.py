"""The port's load-time repack (chatllm_tpu_torch.ops.qtensor) is bit-exact
against the JAX package's, and so is its full-weight dequant, for every ggml
format the repack takes."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax.numpy as jnp

from chatllm_tpu.ggmm.quants import GGMLType, nbytes_for, quantize
from chatllm_tpu.ops import qmm as jqmm
from chatllm_tpu.ops import qtensor as jqt
from chatllm_tpu_torch.ops import qmm as tqmm
from chatllm_tpu_torch.ops import qtensor as tqt

SHAPE = (64, 512)          # [out, in]; in % 256 == 0 takes the superblock path

# byte offsets of each block's f16 scale fields (kept finite in random blocks)
_F16_FIELDS = {GGMLType.Q5_0: (22, [0]), GGMLType.Q5_1: (24, [0, 2]),
               GGMLType.Q5_K: (176, [0, 2]), GGMLType.Q6_K: (210, [208]),
               GGMLType.Q2_K: (84, [80, 82])}


def _raw(t: GGMLType, shape=SHAPE) -> np.ndarray:
    """Encoded weights: quantized with the codec where the package has an
    encoder, else random blocks with finite f16 scales."""
    rng = np.random.default_rng(int(t))
    if t in _F16_FIELDS:
        bb, offs = _F16_FIELDS[t]
        raw = rng.integers(0, 256, nbytes_for(t, shape[0] * shape[1]),
                           dtype=np.uint8).reshape(-1, bb)
        for o in offs:
            raw[:, o:o + 2] = (rng.random((raw.shape[0], 1)) * 0.01 + 1e-4) \
                .astype(np.float16).view(np.uint8)
        return raw.reshape(-1)
    x = rng.standard_normal(shape).astype(np.float32) * 0.3
    return np.frombuffer(quantize(x, t), dtype=np.uint8)


FORMATS = [GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0,
           GGMLType.Q5_1, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K,
           GGMLType.Q2_K]


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


@pytest.mark.parametrize("t", FORMATS, ids=lambda t: t.name)
def test_repack_bit_exact(t):
    raw = _raw(t)
    j = jqt.linear_from_ggml(raw, t, SHAPE)
    p = tqt.linear_from_ggml(raw, t, SHAPE, device="cpu")
    assert isinstance(p, tqt.QuantLinear)
    for f in ("group_size", "packed", "zero_point", "sb"):
        assert getattr(p, f) == getattr(j, f), f
    for f in ("q", "s", "b", "d", "dm"):
        ja, pa = getattr(j, f), getattr(p, f)
        assert (ja is None) == (pa is None), f
        if ja is None:
            continue
        ja = np.asarray(ja)
        pa = pa.numpy()
        assert pa.dtype == ja.dtype and pa.shape == ja.shape, f
        np.testing.assert_array_equal(_bits(pa), _bits(ja), err_msg=f)


@pytest.mark.parametrize("t", FORMATS, ids=lambda t: t.name)
def test_dequant_bit_exact(t):
    raw = _raw(t)
    wj = np.asarray(jqmm.dequant_weight(jqt.linear_from_ggml(raw, t, SHAPE),
                                        jnp.float32))
    wp = tqmm.dequant_weight(tqt.linear_from_ggml(raw, t, SHAPE, device="cpu"),
                             torch.float32).numpy()
    np.testing.assert_array_equal(_bits(wp), _bits(wj))


@pytest.mark.parametrize("t", [GGMLType.F32, GGMLType.F16], ids=lambda t: t.name)
def test_dense_formats_load_dense(t):
    x = np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)
    raw = np.frombuffer(quantize(x, t), dtype=np.uint8)
    j = jqt.linear_from_ggml(raw, t, SHAPE)
    p = tqt.linear_from_ggml(raw, t, SHAPE, device="cpu")
    assert isinstance(p, tqt.DenseLinear)
    np.testing.assert_array_equal(p.w.numpy(), np.asarray(j.w))
