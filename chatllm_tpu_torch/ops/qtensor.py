"""Linear-layer weight containers and the load-time repack.

At load time every ggml block format is repacked into the planar
"grouped-affine" layout the kernels read (same layout as the JAX package,
`chatllm_tpu/ops/qtensor.py`):

    q : int8  [in, out]          quantized values, output dim contiguous
                                 (uint8 [in/2, out] when nibble-packed)
    s : f16   [in // G, out]     per-group scale
    b : f16   [in // G, out]     per-group bias (None for symmetric formats)

with  w[i, o] = q[i, o] * s[i//G, o] + b[i//G, o].  The k-quants use the
superblock variant (int8 sc/m per group, f16 d/dmin per 256-row
superblock, s = d*sc and b = -dmin*m composed inside the kernels).

The numpy repackers below are copies of the JAX package's; the containers
hold torch tensors on the model's device.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, fields, replace
from typing import Optional

import numpy as np
import torch

from ..ggmm.quants import QK, QK_K, GGMLType, _f16, _k4_scale_min


@dataclass
class DenseLinear:
    """A dense (bf16/f32) linear layer; w is [in, out] so y = x @ w."""
    w: torch.Tensor
    bias: Optional[torch.Tensor] = None

    @property
    def shape_in_out(self):
        return tuple(self.w.shape)

    def to(self, device) -> "DenseLinear":
        return _to(self, device)


@dataclass
class QuantLinear:
    """Grouped-affine quantized linear layer (planar layout, see module doc).

    When `packed` is set, q is uint8 [in/2, out] with GROUP-LOCAL row
    pairing: byte row j of group g holds rows (G*g + j, G*g + j + G/2) in
    its (low, high) nibbles; packed values are unsigned and `zero_point`
    is subtracted before scaling.  `sb` > 0 selects the k-quant superblock
    layout (sb groups per superblock; s/b are then int8 sc/m and d/dm the
    f16 superblock scales)."""
    q: torch.Tensor                        # int8 [in, out] | uint8 [in/2, out]
    s: torch.Tensor                        # f16/f32 [in//G, out]; int8 sc when sb>0
    b: Optional[torch.Tensor] = None       # f16/f32 [in//G, out]; int8 m when sb>0
    bias: Optional[torch.Tensor] = None    # f32 [out]
    group_size: int = 32
    packed: bool = False
    zero_point: int = 0
    d: Optional[torch.Tensor] = None       # f16 [in//(G*sb), out]
    dm: Optional[torch.Tensor] = None      # f16 [in//(G*sb), out]
    sb: int = 0

    @property
    def shape_in_out(self):
        cin = self.q.shape[0] * (2 if self.packed else 1)
        return (cin, self.q.shape[1])

    def to(self, device) -> "QuantLinear":
        return _to(self, device)


def _to(lin, device):
    return replace(lin, **{f.name: getattr(lin, f.name).to(device)
                           for f in fields(lin)
                           if isinstance(getattr(lin, f.name), torch.Tensor)})


def _nibbles(qs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return (qs & 0xF), (qs >> 4)


def repack_quantized(data, t: GGMLType, shape) -> tuple[np.ndarray, np.ndarray, np.ndarray | None, int]:
    """Repack raw ggml block bytes into the *transposed* planar layout:
    (q int8 [in, out], s f32 [in//G, out], b|None, G).

    `shape` is the logical numpy-order shape of the stored tensor, [out, in];
    groups run along its last (in) axis.  Reconstruction q*s+b matches
    chatllm_tpu.ggmm.quants.dequantize bit-for-bit in f32.
    """
    t = GGMLType(t)
    n = int(np.prod(shape))
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else data

    if t == GGMLType.Q8_0:
        raw = buf[: n // QK * 34].reshape(-1, 34)
        s = _f16(raw[:, 0:2])                                   # [nb,1]
        q = raw[:, 2:34].view(np.int8)
        G = 32
        b = None
    elif t == GGMLType.Q4_0:
        raw = buf[: n // QK * 18].reshape(-1, 18)
        s = _f16(raw[:, 0:2])
        lo, hi = _nibbles(raw[:, 2:18])
        q = (np.concatenate([lo, hi], axis=1).astype(np.int8) - 8)
        G = 32
        b = None
    elif t == GGMLType.Q4_1:
        raw = buf[: n // QK * 20].reshape(-1, 20)
        s = _f16(raw[:, 0:2])
        b = _f16(raw[:, 2:4])
        lo, hi = _nibbles(raw[:, 4:20])
        q = np.concatenate([lo, hi], axis=1).astype(np.int8)
        G = 32
    elif t == GGMLType.Q5_0:
        raw = buf[: n // QK * 22].reshape(-1, 22)
        s = _f16(raw[:, 0:2])
        qh = raw[:, 2:6].copy().view(np.uint32)
        lo, hi = _nibbles(raw[:, 6:22])
        shifts = np.arange(32, dtype=np.uint32)
        hb = ((qh >> shifts) & 1).astype(np.uint8)
        q = ((np.concatenate([lo, hi], axis=1) | (hb << 4)).astype(np.int16) - 16).astype(np.int8)
        G = 32
        b = None
    elif t == GGMLType.Q5_1:
        raw = buf[: n // QK * 24].reshape(-1, 24)
        s = _f16(raw[:, 0:2])
        b = _f16(raw[:, 2:4])
        qh = raw[:, 4:8].copy().view(np.uint32)
        lo, hi = _nibbles(raw[:, 8:24])
        shifts = np.arange(32, dtype=np.uint32)
        hb = ((qh >> shifts) & 1).astype(np.uint8)
        q = (np.concatenate([lo, hi], axis=1) | (hb << 4)).astype(np.int8)
        G = 32
    elif t == GGMLType.Q4_K:
        nb = n // QK_K
        raw = buf[: nb * 144].reshape(nb, 144)
        d = _f16(raw[:, 0:2])
        dmin = _f16(raw[:, 2:4])
        sc, m = _k4_scale_min(raw[:, 4:16])                     # [nb,8]
        qs = raw[:, 16:144].reshape(nb, 4, 32)
        lo, hi = _nibbles(qs)
        q = np.stack([lo, hi], axis=2).reshape(nb, 8, 32).astype(np.int8)
        s = (d * sc.astype(np.float32)).reshape(nb, 8, 1)       # per-32 scale
        b = (-(dmin * m.astype(np.float32))).reshape(nb, 8, 1)
        s = np.broadcast_to(s, (nb, 8, 1)).reshape(nb * 8, 1)
        b = np.broadcast_to(b, (nb, 8, 1)).reshape(nb * 8, 1)
        q = q.reshape(nb * 8, 32)
        G = 32
    elif t == GGMLType.Q5_K:
        nb = n // QK_K
        raw = buf[: nb * 176].reshape(nb, 176)
        d = _f16(raw[:, 0:2])
        dmin = _f16(raw[:, 2:4])
        sc, m = _k4_scale_min(raw[:, 4:16])
        qh = raw[:, 16:48]
        qs = raw[:, 48:176].reshape(nb, 4, 32)
        lo, hi = _nibbles(qs)
        bits = np.arange(4, dtype=np.uint8)
        hlo = ((qh[:, None, :] >> (2 * bits)[None, :, None]) & 1).astype(np.uint8)
        hhi = ((qh[:, None, :] >> (2 * bits + 1)[None, :, None]) & 1).astype(np.uint8)
        q = np.stack([lo + (hlo << 4), hi + (hhi << 4)], axis=2).reshape(nb, 8, 32).astype(np.int8)
        s = (d * sc.astype(np.float32)).reshape(nb * 8, 1)
        b = (-(dmin * m.astype(np.float32))).reshape(nb * 8, 1)
        q = q.reshape(nb * 8, 32)
        G = 32
    elif t == GGMLType.Q6_K:
        nb = n // QK_K
        raw = buf[: nb * 210].reshape(nb, 210)
        ql = raw[:, 0:128].reshape(nb, 2, 64)
        qh = raw[:, 128:192].reshape(nb, 2, 32)
        sc = raw[:, 192:208].view(np.int8).reshape(nb, 16).astype(np.float32)
        d = _f16(raw[:, 208:210])
        l0, l1 = ql[:, :, :32], ql[:, :, 32:]
        q1 = ((l0 & 0xF) | (((qh >> 0) & 3) << 4)).astype(np.int8) - 32
        q2 = ((l1 & 0xF) | (((qh >> 2) & 3) << 4)).astype(np.int8) - 32
        q3 = ((l0 >> 4) | (((qh >> 4) & 3) << 4)).astype(np.int8) - 32
        q4 = ((l1 >> 4) | (((qh >> 6) & 3) << 4)).astype(np.int8) - 32
        q = np.concatenate([q1, q2, q3, q4], axis=2).reshape(nb, QK_K).astype(np.int8)
        s = (d * sc).reshape(nb * 16, 1)                        # per-16 scale
        q = q.reshape(nb * 16, 16)
        b = None
        G = 16
    elif t == GGMLType.Q2_K:
        nb = n // QK_K
        raw = buf[: nb * 84].reshape(nb, 84)
        scales = raw[:, 0:16]
        qs = raw[:, 16:80].reshape(nb, 2, 32)
        d = _f16(raw[:, 80:82])
        dmin = _f16(raw[:, 82:84])
        sc = (scales & 0xF).astype(np.float32)
        mn = (scales >> 4).astype(np.float32)
        shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
        q = ((qs[:, :, None, :] >> shifts[None, None, :, None]) & 3).reshape(nb, 16, 16).astype(np.int8)
        s = (d * sc).reshape(nb * 16, 1)
        b = (-(dmin * mn)).reshape(nb * 16, 1)
        q = q.reshape(nb * 16, 16)
        G = 16
    else:
        raise NotImplementedError(f"repack for {t}")

    out_shape = tuple(shape)
    g_shape = out_shape[:-1] + (out_shape[-1] // G,)
    # transpose [out, in] -> [in, out] (and [out, in//G] -> [in//G, out])
    q = np.ascontiguousarray(np.moveaxis(q.reshape(out_shape), -1, -2))
    s = np.ascontiguousarray(np.moveaxis(
        s.reshape(-1).reshape(g_shape).astype(np.float32), -1, -2))
    if b is not None:
        b = np.ascontiguousarray(np.moveaxis(
            b.reshape(-1).reshape(g_shape).astype(np.float32), -1, -2))
    return q, s, b, G


_QUANT_TYPES = {
    GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
    GGMLType.Q2_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K,
}

# formats whose values fit 4 unsigned bits after zero-point folding
_PACKABLE = {GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q4_K, GGMLType.Q2_K}


def pack_nibbles(q: np.ndarray, G: int):
    """Pack int8 values with 4-bit range into uint8 pairs.

    q: [K, N] int8 → (packed uint8 [K/2, N], zero_point) with
    value = nibble - zero_point."""
    K, N = q.shape
    qf = q.astype(np.int16)
    zero = max(0, -int(qf.min()))
    assert qf.max() + zero <= 15, "values exceed 4-bit range"
    u = (qf + zero).astype(np.uint8)
    half = G // 2
    ug = u.reshape(K // G, G, N)
    packed = (ug[:, :half, :] | (ug[:, half:, :] << 4)).reshape(K // 2, N)
    return packed, zero


def repack_q4_k_super(data, shape):
    """Repack raw q4_k blocks into the SUPERBLOCK planar layout:

    (q uint8 [in/2, out] nibble-packed, sc int8 [in/32, out],
     m int8 [in/32, out], d f16 [in/256, out], dmin f16 [in/256, out])

    with w = d*sc*qv - dmin*m exactly as ggml's dequantize_row_q4_K
    (reference ggml/src/ggml-quants.c) — the f16 d/dmin and the 6-bit sc/m
    are stored verbatim, so the kernel-side f32 product d*sc is bit-identical
    to ggml's, unlike the classic layout's f16-rounded s = f16(d*sc)."""
    n = int(np.prod(shape))
    buf = (np.frombuffer(data, dtype=np.uint8)
           if isinstance(data, (bytes, bytearray, memoryview)) else data)
    nb = n // QK_K
    raw = buf[: nb * 144].reshape(nb, 144)
    d = raw[:, 0:2].copy().view(np.float16)                 # [nb, 1]
    dmin = raw[:, 2:4].copy().view(np.float16)
    sc, m = _k4_scale_min(raw[:, 4:16])                     # [nb, 8] uint8
    qs = raw[:, 16:144].reshape(nb, 4, 32)
    lo, hi = _nibbles(qs)
    q = np.stack([lo, hi], axis=2).reshape(nb, 8, 32).astype(np.int8)

    out_shape = tuple(shape)                                # [out, in]
    g_shape = out_shape[:-1] + (out_shape[-1] // 32,)
    sb_shape = out_shape[:-1] + (out_shape[-1] // QK_K,)
    q = np.ascontiguousarray(np.moveaxis(q.reshape(out_shape), -1, -2))
    sc = np.ascontiguousarray(np.moveaxis(
        sc.reshape(g_shape).astype(np.int8), -1, -2))
    m = np.ascontiguousarray(np.moveaxis(
        m.reshape(g_shape).astype(np.int8), -1, -2))
    d = np.ascontiguousarray(np.moveaxis(d.reshape(sb_shape), -1, -2))
    dmin = np.ascontiguousarray(np.moveaxis(dmin.reshape(sb_shape), -1, -2))
    qp, zero = pack_nibbles(q, 32)
    assert zero == 0
    return qp, sc, m, d, dmin


def repack_q5_k_super(data, shape):
    """q5_k -> superblock layout: (q int8 [in,out] 0..31 unpacked,
    sc int8, m int8 [in/32,out], d f16, dmin f16 [in/256,out])."""
    n = int(np.prod(shape))
    buf = (np.frombuffer(data, dtype=np.uint8)
           if isinstance(data, (bytes, bytearray, memoryview)) else data)
    nb = n // QK_K
    raw = buf[: nb * 176].reshape(nb, 176)
    d = raw[:, 0:2].copy().view(np.float16)
    dmin = raw[:, 2:4].copy().view(np.float16)
    sc, m = _k4_scale_min(raw[:, 4:16])
    qh = raw[:, 16:48]
    qs = raw[:, 48:176].reshape(nb, 4, 32)
    lo, hi = _nibbles(qs)
    bits = np.arange(4, dtype=np.uint8)
    hlo = ((qh[:, None, :] >> (2 * bits)[None, :, None]) & 1).astype(np.uint8)
    hhi = ((qh[:, None, :] >> (2 * bits + 1)[None, :, None]) & 1).astype(np.uint8)
    q = np.stack([lo + (hlo << 4), hi + (hhi << 4)],
                 axis=2).reshape(nb, QK_K).astype(np.int8)

    out_shape = tuple(shape)
    g_shape = out_shape[:-1] + (out_shape[-1] // 32,)
    sb_shape = out_shape[:-1] + (out_shape[-1] // QK_K,)
    q = np.ascontiguousarray(np.moveaxis(q.reshape(out_shape), -1, -2))
    sc = np.ascontiguousarray(np.moveaxis(
        sc.reshape(g_shape).astype(np.int8), -1, -2))
    m = np.ascontiguousarray(np.moveaxis(
        m.reshape(g_shape).astype(np.int8), -1, -2))
    d = np.ascontiguousarray(np.moveaxis(d.reshape(sb_shape), -1, -2))
    dmin = np.ascontiguousarray(np.moveaxis(dmin.reshape(sb_shape), -1, -2))
    return q, sc, m, d, dmin


def repack_q2_k_super(data, shape):
    """q2_k -> superblock layout: (q int8 [in,out] 0..3 unpacked, sc int8
    [in/16,out] 0..15, m int8 [in/16,out] 0..15, d f16, dmin f16
    [in/256,out])."""
    n = int(np.prod(shape))
    buf = (np.frombuffer(data, dtype=np.uint8)
           if isinstance(data, (bytes, bytearray, memoryview)) else data)
    nb = n // QK_K
    raw = buf[: nb * 84].reshape(nb, 84)
    scales = raw[:, 0:16]
    qs = raw[:, 16:80].reshape(nb, 2, 32)
    d = raw[:, 80:82].copy().view(np.float16)
    dmin = raw[:, 82:84].copy().view(np.float16)
    sc = (scales & 0xF).astype(np.int8)                     # [nb, 16]
    mn = (scales >> 4).astype(np.int8)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    q = ((qs[:, :, None, :] >> shifts[None, None, :, None]) & 3) \
        .reshape(nb, QK_K).astype(np.int8)

    out_shape = tuple(shape)
    g_shape = out_shape[:-1] + (out_shape[-1] // 16,)
    sb_shape = out_shape[:-1] + (out_shape[-1] // QK_K,)
    q = np.ascontiguousarray(np.moveaxis(q.reshape(out_shape), -1, -2))
    sc = np.ascontiguousarray(np.moveaxis(sc.reshape(g_shape), -1, -2))
    mn = np.ascontiguousarray(np.moveaxis(mn.reshape(g_shape), -1, -2))
    d = np.ascontiguousarray(np.moveaxis(d.reshape(sb_shape), -1, -2))
    dmin = np.ascontiguousarray(np.moveaxis(dmin.reshape(sb_shape), -1, -2))
    return q, sc, mn, d, dmin


def repack_q6_k_super(data, shape):
    """q6_k -> superblock layout: (q int8 [in,out] -32..31, sc int8
    [in/16,out] SIGNED, d f16 [in/256,out]); no min term."""
    n = int(np.prod(shape))
    buf = (np.frombuffer(data, dtype=np.uint8)
           if isinstance(data, (bytes, bytearray, memoryview)) else data)
    nb = n // QK_K
    raw = buf[: nb * 210].reshape(nb, 210)
    ql = raw[:, 0:128].reshape(nb, 2, 64)
    qh = raw[:, 128:192].reshape(nb, 2, 32)
    sc = raw[:, 192:208].copy().view(np.int8).reshape(nb, 16)
    d = raw[:, 208:210].copy().view(np.float16)
    l0, l1 = ql[:, :, :32], ql[:, :, 32:]
    q1 = ((l0 & 0xF) | (((qh >> 0) & 3) << 4)).astype(np.int8) - 32
    q2 = ((l1 & 0xF) | (((qh >> 2) & 3) << 4)).astype(np.int8) - 32
    q3 = ((l0 >> 4) | (((qh >> 4) & 3) << 4)).astype(np.int8) - 32
    q4 = ((l1 >> 4) | (((qh >> 6) & 3) << 4)).astype(np.int8) - 32
    q = np.concatenate([q1, q2, q3, q4], axis=2).reshape(nb, QK_K)

    out_shape = tuple(shape)
    g_shape = out_shape[:-1] + (out_shape[-1] // 16,)
    sb_shape = out_shape[:-1] + (out_shape[-1] // QK_K,)
    q = np.ascontiguousarray(np.moveaxis(
        q.astype(np.int8).reshape(out_shape), -1, -2))
    sc = np.ascontiguousarray(np.moveaxis(sc.reshape(g_shape), -1, -2))
    d = np.ascontiguousarray(np.moveaxis(d.reshape(sb_shape), -1, -2))
    return q, sc, d


def _superblock_enabled() -> bool:
    """CHATLLM_TPU_SB (read at load time, as the JAX package reads it): "0"
    repacks the k-quants into the classic layout instead of the superblock
    one."""
    return os.environ.get("CHATLLM_TPU_SB", "1") != "0"


def linear_from_ggml(raw, t: GGMLType, shape, *, bias: np.ndarray | None = None,
                     dequant_to: torch.dtype | None = None, device="cpu"):
    """Build a linear layer from a ggml tensor (`shape` in numpy order
    [out, in]).  With `dequant_to` set (or for non-quantized formats) the
    weight is dequantized at load; otherwise quantized formats keep the
    planar layout and run through the fused kernels."""
    from ..ggmm.quants import dequantize

    t = GGMLType(t)
    bias_t = (torch.as_tensor(np.asarray(bias, np.float32), device=device)
              if bias is not None else None)
    if dequant_to is not None or t not in _QUANT_TYPES:
        w = dequantize(raw, t, shape)
        dt = dequant_to or torch.float32
        return DenseLinear(
            w=torch.from_numpy(np.ascontiguousarray(w.T)).to(device=device, dtype=dt),
            bias=bias_t)

    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    if (len(shape) == 2 and shape[-1] % QK_K == 0 and _superblock_enabled()
            and t in (GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K,
                      GGMLType.Q2_K)):
        if t == GGMLType.Q4_K:
            qq, sc, m, d, dmin = repack_q4_k_super(raw, shape)
            G, packed = 32, True
        elif t == GGMLType.Q5_K:
            qq, sc, m, d, dmin = repack_q5_k_super(raw, shape)
            G, packed = 32, False
        elif t == GGMLType.Q2_K:
            qq, sc, m, d, dmin = repack_q2_k_super(raw, shape)
            qq, zero = pack_nibbles(qq, 16)
            assert zero == 0
            G, packed = 16, True
        else:                                      # Q6_K: symmetric, no min
            qq, sc, d = repack_q6_k_super(raw, shape)
            m = dmin = None
            G, packed = 16, False
        return QuantLinear(
            q=dev(qq), s=dev(sc), b=None if m is None else dev(m),
            bias=bias_t, group_size=G, packed=packed, zero_point=0,
            d=dev(d, torch.float16),
            dm=None if dmin is None else dev(dmin, torch.float16),
            sb=QK_K // G,
        )
    q, s, b, G = repack_quantized(raw, t, shape)
    packed = t in _PACKABLE and q.ndim == 2 and q.shape[0] % G == 0
    zero = 0
    if packed:
        q, zero = pack_nibbles(q, G)
    # Device scales are f16: bit-exact for q4_0/q4_1/q5_x/q8_0 (their native
    # scale IS f16) and within 1 f16 ulp for the k-quants' d*sc products.
    return QuantLinear(
        q=dev(q), s=dev(s.astype(np.float16)),
        b=None if b is None else dev(b.astype(np.float16)),
        bias=bias_t, group_size=G, packed=packed, zero_point=zero,
    )
