"""K1: fused dequant GEMV for single-row decode (csrc/qgemv.cu).

Replaces chatllm_tpu/ops/pallas/gemv_kernel.py::qgemv_pallas.  `qgemv`
launches the CUDA kernel for CUDA tensors and runs `qgemv_plain`, its plain
PyTorch version, for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from ..qmm import dequant_arrays
from .build import QGEMV, num_sms, ptr, stream_ptr
from .checks import check_weight, elem_kind, scale_kind

THREADS = 256         # threads per block (csrc/qgemv.cu)
CPT = 16              # columns per thread
CL_LANES = (32, 16, 8)   # column lanes per block the kernel takes, widest first
MAX_SPLITS = 8        # blocks per thread-block cluster (the portable limit)
UNIT_ROWS = 8         # byte rows of one group per unit of a thread's work


def qgemv_plain(x, q, s, b=None, bias=None, *, group: int = 32,
                packed: bool = False, zero_point: int = 0, d=None, dm=None,
                sb: int = 0) -> torch.Tensor:
    """Same function in plain PyTorch: f32 dequant, f32 product."""
    w = dequant_arrays(q, s, b, group=group, packed=packed,
                       zero_point=zero_point, d=d, dm=dm, sb=sb)
    y = x.float().reshape(1, -1) @ w
    if bias is not None:
        y = y + bias.float()
    return y


def gemv_geometry(K: int, N: int, group: int, packed: bool, sms: int) -> tuple[int, int]:
    """(column lanes per block, splits) for csrc/qgemv.cu.  A block of 256
    threads is `cl` column lanes (16 columns each) by 256 / cl unit lanes; a
    unit is 8 byte rows of one group.  The splits of a column tile form one
    cluster along K: a power of two up to 8, and no more than it takes to
    give every thread one unit.  For the widest tile no wider than N first,
    the fewest splits that make two blocks per SM (the kernel's occupancy)
    win; failing that everywhere, the tile and splits with the most blocks."""
    units = (K // group) * ((group // 2 if packed else group) // UNIT_ROWS)
    best = None
    for cl in CL_LANES:
        if CPT * cl > N and cl > CL_LANES[-1]:
            continue                  # a narrower tile covers N with no idle lanes
        tiles = math.ceil(N / (CPT * cl))
        cap = 1 << (min(MAX_SPLITS, math.ceil(units / (THREADS // cl))).bit_length() - 1)
        splits = min(cap, 1 << (math.ceil(2 * sms / tiles) - 1).bit_length())
        if tiles * splits >= 2 * sms:
            return cl, splits
        if best is None or tiles * splits > best[0]:
            best = (tiles * splits, cl, splits)
    return best[1], best[2]


def qgemv(x, q, s, b=None, bias=None, *, group: int = 32, packed: bool = False,
          zero_point: int = 0, d=None, dm=None, sb: int = 0) -> torch.Tensor:
    """x: [1, K] float; q: int8 [K, N] | packed uint8 [K/2, N]; s/b: [K/G, N]
    (f16/f32 classic, int8 sc/m with f16 d/dm [K/(G*sb), N] when sb > 0);
    bias: f32 [N].  Returns [1, N] f32."""
    if not x.is_cuda:
        return qgemv_plain(x, q, s, b, bias, group=group, packed=packed,
                           zero_point=zero_point, d=d, dm=dm, sb=sb)
    if x.dim() != 2 or x.shape[0] != 1:
        raise ValueError(f"qgemv takes one row, got x {tuple(x.shape)}")
    K = x.shape[1]
    N = q.shape[1]
    check_weight(x.device, q, s, b, d, dm, bias, K=K, group=group,
                 packed=packed, sb=sb)
    xf = x.reshape(K)
    if xf.dtype not in (torch.bfloat16, torch.float32):
        xf = xf.float()
    xf = xf.contiguous()
    if xf.data_ptr() % 16:                 # the kernel reads x in 16-byte vectors
        xf = xf.clone()
    y = torch.empty(N, dtype=torch.float32, device=x.device)
    cl, n_splits = gemv_geometry(K, N, group, packed, num_sms(x.device))
    QGEMV.launch(ptr(xf), elem_kind(xf), ptr(q), ptr(s), ptr(b), ptr(d), ptr(dm), ptr(bias),
                 ptr(y), K, N, group, sb, int(packed), zero_point, scale_kind(s, sb),
                 cl, n_splits, stream_ptr(x.device))
    return y.reshape(1, N)
