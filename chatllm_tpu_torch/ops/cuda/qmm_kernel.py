"""K2: fused dequant x matmul for 2..64 rows (csrc/qmm.cu).

Replaces chatllm_tpu/ops/pallas/qmm_kernel.py::qmm_pallas.  `qmm` launches
the CUDA kernel for CUDA tensors and runs `qmm_plain`, its plain PyTorch
version, for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from ..qmm import effective_scales, stored_values
from .build import QMM, num_sms, ptr, stream_ptr
from .checks import check_weight, elem_kind, scale_kind

TK = 128              # K rows per pipeline stage
MAX_ROWS = 64
MAX_SPLITS = 8        # blocks per thread-block cluster (the portable limit)
WIDE_N = 4096         # N from which more than 16 rows take 256-column tiles


def qmm_plain(x, q, s, b=None, bias=None, *, group: int = 32,
              packed: bool = False, zero_point: int = 0, d=None, dm=None,
              sb: int = 0, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Same function and rounding in plain PyTorch: the weight is
    dequantized as q * s_eff with s_eff rounded to `compute_dtype` and the
    product rounded to it too, x is rounded to it, products accumulate in
    f32; the affine term is (group sums of x) @ b_eff in f32."""
    B, K = x.shape
    qv = stored_values(q, group, packed, zero_point)
    s_eff, b_eff = effective_scales(s, b, d, dm, sb)
    cin, n = qv.shape
    s_c = s_eff.to(compute_dtype).float()
    w = (qv.reshape(cin // group, group, n) * s_c[:, None, :]).reshape(cin, n)
    w = w.to(compute_dtype).float()
    y = x.to(compute_dtype).float() @ w
    if b_eff is not None:
        xg = x.float().reshape(B, K // group, group).sum(dim=2)
        y = y + xg @ b_eff
    if bias is not None:
        y = y + bias.float()
    return y


def qmm_tile_n(rows: int, N: int) -> int:
    """Columns per block of csrc/qmm.cu: 256 above 16 rows when N is wide
    (half the copies of x and of the scale rows per weight byte), else 128
    (more blocks for a narrow N)."""
    return 256 if rows > 16 and N >= WIDE_N else 128


def qmm_splits(K: int, N: int, rows: int, sms: int) -> int:
    """Split-K factor of csrc/qmm.cu: the blocks of a column tile that share
    its K tiles, one cluster along K.  A power of two up to 8, enough blocks
    for two per SM (the kernel's occupancy), never more splits than K tiles."""
    n_tiles = math.ceil(N / qmm_tile_n(rows, N))
    want = min(MAX_SPLITS, math.ceil(K / TK), math.ceil(2 * sms / n_tiles))
    return 1 << (max(1, want).bit_length() - 1)


def qmm(x, q, s, b=None, bias=None, *, group: int = 32, packed: bool = False,
        zero_point: int = 0, d=None, dm=None, sb: int = 0,
        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x: [B, K] float, B <= 64; weight arrays as in `qgemv`.  Returns
    [B, N] f32, accumulated in f32 from bf16 products.  The CUDA kernel
    computes in bf16 only (the JAX package's `matmul` never asks its Pallas
    kernel for another compute dtype); the plain version takes any."""
    if not x.is_cuda:
        return qmm_plain(x, q, s, b, bias, group=group, packed=packed,
                         zero_point=zero_point, d=d, dm=dm, sb=sb,
                         compute_dtype=compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise TypeError(f"qmm: the CUDA kernel computes in bfloat16, not {compute_dtype}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"qmm takes 1..{MAX_ROWS} rows, got x {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qmm: x dtype {x.dtype}")
    M, K = x.shape
    N = q.shape[1]
    check_weight(x.device, q, s, b, d, dm, bias, K=K, group=group,
                 packed=packed, sb=sb)
    xc = x.contiguous()
    if xc.data_ptr() % 16:                 # the kernel reads x in 16-byte vectors
        xc = xc.clone()
    y = torch.empty(M, N, dtype=torch.float32, device=x.device)
    n_splits = qmm_splits(K, N, M, num_sms(x.device))
    QMM.launch(ptr(xc), elem_kind(xc), ptr(q), ptr(s), ptr(b), ptr(d), ptr(dm),
               ptr(bias), ptr(y), M, K, N, group, sb, int(packed),
               zero_point, scale_kind(s, sb), qmm_tile_n(M, N), n_splits, stream_ptr(x.device))
    return y
