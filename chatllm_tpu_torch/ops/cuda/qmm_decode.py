"""K5: pipelined fused dequant x matmul for batched decode, 2..64 rows
(csrc/qmm_decode.cu).

Replaces chatllm_tpu/ops/pallas/qmm_decode.py::qmm_decode_pallas.  Same
arguments and layouts as K2 (`qmm_kernel.qmm`), but the activations are
split outside the kernel into the columns that meet the low and the high
nibbles of each group, the kernel keeps two weight slots in flight, and the
superblock affine term is rounded into every bf16 weight instead of being
added in f32 (so its results differ from K2's in the last bf16 digits).
`qmm_decode` launches the CUDA kernel for CUDA tensors and runs
`qmm_decode_plain`, its plain PyTorch version, for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from ..qmm import effective_scales, stored_values
from .build import QMM_DECODE, num_sms, ptr, stream_ptr
from .checks import check_weight, scale_kind
from .qmm_kernel import MAX_ROWS

TN = 64               # columns per block (csrc/qmm_decode.cu)
TK = 64               # K tile


def qmm_decode_splits(K: int, N: int, sms: int) -> int:
    """Split-K factor: enough blocks for two waves over the SMs, at least
    two K tiles per split."""
    n_tiles = math.ceil(N / TN)
    return max(1, min(math.ceil(2 * sms / n_tiles), math.ceil(K / TK) // 2))


def split_lo_hi(x: torch.Tensor, group: int):
    """x [B, K] -> (x_lo, x_hi), each [B, K/group, group/2]: the first and
    the second half of every group of `group` columns (flattened over the
    last two axes, the K/2 columns of each half).  With the group-local
    nibble pairing (byte row j of group g = weight rows G*g + j and
    G*g + j + G/2) x_lo meets the low nibbles and x_hi the high ones, run
    for run.  Both are views of x: nothing is copied."""
    B, K = x.shape
    halves = x.view(B, K // group, 2, group // 2)
    return halves[:, :, 0], halves[:, :, 1]


def _group_sum_affine(x, b, group: int):
    """The classic layouts' affine term: (group sums of x) @ b, in f32."""
    B, K = x.shape
    return x.float().reshape(B, K // group, group).sum(dim=2) @ b.float()


def qmm_decode_plain(x, q, s, b=None, bias=None, *, group: int = 32,
                     packed: bool = False, zero_point: int = 0, d=None, dm=None,
                     sb: int = 0, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Same function and rounding in plain PyTorch: s (and, for superblock
    layouts, bb = -(dmin*m)) are rounded to `compute_dtype`, every weight is
    formed in it as (q - zero_point) * s, then + bb, one rounding per step;
    x is rounded to it and the products accumulate in f32.  A classic affine
    term b is (group sums of x) @ b in f32."""
    cd = compute_dtype
    qv = stored_values(q, group, packed, zero_point).to(cd)
    cin, n = qv.shape
    s_eff, b_eff = effective_scales(s, b, d, dm, sb)
    w = qv.reshape(cin // group, group, n) * s_eff.to(cd)[:, None, :]
    if sb and b_eff is not None:
        w = w + b_eff.to(cd)[:, None, :]
    y = x.to(cd).float() @ w.reshape(cin, n).float()
    if bias is not None:
        y = y + bias.float()
    if b is not None and not sb:
        y = y + _group_sum_affine(x, b, group)
    return y


def qmm_decode(x, q, s, b=None, bias=None, *, group: int = 32, packed: bool = False,
               zero_point: int = 0, d=None, dm=None, sb: int = 0,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x: [B, K] float, B <= 64; weight arrays as in `qgemv`.  Returns
    [B, N] f32.  The CUDA kernel computes in bf16 only; the plain version
    takes any compute dtype."""
    if not x.is_cuda:
        return qmm_decode_plain(x, q, s, b, bias, group=group, packed=packed,
                                zero_point=zero_point, d=d, dm=dm, sb=sb,
                                compute_dtype=compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise TypeError(f"qmm_decode: the CUDA kernel computes in bfloat16, not {compute_dtype}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"qmm_decode takes 1..{MAX_ROWS} rows, got x {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qmm_decode: x dtype {x.dtype}")
    M, K = x.shape
    N = q.shape[1]
    check_weight(x.device, q, s, b, d, dm, bias, K=K, group=group,
                 packed=packed, sb=sb)
    xc = x.to(torch.bfloat16)
    if xc.data_ptr() % 16:                 # cp.async moves 16 aligned bytes
        xc = xc.clone()
    xc = xc.contiguous()
    # x_lo, x_hi [M, runs, run]: views of x when packed, x itself otherwise
    x_lo, x_hi = split_lo_hi(xc, group) if packed else (xc.view(M, 1, K),) * 2
    y = torch.empty(M, N, dtype=torch.float32, device=x.device)
    n_splits = qmm_decode_splits(K, N, num_sms(x.device))
    part = (torch.empty(n_splits * M * N, dtype=torch.float32, device=x.device)
            if n_splits > 1 else None)
    # the kernel takes the superblock min term only; a classic b is added below
    QMM_DECODE.launch(ptr(x_lo), ptr(x_hi), x_lo.stride(0), x_lo.shape[1] * x_lo.shape[2],
                      x_lo.shape[2], x_lo.stride(1), ptr(q), ptr(s),
                      ptr(b) if sb else None, ptr(d), ptr(dm) if sb else None,
                      ptr(bias), ptr(part), ptr(y), M, K, N, group, sb, int(packed),
                      zero_point, scale_kind(s, sb), n_splits, stream_ptr(x.device))
    if b is not None and not sb:
        y += _group_sum_affine(x, b, group)
    return y
