"""K5: pipelined fused dequant x matmul for batched decode, 1..64 rows
(csrc/qmm_decode.cu).

Replaces chatllm_tpu/ops/pallas/qmm_decode.py::qmm_decode_pallas.  Same
arguments and layouts as K2 (`qmm_kernel.qmm`), but the superblock affine
term is rounded into every bf16 weight instead of being added in f32 (so
its results differ from K2's in the last bf16 digits).  The kernel takes x
whole and pairs each byte row's low and high nibbles inside one mma step;
`split_lo_hi` states that pairing.  One launch per call: split-K runs over
a thread-block cluster (`qmm_decode_splits`), summed in shared memory.
`qmm_decode` launches the CUDA kernel for CUDA tensors and runs
`qmm_decode_plain`, its plain PyTorch version, for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from ..qmm import effective_scales, stored_values
from .build import QMM_DECODE, num_sms, ptr, stream_ptr
from .checks import check_weight, elem_kind, scale_kind
from .qmm_kernel import MAX_ROWS

# csrc/qmm_decode.cu's geometry
TK = 128              # K rows per pipeline stage
TN = 128              # columns per block
MAX_SPLITS = 8        # blocks per thread-block cluster (the portable limit)
SMEM_BUDGET = 110 * 1024   # 4 stages where they fit in it, else 3
SM_SMEM = 228 * 1024       # shared memory of one SM; 1 KB of it is reserved per block


def qmm_decode_smem(rows: int, packed: bool, group: int, x_bytes: int) -> int:
    """Dynamic shared memory of one block (csrc `Geom::SMEM`): the stages
    of raw weight, x and scale rows, or the K parts' partial tiles."""
    rows8 = 8 * (1 if rows <= 8 else 2 if rows <= 16 else 4 if rows <= 32 else 8)
    stage = ((TK // 2 if packed else TK) * (TN + 16) + rows8 * (TK * x_bytes + 16)
             + TK // group * 6 * TN)
    stages = 4 if SMEM_BUDGET // stage >= 4 else 3
    return max(stages * stage, 2 * rows8 * TN * 4)


def qmm_decode_splits(K: int, N: int, rows: int, sms: int, *, packed: bool,
                      group: int, x_bytes: int) -> int:
    """Split-K factor: the blocks of a column tile that share its 128-deep K
    tiles, one cluster along K.  About 3/4 of the blocks the SMs hold at
    once (two per SM where their shared memory fits, else one; fewer
    blocks than that leave SMs idle, a partial second wave or 2 K tiles
    per block cost more), at most MAX_SPLITS and never more splits than K
    tiles."""
    per_sm = min(2, SM_SMEM // (qmm_decode_smem(rows, packed, group, x_bytes) + 1024))
    want = int(0.75 * sms * per_sm / math.ceil(N / TN) + 0.5)
    return max(1, min(MAX_SPLITS, math.ceil(K / TK), want))


def split_lo_hi(x: torch.Tensor, group: int):
    """x [B, K] -> (x_lo, x_hi), each [B, K/group, group/2]: the first and
    the second half of every group of `group` columns (flattened over the
    last two axes, the K/2 columns of each half).  With the group-local
    nibble pairing (byte row j of group g = weight rows G*g + j and
    G*g + j + G/2) x_lo meets the low nibbles and x_hi the high ones, run
    for run: the pairing the kernel follows inside each mma step.  Both are
    views of x: nothing is copied."""
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
    xc = x.contiguous()
    if xc.data_ptr() % 16:                 # the kernel reads x in 16-byte vectors
        xc = xc.clone()
    y = torch.empty(M, N, dtype=torch.float32, device=x.device)
    n_splits = qmm_decode_splits(K, N, M, num_sms(x.device), packed=packed, group=group,
                                 x_bytes=xc.element_size())
    # the kernel takes the superblock min term only; a classic b is added below
    QMM_DECODE.launch(ptr(xc), elem_kind(xc), ptr(q), ptr(s), ptr(b) if sb else None,
                      ptr(d), ptr(dm) if sb else None, ptr(bias), ptr(y), M, K, N, group,
                      sb, int(packed), zero_point, scale_kind(s, sb), n_splits,
                      stream_ptr(x.device))
    if b is not None and not sb:
        y += _group_sum_affine(x, b, group)
    return y
