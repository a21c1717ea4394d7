"""Matmul over dense / grouped-affine quantized linear layers.

Counterpart of the JAX package's `ops/qmm.py`, with the same routing:

  - 1 row                      -> K1, the fused dequant GEMV
                                  (`ops/cuda/gemv_kernel.py::qgemv`);
  - 2..64 rows, N % 128 == 0   -> K2, the fused dequant GEMM
                                  (`ops/cuda/qmm_kernel.py::qmm`), or, with
                                  CHATLLM_TPU_QMM_V2=1 in the environment,
                                  K5, the pipelined one
                                  (`ops/cuda/qmm_decode.py::qmm_decode`);
  - otherwise                  -> dequantize the whole weight, then one
                                  torch.matmul (the JAX package leaves this
                                  to XLA outside any kernel).

The JAX package's switches, read at call time under its names:
  CHATLLM_TPU_QMM=0|1|auto     0 sends every quantized matmul to the
                               dequant path; 1 and auto (the default) take
                               the kernels, as auto takes Pallas on a TPU
  CHATLLM_TPU_QMM_MAX_ROWS=n   the kernels take up to n rows (default 64);
                               above 64, K2 runs on row blocks of 64 (the
                               Pallas kernel takes any row count; its rows
                               are independent)
  CHATLLM_TPU_GEMV=0           one row goes to K2 (or K5) instead of K1
  CHATLLM_TPU_QMM_V2=1         2..64 rows (and one row under GEMV=0) go to K5
The thresholds are the JAX package's, so both packages take the same paths;
re-tuning them on H100 measurements is separate work.  On CPU tensors each
kernel wrapper runs its plain PyTorch version (that is what the tests
compare); on CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import os

import torch

from .qtensor import DenseLinear, QuantLinear

# Number of calls per route (the JAX package counts per traced call site;
# eager PyTorch counts per call).  Read with `kernel_dispatch_stats()`.
KERNEL_DISPATCH: dict[str, int] = {}

MAX_KERNEL_ROWS = 64      # rows K2 and K5 take in one launch


def kernels_enabled() -> bool:
    """CHATLLM_TPU_QMM (JAX `use_pallas_qmm`): "0" turns the kernels off;
    "1" and auto turn them on (auto means the accelerator's kernels, here
    the card's, and their plain versions on CPU tensors)."""
    return os.environ.get("CHATLLM_TPU_QMM", "auto") != "0"


def kernel_max_rows() -> int:
    """CHATLLM_TPU_QMM_MAX_ROWS (JAX `_pallas_max_rows`), default 64."""
    return int(os.environ.get("CHATLLM_TPU_QMM_MAX_ROWS", "64"))


def _count(route: str):
    KERNEL_DISPATCH[route] = KERNEL_DISPATCH.get(route, 0) + 1


def kernel_dispatch_stats() -> dict:
    return dict(KERNEL_DISPATCH)


def reset_kernel_dispatch_stats():
    KERNEL_DISPATCH.clear()


def unpack_nibbles(q: torch.Tensor, group: int, zero: int = 0) -> torch.Tensor:
    """uint8 [K/2, N] (group-local row pairing) -> int-valued [K, N] f32."""
    k2, n = q.shape
    half = group // 2
    qg = q.reshape(k2 // half, half, n)
    u = torch.cat([qg & 0xF, qg >> 4], dim=1).reshape(k2 * 2, n)
    return u.float() - float(zero)


def effective_scales(s, b, d, dm, sb: int):
    """(s, b) as f32 [in/G, out], composing the superblock factorization
    (s = d*sc, b = -(dmin*m)) when sb > 0."""
    if not sb:
        return s.float(), None if b is None else b.float()
    s_eff = s.float() * d.float().repeat_interleave(sb, dim=0)
    b_eff = None
    if b is not None:
        b_eff = -(b.float() * dm.float().repeat_interleave(sb, dim=0))
    return s_eff, b_eff


def stored_values(q, group: int, packed: bool, zero_point: int) -> torch.Tensor:
    """The quantized values q - zero_point as f32 [in, out]."""
    if packed:
        return unpack_nibbles(q, group, zero_point)
    return q.float() - float(zero_point)


def dequant_arrays(q, s, b, *, group: int, packed: bool, zero_point: int,
                   d=None, dm=None, sb: int = 0, dtype=torch.float32):
    """Materialize the full weight [in, out] from the planar arrays."""
    qv = stored_values(q, group, packed, zero_point)
    cin, out = qv.shape
    s_eff, b_eff = effective_scales(s, b, d, dm, sb)
    w = qv.reshape(cin // group, group, out) * s_eff[:, None, :]
    if b_eff is not None:
        w = w + b_eff[:, None, :]
    return w.reshape(cin, out).to(dtype)


def dequant_weight(lin: QuantLinear, dtype=torch.bfloat16) -> torch.Tensor:
    return dequant_arrays(lin.q, lin.s, lin.b, group=lin.group_size,
                          packed=lin.packed, zero_point=lin.zero_point,
                          d=lin.d, dm=lin.dm, sb=lin.sb, dtype=dtype)


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] with f32 accumulation and an f32 result that is
    never rounded to the operands' dtype (the JAX package's
    `jnp.dot(..., preferred_element_type=float32)`).  A plain product of two
    bf16 tensors would round every output to bf16."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def matmul(x: torch.Tensor, lin, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ W (+ bias) in f32.  x: [..., in] -> [..., out]."""
    if isinstance(lin, DenseLinear):
        y = dot_f32(x.to(lin.w.dtype), lin.w)
        _count("dense")
    elif isinstance(lin, QuantLinear):
        rows = x.numel() // x.shape[-1]
        lead = x.shape[:-1]
        if kernels_enabled() and rows <= kernel_max_rows() and lin.q.shape[1] % 128 == 0:
            x2 = x.reshape(rows, x.shape[-1])
            kw = dict(group=lin.group_size, packed=lin.packed,
                      zero_point=lin.zero_point, d=lin.d, dm=lin.dm, sb=lin.sb)
            if rows == 1 and os.environ.get("CHATLLM_TPU_GEMV", "1") != "0":
                from .cuda.gemv_kernel import qgemv

                _count("qgemv")
                y = qgemv(x2, lin.q, lin.s, lin.b, lin.bias, **kw)
            elif rows <= MAX_KERNEL_ROWS and os.environ.get("CHATLLM_TPU_QMM_V2", "0") == "1":
                # opt-in, read at call time under the JAX package's name
                from .cuda.qmm_decode import qmm_decode

                _count("qmm_decode")
                y = qmm_decode(x2, lin.q, lin.s, lin.b, lin.bias,
                               compute_dtype=compute_dtype, **kw)
            else:
                from .cuda.qmm_kernel import qmm

                _count("qmm")
                parts = [qmm(x2[i:i + MAX_KERNEL_ROWS], lin.q, lin.s, lin.b, lin.bias,
                             compute_dtype=compute_dtype, **kw)
                         for i in range(0, rows, MAX_KERNEL_ROWS)]
                y = parts[0] if len(parts) == 1 else torch.cat(parts)
            return y.reshape(*lead, y.shape[-1])
        _count("dequant_matmul")
        w = dequant_weight(lin, compute_dtype)
        y = dot_f32(x.to(compute_dtype), w)
    else:
        raise TypeError(f"not a linear: {type(lin)}")
    if lin.bias is not None:
        y = y + lin.bias
    return y
