"""Device resolution for the port's entry points.

The port runs on the card.  The CPU is used only when the caller asks for it
(`device="cpu"`, `--device cpu`) — the tests do — never as a silent
substitute for a missing card.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card (cuda:0).  Raises when CUDA is requested but
    unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) "
                "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """'bfloat16' | 'float32' | 'int8' (RuntimeConfig spellings) -> torch.dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}[name]
