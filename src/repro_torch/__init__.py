"""PyTorch / CUDA port of the ``repro`` package, for an NVIDIA H100.

The JAX package under ``src/repro`` is the reference; this package imports
nothing of it (nor JAX).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; with no GPU present and the CPU not asked for,
they raise.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and no GPU
    is present — there is no quiet CPU path.  On the card, fp32 matrix
    products are held to full fp32 and bf16 products to fp32 reductions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev}: no CUDA GPU is available (pass "
                "device='cpu' to run the plain PyTorch path)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    return dev
