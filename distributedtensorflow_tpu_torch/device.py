"""The one device rule of the port.

Entry points run on the card.  A caller that wants the CPU (the parity
tests) says so with ``device="cpu"``; there is no silent CPU fallback
when CUDA is missing.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; raises when the requested CUDA device is
    not there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return dev
