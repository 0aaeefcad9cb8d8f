"""Device resolution shared by the port's entry points.

The port runs on the GPU unless the caller asks for the CPU by name:
``device=None`` means ``torch.device("cuda")``, and a CUDA device that
is not there raises — there is no quiet CPU fallback.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device; anything else is the caller's
    explicit choice. Raises when a CUDA device is asked for (by default
    or by name) and CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "explicitly to run on the CPU")
    return dev
