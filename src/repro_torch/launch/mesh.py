"""Meshes and the card's constants for the roofline.

Port of ``repro/launch/mesh.py``. ``make_production_mesh`` is the
reference's 16 x 16 (or 2 x 16 x 16) mesh as a SHAPE-ONLY ``Mesh``: it
sizes the sharding specs of the dry run (``launch/dryrun.py``) one to
one with the reference's, and holds no device; nothing runs on it.
``make_host_mesh`` is a real ``("data", "model")`` mesh over the CUDA
devices, or over the device the caller names.

The constants are one NVIDIA H100 SXM's (80GB HBM3), the card the port
targets: dense bf16 tensor-core peak, f32 peak outside the tensor
cores, HBM rate, one direction of its NVLink, and the bytes
``torch.cuda.get_device_properties(0).total_memory`` reads on an
"NVIDIA H100 80GB HBM3" (``chip_smoke.py`` checks it on the card).
Functions, not module-level meshes: importing this module touches no
device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(None, axes, shape=shape)


def make_host_mesh(model_parallel: int = 1, device=None) -> Mesh:
    """A ``("data", "model")`` mesh over every visible CUDA device, or
    over ``device`` (one device or a list) when given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_host_mesh() defaults to the CUDA devices and "
                "torch.cuda.is_available() is False; pass device='cpu'")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    elif isinstance(device, (list, tuple)):
        devs = [torch.device(d) for d in device]
    else:
        devs = [torch.device(device)]
    n = len(devs)
    mp = max(1, min(model_parallel, n))
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(n // mp, mp), ("data", "model"))


# NVIDIA H100 SXM 80GB HBM3 constants for the roofline (per card)
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12       # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12             # B/s
ICI_BW_PER_LINK = 450e9      # B/s, NVLink 4, one direction
HBM_BYTES = 85_017_493_504   # total_memory on an NVIDIA H100 80GB HBM3
