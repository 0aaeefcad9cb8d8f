"""Device resolution and the device mesh shared by the port's entry points.

The port runs on the GPU unless the caller asks for the CPU by name:
``device=None`` means ``torch.device("cuda")``, and a CUDA device that
is not there raises — there is no quiet CPU fallback.

``Mesh`` is the port's reading of ``jax.sharding.Mesh``: an array of
devices with named axes, and ``with mesh:`` puts it in context the way
the reference's ``with mesh:`` does. The port is single-controller like
the reference: one process drives every device of a mesh, and nothing
here starts ``torch.distributed``.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
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


#: the meshes in context, innermost last (``with mesh:`` pushes and pops)
_CONTEXT = []


class Mesh:
    """Named axes over an array of devices.

    ``devices``: a (nested) sequence or array of ``torch.device``s (or
    device strings), reshaped to ``shape`` when given; ``None`` makes a
    shape-only mesh (``shape`` required), which sizes specs and holds no
    device, as the production meshes of the dry run do. ``.shape`` is
    the ordered axis -> size mapping, ``.size`` the device count,
    ``.devices`` the object array of devices (None on a shape-only
    mesh), ``.axis_names`` the names.

    A device may appear more than once. A cohort split over such a mesh
    runs its chunks in turn on that device: this is how one card, and
    the CPU, exercise the split path of ``engine.backends.HostBackend``.
    """

    def __init__(self, devices, axis_names: Sequence[str],
                 shape: Optional[Sequence[int]] = None):
        self.axis_names = tuple(axis_names)
        if devices is None:
            if shape is None:
                raise ValueError("a shape-only Mesh needs shape")
            sizes = tuple(int(s) for s in shape)
            self.devices = None
        else:
            flat = np.asarray(devices, dtype=object).reshape(-1)
            arr = np.empty(len(flat), dtype=object)
            arr[:] = [torch.device(d) for d in flat]
            if shape is None:
                shape = (np.asarray(devices, dtype=object).shape
                         if len(self.axis_names) > 1 else (len(flat),))
            self.devices = arr.reshape(tuple(int(s) for s in shape))
            sizes = self.devices.shape
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {sizes} does not match axes "
                             f"{self.axis_names}")
        self.shape = OrderedDict(zip(self.axis_names, sizes))
        self.size = math.prod(sizes)

    def device_list(self):
        """The devices in row-major order (chunk i of a 1-D split runs on
        entry i)."""
        if self.devices is None:
            raise ValueError("a shape-only mesh holds no device")
        return list(self.devices.reshape(-1))

    def __enter__(self):
        _CONTEXT.append(self)
        return self

    def __exit__(self, *exc):
        _CONTEXT.pop()
        return False

    def __repr__(self):
        return f"Mesh({dict(self.shape)})"


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh in context, or None."""
    return _CONTEXT[-1] if _CONTEXT else None


def with_sharding_constraint(x: torch.Tensor, spec) -> torch.Tensor:
    """The port's ``jax.lax.with_sharding_constraint``: ``spec`` (a
    tuple of axis names, axis-name tuples or None, one per leading dim)
    constrains ``x``'s layout over the mesh in context. One process
    computes the whole tensor, so the value is ``x`` itself; the layout
    shows in the specs the dry run sizes. Like the reference, it raises
    ``RuntimeError`` with no mesh in context and ``ValueError`` for an
    axis the mesh lacks or a spec longer than ``x``'s rank."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 0:
        raise RuntimeError("with_sharding_constraint requires a non-empty "
                           "mesh in context (use `with mesh:`)")
    spec = tuple(spec)
    if len(spec) > x.dim():
        raise ValueError(f"sharding spec {spec} has more entries than the "
                         f"rank {x.dim()} of the constrained tensor")
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None and ax not in mesh.shape:
                raise ValueError(f"sharding axis {ax!r} is not an axis of "
                                 f"{mesh}")
    return x
