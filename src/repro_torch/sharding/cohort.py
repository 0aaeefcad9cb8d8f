"""Cohort-axis sharding — batch the host cohort over devices, not lanes.

Port of ``repro/sharding/cohort.py`` over the port's ``device.Mesh``.
``sharding/rules.py`` partitions ONE model's tensors over an FSDP x
tensor mesh; this module is its orthogonal sibling for the host
simulation: ``HostBackend``'s fused round carries a stacked cohort with
a leading user axis (U, ...), and at 1e4-1e5 users that axis, not the
per-user model, is what spreads over devices. Only the leading cohort
axis splits; each user's (small) model stays whole within its chunk.

The predicates decide whether a stack splits; ``sweep_sharding`` which
dim of a sweep's stack does (the torch reading of the reference's
``PartitionSpec``: 0 for the lanes, 1 for the users). ``HostBackend``
splits that dim explicitly, chunk i on the mesh's i-th device, and keeps
its kernels on every chunk (``engine/backends.py``). The reference's
specs of leaves that never split here (the per-user stack's dim 0, the
winner stack's dim 0, the replicated global, the per-lane globals) have
no reader in the port and are not kept.

On a single device everything here is a no-op by construction: a 1-long
mesh axis splits nothing, so a 1-device-mesh run is bit-identical to a
mesh-less run.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.device import Mesh

#: logical name of the leading stacked-user axis
COHORT_AXIS = "cohort"


def cohort_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over ``devices`` (default: every visible CUDA device)
    whose single axis is the cohort axis. A device may repeat: the
    chunks placed on it then run in turn."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cohort_mesh() defaults to the CUDA devices and "
                "torch.cuda.is_available() is False; name the devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(list(devices), (COHORT_AXIS,))


def sweep_sharding(mesh: Mesh, num_experiments: int,
                   num_users: int) -> int:
    """Sweep-stacked ``(E, U, ...)`` leaves: a 1-D mesh splits one of the
    two leading axes — the experiment dim when E divides the cohort
    axis (whole lanes a chunk), else the user dim."""
    axis = mesh.shape[COHORT_AXIS]
    return 0 if num_experiments % axis == 0 else 1


def sweep_shardable(num_experiments: int, num_users: int,
                    mesh: Optional[Mesh]) -> bool:
    """True when the ``(E, U)`` sweep cohort can split over ``mesh`` on
    at least one of its leading axes (divisibility on E or U)."""
    if mesh is None or COHORT_AXIS not in mesh.shape:
        return False
    axis = mesh.shape[COHORT_AXIS]
    return (num_experiments % axis == 0) or (num_users % axis == 0)


def winner_shardable(k_max: int, mesh: Optional[Mesh]) -> bool:
    """True when the compact ``(K_max, ...)`` winner stack can split over
    ``mesh`` along its K axis (``shardable``'s rule on the winner
    budget)."""
    if mesh is None or COHORT_AXIS not in mesh.shape:
        return False
    return k_max % mesh.shape[COHORT_AXIS] == 0


def shardable(num_users: int, mesh: Optional[Mesh]) -> bool:
    """True when the cohort axis can split over ``mesh``. False (the
    unsplit path, still correct) with no mesh, a mesh without a
    ``"cohort"`` axis, or a user count the axis does not divide."""
    if mesh is None or COHORT_AXIS not in mesh.shape:
        return False
    return num_users % mesh.shape[COHORT_AXIS] == 0
