"""Side-effect-free roofline helper (importable from tests;
``dryrun.py`` and ``hillclimb.py`` read it).

Port of ``repro/launch/hlo_analysis.py``. The reference reads XLA's
post-SPMD HLO text for its collectives' bytes; the port runs no
collective (one process, no SPMD partitioner), so the dry run reports
that term as not counted and the module keeps only ``roofline_terms``:
the reference's formula over the H100's constants (``launch/mesh.py``).
"""
from __future__ import annotations

from repro_torch.launch.mesh import HBM_BW, ICI_BW_PER_LINK, PEAK_FLOPS_BF16


def roofline_terms(flops_dev, bytes_dev, coll_dev):
    """Seconds of compute, memory and collectives a device; a term whose
    input is None (not measured) is None and never dominant."""
    terms = {"compute_s": flops_dev / PEAK_FLOPS_BF16,
             "memory_s": bytes_dev / HBM_BW,
             "collective_s": (None if coll_dev is None
                              else coll_dev / ICI_BW_PER_LINK)}
    known = {k: v for k, v in terms.items() if v is not None}
    return {**{k: (None if v is None else round(v, 6))
               for k, v in terms.items()},
            "dominant": max(known, key=known.get)}
