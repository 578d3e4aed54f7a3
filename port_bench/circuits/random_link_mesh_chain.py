"""The upstream's random-link resistor mesh where its chain dominates
(10^3 links over 10^5 nodes): the jobs, the check and the reference of
``random_link_mesh.py``, with the program's counters for the per-layer
readers.

On such a mesh Jacobi BiCGStab needs iterations in proportion to the
chain's length and stops at its cap; the engine's sparse route then
escalates to its chain preconditioner (``ops/sparse.py``) in the warm-up
job and keeps it for the pattern, so the window's jobs run the chain
preconditioner alone.  A program that leaves a lane of the warm-up job
unconverged cannot run this cell: set-up raises, before the window.
"""

from __future__ import annotations

from .. import traffic
from . import random_link_mesh
# the harness reads these from the family module
from .random_link_mesh import FAILED, RATE, ZERO  # noqa: F401

# present from the first call, so that the window's differences have them
COUNTERS = ("host_syncs", "bicgstab.iterations_launched",
            "bicgstab.escalations", "chain.factors", "chain.applies")


class Bench(random_link_mesh.Bench):
    """``random_link_mesh.Bench`` whose warm-up must converge and whose
    ``counters()`` are the program's own (``trace.counters()``)."""

    def job(self, seed: int, j: int):
        kept, fails = super().job(seed, j)
        if j >= traffic.WARM_JOB and int(fails):
            raise RuntimeError(
                f"{int(fails)} of the warm-up job's {self.B} solves did not "
                "converge: the program does not solve this configuration")
        return kept, fails

    def counters(self) -> dict:
        from phy_engine_tpu_torch import trace
        return dict(dict.fromkeys(COUNTERS, 0), **trace.counters())
