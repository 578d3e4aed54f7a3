"""The random-link diode ladder under Monte-Carlo jobs: each job B lanes of
jittered resistances from rest through the frozen-Newton transient
(``system.run_job``), checked against the float64 transient of
``reference/ladder_tr.py``.

The check compares a sample of the window's lanes, drawn from the seed,
that always holds the first and the last lane of a job (the edges of the
batch, where a kernel's grid ends), against the reference:

- ``failed_lanes``: lanes of the window that the program did not bring to
  convergence (all of them, not a sample); limit 0;
- ``x_gap_p90``: the 90th percentile of the sampled lanes' gaps; a lane's
  gap is the widest over its unknowns, each on its own scale: a node
  voltage against the drive's amplitude, the source's branch current
  against its own value.  The current is the sum of every element's
  current at the driven node, and a lower precision loses its digits
  there, so the float32 control fails this number;
- ``x_gap_max``: the widest lane of the sample, held far above the widest
  sound lane, so that a few grossly wrong lanes (another lane's
  parameters, a skipped block of the batch) fail even where the
  percentile does not see them;
- ``ref_unconverged``: sampled lanes on which the reference's Newton did
  not reach rounding; limit 0 (the comparison is void there).
"""

from __future__ import annotations

import numpy as np

from .. import ladder, system, traffic
from .. import trace as tr

RATE = ("circuit_steps_per_s", "circuit-steps/s")
FAILED = "failed_lanes"
ZERO = (FAILED, "ref_unconverged")


def lane_gaps(lad, env: dict, x: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Each lane's gap (L,) of answers x (L, n) from the reference's ref
    (L, n), both in the reference's order (nodes, then the source's
    current): the widest over its unknowns, each on its own scale."""
    N = lad.stages
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    dv = np.abs(x[:, :N] - ref[:, :N]).max(axis=1) / lad.drive["Vp"]
    di = np.abs(x[:, N] - ref[:, N]) / np.maximum(np.abs(ref[:, N]),
                                                  env["i_abstol"])
    gap = np.maximum(dv, di)
    return np.where(np.isfinite(x).all(axis=1), gap, np.inf)


def numbers(lad, env: dict, x: np.ndarray, ref: np.ndarray) -> dict:
    """The numbers compared from the lane gaps: their 90th percentile and
    their widest."""
    g = lane_gaps(lad, env, x, ref)
    if not np.isfinite(g).all():
        return {"x_gap_p90": float("inf"), "x_gap_max": float("inf")}
    return {"x_gap_p90": float(np.percentile(g, 90)),
            "x_gap_max": float(g.max())}


class Bench:
    """The cell's circuit, lowered by the port and warmed up at the cell's
    lanes: everything a job needs."""

    def __init__(self, c, seed: int, device):
        self.c, self.mix, self.device = c, c.traffic, device
        mix = self.mix
        if mix["solver"] != "frozen":
            raise ValueError(f"unknown solver route {mix['solver']!r}")
        self.lad = ladder.build(c.config, mix.get("drive"))
        self.low = system.lower(self.lad, c.config["env"])
        self.B, self.steps = int(mix["lanes"]), int(mix["steps"])
        self.work, self.answers = self.B * self.steps, self.B
        self.dt, self.inv = float(mix["dt"]), mix["inv"]
        self.K = int(c.cell["check"]["lanes"])
        warm = traffic.resistances(self.lad, mix, seed, traffic.WARM_JOB)
        x, ok = system.run_job(self.low, warm, int(mix["warmup_steps"]),
                               self.dt, device, self.inv)
        x.sum().item()
        del x, ok

    def job(self, seed: int, j: int):
        import torch
        r = traffic.resistances(self.lad, self.mix, seed, j)
        idx = torch.as_tensor(traffic.check_lanes(self.mix, seed, j, self.K),
                              device=self.device)
        x, ok = system.run_job(self.low, r, self.steps, self.dt, self.device,
                               self.inv)
        return x[idx], (~ok).sum()

    def counters(self) -> dict:
        from phy_engine_tpu_torch.ops import gj
        return {"refactors": gj.gj_inverse32.launches,
                "bursts": gj.gj_solve32.launches}

    def marks(self, calls: list):
        return tr.marks(calls)

    def sample(self, seed: int, kept: list):
        """The lanes the check compares: (their resistances (L, n_r), the
        program's answers (L, n) in the reference's order)."""
        by_job = {}
        for j, i in traffic.check_sample(seed, len(kept), self.K, self.K):
            by_job.setdefault(j, []).append(i)
        rs, xs = [], []
        for j, ii in sorted(by_job.items()):
            lanes = traffic.check_lanes(self.mix, seed, j, self.K)[ii]
            rs.append(traffic.resistances(self.lad, self.mix, seed, j)[lanes])
            xs.append(kept[j][ii])
        return (np.concatenate(rs),
                system.in_ladder_order(self.low, np.concatenate(xs)))

    def reference(self, r, dtype):
        from ..reference import ladder_tr
        return ladder_tr.transient(self.lad, r, self.steps, self.dt, dtype,
                                   self.device,
                                   int(self.c.cell["check"]["block"]))

    def compare(self, seed: int, kept: list, control: bool = False) -> dict:
        """The numbers compared; with ``control``, those of the reference
        in float32 put in the program's place on the same lanes."""
        import torch
        r, xp = self.sample(seed, kept)
        ref, unconv = self.reference(r, torch.float64)
        if control:
            xp, _ = self.reference(r, torch.float32)
        values = numbers(self.lad, self.c.config["env"], xp, ref)
        values["ref_unconverged"] = int(unconv.sum())
        return values
