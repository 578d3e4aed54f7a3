"""The upstream's series resistor ladder under DC sweeps: the port builds
the ladder's netlist once, lowers it, assembles its COO system on the
device (``engine.analog.assemble_sparse``) and takes out its tridiagonal
core and the source's border on the host (``workloads.ladder_extract``),
as the port's ``bench_ladder.py`` route does; each job is one DC sweep of
the source, its values solved as lanes at once by parallel cyclic
reduction with refinement (``ops.tridiag.border_solve``).

Every lane of every job keeps its answer at ``check.positions`` unknowns
drawn from the seed (both ends of the ladder and the source's current
among them), each compared with ``reference/series_dc.py`` (the circuit
is linear, so the reference solves once for 1 V and scales):

- ``failed_solves``: lanes whose answer is not finite; limit 0;
- ``v_gap_max``: the widest node-voltage gap, against the lane's source
  value;
- ``i_gap_max``: the widest gap of the source's current, against the
  reference's.
"""

from __future__ import annotations

import contextlib

import numpy as np

from .. import check, traffic

RATE = ("ladder_solves_per_s", "solves/s")
FAILED = "failed_solves"
ZERO = (FAILED,)


def lower(n_res: int, r: float, vdc: float):
    """The ladder as the port's netlist, its nodes created down the chain,
    lowered.  Returns (ir, the unknown of each node, the unknown of the
    source's current)."""
    from phy_engine_tpu_torch.engine.lower import lower_analog
    from phy_engine_tpu_torch.models.linear import RESISTANCE, VDC
    from phy_engine_tpu_torch.netlist import operations as netops
    from phy_engine_tpu_torch.netlist.netlist import Netlist

    nl = Netlist()
    src = netops.add_model(nl, VDC, {"V": vdc})
    nodes = [netops.create_node(nl)]
    netops.add_to_node(nl, src, 0, nodes[0])
    netops.add_to_node(nl, src, 1, nl.ground_node)
    for k in range(n_res):
        e = netops.add_model(nl, RESISTANCE, {"r": r})
        netops.add_to_node(nl, e, 0, nodes[-1])
        if k < n_res - 1:
            nodes.append(netops.create_node(nl))
            netops.add_to_node(nl, e, 1, nodes[-1])
        else:
            netops.add_to_node(nl, e, 1, nl.ground_node)
    ir = lower_analog(nl)
    return (ir, np.asarray([ir.index_of(n) for n in nodes]),
            int(src.branches[0].index))


class Bench:
    """The ladder lowered and assembled by the port, its tridiagonal core
    and border on the device, and one warm-up job."""

    def __init__(self, c, seed: int, device):
        import torch

        from phy_engine_tpu_torch.engine import analog
        from phy_engine_tpu_torch.models.base import StampCtx
        from phy_engine_tpu_torch.workloads import ladder_extract
        cfg, self.mix, self.device = c.config, c.traffic, device
        if self.mix["solver"] != "pcr":
            raise ValueError(f"unknown solver route {self.mix['solver']!r}")
        self.n_res, self.r = int(cfg["resistors"]), float(cfg["r"])
        self.vdc = float(cfg["vdc"])
        self.B, self.refine = int(self.mix["lanes"]), int(self.mix["refine"])
        ir, nodes, branch = lower(self.n_res, self.r, self.vdc)
        n = ir.n_unknowns
        if not (np.array_equal(nodes, np.arange(n - 1)) and branch == n - 1):
            raise ValueError("the ladder's unknowns are not in chain order")
        params = {k: v[None] for k, v in
                  analog.initial_params(ir, device).items()}
        states = {k: {s: a[None] for s, a in d.items()} for k, d in
                  analog.initial_state(ir, device).items()}
        ctx = StampCtx(mode="op", t=0.0, dt=0.0, env=dict(cfg["env"]))
        rows, cols, vals, Z, _ = analog.assemble_sparse(
            ir, params, analog.initial_x(ir, device)[None], states, ctx)
        dl, d, du, e, z, rhs_b = ladder_extract(
            rows.cpu().numpy(), cols.cpu().numpy(), vals[0].cpu().numpy(),
            Z[0].cpu().numpy(), n)
        dev = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
        self.core = (dev(dl), dev(d), dev(du))
        self.z, self.e = dev(z / self.vdc), dev(e)
        self.rhs_unit = rhs_b / self.vdc
        self.n = n
        self.pos = traffic.check_positions(
            seed, n, int(c.cell["check"]["positions"]), keep=(0, n - 2, n - 1))
        self.kept_at = torch.as_tensor(self.pos, device=device)
        self.steps, self.work, self.answers = 1, self.B, self.B
        for j in range(int(self.mix["warmup_jobs"])):
            kept, fails = self.job(seed, traffic.WARM_JOB + j)
            fails.item()

    def volts(self, seed: int, j: int) -> np.ndarray:
        return self.vdc * traffic.sweep(self.mix, seed, j)

    def _solve(self, volts: np.ndarray):
        import torch

        from phy_engine_tpu_torch.ops.tridiag import border_solve
        v = torch.as_tensor(volts, dtype=torch.float64, device=self.device)
        x, i = border_solve(*self.core, self.z * v[:, None], self.e,
                            v * self.rhs_unit, refine=self.refine)
        return torch.cat([x, i[:, None]], dim=1)

    def job(self, seed: int, j: int):
        import torch
        x = self._solve(self.volts(seed, j))
        return x[:, self.kept_at], (~torch.isfinite(x)).any(dim=1).sum()

    def counters(self) -> dict:
        return {}

    def marks(self, calls: list):
        return contextlib.nullcontext()

    def compare(self, seed: int, kept: list, control: bool = False) -> dict:
        """The numbers compared; with ``control``, those of the reference
        in float32 put in the program's place for every lane."""
        from ..reference import series_dc
        unit = series_dc.solve(self.n_res, self.r)
        if control:
            at32 = series_dc.solve(self.n_res, self.r, np.float32)[self.pos]
        worst = {"v_gap_max": 0.0, "i_gap_max": 0.0}
        for j, at in enumerate(kept):
            volts = self.volts(seed, j)
            if control:
                at = volts[:, None] * at32[None]
            got = check.dc_gaps(at, self.pos, unit, volts, self.n - 1)
            worst = {k: max(worst[k], got[k]) for k in worst}
        return worst
