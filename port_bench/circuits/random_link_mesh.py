"""The upstream's random-link resistor mesh under DC sweeps: the port
builds the mesh's netlist once and lowers it; each job is one DC sweep of
the source, its values solved as lanes at once from zero through the
engine's sparse route (``engine.analog.newton_solve(method="sparse")``:
COO assembly and the float64 Jacobi BiCGStab of ``ops/sparse.py``).

The check compares every job of the window with ``reference/mesh_dc.py``
(the circuit is linear, so the reference solves once for 1 V and
scales): every lane at ``check.positions`` unknowns drawn from the seed
(the source's node and current and both ends of the chain among them),
and one whole lane a job, drawn from (seed, job):

- ``failed_solves``: lanes the program did not report converged; limit 0;
- ``v_gap_max``: the widest node-voltage gap, against the lane's source
  value;
- ``i_gap_max``: the widest gap of the source's branch current, against
  the reference's current (the sum of every current at the driven node);
- ``ref_unconverged``: 1 where the reference did not reach its residual
  limit; limit 0.
"""

from __future__ import annotations

import contextlib

import numpy as np

from .. import check, mesh, traffic

RATE = ("dc_solves_per_s", "solves/s")
FAILED = "failed_solves"
ZERO = (FAILED, "ref_unconverged")


def lower(m: mesh.Mesh):
    """The mesh as the port's netlist, lowered.  Returns (ir, the unknown
    of each node (nodes,), the unknown of the source's current, the
    source's parameter column)."""
    from phy_engine_tpu_torch.engine.lower import lower_analog
    from phy_engine_tpu_torch.models.linear import RESISTANCE, VDC
    from phy_engine_tpu_torch.netlist import operations as netops
    from phy_engine_tpu_torch.netlist.netlist import Netlist

    nl = Netlist()
    nodes = [netops.create_node(nl) for _ in range(m.nodes)]
    pin = lambda i: nl.ground_node if i == mesh.GROUND else nodes[i]
    for a, b, r in zip(m.r_a.tolist(), m.r_b.tolist(), m.r_val.tolist()):
        e = netops.add_model(nl, RESISTANCE, {"r": r})
        netops.add_to_node(nl, e, 0, pin(a))
        netops.add_to_node(nl, e, 1, pin(b))
    src = netops.add_model(nl, VDC, {"V": m.vdc})
    netops.add_to_node(nl, src, 0, nodes[m.src])
    netops.add_to_node(nl, src, 1, nl.ground_node)
    ir = lower_analog(nl)
    fam = {f.mdef.id_name: f for f in ir.families}
    if len(fam["VDC"].instances) != 1:
        raise ValueError("the mesh has one DC source")
    return (ir, np.asarray([ir.index_of(n) for n in nodes]),
            int(src.branches[0].index),
            fam["VDC"].mdef.param_order.index("V"))


class Bench:
    """The mesh lowered by the port, its parameters, states and starting
    point for the sweep's lanes on the device, and one warm-up job."""

    def __init__(self, c, seed: int, device):
        import torch

        from phy_engine_tpu_torch.engine import analog
        from phy_engine_tpu_torch.models.base import StampCtx
        self.c, self.mix, self.device = c, c.traffic, device
        if self.mix["solver"] != "sparse":
            raise ValueError(f"unknown solver route {self.mix['solver']!r}")
        self.mesh = m = mesh.build(c.config)
        self.B = int(self.mix["lanes"])
        self.ir, nodes, branch, self.v_col = lower(m)
        lanes = lambda a: a[None].repeat((self.B,) + (1,) * a.dim())
        self.params = {k: lanes(v) for k, v in
                       analog.initial_params(self.ir, device).items()}
        self.states = {k: {s: lanes(a) for s, a in d.items()} for k, d in
                       analog.initial_state(self.ir, device).items()}
        self.x0 = lanes(analog.initial_x(self.ir, device))
        self.ctx = StampCtx(mode="op", t=0.0, dt=0.0,
                            env=dict(c.config["env"]))
        # the port's unknown of each of the reference's
        self.order = torch.as_tensor(np.concatenate([nodes, [branch]]),
                                     device=device)
        n = m.n_unknowns
        self.pos = traffic.check_positions(
            seed, n, int(c.cell["check"]["positions"]),
            keep=(0, m.src, m.nodes - 1, n - 1))
        self.kept_at = self.order[torch.as_tensor(self.pos, device=device)]
        self.steps, self.work = 1, self.B
        self.answers = self.B
        for j in range(int(self.mix["warmup_jobs"])):
            kept, fails = self.job(seed, traffic.WARM_JOB + j)
            fails.item()

    def volts(self, seed: int, j: int) -> np.ndarray:
        return self.mesh.vdc * traffic.sweep(self.mix, seed, j)

    def lane(self, seed: int, j: int) -> int:
        """The lane of job j whose whole answer the check keeps."""
        return int(np.random.default_rng(
            traffic._key(seed, 5, j)).integers(self.B))

    def _solve(self, volts: np.ndarray):
        import torch

        from phy_engine_tpu_torch.engine import analog
        p = dict(self.params)
        p["VDC"] = self.params["VDC"].clone()
        p["VDC"][:, 0, self.v_col] = torch.as_tensor(
            volts, dtype=p["VDC"].dtype, device=self.device)
        x, _st, ok = analog.newton_solve(self.ir, p, self.x0, self.states,
                                         self.ctx, method="sparse")
        return x, ok

    def job(self, seed: int, j: int):
        x, ok = self._solve(self.volts(seed, j))
        return (x[:, self.kept_at], x[self.lane(seed, j), self.order]), \
            (~ok).sum()

    def counters(self) -> dict:
        return {}

    def marks(self, calls: list):
        return record_iterations(calls)

    def compare(self, seed: int, kept: list, control: bool = False) -> dict:
        """The numbers compared; with ``control``, those of the reference
        in float32 put in the program's place for every lane."""
        import torch

        from ..reference import mesh_dc
        unit, conv = mesh_dc.solve(self.mesh, torch.float64, self.device)
        unit = unit.numpy()
        if control:
            x32 = mesh_dc.solve(self.mesh, torch.float32, self.device)[0]
            x32 = x32.numpy()
        n, worst = self.mesh.n_unknowns, {"v_gap_max": 0.0, "i_gap_max": 0.0}
        for j, (at, whole) in enumerate(kept):
            volts = self.volts(seed, j)
            lane = self.lane(seed, j)
            if control:
                at = volts[:, None] * x32[self.pos][None]
                whole = volts[lane] * x32
            for got in (check.dc_gaps(at, self.pos, unit, volts, n - 1),
                        check.dc_gaps(whole[None], np.arange(n), unit,
                                      volts[lane:lane + 1], n - 1)):
                worst = {k: max(worst[k], got[k]) for k in worst}
        worst["ref_unconverged"] = int(not conv)
        return worst


@contextlib.contextmanager
def record_iterations(calls: list):
    """Wrap the engine's sparse solver as the DC route calls it, recording
    ("bicgstab", iterations of its slowest lane) of each call in
    ``calls``."""
    from phy_engine_tpu_torch.engine import analog
    real = analog.bicgstab

    def call(*a, **kw):
        x, ok, it = real(*a, **kw)
        calls.append(("bicgstab", it.max()))
        return x, ok, it
    analog.bicgstab = call
    try:
        yield
    finally:
        analog.bicgstab = real
