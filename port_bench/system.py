"""The system under test: the port's frozen-Newton Monte-Carlo transient.

Everything here that touches the program goes through its public entry
points: the netlist operations, ``engine.lower.lower_analog``,
``parallel.batch`` and ``engine.analog.transient_batched``.  The port is
imported inside the functions, so that importing this module (the tests
do) loads nothing of it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ladder import Ladder

PN_KEYS = ("Is", "N", "Isr", "Nr", "Temp", "Ibv", "Bv", "Bv_set", "Area",
           "tt")


@dataclass
class Lowered:
    ir: object               # the port's AnalogIR
    base: dict               # {family: (n_inst, n_params)}, the port's packing
    r_cols: tuple            # (r's column in R's params, R instances' order)
    nodes: np.ndarray        # (stages,) the port's unknown of each ladder node
    branch: int              # the port's unknown of the source's current
    env: dict


def lower(lad: Ladder, env: dict) -> Lowered:
    """Build the ladder as the port's netlist and lower it."""
    from phy_engine_tpu_torch.engine.lower import lower_analog
    from phy_engine_tpu_torch.models.linear import CAPACITOR, RESISTANCE, VAC
    from phy_engine_tpu_torch.models.nonlinear import PN_JUNCTION
    from phy_engine_tpu_torch.netlist import operations as netops
    from phy_engine_tpu_torch.netlist.netlist import Netlist

    nl = Netlist()
    gnd = nl.ground_node
    src = netops.add_model(nl, VAC, dict(lad.drive))
    nodes = [netops.create_node(nl) for _ in range(lad.stages)]
    netops.add_to_node(nl, src, 0, nodes[0])
    netops.add_to_node(nl, src, 1, gnd)
    res = []
    for a, b, r in zip(lad.r_a, lad.r_b, lad.r_nom):
        m = netops.add_model(nl, RESISTANCE, {"r": float(r)})
        netops.add_to_node(nl, m, 0, nodes[a])
        netops.add_to_node(nl, m, 1, nodes[b])
        res.append(m)
    pn = {k: float(lad.pn[k]) for k in PN_KEYS}
    for node in nodes:
        for mdef, params in ((PN_JUNCTION, pn),
                             (CAPACITOR, {"C": lad.c_node})):
            m = netops.add_model(nl, mdef, params)
            netops.add_to_node(nl, m, 0, node)
            netops.add_to_node(nl, m, 1, gnd)
    ir = lower_analog(nl)
    fam = {f.mdef.id_name: f for f in ir.families}
    where = {id(m): k for k, m in enumerate(res)}
    order = np.asarray([where[id(m)] for m in fam["R"].instances])
    col = fam["R"].mdef.param_order.index("r")
    return Lowered(ir=ir, base={k: f.P for k, f in fam.items()},
                   r_cols=(col, order),
                   nodes=np.asarray([ir.index_of(n) for n in nodes]),
                   branch=int(src.branches[0].index), env=dict(env))


def params(low: Lowered, r: np.ndarray, device):
    """The port's parameter tensors for lanes of resistances r (B, n_r)
    in the element list's order."""
    from phy_engine_tpu_torch.parallel.batch import params_from_numpy
    B = r.shape[0]
    arrays = {k: np.broadcast_to(P, (B,) + P.shape)
              for k, P in low.base.items()}
    col, order = low.r_cols
    R = np.array(arrays["R"])
    R[:, :, col] = r[:, order]
    arrays["R"] = R
    return params_from_numpy(low.ir, arrays, device=device)


def run_job(low: Lowered, r: np.ndarray, steps: int, dt: float, device,
            inv: str = "gj"):
    """One Monte-Carlo job: every lane of r from rest through ``steps``
    trapezoidal steps of ``dt`` by the frozen Newton.  Returns the port's
    (x (B, n), ok (B,)) on the device, without waiting for them."""
    from phy_engine_tpu_torch.engine import analog
    from phy_engine_tpu_torch.parallel.batch import batch_state, batch_x
    B = r.shape[0]
    x, _st, ok, _ = analog.transient_batched(
        low.ir, params(low, r, device), batch_x(low.ir, B, device),
        batch_state(low.ir, B, device), low.env, 0.0, dt, steps,
        solver="frozen", inv=inv)
    return x, ok


def in_ladder_order(low: Lowered, x: np.ndarray) -> np.ndarray:
    """The port's unknowns (L, n) as the reference orders them: the ladder's
    nodes, then the source's branch current."""
    return np.concatenate([x[:, low.nodes], x[:, [low.branch]]], axis=1)
