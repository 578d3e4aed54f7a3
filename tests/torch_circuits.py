"""Circuit descriptions for the port's tests, free of JAX (the card tests
import them on a machine that has only torch).

A description is a list of devices ``(name, MODEL, params, pins)``:
``MODEL`` names a family constant of ``<package>.models`` (``"VDC"``,
``"RESISTANCE"``, ...) and ``pins`` the nets its pins connect to, in pin
order; net ``"0"`` is ground and every other net is created at its first
use.
"""

from types import SimpleNamespace

import torch

import phy_engine_tpu_torch as tpe
from phy_engine_tpu_torch.engine import circuit as tcircuit


def build(pe, mod, spec, env=None, **kw):
    """The circuit of ``spec`` in package ``pe`` (circuit module ``mod``):
    a namespace with ``c`` the Circuit, ``nodes`` / ``devs`` by name and
    ``mod``."""
    c = pe.Circuit(env=pe.Environment(**env) if env else None, **kw)
    nl = c.nl
    nodes = {"0": nl.ground_node}
    devs = {}
    for name, fam, params, pins in spec:
        m = pe.netops.add_model(nl, getattr(pe.models, fam), dict(params))
        for k, net in enumerate(pins):
            if net not in nodes:
                nodes[net] = pe.netops.create_node(nl)
            pe.netops.add_to_node(nl, m, k, nodes[net])
        devs[name] = m
    return SimpleNamespace(c=c, nodes=nodes, devs=devs, mod=mod)


def build_port(spec, device, env=None, **kw):
    return build(tpe, tcircuit, spec, env, device=device, **kw)


def divider(v=4.0, r1=1e3, r2=3e3):
    return [("v", "VDC", {"V": v}, ("top", "0")),
            ("r1", "RESISTANCE", {"r": r1}, ("top", "mid")),
            ("r2", "RESISTANCE", {"r": r2}, ("mid", "0"))]


def diode_load(v=5.0, r=1e3, **pn):
    """VDC - R - diode to ground (tests/test_nonlinear.py)."""
    return [("v", "VDC", {"V": v}, ("in", "0")),
            ("r", "RESISTANCE", {"r": r}, ("in", "d")),
            ("d", "PN_JUNCTION", dict(pn), ("d", "0"))]


# BSIM3 parameter sets of bench_bsim3.py and the series resistances of an
# _RC device (all real: a terminal floored to 1 uOhm is a 1e6 S entry)
B3_NMOS = {"Kp": 2e-4, "Vth0": 0.7, "W": 10e-6, "L": 1e-6}
B3_PMOS = {"Kp": 1e-4, "Vth0": 0.7, "W": 20e-6, "L": 1e-6}
B3_RC = {"rd": 500.0, "rs": 20.0, "rg": 100.0, "rb": 50.0}
# Newton to machine precision: the default 1e-3 relative step tolerance
# lets two implementations stop one iteration apart on a BSIM3 bias point
TIGHT = {"V_eps_max": 1e-12, "V_epsr_max": 1e-9}


def bsim3_stages():
    """Two common-source stages, a BSIM3 NMOS with flicker and a PMOS_RC,
    each gate through 50 kOhm from its bias, summed into net "out" by
    resistors; "vg" biases the NMOS gate."""
    spec = [("vdd", "VDC", {"V": 3.0}, ("vdd", "0")),
            ("vg", "VDC", {"V": 1.2}, ("gn", "0")),
            ("vgp", "VDC", {"V": 1.8}, ("gp", "0"))]
    for k, (fam, params, rail, bias) in enumerate((
            ("BSIM3V32_NMOS", {**B3_NMOS, "kf": 1e-24}, "0", "gn"),
            ("BSIM3V32_PMOS_RC", {**B3_PMOS, **B3_RC}, "vdd", "gp"))):
        spec += [(f"m{k}", fam, params, (f"d{k}", f"g{k}", rail, rail)),
                 (f"rg{k}", "RESISTANCE", {"r": 50e3}, (bias, f"g{k}")),
                 (f"rl{k}", "RESISTANCE", {"r": 4.7e3},
                  (f"d{k}", "vdd" if rail == "0" else "0")),
                 (f"rs{k}", "RESISTANCE", {"r": 20e3}, (f"d{k}", "out"))]
    return spec + [("ro", "RESISTANCE", {"r": 10e3}, ("out", "0"))]


def bsim3_cs_stage():
    """A common-source BSIM3 NMOS stage (capMod 1) on a resistive gate
    bias chain, a 1 mV VAC on the gate, output net "d"."""
    return [("vdd", "VDC", {"V": 3.0}, ("vdd", "0")),
            ("r1", "RESISTANCE", {"r": 100e3}, ("vdd", "gb")),
            ("r2", "RESISTANCE", {"r": 68e3}, ("gb", "0")),
            ("vsig", "VAC", {"Vp": 1e-3}, ("g", "gb")),
            ("rl", "RESISTANCE", {"r": 10e3}, ("vdd", "d")),
            ("cl", "CAPACITOR", {"C": 2e-14}, ("d", "0")),
            ("m", "BSIM3V32_NMOS", {"W": 10e-6, "L": 1e-6, "Vth0": 0.7,
                                    "Kp": 120e-6, "capmod": 1.0},
             ("d", "g", "0", "0"))]


def mesh_mna(c):
    """An independent rebuild of a resistor-and-VDC netlist's MNA from the
    netlist objects (tests/test_sparse.py:83-134), over the lowered
    circuit's unknowns, with the environment's g_min on every node:
    (scipy CSR A, rhs)."""
    import numpy as np
    import scipy.sparse as sp
    ir = c.prepare()
    n = ir.n_unknowns
    rows, cols, vals = [], [], []
    rhs = np.zeros(n)
    for m in c.nl.live_models():
        a, b = (p.node for p in m.pins)
        ia = -1 if a.is_ground else a.node_index
        ib = -1 if b.is_ground else b.node_index
        if m.mdef.id_name == "R":
            g = 1.0 / float(m.params["r"])
            for i, j, v in ((ia, ia, g), (ib, ib, g), (ia, ib, -g),
                            (ib, ia, -g)):
                if i >= 0 and j >= 0:
                    rows.append(i)
                    cols.append(j)
                    vals.append(v)
        elif m.mdef.id_name == "VDC":
            k = m.branches[0].index
            for i, v in ((ia, 1.0), (ib, -1.0)):
                if i >= 0:
                    rows += [i, k]
                    cols += [k, i]
                    vals += [v, v]
            rhs[k] = float(m.params["V"])
        else:
            raise ValueError(f"mesh_mna: no stamp for {m.mdef.id_name}")
    rows += list(range(ir.n_nodes))
    cols += list(range(ir.n_nodes))
    vals += [c.env.g_min] * ir.n_nodes
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n)), rhs


def random_link_mesh_ir(nodes: int, links: int, seed: int = 1):
    """The upstream's 100000_random_links topology lowered by the port: a
    1 kOhm chain ground - n0 - ... - n_{nodes-1}, ``links`` 1 kOhm links
    between uniform node pairs (numpy's generator at ``seed``; a pair
    drawn twice as one node takes the next node instead) and a 1 V DC
    source from n_{nodes-1} to ground.  Returns the lowered circuit, over
    nodes + 1 unknowns."""
    import numpy as np

    from phy_engine_tpu_torch.engine.lower import lower_analog
    from phy_engine_tpu_torch.models.linear import RESISTANCE, VDC
    from phy_engine_tpu_torch.netlist import operations as netops
    from phy_engine_tpu_torch.netlist.netlist import Netlist
    rng = np.random.default_rng(seed)
    a = rng.integers(0, nodes, links)
    b = rng.integers(0, nodes, links)
    b = np.where(a == b, (b + 1) % nodes, b)
    nl = Netlist()
    net = [netops.create_node(nl) for _ in range(nodes)]
    pairs = [(nl.ground_node, net[0])]
    pairs += [(net[i], net[i + 1]) for i in range(nodes - 1)]
    pairs += [(net[i], net[j]) for i, j in zip(a.tolist(), b.tolist())]
    for p, q in pairs:
        r = netops.add_model(nl, RESISTANCE, {"r": 1000.0})
        netops.add_to_node(nl, r, 0, p)
        netops.add_to_node(nl, r, 1, q)
    v = netops.add_model(nl, VDC, {"V": 1.0})
    netops.add_to_node(nl, v, 0, net[-1])
    netops.add_to_node(nl, v, 1, nl.ground_node)
    return lower_analog(nl)


def mesh_routes_run(device) -> int:
    """The routes that take ``mesh=`` run on a one-rank mesh of
    ``device``'s type (NCCL on a card, gloo on the CPU) and agree with the
    local route: ``Circuit(mesh=)`` OP through the distributed Newton and
    the three sweeps with ``mesh=``.  Returns the number of routes held."""
    from phy_engine_tpu_torch.parallel.mesh import make_mesh
    import numpy as np
    mesh = make_mesh(device_type=torch.device(device).type)
    local = build_port(divider(), device)
    local.c.set_analyze_type(local.mod.AnalyzeType.OP)
    assert local.c.analyze()
    m = build_port(divider(), device, mesh=mesh)
    m.c.set_analyze_type(m.mod.AnalyzeType.OP)
    assert m.c.analyze()
    assert np.isclose(m.nodes["mid"].voltage.real, 3.0, rtol=1e-12)
    routes = [(lambda c, **kw: c.dc_sweep(
                   c.nl.live_models()[0], "V", [1.0, 4.0], **kw).x),
              (lambda c, **kw: c.temp_sweep([0.0, 27.0, 80.0], **kw).x),
              (lambda c, **kw: c.monte_carlo(
                  {"R": {"r": 0.1}}, 3,
                  generator=torch.Generator().manual_seed(1), **kw).x)]
    for run in routes:
        assert np.array_equal(run(m.c, mesh=mesh), run(local.c))
    return 1 + len(routes)
