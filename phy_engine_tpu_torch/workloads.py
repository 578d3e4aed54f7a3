"""The port's workloads: the nonlinear random-link diode ladder (analog
main path) and the synthesized RV32 core (digital main path).

``build_diode_ladder`` is the port's copy of the JAX package's
``__graft_entry__._build_diode_ladder`` (its output IR is held identical
by the tests): a VAC source drives an R chain plus ``n_links`` random
long-range R links, with a diode and a capacitor to ground at every
node.  255 stages give 256 MNA unknowns (255 nodes + 1 source branch).
``diode_ladder_netlist`` is the same circuit as a netlist, which the
``Circuit`` driver runs, and ``diode_ladder_elements`` as the C ABI's
element-code stream (``capi.create_circuit``, ``api.Circuit``).

``frozen_transient`` is the main path at a chosen size: a Monte-Carlo
batch with 5 % lognormal jitter on every R, advanced through fixed
trapezoidal steps by the frozen-preconditioner Newton solver — the
counterpart of the JAX package's ``bench.py`` headline; ``inv='block'``
refactors with the blocked inverse (``ops.lu_block``) in place of the
Gauss-Jordan one, as the JAX package's ``FROZEN_INV = "block"`` does.

``bsim3_chain_netlist`` / ``build_bsim3_ir`` are the port's copy of
``bench_bsim3.py``'s workload: an M-stage CMOS inverter chain of BSIM3v3.2
devices (2M a lane, 20 fF loads) driven rail-to-rail by a 1.5 V / 100 MHz
sine on a 1.5 V bias, VDD 3 V.  ``bsim3_seed`` is its TROP gmin ladder
at the nominal point and ``bsim3_transient`` the Monte-Carlo frozen-Newton
transient from that seed (Vth0 jitter 0.02 on both families).

``build_rv32`` synthesizes the in-repo RV32I-subset core
(``data/pe_rv32.v``: the ``pe_rv32`` template with the fib-checksum ROM,
whose ``result`` bus ends at ``RV32_EXPECT``) to gates at ``-O1`` (or any
level), and ``rv32_run`` clocks it through ``Circuit.digital_run`` /
``digital_run_batch`` with ``bench_digital.py``'s schedule.
``rv32_levels`` runs the same core through the levelled tick (the oracle
the chip smoke holds against the turbo kernel).  ``FP16_ADD_SRC`` is the
combinational half-precision adder of the tests.  ``synth_counts``
synthesizes either design at a level and counts its live devices by type
and its logic gates (QOR.md's ``count_logic_gates``); ``RV32_O2_COUNTS``
holds what the JAX package gives for RV32 at -O2, which the chip smoke
checks.  ``rv32_of_penl`` finds the core's clock, reset and ports by
name in a netlist that ``cli.verilog2penl`` wrote and ``io.load`` read.

``rectifier_netlist`` and ``r_ladder_netlist`` are the mesh dry run's
small circuits (``parallel/dryrun.py``).

``sar_adc`` / ``sar_convert`` are the port's copy of tests/test_adc.py: a
``bits``-bit SAR ADC, synthesized SAR logic driving an R-2R DAC through
digital drive slots, a comparator closing the loop; ``analyze()`` and
``digital_clk()`` alternate through each conversion.  8 bits is the
tests' design, 16 the reference's test/0028.16b_adc.
"""

from __future__ import annotations

import time
from collections import Counter
from pathlib import Path
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from .api import _CODE_TABLE, ElementCode
from .engine import analog
from .engine.circuit import AnalyzeType, Circuit
from .engine.environment import Environment
from .engine.lower import lower_analog
from .models.digital_gates import INPUT
from .models.base import StampCtx
from .models.bsim3 import BSIM3V32_NMOS, BSIM3V32_PMOS
from .models.linear import CAPACITOR, RESISTANCE, VAC, VDC
from .models.nonlinear import PN_JUNCTION
from .netlist import operations as netops
from .netlist.netlist import Netlist
from .parallel.batch import batch_params, batch_state, batch_x

N_STAGES = 255
R_CHAIN, C_NODE = 100.0, 1e-9
DT = 5e-8
R_JITTER = 0.05


def ladder_links(n_stages: int, n_links: int):
    """Deterministic random long-range links (reference
    benchmark/0001.models/100000_random_links_* workload family)."""
    rng = np.random.default_rng(12345)
    pairs = []
    while len(pairs) < n_links:
        a, b = rng.integers(0, n_stages, 2)
        if abs(int(a) - int(b)) > 1:
            pairs.append((int(a), int(b)))
    return pairs


def build_diode_ladder(n_stages: int = N_STAGES, r: float = R_CHAIN,
                       c: float = C_NODE, n_links: int = 255):
    """Lowered IR of the diode ladder (see the module docstring)."""
    return lower_analog(diode_ladder_netlist(n_stages, r, c, n_links))


def diode_ladder_netlist(n_stages: int = N_STAGES, r: float = R_CHAIN,
                         c: float = C_NODE, n_links: int = 255,
                         dc: float = None) -> Netlist:
    """The diode ladder's netlist, for ``Circuit(netlist=...)``; its nets
    in ladder order are ``Netlist.nodes``.  ``dc``: drive it with a VDC of
    that voltage instead of the VAC (whose operating point is 0 V)."""
    nl = Netlist()
    v = (netops.add_model(nl, VAC, {"Vp": 2.0, "freq": 1e6}) if dc is None
         else netops.add_model(nl, VDC, {"V": float(dc)}))
    nodes = [netops.create_node(nl) for _ in range(n_stages)]
    netops.add_to_node(nl, v, 0, nodes[0])
    netops.add_to_node(nl, v, 1, nl.ground_node)
    for i in range(n_stages - 1):
        rs = netops.add_model(nl, RESISTANCE, {"r": r})
        netops.add_to_node(nl, rs, 0, nodes[i])
        netops.add_to_node(nl, rs, 1, nodes[i + 1])
    for a, b in ladder_links(n_stages, n_links):
        rs = netops.add_model(nl, RESISTANCE, {"r": 10.0 * r})
        netops.add_to_node(nl, rs, 0, nodes[a])
        netops.add_to_node(nl, rs, 1, nodes[b])
    for i in range(n_stages):
        d = netops.add_model(nl, PN_JUNCTION, {})
        netops.add_to_node(nl, d, 0, nodes[i])
        netops.add_to_node(nl, d, 1, nl.ground_node)
        cl = netops.add_model(nl, CAPACITOR, {"C": c})
        netops.add_to_node(nl, cl, 0, nodes[i])
        netops.add_to_node(nl, cl, 1, nl.ground_node)
    return nl


def rectifier_netlist() -> Netlist:
    """VAC -> series R -> diode -> RC load (the port's copy of
    ``__graft_entry__._build_rectifier``: nonlinear, a branch, state)."""
    nl = Netlist()
    v = netops.add_model(nl, VAC, {"Vp": 5.0, "freq": 1e3})
    rs = netops.add_model(nl, RESISTANCE, {"r": 100.0})
    d = netops.add_model(nl, PN_JUNCTION, {})
    rl = netops.add_model(nl, RESISTANCE, {"r": 10e3})
    cl = netops.add_model(nl, CAPACITOR, {"C": 1e-6})
    n_src, n_a, n_o = (netops.create_node(nl) for _ in range(3))
    for m, pins in ((v, (n_src, nl.ground_node)), (rs, (n_src, n_a)),
                    (d, (n_a, n_o)), (rl, (n_o, nl.ground_node)),
                    (cl, (n_o, nl.ground_node))):
        netops.add_to_node(nl, m, 0, pins[0])
        netops.add_to_node(nl, m, 1, pins[1])
    return nl


def r_ladder_netlist(n_res: int, r=100.0, v: float = 1.0) -> Netlist:
    """A VDC across a chain of ``n_res`` resistors to ground; ``r`` is one
    value or a sequence of ``n_res`` values (the mesh dry run's and the
    tests' instance-sharding ladders)."""
    rv = np.broadcast_to(np.asarray(r, np.float64), (n_res,))
    nl = Netlist()
    src = netops.add_model(nl, VDC, {"V": float(v)})
    prev = netops.create_node(nl)
    netops.add_to_node(nl, src, 0, prev)
    netops.add_to_node(nl, src, 1, nl.ground_node)
    for k in range(n_res):
        res = netops.add_model(nl, RESISTANCE, {"r": float(rv[k])})
        nxt = nl.ground_node if k == n_res - 1 else netops.create_node(nl)
        netops.add_to_node(nl, res, 0, prev)
        netops.add_to_node(nl, res, 1, nxt)
        prev = nxt
    return nl


def diode_ladder_elements(n_stages: int = N_STAGES, r: float = R_CHAIN,
                          c: float = C_NODE, n_links: int = 255):
    """``diode_ladder_netlist`` as the C ABI's element stream: (element
    codes, wire quads (element, pin, element, pin) flattened, positional
    properties), element 0 the ground; every property the netlist leaves
    at its default is given as that default."""
    E = ElementCode
    codes, props = [int(E.GROUND)], []

    def add(code, **given):
        mdef, names = _CODE_TABLE[code]
        codes.append(int(code))
        props.extend(float(given.get(n, mdef.defaults[n])) for n in names)
        return len(codes) - 1

    v = add(E.VAC, Vp=2.0, freq=1e6)
    pairs = [(i, i + 1, r) for i in range(n_stages - 1)]
    pairs += [(a, b, 10.0 * r) for a, b in ladder_links(n_stages, n_links)]
    res = [(add(E.RESISTOR, r=rv), a, b) for a, b, rv in pairs]
    stages = [(add(E.PN_JUNCTION), add(E.CAPACITOR, C=c))
              for _ in range(n_stages)]
    node = [cap for _d, cap in stages]       # pin 0 of a stage's capacitor
    wires = [(v, 0, node[0], 0), (v, 1, 0, 0)]
    wires += [w for e, a, b in res for w in ((e, 0, node[a], 0),
                                             (e, 1, node[b], 0))]
    wires += [w for d, cap in stages for w in ((d, 0, cap, 0), (d, 1, 0, 0),
                                               (cap, 1, 0, 0))]
    return codes, [x for w in wires for x in w], props


def default_env():
    return analog.env_scalars(Environment())


def frozen_transient(batch: int = 256, steps: int = 100,
                     stages: int = N_STAGES, device="cuda", seed: int = 0,
                     inv: str = "gj"):
    """Run the frozen-Newton transient of the diode ladder.

    Builds the ``stages``-stage ladder, draws ``batch`` lanes of R jitter
    from ``torch.Generator().manual_seed(seed)``, and advances ``steps``
    trapezoidal steps of ``DT`` from x = 0, refactoring with ``inv``
    (``'gj'`` or ``'block'``, see ``analog.newton_solve_frozen``).
    Returns (x (B, n), ok (B,))."""
    ir = build_diode_ladder(stages)
    gen = torch.Generator().manual_seed(seed)
    params = batch_params(ir, batch, jitter={"R": {"r": R_JITTER}},
                          generator=gen, device=device)
    x, _st, ok, _ = analog.transient_batched(
        ir, params, batch_x(ir, batch, device), batch_state(ir, batch, device),
        default_env(), 0.0, DT, steps, solver="frozen", inv=inv)
    return x, ok


# ---------------------------------------------------------------------------
# analog: the BSIM3 inverter chain (bench_bsim3.py)
# ---------------------------------------------------------------------------

BSIM3_STAGES = 31
BSIM3_VDD, BSIM3_VP, BSIM3_FREQ = 3.0, 1.5, 1e8
BSIM3_DT = 1e-10
BSIM3_CLOAD = 2e-14
BSIM3_NMOS_P = {"Kp": 2e-4, "Vth0": 0.7, "W": 10e-6, "L": 1e-6}
BSIM3_PMOS_P = {"Kp": 1e-4, "Vth0": 0.7, "W": 20e-6, "L": 1e-6}
BSIM3_JITTER = {"BSIM3_NMOS": {"Vth0": 0.02}, "BSIM3_PMOS": {"Vth0": 0.02}}
BSIM3_GMIN_LADDER = tuple(float(g) for g in np.logspace(-2.0, -12.0, 8))
BSIM3_SEED = 0          # the Monte-Carlo draw's torch.Generator seed


def bsim3_chain_netlist(stages: int = BSIM3_STAGES) -> Netlist:
    """The inverter chain as a netlist, devices in the bench's order: VDD,
    the 1.5 V bias, the VAC input on the bias, then per stage PMOS (D out,
    G in, S and B at VDD), NMOS (S and B at ground) and the load cap.  Its
    stage outputs are the last ``stages`` of ``Netlist.nodes``."""
    nl = Netlist()
    n_vdd, n_bias, n_in = (netops.create_node(nl) for _ in range(3))
    gnd = nl.ground_node
    for model, params, a, b in ((VDC, {"V": BSIM3_VDD}, n_vdd, gnd),
                                (VDC, {"V": BSIM3_VDD / 2.0}, n_bias, gnd),
                                (VAC, {"Vp": BSIM3_VP, "freq": BSIM3_FREQ},
                                 n_in, n_bias)):
        m = netops.add_model(nl, model, params)
        netops.add_to_node(nl, m, 0, a)
        netops.add_to_node(nl, m, 1, b)
    gate = n_in
    for _ in range(stages):
        n_out = netops.create_node(nl)
        for model, params, rail in ((BSIM3V32_PMOS, BSIM3_PMOS_P, n_vdd),
                                    (BSIM3V32_NMOS, BSIM3_NMOS_P, gnd)):
            m = netops.add_model(nl, model, dict(params))
            for pin, node in enumerate((n_out, gate, rail, rail)):
                netops.add_to_node(nl, m, pin, node)
        cl = netops.add_model(nl, CAPACITOR, {"C": BSIM3_CLOAD})
        netops.add_to_node(nl, cl, 0, n_out)
        netops.add_to_node(nl, cl, 1, gnd)
        gate = n_out
    return nl


def build_bsim3_ir(stages: int = BSIM3_STAGES):
    """Lowered IR of the chain: stages + 3 nodes, 3 source branches."""
    return lower_analog(bsim3_chain_netlist(stages))


def bsim3_params(ir, batch: int, device="cuda"):
    """``batch`` lanes of the chain's parameters with the bench's Vth0
    jitter, drawn from ``torch.Generator().manual_seed(BSIM3_SEED)``."""
    return batch_params(ir, batch, jitter=BSIM3_JITTER,
                        generator=torch.Generator().manual_seed(BSIM3_SEED),
                        device=device)


def bsim3_seed(ir, device="cuda"):
    """The chain's TROP bias point at the nominal parameters: the gmin
    ladder ``BSIM3_GMIN_LADDER`` (1e-2 down to 1e-12 in eight rungs),
    each rung the per-lane dense f64 Newton with a 1024-iteration budget,
    warm-started from the previous rung.  Returns (x (1, n), states with a
    lane dimension of 1); raises naming the rung that does not
    converge."""
    env = default_env()
    p1 = batch_params(ir, 1, device=device)
    x, st = batch_x(ir, 1, device), batch_state(ir, 1, device)
    for k, g in enumerate(BSIM3_GMIN_LADDER):
        ctx = StampCtx(mode="trop", t=0.0, dt=0.0, env={**env, "g_min": g})
        x, st, ok = analog.newton_solve(ir, p1, x, st, ctx, max_iter=1024)
        if not bool(ok.all()):
            raise RuntimeError(f"BSIM3 chain TROP: rung {k} (g_min = {g:.3e})"
                               " did not converge")
    return x, st


def bsim3_run(ir, params, start, steps: int, max_iter: int = 256):
    """The chain's fixed-step transient of ``steps`` x ``BSIM3_DT`` for the
    lanes of ``params``, every lane warm-started from ``start`` = (x (1, n),
    states) of `bsim3_seed`.  Returns (xs (steps, B, n), ok (B,))."""
    B = next(iter(params.values())).shape[0]
    x1, st1 = start
    dev = next(iter(params.values())).device
    x_b = x1.to(dev).expand(B, -1).clone()
    st_b = {k: {v: a.to(dev).expand((B,) + a.shape[1:]).clone()
                for v, a in d.items()} for k, d in st1.items()}
    _x, _st, ok, xs = analog.transient_batched(
        ir, params, x_b, st_b, default_env(), 0.0, BSIM3_DT, steps,
        solver="frozen", keep_trace=True, max_iter=max_iter)
    return xs, ok


def bsim3_transient(batch: int = 256, steps: int = 100,
                    stages: int = BSIM3_STAGES, device="cuda",
                    max_iter: int = 256, start=None):
    """``bench_bsim3.py``'s accelerator pass: the chain's Monte-Carlo
    transient, ``batch`` lanes (`bsim3_params`) through the
    frozen-Newton solver with ``max_iter`` iterations a step, from the
    TROP seed ``start`` (run here when None).  Returns xs (steps, batch,
    n); raises naming the lanes that do not converge."""
    ir = build_bsim3_ir(stages)
    if start is None:
        start = bsim3_seed(ir, device)
    xs, ok = bsim3_run(ir, bsim3_params(ir, batch, device), start,
                       steps, max_iter)
    if not bool(ok.all()):
        bad = torch.nonzero(~ok).flatten().tolist()
        raise RuntimeError(f"BSIM3 chain transient: lanes {bad} of {batch} "
                           "did not converge")
    return xs


# ---------------------------------------------------------------------------
# digital: the synthesized RV32 core
# ---------------------------------------------------------------------------

_DATA = Path(__file__).resolve().parent / "data"
RV32_SRC = (_DATA / "pe_rv32.v").read_text()
RV32_EXPECT = 4264
FP16_ADD_SRC = (_DATA / "fp16_add.v").read_text()


def synth_top(src: str, top: str, device="cuda", opt_level: int = 1,
              inputs=None, binary: bool = False):
    """Compile ``src``, elaborate module ``top`` and synthesize it into a
    fresh :class:`Circuit` on ``device``.  One net per port bit; every
    bit of the ports named in ``inputs`` (all input ports when None) is
    driven by its own INPUT device at logic 0.  ``binary``: the
    ``assume_binary_inputs`` relaxation (-O3 and above).

    Returns (circuit, {port: [INPUT per bit]}, {port: [net per bit]},
    SynthReport)."""
    from .verilog import build_design, compile_source, elaborate, find_module
    from .verilog.synth import SynthOptions, synthesize_to_netlist
    design = build_design(compile_source(src))
    topm = find_module(design, top)
    inst = elaborate(design, topm)
    c = Circuit(device=device)
    nl = c.nl
    pn = {p: [netops.create_node(nl) for _ in range(inst.signals[p].width)]
          for p in topm.ports}
    if inputs is None:
        inputs = [p for p in topm.ports
                  if getattr(inst.signals[p].decl, "direction", None)
                  == "input"]
    ins: Dict[str, List] = {}
    for name in inputs:
        ins[name] = []
        for n in pn[name]:
            m = netops.add_model(nl, INPUT, {"boolean": 0.0})
            netops.add_to_node(nl, m, 0, n)
            ins[name].append(m)
    report = synthesize_to_netlist(nl, design, inst, pn,
                                   SynthOptions(opt_level=opt_level,
                                                assume_binary_inputs=binary))
    return c, ins, pn, report


# QOR.md's logic-gate metric (the reference's count_logic_gates): pure
# logic ops; macros, flip-flops and IO are free.  The O2+ driver counts
# the same ops through a tuple local to verilog/optimize.py, which stays
# the JAX package's module byte for byte
LOGIC_OPS = ("AND", "OR", "XOR", "XNOR", "NOT", "NAND", "NOR", "IMP", "NIMP",
             "YES")

# design -> (source, top module, ports driven by INPUT devices)
SYNTH_DESIGNS = {
    "rv32": (RV32_SRC, "pe_rv32", ("clk", "rst_n")),
    "fp16_add": (FP16_ADD_SRC, "fp16_add", ("a", "b")),
}

# synth_counts("rv32", 2)'s (per-type counts, logic gates) as the JAX
# package gives them, every live device counted (the INPUT devices on the
# driven ports too); tests/test_torch_synth_rv32.py holds both packages
# to them
RV32_O2_COUNTS = ({
    "AND": 13962, "DFF_ARSTN": 640, "FULL_ADDER": 251, "HALF_ADDER": 39,
    "INPUT": 18, "NAND": 2, "NON_IMPLICATION": 37, "NOT": 192,
    "OR": 6767, "XNOR": 1, "XOR": 31}, 20992)


def device_counts(nl: Netlist):
    """(live devices by ``mdef.name``, logic gates) of a netlist."""
    live = nl.live_models()
    counts = Counter(m.mdef.name for m in live)
    return (dict(sorted(counts.items())),
            sum(1 for m in live if m.mdef.digital_op in LOGIC_OPS))


class Synth(NamedTuple):
    circuit: Circuit
    ins: Dict[str, List]        # port -> INPUT device per bit
    nets: Dict[str, List]       # port -> net per bit, LSB first
    report: object              # SynthReport
    counts: Dict[str, int]      # live devices by type
    logic_gates: int
    seconds: float              # synthesis wall time on the host


def synth_counts(design: str, opt_level: int = 1, binary: bool = False,
                 device="cuda") -> Synth:
    """``design`` ("rv32" or "fp16_add", see ``SYNTH_DESIGNS``)
    synthesized at ``opt_level`` into a Circuit on ``device``, with its
    device counts."""
    src, top, inputs = SYNTH_DESIGNS[design]
    t0 = time.perf_counter()
    c, ins, pn, rep = synth_top(src, top, device, opt_level, inputs=inputs,
                                binary=binary)
    sec = time.perf_counter() - t0
    counts, logic = device_counts(c.nl)
    return Synth(c, ins, pn, rep, counts, logic, sec)


# binary-domain functions of the combinational macro devices, as gates:
# out pin -> expression over the input pins (see comb_graph)
_MACROS = {
    "HALF_ADDER": {"s": ("XOR", "ia", "ib"), "c": ("AND", "ia", "ib")},
    "FULL_ADDER": {
        "s": ("XOR", ("XOR", "ia", "ib"), "cin"),
        "cout": ("OR", ("AND", "ia", "ib"),
                 ("AND", "cin", ("XOR", "ia", "ib")))},
    "HALF_SUBTRACTOR": {"d": ("XOR", "ia", "ib"), "b": ("NIMP", "ib", "ia")},
    "FULL_SUBTRACTOR": {
        "d": ("XOR", ("XOR", "ia", "ib"), "bin"),
        "bout": ("OR", ("NIMP", "ib", "ia"),
                 ("AND", "bin", ("XNOR", "ia", "ib")))},
    "MUL2": {
        "p0": ("AND", "a0", "b0"),
        "p1": ("XOR", ("AND", "a1", "b0"), ("AND", "a0", "b1")),
        "p2": ("XOR", ("AND", "a1", "b1"),
               ("AND", ("AND", "a1", "b0"), ("AND", "a0", "b1"))),
        "p3": ("AND", ("AND", "a1", "b1"),
               ("AND", ("AND", "a1", "b0"), ("AND", "a0", "b1")))},
}
_GATES = ("AND", "OR", "XOR", "XNOR", "NAND", "NOR", "IMP", "NIMP", "NOT",
          "YES")


def comb_graph(nl: Netlist, outputs, key=id, names=None):
    """The binary-domain combinational function of a gate netlist as an
    ``opt_graph.GateGraph``: logic gates and the adder / subtractor / MUL2
    macros become graph gates, a synthesis-constant INPUT a constant, and
    every other net (a real INPUT's, a flip-flop's output) a leaf.
    ``outputs``: the nets whose cones the graph holds.  ``key(net)`` names
    leaves and outputs, and ``names`` (a dict passed to both calls) holds
    one stand-in net per name, so the graphs of two netlists of one design
    (two optimization levels) share leaves and outputs and compare with
    ``graphs_equivalent``."""
    from .verilog.opt_graph import GateGraph

    names = {} if names is None else names

    def name(net):
        return names.setdefault(key(net), _NamedNet(key(net)))

    driver = {}
    for inst in nl.live_models():
        op = inst.mdef.digital_op
        if op in _GATES or op in _MACROS or op == "INPUT":
            for k in inst.mdef.dout_pins:
                node = inst.pins[k].node
                if node is not None:
                    driver[id(node)] = (inst, inst.mdef.pins[k])
    g = GateGraph()
    done: Dict[int, int] = {}

    def expr(inst, e):
        if isinstance(e, str):
            return net_node(inst.pins[inst.mdef.pins.index(e)].node)
        return g.gate(e[0], *[expr(inst, a) for a in e[1:]])

    def net_node(net):
        if id(net) in done:
            return done[id(net)]
        d = driver.get(id(net))
        if d is None:
            idx = g.leaf(name(net))
        else:
            inst, pin = d
            op = inst.mdef.digital_op
            if op == "INPUT":
                idx = (g.const(int(inst.params.get("boolean", 2)))
                       if inst.params.get("synth_const") else
                       g.leaf(name(net)))
            elif op in _MACROS:
                idx = expr(inst, _MACROS[op][pin])
            else:
                ins = [net_node(inst.pins[k].node)
                       for k in inst.mdef.din_pins]
                idx = ins[0] if op == "YES" else g.gate(op, *ins)
        done[id(net)] = idx
        return idx

    import sys
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 100_000))
    try:
        for net in outputs:
            g.set_output(name(net), net_node(net))
    finally:
        sys.setrecursionlimit(limit)
    return g


class _NamedNet:
    """A stand-in net of ``comb_graph``, named by its key."""

    def __init__(self, key):
        self.key = key


def ff_cone_outputs(nl: Netlist, ports) -> List:
    """The nets a sequential design's next state and outputs depend on:
    every flip-flop / latch input net, then the given port nets."""
    outs, seen = [], set()
    for inst in nl.live_models():
        if inst.mdef.digital_op in ("DFF", "DFF_ARSTN", "DLATCH", "JKFF",
                                    "TFF", "TBARFF"):
            for k in inst.mdef.din_pins:
                node = inst.pins[k].node
                if node is not None and id(node) not in seen:
                    seen.add(id(node))
                    outs.append(node)
    for net in ports:
        if id(net) not in seen:
            seen.add(id(net))
            outs.append(net)
    return outs


class Rv32(NamedTuple):
    circuit: Circuit
    clk: object                 # INPUT device on clk
    rst: object                 # INPUT device on rst_n
    ports: Dict[str, List]      # port -> nets, LSB first
    gates: int                  # synthesized gates + flip-flops
    expect: int


def build_rv32(device="cuda", opt_level: int = 1) -> Rv32:
    """The RV32 core synthesized at ``opt_level`` into a Circuit."""
    return rv32_of(synth_counts("rv32", opt_level, device=device))


def rv32_of(syn: "Synth") -> Rv32:
    """The RV32 core of a ``synth_counts("rv32", ...)`` result."""
    rep = syn.report
    return Rv32(syn.circuit, syn.ins["clk"][0], syn.ins["rst_n"][0],
                syn.nets, rep.gate_count + rep.ff_count, RV32_EXPECT)


def rv32_of_penl(c: Circuit) -> Rv32:
    """The RV32 core of a Circuit that ``io.load`` read from
    ``cli.verilog2penl``'s ``.penl`` of ``pe_rv32``: the INPUT devices
    ``clk[0]`` / ``rst_n[0]`` and the nets ``result[i]`` / ``done[0]``
    found by name.  The CLI leaves its INPUT devices at X; both are set
    to 0 here, as ``synth_top`` builds them, so ``rv32_schedules`` gives
    the same stimulus.  ``gates``: the live devices but INPUT / OUTPUT."""
    ins = c.digital_inputs()
    for name in ("clk[0]", "rst_n[0]"):
        ins[name].set_attribute("boolean", 0.0)
    nets = {n.name: n for n in c.nl.nodes}
    ports = {"result": [nets[f"result[{i}]"] for i in range(32)],
             "done": [nets["done[0]"]]}
    gates = sum(1 for m in c.nl.live_models()
                if m.mdef.digital_op not in ("INPUT", "OUTPUT"))
    return Rv32(c, ins["clk[0]"], ins["rst_n[0]"], ports, gates, RV32_EXPECT)


def rv32_schedules(d: Rv32, cycles: int):
    """(reset, body): settle plus a reset pulse, then ``cycles`` full
    clocks with reset released (bench_digital.py's schedule)."""
    reset = [{}, {d.clk: 1}, {d.clk: 0}, {d.rst: 1}]
    body = []
    for _ in range(cycles):
        body += [{d.clk: 1, d.rst: 1}, {d.clk: 0, d.rst: 1}]
    return reset, body


def rv32_run(batch: int = 1, cycles: int = 200, device="cuda",
             design: Rv32 = None):
    """Reset the core and clock it ``cycles`` times, ``batch`` instances
    (one ``digital_run`` when batch == 1, else ``digital_run_batch`` from
    the common post-reset state).  Returns (result (batch,) int64, done
    (batch,) int8): the ``result`` bus and the ``done`` code at the last
    tick, lane 0."""
    d = design if design is not None else build_rv32(device)
    c = d.circuit
    c.digital_engine().reset_state()
    reset, body = rv32_schedules(d, cycles)
    c.digital_run(reset)
    if batch == 1:
        tr = c.digital_run(body)
        res = tr.bus_values(d.ports["result"])[-1:]
        done = tr.node_codes(d.ports["done"][0])[-1:]
        return res, done
    codes = c.digital_run_batch([body] * batch,
                                d.ports["result"] + d.ports["done"])
    last = codes[:, -1].astype(np.int64)          # (B, 33)
    bits = (last[:, :32] == 1).astype(np.int64)
    res = (bits << np.arange(32, dtype=np.int64)).sum(axis=1)
    return res, codes[:, -1, 32]


def rv32_levels(d: Rv32, cycles: int):
    """The RV32 core from power-up through ``rv32_schedules(d, cycles)``
    (reset, then ``cycles`` clocks) on the levelled tick, which
    ``digital_run`` does not take for it (the design is turbo-eligible).
    Returns (forced_sig, FV, FU) of that schedule and the history
    (hv, hu) as int32 device tensors (T, n_signals); the final state is
    committed."""
    eng = d.circuit.digital_engine()
    eng.reset_state()
    reset, body = rv32_schedules(d, cycles)
    _e, fs, FV, FU = d.circuit._compile_schedule(reset + body)
    hv, hu, last = eng.run_levels(fs, FV[None], FU[None])
    eng.commit(*last)
    return (fs, FV, FU), (hv[0], hu[0])


# ---------------------------------------------------------------------------
# mixed signal: the SAR ADC (tests/test_adc.py, test/0028.16b_adc)
# ---------------------------------------------------------------------------

SAR_R = 10e3
SAR_VREF = 5.0


def sar_src(bits: int = 8) -> str:
    """Verilog of a ``bits``-bit successive-approximation register:
    ``bits`` = 8 is tests/test_adc.py's ``sar8``, text for text."""
    n, w = bits, (bits - 1).bit_length() + 1
    msb, half = f"{n}'h{1 << (n - 1):X}", f"{n}'h{1 << (n - 2):X}"
    return f"""
module sar{n}(input clk, input rst_n, input cmp,
            output reg [{n - 1}:0] dac, output reg [{n - 1}:0] code,
            output reg done);
  reg [{w - 1}:0] step;
  always @(posedge clk or negedge rst_n) begin
    if (!rst_n) begin
      dac <= {msb};
      code <= {n}'h{0:0{n // 4}X};
      step <= {w}'d0;
      done <= 1'b0;
    end else if (!done) begin
      if (cmp) code <= code | ({msb} >> step);
      if (step == {w}'d{n - 1}) begin
        done <= 1'b1;
        dac <= cmp ? dac : (dac & ~({msb} >> step));
      end else begin
        dac <= (cmp ? dac : (dac & ~({msb} >> step)))
               | ({half} >> step);
        step <= step + {w}'d1;
      end
    end
  end
endmodule
"""


class Sar(NamedTuple):
    circuit: Circuit
    clk: object                 # INPUT device on clk
    rst: object                 # INPUT device on rst_n
    vin: object                 # the VDC of the input voltage
    ports: Dict[str, List]      # port -> nets, LSB first
    n_dac: object               # the R-2R ladder's output net
    bits: int


def sar_adc(bits: int = 8, device="cuda") -> Sar:
    """A ``bits``-bit SAR ADC (tests/test_adc.py's ``build_adc``, the
    reference's test/0028.16b_adc at 16 bits): the synthesized SAR logic
    at -O1 drives an R-2R DAC (R = 10 kOhm, LSB first, 2R terminator)
    through digital drive slots, and a comparator of the input VDC
    against the DAC output closes the loop."""
    from .models.controller import COMPARATOR
    from .verilog import build_design, compile_source, elaborate, find_module
    from .verilog.synth import SynthOptions, synthesize_to_netlist
    design = build_design(compile_source(sar_src(bits)))
    topm = find_module(design, f"sar{bits}")
    inst = elaborate(design, topm)
    c = Circuit(device=device)
    nl = c.nl
    pn = {p: [netops.create_node(nl) for _ in range(inst.signals[p].width)]
          for p in topm.ports}
    clk = netops.add_model(nl, INPUT, {"boolean": 0.0})
    rst = netops.add_model(nl, INPUT, {"boolean": 0.0})
    netops.add_to_node(nl, clk, 0, pn["clk"][0])
    netops.add_to_node(nl, rst, 0, pn["rst_n"][0])
    # the analog side before synthesis, so the dac port nets are hybrid
    vin = netops.add_model(nl, VDC, {"V": 0.0})
    n_vin = netops.create_node(nl)
    netops.add_to_node(nl, vin, 0, n_vin)
    netops.add_to_node(nl, vin, 1, nl.ground_node)
    ladder = [netops.create_node(nl) for _ in range(bits)]
    rt = netops.add_model(nl, RESISTANCE, {"r": 2 * SAR_R})
    netops.add_to_node(nl, rt, 0, ladder[0])
    netops.add_to_node(nl, rt, 1, nl.ground_node)
    for i in range(bits):
        r2 = netops.add_model(nl, RESISTANCE, {"r": 2 * SAR_R})
        netops.add_to_node(nl, r2, 0, pn["dac"][i])
        netops.add_to_node(nl, r2, 1, ladder[i])
        if i < bits - 1:
            r1 = netops.add_model(nl, RESISTANCE, {"r": SAR_R})
            netops.add_to_node(nl, r1, 0, ladder[i])
            netops.add_to_node(nl, r1, 1, ladder[i + 1])
    cmp_ = netops.add_model(nl, COMPARATOR)
    netops.add_to_node(nl, cmp_, 0, n_vin)
    netops.add_to_node(nl, cmp_, 1, ladder[-1])
    netops.add_to_node(nl, cmp_, 2, pn["cmp"][0])
    synthesize_to_netlist(nl, design, inst, pn, SynthOptions(opt_level=1))
    c.set_analyze_type(AnalyzeType.OP)
    return Sar(c, clk, rst, vin, pn, ladder[-1], bits)


def sar_convert(adc: Sar, v_in: float):
    """One conversion (tests/test_adc.py's ``convert``): a reset pulse,
    then SAR clocks alternating ``digital_clk`` with ``analyze`` until
    ``done``.  Returns (code, DAC output voltage); raises when the
    conversion does not finish."""
    c, clk, rst = adc.circuit, adc.clk, adc.rst
    adc.vin.set_attribute("V", v_in)
    rst.set_attribute("boolean", 0.0)
    c.analyze()
    c.digital_clk()
    for lv in (1.0, 0.0):
        clk.set_attribute("boolean", lv)
        c.digital_clk()
    rst.set_attribute("boolean", 1.0)
    c.digital_clk()
    c.analyze()
    c.digital_clk()              # comparator sees the MSB trial
    done = 0
    for _cycle in range(adc.bits + 1):
        clk.set_attribute("boolean", 1.0)
        c.digital_clk()          # SAR clocks in the comparator decision
        c.analyze()              # DAC settles with the new trial code
        clk.set_attribute("boolean", 0.0)
        c.digital_clk()          # comparator re-samples the settled DAC
        c.analyze()
        done = c.node_digital(adc.ports["done"][0])
        if done == 1:
            break
    if done != 1:
        raise RuntimeError(f"SAR conversion of {v_in} V never finished")
    code = sum((c.node_digital(n) & 1) << i
               for i, n in enumerate(adc.ports["code"]))
    return code, c.node_voltage(adc.n_dac).real


# ---------------------------------------------------------------------------
# large systems: the resistor ladders (bench_ladder.py) and the random-link
# meshes (bench_sparse.py, tests/test_sparse.py)
# ---------------------------------------------------------------------------

LADDER_R, LADDER_V = 30.0, 3.0
MESH_R, MESH_V = 1000.0, 1.0


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def ladder_netlist(n_res: int) -> Netlist:
    """The reference's series chain (benchmark/0001.models/1000000xR.cpp):
    a VDC of ``LADDER_V`` from the top node to ground across ``n_res``
    resistors of ``LADDER_R`` in series (bench_ladder.py:41-61)."""
    nl = Netlist()
    v = netops.add_model(nl, VDC, {"V": LADDER_V})
    top = netops.create_node(nl)
    netops.add_to_node(nl, v, 0, top)
    netops.add_to_node(nl, v, 1, nl.ground_node)
    prev = top
    for _ in range(n_res - 1):
        r = netops.add_model(nl, RESISTANCE, {"r": LADDER_R})
        nxt = netops.create_node(nl)
        netops.add_to_node(nl, r, 0, prev)
        netops.add_to_node(nl, r, 1, nxt)
        prev = nxt
    r = netops.add_model(nl, RESISTANCE, {"r": LADDER_R})
    netops.add_to_node(nl, r, 0, prev)
    netops.add_to_node(nl, r, 1, nl.ground_node)
    return nl


def ladder_ir(n_res: int):
    return lower_analog(ladder_netlist(n_res))


def ladder_extract(rows, cols, vals, Z, n: int):
    """The host's symbolic phase (bench_ladder.py:178-198): the ladder's
    COO system over n unknowns (n - 1 nodes, then the source's branch) as
    a tridiagonal core (dl, d, du), the border column e and the right
    sides (z, rhs_b), host float64."""
    nn = n - 1
    keep = (rows < n) & (cols < n)
    r_, c_, v_ = rows[keep], cols[keep], vals[keep]
    node = (r_ < nn) & (c_ < nn)
    d, dl, du, e = (np.zeros(nn) for _ in range(4))
    diag = node & (r_ == c_)
    np.add.at(d, r_[diag], v_[diag])
    sub = node & (r_ == c_ + 1)
    np.add.at(dl, r_[sub], v_[sub])
    sup = node & (c_ == r_ + 1)
    np.add.at(du, r_[sup], v_[sup])
    brow = (r_ == nn) & (c_ < nn)
    np.add.at(e, c_[brow], v_[brow])
    return dl, d, du, e, np.asarray(Z[:nn], np.float64), float(Z[nn])


def ladder_ramp_tol(n_res: int) -> float:
    """The direct mode's accuracy gate on a native-f64 platform,
    ``max(1e-6, 1e4 eps N)`` with eps = 1.2e-16 (bench_ladder.py:135-137):
    the ladder Laplacian's cond ~N^2 sets every backward-stable solver's
    forward error."""
    return max(1e-6, 1e4 * 1.2e-16 * n_res)


def ladder_dc(n_res: int = 10 ** 6, refine: int = 4, solves: int = 5,
              device="cuda") -> dict:
    """The port's ``bench_ladder.py`` default mode (``main``, :152-249):
    build the ``n_res``-resistor ladder's netlist and IR, assemble its COO
    system on ``device`` (``assemble_sparse``) and fetch it, extract the
    tridiagonal core and the source's border on the host, then solve by
    ``ops.tridiag.border_solve`` (partitioned solves + Schur, ``refine``
    passes): one warm-up solve, then ``solves`` timed ones with varied
    right sides (:213-223).  Returns the timings, the solution and the exact check's
    numbers: v (host) and i_src of the last solve, whose source voltage
    is V times rhs_scale, max_ramp_err, i_err (|i + V/(N R)|) and the
    bench's native-f64 tol (1e-6, :237); ``again`` reruns the last solve
    (for a profiler)."""
    from .ops.tridiag import border_solve
    t0 = time.perf_counter()
    ir = ladder_ir(n_res)
    build_s = time.perf_counter() - t0
    n = ir.n_unknowns                        # n_res nodes + 1 branch
    params = analog.initial_params(ir, device)
    states = analog.initial_state(ir, device)
    ctx = StampCtx(mode="op", t=0.0, dt=0.0, env=default_env())
    x0 = analog.initial_x(ir, device)[None]

    def assemble():
        rows, cols, vals, Z, _ = analog.assemble_sparse(
            ir, {k: v[None] for k, v in params.items()}, x0,
            {k: {s: a[None] for s, a in d.items()} for k, d in states.items()},
            ctx)
        return (rows.cpu().numpy(), cols.cpu().numpy(), vals[0].cpu().numpy(),
                Z[0].cpu().numpy())

    assemble()                                 # plans and patterns built
    _sync(device)
    t0 = time.perf_counter()
    rows, cols, vals, Z = assemble()
    assemble_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dl, d, du, e, z, rhs_b = ladder_extract(rows, cols, vals, Z, n)
    extract_s = time.perf_counter() - t0

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    dl_d, d_d, du_d, e_d = dev(dl), dev(d), dev(du), dev(e)

    def solve(zk, rb):
        return border_solve(dl_d, d_d, du_d, zk, e_d, rb, refine=refine)

    v, i_src = solve(dev(z), dev(rhs_b))
    float(i_src)
    ts = []
    for k in range(solves):
        zk = dev(z + 0.0 * k)                  # vary to defeat memoization
        rbk = dev(rhs_b * (1.0 + 1e-9 * k))
        _sync(device)
        t0 = time.perf_counter()
        v, i_src = solve(zk, rbk)
        float(i_src)
        ts.append(time.perf_counter() - t0)
    v = v.cpu().numpy()
    ramp = LADDER_V - np.arange(n - 1) * (LADDER_V / n_res)
    i_exp = LADDER_V / (n_res * LADDER_R)
    return dict(n_res=n_res, build_s=build_s, assemble_s=assemble_s,
                again=lambda: solve(zk, rbk),
                extract_s=extract_s, solve_s=ts, v=v, i_src=float(i_src),
                rhs_scale=1.0 + 1e-9 * (solves - 1) if solves else 1.0,
                max_ramp_err=float(np.abs(v - ramp).max()),
                i_err=abs(float(i_src) + i_exp), i_exp=i_exp, tol=1e-6)


def ladder_direct(n_res: int = 10 ** 8, chunks: int = 512, nbatch: int = 4,
                  refine: int = 1, solves: int = 3, device="cuda") -> dict:
    """The port's ``bench_ladder.py`` solver-scale mode (``main_direct``,
    :64-149, the reference's 100000000xR.cpp): the ladder's tridiagonal
    core and unit border synthesized directly at ``n_res`` (a netlist of
    10^8 instances is out of scope for both object models): dl and du
    built on ``device``, the pivot table from ``spike_host_pivots`` in
    host f64, then ``spike_border_solve_unit_factor`` (SPIKE, ``chunks``
    chunks in ``nbatch`` sub-batches) and ``solves`` timed bordered solves
    (``refine`` passes) after a warm-up.  Returns the factor's seconds,
    the solve seconds, the last solve's ramp sampled at nodes 0, N/2 and
    N - 1 (its source voltage V times rhs_scale), the check's numbers and
    ``again``, which reruns the last solve."""
    from .ops.tridiag import (spike_border_solve_unit,
                              spike_border_solve_unit_factor,
                              spike_host_pivots)
    g = 1.0 / LADDER_R
    f64 = torch.float64
    dl = torch.full((n_res,), -g, dtype=f64, device=device)
    du = torch.full((n_res,), -g, dtype=f64, device=device)
    _sync(device)
    t0 = time.perf_counter()
    d_h = np.full(n_res, 2.0 * g)
    d_h[0] = g
    off = np.full(n_res, -g)
    dp = spike_host_pivots(off, d_h, off, chunks)
    del d_h, off
    pivots_s = time.perf_counter() - t0
    fac, t_e, ete = spike_border_solve_unit_factor(
        dl, None, du, idx=0, chunks=chunks, nbatch=nbatch, dp=dp)
    del dp, dl, du
    _sync(device)
    factor_s = time.perf_counter() - t0
    z = torch.zeros(n_res, dtype=f64, device=device)

    def solve(rb):
        return spike_border_solve_unit(fac, t_e, ete, z, rb, idx=0,
                                       refine=refine)

    v, i_src = solve(torch.tensor(LADDER_V, dtype=f64, device=device))
    float(i_src)
    ts = []
    for k in range(solves):
        rbk = torch.tensor(LADDER_V * (1.0 + 1e-9 * k), dtype=f64,
                           device=device)
        _sync(device)
        t0 = time.perf_counter()
        v, i_src = solve(rbk)
        float(i_src)
        ts.append(time.perf_counter() - t0)
    idx = np.array([0, n_res // 2, n_res - 1])
    vs = v[torch.as_tensor(idx, device=v.device)].cpu().numpy()
    ramp = LADDER_V - idx * (LADDER_V / n_res)
    i_exp = LADDER_V / (n_res * LADDER_R)
    return dict(n_res=n_res, chunks=chunks, nbatch=nbatch, refine=refine,
                again=lambda: solve(rbk),
                pivots_s=pivots_s, factor_s=factor_s, solve_s=ts,
                v_sampled=vs, i_src=float(i_src),
                rhs_scale=1.0 + 1e-9 * (solves - 1) if solves else 1.0,
                max_ramp_err=float(np.abs(vs - ramp).max()),
                i_err=abs(float(i_src) + i_exp), i_exp=i_exp,
                tol=ladder_ramp_tol(n_res))


def sparse_mesh_coo(n: int, links: int, seed: int = 1):
    """The reference's 100000_random_links_* topology
    (100000_random_links_cpu.cpp:120-165; bench_sparse.py ``build_coo``,
    :33-72): ground -> n0 chain -> n_{N-1} of ``MESH_R``, a VDC of
    ``MESH_V`` at n_{N-1} (one branch unknown) and ``links`` random links
    of ``MESH_R``.  Returns host (rows, cols, vals, z) over n + 1
    unknowns."""
    rng = np.random.default_rng(seed)
    g = 1.0 / MESH_R
    gl = 1.0 / MESH_R
    rows, cols, vals = [[0]], [[0]], [[g]]
    i = np.arange(n - 1)
    rows += [i, i + 1, i, i + 1]
    cols += [i, i + 1, i + 1, i]
    vals += [np.full(n - 1, g), np.full(n - 1, g),
             np.full(n - 1, -g), np.full(n - 1, -g)]
    a = rng.integers(0, n, links)
    b = rng.integers(0, n, links)
    fix = a == b
    b[fix] = (b[fix] + 1) % n
    rows += [a, b, a, b]
    cols += [a, b, b, a]
    vals += [np.full(links, gl), np.full(links, gl),
             np.full(links, -gl), np.full(links, -gl)]
    br = n
    rows += [[n - 1], [br]]
    cols += [[br], [n - 1]]
    vals += [[1.0], [1.0]]
    z = np.zeros(n + 1)
    z[br] = MESH_V
    rows = np.concatenate([np.asarray(r) for r in rows]).astype(np.int32)
    cols = np.concatenate([np.asarray(c) for c in cols]).astype(np.int32)
    vals = np.concatenate([np.asarray(v, np.float64) for v in vals])
    return rows, cols, vals, z


def sparse_mesh_solve(rows, cols, vals, z, max_iter: int = 20000,
                      solves: int = 3, device="cuda") -> dict:
    """The port's ``bench_sparse.py`` device case (``tpu_case``, :75-100):
    ``BandedCOO`` + ``bicgstab_ell`` (tol 1e-10, ``max_iter``) on the
    right side z scaled by 1, then ``solves`` timed solves at scales
    1 + 1e-3 (k + 1).  Returns ok, the iterations, the seconds of each
    timed solve (none when the first solve did not converge), the last
    solution x with its scale, and ``again``, which reruns a solve."""
    from .ops.sparse import BandedCOO, bicgstab_ell
    ell = BandedCOO(rows, cols, len(z))
    vals_d = torch.as_tensor(vals, dtype=torch.float64, device=device)
    z_d = torch.as_tensor(z, dtype=torch.float64, device=device)

    def solve(scale):
        return bicgstab_ell(ell, vals_d, z_d * scale, tol=1e-10,
                            max_iter=max_iter)

    x, ok, it = solve(1.0)
    out = dict(ok=bool(ok), iters=int(it), solve_s=[], x=x.cpu().numpy(),
               scale=1.0, again=lambda: solve(1.0))
    if not out["ok"]:
        return out
    for k in range(solves):
        scale = 1.0 + 1e-3 * (k + 1)
        _sync(device)
        t0 = time.perf_counter()
        x, ok, it = solve(scale)
        x = x.cpu().numpy()
        out["solve_s"].append(time.perf_counter() - t0)
        out.update(ok=out["ok"] and bool(ok), iters=int(it), x=x, scale=scale)
    return out


def sparse_mesh_splu(rows, cols, vals, z, solves: int = 3):
    """bench_sparse.py's host denominator (``cpu_case``, :103-116, which
    runs max(2, 3) solves): scipy SparseLU, factor and solve each time, at
    right sides scaled 1 + 1e-3 (k + 1).  Returns (seconds of each solve,
    the last solution, its scale)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    nu = len(z)
    ts, x, scale = [], None, 1.0
    for k in range(solves):
        scale = 1.0 + 1e-3 * (k + 1)
        t0 = time.perf_counter()
        A = sp.csc_matrix((vals, (rows, cols)), shape=(nu, nu))
        x = spl.splu(A).solve(z * scale)
        ts.append(time.perf_counter() - t0)
    return ts, x, scale


def random_mesh_netlist(n_nodes: int = 400, n_links: int = 1600,
                        seed: int = 3):
    """tests/test_sparse.py:14-38's random mesh: a VDC of 5 V on node 0,
    a grounding resistor on every ``n_nodes // 8``-th node and
    ``n_links`` random links (a self-loop draw is skipped), resistances
    uniform in 10 Ω .. 10 kΩ, the same draws in the same order.  Returns
    (netlist, nodes)."""
    rng = np.random.default_rng(seed)
    nl = Netlist()
    nodes = [netops.create_node(nl) for _ in range(n_nodes)]
    v = netops.add_model(nl, VDC, {"V": 5.0})
    netops.add_to_node(nl, v, 0, nodes[0])
    netops.add_to_node(nl, v, 1, nl.ground_node)
    for k in range(0, n_nodes, max(1, n_nodes // 8)):
        r = netops.add_model(nl, RESISTANCE,
                             {"r": float(rng.uniform(10, 1e4))})
        netops.add_to_node(nl, r, 0, nodes[k])
        netops.add_to_node(nl, r, 1, nl.ground_node)
    for _ in range(n_links):
        a, b = rng.integers(0, n_nodes, 2)
        if a == b:
            continue
        r = netops.add_model(nl, RESISTANCE,
                             {"r": float(rng.uniform(10, 1e4))})
        netops.add_to_node(nl, r, 0, nodes[int(a)])
        netops.add_to_node(nl, r, 1, nodes[int(b)])
    return nl, nodes
