"""The digital cases of ``tests/test_digital.py`` (and a few more), free of
JAX, in a form that runs in either package: ``CASES[name](pe, rec)``
builds its netlist in package ``pe`` (the JAX package or the port), drives
it through ``digital_clk`` / ``analyze`` / ``digital_run`` exactly as the
JAX test does, and records what it observes into ``rec`` (a :class:`Rec`
made with the Circuit factory of that package).  Two records of one case
compare with :func:`assert_same`: every plane after every tick and every
node code bit-identical, node voltages to ``VTOL``.

The card tests run every case on the card and on the CPU; the parity
tests run it in both packages on the CPU.
"""

import numpy as np

# relative to max|v| of the reference (the same f64 solves, in another
# summation order)
VTOL = 1e-9

COUNTER_SRC = """
module counter(input clk, input rst_n, output reg [3:0] q);
  always @(posedge clk or negedge rst_n)
    if (!rst_n) q <= 4'd0; else q <= q + 4'd1;
endmodule
"""

# an incomplete always @*: q holds when en is low, a latch that synthesis
# builds as gate feedback (the engine's cyclic fixpoint)
LATCH_SRC = """
module lat(input en, input d, input s, output reg q, output y);
  always @* begin
    if (en) q = d ^ s;
  end
  assign y = q & s;
endmodule
"""

L, H, X, Z = 0, 1, 2, 3


class Rec:
    """Observations of one run: ('planes', sv, su) after every tick,
    ('codes', [...]), ('ok', bool) and ('v', [...]) node voltages."""

    def __init__(self, make_circuit):
        self.circuit = make_circuit
        self.items = []

    def snap(self, c, *nodes):
        eng = c._digital
        self.items.append(("planes", np.asarray(eng.sv).copy(),
                           np.asarray(eng.su).copy()))
        if nodes:
            self.items.append(("codes", [int(c.node_digital(n))
                                         for n in nodes]))

    def clk(self, c, *nodes):
        c.digital_clk()
        self.snap(c, *nodes)

    def analyze(self, c):
        ok = bool(c.analyze())
        self.items.append(("ok", ok))
        return ok

    def volts(self, c, *nodes):
        self.items.append(("v", [float(c.node_voltage(n).real)
                                 for n in nodes]))

    def value(self, *vals):
        self.items.append(("codes", [int(v) for v in vals]))


def assert_same(a: Rec, b: Rec, vtol=VTOL):
    """``a`` (under test) against ``b`` (the reference)."""
    assert [i[0] for i in a.items] == [i[0] for i in b.items]
    for k, (x, y) in enumerate(zip(a.items, b.items)):
        if x[0] == "planes":
            np.testing.assert_array_equal(x[1], y[1], err_msg=f"sv {k}")
            np.testing.assert_array_equal(x[2], y[2], err_msg=f"su {k}")
        elif x[0] == "v":
            ref = np.asarray(y[1])
            scale = max(float(np.abs(ref).max()), 1.0)
            assert np.abs(np.asarray(x[1]) - ref).max() <= vtol * scale, \
                (k, x[1], y[1])
        else:
            assert x[1] == y[1], (k, x, y)


def wire(pe, nl, *pins):
    n = pe.netops.create_node(nl)
    for inst, pi in pins:
        pe.netops.add_to_node(nl, inst, pi, n)
    return n


def _inp(pe, nl, code):
    return pe.netops.add_model(nl, pe.models.INPUT, {"boolean": float(code)})


def _mk(pe, rec):
    c = rec.circuit()
    c.set_analyze_type(pe.AnalyzeType.OP)
    return c, c.nl


def and_gate(pe, rec):
    for a_code, b_code in [(L, L), (L, H), (H, L), (H, H), (X, H), (X, L),
                           (Z, H), (Z, L), (X, X)]:
        c, nl = _mk(pe, rec)
        ia, ib = _inp(pe, nl, a_code), _inp(pe, nl, b_code)
        g = pe.netops.add_model(nl, pe.models.AND)
        out = pe.netops.add_model(nl, pe.models.OUTPUT)
        wire(pe, nl, (ia, 0), (g, 0))
        wire(pe, nl, (ib, 0), (g, 1))
        n_o = wire(pe, nl, (g, 2), (out, 0))
        rec.clk(c, n_o)
        rec.value(out.params["value"])


def not_chain(pe, rec):
    c, nl = _mk(pe, rec)
    src = _inp(pe, nl, H)
    prev = wire(pe, nl, (src, 0))
    for _ in range(20):
        g = pe.netops.add_model(nl, pe.models.NOT)
        pe.netops.add_to_node(nl, g, 0, prev)
        prev = wire(pe, nl, (g, 1))
    rec.clk(c, prev)


def xor_nand(pe, rec):
    c, nl = _mk(pe, rec)
    a, b = _inp(pe, nl, H), _inp(pe, nl, L)
    x = pe.netops.add_model(nl, pe.models.XOR)
    nd = pe.netops.add_model(nl, pe.models.NAND)
    wire(pe, nl, (a, 0), (x, 0), (nd, 0))
    wire(pe, nl, (b, 0), (x, 1), (nd, 1))
    nx, nn = wire(pe, nl, (x, 2)), wire(pe, nl, (nd, 2))
    rec.clk(c, nx, nn)


def dff_rising_edge(pe, rec):
    c, nl = _mk(pe, rec)
    d_in, clk = _inp(pe, nl, H), _inp(pe, nl, L)
    ff = pe.netops.add_model(nl, pe.models.D_FF)
    wire(pe, nl, (d_in, 0), (ff, 0))
    wire(pe, nl, (clk, 0), (ff, 1))
    nq = wire(pe, nl, (ff, 2))
    rec.clk(c, nq)
    for dev, v in ((clk, H), (d_in, L), (clk, L), (clk, H)):
        dev.set_attribute("boolean", float(v))
        rec.clk(c, nq)


def counter4(pe, rec):
    c, nl = _mk(pe, rec)
    clk, en = _inp(pe, nl, L), _inp(pe, nl, H)
    cnt = pe.netops.add_model(nl, pe.models.COUNTER4)
    wire(pe, nl, (clk, 0), (cnt, 4))
    wire(pe, nl, (en, 0), (cnt, 5))
    qs = [wire(pe, nl, (cnt, i)) for i in range(4)]
    rec.clk(c, *qs)
    for k in range(1, 6):
        if k == 4:
            en.set_attribute("boolean", float(X))    # X enable: unknown
        for v in (H, L):
            clk.set_attribute("boolean", float(v))
            rec.clk(c, *qs)


def tick_delay(pe, rec):
    c, nl = _mk(pe, rec)
    src = _inp(pe, nl, H)
    td = pe.netops.add_model(nl, pe.models.TICK_DELAY)
    wire(pe, nl, (src, 0), (td, 0))
    n_o = wire(pe, nl, (td, 1))
    rec.clk(c, n_o)
    rec.clk(c, n_o)
    src.set_attribute("boolean", float(L))
    rec.clk(c, n_o)
    rec.clk(c, n_o)


def full_adder(pe, rec):
    for a, b, cin in [(L, L, L), (H, L, L), (H, H, L), (H, H, H),
                      (X, L, L)]:
        c, nl = _mk(pe, rec)
        ins = [_inp(pe, nl, v) for v in (a, b, cin)]
        fa = pe.netops.add_model(nl, pe.models.FULL_ADDER)
        for k, m in enumerate(ins):
            wire(pe, nl, (m, 0), (fa, k))
        rec.clk(c, wire(pe, nl, (fa, 3)), wire(pe, nl, (fa, 4)))


def latch_transparent(pe, rec):
    c, nl = _mk(pe, rec)
    d, en = _inp(pe, nl, H), _inp(pe, nl, H)
    lat = pe.netops.add_model(nl, pe.models.D_LATCH)
    wire(pe, nl, (d, 0), (lat, 0))
    wire(pe, nl, (en, 0), (lat, 1))
    nq = wire(pe, nl, (lat, 2))
    rec.clk(c, nq)
    en.set_attribute("boolean", float(L))
    d.set_attribute("boolean", float(L))
    rec.clk(c, nq)
    en.set_attribute("boolean", float(X))
    rec.clk(c, nq)


def tri_state_resolve2(pe, rec):
    c, nl = _mk(pe, rec)
    d1, e1, d2, e2 = (_inp(pe, nl, v) for v in (H, H, L, L))
    t1 = pe.netops.add_model(nl, pe.models.TRI_STATE)
    t2 = pe.netops.add_model(nl, pe.models.TRI_STATE)
    res = pe.netops.add_model(nl, pe.models.RESOLVE2)
    wire(pe, nl, (d1, 0), (t1, 0))
    wire(pe, nl, (e1, 0), (t1, 1))
    wire(pe, nl, (d2, 0), (t2, 0))
    wire(pe, nl, (e2, 0), (t2, 1))
    wire(pe, nl, (t1, 2), (res, 0))
    wire(pe, nl, (t2, 2), (res, 1))
    n_o = wire(pe, nl, (res, 2))
    rec.clk(c, n_o)
    e1.set_attribute("boolean", float(L))
    rec.clk(c, n_o)
    e2.set_attribute("boolean", float(H))
    rec.clk(c, n_o)


def jk_t_flipflops(pe, rec):
    """test_jkff_and_tff's JK flip-flop, with a T and a T-bar flip-flop on
    the same clock."""
    c, nl = _mk(pe, rec)
    j, k, clk, t = (_inp(pe, nl, v) for v in (H, H, L, H))
    ff = pe.netops.add_model(nl, pe.models.JK_FF)
    tf = pe.netops.add_model(nl, pe.models.T_FF)
    tb = pe.netops.add_model(nl, pe.models.T_BAR_FF)
    wire(pe, nl, (j, 0), (ff, 0))
    wire(pe, nl, (k, 0), (ff, 1))
    wire(pe, nl, (clk, 0), (ff, 2), (tf, 1), (tb, 1))
    wire(pe, nl, (t, 0), (tf, 0), (tb, 0))
    nodes = [wire(pe, nl, (ff, 3)), wire(pe, nl, (tf, 2)),
             wire(pe, nl, (tb, 2))]
    rec.clk(c, *nodes)
    for jk, tv in ((H, H), (L, L), (H, X), (X, L)):
        k.set_attribute("boolean", float(jk))
        t.set_attribute("boolean", float(tv))
        for v in (H, L):
            clk.set_attribute("boolean", float(v))
            rec.clk(c, *nodes)


def eight_bit_io(pe, rec):
    c, nl = _mk(pe, rec)
    src = pe.netops.add_model(nl, pe.models.EIGHT_BIT_INPUT, {"value": 0xA5})
    dst = pe.netops.add_model(nl, pe.models.EIGHT_BIT_DISPLAY)
    for i in range(8):
        wire(pe, nl, (src, i), (dst, i))
    rec.clk(c)
    rec.value(dst.params["value"], dst.params["unknown_mask"])
    src.set_attribute("value", 0x3C)
    rec.clk(c)
    rec.value(dst.params["value"], dst.params["unknown_mask"])


def comparator(pe, rec):
    c, nl = _mk(pe, rec)
    v1 = pe.netops.add_model(nl, pe.models.VDC, {"V": 3.0})
    v2 = pe.netops.add_model(nl, pe.models.VDC, {"V": 2.0})
    r1 = pe.netops.add_model(nl, pe.models.RESISTANCE, {"r": 1e3})
    r2 = pe.netops.add_model(nl, pe.models.RESISTANCE, {"r": 1e3})
    cmp_ = pe.netops.add_model(nl, pe.models.COMPARATOR)
    na = wire(pe, nl, (v1, 0), (r1, 0))
    nb = wire(pe, nl, (v2, 0), (r2, 0))
    for m in (v1, v2, r1, r2):
        pe.netops.add_to_node(nl, m, 1, nl.ground_node)
    pe.netops.add_to_node(nl, cmp_, 0, na)
    pe.netops.add_to_node(nl, cmp_, 1, nb)
    n_o = wire(pe, nl, (cmp_, 2))
    rec.analyze(c)
    rec.clk(c, n_o)
    v2.set_attribute("V", 4.0)
    rec.analyze(c)
    rec.clk(c, n_o)


def gate_drives_analog(pe, rec):
    c, nl = _mk(pe, rec)
    a, b = _inp(pe, nl, H), _inp(pe, nl, H)
    g = pe.netops.add_model(nl, pe.models.AND, {"Hl": 5.0, "Ll": 0.0})
    r = pe.netops.add_model(nl, pe.models.RESISTANCE, {"r": 1e3})
    wire(pe, nl, (a, 0), (g, 0))
    wire(pe, nl, (b, 0), (g, 1))
    n_o = wire(pe, nl, (g, 2), (r, 0))
    pe.netops.add_to_node(nl, r, 1, nl.ground_node)
    rec.analyze(c)
    rec.volts(c, n_o)
    for code in (None, L):
        if code is not None:
            b.set_attribute("boolean", float(code))
        rec.clk(c)
        rec.analyze(c)
        rec.volts(c, n_o)


def schmitt(pe, rec):
    c, nl = _mk(pe, rec)
    v = pe.netops.add_model(nl, pe.models.VDC, {"V": 0.0})
    st = pe.netops.add_model(nl, pe.models.SCHMITT_TRIGGER)
    n_in = wire(pe, nl, (v, 0), (st, 0))
    pe.netops.add_to_node(nl, v, 1, nl.ground_node)
    n_o = wire(pe, nl, (st, 1))
    rec.analyze(c)
    rec.clk(c, n_o)
    for volts in (2.5, 4.0, 2.5, 0.5):
        v.set_attribute("V", volts)
        rec.analyze(c)
        rec.volts(c, n_in)
        rec.clk(c, n_o)


def random4(pe, rec):
    """RANDOM4 (random_generator4.h): seeded LFSR stepping on clk edges,
    reset low clears, X reset makes every bit unknown."""
    c, nl = _mk(pe, rec)
    clk, rst = _inp(pe, nl, L), _inp(pe, nl, H)
    rg = pe.netops.add_model(nl, pe.models.RANDOM_GENERATOR4, {"seed": 11.0})
    wire(pe, nl, (clk, 0), (rg, 4))
    wire(pe, nl, (rst, 0), (rg, 5))
    qs = [wire(pe, nl, (rg, i)) for i in range(4)]
    rec.clk(c, *qs)
    for step in range(9):
        if step == 5:
            rst.set_attribute("boolean", float(L))
        if step == 6:
            rst.set_attribute("boolean", float(H))
        if step == 8:
            rst.set_attribute("boolean", float(X))
        for v in (H, L):
            clk.set_attribute("boolean", float(v))
            rec.clk(c, *qs)


def _synth(pe, rec, src, top, inputs):
    """``src`` synthesized at -O1 into a fresh circuit: one net per port
    bit, an INPUT device per bit of the ports named in ``inputs``."""
    from importlib import import_module
    v = import_module(pe.__name__ + ".verilog")
    synth = import_module(pe.__name__ + ".verilog.synth")
    design = v.build_design(v.compile_source(src))
    topm = v.find_module(design, top)
    inst = v.elaborate(design, topm)
    c = rec.circuit()
    nl = c.nl
    pn = {p: [pe.netops.create_node(nl)
              for _ in range(inst.signals[p].width)] for p in topm.ports}
    ins = {}
    for name in inputs:
        ins[name] = []
        for n in pn[name]:
            m = _inp(pe, nl, L)
            pe.netops.add_to_node(nl, m, 0, n)
            ins[name].append(m)
    synth.synthesize_to_netlist(nl, design, inst, pn,
                                synth.SynthOptions(opt_level=1))
    return c, ins, pn


def digital_run_vs_clk(pe, rec):
    """test_digital_run_scan_matches_per_tick: the synthesized counter
    through digital_run, then the same schedule tick by tick."""
    for mode in ("run", "clk"):
        c, ins, pn = _synth(pe, rec, COUNTER_SRC, "counter",
                            ("clk", "rst_n"))
        clk, rst = ins["clk"][0], ins["rst_n"][0]
        sched = [{}, {clk: 1}, {clk: 0}, {rst: 1}]
        for _ in range(6):
            sched += [{clk: 1, rst: 1}, {clk: 0, rst: 1}]
        if mode == "run":
            tr = c.digital_run(sched)
            rec.items.append(("planes", tr.sv.copy(), tr.su.copy()))
            rec.value(*tr.bus_values(pn["q"]))
            continue
        for entry in sched:
            for m, val in entry.items():
                m.set_attribute("boolean", float(val))
            rec.clk(c, *pn["q"])


def fp16_lanes(pe, rec):
    """test_digital_run_lane_parallel_fp16: 32 stimulus lanes a tick
    through the synthesized fp16 adder."""
    from phy_engine_tpu_torch.workloads import FP16_ADD_SRC
    c, ins, pn = _synth(pe, rec, FP16_ADD_SRC, "fp16_add", ("a", "b"))
    rng = np.random.default_rng(77)
    T = 4
    vec = {n: rng.integers(0, 1 << 16, (T, 32)) for n in ("a", "b")}
    sched = []
    for t in range(T):
        entry = {}
        for name, vals in vec.items():
            for i, m in enumerate(ins[name]):
                word = 0
                for lane in range(32):
                    word |= (int(vals[t, lane]) >> i & 1) << lane
                entry[m] = (word, 0)
        sched.append(entry)
    tr = c.digital_run(sched)
    rec.items.append(("planes", tr.sv.copy(), tr.su.copy()))
    rec.value(*tr.bus_values_lanes(pn["y"]).ravel())


def latch_feedback(pe, rec):
    """The incomplete ``always @*`` latch (gate feedback) by digital_clk,
    then by digital_run from the same state."""
    c, ins, pn = _synth(pe, rec, LATCH_SRC, "lat", ("en", "d", "s"))
    en, d, s = ins["en"][0], ins["d"][0], ins["s"][0]
    steps = [(H, H, L), (H, L, L), (L, H, H), (L, L, H), (H, H, H),
             (X, L, H), (L, L, L), (H, L, H)]
    for e, dv, sv in steps:
        for m, v in ((en, e), (d, dv), (s, sv)):
            m.set_attribute("boolean", float(v))
        rec.clk(c, pn["q"][0], pn["y"][0])
    tr = c.digital_run([{en: e, d: dv, s: sv} for e, dv, sv in steps])
    rec.items.append(("planes", tr.sv.copy(), tr.su.copy()))


CASES = {
    "and_gate": and_gate, "not_chain": not_chain, "xor_nand": xor_nand,
    "dff_rising_edge": dff_rising_edge, "counter4": counter4,
    "tick_delay": tick_delay, "full_adder": full_adder,
    "latch_transparent": latch_transparent,
    "tri_state_resolve2": tri_state_resolve2,
    "jk_t_flipflops": jk_t_flipflops, "eight_bit_io": eight_bit_io,
    "comparator": comparator, "gate_drives_analog": gate_drives_analog,
    "schmitt": schmitt, "random4": random4,
    "digital_run_vs_clk": digital_run_vs_clk, "fp16_lanes": fp16_lanes,
    "latch_feedback": latch_feedback,
}


def run_case(pe, name, make_circuit) -> Rec:
    rec = Rec(make_circuit)
    CASES_ALL[name](pe, rec)
    return rec


def every_kind(pe, c):
    """A netlist of ``c`` with every sequential kind the levelled tick
    carries state for — DFF, DFF_ARSTN, DLATCH, JKFF, TFF, TBARFF,
    COUNTER4, RANDOM4, TICK_DELAY, SCHMITT (on a VDC's net) — a
    cross-coupled NAND latch (gate feedback), a gate on two flip-flop
    outputs and an INPUT8 -> OUTPUT8 bus.  The INPUTs are named after
    their nets.  Returns ({name: INPUT}, [watched nets])."""
    nl = c.nl
    ins = {n: pe.netops.add_model(nl, pe.models.INPUT, {"boolean": 0.0},
                                  name=n)
           for n in ("clk", "d", "en", "t", "rst", "j", "k", "s", "r")}
    nets = {n: wire(pe, nl, (m, 0)) for n, m in ins.items()}
    m = pe.models
    add = pe.netops.add_model
    pin = pe.netops.add_to_node
    outs = []

    def dev(model, inputs, n_out, params=None):
        d = add(nl, model, params or {})
        for k, net in enumerate(inputs):
            pin(nl, d, k, nets[net])
        q = [wire(pe, nl, (d, len(inputs) + k)) for k in range(n_out)]
        outs.extend(q)
        return q

    q_dff = dev(m.D_FF, ("d", "clk"), 1)[0]
    dev(m.D_FF_ARSTN, ("d", "clk", "rst"), 1)
    q_lat = dev(m.D_LATCH, ("d", "en"), 1)[0]
    dev(m.JK_FF, ("j", "k", "clk"), 1)
    dev(m.T_FF, ("t", "clk"), 1)
    dev(m.T_BAR_FF, ("t", "clk"), 1)
    td = add(nl, m.TICK_DELAY)
    pin(nl, td, 0, nets["d"])
    outs.append(wire(pe, nl, (td, 1)))
    for model, params, ctl in ((m.COUNTER4, None, "en"),
                               (m.RANDOM_GENERATOR4, {"seed": 6.0}, "rst")):
        d = add(nl, model, params or {})
        outs.extend(wire(pe, nl, (d, k)) for k in range(4))
        pin(nl, d, 4, nets["clk"])
        pin(nl, d, 5, nets[ctl])
    v = add(nl, m.VDC, {"V": 4.0})
    n_in = wire(pe, nl, (v, 0))
    pin(nl, v, 1, nl.ground_node)
    st = add(nl, m.SCHMITT_TRIGGER)
    pin(nl, st, 0, n_in)
    outs.append(wire(pe, nl, (st, 1)))
    n1, n2 = add(nl, m.NAND), add(nl, m.NAND)
    q, qb = wire(pe, nl, (n1, 2), (n2, 1)), wire(pe, nl, (n2, 2), (n1, 1))
    pin(nl, n1, 0, nets["s"])
    pin(nl, n2, 0, nets["r"])
    outs += [q, qb]
    x = add(nl, m.XOR)
    pin(nl, x, 0, q_dff)
    pin(nl, x, 1, q_lat)
    outs.append(wire(pe, nl, (x, 2)))
    src = add(nl, m.EIGHT_BIT_INPUT, {"value": 0x5A}, name="bus_in")
    dst = add(nl, m.EIGHT_BIT_DISPLAY, name="bus_out")
    outs.extend(wire(pe, nl, (src, i), (dst, i)) for i in range(8))
    return ins, outs


def random_codes(rng, names, ticks, lanes=False):
    """Per tick {name: code} (0-3, X and Z one time in eight each), or
    with ``lanes`` {name: (v_word, u_word)} of random lanes."""
    sched = []
    for _ in range(ticks):
        e = {}
        for n in names:
            if lanes:
                v = int(rng.integers(0, 2 ** 32))
                u = int(rng.integers(0, 2 ** 32)) & int(rng.integers(0, 2 ** 32)) \
                    & int(rng.integers(0, 2 ** 32))
                e[n] = (v, u)
            else:
                r = int(rng.integers(0, 16))
                e[n] = 2 if r == 0 else 3 if r == 1 else r & 1
        sched.append(e)
    return sched


# ---------------------------------------------------------------------------
# mixed signal: the Tsu/Th automata (tests/test_unsteady.py) and the
# VERILOG_MODULE device (tests/test_verilog_module.py)
# ---------------------------------------------------------------------------

def rc_gate(pe, c, tsu, th):
    """VDC 5V -> R -> C node sampled by a YES gate (Hl=3V); tau = 1 ms,
    the node crosses 3 V at t ~ 0.92 ms (test_unsteady._rc_gate)."""
    nl, m = c.nl, pe.models
    v = pe.netops.add_model(nl, m.VDC, {"V": 5.0})
    r = pe.netops.add_model(nl, m.RESISTANCE, {"r": 1e3})
    cap = pe.netops.add_model(nl, m.CAPACITOR, {"C": 1e-6})
    g = pe.netops.add_model(nl, m.YES, {"Ll": 1.0, "Hl": 3.0,
                                        "Tsu": tsu, "Th": th})
    n_s = wire(pe, nl, (v, 0), (r, 0))
    pe.netops.add_to_node(nl, v, 1, nl.ground_node)
    n_c = wire(pe, nl, (r, 1), (cap, 0), (g, 0))
    pe.netops.add_to_node(nl, cap, 1, nl.ground_node)
    n_o = wire(pe, nl, (g, 1))
    c.set_analyze_type(pe.AnalyzeType.TR)
    c.tr.t_step = 1e-4
    c.tr.t_stop = 5e-3
    return n_s, n_c, n_o, v


def _tr_clk(rec, c, n_c, n_o):
    rec.analyze(c)
    rec.volts(c, n_c)
    rec.clk(c, n_o)


def unsteady_commit_within_chunk(pe, rec):
    c = rec.circuit()
    _s, n_c, n_o, _v = rc_gate(pe, c, 2e-3, 1e-3)
    _tr_clk(rec, c, n_c, n_o)


def unsteady_spurious_window(pe, rec):
    for substeps in (True, False):
        c = rec.circuit()
        _s, n_c, n_o, _v = rc_gate(pe, c, 2e-4, 1e-3)
        if not substeps:
            c._observe_tr_substeps = lambda: None
        c.tr.t_stop = 2e-4
        _tr_clk(rec, c, n_c, n_o)
        c.tr.t_stop = 5e-3
        _tr_clk(rec, c, n_c, n_o)
        _tr_clk(rec, c, n_c, n_o)


def unsteady_late_crossing(pe, rec):
    c = rec.circuit()
    _s, n_c, n_o, _v = rc_gate(pe, c, 2e-3, 8e-3)
    _tr_clk(rec, c, n_c, n_o)
    _tr_clk(rec, c, n_c, n_o)


def unsteady_glitch_reverts(pe, rec):
    c = rec.circuit()
    _s, n_c, n_o, v = rc_gate(pe, c, 1e-3, 8e-3)
    _tr_clk(rec, c, n_c, n_o)
    v.set_attribute("V", 0.0)
    _tr_clk(rec, c, n_c, n_o)


def unsteady_zero_is_plain(pe, rec):
    c = rec.circuit()
    _s, n_c, n_o, _v = rc_gate(pe, c, 0.0, 0.0)
    _tr_clk(rec, c, n_c, n_o)


VM_COUNTER_SRC = """
module counter(input clk, input rst_n, output [3:0] q, output carry);
  reg [3:0] cnt;
  always @(posedge clk or negedge rst_n) begin
    if (!rst_n) cnt <= 4'd0;
    else cnt <= cnt + 4'd1;
  end
  assign q = cnt;
  assign carry = (cnt == 4'd15);
endmodule
"""

VM_INV_SRC = """
module inv(input a, output y);
  assign y = ~a;
endmodule
"""


def vmod_counter(pe, rec, ticks=4):
    """test_verilog_module_counter (``ticks`` clocks; the card runs more)."""
    c = rec.circuit()
    nl = c.nl
    vm = pe.models.make_verilog_module(VM_COUNTER_SRC, top="counter")
    pe.netops.add_model(nl, vm)
    clk, rst = _inp(pe, nl, L), _inp(pe, nl, L)
    wire(pe, nl, (clk, 0), (vm, 0))
    wire(pe, nl, (rst, 0), (vm, 1))
    nq, ncarry = wire(pe, nl, (vm, 2)), wire(pe, nl, (vm, 3))
    rec.clk(c, nq, ncarry)
    rst.set_attribute("boolean", float(H))
    rec.clk(c, nq, ncarry)
    for _ in range(ticks):
        for v in (H, L):
            clk.set_attribute("boolean", float(v))
            rec.clk(c, nq, ncarry)


def vmod_drives_analog(pe, rec):
    c = rec.circuit()
    nl = c.nl
    vm = pe.models.make_verilog_module(VM_INV_SRC, top="inv", Hl=3.3)
    pe.netops.add_model(nl, vm)
    a = _inp(pe, nl, L)
    r = pe.netops.add_model(nl, pe.models.RESISTANCE, {"r": 1e3})
    wire(pe, nl, (a, 0), (vm, 0))
    ny = wire(pe, nl, (vm, 1), (r, 0))
    pe.netops.add_to_node(nl, r, 1, nl.ground_node)
    c.set_analyze_type(pe.AnalyzeType.OP)
    rec.analyze(c)
    rec.volts(c, ny)
    for code in (None, H):
        if code is not None:
            a.set_attribute("boolean", float(code))
        rec.clk(c, ny)
        rec.analyze(c)
        rec.volts(c, ny)


MIXED = {
    "unsteady_commit_within_chunk": unsteady_commit_within_chunk,
    "unsteady_spurious_window": unsteady_spurious_window,
    "unsteady_late_crossing": unsteady_late_crossing,
    "unsteady_glitch_reverts": unsteady_glitch_reverts,
    "unsteady_zero_is_plain": unsteady_zero_is_plain,
    "vmod_counter": vmod_counter,
    "vmod_drives_analog": vmod_drives_analog,
}
CASES_ALL = {**CASES, **MIXED}
