"""The port's persistence and scene interop against the JAX package's:
``.penl`` files written by either package load in the other to the same
netlist and stamp IR (as ``tests/test_torch_ir.py`` compares it), with
equal stable IDs; checkpoints resume to 1e-6 of an uninterrupted run;
checksums, the directory layout and VERILOG_MODULE state; PhysicsLab
scenes equal under the same ``random`` seed, both auto-layouts,
``CornerLocator`` and ``detect_floating_subnets``
(``tests/test_persistence.py``, ``tests/test_plsav.py``)."""

import json
import os
import random

import numpy as np
import pytest

import phy_engine_tpu as jpe
import phy_engine_tpu_torch as tpe
from phy_engine_tpu import io as jio
from phy_engine_tpu.io import layout as jlayout, plsav as jplsav
from phy_engine_tpu.utils import detect_floating_subnets as jfloating
from phy_engine_tpu_torch import io as tio
from phy_engine_tpu_torch.io import layout as tlayout, plsav as tplsav
from phy_engine_tpu_torch.io.penl import LoadError
from phy_engine_tpu_torch.utils import detect_floating_subnets

from test_torch_ir import FAMILY_ARRAYS, ZOO, _same
from torch_circuit_cases import build
from torch_circuits import diode_load

PKG = {"jax": (jpe, jio), "torch": (tpe, tio)}
CPU = {"jax": {}, "torch": {"device": "cpu"}}

# every analog family but the triangle source: its id_name, "TRI", is the
# tri-state gate's too, and the registry's "TRI" is the gate, so neither
# package reloads a saved TRIANGLE (test_triangle_reloads_as_tri_state)
SAVABLE = [d for d in ZOO if d[1] != "TRIANGLE"]

# tests/test_persistence.py's rc_diode_circuit
RC_DIODE = [("src", "VAC", {"Vp": 5.0, "freq": 1e3}, ("in", "0")),
            ("r1", "RESISTANCE", {"r": 1e3}, ("in", "out")),
            ("d1", "PN_JUNCTION", {}, ("out", "0")),
            ("c1", "CAPACITOR", {"C": 1e-6}, ("out", "0"))]


def _rc_diode(pkg):
    b = build(pkg, RC_DIODE)
    for name, m in b.devs.items():
        m.name = name
    b.nodes["in"].name, b.nodes["out"].name = "in", "out"
    return b


def _same_ir(a, b):
    ia, ib = a.prepare(), b.prepare()
    assert (ia.n_unknowns, ia.n_nodes, ia.n_branches, ia.nonlinear) == (
        ib.n_unknowns, ib.n_nodes, ib.n_branches, ib.nonlinear)
    assert [f.mdef.id_name for f in ia.families] == \
        [f.mdef.id_name for f in ib.families]
    for fa, fb in zip(ia.families, ib.families):
        for name in FAMILY_ARRAYS:
            _same(getattr(fa, name), getattr(fb, name))


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("spec", ["zoo", "rc_diode"])
def test_penl_loads_across_packages(tmp_path, writer, reader, spec):
    """Each package writes the same file for the same netlist, and a file
    from either loads in the other to the same netlist and IR."""
    desc = SAVABLE if spec == "zoo" else RC_DIODE
    files = {}
    for pkg in ("jax", "torch"):
        b = build(pkg, desc)
        files[pkg] = str(tmp_path / f"{pkg}.penl")
        PKG[pkg][1].save(files[pkg], b.c)
    with open(files["jax"]) as f, open(files["torch"]) as g:
        assert f.read() == g.read()
    c = PKG[reader][1].load(files[writer], **CPU[reader])
    orig = build(reader, desc).c
    assert [(m.mdef.id_name, m.params) for m in c.nl.live_models()] == \
        [(m.mdef.id_name, m.params) for m in orig.nl.live_models()]
    assert PKG[reader][1].compute_stable_ids(c.nl) == \
        jio.compute_stable_ids(build("jax", desc).c.nl)
    _same_ir(c, orig)


def test_triangle_reloads_as_tri_state(tmp_path):
    """A mirrored fault of the file format: both packages write a
    TRIANGLE source as type "TRI" and read "TRI" back as the tri-state
    gate, which rejects the source's parameters."""
    spec = [("tri", "TRIANGLE", {}, ("p", "0"))]
    for pkg in ("jax", "torch"):
        p = str(tmp_path / f"{pkg}.penl")
        PKG[pkg][1].save(p, build(pkg, spec).c)
        with pytest.raises(KeyError, match="for model TRI"):
            PKG[pkg][1].load(p, **CPU[pkg])


def test_stable_ids_equal():
    for desc in (ZOO, RC_DIODE, diode_load()):
        j, t = build("jax", desc), build("torch", desc)
        ids = tio.compute_stable_ids(t.c.nl)
        assert ids == jio.compute_stable_ids(j.c.nl)
        assert len(set(ids)) == len(ids)


def _tr(b, t_stop):
    c = b.c
    c.set_analyze_type(b.mod.AnalyzeType.TR)
    c.tr.t_step = 1e-6
    c.tr.t_stop = t_stop
    assert c.analyze()
    return c


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoint_resume(tmp_path, writer):
    """test_persistence.py::test_checkpoint_resume through the port: half
    the transient, a runtime_only checkpoint (written by either package),
    a fresh port circuit resumed from it; the end state within 1e-6 of an
    uninterrupted port run and of the JAX package's."""
    full = _tr(_rc_diode("torch"), 2e-4)
    jfull = _tr(_rc_diode("jax"), 2e-4)
    half = _tr(_rc_diode(writer), 1e-4)
    p = str(tmp_path / "ckpt.penl")
    PKG[writer][1].save(p, half,
                        PKG[writer][1].SaveOptions(mode="runtime_only"))
    r = _rc_diode("torch")
    tio.load(p, circuit=r.c)
    assert np.isclose(r.c.tr_duration, 1e-4)
    for k in ("in", "out"):         # restored before the resumed run
        assert r.nodes[k].voltage == _node(half, k).voltage
    _tr(r, 1e-4)
    for ref in (full, jfull):
        for k in ("in", "out"):
            got = r.c.node_voltage(r.nodes[k]).real
            want = ref.node_voltage(_node(ref, k)).real
            assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12), \
                (k, got, want)


def _node(c, name):
    return [n for n in c.nl.nodes if n.name == name][0]


def test_checkpoint_carries_device_state(tmp_path):
    """Everything a transient keeps between calls reaches the file: the
    diode's and capacitor's step state (``inst.runtime``), the branch
    current of the source and every node voltage, equal to the JAX
    package's checkpoint of the same run."""
    docs = []
    for pkg in ("jax", "torch"):
        c = _tr(_rc_diode(pkg), 5e-5)
        p = str(tmp_path / f"{pkg}.penl")
        PKG[pkg][1].save(p, c, PKG[pkg][1].SaveOptions(mode="runtime_only"))
        with open(p) as f:
            docs.append(json.load(f)["body"])
    j, t = docs
    assert [r["stable_id"] for r in t["runtime"]] == \
        [r["stable_id"] for r in j["runtime"]]
    for rj, rt in zip(j["runtime"], t["runtime"]):
        assert sorted(rt["payload"]["state"]) == \
            sorted(rj["payload"]["state"])
        for k, v in rj["payload"]["state"].items():
            assert rt["payload"]["state"][k] == pytest.approx(v, rel=1e-6,
                                                              abs=1e-15)
        np.testing.assert_allclose(rt["payload"]["branches"],
                                   rj["payload"]["branches"], rtol=1e-6,
                                   atol=1e-15)
    np.testing.assert_allclose(t["node_voltages"], j["node_voltages"],
                               rtol=1e-6, atol=1e-12)
    assert t["analysis"] == j["analysis"]
    assert t["environment"] == j["environment"]
    assert any(r["payload"]["state"] for r in t["runtime"])


def test_checksum_detects_corruption(tmp_path):
    b = _rc_diode("torch")
    p = str(tmp_path / "x.penl")
    tio.save(p, b.c)
    with open(p) as f:
        doc = json.load(f)
    doc["body"]["models"][0]["params"]["Vp"] = 99.0
    with open(p, "w") as f:
        json.dump(doc, f)
    with pytest.raises(LoadError, match="checksum"):
        tio.load(p, device="cpu")
    with pytest.raises(jio.penl.LoadError):
        jio.load(p)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_directory_layout(tmp_path, writer):
    b = _rc_diode(writer)
    p = str(tmp_path / "dir.penl")
    PKG[writer][1].save(p, b.c, PKG[writer][1].SaveOptions(
        layout="directory"))
    assert os.path.exists(os.path.join(p, "structure.json"))
    assert os.path.exists(os.path.join(p, "runtime.json"))
    c = tio.load(p, device="cpu")
    assert c.nl.model_count() == 4
    assert [n.name for n in c.nl.nodes] == ["in", "out"]
    _same_ir(c, _rc_diode("torch").c)
    rt = str(tmp_path / "rt.penl")
    tio.save(rt, c, tio.SaveOptions(mode="runtime_only"))
    with pytest.raises(LoadError, match="needs a circuit"):
        tio.load(rt, device="cpu")


TOGGLE = """
module toggle(input clk, output q);
  reg s;
  always @(posedge clk) s <= ~s;
  initial s = 1'b0;
  assign q = s;
endmodule
"""


def _toggled(pkg):
    """test_persistence.py::test_verilog_module_roundtrip's circuit,
    clocked once to s = 1."""
    pe = PKG[pkg][0]
    c = pe.Circuit(**CPU[pkg])
    nl = c.nl
    vm = pe.netops.add_model(nl, pe.models.make_verilog_module(
        TOGGLE, top="toggle"))
    clk = pe.netops.add_model(nl, pe.models.INPUT, {"boolean": 0.0})
    nclk = pe.netops.create_node(nl)
    nq = pe.netops.create_node(nl)
    pe.netops.add_to_node(nl, clk, 0, nclk)
    pe.netops.add_to_node(nl, vm, 0, nclk)
    pe.netops.add_to_node(nl, vm, 1, nq)
    c.digital_clk()
    clk.set_attribute("boolean", 1.0)
    c.digital_clk()
    assert c.node_digital(nq) == 1
    return c


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_verilog_module_roundtrip(tmp_path, writer):
    """The Verilog instance's signals (``Val`` planes) and tick survive a
    save in either package and a load in the port; both packages write
    the same file."""
    files = {}
    for pkg in ("jax", "torch"):
        files[pkg] = str(tmp_path / f"{pkg}.penl")
        PKG[pkg][1].save(files[pkg], _toggled(pkg))
    with open(files["jax"]) as f, open(files["torch"]) as g:
        assert json.load(f) == json.load(g)
    c2 = tio.load(files[writer], device="cpu")
    vm2 = c2.nl.live_models()[0]
    assert vm2.mdef.id_name == "VERILOG"
    assert vm2.runtime["rt"].values["s"].to_int() == 1
    assert type(vm2.runtime["rt"].values["s"]).__module__ == \
        "phy_engine_tpu_torch.verilog.fourstate"


def _and_netlist(pe):
    nl = pe.Netlist()
    a = pe.netops.add_model(nl, pe.models.INPUT)
    b = pe.netops.add_model(nl, pe.models.INPUT)
    g = pe.netops.add_model(nl, pe.models.AND)
    o = pe.netops.add_model(nl, pe.models.OUTPUT)
    nets = [pe.netops.create_node(nl) for _ in range(3)]
    for m, k, n in ((a, 0, 0), (g, 0, 0), (b, 0, 1), (g, 1, 1), (g, 2, 2),
                    (o, 0, 2)):
        pe.netops.add_to_node(nl, m, k, nets[n])
    return nl


def _dff_netlist(pe):
    """An OR and a DFF_ARSTN (the async-reset pin dropped on export) with
    a resistor to ground (linear and ground export)."""
    nl = pe.Netlist()
    ins = [pe.netops.add_model(nl, pe.models.INPUT) for _ in range(3)]
    g = pe.netops.add_model(nl, pe.models.OR)
    ff = pe.netops.add_model(nl, pe.models.D_FF_ARSTN)
    r = pe.netops.add_model(nl, pe.models.RESISTANCE, {"r": 1e3})
    o = pe.netops.add_model(nl, pe.models.OUTPUT)
    n = [pe.netops.create_node(nl) for _ in range(5)]
    for m, k, i in ((ins[0], 0, 0), (g, 0, 0), (ins[1], 0, 1), (g, 1, 1),
                    (g, 2, 2), (ff, 0, 2), (ins[2], 0, 3), (ff, 1, 3),
                    (ff, 2, 3), (ff, 3, 4), (o, 0, 4), (r, 0, 4)):
        pe.netops.add_to_node(nl, m, k, n[i])
    pe.netops.add_to_node(nl, r, 1, nl.ground_node)
    return nl


@pytest.mark.parametrize("mode", ["fast", "quality"])
@pytest.mark.parametrize("netlist", [_and_netlist, _dff_netlist])
def test_scene_export_equal(netlist, mode):
    """circuit_to_experiment under the same ``random`` seed: the same
    scene JSON (identifiers, positions, wires) in both packages."""
    dumps = []
    for pe, plsav in ((jpe, jplsav), (tpe, tplsav)):
        nl = netlist(pe)
        random.seed(12)
        ex = plsav.circuit_to_experiment(
            nl, plsav.ExportOptions(layout=mode), name="t")
        dumps.append((ex.dump(), ex._warnings))
    assert dumps[0] == dumps[1]
    assert json.loads(json.loads(dumps[1][0])["Experiment"]["StatusSave"])[
        "Wires"]


def _and_scene(plsav):
    ex = plsav.Experiment("and-test")
    a = ex.add_element("Logic Input")
    b = ex.add_element("Logic Input")
    g = ex.add_element("And Gate")
    o = ex.add_element("Logic Output")
    ex.add_wire(a, 0, g, 0)
    ex.add_wire(b, 0, g, 1)
    ex.add_wire(g, 2, o, 0)
    return ex, (a, b, g, o)


def test_scene_roundtrip_and_simulation(tmp_path):
    """test_plsav.py's scene round trip and simulation with write-back,
    the port on the CPU against the JAX package, under one seed."""
    out = []
    for plsav in (jplsav, tplsav):
        random.seed(5)
        ex, (a, b, g, o) = _and_scene(plsav)
        p = str(tmp_path / f"{plsav.__name__}.sav")
        ex.save(p)
        ex2 = plsav.Experiment.load(p)
        assert [e.model_id for e in ex2.elements] == \
            [e.model_id for e in ex.elements]
        a.properties["开关"] = 1.0
        b.properties["开关"] = 1.0
        kw = {"device": "cpu"} if plsav is tplsav else {}
        c, idx = plsav.experiment_to_circuit(ex, **kw)
        states = []
        for sw in (1.0, 0.0):
            b.properties["开关"] = sw
            plsav.sync_inputs(ex, c)
            c.digital_clk()
            plsav.write_back(ex, c, out_l=0.0, out_h=1.0)
            states.append(o.properties["状态"])
        assert states == [1.0, 0.0]
        out.append((open(p, encoding="utf-8").read(), ex.dump(), idx))
    assert out[0] == out[1]


def test_analog_scene():
    stats = []
    for plsav in (jplsav, tplsav):
        ex = plsav.Experiment("divider")
        v = ex.add_element("Battery Source", properties={"电压": 4.0,
                                                         "锁定": 1.0})
        r1 = ex.add_element("Resistor", properties={"电阻": 1000.0})
        r2 = ex.add_element("Resistor", properties={"电阻": 3000.0})
        gnd = ex.add_element("Ground Component")
        ex.add_wire(v, 0, r1, 0)
        ex.add_wire(r1, 1, r2, 0)
        ex.add_wire(r2, 1, gnd, 0)
        ex.add_wire(v, 1, gnd, 0)
        kw = {"device": "cpu"} if plsav is tplsav else {}
        c, _ = plsav.experiment_to_circuit(ex, **kw)
        c.set_analyze_type(1)                    # AnalyzeType.DC
        c.analyze()
        plsav.write_back(ex, c)
        assert np.isclose(r2.statistics["电压"], 3.0)
        stats.append([dict(e.statistics) for e in ex.elements])
    for sj, st in zip(*stats):
        assert sorted(sj) == sorted(st)
        for k in sj:
            assert st[k] == pytest.approx(sj[k], rel=1e-9, abs=1e-12)


def _cliques(plsav, big=False):
    ex = plsav.Experiment(name="t")
    if big:
        els = [ex.add_element("8bit Input") for _ in range(4)]
        for i in range(3):
            ex.add_wire(els[i], 0, els[i + 1], 0)
        return ex
    els = [ex.add_element("Logic Input") for _ in range(12)]
    for grp in (els[:6], els[6:]):
        for i in range(len(grp)):
            for j in range(i + 1, len(grp)):
                ex.add_wire(grp[i], 0, grp[j], 0)
    ex.add_wire(els[0], 0, els[6], 0)
    return ex


@pytest.mark.parametrize("case", ["levels", "cliques", "big"])
def test_auto_layout_equal(case):
    """auto_layout and auto_layout_quality place every element where the
    JAX package does (test_plsav.py's three layout cases)."""
    res = []
    for plsav, layout in ((jplsav, jlayout), (tplsav, tlayout)):
        random.seed(3)
        if case == "levels":
            ex, (a, b, g, o) = _and_scene(plsav)
            st = layout.auto_layout(ex)
            assert a.position[0] < g.position[0] < o.position[0]
        elif case == "cliques":
            ex = _cliques(plsav)
            st = layout.auto_layout_quality(ex, seed=7)
            pos = [tuple(e.position[:2]) for e in ex.elements]
            assert len(set(pos)) == 12
        else:
            ex = _cliques(plsav, big=True)
            st = layout.auto_layout_quality(ex, spacing=0.1)
        res.append(((st.columns, st.rows, st.placed),
                    [e.position for e in ex.elements]))
    assert res[0] == res[1]


def test_corner_locator():
    out = []
    for plsav, layout in ((jplsav, jlayout), (tplsav, tlayout)):
        ex = plsav.Experiment(name="t")
        for mid, pos in (("Logic Input", (0.0, 1.0, 0.0)),
                         ("Logic Output", (0.0, 0.0, 0.0)),
                         ("8bit Input", (2.0, 1.0, 0.0)),
                         ("8bit Display", (2.0, 0.0, 0.0))):
            ex.add_element(mid).position = pos
        loc = layout.CornerLocator.from_experiment(
            ex, "Logic Input", "Logic Output", "8bit Input", "8bit Display")
        assert loc.locate(0.5, 0.5) == (1.0, 0.5, 0.0)
        out.append((loc.locate(0.25, 0.75), loc.grid(3, 2), loc.x_axis,
                    loc.y_axis))
        with pytest.raises(ValueError):
            layout.CornerLocator.from_experiment(
                ex, "Nope", "Logic Output", "8bit Input", "8bit Display")
    assert out[0] == out[1]


FLOATING = [("v", "VDC", {"V": 1.0}, ("a", "0")),
            ("r", "RESISTANCE", {}, ("a", "0")),
            ("r2", "RESISTANCE", {}, ("b", "c")),
            ("r3", "RESISTANCE", {}, ("c", "d")),
            ("r4", "RESISTANCE", {}, ("e", "e2"))]


def test_detect_floating_subnets():
    out = []
    for pkg, fn in (("jax", jfloating), ("torch", detect_floating_subnets)):
        b = build(pkg, FLOATING)
        nl = b.c.nl
        out.append([[nl.nodes.index(n) for n in comp]
                    for comp in fn(nl)])
    assert out[0] == out[1]
    assert len(out[1]) == 2
