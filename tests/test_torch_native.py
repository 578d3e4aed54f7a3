"""The port's host C++ libraries (``phy_engine_tpu_torch/native``): the
truth-table library against its numpy version and the JAX package's; the
host sweep engine (``DigitalEngine(backend="native")``) against the port's
levelled tick and the JAX ``native_run`` on the four cases of
``tests/test_native_digital.py``; the netlist's snapshot, restore and copy;
and the designs the native backend refuses."""

import numpy as np
import pytest

import phy_engine_tpu as jpe
import phy_engine_tpu_torch as tpe
from phy_engine_tpu import native as jnative
from phy_engine_tpu_torch import native

import torch_digital_cases as dc
from test_snake import SNAKE_SRC

H = 1


# ---------------------------------------------------------------------------
# the truth-table library
# ---------------------------------------------------------------------------

def _random_graph(rng, n_leaves, n_gates, n_words):
    """A topologically ordered graph over every op, leaf rows random."""
    ops = [native.OP_LEAF] * n_leaves
    f0, f1 = [0] * n_leaves, [0] * n_leaves
    for i in range(n_leaves, n_leaves + n_gates):
        ops.append(int(rng.integers(1, 7)))
        f0.append(int(rng.integers(0, i)))
        f1.append(int(rng.integers(0, i)))
    words = np.zeros((len(ops), n_words), np.uint64)
    words[:n_leaves] = rng.integers(0, 1 << 63, (n_leaves, n_words),
                                    dtype=np.uint64) << np.uint64(1) | \
        rng.integers(0, 2, (n_leaves, n_words), dtype=np.uint64)
    # gate rows start as garbage: every op must overwrite its row
    words[n_leaves:] = rng.integers(0, 1 << 63, (n_gates, n_words),
                                    dtype=np.uint64)
    return (np.array(ops, np.int32), np.array(f0, np.int32),
            np.array(f1, np.int32), words)


@pytest.mark.parametrize("n_words", [1, 3, 64, 1024])
def test_eval_graph_matches_plain_and_jax(n_words):
    """Graphs of every op, narrow and wide (the library splits the
    columns over threads past 2^16 node-words)."""
    rng = np.random.default_rng(n_words)
    op, f0, f1, w = _random_graph(rng, 8, 120, n_words)
    got = native.eval_graph(op, f0, f1, w.copy())
    np.testing.assert_array_equal(got, native.eval_graph_plain(op, f0, f1,
                                                               w.copy()))
    np.testing.assert_array_equal(got, jnative.eval_graph(op, f0, f1,
                                                          w.copy()))
    a, b = got[0], got[1]
    i = int(np.nonzero(op == native.OP_AND)[0][0])
    np.testing.assert_array_equal(got[i], got[f0[i]] & got[f1[i]])
    assert a.dtype == b.dtype == np.uint64


def test_rows_equal_matches_plain_and_jax():
    """test_rows_equal_tail_mask's case (npat % 64 != 0), then random
    rows, equal, complementary or differing in one bit."""
    a = np.array([0xDEADBEEF, 0x12345], np.uint64)
    b = a.copy()
    b[1] ^= np.uint64(1 << 40)      # differ only above npat = 100
    for fn in (native.rows_equal, native.rows_equal_plain):
        assert fn(a, b, 100, False)
        assert not fn(a, b, 128, False)
        assert fn(a, ~a, 128, True)
    rng = np.random.default_rng(3)
    for _ in range(200):
        n = int(rng.integers(1, 6))
        npat = int(rng.integers(1, 64 * n + 1))
        x = rng.integers(0, 1 << 63, n, dtype=np.uint64)
        neg = bool(rng.integers(0, 2))
        y = ~x if neg else x.copy()
        if rng.integers(0, 2):
            bit = int(rng.integers(0, 64 * n))
            y[bit // 64] ^= np.uint64(1) << np.uint64(bit % 64)
        got = native.rows_equal(x, y, npat, neg)
        assert got == native.rows_equal_plain(x, y, npat, neg)
        assert got == jnative.rows_equal(x, y, npat, neg)


def test_libraries_build_from_the_port():
    """Both libraries come from this package's sources, into build/, with
    a name that carries the source hash and the host."""
    for name in native.LIBS:
        so = native.build(name)
        assert so.parent == native.BUILD_DIR
        assert so == native.library_path(name)
        src = native.SRC_DIR / native.LIBS[name][0]
        assert src.is_file() and src.parent.name == "native"
        assert src.parent.parent.name == "phy_engine_tpu_torch"


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    (tmp_path / "pe_tt.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build("pe_tt")
    assert not list((tmp_path / "build").glob("*.so"))


# ---------------------------------------------------------------------------
# the host sweep engine: test_native_digital.py's four cases
# ---------------------------------------------------------------------------

def _synth(pe, c, src, top, inputs):
    from importlib import import_module
    v = import_module(pe.__name__ + ".verilog")
    synth = import_module(pe.__name__ + ".verilog.synth")
    design = v.build_design(v.compile_source(src))
    topm = v.find_module(design, top)
    inst = v.elaborate(design, topm)
    nl = c.nl
    pn = {p: [pe.netops.create_node(nl) for _ in range(inst.signals[p].width)]
          for p in topm.ports}
    ins = {}
    for name in inputs:
        ins[name] = []
        for n in pn[name]:
            m = pe.netops.add_model(nl, pe.models.INPUT, {"boolean": 0.0})
            pe.netops.add_to_node(nl, m, 0, n)
            ins[name].append(m)
    synth.synthesize_to_netlist(nl, design, inst, pn,
                                synth.SynthOptions(opt_level=1))
    return ins


def snake(pe, c):
    ins = _synth(pe, c, SNAKE_SRC, "snake4", ("clk", "rst_n", "dir"))
    rng = np.random.default_rng(5)
    clk, rst = ins["clk"][0], ins["rst_n"][0]
    sched = [{}, {rst: 0}, {rst: 0, clk: 1}, {rst: 1, clk: 0}]
    for _ in range(24):
        d = int(rng.integers(0, 4))
        base = {rst: 1, ins["dir"][0]: d & 1, ins["dir"][1]: (d >> 1) & 1}
        sched += [{**base, clk: 1}, {**base, clk: 0}]
    return sched


def gate_latch(pe, c):
    """test_native_digital._build_gate_latch: four latches of raw gate
    feedback (q = en·d + ~en·q) and an XOR stage behind them."""
    nl = c.nl
    w = lambda *pins: dc.wire(pe, nl, *pins)          # noqa: E731
    M = pe.models
    en = pe.netops.add_model(nl, M.INPUT, {"boolean": 0.0})
    n_en = w((en, 0))
    inv = pe.netops.add_model(nl, M.NOT)
    pe.netops.add_to_node(nl, inv, 0, n_en)
    n_nen = w((inv, 1))
    ds, q_nodes = [], []
    for _ in range(4):
        d = pe.netops.add_model(nl, M.INPUT, {"boolean": 0.0})
        ds.append(d)
        n_d = w((d, 0))
        g_set = pe.netops.add_model(nl, M.AND)
        pe.netops.add_to_node(nl, g_set, 0, n_en)
        pe.netops.add_to_node(nl, g_set, 1, n_d)
        n_set = w((g_set, 2))
        g_hold = pe.netops.add_model(nl, M.AND)
        g_q = pe.netops.add_model(nl, M.OR)
        pe.netops.add_to_node(nl, g_q, 0, n_set)
        w((g_hold, 2), (g_q, 1))
        q_nodes.append(w((g_q, 2), (g_hold, 1)))
        pe.netops.add_to_node(nl, g_hold, 0, n_nen)
    for i in range(3):
        x = pe.netops.add_model(nl, M.XOR)
        pe.netops.add_to_node(nl, x, 0, q_nodes[i])
        pe.netops.add_to_node(nl, x, 1, q_nodes[i + 1])
        w((x, 2))
    rng = np.random.default_rng(9)
    sched = [{}]
    for _ in range(10):
        dv = int(rng.integers(0, 16))
        base = {ds[i]: (dv >> i) & 1 for i in range(4)}
        sched += [{**base, en: 1}, {**base, en: 0}]
        d2 = int(rng.integers(0, 16))
        sched.append({**{ds[i]: (d2 >> i) & 1 for i in range(4)}, en: 0})
    return sched


ADD4_SRC = """
module m(input [3:0] a, input [3:0] b, output [4:0] y);
  assign y = a + b;
endmodule
"""


def lane_adder(pe, c):
    """test_native_lane_planes: 32 stimulus lanes through a 4-bit adder."""
    ins = _synth(pe, c, ADD4_SRC, "m", ("a", "b"))
    rng = np.random.default_rng(11)
    vals = {"a": rng.integers(0, 16, (6, 32)), "b": rng.integers(0, 16, (6, 32))}
    sched = []
    for t in range(6):
        entry = {}
        for name, v in vals.items():
            for i, m in enumerate(ins[name]):
                word = 0
                for lane in range(32):
                    word |= (int(v[t, lane]) >> i & 1) << lane
                entry[m] = (word, 0)
        sched.append(entry)
    return sched


CASES = {"snake": snake, "gate_latch": gate_latch, "lane_adder": lane_adder}


def _state(eng):
    return (np.asarray(eng.sv).copy(), np.asarray(eng.su).copy(),
            {k: {n: np.asarray(a).copy() for n, a in d.items()}
             for k, d in eng.seq_state.items()})


def _assert_state(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert sorted(k for k, d in a[2].items() if d) == \
        sorted(k for k, d in b[2].items() if d)
    for k, d in a[2].items():
        for n, arr in d.items():
            np.testing.assert_array_equal(arr, b[2][k][n], err_msg=f"{k}.{n}")


def _port_levels(build):
    """History and committed state of the port's levelled tick."""
    c = tpe.Circuit(device="cpu")
    sched = build(tpe, c)
    eng, fs, FV, FU = c._compile_schedule(sched)
    hv, hu, last = eng.run_levels(fs, FV[None], FU[None])
    eng.commit(*last)
    return (hv[0].numpy().view(np.uint32), hu[0].numpy().view(np.uint32),
            _state(eng))


def _jax_native(build, monkeypatch):
    from phy_engine_tpu.digital import native_run
    assert native_run.available()
    monkeypatch.setenv("PE_TPU_DIGITAL", "native")
    c = jpe.Circuit()
    sched = build(jpe, c)
    tr = c.digital_run(sched)
    assert getattr(c._digital, "_native_plan", None) is not None
    return np.asarray(tr.sv), np.asarray(tr.su), _state(c._digital)


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_matches_levels_and_jax(name, monkeypatch):
    """The snake, the cyclic gate latch and the 32-lane adder: the port's
    native backend against its levelled tick and the JAX native_run,
    every signal, tick and lane, and the committed state."""
    build = CASES[name]
    c = tpe.Circuit(device="cpu", digital_backend="native")
    tr = c.digital_run(build(tpe, c))
    if name == "gate_latch":
        assert c.digital_engine().ir.cyclic
    got = (tr.sv, tr.su, _state(c.digital_engine()))
    for ref in (_port_levels(build), _jax_native(build, monkeypatch)):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        _assert_state(got[2], ref[2])


def test_native_state_carries_across_runs():
    """Two digital_run calls on the native backend continue the state, and
    a device run after a native one continues it too."""
    ref_v, ref_u, _st = _port_levels(snake)
    for second in ("native", "device"):
        c = tpe.Circuit(device="cpu", digital_backend="native")
        sched = snake(tpe, c)
        cut = len(sched) // 2
        tr1 = c.digital_run(sched[:cut])
        c.digital_engine().backend = second
        tr2 = c.digital_run(sched[cut:])
        np.testing.assert_array_equal(np.concatenate([tr1.sv, tr2.sv]), ref_v)
        np.testing.assert_array_equal(np.concatenate([tr1.su, tr2.su]), ref_u)


def test_native_tick_matches_digital_clk():
    """tick() on the native backend (one library call a digital_clk)
    against the levelled tick, tick for tick."""
    recs = []
    for backend in ("native", "device"):
        c = tpe.Circuit(device="cpu", digital_backend=backend)
        sched = snake(tpe, c)
        rec = dc.Rec(None)
        for entry in sched:
            for m, v in entry.items():
                m.set_attribute("boolean", float(v))
            rec.clk(c)
        recs.append(rec)
    dc.assert_same(recs[0], recs[1])


def test_native_refuses_what_it_cannot_run():
    """VERILOG_MODULE devices, analog sampling, and (for digital_clk)
    analog drives raise, naming the condition; nothing falls back."""
    c = tpe.Circuit(device="cpu", digital_backend="native")
    nl = c.nl
    vm = tpe.models.make_verilog_module(dc.VM_INV_SRC, top="inv")
    tpe.netops.add_model(nl, vm)
    a = dc._inp(tpe, nl, H)
    dc.wire(tpe, nl, (a, 0), (vm, 0))
    dc.wire(tpe, nl, (vm, 1))
    with pytest.raises(ValueError, match="VERILOG_MODULE"):
        c.digital_clk()

    c = tpe.Circuit(device="cpu", digital_backend="native")
    nl = c.nl
    a, b = dc._inp(tpe, nl, H), dc._inp(tpe, nl, H)
    g = tpe.netops.add_model(nl, tpe.models.AND, {"Hl": 5.0, "Ll": 0.0})
    r = tpe.netops.add_model(nl, tpe.models.RESISTANCE, {"r": 1e3})
    dc.wire(tpe, nl, (a, 0), (g, 0))
    dc.wire(tpe, nl, (b, 0), (g, 1))
    dc.wire(tpe, nl, (g, 2), (r, 0))
    tpe.netops.add_to_node(nl, r, 1, nl.ground_node)
    with pytest.raises(ValueError, match="drives analog"):
        c.digital_clk()

    c = tpe.Circuit(device="cpu", digital_backend="native")
    nl = c.nl
    v = tpe.netops.add_model(nl, tpe.models.VDC, {"V": 5.0})
    g = tpe.netops.add_model(nl, tpe.models.NOT)
    dc.wire(tpe, nl, (v, 0), (g, 0))
    tpe.netops.add_to_node(nl, v, 1, nl.ground_node)
    dc.wire(tpe, nl, (g, 1))
    with pytest.raises(ValueError, match="samples analog"):
        c.digital_clk()

    with pytest.raises(ValueError, match="unknown digital backend"):
        tpe.Circuit(device="cpu", digital_backend="turbo")


# ---------------------------------------------------------------------------
# the netlist's snapshot, restore and copy
# ---------------------------------------------------------------------------

def _shape(nl):
    num = {id(nl.ground_node): -1}
    return [(m.mdef.name, m.enabled, dict(m.params),
             tuple(num.setdefault(id(p.node), len(num) - 1)
                   if p.node is not None else -2 for p in m.pins))
            for m in nl.models if m is not None]


def test_state_save_restore_keeps_identity():
    c = tpe.Circuit(device="cpu")
    ins = _synth(tpe, c, ADD4_SRC, "m", ("a", "b"))
    nl = c.nl
    models, nodes = list(nl.models), list(nl.nodes)
    pins = {id(m): [p.node for p in m.pins] for m in models if m is not None}
    before = _shape(nl)
    snap = nl.state_save()
    # edit: a new gate, a deleted one, a rewired pin, a param, a new net
    g = tpe.netops.add_model(nl, tpe.models.AND)
    n = tpe.netops.create_node(nl)
    tpe.netops.add_to_node(nl, g, 2, n)
    victim = next(m for m in nl.live_models()
                  if m.mdef.name not in ("INPUT", "AND"))
    tpe.netops.delete_model(nl, victim)
    ins["a"][0].set_attribute("boolean", 1.0)
    assert _shape(nl) != before
    nl.state_restore(snap)
    assert _shape(nl) == before
    assert nl.models == models and nl.nodes == nodes
    for m in models:                          # the same objects, rewired
        if m is not None:
            assert [p.node for p in m.pins] == pins[id(m)]
            for p in m.pins:
                assert p.node is None or p in p.node.pins
    assert ins["a"][0].params["boolean"] == 0.0 and victim.enabled


def test_copy_is_deep_and_equal():
    c = tpe.Circuit(device="cpu")
    _synth(tpe, c, ADD4_SRC, "m", ("a", "b"))
    nl = c.nl
    cp = nl.copy()
    assert _shape(cp) == _shape(nl) and cp.version == nl.version
    own = {id(x) for x in nl.models + nl.nodes if x is not None}
    assert not own & {id(x) for x in cp.models + cp.nodes if x is not None}
    m0 = next(i for i, m in enumerate(nl.models)
              if m is not None and m.mdef.name == "INPUT")
    cp.models[m0].params["boolean"] = 1.0
    assert nl.models[m0].params["boolean"] == 0.0
