"""Port parity: the levelled digital tick of phy_engine_tpu_torch (the JAX
package's ``build_tick``, on the CPU) against the JAX package.

Every case of ``tests/test_digital.py`` (``torch_digital_cases``: the
same netlist built once in each package, driven the same way) must give
bit-identical planes after every tick and identical node codes; node
voltages of the mixed-signal cases agree to ``VTOL``.  The JAX side runs
its levelled engine (``PE_TPU_DIGITAL=levels``), except the fp16 adder's
``digital_run``, which the port sends to its turbo route and the JAX
side to ``turbo_xla`` (its levelled scan takes minutes to compile; both
are bit-exact with the levelled engine).  Added: RANDOM4, the latch of an
incomplete ``always @*`` (gate feedback), the batched levelled tick
against the JAX package's vmapped batch, ``load_state`` continuing a JAX
mid-run state of every sequential kind, the levelled tick against the
turbo tick on a feed-forward design, and overlapping forced writes."""

import numpy as np
import pytest
import torch

import phy_engine_tpu as jpe
import phy_engine_tpu_torch as tpe
from phy_engine_tpu_torch.digital import engine as tengine
from phy_engine_tpu_torch.digital import turbo

import torch_digital_cases as dc
from test_torch_verilog import DESIGNS
from test_torch_digital import SCHEDULES

torch.set_num_threads(1)


def _jax_circuit():
    return jpe.Circuit()


def _port_circuit():
    return tpe.Circuit(device="cpu")


@pytest.mark.parametrize("name", list(dc.CASES))
def test_digital_case_matches_jax(name, monkeypatch):
    monkeypatch.setenv("PE_TPU_DIGITAL",
                       "turbo_xla" if name == "fp16_lanes" else "levels")
    t = dc.run_case(tpe, name, _port_circuit)
    j = dc.run_case(jpe, name, _jax_circuit)
    dc.assert_same(t, j)
    assert any(i[0] == "planes" for i in t.items)


def _every_kind_pair():
    out = []
    for pe, mk in ((jpe, _jax_circuit), (tpe, _port_circuit)):
        c = mk()
        ins, nets = dc.every_kind(pe, c)
        c.set_analyze_type(pe.AnalyzeType.OP)
        assert c.analyze()
        out.append((c, ins, nets))
    return out


def _drive(c, ins, sched):
    for entry in sched:
        for n, code in entry.items():
            ins[n].set_attribute("boolean", float(code))
        c.digital_clk()
        yield np.asarray(c._digital.sv).copy(), np.asarray(c._digital.su).copy()


def test_every_kind_design_is_levels_only():
    (jc, _ji, _jn), (tc, _ti, _tn) = _every_kind_pair()
    ir = tc.digital_engine().ir
    assert ir.cyclic and not turbo.eligible(ir, allow_cyclic=True)
    assert ir.tick_delays is not None
    kinds = {s.op for s in ir.seq} | {"TICK_DELAY"}
    assert kinds == {"DFF", "DFF_ARSTN", "DLATCH", "JKFF", "TFF", "TBARFF",
                     "COUNTER4", "RANDOM4", "SCHMITT", "TICK_DELAY"}
    assert sorted(tc._digital._seq_template()) == sorted(
        k for k, d in jc._digital.seq_state.items() if d)


def test_load_state_continues_jax_every_kind(monkeypatch):
    """The JAX engine's mid-run state (planes and every sequential kind's
    state) carried into the port: the rest of the run matches."""
    monkeypatch.setenv("PE_TPU_DIGITAL", "levels")
    (jc, ji, jn), (tc, ti, tn) = _every_kind_pair()
    rng = np.random.default_rng(5)
    first = dc.random_codes(rng, list(ji), 12)
    rest = dc.random_codes(rng, list(ji), 14)
    list(_drive(jc, ji, first))
    eng = jc._digital
    mid = (np.asarray(eng.sv), np.asarray(eng.su),
           {k: {n: np.asarray(a) for n, a in d.items()}
            for k, d in eng.seq_state.items()})
    teng = tc.digital_engine()
    teng.load_state(*mid)
    for k, d in teng.seq_state.items():
        for n, a in d.items():
            np.testing.assert_array_equal(a, mid[2][k][n])
    assert [tc.node_digital(n) for n in tn] == [jc.node_digital(n)
                                                 for n in jn]
    for (jv, ju), (tv, tu) in zip(_drive(jc, ji, rest), _drive(tc, ti, rest)):
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tu, ju)
    assert [tc.node_digital(n) for n in tn] == [jc.node_digital(n)
                                                 for n in jn]
    bad = dict(mid[2])
    bad.pop("COUNTER4")
    with pytest.raises(ValueError, match="keys"):
        teng.load_state(mid[0], mid[1], bad)
    bad = dict(mid[2], RANDOM4={**mid[2]["RANDOM4"],
                                "bits": mid[2]["RANDOM4"]["bits"][:, :3]})
    with pytest.raises(ValueError, match="shape"):
        teng.load_state(mid[0], mid[1], bad)


@pytest.mark.parametrize("watched", [False, True])
def test_batched_levels_match_jax_vmap(watched, monkeypatch):
    """Three instances with their own per-lane random schedules, from a
    common mid-run state: the port's batched levelled tick against the
    JAX package's vmapped levelled scan."""
    monkeypatch.setenv("PE_TPU_DIGITAL", "levels")
    (jc, ji, jn), (tc, ti, tn) = _every_kind_pair()
    warm = dc.random_codes(np.random.default_rng(2), list(ji), 4)
    for _ in zip(_drive(jc, ji, warm), _drive(tc, ti, warm)):
        pass
    comp = {}
    for pkg, c, ins in (("jax", jc, ji), ("torch", tc, ti)):
        scheds = [[{ins[n]: v for n, v in e.items()} for e in
                   dc.random_codes(np.random.default_rng(s), list(ins), 6,
                                   lanes=True)] for s in (7, 8, 9)]
        cs = [c._compile_schedule(s) for s in scheds]
        comp[pkg] = (cs[0][0], cs[0][1], np.stack([x[2] for x in cs]),
                     np.stack([x[3] for x in cs]))
    (je, fs, FV, FU), (te, tfs, TFV, TFU) = comp["jax"], comp["torch"]
    np.testing.assert_array_equal(tfs, fs)
    np.testing.assert_array_equal(TFV, FV)
    watch = ([te.ir.node_sig[id(n)] for n in tn] if watched else None)
    jv, ju = je.run_ticks_batched(fs, FV, FU, watch=watch)
    tv, tu = te.run_ticks_batched(tfs, TFV, TFU, watch=watch)
    assert tv.shape == np.asarray(jv).shape
    np.testing.assert_array_equal(tv, np.asarray(jv))
    np.testing.assert_array_equal(tu, np.asarray(ju))
    # the three instances differ, and no state was committed
    assert (tv[0] != tv[1]).any()
    np.testing.assert_array_equal(te.sv, np.asarray(je.sv))


def test_digital_run_batch_and_named_devices_match_jax(monkeypatch):
    """Circuit.digital_run_batch (three code schedules, watched nets) and
    digital_run on the every-kind design, and Circuit.digital_inputs /
    digital_outputs, against the JAX package."""
    monkeypatch.setenv("PE_TPU_DIGITAL", "levels")
    (jc, ji, jn), (tc, ti, tn) = _every_kind_pair()
    out, runs = [], []
    for c, ins, nets in ((jc, ji, jn), (tc, ti, tn)):
        scheds = [[{ins[n]: v for n, v in e.items()} for e in
                   dc.random_codes(np.random.default_rng(s), list(ins), 7)]
                  for s in (3, 4, 5)]
        out.append(np.asarray(c.digital_run_batch(scheds, nets)))
        tr = c.digital_run(scheds[0])
        runs.append((np.asarray(tr.sv), np.asarray(tr.su),
                     [c.node_digital(n) for n in nets]))
        assert sorted(c.digital_inputs()) == sorted(ins)
        assert sorted(c.digital_outputs()) == ["bus_out"]
    assert out[1].dtype == np.int8 and out[1].shape == (3, 7, len(tn))
    np.testing.assert_array_equal(out[1], out[0])
    assert {0, 1, 2} <= set(np.unique(out[1]))
    np.testing.assert_array_equal(runs[1][0], runs[0][0])
    np.testing.assert_array_equal(runs[1][1], runs[0][1])
    assert runs[1][2] == runs[0][2]


@pytest.mark.parametrize("name", ["fsm", "fp16"])
def test_levels_tick_matches_turbo(name):
    """A feed-forward design through the port's levelled tick (run as
    the batch of one) against its turbo route on the same schedule."""
    src, top, inputs = DESIGNS[name]
    from phy_engine_tpu_torch import workloads
    c, ins, _pn, _r = workloads.synth_top(src, top, "cpu", inputs=inputs)
    eng, fs, FV, FU = c._compile_schedule(SCHEDULES[name](ins))
    assert turbo.eligible(eng.ir)
    hv, hu, _last = eng.run_levels(fs, FV[None], FU[None], None)
    tv, tu = eng.run_ticks(fs, FV, FU)
    np.testing.assert_array_equal(tengine._u32(hv[0]), tv)
    np.testing.assert_array_equal(tengine._u32(hu[0]), tu)


def test_forced_overlap_last_write_wins():
    """A signal forced twice in one tick (an INPUT and an automaton or a
    VERILOG_MODULE output) takes the last value, as the JAX package's
    sequential scatter gives it."""
    np.testing.assert_array_equal(tengine.last_writes([4, 2, 4, 7, 2, 4]),
                                  [3, 4, 5])
    c = _port_circuit()
    ins, nets = dc.every_kind(tpe, c)
    eng = c.digital_engine()
    sig = eng.ir.node_sig[id(c.nl.nodes[0])]
    fs = np.array([sig, sig, sig], np.int32)
    for vals, want in (([0, 0, 0xFFFFFFFF], 0xFFFFFFFF),
                       ([0xFFFFFFFF, 0xFFFFFFFF, 0], 0)):
        fv = np.array(vals, np.uint32)
        fu = np.zeros(3, np.uint32)
        sv, su, st = eng._planes(1)
        out = eng.tick_fn(sv, su, st, *eng._forced_dev(fs, fv, fu),
                          eng._analog(None))
        assert int(out[0][0, sig]) & 0xFFFFFFFF == want
        assert int(out[1][0, sig]) == 0


def test_tick_leaves_inputs_untouched():
    c = _port_circuit()
    dc.every_kind(tpe, c)
    eng = c.digital_engine()
    sv, su, st = eng._planes(2)
    before = (sv.clone(), su.clone(),
              {k: {n: a.clone() for n, a in d.items()} for k, d in st.items()})
    fs, fv, fu = eng._forced_dev(*eng._forced_arrays_np())
    eng.tick_fn(sv, su, st, fs, fv, fu, eng._analog(None))
    assert torch.equal(sv, before[0]) and torch.equal(su, before[1])
    for k, d in before[2].items():
        for n, a in d.items():
            assert torch.equal(st[k][n], a)
