"""Port parity: the digital turbo path of phy_engine_tpu_torch against the
JAX package, on the CPU (the tick's plain torch version).

The same designs (test_torch_verilog.DESIGNS) and the same schedules,
made with numpy from a seed, go through both packages.  DigitalIR and
TurboPlan must be identical array for array; tick histories must be
bit-identical on every slot, tick, lane and plane (no tolerance: the
engine is exact integer logic)."""

import functools
import os

import numpy as np
import pytest
import torch

from phy_engine_tpu.digital import turbo as jturbo

from phy_engine_tpu_torch import workloads
from phy_engine_tpu_torch.digital import turbo

from test_torch_verilog import DESIGNS, built, jax_synth
from test_turbo import _snake_schedule


def slab_to_planes(slab):
    """JAX (Khi, 512) f32 slab of u16 halves -> (2, K) uint32 [V; U]."""
    h = np.asarray(slab).astype(np.uint32)
    v = h[:, 0:128] | (h[:, 128:256] << 16)
    u = h[:, 256:384] | (h[:, 384:512] << 16)
    return np.stack([v.reshape(-1), u.reshape(-1)])


def fsm_schedule(ins):
    clk, rst, d = ins["clk"][0], ins["rst_n"][0], ins["d"][0]
    sched = [{}, {rst: 0}, {rst: 0, clk: 1}, {rst: 1, clk: 0}]
    for b in [1, 1, 0, 1, 0, 0, 1]:
        sched.append({rst: 1, d: b, clk: 1})
        sched.append({rst: 1, d: b, clk: 0})
    return sched


def fp16_schedule(ins, ticks=6, seed=3):
    """Random per-lane words on every input bit, a quarter of the lanes
    X (v=0, u=1) or Z (v=1, u=1)."""
    rng = np.random.default_rng(seed)
    sched = []
    for _ in range(ticks):
        e = {}
        for name in ("a", "b"):
            for m in ins[name]:
                v = int(rng.integers(0, 2 ** 32))
                u = int(rng.integers(0, 2 ** 32)) & int(rng.integers(0, 2 ** 32))
                e[m] = (v, u)
        sched.append(e)
    return sched


def rv32_schedule(ins):
    clk, rst = ins["clk"][0], ins["rst_n"][0]
    return [{}, {clk: 1}, {clk: 0}, {rst: 1},
            {clk: 1, rst: 1}, {clk: 0, rst: 1}]


SCHEDULES = {"snake": _snake_schedule, "fp16": fp16_schedule,
             "fsm": fsm_schedule, "rv32": rv32_schedule}


def _both(name):
    """JAX engine + compiled schedule, port engine + compiled schedule."""
    (jc, ji, _jp, _jr), (tc, ti, _tp, _tr) = built(name)
    jc.prepare()
    _e, fs, FV, FU = jc._compile_schedule(SCHEDULES[name](ji))
    teng = tc.digital_engine()
    _e, tfs, TFV, TFU = tc._compile_schedule(SCHEDULES[name](ti))
    np.testing.assert_array_equal(tfs, fs)
    np.testing.assert_array_equal(TFV, FV)
    np.testing.assert_array_equal(TFU, FU)
    return jc._digital, (fs, FV, FU), teng


def _jax_start(jeng, fs):
    jplan = jturbo.TurboPlan(jeng.ir, fs)
    state0 = jplan.pack_state(np.asarray(jeng.sv), np.asarray(jeng.su),
                              jeng.seq_state)
    return jplan, state0


def _port_run(teng, fs, FV, FU, jstate0):
    plan = teng.plan(fs)
    st0 = plan.pack_state(teng.sv, teng.su, teng.seq_state)
    np.testing.assert_array_equal(st0.view(np.uint32), slab_to_planes(jstate0))
    hv, hu = turbo.run_turbo(plan, torch.from_numpy(st0)[None],
                             turbo.as_int32(FV)[None], turbo.as_int32(FU)[None])
    return plan.unpack_hist(hv[0], hu[0])


@pytest.mark.parametrize("name", list(DESIGNS))
def test_ir_matches_jax(name):
    (jc, _ji, _jp, _jr), (tc, _ti, _tp, _tr) = built(name)
    jc.prepare()
    j, t = jc._digital.ir, tc.digital_engine().ir
    jplace = {id(n): i for i, n in enumerate(jc.nl.all_nodes())}
    tplace = {id(n): i for i, n in enumerate(tc.nl.all_nodes())}
    assert t.n_signals == j.n_signals
    assert ({tplace[k]: s for k, s in t.node_sig.items()}
            == {jplace[k]: s for k, s in j.node_sig.items()})
    assert len(t.levels) == len(j.levels)
    for tl, jl in zip(t.levels + [t.cyclic, t.seq], j.levels + [j.cyclic, j.seq]):
        assert [s.op for s in tl] == [s.op for s in jl]
        for ts, js in zip(tl, jl):
            np.testing.assert_array_equal(ts.inputs, js.inputs)
            np.testing.assert_array_equal(ts.outputs, js.outputs)
            assert ts.inputs.dtype == js.inputs.dtype
            assert len(ts.instances) == len(js.instances)
    for tio, jio in ((t.inputs, j.inputs), (t.outputs, j.outputs)):
        assert [(m.mdef.id_name, list(s)) for m, s in tio] == \
            [(m.mdef.id_name, list(s)) for m, s in jio]
    assert t.tick_delays is None and j.tick_delays is None
    for a in ("samp_sig", "samp_ll", "samp_hl", "samp_tsu", "samp_th",
              "drv_sig", "drv_ll", "drv_hl"):
        np.testing.assert_array_equal(getattr(t, a), getattr(j, a))
    assert t.cyclic_budget == j.cyclic_budget and not t.vmods and not j.vmods


@pytest.mark.parametrize("name", list(DESIGNS))
def test_plan_matches_jax(name):
    jeng, (fs, _FV, _FU), teng = _both(name)
    assert turbo.eligible(teng.ir) and jturbo.eligible(jeng.ir)
    t, j = teng.plan(fs), jturbo.TurboPlan(jeng.ir, fs)
    for a in ("S", "K", "Khi", "trash", "n_cone", "n_full", "nf", "nf_pad",
              "ff_ranges"):
        assert getattr(t, a) == getattr(j, a), a
    for a in ("cone_tab", "full_tab", "ff_tab", "f_hi", "f_lo"):
        x, y = getattr(t, a), getattr(j, a)
        assert x.dtype == y.dtype, a
        np.testing.assert_array_equal(x, y)
    assert [(op, list(q), list(lc)) for op, q, lc in t.ff_meta] == \
        [(op, list(q), list(lc)) for op, q, lc in j.ff_meta]


@pytest.mark.parametrize("name", ["snake", "fp16", "rv32"])
def test_ticks_match_run_xla(name):
    """Snake's schedule, fp16 with X/Z lanes, 6 ticks of RV32 from
    reset: bit-identical to ``turbo.run_xla`` on every slot."""
    jeng, (fs, FV, FU), teng = _both(name)
    jplan, state0 = _jax_start(jeng, fs)
    jv, ju = jplan.unpack_hist(*jturbo.run_xla(jplan, state0, FV, FU))
    tv, tu = _port_run(teng, fs, FV, FU, state0)
    assert tv.shape == jv.shape == (len(FV), jplan.K)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tu, ju)
    if name == "fp16":                       # X and Z lanes did occur
        assert (tu[:, :jplan.S] != 0).any() and (tu[:, :jplan.S] != 0xFFFFFFFF).any()


def test_ticks_match_run_pallas_interpret():
    """The tiny FSM against the Pallas kernel itself in interpret mode."""
    jeng, (fs, FV, FU), teng = _both("fsm")
    jplan, state0 = _jax_start(jeng, fs)
    jv, ju = jplan.unpack_hist(*jturbo.run_pallas(jplan, state0, FV, FU,
                                                  interpret=True))
    tv, tu = _port_run(teng, fs, FV, FU, state0)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tu, ju)


def test_batched_matches_run_xla_batch():
    """fp16, B = 3 instances with their own schedules, a watch list."""
    jeng, (fs, _FV, _FU), teng = _both("fp16")
    (jc, ji, _jp, _jr), (tc, ti, _tp, _tr) = built("fp16")
    comp = [jc._compile_schedule(fp16_schedule(ji, ticks=5, seed=s))
            for s in (7, 8, 9)]
    FV = np.stack([c[2] for c in comp])
    FU = np.stack([c[3] for c in comp])
    watch = [int(s) for s in np.random.default_rng(1).choice(
        jeng.ir.n_signals, 40, replace=False)]
    jplan, state0 = _jax_start(jeng, fs)
    jv, ju = jturbo.run_xla_batch(jplan, state0, FV, FU, watch)
    tv, tu = teng.run_ticks_batched(fs, FV, FU, watch=watch)
    assert tv.shape == jv.shape == (3, 5, 40)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tu, ju)
    # the watch list picks the same words as the full history
    fv, fu = teng.run_ticks_batched(fs, FV, FU)
    np.testing.assert_array_equal(fv[..., watch], tv)
    np.testing.assert_array_equal(fu[..., watch], tu)


@functools.lru_cache(maxsize=None)
def levels_halves():
    """Snake on the JAX levelled engine, the bit-exact oracle: the
    schedule's two halves as two digital_run calls (one compiled shape),
    with the engine state between them."""
    src, top, inputs = DESIGNS["snake"]
    jc, ji, jp, _ = jax_synth(src, top, inputs)
    js = _snake_schedule(ji)
    assert len(js) % 2 == 0
    old = os.environ.get("PE_TPU_DIGITAL")
    os.environ["PE_TPU_DIGITAL"] = "levels"
    try:
        first = jc.digital_run(js[:len(js) // 2])
        eng = jc._digital
        mid = (np.asarray(eng.sv), np.asarray(eng.su),
               {op: {k: np.asarray(v) for k, v in d.items()}
                for op, d in eng.seq_state.items()},
               jc.node_digital(jp["head"][0]))
        second = jc.digital_run(js[len(js) // 2:])
    finally:
        if old is None:
            os.environ.pop("PE_TPU_DIGITAL", None)
        else:
            os.environ["PE_TPU_DIGITAL"] = old
    return jp, first, mid, second, jc.node_digital(jp["head"][0])


def _port_snake():
    src, top, inputs = DESIGNS["snake"]
    tc, ti, tp, _ = workloads.synth_top(src, top, "cpu", inputs=inputs)
    return tc, _snake_schedule(ti), tp


def test_circuit_digital_run_matches_levels_engine():
    """End to end on snake: the port's Circuit.digital_run against the JAX
    Circuit.digital_run on the levelled engine."""
    jp, first, _mid, second, head = levels_halves()
    tc, ts, tp = _port_snake()
    tr = tc.digital_run(ts)
    np.testing.assert_array_equal(tr.sv, np.concatenate([first.sv, second.sv]))
    np.testing.assert_array_equal(tr.su, np.concatenate([first.su, second.su]))
    n = len(first)
    for port in ("head", "length", "food"):
        np.testing.assert_array_equal(tr.bus_values(tp[port])[n:],
                                      second.bus_values(jp[port]))
        np.testing.assert_array_equal(tr.bus_values_lanes(tp[port])[:n],
                                      first.bus_values_lanes(jp[port]))
    np.testing.assert_array_equal(tr.node_codes(tp["dead"][0])[n:],
                                  second.node_codes(jp["dead"][0]))
    # the final state is committed into the netlist and the engine
    assert tc.node_digital(tp["head"][0]) == head


def test_load_state_continues_jax_run():
    """Start the port from the JAX engine's mid-run state: the rest of
    the run matches the JAX engine's, and the state round-trips."""
    jp, first, (sv, su, seq, head_mid), second, _head = levels_halves()
    tc, ts, tp = _port_snake()
    teng = tc.digital_engine()
    teng.load_state(sv, su, seq)
    np.testing.assert_array_equal(teng.sv, sv)
    np.testing.assert_array_equal(teng.su, su)
    for op, d in seq.items():
        for k, v in d.items():
            np.testing.assert_array_equal(teng.seq_state[op][k], v)
    assert tc.node_digital(tp["head"][0]) == head_mid
    tr = tc.digital_run(ts[len(first):])
    np.testing.assert_array_equal(tr.sv, second.sv)
    np.testing.assert_array_equal(tr.su, second.su)
    with pytest.raises(ValueError):
        teng.load_state(sv[:-1], su, seq)


def test_rv32_run_single_and_batched_agree():
    d = workloads.build_rv32(device="cpu")
    res1, done1 = workloads.rv32_run(1, 1, device="cpu", design=d)
    resb, doneb = workloads.rv32_run(3, 1, device="cpu", design=d)
    assert res1.shape == done1.shape == (1,)
    assert resb.shape == doneb.shape == (3,)
    assert (resb == res1[0]).all() and (doneb == done1[0]).all()
    assert done1[0] in (0, 1)


def test_ineligible_design_raises(monkeypatch):
    """A design the turbo tick cannot run (a D latch), its output on an
    analog net (a resistor to ground): once refused, now the levelled
    tick and the drive slots run it.  Planes, the OUTPUT's value and the
    driven node's voltage after every tick and OP match the JAX
    package's."""
    import torch_circuit_cases as cases
    monkeypatch.setenv("PE_TPU_DIGITAL", "levels")
    spec = [("d", "INPUT", {"boolean": 0.0}, ("d",)),
            ("en", "INPUT", {"boolean": 0.0}, ("en",)),
            ("lat", "D_LATCH", {}, ("d", "en", "q")),
            ("out", "OUTPUT", {}, ("q",)),
            ("r", "RESISTANCE", {"r": 1.0}, ("q", "0"))]
    j, t = cases.both(spec)
    assert not turbo.eligible(t.c.digital_engine().ir)
    assert t.c.prepare().n_drive_slots == 1
    seen = set()
    for dv, ev in ((1, 1), (0, 0), (0, 1), (1, 2), (1, 1), (0, 0)):
        for b in (j, t):
            b.devs["d"].set_attribute("boolean", float(dv))
            b.devs["en"].set_attribute("boolean", float(ev))
            b.c.digital_clk()
            b.c.set_analyze_type(b.mod.AnalyzeType.OP)
            assert b.c.analyze()
        np.testing.assert_array_equal(t.c._digital.sv,
                                      np.asarray(j.c._digital.sv))
        np.testing.assert_array_equal(t.c._digital.su,
                                      np.asarray(j.c._digital.su))
        assert t.devs["out"].params["value"] == j.devs["out"].params["value"]
        vq = t.c.node_voltage(t.nodes["q"]).real
        assert vq == j.c.node_voltage(j.nodes["q"]).real
        seen.add((t.devs["out"].params["value"], vq))
    assert {v for v, _q in seen} == {0, 1}
    assert {q for _v, q in seen} == {0.0, 5.0}


def test_wrapper_checks_its_arguments():
    jeng, (fs, FV, FU), teng = _both("fsm")
    plan = teng.plan(fs)
    st0 = torch.from_numpy(plan.pack_state(teng.sv, teng.su, teng.seq_state))
    fv, fu = turbo.as_int32(FV)[None], turbo.as_int32(FU)[None]
    with pytest.raises(ValueError, match="state0"):
        turbo.run_turbo(plan, st0, fv, fu)                 # no batch axis
    with pytest.raises(TypeError):
        turbo.run_turbo(plan, st0[None].long(), fv, fu)
    with pytest.raises(ValueError, match="FV"):
        turbo.run_turbo(plan, st0[None], fv[..., :-1], fu)
    with pytest.raises(ValueError, match="watch"):
        turbo.run_turbo(plan, st0[None], fv, fu, watch=[plan.K])
    before = turbo.run_turbo.launches
    turbo.run_turbo(plan, st0[None], fv, fu, watch=[0, 1])
    assert turbo.run_turbo.launches == before        # CPU: plain version
