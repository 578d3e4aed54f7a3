"""The port's user API (``phy_engine_tpu_torch/api.py``) against the JAX
package's: every case of ``tests/test_api.py`` built once from one
description and run through both packages on the CPU.  Analog samples
agree to 1e-9, digital states and Verilog runtime values are equal, and
the element-code tables are the same."""

import numpy as np
import pytest

from phy_engine_tpu import api as japi
from phy_engine_tpu_torch import api as tapi
from phy_engine_tpu_torch.digital import BACKENDS
from phy_engine_tpu_torch.engine.circuit import (DIGITAL_BACKENDS,
                                                 Circuit as CoreCircuit)

TOL = 1e-9
PACKAGES = (japi, tapi)


def _circuit(api, elements, wires, **kw):
    """``api.Circuit`` on the CPU (the JAX class ignores ``device``)."""
    els = [api.Element(*e) if isinstance(e, tuple) else api.Element(e)
           for e in elements]
    return api.Circuit(els, [api.Wire(*w) for w in wires], device="cpu",
                       **kw)


def _flat(sample):
    """(codes, pin voltages, branch currents, digital states) of a
    CircuitSample, component by component."""
    comps = sample.components
    return ([c.code for c in comps],
            np.array([v for c in comps for v in c.pin_voltages]),
            np.array([i for c in comps for i in c.branch_currents]),
            [d for c in comps for d in c.digital_states])


def _same_sample(a, b):
    ca, va, ia, da = _flat(a)
    cb, vb, ib, db = _flat(b)
    assert ca == cb and da == db
    np.testing.assert_allclose(vb, va, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ib, ia, rtol=TOL, atol=TOL * 1e-3)


DIVIDER = ([japi.ElementCode.GROUND, (japi.ElementCode.VDC, (4.0,)),
            (japi.ElementCode.RESISTOR, (1000.0,)),
            (japi.ElementCode.RESISTOR, (3000.0,))],
           [(1, 0, 2, 0), (2, 1, 3, 0), (3, 1, 0, 0), (1, 1, 0, 0)])


def test_element_code_divider():
    out = []
    for api in PACKAGES:
        c = _circuit(api, *DIVIDER)
        assert c.component_count == 3
        c.set_analyze_type(api.AnalyzeType.DC)
        s = c.analyze_and_sample()
        assert np.isclose(s.components[0].pin_voltages[0], 4.0)
        assert np.isclose(s.components[0].branch_currents[0], -1e-3)
        assert np.isclose(s.components[2].pin_voltages[0], 3.0)
        out.append((s, c.sample_layout()))
    _same_sample(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]


def test_element_code_noise():
    r1, r2 = 4.7e3, 1.2e3
    els = [japi.ElementCode.GROUND, (japi.ElementCode.VDC, (1.0,)),
           (japi.ElementCode.RESISTOR, (r1,)),
           (japi.ElementCode.RESISTOR, (r2,))]
    res = []
    for api in PACKAGES:
        c = _circuit(api, els, DIVIDER[1])
        c.set_ac_omega(2 * np.pi * 1e4)
        res.append(c.noise(2, out_pin=1, src_element=1))
    np.testing.assert_allclose(np.asarray(res[1].onoise_psd),
                               np.asarray(res[0].onoise_psd), rtol=TOL)
    np.testing.assert_allclose(np.asarray(res[1].gain2),
                               np.asarray(res[0].gain2), rtol=TOL)


def _and_gate(api):
    H = float(api.DigitalState.H)
    return _circuit(api, [(api.ElementCode.DIGITAL_INPUT, (H,)),
                          (api.ElementCode.DIGITAL_INPUT, (H,)),
                          api.ElementCode.DIGITAL_AND,
                          api.ElementCode.DIGITAL_OUTPUT],
                    [(0, 0, 2, 0), (1, 0, 2, 1), (2, 2, 3, 0)])


def test_digital_codes_and_gate():
    trace = []
    for api in PACKAGES:
        c = _and_gate(api)
        c.digital_clk()
        s1 = c.sample()
        c.set_model_digital(1, api.DigitalState.L)
        c.digital_clk()
        s2 = c.sample()
        assert s1.components[3].digital_states[0] == api.DigitalState.H
        assert s2.components[3].digital_states[0] == api.DigitalState.L
        trace.append((s1, s2))
    for a, b in zip(*trace):
        _same_sample(a, b)


def test_builder_rc():
    out = []
    for api in PACKAGES:
        b = api.NetlistBuilder()
        gnd = b.add_element(api.ElementCode.GROUND, name="gnd")
        v = b.add_element(api.ElementCode.VDC, (2.0,), name="v1")
        r1 = b.add_element(api.ElementCode.RESISTOR, (1e3,), name="r1")
        r2 = b.add_element(api.ElementCode.RESISTOR, (1e3,), name="r2")
        top = b.create_node("top")
        mid = b.create_node("mid")
        b.add_to_node(v, 0, top)
        b.add_to_node(r1, 0, top)
        b.add_to_node(r1, 1, mid)
        b.add_to_node(r2, 0, mid)
        b.connect_pins(r2.pin(1), gnd.pin(0))
        b.connect_pins(v.pin(1), gnd.pin(0))
        c = b.build(device="cpu")
        c.set_analyze_type(api.AnalyzeType.DC)
        s = c.analyze_and_sample()
        assert np.isclose(s.components[2].pin_voltages[0], 1.0)
        out.append(s)
    _same_sample(*out)


COUNTER = """
module counter(input clk, input rst_n, output [3:0] q);
  reg [3:0] cnt;
  always @(posedge clk or negedge rst_n) begin
    if (!rst_n) cnt <= 4'd0;
    else cnt <= cnt + 4'd1;
  end
  assign q = cnt;
endmodule
"""


def test_verilog_runtime():
    logs = []
    for api in PACKAGES:
        vr = api.VerilogRuntime(COUNTER, top="counter")
        log = [vr.top_module_name,
               [(p.name, int(p.direction), p.width) for p in vr.ports()],
               vr.signals(), vr.modules(), vr.preprocessed]
        vr.set_value("rst_n", 0)
        vr.set_value("clk", 0)
        vr.tick()
        vr.set_value("rst_n", 1)
        vr.tick()
        for _ in range(3):
            vr.set_value("clk", 1)
            log.append((vr.tick(), vr.get_value("q"), vr.get_state("q")))
            vr.set_value("clk", 0)
            log.append((vr.tick(), vr.get_value("q")))
        vr.set_state("rst_n", 0)
        vr.step_at(20)
        log.append((vr.get_tick(), vr.get_value("q"), vr.is_known("q")))
        vr.reset()
        log.append((vr.get_tick(), vr.is_known("q")))
        logs.append(log)
    assert logs[0] == logs[1]
    assert [x[1] for x in logs[1][5:11:2]] == [1, 2, 3]


def test_verilog_module_element():
    src = """
module inv(input a, output y);
  assign y = ~a;
endmodule
"""
    out = []
    for api in PACKAGES:
        c = _circuit(api, [(api.ElementCode.DIGITAL_INPUT,
                            (float(api.DigitalState.L),)),
                           (api.ElementCode.VERILOG_MODULE, (), src, "inv"),
                           api.ElementCode.DIGITAL_OUTPUT],
                     [(0, 0, 1, 0), (1, 1, 2, 0)])
        c.digital_clk()
        s = c.sample()
        assert s.components[2].digital_states[0] == api.DigitalState.H
        out.append(s)
    _same_sample(*out)


def test_verilog_netlist_element():
    src = """
module xnor2(input a, input b, output y);
  assign y = ~(a ^ b);
endmodule
"""
    out = []
    for api in PACKAGES:
        H = float(api.DigitalState.H)
        c = _circuit(api, [(api.ElementCode.DIGITAL_INPUT, (H,)),
                           (api.ElementCode.DIGITAL_INPUT, (H,)),
                           (api.ElementCode.VERILOG_NETLIST, (), src, "xnor2"),
                           api.ElementCode.DIGITAL_OUTPUT],
                     [(0, 0, 2, 0), (1, 0, 2, 1), (2, 2, 3, 0)])
        c.digital_clk()
        s1 = c.sample()
        c.set_model_digital(1, False)
        c.digital_clk()
        out.append((s1, c.sample()))
        assert s1.components[3].digital_states[0] == api.DigitalState.H
        assert out[-1][1].components[3].digital_states[0] == \
            api.DigitalState.L
    for a, b in zip(*out):
        _same_sample(a, b)


def test_synth_config_globals():
    """Same defaults, and each package's global is its own: setting one
    leaves the other as it was."""
    assert japi.get_verilog_synth_config() == \
        japi.VerilogSynthConfig()
    assert vars(tapi.get_verilog_synth_config()) == \
        vars(japi.get_verilog_synth_config())
    prev = tapi.get_verilog_synth_config()
    try:
        tapi.set_verilog_synth_config(opt_level=3, loop_unroll_limit=None)
        assert tapi.get_verilog_synth_config().opt_level == 3
        assert tapi.get_verilog_synth_config().loop_unroll_limit == 64
        assert japi.get_verilog_synth_config().opt_level == 0
    finally:
        tapi.set_verilog_synth_config(**vars(prev))
    assert tapi.get_verilog_synth_config() == prev


def test_property_arity_table():
    assert tapi.PROPERTY_ARITY == japi.PROPERTY_ARITY
    assert {e.name: int(e) for e in tapi.ElementCode} == \
        {e.name: int(e) for e in japi.ElementCode}
    assert {int(k): (m.id_name, props)
            for k, (m, props) in tapi._CODE_TABLE.items()} == \
        {int(k): (m.id_name, props)
         for k, (m, props) in japi._CODE_TABLE.items()}
    assert tapi.PROPERTY_ARITY[int(tapi.ElementCode.PN_JUNCTION)] == 9
    assert tapi.PROPERTY_ARITY[int(tapi.ElementCode.PULSE)] == 7
    assert tapi.PROPERTY_ARITY[int(tapi.ElementCode.GROUND)] == 0


def test_element_code_sweeps_and_four():
    """dc_sweep / temp_sweep equal across the packages; monte_carlo draws
    from each package's own generator, so each lane is held to the
    divider law of its own sampled resistances."""
    r1, r2, e = 2e3, 3e3, 2.0
    els = [japi.ElementCode.GROUND, (japi.ElementCode.VDC, (e,)),
           (japi.ElementCode.RESISTOR, (r1,)),
           (japi.ElementCode.RESISTOR, (r2,))]
    vals = np.linspace(0.0, 4.0, 9)
    out = []
    for api in PACKAGES:
        c = _circuit(api, els, DIVIDER[1])
        res = c.dc_sweep(1, "V", vals, out_element=2, out_pin=1)
        assert np.asarray(res.ok).all()
        ts = c.temp_sweep([0.0, 27.0, 100.0], out_element=2, out_pin=1)
        assert np.asarray(ts.ok).all()
        mc = c.monte_carlo({"R": {"r": 0.1}}, n=8)
        assert np.asarray(mc.ok).all()
        rr = np.asarray(mc.param_of(c.core.nl.live_models()[1], "r"))
        rb = np.asarray(mc.param_of(c.core.nl.live_models()[2], "r"))
        mid = c.core.nl.live_models()[1].pins[1].node
        np.testing.assert_allclose(np.asarray(mc.trace(mid)),
                                   e * rb / (rr + rb), rtol=1e-12)
        out.append((np.asarray(res.out), np.asarray(ts.out)))
    np.testing.assert_allclose(out[1][0], vals * r2 / (r1 + r2), rtol=1e-12)
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_circuit_keywords():
    """``device`` and ``digital_backend`` reach the core Circuit, other
    keywords are ignored (as the JAX class ignores every keyword), and a
    bad backend is a ValueError when the circuit is built, on both
    surfaces."""
    c = _circuit(tapi, *DIVIDER, digital_backend="native", foo=1)
    assert isinstance(c.core, CoreCircuit)
    assert str(c.core.device) == "cpu"
    assert c.core.digital_backend == "native"
    assert DIGITAL_BACKENDS == BACKENDS
    with pytest.raises(ValueError, match="digital backend"):
        _circuit(tapi, *DIVIDER, digital_backend="levels")
    with pytest.raises(ValueError, match="digital backend"):
        CoreCircuit(device="cpu", digital_backend="turbo")
