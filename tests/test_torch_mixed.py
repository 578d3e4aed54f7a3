"""Port parity: mixed signal in phy_engine_tpu_torch (on the CPU) against
the JAX package — digital drives in every analysis, the SAR ADC of
``tests/test_adc.py``, the Tsu/Th automata of ``tests/test_unsteady.py``
and the VERILOG_MODULE device of ``tests/test_verilog_module.py``.

Held: digital planes and node codes bit-identical after every tick,
SAR codes equal and DAC voltages within 1e-6 relative, the analyses'
solutions within ``torch_circuit_cases.TOL`` (1e-9 of max|x|), and the
sweeps refusing a mixed-signal netlist as the JAX package's do."""

import numpy as np
import pytest
import torch

import phy_engine_tpu as jpe
import phy_engine_tpu_torch as tpe
from phy_engine_tpu_torch import workloads

import test_adc
import torch_circuit_cases as cases
import torch_digital_cases as dc

torch.set_num_threads(1)

DAC_TOL = 1e-6

# a gate drives the RC net "drv" -> "out"; a VDC divider loads "out"
MIXED_RC = [("a", "INPUT", {"boolean": 1.0}, ("a",)),
            ("b", "INPUT", {"boolean": 1.0}, ("b",)),
            ("g", "AND", {"Hl": 5.0, "Ll": 0.0}, ("a", "b", "drv")),
            ("r", "RESISTANCE", {"r": 1e3}, ("drv", "out")),
            ("cl", "CAPACITOR", {"C": 1e-6}, ("out", "0")),
            ("v", "VDC", {"V": 2.0}, ("top", "0")),
            ("r2", "RESISTANCE", {"r": 2e3}, ("top", "out"))]


@pytest.mark.parametrize("name", list(dc.MIXED))
def test_mixed_case_matches_jax(name, monkeypatch):
    monkeypatch.setenv("PE_TPU_DIGITAL", "levels")
    t = dc.run_case(tpe, name, lambda: tpe.Circuit(device="cpu"))
    j = dc.run_case(jpe, name, jpe.Circuit)
    dc.assert_same(t, j)


def _drive_high(b):
    """OP with the drive inactive, then one tick: the gate requests 5 V."""
    b.c.set_analyze_type(b.mod.AnalyzeType.OP)
    assert b.c.analyze()
    b.c.digital_clk()
    assert b.c._drives is not None


@pytest.mark.parametrize("at", ["OP", "DC", "TROP", "TR", "TR_ADAPTIVE",
                                "AC"])
def test_analyses_apply_the_drives(at, monkeypatch):
    monkeypatch.setenv("PE_TPU_DIGITAL", "levels")
    j, t = cases.both(MIXED_RC, _drive_high)
    for b in (j, t):
        b.c.tr.t_step, b.c.tr.t_stop = 1e-4, 2e-3
        b.c.tr.adaptive = at == "TR_ADAPTIVE"
        b.c.ac = b.mod.ACSettings(sweep=b.mod.ACSweepType.LOG,
                                  omega_start=10.0, omega_stop=1e5, points=7)
        b.c.set_analyze_type(getattr(b.mod.AnalyzeType,
                                     "TR" if at == "TR_ADAPTIVE" else at))
        assert b.c.analyze()
    if at in ("OP", "DC", "TROP"):
        # the drive holds "drv" at 5 V: out = 5 * (2k || ...) divider
        assert np.isclose(t.c.node_voltage(t.nodes["drv"]).real, 5.0,
                          atol=1e-9)
    if at == "AC":
        for (wj, xj), (wt, xt) in zip(j.c.ac_sweep_results,
                                      t.c.ac_sweep_results):
            assert wj == wt
            cases.assert_close(xt, xj)
    elif at.startswith("TR"):
        cases.assert_same_tr(j, t)
    else:
        cases.assert_same_solution(j, t)
    # the drive goes low: every later analysis follows
    for b in (j, t):
        b.devs["b"].set_attribute("boolean", 0.0)
        b.c.digital_clk()
        b.c.set_analyze_type(b.mod.AnalyzeType.OP)
        assert b.c.analyze()
    cases.assert_same_solution(j, t)
    assert abs(t.c.node_voltage(t.nodes["drv"]).real) < 1e-9


def test_noise_and_sens_apply_the_drives(monkeypatch):
    monkeypatch.setenv("PE_TPU_DIGITAL", "levels")
    j, t = cases.both(MIXED_RC, _drive_high)
    res = {}
    for k, b in (("jax", j), ("torch", t)):
        b.c.ac = b.mod.ACSettings(sweep=b.mod.ACSweepType.LOG,
                                  omega_start=10.0, omega_stop=1e5, points=5)
        nz = b.c.noise(b.nodes["out"])
        s = b.c.sens(b.nodes["out"])
        _f, mag, sac = b.c.sens_ac(b.nodes["out"])
        res[k] = (nz.onoise_psd, s, mag, sac, b)
    (jn, js, jm, jsa, jb), (tn, ts, tm, tsa, tb) = res["jax"], res["torch"]
    cases.assert_close(tn, jn)
    cases.assert_close(tm, jm)
    for name in ("r", "r2", "v", "cl"):
        for p in jb.devs[name].mdef.param_order:
            for jr, tr in ((js, ts), (jsa, tsa)):
                ref = np.asarray(jr.get(jb.devs[name], p))
                cases.assert_close(np.asarray(tr.get(tb.devs[name], p)), ref,
                                   1e-8, max(np.abs(ref).max(), 1e-30))
    # the drive fixes "drv": out does not depend on the source through r
    assert abs(ts.get(tb.devs["v"], "V")) < 1.0


def test_sweeps_refuse_a_mixed_netlist():
    for pkg in ("jax", "torch"):
        b = cases.build(pkg, MIXED_RC)
        c = b.c
        for call in (lambda: c.dc_sweep(b.devs["v"], "V", [1.0, 2.0]),
                     lambda: c.temp_sweep([27.0]),
                     lambda: c.monte_carlo({"R": {"r": 0.05}}, 2)):
            with pytest.raises(ValueError, match="mixed-signal"):
                call()


def _jax_sar(bits):
    """tests/test_adc.py's build_adc at ``bits`` (the JAX package)."""
    from phy_engine_tpu import netops
    from phy_engine_tpu.models import COMPARATOR, INPUT, RESISTANCE, VDC
    from phy_engine_tpu.verilog import (build_design, compile_source,
                                        elaborate, find_module)
    from phy_engine_tpu.verilog.synth import (SynthOptions,
                                              synthesize_to_netlist)
    design = build_design(compile_source(workloads.sar_src(bits)))
    topm = find_module(design, f"sar{bits}")
    inst = elaborate(design, topm)
    c = jpe.Circuit()
    nl = c.nl
    pn = {p: [netops.create_node(nl) for _ in range(inst.signals[p].width)]
          for p in topm.ports}
    clk = netops.add_model(nl, INPUT, {"boolean": 0.0})
    rst = netops.add_model(nl, INPUT, {"boolean": 0.0})
    netops.add_to_node(nl, clk, 0, pn["clk"][0])
    netops.add_to_node(nl, rst, 0, pn["rst_n"][0])
    vin = netops.add_model(nl, VDC, {"V": 0.0})
    n_vin = netops.create_node(nl)
    netops.add_to_node(nl, vin, 0, n_vin)
    netops.add_to_node(nl, vin, 1, nl.ground_node)
    ladder = [netops.create_node(nl) for _ in range(bits)]
    rt_ = netops.add_model(nl, RESISTANCE, {"r": 2 * test_adc.R})
    netops.add_to_node(nl, rt_, 0, ladder[0])
    netops.add_to_node(nl, rt_, 1, nl.ground_node)
    for i in range(bits):
        r2 = netops.add_model(nl, RESISTANCE, {"r": 2 * test_adc.R})
        netops.add_to_node(nl, r2, 0, pn["dac"][i])
        netops.add_to_node(nl, r2, 1, ladder[i])
        if i < bits - 1:
            r1 = netops.add_model(nl, RESISTANCE, {"r": test_adc.R})
            netops.add_to_node(nl, r1, 0, ladder[i])
            netops.add_to_node(nl, r1, 1, ladder[i + 1])
    cmp_ = netops.add_model(nl, COMPARATOR)
    netops.add_to_node(nl, cmp_, 0, n_vin)
    netops.add_to_node(nl, cmp_, 1, ladder[-1])
    netops.add_to_node(nl, cmp_, 2, pn["cmp"][0])
    synthesize_to_netlist(nl, design, inst, pn, SynthOptions(opt_level=1))
    c.set_analyze_type(jpe.AnalyzeType.OP)
    return workloads.Sar(c, clk, rst, vin, pn, ladder[-1], bits)


def test_sar_source_is_the_tests_design():
    assert workloads.sar_src(8) == test_adc.SAR_SRC
    assert (workloads.SAR_R, workloads.SAR_VREF) == (test_adc.R,
                                                     test_adc.VREF)


def test_sar8_matches_jax(monkeypatch):
    """tests/test_adc.py's voltages and rails through its own build_adc /
    convert (JAX) and workloads.sar_adc / sar_convert (the port)."""
    monkeypatch.setenv("PE_TPU_DIGITAL", "levels")
    j = test_adc.build_adc()
    t = workloads.sar_adc(8, "cpu")
    lsb = test_adc.VREF / 256.0
    for v_in in (0.7, 1.23, 2.5, 3.9, 4.97, -0.5, 5.5):
        jcode, jv = test_adc.convert(*j, v_in)
        tcode, tv = workloads.sar_convert(t, v_in)
        assert tcode == jcode, (v_in, tcode, jcode)
        assert abs(tv - jv) <= DAC_TOL * max(abs(jv), lsb), (v_in, tv, jv)
        ideal = min(max(v_in, 0.0), test_adc.VREF - lsb) / lsb
        assert abs(tcode - ideal) <= 1.0 + 1e-9, (v_in, tcode)


@pytest.mark.parametrize("v_in", [1.2345, 3.98765])
def test_sar16_matches_jax(v_in, monkeypatch):
    """The 16-bit SAR (the reference's test/0028.16b_adc) at two
    voltages, LSB = 5 V / 65536."""
    monkeypatch.setenv("PE_TPU_DIGITAL", "levels")
    jcode, jv = workloads.sar_convert(_jax_sar(16), v_in)
    tcode, tv = workloads.sar_convert(workloads.sar_adc(16, "cpu"), v_in)
    lsb = workloads.SAR_VREF / 2 ** 16
    assert tcode == jcode, (tcode, jcode)
    assert abs(tv - jv) <= DAC_TOL * abs(jv)
    assert abs(tcode - v_in / lsb) <= 1.0 + 1e-9
