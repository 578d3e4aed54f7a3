"""Port parity: the ``Circuit`` driver's OP / DC analyses against the JAX
package's, on every circuit of ``tests/test_dc.py`` and on one circuit
per linear family the DC tests do not reach (CCVS, CCCS, the centre-tap
transformer, coupled inductors, the inductor, IAC and the waveform
sources at t = 0).  Each circuit is built once per package from one
description (``torch_circuit_cases``).

Tolerance met: the solution vector, node voltages, branch currents and
device runtime states within 1e-9 relative to max|x| of the JAX result
(both solve the same f64 systems with the same partial-pivoted
Gauss-Jordan); ``ok`` flags exactly.
"""

import numpy as np
import pytest
import torch

import phy_engine_tpu as jpe
import phy_engine_tpu_torch as tpe

from torch_circuit_cases import analyze_both, assert_same_solution, both
from torch_circuits import divider, mesh_routes_run

torch.set_num_threads(1)


def _ladder(n=50, seed=42):
    rs = np.random.default_rng(seed).uniform(10.0, 1e4, size=n)
    spec = [("v", "VDC", {"V": 3.0}, ("n0", "0"))]
    for i, r in enumerate(rs):
        spec.append((f"r{i}", "RESISTANCE", {"r": float(r)},
                     (f"n{i}", "0" if i == n - 1 else f"n{i + 1}")))
    return spec


CIRCUITS = {
    "divider": divider(),
    "series_ladder": _ladder(),
    "current_source": [
        ("i", "IDC", {"I": 2e-3}, ("0", "n1")),
        ("r", "RESISTANCE", {"r": 500.0}, ("n1", "0"))],
    "vcvs_gain": [
        ("v", "VDC", {"V": 1.5}, ("in", "0")),
        ("e", "VCVS", {"mu": 4.0}, ("out", "0", "in", "0")),
        ("rl", "RESISTANCE", {"r": 1e3}, ("out", "0"))],
    "vccs": [
        ("v", "VDC", {"V": 2.0}, ("in", "0")),
        ("g", "VCCS", {"g": 1e-3}, ("out", "0", "in", "0")),
        ("r", "RESISTANCE", {"r": 1e3}, ("out", "0"))],
    "opamp_follower": [
        ("v", "VDC", {"V": 1.25}, ("in", "0")),
        ("oa", "OP_AMP", {"mu": 1e6}, ("in", "out", "out", "0"))],
    "transformer": [
        ("v", "VDC", {"V": 10.0}, ("p", "0")),
        ("tx", "TRANSFORMER", {"n": 2.0}, ("p", "0", "s", "0")),
        ("rl", "RESISTANCE", {"r": 100.0}, ("s", "0"))],
    "ccvs_cccs": [
        ("v", "VDC", {"V": 2.0}, ("in", "0")),
        ("rs", "RESISTANCE", {"r": 1e3}, ("in", "m")),
        ("h", "CCVS", {"r": 250.0}, ("o1", "0", "m", "0")),
        ("r1", "RESISTANCE", {"r": 2e3}, ("o1", "0")),
        ("f", "CCCS", {"alpha": 3.0}, ("o2", "0", "m2", "0")),
        ("rs2", "RESISTANCE", {"r": 500.0}, ("in", "m2")),
        ("r2", "RESISTANCE", {"r": 1e3}, ("o2", "0"))],
    "center_tap": [
        ("v", "VDC", {"V": 12.0}, ("p", "0")),
        ("tx", "TRANSFORMER_CENTER_TAP", {"n_half": 4.0},
         ("p", "0", "s1", "0", "s2")),
        ("r1", "RESISTANCE", {"r": 50.0}, ("s1", "0")),
        ("r2", "RESISTANCE", {"r": 80.0}, ("s2", "0"))],
    "inductors_dc_short": [
        ("v", "VDC", {"V": 5.0}, ("a", "0")),
        ("r", "RESISTANCE", {"r": 100.0}, ("a", "b")),
        ("l", "INDUCTOR", {"L": 1e-3}, ("b", "c")),
        ("kl", "COUPLED_INDUCTORS", {"L1": 1e-3, "L2": 4e-3, "k": 0.9},
         ("c", "0", "s", "0")),
        ("rl", "RESISTANCE", {"r": 10.0}, ("s", "0"))],
    "sources_at_t0": [
        ("saw", "SAWTOOTH", {"Vh": 3.0, "Vl": -1.0, "freq": 2e3,
                             "phase": 1.0}, ("a", "0")),
        ("sq", "SQUARE", {"Vh": 2.0, "Vl": 0.5, "duty": 0.3, "phase": 2.0},
         ("b", "a")),
        ("pu", "PULSE", {"Vh": 4.0, "Vl": 1.0, "tr": 1e-5, "tf": 2e-5,
                         "phase": 0.3}, ("c", "b")),
        ("tri", "TRIANGLE", {"Vh": 1.0, "Vl": -2.0, "phase": 4.0},
         ("d", "c")),
        ("iac", "IAC", {"Ip": 1e-3, "phase": 30.0}, ("d", "0")),
        ("r", "RESISTANCE", {"r": 1e3}, ("d", "0"))],
}


@pytest.mark.parametrize("at", ["OP", "DC"])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_op_matches_jax(name, at):
    j, t, ok = analyze_both(CIRCUITS[name], at)
    assert ok
    assert_same_solution(j, t)
    assert t.c._ir.n_unknowns == j.c._ir.n_unknowns


def test_divider_closed_form():
    _j, t, ok = analyze_both(divider(), "DC")
    assert ok
    assert np.isclose(t.c.node_voltage(t.nodes["mid"]).real, 3.0, atol=1e-9)
    assert np.isclose(t.devs["v"].branches[0].current.real, -1e-3,
                      atol=1e-12)


def _switch_spec():
    return [("v", "VDC", {"V": 5.0}, ("a", "0")),
            ("sw", "SWITCH", {"cut_through": 0.0}, ("a", "b")),
            ("r", "RESISTANCE", {"r": 1e3}, ("b", "0"))]


def test_switch_open_closed_matches_jax():
    """set_attribute by display name ("Cut Through") between analyses."""
    j, t = both(_switch_spec())
    for b in (j, t):
        b.c.set_analyze_type(b.mod.AnalyzeType.DC)
        assert b.c.analyze()
    assert_same_solution(j, t)
    assert t.c.node_voltage(t.nodes["b"]).real < 1e-6
    for b in (j, t):
        assert b.devs["sw"].set_attribute("Cut Through", 1.0)
        assert b.c.analyze()
    assert_same_solution(j, t)
    assert np.isclose(t.c.node_voltage(t.nodes["b"]).real, 5.0, atol=1e-6)


def test_parameter_edit_no_restructure():
    j, t = both(divider(2.0, 1e3, 1e3))
    for b in (j, t):
        b.c.set_analyze_type(b.mod.AnalyzeType.DC)
        assert b.c.analyze()
    ir_before = t.c._ir
    for b in (j, t):
        assert b.devs["r2"].set_attribute("r", 3000.0)
        assert b.c.analyze()
    assert t.c._ir is ir_before          # no relowering on a parameter edit
    assert_same_solution(j, t)
    assert np.isclose(t.c.node_voltage(t.nodes["mid"]).real, 1.5)


def test_attribute_api_matches_jax():
    """Names, index access, aliases by case and spaces, unknown keys."""
    j, t = both(CIRCUITS["sources_at_t0"] + _switch_spec())
    for name, jd in j.devs.items():
        td = t.devs[name]
        assert td.attribute_names() == jd.attribute_names()
        for k in range(len(jd.attribute_names()) + 1):
            assert td.get_attribute(k) == jd.get_attribute(k)
        assert td.get_attribute("no such") is jd.get_attribute("no such")
    assert t.devs["sw"].get_attribute("cut through") == 0.0
    assert not t.devs["r"].set_attribute(5, 1.0)
    assert t.devs["r"].set_attribute(0, 2e3)
    assert t.devs["r"].params["r"] == 2e3
    version = t.c.nl.version
    t.devs["r"].set_attribute("r", 3e3)
    assert t.c.nl.version == version     # no structural bump
    assert t.c.nl.model_count() == j.c.nl.model_count()
    assert t.c.nl.node_count() == j.c.nl.node_count()


def test_warm_restart_from_node_voltages():
    """A second Circuit on the same netlist starts from the written-back
    voltages and branch currents, as the JAX package's prepare does."""
    j, t = both(CIRCUITS["transformer"])
    for b in (j, t):
        b.c.set_analyze_type(b.mod.AnalyzeType.OP)
        assert b.c.analyze()
    jc, tc = jpe.Circuit(j.c.nl), tpe.Circuit(t.c.nl, device="cpu")
    jc.prepare()
    tc.prepare()
    np.testing.assert_array_equal(tc._x.numpy(), np.asarray(jc._x))
    assert np.abs(tc._x.numpy()).max() > 0.0


def test_unported_routes_raise_naming_their_item():
    """The mesh routes that raised before ``parallel/`` was ported now run
    on a one-rank gloo mesh and agree with the local routes (name kept)."""
    assert mesh_routes_run("cpu") == 4
