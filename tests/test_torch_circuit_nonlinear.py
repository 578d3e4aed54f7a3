"""Port parity: the ``Circuit`` driver on the nonlinear circuits of
``tests/test_nonlinear.py`` (no BSIM3) and the gmin-stepping homotopy of
``tests/test_homotopy.py`` (the diode string's honest reject, the
floating capacitor node, easy circuits left alone) against the JAX
package's.

Tolerance met: the solution vector, node voltages, branch currents and
runtime states within 1e-9 relative to max|x| of the JAX result (states:
of the larger of max|x| and the variable's own largest magnitude);
``ok`` flags exactly, the gmin ladder's rejects included.
"""

import numpy as np
import pytest
import torch

from torch_circuit_cases import analyze_both, assert_same_solution, both
from torch_circuits import diode_load

torch.set_num_threads(1)


def _bjt_ce():
    return [("vcc", "VDC", {"V": 10.0}, ("vcc", "0")),
            ("vbb", "VDC", {"V": 2.0}, ("vbb", "0")),
            ("rb", "RESISTANCE", {"r": 100e3}, ("vbb", "b")),
            ("rc", "RESISTANCE", {"r": 1e3}, ("vcc", "c")),
            ("q", "BJT_NPN", {}, ("b", "c", "0"))]


def _mos(pmos):
    s = -1.0 if pmos else 1.0
    return [("vdd", "VDC", {"V": 10.0 * s}, ("vdd", "0")),
            ("vg", "VDC", {"V": 3.0 * s}, ("g", "0")),
            ("rd", "RESISTANCE", {"r": 1e3}, ("vdd", "d")),
            ("m", "PMOSFET" if pmos else "NMOSFET", {"Kp": 1e-3, "Vth": 1.0},
             ("d", "g", "0"))]


def _bjt_stiff(pnp):
    if pnp:
        return [("v", "VDC", {"V": 3.0}, ("top", "0")),
                ("r", "RESISTANCE", {"r": 47e3}, ("0", "b")),
                ("q", "BJT_PNP", {}, ("b", "0", "top"))]
    return [("v", "VDC", {"V": 3.0}, ("top", "0")),
            ("r", "RESISTANCE", {"r": 47e3}, ("top", "b")),
            ("q", "BJT_NPN", {}, ("b", "top", "0"))]


TIGHT = {"V_eps_max": 1e-12, "V_epsr_max": 1e-9}


def _gmin(steps):
    def setup(b):
        b.c.gmin_steps = steps
    return setup


# (spec, env)
CASES = {
    "pn_forward": (diode_load(5.0), None),
    "pn_reverse": (diode_load(-5.0), None),
    "pn_breakdown": (diode_load(-60.0), None),
    "pn_recombination": (diode_load(2.0, 1e3, Isr=1e-12, N=1.5,
                                    Temp=60.0), None),
    "bjt_common_emitter": (_bjt_ce(), None),
    "nmos_saturation": (_mos(False), None),
    "pmos_mirror": (_mos(True), None),
    "bjt_stiff_npn": (_bjt_stiff(False), TIGHT),
    "bjt_stiff_pnp": (_bjt_stiff(True), TIGHT),
}


@pytest.mark.parametrize("name", list(CASES))
def test_op_matches_jax(name):
    spec, env = CASES[name]
    j, t, ok = analyze_both(spec, "OP", env=env)
    assert ok
    assert_same_solution(j, t)


def test_nmos_saturation_closed_form():
    _j, t, ok = analyze_both(_mos(False), "OP")
    assert ok
    i_d = (10.0 - t.c.node_voltage(t.nodes["d"]).real) / 1e3
    assert np.isclose(i_d, 0.5e-3 * (3.0 - 1.0) ** 2, rtol=1e-9)


def test_relay_hysteresis_matches_jax():
    spec = [("vc", "VDC", {"V": 0.0}, ("coil", "0")),
            ("vs", "VDC", {"V": 8.0}, ("sup", "0")),
            ("rl", "RESISTANCE", {"r": 1e3}, ("out", "0")),
            ("rel", "RELAY", {"Von": 5.0, "Voff": 3.0},
             ("coil", "0", "sup", "out"))]
    j, t = both(spec)
    for v, engaged in ((0.0, False), (6.0, True), (4.0, True), (2.0, False)):
        for b in (j, t):
            b.devs["vc"].set_attribute("V", v)
            b.c.set_analyze_type(b.mod.AnalyzeType.DC)
            assert b.c.analyze()
        assert_same_solution(j, t)
        vout = t.c.node_voltage(t.nodes["out"]).real
        assert (abs(vout - 8.0) < 1e-5) if engaged else (vout < 1e-3)


def _string(n=20, v_src=100.0):
    spec = [("v", "VDC", {"V": v_src}, ("n0", "0"))]
    for k in range(n):
        spec.append((f"d{k}", "PN_JUNCTION", {"Is": 1e-14 * 10 ** (k % 3)},
                     (f"n{k}", "0" if k == n - 1 else f"n{k + 1}")))
    return spec


@pytest.mark.parametrize("gmin_steps", [0, 8])
def test_diode_string_honest_reject(gmin_steps):
    """Both packages fail the limexp-saturated string, with the ladder
    off (64-iteration Newton) and on (the row-wise residual check refuses
    the Δx-stationary point)."""
    _j, _t, ok = analyze_both(_string(), "OP", _gmin(gmin_steps))
    assert not ok


def _floating_cap():
    return [("v", "VDC", {"V": 2.0}, ("top", "0")),
            ("c1", "CAPACITOR", {"C": 1e-9}, ("top", "m")),
            ("c2", "CAPACITOR", {"C": 1e-9}, ("m", "0")),
            ("r", "RESISTANCE", {"r": 1e3}, ("top", "0"))]


def test_floating_cap_node_rescued_as_jax():
    _j, _t, ok = analyze_both(_floating_cap(), "OP", _gmin(0))
    assert not ok                     # singular at g_min = 0
    j, t, ok = analyze_both(_floating_cap(), "OP")
    assert ok
    assert_same_solution(j, t)
    assert abs(t.c.node_voltage(t.nodes["m"]).real) < 1e-9


def test_gmin_ladder_rescues_a_nonlinear_floating_node():
    """A diode load with a capacitor-coupled floating node: singular at
    g_min = 0, so the plain Newton fails; the ladder's Newton rungs walk
    the diode in, and both packages end at the same point."""
    spec = diode_load(3.0) + [("c1", "CAPACITOR", {"C": 1e-9}, ("d", "m")),
                              ("c2", "CAPACITOR", {"C": 2e-9}, ("m", "0"))]
    _j, _t, ok = analyze_both(spec, "DC", _gmin(0))
    assert not ok
    j, t, ok = analyze_both(spec, "DC")
    assert ok
    assert_same_solution(j, t)
    assert 0.5 < t.c.node_voltage(t.nodes["d"]).real < 0.8


def test_homotopy_leaves_easy_circuits_alone():
    j, t, ok = analyze_both(diode_load(2.0), "OP", _gmin(0))
    assert ok
    assert_same_solution(j, t)
    assert 0.5 < t.c.node_voltage(t.nodes["d"]).real < 0.8
