"""Port parity: the ``Circuit`` driver's AC / ACOP analyses, ``.TF`` and
``.PZ`` against the JAX package's, on every circuit of
``tests/test_ac.py``, the diode small-signal case of
``tests/test_nonlinear.py``, and circuits that put every family's AC
stamp into a sweep (controlled sources, op-amp, both transformers, the
inductors, the sources, switch and relay, BJT, MOSFET and the
full-bridge rectifier at their bias points).

Tolerance met: ``ac_sweep_results`` (the ω grid exactly, the complex
solutions within 1e-9 relative to max|x| over the grid), the written-back
phasors likewise, ``tf``'s gain and resistances within 1e-9 relative,
``pz``'s poles and zeros within 1e-9 relative to the largest (both
packages hand the same G and C to scipy); ``ok`` flags exactly.
"""

import numpy as np
import pytest
import torch

from torch_circuit_cases import (analyze_both, assert_close,
                                 assert_same_solution, both)

torch.set_num_threads(1)


def _rc_lowpass():
    return [("v", "VAC", {"Vp": 1.0}, ("in", "0")),
            ("r", "RESISTANCE", {"r": 1e3}, ("in", "out")),
            ("cap", "CAPACITOR", {"C": 1e-6}, ("out", "0"))]


def _rlc():
    return [("v", "VAC", {"Vp": 1.0}, ("n1", "0")),
            ("r", "RESISTANCE", {"r": 10.0}, ("n1", "n2")),
            ("l", "INDUCTOR", {"L": 1e-3}, ("n2", "n3")),
            ("cap", "CAPACITOR", {"C": 1e-6}, ("n3", "0"))]


def _coupled():
    return [("v", "VAC", {"Vp": 1.0}, ("p", "0")),
            ("kl", "COUPLED_INDUCTORS", {"L1": 1.0, "L2": 0.25,
                                         "k": 0.99999}, ("p", "0", "s", "0")),
            ("rl", "RESISTANCE", {"r": 50.0}, ("s", "0"))]


def _diode_ac():
    """VDC bias, a series VAC excitation, R and a diode to ground."""
    return [("vdc", "VDC", {"V": 5.0}, ("mid", "0")),
            ("vac", "VAC", {"Vp": 1.0}, ("in", "mid")),
            ("r", "RESISTANCE", {"r": 1e3}, ("in", "d")),
            ("d", "PN_JUNCTION", {"tt": 1e-9}, ("d", "0"))]


def _linear_zoo():
    """Every linear family's AC stamp in one network."""
    return [("v", "VAC", {"Vp": 1.0, "phase": 20.0}, ("in", "0")),
            ("ia", "IAC", {"Ip": 1e-3, "phase": -40.0}, ("0", "in")),
            ("idc", "IDC", {"I": 1e-3}, ("0", "in")),
            ("r0", "RESISTANCE", {"r": 200.0}, ("in", "a")),
            ("c0", "CAPACITOR", {"C": 1e-7}, ("a", "0")),
            ("e", "VCVS", {"mu": 2.0}, ("b", "0", "a", "0")),
            ("rb", "RESISTANCE", {"r": 1e3}, ("b", "bb")),
            ("l0", "INDUCTOR", {"L": 1e-3}, ("bb", "0")),
            ("g", "VCCS", {"g": 1e-3}, ("c", "0", "b", "0")),
            ("rc", "RESISTANCE", {"r": 2e3}, ("c", "0")),
            ("h", "CCVS", {"r": 50.0}, ("d", "0", "c", "cc")),
            ("rcc", "RESISTANCE", {"r": 300.0}, ("cc", "0")),
            ("rd", "RESISTANCE", {"r": 500.0}, ("d", "0")),
            ("f", "CCCS", {"alpha": 0.5}, ("e1", "0", "d", "dd")),
            ("rdd", "RESISTANCE", {"r": 100.0}, ("dd", "0")),
            ("re", "RESISTANCE", {"r": 1e3}, ("e1", "0")),
            ("oa", "OP_AMP", {"mu": 1e5}, ("e1", "o", "o", "0")),
            ("tx", "TRANSFORMER", {"n": 2.0}, ("o", "0", "s", "0")),
            ("rs", "RESISTANCE", {"r": 100.0}, ("s", "0")),
            ("txct", "TRANSFORMER_CENTER_TAP", {"n_half": 3.0},
             ("o", "0", "s1", "0", "s2")),
            ("rs1", "RESISTANCE", {"r": 60.0}, ("s1", "0")),
            ("rs2", "RESISTANCE", {"r": 90.0}, ("s2", "0")),
            ("rk1", "RESISTANCE", {"r": 20.0}, ("s", "k1")),
            ("kl", "COUPLED_INDUCTORS", {"L1": 1e-3, "L2": 2e-3, "k": 0.8},
             ("k1", "0", "k2", "0")),
            ("rk", "RESISTANCE", {"r": 30.0}, ("k2", "0"))]


def _sources_switches():
    return [("saw", "SAWTOOTH", {}, ("a", "0")),
            ("sq", "SQUARE", {}, ("b", "a")),
            ("pu", "PULSE", {}, ("c", "b")),
            ("tri", "TRIANGLE", {}, ("d", "c")),
            ("v", "VAC", {"Vp": 1.0}, ("e", "d")),
            ("sw", "SWITCH", {"cut_through": 1.0}, ("e", "f")),
            ("r", "RESISTANCE", {"r": 1e3}, ("f", "0")),
            ("vc", "VDC", {"V": 6.0}, ("coil", "0")),
            ("rel", "RELAY", {}, ("coil", "0", "f", "g")),
            ("rg", "RESISTANCE", {"r": 2e3}, ("g", "0")),
            ("sw2", "SWITCH", {}, ("g", "0"))]


def _active():
    """BJT, MOSFET and bridge at their bias points, AC-coupled input."""
    return [("vcc", "VDC", {"V": 10.0}, ("vcc", "0")),
            ("vb", "VDC", {"V": 2.0}, ("vbb", "0")),
            ("vac", "VAC", {"Vp": 0.01}, ("vin", "vbb")),
            ("rb", "RESISTANCE", {"r": 100e3}, ("vin", "b")),
            ("rc", "RESISTANCE", {"r": 1e3}, ("vcc", "c")),
            ("q", "BJT_NPN", {}, ("b", "c", "0")),
            ("rp", "RESISTANCE", {"r": 47e3}, ("0", "bp")),
            ("qp", "BJT_PNP", {}, ("bp", "0", "vcc")),
            ("vg", "VDC", {"V": 3.0}, ("g", "0")),
            ("cg", "CAPACITOR", {"C": 1e-9}, ("c", "g2")),
            ("rg", "RESISTANCE", {"r": 1e6}, ("g", "g2")),
            ("rd", "RESISTANCE", {"r": 1e3}, ("vcc", "dn")),
            ("mn", "NMOSFET", {"lambda": 0.01}, ("dn", "g2", "0")),
            ("rdp", "RESISTANCE", {"r": 1e3}, ("dp", "0")),
            ("mp", "PMOSFET", {"Kp": 1e-5, "lambda": 0.01},
             ("dp", "0", "vcc")),
            ("fbr", "FULL_BRIDGE_RECTIFIER", {}, ("c", "dn", "p", "0")),
            ("rl", "RESISTANCE", {"r": 10e3}, ("p", "0"))]


def _ac(sweep, omega=1.0, start=1.0, stop=1e6, points=10):
    def setup(b):
        b.c.ac.sweep = getattr(b.mod.ACSweepType, sweep)
        b.c.ac.omega = omega
        b.c.ac.omega_start = start
        b.c.ac.omega_stop = stop
        b.c.ac.points = points
    return setup


# (spec, analysis, sweep setup)
CASES = {
    "rc_single": (_rc_lowpass(), "AC", _ac("SINGLE", 1e3)),
    "rc_log": (_rc_lowpass(), "AC", _ac("LOG", points=40)),
    "rlc_resonance": (_rlc(), "AC", _ac("SINGLE", 1.0 / np.sqrt(1e-9))),
    "coupled": (_coupled(), "AC", _ac("SINGLE", 1e6)),
    "diode_small_signal": (_diode_ac(), "AC", _ac("SINGLE", 100.0)),
    "diode_acop_sweep": (_diode_ac(), "ACOP",
                         _ac("LOG", start=1e3, stop=1e10, points=15)),
    "linear_zoo": (_linear_zoo(), "ACOP",
                   _ac("LINEAR", start=1e2, stop=1e5, points=12)),
    "sources_switches": (_sources_switches(), "ACOP",
                         _ac("LOG", start=10.0, stop=1e4, points=5)),
    "active_devices": (_active(), "ACOP",
                       _ac("LOG", start=1e2, stop=1e8, points=9)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_ac_matches_jax(name):
    spec, at, setup = CASES[name]
    j, t, ok = analyze_both(spec, at, setup)
    assert ok
    wj = [w for w, _ in j.c.ac_sweep_results]
    wt = [w for w, _ in t.c.ac_sweep_results]
    assert wt == wj
    xj = np.stack([x for _, x in j.c.ac_sweep_results])
    xt = np.stack([x for _, x in t.c.ac_sweep_results])
    assert_close(xt, xj)
    scale = float(np.abs(xj).max())
    names = [n for n in j.nodes if n != "0"]
    assert_close([t.c.node_voltage(t.nodes[n]) for n in names],
                 [j.c.node_voltage(j.nodes[n]) for n in names],
                 scale=scale)
    for name_, jd in j.devs.items():
        assert_close([br.current for br in t.devs[name_].branches],
                     [br.current for br in jd.branches], scale=scale)


def test_rc_corner_closed_form():
    _j, t, ok = analyze_both(_rc_lowpass(), "AC", _ac("SINGLE", 1e3))
    assert ok
    h = t.c.node_voltage(t.nodes["out"])
    assert np.isclose(abs(h), 1.0 / np.sqrt(2.0), rtol=1e-9)
    assert np.isclose(np.angle(h), -np.pi / 4.0, rtol=1e-9)


def test_diode_small_signal_uses_the_bias_point():
    """AC after the bias point: the port's diode reads its saved geq."""
    j, t, ok = analyze_both(_diode_ac(), "AC", _ac("SINGLE", 100.0))
    assert ok
    geq = t.devs["d"].runtime["geq"]
    assert geq > 0.0 and geq == pytest.approx(j.devs["d"].runtime["geq"],
                                              rel=1e-9)


def _amp():
    return [("v", "VDC", {"V": 1.0}, ("in", "0")),
            ("r1", "RESISTANCE", {"r": 1e3}, ("in", "m")),
            ("e", "VCVS", {"mu": -5.0}, ("out", "0", "m", "0")),
            ("r2", "RESISTANCE", {"r": 2e3}, ("m", "0")),
            ("rl", "RESISTANCE", {"r": 500.0}, ("out", "0")),
            ("cap", "CAPACITOR", {"C": 1e-6}, ("out", "0"))]


@pytest.mark.parametrize("spec,out,src", [(_amp(), "out", "v"),
                                          (_rlc()[1:] + [
                                              ("vs", "VDC", {"V": 0.0},
                                               ("n1", "0"))], "n3", "vs"),
                                          ([("v", "VDC", {"V": 5.0},
                                             ("in", "0"))]
                                           + _diode_ac()[2:], "d", "v")])
def test_tf_and_pz_match_jax(spec, out, src):
    j, t = both(spec)
    jtf = j.c.tf(j.nodes[out], j.devs[src])
    ttf = t.c.tf(t.nodes[out], t.devs[src])
    assert_close(ttf, jtf)
    assert_same_solution(j, t)
    jp, jz = j.c.pz(j.nodes[out], j.devs[src])
    tp, tz = t.c.pz(t.nodes[out], t.devs[src])
    for a, b in ((tp, jp), (tz, jz)):
        assert a.shape == b.shape
        order = np.lexsort((b.imag, b.real))
        assert_close(np.sort_complex(a), b[order])
