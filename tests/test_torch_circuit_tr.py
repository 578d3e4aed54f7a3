"""Port parity: the ``Circuit`` driver's transient analyses (TR, TROP,
adaptive TR, the persistent clock) and ``.FOUR`` against the JAX
package's, on every circuit of ``tests/test_tr.py`` and
``tests/test_four.py``, the rectifiers of ``tests/test_nonlinear.py``,
and one transient per family with time dependence the TR tests do not
reach (every waveform source, IAC, the coupled inductors).

Tolerance met: ``tr_history`` and the final solution, node voltages,
branch currents and runtime states within 1e-9 relative to max|x| of the
JAX result, ``tr_times`` and ``tr_duration`` exactly (the same host
arithmetic), ``ok`` flags exactly; ``FourierResult`` amplitudes within
1e-9 relative to their largest.
"""

import numpy as np
import pytest
import torch

from torch_circuit_cases import (analyze_both, assert_close, assert_same_tr,
                                 both)

torch.set_num_threads(1)


def _rc(v=5.0, r=1e3, c=1e-6):
    return [("v", "VDC", {"V": v}, ("in", "0")),
            ("r", "RESISTANCE", {"r": r}, ("in", "out")),
            ("cap", "CAPACITOR", {"C": c}, ("out", "0"))]


def _rl():
    return [("v", "VDC", {"V": 2.0}, ("in", "0")),
            ("r", "RESISTANCE", {"r": 10.0}, ("in", "mid")),
            ("l", "INDUCTOR", {"L": 1e-3}, ("mid", "0"))]


def _rectifier(r=10e3):
    return [("v", "VAC", {"Vp": 5.0, "freq": 1e3}, ("in", "0")),
            ("d", "PN_JUNCTION", {}, ("in", "out")),
            ("r", "RESISTANCE", {"r": r}, ("out", "0")),
            ("cap", "CAPACITOR", {"C": 1e-6}, ("out", "0"))]


def _bridge():
    return [("v", "VAC", {"Vp": 5.0, "freq": 1e3}, ("a", "b")),
            ("fbr", "FULL_BRIDGE_RECTIFIER", {}, ("a", "b", "p", "0")),
            ("rl", "RESISTANCE", {"r": 10e3}, ("p", "0"))]


def _waveforms():
    """Every waveform source in series, IAC into the load, and a coupled
    inductor pair feeding a second load."""
    return [("saw", "SAWTOOTH", {"Vh": 3.0, "Vl": -1.0, "freq": 2e3,
                                 "phase": 1.0}, ("a", "0")),
            ("sq", "SQUARE", {"Vh": 2.0, "Vl": 0.5, "freq": 3e3,
                              "duty": 0.3}, ("b", "a")),
            ("pu", "PULSE", {"Vh": 4.0, "Vl": 1.0, "freq": 1.5e3,
                             "tr": 1e-4, "tf": 5e-5, "duty": 0.6},
             ("c", "b")),
            ("tri", "TRIANGLE", {"Vh": 1.0, "Vl": -2.0, "freq": 2.5e3},
             ("d", "c")),
            ("r", "RESISTANCE", {"r": 1e3}, ("d", "0")),
            ("iac", "IAC", {"Ip": 1e-3, "freq": 4e3, "phase": 30.0},
             ("d", "0")),
            ("kl", "COUPLED_INDUCTORS", {"L1": 1e-3, "L2": 4e-3, "k": 0.9},
             ("d", "e", "s", "0")),
            ("r2", "RESISTANCE", {"r": 100.0}, ("e", "0")),
            ("r3", "RESISTANCE", {"r": 50.0}, ("s", "0"))]


def _tr(t_step, t_stop, adaptive=False):
    def setup(b):
        b.c.tr.t_step = t_step
        b.c.tr.t_stop = t_stop
        b.c.tr.adaptive = adaptive
    return setup


# (spec, analysis, t_step, t_stop, adaptive)
CASES = {
    "rc_step": (_rc(), "TR", 1e-3 / 200, 5e-3, False),
    "rl_step": (_rl(), "TR", 1e-4 / 200, 5e-4, False),
    "trop_cap_open": (_rc(3.0), "TROP", 1e-5, 1e-4, False),
    "adaptive_rc": (_rc(1.0), "TR", 1e-3 / 50, 1e-3, True),
    "adaptive_diode": (_rectifier(1e3), "TR", 5e-5, 1e-3, True),
    "rectifier": (_rectifier(), "TR", 1e-3 / 200, 3e-3, False),
    "full_bridge": (_bridge(), "TR", 1e-3 / 200, 2e-3, False),
    "waveforms": (_waveforms(), "TR", 2e-6, 1e-3, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_transient_matches_jax(name):
    spec, at, t_step, t_stop, adaptive = CASES[name]
    j, t, ok = analyze_both(spec, at, _tr(t_step, t_stop, adaptive))
    assert ok
    assert_same_tr(j, t)


def test_tr_duration_persists():
    spec = [("v", "SQUARE", {"Vh": 1.0, "Vl": 0.0, "freq": 1e3}, ("n1", "0")),
            ("r", "RESISTANCE", {"r": 1e3}, ("n1", "0"))]
    j, t = both(spec, _tr(1e-5, 4e-4))
    for high in (True, False):       # 0.4 ms of a 1 ms period, twice
        for b in (j, t):
            b.c.set_analyze_type(b.mod.AnalyzeType.TR)
            assert b.c.analyze()
        assert_same_tr(j, t)
        assert np.isclose(t.c.node_voltage(t.nodes["n1"]).real,
                          1.0 if high else 0.0)
    assert np.isclose(t.c.tr_duration, 8e-4)


def _inverter_chain(n, C):
    """CMOS inverters (square-law MOSFETs, no limiting) after a fast
    PULSE edge, a capacitor on every output: Newton fails at large steps
    and converges at smaller ones."""
    spec = [("vdd", "VDC", {"V": 5.0}, ("vdd", "0")),
            ("v", "PULSE", {"Vh": 5.0, "Vl": 0.0, "freq": 500.0,
                            "duty": 0.5, "tr": 1e-7, "tf": 1e-7,
                            "phase": 0.5}, ("x0", "0"))]
    mos = {"Kp": 1e-3, "Vth": 1.0, "lambda": 0.02}
    for k in range(n):
        spec += [(f"mn{k}", "NMOSFET", mos, (f"x{k + 1}", f"x{k}", "0")),
                 (f"mp{k}", "PMOSFET", mos, (f"x{k + 1}", f"x{k}", "vdd")),
                 (f"c{k}", "CAPACITOR", {"C": C}, (f"x{k + 1}", "0"))]
    return spec


def test_adaptive_step_halving_matches_jax():
    """Rejected attempts halve dt and accepted ones grow it back: the
    accepted rows (times and waveforms) match the JAX package's row for
    row."""
    j, t, ok = analyze_both(_inverter_chain(3, 1e-6), "TR",
                            _tr(2e-4, 2e-3, True))
    assert ok
    assert_same_tr(j, t)
    steps = np.unique(np.round(np.diff(t.c.tr_times), 12))
    assert steps.min() < 2e-4 and len(t.c.tr_times) > 10


def test_adaptive_underflow_fails_as_jax():
    """Below dt_min the adaptive transient fails in both packages."""
    _j, _t, ok = analyze_both(_inverter_chain(5, 1e-9), "TR",
                              _tr(2e-4, 2e-3, True))
    assert not ok


def _two_tone(a1, a3, f0=1e3):
    return [("v1", "VAC", {"Vp": a1, "freq": f0, "phase": 0.0},
             ("top", "mid")),
            ("v3", "VAC", {"Vp": a3, "freq": 3 * f0, "phase": 0.0},
             ("mid", "0")),
            ("ra", "RESISTANCE", {"r": 1e3}, ("top", "out")),
            ("rb", "RESISTANCE", {"r": 1e3}, ("out", "0"))]


@pytest.mark.parametrize("a1,a3,periods,harmonics", [(2.0, 0.5, 4.0, 9),
                                                      (1.0, 0.0, 3.0, 5)])
def test_four_matches_jax(a1, a3, periods, harmonics):
    f0 = 1e3
    j, t, ok = analyze_both(_two_tone(a1, a3), "TR",
                            _tr(1.0 / (f0 * 512), periods / f0))
    assert ok
    assert_same_tr(j, t)
    jr = j.c.four(f0, j.nodes["out"], harmonics=harmonics)
    tr = t.c.four(f0, t.nodes["out"], harmonics=harmonics)
    assert_close(tr.amps, jr.amps)
    assert tr.fundamental == jr.fundamental
    assert abs(tr.thd - jr.thd) <= 1e-9 * max(jr.thd, 1e-3)
    assert np.isclose(tr.amps[1], a1 / 2, rtol=1e-3)
    # the source branch current: FOUR of a branch device
    jb = j.c.four(f0, j.devs["v1"], harmonics=harmonics)
    tb = t.c.four(f0, t.devs["v1"], harmonics=harmonics)
    assert_close(tb.amps, jb.amps)
