"""Port parity of the noise analysis (``engine/noise.py``,
``Circuit.noise``): the circuits of ``tests/test_noise.py`` (its BSIM3
stages folded into one circuit: an NMOS stage and a PMOS_RC stage; every
BSIM3 family's hooks are held alone in ``test_torch_bsim3*.py``), built
in both
packages from one description and swept through both ``Circuit.noise``.

Held: the frequency grid bit for bit; ``onoise``, ``gain2`` and every
family's contribution within 1e-9 relative to the largest |value| of the
JAX package's array (PSDs of cut-off devices and of ideal-source-held
terminals are 0 in both).  Covered: resistor thermal, diode shot and
flicker, BJT (NPN and PNP) base and collector shot, square-law MOSFET
(NMOS and PMOS) channel and flicker, BSIM3 channel thermal and flicker,
the induced gate noise correlated with the channel source, and the
``_RC`` variants' series-resistor thermal sources.
"""

import numpy as np
import pytest
import torch

import torch_circuit_cases as cases
import torch_circuits

torch.set_num_threads(1)

TOL = 1e-9
TWO_PI = 2.0 * np.pi

_rng = np.random.default_rng(3)
MESH = ([("v", "VDC", {"V": 1.0}, ("n0", "0"))]
        + [(f"r{a}{b}", "RESISTANCE", {"r": float(_rng.uniform(100, 10e3))},
            (f"n{a}", f"n{b}"))
           for a, b in [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6),
                        (6, 0), (1, 4), (2, 5)]]
        + [("rg", "RESISTANCE", {"r": 3.3e3}, ("n3", "0")),
           ("cl", "CAPACITOR", {"C": 2e-9}, ("n5", "0"))])


# name: (description, output net, source device or None, AC settings)
CIRCUITS = {
    "divider_thermal": (
        [("v", "VDC", {"V": 1.0}, ("top", "0")),
         ("r1", "RESISTANCE", {"r": 4.7e3}, ("top", "mid")),
         ("r2", "RESISTANCE", {"r": 1.2e3}, ("mid", "0"))],
        "mid", "v", ("LOG", TWO_PI * 10, TWO_PI * 1e6, 7)),
    "rc_lowpass": (
        [("v", "VDC", {"V": 1.0}, ("top", "0")),
         ("r", "RESISTANCE", {"r": 1e3}, ("top", "out")),
         ("c", "CAPACITOR", {"C": 1e-9}, ("out", "0"))],
        "out", None, ("LOG", 1e3, 1e10, 201)),
    "diode_shot_flicker": (
        [("v", "VDC", {"V": 2.0}, ("top", "0")),
         ("r", "RESISTANCE", {"r": 2.2e3}, ("top", "out")),
         ("d", "PN_JUNCTION", {"kf": 1e-16, "af": 1.0}, ("out", "0"))],
        "out", "v", ("LOG", TWO_PI, TWO_PI * 1e6, 13)),
    "resistive_mesh": (MESH, "n4", None, ("SINGLE", TWO_PI * 50e3)),
    "bjt_npn": (
        [("vcc", "VDC", {"V": 5.0}, ("cc", "0")),
         ("vb", "VDC", {"V": 0.65}, ("b", "0")),
         ("rl", "RESISTANCE", {"r": 4.7e3}, ("cc", "c")),
         ("q", "BJT_NPN", {"kf": 1e-15}, ("b", "c", "0"))],
        "c", None, ("LOG", TWO_PI * 10, TWO_PI * 1e5, 5)),
    "bjt_pnp": (
        [("vcc", "VDC", {"V": 5.0}, ("cc", "0")),
         ("vb", "VDC", {"V": 4.35}, ("b", "0")),
         ("rb", "RESISTANCE", {"r": 1e3}, ("b", "bb")),
         ("rl", "RESISTANCE", {"r": 4.7e3}, ("c", "0")),
         ("q", "BJT_PNP", {}, ("bb", "c", "cc"))],
        "c", "vb", ("SINGLE", TWO_PI * 1e4)),
    "nmos_channel": (
        [("vdd", "VDC", {"V": 5.0}, ("vdd", "0")),
         ("vg", "VDC", {"V": 1.6}, ("g", "0")),
         ("rl", "RESISTANCE", {"r": 10e3}, ("vdd", "d")),
         ("m", "NMOSFET", {"Kp": 2e-3, "lambda": 0.05, "Vth": 1.0,
                           "kf": 1e-18}, ("d", "g", "0"))],
        "d", "vg", ("LOG", TWO_PI * 10, TWO_PI * 1e5, 5)),
    "pmos_channel": (
        [("vdd", "VDC", {"V": 5.0}, ("vdd", "0")),
         ("vg", "VDC", {"V": 3.4}, ("g", "0")),
         ("rl", "RESISTANCE", {"r": 10e3}, ("d", "0")),
         ("m", "PMOSFET", {"Kp": 2e-3, "lambda": 0.05, "Vth": 1.0},
          ("d", "g", "vdd"))],
        "d", "vg", ("SINGLE", TWO_PI * 1e4)),
    # tests/test_noise.py's BSIM3 stages (190-255, 452-545, 565-630): an
    # NMOS with flicker and a PMOS_RC, swept from 10 Hz (flicker) to 20 GHz,
    # where omega*Cgs ~ gm and the induced gate noise and its correlation
    # with the channel source matter
    "bsim3_stages": (torch_circuits.bsim3_stages(), "out", "vg",
                     ("LOG", TWO_PI * 10, TWO_PI * 2e10, 11)),
}


def _noise(pkg, name):
    spec, out, src, ac = CIRCUITS[name]
    b = cases.build(pkg, spec,
                    env=torch_circuits.TIGHT if "bsim3" in name else None)
    if ac[0] == "SINGLE":
        b.c.ac = b.mod.ACSettings(sweep=b.mod.ACSweepType.SINGLE, omega=ac[1])
    else:
        b.c.ac = b.mod.ACSettings(sweep=getattr(b.mod.ACSweepType, ac[0]),
                                  omega_start=ac[1], omega_stop=ac[2],
                                  points=ac[3])
    res = b.c.noise(b.nodes[out], src=b.devs[src] if src else None)
    assert res is not None, (pkg, name)
    return res


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_noise_matches_jax(name):
    j, t = _noise("jax", name), _noise("torch", name)
    np.testing.assert_array_equal(t.freqs, j.freqs)
    assert np.abs(j.onoise_psd).max() > 0.0
    cases.assert_close(t.onoise_psd, j.onoise_psd, TOL)
    cases.assert_close(t.gain2, j.gain2, TOL)
    cases.assert_close(t.inoise_psd, j.inoise_psd, TOL)
    assert sorted(t.contribs) == sorted(j.contribs)
    for key in j.contribs:
        cases.assert_close(t.contribs[key], j.contribs[key], TOL)
    assert np.isclose(t.onoise_total(), j.onoise_total(), rtol=TOL)


def test_noise_runs_where_the_circuit_lives():
    """The sweep's tensors stay on the Circuit's device (the CPU here; the
    card test holds the card), and a failed bias point gives None."""
    b = cases.build("torch", CIRCUITS["diode_shot_flicker"][0])
    assert b.c.device.type == "cpu"
    res = b.c.noise(b.nodes["out"], src=b.devs["v"])
    assert np.isfinite(res.onoise_psd).all() and res.onoise_psd[0] > 0.0
    b.c.gmin_steps = 0
    b.devs["d"].params["Is"] = float("nan")
    assert b.c.noise(b.nodes["out"]) is None
