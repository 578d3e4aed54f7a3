"""Port parity of the sensitivity analysis (``engine/sens.py``,
``Circuit.sens`` / ``Circuit.sens_ac``): the circuits of
``tests/test_sens.py`` built in both packages from one description.

Held: every family's gradient array within 1e-8 relative to the JAX
package's largest |gradient| of that family (all-zero families exactly
zero), the AC magnitudes within 1e-9, and the report rows.  The port's
gradients come from ``torch.autograd`` through the assembly and the
adjoint f64 solve (``ops.linsolve.GaussSolve``), the JAX package's from
``jax.grad`` through its elimination: a parameter whose path to the
output is cut (turned into a host float on the way) would show here as
a zero gradient against a nonzero one.  BSIM3 runs in
``test_torch_sens_bsim3.py``.
"""

import numpy as np
import pytest
import torch

import torch_circuit_cases as cases
from torch_circuits import TIGHT

torch.set_num_threads(1)

TOL = 1e-8
TWO_PI = 2.0 * np.pi

DIVIDER = [("v", "VDC", {"V": 2.5}, ("top", "0")),
           ("ra", "RESISTANCE", {"r": 4.7e3}, ("top", "out")),
           ("rb", "RESISTANCE", {"r": 1.2e3}, ("out", "0"))]
DIODE = [("v", "VDC", {"V": 2.0}, ("top", "0")),
         ("ra", "RESISTANCE", {"r": 1e3}, ("top", "out")),
         ("d", "PN_JUNCTION", {}, ("out", "0"))]
RC = [("v", "VAC", {"Vp": 1.0, "phase": 0.0}, ("top", "0")),
      ("ra", "RESISTANCE", {"r": 1e3}, ("top", "out")),
      ("cl", "CAPACITOR", {"C": 1e-9}, ("out", "0"))]
MOS_AMP = [("vdd", "VDC", {"V": 5.0}, ("vdd", "0")),
           ("vsig", "VAC", {"Vp": 1.0, "phase": 0.0}, ("mid", "0")),
           ("vg", "VDC", {"V": 1.6}, ("g", "mid")),
           ("rl", "RESISTANCE", {"r": 10e3}, ("vdd", "d")),
           ("m", "NMOSFET", {}, ("d", "g", "0"))]
BJT_AMP = [("vcc", "VDC", {"V": 5.0}, ("cc", "0")),
           ("vsig", "VAC", {"Vp": 1e-3}, ("s", "0")),
           ("vb", "VDC", {"V": 0.65}, ("b", "s")),
           ("rl", "RESISTANCE", {"r": 4.7e3}, ("cc", "c")),
           ("cc1", "CAPACITOR", {"C": 1e-12}, ("c", "0")),
           ("q", "BJT_NPN", {}, ("b", "c", "0"))]

# name: (description, output (net or device), analysis, env, AC settings)
CASES = {
    "divider_node": (DIVIDER, "out", "sens", None, None),
    "divider_branch_current": (DIVIDER, "v", "sens", None, None),
    "diode_chain": (DIODE, "out", "sens", TIGHT, None),
    "rc_lowpass_ac": (RC, "out", "sens_ac", None,
                      ("LOG", 1e6 / 100, 1e6 * 100, 9)),
    "mos_amp_ac": (MOS_AMP, "d", "sens_ac", TIGHT, ("SINGLE", TWO_PI * 1e3)),
    "mos_amp_dc": (MOS_AMP, "d", "sens", TIGHT, None),
    "bjt_amp_ac": (BJT_AMP, "c", "sens_ac", TIGHT,
                   ("LOG", TWO_PI * 1e3, TWO_PI * 1e10, 5)),
}


def run(pkg, spec, out, what, env=None, ac=None):
    """``what`` ("sens" or "sens_ac") of output ``out`` in package
    ``pkg``: (SensResult, AC magnitudes or None, the build)."""
    b = cases.build(pkg, spec, env=env)
    if ac is not None:
        sweep = getattr(b.mod.ACSweepType, ac[0])
        b.c.ac = (b.mod.ACSettings(sweep=sweep, omega=ac[1])
                  if ac[0] == "SINGLE" else
                  b.mod.ACSettings(sweep=sweep, omega_start=ac[1],
                                   omega_stop=ac[2], points=ac[3]))
    target = b.nodes[out] if out in b.nodes else b.devs[out]
    res = getattr(b.c, what)(target)
    assert res is not None, (pkg, what)
    if what == "sens":
        return res, None, b
    freqs, mag, rep = res
    return rep, (freqs, mag), b


def assert_same_sens(j, t):
    """Every family's gradients (see the module docstring) and rows."""
    (jr, jm, jb), (tr, tm, tb) = j, t
    assert sorted(tr.grads) == sorted(jr.grads)
    for key, ref in jr.grads.items():
        got = tr.grads[key]
        assert got.shape == ref.shape, key
        scale = np.abs(ref).max()
        if scale == 0.0:
            assert np.abs(got).max() == 0.0, key
            continue
        err = np.abs(got - ref).max() / scale
        assert err <= TOL, (key, err)
    if jm is not None:
        np.testing.assert_array_equal(tm[0], jm[0])
        cases.assert_close(tm[1], jm[1], 1e-9)
    for name in jb.devs:
        jd, td = jb.devs[name], tb.devs[name]
        for p in jd.mdef.param_order:
            cases.assert_close(np.asarray(tr.get(td, p)),
                               np.asarray(jr.get(jd, p)), TOL,
                               np.abs(jr.grads[jd.mdef.id_name]).max()
                               or 1.0)


@pytest.mark.parametrize("name", list(CASES))
def test_sens_matches_jax(name):
    spec, out, what, env, ac = CASES[name]
    j = run("jax", spec, out, what, env, ac)
    t = run("torch", spec, out, what, env, ac)
    assert any(np.abs(g).max() > 0.0 for g in j[0].grads.values())
    assert_same_sens(j, t)


def test_sens_gradient_flows_to_every_resistor():
    """Closed form on the divider (tests/test_sens.py:38-56): dV/dR1,
    dV/dR2, dV/dE; the rows' normalized column is p · dV/dp."""
    r1, r2, e = 4.7e3, 1.2e3, 2.5
    res, _m, b = run("torch", DIVIDER, "out", "sens")
    assert np.isclose(res.get(b.devs["ra"], "r"), -e * r2 / (r1 + r2) ** 2,
                      rtol=1e-12)
    assert np.isclose(res.get(b.devs["rb"], "r"), e * r1 / (r1 + r2) ** 2,
                      rtol=1e-12)
    assert np.isclose(res.get(b.devs["v"], "V"), r2 / (r1 + r2), rtol=1e-12)
    rows = {p: nrm for _n, p, _v, nrm in res.rows() if p == "V"}
    assert np.isclose(rows["V"], e * r2 / (r1 + r2), rtol=1e-12)


def test_gauss_solve_gradient_is_the_adjoint():
    """GaussSolve's backward pass against torch.linalg.solve's on random
    f64 systems, batched and single."""
    from phy_engine_tpu_torch.ops.linsolve import dense_solve
    gen = torch.Generator().manual_seed(0)
    for shape in ((5, 5), (3, 6, 6)):
        A = torch.randn(shape, generator=gen, dtype=torch.float64) \
            + 4.0 * torch.eye(shape[-1], dtype=torch.float64)
        b = torch.randn(shape[:-1], generator=gen, dtype=torch.float64)
        g = torch.randn(shape[:-1], generator=gen, dtype=torch.float64)
        grads = []
        for solve in (dense_solve, torch.linalg.solve):
            A_, b_ = A.clone().requires_grad_(), b.clone().requires_grad_()
            (solve(A_, b_) * g).sum().backward()
            grads.append((A_.grad, b_.grad))
        for a, c in zip(*grads):
            assert torch.allclose(a, c, rtol=1e-12, atol=1e-14)
