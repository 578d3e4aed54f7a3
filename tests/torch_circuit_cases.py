"""Shared helpers of the ``test_torch_circuit_*`` parity tests: one
circuit description (``torch_circuits``) built in both packages, and the
comparisons.  ``build(pkg, spec)`` places the devices into a fresh
``Circuit`` of ``pkg`` (the JAX package or the port, on the CPU) in the
same order, so both lower to the same unknown vector.
"""

import numpy as np

import phy_engine_tpu as jpe
import phy_engine_tpu_torch as tpe
from phy_engine_tpu.engine import circuit as jcircuit
from phy_engine_tpu_torch.engine import circuit as tcircuit

import torch_circuits

# relative to max|x| of the reference: both packages solve the same f64
# systems with the same algorithm, in another summation order
TOL = 1e-9

PACKAGES = {"jax": (jpe, jcircuit), "torch": (tpe, tcircuit)}


def build(pkg: str, spec, env=None, **kw):
    """The circuit of ``spec`` in package ``pkg`` ("jax" or "torch", the
    port on the CPU); see ``torch_circuits.build``."""
    if pkg == "torch":
        kw.setdefault("device", "cpu")
    return torch_circuits.build(*PACKAGES[pkg], spec, env, **kw)


def both(spec, setup=None, env=None, **kw):
    """(jax, torch) builds of ``spec``; ``setup(b)`` then runs on each."""
    out = []
    for pkg in ("jax", "torch"):
        b = build(pkg, spec, env, **kw)
        if setup is not None:
            setup(b)
        out.append(b)
    return out


def analyze_both(spec, at: str, setup=None, env=None, **kw):
    """Build both, set the analysis type named ``at`` and run it; the
    ``ok`` flags must agree exactly.  Returns (j, t, ok)."""
    j, t = both(spec, setup, env, **kw)
    oks = []
    for b in (j, t):
        b.c.set_analyze_type(getattr(b.mod.AnalyzeType, at))
        oks.append(bool(b.c.analyze()))
    assert oks[0] == oks[1], oks
    return j, t, oks[0]


def x_of(b):
    x = b.c._x
    return np.asarray(x if not hasattr(x, "cpu") else x.cpu().numpy())


def rel_err(a, b, scale=None):
    """max|a - b| / ``scale`` (default max|b|; an all-zero reference
    leaves the absolute difference); non-finite entries must coincide."""
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    if not fin.any():
        return 0.0
    if scale is None:
        scale = np.abs(b[fin]).max()
    diff = np.abs(a[fin] - b[fin]).max()
    return float(diff / scale) if scale > 0 else float(diff)


def assert_close(a, b, tol=TOL, scale=None):
    err = rel_err(a, b, scale)
    assert err <= tol, err
    return err


def assert_same_solution(j, t, tol=TOL, scale=0.0):
    """The stored solution vector, every net's voltage and every branch
    current agree to ``tol`` of max|x| (or of ``scale`` where larger: a
    transient's max|trace|); each device family's runtime states to
    ``tol`` of the larger of that and the variable's own largest
    magnitude over the family."""
    xj = x_of(j)
    xs = max(float(np.abs(xj).max()) if xj.size else 0.0, scale)
    assert_close(x_of(t), xj, tol, xs)
    names = [n for n in j.nodes if n != "0"]
    assert_close([t.c.node_voltage(t.nodes[n]) for n in names],
                 [j.c.node_voltage(j.nodes[n]) for n in names], tol, xs)
    assert_close([br.current for d in t.devs.values() for br in d.branches],
                 [br.current for d in j.devs.values() for br in d.branches],
                 tol, xs)
    by_var = {}
    for name, jd in j.devs.items():
        td = t.devs[name]
        assert sorted(td.runtime) == sorted(jd.runtime), name
        for k in jd.runtime:
            by_var.setdefault((jd.mdef.id_name, k), []).append(
                (td.runtime[k], jd.runtime[k]))
    for key, pairs in by_var.items():
        a, b = np.array(pairs).T
        assert_close(a, b, tol, max(xs, float(np.abs(b).max())))


def assert_same_tr(j, t, tol=TOL):
    """tr_history and tr_times row for row, and the final solution (to
    ``tol`` of max|trace|)."""
    assert j.c.tr_history.shape == t.c.tr_history.shape
    assert_close(t.c.tr_history, j.c.tr_history, tol)
    np.testing.assert_array_equal(t.c.tr_times, j.c.tr_times)
    assert t.c.tr_duration == j.c.tr_duration
    assert_same_solution(j, t, tol, float(np.abs(j.c.tr_history).max()))
