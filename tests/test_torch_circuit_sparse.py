"""Port parity of the ``Circuit`` driver's sparse route (COO assembly and
the f64 Jacobi BiCGStab, no dense matrix) against the JAX package's
sparse and dense routes and scipy, on the CPU: the random meshes of
``tests/test_sparse.py``, the diode mesh, TR and adaptive TR, and the
gmin ladder with its row-wise residual check computed from the COO
values.

Tolerance: 1e-6 of max(1, max|v|) for node voltages (1e-6 of max|trace|
for transients), as ``tests/test_sparse.py``: BiCGStab stops at a 1e-10
relative residual, so two implementations (or BiCGStab against a direct
solve) agree to the system's condition times that, not to rounding.
"""

import numpy as np
import pytest
import torch

import phy_engine_tpu as jpe
import phy_engine_tpu_torch as tpe
from phy_engine_tpu_torch import workloads
from phy_engine_tpu_torch.engine import analog
from phy_engine_tpu_torch.models.base import StampCtx
from phy_engine_tpu_torch.ops import linsolve

from test_sparse import random_mesh_circuit
from torch_circuit_cases import analyze_both, assert_close, build, x_of
from torch_circuits import diode_load, mesh_mna

torch.set_num_threads(1)

TOL = 1e-6


def _port_mesh(n_nodes=400, n_links=1600, seed=3, solver="auto",
               threshold=2048):
    nl, nodes = workloads.random_mesh_netlist(n_nodes, n_links, seed)
    c = tpe.Circuit(nl, solver=solver, sparse_threshold=threshold,
                    device="cpu")
    c.set_analyze_type(tpe.AnalyzeType.DC)
    return c, nodes


def _volts(c, nodes):
    return np.array([c.node_voltage(n).real for n in nodes])


def _no_dense(monkeypatch):
    """Make any dense assembly or dense solve on the route fail."""
    def refuse(*_a, **_k):
        raise AssertionError("the sparse route built a dense system")
    monkeypatch.setattr(analog, "assemble", refuse)
    monkeypatch.setattr(linsolve, "lu_solve_gauss", refuse)
    monkeypatch.setattr(analog, "dense_solve", refuse)


def _close(got, ref):
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= TOL, err
    return err


def test_sparse_route_matches_jax_sparse_and_dense(monkeypatch):
    """random_mesh(400, 1600): the port's sparse route against the JAX
    package's sparse and dense routes (the reference's CPU-vs-GPU
    cross-check, 0013.cuda/cuda_random_links_correctness)."""
    results = {}
    for solver in ("sparse", "dense"):
        cj, nj = random_mesh_circuit(solver=solver)
        assert cj.analyze()
        results[solver] = np.array([cj.node_voltage(n).real for n in nj])
    ct, nt = _port_mesh(solver="sparse")
    _no_dense(monkeypatch)
    assert ct.analyze()
    assert ct._method() == "sparse"
    v = _volts(ct, nt)
    _close(v, results["sparse"])
    _close(v, results["dense"])


def _add_diode(pe, nl, node):
    d = pe.netops.add_model(nl, pe.models.PN_JUNCTION, {})
    pe.netops.add_to_node(nl, d, 0, node)
    pe.netops.add_to_node(nl, d, 1, nl.ground_node)


def test_diode_mesh_newton_on_the_sparse_route(monkeypatch):
    cj, nj = random_mesh_circuit(n_nodes=200, n_links=800, seed=5,
                                 solver="sparse")
    _add_diode(jpe, cj.nl, nj[1])
    assert cj.analyze()
    ct, nt = _port_mesh(200, 800, 5, solver="sparse")
    _add_diode(tpe, ct.nl, nt[1])
    _no_dense(monkeypatch)
    assert ct.analyze()
    vd = ct.node_voltage(nt[1]).real
    assert 0.0 < vd < 1.0
    _close(_volts(ct, nt), np.array([cj.node_voltage(n).real for n in nj]))


def test_auto_picks_sparse_at_the_threshold():
    ct, _ = _port_mesh(100, 300, solver="auto", threshold=50)
    ct.prepare()
    assert ct._method() == "sparse"
    assert ct.analyze()
    cd, _ = _port_mesh(100, 300, solver="auto", threshold=10 ** 6)
    cd.prepare()
    assert cd._method() == "dense"
    assert cd.analyze()
    _close(ct._x.numpy(), cd._x.numpy())


def test_large_mesh_against_scipy():
    """1,500 nodes / 6,000 links: the sparse route's node voltages against
    scipy's direct solve of the same MNA (tests/test_sparse.py:83-134)."""
    import scipy.sparse.linalg as spla
    c, nodes = _port_mesh(1500, 6000, 11, solver="sparse")
    assert c.analyze()
    x_ref = spla.spsolve(*mesh_mna(c))
    live = [nd for nd in nodes if nd.node_index >= 0]
    assert len(live) > 1400
    got = np.array([c.node_voltage(nd).real for nd in live])
    ref = np.array([x_ref[nd.node_index] for nd in live])
    assert np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-9)) < TOL


def _caps(pe, nl, nodes, every=20, C=1e-9):
    for k in range(3, len(nodes), every):
        cap = pe.netops.add_model(nl, pe.models.CAPACITOR, {"C": C})
        pe.netops.add_to_node(nl, cap, 0, nodes[k])
        pe.netops.add_to_node(nl, cap, 1, nl.ground_node)


@pytest.mark.parametrize("adaptive", [False, True])
def test_transients_on_the_sparse_route_match_jax(adaptive, monkeypatch):
    """TR (10 steps) and adaptive TR of the 200-node mesh with a
    capacitor on every 20th node and a diode on node 1, from x = 0."""
    traces = []
    for pe, make in ((jpe, lambda: random_mesh_circuit(
            n_nodes=200, n_links=800, seed=7, solver="sparse")),
                     (tpe, lambda: _port_mesh(200, 800, 7, "sparse"))):
        c, nodes = make()
        _caps(pe, c.nl, nodes)
        _add_diode(pe, c.nl, nodes[1])
        c.tr.t_step, c.tr.t_stop = 1e-7, 1e-6
        c.tr.adaptive = adaptive
        c.set_analyze_type(pe.AnalyzeType.TR)
        if pe is tpe:
            _no_dense(monkeypatch)
        assert c.analyze()
        traces.append((c.tr_history, np.asarray(c.tr_times)))
    (hj, tj), (ht, tt_) = traces
    assert ht.shape == hj.shape and ht.shape[0] >= 10
    np.testing.assert_allclose(tt_, tj, rtol=1e-12)
    assert_close(ht, hj, TOL)
    assert np.abs(ht[-1] - ht[0]).max() > 1e-3          # it moved


def _floating_diode():
    """tests/test_torch_circuit_nonlinear.py's capacitor-coupled floating
    node on a diode load: singular at g_min = 0, rescued by the ladder."""
    return diode_load(3.0) + [("c1", "CAPACITOR", {"C": 1e-9}, ("d", "m")),
                              ("c2", "CAPACITOR", {"C": 2e-9}, ("m", "0"))]


def _string(n=20, v_src=100.0):
    spec = [("v", "VDC", {"V": v_src}, ("n0", "0"))]
    for k in range(n):
        spec.append((f"d{k}", "PN_JUNCTION", {"Is": 1e-14 * 10 ** (k % 3)},
                     (f"n{k}", "0" if k == n - 1 else f"n{k + 1}")))
    return spec


def test_gmin_ladder_on_the_sparse_route_matches_jax():
    j, t, ok = analyze_both(_floating_diode(), "DC", solver="sparse",
                            env={"g_min": 0.0})
    assert ok
    assert_close(x_of(t), x_of(j), TOL, max(1.0, np.abs(x_of(j)).max()))
    assert 0.5 < t.c.node_voltage(t.nodes["d"]).real < 0.8


def _rows_both_routes(spec, x=None):
    """The row-wise residual of the gmin check at the circuit's own
    solution (or at ``x``) through the sparse route (COO values) and the
    dense route (a dense A): (sparse rows, dense rows)."""
    out = []
    for solver in ("sparse", "dense"):
        t = build("torch", spec, solver=solver)
        t.c.prepare()
        if x is None:
            t.c.set_analyze_type(t.mod.AnalyzeType.OP)
            assert t.c.analyze()
        xx = t.c._x if x is None else torch.as_tensor(x)
        ctx = StampCtx(mode="op", t=0.0, dt=0.0, env=t.c._env_scalars())
        out.append(t.c._row_residual(ctx, t.c._params(), xx,
                                     t.c._states).numpy())
    return out


def test_coo_residual_check_agrees_with_the_dense_one():
    """The gmin ladder's row-wise check, computed from the COO values on
    the sparse route, equals the dense route's row for row, on a passing
    point and on a failing one (the forced diode string, whose stationary
    point violates KCL), so both refuse and accept alike.  The rows are
    relative (|A x - Z| over the row's scale), so they agree to 1e-12
    absolute: a row whose residual is rounding noise differs there."""
    sp_rows, de_rows = _rows_both_routes(diode_load(3.0))
    np.testing.assert_allclose(sp_rows, de_rows, rtol=1e-9, atol=1e-12)
    assert sp_rows.max() <= 1e-6
    x_bad = np.linspace(100.0, 0.0, 21)
    x_bad = np.concatenate([x_bad[:-1], [0.5]])      # 20 nodes + branch
    sp_rows, de_rows = _rows_both_routes(_string(), x_bad)
    np.testing.assert_allclose(sp_rows, de_rows, rtol=1e-9, atol=1e-12)
    assert sp_rows.max() > 1e-6


@pytest.mark.parametrize("gmin_steps", [0, 8])
def test_diode_string_rejected_on_the_sparse_route_as_in_jax(gmin_steps):
    """The limexp-saturated diode string fails in both packages on the
    sparse route too, with the ladder off and on."""
    def steps(b):
        b.c.gmin_steps = gmin_steps
    _j, _t, ok = analyze_both(_string(), "OP", steps, solver="sparse")
    assert not ok
