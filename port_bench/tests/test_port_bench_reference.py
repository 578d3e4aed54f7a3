"""The plain references: the transient against a textbook trapezoidal
integration of a linear RC ladder and against the port's CPU path on a
small diode ladder; the DC solve against a dense solve of the full MNA
and against the port's CPU path on a small mesh."""

import json

import numpy as np
import pytest
import torch

from port_bench import ladder, mesh, spec, system, traffic
from port_bench.circuits import random_link_diode_ladder as diode
from port_bench.circuits import random_link_mesh, series_ladder
from port_bench.reference import ladder_tr, mesh_dc, series_dc

import pb_tiny


def _linear_config(stages=6):
    c = spec.cell("ladder255.mc4096").config
    # a junction with Is = 1e-30 A carries nothing at these voltages
    return dict(c, stages=stages, links=2,
                pn=dict(c["pn"], Is=1e-30, Bv_set=False))


def _textbook(lad, r, steps, dt):
    """C dv/dt = f(v, t) for the free nodes 1..N-1 (node 0 is the source),
    integrated by v_k = v_k-1 + dt/2 C^-1 (f_k + f_k-1); the source's
    current from KCL at node 0, the capacitor there by the same rule."""
    N = lad.stages
    G = np.zeros((N, N))
    for a, b, rv in zip(lad.r_a, lad.r_b, r):
        g = 1.0 / rv
        G[a, a] += g
        G[b, b] += g
        G[a, b] -= g
        G[b, a] -= g
    C = lad.c_node
    e = lambda t: lad.drive["Vp"] * np.sin(2 * np.pi * lad.drive["freq"] * t)
    f = lambda v, t: -(G[1:, 1:] @ v + G[1:, 0] * e(t))
    v = np.zeros(N - 1)
    M = np.eye(N - 1) + dt / (2 * C) * G[1:, 1:]
    i_c0 = 0.0
    for k in range(steps):
        t0, t1 = k * dt, (k + 1) * dt
        rhs = v + dt / (2 * C) * (f(v, t0) - G[1:, 0] * e(t1))
        v_new = np.linalg.solve(M, rhs)
        i_c0 = 2 * C / dt * (e(t1) - e(t0)) - i_c0
        v = v_new
    v_all = np.concatenate([[e(steps * dt)], v])
    i_src = -(G[0] @ v_all + i_c0)
    return np.concatenate([v_all, [i_src]])


def test_reference_is_the_trapezoidal_rule_on_a_linear_ladder():
    lad = ladder.build(_linear_config())
    rng = np.random.default_rng(3)
    r = lad.r_nom * np.exp(0.05 * rng.standard_normal((2, lad.n_r)))
    steps, dt = 40, 5e-8
    x, bad = ladder_tr.transient(lad, r, steps, dt)
    assert not bad.any()
    for lane in range(2):
        want = _textbook(lad, r[lane], steps, dt)
        np.testing.assert_allclose(x[lane], want, rtol=1e-9, atol=1e-13)


def test_reference_float32_is_the_same_arithmetic():
    lad = ladder.build(_linear_config())
    r = lad.r_nom[None, :].repeat(2, axis=0)
    x64, _ = ladder_tr.transient(lad, r, 20, 5e-8, torch.float64)
    x32, _ = ladder_tr.transient(lad, r, 20, 5e-8, torch.float32)
    assert x32.dtype == np.float32
    # float32 rounding, nothing more
    np.testing.assert_allclose(x32, x64, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("drive", [None, {"Vp": 0.2}])
def test_reference_against_the_port_cpu_path(drive):
    c = pb_tiny.cell(stages=31, links=31, lanes=3, steps=20)
    lad = ladder.build(c.config, drive)
    low = system.lower(lad, c.config["env"])
    r = traffic.resistances(lad, c.traffic, 2 ** 33 + 5, 0)
    x, ok = system.run_job(low, r, 20, c.traffic["dt"], "cpu")
    assert bool(ok.all())
    ref, bad = ladder_tr.transient(lad, r, 20, c.traffic["dt"])
    assert not bad.any()
    gaps = diode.lane_gaps(lad, c.config["env"],
                           system.in_ladder_order(low, x.numpy()), ref)
    # the program stops each step's Newton at the SPICE tolerances
    # (reltol 1e-3), so its answers sit well inside a thousandth
    assert gaps.max() < 1e-3


def test_diode_ladder_matches_the_ports_workload_topology():
    """The benchmark's copy of the link generator gives the circuit that
    the port's own workload builds (the same draws from rng 12345)."""
    from phy_engine_tpu_torch.workloads import ladder_links
    lad = ladder.build(spec.cell("ladder255.mc4096").config)
    links = list(zip(lad.r_a[254:].tolist(), lad.r_b[254:].tolist()))
    assert links == ladder_links(255, 255)
    assert lad.n_unknowns == 256 and lad.n_r == 254 + 255


def _full_mna(m):
    """The mesh's MNA over its nodes and the source's current, dense, as a
    textbook stamps it, and its right side for a source of 1 V."""
    n = m.nodes
    A = np.zeros((n + 1, n + 1))
    for a, b, r in zip(m.r_a, m.r_b, m.r_val):
        for i, j, s in ((a, a, 1), (b, b, 1), (a, b, -1), (b, a, -1)):
            if i >= 0 and j >= 0:
                A[i, j] += s / r
    A[m.src, n] = A[n, m.src] = 1.0
    z = np.zeros(n + 1)
    z[n] = 1.0
    return A, z


def test_mesh_reference_solves_the_full_mna():
    m = mesh.build(dict(spec.cell("mesh100k.dc").config, nodes=60, links=15))
    A, z = _full_mna(m)
    want = np.linalg.solve(A, z)
    x, conv = mesh_dc.solve(m)
    assert conv
    np.testing.assert_allclose(x.numpy(), want, rtol=1e-10, atol=1e-15)
    x32, _ = mesh_dc.solve(m, torch.float32)
    assert np.abs(x32.numpy() - want)[:-1].max() < 1e-4


def test_mesh_reference_against_the_port_cpu_path():
    c = pb_tiny.mesh_cell()
    b = random_link_mesh.Bench(c, 5, "cpu")
    unit, conv = mesh_dc.solve(b.mesh)
    assert conv
    (at, whole), fails = b.job(5, 0)
    assert int(fails) == 0
    got = b.compare(5, [(at.numpy(), whole.numpy())])
    # BiCGStab stops at a relative residual of 1e-10
    assert got["v_gap_max"] < 1e-5 and got["i_gap_max"] < 1e-5


def test_mesh_is_the_ports_copy_of_the_upstream_topology():
    """The benchmark's element list gives the matrix that the port's copy
    of bench_sparse.py's generator builds (the same draws)."""
    import scipy.sparse as sp

    from phy_engine_tpu_torch.workloads import sparse_mesh_coo
    n, links = 500, 40
    m = mesh.build(dict(spec.cell("mesh100k.dc").config, nodes=n,
                        links=links))
    rows, cols, vals, z = sparse_mesh_coo(n, links)
    theirs = sp.coo_matrix((vals, (rows, cols)), (n + 1, n + 1)).toarray()
    A, _ = _full_mna(m)
    np.testing.assert_allclose(A, theirs, rtol=1e-15, atol=0)
    assert z[n] == m.vdc and m.src == n - 1


def test_series_reference_solves_the_full_mna():
    n, r = 40, 30.0
    A = np.zeros((n + 1, n + 1))
    for k in range(n):                   # resistor k: node k to k + 1
        a, b = k, (k + 1 if k < n - 1 else -1)
        for i, j, s in ((a, a, 1), (b, b, 1), (a, b, -1), (b, a, -1)):
            if i >= 0 and j >= 0:
                A[i, j] += s / r
    A[0, n] = A[n, 0] = 1.0
    z = np.zeros(n + 1)
    z[n] = 1.0
    want = np.linalg.solve(A, z)
    np.testing.assert_allclose(series_dc.solve(n, r), want, rtol=1e-12,
                               atol=1e-15)
    x32 = series_dc.solve(n, r, np.float32)
    assert np.abs(x32 - want)[:-1].max() < 1e-5


def test_series_reference_against_the_port_cpu_path():
    c = pb_tiny.series_cell()
    b = series_ladder.Bench(c, 5, "cpu")
    at, fails = b.job(5, 0)
    assert int(fails) == 0 and at.shape == (3, 64)
    got = b.compare(5, [at.numpy()])
    assert got["v_gap_max"] < 1e-12 and got["i_gap_max"] < 1e-9
