"""Port parity: ``ops/gj.py``'s panel_factor / trailing_update and
``parallel/dist_gj.py`` / ``dist_newton.py`` on a one-rank gloo mesh, in
process, against the JAX package (``tests/test_dist_gj.py``'s cases and
bounds are the oracles).

Tolerances: ``krow`` equal, G / pivd / the trailing update within 1e-6
relative to their max; ``_block_cyclic_perm`` equal; each ``dist_solve``
case held to test_dist_gj's own bound against numpy and its x within 1e-9
(the ``relerr`` measure) of the JAX package's (the cond ~1e9 reject case:
both to its 1e-4 bound, and the unvalidated f32 solve off by more than
1e-2 in both); the distributed Newton, TR and AC within 1e-6 relative of
the JAX package's local analyses and 1e-9 of the port's.  The JAX side
runs on two devices of the suite's virtual CPU mesh (its cheapest
compile; no result depends on D).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import phy_engine_tpu as jpe
import phy_engine_tpu_torch as tpe
from phy_engine_tpu.engine import circuit as jcircuit
from phy_engine_tpu.ops import gj as jgj
from phy_engine_tpu.parallel import dist_gj as jdg
from phy_engine_tpu_torch.engine import analog as tanalog
from phy_engine_tpu_torch.ops import gj as tgj
from phy_engine_tpu_torch.parallel import dist_gj as tdg
from phy_engine_tpu_torch.parallel import dist_newton as tdn
from phy_engine_tpu_torch.parallel.mesh import make_mesh

import torch_mesh_cases as mc
from torch_circuits import build

torch.set_num_threads(1)
NB = tgj.NB


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(device_type="cpu")


def _jax_mesh(d=2):
    return Mesh(np.array(jax.devices()[:d]), ("d",))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_panel_factor_matches_jax(dtype):
    """Two panels in sequence (the second sees the first's pivots)."""
    A, _ = mc.rand_system(2, 2 * NB, seed=4)
    A = A.astype(dtype)
    tdt = getattr(torch, dtype)
    krow_j = jnp.full((2, 2 * NB), -1, jnp.int32)
    pivd_j = jnp.ones((2, 2 * NB), dtype)
    krow_t = torch.full((2, 2 * NB), -1, dtype=torch.int64)
    pivd_t = torch.ones((2, 2 * NB), dtype=tdt)
    for p in range(2):
        panel = A[:, :, p * NB:(p + 1) * NB]
        Gj, krow_j, pivd_j = jgj.panel_factor(jnp.asarray(panel), krow_j,
                                              pivd_j, p * NB)
        Gt, krow_t, pivd_t = tgj.panel_factor(torch.as_tensor(panel),
                                              krow_t, pivd_t, p * NB)
        assert np.array_equal(krow_t.numpy(), np.asarray(krow_j))
        assert _rel(Gt.numpy(), Gj) < 1e-6
        assert _rel(pivd_t.numpy(), pivd_j) < 1e-6


def test_trailing_update_matches_jax():
    rng = np.random.default_rng(8)
    perm = np.stack([rng.permutation(2 * NB)[:NB] for _ in range(2)])
    O = np.zeros((2, 2 * NB, NB), np.float32)
    O[np.arange(2)[:, None], perm, np.arange(NB)] = 1.0
    G = rng.standard_normal((2, 2 * NB, NB)).astype(np.float32)
    T = rng.standard_normal((2, 2 * NB, 3 * NB)).astype(np.float32)
    want = np.asarray(jgj.trailing_update(jnp.asarray(O), jnp.asarray(G),
                                          jnp.asarray(T)))
    got = tgj.trailing_update(torch.as_tensor(O), torch.as_tensor(G),
                              torch.as_tensor(T)).numpy()
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("n,D", [(8 * NB, 1), (8 * NB, 2), (8 * NB, 4),
                                 (8 * NB, 8), (6 * NB, 4), (3 * NB, 2)])
def test_block_cyclic_perm_matches_jax(n, D):
    p = tdg._block_cyclic_perm(n, D)
    assert np.array_equal(p, jdg._block_cyclic_perm(n, D))
    assert sorted(p.tolist()) == list(range(n))


def _mna_zero_diag(n=2 * NB, kv=16, seed=7):
    """test_dist_gj's MNA system with zero-diagonal branch rows."""
    nn = n - kv
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    G = rng.uniform(0.5, 2.0, (nn, nn)) * (rng.random((nn, nn)) < 0.05)
    G = G + G.T
    A[:nn, :nn] = np.diag(G.sum(1) + rng.uniform(1e-3, 1.0, nn)) - G
    for k in range(kv):
        a, b = 2 * k, 2 * k + 1
        A[nn + k, a], A[nn + k, b] = 1.0, -1.0
        A[a, nn + k], A[b, nn + k] = 1.0, -1.0
    return A[None], rng.standard_normal(n)[None]


def _ill_conditioned(n=2 * NB, seed=3):
    """test_dist_gj's cond ~1e9 system that defeats the f32 factor."""
    rng = np.random.default_rng(seed)
    q1, _ = np.linalg.qr(rng.standard_normal((n, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (q1 * np.logspace(0, -9, n)) @ q2
    return A[None], (rng.standard_normal(n) / np.sqrt(n))[None]


CASES = {   # name: (A, b, refine, test_dist_gj's bound against numpy)
    "batched": (*mc.rand_system(4, 2 * NB, seed=1), 2, 1e-10),
    "badly_scaled": (*mc.rand_system(2, 2 * NB, seed=3, cond_boost=12.0), 3,
                     1e-8),
    "mna_zero_diag": (*_mna_zero_diag(), 2, 1e-8),
    "zero_leading_panel": (*mc.zero_leading_panel(2 * NB), 2, 1e-10),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dist_solve_matches_jax(mesh, name):
    A, b, refine, bound = CASES[name]
    x = tdg.dist_solve(mesh, A, b, refine=refine).numpy()
    assert mc.relerr(x, A, b) < bound
    xj = np.asarray(jdg.dist_solve(_jax_mesh(), A, b, refine=refine))
    assert np.max(np.abs(x - xj) / (1 + np.abs(xj))) < 1e-9


def test_dist_solve_single_system(mesh):
    A, b = mc.rand_system(1, 2 * NB, seed=2)
    x = tdg.dist_solve(mesh, A[0], b[0], refine=2).numpy()
    assert x.shape == (2 * NB,)
    assert mc.relerr(x[None], A, b) < 1e-10
    xj = np.asarray(jdg.dist_solve(_jax_mesh(), A[0], b[0], refine=2))
    assert np.max(np.abs(x - xj) / (1 + np.abs(xj))) < 1e-9


def test_dist_solve_validated_reject(mesh):
    """cond ~1e9: the f32 factor mis-solves without a NaN; validation
    rejects it and the f64 refactor recovers, as in the JAX package."""
    A, b = _ill_conditioned()
    x = tdg.dist_solve(mesh, A, b, refine=2).numpy()
    xj = np.asarray(jdg.dist_solve(_jax_mesh(), A, b, refine=2))
    assert mc.relerr(x, A, b) < 1e-4 and mc.relerr(xj, A, b) < 1e-4
    raw = tdg.dist_solve(mesh, A, b, refine=2, validate=False).numpy()
    assert mc.relerr(raw, A, b) > 1e-2


def test_dist_solve_raises_after_the_fallback(mesh):
    A = np.eye(NB)[None].repeat(2, axis=0)
    A[1, 5] = 0.0                              # a singular lane
    with pytest.raises(RuntimeError, match="validated reject"):
        tdg.dist_solve(mesh, A, np.ones((2, NB)))


def test_dist_solve_rejects_bad_n(mesh):
    with pytest.raises(ValueError):
        tdg.dist_solve(mesh, np.eye(100)[None], np.ones((1, 100)))


def _diode_ladder_300(seed=11):
    """test_newton_solve_dist_matches_engine's 300-node ladder."""
    rng = np.random.default_rng(seed)
    spec = [("v", "VDC", {"V": 3.0}, ("n0", "0"))]
    spec += [(f"r{i}", "RESISTANCE", {"r": float(rng.uniform(20, 200))},
              (f"n{i}", f"n{i + 1}")) for i in range(299)]
    for i in range(0, 300, 23):
        spec += [(f"rs{i}", "RESISTANCE", {"r": 220.0}, (f"n{i}", f"m{i}")),
                 (f"d{i}", "PN_JUNCTION", {}, (f"m{i}", "0"))]
    return spec


def _port(spec):
    return build(tpe, tpe.engine.circuit, spec, device="cpu")


def _jax(spec):
    return build(jpe, jcircuit, spec)


def test_newton_solve_dist_matches_jax(mesh):
    spec = _diode_ladder_300()
    j, t = _jax(spec), _port(spec)
    for b in (j, t):
        b.c.set_analyze_type(b.mod.AnalyzeType.OP)
        assert b.c.analyze()
    ir = t.c.prepare()
    x, st, ok = tdn.newton_solve_dist(
        ir, mesh, t.c._params(), tanalog.initial_x(ir, "cpu"),
        tanalog.initial_state(ir, "cpu"), t.c._env_scalars())
    assert ok
    assert _rel(x.numpy(), np.asarray(j.c._x)) < 1e-6
    assert _rel(x.numpy(), t.c._x.numpy()) < 1e-9


def test_transient_dist_matches_jax(mesh):
    spec = mc.rc_diode_ladder()
    j, t = _jax(spec), _port(spec)
    for b in (j, t):
        b.c.tr.t_stop, b.c.tr.t_step = 2e-6, 1e-7
        b.c.set_analyze_type(b.mod.AnalyzeType.TR)
        assert b.c.analyze()
    d = _port(spec)
    ir = d.c.prepare()
    x, st, ok, xs = tdn.transient_dist(
        ir, mesh, d.c._params(), d.c._x, d.c._states, d.c._env_scalars(),
        0.0, 1e-7, 20)
    assert ok and xs.shape == (20, ir.n_unknowns)
    assert _rel(xs, j.c.tr_history) < 1e-6
    assert _rel(xs, t.c.tr_history) < 1e-9
    # the padded states carry the real instances first
    for fam in ir.families:
        for k, v in st[fam.mdef.id_name].items():
            assert v.shape[0] == len(fam.instances)      # D = 1: no padding


def test_ac_solve_dist_matches_jax(mesh):
    """Three omegas around the RC corner (500, 1000, 2000 rad/s), each
    factored cooperatively."""
    spec = mc.rc_corner()
    j = _jax(spec)
    j.c.ac.sweep = j.mod.ACSweepType.LOG
    j.c.ac.omega_start, j.c.ac.omega_stop, j.c.ac.points = 5e2, 2e3, 3
    j.c.set_analyze_type(j.mod.AnalyzeType.AC)
    assert j.c.analyze()
    t = _port(spec)
    ir = t.c.prepare()
    xs = tdn.ac_solve_dist(ir, mesh, t.c._params(), t.c._states,
                           [w for w, _x in j.c.ac_sweep_results])
    ref = np.stack([x for _w, x in j.c.ac_sweep_results])
    assert _rel(xs, ref) < 1e-6
    out = t.nodes["out"].node_index
    assert abs(abs(xs[1, out]) - 1.0 / np.sqrt(2.0)) < 1e-6


def test_delta_solver_is_cached(mesh):
    s1 = tdg.make_dist_delta_solver(mesh, 200, 256)
    assert tdg.make_dist_delta_solver(mesh, 200, 256) is s1
    with pytest.raises(ValueError):
        tdg.make_dist_delta_solver(mesh, 200, 300)
