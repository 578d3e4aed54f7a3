"""Port parity of the batched analog engine on the 63-stage diode ladder:
sparse assembly, the companion step update, the equilibrated dense f32
build, and one Newton solve per solver ('gauss', 'delta', 'hybrid'),
each against the JAX package on identical inputs (the JAX-drawn
Monte-Carlo params carried across by ``params_from_numpy``).

Tolerances: assembly and step update 1e-12 relative (float64);
equilibration scales bit for bit and the scaled f32 matrix to f32
rounding; Newton solutions 1e-6 relative to max|x|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from phy_engine_tpu.engine import analog as jan
from phy_engine_tpu.models.base import StampCtx as JStampCtx
from phy_engine_tpu.parallel import batch as jbatch

from phy_engine_tpu_torch import workloads
from phy_engine_tpu_torch.engine import analog as tan
from phy_engine_tpu_torch.models.base import StampCtx
from phy_engine_tpu_torch.parallel.batch import params_from_numpy, state_from_numpy

# tiny tensors: torch's intra-op threads would only contend with the
# other test worker processes
torch.set_num_threads(1)

B = 4
T, DT = 2.5e-7, 5e-8


@pytest.fixture(scope="module")
def case():
    ref = g._build_diode_ladder(63)
    ir = workloads.build_diode_ladder(63)
    env = g._env()
    pj = jbatch.batch_params(ref, B, jitter={"R": {"r": 0.05}})
    sj = jbatch.batch_state(ref, B)
    rng = np.random.default_rng(42)
    x = np.zeros((B, ref.n_unknowns))
    x[:, :ref.n_nodes] = rng.uniform(-0.2, 0.9, (B, ref.n_nodes))
    x[:, ref.n_nodes:] = rng.standard_normal((B, ref.n_branches)) * 1e-3
    # states one companion step in: nonzero C and PN history
    sj = jax.vmap(jan.step_update_all, in_axes=(None, 0, 0, 0, None, None))(
        ref, pj, jnp.asarray(x), sj, jnp.asarray(DT), jnp.asarray(T))
    p_np = {k: np.asarray(v) for k, v in pj.items()}
    s_np = jax.tree_util.tree_map(np.asarray, sj)
    return dict(ref=ref, ir=ir, env=env, pj=pj, sj=sj, x=x,
                pt=params_from_numpy(ir, p_np, device="cpu"),
                st=state_from_numpy(ir, s_np, device="cpu"))


def _rel(a, b, scale=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    s = np.abs(b).max() if scale is None else scale
    return np.abs(a - b).max() / s


def _jctx(env):
    return JStampCtx(mode="tr", t=jnp.asarray(T), dt=jnp.asarray(DT), env=env)


def test_params_and_state_carried_exactly(case):
    for k, v in case["pj"].items():
        assert np.array_equal(case["pt"][k].numpy(), np.asarray(v))
    for k, d in case["sj"].items():
        for v, a in d.items():
            assert np.array_equal(case["st"][k][v].numpy(), np.asarray(a))


def test_step_update_all_matches_jax(case):
    ref, ir = case["ref"], case["ir"]
    x = case["x"] * 0.5
    sj = jax.vmap(jan.step_update_all, in_axes=(None, 0, 0, 0, None, None))(
        ref, case["pj"], jnp.asarray(x), case["sj"], jnp.asarray(DT),
        jnp.asarray(T + DT))
    st = tan.step_update_all(ir, case["pt"], torch.from_numpy(x), case["st"],
                             DT, T + DT)
    for k, d in sj.items():
        for v, a in d.items():
            assert _rel(st[k][v], a, np.abs(a).max() + 1e-300) <= 1e-12, (k, v)


def test_assemble_sparse_matches_jax(case):
    ref, ir, env = case["ref"], case["ir"], case["env"]
    jr, jc, jv, jZ, jst = jax.vmap(
        lambda p, x, s: jan.assemble_sparse(ref, p, x, s, _jctx(env)))(
        case["pj"], jnp.asarray(case["x"]), case["sj"])
    rows, cols, vals, Z, st = tan.assemble_sparse(
        ir, case["pt"], torch.from_numpy(case["x"]), case["st"],
        StampCtx(mode="tr", t=T, dt=DT, env=env))
    assert np.array_equal(rows.numpy(), np.asarray(jr)[0])
    assert np.array_equal(cols.numpy(), np.asarray(jc)[0])
    assert _rel(vals, jv) <= 1e-12
    assert _rel(Z, jZ) <= 1e-12
    for k, d in jst.items():
        for v, a in d.items():
            assert _rel(st[k][v], a, np.abs(a).max() + 1e-300) <= 1e-12


def test_equil_dense32_bit_exact(case):
    ref, ir, env = case["ref"], case["ir"], case["env"]
    npad = 128
    _r, _c, vals, _Z, _st = tan.assemble_sparse(
        ir, case["pt"], torch.from_numpy(case["x"]), case["st"],
        StampCtx(mode="tr", t=T, dt=DT, env=env))
    rows, cols = jan._sparse_pattern(ref)
    jA, jrs, jcs = jax.vmap(
        lambda v: jan._equil_dense32(jnp.asarray(rows), jnp.asarray(cols), v,
                                     ref.n_unknowns, npad))(
        jnp.asarray(vals.numpy()))
    A32, rs, cs = tan._equil_dense32(ir, vals, npad)
    assert rs.dtype == cs.dtype == A32.dtype == torch.float32
    assert np.array_equal(rs.numpy(), np.asarray(jrs))
    assert np.array_equal(cs.numpy(), np.asarray(jcs))
    # every scale an exact power of two
    m, _e = np.frexp(rs.numpy())
    assert np.all(m == 0.5)
    assert _rel(A32, jA) <= 1e-6


def test_equil_scales_exact_powers_of_two_over_wide_range(case):
    """Values spanning 1e-12..1e3: the port's scales are exact powers of
    two (built from frexp); they equal JAX's wherever JAX's are — XLA's
    CPU exp2 in f32 is inexact for integer arguments |e| >= 13 (e.g.
    exp2(13) = 8192.004), and there the two differ by that rounding."""
    ref, ir = case["ref"], case["ir"]
    rows, cols = jan._sparse_pattern(ref)
    rng = np.random.default_rng(3)
    vals = (rng.standard_normal((3, len(rows)))
            * 10 ** rng.uniform(-12, 3, (3, len(rows))))
    _A, rs, cs = tan._equil_dense32(ir, torch.from_numpy(vals), 128)
    _jA, jrs, jcs = jax.vmap(
        lambda v: jan._equil_dense32(jnp.asarray(rows), jnp.asarray(cols), v,
                                     ref.n_unknowns, 128))(jnp.asarray(vals))
    for mine, theirs in ((rs.numpy(), np.asarray(jrs)),
                         (cs.numpy(), np.asarray(jcs))):
        assert np.all(np.frexp(mine)[0] == 0.5)
        exact = np.frexp(theirs)[0] == 0.5
        assert exact.mean() > 0.5
        assert np.array_equal(mine[exact], theirs[exact])
        assert np.abs(mine / theirs - 1.0).max() <= 1e-6


def test_frozen_tol_and_stale_dense_match_jax(case):
    """The frozen path's residual tolerances and its stale-scaled dense
    build against the same expressions in the JAX package."""
    ir, env = case["ir"], case["env"]
    ctx = StampCtx(mode="tr", t=T, dt=DT, env=env)
    x = torch.from_numpy(case["x"])
    _r, _c, vals, Z, _st = tan.assemble_sparse(ir, case["pt"], x,
                                               case["st"], ctx)
    n, npad = ir.n_unknowns, 128
    rows, cols = (np.asarray(a) for a in jan._sparse_pattern(case["ref"]))
    v, xn, Zn = vals.numpy(), case["x"], Z.numpy()
    xe = np.concatenate([xn, np.zeros((B, 1))], axis=1)
    sc = np.zeros((B, n + 1))
    for i in range(len(rows)):
        sc[:, rows[i]] += np.abs(v[:, i] * xe[:, cols[i]])
    tol_ref = env["i_abstol"] + env["i_reltol"] * (sc[:, :n] + np.abs(Zn))
    tol = tan._frozen_tol(ir, vals, Z, x, env)
    assert _rel(tol, tol_ref) <= 1e-12
    A_fresh, rs, cs = tan._equil_dense32(ir, vals, npad)
    A_stale = tan._dense_stale32(ir, vals, rs * 2.0, cs * 0.5, npad)
    assert torch.equal(A_stale, A_fresh)


@pytest.mark.parametrize("solver", ["gauss", "delta", "hybrid"])
def test_newton_solve_batched_matches_jax(case, solver):
    ref, ir, env = case["ref"], case["ir"], case["env"]
    xj, _stj, okj = jan.newton_solve_batched(
        ref, case["pj"], jnp.asarray(case["x"]), case["sj"], _jctx(env),
        solver=solver)
    x, _st, ok = tan.newton_solve_batched(
        ir, case["pt"], torch.from_numpy(case["x"]), case["st"],
        StampCtx(mode="tr", t=T, dt=DT, env=env), solver=solver)
    assert bool(np.asarray(okj).all()) and bool(ok.all())
    assert _rel(x, xj) <= 1e-6


def _rectifier(Netlist, netops, models, lower_analog, slots):
    """VAC -> R -> diode -> RC load (``__graft_entry__._build_rectifier``)
    with ``slots`` inactive hybrid drive slots."""
    R, C, V, PN = models
    nl = Netlist()
    v = netops.add_model(nl, V, {"Vp": 5.0, "freq": 1e3})
    rs = netops.add_model(nl, R, {"r": 100.0})
    d = netops.add_model(nl, PN, {})
    rl = netops.add_model(nl, R, {"r": 10e3})
    cl = netops.add_model(nl, C, {"C": 1e-6})
    n_src, n_a, n_o = (netops.create_node(nl) for _ in range(3))
    for inst, pin, node in ((v, 0, n_src), (v, 1, nl.ground_node),
                            (rs, 0, n_src), (rs, 1, n_a), (d, 0, n_a),
                            (d, 1, n_o), (rl, 0, n_o), (rl, 1, nl.ground_node),
                            (cl, 0, n_o), (cl, 1, nl.ground_node)):
        netops.add_to_node(nl, inst, pin, node)
    return lower_analog(nl, max_drive_slots=slots)


@pytest.mark.parametrize("solver", ["frozen", "delta"])
def test_rectifier_with_inactive_drive_slots_matches_jax(solver):
    """A second topology, with two inactive digital drive slots (identity
    rows): IR, and a 40-step transient through the quarter period."""
    import phy_engine_tpu as jpe
    from phy_engine_tpu import models as jm
    from phy_engine_tpu.engine.lower import lower_analog as jlower
    from phy_engine_tpu_torch import models as tm
    from phy_engine_tpu_torch.engine.lower import lower_analog as tlower
    from phy_engine_tpu_torch.netlist import operations as tnetops
    from phy_engine_tpu_torch.netlist.netlist import Netlist as TNetlist
    from phy_engine_tpu_torch.parallel.batch import batch_state, batch_x

    ref = _rectifier(jpe.Netlist, jpe.netops, (jm.RESISTANCE, jm.CAPACITOR,
                                               jm.VAC, jm.PN_JUNCTION),
                     jlower, 2)
    ir = _rectifier(TNetlist, tnetops, (tm.RESISTANCE, tm.CAPACITOR, tm.VAC,
                                        tm.PN_JUNCTION), tlower, 2)
    assert ir.n_drive_slots == ref.n_drive_slots == 2
    assert ir.n_unknowns == ref.n_unknowns
    for fam, rfam in zip(ir.families, ref.families):
        for name in ("P", "pin_nodes", "br_idx", "a_rows", "a_cols", "z_rows"):
            assert np.array_equal(getattr(fam, name), getattr(rfam, name))
    Bn, steps, dt = 3, 40, 6.25e-6
    pj = jbatch.batch_params(ref, Bn, jitter={"R": {"r": 0.05}})
    _x, _s, okj, trj = jan.transient_batched(
        ref, pj, jbatch.batch_x(ref, Bn), jbatch.batch_state(ref, Bn),
        g._env(), jnp.asarray(0.0), jnp.asarray(dt), steps, solver=solver,
        keep_trace=True)
    pt = params_from_numpy(ir, {k: np.asarray(v) for k, v in pj.items()},
                           device="cpu")
    _x, _s, ok, tr = tan.transient_batched(
        ir, pt, batch_x(ir, Bn, "cpu"), batch_state(ir, Bn, "cpu"),
        workloads.default_env(), 0.0, dt, steps, solver=solver, keep_trace=True)
    assert bool(np.asarray(okj).all()) and bool(ok.all())
    trj = np.asarray(trj)
    assert np.abs(trj).max() > 1.0          # the source swung up
    assert _rel(tr, trj) < 1e-6


@pytest.mark.parametrize("n_out", [5, 12])
def test_scatter_plan_matches_sequential_scatter(n_out):
    """ScatterPlan against numpy's sequential ``add.at`` / ``maximum.at``:
    duplicate keys summed in entry order, out-of-range keys dropped."""
    rng = np.random.default_rng(n_out)
    keys = rng.integers(-2, n_out + 3, 40)
    vals = rng.standard_normal((3, 40)) * 10 ** rng.uniform(-8, 8, (3, 40))
    plan = tan.ScatterPlan(keys, n_out)
    keep = (keys >= 0) & (keys < n_out)
    ref_sum = np.zeros((3, n_out))
    ref_max = np.zeros((3, n_out))
    for b in range(3):
        np.add.at(ref_sum[b], keys[keep], vals[b, keep])
        np.maximum.at(ref_max[b], keys[keep], np.abs(vals[b, keep]))
    got_sum = plan.sum(torch.from_numpy(vals)).numpy()
    got_max = plan.amax(torch.from_numpy(np.abs(vals))).numpy()
    assert np.array_equal(got_sum, ref_sum)
    assert np.array_equal(got_max, ref_max)
    assert np.array_equal(tan.ScatterPlan([], n_out).sum(
        torch.zeros((2, 0), dtype=torch.float64)).numpy(), np.zeros((2, n_out)))


def test_lu_solve_gauss_matches_jax():
    """The f64 Gauss tier on MNA-border systems (structural-zero
    diagonals force row swaps) against the JAX package's."""
    from phy_engine_tpu.ops.linsolve import lu_solve_gauss as jgauss
    from phy_engine_tpu_torch.ops.gj_cases import system
    from phy_engine_tpu_torch.ops.linsolve import lu_solve_gauss
    A, b = (a.astype(np.float64) for a in system("mna_border", 3, 64, seed=2))
    xj = np.asarray(jax.vmap(jgauss)(jnp.asarray(A), jnp.asarray(b)))
    x = lu_solve_gauss(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    ref = np.linalg.solve(A, b[..., None])[..., 0]
    assert _rel(x, xj) <= 1e-12
    assert _rel(x, ref) <= 1e-12
