"""Port parity of the BSIM3 inverter chain (``bench_bsim3.py``'s
workload, ``workloads.bsim3_*``), port against the JAX package on
identical inputs, at 5 stages (37 -> 11 unknowns), B = 4, 15 steps of
0.1 ns.

* The IR of ``workloads.build_bsim3_ir`` equals ``bench_bsim3.build_ir``'s
  array for array (5 and 31 stages).
* The TROP gmin ladder (``workloads.bsim3_seed`` against the bench's
  ``_trop_ladder``): x within 1e-6 of max|x|.
* The frozen-Newton Monte-Carlo transient from that seed, with the Vth0
  jitter the JAX package's ``batch_params`` drew: traces within 1e-6 of
  max|trace|, ``ok`` flags equal.  At ``max_iter = 40`` the frozen solver
  stalls every lane of steps 1 and 2 (it needs 41-48 and ~60 iterations
  there, 188 over the run at 256), so the per-step rescue ladder
  (``newton_solve_batched(solver="hybrid")``) runs and converges them:
  this one configuration is both the parity run and the ladder's test,
  so the JAX side compiles once.  The rescues are counted by wrapping
  the port's ``analog.newton_solve_batched``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_bsim3 as bench
from phy_engine_tpu.engine import analog as jan
from phy_engine_tpu.parallel import batch as jbatch

from phy_engine_tpu_torch import workloads
from phy_engine_tpu_torch.engine import analog as tan
from phy_engine_tpu_torch.parallel.batch import params_from_numpy

torch.set_num_threads(1)

STAGES, B, STEPS, MAX_ITER = 5, 4, 15, 40
FAMILY_ARRAYS = ("P", "pin_nodes", "br_idx", "a_rows", "a_cols", "z_rows")


def _bench_ir(stages):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "STAGES", stages)
        return bench.build_ir()


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's side: the bench's seed, the jitter draw and the
    frozen transient (one compile)."""
    jir = _bench_ir(STAGES)
    env = bench._env()
    x1, st1 = bench._trop_ladder(jir, env)
    pj = jbatch.batch_params(jir, B, jitter=workloads.BSIM3_JITTER)
    x_b = jnp.broadcast_to(x1[0], (B,) + x1.shape[1:])
    st_b = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[0], (B,) + a.shape[1:]), st1)
    _x, _st, ok, xs = jax.jit(lambda p, x, s: jan.transient_batched(
        jir, p, x, s, env, jnp.asarray(0.0, jnp.float64),
        jnp.asarray(workloads.BSIM3_DT, jnp.float64), STEPS,
        solver="frozen", keep_trace=True, max_iter=MAX_ITER))(pj, x_b, st_b)
    return dict(x1=np.asarray(x1), ok=np.asarray(ok), xs=np.asarray(xs),
                params={k: np.asarray(v) for k, v in pj.items()})


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's side on the JAX draw, from its own seed, counting the
    rescue ladder's calls: [(step, lanes it failed to converge)]."""
    ir = workloads.build_bsim3_ir(STAGES)
    start = workloads.bsim3_seed(ir, "cpu")
    params = params_from_numpy(ir, jax_run["params"], "cpu")
    rescues = []
    orig = tan.newton_solve_batched

    def counted(ir_, p, x, st, ctx, max_iter=tan.MAX_NEWTON_ITER,
                solver="hybrid"):
        out = orig(ir_, p, x, st, ctx, max_iter=max_iter, solver=solver)
        rescues.append((round(ctx.t / workloads.BSIM3_DT),
                        int((~out[2]).sum())))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tan, "newton_solve_batched", counted)
        xs, ok = workloads.bsim3_run(ir, params, start, STEPS,
                                     max_iter=MAX_ITER)
    return dict(x1=start[0].numpy(), ok=ok.numpy(), xs=xs.numpy(),
                rescues=rescues)


@pytest.mark.parametrize("stages", [STAGES, workloads.BSIM3_STAGES])
def test_chain_ir_matches_bench(stages):
    ref = _bench_ir(stages)
    ir = workloads.build_bsim3_ir(stages)
    assert (ir.n_unknowns, ir.n_nodes, ir.n_branches, ir.nonlinear) == (
        ref.n_unknowns, ref.n_nodes, ref.n_branches, ref.nonlinear)
    assert ir.n_unknowns == stages + 6
    assert ([f.mdef.id_name for f in ir.families]
            == [f.mdef.id_name for f in ref.families])
    for fam, rfam in zip(ir.families, ref.families):
        for name in FAMILY_ARRAYS:
            np.testing.assert_array_equal(getattr(fam, name),
                                          getattr(rfam, name))
        for k in rfam.state0:
            np.testing.assert_array_equal(fam.state0[k], rfam.state0[k])


def test_trop_seed_matches_jax(jax_run, port_run):
    xj, xt = jax_run["x1"], port_run["x1"]
    assert xt.shape == xj.shape == (1, STAGES + 6)
    assert np.abs(xt - xj).max() <= 1e-6 * np.abs(xj).max()


def test_frozen_transient_matches_jax(jax_run, port_run):
    xj, xt = jax_run["xs"], port_run["xs"]
    assert xt.shape == xj.shape == (STEPS, B, STAGES + 6)
    np.testing.assert_array_equal(port_run["ok"], jax_run["ok"])
    assert jax_run["ok"].all()
    assert np.isfinite(xt).all()
    rel = np.abs(xt - xj).max() / np.abs(xj).max()
    assert rel <= 1e-6, rel


def test_rescue_ladder_fires_and_converges(jax_run, port_run):
    """The ladder ran (steps 1 and 2) and every lane it took converged;
    the run it belongs to matches the JAX package (above)."""
    steps = [s for s, _failed in port_run["rescues"]]
    assert len(steps) > 0 and steps[0] == 1, port_run["rescues"]
    assert all(failed == 0 for _s, failed in port_run["rescues"])
    assert port_run["ok"].all()


def test_transient_names_the_lanes_that_fail():
    """Two steps at a budget of 4 iterations: neither the frozen solver
    nor the rescue converges, and the error names every lane."""
    with pytest.raises(RuntimeError, match=r"lanes \[0, 1, 2\] of 3 did "
                                           "not converge"):
        workloads.bsim3_transient(batch=3, steps=2, stages=STAGES,
                                  device="cpu", max_iter=4)


def test_seed_names_the_rung_that_fails(monkeypatch):
    def stalled(ir, params, x, st, ctx, max_iter=64):
        return x, st, torch.zeros(x.shape[0], dtype=torch.bool)

    monkeypatch.setattr(tan, "newton_solve", stalled)
    with pytest.raises(RuntimeError, match=r"rung 0 \(g_min = 1\.000e-02\)"):
        workloads.bsim3_seed(workloads.build_bsim3_ir(STAGES), "cpu")
