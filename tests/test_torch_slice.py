"""Port parity of the whole slice: the batched transient of the diode
ladder, port against the JAX package on identical inputs.

* ``solver='frozen'`` (the main path: frozen-preconditioner Newton with
  the factor carried across steps and the per-step rescue ladder) on the
  63-stage ladder, B = 6, 25 steps of 50 ns, with the R jitter that the
  JAX package's ``batch_params`` drew — the setting of
  ``tests/test_tr.py::test_frozen_newton_matches_delta_and_gauss``.
* ``solver='delta'`` (``__graft_entry__.entry()``'s solver) on the
  255-stage ladder, B = 4, 4 steps.

Gate: every lane converges on both sides and the traces agree to 1e-6
relative to max|trace| (the bar of ``tests/test_tr.py:236-238``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from phy_engine_tpu.engine import analog as jan
from phy_engine_tpu.parallel import batch as jbatch

from phy_engine_tpu_torch import workloads
from phy_engine_tpu_torch.engine import analog as tan
from phy_engine_tpu_torch.parallel.batch import (batch_state, batch_x,
                                                 params_from_numpy)

# tiny tensors: torch's intra-op threads would only contend with the
# other test worker processes
torch.set_num_threads(1)

DT = 5e-8


def _run_both(stages, B, steps, solver):
    ref = g._build_diode_ladder(stages)
    ir = workloads.build_diode_ladder(stages)
    env = g._env()
    pj = jbatch.batch_params(ref, B, jitter={"R": {"r": 0.05}})
    _x, _st, okj, trj = jan.transient_batched(
        ref, pj, jbatch.batch_x(ref, B), jbatch.batch_state(ref, B), env,
        jnp.asarray(0.0, jnp.float64), jnp.asarray(DT, jnp.float64), steps,
        solver=solver, keep_trace=True)
    pt = params_from_numpy(ir, {k: np.asarray(v) for k, v in pj.items()},
                           device="cpu")
    _x, _st, ok, tr = tan.transient_batched(
        ir, pt, batch_x(ir, B, "cpu"), batch_state(ir, B, "cpu"),
        workloads.default_env(), 0.0, DT, steps, solver=solver, keep_trace=True)
    return np.asarray(okj), np.asarray(trj), ok.numpy(), tr.numpy()


@pytest.mark.parametrize("stages,B,steps,solver",
                         [(63, 6, 25, "frozen"), (255, 4, 4, "delta")])
def test_transient_matches_jax(stages, B, steps, solver):
    okj, trj, ok, tr = _run_both(stages, B, steps, solver)
    assert okj.all() and ok.all()
    assert tr.shape == trj.shape == (steps, B, stages + 1)
    assert np.isfinite(tr).all()
    rel = np.abs(tr - trj).max() / np.abs(trj).max()
    assert rel < 1e-6, rel


def test_frozen_transient_workload_runs_on_cpu():
    """The chip smoke's main-path entry at a tiny size: converges, is
    finite, and seeds reproduce."""
    x1, ok1 = workloads.frozen_transient(batch=3, steps=4, stages=31,
                                         device="cpu", seed=1)
    x2, ok2 = workloads.frozen_transient(batch=3, steps=4, stages=31,
                                         device="cpu", seed=1)
    assert ok1.all() and torch.isfinite(x1).all()
    assert x1.shape == (3, 32) and x1.dtype == torch.float64
    assert torch.equal(x1, x2)
