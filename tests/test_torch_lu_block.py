"""Port parity of the blocked inverse (``ops/lu_block.py``): the plain
version ``lu_block_inverse32_plain`` against the JAX package's
``lu_block_inverse32`` on the CPU (the plain XLA reference of the Pallas
kernel ``_lu_block_pallas``) and against float64 numpy; the failure
contract on singular blocks; the wrapper's CPU routing and input checks;
and the frozen transient with the blocked refactor (``inv='block'``)
against the JAX package's ``FROZEN_INV = "block"``.  The CUDA kernel is
held to the plain version in ``test_torch_cuda.py``.

Tolerances: inverses ``gj_cases.TOL`` (1e-4) relative to max|X| of the
lane, since two f32 eliminations accumulate in different orders; the
transient 1e-6 relative to max|trace| (the bar of
``tests/test_tr.py:238,276``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from phy_engine_tpu.engine import analog as jan
from phy_engine_tpu.ops import lu_block as jlu
from phy_engine_tpu.parallel import batch as jbatch

from phy_engine_tpu_torch import workloads
from phy_engine_tpu_torch.engine import analog as tan
from phy_engine_tpu_torch.ops import gj, lu_block
from phy_engine_tpu_torch.ops.gj_cases import TOL, lane_rel_err, singular_lane, system
from phy_engine_tpu_torch.parallel.batch import (batch_state, batch_x,
                                                 params_from_numpy)

# tiny tensors: torch's intra-op threads would only contend with the
# other test worker processes
torch.set_num_threads(1)

DT = 5e-8


def _np_inv(A):
    return np.linalg.inv(A.astype(np.float64))


@pytest.mark.parametrize("case", ["random", "mna_border"])
@pytest.mark.parametrize("B,n,nb", [(4, 128, 32), (4, 256, 32), (2, 512, 32),
                                    (4, 128, 16)])
def test_plain_matches_jax_and_numpy(B, n, nb, case):
    A, _b = system(case, B, n, seed=n + nb)
    X = lu_block.lu_block_inverse32_plain(torch.from_numpy(A), nb).numpy()
    Xj = np.asarray(jlu.lu_block_inverse32(jnp.asarray(A), nb=nb))
    ref = _np_inv(A)
    assert X.dtype == np.float32 and X.shape == (B, n, n)
    assert lane_rel_err(X, Xj).max() <= TOL
    assert lane_rel_err(X, ref).max() <= TOL
    assert lane_rel_err(Xj, ref).max() <= TOL


@pytest.mark.parametrize("case", ["singular", "block_singular"])
def test_bad_lane_nonfinite_in_both_packages(case):
    B, n = 4, 128
    A, _b = system(case, B, n, seed=7)
    s = singular_lane(B)
    others = [i for i in range(B) if i != s]
    X = lu_block.lu_block_inverse32_plain(torch.from_numpy(A)).numpy()
    Xj = np.asarray(jlu.lu_block_inverse32(jnp.asarray(A)))
    for out in (X, Xj):
        assert not np.isfinite(out[s]).all()
        assert np.isfinite(out[others]).all()
    assert lane_rel_err(X[others], Xj[others]).max() <= TOL
    assert lane_rel_err(X[others], _np_inv(A[others])).max() <= TOL
    if case == "block_singular":
        # the matrix itself is nonsingular: the global-pivot GJ inverts it
        Xg = gj.gj_inverse32_plain(torch.from_numpy(A)).numpy()
        assert np.isfinite(Xg).all()
        assert lane_rel_err(Xg, _np_inv(A)).max() <= TOL


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    lu_block.lu_block_inverse32.launches = 0
    A, _b = system("mna_border", 2, 128, seed=9)
    At = torch.from_numpy(A)
    assert torch.equal(lu_block.lu_block_inverse32(At),
                       lu_block.lu_block_inverse32_plain(At))
    assert torch.equal(lu_block.lu_block_inverse32(At, nb=16),
                       lu_block.lu_block_inverse32_plain(At, 16))
    assert lu_block.lu_block_inverse32.launches == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    A, _b = system("random", 2, 128)
    At = torch.from_numpy(A)
    with pytest.raises(TypeError):
        lu_block.lu_block_inverse32(At.double())
    with pytest.raises(ValueError):
        lu_block.lu_block_inverse32(At.transpose(1, 2))       # not contiguous
    with pytest.raises(ValueError):
        lu_block.lu_block_inverse32(At[:, :100, :100].contiguous())  # n % 32
    with pytest.raises(ValueError):
        lu_block.lu_block_inverse32(At[0])                    # not batched
    with pytest.raises(ValueError):
        lu_block.lu_block_inverse32(At, nb=48)                # n % nb


def _counting(fn, calls):
    def wrapped(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)
    return wrapped


def test_block_path_matches_jax(monkeypatch):
    """The 63-stage ladder, B = 4, 12 steps (``tests/test_tr.py:253-276``'s
    setting): the port's ``inv='block'`` against the JAX package with
    ``FROZEN_INV = "block"`` and against its ``delta`` trace; both sides
    provably went through their blocked inverse."""
    stages, B, steps = 63, 4, 12
    ref = g._build_diode_ladder(stages)
    ir = workloads.build_diode_ladder(stages)
    pj = jbatch.batch_params(ref, B, jitter={"R": {"r": 0.05}})
    args_j = (ref, pj, jbatch.batch_x(ref, B), jbatch.batch_state(ref, B),
              g._env(), jnp.asarray(0.0, jnp.float64),
              jnp.asarray(DT, jnp.float64), steps)
    _x, _st, ok_d, tr_d = jan.transient_batched(*args_j, solver="delta",
                                                keep_trace=True)
    jcalls, tcalls = [], []
    monkeypatch.setattr(jan, "FROZEN_INV", "block")
    monkeypatch.setattr(jlu, "lu_block_inverse32_auto",
                        _counting(jlu.lu_block_inverse32_auto, jcalls))
    _x, _st, ok_j, tr_j = jan.transient_batched(*args_j, solver="frozen",
                                                keep_trace=True)
    monkeypatch.setitem(tan.FROZEN_INVERSES, "block",
                        _counting(lu_block.lu_block_inverse32, tcalls))
    pt = params_from_numpy(ir, {k: np.asarray(v) for k, v in pj.items()},
                           device="cpu")
    args_t = (ir, pt, batch_x(ir, B, "cpu"), batch_state(ir, B, "cpu"),
              workloads.default_env(), 0.0, DT, steps)
    _x, _st, ok, tr = tan.transient_batched(*args_t, solver="frozen",
                                            keep_trace=True, inv="block")
    assert jcalls and tcalls
    assert np.asarray(ok_d).all() and np.asarray(ok_j).all() and ok.all()
    tr = tr.numpy()
    assert tr.shape == (steps, B, stages + 1) and np.isfinite(tr).all()
    for other in (np.asarray(tr_j), np.asarray(tr_d)):
        rel = np.abs(tr - other).max() / np.abs(other).max()
        assert rel < 1e-6, rel
    with pytest.raises(ValueError, match="inv must be one of"):
        tan.transient_batched(*args_t, solver="frozen", inv="bogus")
