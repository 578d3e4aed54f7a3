"""The sparse route's chain preconditioner (``ops/sparse.py``:
``ChainPlan``, ``ChainPreconditioner``, ``bicgstab``'s escalation) and
its band's factors (``ops/tridiag.py``: ``PartitionFactor`` in float64,
shared or one T a lane, ``PCRFactor`` in float32), on the CPU.

The route runs Jacobi until a pattern's solve leaves a lane unconverged,
then that solve again with the chain preconditioner, and the pattern's
later solves with it alone.  Tolerances: against a direct or float64 CG
answer 1e-5 of the source's value (the route stops at a relative
residual of 1e-10, checked at 1e-9; a 2,000-resistor chain's condition
number turns that into gaps of 1e-7 to 2e-6); one application of the
preconditioner of a chain with no links (M = A) against scipy's direct
solve 1e-9 of max|x|; ``PCRFactor`` against
``tridiag_solve`` 1e-13 of max|x| (the same rounds, its multiply-adds
fused where the platform fuses them).
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spl
import torch

from phy_engine_tpu_torch import trace
from phy_engine_tpu_torch.engine import analog
from phy_engine_tpu_torch.models.base import StampCtx
from phy_engine_tpu_torch.ops import sparse, tridiag

from port_bench import mesh as pb_mesh
from port_bench import spec
from port_bench.circuits import random_link_mesh
from port_bench.reference import mesh_dc
from test_torch_sparse import _loaded_mesh

F64 = torch.float64
GAP = 1e-5
VOLTS = (1.0, 0.7)


def _delta(before, after):
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in ("bicgstab.escalations", "chain.factors",
                      "chain.applies", "bicgstab.iterations_launched")}


@pytest.fixture(scope="module")
def chain_mesh():
    """The upstream's random-link mesh at 2,000 nodes and 20 links,
    lowered by the port as the benchmark lowers it, two source values,
    and its float64 CG answer at 1 V."""
    cfg = spec.cell("mesh100k.dc").config
    m = pb_mesh.build(dict(cfg, nodes=2000, links=20))
    ir, nodes, branch, v_col = random_link_mesh.lower(m)
    lanes = lambda a: a[None].repeat((len(VOLTS),) + (1,) * a.dim())
    params = {k: lanes(v) for k, v in analog.initial_params(ir, "cpu").items()}
    params["VDC"][:, 0, v_col] = torch.tensor(VOLTS, dtype=F64)
    states = {k: {s: lanes(a) for s, a in d.items()}
              for k, d in analog.initial_state(ir, "cpu").items()}
    x0 = lanes(analog.initial_x(ir, "cpu"))
    ctx = StampCtx(mode="op", t=0.0, dt=0.0, env=dict(cfg["env"]))
    unit, conv = mesh_dc.solve(m)
    assert conv
    order = np.concatenate([nodes, [branch]])
    return ir, params, x0, states, ctx, order, unit.numpy()


def _solve_mesh(chain_mesh):
    """(x in the reference's order, ok, the slowest lane's iterations,
    the counters' moves) of one DC solve on the sparse route."""
    ir, params, x0, states, ctx, order, _unit = chain_mesh
    calls = []
    before = trace.counters()
    with random_link_mesh.record_iterations(calls):
        x, _st, ok = analog.newton_solve(ir, params, x0, states, ctx,
                                         method="sparse")
    (_name, it), = calls
    return (x.numpy()[:, order], ok, int(it),
            _delta(before, trace.counters()))


def _assert_gaps(x, unit):
    for lane, v in enumerate(VOLTS):
        assert np.abs(x[lane, :-1] - v * unit[:-1]).max() <= GAP * v
        assert abs(x[lane, -1] - v * unit[-1]) <= GAP * abs(v * unit[-1])


def test_jacobi_fails_on_the_chain_mesh_and_the_escalation_converges(
        chain_mesh):
    ir = chain_mesh[0]
    lay = analog.coo_layout(ir)
    assert not lay.chain_first
    x, ok, it, d = _solve_mesh(chain_mesh)
    # Jacobi ran its 400 iterations and left a lane unconverged
    assert d["bicgstab.escalations"] == 1 and d["chain.factors"] == 1
    assert it > 400 and d["bicgstab.iterations_launched"] > 400
    assert bool(ok.all()) and lay.chain_first
    # the source's branch row is the border, last in order
    assert lay.chain.k == 1 and lay.chain.perm is None
    assert d["chain.applies"] == 2 * (d["bicgstab.iterations_launched"] - 400)
    _assert_gaps(x, chain_mesh[-1])


def test_a_marked_pattern_runs_no_jacobi_pass(chain_mesh):
    lay = analog.coo_layout(chain_mesh[0])
    if not lay.chain_first:                 # run alone: mark it first
        _solve_mesh(chain_mesh)
    x, ok, it, d = _solve_mesh(chain_mesh)
    assert d["bicgstab.escalations"] == 0 and d["chain.factors"] == 1
    assert bool(ok.all()) and it < 100
    assert d["bicgstab.iterations_launched"] < 100
    assert d["chain.applies"] == 2 * d["bicgstab.iterations_launched"]
    _assert_gaps(x, chain_mesh[-1])


def test_a_system_jacobi_solves_never_escalates_and_is_unchanged():
    """``bicgstab`` on a system Jacobi solves gives, bit for bit, what
    Jacobi's ``_krylov`` gives called directly."""
    rows, cols, vals, z = _loaded_mesh()
    nu = len(z)
    lay = sparse.COOLayout(rows, cols, nu)
    v = torch.as_tensor(vals)
    b = torch.stack([torch.as_tensor(z), -2.0 * torch.as_tensor(z)])
    before = trace.counters()
    x, ok, it = sparse.bicgstab(None, None, v, b, nu, layout=lay)
    d = _delta(before, trace.counters())
    assert d["bicgstab.escalations"] == 0 and d["chain.factors"] == 0
    assert bool(ok.all()) and not lay.chain_first
    d_ = lay.diagonal(v)
    row_max = lay.row_max(v).clamp(min=1e-300)
    minv = 1.0 / torch.where(d_.abs() > 1e-3 * row_max, d_, row_max)
    b_norm = torch.linalg.vector_norm(b, dim=-1)
    x0 = torch.zeros_like(b)
    mv = lay.bind(v)
    xj, itj, okj = sparse._krylov(
        mv, lambda r: minv * r, x0, b - mv(x0), 400,
        lambda r: torch.linalg.vector_norm(r, dim=-1) / b_norm < 1e-10,
        1e-300)
    assert torch.equal(x, xj) and torch.equal(it, itj) and bool(okj.all())


def _two_source_chain(n=3000, links=12, seed=3):
    """A grounded 1 kΩ chain of n nodes with a few random links and two
    voltage sources, their branch rows placed among the nodes (after
    node n // 2 and last), as COO over n + 2 unknowns."""
    rng = np.random.default_rng(seed)
    mid = n // 2
    idx = np.concatenate([np.arange(mid), np.arange(mid + 1, n + 1)])
    br = (mid, n + 1)                         # the two branch unknowns
    g = 1e-3
    i = np.arange(n - 1)
    a = rng.integers(0, n, links)
    b = (a + rng.integers(2, n - 2, links)) % n
    pa = np.concatenate([[0], i, a])
    pb = np.concatenate([[-1], i + 1, b])
    rows, cols, vals = [], [], []
    for p, q in ((pa, pa), (pb, pb), (pa, pb), (pb, pa)):
        keep = (p >= 0) & (q >= 0)
        rows.append(idx[p[keep]])
        cols.append(idx[q[keep]])
        vals.append(np.full(keep.sum(), g if p is q else -g))
    for node, branch in ((n - 1, br[0]), (n // 3, br[1])):
        rows.append([idx[node], branch])
        cols.append([branch, idx[node]])
        vals.append([1.0, 1.0])
    z = np.zeros(n + 2)
    z[list(br)] = (1.0, 0.4)
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), z)


def test_two_voltage_sources_match_splu():
    """k = 2 border rows, neither at the end of the order (the plan's
    permutation), against scipy's direct solve."""
    rows, cols, vals, z = _two_source_chain()
    nu = len(z)
    lay = sparse.COOLayout(rows, cols, nu)
    before = trace.counters()
    x, ok, it = sparse.bicgstab(None, None, torch.as_tensor(vals),
                                torch.as_tensor(z), nu, layout=lay)
    d = _delta(before, trace.counters())
    assert lay.chain.k == 2 and lay.chain.perm is not None
    assert d["bicgstab.escalations"] == 1 and bool(ok) and int(it) > 400
    A = sp.csc_matrix((vals, (rows, cols)), shape=(nu, nu))
    xe = spl.splu(A).solve(z)
    assert np.abs(x.numpy() - xe).max() <= GAP * np.abs(xe).max()


@pytest.mark.parametrize("right_sides", [(3,), (2, 3)])
def test_pcr_factor_matches_tridiag_solve(right_sides):
    """Random diagonally dominant T of 3 lanes; right sides (3, N), or
    (2, 3, N) broadcast against the factor."""
    rng = np.random.default_rng(8)
    n = 777
    dl, du = (torch.as_tensor(rng.uniform(-1, 1, (3, n))) for _ in range(2))
    d = dl.abs() + du.abs() + torch.as_tensor(rng.uniform(0.1, 2, (3, n)))
    b = torch.as_tensor(rng.standard_normal(right_sides + (n,)))
    x = tridiag.PCRFactor(dl, d, du).solve(b)
    want = tridiag.tridiag_solve(dl, d, du, b)
    assert x.shape == want.shape
    assert float((x - want).abs().max()) <= 1e-13 * float(want.abs().max())


@pytest.mark.parametrize("lanes", [None, 3])
def test_chain_preconditioner_takes_the_factor_its_values_call_for(lanes):
    """Values (nnz,) give the band a shared ``PartitionFactor``, values
    (B, nnz) one T a lane, float32 values ``PCRFactor``.  On a chain with
    no links (M = A, two border rows placed by the plan's permutation)
    an application of M^-1 to (B, n) right sides is each lane's direct
    solve; lane l's values are the pattern's scaled by 1 + l."""
    rows, cols, vals, z = _two_source_chain(n=700, links=0)
    nu = len(z)
    lay = sparse.COOLayout(rows, cols, nu)
    rng = np.random.default_rng(11)
    B = 3 if lanes is None else lanes
    r = rng.standard_normal((B, nu))
    scale = np.ones(B) if lanes is None else 1.0 + np.arange(B)
    v = torch.as_tensor(vals if lanes is None else scale[:, None] * vals)
    pre = sparse.ChainPreconditioner(lay, v)
    assert isinstance(pre.tri, tridiag.PartitionFactor)
    assert pre.tri.lanes == lanes and pre.tri.n == lay.chain.m
    x = pre(torch.as_tensor(r)).numpy()
    lu = spl.splu(sp.csc_matrix((vals, (rows, cols)), shape=(nu, nu)))
    for k in range(B):
        xe = lu.solve(r[k]) / scale[k]
        assert np.abs(x[k] - xe).max() <= 1e-9 * np.abs(xe).max()
    pre32 = sparse.ChainPreconditioner(lay, v.float())
    assert isinstance(pre32.tri, tridiag.PCRFactor)
    x32 = pre32(torch.as_tensor(r, dtype=torch.float32)).double().numpy()
    # float32 on a chain of condition ~n^2: 1e-3 of max|x| read
    assert np.abs(x32 - x).max() <= 1e-2 * np.abs(x).max()
