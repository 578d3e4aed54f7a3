"""Port parity of ``phy_engine_tpu_torch/ops/sparse.py`` against the JAX
package's ``ops/sparse.py`` and scipy, on the CPU.

Tolerances: matvecs 1e-12 of max|y| (the same f64 products, summed in
another order only in rows wider than eight entries); ``bicgstab_ell``
1e-7 relative to max|x| of scipy's SparseLU solution (as
``tests/test_sparse.py``), the JAX package's within the same; the f64
``bicgstab`` 1e-7 relative (both stop at a 1e-10 relative residual on a
system of condition ~1e3).  Iteration counts are not compared: the two
packages' f32 recurrences round differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spl
import torch

from phy_engine_tpu.ops import sparse as jsp

from phy_engine_tpu_torch import trace
from phy_engine_tpu_torch.ops import sparse as tsp
from test_sparse import _random_mesh_coo

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _splu(rows, cols, vals, z):
    nu = len(z)
    A = sp.csc_matrix((vals, (rows, cols)), shape=(nu, nu))
    return spl.splu(A).solve(z)


def _loaded_mesh(n=300, links=200, seed=4, load=1e-3):
    """A random mesh with every node leaking ``load`` to ground: an
    M-matrix of moderate condition, for the f64 solver."""
    rows, cols, vals, z = _random_mesh_coo(n, links, seed)
    d = np.arange(n)
    return (np.concatenate([rows, d]), np.concatenate([cols, d]),
            np.concatenate([vals, np.full(n, load)]), z)


def _patterns(rows, cols, nu):
    return {"ELL": (tsp.ELL(rows, cols, nu), jsp.ELL(rows, cols, nu)),
            "BandedCOO": (tsp.BandedCOO(rows, cols, nu),
                          jsp.BandedCOO(rows, cols, nu))}


def test_matvecs_match_jax_and_each_other():
    rows, cols, vals, z = _random_mesh_coo(500, 60)
    nu = len(z)
    x = np.random.default_rng(0).standard_normal((3, nu))
    y0 = tsp.coo_matvec(rows, cols, _t(vals), _t(x), nu).numpy()
    scale = np.abs(y0).max()
    for k in range(3):
        yj = np.asarray(jsp.coo_matvec(jnp.asarray(rows), jnp.asarray(cols),
                                       jnp.asarray(vals), jnp.asarray(x[k]),
                                       nu))
        assert np.abs(y0[k] - yj).max() <= 1e-12 * scale
    assert np.abs(y0 - (sp.csr_matrix((vals, (rows, cols)), shape=(nu, nu))
                        @ x.T).T).max() <= 1e-12 * scale
    for name, (tp, jp) in _patterns(rows, cols, nu).items():
        y = tp.matvec(tp.values(_t(vals)), _t(x)).numpy()
        assert np.abs(y - y0).max() <= 1e-12 * scale, name
        yj = np.asarray(jp.matvec(jp.values(jnp.asarray(vals)),
                                  jnp.asarray(x[1])))
        assert np.abs(y[1] - yj).max() <= 1e-12 * scale, name
        dt, mt = tp.diag_and_rowmax(tp.values(_t(vals)))
        dj, mj = jp.diag_and_rowmax(jp.values(jnp.asarray(vals)))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-15)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    d = tsp.coo_diagonal(rows, cols, _t(vals), nu).numpy()
    dj = np.asarray(jsp.coo_diagonal(jnp.asarray(rows), jnp.asarray(cols),
                                     jnp.asarray(vals), nu))
    np.testing.assert_allclose(d, dj, rtol=1e-15)


@pytest.mark.parametrize("pattern", ["ELL", "BandedCOO"])
def test_bicgstab_ell_vs_scipy_and_jax(pattern):
    rows, cols, vals, z = _random_mesh_coo(800, 100)
    nu = len(z)
    xe = _splu(rows, cols, vals, z)
    tp, jp = _patterns(rows, cols, nu)[pattern]
    x, ok, it = tsp.bicgstab_ell(tp, _t(vals), _t(z), tol=1e-10,
                                 max_iter=5000)
    assert bool(ok) and x.shape == (nu,) and int(it) > 0
    xj, okj, _itj = jsp.bicgstab_ell(jp, jnp.asarray(vals), jnp.asarray(z),
                                     tol=1e-10, max_iter=5000)
    assert bool(okj)
    scale = np.abs(xe).max()
    assert np.abs(x.numpy() - xe).max() / scale < 1e-7
    assert np.abs(x.numpy() - np.asarray(xj)).max() / scale < 1e-7


def test_bicgstab_vs_jax_and_scipy():
    rows, cols, vals, z = _loaded_mesh()
    nu = len(z)
    xe = _splu(rows, cols, vals, z)
    x, ok, it = tsp.bicgstab(rows, cols, _t(vals), _t(z), nu)
    xj, okj, _ = jsp.bicgstab(jnp.asarray(rows), jnp.asarray(cols),
                              jnp.asarray(vals), jnp.asarray(z), nu)
    assert bool(ok) and bool(okj) and 0 < int(it) <= 400
    scale = np.abs(xe).max()
    assert np.abs(x.numpy() - xe).max() / scale < 1e-7
    assert np.abs(x.numpy() - np.asarray(xj)).max() / scale < 1e-7
    # warm start from the solution: converged at once, x kept
    x2, ok2, it2 = tsp.bicgstab(rows, cols, _t(vals), _t(z), nu, x0=x)
    assert bool(ok2) and int(it2) <= 1
    assert np.abs(x2.numpy() - xe).max() / scale < 1e-7


def _lanes_system():
    """Three lanes of one pattern with different values and right sides,
    so that they stop at different iterations."""
    rows, cols, vals, z = _loaded_mesh(n=200, links=150, seed=9)
    rng = np.random.default_rng(2)
    vals_b = np.stack([vals * s for s in (1.0, 3.0, 0.5)])
    vals_b[1, -200:] *= 10.0                         # a heavier leak
    z_b = np.stack([z, z * 2.0 + 1e-3 * rng.standard_normal(len(z)),
                    z * -1.0])
    return rows, cols, vals_b, z_b


@pytest.mark.parametrize("solver", ["bicgstab", "bicgstab_ell"])
def test_check_every_k_equals_every_iteration(solver, monkeypatch):
    """Reading the stop condition every k iterations gives the result of
    reading it every iteration, bit for bit, lane by lane."""
    rows, cols, vals_b, z_b = _lanes_system()
    nu = z_b.shape[1]
    lay = tsp.BandedCOO(rows, cols, nu)
    outs = []
    for k in (1, 5, tsp.CHECK_EVERY):
        monkeypatch.setattr(tsp, "CHECK_EVERY", k)
        if solver == "bicgstab":
            out = tsp.bicgstab(rows, cols, _t(vals_b), _t(z_b), nu)
        else:
            out = tsp.bicgstab_ell(lay, _t(vals_b), _t(z_b), max_iter=2000)
        outs.append(out)
    its = outs[0][2].tolist()
    assert len(set(its)) > 1, its                  # lanes stop apart
    for x, ok, it in outs[1:]:
        assert torch.equal(x, outs[0][0])
        assert torch.equal(ok, outs[0][1]) and bool(ok.all())
        assert torch.equal(it, outs[0][2])


@pytest.mark.parametrize("solver", ["bicgstab", "bicgstab_ell"])
def test_lanes_solve_as_alone(solver):
    rows, cols, vals_b, z_b = _lanes_system()
    nu = z_b.shape[1]
    lay = tsp.BandedCOO(rows, cols, nu)

    def run(v, zz):
        if solver == "bicgstab":
            return tsp.bicgstab(rows, cols, _t(v), _t(zz), nu)
        return tsp.bicgstab_ell(lay, _t(v), _t(zz), max_iter=2000)

    xb, okb, itb = run(vals_b, z_b)
    for k in range(3):
        x, ok, it = run(vals_b[k], z_b[k])
        assert bool(ok) and bool(okb[k]) and int(it) == int(itb[k])
        xe = _splu(rows, cols, vals_b[k], z_b[k])
        assert np.abs(xb[k].numpy() - x.numpy()).max() <= \
            1e-12 * np.abs(xe).max()


def test_hub_row_of_degree_10000():
    """A node tied to 10,000 resistors: the row plan stays O(nnz) (under
    2 nnz + n entries, not n x 10,000), and the matvec, the diagonal and
    both solvers agree with scipy."""
    n, hub_links = 300, 10_000
    rows, cols, vals, z = _random_mesh_coo(n, 40, seed=5)
    rng = np.random.default_rng(6)
    other = rng.integers(1, n, hub_links)
    g = 10.0 ** rng.uniform(-4, -2, hub_links)
    rows = np.concatenate([rows, np.zeros_like(other), other,
                           np.zeros_like(other), other])
    cols = np.concatenate([cols, np.zeros_like(other), other, other,
                           np.zeros_like(other)])
    vals = np.concatenate([vals, g, g, -g, -g])
    nu = len(z)
    lay = tsp.COOLayout(rows, cols, nu)
    assert lay.rows.entries < 2 * len(rows) + nu
    hub = int((rows == 0).sum())                   # 20,000 + entries
    widths = [t.shape[1] for _s, t in lay.rows.buckets]
    assert hub <= max(widths) < 2 * hub
    x = np.random.default_rng(7).standard_normal(nu)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(nu, nu))
    y = lay.matvec(_t(vals), _t(x)).numpy()
    assert np.abs(y - A @ x).max() <= 1e-12 * np.abs(A @ x).max()
    np.testing.assert_allclose(lay.diagonal(_t(vals)).numpy(),
                               A.diagonal(), rtol=1e-12)
    xe = _splu(rows, cols, vals, z)
    scale = np.abs(xe).max()
    x1, ok1, _ = tsp.bicgstab(rows, cols, _t(vals), _t(z), nu, layout=lay,
                              max_iter=4000)
    x2, ok2, _ = tsp.bicgstab_ell(tsp.BandedCOO(rows, cols, nu), _t(vals),
                                  _t(z), max_iter=4000)
    assert bool(ok1) and bool(ok2)
    assert np.abs(x1.numpy() - xe).max() / scale < 1e-6
    assert np.abs(x2.numpy() - xe).max() / scale < 1e-7


def test_repeat_run_bit_identical():
    rows, cols, vals, z = _random_mesh_coo(800, 100)
    nu = len(z)
    runs = [tsp.bicgstab_ell(tsp.BandedCOO(rows, cols, nu), _t(vals), _t(z),
                             max_iter=5000) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert int(runs[0][2]) == int(runs[1][2])


def test_row_plan_sums_in_entry_order():
    """Rows up to eight entries wide sum left to right, as a sequential
    scatter-add; wider rows and maxima agree to rounding / exactly."""
    rng = np.random.default_rng(8)
    keys = rng.integers(-2, 40, 2000)              # out-of-range dropped
    keys[:30] = 41                                 # one row 30 wide
    vals = rng.standard_normal(2000) * 10.0 ** rng.uniform(-8, 8, 2000)
    plan = tsp.RowPlan(keys, 42)
    got = plan.sum(_t(vals)).numpy()
    ref = np.zeros(42)
    for k, v in zip(keys, vals):
        if 0 <= k < 42:
            ref[k] += v
    narrow = np.bincount(keys[keys >= 0], minlength=42) <= 8
    np.testing.assert_array_equal(got[narrow], ref[narrow])
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(vals).max())
    mx = plan.amax(_t(np.abs(vals))).numpy()
    ref_mx = np.zeros(42)
    np.maximum.at(ref_mx, keys[keys >= 0], np.abs(vals[keys >= 0]))
    np.testing.assert_array_equal(mx, ref_mx)


def test_shadow_built_on_the_host_in_f64():
    h = tsp.shadow(1000, torch.float32, "cpu")
    i = np.arange(1000, dtype=np.float64)
    ref = np.sin((i + 1.0) * 12.9898) * 43758.5453
    ref = (ref - np.floor(ref)) + 0.5
    np.testing.assert_array_equal(h.numpy(), ref.astype(np.float32))
    assert h.dtype == torch.float32


def _grounded_pattern(n=60, wide_row=5, seed=11):
    """A pattern with ground-row entries (row n), ground-dummy columns
    (col n), repeated (row, col) pairs and one row over
    ``ROW_THREAD_MAX`` entries, in no particular order."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n + 1, 700)
    cols = rng.integers(0, n + 1, 700)
    rows[:tsp.ROW_THREAD_MAX + 9] = wide_row
    perm = rng.permutation(rows.size)
    return rows[perm], cols[perm], n


def test_row_layout_holds_each_entry_once_in_row_plan_order():
    rows, cols, n = _grounded_pattern()
    lay = tsp.COOLayout(rows, cols, n)
    keep = np.nonzero(rows < n)[0]
    assert (rows == n).any() and (cols[keep] == n).any()
    # every in-range entry exactly once, ground-row entries dropped
    np.testing.assert_array_equal(np.sort(lay.perm), keep)
    # a stable sort by row: rows ascending, COO order inside a row
    r, k = rows[lay.perm], lay.perm
    assert ((r[1:] > r[:-1]) | ((r[1:] == r[:-1]) & (k[1:] > k[:-1]))).all()
    counts = np.bincount(rows[keep], minlength=n)
    np.testing.assert_array_equal(np.diff(lay.rowptr), counts)
    assert lay.rowptr.dtype == lay.row_cols.dtype == np.int32
    # the dummy column stays, as n
    np.testing.assert_array_equal(lay.row_cols, cols[lay.perm])
    np.testing.assert_array_equal(lay.wide,
                                  np.nonzero(counts > tsp.ROW_THREAD_MAX)[0])
    assert lay.wide.tolist() == [5]


@pytest.mark.parametrize("lanes", ["per_lane", "shared", "one", "float32"])
def test_row_ordered_sum_over_bind_reproduces_row_plan(lanes):
    """The card kernel's arithmetic, emulated on the CPU: over the bound
    row-ordered values, each row's products rounded and added left to
    right in the values' dtype, reproduce the plain twin bit for bit on
    rows up to eight entries wide and to 1e-12 of max|y| (float64) or 32
    ulps of the row's |A| |x| (float32) elsewhere."""
    rows, cols, n = _grounded_pattern()
    lay = tsp.COOLayout(rows, cols, n)
    rng = np.random.default_rng(12)
    B = 1 if lanes == "one" else 3
    vals = rng.standard_normal((B, rows.size)) * 10.0 ** rng.uniform(
        -6, 6, (B, rows.size))
    x = rng.standard_normal((B, n))
    if lanes == "shared":
        vals = vals[0]
    if lanes == "one":
        vals, x = vals[0], x[0]
    if lanes == "float32":
        vals, x = vals.astype(np.float32), x.astype(np.float32)
    prod = lay.bind(_t(vals))
    want = prod(_t(x)).numpy()
    np.testing.assert_array_equal(want, lay.matvec_plain(_t(vals),
                                                         _t(x)).numpy())
    rv = prod.row_vals.numpy()
    assert rv.flags.c_contiguous and rv.shape[-1] == lay.perm.size
    xe = np.concatenate([np.atleast_2d(x), np.zeros((np.atleast_2d(x)
                                                     .shape[0], 1), x.dtype)], 1)
    rv2 = np.broadcast_to(np.atleast_2d(rv), (xe.shape[0], rv.shape[-1]))
    got = np.zeros((xe.shape[0], n), x.dtype)
    for r in range(n):
        for k in range(lay.rowptr[r], lay.rowptr[r + 1]):
            p = rv2[:, k] * xe[:, lay.row_cols[k]]
            got[:, r] = p if k == lay.rowptr[r] else got[:, r] + p
    got = got.reshape(want.shape)
    narrow = np.diff(lay.rowptr) <= 8
    np.testing.assert_array_equal(got[..., narrow], want[..., narrow])
    if lanes == "float32":
        tol = 32 * np.finfo(np.float32).eps * lay.matvec_plain(
            _t(np.abs(vals)), _t(np.abs(x))).numpy()
        assert (np.abs(got - want) <= tol).all()
    else:
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_coo_spmm_refuses_what_the_kernel_does_not_take():
    rows, cols, n = _grounded_pattern()
    lay = tsp.COOLayout(rows, cols, n)
    rv = torch.zeros(lay.perm.size, dtype=torch.float64)
    x = torch.zeros(n, dtype=torch.float64)
    before = tsp.coo_spmm.launches
    with pytest.raises(TypeError):
        tsp.coo_spmm(lay, rv.half(), x.half())
    with pytest.raises(TypeError):
        tsp.coo_spmm(lay, rv, x.float())
    with pytest.raises(TypeError):
        tsp.coo_spmm(lay, rv.float(), x)
    for dt in (torch.float64, torch.float32):
        with pytest.raises(ValueError, match="CUDA"):
            tsp.coo_spmm(lay, rv.to(dt), x.to(dt))
    assert tsp.coo_spmm.launches == before
    # a CPU product takes the plain twin and launches nothing
    lay.matvec(torch.ones(rows.size, dtype=torch.float64), x)
    assert tsp.coo_spmm.launches == before
    assert "coo_spmm.launches" in trace.counters()


def test_row_layout_of_the_mesh_cell_pattern():
    """The 100,001-unknown random-link mesh the port lowers
    (``torch_circuits.random_link_mesh_ir``, 10,000 links): 540,004
    entries, 540,001 in range, rows of 5, 7 and 9-13 entries and none over
    ``ROW_THREAD_MAX``, so the card's product is one launch."""
    from phy_engine_tpu_torch.engine import analog
    from torch_circuits import random_link_mesh_ir
    lay = analog.coo_layout(random_link_mesh_ir(100_000, 10_000))
    widths = dict(zip(*np.unique(np.diff(lay.rowptr), return_counts=True)))
    assert (lay.n, lay.nnz, lay.perm.size) == (100_001, 540_004, 540_001)
    assert widths == {2: 1, 4: 1, 5: 81_874, 7: 16_376, 9: 1_627, 11: 118,
                      13: 4}
    assert lay.wide.size == 0
    assert int(lay.rowptr[-1]) == lay.perm.size == lay.row_cols.size
