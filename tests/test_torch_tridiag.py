"""Port parity of ``phy_engine_tpu_torch/ops/tridiag.py`` (PCR, the
bordered solves, SPIKE with its Thomas inner solver) and of the ladder
workloads against the JAX package's ``ops/tridiag.py`` / ``bench_ladder.py``
algorithms and numpy, on the CPU.

Tolerances: PCR and SPIKE 1e-9 / 1e-8 relative and absolute (as
``tests/test_parallel.py:358-520``); the Kogge-Stone scan 1e-12 of a
sequential recurrence (it rounds differently from XLA's odd-even scan);
the ladders the bench's native-f64 gate (ramp within 1e-6 of V) and the
JAX functions' results to 1e-9 of V.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phy_engine_tpu.ops import tridiag as jt

from phy_engine_tpu_torch import workloads
from phy_engine_tpu_torch.ops import tridiag as tt

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _system(n, seed, batch=()):
    rng = np.random.default_rng(seed)
    dl = rng.uniform(-1, 0, batch + (n,))
    du = rng.uniform(-1, 0, batch + (n,))
    d = np.abs(dl) + np.abs(du) + rng.uniform(0.5, 1.5, batch + (n,))
    b = rng.standard_normal(batch + (n,))
    return dl, d, du, b


def _dense(dl, d, du):
    return np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_pcr_matches_jax_and_numpy(batch):
    dl, d, du, b = _system(257, 2, batch)
    x = tt.tridiag_solve(_t(dl), _t(d), _t(du), _t(b)).numpy()
    xj = np.asarray(jt.tridiag_solve(*map(jnp.asarray, (dl, d, du, b))))
    ref = np.stack([np.linalg.solve(_dense(*a), bb) for *a, bb in
                    zip(*(np.reshape(v, (-1, 257)) for v in (dl, d, du, b)))])
    ref = ref.reshape(x.shape)
    assert np.allclose(x, ref, rtol=1e-9, atol=1e-9)
    assert np.allclose(x, xj, rtol=1e-9, atol=1e-9)
    y = tt.tridiag_matvec(_t(dl), _t(d), _t(du), _t(ref)).numpy()
    assert np.allclose(y, b, rtol=1e-12, atol=1e-12)


def _bordered_ladder(N=64, g=1.0 / 30.0):
    dl = np.full(N, -g)
    du = np.full(N, -g)
    dd = np.full(N, 2 * g)
    dd[-1] = g                       # end node: single resistor
    e = np.zeros(N)
    e[0] = 1.0                       # VDC drives node 0
    return dl, dd, du, e


def test_border_solve_on_the_bordered_ladder():
    dl, dd, du, e = _bordered_ladder()
    N = len(dd)
    z = np.zeros(N)
    v, i = tt.border_solve(_t(dl), _t(dd), _t(du), _t(z), _t(e), _t(3.0))
    vj, ij = jt.border_solve(*map(jnp.asarray, (dl, dd, du, z, e, 3.0)))
    M = np.zeros((N + 1, N + 1))
    M[:N, :N] = _dense(dl, dd, du)
    M[:N, N] = e
    M[N, :N] = e
    ref = np.linalg.solve(M, np.concatenate([z, [3.0]]))
    assert np.allclose(v.numpy(), ref[:N], rtol=1e-9, atol=1e-9)
    assert np.isclose(float(i), ref[N], rtol=1e-9, atol=1e-12)
    assert np.allclose(v.numpy(), np.asarray(vj), rtol=1e-9, atol=1e-9)
    assert np.isclose(float(i), float(ij), rtol=1e-9, atol=1e-12)
    assert np.allclose(v.numpy(), 3.0)               # open chain: no current


def _sequential(coef, add, reverse):
    y = np.empty_like(add)
    m = add.shape[-1]
    order = range(m - 1, -1, -1) if reverse else range(m)
    prev = np.zeros(add.shape[:-1])
    for i in order:
        prev = add[..., i] + coef[..., i] * prev
        y[..., i] = prev
    return y


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("m", [1, 2, 7, 64, 1000])
def test_linrec_scan_matches_sequential(m, reverse):
    rng = np.random.default_rng(m)
    coef = rng.uniform(0.1, 0.9, (3, m))
    add = rng.standard_normal((3, m))
    got = tt._linrec_scan(_t(coef), _t(add), reverse=reverse).numpy()
    ref = _sequential(coef, add, reverse)
    assert np.abs(got - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1.0)
    gj = np.asarray(jt._linrec_scan(jnp.asarray(coef), jnp.asarray(add),
                                    reverse=reverse))
    assert np.abs(got - gj).max() <= 1e-12 * max(np.abs(ref).max(), 1.0)


def test_host_pivots_match_jax_bit_for_bit():
    dl, d, du, _b = _system(1003, 7)
    np.testing.assert_array_equal(tt.spike_host_pivots(dl, d, du, 8),
                                  jt.spike_host_pivots(dl, d, du, 8))


@pytest.mark.parametrize("inner,pivots", [("thomas", "device"),
                                          ("thomas", "host"),
                                          ("pcr", "device")])
@pytest.mark.parametrize("nbatch", [1, 2])
def test_spike_factor_matches_jax_and_dense(inner, pivots, nbatch):
    dl, d, du, b = _system(1003, 7)                 # not a multiple of 8
    x_ref = np.linalg.solve(_dense(dl, d, du), b)
    kw = dict(chunks=8, nbatch=nbatch, inner=inner)
    if pivots == "host":
        kw["dp"] = tt.spike_host_pivots(dl, d, du, 8)
        fac = tt.SpikeFactor(_t(dl), None, _t(du), **kw)
        facj = jt.SpikeFactor(jnp.asarray(dl), None, jnp.asarray(du), **kw)
    else:
        fac = tt.SpikeFactor(_t(dl), _t(d), _t(du), **kw)
        facj = jt.SpikeFactor(*map(jnp.asarray, (dl, d, du)), **kw)
    x = fac.solve(_t(b)).numpy()
    xj = np.asarray(facj.solve(jnp.asarray(b)))
    assert np.allclose(x, x_ref, rtol=1e-8, atol=1e-9)
    assert np.allclose(x, xj, rtol=1e-8, atol=1e-9)
    y = fac.matvec(_t(x_ref)).numpy()
    assert np.allclose(y, b, rtol=1e-7, atol=1e-8)


def test_thomas_device_factor_matches_host_pivots():
    dl, d, du, _b = _system(1003, 5)
    dev = tt.SpikeFactor(_t(dl), _t(d), _t(du), chunks=8)
    host = tt.SpikeFactor(_t(dl), None, _t(du), chunks=8,
                          dp=tt.spike_host_pivots(dl, d, du, 8))
    for a, b in ((dev._thomas.w, host._thomas.w),
                 (dev._thomas.dpinv, host._thomas.dpinv),
                 (dev._thomas.t, host._thomas.t)):
        assert torch.allclose(a, b, rtol=1e-14, atol=0.0)


def test_spike_border_solves_match_jax_and_dense():
    N, g = 400, 1.0 / 30.0
    dl = np.full(N, -g)
    du = np.full(N, -g)
    dd = np.full(N, 2 * g)
    dd[0] = g
    e = np.zeros(N)
    e[0] = 1.0
    z = np.zeros(N)
    M = np.zeros((N + 1, N + 1))
    M[:N, :N] = _dense(dl, du=du, d=dd)
    M[:N, N] = e
    M[N, :N] = e
    ref = np.linalg.solve(M, np.concatenate([z, [3.0]]))

    fac, t_e, ete = tt.spike_border_solve_factor(
        _t(dl), _t(dd), _t(du), _t(e), chunks=16, nbatch=4)
    v, i = tt.spike_border_solve(fac, t_e, ete, _t(z), _t(e), _t(3.0))
    facj, t_ej, etej = jt.spike_border_solve_factor(
        *map(jnp.asarray, (dl, dd, du, e)), chunks=16, nbatch=4)
    vj, ij = jt.spike_border_solve(facj, t_ej, etej, jnp.asarray(z),
                                   jnp.asarray(e), jnp.asarray(3.0))
    xprobe = np.random.default_rng(1).standard_normal(N)
    assert np.allclose(fac.matvec(_t(xprobe)).numpy(),
                       _dense(dl, dd, du) @ xprobe, rtol=1e-10, atol=1e-12)
    for vv, ii in ((v, i), (vj, ij)):
        assert np.allclose(np.asarray(vv), ref[:N], rtol=1e-8, atol=1e-9)
        assert np.isclose(float(ii), ref[N], rtol=1e-8, atol=1e-12)

    facu, t_eu, eteu = tt.spike_border_solve_unit_factor(
        _t(dl), _t(dd), _t(du), idx=0, chunks=16, nbatch=4)
    vu, iu = tt.spike_border_solve_unit(facu, t_eu, eteu, _t(z), _t(3.0))
    fju, t_eju, eteju = jt.spike_border_solve_unit_factor(
        *map(jnp.asarray, (dl, dd, du)), idx=0, chunks=16, nbatch=4)
    vju, iju = jt.spike_border_solve_unit(fju, t_eju, eteju, jnp.asarray(z),
                                          jnp.asarray(3.0))
    assert np.allclose(vu.numpy(), ref[:N], rtol=1e-8, atol=1e-9)
    assert np.allclose(vu.numpy(), np.asarray(vju), rtol=1e-9, atol=1e-9)
    assert np.isclose(float(iu), float(iju), rtol=1e-9, atol=1e-12)


def test_ladder_dc_exact_ramp_and_jax():
    """``workloads.ladder_dc`` at N = 1000: the exact ramp and source
    current, and the JAX ``border_solve`` on the same host extraction
    (bench_ladder.py's ``main`` pipeline)."""
    r = workloads.ladder_dc(1000, device="cpu", solves=2)
    V, N = workloads.LADDER_V, 1000
    assert r["max_ramp_err"] < r["tol"] * V
    assert r["i_err"] < 1e-9 + r["tol"] * r["i_exp"]
    assert len(r["solve_s"]) == 2 and r["v"].shape == (N,)
    # the JAX pipeline's solve on the port's assembled system
    from phy_engine_tpu_torch.engine import analog
    from phy_engine_tpu_torch.models.base import StampCtx
    ir = workloads.ladder_ir(N)
    one = {k: v[None] for k, v in analog.initial_params(ir, "cpu").items()}
    st = {k: {s: a[None] for s, a in d.items()}
          for k, d in analog.initial_state(ir, "cpu").items()}
    ctx = StampCtx(mode="op", t=0.0, dt=0.0, env=workloads.default_env())
    rows, cols, vals, Z, _ = analog.assemble_sparse(
        ir, one, analog.initial_x(ir, "cpu")[None], st, ctx)
    parts = workloads.ladder_extract(rows.numpy(), cols.numpy(),
                                     vals[0].numpy(), Z[0].numpy(),
                                     ir.n_unknowns)
    dl, d, du, e, z, rb = parts
    vj, ij = jt.border_solve(*map(jnp.asarray, (dl, d, du, z, e,
                                                rb * r["rhs_scale"])),
                             refine=4)
    assert np.abs(r["v"] - np.asarray(vj)).max() < 1e-9 * V
    assert abs(r["i_src"] - float(ij)) < 1e-9 * r["i_exp"]


def test_ladder_direct_exact_ramp_and_jax():
    """``workloads.ladder_direct`` at N = 1e5 in 16 chunks: the sampled
    ramp and source current, and the JAX SPIKE path on the same host
    pivots (bench_ladder.py's ``main_direct`` pipeline)."""
    N, V = 10 ** 5, workloads.LADDER_V
    r = workloads.ladder_direct(N, chunks=16, device="cpu", solves=1)
    assert r["max_ramp_err"] < r["tol"] * V
    assert r["i_err"] < 1e-9 + r["tol"] * r["i_exp"]
    g = 1.0 / workloads.LADDER_R
    d_h = np.full(N, 2.0 * g)
    d_h[0] = g
    dp = jt.spike_host_pivots(np.full(N, -g), d_h, np.full(N, -g), 16)
    fac, t_e, ete = jt.spike_border_solve_unit_factor(
        jnp.full(N, -g), None, jnp.full(N, -g), idx=0, chunks=16, nbatch=4,
        dp=dp)
    vj, ij = jt.spike_border_solve_unit(fac, t_e, ete, jnp.zeros(N),
                                        jnp.asarray(V * r["rhs_scale"]),
                                        idx=0, refine=1)
    vj = np.asarray(vj)[[0, N // 2, N - 1]]
    assert np.abs(r["v_sampled"] - vj).max() < 1e-9 * V
    assert abs(r["i_src"] - float(ij)) < 1e-9 * r["i_exp"]


def _shared(n, seed, batch):
    """``_system``'s T (n,), shared by the ``batch`` right sides b."""
    dl, d, du, _b = _system(n, seed)
    b = np.random.default_rng(seed + 1).standard_normal(batch + (n,))
    return dl, d, du, b


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("n", [1, 20, 31, 32, 33, 64, 65, 1000, 2049])
def test_partition_twin_matches_dense(n, batch):
    """The partitioned solve's plain twin (``PartitionFactor`` on CPU
    tensors) against numpy's dense solve: n below one chunk, at and
    around a chunk and the direct level's limit, not a multiple of a
    chunk, and three levels (2049 -> 65 -> 3)."""
    dl, d, du, b = _shared(n, n, batch)
    fac = tt.PartitionFactor(_t(dl), _t(d), _t(du))
    assert len(fac.levels) == len(tt.part_sizes(n)) - 1
    x = fac.solve(_t(b)).numpy()
    ref = np.linalg.solve(_dense(dl, d, du), b.reshape(-1, n).T).T
    assert x.shape == b.shape
    assert np.allclose(x, ref.reshape(b.shape), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("per", [1, 2])
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("n", [1, 20, 31, 32, 33, 64, 65, 1000, 2049])
def test_partition_twin_per_lane_matches_dense(n, lanes, per):
    """The twin with one T a lane, (lanes, n), against numpy's dense solve
    of each lane's T: ``per`` right sides a lane, (per lanes, n), row r
    solved with lane r mod lanes's T, and the same rows as (per, lanes,
    n); the n of ``test_partition_twin_matches_dense``."""
    dl, d, du, _b = _system(n, 3 * n + lanes, (lanes,))
    b = np.random.default_rng(n).standard_normal((per * lanes, n))
    fac = tt.PartitionFactor(_t(dl), _t(d), _t(du))
    assert fac.lanes == lanes
    assert len(fac.levels) == len(tt.part_sizes(n)) - 1
    for lev in fac.levels:
        C = -(-lev.n // tt.PART_M)
        assert lev.w.shape == (lanes, tt.PART_M - 1, C)
        assert lev.edge.shape == (lanes, 10, C)
    assert fac.direct.w.shape == (lanes, fac.direct.n)
    x = fac.solve(_t(b)).numpy()
    assert x.shape == b.shape
    # (per, lanes, n): the same rows in order
    assert np.array_equal(fac.solve(_t(b).reshape(per, lanes, n)).numpy(),
                          x.reshape(per, lanes, n))
    for r in range(per * lanes):
        k = r % lanes
        ref = np.linalg.solve(_dense(dl[k], d[k], du[k]), b[r])
        assert np.allclose(x[r], ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n", [20, 1000, 2049])
def test_partition_per_lane_factor_of_equal_lanes_is_the_shared_one(n):
    """A per-lane factor whose lanes all hold one T: each level's arrays
    are the shared factor's, lane by lane, and its answers the shared
    factor's, bit for bit."""
    dl, d, du, b = _shared(n, 5 * n, (6,))
    shared = tt.PartitionFactor(_t(dl), _t(d), _t(du))
    lanes = tt.PartitionFactor(*(_t(np.tile(v, (3, 1))) for v in (dl, d, du)))
    for got, want in zip(lanes.levels + [lanes.direct],
                         shared.levels + [shared.direct]):
        assert got[0] == want[0]
        for u, v in zip(got[1:], want[1:]):
            for k in range(3):
                assert torch.equal(u[k], v)
    assert torch.equal(lanes.solve(_t(b)), shared.solve(_t(b)))
    assert torch.equal(lanes.solve(_t(b[:3])), shared.solve(_t(b[:3])))


@pytest.mark.parametrize("N", [64, 400, 5000])
def test_partition_border_solve_matches_jax_and_dense(N):
    """``border_solve_part`` with the twin's factor on the bordered ladder
    against the JAX package's ``border_solve`` and a dense solve (the
    tolerances of ``test_border_solve_on_the_bordered_ladder``), for one
    right side and for three lanes of source values."""
    dl, dd, du, e = _bordered_ladder(N)
    z = np.zeros(N)
    fac = tt.PartitionFactor(_t(dl), _t(dd), _t(du))
    v, i = tt.border_solve_part(fac, _t(dl), _t(dd), _t(du), _t(z), _t(e),
                                _t(3.0), refine=2)
    vj, ij = jt.border_solve(*map(jnp.asarray, (dl, dd, du, z, e, 3.0)))
    M = np.zeros((N + 1, N + 1))
    M[:N, :N] = _dense(dl, dd, du)
    M[:N, N] = e
    M[N, :N] = e
    ref = np.linalg.solve(M, np.concatenate([z, [3.0]]))
    assert np.allclose(v.numpy(), ref[:N], rtol=1e-9, atol=1e-9)
    assert np.isclose(float(i), ref[N], rtol=1e-9, atol=1e-12)
    assert np.allclose(v.numpy(), np.asarray(vj), rtol=1e-9, atol=1e-9)
    assert np.isclose(float(i), float(ij), rtol=1e-9, atol=1e-12)
    volts = np.array([0.5, 1.0, 1.5])
    zb = np.random.default_rng(N).standard_normal((3, N)) * 1e-3
    vb, ib = tt.border_solve_part(fac, _t(dl), _t(dd), _t(du), _t(zb),
                                  _t(e), _t(3.0 * volts), refine=2)
    for k in range(3):
        refk = np.linalg.solve(M, np.concatenate([zb[k], [3.0 * volts[k]]]))
        assert np.allclose(vb[k].numpy(), refk[:N], rtol=1e-9, atol=1e-9)
        assert np.isclose(float(ib[k]), refk[N], rtol=1e-9, atol=1e-12)


def test_border_solve_on_the_cpu_takes_the_twin(monkeypatch):
    """On CPU tensors ``border_solve`` at refine 4 runs six
    ``PartitionFactor`` solves (the plain twin: no launch) and no host
    sync, to the answer of its Schur pass written out over
    ``part_solve_plain``, bit for bit."""
    from phy_engine_tpu_torch import trace
    dl, dd, du, e = _bordered_ladder(300)
    z = np.random.default_rng(3).standard_normal((2, 300)) * 1e-3
    a, d, c, zz, ee, rb = (_t(dl), _t(dd), _t(du), _t(z), _t(e),
                           _t([3.0, 1.5]))
    calls = []
    solve = tt.PartitionFactor.solve
    monkeypatch.setattr(tt.PartitionFactor, "solve",
                        lambda f, b: calls.append(1) or solve(f, b))
    before = trace.counters()
    v, i = tt.border_solve(a, d, c, zz, ee, rb, refine=4)
    after = trace.counters()
    assert len(calls) == 6
    assert after["tridiag_part64.launches"] == \
        before["tridiag_part64.launches"]
    assert after.get("host_syncs", 0) == before.get("host_syncs", 0)
    # the Schur pass written out: t_e, then base(z) and four refinements
    levels, direct = tt.part_factor_plain(a, d, c)
    t_e = tt.part_solve_plain(levels, direct, ee)
    ete = t_e @ ee

    def base(zk, rk):
        t_z = tt.part_solve_plain(levels, direct, zk)
        ik = (t_z @ ee - rk) / ete
        return torch.addcmul(t_z, t_e, ik[..., None], value=-1.0), ik

    vv, ii = base(zz, rb)
    for _ in range(4):
        dv, di = base(tt._residual(a, d, c, zz, vv, ee, ii), rb - vv @ ee)
        vv, ii = vv + dv, ii + di
    assert torch.equal(v, vv) and torch.equal(i, ii)


def test_partition_factor_on_the_cpu_counts_no_launch():
    """The twin factors and solves CPU tensors of any shape it takes with
    no launch counted: a shared T (n,) and a per-lane T (B, n).  Ragged
    diagonals raise, as do 3-D ones, a right side whose rows are not a
    multiple of a per-lane factor's lanes, and in ``border_solve`` a 2-D
    T or border."""
    dl, d, du, b = _shared(1000, 4, (2,))
    before = tt.tridiag_part64.launches
    fac = tt.PartitionFactor(_t(dl), _t(d), _t(du))
    fac.solve(_t(b))
    fac.solve(_t(b[0]))
    lanes = tt.PartitionFactor(_t(dl)[None], _t(d)[None], _t(du)[None])
    assert lanes.lanes == 1 and fac.lanes is None
    lanes.solve(_t(b))
    two = tt.PartitionFactor(*(_t(np.stack([v, v])) for v in (dl, d, du)))
    assert two.lanes == 2
    two.solve(_t(np.concatenate([b, b])))
    assert tt.tridiag_part64.launches == before
    with pytest.raises(ValueError):
        two.solve(_t(b[0]))
    with pytest.raises(ValueError):
        two.solve(_t(np.concatenate([b, b[:1]])))
    with pytest.raises(ValueError):
        tt.border_solve(_t(dl)[None], _t(d)[None], _t(du)[None], _t(b),
                        _t(b[0]), _t(1.0))
    with pytest.raises(ValueError):
        tt.border_solve(_t(dl), _t(d), _t(du), _t(b), _t(b), _t([1.0, 2.0]))
    with pytest.raises(ValueError):
        tt.PartitionFactor(_t(dl)[None, None], _t(d)[None, None],
                           _t(du)[None, None])
    with pytest.raises(ValueError):
        tt.PartitionFactor(_t(dl), _t(d)[:-1], _t(du))
    with pytest.raises(ValueError):
        tt.PartitionFactor(_t(dl)[None], _t(d)[None], _t(du))
    with pytest.raises(ValueError):
        tt.PartitionFactor(*(_t(np.stack([v, v]))[:, :-1] if k == 1
                             else _t(np.stack([v, v]))
                             for k, v in enumerate((dl, d, du))))
    with pytest.raises(ValueError):
        fac.solve(_t(b)[:, :-1])


def test_partition_route_residual_matches_tridiag_matvec():
    """The partitioned route's residual z - T v - e i (slices, no scalar
    written) against ``tridiag_matvec`` and numpy, for 1-D and 2-D v."""
    dl, d, du, b = _shared(257, 9, (3,))
    rng = np.random.default_rng(10)
    e = rng.standard_normal(257)
    for z, v, i in ((b, b[::-1].copy(), rng.standard_normal(3)),
                    (b[0], b[1], rng.standard_normal(()))):
        got = tt._residual(_t(dl), _t(d), _t(du), _t(z), _t(v), _t(e),
                           _t(i)).numpy()
        tv = tt.tridiag_matvec(_t(dl), _t(d), _t(du), _t(v)).numpy()
        want = z - tv - e * np.asarray(i)[..., None]
        assert np.allclose(got, want, rtol=1e-13, atol=1e-13)
        dense = z - (_dense(dl, d, du) @ v.T).T - e * np.asarray(i)[..., None]
        assert np.allclose(got, dense, rtol=1e-12, atol=1e-12)
