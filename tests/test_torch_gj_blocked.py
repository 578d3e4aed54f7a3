"""CPU rehearsal of the blocked dataflow of ``phy_engine_tpu_torch/ops/csrc/gj.cu``.

The CUDA kernels cannot run here, so this file carries a torch emulation
of their dataflow, step for step as the kernels take it: 32-wide
micro-panels whose eliminated slots keep their factor columns (the panel
becomes G with M = I - G O^T), the panel's pivot rows copied out of the
live region before the update (R), the update base - G R, the inverse's
in-place column map (physical column k holds A column k before its panel
and identity column rowof[k] after it, so the panel's own columns become
e_rowof[k] - G[:, k - k0]) and the final gather
X[krow[r]][j] = W[r][krow[j]] / pivd[r]; the solve's b column and its
placement x[krow[r]] = Wb[r] / pivd[r].  Past n = 1024 the panel launch
is a thread-block cluster: ``cluster_pick`` emulates its pivot search
(each block's warps' candidates over its own rows, merged in block order
by the single-block rule).  The emulation is held against the plain
versions ``gj_*_plain``, the JAX package's ``gj_inverse32`` /
``gj_solve32`` (their XLA path on the CPU) and float64 numpy.

Tolerance: ``gj_cases.TOL`` (1e-4) relative to max|x| of the lane, since
the blocked update sums the panel's rank-1 terms in another order than
the sequential steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phy_engine_tpu.ops import gj as jgj

from phy_engine_tpu_torch.ops import gj
from phy_engine_tpu_torch.ops.gj_cases import TOL, lane_rel_err, singular_lane, system

torch.set_num_threads(1)

MB = gj.MB
_BIG = 2 ** 30


def global_pick(col, krow):
    """The single-block panel's pivot: the unpivoted row with the largest
    |col| (a NaN as +inf), a tie to the smallest row."""
    rows = torch.arange(col.shape[1])
    key = torch.where(krow >= 0, torch.tensor(-3e38),
                      torch.where(torch.isnan(col), torch.tensor(np.inf),
                                  col.abs()))
    best = key.amax(dim=1, keepdim=True)
    return torch.where(key == best, rows, _BIG).amin(dim=1)


def kernel_split(n: int):
    """The cluster the GJ panel launch takes for n > 1024 (gj.cu's
    ``launch_panel``): cs = ceil(n / 1024) blocks of rb = ceil(n / cs)
    rows rounded up to a multiple of 256."""
    cs = -(-n // 1024)
    return cs, -(-(-(-n // cs)) // 256) * 256


def cluster_pick(col, krow, cs, rb):
    """The cluster's pivot as the kernel takes it: each block's warps find
    their candidates over their own rows (thread t of block c owns rows c
    rb + t + 256 s; the integer key, a pivoted row 1, an unpivoted one the
    bits of |col| plus 2, a NaN as +inf; a tie to the smaller row), then
    every block merges the cs x 8 candidates in block order by the same
    rule."""
    B, n = col.shape
    rows = torch.arange(n)
    mag = torch.where(torch.isnan(col), torch.tensor(np.inf), col.abs())
    key = torch.where(krow >= 0, 1, mag.view(torch.int32).to(torch.int64) + 2)
    best_k = torch.zeros(B, dtype=torch.int64)
    best_r = torch.full((B,), _BIG, dtype=torch.int64)
    for c in range(cs):
        local = rows - c * rb
        for w in range(8):
            mine = ((local >= 0) & (local < rb) & (rows < n)
                    & ((local % 256) // 32 == w))
            k = torch.where(mine, key, 0)
            kmax = k.amax(dim=1)
            r = torch.where(mine & (k == kmax[:, None]), rows, _BIG).amin(dim=1)
            take = (kmax > best_k) | ((kmax == best_k) & (r < best_r))
            best_k = torch.where(take, kmax, best_k)
            best_r = torch.where(take, r, best_r)
    return best_r


def _panel(P, krow, pivd, rowof, k0, pick=global_pick):
    """The panel launch: 32 one-hot pivot steps on the (B, n, 32) panel,
    each slot keeping its factor column.  Updates krow / pivd / rowof in
    place and returns G."""
    B, n, _ = P.shape
    rows = torch.arange(n)
    lanes = torch.arange(B)
    for j in range(MB):
        col = P[:, :, j]
        r = pick(col, krow)
        prow = P[lanes, r].clone()                        # before the step
        p = prow[:, j:j + 1]
        onehot = rows[None, :] == r[:, None]
        f = (col / p) * (~onehot).to(torch.float32)
        P = P - f[:, :, None] * prow[:, None, :]
        P[:, :, j] = f
        krow[onehot] = k0 + j
        pivd[onehot] = (1.0 + (p - 1.0)).expand(-1, n)[onehot]
        rowof[:, k0 + j] = r
    return P


def blocked_gj(A, b=None, pick=global_pick):
    """The kernels' dataflow: the inverse when ``b`` is None, else the
    solve.  A (B, n, n), b (B, n) float32 tensors; ``pick`` the panel's
    pivot search."""
    B, n, _ = A.shape
    inverse = b is None
    lanes = torch.arange(B)[:, None]
    W = A.clone()                        # the kernel reads A at k0 = 0
    Wb = None if inverse else b.clone()
    krow = torch.full((B, n), -1, dtype=torch.int64)
    pivd = torch.ones((B, n), dtype=torch.float32)
    rowof = torch.zeros((B, n), dtype=torch.int64)
    for k0 in range(0, n, MB):
        G = _panel(W[:, :, k0:k0 + MB].clone(), krow, pivd, rowof, k0, pick)
        piv = rowof[:, k0:k0 + MB]                       # (B, 32)
        R = W[lanes, piv].clone()                        # (B, 32, n) copy
        if inverse:
            R[:, :, k0:k0 + MB] = torch.eye(MB)
            base = W.clone()
            base[:, :, k0:k0 + MB] = (torch.arange(n)[None, :, None]
                                      == piv[:, None, :]).to(torch.float32)
            W = base - torch.bmm(G, R)
        else:
            c0 = k0 + MB
            T = torch.cat([W[:, :, c0:], Wb[:, :, None]], dim=2)
            Rt = torch.cat([R[:, :, c0:], Wb[lanes, piv][:, :, None]], dim=2)
            T = T - torch.bmm(G, Rt)
            W[:, :, c0:] = T[:, :, :-1]
            Wb = T[:, :, -1].clone()
    if inverse:
        X = torch.empty_like(W)
        cols = W.gather(2, krow[:, None, :].expand(B, n, n))  # W[r][krow[j]]
        X[lanes, krow] = cols / pivd[:, :, None]
        return X
    x = torch.empty_like(Wb)
    x[lanes, krow] = Wb / pivd
    return x


@pytest.mark.parametrize("case", ["random", "mna_border", "block_singular",
                                  "singular"])
@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("kind", ["inverse", "solve"])
def test_blocked_dataflow_matches_plain_jax_and_numpy(kind, n, case):
    B = 4
    A, b = system(case, B, n, seed=n + len(case))
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    if kind == "inverse":
        mine = blocked_gj(At).numpy()
        plain = gj.gj_inverse32_plain(At).numpy()
        jax_out = np.asarray(jgj.gj_inverse32(jnp.asarray(A)))
        ref = lambda M, v: np.linalg.inv(M.astype(np.float64))
    else:
        mine = blocked_gj(At, bt).numpy()
        plain = gj.gj_solve32_plain(At, bt).numpy()
        jax_out = np.asarray(jgj.gj_solve32(jnp.asarray(A), jnp.asarray(b)))
        ref = lambda M, v: np.linalg.solve(
            M.astype(np.float64), v.astype(np.float64)[..., None])[..., 0]
    assert mine.dtype == np.float32 and mine.shape == plain.shape
    s = singular_lane(B)
    good = [i for i in range(B) if case != "singular" or i != s]
    for out in (mine, plain, jax_out):
        assert np.isfinite(out[good]).all()
        if case == "singular":
            assert not np.isfinite(out[s]).all()
    assert lane_rel_err(mine[good], plain[good]).max() <= TOL
    assert lane_rel_err(mine[good], jax_out[good]).max() <= TOL
    assert lane_rel_err(mine[good], ref(A[good], b[good])).max() <= TOL


def test_inverse_column_map_holds_identity_columns_in_place():
    """After the last panel every physical column k holds the identity
    column of the row that step k pivoted: X = A^-1 follows from the
    gather alone, and A X = I to float32 accuracy."""
    A, _b = system("mna_border", 2, 128, seed=4)
    X = blocked_gj(torch.from_numpy(A)).numpy().astype(np.float64)
    eye = np.eye(128)
    assert np.abs(A.astype(np.float64) @ X - eye).max() <= 1e-4


@pytest.mark.parametrize("kind", ["inverse", "solve"])
def test_cluster_split_panel_matches_plain_and_numpy(kind):
    """n = 1152: the panel launch is a cluster of two blocks with 768 and
    384 rows; its merged pivot search gives the plain version's function."""
    n = 1152
    cs, rb = kernel_split(n)
    assert (cs, rb) == (2, 768)
    A, b = system("mna_border", 1, n, seed=21)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    pick = lambda col, krow: cluster_pick(col, krow, cs, rb)
    A64 = A.astype(np.float64)
    if kind == "inverse":
        mine = blocked_gj(At, pick=pick).numpy()
        plain = gj.gj_inverse32_plain(At).numpy()
        ref = np.linalg.inv(A64)
    else:
        mine = blocked_gj(At, bt, pick=pick).numpy()
        plain = gj.gj_solve32_plain(At, bt).numpy()
        ref = np.linalg.solve(A64, b.astype(np.float64)[..., None])[..., 0]
    assert np.isfinite(mine).all()
    assert lane_rel_err(mine, plain).max() <= TOL
    assert lane_rel_err(mine, ref).max() <= TOL


def test_cluster_merge_rule_ties_across_blocks_and_nan():
    """The merge takes the single-block rule: the largest |v|, a NaN above
    everything, a tie to the smallest row, across the blocks too."""
    n = 1152
    cs, rb = kernel_split(n)
    col = torch.zeros((1, n))
    krow = torch.full((1, n), -1, dtype=torch.int64)

    def both():
        r = int(cluster_pick(col, krow, cs, rb)[0])
        assert r == int(global_pick(col, krow)[0])
        return r

    assert both() == 0                       # all zero: the smallest row
    col[0, 900] = -5.0                       # block 1
    col[0, 700] = 5.0                        # block 0, equal |v|
    assert both() == 700
    krow[0, 700] = 3                         # pivoted rows drop out
    assert both() == 900
    col[0, 1000] = 7.0
    col[0, 1001] = 7.0                       # a tie inside one warp
    assert both() == 1000
    col[0, 1100] = float("nan")              # a NaN ranks above everything
    assert both() == 1100
    col[0, 5] = float("inf")                 # +inf ties a NaN: smaller row
    assert both() == 5
    krow[0, :] = 0
    krow[0, 1151] = -1                       # one unpivoted row, last block
    assert both() == 1151


@pytest.mark.parametrize("kind", ["inverse", "solve"])
def test_plain_matches_jax_past_1024(kind):
    """The plain versions (what the kernels are held to on the card)
    against the JAX package at n = 1152."""
    A, b = system("random", 1, 1152, seed=22)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    if kind == "inverse":
        plain = gj.gj_inverse32_plain(At).numpy()
        jax_out = np.asarray(jgj.gj_inverse32(jnp.asarray(A)))
    else:
        plain = gj.gj_solve32_plain(At, bt).numpy()
        jax_out = np.asarray(jgj.gj_solve32(jnp.asarray(A), jnp.asarray(b)))
    assert np.isfinite(plain).all() and np.isfinite(jax_out).all()
    assert lane_rel_err(plain, jax_out).max() <= TOL
