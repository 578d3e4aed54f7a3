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
placement x[krow[r]] = Wb[r] / pivd[r].  The emulation is held against the
plain versions ``gj_*_plain``, the JAX package's ``gj_inverse32`` /
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


def _panel(P, krow, pivd, rowof, k0):
    """The panel launch: 32 one-hot pivot steps on the (B, n, 32) panel,
    each slot keeping its factor column.  Updates krow / pivd / rowof in
    place and returns G."""
    B, n, _ = P.shape
    rows = torch.arange(n)
    lanes = torch.arange(B)
    for j in range(MB):
        col = P[:, :, j]
        key = torch.where(krow >= 0, torch.tensor(-3e38),
                          torch.where(torch.isnan(col), torch.tensor(np.inf),
                                      col.abs()))
        best = key.amax(dim=1, keepdim=True)
        r = torch.where(key == best, rows, _BIG).amin(dim=1)
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


def blocked_gj(A, b=None):
    """The kernels' dataflow: the inverse when ``b`` is None, else the
    solve.  A (B, n, n), b (B, n) float32 tensors."""
    B, n, _ = A.shape
    inverse = b is None
    lanes = torch.arange(B)[:, None]
    W = A.clone()                        # the kernel reads A at k0 = 0
    Wb = None if inverse else b.clone()
    krow = torch.full((B, n), -1, dtype=torch.int64)
    pivd = torch.ones((B, n), dtype=torch.float32)
    rowof = torch.zeros((B, n), dtype=torch.int64)
    for k0 in range(0, n, MB):
        G = _panel(W[:, :, k0:k0 + MB].clone(), krow, pivd, rowof, k0)
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
