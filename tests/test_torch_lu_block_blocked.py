"""CPU rehearsal of the dataflow of ``phy_engine_tpu_torch/ops/csrc/lu_block.cu``.

The CUDA kernel cannot run here, so this file carries a torch emulation of
its dataflow as the kernel takes it: super-panels of w = 128 columns (the
last 32, 64 or 96 wide when n % 128 != 0; 64 and 32 where the kernel
narrows them for large n); per super-panel R = X[s0:s0+w, :] as it
stands before the super-panel (the kernel's launches of the super-panel
before write it to a second buffer), the n x w column panel's rows split
over the blocks of a cluster,
and per 32-wide block step the owner's diagonal chain (in place on 32
slots a row, each pivot column taking the identity column of its pivot
row) with Dinv and the block rows Wb handed to every block, each block
applying base - G Wb to its own rows; then U = the panel, written into
X's super-panel columns, and over the other columns X <- X + U R outside
the super-panel's rows and U R on them (T = I + (U - E) E^T with E^T X =
R, so no E is subtracted from U).
The emulation is held against ``lu_block_inverse32_plain``, the JAX
package's ``lu_block_inverse32`` (its XLA path on the CPU) and float64
numpy, on the four ``gj_cases`` systems.

Tolerance: ``gj_cases.TOL`` (1e-4) relative to max|x| of the lane, since
the super-panel's rank-128 update sums the block steps' terms in another
order than the plain version's one step at a time.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phy_engine_tpu.ops import lu_block as jlu

from phy_engine_tpu_torch.ops import lu_block
from phy_engine_tpu_torch.ops.gj_cases import TOL, lane_rel_err, singular_lane, system

torch.set_num_threads(1)

NB = lu_block.NB_BLOCK
_BIG = 2 ** 30


def kernel_split(n: int):
    """The kernel's row split (``make_plan`` in lu_block.cu): cs =
    min(8, ceil(n / 256)) blocks of rb = ceil(n / cs) rows rounded up to a
    multiple of 32."""
    cs = min(8, max(1, -(-n // 256)))
    rb = -(-(-(-n // cs)) // NB) * NB
    return cs, rb


def kernel_plan(n: int, smem_limit: int = 227 * 1024):
    """The kernel's plan (``make_plan`` in lu_block.cu): (w, cs, rb,
    onchip), the widest w of 128, 64, 32 whose panel, G and the published
    tiles (``Layout``) fit one block's shared memory, else w = 128 with the
    panel and G in global scratch."""
    cs, rb = kernel_split(n)
    for w in (128, 64, 32):
        small = 2 * NB * w + 2 * NB * NB + NB * (NB + 1) + NB
        big = rb * (w + 4) + NB * rb
        if 4 * (small + big) <= smem_limit:
            return w, cs, rb, True
    return 128, cs, rb, False


def diag_chain(D):
    """The owner warp's chain on (B, 32, 32) diagonal blocks: one-hot
    pivot steps confined to the block, in place on 32 slots a row (slot j
    holds D's column j until step j, then the right half's column of the
    step's pivot row, e_r - f).  Products and differences round apart
    here, as in the reference; the kernel fuses them (one rounding).
    Returns Dinv[k][c] = T[rowof[k]][krow[c]] / pivd[rowof[k]]."""
    B = D.shape[0]
    T = D.clone()
    rows = torch.arange(NB)
    lanes = torch.arange(B)
    kr = torch.full((B, NB), -1, dtype=torch.int64)
    pd = torch.ones((B, NB), dtype=torch.float32)
    for j in range(NB):
        col = T[:, :, j]
        key = torch.where(kr >= 0, torch.tensor(-1.0),
                          torch.where(torch.isnan(col), torch.tensor(np.inf),
                                      col.abs()))
        best = key.amax(dim=1, keepdim=True)
        r = torch.where(key == best, rows, _BIG).amin(dim=1)
        prow = T[lanes, r].clone()                       # before the step
        p = prow[:, j:j + 1]
        onehot = rows[None, :] == r[:, None]
        f = (col / p) * (~onehot).to(torch.float32)
        T = T - f[:, :, None] * prow[:, None, :]
        T[:, :, j] = onehot.to(torch.float32) - f
        kr[onehot] = j
        pd[onehot] = (1.0 + (p - 1.0)).expand(-1, NB)[onehot]
    rowof = torch.argsort(kr, dim=1)                     # step -> row
    slots = T.gather(2, kr[:, None, :].expand(B, NB, NB))  # [r][c] = T[r][krow[c]]
    Y = slots / pd[:, :, None]
    return Y.gather(1, rowof[:, :, None].expand(B, NB, NB))


def blocked_lu(A, w: int = 128, split=None):
    """The kernel's dataflow on A (B, n, n) float32; ``split`` = (cs, rb),
    the kernel's when None."""
    B, n, _ = A.shape
    cs, rb = kernel_split(n) if split is None else split
    assert rb % NB == 0 and cs * rb >= n
    blocks = [(c * rb, min(n, (c + 1) * rb)) for c in range(cs)]
    X = A.clone()
    eye = torch.eye(NB)
    for s0 in range(0, n, w):
        ws = min(w, n - s0)
        R = X[:, s0:s0 + ws, :].clone()
        P = [X[:, lo:hi, s0:s0 + ws].clone() for lo, hi in blocks]
        for i in range(ws // NB):
            q0 = NB * i
            k0 = s0 + q0
            owner = k0 // rb
            lk = k0 - blocks[owner][0]
            Dinv = diag_chain(P[owner][:, lk:lk + NB, q0:q0 + NB])
            Wb = P[owner][:, lk:lk + NB, :].clone()
            Wb[:, :, q0:q0 + NB] = eye
            for c, (lo, hi) in enumerate(blocks):
                rows = torch.arange(lo, hi)
                diag = (rows >= k0) & (rows < k0 + NB)
                G = torch.bmm(P[c][:, :, q0:q0 + NB], Dinv)
                G[:, diag] = -Dinv[:, rows[diag] - k0]
                base = P[c].clone()
                base[:, diag] = 0.0
                base[:, :, q0:q0 + NB] = 0.0
                P[c] = base - torch.bmm(G, Wb)
        U = torch.cat(P, dim=1)                              # (B, n, ws)
        out = torch.ones(n, dtype=torch.bool)
        out[s0:s0 + ws] = False
        base = X[:, :, out]
        base[:, s0:s0 + ws] = 0.0
        X[:, :, out] = base + torch.bmm(U, R[:, :, out])
        X[:, :, s0:s0 + ws] = U
    return X


def _hold(A, mine):
    """The emulation against the plain version, the JAX package and
    numpy; the same lanes non-finite in all three."""
    At = torch.from_numpy(A)
    plain = lu_block.lu_block_inverse32_plain(At).numpy()
    jax_out = np.asarray(jlu.lu_block_inverse32(jnp.asarray(A)))
    assert mine.dtype == np.float32 and mine.shape == A.shape
    fin = [np.isfinite(o).reshape(len(A), -1).all(axis=1)
           for o in (mine, plain, jax_out)]
    assert (fin[0] == fin[1]).all() and (fin[0] == fin[2]).all()
    good = np.flatnonzero(fin[0])
    ref = np.linalg.inv(A[good].astype(np.float64))
    assert lane_rel_err(mine[good], plain[good]).max() <= TOL
    assert lane_rel_err(mine[good], jax_out[good]).max() <= TOL
    assert lane_rel_err(mine[good], ref).max() <= TOL
    return fin[0]


@pytest.mark.parametrize("case", ["random", "mna_border", "singular",
                                  "block_singular"])
@pytest.mark.parametrize("n", [32, 96, 128, 160, 256, 512])
def test_super_panel_dataflow_matches_plain_jax_and_numpy(n, case):
    B = 3 if n == 512 else 4
    A, _b = system(case, B, n, seed=n + len(case))
    fin = _hold(A, blocked_lu(torch.from_numpy(A)).numpy())
    s = singular_lane(B)
    assert fin[[i for i in range(B) if i != s]].all()
    assert fin[s] == (case in ("random", "mna_border"))


@pytest.mark.parametrize("n,w,split", [(160, 128, (2, 96)),
                                       (512, 128, (3, 192)),
                                       (416, 64, (2, 224)),
                                       (288, 32, (3, 96)),
                                       (480, 128, (8, 64))],
                         ids=["160_uneven", "512_three_blocks", "416_w64",
                              "288_w32", "480_eight_blocks"])
def test_cluster_splits_and_narrow_super_panels(n, w, split):
    """Row splits with a short last block and the narrower super-panels
    the kernel takes for large n give the same function."""
    A, _b = system("mna_border", 2, n, seed=n)
    _hold(A, blocked_lu(torch.from_numpy(A), w=w, split=split).numpy())


def test_kernel_split_follows_the_plan():
    """One block to n = 256, then blocks of at most 256 rows up to eight,
    each a multiple of 32 rows; every diagonal block in one block."""
    assert kernel_split(256) == (1, 256)
    assert kernel_split(96) == (1, 96)
    assert kernel_split(512) == (2, 256)
    assert kernel_split(1024) == (4, 256)
    assert kernel_split(1152) == (5, 256)
    assert kernel_split(2048) == (8, 256)
    assert kernel_split(3072) == (8, 384)


@pytest.mark.parametrize("n,plan", [(256, (128, 1, 256, True)),
                                    (2048, (128, 8, 256, True)),
                                    (2080, (64, 8, 288, True)),
                                    (3840, (64, 8, 480, True)),
                                    (3872, (32, 8, 512, True)),
                                    (6144, (32, 8, 768, True)),
                                    (6176, (128, 8, 800, False)),
                                    (16384, (128, 8, 2048, False))])
def test_kernel_plan_narrows_then_moves_the_panel_off_chip(n, plan):
    """At 227 KB of shared memory a block: 128-wide super-panels on chip
    to n = 2048, 64 to 3840, 32 to 6144; past that the panel lies in
    global scratch, 128 wide, for any n (the eight-block split with a
    short last block is ``480_eight_blocks`` above)."""
    assert kernel_plan(n) == plan


def test_diag_chain_matches_the_reference_block_inverse():
    """The in-place slot map is the reference's [D | I] elimination: with
    the same rounding, bit for bit against ``_block_inv32``."""
    rng = np.random.default_rng(5)
    D = (rng.standard_normal((6, NB, NB)) + 3 * np.eye(NB)).astype(np.float32)
    D[2, :, 4] = 0.0                                   # a singular block
    Dt = torch.from_numpy(D)
    mine, ref = diag_chain(Dt), lu_block._block_inv32(Dt)
    ok = [0, 1, 3, 4, 5]
    assert torch.equal(mine[ok], ref[ok])
    assert not torch.isfinite(mine[2]).all() and not torch.isfinite(ref[2]).all()
