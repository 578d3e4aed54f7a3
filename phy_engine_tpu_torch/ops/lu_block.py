"""Batched blocked right-looking Gauss-Jordan inverse in float32 (port of
``phy_engine_tpu/ops/lu_block.py``: ``lu_block_inverse32``).

The algorithm is the reference's.  W = [A | I] is processed one nb x nb
diagonal block at a time:

* the diagonal block D is inverted by one-hot Gauss-Jordan whose pivot
  search is confined to the block's own rows (the largest |col| among
  the block's unpivoted rows, a tie to the smallest row index; ``pivd``
  accumulates as ``1 + (pivval - 1)`` in float32, as the reference does),
  and the inverse is placed by the pivot map, Dinv[k] = Y[r] / pivd[r]
  where krow[r] == k;
* one composed product applies the whole block step,
  G = (C·rmask − S)·Dinv + S, then W −= G·Wb (C the block's columns, Wb
  its rows, S the one-hot placement of the block rows, rmask zeroing
  them): other rows are eliminated, the block rows normalised.

Pivoting never leaves the diagonal block, so a lane whose leading block
is singular (say all zero, while the whole matrix is not) comes out
non-finite; callers gate on isfinite, as for ``ops.gj``.

Two versions:

* ``lu_block_inverse32_plain`` — plain torch, the reference's steps with
  ``torch.bmm`` at full float32 (TF32 off, see the package's
  ``__init__``); any nb that divides n.
* ``lu_block_inverse32`` — the wrapper.  A CPU tensor goes to the plain
  version; a CUDA tensor launches the hand-written kernel of
  ``csrc/lu_block.cu`` (nb = 32 only, any n % 32 == 0) or raises.
  ``lu_block_inverse32.launches`` counts the calls that reached the
  kernel.  The reference's ``lu_block_inverse32_auto`` /
  ``lu_block_inverse32_pallas`` have no counterpart: the wrapper's device
  rule takes their place.

The kernel composes each 128-wide super-panel's four block steps into one
rank-128 update (see ``csrc/lu_block.cu``), so it sums in another order
than the plain version: the two agree to ``gj_cases.TOL``, not bit for
bit, and a repeat run of the kernel is bit-identical.
"""

from __future__ import annotations

import torch

from ..trace import kernel_wrapper
from ._build import launcher

NB_BLOCK = 32     # diagonal block = pivot scope; the kernel's only nb
SUPER = 128       # the kernel's widest super-panel: rows of its U^T and R

_NO_PIVOT = 2 ** 30


def _block_inv32(D):
    """Explicit inverses of (B, nb, nb) f32 blocks by one-hot-pivot GJ
    with the pivot search confined to the block (nb serial steps on the
    (B, nb, 2nb) working tile).  Singular blocks give NaN/Inf."""
    B, nb, _ = D.shape
    dev = D.device
    eye = torch.eye(nb, dtype=torch.float32, device=dev).expand(B, nb, nb)
    W = torch.cat([D, eye], dim=2)
    rows = torch.arange(nb, device=dev)
    krow = torch.full((B, nb), -1, dtype=torch.int64, device=dev)
    pivd = torch.ones((B, nb), dtype=torch.float32, device=dev)
    for j in range(nb):
        col = W[:, :, j]
        m = torch.where(krow < 0, col.abs(), -3e38)
        mmax = m.amax(dim=1, keepdim=True)
        r = torch.where(m == mmax, rows, _NO_PIVOT).amin(dim=1, keepdim=True)
        onehot = (rows == r).to(torch.float32)                  # (B, nb)
        pivval = (onehot * col).sum(dim=1, keepdim=True)        # (B, 1)
        pivrow = (onehot[:, :, None] * W).sum(dim=1)            # (B, 2nb)
        f = col / pivval * (1.0 - onehot)
        W = W - f[:, :, None] * pivrow[:, None, :]
        krow = torch.where(onehot > 0.5, j, krow)
        pivd = pivd + onehot * (pivval - 1.0)
    Y = W[:, :, nb:] / pivd[:, :, None]
    P = (rows[None, :, None] == krow[:, None, :]).to(torch.float32)  # (B, k, r)
    return torch.bmm(P, Y)


def lu_block_inverse32_plain(A32, nb: int = NB_BLOCK):
    """Plain torch A^-1: A (B, n, n) f32 -> (B, n, n) f32, n % nb == 0."""
    B, n, _ = A32.shape
    dev = A32.device
    eye = torch.eye(n, dtype=torch.float32, device=dev)
    W = torch.cat([A32, eye.expand(B, n, n)], dim=2)             # (B, n, 2n)
    rit = torch.arange(n, device=dev)
    cit = torch.arange(nb, device=dev)
    for k0 in range(0, n, nb):
        Wb = W[:, k0:k0 + nb, :]
        Dinv = _block_inv32(Wb[:, :, k0:k0 + nb])
        C = W[:, :, k0:k0 + nb]
        rmask = ((rit < k0) | (rit >= k0 + nb)).to(torch.float32)
        S = (rit[:, None] == k0 + cit).to(torch.float32)         # (n, nb)
        G = torch.bmm(C * rmask[None, :, None] - S, Dinv) + S
        W = W - torch.bmm(G, Wb)
    return W[:, :, n:]


def _check(A32, nb: int):
    if not isinstance(A32, torch.Tensor) or A32.dtype != torch.float32:
        raise TypeError("A32 must be a float32 tensor")
    if A32.dim() != 3 or A32.shape[1] != A32.shape[2] or A32.shape[0] < 1:
        raise ValueError(f"A32 must be (B, n, n), got {tuple(A32.shape)}")
    n = A32.shape[1]
    if nb < 1 or n % nb:
        raise ValueError(f"n={n} is not a multiple of nb={nb}")
    if not A32.is_contiguous():
        raise ValueError("A32 must be contiguous")
    if A32.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {A32.device}")


@kernel_wrapper
def lu_block_inverse32(A32, nb: int = NB_BLOCK):
    """Batched f32 inverse by blocked Gauss-Jordan; A (B, n, n), n % nb
    == 0 (nb = 32 on the card).  A singular leading diagonal block makes
    the lane non-finite (callers residual-check)."""
    _check(A32, nb)
    if A32.device.type == "cpu":
        return lu_block_inverse32_plain(A32, nb)
    if nb != NB_BLOCK:
        raise ValueError(f"the CUDA kernel takes nb={NB_BLOCK} only, got {nb}")
    if A32.data_ptr() % 16:
        raise ValueError("A32 must be 16-byte aligned for the CUDA kernel")
    B, n, _ = A32.shape
    f32 = dict(dtype=torch.float32, device=A32.device)
    X = torch.empty((B, n, n), **f32)
    Ut = torch.empty((B, SUPER, n), **f32)      # U^T of each super-panel
    R = torch.empty((2, B, SUPER, n), **f32)    # its rows before it
    with launcher(A32.device) as launch:
        # the panel's global scratch where it does not fit on chip (n > 6144)
        pf = launch.query("pe_lu_block_panel_floats", B, n)
        P = torch.empty(pf, **f32) if pf else None
        launch("pe_lu_block_inverse32", A32, X, Ut, R, P, B, n)
    lu_block_inverse32.launches += 1
    return X
