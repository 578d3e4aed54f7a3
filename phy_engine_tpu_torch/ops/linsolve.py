"""Dense solvers for MNA systems (port of ``phy_engine_tpu/ops/
linsolve.py``).

* ``lu_solve_gauss`` — partial-pivoted Gauss-Jordan elimination as n
  rank-1 steps over a leading batch dimension: pivot on the largest
  |A[i, k]| among i >= k (first index on a tie, as ``argmax``), swap rows
  k and p, eliminate every other row.  MNA voltage-source rows have
  structural-zero diagonals, so pivoting is mandatory; a singular system
  yields NaN/Inf, which the Newton driver's isfinite guard detects.  It
  is the f64 tier of the 'hybrid' Newton solver and the dense solve of
  the ``Circuit`` driver.
* ``dense_solve`` — the dtype dispatch: ``torch.linalg.solve`` for
  float32 / complex64 (as the JAX package sends them to
  ``jnp.linalg.solve``), ``lu_solve_gauss`` otherwise.  Where an input
  requires grad (the sensitivity analysis), the f64 solve runs through
  :class:`GaussSolve`, whose backward pass is one transposed solve.

Both take a system ``(n, n)`` + ``(n,)`` or a batch ``(B, n, n)`` +
``(B, n)``.
"""

from __future__ import annotations

import torch


def lu_solve_gauss(A, b):
    """Solve A x = b by partial-pivoted Gauss-Jordan elimination in A's
    dtype; A (B, n, n) and b (B, n), or one unbatched system."""
    if A.dim() == 2:
        return lu_solve_gauss(A[None], b[None])[0]
    B, n, _ = A.shape
    A = A.clone()
    b = b.clone()
    ar = torch.arange(n, device=A.device)
    lanes = torch.arange(B, device=A.device)
    for k in range(n):
        col = torch.where(ar < k, -torch.inf, A[:, :, k].abs())
        p = torch.argmax(col, dim=1)                            # (B,)
        # swap rows k <-> p (p >= k): the same permutation as the JAX
        # package's whole-matrix gather, moving two rows a lane
        row_p, b_p = A[lanes, p], b[lanes, p]
        A[lanes, p] = A[:, k].clone()
        A[:, k] = row_p
        b[lanes, p] = b[:, k].clone()
        b[:, k] = b_p
        factors = A[:, :, k] / A[:, k, k, None]
        factors[:, k] = 0.0
        A -= factors[:, :, None] * A[:, k, None, :]
        b -= factors * b[:, k, None]
    return b / torch.diagonal(A, dim1=1, dim2=2)


class GaussSolve(torch.autograd.Function):
    """``lu_solve_gauss`` with the adjoint of a linear solve: for x =
    A^-1 b and an output gradient g, the backward pass solves A^T lam = g
    with the same elimination and returns -lam x^T for A and lam for b.
    (The JAX package differentiates through the elimination itself; the
    two are the same derivative, equal to rounding.)"""

    @staticmethod
    def forward(ctx, A, b):
        x = lu_solve_gauss(A, b)
        ctx.save_for_backward(A, x)
        return x

    @staticmethod
    def backward(ctx, g):
        A, x = ctx.saved_tensors
        lam = lu_solve_gauss(A.transpose(-1, -2), g)
        return -lam[..., :, None] * x[..., None, :], lam


def dense_solve(A, b):
    """Dtype-dispatching dense solve (see the module docstring)."""
    if A.dtype in (torch.float32, torch.complex64):
        return torch.linalg.solve(A, b)
    if torch.is_grad_enabled() and (A.requires_grad or b.requires_grad):
        return GaussSolve.apply(A, b)
    return lu_solve_gauss(A, b)
