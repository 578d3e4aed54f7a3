"""Batched one-hot-pivot Gauss-Jordan in float32 (port of
``phy_engine_tpu/ops/gj.py``: ``gj_solve32`` / ``gj_inverse32``).

The algorithm is the reference's: no row swaps — at step k the pivot row
is *selected* as the largest |A[:, k]| among rows not yet pivoted (a tie
goes to the smallest row index), every other row is eliminated with a
rank-1 update, and at the end the answer is placed by the pivot map,
x[k] = W[r] / pivd[r] where krow[r] = k.  A singular lane yields
NaN/Inf and never raises; callers gate on isfinite.  ``pivd`` accumulates
as ``1 + (pivval - 1)`` in float32 exactly as the reference does.

``panel_factor`` / ``trailing_update`` are the panel step and the
rank-128 update of the mesh-distributed solver (``parallel/dist_gj.py``);
they are plain XLA in the JAX package and plain torch here.

``solve_batched`` is the dense batched solve around ``gj_solve32``:
power-of-two equilibration, padding to a multiple of 128, float64
residual refinement and a NaN reject of lanes whose residual stays above
``check_rtol`` (on a CUDA tensor every solve of it launches the kernel).

Two versions of each entry point:

* ``gj_solve32_plain`` / ``gj_inverse32_plain`` — plain torch, n rank-1
  steps on a working ``[A | RHS]`` (the TPU's 128/32 panel blocking is
  not copied: it is a layout for the MXU, not part of the algorithm).
* ``gj_solve32`` / ``gj_inverse32`` — the wrappers.  A CPU tensor goes to
  the plain version; a CUDA tensor launches the hand-written kernel of
  ``csrc/gj.cu`` or raises.  ``gj_solve32.launches`` and
  ``gj_inverse32.launches`` count the calls that reached the kernel.

The kernel eliminates 32-wide micro-panels on chip and applies each as
one rank-32 update (see ``csrc/gj.cu``), so it sums in another order than
the plain version's rank-1 steps: the two agree to ``gj_cases.TOL``, not
bit for bit, and a repeat run of the kernel is bit-identical.  Above
n = 1024 a panel launch is a thread-block cluster of up to eight blocks
a lane; the kernel takes n up to ``MAX_N`` and a 16-byte aligned
``A32``, and the wrapper raises ``ValueError`` on anything else.
"""

from __future__ import annotations

import torch

from ..trace import kernel_wrapper
from ._build import launcher

NB = 128          # n must be a multiple of this (the reference's panel)
MB = 32           # the kernel's micro-panel width (csrc/gj.cu)
MAX_N = 8192      # the largest n the kernel takes (a cluster of 8 blocks)

_NO_PIVOT = 2 ** 30


def _gj_eliminate(W, n: int):
    """n one-hot-pivot Gauss-Jordan steps, in place on W (B, n, m) f32.

    Returns (krow (B, n) int64, pivd (B, n) f32).  Column k is read only
    at step k, so each update touches the columns after it."""
    B = W.shape[0]
    rows = torch.arange(n, device=W.device)
    krow = torch.full((B, n), -1, dtype=torch.int64, device=W.device)
    pivd = torch.ones((B, n), dtype=torch.float32, device=W.device)
    for k in range(n):
        col = W[:, :, k]
        m = torch.where(krow < 0, col.abs(), -3e38)
        mmax = m.amax(dim=1, keepdim=True)
        r = torch.where(m == mmax, rows, _NO_PIVOT).amin(dim=1, keepdim=True)
        onehot = (rows == r).to(torch.float32)                  # (B, n)
        pivval = (onehot * col).sum(dim=1, keepdim=True)        # (B, 1)
        pivrow = torch.gather(
            W[:, :, k + 1:], 1,
            r.clamp(max=n - 1)[:, :, None].expand(-1, 1, W.shape[2] - k - 1))
        f = col / pivval * (1.0 - onehot)
        W[:, :, k + 1:] -= f[:, :, None] * pivrow
        krow = torch.where(onehot > 0.5, k, krow)
        pivd = pivd + onehot * (pivval - 1.0)
    return krow, pivd


def panel_factor(panel, krow, pivd, k0: int):
    """One-hot-pivot elimination of one (B, n, nb) column panel (the JAX
    package's ``panel_factor``, plain torch: it is XLA there too).

    Eliminates the panel's nb columns in sequence, each against the
    largest |value| among rows not yet pivoted (``krow < 0``; a tie goes
    to the smallest row index); each eliminated column is overwritten
    with its factor column, so the returned panel is the accumulated
    transform G (M = I - G·Oᵀ).  ``krow`` / ``pivd`` are the (B, n) pivot
    bookkeeping shared across panels (krow int, -1 = free); ``k0`` is the
    panel's global column offset.  Arithmetic follows the panel's dtype
    (f32 on the fast path; the distributed solver's validated fallback
    factors in f64), and pivots accumulate as ``1 + (p - 1)``.  Returns
    new (G, krow, pivd); the inputs are not modified."""
    B, n, nb = panel.shape
    panel = panel.clone()
    krow = krow.clone()
    pivd = pivd.clone()
    taken = krow >= 0
    for j in range(nb):
        col = panel[:, :, j]
        # the first largest |value| among free rows: argmax returns the
        # first index of the maximum (a NaN column picks its NaN)
        r = col.abs().masked_fill(taken, -3e38).argmax(dim=1, keepdim=True)
        pivval = torch.gather(col, 1, r)                        # (B, 1)
        pivrow = torch.gather(panel, 1, r[:, :, None].expand(-1, 1, nb))
        f = (col / pivval).scatter_(1, r, 0.0)
        panel -= f[:, :, None] * pivrow
        panel[:, :, j] = f
        taken.scatter_(1, r, True)
        krow.scatter_(1, r, k0 + j)
        pivd.scatter_add_(1, r, pivval - 1.0)
    return panel, krow, pivd


def trailing_update(O, G, T):
    """Rank-nb update ``T - G · (Oᵀ · T)`` of one trailing block.

    O: (B, n, nb) one-hot pivot selectors, G: (B, n, nb) factor panel,
    T: (B, n, m) trailing columns (or right-hand sides).  Two batched
    full-FP32 (or f64) matmuls in T's dtype; Oᵀ·T only selects rows, so
    it is exact."""
    acc = T.dtype
    R = torch.bmm(O.to(acc).transpose(1, 2), T)
    return T - torch.bmm(G.to(acc), R)


def _place(Y, krow, n: int):
    """out[:, krow[r]] = Y[:, r] (rows never pivoted are dropped)."""
    idx = torch.where(krow < 0, n, krow)
    shape = (Y.shape[0], n + 1) + Y.shape[2:]
    if Y.dim() == 3:
        idx = idx[:, :, None].expand(-1, -1, Y.shape[2])
    return Y.new_zeros(shape).scatter_(1, idx, Y)[:, :n]


def gj_solve32_plain(A32, b32):
    """Plain torch A x = b: A (B, n, n) f32, b (B, n) f32 -> x (B, n)."""
    n = A32.shape[1]
    W = torch.cat([A32, b32[:, :, None]], dim=2)
    krow, pivd = _gj_eliminate(W, n)
    return _place(W[:, :, n] / pivd, krow, n)


def gj_inverse32_plain(A32):
    """Plain torch A^-1: A (B, n, n) f32 -> (B, n, n) f32."""
    B, n, _ = A32.shape
    eye = torch.eye(n, dtype=torch.float32, device=A32.device)
    W = torch.cat([A32, eye.expand(B, n, n)], dim=2)
    krow, pivd = _gj_eliminate(W, n)
    return _place(W[:, :, n:] / pivd[:, :, None], krow, n)


def _check(A32, b32=None):
    if not isinstance(A32, torch.Tensor) or A32.dtype != torch.float32:
        raise TypeError("A32 must be a float32 tensor")
    if A32.dim() != 3 or A32.shape[1] != A32.shape[2] or A32.shape[0] < 1:
        raise ValueError(f"A32 must be (B, n, n), got {tuple(A32.shape)}")
    n = A32.shape[1]
    if n % NB:
        raise ValueError(f"n={n} is not a multiple of {NB}")
    if not A32.is_contiguous():
        raise ValueError("A32 must be contiguous")
    if b32 is not None:
        if not isinstance(b32, torch.Tensor) or b32.dtype != torch.float32:
            raise TypeError("b32 must be a float32 tensor")
        if tuple(b32.shape) != (A32.shape[0], n):
            raise ValueError(f"b32 must be (B, n) = ({A32.shape[0]}, {n}), "
                             f"got {tuple(b32.shape)}")
        if b32.device != A32.device:
            raise ValueError("A32 and b32 lie on different devices")
        if not b32.is_contiguous():
            raise ValueError("b32 must be contiguous")
    if A32.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {A32.device}")


def _scratch(A32, rhs_cols: int):
    """The kernel's scratch: W (B, n, n), G (B, n, MB), R (B, MB, n +
    rhs_cols) (the solve's b column and padding to 16 bytes), krow and
    rowof (B, n) int32, pivd (B, n)."""
    B, n, _ = A32.shape
    if n > MAX_N:
        raise ValueError(f"n={n}: the CUDA kernel takes n <= {MAX_N}")
    if A32.data_ptr() % 16:
        raise ValueError("A32 must be 16-byte aligned for the CUDA kernel")
    f32 = dict(dtype=torch.float32, device=A32.device)
    i32 = dict(dtype=torch.int32, device=A32.device)
    return (torch.empty((B, n, n), **f32), torch.empty((B, n, MB), **f32),
            torch.empty((B, MB, n + rhs_cols), **f32),
            torch.empty((B, n), **i32), torch.empty((B, n), **f32),
            torch.empty((B, n), **i32))


@kernel_wrapper
def gj_solve32(A32, b32):
    """f32 batched solve A x = b; A (B, n, n), b (B, n); n % 128 == 0."""
    _check(A32, b32)
    if A32.device.type == "cpu":
        return gj_solve32_plain(A32, b32)
    B, n, _ = A32.shape
    W, G, R, krow, pivd, rowof = _scratch(A32, 4)
    Wb = torch.empty((B, n), dtype=torch.float32, device=A32.device)
    x = torch.empty((B, n), dtype=torch.float32, device=A32.device)
    with launcher(A32.device) as launch:
        launch("pe_gj_solve32", A32, b32, W, Wb, G, R, krow, pivd, rowof, x,
               B, n)
    gj_solve32.launches += 1
    return x


@kernel_wrapper
def gj_inverse32(A32):
    """Batched f32 inverse; A (B, n, n), n % 128 == 0.  Singular lanes
    yield NaN/Inf entries (callers residual-check)."""
    _check(A32)
    if A32.device.type == "cpu":
        return gj_inverse32_plain(A32)
    B, n, _ = A32.shape
    W, G, R, krow, pivd, rowof = _scratch(A32, 0)
    X = torch.empty((B, n, n), dtype=torch.float32, device=A32.device)
    with launcher(A32.device) as launch:
        launch("pe_gj_inverse32", A32, W, G, R, krow, pivd, rowof, X, B, n)
    gj_inverse32.launches += 1
    return X


def pow2_recip_floor(x):
    """exp2(-floor(log2(x))) for positive float32 / float64 x, exact: the
    power of two is built from x's binary exponent (frexp) instead of a
    rounded log2 (XLA's CPU exp2 is inexact for |e| >= 13)."""
    mant, bias, itype = {torch.float32: (23, 127, torch.int32),
                         torch.float64: (52, 1023, torch.int64)}[x.dtype]
    _m, e = torch.frexp(x)                  # x = m 2^e, 0.5 <= m < 1
    biased = (bias + 1 - e).clamp(1, 2 * bias).to(itype)    # 2^(1 - e)
    pow2 = (biased << mant).view(x.dtype)
    return torch.where(torch.isfinite(x), pow2,
                       torch.exp2(-torch.floor(torch.log2(x))))


def solve_batched(A, b, refine: int = 2, check: bool = True,
                  check_rtol: float = 1e-6):
    """Batched dense solve with equilibration and f64 refinement (port of
    the JAX package's ``ops/gj.py::solve_batched``).

    A (B, n, n), b (B, n), any float dtype; returns x in A's dtype.  Rows,
    then columns, are scaled by exact powers of two; n is padded to a
    multiple of 128 with identity rows; ``gj_solve32`` solves in f32 and
    ``refine`` fixed f64 residual passes recover ~f64 accuracy for an
    equilibrated condition up to ~1e7.  ``check``: lanes whose final
    relative residual exceeds ``check_rtol`` come back NaN, for the
    callers' isfinite guards."""
    B, n, _ = A.shape
    out_dtype = A.dtype
    f64 = torch.float64
    A = A.to(f64)
    b = b.to(f64)
    r = pow2_recip_floor(A.abs().amax(dim=2).clamp(min=1e-300))
    A = A * r[:, :, None]
    c = pow2_recip_floor(A.abs().amax(dim=1).clamp(min=1e-300))
    A = A * c[:, None, :]
    b = b * r
    npad = max(NB, -(-n // NB) * NB)
    if npad != n:
        Ap = A.new_zeros((B, npad, npad))
        Ap[:, :n, :n] = A
        pad = torch.arange(n, npad, device=A.device)
        Ap[:, pad, pad] = 1.0
        A = Ap
        b = torch.cat([b, b.new_zeros((B, npad - n))], dim=1)
    A32 = A.to(torch.float32).contiguous()
    x = gj_solve32(A32, b.to(torch.float32).contiguous()).to(f64)
    for _ in range(refine):
        resid = b - torch.einsum("bij,bj->bi", A, x)
        x = x + gj_solve32(A32, resid.to(torch.float32).contiguous()).to(f64)
    if check:
        resid = b - torch.einsum("bij,bj->bi", A, x)
        scale = torch.maximum(b.abs().amax(dim=1),
                              A.abs().amax(dim=(1, 2)) * x.abs().amax(dim=1))
        bad = resid.abs().amax(dim=1) > check_rtol * scale.clamp(min=1e-30)
        x = torch.where(bad[:, None], torch.full_like(x, float("nan")), x)
    return (x[:, :n] * c).to(out_dtype)
