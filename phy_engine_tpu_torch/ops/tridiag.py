"""Tridiagonal solvers for ladder-shaped MNA systems (port of
``phy_engine_tpu/ops/tridiag.py``).

The reference's largest benchmark netlists are series resistor ladders
(benchmark/0001.models/1000000xR.cpp, 100000000xR.cpp): the MNA is
tridiagonal plus one voltage-source border row / column.  Three solvers:

* ``tridiag_solve`` — parallel cyclic reduction (PCR): ceil(log2 N)
  rounds of shifts and fused multiply-adds, no sequential dependence;
  ``PCRFactor`` keeps PCR's right-side-independent rounds
  (``_pcr_rounds``, which both share) for repeated solves with one T
  (the sparse route's chain preconditioner in float32, ``ops/sparse.py``).
* ``PartitionFactor`` — a partitioned solve for one T shared by every
  lane, or for one T a lane: Thomas within chunks of ``PART_M`` rows, the
  chunks' separators a smaller tridiagonal system of the same kind,
  recursively.  On a CUDA tensor it is the hand-written kernel of
  ``csrc/tridiag_part.cu`` (``tridiag_part64``, its shared and per-lane
  forms); its plain twin ``part_factor_plain`` / ``part_solve_plain``
  serves CPU tensors.  ``border_solve`` solves its shared T through it on
  every device, the chain preconditioner its float64 band.
* ``SpikeFactor`` — chunked (SPIKE) elimination for N in the 1e8 range:
  C chunks of M rows, each solved by Thomas, whose pivots come from a
  sequential recurrence (on the device, ``_thomas_factor``, or in true
  host float64, ``spike_host_pivots``) and whose substitutions are
  first-order linear recurrences evaluated by a log-depth scan
  (``_linrec_scan``); the 2C x 2C reduced interface system is banded and
  LU-factored once on the host (LAPACK ``dgbtrf`` / ``dgbtrs`` through
  scipy).

Every bordered solve (``border_solve``, ``border_solve_part``,
``spike_border_solve`` and its unit-vector form) is one Schur complement
with residual refinement passes, ``_bordered``, over its factor's solve.

Everything else is torch ops in the input dtype (float64 for the
ladders) over arbitrary leading batch dimensions (the JAX package has no
Pallas kernel here).  ``lax.scan`` / ``lax.map``
become host loops; ``jax.lax.associative_scan`` becomes a Kogge-Stone
scan (``_linrec_scan``), which rounds differently from XLA's odd-even
scan, so results agree with the JAX package to a tolerance, not bit for
bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..trace import kernel_wrapper, span, spanned
from ._build import launcher


def _shift_down(a, s, fill):
    """out[i] = a[i-s] (out[:s] = fill)."""
    if s == 0:
        return a
    pad = a.new_full(a.shape[:-1] + (s,), fill)
    return torch.cat([pad, a[..., :-s]], dim=-1)


def _shift_up(a, s, fill):
    """out[i] = a[i+s] (out[-s:] = fill)."""
    if s == 0:
        return a
    pad = a.new_full(a.shape[:-1] + (s,), fill)
    return torch.cat([a[..., s:], pad], dim=-1)


def _corners_dropped(dl, du):
    """dl and du with ``dl[..., 0]`` and ``du[..., -1]`` zeroed by slices:
    no scalar is written into a tensor, so nothing waits for the device.
    dl and du share one shape (..., N)."""
    zero = dl.new_zeros(dl.shape[:-1] + (1,))
    return (torch.cat([zero, dl[..., 1:]], dim=-1),
            torch.cat([du[..., :-1], zero], dim=-1))


def _pcr_rounds(dl, d, du):
    """PCR's a / c / d recursion, which does not depend on the right
    side, one round at a time: yields (s, alpha, gamma, d) for s = 1, 2,
    4, ... below N, d the diagonal after the round."""
    n = d.shape[-1]
    a, c = _corners_dropped(dl, du)
    s = 1
    while s < n:
        alpha = -a / _shift_down(d, s, 1.0)
        gamma = -c / _shift_up(d, s, 1.0)
        a_new = alpha * _shift_down(a, s, 0.0)
        c_new = gamma * _shift_up(c, s, 0.0)
        d = (d + alpha * _shift_down(c, s, 0.0)
             + gamma * _shift_up(a, s, 0.0))
        a, c = a_new, c_new
        yield s, alpha, gamma, d
        s *= 2


@spanned("pe.pcr")
def tridiag_solve(dl, d, du, b):
    """Solve T x = b for tridiagonal T (sub dl, diag d, super du) by PCR.

    ``dl[..., 0]`` and ``du[..., -1]`` are ignored.  All arrays share the
    shape (..., N) (a leading dimension of 1 broadcasts); the solve
    vectorizes over the leading axes, holding one round at a time.  PCR
    is stable for the diagonally dominant systems MNA produces; a
    singular system yields inf / nan."""
    x, dd = b, d
    for s, alpha, gamma, dd in _pcr_rounds(dl, d, du):
        x = (x + alpha * _shift_down(x, s, 0.0)
             + gamma * _shift_up(x, s, 0.0))
    return x / dd


class PCRFactor:
    """``tridiag_solve`` for one T and many right sides: the a / c / d
    recursion runs once here, keeping each round's (alpha, gamma) and the
    final diagonal; ``solve`` runs only the right side's recursion.

    dl, d, du share one shape (..., N); ``dl[..., 0]`` and ``du[..., -1]``
    are ignored (dropped by slices: neither the factor nor a solve waits
    for the device).  Holds 2 ceil(log2 N) arrays of T's shape."""

    def __init__(self, dl, d, du):
        self.rounds, self.d = [], d
        for s, alpha, gamma, dd in _pcr_rounds(dl, d, du):
            self.rounds.append((s, alpha, gamma))
            self.d = dd

    def solve(self, b):
        """T^-1 b for b (..., N) broadcasting against the factor's shape
        (a factor of (B, N) solves (k, B, N) at once).  A round is a copy
        of its first s entries and two multiply-adds on slices, in
        ``tridiag_solve``'s order: x + alpha x[i - s], then + gamma
        x[i + s] (alpha is 0 on the first s entries, gamma on the last
        s)."""
        x = b.expand(torch.broadcast_shapes(b.shape, self.d.shape))
        for s, alpha, gamma in self.rounds:
            y = torch.empty_like(x)
            y[..., :s] = x[..., :s]
            torch.addcmul(x[..., s:], alpha[..., s:], x[..., :-s],
                          out=y[..., s:])
            y[..., :-s].addcmul_(gamma[..., :-s], x[..., s:])
            x = y
        return x / self.d


def tridiag_matvec(dl, d, du, x):
    """y = T x for tridiagonal T (same layout as tridiag_solve)."""
    a, c = _corners_dropped(dl, du)
    return d * x + a * _shift_down(x, 1, 0.0) + c * _shift_up(x, 1, 0.0)


def _linrec_scan(coef, add, reverse=False):
    """First-order linear recurrence y_i = add_i + coef_i * y_{i-1} (or,
    ``reverse``, y_i = add_i + coef_i * y_{i+1}) over axis -1.

    A Kogge-Stone scan: log2(M) rounds, each combining every element with
    the one 2^k before it, elements (a, b) composing as (a1 a2, b1 a2 +
    b2) — the JAX package's operator.  For the same-sign coefficient
    chains tridiagonal M-matrices give there is no cancellation, so it
    keeps sequential Thomas's componentwise stability.  The last round
    leaves the coefficient products alone (nothing reads them)."""
    a, b = coef, add
    m = a.shape[-1]
    s = 1
    while s < m:
        last = 2 * s >= m
        if not reverse:
            b = torch.cat([b[..., :s], b[..., :-s] * a[..., s:] + b[..., s:]],
                          dim=-1)
            if not last:
                a = torch.cat([a[..., :s], a[..., :-s] * a[..., s:]], dim=-1)
        else:
            b = torch.cat([b[..., s:] * a[..., :-s] + b[..., :-s],
                           b[..., -s:]], dim=-1)
            if not last:
                a = torch.cat([a[..., s:] * a[..., :-s], a[..., -s:]],
                              dim=-1)
        s *= 2
    return b


class ThomasChunks:
    """Batched tridiagonal LU (Thomas) over a (C, M) chunk layout.

    The pivot recurrence d'_i = d_i - w_i du_{i-1} is sequential: it runs
    once, either on the device (``_thomas_factor``, M steps vectorized over
    the C chunks) or, given ``dp``, from a pivot table computed in host
    float64 (``spike_host_pivots``), from which w, 1/d' and t follow
    elementwise.  Each solve's forward and backward substitutions are
    first-order linear recurrences evaluated by ``_linrec_scan``.  Thomas
    on diagonally dominant M-matrices is componentwise stable — what lets
    SPIKE survive global condition numbers ~N^2 (ladder Laplacians at
    N = 1e8 reach ~1e16)."""

    def __init__(self, dlc, dc, duc, dp=None):
        if dp is not None:
            dp = torch.as_tensor(dp, dtype=dlc.dtype, device=dlc.device)
            self.w, self.dpinv, self.t = _thomas_from_dp(dlc, duc, dp)
        else:
            self.w, self.dpinv, self.t = _thomas_factor(dlc, dc, duc)

    def solve(self, b):
        """Solve the (batched) chunk systems for b of shape (C, M)."""
        return _thomas_apply(self.w, self.dpinv, self.t, b)


def _thomas_from_dp(dlc, duc, dp):
    """(w, 1/d', t) elementwise from a precomputed pivot diagonal d'."""
    dpinv = 1.0 / dp
    w = dlc * _shift_down(dpinv, 1, 0.0)       # w_0 = 0 through dlc[:, 0] = 0
    t = duc * dpinv
    return w, dpinv, t


def thomas_pivots_host(dlc, dc, duc):
    """Sequential pivot recurrence in host float64, vectorized across the
    chunk axis: d'_i = d_i - (dl_i / d'_{i-1}) du_{i-1}.  Runs over the
    transposed (M, C) layout so that each step reads contiguous rows; the
    arithmetic is the JAX package's, operation for operation."""
    dlT = np.ascontiguousarray(np.asarray(dlc, np.float64).T)
    dcT = np.ascontiguousarray(np.asarray(dc, np.float64).T)
    duT = np.ascontiguousarray(np.asarray(duc, np.float64).T)
    m = dcT.shape[0]
    dpT = np.empty_like(dcT)
    dpT[0] = dcT[0]
    tmp = np.empty_like(dcT[0])
    for i in range(1, m):
        np.divide(dlT[i], dpT[i - 1], out=tmp)
        np.multiply(tmp, duT[i - 1], out=tmp)
        np.subtract(dcT[i], tmp, out=dpT[i])
    return np.ascontiguousarray(dpT.T)


def spike_host_pivots(dl, d, du, chunks: int):
    """The chunked Thomas pivot table d' (C, M) in true host float64, for
    ``SpikeFactor(..., dp=...)``.  The pivot recurrence of a ladder
    Laplacian has a degenerate fixed point, so its per-step rounding
    accumulates ~linearly in M; the JAX package computes it on the host
    because a TPU's emulated f64 drifts too far at N = 1e8.  The H100 has
    native f64; the host table is kept because it is the JAX package's
    algorithm at that size, and because the device recurrence is M
    sequential steps of launches (``_thomas_factor``).  Inputs are host
    arrays; only the (C, M) table crosses to the device."""
    dl = np.asarray(dl, np.float64)
    d = np.asarray(d, np.float64)
    du = np.asarray(du, np.float64)
    n = d.shape[-1]
    c = int(chunks)
    m = -(-n // c)
    pad = c * m - n

    def chunked(a, fill):
        return np.concatenate([a, np.full(pad, fill, np.float64)]).reshape(c, m)

    dlc = chunked(dl, 0.0)
    dlc[:, 0] = 0.0
    duc = chunked(du, 0.0)
    duc[:, -1] = 0.0
    return thomas_pivots_host(dlc, chunked(d, 1.0), duc)


def _thomas_factor(dlc, dc, duc):
    """The pivot recurrence on the device: a host loop over the M axis
    with a C-wide carry (sequential in M, vectorized across chunks) — M
    steps of a few launches each, fine at test sizes; at N = 1e8 (M ~ 2e5)
    callers pass host pivots (``dp=``) instead, so this loop never runs
    there.  Returns (w, 1/d', t), each (C, M)."""
    c, m = dc.shape
    du_prev = _shift_down(duc, 1, 0.0)
    w = torch.zeros_like(dc)
    dpinv = torch.empty_like(dc)
    t = torch.empty_like(dc)
    dprev = dc[:, 0]
    dpinv[:, 0] = 1.0 / dprev
    t[:, 0] = duc[:, 0] / dprev
    for i in range(1, m):
        w_i = dlc[:, i] / dprev
        dp_i = dc[:, i] - w_i * du_prev[:, i]
        w[:, i] = w_i
        dpinv[:, i] = 1.0 / dp_i
        t[:, i] = duc[:, i] / dp_i
        dprev = dp_i
    return w, dpinv, t


def _thomas_apply(w, dpinv, t, b):
    y = _linrec_scan(-w, b)                     # forward elimination
    return _linrec_scan(-t, y * dpinv, reverse=True)   # back substitution


def _mapped(fn, nbatch, *arrays):
    """``lax.map`` over nbatch sub-batches of the chunk axis, so that the
    per-round temporaries cover only C / nbatch chunks at once."""
    if nbatch == 1:
        return fn(*arrays)
    c = arrays[0].shape[0]
    g = c // nbatch
    return torch.cat([fn(*(a[k * g:(k + 1) * g] for a in arrays))
                      for k in range(nbatch)], dim=0)


def _chunk_solve(dlc, dc, duc, b, nbatch=1):
    """Batched per-chunk PCR solve, in nbatch sequential sub-batches."""
    return _mapped(tridiag_solve, nbatch, dlc, dc, duc, b)


def _thomas_apply_mapped(w, dpinv, t, b, nbatch):
    return _mapped(_thomas_apply, nbatch, w, dpinv, t, b)


def _chunked(a, pad, c, m, fill):
    return torch.cat([a, a.new_full((pad,), fill)]).reshape(c, m)


def _spike_prep_lu(dl, du, pad, c, m):
    """`_spike_prep` without the main diagonal (the ``dp=`` path)."""
    dl = _chunked(dl, pad, c, m, 0.0)
    du = _chunked(du, pad, c, m, 0.0)
    a_tip = dl[:, 0].clone()
    c_tip = du[:, -1].clone()
    dl[:, 0] = 0.0
    du[:, -1] = 0.0
    return dl, du, a_tip, c_tip


def _spike_prep(dl, d, du, pad, c, m):
    """Pad to C M (identity rows), reshape to chunks, zero the inter-chunk
    coupling entries and return them apart."""
    dlc, duc, a_tip, c_tip = _spike_prep_lu(dl, du, pad, c, m)
    return dlc, _chunked(d, pad, c, m, 1.0), duc, a_tip, c_tip


def _spike_tips(Y):
    return torch.stack([Y[:, 0], Y[:, -1]], dim=-1).reshape(-1)


def _spike_stage2(Y, V, W, u, n):
    c, m = Y.shape
    f = u[0::2]
    last = u[1::2]
    zero = Y.new_zeros(1)
    l_prev = torch.cat([zero, last[:-1]])
    f_next = torch.cat([f[1:], zero])
    x = Y - V * l_prev[:, None] - W * f_next[:, None]
    return x.reshape(c * m)[:n]


def _coupled(y, xx, a_tip, c_tip, n):
    """Add the inter-chunk coupling entries to a chunked matvec."""
    zero = xx.new_zeros(1)
    x_last_prev = torch.cat([zero, xx[:-1, -1]])
    x_first_next = torch.cat([xx[1:, 0], zero])
    y[:, 0] += a_tip * x_last_prev
    y[:, -1] += c_tip * x_first_next
    return y.reshape(-1)[:n]


def _spike_matvec_lu(w, dpinv, t, a_tip, c_tip, x, pad, n):
    """y = T x from the Thomas factor: T = L U with unit lower bidiagonal
    L (subdiagonal w) and upper bidiagonal U (diagonal d' = 1/dpinv,
    superdiagonal du = t d')."""
    c, m = w.shape
    xx = _chunked(x, pad, c, m, 0.0)
    dp = 1.0 / dpinv
    u = dp * xx + (t * dp) * _shift_up(xx, 1, 0.0)
    y = u + w * _shift_down(u, 1, 0.0)
    return _coupled(y, xx, a_tip, c_tip, n)


def _spike_matvec(dlc, dc, duc, a_tip, c_tip, x, pad, n):
    c, m = dc.shape
    xx = _chunked(x, pad, c, m, 0.0)
    return _coupled(tridiag_matvec(dlc, dc, duc, xx), xx, a_tip, c_tip, n)


class SpikeFactor:
    """Chunked tridiagonal factorization (SPIKE / block elimination) for
    huge N, where one monolithic PCR would hold log2(N) rounds of N-sized
    temporaries and accumulate rounding at the global condition number.

    Set-up splits the N rows into C chunks of M, solves the two coupling
    spikes V = T_c^-1 e_0 a_c and W = T_c^-1 e_{M-1} c_c per chunk, and
    LU-factors the 2C x 2C reduced interface system (pentadiagonal in the
    interleaving [f_0, l_0, f_1, l_1, ...]) once on the host with LAPACK
    ``dgbtrf``.  Each ``solve(b)`` is one batched chunk solve, a banded
    solve of 2C values on the host (``dgbtrs``) and an elementwise
    combine.  ``inner``: "thomas" (componentwise stable; the raw
    coefficients are then dropped, since the factor reproduces T for the
    refinement matvec) or "pcr".  ``dp``: a host pivot table from
    ``spike_host_pivots`` (``d`` is then never needed on the device).
    ``nbatch``: sub-batches of the chunk axis per solve.

    Role parity: the reference factors its 1e8-resistor benchmark
    (100000000xR.cpp) once with Eigen SparseLU and re-solves."""

    def __init__(self, dl, d, du, chunks: int = 2048, nbatch: int = 1,
                 inner: str = "thomas", factor_host: bool = False, dp=None):
        n = int(dl.shape[-1])
        c = int(chunks)
        if c % nbatch:
            raise ValueError(f"chunks={c} is not a multiple of nbatch="
                             f"{nbatch}")
        m = -(-n // c)
        pad = c * m - n
        if dp is not None:
            if inner != "thomas":
                raise ValueError("dp= requires the Thomas inner solver")
            if tuple(np.shape(dp)) != (c, m):
                raise ValueError(f"dp has shape {np.shape(dp)}, not {(c, m)}")
        elif factor_host and inner == "thomas":
            dp = spike_host_pivots(_np(dl), _np(d), _np(du), c)
        self.n, self.c, self.m, self.pad = n, c, m, pad
        self.nbatch = nbatch
        self.inner = inner
        self.dtype = dl.dtype
        if dp is not None:
            dlc, duc, a_tip, c_tip = _spike_prep_lu(dl, du, pad, c, m)
            dc_ = None
        else:
            dlc, dc_, duc, a_tip, c_tip = _spike_prep(dl, d, du, pad, c, m)
        del dl, du, d
        self.a_tip, self.c_tip = a_tip, c_tip
        if inner == "thomas":
            self._thomas = ThomasChunks(dlc, dc_, duc, dp=dp)
            self.dlc = self.duc = self.dc = None
            del dlc, dc_, duc, dp
        else:
            self._thomas = None
            self.dlc, self.dc, self.duc = dlc, dc_, duc
        e = a_tip.new_zeros((c, m))
        e[:, 0] = a_tip
        self.V = self._chunks_solve(e)
        e.zero_()
        e[:, -1] = c_tip
        self.W = self._chunks_solve(e)
        del e
        # reduced system over [f_0, l_0, f_1, l_1, ...] (size 2C):
        #   f_c + V_c[0]  l_{c-1} + W_c[0]  f_{c+1} = Y_c[0]
        #   l_c + V_c[-1] l_{c-1} + W_c[-1] f_{c+1} = Y_c[-1]
        V0, Vm = _np(self.V[:, 0]), _np(self.V[:, -1])
        W0, Wm = _np(self.W[:, 0]), _np(self.W[:, -1])
        kl = ku = 2
        ab = np.zeros((2 * kl + ku + 1, 2 * c))     # gbtrf layout
        k = np.arange(c)
        ab[kl + ku, :] = 1.0
        # put(i, j, v): ab[kl + ku + i - j, j] = v
        ab[kl + ku + 1, 2 * k[1:] - 1] = V0[1:]      # (2k, 2k - 1)
        ab[kl + ku + 2, 2 * k[1:] - 1] = Vm[1:]      # (2k + 1, 2k - 1)
        ab[kl + ku - 2, 2 * k[:-1] + 2] = W0[:-1]    # (2k, 2k + 2)
        ab[kl + ku - 1, 2 * k[:-1] + 2] = Wm[:-1]    # (2k + 1, 2k + 2)
        from scipy.linalg import lapack
        lu, piv, info = lapack.dgbtrf(ab, kl, ku)
        if info != 0:
            raise ValueError(f"SPIKE reduced system: dgbtrf info {info}")
        self._red_lu = (lu, piv, kl, ku)

    def _chunks_solve(self, bchunks):
        """Solve the decoupled per-chunk systems for (C, M) right sides."""
        if self._thomas is not None:
            th = self._thomas
            return _thomas_apply_mapped(th.w, th.dpinv, th.t, bchunks,
                                        self.nbatch)
        return _chunk_solve(self.dlc, self.dc, self.duc, bchunks, self.nbatch)

    def _reduced_solve(self, r):
        from scipy.linalg import lapack
        lu, piv, kl, ku = self._red_lu
        u, info = lapack.dgbtrs(lu, kl, ku, _np(r), piv)
        if info != 0:
            raise ValueError(f"SPIKE reduced system: dgbtrs info {info}")
        return u

    def solve(self, b):
        """Solve T x = b (b of length n): the batched chunk solves on the
        device, the reduced banded solve on the host (2C values each way),
        the combine on the device."""
        Y = self._chunks_solve(_chunked(b, self.pad, self.c, self.m, 0.0))
        u = self._reduced_solve(_spike_tips(Y))
        u = torch.as_tensor(u, dtype=Y.dtype, device=Y.device)
        return _spike_stage2(Y, self.V, self.W, u, self.n)

    def matvec(self, x):
        """y = T x from the chunked representation (the refinement's
        residual, without the global dl / d / du on the device)."""
        if self._thomas is not None:
            th = self._thomas
            return _spike_matvec_lu(th.w, th.dpinv, th.t, self.a_tip,
                                    self.c_tip, x, self.pad, self.n)
        return _spike_matvec(self.dlc, self.dc, self.duc, self.a_tip,
                             self.c_tip, x, self.pad, self.n)


def _np(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _bordered(solve, residual, t_e, ete, z, e, rhs_b, refine):
    """The Schur complement of [T e; e^T 0] [v; i] = [z; rhs_b] and its
    ``refine`` residual refinement passes, for every bordered solve:
    ``solve(b)`` is T^-1 b, ``residual(v, i)`` z - T v - e i, t_e = T^-1
    e and ete = e^T t_e.  e is a vector or, as an int, the index of a
    unit vector, so that no N-length e need exist."""
    if isinstance(e, torch.Tensor):
        dot = lambda x: x @ e
    else:
        dot = lambda x: x[..., e]

    def base(zz, rb):
        t_z = solve(zz)
        ii = (dot(t_z) - rb) / ete
        return torch.addcmul(t_z, t_e, ii[..., None], value=-1.0), ii

    v, i = base(z, rhs_b)
    for _ in range(refine):
        with span("pe.refine"):
            dv, di = base(residual(v, i), rhs_b - dot(v))
            v = v + dv
            i = i + di
    return v, i


def spike_border_solve_factor(dl, d, du, e, chunks: int = 2048,
                              nbatch: int = 1, factor_host: bool = False):
    """A SpikeFactor for T plus the Schur pieces for one voltage-source
    border column e, for repeated bordered solves.  Returns (factor, t_e,
    ete)."""
    fac = SpikeFactor(dl, d, du, chunks=chunks, nbatch=nbatch,
                      factor_host=factor_host)
    t_e = fac.solve(e)
    return fac, t_e, t_e @ e


def spike_border_solve_unit_factor(dl, d, du, idx: int = 0,
                                   chunks: int = 2048, nbatch: int = 1,
                                   inner: str = "thomas",
                                   factor_host: bool = False, dp=None):
    """spike_border_solve_factor for the common MNA case where the border
    column is the unit vector at ``idx`` (no N-length e kept)."""
    fac = SpikeFactor(dl, d, du, chunks=chunks, nbatch=nbatch, inner=inner,
                      factor_host=factor_host, dp=dp)
    e = dl.new_zeros(fac.n)
    e[idx] = 1.0
    t_e = fac.solve(e)
    del e
    return fac, t_e, t_e[idx]


def spike_border_solve_unit(fac, t_e, ete, z, rhs_b, idx: int = 0,
                            refine: int = 2):
    """Bordered solve with e = the unit vector at ``idx`` (see
    spike_border_solve)."""

    def residual(v, i):
        r = z - fac.matvec(v)
        r[idx] -= i
        return r

    return _bordered(fac.solve, residual, t_e, ete, z, int(idx), rhs_b,
                     refine)


def spike_border_solve(fac, t_e, ete, z, e, rhs_b, refine: int = 2):
    """Bordered solve through a prebuilt SpikeFactor (``border_solve``'s
    semantics); the ``refine`` passes use the factor's chunked matvec."""

    def residual(v, i):
        return (z - fac.matvec(v)).addcmul_(e, i[..., None], value=-1.0)

    return _bordered(fac.solve, residual, t_e, ete, z, e, rhs_b, refine)


# ---------------------------------------------------------------------------
# The partitioned solve (``csrc/tridiag_part.cu`` and its plain twin)

PART_M = 32        # rows a chunk (31 interior, 1 separator): the .cu's kM
PART_DIRECT = 64   # a level of at most this many rows: Thomas, whole
_PI = PART_M - 1   # interior rows a chunk
# the rows of a level's ``edge`` (10, C), as ``tridiag_part.cu``'s enum Edge
_A0, _CL, _AS, _CQ, _DS, _CS, _GLF, _GLL, _GRF, _GRL = range(10)


class PartLevel(NamedTuple):
    """One level of a :class:`PartitionFactor`: n rows in C = ceil(n /
    PART_M) chunks; w, ip, t (31, C) the interiors' Thomas coefficients
    (row j of chunk k at [j, k]); edge (10, C) the couplings and the
    spikes' tips.  A per-lane factor's arrays have a leading lane axis:
    (B, 31, C), (B, 10, C)."""
    n: int
    w: torch.Tensor
    ip: torch.Tensor
    t: torch.Tensor
    edge: torch.Tensor


class PartDirect(NamedTuple):
    """The last level, solved by Thomas over its n rows: w, ip, t (n,), or
    (B, n) for a per-lane factor."""
    n: int
    w: torch.Tensor
    ip: torch.Tensor
    t: torch.Tensor


def part_sizes(n: int) -> list:
    """The levels' sizes: n, then ceil(n / PART_M) while a level has more
    than PART_DIRECT rows; the last is the directly solved level."""
    sizes = [int(n)]
    while sizes[-1] > PART_DIRECT:
        sizes.append(-(-sizes[-1] // PART_M))
    return sizes


def _part_diags(a, d, c, n: int, rows: int):
    """A level's (..., n) diagonals padded with identity rows to
    ``rows``, a[..., 0] and c[..., n - 1] dropped by slices."""
    zeros = lambda k: a.new_zeros(a.shape[:-1] + (k,))
    a = torch.cat([zeros(1), a[..., 1:n], zeros(rows - n)], dim=-1)
    c = torch.cat([c[..., :n - 1], zeros(rows - n + 1)], dim=-1)
    d = torch.cat([d[..., :n], d.new_ones(d.shape[:-1] + (rows - n,))],
                  dim=-1)
    return a, d, c


def _part_thomas(a, d, c):
    """Thomas's coefficients along the last axis of (..., m) diagonals:
    lists of m tensors w = a / p[-1], ip = 1 / p, t = c / p (w[0] zero),
    each quotient a product with ip."""
    ip = [torch.reciprocal(d[..., 0])]
    w, t = [torch.zeros_like(ip[0])], [c[..., 0] * ip[0]]
    for j in range(1, d.shape[-1]):
        w.append(a[..., j] * ip[-1])
        ip.append(torch.reciprocal(d[..., j] - w[-1] * c[..., j - 1]))
        t.append(c[..., j] * ip[-1])
    return w, ip, t


def _part_interior(w, ip, t, r):
    """T_k^-1 r over the interiors: r 31 (..., C) right sides, w / ip / t
    indexable by row; the kernel's operations in its order."""
    r = list(r)
    for j in range(1, _PI):
        r[j] = r[j] - w[j] * r[j - 1]
    r[_PI - 1] = r[_PI - 1] * ip[_PI - 1]
    for j in range(_PI - 2, -1, -1):
        r[j] = r[j] * ip[j] - t[j] * r[j + 1]
    return r


def part_factor_plain(dl, d, du):
    """The plain twin of the card's factor: ([PartLevel], PartDirect) for
    T (dl, d, du), each (n,), or (B, n) for one T a lane; dl[..., 0] and
    du[..., -1] are ignored."""
    a, dd, c = dl, d, du
    levels = []
    sizes = part_sizes(d.shape[-1])
    for n, C in zip(sizes, sizes[1:]):
        a, dd, c = (v.unflatten(-1, (C, PART_M))
                    for v in _part_diags(a, dd, c, n, C * PART_M))
        w, ip, t = _part_thomas(a[..., :_PI], dd[..., :_PI], c[..., :_PI])
        zero = torch.zeros_like(dd[..., 0])
        gl = _part_interior(w, ip, t, [a[..., 0]] + [zero] * (_PI - 1))
        gr = _part_interior(w, ip, t,
                            [zero] * (_PI - 1) + [c[..., _PI - 1]])
        z1 = zero[..., :1]
        a_s, d_s, c_s = a[..., -1], dd[..., -1], c[..., -1]
        edge = torch.stack([a[..., 0], c[..., _PI - 1], a_s,
                            torch.cat([z1, c_s[..., :-1]], dim=-1), d_s, c_s,
                            gl[0], gl[-1], gr[0], gr[-1]], dim=-2)
        levels.append(PartLevel(n, torch.stack(w, dim=-2),
                                torch.stack(ip, dim=-2),
                                torch.stack(t, dim=-2), edge))
        glf = torch.cat([gl[0][..., 1:], z1], dim=-1)
        grf = torch.cat([gr[0][..., 1:], z1], dim=-1)
        a = -(a_s * gl[-1])
        dd = (d_s - a_s * gr[-1]) - c_s * glf
        c = -(c_s * grf)
    n = sizes[-1]
    w, ip, t = _part_thomas(*_part_diags(a, dd, c, n, n))
    return levels, PartDirect(n, torch.stack(w, dim=-1),
                              torch.stack(ip, dim=-1),
                              torch.stack(t, dim=-1))


def _part_rhs(p, q, n: int, rows: int):
    """A level's right side p - q[+1] (..., n) (q None at the top level),
    padded with zeros to ``rows``."""
    if q is not None:
        p = p - torch.cat([q[..., 1:], q.new_zeros(q.shape[:-1] + (1,))],
                          dim=-1)
    return torch.cat([p, p.new_zeros(p.shape[:-1] + (rows - n,))], dim=-1)


def part_solve_plain(levels, direct, b):
    """The plain twin of the card's solve: T^-1 b through a factor's
    levels (``part_factor_plain``'s or the card's): b (..., n), its rows
    in order; for a per-lane factor of B lanes the rows a multiple of B,
    row r solved with lane r mod B's T."""
    bt = direct.w.shape[0] if direct.w.dim() == 2 else 1
    # (R / bt, bt, n): a per-lane factor's arrays broadcast over the first
    # axis, a shared one's over both
    ps, qs = [b.reshape(-1, bt, b.shape[-1])], [None]
    for lev in levels:
        C = lev.edge.shape[-1]
        R = _part_rhs(ps[-1], qs[-1], lev.n, C * PART_M).unflatten(
            -1, (C, PART_M))
        y = _part_interior(lev.w.unbind(-2), lev.ip.unbind(-2),
                           lev.t.unbind(-2), R[..., :_PI].unbind(-1))
        ps.append(R[..., -1] - lev.edge[..., _AS, :] * y[-1])
        qs.append(lev.edge[..., _CQ, :] * y[0])
    r = _part_rhs(ps[-1], qs[-1], direct.n, direct.n)
    z = [r[..., 0]]
    for i in range(1, direct.n):
        z.append(r[..., i] - direct.w[..., i] * z[-1])
    z[-1] = z[-1] * direct.ip[..., -1]
    for i in range(direct.n - 2, -1, -1):
        z[i] = z[i] * direct.ip[..., i] - direct.t[..., i] * z[i + 1]
    x = torch.stack(z, dim=-1)
    for lev, p, q in zip(levels[::-1], ps[-2::-1], qs[-2::-1]):
        C = lev.edge.shape[-1]
        R = _part_rhs(p, q, lev.n, C * PART_M).unflatten(-1, (C, PART_M))
        r = list(R[..., :_PI].unbind(-1))
        xp = torch.cat([x.new_zeros(x.shape[:-1] + (1,)), x[..., :-1]],
                       dim=-1)
        r[0] = r[0] - lev.edge[..., _A0, :] * xp
        r[-1] = r[-1] - lev.edge[..., _CL, :] * x
        y = _part_interior(lev.w.unbind(-2), lev.ip.unbind(-2),
                           lev.t.unbind(-2), r)
        x = torch.stack(y + [x], dim=-1).flatten(-2)[..., :lev.n]
    return x.reshape(b.shape)


class PartitionFactor:
    """T (dl, d, du) factored for the partitioned solve (``dl[..., 0]``
    and ``du[..., -1]`` ignored): each (n,), one T shared by every right
    side, or each (B, n), one T a lane (``lanes`` B, else None), whose
    solve takes rows in a multiple of B, row r through lane r mod B.  On
    the CPU the plain twin factors and solves; on a CUDA device the kernel
    of ``csrc/tridiag_part.cu`` does (float64, contiguous, one device), or
    it raises.  Nothing is kept across factors: each holds its own levels
    (~3.4 arrays of T's shape at the top level)."""

    @spanned("pe.tridiag_part")
    def __init__(self, dl, d, du):
        ts = (("dl", dl), ("d", d), ("du", du))
        for name, v in ts:
            if not isinstance(v, torch.Tensor) or v.dim() not in (1, 2):
                raise ValueError(f"{name} must be a 1-D or 2-D tensor")
        if not dl.shape == d.shape == du.shape or 0 in d.shape:
            raise ValueError(f"dl, d, du of one shape (n,) or (B, n), n, B "
                             f">= 1 expected, got {tuple(dl.shape)}, "
                             f"{tuple(d.shape)}, {tuple(du.shape)}")
        self.n, self.device = int(d.shape[-1]), d.device
        self.lanes = int(d.shape[0]) if d.dim() == 2 else None
        if all(v.device.type == "cpu" for _n, v in ts):
            self.levels, self.direct = part_factor_plain(dl, d, du)
        else:
            self.levels, self.direct = _part_factor_card(ts)

    @spanned("pe.tridiag_part")
    def solve(self, b):
        """T^-1 b for b (..., n), its rows in order (a multiple of
        ``lanes`` of them for a per-lane factor): the plain twin where the
        factor and b lie on the CPU, else the kernel (b float64 on the
        factor's device, its last axis contiguous), or it raises."""
        _part_b_check(self, b)
        if self.device.type == "cpu" and b.device.type == "cpu":
            return part_solve_plain(self.levels, self.direct, b)
        return tridiag_part64(self, b)


def _part_b_check(fac, b):
    """b (..., n) with at least one row, for a factor of n rows; the rows
    a multiple of a per-lane factor's lanes."""
    if not isinstance(b, torch.Tensor):
        raise TypeError("b must be a tensor")
    if b.dim() < 1 or b.shape[-1] != fac.n or b.numel() == 0:
        raise ValueError(f"b (..., n) with n = {fac.n} and a row or more "
                         f"expected, got {tuple(b.shape)}")
    R = b.numel() // fac.n
    if fac.lanes is not None and R % fac.lanes:
        raise ValueError(f"{R} right sides for a factor of {fac.lanes} "
                         "lanes: a multiple of the lanes expected")


def _part_card_check(ts, device=None):
    """The card's terms: float64 (TypeError), CUDA, contiguous, one device
    (ValueError)."""
    for name, v in ts:
        if v.dtype != torch.float64:
            raise TypeError(f"{name} is {v.dtype}: the partitioned kernel "
                            "takes float64")
    for name, v in ts:
        if v.device.type != "cuda":
            raise ValueError(f"{name} lies on {v.device}: the partitioned "
                             "kernel runs on a CUDA device")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if v.device != (device or ts[0][1].device):
            raise ValueError("the partitioned solve's tensors lie on "
                             "different devices")


def _part_factor_card(ts):
    """``part_factor_plain`` by the kernel: two launches a level, one for
    the last."""
    _part_card_check(ts)
    a, dd, c = (v for _n, v in ts)
    if a.numel() >= 2 ** 31:
        raise ValueError(f"{a.numel()} rows: the kernel indexes rows in "
                         "int32")
    # a per-lane factor's arrays and entries take the lanes first
    lead = tuple(a.shape[:-1])
    suffix = "_lanes64" if lead else "64"
    levels = []
    sizes = part_sizes(a.shape[-1])
    with launcher(a.device) as launch:
        for n, C in zip(sizes, sizes[1:]):
            w, ip, t = a.new_empty((3,) + lead + (_PI, C))
            edge = a.new_empty(lead + (10, C))
            a2, d2, c2 = a.new_empty((3,) + lead + (C,))
            launch("pe_tridiag_part_factor" + suffix, a, dd, c, n, *lead,
                   w, ip, t, edge, a2, d2, c2)
            tridiag_part64.launches += 2
            levels.append(PartLevel(n, w, ip, t, edge))
            a, dd, c = a2, d2, c2
        n = sizes[-1]
        w, ip, t = a.new_empty((3,) + lead + (n,))
        launch("pe_tridiag_part_direct_factor" + suffix, a, dd, c, n,
               *lead, w, ip, t)
        tridiag_part64.launches += 1
    return levels, PartDirect(n, w, ip, t)


@kernel_wrapper
def tridiag_part64(fac: PartitionFactor, b):
    """x = T^-1 b on the card by ``csrc/tridiag_part.cu`` through the
    card's factor ``fac``: b (..., n) float64 on the factor's device, its
    last axis contiguous; x of b's shape, contiguous.  The per-lane form
    reads rows that lie evenly n or more apart in place (the band's rows
    of a wider right side); any other layout is copied to (R, n) first.
    Bit for bit the plain twin ``part_solve_plain`` on the same factor; a
    repeat run is bit-identical.  2L + 1 launches for L levels above the
    last (7 at n = 10^5 and 10^6); ``tridiag_part64.launches`` counts
    them and the factors'."""
    _part_b_check(fac, b)
    if fac.device.type != "cuda":
        raise ValueError("the factor lies on the CPU: its solve is the "
                         "plain twin's, on CPU tensors")
    # a row of b: its dtype, device and last axis
    _part_card_check((("b", b[(0,) * (b.dim() - 1)]),), fac.device)
    shape, b = b.shape, b.reshape(-1, fac.n)
    R, ld = b.shape[0], b.stride(0) if b.shape[0] > 1 else fac.n
    if (fac.lanes is None and not b.is_contiguous()) or ld < fac.n:
        b = b.contiguous()
        ld = fac.n
    suffix = "64" if fac.lanes is None else "_lanes64"

    def rows(q, n):
        """The per-lane entries' lanes and distance between p's rows: b's
        at the top level (q None), the level's n below."""
        if fac.lanes is None:
            return ()
        return fac.lanes, ld if q is None else n

    ps, qs = [b], [None]
    d = fac.direct
    with launcher(b.device) as launch:
        for lev in fac.levels:
            p2, q2 = b.new_empty((2, R, lev.edge.shape[-1]))
            launch("pe_tridiag_part_reduce" + suffix, ps[-1], qs[-1], lev.n,
                   R, *rows(qs[-1], lev.n), lev.w, lev.ip, lev.t, lev.edge,
                   p2, q2)
            ps.append(p2)
            qs.append(q2)
        x = b.new_empty((R, d.n))
        launch("pe_tridiag_part_direct" + suffix, ps[-1], qs[-1], d.n, R,
               *rows(qs[-1], d.n), d.w, d.ip, d.t, x)
        for lev, p, q in zip(fac.levels[::-1], ps[-2::-1], qs[-2::-1]):
            out = b.new_empty((R, lev.n))
            launch("pe_tridiag_part_expand" + suffix, p, q, lev.n, R,
                   *rows(q, lev.n), lev.w, lev.ip, lev.t, lev.edge, x, out)
            x = out
    tridiag_part64.launches += 2 * len(fac.levels) + 1
    return x.reshape(shape)


def _residual(dl, d, du, z, v, e, i):
    """z - T v - e i in four passes, T's corners dl[0] and du[-1] left out
    by slices: no scalar is written into a tensor, so nothing waits for
    the device."""
    r = torch.addcmul(z, d, v, value=-1.0)
    r[..., 1:].addcmul_(dl[1:], v[..., :-1], value=-1.0)
    r[..., :-1].addcmul_(du[:-1], v[..., 1:], value=-1.0)
    return r.addcmul_(e, i[..., None], value=-1.0)


def border_solve_part(fac: PartitionFactor, dl, d, du, z, e, rhs_b,
                      refine: int = 2):
    """``border_solve``'s Schur complement and refinement for a 1-D border
    e, with T's solves through the partitioned factor ``fac`` of (dl, d,
    du): 2 + refine solves; the residual by ``_residual``, e's dot
    products matrix-vector products; no host sync."""
    t_e = fac.solve(e.contiguous())
    return _bordered(lambda b: fac.solve(b.contiguous()),
                     lambda v, i: _residual(dl, d, du, z, v, e, i),
                     t_e, t_e @ e, z, e, rhs_b, refine)


@spanned("pe.border_solve")
def border_solve(dl, d, du, z, e, rhs_b, refine: int = 2):
    """Solve the bordered system [T e; e^T 0] [v; i] = [z; rhs_b] (one
    voltage-source branch over a tridiagonal MNA core) by the Schur
    complement: two solves, i = (e^T T^-1 z - rhs_b) / (e^T T^-1 e),
    v = T^-1 (z - e i), then ``refine`` residual refinement passes
    (ladder Laplacians reach condition ~N^2).  Returns (v, i).

    T (dl, d, du) and e are (N,), shared by every lane; z is (N,) or (B,
    N).  T's solves are one ``PartitionFactor`` (``border_solve_part``):
    the plain twin on CPU tensors, the kernel on CUDA float64 ones; it
    raises on anything else (``ValueError`` for a 2-D T, ``TypeError``
    for CUDA float32).  The JAX package's ``border_solve`` also takes a
    batched T."""
    for name, v in (("dl", dl), ("d", d), ("du", du), ("e", e)):
        if not isinstance(v, torch.Tensor) or v.dim() != 1:
            raise ValueError(f"{name} must be a 1-D tensor")
    return border_solve_part(PartitionFactor(dl, d, du), dl, d, du, z, e,
                             rhs_b, refine)
