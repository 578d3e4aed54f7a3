"""Tridiagonal solvers for ladder-shaped MNA systems (port of
``phy_engine_tpu/ops/tridiag.py``).

The reference's largest benchmark netlists are series resistor ladders
(benchmark/0001.models/1000000xR.cpp, 100000000xR.cpp): the MNA is
tridiagonal plus one voltage-source border row / column.  Two solvers:

* ``tridiag_solve`` — parallel cyclic reduction (PCR): ceil(log2 N)
  rounds of shifts and fused multiply-adds, no sequential dependence;
  ``border_solve`` eliminates the border by a Schur complement (two PCR
  solves) with residual refinement passes; ``PCRFactor`` keeps PCR's
  right-side-independent rounds for repeated solves with one T (the
  sparse route's chain preconditioner, ``ops/sparse.py``).
* ``SpikeFactor`` — chunked (SPIKE) elimination for N in the 1e8 range:
  C chunks of M rows, each solved by Thomas, whose pivots come from a
  sequential recurrence (on the device, ``_thomas_factor``, or in true
  host float64, ``spike_host_pivots``) and whose substitutions are
  first-order linear recurrences evaluated by a log-depth scan
  (``_linrec_scan``); the 2C x 2C reduced interface system is banded and
  LU-factored once on the host (LAPACK ``dgbtrf`` / ``dgbtrs`` through
  scipy).

Everything is torch ops in the input dtype (float64 for the ladders) over
arbitrary leading batch dimensions; there is no hand kernel (the JAX
package has no Pallas kernel here either).  ``lax.scan`` / ``lax.map``
become host loops; ``jax.lax.associative_scan`` becomes a Kogge-Stone
scan (``_linrec_scan``), which rounds differently from XLA's odd-even
scan, so results agree with the JAX package to a tolerance, not bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..trace import span, spanned, sync_site


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


def _edges_zeroed(dl, du):
    a = dl.clone()
    with sync_site("tridiag_edge"):      # a scalar's copy to the device
        a[..., 0] = 0.0
    c = du.clone()
    with sync_site("tridiag_edge"):
        c[..., -1] = 0.0
    return a, c


@spanned("pe.pcr")
def tridiag_solve(dl, d, du, b):
    """Solve T x = b for tridiagonal T (sub dl, diag d, super du) by PCR.

    ``dl[..., 0]`` and ``du[..., -1]`` are ignored.  All arrays share the
    shape (..., N) (a leading dimension of 1 broadcasts); the solve
    vectorizes over the leading axes.  PCR is stable for the diagonally
    dominant systems MNA produces; a singular system yields inf / nan."""
    n = d.shape[-1]
    a, c = _edges_zeroed(dl, du)
    x = b
    s = 1
    while s < n:
        alpha = -a / _shift_down(d, s, 1.0)
        gamma = -c / _shift_up(d, s, 1.0)
        a_new = alpha * _shift_down(a, s, 0.0)
        c_new = gamma * _shift_up(c, s, 0.0)
        d_new = (d + alpha * _shift_down(c, s, 0.0)
                 + gamma * _shift_up(a, s, 0.0))
        x = (x + alpha * _shift_down(x, s, 0.0)
             + gamma * _shift_up(x, s, 0.0))
        a, c, d = a_new, c_new, d_new
        s *= 2
    return x / d


class PCRFactor:
    """``tridiag_solve`` for one T and many right sides: the a / c / d
    recursion, which does not depend on the right side, runs once here,
    keeping each round's (alpha, gamma) and the final diagonal; ``solve``
    runs only the right side's recursion.

    dl, d, du share one shape (..., N); ``dl[..., 0]`` and ``du[..., -1]``
    are ignored (dropped by a slice, with no scalar written into a tensor,
    so neither the factor nor a solve waits for the device).  Holds
    2 ceil(log2 N) arrays of T's shape."""

    def __init__(self, dl, d, du):
        n = d.shape[-1]
        zero = d.new_zeros(d.shape[:-1] + (1,))
        a = torch.cat([zero, dl[..., 1:]], dim=-1)
        c = torch.cat([du[..., :-1], zero], dim=-1)
        self.rounds = []
        s = 1
        while s < n:
            alpha = -a / _shift_down(d, s, 1.0)
            gamma = -c / _shift_up(d, s, 1.0)
            a_new = alpha * _shift_down(a, s, 0.0)
            c_new = gamma * _shift_up(c, s, 0.0)
            d = (d + alpha * _shift_down(c, s, 0.0)
                 + gamma * _shift_up(a, s, 0.0))
            a, c = a_new, c_new
            self.rounds.append((s, alpha, gamma))
            s *= 2
        self.d = d

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
    a, c = _edges_zeroed(dl, du)
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


def spike_border_solve_factor(dl, d, du, e, chunks: int = 2048,
                              nbatch: int = 1, factor_host: bool = False):
    """A SpikeFactor for T plus the Schur pieces for one voltage-source
    border column e, for repeated bordered solves.  Returns (factor, t_e,
    ete)."""
    fac = SpikeFactor(dl, d, du, chunks=chunks, nbatch=nbatch,
                      factor_host=factor_host)
    t_e = fac.solve(e)
    return fac, t_e, (e * t_e).sum(-1)


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

    def base(zz, rb):
        t_z = fac.solve(zz)
        ii = (t_z[idx] - rb) / ete
        return t_z - t_e * ii, ii

    v, i = base(z, rhs_b)
    for _ in range(refine):
        r1 = z - fac.matvec(v)
        r1[idx] -= i
        dv, di = base(r1, rhs_b - v[idx])
        v = v + dv
        i = i + di
    return v, i


def spike_border_solve(fac, t_e, ete, z, e, rhs_b, refine: int = 2):
    """Bordered solve through a prebuilt SpikeFactor (``border_solve``'s
    semantics); the ``refine`` passes use the factor's chunked matvec."""

    def base(zz, rb):
        t_z = fac.solve(zz)
        ii = ((e * t_z).sum(-1) - rb) / ete
        return t_z - t_e * ii[..., None], ii

    v, i = base(z, rhs_b)
    for _ in range(refine):
        r1 = z - fac.matvec(v) - e * i[..., None]
        r2 = rhs_b - (e * v).sum(-1)
        dv, di = base(r1, r2)
        v = v + dv
        i = i + di
    return v, i


@spanned("pe.border_solve")
def border_solve(dl, d, du, z, e, rhs_b, refine: int = 2):
    """Solve the bordered system [T e; e^T 0] [v; i] = [z; rhs_b] (one
    voltage-source branch over a tridiagonal MNA core) by the Schur
    complement: two PCR solves, i = (e^T T^-1 z - rhs_b) / (e^T T^-1 e),
    v = T^-1 (z - e i), then ``refine`` residual refinement passes
    (ladder Laplacians reach condition ~N^2).  Returns (v, i)."""
    t_e = tridiag_solve(dl, d, du, e)
    ete = (e * t_e).sum(-1)

    def base(zz, rb):
        t_z = tridiag_solve(dl, d, du, zz)
        ii = ((e * t_z).sum(-1) - rb) / ete
        return t_z - t_e * ii[..., None], ii

    v, i = base(z, rhs_b)
    for _ in range(refine):
        with span("pe.refine"):
            r1 = z - tridiag_matvec(dl, d, du, v) - e * i[..., None]
            r2 = rhs_b - (e * v).sum(-1)
            dv, di = base(r1, r2)
            v = v + dv
            i = i + di
    return v, i
