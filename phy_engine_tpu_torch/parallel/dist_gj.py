"""Cooperative single-system Gauss-Jordan over the mesh (port of
``phy_engine_tpu/parallel/dist_gj.py``).

ONE system too large (or too slow) for one device, factored by every rank
of the mesh with the columns of A distributed block-cyclically:

* Columns are split into 128-wide panels; panel ``p`` lives on rank
  ``p % D``, so late panels do not pile onto one rank.  Each rank holds a
  (B, n, n/D) shard — no rank ever holds the factored matrix whole.
* At step ``p`` the owner runs ``ops.gj.panel_factor`` on its panel and
  the factored panel G, the pivot divisors and the pivot rows go to every
  rank in ONE ``psum`` of a value the non-owners hold as fresh zeros (the
  owner test is a host comparison of the rank's coordinate, so a
  non-owner never computes the panel and nothing it holds can leak in;
  the pivot rows ride as exact ``krow + 1`` floats).
* The O(B·n²·128) trailing update — where the n³ work goes — is shard
  local (``ops.gj.trailing_update``, full-FP32 matmuls) and touches only
  the rank's panels not yet eliminated (a host test on the static panel
  index replaces the JAX package's ``lax.cond``), so the aggregate
  trailing work is the sequential n³ divided by D.
* Refinement re-applies the stored panels to a fresh right-hand side with
  one broadcast per panel, against an f64 residual computed as a
  distributed matvec (each rank multiplies its column shard, ``psum``
  adds them up).

``dist_solve`` equilibrates by exact powers of two (``frexp``; the
reference's CPU ``exp2`` is inexact for |e| >= 13), factors in f32 and
refines in f64, then validates the f64 residual: rejected lanes get ONE
f64 refactor, and a lane still rejected raises ``RuntimeError``.
``make_dist_delta_solver`` is the COO entry of the distributed Newton.
Every scatter goes through a host-built ``ScatterPlan`` (no atomics), so
a CUDA run repeats itself bit for bit.

Column ownership: rank d holds the original columns of panels d, d + D,
d + 2D, ... (``_block_cyclic_perm``'s layout).  The JAX package's COO
solver places an entry by its permuted position instead, which agrees
with this only when D = 1 or n / 128 == D (every mesh its tests use) and
returns x permuted by panels otherwise; the port places by the original
panel always.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import F32, F64
from ..engine.analog import ScatterPlan
from ..ops.gj import NB, _place, panel_factor, pow2_recip_floor, \
    trailing_update
from .mesh import (all_true, axis_index, axis_size, mesh_axes, mesh_device,
                   psum, psum_many)


def _block_cyclic_perm(n: int, D: int) -> np.ndarray:
    """Column permutation: rank d's shard = panels [d, d+D, ...]."""
    npan = n // NB
    order = [p for d in range(D) for p in range(d, npan, D)]
    return np.concatenate(
        [np.arange(p * NB, (p + 1) * NB) for p in order])


def _shard_cols(n: int, D: int, d: int) -> np.ndarray:
    """The original column indices rank d holds, in its local order."""
    nloc = n // D
    return _block_cyclic_perm(n, D)[d * nloc:(d + 1) * nloc]


def _x_from(krow, pivd, rhs, n: int):
    """x in the original index space: x[k] = y[r] with krow[r] == k,
    y = b_final / pivot."""
    return _place(rhs[:, :, 0] / pivd, krow, n)


def _dist_local(Aloc, b, mesh, axes, refine: int, factor_dtype=F32,
                validate: bool = False):
    """The rank's part of the cooperative solve.  Aloc: (B, n, n/D) work-
    dtype (f64) column shard, rank d's local panel li being the original
    panel li·D + d; b: (B, n) replicated.  Returns x (B, n) replicated —
    or (x, rel) when ``validate``, rel the per-lane relative residual
    max|b - A x| / (Σ_ranks max|A_loc| · max|x| + max|b|) in f64 (inf on
    a non-finite lane).  ``factor_dtype``: f32 on the fast path, f64 for
    the validated fallback."""
    B, n, nloc = Aloc.shape
    work = Aloc.dtype
    fdt = factor_dtype
    D = axis_size(mesh, axes)
    d = axis_index(mesh, axes)
    npl = nloc // NB
    npan = n // NB
    dev = Aloc.device
    F = Aloc.to(fdt).clone()
    krow = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    pivd = torch.ones((B, n), dtype=fdt, device=dev)
    lane = torch.arange(NB, device=dev)

    def one_pass(rhs, krow, pivd, factor: bool):
        for p in range(npan):
            li = p // D
            mine = p % D == d
            cols = slice(li * NB, (li + 1) * NB)
            if factor:
                if mine:
                    Gp, k2, pv2 = panel_factor(F[:, :, cols], krow, pivd,
                                               p * NB)
                    F[:, :, cols] = Gp
                    payload = [Gp, pv2, (k2 + 1).to(fdt)]
                else:
                    payload = [F.new_zeros((B, n, NB)), F.new_zeros((B, n)),
                               F.new_zeros((B, n))]
                G, pivd, k1 = psum_many(payload, mesh, axes)
                krow = k1.to(torch.int64) - 1
            else:
                G = psum(F[:, :, cols] if mine else F.new_zeros((B, n, NB)),
                         mesh, axes)
            O = (krow[:, :, None] == p * NB + lane).to(fdt)
            if factor:
                # this rank's panels after p: a suffix of its shard
                lj0 = next((lj for lj in range(npl) if lj * D + d > p), npl)
                if lj0 < npl:
                    F[:, :, lj0 * NB:] = trailing_update(O, G,
                                                         F[:, :, lj0 * NB:])
            rhs = trailing_update(O, G, rhs)
        return rhs, krow, pivd

    rhs, krow, pivd = one_pass(b.to(fdt)[:, :, None], krow, pivd, True)
    x = _x_from(krow, pivd, rhs, n).to(work)
    gcols = torch.as_tensor(_shard_cols(n, D, d), device=dev)

    def residual(x):
        contrib = torch.einsum("bnj,bj->bn", Aloc, x[:, gcols])
        return b - psum(contrib, mesh, axes)

    for _ in range(refine):
        r = residual(x)
        rr, _k, _p = one_pass(r.to(fdt)[:, :, None], krow, pivd, False)
        x = x + _x_from(krow, pivd, rr, n).to(work)
    if not validate:
        return x
    # validated reject: the distributed work-dtype residual exposes
    # silent f32-factor failures (element growth, near-singular lanes)
    # that refinement cannot repair
    r = residual(x)
    anorm = psum(Aloc.abs().amax(dim=(1, 2)), mesh, axes)
    scale = anorm * x.abs().amax(dim=1) + b.abs().amax(dim=1)
    tiny = 1e-300 if work == F64 else 1e-30
    rel = r.abs().amax(dim=1) / scale.clamp(min=tiny)
    rel = torch.where(torch.isfinite(rel), rel, torch.inf)
    return x, rel


class _DeltaSolver:
    """Cooperative COO solver: (rows, cols, vals, b) -> (x, rel); see
    :func:`make_dist_delta_solver`.  The rank's (npad, npad/D) panel is
    scattered through a ScatterPlan built once per COO pattern."""

    def __init__(self, mesh, axes, n: int, npad: int, refine: int):
        self.mesh, self.axes = mesh, axes
        self.n, self.npad, self.refine = n, npad, refine
        D = axis_size(mesh, axes)
        self.d = axis_index(mesh, axes)
        self.nloc = npad // D
        self.gcols = _shard_cols(npad, D, self.d)
        self._plans: Dict = {}

    def _plan(self, rows, cols):
        key = (id(rows), id(cols))
        if key not in self._plans:
            r = rows.detach().cpu().numpy().astype(np.int64)
            c = cols.detach().cpu().numpy().astype(np.int64)
            loc = np.full(self.npad + 1, -1, np.int64)
            loc[self.gcols] = np.arange(self.nloc)
            lc = loc[np.clip(c, 0, self.npad)]
            mine = (r < self.n) & (c < self.n) & (lc >= 0)
            keys = np.where(mine, r * self.nloc + lc, -1)
            # identity on the padding diagonal (original cols n..npad)
            pl = np.nonzero(self.gcols >= self.n)[0]
            pad = (torch.as_tensor(self.gcols[pl]),
                   torch.as_tensor(pl))
            self._plans[key] = (rows, cols,
                                ScatterPlan(keys, self.npad * self.nloc),
                                pad)
        return self._plans[key][2:]

    def __call__(self, rows, cols, vals, b):
        plan, (prow, pcol) = self._plan(rows, cols)
        Aloc = plan.sum(vals.to(F64)[None]).reshape(1, self.npad, self.nloc)
        Aloc[0, prow.to(vals.device), pcol.to(vals.device)] += 1.0
        x, rel = _dist_local(Aloc, b.to(F64)[None], self.mesh, self.axes,
                             self.refine, validate=True)
        return x[0], rel[0]


_DELTA_CACHE: Dict = {}


def make_dist_delta_solver(mesh, n: int, npad: int, axis=None,
                           refine: int = 2):
    """The cooperative COO solver ``solver(rows, cols, vals, b) -> (x,
    rel)`` of one (pre-equilibrated) system: rows / cols (nnz,) the static
    pattern (ground dummy at index >= n, dropped), vals (nnz,), b (npad,)
    replicated.  Each rank keeps ONLY the entries of the columns it owns
    and builds its (npad, npad/D) f64 panel (identity on the padding
    diagonal); the factorization runs in f32 exactly as in
    ``dist_solve`` and ``refine`` distributed f64 refinement passes
    recover full precision.  ``rel`` is the f64 relative residual (inf on
    a non-finite lane): the Newton caller gates on it.

    Cached per (mesh, axes, n, npad, refine), and its scatter plan per
    pattern, so Newton iterations reuse both."""
    axes = mesh_axes(mesh, axis)
    key = (id(mesh), axes, n, npad, refine)
    if key in _DELTA_CACHE:
        return _DELTA_CACHE[key][1]
    D = axis_size(mesh, axes)
    if npad % (NB * D):
        raise ValueError(f"npad={npad} must be a multiple of {NB * D}")
    solver = _DeltaSolver(mesh, axes, n, npad, refine)
    _DELTA_CACHE[key] = (mesh, solver)
    return solver


def dist_solve(mesh, A, b, axis=None, refine: int = 2,
               validate: bool = True, tol: float = None):
    """Solve A x = b with A's columns block-cyclic over ``mesh``.

    A: (B, n, n) or (n, n), b: (B, n) or (n,), numpy or tensors; n must
    be a multiple of 128·D.  ``axis`` defaults to every mesh axis
    (flattened).  Rows, then columns, are scaled by exact powers of two;
    each rank keeps only its (B, n, n/D) column shard, factored
    cooperatively in f32 and refined with f64 residuals.  Returns x on the
    rank's device, replicated, shaped like b.

    ``validate`` (default on): the distributed f64 residual is checked
    against ``tol`` (relative, default 1e-9).  Lanes the f32 factor
    mis-solved (element growth, near-singular lanes) trigger ONE f64
    refactor; ``RuntimeError`` if a lane still fails."""
    axes = mesh_axes(mesh, axis)
    D = axis_size(mesh, axes)
    d = axis_index(mesh, axes)
    dev = mesh_device(mesh)
    A = torch.as_tensor(A, dtype=F64).to(dev)
    b = torch.as_tensor(b, dtype=F64).to(dev)
    squeeze = A.dim() == 2
    if squeeze:
        A, b = A[None], b[None]
    B, n, _ = A.shape
    if n % (NB * D):
        raise ValueError(f"n={n} must be a multiple of {NB * D}")
    tol = 1e-9 if tol is None else tol

    # exact power-of-two equilibration (as ops.gj.solve_batched)
    rs = pow2_recip_floor(A.abs().amax(dim=2).clamp(min=1e-300))
    A = A * rs[:, :, None]
    cs = pow2_recip_floor(A.abs().amax(dim=1).clamp(min=1e-300))
    gcols = torch.as_tensor(_shard_cols(n, D, d), device=dev)
    Aloc = (A[:, :, gcols] * cs[:, None, gcols]).contiguous()
    del A
    b = b * rs

    def run(fdt):
        return _dist_local(Aloc, b, mesh, axes, refine, fdt, validate)

    if not validate:
        x = run(F32) * cs
        return x[0] if squeeze else x
    x, rel = run(F32)
    if not all_true(mesh, axes, rel <= tol)[0]:
        x2, rel2 = run(F64)
        x = torch.where((rel2 < rel)[:, None], x2, x)
        rel = torch.minimum(rel, rel2)
        if not all_true(mesh, axes, rel <= tol)[0]:
            raise RuntimeError(
                f"dist_solve: validated reject — relative residual "
                f"{float(rel.max()):.3e} > tol {tol:.1e} after the f64 "
                f"fallback (singular or pathological lane)")
    x = x * cs
    return x[0] if squeeze else x
