"""Sparse MNA solving for large circuits (port of
``phy_engine_tpu/ops/sparse.py``).

The matrix stays in COO form — the stamp pattern is static — and the
solver is preconditioned BiCGStab, whose only operations are sparse
products and vector passes: torch ops, no factorization of A.  On a
CUDA tensor the COO product (float64 or float32) is one hand-written
kernel,
``csrc/coo_spmm.cu`` (``coo_spmm``, over the row-ordered layout that
:class:`COOLayout` builds); on a CPU tensor it is the plain torch twin,
a gather, a multiply and :class:`RowPlan`'s segment sum.  The JAX package
has no Pallas kernel here: XLA fuses the product there.

* ``coo_matvec`` / ``coo_diagonal`` — y = A x and diag(A) of a COO system
  whose rows / cols may hold the ground dummy n; ``COOLayout.bind`` — the
  product with its values bound once (a solve's operator);
* ``ELL`` — the padded-row layout; ``BandedCOO`` — frequent diagonal
  offsets as dense bands (a shift and a multiply each) plus a COO
  remainder;
* ``bicgstab`` — f64 BiCGStab on COO (the ``Circuit`` sparse route),
  Jacobi-preconditioned until a pattern needs the chain preconditioner
  (``ChainPreconditioner``: the tridiagonal band by the partitioned
  solve of ``ops/tridiag.py`` in float64, PCR in float32, and a Schur
  border); ``bicgstab_ell`` — f32 Krylov on an ELL / BandedCOO layout with
  f64 refinement passes (``bench_sparse.py``'s solver).

Vectors carry a lane dimension ``(B, n)`` (a 1-D vector is one lane);
values are ``(nnz,)``, shared by every lane, or ``(B, nnz)``.  Each lane
has its own ``done`` / ``ok`` and stops as it would alone: the loop
updates only the lanes that were still iterating, and reads the stop
condition back to the host every ``CHECK_EVERY`` iterations, so checking
less often gives the same result as checking every iteration.

Scatter-adds are deterministic: every segment reduction goes through a
host-built :class:`RowPlan` (entries sorted by row, rows bucketed by
degree, a fixed summation order, no atomics), whose memory stays O(nnz)
however wide one row is, or, for the product on the card, through the
kernel's fixed order over the same sorted entries, so a run on the card
reproduces itself bit for bit.

The shadow residual of both solvers is the JAX package's pseudo-random
vector ``frac(sin((i + 1) 12.9898) 43758.5453) + 0.5``, built once a size
on the host in float64 and cast: the card's and the CPU's ``sin`` then
give the same vector (in f32 at arguments near 1e6 a few ulps of ``sin``
would otherwise become ~1e-3 in ``h``, and each platform would take its
own Krylov path).
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch

from ..trace import (count, host_read, kernel_wrapper, span, spanned,
                     sync_site)
from ._build import launcher
from .tridiag import PartitionFactor, PCRFactor

CHECK_EVERY = 8      # iterations between host reads of the stop condition
_ORDERED_MAX = 8     # rows up to this wide sum strictly left to right
ROW_THREAD_MAX = 32  # coo_spmm: wider rows take a block each, not a thread


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _lanes(v):
    """(v with a lane dimension, whether it had none)."""
    return (v[None], True) if v.dim() == 1 else (v, False)


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(a):
    return torch.linalg.vector_norm(a, dim=-1)


def _ext(x):
    """x with the ground dummy (0.0) appended as slot n."""
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)


class RowPlan:
    """Deterministic segment reduction of ``(..., nnz)`` values into
    ``(..., n_out)`` slots along a static key vector (keys outside
    ``[0, n_out)`` are dropped), in O(nnz) memory.

    Built once on the host: the entries are sorted by key (stable, so a
    slot keeps its entries' original order) and the slots are bucketed by
    their entry count into power-of-two widths; each bucket is a padded
    gather table ``(slots, width)`` whose padding points at an appended
    zero.  Padding at most doubles a slot, so the tables hold under
    2 nnz + n_out entries whatever the widest slot — a rail node of
    10,000 entries costs 16,384 entries, not n_out x 10,000.  A bucket up
    to ``_ORDERED_MAX`` wide sums left to right (the JAX package's
    sequential CPU scatter order); a wider one sums in torch's fixed
    reduction order.  No atomics: a run reproduces itself bit for bit.
    ``order`` keeps the sorted positions of the kept entries and
    ``counts`` the entries of each slot (:class:`COOLayout` lays its rows
    out from them)."""

    def __init__(self, keys, n_out: int):
        keys = np.asarray(keys, np.int64).reshape(-1)
        self.n_out = int(n_out)
        nnz = keys.size
        pos = np.nonzero((keys >= 0) & (keys < n_out))[0]
        pos = pos[np.argsort(keys[pos], kind="stable")]
        slots, start, counts = np.unique(keys[pos], return_index=True,
                                         return_counts=True)
        self.order = pos                        # the kept entries by key
        self.counts = np.zeros(self.n_out, np.int64)
        self.counts[slots] = counts             # entries per slot
        width = np.ones_like(counts)
        while True:
            short = width < counts
            if not short.any():
                break
            width[short] *= 2
        self.buckets = []
        for w in np.unique(width):
            sel = np.nonzero(width == w)[0]
            cnt = counts[sel]
            table = np.full((sel.size, int(w)), nnz, np.int64)
            seg = np.repeat(np.arange(sel.size), cnt)
            first = np.repeat(start[sel], cnt)
            off = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            table[seg, off] = pos[first + off]
            self.buckets.append((slots[sel], table))
        self.entries = int(sum(t.size for _s, t in self.buckets))
        self._dev: Dict[torch.device, Any] = {}

    def _tables(self, device):
        if device not in self._dev:
            self._dev[device] = [(torch.as_tensor(s, device=device),
                                  torch.as_tensor(t, device=device))
                                 for s, t in self.buckets]
        return self._dev[device]

    def _reduce(self, vals, reduce):
        out = vals.new_zeros(vals.shape[:-1] + (self.n_out,))
        if not self.buckets:
            return out
        padded = _ext(vals)
        for slots, table in self._tables(vals.device):
            out[..., slots] = reduce(padded[..., table])
        return out

    def sum(self, vals):
        """Segment sum in the fixed order described above."""
        def fixed_sum(g):
            if g.shape[-1] > _ORDERED_MAX:
                return g.sum(-1)
            acc = g[..., 0]
            for d in range(1, g.shape[-1]):
                acc = acc + g[..., d]
            return acc
        return self._reduce(vals, fixed_sum)

    def amax(self, vals):
        """Segment max over a zero base (``zeros.at[keys].max(vals)``)."""
        return self._reduce(vals, lambda g: g.amax(dim=-1))


class COOLayout:
    """Host-built plans of a static COO pattern over n unknowns (rows and
    cols may hold the ground dummy n): the row sums of y = A x, the
    diagonal and the row maxima, each a :class:`RowPlan`, and the
    pattern in rows for the card's product (``coo_spmm``): ``rowptr``
    (n + 1) int32, ``row_cols`` int32 (the ground dummy n kept; it reads
    as 0.0), ``perm`` int64 (each row-ordered entry's position in the COO
    list) and ``wide`` int32 (the rows over ``ROW_THREAD_MAX`` entries).
    The order is the row plan's stable sort, so a row keeps its entries'
    COO order; entries of the ground row are dropped."""

    def __init__(self, rows, cols, n: int):
        rows = _host(rows).astype(np.int64).reshape(-1)
        cols = _host(cols).astype(np.int64).reshape(-1)
        self.n = int(n)
        self.nnz = rows.size
        self._cols_np = cols
        self.rows = RowPlan(rows, n)
        self.diag = RowPlan(np.where(rows == cols, rows, -1), n)
        self.perm = self.rows.order
        if self.perm.size >= 2 ** 31:
            raise ValueError(f"{self.perm.size} entries: the row layout "
                             "indexes them in int32")
        counts = self.rows.counts
        self.rowptr = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int32)
        self.row_cols = cols[self.perm].astype(np.int32)
        self.wide = np.nonzero(counts > ROW_THREAD_MAX)[0].astype(np.int32)
        self._rows_np = rows
        self._cols: Dict[torch.device, torch.Tensor] = {}
        self._csr: Dict[torch.device, Any] = {}
        # set by ``bicgstab`` once Jacobi has failed on this pattern: its
        # later solves take the chain preconditioner from the start
        self.chain_first = False

    @functools.cached_property
    def chain(self) -> "ChainPlan":
        """The pattern's :class:`ChainPlan`, built on first use."""
        return ChainPlan(self._rows_np, self._cols_np, self.n)

    def cols(self, device):
        if device not in self._cols:
            self._cols[device] = torch.as_tensor(self._cols_np, device=device)
        return self._cols[device]

    def csr(self, device):
        """(rowptr, row_cols, wide, perm) on ``device``, cached."""
        if device not in self._csr:
            self._csr[device] = tuple(
                torch.as_tensor(a, device=device)
                for a in (self.rowptr, self.row_cols, self.wide, self.perm))
        return self._csr[device]

    def bind(self, vals):
        """The product x -> A x with ``vals`` (nnz,) or (B, nnz) bound:
        a solve's operator, whose values stay fixed across its calls."""
        return COOProduct(self, vals)

    def matvec(self, vals, x):
        """y = A x; x (..., n), vals (nnz,) or (..., nnz): one call of
        ``bind(vals)``."""
        return self.bind(vals)(x)

    def matvec_plain(self, vals, x):
        """The product's plain torch twin, on any device: a gather of x at
        every entry's column, the multiply and the row plan's sum."""
        return self.rows.sum(vals * _ext(x)[..., self.cols(x.device)])

    def diagonal(self, vals):
        return self.diag.sum(vals)

    def row_max(self, vals):
        return self.rows.amax(vals.abs())


class COOProduct:
    """y = A x for the values of one solve (``COOLayout.bind``).

    Both operands on the CPU: the plain twin,
    :meth:`COOLayout.matvec_plain`.  Otherwise the hand-written kernel
    ``coo_spmm`` (or it raises): the values are gathered into row order
    once, here, and every call is one launch (two where the layout has
    rows over ``ROW_THREAD_MAX``)."""

    def __init__(self, layout: COOLayout, vals):
        self.layout, self.vals = layout, vals
        if vals.device.type != "cpu":
            self.row_vals       # the one gather a solve, outside the calls

    @functools.cached_property
    def row_vals(self):
        """The values in the layout's row order, (nnz_rows,) or (B,
        nnz_rows), contiguous."""
        perm = self.layout.csr(self.vals.device)[3]
        return self.vals[..., perm].contiguous()

    @spanned("pe.coo_matvec")
    def __call__(self, x):
        if self.vals.device.type == "cpu" and x.device.type == "cpu":
            return self.layout.matvec_plain(self.vals, x)
        return coo_spmm(self.layout, self.row_vals, x)


@kernel_wrapper
def coo_spmm(layout: COOLayout, row_vals, x):
    """y = A x on the card by ``csrc/coo_spmm.cu``: row_vals (nnz_rows,)
    or (B, nnz_rows) in ``layout``'s row order, x (n,) or (B, n), both
    float64 or both float32, contiguous on one CUDA device; y has the
    lanes of either ((n,) when both are 1-D).  Rows up to eight entries
    wide agree with the plain twin bit for bit, wider ones to rounding; a
    repeat run is bit-identical.  ``coo_spmm.launches`` counts kernel
    launches."""
    n = layout.n
    args = (("row_vals", row_vals), ("x", x))
    for name, t in args:
        if not isinstance(t, torch.Tensor) or t.dtype not in _SPMM:
            raise TypeError(f"{name} must be a float64 or float32 tensor")
    if row_vals.dtype != x.dtype:
        raise TypeError(f"row_vals is {row_vals.dtype} and x {x.dtype}")
    for name, t in args:
        if t.device.type != "cuda":
            raise ValueError(f"{name} lies on {t.device}: the product "
                             "runs on a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() not in (1, 2):
            raise ValueError(f"{name} must be 1-D or 2-D, got "
                             f"{tuple(t.shape)}")
    if row_vals.device != x.device:
        raise ValueError("row_vals and x lie on different devices")
    if row_vals.shape[-1] != layout.perm.size or x.shape[-1] != n:
        raise ValueError(f"row_vals (..., {layout.perm.size}) and x (..., "
                         f"{n}) expected, got {tuple(row_vals.shape)} and "
                         f"{tuple(x.shape)}")
    lanes = {t.shape[0] for t in (row_vals, x) if t.dim() == 2}
    if len(lanes) > 1:
        raise ValueError(f"row_vals and x differ in lanes: {lanes}")
    B = lanes.pop() if lanes else 1
    stride = lambda t: t.shape[-1] if t.dim() == 2 else 0
    y = torch.empty((B, n) if row_vals.dim() == 2 or x.dim() == 2 else (n,),
                    dtype=x.dtype, device=x.device)
    rowptr, cols, wide, _perm = layout.csr(x.device)
    n_wide = wide.numel()
    with launcher(x.device) as launch:
        launch(_SPMM[x.dtype], rowptr, cols, wide if n_wide else None,
               row_vals, stride(row_vals), x, stride(x), y, B, n,
               ROW_THREAD_MAX, n_wide)
    coo_spmm.launches += 1 + (n_wide > 0)
    return y


_SPMM = {torch.float64: "pe_coo_spmm64", torch.float32: "pe_coo_spmm32"}


def coo_matvec(rows, cols, vals, x, n: int):
    """y = A x with A in COO (duplicates sum); rows / cols may contain the
    dummy index n (ground), whose entries are dropped.  Builds the
    pattern's layout on the host; a caller that repeats a pattern keeps a
    :class:`COOLayout` instead."""
    return COOLayout(rows, cols, n).matvec(vals, x)


def coo_diagonal(rows, cols, vals, n: int):
    return COOLayout(rows, cols, n).diagonal(vals)


@functools.lru_cache(maxsize=8)
def _shadow_host(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    h = np.sin((i + 1.0) * 12.9898) * 43758.5453
    return (h - np.floor(h)) + 0.5


def shadow(n: int, dtype, device) -> torch.Tensor:
    """The shadow-residual direction h (see the module docstring)."""
    return torch.as_tensor(_shadow_host(n), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# ELLPACK layout and diagonal bands (the JAX package's scatter-free
# matvecs for static patterns)
# ---------------------------------------------------------------------------

class ELL:
    """Host-built padded-row (ELLPACK) pattern for a static COO graph:
    every row padded to the widest one, (n + 1, k) slots."""

    def __init__(self, rows, cols, n: int):
        rows = _host(rows)
        cols = _host(cols)
        self.n = n
        order = np.argsort(rows, kind="stable")
        r_s = rows[order]
        c_s = cols[order]
        counts = np.bincount(r_s, minlength=n + 1)
        self.k = int(counts.max()) if len(r_s) else 1
        slot = np.arange(len(r_s)) - np.repeat(
            np.cumsum(np.concatenate([[0], counts[:-1]])), counts)
        self.pos = (r_s.astype(np.int64) * self.k + slot)
        self.perm = order.astype(np.int64)
        colmat = np.full((n + 1) * self.k, n, np.int64)   # ghost col
        colmat[self.pos] = c_s
        self.colmat = colmat.reshape(n + 1, self.k)
        self._dev: Dict[torch.device, Any] = {}

    def _idx(self, device):
        if device not in self._dev:
            self._dev[device] = tuple(torch.as_tensor(a, device=device)
                                      for a in (self.pos, self.perm,
                                                self.colmat))
        return self._dev[device]

    def values(self, vals):
        """Place COO values into the padded layout (unique slots)."""
        pos, perm, _c = self._idx(vals.device)
        flat = vals.new_zeros(vals.shape[:-1] + ((self.n + 1) * self.k,))
        flat[..., pos] = vals[..., perm]
        return flat.reshape(vals.shape[:-1] + (self.n + 1, self.k))

    def matvec(self, valmat, x):
        _p, _q, colmat = self._idx(x.device)
        y = (valmat * _ext(x)[..., colmat]).sum(-1)
        return y[..., :self.n]

    def diag_and_rowmax(self, valmat):
        n = self.n
        _p, _q, colmat = self._idx(valmat.device)
        colmat = colmat[:n]
        rows = torch.arange(n, device=valmat.device)[:, None]
        v = valmat[..., :n, :]
        diag = torch.where(colmat == rows, v, 0.0).sum(-1)
        return diag, v.abs().amax(-1)


class BandedCOO:
    """Diagonal-offset storage plus a small COO remainder.  Circuit
    matrices are mostly local (chains, grids, companion stamps on the
    diagonal): offsets d = col - row that hold at least ``min_frac`` n
    entries (at most ``max_diags`` of them) become dense bands whose
    matvec is a shift and a multiply; the far entries stay COO.  Duck-types
    the ELL interface (``values`` / ``matvec`` / ``diag_and_rowmax``) for
    ``bicgstab_ell``."""

    def __init__(self, rows, cols, n: int, min_frac: float = 0.02,
                 max_diags: int = 16):
        rows = _host(rows).astype(np.int64)
        cols = _host(cols).astype(np.int64)
        self.n = n
        offs = cols - rows
        uniq, counts = np.unique(offs, return_counts=True)
        count_of = dict(zip(uniq.tolist(), counts.tolist()))
        keep = uniq[np.argsort(-counts)][:max_diags]
        self.offsets = sorted(int(o) for o in keep
                              if count_of[int(o)] >= min_frac * n
                              and abs(o) < n)
        offsets = np.asarray(self.offsets, np.int64)
        in_band = np.isin(offs, offsets)
        bi = np.searchsorted(offsets, offs) if offsets.size else \
            np.zeros_like(offs)
        band_key = np.where(in_band, bi * (n + 1) + rows, -1)
        self.band_plan = RowPlan(band_key, len(self.offsets) * (n + 1))
        self.rem_rows = rows[~in_band]
        self.rem_cols = cols[~in_band]
        self.nnz = len(rows)
        self._rem_sel = np.nonzero(~in_band)[0]
        self.rem_plan = RowPlan(self.rem_rows, n)
        self.rem_diag_plan = RowPlan(
            np.where(self.rem_rows == self.rem_cols, self.rem_rows, -1), n)
        self._dev: Dict[torch.device, Any] = {}

    def _idx(self, device):
        if device not in self._dev:
            self._dev[device] = (torch.as_tensor(self._rem_sel, device=device),
                                 torch.as_tensor(self.rem_cols, device=device))
        return self._dev[device]

    def values(self, vals):
        """(bands (..., ndiag, n + 1), remainder values (..., n_rem))."""
        sel, _c = self._idx(vals.device)
        bands = self.band_plan.sum(vals).reshape(
            vals.shape[:-1] + (len(self.offsets), self.n + 1))
        return bands, vals[..., sel]

    def matvec(self, valpack, x):
        bands, rem = valpack
        n = self.n
        y = None
        for i, off in enumerate(self.offsets):
            d = bands[..., i, :n]
            # y[r] += d[r] * x[r + off]  (a static shift)
            if off == 0:
                xs = x
            elif off > 0:
                xs = torch.cat([x[..., off:],
                                x.new_zeros(x.shape[:-1] + (off,))], -1)
            else:
                xs = torch.cat([x.new_zeros(x.shape[:-1] + (-off,)),
                                x[..., :off]], -1)
            y = d * xs if y is None else y + d * xs
        if y is None:
            y = x.new_zeros(x.shape)
        if len(self._rem_sel):
            _s, cc = self._idx(x.device)
            y = y + self.rem_plan.sum(rem * _ext(x)[..., cc])
        return y

    def diag_and_rowmax(self, valpack):
        bands, rem = valpack
        n = self.n
        shape = bands.shape[:-2] + (n,)
        diag = bands.new_zeros(shape)
        row_max = bands.new_zeros(shape)
        for i, off in enumerate(self.offsets):
            d = bands[..., i, :n]
            if off == 0:
                diag = diag + d
            row_max = torch.maximum(row_max, d.abs())
        if len(self._rem_sel):
            diag = diag + self.rem_diag_plan.sum(rem)
            row_max = torch.maximum(row_max, self.rem_plan.amax(rem.abs()))
        return diag, row_max


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------

def _safe(d, tiny):
    return torch.where(d == 0, torch.full_like(d, tiny), d)


class ChainPlan:
    """Host plan of a COO pattern's chain preconditioner.

    The border unknowns are the rows with no diagonal entry in the
    pattern (an MNA's voltage-source branch rows); the other m unknowns,
    in their own order, make the band.  Four :class:`RowPlan` sums gather
    from the values, duplicates summed in entry order: the band's
    tridiagonal T as (3, m) (sub, main, super diagonal), E (k, m) (band
    rows, border columns; stored by border), F (k, m) (border rows, band
    columns) and D (k, k).  Band entries off the tridiagonal and entries
    in the ground dummy's row or column are left out."""

    def __init__(self, rows, cols, n: int):
        inr = (rows < n) & (cols < n)
        has_diag = np.zeros(n, bool)
        has_diag[rows[inr & (rows == cols)]] = True
        band = np.nonzero(has_diag)[0]
        border = np.nonzero(~has_diag)[0]
        self.m, self.k = m, k = band.size, border.size
        order = np.concatenate([band, border])
        # None where the band is the first m unknowns, in order
        self.perm = (None if np.array_equal(order, np.arange(n))
                     else order)
        self.inv_perm = None if self.perm is None else np.argsort(order)
        at = np.full(n + 1, -1)                 # band position, or -1
        at[band] = np.arange(m)
        at_b = np.full(n + 1, -1)               # border position, or -1
        at_b[border] = np.arange(k)
        pr, pc = at[rows], at[cols]
        br, bc = at_b[rows], at_b[cols]
        on_band = (pr >= 0) & (pc >= 0) & (np.abs(pr - pc) <= 1)
        self.band = RowPlan(np.where(on_band, (pc - pr + 1) * m + pr, -1),
                            3 * m)
        self.e = RowPlan(np.where((pr >= 0) & (bc >= 0), bc * m + pr, -1),
                         k * m)
        self.f = RowPlan(np.where((br >= 0) & (pc >= 0), br * m + pc, -1),
                         k * m)
        self.d = RowPlan(np.where((br >= 0) & (bc >= 0), br * k + bc, -1),
                         k * k)
        self._dev: Dict[torch.device, Any] = {}

    def perms(self, device):
        """(perm, inv_perm) on ``device``, cached; (None, None) where the
        band comes first in order."""
        if self.perm is None:
            return None, None
        if device not in self._dev:
            self._dev[device] = (torch.as_tensor(self.perm, device=device),
                                 torch.as_tensor(self.inv_perm,
                                                 device=device))
        return self._dev[device]


class ChainPreconditioner:
    """M^-1 for the chain preconditioner of a solve's values: M is the
    matrix with the band's entries off its tridiagonal dropped,

        M = [T  E^T]   over (band, border),
            [F  D  ]

    factored once (:class:`ChainPlan` gathers the pieces): T, in float64,
    by :class:`~.tridiag.PartitionFactor` (shared where the values are
    (nnz,), one T a lane where they are (B, nnz)), else by
    :class:`~.tridiag.PCRFactor`; T^-1 E^T by it (k solves at once) and
    the Schur matrix S = D - F T^-1 E^T, (..., k, k), inverted.  An
    application is t = T^-1 r_band, i = S^-1 (r_border - F t),
    v = t - (T^-1 E^T) i: one partitioned solve (on the card, 7 launches
    at 10^5 band rows; PCR's right-side rounds in float32) and a few
    small products, with no host synchronisation.  On a chain-dominated
    network (a long RC or resistor chain with sparse shortcuts) M^-1 A is
    the identity plus a term of low rank for each shortcut, where Jacobi
    needs iterations in proportion to the chain's length."""

    def __init__(self, layout: COOLayout, vals):
        plan = self.plan = layout.chain
        m, k = plan.m, plan.k
        with span("pe.chain_factor"):
            count("chain.factors")
            band = plan.band.sum(vals).unflatten(-1, (3, m))
            if band.dtype == torch.float64:
                self.tri = PartitionFactor(
                    *(band[..., j, :].contiguous() for j in range(3)))
            else:
                self.tri = PCRFactor(band[..., 0, :], band[..., 1, :],
                                     band[..., 2, :])
            if k:
                e = plan.e.sum(vals).unflatten(-1, (k, m))
                self.f = plan.f.sum(vals).unflatten(-1, (k, m))
                # T^-1 E^T, (..., k, m): the k columns solved as one batch
                self.t_e = self.tri.solve(e.movedim(-2, 0)).movedim(0, -2)
                s = (plan.d.sum(vals).unflatten(-1, (k, k))
                     - self.f @ self.t_e.transpose(-1, -2))
                self.s_inv = torch.linalg.inv_ex(s).inverse

    def __call__(self, r):
        plan = self.plan
        with span("pe.chain_apply"):
            count("chain.applies")
            perm, inv_perm = plan.perms(r.device)
            if perm is not None:
                r = r[..., perm]
            t = self.tri.solve(r[..., :plan.m])
            if not plan.k:
                return t if perm is None else t[..., inv_perm]
            i = (self.s_inv @ (r[..., plan.m:] - (
                self.f @ t[..., None])[..., 0])[..., None])[..., 0]
            v = torch.cat([t - (i[..., None, :] @ self.t_e)[..., 0, :], i],
                          dim=-1)
            return v if perm is None else v[..., inv_perm]


def _krylov(mv, precond, x, r0, max_iter, stop, tiny, done=None):
    """Per-lane right-preconditioned BiCGStab from the iterate x, whose
    residual is r0.

    ``precond(v)`` applies M^-1 (Jacobi: ``minv * v``).  ``stop(r_new)``
    is each lane's convergence test.  A lane iterates
    while not done (``done``: lanes that start done), finite and under
    ``max_iter``; the update is taken only by the lanes that were
    iterating, so a lane stops as it would alone.  Returns (x,
    iterations, ok)."""
    B, n = r0.shape
    dt, dev = r0.dtype, r0.device
    with sync_site("shadow"):            # a copy from pageable host memory
        h = shadow(n, dt, dev)
    r_hat = h * _norm(r0).clamp(min=tiny)[:, None] / _norm(h)
    rho = _dot(r_hat, r0)
    r, p = r0, r0
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    if done is None:
        done = torch.zeros(B, dtype=torch.bool, device=dev)
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    k = 0
    while k < max_iter:
        with span("pe.bicgstab.burst"):
            for _ in range(min(CHECK_EVERY, max_iter - k)):
                run = (~done) & ok & (it < max_iter)
                p_hat = precond(p)
                v = mv(p_hat)
                alpha = rho / _safe(_dot(r_hat, v), tiny)
                s = r - alpha[:, None] * v
                s_hat = precond(s)
                t = mv(s_hat)
                omega = _dot(t, s) / _safe(_dot(t, t), tiny)
                x_new = (x + alpha[:, None] * p_hat
                         + omega[:, None] * s_hat)
                r_new = s - omega[:, None] * t
                rho_new = _dot(r_hat, r_new)
                beta = ((rho_new / _safe(rho, tiny))
                        * (alpha / _safe(omega, tiny)))
                p_new = r_new + beta[:, None] * (p - omega[:, None] * v)
                run2 = run[:, None]
                x = torch.where(run2, x_new, x)
                r = torch.where(run2, r_new, r)
                p = torch.where(run2, p_new, p)
                rho = torch.where(run, rho_new, rho)
                done = torch.where(run, stop(r_new), done)
                ok = torch.where(run, torch.isfinite(x_new).all(-1), ok)
                it = it + run.to(it.dtype)
                k += 1
        if not host_read(((~done) & ok & (it < max_iter)).any(),
                         "bicgstab_stop"):
            break
    count("bicgstab.iterations_launched", k)
    return x, it, ok


@spanned("pe.bicgstab")
def bicgstab(rows, cols, vals, b, n: int, x0=None, tol: float = 1e-10,
             max_iter: int = 400, layout: COOLayout = None):
    """Preconditioned BiCGStab on a COO system, in b's dtype: Jacobi
    first, escalating to the chain preconditioner.

    b (B, n) or (n,); vals (nnz,) or (B, nnz); x0 like b.  Returns (x,
    converged, iterations), per lane.  ``layout``: a prebuilt
    :class:`COOLayout` of (rows, cols) (the ``Circuit`` route caches one
    per pattern).

    A pattern runs Jacobi, as the JAX package does, until a solve of it
    leaves a lane unconverged.  That solve then runs again, with
    :class:`ChainPreconditioner` and ``max_iter`` more iterations, on
    the lanes that failed, each from its Jacobi iterate (from x0 where
    that is not finite); the converged lanes keep their answers.  The
    layout remembers it: the pattern's later solves take the chain
    preconditioner from x0 and run no Jacobi pass.  The iterations
    returned are both passes'."""
    lay = layout if layout is not None else COOLayout(rows, cols, n)
    b2, one = _lanes(b)
    b2 = b2.contiguous()
    dtype = b2.dtype
    vals = vals.to(dtype)
    mv = lay.bind(vals)
    x = (torch.zeros_like(b2) if x0 is None
         else _lanes(x0.to(dtype))[0].contiguous())
    b_norm = _norm(b2).clamp(min=1e-300)

    def stop(r_new):
        return _norm(r_new) / b_norm < tol

    def solve(precond, x, done=None):
        """One BiCGStab pass from x: (x, iterations, converged)."""
        x, it, ok = _krylov(mv, precond, x, b2 - mv(x), max_iter, stop,
                            1e-300, done=done)
        return x, it, (_norm(b2 - mv(x)) / b_norm < tol * 10.0) & ok

    if lay.chain_first:
        x, it, conv = solve(ChainPreconditioner(lay, vals), x)
    else:
        d = lay.diagonal(vals)
        # row-max-scaled Jacobi: the diagonal where it carries the row's
        # weight, else (structural-zero source rows) the row's max |entry|
        row_max = lay.row_max(vals).clamp(min=1e-300)
        minv = 1.0 / torch.where(d.abs() > 1e-3 * row_max, d, row_max)
        x_j, it, conv = solve(lambda v: minv * v, x)
        if host_read(conv.all(), "bicgstab_conv"):
            x = x_j
        else:
            count("bicgstab.escalations")
            lay.chain_first = True
            with span("pe.bicgstab.escalate"):
                x = torch.where(torch.isfinite(x_j).all(-1, keepdim=True),
                                x_j, x)
                x, it2, conv = solve(ChainPreconditioner(lay, vals), x,
                                     done=conv)
                it = it + it2
    if one:
        return x[0], conv[0], it[0]
    return x, conv, it


def bicgstab_ell(ell, vals, b, x0=None, tol: float = 1e-10,
                 max_iter: int = 400, inner_tol: float = 1e-6,
                 refine: int = 5):
    """Mixed-precision BiCGStab on an ELL / BandedCOO pattern.

    Krylov iterations run in f32; up to ``refine`` outer passes
    recompute the residual in f64 and solve for the correction until it
    meets ``tol`` (the dense GJ path's refinement discipline).  b (B, n)
    or (n,).  Returns (x, converged, total iterations), per lane."""
    f64, f32 = torch.float64, torch.float32
    b2, one = _lanes(b.to(f64))
    vm64 = ell.values(vals.to(f64))
    vm32 = tuple(a.to(f32) for a in vm64) if isinstance(vm64, tuple) \
        else vm64.to(f32)
    bnorm = _norm(b2).clamp(min=1e-300)
    x = torch.zeros_like(b2) if x0 is None else _lanes(x0.to(f64))[0]

    # f32 Jacobi preconditioner with the row-max floor (see bicgstab)
    diag, row_max = ell.diag_and_rowmax(vm32)
    row_max = row_max.clamp(min=1e-30)
    minv = 1.0 / torch.where(diag.abs() > 1e-3 * row_max, diag, row_max)
    mv32 = functools.partial(ell.matvec, vm32)

    total = torch.zeros(b2.shape[0], dtype=torch.int64, device=b2.device)
    for _ in range(refine):
        r64 = b2 - ell.matvec(vm64, x)
        r_norm = _norm(r64)
        need = r_norm / bnorm >= tol
        if not host_read(need.any(), "bicgstab_ell_refine"):
            break
        # the correction's system is solved for the unit-norm residual
        # and scaled back: BiCGStab is scale-invariant, and a residual
        # already near f64 rounding would otherwise drive the f32
        # recurrences into subnormals, where they stall on a card (and on
        # a CPU) that does not flush them to zero
        scale = r_norm.clamp(min=1e-300)[:, None]
        r32 = (r64 / scale).to(f32)
        r0n = _norm(r32).clamp(min=1e-30)

        def stop(r_new, r0n=r0n):
            return _norm(r_new) / r0n < inner_tol

        # a lane whose residual already meets tol takes no pass; a pass
        # that goes non-finite contributes dx = 0; the f64 residual below
        # is the sole convergence verdict
        dx, it, ok = _krylov(mv32, lambda v: minv * v,
                             torch.zeros_like(r32), r32,
                             max_iter, stop, 1e-30, done=~need)
        x = x + torch.where(ok[:, None], dx, 0.0).to(f64) * scale
        total = total + it
    res = _norm(b2 - ell.matvec(vm64, x)) / bnorm
    conv = (res < tol * 10.0) & torch.isfinite(x).all(-1)
    if one:
        return x[0], conv[0], total[0]
    return x, conv, total
