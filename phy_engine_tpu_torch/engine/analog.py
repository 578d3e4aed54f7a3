"""Batched analog engine (port of ``phy_engine_tpu/engine/analog.py``):
MNA assembly (sparse, dense f64 and AC), the per-lane Newton (dense, or
sparse through ``ops/sparse.py``'s BiCGStab) and transients of the
``Circuit`` driver, the AC sweep, and the explicit-batch
masked Newton solvers with the frozen-preconditioner transient of the
Monte-Carlo main path.

Everything takes a leading batch dimension B (Monte-Carlo lanes of one
topology): ``params`` is ``{family: (B, n_inst, n_params)}``, ``x``
``(B, n)``, ``states`` ``{family: {var: (B, n_inst)}}``, all float64.
Where the JAX package vmaps a per-lane function, the port writes the
batch dimension out; where it runs ``lax.while_loop`` / ``lax.cond`` /
``lax.scan``, the port runs a Python loop whose branch decisions read
small device tensors back to the host.

Scatter-adds are deterministic.  The COO pattern is static, so each
scatter target gets a host-built :class:`ScatterPlan`: the entries of
every output slot, in their original order, as a padded gather table.
A scatter is then a gather plus a fixed-order sum (or max) — no atomics,
so a run on the card reproduces itself bit for bit, and the sums follow
the same order as the JAX package's sequential CPU scatter.  The pattern
and the plans are shared by all lanes (one unbatched index tensor,
broadcast), never a (B, nnz) index tensor.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from .. import F32, F64
from ..models.base import StampCtx
from ..ops.gj import NB, gj_inverse32, gj_solve32
from ..ops.gj import pow2_recip_floor as _pow2_recip_floor
from ..ops.linsolve import dense_solve, lu_solve_gauss
from ..ops.lu_block import lu_block_inverse32
from ..ops.sparse import COOLayout, bicgstab
from ..trace import host_read, spanned
from .lower import AnalogIR

MAX_NEWTON_ITER = 64      # circuit.h:898


# ---------------------------------------------------------------------------
# parameter/state helpers
# ---------------------------------------------------------------------------

def initial_params(ir: AnalogIR, device="cuda",
                   dtype=F64) -> Dict[str, torch.Tensor]:
    return {f.mdef.id_name: torch.as_tensor(f.P, dtype=dtype, device=device)
            for f in ir.families}


def initial_state(ir: AnalogIR, device="cuda",
                  dtype=F64) -> Dict[str, Dict[str, torch.Tensor]]:
    return {f.mdef.id_name: {k: torch.as_tensor(v, dtype=dtype, device=device)
                             for k, v in f.state0.items()}
            for f in ir.families}


def initial_x(ir: AnalogIR, device="cuda", dtype=F64) -> torch.Tensor:
    return torch.zeros(ir.n_unknowns, dtype=dtype, device=device)


def env_scalars(env) -> Dict[str, float]:
    """Pack the Environment into the scalars of StampCtx.env."""
    return {
        "v_abstol": env.v_abstol, "v_reltol": env.v_reltol,
        "i_abstol": env.i_abstol, "i_reltol": env.i_reltol,
        "g_min": env.g_min, "r_open": env.r_open,
        "temperature": env.temperature,
    }


def _npad(n: int) -> int:
    return max(NB, ((n + NB - 1) // NB) * NB)


# ---------------------------------------------------------------------------
# static patterns and deterministic scatter plans (host-built, cached)
# ---------------------------------------------------------------------------

class ScatterPlan:
    """Deterministic scatter of ``(..., nnz)`` values into ``(..., n_out)``
    slots along a static key vector; keys outside ``[0, n_out)`` are
    dropped.  Built once on the host: ``slots`` are the distinct keys and
    ``gather[u]`` lists the entries of slot u in their original order,
    padded with an index to an appended zero."""

    def __init__(self, keys, n_out: int):
        keys = np.asarray(keys, np.int64).reshape(-1)
        self.n_out = n_out
        nnz = keys.size
        pos = np.nonzero((keys >= 0) & (keys < n_out))[0]
        pos = pos[np.argsort(keys[pos], kind="stable")]
        k = keys[pos]
        slots, start, counts = np.unique(k, return_index=True,
                                         return_counts=True)
        depth = int(counts.max()) if counts.size else 0
        gather = np.full((slots.size, depth), nnz, np.int64)
        seg = np.repeat(np.arange(slots.size), counts)
        gather[seg, np.arange(k.size) - start[seg]] = pos
        self._np = (slots, gather)
        self._dev: Dict[torch.device, Any] = {}

    def _gathered(self, vals):
        dev = vals.device
        if dev not in self._dev:
            self._dev[dev] = tuple(torch.as_tensor(a, device=dev)
                                   for a in self._np)
        slots, gather = self._dev[dev]
        padded = torch.cat([vals, vals.new_zeros(vals.shape[:-1] + (1,))], -1)
        return slots, padded[..., gather]                 # (..., U, depth)

    def _scatter(self, vals, reduce: Callable):
        out = vals.new_zeros(vals.shape[:-1] + (self.n_out,))
        if self._np[1].shape[1]:
            slots, g = self._gathered(vals)
            out[..., slots] = reduce(g)
        return out

    def sum(self, vals):
        """Segment sum, left to right in entry order (from 0)."""
        def ordered_sum(g):
            acc = g[..., 0]
            for d in range(1, g.shape[-1]):
                acc = acc + g[..., d]
            return acc
        return self._scatter(vals, ordered_sum)

    def amax(self, vals):
        """Segment max over a zero base (``zeros.at[keys].max(vals)``)."""
        return self._scatter(vals, lambda g: g.amax(dim=-1))


def _cached(ir: AnalogIR, key, build: Callable):
    if ir.cache is None:
        ir.cache = {}
    if key not in ir.cache:
        ir.cache[key] = build()
    return ir.cache[key]


def _sparse_pattern(ir: AnalogIR):
    """Concatenated static COO pattern: every family's stamp entries in
    family order, then the gmin diagonal (numpy int32, as the JAX
    package's ``_sparse_pattern``)."""
    def build():
        rows = [f.a_rows.reshape(-1) for f in ir.families if f.a_rows.size]
        cols = [f.a_cols.reshape(-1) for f in ir.families if f.a_cols.size]
        diag = np.arange(ir.n_nodes, dtype=np.int32)
        rows.append(diag)
        cols.append(diag)
        return (np.concatenate(rows).astype(np.int32),
                np.concatenate(cols).astype(np.int32))
    return _cached(ir, "sparse_pattern", build)


def _drive_nodes(ir: AnalogIR, drives):
    """The drive slots' node column: the bound nodes of ``drives`` (ground
    -> the dummy n), or every slot at the dummy n without drives."""
    n = ir.n_unknowns
    if drives is None:
        return np.full(ir.n_drive_slots, n, np.int32)
    node = np.asarray(drives["node"], np.int32)
    return np.where(node < 0, n, node).astype(np.int32)


def _full_pattern_np(ir: AnalogIR, node=None):
    """`_sparse_pattern` plus the drive-slot extension: B quadrant
    (``node``, slot), C quadrant (slot, ``node``), D identity, with
    ``node`` the slots' nodes from `_drive_nodes` (None: the dummy).

    The JAX package moves an inactive slot's B / C entries to the dummy
    row per call; here a bound slot keeps its node and an inactive one
    stamps 0 there.  The sums are the same: no other entry writes a
    drive slot's row or column."""
    node = _drive_nodes(ir, None) if node is None else node

    def build():
        rows, cols = _sparse_pattern(ir)
        if ir.n_drive_slots:
            k = ir.n_drive_slots
            base = ir.n_nodes + ir.n_branches
            drows = np.arange(base, base + k, dtype=np.int32)
            rows = np.concatenate([rows, node, drows, drows])
            cols = np.concatenate([cols, drows, node, drows])
        return rows.astype(np.int64), cols.astype(np.int64)
    return _cached(ir, ("full_pattern", node.tobytes()), build)


def _frozen_pattern(ir: AnalogIR, device, node=None):
    """COO index pattern (incl. the drive-slot extension at ``node``) as
    unbatched device tensors, shared by every lane."""
    node = _drive_nodes(ir, None) if node is None else node

    def build():
        return tuple(torch.as_tensor(a, device=device)
                     for a in _full_pattern_np(ir, node))
    return _cached(ir, ("pattern", device, node.tobytes()), build)


def _plan(ir: AnalogIR, name: str, width: int = 0,
          node=None) -> ScatterPlan:
    """The scatter plans of the shared pattern (drive slots at ``node``):
    'rows_sum' (B, n) KCL sums, 'rows_max' / 'cols_max' (B, n+1)
    equilibration maxima, 'dense' (B, width*width) the dense target."""
    node = _drive_nodes(ir, None) if node is None else node

    def build():
        rows, cols = _full_pattern_np(ir, node)
        n = ir.n_unknowns
        if name == "rows_sum":
            return ScatterPlan(rows, n)
        if name == "rows_max":
            return ScatterPlan(rows, n + 1)
        if name == "cols_max":
            return ScatterPlan(cols, n + 1)
        if name == "dense":
            keys = np.where((rows < n) & (cols < n), rows * width + cols, -1)
            return ScatterPlan(keys, width * width)
        raise ValueError(name)
    return _cached(ir, ("plan", name, width, node.tobytes()), build)


def _z_plan(ir: AnalogIR, fams) -> ScatterPlan:
    """RHS plan over the given families' z rows, in family order."""
    key = ("z_plan",) + tuple(f.mdef.id_name for f in fams)

    def build():
        parts = [f.z_rows.reshape(-1) for f in fams if f.z_rows.size]
        keys = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        return ScatterPlan(keys, ir.n_unknowns)
    return _cached(ir, key, build)


def _family_index(ir: AnalogIR, fam, device):
    """(pin, branch) gather indices of a family into x_ext (ground -> n)."""
    def build():
        n = ir.n_unknowns
        pins = np.where(fam.pin_nodes < 0, n, fam.pin_nodes)
        return (torch.as_tensor(pins, dtype=torch.int64, device=device),
                torch.as_tensor(fam.br_idx, dtype=torch.int64, device=device))
    return _cached(ir, ("fam_index", fam.mdef.id_name, device), build)


def _ext(x):
    """x with the ground dummy (0.0) appended as slot n."""
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)


def _stamp_family(ir, fam, params, x_ext, states, ctx):
    """One family's (a_vals (B, n_inst, K), z_vals (B, n_inst, Kz), new
    states), with the values of a masked family (``fam.mask``: the
    padding of ``parallel.mesh.tp_pad_ir``) multiplied by its mask."""
    pins, brs = _family_index(ir, fam, x_ext.device)
    key = fam.mdef.id_name
    a_vals, z_vals, st2 = fam.mdef.stamp(params[key], x_ext[:, pins],
                                         x_ext[:, brs], states.get(key, {}),
                                         ctx)
    return apply_mask(fam, a_vals, z_vals) + (st2,)


def apply_mask(fam, a_vals, z_vals):
    """(a_vals, z_vals) times the family's per-instance mask, when it has
    one (the JAX package's optional ``fam.mask``)."""
    msk = getattr(fam, "mask", None)
    if msk is None:
        return a_vals, z_vals
    m = torch.as_tensor(msk, dtype=a_vals.dtype, device=a_vals.device)
    a_vals = a_vals * m[:, None]
    if fam.z_rows.size:
        z_vals = z_vals * m[:, None]
    return a_vals, z_vals


def _merge(take, old, new):
    """Per-lane select over the nested state dicts: new where take."""
    def sel(a, b):
        m = take.reshape((take.shape[0],) + (1,) * (a.dim() - 1))
        return torch.where(m, b, a)
    return {k: {v: sel(old[k][v], new[k][v]) for v in old[k]} for k in old}


# ---------------------------------------------------------------------------
# sparse (COO) assembly
# ---------------------------------------------------------------------------

@spanned("pe.assemble")
def assemble_sparse(ir: AnalogIR, params, x, states, ctx: StampCtx,
                    drives=None, stamp=None):
    """COO values + RHS for the batch.

    ``drives``: optional dict with 'node' (k,) int numpy, 'active' (k,)
    and 'v' (k,) float tensors — the digital->analog branch constraints
    regenerated per tick (circuit.h:1015-1022): an active slot is an
    ideal V source from its node, an inactive one forces its current to
    0.  ``stamp``: the family stamp, ``_stamp_family`` by default (the
    mesh's instance-sharded ``parallel.mesh.sharded_stamper`` takes its
    place).  Returns (rows (nnz,), cols (nnz,), vals (B, nnz), Z (B, n),
    new_states); rows/cols are the shared unbatched pattern."""
    B = x.shape[0]
    x_ext = _ext(x)
    stamp = stamp or _stamp_family
    val_parts, z_parts, new_states = [], [], {}
    for fam in ir.families:
        a_vals, z_vals, st2 = stamp(ir, fam, params, x_ext, states, ctx)
        if fam.a_rows.size:
            val_parts.append(a_vals.reshape(B, -1))
        if fam.z_rows.size:
            z_parts.append(z_vals.reshape(B, -1))
        new_states[fam.mdef.id_name] = st2
    val_parts.append(x.new_full((B, ir.n_nodes), ctx.env.get("g_min", 0.0)))
    val_parts.extend(_drive_tail(ir, x, drives))
    vals = torch.cat(val_parts, dim=1)
    Z = _z_plan(ir, ir.families).sum(_cat(z_parts, x))
    if drives is not None and ir.n_drive_slots:
        # E value of each slot; nothing else writes the drive rows (the
        # last k unknowns)
        base = ir.n_nodes + ir.n_branches
        e = (drives["active"] * drives["v"]).to(Z.dtype)
        Z = torch.cat([Z[:, :base], Z[:, base:] + e], dim=1)
    rows, cols = _frozen_pattern(ir, x.device, _drive_nodes(ir, drives))
    return rows, cols, vals, Z, new_states


def _drive_tail(ir: AnalogIR, x, drives=None):
    """Values of the drive-slot extension, (active, active, 1 - active):
    B quadrant, C quadrant, D identity (all inactive without drives)."""
    if not ir.n_drive_slots:
        return []
    k = ir.n_drive_slots
    if drives is None:
        a = x.new_zeros((x.shape[0], k))
    else:
        a = drives["active"].to(x.dtype).expand(x.shape[0], k)
    return [a, a, 1.0 - a]


def _cat(parts, like):
    if parts:
        return torch.cat(parts, dim=1)
    return like.new_zeros((like.shape[0], 0))


def assemble(ir: AnalogIR, params, x, states, ctx, drives=None,
             stamp=None):
    """Dense (B, n, n) system, (B, n) RHS and the new device states: the
    sparse assembly scattered in entry order — the same sums, in the same
    order, as the JAX package's dense ``assemble`` (families, then gmin,
    then drive slots).  ``drives``, ``stamp``: see `assemble_sparse`."""
    n = ir.n_unknowns
    _r, _c, vals, Z, st2 = assemble_sparse(ir, params, x, states, ctx,
                                           drives, stamp)
    A = _plan(ir, "dense", n, _drive_nodes(ir, drives)).sum(vals).reshape(
        x.shape[0], n, n)
    return A, Z, st2


# ---------------------------------------------------------------------------
# convergence tests
# ---------------------------------------------------------------------------

def _device_converged(ir: AnalogIR, params, x, states):
    """AND of per-family check_conv vetos (circuit.h:950-965); (B,)."""
    ok = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    x_ext = _ext(x)
    for fam in ir.families:
        if fam.mdef.check_conv is None:
            continue
        key = fam.mdef.id_name
        pins, _ = _family_index(ir, fam, x.device)
        flags = fam.mdef.check_conv(params[key], x_ext[:, pins],
                                    states.get(key, {}))
        ok = ok & flags.all(dim=1)
    return ok


def _converged(x_old, x_new, n_nodes: int, env):
    """The reference's V/I abs+rel rule (circuit.h:900-948); (B,)."""
    va, vr = env["v_abstol"], env["v_reltol"]
    ia_, ir_ = env["i_abstol"], env["i_reltol"]
    xo_v, xn_v = x_old[:, :n_nodes], x_new[:, :n_nodes]
    xo_i, xn_i = x_old[:, n_nodes:], x_new[:, n_nodes:]
    tol_v = va + vr * torch.maximum(xn_v.abs(), xo_v.abs())
    tol_i = ia_ + ir_ * torch.maximum(xn_i.abs(), xo_i.abs())
    ok_v = ((xn_v - xo_v).abs() <= tol_v).all(dim=1)
    ok_i = ((xn_i - xo_i).abs() <= tol_i).all(dim=1)
    return ok_v & ok_i


# ---------------------------------------------------------------------------
# per-lane dense Newton and transients (the Circuit driver's path)
#
# The JAX package runs these unbatched and vmaps them for sweeps and
# Monte-Carlo.  Here every lane carries its own loop condition, as under
# vmap: a lane iterates while it has not converged, has not failed and is
# under the budget; an iterating lane takes the iteration's new states
# even when its solve failed (and then stops), while its x keeps the last
# finite value.  (The explicit-batch solvers below merge states only
# where the solve succeeded.)
# ---------------------------------------------------------------------------

def coo_layout(ir: AnalogIR, drives=None) -> COOLayout:
    """The sparse route's cached :class:`~..ops.sparse.COOLayout` of the
    shared pattern (drive slots at their bound nodes)."""
    node = _drive_nodes(ir, drives)

    def build():
        rows, cols = _full_pattern_np(ir, node)
        return COOLayout(rows, cols, ir.n_unknowns)
    return _cached(ir, ("coo_layout", node.tobytes()), build)


@spanned("pe.newton_solve")
def newton_solve(ir: AnalogIR, params, x0, states0, ctx: StampCtx,
                 max_iter: int = MAX_NEWTON_ITER, drives=None,
                 method: str = "dense", stamp=None):
    """Newton outer loop (circuit.h:892-985) per lane.  Linear circuits
    take one solve, as the reference's ``if(!has_nonlinear_device())
    return solve_once()``.  (B, ...) in; returns (x (B, n), states, ok
    (B,)).  ``drives``: the digital drive slots of every lane
    (`assemble_sparse`).

    ``method``: 'dense' — dense assembly and a dense solve
    (``dense_solve``: the f64 Gauss-Jordan for float64); 'sparse' — COO
    assembly and the f64 BiCGStab (``ops.sparse.bicgstab``: Jacobi, or
    the chain preconditioner once Jacobi has failed on the pattern; warm
    started from the lane's x), for large systems: no dense matrix is
    built (the size policy lives in the ``Circuit`` driver).  ``stamp``:
    see `assemble_sparse`."""
    if method == "sparse":
        layout = coo_layout(ir, drives)

        def solve_once(x, st):
            _r, _c, vals, Z, st2 = assemble_sparse(ir, params, x, st, ctx,
                                                   drives, stamp)
            x_new, ok, _it = bicgstab(None, None, vals, Z, ir.n_unknowns,
                                      x0=x, layout=layout)
            return x_new, st2, ok & torch.isfinite(x_new).all(dim=1)
    elif method == "dense":
        def solve_once(x, st):
            A, Z, st2 = assemble(ir, params, x, st, ctx, drives, stamp)
            x_new = dense_solve(A, Z)
            return x_new, st2, torch.isfinite(x_new).all(dim=1)
    else:
        raise ValueError(f"unknown method {method!r}")

    if not ir.nonlinear:
        return solve_once(x0, states0)
    x, st = x0, states0
    conv = torch.zeros(x0.shape[0], dtype=torch.bool, device=x0.device)
    ok = torch.ones_like(conv)
    for _ in range(max_iter):
        run = (~conv) & ok
        if not host_read(run.any(), "newton_run"):
            break
        x_new, st2, ok_new = solve_once(x, st)
        conv_new = _converged(x, x_new, ir.n_nodes, ctx.env) & ok_new
        conv_new = conv_new & _device_converged(ir, params, x_new, st2)
        x = torch.where((run & ok_new)[:, None], x_new, x)
        st = _merge(run, st, st2)
        conv = torch.where(run, conv_new, conv)
        ok = torch.where(run, ok_new, ok)
    return x, st, conv & ok


def transient(ir: AnalogIR, params, x0, states0, env, t0, dt,
              num_steps: int, drives=None, method: str = "dense"):
    """Run ``num_steps`` fixed TR steps per lane from (x0, states0) at time
    t0 (host floats; step i solves at t0 + (i+1)·dt).  A failed step keeps
    the lane's previous solution (the reference rolls back tr_duration,
    circuit.h:249-253) but takes its new states.  ``method``: the Newton
    solves' route (`newton_solve`).

    Returns (x (B, n), states, ok_all (B,), xs (B, num_steps, n))."""
    t0, dt = float(t0), float(dt)
    x, st = x0, states0
    ok_all = torch.ones(x0.shape[0], dtype=torch.bool, device=x0.device)
    xs = []
    for i in range(num_steps):
        t = t0 + (i + 1.0) * dt
        st = step_update_all(ir, params, x, st, dt, t)
        x_new, st, ok = newton_solve(ir, params, x, st,
                                     StampCtx(mode="tr", t=t, dt=dt, env=env),
                                     drives=drives, method=method)
        x = torch.where(ok[:, None], x_new, x)
        ok_all = ok_all & ok
        xs.append(x)
    return x, st, ok_all, torch.stack(xs, dim=1)


def transient_adaptive(ir: AnalogIR, params, x0, states0, env, t0, dt0,
                       t_stop, max_attempts: int, dt_min, drives=None,
                       method: str = "dense"):
    """Adaptive transient of one circuit (B = 1): step-halving on Newton
    failure, growth back toward dt0 on success (the reference declares
    ``adapt_step`` in its TR settings but never wires it).  The JAX
    package scans a fixed ``max_attempts`` rows; rows after ``done`` are
    never accepted, so this loop stops there.

    Returns (x, states, ok, ts (A,), xs (1, A, n), acc (A,)) over the A
    attempts made; ok means t reached t_stop without the step underflowing
    dt_min on a failure.  ``method``: see `newton_solve`."""
    if x0.shape[0] != 1:
        raise ValueError("transient_adaptive runs one circuit (B = 1)")
    t_stop, dt0, dt_min = float(t_stop), float(dt0), float(dt_min)
    x, st = x0, states0
    t, dt = float(t0), dt0
    failed = done = False
    ts, xs, acc = [], [], []
    for _ in range(max_attempts):
        if done:
            break
        dt_eff = min(dt, max(t_stop - t, dt_min))
        t_new = t + dt_eff
        st2 = step_update_all(ir, params, x, st, dt_eff, t_new)
        x_new, st3, ok_t = newton_solve(
            ir, params, x, st2, StampCtx(mode="tr", t=t_new, dt=dt_eff,
                                         env=env), drives=drives,
            method=method)
        ok = host_read(ok_t[0], "tr_adaptive_ok")
        if ok:
            x, st, t = x_new, st3, t_new
            dt = min(dt * 2.0, dt0)
        else:
            failed = dt * 0.5 < dt_min
            dt = dt * 0.5
        done = t >= t_stop * (1.0 - 1e-12) or failed
        ts.append(t)
        xs.append(x)
        acc.append(ok)
    xs = torch.stack(xs, dim=1) if xs else x0.new_zeros((1, 0, x0.shape[1]))
    return (x, st, done and not failed, np.asarray(ts, np.float64), xs,
            np.asarray(acc, bool))


# ---------------------------------------------------------------------------
# AC small-signal sweep: one batched solve over the omega grid, in the
# JAX package's split-real form — (Ar + jAi)(xr + jxi) = Zr + jZi solved
# as the 2n x 2n f64 system [[Ar, -Ai], [Ai, Ar]] [xr; xi] = [Zr; Zi].
# ---------------------------------------------------------------------------

def _ac_plan(ir: AnalogIR) -> ScatterPlan:
    """Dense (n*n) plan of the AC pattern: every family with an AC stamp,
    in family order, then the drive slots' identity rows."""
    def build():
        n = ir.n_unknowns
        keys = [np.where((f.a_rows < n) & (f.a_cols < n),
                         f.a_rows.astype(np.int64) * n + f.a_cols, -1)
                .reshape(-1) for f in _ac_families(ir)]
        base = ir.n_nodes + ir.n_branches
        d = np.arange(base, base + ir.n_drive_slots, dtype=np.int64)
        keys.append(d * n + d)
        return ScatterPlan(np.concatenate(keys), n * n)
    return _cached(ir, "ac_plan", build)


def _ac_families(ir: AnalogIR):
    return [f for f in ir.families if f.mdef.ac_stamp is not None]


def _lanes(a, W: int, dims: int):
    """``a`` with a leading lane dimension of W (expanded if absent)."""
    return a if a.dim() > dims else a.expand((W,) + a.shape)


def assemble_ac(ir: AnalogIR, params, states, omegas):
    """The complex MNA system at each omega of the grid ``omegas`` (W,):
    (Ar, Ai (W, n, n), Zr, Zi (W, n)).  ``params`` / ``states`` are one
    circuit's (the bias point's device states) or already carry the W
    lanes."""
    W = omegas.shape[0]
    n = ir.n_unknowns
    fams = _ac_families(ir)
    re, im, zr, zi = [], [], [], []
    for fam in fams:
        key = fam.mdef.id_name
        P = _lanes(params[key], W, 2)
        st = {k: _lanes(v, W, 1) for k, v in states.get(key, {}).items()}
        w = omegas[:, None].expand(P.shape[:-1])
        a_re, a_im, z_re, z_im = fam.mdef.ac_stamp(P, st, w)
        if fam.a_rows.size:
            re.append(a_re.reshape(W, -1))
            im.append(a_im.reshape(W, -1))
        if fam.z_rows.size:
            zr.append(z_re.reshape(W, -1))
            zi.append(z_im.reshape(W, -1))
    if ir.n_drive_slots:
        # keep the drive rows well-posed (identity) during AC
        re.append(omegas.new_ones((W, ir.n_drive_slots)))
        im.append(omegas.new_zeros((W, ir.n_drive_slots)))
    like = omegas[:, None]
    plan, zplan = _ac_plan(ir), _z_plan(ir, fams)
    return (plan.sum(_cat(re, like)).reshape(W, n, n),
            plan.sum(_cat(im, like)).reshape(W, n, n),
            zplan.sum(_cat(zr, like)), zplan.sum(_cat(zi, like)))


def split_real(Ar, Ai):
    """The real 2n x 2n form [[Ar, -Ai], [Ai, Ar]] of Ar + jAi, over a
    leading batch dimension."""
    return torch.cat([torch.cat([Ar, -Ai], dim=2),
                      torch.cat([Ai, Ar], dim=2)], dim=1)


def ac_sweep(ir: AnalogIR, params, states, omegas):
    """Solve the complex MNA at every omega of the grid in one batched
    split-real f64 solve.  Returns (xs_re, xs_im), each (W, n)."""
    n = ir.n_unknowns
    Ar, Ai, Zr, Zi = assemble_ac(ir, params, states, omegas)
    x = dense_solve(split_real(Ar, Ai), torch.cat([Zr, Zi], dim=1))
    return x[:, :n], x[:, n:]


# ---------------------------------------------------------------------------
# equilibrated dense f32 builds (the factor path)
# ---------------------------------------------------------------------------

def _scatter_dense32(ir: AnalogIR, v32, npad: int):
    """Dense f32 (B, npad, npad) target of the pattern, identity on the
    padding diagonal; entries in the ground row/column are dropped."""
    n = ir.n_unknowns
    A32 = _plan(ir, "dense", npad).sum(v32).reshape(-1, npad, npad)
    pad = torch.arange(n, npad, device=v32.device)
    A32[:, pad, pad] = 1.0
    return A32


def _equil_dense32(ir: AnalogIR, vals, npad: int):
    """Per-lane power-of-two row/col equilibration + scaled dense-f32
    scatter (shared by the delta and frozen Newton paths).  Returns
    (A32 (B, npad, npad), rs (B, n) f32, cs (B, n) f32)."""
    n = ir.n_unknowns
    rows, cols = _frozen_pattern(ir, vals.device)
    v32 = vals.abs().to(F32)
    rmax = _plan(ir, "rows_max").amax(v32).clamp(min=1e-30)
    rs = _pow2_recip_floor(rmax)                          # (B, n+1)
    v32r = vals.to(F32) * rs[:, rows]
    cmax = _plan(ir, "cols_max").amax(v32r.abs()).clamp(min=1e-30)
    cs = _pow2_recip_floor(cmax)                          # (B, n+1)
    A32 = _scatter_dense32(ir, v32r * cs[:, cols], npad)
    return A32, rs[:, :n], cs[:, :n]


def _resid64(ir: AnalogIR, vals, x, Z):
    """f64 sparse residual r = Z - A x (x gathered with ground = 0)."""
    _rows, cols = _frozen_pattern(ir, x.device)
    return Z - _plan(ir, "rows_sum").sum(vals * _ext(x)[:, cols])


def _rhs32(r, rs, npad: int):
    """Row-scaled residual as the padded f32 right-hand side."""
    B, n = r.shape
    rr = r.new_zeros((B, npad), dtype=F32)
    rr[:, :n] = (r * rs.to(F64)).to(F32)
    return rr


def _delta_solve_prep(ir: AnalogIR, params, x, states, ctx, npad: int):
    """Sparse assembly, f64 residual, power-of-two equilibration and the
    scaled dense-f32 target for the Gauss-Jordan kernel.  Returns
    (A32 (B, npad, npad), r32 (B, npad), cs (B, n) f64, resid_inf (B,),
    states2)."""
    _rows, _cols, vals, Z, st2 = assemble_sparse(ir, params, x, states, ctx)
    r = _resid64(ir, vals, x, Z)
    A32, rs, cs = _equil_dense32(ir, vals, npad)
    return (A32, _rhs32(r, rs, npad), cs.to(F64), r.abs().amax(dim=1),
            st2)


# ---------------------------------------------------------------------------
# explicit-batch Newton: gauss / delta / hybrid
# ---------------------------------------------------------------------------

def newton_solve_batched(ir: AnalogIR, params_b, x0_b, states0_b,
                         ctx: StampCtx, max_iter: int = MAX_NEWTON_ITER,
                         solver: str = "hybrid"):
    """Batched Newton: (B, ...) in, (x (B, n), states, ok (B,)) out.

    ``solver``:
      'gauss'  — per-lane f64 Gauss solves (reference-accurate, slow).
      'delta'  — delta-form Newton: each iteration solves J(x)·δ = -F(x)
                 with the f32 Gauss-Jordan kernel and an O(nnz) f64
                 sparse residual, so the fixpoint is f64-accurate.
      'hybrid' — 'delta', then a whole-batch 'gauss' rerun if any lane
                 failed.
    """
    if solver not in ("gauss", "delta", "hybrid"):
        raise ValueError(f"unknown solver {solver!r}")
    n = ir.n_unknowns
    npad = _npad(n)

    def gauss_path():
        def solve_once(x_b, st_b):
            A, Z, st2 = assemble(ir, params_b, x_b, st_b, ctx)
            x_new = lu_solve_gauss(A, Z)
            return x_new, st2, torch.isfinite(x_new).all(dim=1)

        return _newton_loop_batched(ir, params_b, x0_b, states0_b, ctx,
                                    solve_once, max_iter, linear_iters=1)

    if solver == "gauss":
        return gauss_path()

    def solve_once(x_b, st_b):
        A32, r32, cs, _resid, st2 = _delta_solve_prep(
            ir, params_b, x_b, st_b, ctx, npad)
        d32 = gj_solve32(A32, r32)
        x_new = x_b + d32[:, :n].to(F64) * cs
        return x_new, st2, torch.isfinite(x_new).all(dim=1)

    # linear circuits still need 2 delta iterations (solve + refinement)
    out = _newton_loop_batched(ir, params_b, x0_b, states0_b, ctx,
                               solve_once, max_iter, linear_iters=2)
    if solver == "delta" or host_read(out[2].all(), "newton_batched_ok"):
        return out
    return gauss_path()


def _newton_loop_batched(ir, params_b, x0_b, states0_b, ctx, solve_once,
                         max_iter, linear_iters: int):
    """Shared masked batched Newton outer loop."""
    B = x0_b.shape[0]
    if not ir.nonlinear:
        x, st = x0_b, states0_b
        ok = torch.ones(B, dtype=torch.bool, device=x0_b.device)
        for _ in range(linear_iters):
            x, st, ok2 = solve_once(x, st)
            ok = ok & ok2
        return x, st, ok

    x, st = x0_b, states0_b
    conv = torch.zeros(B, dtype=torch.bool, device=x0_b.device)
    ok = torch.ones(B, dtype=torch.bool, device=x0_b.device)
    it = 0
    while it < max_iter and host_read(((~conv) & ok).any(),
                                      "newton_batched_run"):
        active = (~conv) & ok
        x_new, st2, ok_new = solve_once(x, st)
        conv_new = _converged(x, x_new, ir.n_nodes, ctx.env) & ok_new
        conv_new = conv_new & _device_converged(ir, params_b, x_new, st2)
        take = active & ok_new
        x = torch.where(take[:, None], x_new, x)
        st = _merge(take, st, st2)
        conv = torch.where(active, conv_new, conv)
        ok = ok & (ok_new | ~active)
        it += 1
    return x, st, conv & ok


# ---------------------------------------------------------------------------
# frozen-preconditioner Newton (the transient hot path)
# ---------------------------------------------------------------------------

FROZEN_STALL = 16    # frozen-preconditioner refactor cadence (iters)
FROZEN_RATE = 0.85   # refactor when residual contraction is worse
FROZEN_GROW_FRAC = 0.25   # refresh when > this fraction of active lanes
                          # contracts worse than FROZEN_RATE
FROZEN_BAD_FRAC = 0.1     # escalate refresh -> full refactor when > this
                          # fraction sits outside the Newton-Schulz basin
FROZEN_INVERSES = {"gj": gj_inverse32,          # refactor kernels (inv=...)
                   "block": lu_block_inverse32}


def frozen_fac_init(B: int, n: int, npad: int, device="cuda"):
    """Empty factor carry for `newton_solve_frozen` (valid=False):
    (Minv (B, npad, npad) f32, rs, cs (B, n) f32, tol (B, n) f64, valid)."""
    return (torch.zeros((B, npad, npad), dtype=F32, device=device),
            torch.ones((B, n), dtype=F32, device=device),
            torch.ones((B, n), dtype=F32, device=device),
            torch.full((B, n), torch.inf, dtype=F64, device=device),
            False)


def _frozen_cache(ir: AnalogIR, params, x, states, ctx):
    """Once per Newton call: everything constant across the call's
    iterations — LINEAR family stamp values (pure in (P, state, ctx) by
    the engine's linear-device contract), the gmin diagonal, the
    drive-slot values and the static part of Z.

    Returns (parts: {family: (B, nnz_f) A values}, Z_stat (B, n),
    tail_vals (B, 3k)) mirroring assemble_sparse's value ordering."""
    B = x.shape[0]
    x_ext = _ext(x)
    parts, z_parts = {}, []
    lin = [f for f in ir.families if not f.mdef.nonlinear]
    for fam in lin:
        a_vals, z_vals, _st2 = _stamp_family(ir, fam, params, x_ext, states,
                                             ctx)
        if fam.a_rows.size:
            parts[fam.mdef.id_name] = a_vals.reshape(B, -1)
        if fam.z_rows.size:
            z_parts.append(z_vals.reshape(B, -1))
    parts["__gmin__"] = x.new_full((B, ir.n_nodes), ctx.env.get("g_min", 0.0))
    tail = _drive_tail(ir, x)
    tail_vals = torch.cat(tail, dim=1) if tail else x.new_zeros((B, 0))
    Z_stat = _z_plan(ir, lin).sum(_cat(z_parts, x))
    return parts, Z_stat, tail_vals


def _frozen_resid_cached(ir: AnalogIR, params, x, states, ctx, cache):
    """Per-iteration work with the static cache: re-stamp only NONLINEAR
    families, splice their values into the cached pattern, and take the
    O(nnz) f64 residual.  Returns (r (B, n), new_states, vals, Zf)."""
    parts, Z_stat, tail_vals = cache
    B = x.shape[0]
    x_ext = _ext(x)
    val_parts, z_parts, new_states = [], [], {}
    nonlin = []
    for fam in ir.families:
        key = fam.mdef.id_name
        if not fam.mdef.nonlinear:
            if key in parts:
                val_parts.append(parts[key])
            new_states[key] = states.get(key, {})
            continue
        nonlin.append(fam)
        a_vals, z_vals, st2 = _stamp_family(ir, fam, params, x_ext, states,
                                            ctx)
        if fam.a_rows.size:
            val_parts.append(a_vals.reshape(B, -1))
        if fam.z_rows.size:
            z_parts.append(z_vals.reshape(B, -1))
        new_states[key] = st2
    val_parts.append(parts["__gmin__"])
    if tail_vals.shape[1]:
        val_parts.append(tail_vals)
    vals = torch.cat(val_parts, dim=1)
    Zf = _z_plan(ir, nonlin).sum(_cat(z_parts, x)) + Z_stat
    return _resid64(ir, vals, x, Zf), new_states, vals, Zf


def _frozen_tol(ir: AnalogIR, vals, Zf, x, env):
    """Row-wise f64 KCL residual tolerances frozen with the factor."""
    _rows, cols = _frozen_pattern(ir, x.device)
    sc = _plan(ir, "rows_sum").sum((vals * _ext(x)[:, cols]).abs())
    return env["i_abstol"] + env["i_reltol"] * (sc + Zf.abs())


def _dense_stale32(ir: AnalogIR, vals, rs, cs, npad: int):
    """Dense f32 scatter with GIVEN (stale) equilibration scales — the
    Newton-Schulz refresh must build A in the same scaled basis the
    stored inverse lives in.  (Pattern indices never exceed the ground
    dummy n, whose scale is 1.)"""
    rows, cols = _frozen_pattern(ir, vals.device)
    one = rs.new_ones((rs.shape[0], 1))
    rsx = torch.cat([rs, one], dim=1)
    csx = torch.cat([cs, one], dim=1)
    v32 = vals.to(F32) * rsx[:, rows] * csx[:, cols]
    return _scatter_dense32(ir, v32, npad)


def _ns_refresh(Minv, A32, steps: int = 2):
    """Newton-Schulz inverse refresh X <- X(2I - A X), two f32 GEMM
    pairs, guarded per lane: lanes with ||I - A X||_inf >= 0.9 (outside
    the contraction basin) keep the old inverse.  Returns (X, e)."""
    eye = torch.eye(A32.shape[1], dtype=F32, device=A32.device)
    X = Minv
    e = None
    for _ in range(steps):
        AX = torch.bmm(A32, X)
        if e is None:
            e = (eye - AX).abs().sum(dim=2).amax(dim=1)
        X = torch.bmm(X, 2.0 * eye - AX)
    return torch.where((e < 0.9)[:, None, None], X, Minv), e


def _frozen_inverse(inv: str):
    if inv not in FROZEN_INVERSES:
        raise ValueError(f"inv must be one of {sorted(FROZEN_INVERSES)}, "
                         f"got {inv!r}")
    return FROZEN_INVERSES[inv]


def newton_solve_frozen(ir: AnalogIR, params_b, x0_b, states0_b,
                        ctx: StampCtx, fac=None,
                        max_iter: int = MAX_NEWTON_ITER, inv: str = "gj"):
    """Frozen-preconditioner Newton.

    Each iteration prices O(nnz) f64 work (nonlinear stamps + sparse
    residual) plus one batched f32 matvec against a stored explicit
    inverse M^-1 = J(x_f)^-1, computed at refactor points by
    `gj_inverse32` (``inv='gj'``, the default) or by the blocked
    `lu_block_inverse32` (``inv='block'``: pivoting within each 32 x 32
    diagonal block; a lane whose leading block is singular comes out
    non-finite, fails its isfinite gate and goes to the caller's rescue
    ladder) — the JAX package's ``FROZEN_INV`` knob as an argument.
    Because the residual is f64 the fixpoint is f64-accurate however
    stale M is.  Between refactors a Newton-Schulz GEMM pair refreshes
    M; on residual growth a burst iteration solves the fresh Jacobian
    directly with `gj_solve32`.  The factor carry ``fac`` survives
    across transient steps.

    Returns (x, states, ok, fac).
    """
    inverse32 = _frozen_inverse(inv)
    B, n = x0_b.shape
    npad = _npad(n)
    dev = x0_b.device
    if fac is None:
        fac = frozen_fac_init(B, n, npad, dev)
    env = ctx.env
    cache = _frozen_cache(ir, params_b, x0_b, states0_b, ctx)

    def refac(vals, Zf, x, it):
        # reuse this iteration's stamped values: no second assembly
        A32, rs2, cs2 = _equil_dense32(ir, vals, npad)
        return (inverse32(A32), rs2, cs2,
                _frozen_tol(ir, vals, Zf, x, env), it)

    x, st = x0_b, states0_b
    it = 0
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    Minv, rs, cs, tol, valid = fac
    last = 0
    prev_rn = torch.full((B,), torch.inf, dtype=F64, device=dev)
    while it < max_iter and host_read(((~conv) & ok).any(),
                                      "frozen_run"):
        active = (~conv) & ok
        r, st2, vals, Zf = _frozen_resid_cached(ir, params_b, x, st, ctx,
                                                cache)
        rn = r.abs().amax(dim=1)
        # refresh policy: population trigger on contraction worse than
        # FROZEN_RATE, the stall cadence, or step entry with a carry;
        # outright residual growth in any active lane = burst (fresh
        # direct solve, carry invalidated)
        grew = active & (rn > FROZEN_RATE * prev_rn)
        n_act, n_grew, n_burst = host_read(torch.stack([
            active.sum(), grew.sum(), (active & (rn > prev_rn)).sum()
        ]), "frozen_policy")
        burst = n_burst > 0
        frac_grew = n_grew / max(n_act, 1)
        need = ((not valid) or it == 0 or it - last >= FROZEN_STALL
                or frac_grew > FROZEN_GROW_FRAC)
        if (not valid) and not burst:
            Minv, rs, cs, tol, last = refac(vals, Zf, x, it)
        elif need and not burst:
            # stale-scaled rebuild + guarded Newton-Schulz; escalate to a
            # full refactor when too many active lanes sit outside the
            # basin (the Jacobian moved a lot, e.g. diode switching)
            X2, e = _ns_refresh(Minv, _dense_stale32(ir, vals, rs, cs, npad))
            n_bad = host_read(((e >= 0.9) & active).sum(), "frozen_basin")
            if n_bad / max(n_act, 1) > FROZEN_BAD_FRAC:
                Minv, rs, cs, tol, last = refac(vals, Zf, x, it)
            else:
                Minv, last = X2, it
        # row-wise f64 residual criterion (KCL) for stale iterations
        resid_ok = (r.abs() <= tol).all(dim=1)
        if burst:
            # burst iteration: fresh Jacobian, direct factor-solve
            A32, rs_b, cs_b = _equil_dense32(ir, vals, npad)
            d = gj_solve32(A32, _rhs32(r, rs_b, npad))
            delta = d[:, :n].to(F64) * cs_b.to(F64)
        else:
            d = torch.bmm(Minv, _rhs32(r, rs, npad)[:, :, None])[:, :, 0]
            delta = d[:, :n].to(F64) * cs.to(F64)
        x_new = x + delta
        ok_new = torch.isfinite(x_new).all(dim=1)
        conv_new = (_converged(x, x_new, ir.n_nodes, env) & ok_new
                    & (resid_ok | burst))
        conv_new = conv_new & _device_converged(ir, params_b, x_new, st2)
        take = active & ok_new
        x = torch.where(take[:, None], x_new, x)
        st = _merge(take, st, st2)
        conv = torch.where(active, conv_new, conv)
        ok = ok & (ok_new | ~active)
        valid = not burst
        prev_rn = torch.where(active, rn, prev_rn)
        it += 1
    return x, st, conv & ok, (Minv, rs, cs, tol, valid)


# ---------------------------------------------------------------------------
# batched fixed-step transient
# ---------------------------------------------------------------------------

def transient_batched(ir: AnalogIR, params_b, x0_b, states0_b, env, t0,
                      dt, num_steps: int, solver: str = "hybrid",
                      keep_trace: bool = False,
                      max_iter: int = MAX_NEWTON_ITER, inv: str = "gj"):
    """Batched fixed-step transient over the explicit-batch Newton path.

    ``t0`` and ``dt`` are host floats; step i solves at t0 + (i+1)·dt.
    Returns (x (B, n), states, ok (B,), xs) — xs is (num_steps, B, n)
    when keep_trace else the final x.

    ``solver='frozen'`` threads the frozen factor carry across steps and
    runs a per-step rescue ladder: when any lane fails, the step is
    rerun for the whole batch with 'hybrid' (fresh-factor delta, then
    f64 Gauss), failed lanes take the rescued result, and the carry is
    invalidated for the whole batch.  ``inv`` picks the frozen refactor
    (``'gj'`` or ``'block'``, see `newton_solve_frozen`); the other
    solvers ignore it."""
    if solver == "frozen":
        _frozen_inverse(inv)             # an unknown name raises up front
    t0 = float(t0)
    dt = float(dt)
    B = x0_b.shape[0]
    x, st = x0_b, states0_b
    ok_all = torch.ones(B, dtype=torch.bool, device=x0_b.device)
    fac = None
    if solver == "frozen":
        fac = frozen_fac_init(B, ir.n_unknowns, _npad(ir.n_unknowns),
                              x0_b.device)
    trace = []
    for i in range(num_steps):
        t = t0 + (i + 1.0) * dt
        st = step_update_all(ir, params_b, x, st, dt, t)
        ctx = StampCtx(mode="tr", t=t, dt=dt, env=env)
        if solver == "frozen":
            # warm start = previous solution, no extrapolation
            x_new, st2, ok, fac = newton_solve_frozen(
                ir, params_b, x, st, ctx, fac=fac, max_iter=max_iter,
                inv=inv)
            if not host_read(ok.all(), "tr_rescue"):
                x_r, st_r, ok_r = newton_solve_batched(
                    ir, params_b, x, st, ctx, max_iter=max_iter,
                    solver="hybrid")
                take = (~ok) & ok_r
                st2 = _merge(take, st2, st_r)
                x_new = torch.where(take[:, None], x_r, x_new)
                ok = ok | ok_r
                fac = fac[:4] + (False,)
        else:
            x_new, st2, ok = newton_solve_batched(
                ir, params_b, x, st, ctx, max_iter=max_iter, solver=solver)
        x = torch.where(ok[:, None], x_new, x)
        st = st2
        ok_all = ok_all & ok
        if keep_trace:
            trace.append(x)
    xs = torch.stack(trace) if keep_trace else x
    return x, st, ok_all, xs


# ---------------------------------------------------------------------------
# companion-model step update (update_tr_step, circuit.h:363-374)
# ---------------------------------------------------------------------------

def step_update_all(ir: AnalogIR, params, x, states, dt, t):
    x_ext = _ext(x)
    out = {}
    for fam in ir.families:
        key = fam.mdef.id_name
        st = states.get(key, {})
        if fam.mdef.step_update is None:
            out[key] = st
            continue
        pins, brs = _family_index(ir, fam, x.device)
        out[key] = fam.mdef.step_update(params[key], x_ext[:, pins],
                                        x_ext[:, brs], st, dt, t)
    return out
