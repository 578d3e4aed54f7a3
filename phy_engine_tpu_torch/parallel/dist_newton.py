"""Fully distributed Newton for ONE circuit (port of
``phy_engine_tpu/parallel/dist_newton.py``).

Joins the two distributed axes:

* instance-sharded stamping (``mesh.tp_pad_ir`` mask padding; each rank
  stamps its slice of every family and the stamp values are summed across
  ranks, ``mesh.sharded_stamper``), and
* the cooperative column-sharded factorization (``dist_gj``): the delta
  system is scattered block-cyclic per rank and factored with one psum
  broadcast per 128-column panel.

The outer loop is the reference's Newton (circuit.h:892-985: V/I abs+rel
convergence and the per-model veto) in delta form: each iteration
assembles the COO system at x, takes the f64 residual r = Z - A·x in
O(nnz) through the assembler's fixed-order row plans, equilibrates with
exact powers of two (row / column maxima by order-free scatter-max), and
solves A·dx = r cooperatively in f32 — the delta iteration itself is the
f64 refinement.  A dx whose linear solve fails validation (rel >= 1e-3)
or is non-finite is not taken: the iteration reports failure.

``transient_dist`` runs the same step inside fixed-step TR, the companion
updates (``analog.step_update_all``) applied to the padded state;
``ac_solve_dist`` solves each omega's 2n-real split system with
``dist_gj.dist_solve``.  Every loop decision reads all-reduced flags.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import F64
from ..engine import analog
from ..engine.lower import AnalogIR
from ..models.base import StampCtx
from ..ops.gj import NB, pow2_recip_floor
from .dist_gj import dist_solve, make_dist_delta_solver
from .mesh import (_tree_map, all_true, axis_size, mesh_device, pad_states,
                   sharded_stamper, tp_pad_ir)


class _Problem:
    """The padded circuit on the mesh: IR, batched (B = 1) params and
    states on the rank's device, the sharded stamp and the cached
    cooperative solver."""

    def __init__(self, ir: AnalogIR, mesh, params, states0):
        D = axis_size(mesh)
        self.dev = mesh_device(mesh)
        self.n = ir.n_unknowns
        self.npad = -(-self.n // (NB * D)) * (NB * D)
        self.ir = ir
        self.ir2, pad_params = tp_pad_ir(ir, D)
        self.params = {k: v.to(self.dev, F64)[None]
                       for k, v in pad_params(params).items()}
        self.states = _tree_map(lambda v: v.to(self.dev, F64)[None],
                                pad_states(self.ir2, states0))
        self.stamp = sharded_stamper(mesh)
        self.solver = make_dist_delta_solver(mesh, self.n, self.npad)
        self.mesh = mesh

    def x(self, x0):
        x = torch.as_tensor(np.asarray(x0) if not torch.is_tensor(x0)
                            else x0, dtype=F64)
        return x.to(self.dev)

    def step(self, x, st, ctx):
        """One delta-Newton iteration at x (n,).  Returns (x_new, states2,
        conv, ok) with conv / ok host booleans agreed by every rank."""
        ir2, n, npad = self.ir2, self.n, self.npad
        rows, cols, vals, Z, st2 = analog.assemble_sparse(
            ir2, self.params, x[None], st, ctx, stamp=self.stamp)
        r = analog._resid64(ir2, vals, x[None], Z)
        rmax = analog._plan(ir2, "rows_max").amax(vals.abs()).clamp(
            min=1e-300)
        rs = pow2_recip_floor(rmax)                          # (1, n+1)
        vr = vals * rs[:, rows]
        cmax = analog._plan(ir2, "cols_max").amax(vr.abs()).clamp(
            min=1e-300)
        cs = pow2_recip_floor(cmax)
        rp = x.new_zeros(npad)
        rp[:n] = r[0] * rs[0, :n]
        dxs, rel = self.solver(rows, cols, (vr * cs[:, cols])[0], rp)
        dx = dxs[:n] * cs[0, :n]
        ok = torch.isfinite(dx).all() & (rel < 1e-3)
        x_new = torch.where(ok, x + dx, x)
        conv = analog._converged(x[None], x_new[None], self.ir.n_nodes,
                                 ctx.env)
        conv = conv & analog._device_converged(ir2, self.params, x_new[None],
                                               st2)
        conv_ok, ok = all_true(self.mesh, None, conv & ok, ok)
        return x_new, st2, conv_ok, ok


def _unbatch(st):
    return _tree_map(lambda v: v[0], st)


def newton_solve_dist(ir: AnalogIR, mesh, params, x0, states0, env,
                      mode: str = "op", max_iter: int = 64):
    """Operating point of one circuit with both the stamping and the
    factorization distributed over ``mesh``.  ``params``: {family:
    (n_inst, n_params)}; ``x0`` (n,); ``states0`` {family: {var:
    (n_inst,)}}; ``env``: ``analog.env_scalars``.  Returns (x (n,), padded
    states, ok) replicated on every rank, like ``analog.newton_solve``.
    Linear circuits converge in 2-3 delta iterations."""
    prob = _Problem(ir, mesh, params, states0)
    ctx = StampCtx(mode=mode, t=0.0, dt=0.0, env=env)
    x, st = prob.x(x0), prob.states
    conv = ok = False
    for _ in range(max_iter):
        x, st, conv, ok = prob.step(x, st, ctx)
        if conv or not ok:
            break
    return x, _unbatch(st), conv and ok


def transient_dist(ir: AnalogIR, mesh, params, x0, states0, env,
                   t0: float, dt: float, num_steps: int,
                   max_iter: int = 64):
    """Fixed-step transient of one circuit, fully distributed (sharded
    stamping and the cooperative factorization in every Newton
    iteration); step k solves at t0 + (k + 1)·dt.

    Returns (x, padded states, ok, xs): xs the (steps, n) numpy trajectory
    of the accepted steps; a failed step stops the run with ok False and
    the trajectory so far."""
    prob = _Problem(ir, mesh, params, states0)
    x, st = prob.x(x0), prob.states
    t0, dt = float(t0), float(dt)
    hist = []
    for k in range(num_steps):
        t = t0 + (k + 1) * dt
        st = analog.step_update_all(prob.ir2, prob.params, x[None], st, dt,
                                    t)
        ctx = StampCtx(mode="tr", t=t, dt=dt, env=env)
        conv = False
        for _ in range(max_iter):
            x, st, conv, ok = prob.step(x, st, ctx)
            if not ok:
                return x, _unbatch(st), False, np.asarray(hist)
            if conv:
                break
        if not conv:
            return x, _unbatch(st), False, np.asarray(hist)
        hist.append(x.cpu().numpy())
    return x, _unbatch(st), True, np.asarray(hist)


def ac_solve_dist(ir: AnalogIR, mesh, params, states, omegas):
    """Cooperative single-system AC: each omega's complex MNA is solved as
    the 2n-real block system [[Ar, -Ai], [Ai, Ar]] padded with identity to
    a multiple of 128·D, its columns block-cyclic over ``mesh``
    (``dist_solve``: validated residual and f64 fallback; its
    ``RuntimeError`` propagates).  Assembly is replicated; the
    factorization is what distributes.  ``params`` / ``states``: one
    circuit's ({family: (n_inst, n_params)} / the bias point's states).
    Returns the (n_omega, n) complex numpy solutions."""
    dev = mesh_device(mesh)
    n = ir.n_unknowns
    D = axis_size(mesh)
    m = 2 * n
    mpad = -(-m // (NB * D)) * (NB * D)
    params = {k: v.to(dev, F64) for k, v in params.items()}
    states = _tree_map(lambda v: v.to(dev, F64), states)
    outs = []
    for w in np.asarray(omegas, np.float64):
        Ar, Ai, Zr, Zi = analog.assemble_ac(
            ir, params, states, torch.tensor([w], dtype=F64, device=dev))
        M = torch.zeros((mpad, mpad), dtype=F64, device=dev)
        M[:m, :m] = analog.split_real(Ar, Ai)[0]
        pad = torch.arange(m, mpad, device=dev)
        M[pad, pad] = 1.0
        rhs = torch.zeros(mpad, dtype=F64, device=dev)
        rhs[:n], rhs[n:m] = Zr[0], Zi[0]
        x = dist_solve(mesh, M, rhs, refine=2).cpu().numpy()
        outs.append(x[:n] + 1j * x[n:m])
    return np.stack(outs)
