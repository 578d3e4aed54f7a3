"""DC/AC small-signal sensitivity analysis, SPICE .SENS class (port of
``phy_engine_tpu/engine/sens.py``; the reference engine has none).

DC/OP: at the converged operating point x* the Newton companion matrix
A(x*, p) is the exact Jacobian of the device currents, so one more linear
step h(p) = A(x*, p)^-1 Z(x*, p), h(p*) = x*, has by the implicit-function
theorem exactly the derivative of the true solution.  One reverse sweep
of ``torch.autograd`` through the assembly and the adjoint f64 solve
(``ops.linsolve.GaussSolve``) prices d out / d p for every parameter of
every device with a single transposed solve.

AC: the bias shift is chained through in the same sweep — x_op(p) by the
one-more-step trick, a re-assembly at x_op(p) for the saved small-signal
linearizations as a function of p, then the split-real AC solve.  The
JAX package vmaps ``value_and_grad`` over ω; here every ω lane gets its
own copy of the parameters, the lanes' magnitudes are summed and one
backward pass gives each lane its own gradient.

Every parameter stays a tensor from ``params`` to the output: a host
float on the way would cut the graph and leave a zero gradient.
"""

from __future__ import annotations

import torch

from ..models.base import StampCtx
from ..ops.linsolve import dense_solve
from .analog import assemble, assemble_ac, split_real
from .lower import AnalogIR


def _leaves(params, lanes=None):
    """Fresh leaf copies of the parameter matrices that require grad, each
    with a leading lane dimension of 1 (or ``lanes``)."""
    out = {}
    for k, v in params.items():
        v = v.detach()[None]
        if lanes is not None:
            v = v.expand((lanes,) + v.shape[1:])
        out[k] = v.clone().requires_grad_()
    return out


def _lanes(tree, W: int):
    if torch.is_tensor(tree):
        return tree.expand((W,) + tree.shape)
    return {k: _lanes(v, W) for k, v in tree.items()}


def _grads(out, leaves):
    keys = list(leaves)
    g = torch.autograd.grad(out, [leaves[k] for k in keys],
                            allow_unused=True)
    return {k: (torch.zeros_like(leaves[k]) if gk is None else gk)
            for k, gk in zip(keys, g)}


def sens_op(ir: AnalogIR, params, x_op, states, env, out_idx: int,
            drives=None):
    """d x[out_idx] / d params at the converged OP of one circuit
    (``params`` {family: (n_inst, n_param)}, ``x_op`` (n,), ``drives``
    the digital drive slots held fixed).  Returns {family: (n_inst,
    n_param)} absolute sensitivities."""
    ctx = StampCtx(mode="op", t=0.0, dt=0.0, env=env)
    leaves = _leaves(params)
    with torch.enable_grad():
        A, Z, _ = assemble(ir, leaves, x_op[None], _lanes(states, 1), ctx,
                           drives)
        h = dense_solve(A, Z)[0, out_idx]
        g = _grads(h, leaves)
    return {k: v[0] for k, v in g.items()}


def sens_ac(ir: AnalogIR, params, x_op, states, env, out_idx: int, omegas,
            drives=None):
    """d |V_out(jω)| / d params over the grid ``omegas`` (W,).

    Returns ``(mag (W,), {family: (W, n_inst, n_param)})``.  The chain
    runs through the bias point and the saved small-signal
    linearizations, so a parameter that acts only by moving the bias
    (a bias resistor) is priced."""
    n = ir.n_unknowns
    W = omegas.shape[0]
    ctx = StampCtx(mode="op", t=0.0, dt=0.0, env=env)
    leaves = _leaves(params, W)
    st = _lanes(states, W)
    with torch.enable_grad():
        if ir.nonlinear:
            A, Z, _ = assemble(ir, leaves, x_op.expand(W, n), st, ctx,
                               drives)
            xop = dense_solve(A, Z)
            # re-assembly at the (p-dependent) bias reproduces the save_op
            # linearizations as a function of p
            _, _, st = assemble(ir, leaves, xop, st, ctx, drives)
        Ar, Ai, Zr, Zi = assemble_ac(ir, leaves, st, omegas)
        y = dense_solve(split_real(Ar, Ai), torch.cat([Zr, Zi], dim=1))
        re, im = y[:, out_idx], y[:, n + out_idx]
        mag = torch.sqrt(re * re + im * im + 1e-300)
        g = _grads(mag.sum(), leaves)
    return mag.detach(), g


class SensResult:
    """Named sensitivity report (host numpy arrays).

    ``rows()`` yields ``(device_name, param_name, dout_dp, normalized)``
    with ``normalized = p · dout/dp`` (SPICE's .SENS normalized column);
    for AC results each row value is an (nω,) array."""

    def __init__(self, ir: AnalogIR, grads, params):
        self.ir = ir
        self.grads = {k: v.detach().cpu().numpy() for k, v in grads.items()}
        self.params = {k: v.detach().cpu().numpy() for k, v in params.items()}

    def rows(self):
        for fam in self.ir.families:
            key = fam.mdef.id_name
            g = self.grads.get(key)
            if g is None or not fam.mdef.param_order:
                continue
            p = self.params[key]
            for i, inst in enumerate(fam.instances):
                name = getattr(inst, "name", "") or f"{key}#{i}"
                for j, pname in enumerate(fam.mdef.param_order):
                    gv = g[..., i, j]
                    val = gv if gv.ndim else float(gv)
                    pj = float(p[i, j])
                    nrm = gv * pj if gv.ndim else float(gv) * pj
                    yield name, pname, val, nrm

    def get(self, inst, pname: str):
        """Sensitivity of the output to one instance's parameter."""
        for fam in self.ir.families:
            if inst in fam.instances:
                i = fam.instances.index(inst)
                j = fam.mdef.param_order.index(pname)
                g = self.grads[fam.mdef.id_name][..., i, j]
                return g if g.ndim else float(g)
        raise KeyError("instance is not part of the lowered circuit")
