"""Batched analysis of one topology (port of
``phy_engine_tpu/parallel/batch.py``): Monte-Carlo, corners and sweeps.

``batch_params`` / ``batch_state`` / ``batch_x`` tile the IR's arrays
into a leading batch dimension; the lognormal parameter jitter is drawn
from an explicit ``torch.Generator``.  ``batched_op`` /
``batched_transient`` run the per-lane dense Newton of
:mod:`..engine.analog` over the batch — the JAX package's ``vmap`` of
``newton_solve`` / ``transient``, with the batch dimension written
out.  ``params_from_numpy`` / ``state_from_numpy`` carry arrays drawn
elsewhere (e.g. by the JAX package's ``batch_params``, whose PRNG the
port does not re-implement) into the port's float64 tensors, so both
packages run on identical inputs.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import F64
from ..engine import analog
from ..engine.lower import AnalogIR
from ..models.base import StampCtx


def batch_params(ir: AnalogIR, n: int, jitter: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """Tile the IR's parameters into a batch of n circuits.

    ``jitter``: optional {family_id: {param_name: rel_sigma}}; each named
    column is multiplied by exp(sigma * N(0, 1)) drawn per lane and
    instance from ``generator`` (on the CPU, then moved to ``device``).
    """
    return jitter_params(ir, analog.initial_params(ir, "cpu"), n, jitter,
                         generator, device)


def jitter_params(ir: AnalogIR, base: Dict[str, torch.Tensor], n: int,
                  jitter: Optional[Dict] = None,
                  generator: Optional[torch.Generator] = None,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Tile one circuit's parameter matrices ``base`` ({family: (n_inst,
    n_params)}) into n lanes, with ``batch_params``' jitter (drawn and
    applied on the CPU, in family order, then moved to ``device``)."""
    out = {}
    for fam in ir.families:
        k = fam.mdef.id_name
        P = base[k].cpu().expand((n,) + base[k].shape).clone()
        if jitter and k in jitter:
            for pname, sigma in jitter[k].items():
                col = fam.mdef.param_order.index(pname)
                z = torch.randn((n, P.shape[1]), generator=generator,
                                dtype=F64)
                P[:, :, col] *= torch.exp(sigma * z)
        out[k] = P.to(device)
    return out


def batch_state(ir: AnalogIR, n: int, device="cuda", dtype=F64):
    st = analog.initial_state(ir, device, dtype)
    return {k: {v: a.expand((n,) + a.shape).clone() for v, a in d.items()}
            for k, d in st.items()}


def batch_x(ir: AnalogIR, n: int, device="cuda", dtype=F64) -> torch.Tensor:
    return torch.zeros((n, ir.n_unknowns), dtype=dtype, device=device)


def batched_op(ir: AnalogIR, params_b, x_b, states_b, env, mode: str = "op",
               t: float = 0.0):
    """Batched operating-point solve: (B, ...) in, (x (B, n), states,
    ok (B,)) out, each lane with its own Newton loop."""
    ctx = StampCtx(mode=mode, t=float(t), dt=0.0, env=env)
    return analog.newton_solve(ir, params_b, x_b, states_b, ctx)


def batched_transient(ir: AnalogIR, params_b, x_b, states_b, env, t0, dt,
                      num_steps: int, keep_trace: bool = False):
    """Batched fixed-step transient: every circuit of the batch advances
    ``num_steps`` with its own masked Newton loop.  Returns (x, states,
    ok, xs): xs is (B, num_steps, n) when ``keep_trace``, else the final
    x."""
    x, st, ok, xs = analog.transient(ir, params_b, x_b, states_b, env, t0,
                                     dt, num_steps)
    return x, st, ok, (xs if keep_trace else xs[:, -1])


def params_from_numpy(ir: AnalogIR, arrays: Dict[str, np.ndarray],
                      device="cuda") -> Dict[str, torch.Tensor]:
    """{family: (B, n_inst, n_params) array} -> the port's f64 tensors."""
    out = {}
    for fam in ir.families:
        k = fam.mdef.id_name
        a = torch.as_tensor(np.array(arrays[k], np.float64), device=device)
        if a.dim() != 3 or tuple(a.shape[1:]) != fam.P.shape:
            raise ValueError(f"params[{k!r}] has shape {tuple(a.shape)}, "
                             f"expected (B,) + {fam.P.shape}")
        out[k] = a.contiguous()
    return out


def state_from_numpy(ir: AnalogIR, arrays: Dict[str, Dict[str, np.ndarray]],
                     device="cuda"):
    """{family: {var: (B, n_inst) array}} -> the port's f64 tensors."""
    out = {}
    for fam in ir.families:
        k = fam.mdef.id_name
        out[k] = {}
        for v in fam.state0:
            a = torch.as_tensor(np.array(arrays[k][v], np.float64),
                                device=device)
            if a.dim() != 2 or a.shape[1] != fam.state0[v].shape[0]:
                raise ValueError(f"state[{k!r}][{v!r}] has shape "
                                 f"{tuple(a.shape)}")
            out[k][v] = a.contiguous()
    return out
