"""Plain dense-MNA reference of the diode ladder's fixed-step transient.

Written from the circuit's description, not from the program: its own
modified nodal analysis (node voltages, then the source's branch current),
the trapezoidal companion of each capacitor, the Shockley junction with
SPICE's junction-voltage limiting, and a full Newton solve of every step by
``torch.linalg.solve`` on the dense matrix, iterated until the update is at
rounding.  It runs in the dtype it is given: float64 is the reference,
float32 the control that a lower precision would give.

It imports nothing of the program; the element list comes from
``port_bench.ladder``.  TF32 is switched off while it runs, so a float32
product is a float32 product.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ladder import Ladder

Q_E = 1.6021765314e-19        # the upstream engine's physical constants
K_B = 1.380650524e-23
ZERO_C = 273.15
EXP_CAP = 50.0                # exp is continued linearly above this
MAX_ITER = 100


@dataclass(frozen=True)
class Junction:
    is_eff: float
    isr_eff: float
    ute: float                # N Ut
    uter: float               # Nr Ut
    vcrit: float
    bv_eff: float             # breakdown voltage, inf when not set


def junction(pn: dict) -> Junction:
    ut = K_B * (float(pn["Temp"]) + ZERO_C) / Q_E
    is_eff = float(pn["Is"]) * float(pn["Area"])
    ute = float(pn["N"]) * ut
    bv = math.inf
    if pn["Bv_set"]:
        bv = float(pn["Bv"]) - ute * math.log(float(pn["Ibv"]) / is_eff)
    return Junction(is_eff=is_eff,
                    isr_eff=float(pn["Isr"]) * float(pn["Area"]), ute=ute,
                    uter=float(pn["Nr"]) * ut,
                    vcrit=ute * math.log(ute / (math.sqrt(2.0) * is_eff)),
                    bv_eff=bv)


def _exp(x):
    e = torch.exp(x.clamp(-EXP_CAP, EXP_CAP))
    return torch.where(x > EXP_CAP, math.exp(EXP_CAP) * (1.0 + x - EXP_CAP), e)


def diode(j: Junction, v):
    """Junction current and its derivative at voltage v."""
    ef = _exp(v / j.ute)
    i = j.is_eff * (ef - 1.0)
    g = j.is_eff * ef / j.ute
    if j.isr_eff:
        er = _exp(v / j.uter)
        i = i + j.isr_eff * (er - 1.0)
        g = g + j.isr_eff * er / j.uter
    if math.isfinite(j.bv_eff):
        eb = _exp(-(j.bv_eff + v) / j.ute)
        brk = v < -j.bv_eff
        i = torch.where(brk, -j.is_eff * eb, i)
        g = torch.where(brk, j.is_eff * eb / j.ute, g)
    return i, g


def limit(j: Junction, v_new, v_old):
    """SPICE's junction-voltage limiting of a forward step (pnjlim)."""
    vt = j.ute
    big = (v_new > j.vcrit) & ((v_new - v_old).abs() > 2.0 * vt)
    arg = 1.0 + (v_new - v_old) / vt
    from_pos = torch.where(arg > 0.0,
                           v_old + vt * torch.log(arg.clamp(min=1e-300)),
                           torch.full_like(v_new, j.vcrit))
    from_neg = vt * torch.log((v_new / vt).clamp(min=1e-300))
    lim = torch.where(v_old > 0.0, from_pos, from_neg)
    return torch.where(big, lim, v_new)


def _conductance(lad: Ladder, r, dt: float, dtype, device):
    """The step-invariant part of the MNA matrix for lanes of resistances
    r (L, n_r): resistors, the source's rows and the capacitors'
    trapezoidal conductance 2C/dt."""
    L, N = r.shape[0], lad.stages
    n = N + 1
    g = 1.0 / r
    a = torch.as_tensor(lad.r_a, device=device)
    b = torch.as_tensor(lad.r_b, device=device)
    idx = torch.cat([a * n + a, b * n + b, a * n + b, b * n + a])
    vals = torch.cat([g, g, -g, -g], dim=1)
    G = torch.zeros((L, n * n), dtype=dtype, device=device)
    G.index_add_(1, idx, vals)
    G = G.view(L, n, n)
    G[:, 0, N] = 1.0                  # source + at node 0, - at ground
    G[:, N, 0] = 1.0
    d = torch.arange(N, device=device)
    G[:, d, d] += 2.0 * lad.c_node / dt
    return G


def transient(lad: Ladder, r: np.ndarray, steps: int, dt: float,
              dtype=torch.float64, device="cpu", block: int = 64):
    """Run ``steps`` trapezoidal steps of ``dt`` from rest for every lane
    of resistances ``r`` (L, n_r), ``block`` lanes at a time.

    Returns (x (L, n) numpy in ``dtype``: node voltages then the source's
    branch current; unconverged (L,) bool numpy: lanes whose Newton hit
    ``MAX_ITER`` in some step)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        xs, bad = [], []
        for s in range(0, r.shape[0], block):
            x, b = _block(lad, torch.as_tensor(r[s:s + block], dtype=dtype,
                                               device=device),
                          steps, dt)
            xs.append(x.cpu().numpy())
            bad.append(b.cpu().numpy())
        return np.concatenate(xs), np.concatenate(bad)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _block(lad: Ladder, r, steps: int, dt: float):
    dtype, device = r.dtype, r.device
    L, N = r.shape[0], lad.stages
    j = junction(lad.pn)
    eps = torch.finfo(dtype).eps
    G = _conductance(lad, r, dt, dtype, device)
    gc = 2.0 * lad.c_node / dt
    d = torch.arange(N, device=device)
    x = torch.zeros((L, N + 1), dtype=dtype, device=device)
    ic = torch.zeros((L, N), dtype=dtype, device=device)   # capacitor current
    bad = torch.zeros(L, dtype=torch.bool, device=device)
    vp, w, ph = (lad.drive["Vp"], 2.0 * math.pi * lad.drive["freq"],
                 math.radians(lad.drive["phase"]))
    for k in range(steps):
        t = (k + 1) * dt
        ieq = -gc * x[:, :N] - ic           # i_c = gc v + ieq (trapezoid)
        e = vp * math.sin(w * t + ph)
        v_used = x[:, :N].clone()
        done = torch.zeros(L, dtype=torch.bool, device=device)
        last = torch.full((L,), math.inf, dtype=dtype, device=device)
        for _ in range(MAX_ITER):
            v = limit(j, x[:, :N], v_used)
            limited = (v != x[:, :N]).any(dim=1)
            i_d, g_d = diode(j, v)
            J = G.clone()
            J[:, d, d] += g_d
            rhs = torch.zeros_like(x)
            rhs[:, :N] = -ieq - (i_d - g_d * v)
            rhs[:, N] = e
            x_new = torch.linalg.solve(J, rhs)
            step = (x_new - x).abs().amax(dim=1)
            scale = x_new.abs().amax(dim=1).clamp(min=1.0)
            # at rounding: the update is a few ulps, or has stopped
            # shrinking once it is within a few thousand
            conv = ~limited & ((step <= 16.0 * eps * scale)
                               | ((step <= 4096.0 * eps * scale)
                                  & (step >= 0.25 * last)))
            last = step
            keep = done[:, None]
            x = torch.where(keep, x, x_new)
            v_used = torch.where(keep, v_used, v)
            done = done | conv
            if bool(done.all()):
                break
        bad |= ~done
        ic = gc * x[:, :N] + ieq
    return x, bad
