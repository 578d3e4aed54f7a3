"""Time-dependent waveform generators (port of ``phy_engine_tpu/models/
sources.py``; reference ``model/models/generator/*.h``).

All are ideal voltage sources (one branch) whose E value is a waveform of
``ctx.t`` during TR; for DC/OP the value at t=0 is used (square.h:115-117);
AC small-signal excitation is 0 (treated as short).
"""

from __future__ import annotations

import torch

from .base import ModelDef, DeviceClass, register
from .linear import TWO_PI, pat_vsrc, rhs_branch, row, zeros, _VSRC_VALS


def _mod(a, b):
    """Floored modulo, the sign of ``b`` (``jnp.mod``: fmod, then + b
    where the remainder's sign differs from b's)."""
    m = torch.fmod(a, b)
    return torch.where((m != 0) & ((m < 0) != (b < 0)), m + b, m)


def _mk_src(name, id_name, defaults, wave_fn):
    def stamp(P, v, ib, state, ctx):
        t = ctx.t if ctx.mode == "tr" else 0.0
        e = wave_fn(P, t)
        return row(e, *_VSRC_VALS), e[..., None], state

    def ac(P, state, omega):
        like = P[..., 0]
        return (row(like, *_VSRC_VALS), zeros(like, 4), zeros(like, 1),
                zeros(like, 1))

    return register(ModelDef(
        name=name, id_name=id_name, device_class=DeviceClass.LINEAR,
        pins=("+", "-"), defaults=dict(defaults),
        param_order=tuple(defaults), nbranches=1,
        pattern=pat_vsrc, rhs_pattern=rhs_branch,
        stamp=stamp, ac_stamp=ac, attrs=tuple(defaults),
    ))


def _saw_wave(P, t):
    """sawtooth.h:88-104: linear ramp Vl->Vh over each period."""
    vh, vl, freq, phase = P[..., 0], P[..., 1], P[..., 2], P[..., 3]
    period = 1.0 / freq
    tm = _mod(t + phase / TWO_PI / freq, period)
    return vl + (vh - vl) / period * tm


def _square_wave(P, t):
    """square.h:93-107."""
    vh, vl, freq, duty, phase = (P[..., i] for i in range(5))
    period = 1.0 / freq
    tm = _mod(t + phase / TWO_PI / freq, period)
    return torch.where(tm < duty * period, vh, vl)


def _pulse_wave(P, t):
    """pulse.h:107-138: trapezoidal pulse with rise/fall times."""
    vh, vl, freq, duty, phase, tr, tf = (P[..., i] for i in range(7))
    period = 1.0 / freq
    tm = _mod(t + phase / TWO_PI / freq, period)
    ton = duty * period
    kr = (vh - vl) / torch.clamp(tr, min=1e-30)
    kf = (vh - vl) / torch.clamp(tf, min=1e-30)
    return torch.where(
        tm < tr, vl + kr * tm,
        torch.where(tm < ton - tf, vh,
                    torch.where(tm < ton, vh - kf * (tm - (ton - tf)), vl)))


def _tri_wave(P, t):
    """triangle.h:88-109: symmetric up/down ramp."""
    vh, vl, freq, phase = P[..., 0], P[..., 1], P[..., 2], P[..., 3]
    period = 1.0 / freq
    tm = _mod(t + phase / TWO_PI / freq, period)
    amp = vh - vl
    up = vl + (2.0 * amp / period) * tm
    down = vh - (2.0 * amp / period) * (tm - 0.5 * period)
    return torch.where(tm < 0.5 * period, up, down)


SAWTOOTH = _mk_src("Sawtooth Generator", "SAW",
                   {"Vh": 5.0, "Vl": 0.0, "freq": 1e3, "phase": 0.0},
                   _saw_wave)
SQUARE = _mk_src("Square Generator", "SQW",
                 {"Vh": 5.0, "Vl": 0.0, "freq": 1e3, "duty": 0.5,
                  "phase": 0.0},
                 _square_wave)
PULSE = _mk_src("Pulse Generator", "PULSE",
                {"Vh": 5.0, "Vl": 0.0, "freq": 1e3, "duty": 0.5,
                 "phase": 0.0, "tr": 0.0, "tf": 0.0},
                _pulse_wave)
TRIANGLE = _mk_src("Triangle Generator", "TRI",
                   {"Vh": 5.0, "Vl": 0.0, "freq": 1e3, "phase": 0.0},
                   _tri_wave)
