"""Controller devices: switch and relay (port of ``phy_engine_tpu/models/
controller.py``; reference ``model/models/controller/*.h``).

Switch and relay model their contact as an ideal branch with series
contact resistance ``r_contact`` in the D quadrant (0 when closed,
``r_open`` from the environment when open) — switch.h:85-104,
relay.h:75-105.  The relay is hysteretic: its engaged/released state
flips when the coil voltage crosses Von/Voff and is carried as device
state through Newton iterations (it is classified nonlinear so DC
iterates, relay.h:11).

The comparator is a digital-output device handled by the digital engine
(its sequential phase compares the raw voltages of two analog nodes).
"""

from __future__ import annotations

import torch

from .base import ModelDef, DeviceClass, UpdatePhase, register
from .linear import no_rhs, row, zeros, _VSRC_VALS


def _contact(r_contact):
    return row(r_contact, *_VSRC_VALS, -r_contact)


def _contact_ac(P, state, omega):
    a = _contact(state["r_contact"])
    return a, torch.zeros_like(a), zeros(a[..., 0], 0), zeros(a[..., 0], 0)


# ---------------------------------------------------------------------------
# single-pole switch  (switch.h)
# ---------------------------------------------------------------------------

def _sw_stamp(P, v, ib, state, ctx):
    r_contact = torch.where(P[..., 0] > 0.5, torch.zeros_like(P[..., 0]),
                            ctx.env["r_open"])
    return (_contact(r_contact), zeros(r_contact, 0),
            {"r_contact": r_contact})


def _sw_pattern(pins, brs):
    a, b = pins
    k = brs[0]
    return [a, b, k, k, k], [k, k, a, b, k]


SWITCH = register(ModelDef(
    name="switch", id_name="switch", device_class=DeviceClass.LINEAR,
    pins=("A", "B"), defaults={"cut_through": 0.0},
    param_order=("cut_through",), nbranches=1,
    state_vars=(("r_contact", 0.0),),
    pattern=_sw_pattern, rhs_pattern=no_rhs,
    stamp=_sw_stamp, ac_stamp=_contact_ac, attrs=("Cut Through",),
))


# ---------------------------------------------------------------------------
# relay  (relay.h): pins C+, C-, A, B; hysteresis Von/Voff on coil voltage.
# ---------------------------------------------------------------------------

def _relay_pattern(pins, brs):
    cp, cn, a, b = pins
    k = brs[0]
    return [a, b, k, k, k], [k, k, a, b, k]


def _relay_stamp(P, v, ib, state, ctx):
    von, voff = P[..., 0], P[..., 1]
    vctrl = v[..., 0] - v[..., 1]
    one, zero = torch.ones_like(vctrl), torch.zeros_like(vctrl)
    engaged_new = torch.where(state["engaged"] > 0.5,
                              torch.where(vctrl <= voff, zero, one),
                              torch.where(vctrl >= von, one, zero))
    r_contact = torch.where(engaged_new > 0.5, zero, ctx.env["r_open"])
    return (_contact(r_contact), zeros(r_contact, 0),
            {"engaged": engaged_new, "r_contact": r_contact})


RELAY = register(ModelDef(
    name="Relay", id_name="RELAY", device_class=DeviceClass.NONLINEAR,
    pins=("C+", "C-", "A", "B"), defaults={"Von": 5.0, "Voff": 3.0},
    param_order=("Von", "Voff"), nbranches=1,
    state_vars=(("engaged", 0.0), ("r_contact", 0.0)),
    pattern=_relay_pattern, rhs_pattern=no_rhs,
    stamp=_relay_stamp, ac_stamp=_contact_ac, nonlinear=True,
    attrs=("Von", "Voff"),
))


# ---------------------------------------------------------------------------
# comparator (comparator.h): o = H when v(A) >= v(B), else L.
# Handled by the digital engine's special-op table.
# ---------------------------------------------------------------------------

COMPARATOR = register(ModelDef(
    name="Comparator", id_name="CMP", device_class=DeviceClass.DIGITAL,
    pins=("A", "B", "o"), defaults={"Ll": 0.0, "Hl": 5.0},
    digital_op="CMP", update_phase=UpdatePhase.TABLE,
    din_pins=(0, 1), dout_pins=(2,),
    attrs=("Ll", "Hl"),
))
