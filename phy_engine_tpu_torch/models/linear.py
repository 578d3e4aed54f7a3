"""Linear analog devices (port of ``phy_engine_tpu/models/linear.py``):
R, C, L, VDC, VAC, IDC, IAC, the four controlled sources, the ideal
op-amp, the ideal and centre-tapped transformers and the coupled
inductors.

Stamp conventions follow the reference's device headers under
``include/phy_engine/model/models/linear/``.  Pattern functions receive
global indices (branch indices already offset past the node count); the
unknown vector is ``[node voltages | branch currents]`` and index N is
the ground dummy.  Every kernel takes the whole family at once (see
:mod:`.base`): ``P`` is ``(..., n_inst, n_params)`` and each returned
value array is ``(..., n_inst, K)``.
"""

from __future__ import annotations

import torch

from .base import ModelDef, DeviceClass, register

TWO_PI = 6.283185307179586476925286766559
DEG = 0.017453292519943295769236907684886


def pat_g2(pins, brs):
    """2-terminal conductance quad: (a,a),(a,b),(b,a),(b,b)."""
    a, b = pins
    return [a, a, b, b], [a, b, a, b]


def rhs_2(pins, brs):
    a, b = pins
    return [a, b]


def pat_vsrc(pins, brs):
    """Ideal-source pattern: B rows (a,k),(b,k); C rows (k,a),(k,b)."""
    a, b = pins
    k = brs[0]
    return [a, b, k, k], [k, k, a, b]


def rhs_branch(pins, brs):
    return [brs[0]]


def no_rhs(pins, brs):
    return []


_VSRC_VALS = (1.0, -1.0, 1.0, -1.0)


def row(like, *entries):
    """Per-instance value rows: each entry a tensor of ``like``'s shape or
    a float broadcast to it, stacked along a new last dimension."""
    return torch.stack([e if torch.is_tensor(e) else torch.full_like(like, e)
                        for e in entries], dim=-1)


def zeros(like, k: int):
    return like.new_zeros(like.shape + (k,))


def _quad(g):
    return row(g, g, -g, -g, g)


def _vsrc(like):
    return row(like, *_VSRC_VALS)


# ---------------------------------------------------------------------------
# Resistance  (linear/resistance.h:82-110)
# ---------------------------------------------------------------------------

def _r_stamp(P, v, ib, state, ctx):
    g = 1.0 / P[..., 0]
    return _quad(g), zeros(g, 0), state


def _r_ac(P, state, omega):
    g = 1.0 / P[..., 0]
    return _quad(g), zeros(g, 4), zeros(g, 0), zeros(g, 0)


def _r_noise(P, v, ib, state, env, f):
    """Johnson-Nyquist thermal noise, current form: S_i = 4kT/R."""
    T = env["temperature"] + 273.15
    return (4.0 * 1.380649e-23 * T / P[..., 0])[..., None]


RESISTANCE = register(ModelDef(
    name="Resistance", id_name="R", device_class=DeviceClass.LINEAR,
    pins=("A", "B"), defaults={"r": 1000.0}, param_order=("r",),
    pattern=pat_g2, rhs_pattern=no_rhs, stamp=_r_stamp, ac_stamp=_r_ac,
    attrs=("R",), noise=_r_noise, noise_pairs=((0, 1),),
))


# ---------------------------------------------------------------------------
# Capacitor  (linear/capacitor.h): open in DC/OP/TROP; trapezoidal Norton
# companion in TR (geq = 2C/dt, recurrence capacitor.h:106-128); jwC in AC.
# ---------------------------------------------------------------------------

def _c_stamp(P, v, ib, state, ctx):
    if ctx.mode == "tr":
        geq = state["prev_g"]
        ieq = state["hist_i"]
        a_vals = _quad(geq)
        z_vals = row(ieq, -ieq, ieq)
    else:  # op/dc/trop: open circuit
        a_vals = zeros(P[..., 0], 4)
        z_vals = zeros(P[..., 0], 2)
    return a_vals, z_vals, state


def _c_step(P, v, ib, state, dt, t):
    c = P[..., 0]
    v_prev = v[..., 0] - v[..., 1]
    g_new = 2.0 * c / dt
    hist = -(g_new + state["prev_g"]) * v_prev - state["hist_i"]
    return {"prev_g": g_new, "hist_i": hist}


def _c_ac(P, state, omega):
    y = P[..., 0] * omega
    return zeros(y, 4), _quad(y), zeros(y, 2), zeros(y, 2)


CAPACITOR = register(ModelDef(
    name="Capacitor", id_name="C", device_class=DeviceClass.LINEAR,
    pins=("A", "B"), defaults={"C": 1e-5}, param_order=("C",),
    state_vars=(("prev_g", 0.0), ("hist_i", 0.0)),
    pattern=pat_g2, rhs_pattern=rhs_2,
    stamp=_c_stamp, ac_stamp=_c_ac, step_update=_c_step, attrs=("C",),
))


# ---------------------------------------------------------------------------
# Inductor  (linear/inductor.h): short in DC (branch); TR Thevenin companion
# req = 2L/dt, Ueq = -v_prev - req*i_prev (inductor.h:134-208); -jwL in AC.
# Pattern: vsrc quad + D(k,k); rhs row k.
# ---------------------------------------------------------------------------

def _l_pattern(pins, brs):
    a, b = pins
    k = brs[0]
    return [a, b, k, k, k], [k, k, a, b, k]


def _l_stamp(P, v, ib, state, ctx):
    like = P[..., 0]
    if ctx.mode == "tr":
        d = -state["req"]
        z = state["ueq"]
    else:  # dc/op/trop: ideal short
        d = 0.0
        z = 0.0
    return row(like, *_VSRC_VALS, d), row(like, z), state


def _l_step(P, v, ib, state, dt, t):
    req = 2.0 * P[..., 0] / dt
    ueq = -(v[..., 0] - v[..., 1]) - req * ib[..., 0]
    return {"req": req, "ueq": ueq}


def _l_ac(P, state, omega):
    like = P[..., 0]
    return (row(like, *_VSRC_VALS, 0.0),
            row(like, 0.0, 0.0, 0.0, 0.0, -omega * P[..., 0]),
            zeros(like, 1), zeros(like, 1))


INDUCTOR = register(ModelDef(
    name="Inductor", id_name="L", device_class=DeviceClass.LINEAR,
    pins=("A", "B"), defaults={"L": 1e-5}, param_order=("L",),
    nbranches=1, state_vars=(("req", 0.0), ("ueq", 0.0)),
    pattern=_l_pattern, rhs_pattern=rhs_branch,
    stamp=_l_stamp, ac_stamp=_l_ac, step_update=_l_step, attrs=("L",),
))


# ---------------------------------------------------------------------------
# VDC  (linear/VDC.h:82-116)
# ---------------------------------------------------------------------------

def _vdc_stamp(P, v, ib, state, ctx):
    return _vsrc(P[..., 0]), P[..., 0:1], state


def _vdc_ac(P, state, omega):
    # AC small-signal: DC source is 0V perturbation (VDC.h:101-113)
    like = P[..., 0]
    return _vsrc(like), zeros(like, 4), zeros(like, 1), zeros(like, 1)


VDC = register(ModelDef(
    name="VDC", id_name="VDC", device_class=DeviceClass.LINEAR,
    pins=("+", "-"), defaults={"V": 5.0}, param_order=("V",), nbranches=1,
    pattern=pat_vsrc, rhs_pattern=rhs_branch,
    stamp=_vdc_stamp, ac_stamp=_vdc_ac, attrs=("V",),
))


# ---------------------------------------------------------------------------
# VAC  (linear/VAC.h): DC/OP -> 0V source; TR -> Vp*sin(w t + phase);
# AC -> complex phasor Vp*e^{j phase}.
# ---------------------------------------------------------------------------

def _vac_stamp(P, v, ib, state, ctx):
    vp, freq, ph = P[..., 0], P[..., 1], P[..., 2]
    if ctx.mode == "tr":
        e = vp * torch.sin(freq * TWO_PI * ctx.t + ph * DEG)
    else:
        e = torch.zeros_like(vp)
    return _vsrc(vp), e[..., None], state


def _vac_ac(P, state, omega):
    vp, ph = P[..., 0], P[..., 2]
    return (_vsrc(vp), zeros(vp, 4),
            (vp * torch.cos(ph * DEG))[..., None],
            (vp * torch.sin(ph * DEG))[..., None])


VAC = register(ModelDef(
    name="VAC", id_name="VAC", device_class=DeviceClass.LINEAR,
    pins=("+", "-"), defaults={"Vp": 5.0, "freq": 50.0 / TWO_PI, "phase": 0.0},
    param_order=("Vp", "freq", "phase"), nbranches=1,
    pattern=pat_vsrc, rhs_pattern=rhs_branch,
    stamp=_vac_stamp, ac_stamp=_vac_ac, attrs=("Vp", "freq", "phase"),
))


# ---------------------------------------------------------------------------
# IDC / IAC  (linear/IDC.h:90-91, IAC.h:139-157): pure RHS current stamps.
# ---------------------------------------------------------------------------

def _no_pattern(pins, brs):
    return [], []


def _idc_stamp(P, v, ib, state, ctx):
    i = P[..., 0]
    return zeros(i, 0), row(i, -i, i), state


def _idc_ac(P, state, omega):
    like = P[..., 0]
    return zeros(like, 0), zeros(like, 0), zeros(like, 2), zeros(like, 2)


IDC = register(ModelDef(
    name="IDC", id_name="IDC", device_class=DeviceClass.LINEAR,
    pins=("A", "B"), defaults={"I": 0.2}, param_order=("I",),
    pattern=_no_pattern, rhs_pattern=rhs_2,
    stamp=_idc_stamp, ac_stamp=_idc_ac, attrs=("I",),
))


def _iac_stamp(P, v, ib, state, ctx):
    ip, freq, ph = P[..., 0], P[..., 1], P[..., 2]
    if ctx.mode == "tr":
        i = ip * torch.sin(freq * TWO_PI * ctx.t + ph * DEG)
    else:
        i = torch.zeros_like(ip)
    return zeros(ip, 0), row(i, -i, i), state


def _iac_ac(P, state, omega):
    ir = P[..., 0] * torch.cos(P[..., 2] * DEG)
    ii = P[..., 0] * torch.sin(P[..., 2] * DEG)
    return zeros(ir, 0), zeros(ir, 0), row(ir, -ir, ir), row(ii, -ii, ii)


IAC = register(ModelDef(
    name="IAC", id_name="IAC", device_class=DeviceClass.LINEAR,
    pins=("A", "B"), defaults={"Ip": 0.2, "freq": 50.0 / TWO_PI, "phase": 0.0},
    param_order=("Ip", "freq", "phase"),
    pattern=_no_pattern, rhs_pattern=rhs_2,
    stamp=_iac_stamp, ac_stamp=_iac_ac, attrs=("Ip", "freq", "phase"),
))


# ---------------------------------------------------------------------------
# Controlled sources.  Pin order S,T,P,Q throughout (output S-T, control
# P-Q), matching linear/{VCVS,VCCS,CCVS,CCCS}.h.  Their stamps are the
# same in every mode and real in AC.
# ---------------------------------------------------------------------------

def _static(vals_fn):
    """(stamp, ac_stamp) of a family whose only entries are ``vals_fn(P)``
    in every mode, with no RHS."""
    def stamp(P, v, ib, state, ctx):
        a = vals_fn(P)
        return a, zeros(P[..., 0], 0), state

    def ac(P, state, omega):
        a = vals_fn(P)
        like = P[..., 0]
        return a, torch.zeros_like(a), zeros(like, 0), zeros(like, 0)
    return stamp, ac


def _vcvs_pattern(pins, brs):
    s, t, p, q = pins
    k = brs[0]
    # B: (s,k),(t,k); C: (k,s),(k,t),(k,p),(k,q)
    return [s, t, k, k, k, k], [k, k, s, t, p, q]


def _gain_vals(P):
    mu = P[..., 0]
    return row(mu, *_VSRC_VALS, -mu, mu)


_vcvs_stamp, _vcvs_ac = _static(_gain_vals)

VCVS = register(ModelDef(
    name="VCVS", id_name="VCVS", device_class=DeviceClass.LINEAR,
    pins=("S", "T", "P", "Q"), defaults={"mu": 1.0}, param_order=("mu",),
    nbranches=1, pattern=_vcvs_pattern, rhs_pattern=no_rhs,
    stamp=_vcvs_stamp, ac_stamp=_vcvs_ac, attrs=("mu",),
))


def _vccs_pattern(pins, brs):
    s, t, p, q = pins
    return [s, s, t, t], [p, q, p, q]


_vccs_stamp, _vccs_ac = _static(lambda P: _quad(P[..., 0]))

VCCS = register(ModelDef(
    name="VCCS", id_name="VCCS", device_class=DeviceClass.LINEAR,
    pins=("S", "T", "P", "Q"), defaults={"g": 1.0}, param_order=("g",),
    pattern=_vccs_pattern, rhs_pattern=no_rhs,
    stamp=_vccs_stamp, ac_stamp=_vccs_ac, attrs=("g",),
))


def _ccvs_pattern(pins, brs):
    s, t, p, q = pins
    k, c = brs
    # B: (s,k),(t,k),(p,c),(q,c); C: (k,s),(k,t),(c,p),(c,q); D: (k,c)
    return ([s, t, p, q, k, k, c, c, k],
            [k, k, c, c, s, t, p, q, c])


_ccvs_stamp, _ccvs_ac = _static(
    lambda P: row(P[..., 0], *(_VSRC_VALS * 2), -P[..., 0]))

CCVS = register(ModelDef(
    name="CCVS", id_name="CCVS", device_class=DeviceClass.LINEAR,
    pins=("S", "T", "P", "Q"), defaults={"r": 10.0}, param_order=("r",),
    nbranches=2, pattern=_ccvs_pattern, rhs_pattern=no_rhs,
    stamp=_ccvs_stamp, ac_stamp=_ccvs_ac, attrs=("r",),
))


def _cccs_pattern(pins, brs):
    s, t, p, q = pins
    c = brs[0]
    # B: (s,c)*alpha,(t,c)*-alpha,(p,c),(q,c); C: (c,p),(c,q)
    return [s, t, p, q, c, c], [c, c, c, c, p, q]


_cccs_stamp, _cccs_ac = _static(
    lambda P: row(P[..., 0], P[..., 0], -P[..., 0], *_VSRC_VALS))

CCCS = register(ModelDef(
    name="CCCS", id_name="CCCS", device_class=DeviceClass.LINEAR,
    pins=("S", "T", "P", "Q"), defaults={"alpha": 10.0},
    param_order=("alpha",), nbranches=1,
    pattern=_cccs_pattern, rhs_pattern=no_rhs,
    stamp=_cccs_stamp, ac_stamp=_cccs_ac, attrs=("alpha",),
))


# ---------------------------------------------------------------------------
# Ideal op-amp  (linear/op_amp.h): high-gain VCVS, pins +,-,OUT+,OUT-;
# constraint V(out+)-V(out-) = mu (V(+)-V(-)).
# ---------------------------------------------------------------------------

def _opamp_pattern(pins, brs):
    s, t, p, q = pins     # +, -, OUT+, OUT-
    k = brs[0]
    return [p, q, k, k, k, k], [k, k, p, q, s, t]


_opamp_stamp, _opamp_ac = _static(_gain_vals)

OP_AMP = register(ModelDef(
    name="Op Amp", id_name="OPAMP", device_class=DeviceClass.LINEAR,
    pins=("+", "-", "OUT+", "OUT-"), defaults={"mu": 1.0e5},
    param_order=("mu",), nbranches=1,
    pattern=_opamp_pattern, rhs_pattern=no_rhs,
    stamp=_opamp_stamp, ac_stamp=_opamp_ac, attrs=("mu",),
))


# ---------------------------------------------------------------------------
# Ideal transformer  (linear/transformer.h:67-99): Vp = n*Vs; Is = -n*Ip.
# Pins P,Q,S,T (primary P-Q dotted at P).
# ---------------------------------------------------------------------------

def _tx_pattern(pins, brs):
    p, q, s, t = pins
    kp, ks = brs
    return ([p, q, kp, kp, s, t, kp, kp, ks, ks],
            [kp, kp, p, q, ks, ks, s, t, ks, kp])


def _tx_vals(P):
    n = P[..., 0]
    return row(n, *_VSRC_VALS, 1.0, -1.0, -n, n, 1.0, n)


_tx_stamp, _tx_ac = _static(_tx_vals)

TRANSFORMER = register(ModelDef(
    name="Transformer", id_name="TX", device_class=DeviceClass.LINEAR,
    pins=("P", "Q", "S", "T"), defaults={"n": 1.0}, param_order=("n",),
    nbranches=2, pattern=_tx_pattern, rhs_pattern=no_rhs,
    stamp=_tx_stamp, ac_stamp=_tx_ac, attrs=("n",),
))


# ---------------------------------------------------------------------------
# Centre-tapped transformer  (linear/transformer_center_tap.h:80-133):
# two half-secondaries S1-CT, CT-S2, each V_half = V_p / n_half;
# ampere-turns Ip + (Ih1+Ih2)/n_half = 0.
# ---------------------------------------------------------------------------

def _txct_pattern(pins, brs):
    p, q, s1, ct, s2 = pins
    kp, k1, k2 = brs
    rows = [p, q, s1, ct, ct, s2,            # B quads
            k1, k1, k1, k1,                  # KVL half 1
            k2, k2, k2, k2,                  # KVL half 2
            kp, kp, kp]                      # ampere-turns
    cols = [kp, kp, k1, k1, k2, k2,
            s1, ct, p, q,
            ct, s2, p, q,
            kp, k1, k2]
    return rows, cols


def _txct_vals(P):
    inv = 1.0 / P[..., 0]
    return row(inv, 1.0, -1.0, 1.0, -1.0, 1.0, -1.0,
               1.0, -1.0, -inv, inv,
               1.0, -1.0, -inv, inv,
               1.0, inv, inv)


_txct_stamp, _txct_ac = _static(_txct_vals)

TRANSFORMER_CENTER_TAP = register(ModelDef(
    name="Transformer(center tapped)", id_name="TXCT",
    device_class=DeviceClass.LINEAR,
    pins=("P", "Q", "S1", "CT", "S2"), defaults={"n_half": 1.0},
    param_order=("n_half",), nbranches=3,
    pattern=_txct_pattern, rhs_pattern=no_rhs,
    stamp=_txct_stamp, ac_stamp=_txct_ac, attrs=("n_half",),
))


# ---------------------------------------------------------------------------
# Coupled inductors  (linear/coupled_inductors.h:92-230): Z-matrix
# [[L1,M],[M,L2]]; DC short; TR trapezoidal Thevenin with matrix Req.
# ---------------------------------------------------------------------------

def _kl_pattern(pins, brs):
    p1, p2, s1, s2 = pins
    k1, k2 = brs
    rows = [p1, p2, s1, s2, k1, k1, k2, k2, k1, k1, k2, k2]
    cols = [k1, k1, k2, k2, p1, p2, s1, s2, k1, k2, k1, k2]
    return rows, cols


def _kl_stamp(P, v, ib, state, ctx):
    like = P[..., 0]
    if ctx.mode == "tr":
        d = (-state["req11"], -state["req12"], -state["req12"],
             -state["req22"])
        z = row(like, state["ueq1"], state["ueq2"])
    else:
        d = (0.0, 0.0, 0.0, 0.0)
        z = zeros(like, 2)
    return row(like, *(_VSRC_VALS * 2), *d), z, state


def _kl_step(P, v, ib, state, dt, t):
    l1, l2, k = P[..., 0], P[..., 1], P[..., 2]
    m = k * torch.sqrt(l1 * l2)
    sc = torch.full_like(l1, 2.0) / dt     # a host dt of 0 gives inf
    req11, req12, req22 = sc * l1, sc * m, sc * l2
    v1p = v[..., 0] - v[..., 1]
    v2p = v[..., 2] - v[..., 3]
    i1p, i2p = ib[..., 0], ib[..., 1]
    return {"req11": req11, "req12": req12, "req22": req22,
            "ueq1": -v1p - (req11 * i1p + req12 * i2p),
            "ueq2": -v2p - (req12 * i1p + req22 * i2p)}


def _kl_ac(P, state, omega):
    l1, l2, k = P[..., 0], P[..., 1], P[..., 2]
    m = k * torch.sqrt(l1 * l2)
    a_re = row(l1, *(_VSRC_VALS * 2), 0.0, 0.0, 0.0, 0.0)
    a_im = row(l1, *([0.0] * 8), -omega * l1, -omega * m, -omega * m,
               -omega * l2)
    return a_re, a_im, zeros(l1, 2), zeros(l1, 2)


COUPLED_INDUCTORS = register(ModelDef(
    name="Coupled Inductors", id_name="KL", device_class=DeviceClass.LINEAR,
    pins=("P1", "P2", "S1", "S2"),
    defaults={"L1": 1e-3, "L2": 1e-3, "k": 0.999},
    param_order=("L1", "L2", "k"), nbranches=2,
    state_vars=(("req11", 0.0), ("req12", 0.0), ("req22", 0.0),
                ("ueq1", 0.0), ("ueq2", 0.0)),
    pattern=_kl_pattern, rhs_pattern=lambda p, b: list(b),
    stamp=_kl_stamp, ac_stamp=_kl_ac, step_update=_kl_step,
    attrs=("L1", "L2", "k"),
))
