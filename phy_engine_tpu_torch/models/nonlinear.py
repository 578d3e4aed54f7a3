"""Nonlinear analog devices: PN junction, BJT NPN/PNP, square-law
MOSFETs and the full-bridge rectifier (port of
``phy_engine_tpu/models/nonlinear.py``).

Every piecewise branch of the reference (non-linear/*.h) is a branchless
``torch.where`` selection evaluated for the whole family, with the same
SPICE junction limiting and convergence vetos as the JAX package.
Guarded-log/exp discipline: ``where`` evaluates both sides, so every
log/exp argument is clamped to a safe domain before the transcendental
and the correct branch is selected afterwards — the unselected side is
finite garbage, never NaN/Inf.
"""

from __future__ import annotations

import math

import torch

from .base import ModelDef, DeviceClass, register
from .linear import row, zeros

_K_KELVIN = -273.15
_Q_E = 1.6021765314e-19        # same physical constants as the reference
_K_B = 1.380650524e-23
_SQRT2 = 1.4142135623730950488
_TINY = 1e-300
_E50 = 5.184705528587072e21    # exp(50)
_EM50 = math.exp(-50.0)


def limexp(x):
    """Smooth overflow-protected exp (PN_junction.h:10-16)."""
    e = torch.exp(torch.clamp(x, -50.0, 50.0))
    return torch.where(x > 50.0, _E50 * (1.0 + (x - 50.0)),
                       torch.where(x < -50.0, torch.full_like(x, _EM50), e))


def _safe_log(x):
    return torch.log(torch.clamp(x, min=_TINY))


def _pn_derived(P):
    """prepare_foundation (PN_junction.h:296-356): effective params."""
    Is, N, Isr, Nr, Temp, Ibv, Bv, Bv_set, Area, tt = (
        P[..., i] for i in range(10))
    Is_eff = Is * Area
    Isr_eff = Isr * Area
    Ut = _K_B * (Temp - _K_KELVIN) / _Q_E
    Bv_eff = torch.where(Bv_set > 0.5,
                         Bv - N * Ut * _safe_log(Ibv / Is_eff), Bv)
    Uth = N * Ut * _safe_log(N * Ut / (_SQRT2 * Is_eff))
    return Is_eff, Isr_eff, N, Nr, Ut, Bv_eff, Uth, Bv_set, tt


def pn_vlimit(Ud, Ud_last, Ute, Uth, Bv_eff, Bv_set):
    """SPICE3F5 junction voltage limiting (PN_junction.h:58-109),
    branchless."""
    flag = (Bv_set > 0.5) & (Ud < torch.clamp(-Bv_eff + 10.0 * Ute, max=0.0))
    ud0 = torch.where(flag, -(Ud + Bv_eff), Ud)
    ud1 = torch.where(flag, -(Ud_last + Bv_eff), Ud_last)

    high = (ud0 > Uth) & (torch.abs(ud0 - ud1) > 2.0 * Ute)
    arg = (ud0 - ud1) / Ute
    f_pos = ud1 + Ute * (2.0 + _safe_log(arg - 2.0))
    f_neg = ud1 - Ute * (2.0 + _safe_log(2.0 - arg))
    f_a = torch.where(arg > 0.0, f_pos, f_neg)
    f_b = Ute * _safe_log(ud0 / Ute)
    f_high = torch.where(ud1 > 0.0, f_a, f_b)

    arg_l = torch.where(ud1 > 0.0, -1.0 - ud1, 2.0 * ud1 - 1.0)
    f_low = torch.where((ud0 < 0.0) & (ud0 < arg_l), arg_l, ud0)

    ud_f = torch.where(high, f_high, f_low)
    return torch.where(flag, -(ud_f + Bv_eff), ud_f)


def _pn_eval(P, Ud):
    """Diode current + conductance incl. breakdown and recombination
    (PN_junction.h:358-402)."""
    Is_eff, Isr_eff, N, Nr, Ut, Bv_eff, Uth, Bv_set, tt = _pn_derived(P)
    Ute = N * Ut
    Uter = Nr * Ut
    bk = (Bv_set > 0.5) & (Ud < -Bv_eff)

    e_b = limexp(-(Bv_eff + Ud) / Ute)
    Id_b = -Is_eff * e_b
    g_b = Is_eff * e_b / Ute

    e_f = limexp(Ud / Ute)
    g_f = Is_eff * e_f / Ute
    Id_f = Is_eff * (e_f - 1.0)
    e_r = limexp(Ud / Uter)
    g_f = g_f + Isr_eff * e_r / Uter
    Id_f = Id_f + Isr_eff * (e_r - 1.0)

    geq = torch.where(bk, g_b, g_f)
    Id = torch.where(bk, Id_b, Id_f)
    return geq, Id


def _pn_stamp(P, v, ib, state, ctx):
    Is_eff, Isr_eff, N, Nr, Ut, Bv_eff, Uth, Bv_set, tt = _pn_derived(P)
    Ute = N * Ut
    Ud = v[..., 0] - v[..., 1]
    Ud = pn_vlimit(Ud, state["ud_last"], Ute, Uth, Bv_eff, Bv_set)
    geq, Id = _pn_eval(P, Ud)
    Ieq = Id - Ud * geq
    new_state = dict(state)
    new_state["ud_last"] = Ud
    new_state["geq"] = geq

    g_tot = geq
    i_tot_a = -Ieq
    i_tot_b = Ieq
    if ctx.mode == "tr":
        # diffusion-capacitance trapezoidal companion (PN_junction.h:440+)
        gc = state["tr_prev_g"]
        hc = state["tr_hist"]
        g_tot = g_tot + gc
        i_tot_a = i_tot_a - hc
        i_tot_b = i_tot_b + hc
    a_vals = torch.stack([g_tot, -g_tot, -g_tot, g_tot], dim=-1)
    z_vals = torch.stack([i_tot_a, i_tot_b], dim=-1)
    return a_vals, z_vals, new_state


def _pn_step(P, v, ib, state, dt, t):
    tt = P[..., 9]
    geq = state["geq"]
    v_prev = v[..., 0] - v[..., 1]
    valid = (tt > 0.0) & (geq > 0.0) & (dt > 0.0)
    cd = tt * geq
    g_new = 2.0 * cd / dt
    hist = -(g_new + state["tr_prev_g"]) * v_prev - state["tr_hist"]
    out = dict(state)
    out["ud_last"] = v_prev
    out["tr_prev_g"] = torch.where(valid, g_new, 0.0)
    out["tr_hist"] = torch.where(valid, hist, 0.0)
    return out


def _pn_ac(P, state, omega):
    """AC: saved linearization geq (+ optional diffusion cap tt*geq), no
    Ieq injection (PN_junction.h:406-438)."""
    tt = P[..., 9]
    geq = state["geq"]
    use_cd = (tt > 0.0) & (geq > 0.0)
    b = torch.where(use_cd, tt * geq * omega, torch.zeros_like(geq))
    return (row(geq, geq, -geq, -geq, geq), row(b, b, -b, -b, b),
            zeros(geq, 2), zeros(geq, 2))


def _pn_check_conv(P, v, state):
    """Not converged while vlimit is still clamping: the raw junction
    voltage must agree with the limited one used for the stamps."""
    N = P[..., 1]
    Ut = _K_B * (P[..., 4] - _K_KELVIN) / _Q_E
    ud_raw = v[..., 0] - v[..., 1]
    return torch.abs(ud_raw - state["ud_last"]) <= 2.0 * N * Ut + 1e-9


def _pn_noise(P, v, ib, state, env, f):
    """SPICE diode noise: shot 2q·|Id| + flicker kf·|Id|^af / f."""
    _g, Id = _pn_eval(P, v[..., 0] - v[..., 1])
    kf, af = P[..., 10], P[..., 11]
    return (2.0 * _Q_E * Id.abs() + kf * Id.abs() ** af / f)[..., None]


PN_JUNCTION = register(ModelDef(
    name="PN Junction", id_name="PN", device_class=DeviceClass.NONLINEAR,
    pins=("A", "B"), check_conv=_pn_check_conv,
    defaults={"Is": 1e-14, "N": 1.0, "Isr": 0.0, "Nr": 2.0, "Temp": 27.0,
              "Ibv": 1e-3, "Bv": 40.0, "Bv_set": 1.0, "Area": 1.0,
              "tt": 0.0, "kf": 0.0, "af": 1.0},
    param_order=("Is", "N", "Isr", "Nr", "Temp", "Ibv", "Bv", "Bv_set",
                 "Area", "tt", "kf", "af"),
    state_vars=(("ud_last", 0.0), ("geq", 0.0), ("tr_prev_g", 0.0),
                ("tr_hist", 0.0)),
    pattern=lambda p, b: ([p[0], p[0], p[1], p[1]], [p[0], p[1], p[0], p[1]]),
    rhs_pattern=lambda p, b: [p[0], p[1]],
    stamp=_pn_stamp, ac_stamp=_pn_ac, step_update=_pn_step, nonlinear=True,
    attrs=("Is", "N", "Isr", "Nr", "Temp", "Ibv", "Bv", "Area", "tt",
           "kf", "af"),
    noise=_pn_noise, noise_pairs=((0, 1),),
))


# ---------------------------------------------------------------------------
# BJT  (non-linear/BJT_NPN.h:116-185, BJT_PNP.h mirrored): BE diode
# linearization + current-gain VCCS.  Pins B, C, E.  The reference stamps
# the raw exponential; here (as in the JAX package) the junction voltage
# passes through the diode's SPICE pnjlim limiter.
# ---------------------------------------------------------------------------

def _bjt_ut(P):
    return _K_B * (P[..., 3] - _K_KELVIN) / _Q_E     # P[3] = Temp


def _bjt_uth(Is_eff, Ute):
    """Critical voltage for junction limiting (same form as the diode's
    Uth, PN_junction.h:330-346)."""
    return Ute * _safe_log(Ute / (1.4142135623730951 * Is_eff))


def _bjt_stamp(P, vj, vj_last):
    """Shared NPN/PNP companion of the junction voltage ``vj`` (B-E for
    NPN, E-B for PNP): (A values, z values, new state)."""
    Is_eff = P[..., 0] * P[..., 4]
    Ute = P[..., 1] * _bjt_ut(P)
    beta = P[..., 2]
    zero = torch.zeros_like(vj)
    vj = pn_vlimit(vj, vj_last, Ute, _bjt_uth(Is_eff, Ute), zero, zero)
    e = torch.exp(torch.clamp(vj / Ute, -200.0, 200.0))
    geq = Is_eff * e / Ute
    ij = Is_eff * (e - 1.0)
    ieq_j = ij - vj * geq
    gm = beta * geq
    ieq_c = beta * ij - gm * vj
    a = row(geq, geq, -geq, -geq, geq, gm, -gm, -gm, gm)
    z = row(geq, -ieq_j, ieq_j, -ieq_c, ieq_c)
    return a, z, {"geq": geq, "gm": gm, "vj_last": vj}


def _bjt_npn_stamp(P, v, ib, state, ctx):
    return _bjt_stamp(P, v[..., 0] - v[..., 2], state["vj_last"])


def _bjt_pnp_stamp(P, v, ib, state, ctx):
    return _bjt_stamp(P, v[..., 2] - v[..., 0], state["vj_last"])


def _bjt_check_conv(sign):
    """Not converged while pnjlim is still clamping (mirrors the diode's
    check_conv)."""
    def _check(P, v, state):
        Ute = P[..., 1] * _bjt_ut(P)
        vj_raw = (v[..., 0] - v[..., 2]) * sign
        return torch.abs(vj_raw - state["vj_last"]) <= 2.0 * Ute + 1e-9
    return _check


def _bjt_ac(P, state, omega):
    geq, gm = state["geq"], state["gm"]
    a = row(geq, geq, -geq, -geq, geq, gm, -gm, -gm, gm)
    return a, zeros(geq, 8), zeros(geq, 4), zeros(geq, 4)


def _bjt_noise(sign):
    """SPICE BJT noise at the OP bias: base shot 2q·|Ib| (+ flicker
    kf·|Ib|^af/f) between B-E, collector shot 2q·|Ic| between C-E, from
    the same exponential the stamp uses."""
    def _noise(P, v, ib, state, env, f):
        Is_eff = P[..., 0] * P[..., 4]
        Ute = P[..., 1] * _bjt_ut(P)
        vj = (v[..., 0] - v[..., 2]) * sign
        e = torch.exp(torch.clamp(vj / Ute, -200.0, 200.0))
        i_b = (Is_eff * (e - 1.0)).abs()
        i_c = P[..., 2] * i_b
        kf, af = P[..., 5], P[..., 6]
        sb = 2.0 * _Q_E * i_b + kf * i_b ** af / f
        return torch.stack([sb, 2.0 * _Q_E * i_c], dim=-1)
    return _noise


def _bjt_npn_pattern(pins, brs):
    b, c, e = pins
    return [b, b, e, e, c, c, e, e], [b, e, b, e, b, e, b, e]


def _bjt_pnp_pattern(pins, brs):
    b, c, e = pins
    # EB diode quad + VCCS(E->C controlled by Veb) (BJT_PNP.h:126-156)
    return [e, e, b, b, e, e, c, c], [e, b, e, b, e, b, e, b]


_BJT_DEFAULTS = {"Is": 1e-16, "N": 1.0, "BetaF": 100.0, "Temp": 27.0,
                 "Area": 1.0, "kf": 0.0, "af": 1.0}
_BJT_ORDER = ("Is", "N", "BetaF", "Temp", "Area", "kf", "af")

BJT_NPN = register(ModelDef(
    name="NPN BJT", id_name="QNP", device_class=DeviceClass.NONLINEAR,
    pins=("B", "C", "E"), defaults=dict(_BJT_DEFAULTS),
    param_order=_BJT_ORDER,
    state_vars=(("geq", 0.0), ("gm", 0.0), ("vj_last", 0.0)),
    check_conv=_bjt_check_conv(1.0),
    pattern=_bjt_npn_pattern,
    rhs_pattern=lambda p, b: [p[0], p[2], p[1], p[2]],
    stamp=_bjt_npn_stamp, ac_stamp=_bjt_ac, nonlinear=True,
    attrs=_BJT_ORDER, noise=_bjt_noise(1.0), noise_pairs=((0, 2), (1, 2)),
))

BJT_PNP = register(ModelDef(
    name="PNP BJT", id_name="QPN", device_class=DeviceClass.NONLINEAR,
    pins=("B", "C", "E"), defaults=dict(_BJT_DEFAULTS),
    param_order=_BJT_ORDER,
    state_vars=(("geq", 0.0), ("gm", 0.0), ("vj_last", 0.0)),
    check_conv=_bjt_check_conv(-1.0),
    pattern=_bjt_pnp_pattern,
    rhs_pattern=lambda p, b: [p[2], p[0], p[2], p[1]],
    stamp=_bjt_pnp_stamp, ac_stamp=_bjt_ac, nonlinear=True,
    attrs=_BJT_ORDER, noise=_bjt_noise(-1.0), noise_pairs=((0, 2), (1, 2)),
))


# ---------------------------------------------------------------------------
# MOSFET square-law  (non-linear/nmosfet.h:85-140, pmosfet.h mirrored).
# Pins D, G, S.
# ---------------------------------------------------------------------------

def _mos_select(off, triode, tri, sat):
    zero = torch.zeros_like(tri)
    return torch.where(off, zero, torch.where(triode, tri, sat))


def _mos_eval(P, vgs, vds):
    """Square-law (i_d, gm, gds) of the NMOS orientation."""
    kp, lam, vth = P[..., 0], P[..., 1], P[..., 2]
    vov = vgs - vth
    off = vov <= 0.0
    triode = vds < vov
    b = vov * vds - 0.5 * vds * vds
    i_d = _mos_select(off, triode, kp * b * (1.0 + lam * vds),
                      0.5 * kp * vov * vov * (1.0 + lam * vds))
    gm = _mos_select(off, triode, kp * vds * (1.0 + lam * vds),
                     kp * vov * (1.0 + lam * vds))
    gds = _mos_select(off, triode,
                      kp * ((vov - vds) * (1.0 + lam * vds) + b * lam),
                      0.5 * kp * vov * vov * lam)
    return i_d, gm, gds


def _nmos_stamp(P, v, ib, state, ctx):
    vgs = v[..., 1] - v[..., 2]
    vds = v[..., 0] - v[..., 2]
    i_d, gm, gds = _mos_eval(P, vgs, vds)
    ieq = i_d - gm * vgs - gds * vds
    a = row(gm, gds, -gds, -gds, gds, gm, -gm, -gm, gm)
    return a, row(ieq, -ieq, ieq), {"gm": gm, "gds": gds}


def _pmos_stamp(P, v, ib, state, ctx):
    kp, lam, vth = P[..., 0], P[..., 1], P[..., 2]
    vsg = v[..., 2] - v[..., 1]
    vds = v[..., 0] - v[..., 2]
    vov = vsg - vth
    off = vov <= 0.0
    vsd = -vds
    triode = vsd < vov
    b = vov * vsd - 0.5 * vsd * vsd
    i_d = _mos_select(off, triode, -(kp * b * (1.0 + lam * vsd)),
                      -(0.5 * kp * vov * vov * (1.0 + lam * vsd)))
    gm = _mos_select(off, triode, kp * vsd * (1.0 + lam * vsd),
                     kp * vov * (1.0 + lam * vsd))
    gds = _mos_select(off, triode,
                      -(kp * ((vov - vsd) * (1.0 + lam * vsd) + b * lam)),
                      0.5 * kp * vov * vov * (-lam))
    ieq = i_d - gm * vsg - gds * vds
    a = row(gm, gds, -gds, -gds, gds, gm, -gm, -gm, gm)
    return a, row(ieq, -ieq, ieq), {"gm": gm, "gds": gds}


def _mos_noise(sign):
    """Channel thermal 8kT(gm+gds)/3 + flicker kf·|Id|^af/f between D-S,
    from the square law the stamp uses (source-referenced vsg / vsd for
    PMOS)."""
    def _noise(P, v, ib, state, env, f):
        i_d, gm, gds = _mos_eval(P, sign * (v[..., 1] - v[..., 2]),
                                 sign * (v[..., 0] - v[..., 2]))
        T = env["temperature"] + 273.15
        th = (8.0 / 3.0) * _K_B * T * (gm.abs() + gds.abs())
        return (th + P[..., 3] * i_d.abs() ** P[..., 4] / f)[..., None]
    return _noise


def _mos_ac(P, state, omega):
    gm, gds = state["gm"], state["gds"]
    a = row(gm, gds, -gds, -gds, gds, gm, -gm, -gm, gm)
    return a, zeros(gm, 8), zeros(gm, 2), zeros(gm, 2)


def _nmos_pattern(pins, brs):
    d, g, s = pins
    # gds quad + gm entries
    return [d, d, s, s, d, d, s, s], [d, s, d, s, g, s, g, s]


def _pmos_pattern(pins, brs):
    d, g, s = pins
    # gds quad + gm controlled by (Vs - Vg)  (pmosfet.h:123-133)
    return [d, d, s, s, d, d, s, s], [d, s, d, s, s, g, s, g]


_MOS_DEFAULTS = {"Kp": 1e-3, "lambda": 0.0, "Vth": 1.0, "kf": 0.0, "af": 1.0}
_MOS_ORDER = ("Kp", "lambda", "Vth", "kf", "af")

NMOSFET = register(ModelDef(
    name="NMOSFET", id_name="NMOS", device_class=DeviceClass.NONLINEAR,
    pins=("D", "G", "S"), defaults=dict(_MOS_DEFAULTS),
    param_order=_MOS_ORDER, state_vars=(("gm", 0.0), ("gds", 0.0)),
    pattern=_nmos_pattern, rhs_pattern=lambda p, b: [p[0], p[2]],
    stamp=_nmos_stamp, ac_stamp=_mos_ac, nonlinear=True, attrs=_MOS_ORDER,
    noise=_mos_noise(1.0), noise_pairs=((0, 2),),
))

PMOSFET = register(ModelDef(
    name="PMOSFET", id_name="PMOS", device_class=DeviceClass.NONLINEAR,
    pins=("D", "G", "S"), defaults=dict(_MOS_DEFAULTS),
    param_order=_MOS_ORDER, state_vars=(("gm", 0.0), ("gds", 0.0)),
    pattern=_pmos_pattern, rhs_pattern=lambda p, b: [p[0], p[2]],
    stamp=_pmos_stamp, ac_stamp=_mos_ac, nonlinear=True, attrs=_MOS_ORDER,
    noise=_mos_noise(-1.0), noise_pairs=((0, 2),),
))


# ---------------------------------------------------------------------------
# Full-bridge rectifier  (non-linear/full_bridge_rectifier.h): four PN
# junctions sharing one parameter set, D1 A->+, D2 B->+, D3 - -> A,
# D4 - -> B (full_bridge_rectifier.h:20-47), lowered as one 4-pin device
# whose kernels run the diode's over the four (anode, cathode) pin pairs.
# ---------------------------------------------------------------------------

_FBR_PAIRS = ((0, 2), (1, 2), (3, 0), (3, 1))
_PN_STATE = ("ud_last", "geq", "tr_prev_g", "tr_hist")


def _fbr_sub(state, k):
    return {key: state[f"{key}{k}"] for key in _PN_STATE}


def _fbr_merge(new_state, ns, k):
    for key in _PN_STATE:
        new_state[f"{key}{k}"] = ns[key]


def _pair(v, a, c):
    return torch.stack([v[..., a], v[..., c]], dim=-1)


def _fbr_stamp(P, v, ib, state, ctx):
    a_parts, z_parts = [], []
    new_state = dict(state)
    for k, (a, c) in enumerate(_FBR_PAIRS):
        av, zv, ns = _pn_stamp(P, _pair(v, a, c), ib, _fbr_sub(state, k),
                               ctx)
        a_parts.append(av)
        z_parts.append(zv)
        _fbr_merge(new_state, ns, k)
    return torch.cat(a_parts, dim=-1), torch.cat(z_parts, dim=-1), new_state


def _fbr_step(P, v, ib, state, dt, t):
    new_state = dict(state)
    for k, (a, c) in enumerate(_FBR_PAIRS):
        ns = _pn_step(P, _pair(v, a, c), ib, _fbr_sub(state, k), dt, t)
        _fbr_merge(new_state, ns, k)
    return new_state


def _fbr_ac(P, state, omega):
    parts = [_pn_ac(P, _fbr_sub(state, k), omega) for k in range(4)]
    return tuple(torch.cat([p[i] for p in parts], dim=-1) for i in range(4))


def _fbr_check_conv(P, v, state):
    ok = None
    for k, (a, c) in enumerate(_FBR_PAIRS):
        f = _pn_check_conv(P, _pair(v, a, c), _fbr_sub(state, k))
        ok = f if ok is None else ok & f
    return ok


def _fbr_pattern(p, b):
    rows, cols = [], []
    for a, c in _FBR_PAIRS:
        rows += [p[a], p[a], p[c], p[c]]
        cols += [p[a], p[c], p[a], p[c]]
    return rows, cols


def _fbr_rhs(p, b):
    out = []
    for a, c in _FBR_PAIRS:
        out += [p[a], p[c]]
    return out


FULL_BRIDGE_RECTIFIER = register(ModelDef(
    name="Full Bridge Rectifier", id_name="FBR",
    device_class=DeviceClass.NONLINEAR,
    pins=("A", "B", "+", "-"),
    defaults=dict(PN_JUNCTION.defaults),
    param_order=PN_JUNCTION.param_order,
    state_vars=tuple((f"{nm}{k}", init)
                     for k in range(4)
                     for nm, init in (("ud_last", 0.0), ("geq", 0.0),
                                      ("tr_prev_g", 0.0),
                                      ("tr_hist", 0.0))),
    pattern=_fbr_pattern, rhs_pattern=_fbr_rhs,
    stamp=_fbr_stamp, ac_stamp=_fbr_ac, step_update=_fbr_step,
    check_conv=_fbr_check_conv, nonlinear=True,
))
