"""BSIM3v3.2 MOSFET (port of ``phy_engine_tpu/models/bsim3.py``).

The 4-terminal D/G/S/B device of the JAX package, wave for wave: Vth with
body effect, short-channel roll-off, DIBL and narrow width, the
``Vgsteff`` / ``Vdseff`` smoothing, mobMod 0-3, velocity saturation,
series resistance, CLM / DIBL / SCBE output conductance, GIDL / GISL,
impact ionization, gate leakage, bulk junctions with breakdown and
recombination, the charge-based C-V (overlap, capMod >= 1 intrinsic with
the xpart partition, junction depletion and diffusion charges), the
wave-9 first-order NQS relaxation, the wave-7/8 channel, flicker and
induced-gate noise, and the ``_RC`` internal-node variant with D/G/S/B
series resistances.  The physics and its comments live in the JAX
package's module; this one mirrors it line for line.

Every function takes whole families: ``P`` is ``(..., n_inst, 223)`` and
the terminal voltages ``(..., n_inst, 4)`` (8 for ``_RC``).  Where the JAX
package takes ``jax.jacfwd`` of the terminal-current and terminal-charge
functions per instance, :func:`.dual.jacobian` runs forward-mode AD over
the whole family at once: one pass on dual numbers with the k unit
tangents along a new leading dimension.  The Newton stamp is the exact
Jacobian of I(v) and the companion / AC susceptance the exact C(v) =
dQ/dv, never hand-derived.

``torch.maximum`` / ``torch.minimum`` against a constant (``_max`` /
``_min``) keep ``jnp.maximum``'s derivative at a tie (half to each side),
which ``torch.clamp`` does not; the sensitivity analysis differentiates
through parameters that sit exactly at such ties (``rd = 0``, ``tt =
0``, ...).
"""

from __future__ import annotations

import functools

import torch

from .base import ModelDef, DeviceClass, register
from .dual import jacobian as _jac
from .nonlinear import limexp

_K_B = 1.380649e-23
_Q_E = 1.602176634e-19
_T0 = 273.15
_EPS_SI = 11.7 * 8.854187817e-12
_EPS_OX = 3.9 * 8.854187817e-12

# parameter order = the C ABI compat property stream followed by the
# tiered BSIM parameter waves (phy_engine_tpu/models/bsim3.py:124-206)
_PARAMS = (
    # -- compat prefix (wave 1) ------------------------------------------
    "W", "L", "Kp", "lambda", "Vth0", "gamma", "phi",
    "Cgs", "Cgd", "Cgb", "diode_Is", "diode_N", "Temp",
    "vsat", "nfactor", "u0",
    "kt1", "ute", "at", "xti", "eg", "eta0", "theta",
    "cjs", "cjd",
    # -- wave 2: geometry, mobility, Rds, GIDL/GISL, II, charge, junction
    "lint", "wint", "lref", "wref",
    "lvth0", "wvth0", "pvth0", "lkp", "wkp", "pkp",
    "lu0", "wu0", "pu0", "lvsat", "wvsat", "pvsat",
    "tox", "ua", "ub", "uc", "ua1", "ub1", "uc1", "kt2",
    "rdsw", "prwg", "prwb", "prt",
    "agidl", "bgidl", "cgidl", "egidl",
    "agisl", "bgisl", "cgisl", "egisl",
    "alpha0", "beta0",
    "capmod", "xpart", "k1", "k2", "keta", "nch", "vfbcv", "voffcv",
    "cj", "mj", "pb", "cjsw", "mjsw", "pbsw",
    "ad", "as", "pd", "ps",
    # -- wave 3: gate leakage, SCE/DIBL/narrow width, mobility selector,
    #    output resistance, bin grid
    "aigb", "bigb", "cigb", "eigb",
    "aigs", "bigs", "cigs", "eigs",
    "aigd", "bigd", "cigd", "eigd",
    "dwc", "dlc",
    "dvt0", "dvt1", "dvt2", "xj", "vbi", "dsub", "etab",
    "k3", "k3b", "w0", "nlx", "voff", "cit", "noff", "delta",
    "mobmod", "toxm",
    "pclm", "pdiblc1", "pdiblc2", "pdiblcb", "drout", "pvag",
    "pscbe1", "pscbe2", "vdsatii",
    "lua", "wua", "pua", "lub", "wub", "pub", "luc", "wuc", "puc",
    "lnch", "wnch", "pnch", "lphi", "wphi", "pphi",
    "lgamma", "wgamma", "pgamma",
    "lk1", "wk1", "pk1", "lk2", "wk2", "pk2",
    "leta0", "weta0", "peta0", "lnfactor", "wnfactor", "pnfactor",
    "lvoff", "wvoff", "pvoff", "lketa", "wketa", "pketa",
    "lrdsw", "wrdsw", "prdsw",
    # -- wave 4: junction geometry currents, breakdown, tempcos
    "js", "jsw", "jswg",
    "bvd", "ibvd", "bvs", "ibvs",
    "cjswg", "mjswg", "pbswg",
    "tcj", "tcjsw", "tpb", "tpbsw", "tcjswg", "tpbswg",
    # -- wave 5: multiplicity, dtemp, overlap densities, per-junction
    #    overrides, recombination, diffusion charge
    "m", "nf", "dtemp",
    "cgso", "cgdo", "cgbo", "acm", "fc",
    "tt", "ttd", "tts",
    "isd", "iss", "nd", "ns",
    "isr", "nr", "isrd", "isrs", "nrd", "nrs",
    "jsd", "jss", "jswd", "jsws", "jswgd", "jswgs",
    "jsr", "jsrw", "jsrwg",
    # -- terminal parasitics (the _RC variant)
    "rd", "rs", "rg", "rb", "rsh", "nrd", "nrs",
    # -- wave 6: per-junction depletion-cap overrides + selectors
    "cjswd", "cjsws", "cjswgd", "cjswgs",
    "pbd", "pbs", "pbswd", "pbsws", "pbswgd", "pbswgs",
    "mjd", "mjs", "mjswd", "mjsws", "mjswgd", "mjswgs",
    "fcd", "fcs",
    "rdsmod", "rgatemod", "rbodymod",
    # -- wave 7: noise; wave 9: NQS
    "kf", "af", "ef", "noimod",
    "nqsmod", "elm",
)
_DEFAULTS = {p: 0.0 for p in _PARAMS}
_DEFAULTS.update({
    "W": 1e-6, "L": 1e-6, "Kp": 1e-4, "lambda": 0.0,
    "Vth0": 0.7, "gamma": 0.0, "phi": 0.7,
    "Cgs": 0.0, "Cgd": 0.0, "Cgb": 0.0,
    "diode_Is": 1e-14, "diode_N": 1.0, "Temp": 27.0,
    "vsat": 8e4, "nfactor": 1.0, "u0": 0.06,
    "xti": 3.0, "eg": 1.12,
    "tox": 1e-8, "xpart": 0.0,
    "mj": 0.5, "pb": 1.0, "mjsw": 0.33, "pbsw": 1.0,
    "bvd": 40.0, "ibvd": 1e-3, "bvs": 40.0, "ibvs": 1e-3,
    "m": 1.0, "nf": 1.0, "fc": 0.5, "nr": 2.0,
    "ttd": -1.0, "tts": -1.0,
    "isd": -1.0, "iss": -1.0, "isrd": -1.0, "isrs": -1.0,
    "mjd": -1.0, "mjs": -1.0, "mjswd": -1.0, "mjsws": -1.0,
    "mjswgd": -1.0, "mjswgs": -1.0, "fcd": -1.0, "fcs": -1.0,
    "rdsmod": 1.0, "rgatemod": 1.0, "rbodymod": 1.0,
    "af": 1.0, "ef": 1.0, "noimod": 1.0,
    "elm": 5.0,
})
_TNOM = 27.0
_IX = {p: i for i, p in enumerate(_PARAMS)}


def _p(P, name):
    return P[..., _IX[name]]


@functools.lru_cache(maxsize=None)
def _const(c: float, device, dtype):
    return torch.tensor(c, dtype=dtype, device=device)


def _max(x, c):
    """``jnp.maximum(x, c)``: at a tie the derivative is half of x's."""
    return torch.maximum(x, _const(c, x.device, x.dtype))


def _min(x, c):
    return torch.minimum(x, _const(c, x.device, x.dtype))


def _clip(x, lo, hi):
    """``jnp.clip``: maximum, then minimum."""
    return _min(_max(x, lo), hi)


def _mv(M, v):
    """Per-instance matrix-vector product (..., r, c) @ (..., c)."""
    return (M * v[..., None, :]).sum(dim=-1)


def _pins(v4, sign):
    return (sign * v4[..., 0], sign * v4[..., 1], sign * v4[..., 2],
            sign * v4[..., 3])


def _geom(P):
    """Leff/Weff (lint/wint) and the binned parameter set
    (bsim3v32_lw_scale: p + l*dL + w*dW + p*dL*dW)."""
    leff = _max(_p(P, "L") - 2.0 * _p(P, "lint"), 1e-9)
    weff = _max(_p(P, "W") - 2.0 * _p(P, "wint"), 1e-9)
    lref = torch.where(_p(P, "lref") > 0.0, _p(P, "lref"), leff)
    wref = torch.where(_p(P, "wref") > 0.0, _p(P, "wref"), weff)
    dl = leff - lref
    dw = weff - wref

    def scale(base, pre):
        return (base + _p(P, "l" + pre) * dl + _p(P, "w" + pre) * dw +
                _p(P, "p" + pre) * dl * dw)

    binned = {k: scale(_p(P, base), k) for k, base in (
        ("vth0", "Vth0"), ("kp", "Kp"), ("u0", "u0"), ("vsat", "vsat"),
        ("ua", "ua"), ("ub", "ub"), ("uc", "uc"), ("nch", "nch"),
        ("phi", "phi"), ("gamma", "gamma"), ("k1", "k1"), ("k2", "k2"),
        ("eta0", "eta0"), ("nfactor", "nfactor"), ("voff", "voff"),
        ("keta", "keta"), ("rdsw", "rdsw"))}
    return leff, weff, binned


def _pos_smooth(x, eps=1e-4):
    return 0.5 * (x + torch.sqrt(x * x + 4.0 * eps * eps))


def _vgsteff(vgst, n, vt):
    arg = vgst / (2.0 * n * vt)
    return 2.0 * n * vt * torch.where(
        arg > 30.0, arg, torch.log1p(limexp(_min(arg, 30.0))))


def _core(P, vgs, vds, vbs, geom=None):
    """Channel quantities for vds >= 0 (forward orientation): (ids,
    vgsteff, vdseff, vdsat, vth) (bsim3v32.h:740-1007)."""
    leff, weff, B = geom if geom is not None else _geom(P)
    temp = _p(P, "Temp")
    vt = _K_B * (temp + _T0) / _Q_E
    t_ratio = (temp + _T0) / (_TNOM + _T0)
    dt_c = temp - _TNOM

    tox = _max(_p(P, "tox"), 1e-9)
    toxm = torch.where(_p(P, "toxm") > 0.0, _p(P, "toxm"), tox)
    tox_ratio = tox / toxm
    cox = _EPS_OX / tox

    vth0_t = B["vth0"] + (_p(P, "kt1") +
                          _p(P, "kt2") * vbs) * (t_ratio - 1.0)
    vsat = _max(B["vsat"] - _p(P, "at") * (t_ratio - 1.0), 1e3)

    phi_s = _max(B["phi"], 0.1)
    vbs_c = phi_s - 0.5 * ((phi_s - vbs) +
                           torch.sqrt((phi_s - vbs) ** 2 + 4.0 * 0.01))
    sqrt_phi = torch.sqrt(phi_s)
    sqrt_pv = torch.sqrt(_max(phi_s - vbs_c, 1e-12))
    k1 = torch.where(B["k1"] != 0.0, B["k1"], B["gamma"]) * tox_ratio
    k2 = B["k2"] * tox_ratio
    vth = vth0_t + k1 * (sqrt_pv - sqrt_phi) - k2 * vbs_c

    nch = torch.where(B["nch"] > 1.0, B["nch"], 1e23)
    xdep = torch.sqrt(2.0 * _EPS_SI *
                      _max(phi_s - vbs_c, 1e-12) / (_Q_E * nch))
    xdep0 = torch.sqrt(2.0 * _EPS_SI * phi_s / (_Q_E * nch))
    xj = torch.where(_p(P, "xj") > 0.0, _p(P, "xj"), xdep0)
    lt0 = torch.sqrt((_EPS_SI / _EPS_OX) * tox * xj)
    lt = torch.sqrt((_EPS_SI / _EPS_OX) * tox * xdep)
    lt = _max(lt * (1.0 + _p(P, "dvt2") * vbs_c), 1e-18)

    vbi = torch.where(_p(P, "vbi") > 0.0, _p(P, "vbi"), phi_s + 0.5)
    theta_th = _p(P, "dvt0") * (
        limexp(-_p(P, "dvt1") * leff / (2.0 * lt)) +
        2.0 * limexp(-_p(P, "dvt1") * leff / lt))
    vth = vth - theta_th * (vbi - phi_s)

    theta_dibl = torch.where(
        _p(P, "dsub") > 0.0,
        limexp(-_p(P, "dsub") * leff / (2.0 * lt0)) +
        2.0 * limexp(-_p(P, "dsub") * leff / lt0),
        1.0)
    vth = vth - theta_dibl * (B["eta0"] + _p(P, "etab") * vbs_c) * vds

    vth = vth + (_p(P, "k3") + _p(P, "k3b") * vbs_c) * tox_ratio * \
        (tox / _max(weff + _p(P, "w0"), 1e-18)) * phi_s
    vth = vth + k1 * (_max(_p(P, "nlx"), 0.0) / leff) * sqrt_phi

    vgst = vgs - vth - B["voff"]

    n = _max(B["nfactor"], 0.1) * (1.0 + _p(P, "noff"))
    n = n + _p(P, "cit") / cox
    vgsteff = _vgsteff(vgst, n, vt)

    ua = B["ua"] + _p(P, "ua1") * dt_c
    ub = B["ub"] + _p(P, "ub1") * dt_c
    uc = B["uc"] + _p(P, "uc1") * dt_c
    e_leg = (vgsteff + 2.0 * vth) / tox
    den_leg = 1.0 + (ua + uc * vbs_c) * e_leg + ub * e_leg * e_leg
    e3 = (vgsteff + 2.0 * vt) / tox
    den3 = 1.0 + (ua * e3 + ub * e3 * e3) * (1.0 + uc * vbs_c)
    e2 = vgsteff / tox
    den2 = 1.0 + (ua * e2 + ub * e2 * e2) * (1.0 + uc * vbs_c)
    den1 = 1.0 + ua * vgsteff + ub * vgsteff * vgsteff + uc * vbs_c
    mm = _p(P, "mobmod")
    denom = torch.where(mm < 0.5, den_leg,
                        torch.where(mm < 1.5, den1,
                                    torch.where(mm < 2.5, den2, den3)))
    denom = _max(denom, 0.1) * (1.0 + _p(P, "theta") * vgsteff)
    u0 = B["u0"] * t_ratio ** _p(P, "ute") / denom
    kp_eff = B["kp"] * (u0 / _max(B["u0"], 1e-12))
    beta = kp_eff * weff / leff
    esat_l = 2.0 * vsat * leff / _max(u0, 1e-6)

    abulk = _max(1.0 + B["keta"] * vbs_c, 0.1)
    vdsat = esat_l * vgsteff / (abulk * esat_l + vgsteff)
    delta = torch.where(_p(P, "delta") > 0.0, _p(P, "delta"), 0.01)
    t1 = vdsat - vds - delta
    vdseff = vdsat - 0.5 * (t1 + torch.sqrt(t1 * t1 + 4.0 * delta * vdsat))

    vgst2 = vgsteff + 2.0 * vt
    ids0 = beta * vgsteff * (1.0 - abulk * vdseff /
                             (2.0 * vgst2)) * vdseff
    ids0 = ids0 / (1.0 + vdseff / esat_l)

    rdsw = B["rdsw"] * (1.0 + _p(P, "prt") * (t_ratio - 1.0))
    rds = rdsw * (1.0 + _p(P, "prwg") * vgsteff +
                  _p(P, "prwb") * (sqrt_pv - sqrt_phi))
    rds = _max(rds, 0.0) * 1e-6 / weff
    rds = torch.where(_p(P, "rdsmod") != 0.0, rds, 0.0)
    ids0 = ids0 / (1.0 + rds * ids0 / _max(vdseff, 1e-6))

    vdsx = _pos_smooth(vds - vdseff)
    pclm = _p(P, "pclm")
    pd1 = _p(P, "pdiblc1")
    pd2 = _p(P, "pdiblc2")
    vaclm = (abulk * esat_l + vgsteff) * vdsx / \
        (_max(pclm, 1e-12) * abulk * esat_l / leff * _max(lt, 1e-18))
    theta_rout = pd1 * (limexp(-_p(P, "drout") * leff / (2.0 * lt0)) +
                        2.0 * limexp(-_p(P, "drout") * leff / lt0)) + pd2
    t3 = 1.0 - abulk * vdsat / _max(abulk * vdsat + vgst2, 1e-18)
    pvag_f = 1.0 + _p(P, "pvag") * u0 * vgsteff / \
        _max(2.0 * vsat * leff, 1e-18)
    vadiblc = vgst2 / _max(
        theta_rout * (1.0 + _p(P, "pdiblcb") * vbs_c) * t3, 1e-18) * pvag_f
    inv_va = torch.where(pclm > 0.0, 1.0 / _max(vaclm, 1e-12), 0.0)
    inv_va = inv_va + torch.where(theta_rout != 0.0,
                                  1.0 / _max(vadiblc, 1e-12), 0.0)
    clm_f = 1.0 + vdsx * inv_va
    inv_vascbe = torch.where(
        (_p(P, "pscbe1") > 0.0) & (_p(P, "pscbe2") != 0.0),
        _p(P, "pscbe2") * limexp(-_p(P, "pscbe1") * lt /
                                 _max(vdsx, 1e-12)) / leff,
        0.0)
    scbe_f = 1.0 + vdsx * inv_vascbe
    legacy = (pclm <= 0.0) & (pd1 == 0.0) & (pd2 == 0.0)
    ids = torch.where(legacy,
                      ids0 * (1.0 + _p(P, "lambda") * (vds - vdseff)),
                      ids0 * clm_f * scbe_f)
    return ids, vgsteff, vdseff, vdsat, vth


def _barrier_t(P, b):
    """barrier(T) = barrier(Tnom) * Tnom/T (bsim3v32.h:399-409)."""
    t_k = _p(P, "Temp") + _T0
    return b * (_TNOM + _T0) / _max(t_k, 1.0)


def _gidl(P, weff, a, b, c, e, vg, vx, vb):
    """GIDL subset (bsim3v32.h:1018-1040), flowing x -> bulk."""
    vxg_eff = _pos_smooth((vx - vg) - e)
    vxb_eff = _pos_smooth(vx - vb)
    denom = _max(vxg_eff + c, 1e-6)
    on = (a > 0.0) & (b > 0.0)
    i = a * weff * vxb_eff * limexp(-_barrier_t(P, b) / denom)
    return torch.where(on, i, 0.0)


def _with_dtemp(P):
    """Fold the per-device temperature delta into the Temp slot
    (bsim3v32.h:2131 Temp = base + dtemp)."""
    i = _IX["Temp"]
    return torch.cat([P[..., :i], (P[..., i] + _p(P, "dtemp"))[..., None],
                      P[..., i + 1:]], dim=-1)


def _mnf_scale(P):
    """m*nf multiplicity (bsim3v32.h:3229,3388); nonpositive -> 1."""
    m = torch.where(_p(P, "m") > 0.0, _p(P, "m"), 1.0)
    nf = torch.where(_p(P, "nf") > 0.0, _p(P, "nf"), 1.0)
    return m * nf


def _junction_params(P, weff):
    """Per-junction saturation / recombination currents and emission
    slopes with temperature scaling: (is_d, is_s, nv_d, nv_s, isr_d,
    isr_s, nvr_d, nvr_s)."""
    vt = _K_B * (_p(P, "Temp") + _T0) / _Q_E
    vtnom = _K_B * (_TNOM + _T0) / _Q_E
    t_ratio = (_p(P, "Temp") + _T0) / (_TNOM + _T0)

    def tfac(n):
        return t_ratio ** (_p(P, "xti") / n) * \
            limexp((_p(P, "eg") / n) * (1.0 / vtnom - 1.0 / vt))

    def ov(name, base, strict=True):
        v = _p(P, name)
        return torch.where(v > 0.0 if strict else v >= 0.0, v, base)

    nj = _max(_p(P, "diode_N"), 0.1)
    nj_d, nj_s = ov("nd", nj), ov("ns", nj)
    nr = _max(_p(P, "nr"), 0.1)
    nr_d, nr_s = ov("nrd", nr), ov("nrs", nr)

    js_, jsw_, jswg_ = _p(P, "js"), _p(P, "jsw"), _p(P, "jswg")
    jsd_, jss_ = ov("jsd", js_), ov("jss", js_)
    jswd_, jsws_ = ov("jswd", jsw_), ov("jsws", jsw_)
    jswgd_, jswgs_ = ov("jswgd", jswg_), ov("jswgs", jswg_)
    use_dens = (jsd_ > 0.0) | (jss_ > 0.0) | (jswd_ > 0.0) | \
        (jsws_ > 0.0) | (jswgd_ > 0.0) | (jswgs_ > 0.0)
    is0 = _p(P, "diode_Is")
    is0_d, is0_s = ov("isd", is0, False), ov("iss", is0, False)
    is_d = torch.where(
        use_dens,
        _max(jsd_ * _p(P, "ad") + jswd_ * _p(P, "pd") + jswgd_ * weff,
             1e-30), is0_d) * tfac(nj_d)
    is_s = torch.where(
        use_dens,
        _max(jss_ * _p(P, "as") + jsws_ * _p(P, "ps") + jswgs_ * weff,
             1e-30), is0_s) * tfac(nj_s)

    jsr_, jsrw_, jsrwg_ = _p(P, "jsr"), _p(P, "jsrw"), _p(P, "jsrwg")
    use_jsr = (jsr_ > 0.0) | (jsrw_ > 0.0) | (jsrwg_ > 0.0)
    isr0 = _p(P, "isr")
    isr0_d, isr0_s = ov("isrd", isr0, False), ov("isrs", isr0, False)
    isr_d = torch.where(
        use_jsr, jsr_ * _p(P, "ad") + jsrw_ * _p(P, "pd") + jsrwg_ * weff,
        isr0_d) * tfac(nr_d)
    isr_s = torch.where(
        use_jsr, jsr_ * _p(P, "as") + jsrw_ * _p(P, "ps") + jsrwg_ * weff,
        isr0_s) * tfac(nr_s)
    return (is_d, is_s, nj_d * vt, nj_s * vt,
            isr_d, isr_s, nr_d * vt, nr_s * vt)


def _terminal_currents(P, v4, sign):
    """I(d, g, s, b) with the symmetric source/drain swap for reverse
    vds; ``sign`` +1 NMOS, -1 PMOS (evaluated in mirrored voltages)."""
    P = _with_dtemp(P)
    geom = _geom(P)
    vd, vg, vs, vb = _pins(v4, sign)
    vds = vd - vs
    fwd = vds >= 0.0

    ids_f, _vgst_f, vdse_f, _vds_f, _vth_f = _core(P, vg - vs, vds,
                                                   vb - vs, geom)
    ids_r, _vgst_r, vdse_r, _vds_r, _vth_r = _core(P, vg - vd, -vds,
                                                   vb - vd, geom)
    ids = torch.where(fwd, ids_f, -ids_r)
    vdseff = torch.where(fwd, vdse_f, vdse_r)

    # impact ionization (bsim3v32.h:1141-1154)
    vds_ii = _pos_smooth(vds.abs() -
                         torch.where(_p(P, "vdsatii") > 0.0,
                                     _p(P, "vdsatii"), vdseff))
    a0, b0 = _p(P, "alpha0"), _p(P, "beta0")
    iii = torch.where((a0 > 0.0) & (b0 > 0.0),
                      a0 * ids.abs() * vds_ii *
                      limexp(-_barrier_t(P, b0) / _max(vds_ii, 1e-6)),
                      0.0)

    # GIDL (drain edge) and GISL (source edge, params fall back)
    leff, weff, _B = geom
    ig_d = _gidl(P, weff, _p(P, "agidl"), _p(P, "bgidl"),
                 _p(P, "cgidl"), _p(P, "egidl"), vg, vd, vb)

    def fb(name, base):
        return torch.where(_p(P, name) > 0.0, _p(P, name), _p(P, base))

    ig_s = _gidl(P, weff, fb("agisl", "agidl"), fb("bgisl", "bgidl"),
                 fb("cgisl", "cgidl"), fb("egisl", "egidl"), vg, vs, vb)

    # bulk junctions (SPICE-style, limexp-clamped)
    (is_d, is_s, nv_d, nv_s,
     isr_d, isr_s, nvr_d, nvr_s) = _junction_params(P, weff)
    ibs = is_s * (limexp((vb - vs) / nv_s) - 1.0) + \
        isr_s * (limexp((vb - vs) / nvr_s) - 1.0)
    ibd = is_d * (limexp((vb - vd) / nv_d) - 1.0) + \
        isr_d * (limexp((vb - vd) / nvr_d) - 1.0)

    # junction breakdown (bsim3v32.h:1921-1926,3340-3347)
    def _jbk(v, is_eff, nv, bv, ibv):
        on = (bv > 0.0) & (ibv > 0.0)
        is_safe = _max(is_eff, 1e-30)
        bv_eff = bv - nv * torch.log(_max(ibv / is_safe, 1.0))
        bk = on & (v < -bv_eff)
        return torch.where(bk, -is_eff * limexp(-(bv_eff + v) / nv), 0.0)

    ibd = ibd + _jbk(vb - vd, is_d, nv_d, _p(P, "bvd"), _p(P, "ibvd"))
    ibs = ibs + _jbk(vb - vs, is_s, nv_s, _p(P, "bvs"), _p(P, "ibvs"))

    # gate leakage (bsim3v32.h:1069-1131 igb/igs/igd subset)
    weff_c = _max(_p(P, "W") - 2.0 * _max(_p(P, "dwc"), 0.0), 1e-18)
    leff_c = _max(_p(P, "L") - 2.0 * _max(_p(P, "dlc"), 0.0), 1e-18)

    def _ig(a, b, c, e, dv):
        b_ = torch.where(b > 0.0, b, _p(P, "bigb"))
        c_ = torch.where(c != 0.0, c, _p(P, "cigb"))
        e_ = torch.where(e != 0.0, e, _p(P, "eigb"))
        v_eff = _pos_smooth(dv - e_)
        denom = _max(v_eff + c_, 1e-12)
        on = (a > 0.0) & (b_ > 0.0)
        i = a * weff_c * leff_c * v_eff * v_eff * \
            limexp(-_barrier_t(P, b_) / denom)
        return torch.where(on, i, 0.0)

    def ig(kind, dv):
        return _ig(*(_p(P, f"{c}ig{kind}") for c in "abce"), dv)

    igb = ig("b", vg - vb)
    igs = ig("s", vg - vs)
    igd = ig("d", vg - vd)

    i_d = ids - ibd + iii + ig_d - igd
    i_s = -ids - ibs + ig_s - igs
    i_b = ibs + ibd - iii - ig_d - ig_s - igb
    i_g = igb + igs + igd
    return (sign * _mnf_scale(P))[..., None] * \
        torch.stack([i_d, i_g, i_s, i_b], dim=-1)


# ---------------------------------------------------------------------------
# charge model: one Q(v) covering overlaps, intrinsic C-V, junctions
# ---------------------------------------------------------------------------

def _qj(v, cj0, mjq, pbq, fcq):
    """Depletion charge of a junction cap (SPICE grading), linearized
    above fc*pb."""
    pbq = _max(pbq, 0.1)
    mjq = _clip(mjq, 0.05, 0.95)
    fc = _clip(fcq, 0.0, 0.95) * pbq
    q_rev = cj0 * pbq / (1.0 - mjq) * \
        (1.0 - _max(1.0 - torch.minimum(v, fc) / pbq, 1e-3) ** (1.0 - mjq))
    c_fc = cj0 * (1.0 - fc / pbq) ** (-mjq)
    q_fwd = q_rev + c_fc * (v - fc)
    return torch.where(v <= fc, q_rev, q_fwd)


def _intrinsic_charges(P, vgs, vds, vbs, geom):
    """capMod >= 1 intrinsic (qd, qg, qs, qb) (bsim3v32.h:1202-1420)."""
    leff, weff, B = geom
    temp = _p(P, "Temp")
    vt = _K_B * (temp + _T0) / _Q_E
    cox = _EPS_OX / _max(_p(P, "tox"), 1e-9)
    coxwl = cox * weff * leff

    phi_s = _max(B["phi"], 0.1)
    vbseff = phi_s - _pos_smooth(phi_s - vbs, 1e-2)
    sqrt_phi = torch.sqrt(phi_s)
    sqrt_pv = torch.sqrt(_max(phi_s - vbseff, 1e-12))
    k1 = torch.where(B["k1"] != 0.0, B["k1"], B["gamma"])
    qb = coxwl * (k1 * (sqrt_pv - sqrt_phi) - _p(P, "k2") * vbseff)

    _ids, vgsteff, vdseff, vdsat, vth = _core(P, vgs, _pos_smooth(vds),
                                              vbs, geom)
    vgst_cv = vgs - vth - _p(P, "voffcv")
    n = _max(_p(P, "nfactor"), 0.1)
    vgsteff_cv = _vgsteff(vgst_cv, n, vt)
    abulk = 1.0 + B["keta"] * vbseff
    vds_pos = _pos_smooth(vds)

    delta = 0.01
    s_reg = vds_pos - vdsat
    f_sat = 0.5 * (1.0 + s_reg / torch.sqrt(s_reg * s_reg + delta * delta))

    qinv_lin = -coxwl * (vgsteff_cv - abulk * vdseff / 2.0)
    qinv_sat = -(2.0 / 3.0) * coxwl * vgsteff_cv
    qinv = (1.0 - f_sat) * qinv_lin + f_sat * qinv_sat

    qd_lin = -coxwl * (0.5 * vgsteff_cv - abulk * vdseff / 3.0)
    xp = _clip(_p(P, "xpart"), 0.0, 1.0)
    frac_d = torch.where(xp <= 0.5, xp, 0.6 - 0.2 * xp)
    qd_sat = frac_d * qinv_sat
    qd = (1.0 - f_sat) * qd_lin + f_sat * qd_sat
    qs = qinv - qd

    qg = -(qinv + qb)

    nch = torch.where(B["nch"] > 1.0, B["nch"], 1e23)
    xdep = torch.sqrt(2.0 * _EPS_SI *
                      _max(phi_s - vbseff, 1e-12) / (_Q_E * nch))
    cdep = _EPS_SI / _max(xdep, 1e-18)
    cdep_wl = coxwl * cdep / (cox + cdep)
    vfb = torch.where(_p(P, "vfbcv") != 0.0, _p(P, "vfbcv"),
                      B["vth0"] - phi_s)
    x = (vgs - vbs) - vfb
    absx = torch.sqrt(x * x + 1e-4)
    minx = 0.5 * (x - absx)
    maxx = 0.5 * (x + absx)
    vgst_sgn = vgs - vth
    f_cut = 0.5 * (1.0 - vgst_sgn / torch.sqrt(vgst_sgn * vgst_sgn + 1e-4))
    qacc = coxwl * minx
    qdep = cdep_wl * maxx * f_cut
    qg = qg + qacc + qdep
    qb = qb - qacc - qdep
    return qd, qg, qs, qb


def _intrinsic_terminal(P, vd, vg, vs, vb, geom):
    """The capMod >= 1 intrinsic charges, source/drain-swap symmetric
    and gated by capmod: [qd, qg, qs, qb] (unscaled)."""
    vds = vd - vs
    fwd = vds >= 0.0
    qd_f, qg_f, qs_f, qb_f = _intrinsic_charges(P, vg - vs, vds, vb - vs,
                                                geom)
    qs_r, qg_r, qd_r, qb_r = _intrinsic_charges(P, vg - vd, -vds, vb - vd,
                                                geom)
    on = _p(P, "capmod") >= 1.0
    return [torch.where(on, torch.where(fwd, f, r), 0.0)
            for f, r in ((qd_f, qd_r), (qg_f, qg_r), (qs_f, qs_r),
                         (qb_f, qb_r))]


def _capmod_on(P) -> bool:
    """Whether any instance has capMod >= 1 (one host read): with none,
    every intrinsic charge is exactly 0 and is not evaluated."""
    return bool((_p(P, "capmod") >= 1.0).any())


def _charges(P, v4, sign, intrinsic=True):
    """Terminal charges Q(d, g, s, b): overlap + intrinsic + junction.
    ``intrinsic=False`` leaves the intrinsic block out, which is exact
    when no instance has capMod >= 1 (its terms are then + 0.0)."""
    P = _with_dtemp(P)
    vd, vg, vs, vb = _pins(v4, sign)
    leff_c = _max(_p(P, "L") - 2.0 * _max(_p(P, "dlc"), 0.0), 1e-18)
    weff_c = _max(_p(P, "W") - 2.0 * _max(_p(P, "dwc"), 0.0), 1e-18)
    dens_on = _p(P, "acm") == 0.0
    cgs_e = _p(P, "Cgs") + torch.where(dens_on, _p(P, "cgso") * weff_c, 0.0)
    cgd_e = _p(P, "Cgd") + torch.where(dens_on, _p(P, "cgdo") * weff_c, 0.0)
    cgb_e = _p(P, "Cgb") + torch.where(dens_on, _p(P, "cgbo") * leff_c, 0.0)
    qg = (cgs_e * (vg - vs) + cgd_e * (vg - vd) + cgb_e * (vg - vb))
    qd = cgd_e * (vd - vg)
    qs = cgs_e * (vs - vg)
    qb = cgb_e * (vb - vg)
    # junction depletion charges with tempcos and the wave-6 per-junction
    # override / inherit chains (bsim3v32.h:1990-2042)
    dT = _p(P, "Temp") - _TNOM

    def ov(name, base):
        v = _p(P, name)                  # <= 0 inherits base
        return torch.where(v > 0.0, v, base)

    def nz(name, base):                  # 0 inherits base
        return torch.where(_p(P, name) != 0.0, _p(P, name), _p(P, base))

    def ge(name, base):                  # < 0 inherits base
        return torch.where(_p(P, name) >= 0.0, _p(P, name), base)

    cj_d0, cj_s0 = nz("cjd", "cj"), nz("cjs", "cj")
    cjsw_d0, cjsw_s0 = nz("cjswd", "cjsw"), nz("cjsws", "cjsw")
    cjswg_d0, cjswg_s0 = nz("cjswgd", "cjswg"), nz("cjswgs", "cjswg")
    tcj_f = 1.0 + _p(P, "tcj") * dT
    tcjsw_f = 1.0 + _p(P, "tcjsw") * dT
    tcjswg_f = 1.0 + _p(P, "tcjswg") * dT
    pb_d0, pb_s0 = ov("pbd", _p(P, "pb")), ov("pbs", _p(P, "pb"))
    pbsw_d0, pbsw_s0 = ov("pbswd", _p(P, "pbsw")), ov("pbsws", _p(P, "pbsw"))
    pbswg_b = ov("pbswg", _p(P, "pbsw"))
    pbswg_d0, pbswg_s0 = ov("pbswgd", pbswg_b), ov("pbswgs", pbswg_b)
    tpb_f = 1.0 + _p(P, "tpb") * dT
    tpbsw_f = 1.0 + _p(P, "tpbsw") * dT
    tpbswg_f = 1.0 + _p(P, "tpbswg") * dT
    mj_d, mj_s = ge("mjd", _p(P, "mj")), ge("mjs", _p(P, "mj"))
    mjsw_d, mjsw_s = ge("mjswd", _p(P, "mjsw")), ge("mjsws", _p(P, "mjsw"))
    mjswg_b = ov("mjswg", _p(P, "mjsw"))
    mjswg_d, mjswg_s = ge("mjswgd", mjswg_b), ge("mjswgs", mjswg_b)
    fc_d, fc_s = ge("fcd", _p(P, "fc")), ge("fcs", _p(P, "fc"))
    weff_cv = _max(_p(P, "W") - 2.0 * _max(_p(P, "dwc"), 0.0), 1e-18)
    cj_s_ = cj_s0 * tcj_f * _p(P, "as")
    cj_d_ = cj_d0 * tcj_f * _p(P, "ad")
    cjsw_s_ = cjsw_s0 * tcjsw_f * _p(P, "ps")
    cjsw_d_ = cjsw_d0 * tcjsw_f * _p(P, "pd")
    cjswg_s_ = cjswg_s0 * tcjswg_f * weff_cv
    cjswg_d_ = cjswg_d0 * tcjswg_f * weff_cv
    qbs = _qj(vb - vs, cj_s_, mj_s, pb_s0 * tpb_f, fc_s) + \
        _qj(vb - vs, cjsw_s_, mjsw_s, pbsw_s0 * tpbsw_f, fc_s) + \
        _qj(vb - vs, cjswg_s_, mjswg_s, pbswg_s0 * tpbswg_f, fc_s)
    qbd = _qj(vb - vd, cj_d_, mj_d, pb_d0 * tpb_f, fc_d) + \
        _qj(vb - vd, cjsw_d_, mjsw_d, pbsw_d0 * tpbsw_f, fc_d) + \
        _qj(vb - vd, cjswg_d_, mjswg_d, pbswg_d0 * tpbswg_f, fc_d)

    # diffusion (transit-time) charge q = tt * I_junction(v)
    tt_d = ge("ttd", _p(P, "tt"))
    tt_s = ge("tts", _p(P, "tt"))
    geom = _geom(P)
    (is_d, is_s, nv_d, nv_s,
     _isr_d, _isr_s, _nvr_d, _nvr_s) = _junction_params(P, geom[1])
    qbs = qbs + _max(tt_s, 0.0) * (is_s * (limexp((vb - vs) / nv_s) - 1.0))
    qbd = qbd + _max(tt_d, 0.0) * (is_d * (limexp((vb - vd) / nv_d) - 1.0))

    qb = qb + qbs + qbd
    qs = qs - qbs
    qd = qd - qbd

    q = [qd, qg, qs, qb]
    if intrinsic:
        q = [a + b for a, b in zip(q, _intrinsic_terminal(P, vd, vg, vs, vb,
                                                          geom))]
    return (sign * _mnf_scale(P))[..., None] * torch.stack(q, dim=-1)


def _charges_intrinsic_only(P, v4, sign):
    """The intrinsic (capMod >= 1) terminal-charge vector alone: the
    subsystem wave-9 NQS relaxes."""
    P = _with_dtemp(P)
    q = _intrinsic_terminal(P, *_pins(v4, sign), _geom(P))
    return (sign * _mnf_scale(P))[..., None] * torch.stack(q, dim=-1)


def _chan_noise_bias(P2, v4, sign):
    """(ids, gsum) at the OP bias: gsum = |gm| + |gds| + |gmb| from the
    Jacobian of the same channel-current core the stamps use."""
    geom = _geom(P2)

    def chan(v4_):
        vd, vg, vs, vb = _pins(v4_, sign)
        vds = vd - vs
        ids_f = _core(P2, vg - vs, vds, vb - vs, geom)[0]
        ids_r = _core(P2, vg - vd, -vds, vb - vd, geom)[0]
        return torch.where(vds >= 0.0, ids_f, -ids_r)[..., None]

    ids, J = _jac(chan, v4)
    J = J[..., 0, :]
    return ids[..., 0], J[..., 1].abs() + J[..., 0].abs() + J[..., 3].abs()


def _nqs_tau(P, v4, sign):
    """Wave-9 NQS relaxation time: 1/τ = 16·μ0·Ut/Leff² +
    elm·gd0/(Cox·Weff·Leff), gd0 = gm + gds + gmb at the bias."""
    P2 = _with_dtemp(P)
    leff, weff, B = _geom(P2)
    ut = _K_B * (_p(P2, "Temp") + _T0) / _Q_E
    cox = _EPS_OX / _max(_p(P2, "tox"), 1e-9)
    cwl = cox * weff * leff
    u0b = _max(B["u0"], 1e-6)
    inv_diff = 16.0 * u0b * ut / (leff * leff)
    _ids, g0 = _chan_noise_bias(P2, v4, sign)
    elm = _max(_p(P2, "elm"), 1e-3)
    inv_drift = elm * g0 / _max(cwl, 1e-30)
    return 1.0 / (inv_diff + inv_drift)


def _nqs_on(P):
    """(per-instance NQS flags, whether any instance has NQS on); with
    none, every NQS term is exactly 0 and is not evaluated."""
    on = _p(P, "nqsmod") != 0.0
    return on, bool(on.any())


# ---------------------------------------------------------------------------
# stamps
# ---------------------------------------------------------------------------

def _state_mat(state, prefix, k):
    """(..., k, k) matrix from the state slots prefix0..prefix{k*k-1}."""
    m = torch.stack([state[f"{prefix}{i}"] for i in range(k * k)], dim=-1)
    return m.reshape(m.shape[:-1] + (k, k))


def _state_vec(state, prefix, k):
    return torch.stack([state[f"{prefix}{i}"] for i in range(k)], dim=-1)


def _put(out, prefix, vals):
    for i in range(vals.shape[-1]):
        out[f"{prefix}{i}"] = vals[..., i]


def _make_stamp(sign):
    def stamp(P, v, ib, state, ctx):
        i_now, J = _jac(lambda v4: _terminal_currents(P, v4, sign), v)
        ieq = i_now - _mv(J, v)
        a_vals = J.reshape(J.shape[:-2] + (16,))
        z_vals = -ieq
        new_state = dict(state)
        # save the operating point for AC (save_op role)
        for k, name in enumerate(("vd", "vg", "vs", "vb")):
            new_state[name] = v[..., k]
        if ctx.mode == "tr":
            # trapezoidal charge companion + the NQS current model
            G = torch.stack([state[f"cg{k}"] + state[f"ng{k}"]
                             for k in range(16)], dim=-1)
            h = torch.stack([state[f"ch{k}"] + state[f"nh{k}"]
                             for k in range(4)], dim=-1)
            a_vals = a_vals + G
            z_vals = z_vals - h
        return a_vals, z_vals, new_state
    return stamp


def _make_step_update(sign):
    def _step_update(P, v, ib, state, dt, t):
        out = dict(state)
        nqs_on, nqs_any = _nqs_on(P)
        capmod = _capmod_on(P)
        _q, C = _jac(lambda v4: _charges(P, v4, sign, capmod), v)
        C_int = None
        if nqs_any:
            _q, C_int = _jac(lambda v4: _charges_intrinsic_only(P, v4, sign),
                             v)
            C_qs = torch.where(nqs_on[..., None, None], C - C_int, C)
        else:
            C_qs = C
        G_prev = _state_mat(state, "cg", 4)
        h_prev = _state_vec(state, "ch", 4)
        ic_now = _mv(G_prev, v) + h_prev          # companion current at t
        G_new = 2.0 * C_qs / dt
        h_new = -_mv(G_new, v) - ic_now
        _put(out, "cg", G_new.reshape(G_new.shape[:-2] + (16,)))
        _put(out, "ch", h_new)
        # NQS current model for the next step, trapezoid-consistent
        # (phy_engine_tpu/models/bsim3.py:970-991)
        zero = torch.zeros_like(v[..., 0])
        if not nqs_any:
            for k in range(16):
                out[f"ng{k}"] = zero
            for k in range(4):
                out[f"nh{k}"] = zero
            out["ntau"] = zero
            return out
        tau = _nqs_tau(P, v, sign)
        i_n = _mv(_state_mat(state, "ng", 4), v) + _state_vec(state, "nh", 4)
        qdef_n = state["ntau"][..., None] * i_n
        den = tau + dt / 2.0
        Gn = C_int / den[..., None, None]
        hn = (qdef_n - (dt / 2.0) * i_n) / den[..., None] - _mv(Gn, v)
        on = nqs_on[..., None]
        _put(out, "ng", torch.where(on, Gn.reshape(Gn.shape[:-2] + (16,)),
                                    0.0))
        _put(out, "nh", torch.where(on, hn, 0.0))
        out["ntau"] = torch.where(nqs_on, tau, zero)
        return out
    return _step_update


def _make_ac_stamp(sign):
    def _ac_stamp(P, state, omega):
        v = torch.stack([state["vd"], state["vg"], state["vs"],
                         state["vb"]], dim=-1)
        _i, J = _jac(lambda v4: _terminal_currents(P, v4, sign), v)
        nqs_on, nqs_any = _nqs_on(P)
        _q, C = _jac(lambda v4: _charges(P, v4, sign, _capmod_on(P)), v)
        J, C = J.reshape(J.shape[:-2] + (16,)), C.reshape(C.shape[:-2] + (16,))
        w = omega[..., None]
        if not nqs_any:
            return J, w * C, _zeros4(v), _zeros4(v)
        # wave-9 NQS: jωC_int -> jωC_int/(1+jωτ) on the intrinsic part
        _q, C_int = _jac(lambda v4: _charges_intrinsic_only(P, v4, sign), v)
        C_int = C_int.reshape(C_int.shape[:-2] + (16,))
        tau = _nqs_tau(P, v, sign)[..., None]
        den = 1.0 + (w * tau) ** 2
        on = nqs_on[..., None]
        a_re = J + torch.where(on, (w * w * tau / den) * C_int, 0.0)
        a_im = w * torch.where(on, (C - C_int) + C_int / den, C)
        return a_re, a_im, _zeros4(v), _zeros4(v)
    return _ac_stamp


def _zeros4(v):
    return v.new_zeros(v.shape[:-1] + (4,))


def _pattern(pins, brs):
    order = tuple(pins[:4])
    rows, cols = [], []
    for r in order:
        for c in order:
            rows.append(r)
            cols.append(c)
    return rows, cols


def _rhs(pins, brs):
    return list(pins[:4])


_STATE = tuple([("vd", 0.0), ("vg", 0.0), ("vs", 0.0), ("vb", 0.0)] +
               [(f"cg{k}", 0.0) for k in range(16)] +
               [(f"ch{k}", 0.0) for k in range(4)] +
               [(f"ng{k}", 0.0) for k in range(16)] +
               [(f"nh{k}", 0.0) for k in range(4)] +
               [("ntau", 0.0)])

# alternate attribute spellings (bsim3v32.h:2865+)
_ALIASES = {
    "w": "W", "l": "L", "kp": "Kp", "vth0": "Vth0", "temp": "Temp",
    "cgs": "Cgs", "cgd": "Cgd", "cgb": "Cgb",
    "mobMod": "mobmod", "capMod": "capmod",
    "rdsMod": "rdsmod", "rgateMod": "rgatemod",
    "rbodyMod": "rbodymod", "nqsMod": "nqsmod",
    "is": "diode_Is", "n": "diode_N",
    "diode_Isr": "isr", "diode_Nr": "nr",
    "diode_Isd": "isd", "diode_Iss": "iss",
    "diode_Nd": "nd", "diode_Ns": "ns",
    "diode_Isrd": "isrd", "diode_Isrs": "isrs",
    "diode_Nrd": "nrd", "diode_Nrs": "nrs",
    "Rd": "rd", "Rs": "rs", "Rb": "rb",
    "drainArea": "ad", "sourceArea": "as",
    "drainPerimeter": "pd", "sourcePerimeter": "ps",
}


def _make_noise(sign):
    """Wave 7: drain-source channel noise at the OP bias, thermal
    8kT(gm+gds+gmb)/3 + flicker kf·Ids^af / (Cox·Leff²·f^ef)."""
    def _noise(P, v, ib, state, env, f):
        P2 = _with_dtemp(P)
        T = _p(P2, "Temp") + _T0
        ids, gsum = _chan_noise_bias(P2, v[..., :4], sign)
        thermal = (8.0 / 3.0) * _K_B * T * gsum
        leff, _weff, _B = _geom(P2)
        cox = _EPS_OX / _max(_p(P2, "tox"), 1e-9)
        flicker = (_p(P2, "kf") * ids.abs() ** _p(P2, "af") /
                   (cox * leff * leff * _max(f, 1e-30) ** _p(P2, "ef")))
        on = _p(P2, "noimod") != 0.0
        return torch.where(on, (thermal + flicker) * _mnf_scale(P2),
                           0.0)[..., None]
    return _noise


def _make_noise_corr(sign, src):
    """Wave 8: induced gate noise S_ig = (16/15)·kT·ω²·Cgs²/gd0 on the gate
    pair, cross-correlated j·0.395·sqrt(S_ig·S_id0) with the channel
    source, S_id0 = (8/3)·kT·gd0 (S_bb = 0: the drain thermal lives in
    the plain hook)."""
    def _corr(P, v, ib, state, env, f, w):
        P2 = _with_dtemp(P)
        T = _p(P2, "Temp") + _T0
        _ids, gsum = _chan_noise_bias(P2, v[..., src], sign)
        leff, weff, _B = _geom(P2)
        cox = _EPS_OX / _max(_p(P2, "tox"), 1e-9)
        cgs = (2.0 / 3.0) * cox * weff * leff
        g0 = _max(gsum, 1e-18)
        sig = (16.0 / 15.0) * _K_B * T * (w * cgs) ** 2 / g0
        sid0 = (8.0 / 3.0) * _K_B * T * g0
        cr_im = 0.395 * torch.sqrt(sig * sid0)
        scale = (_p(P2, "noimod") != 0.0).to(P.dtype) * _mnf_scale(P2)
        z = torch.zeros_like(sig)
        S = torch.stack([sig, z, z, cr_im], dim=-1)
        return (scale[..., None] * S)[..., None, :]
    return _corr


def _mk(name, id_name, sign):
    return register(ModelDef(
        name=name, id_name=id_name, device_class=DeviceClass.NONLINEAR,
        pins=("D", "G", "S", "B"), defaults=dict(_DEFAULTS),
        param_order=_PARAMS,
        state_vars=_STATE,
        pattern=_pattern, rhs_pattern=_rhs,
        stamp=_make_stamp(sign), ac_stamp=_make_ac_stamp(sign),
        step_update=_make_step_update(sign), nonlinear=True,
        attrs=_PARAMS, attr_aliases=_ALIASES,
        noise=_make_noise(sign), noise_pairs=((0, 2),),
        # induced gate noise group: gate source (G,S) correlated with the
        # drain source (D,S)
        noise_corr=_make_noise_corr(sign, slice(0, 4)),
        noise_corr_pairs=(((1, 2), (0, 2)),),
    ))


BSIM3V32_NMOS = _mk("BSIM3v32 NMOS", "BSIM3_NMOS", +1.0)
BSIM3V32_PMOS = _mk("BSIM3v32 PMOS", "BSIM3_PMOS", -1.0)


# ---------------------------------------------------------------------------
# parasitic-terminal variant: D/G/S/B series resistances via internal
# nodes (bsim3v32.h:3388-3400), floored at 1 uOhm
# ---------------------------------------------------------------------------

_R_FLOOR = 1e-6


def _rc_conductances(P):
    """Per-terminal series conductances g = scale / max(R_eff, floor) in
    pin order (d, g, s, b): (..., 4)."""
    scale = _mnf_scale(P)
    rsh = _max(_p(P, "rsh"), 0.0)
    rd = _max(_p(P, "rd"), 0.0) + rsh * _max(_p(P, "nrd"), 0.0)
    rs = _max(_p(P, "rs"), 0.0) + rsh * _max(_p(P, "nrs"), 0.0)
    rg = torch.where(_p(P, "rgatemod") != 0.0, _max(_p(P, "rg"), 0.0), 0.0)
    rb = torch.where(_p(P, "rbodymod") != 0.0, _max(_p(P, "rb"), 0.0), 0.0)
    rr = torch.stack([rd, rg, rs, rb], dim=-1)
    return scale[..., None] / _max(rr, _R_FLOOR)


def _rc_currents(P, v8, sign):
    """Total currents of the 8-terminal device, v8 = [ext d g s b, int d'
    g' s' b']: intrinsic BSIM3 at the internal nodes, series resistors
    between external and internal."""
    g = _rc_conductances(P)
    i_ser = g * (v8[..., :4] - v8[..., 4:])
    i_int = _terminal_currents(P, v8[..., 4:], sign)
    return torch.cat([i_ser, i_int - i_ser], dim=-1)


def _rc_charges(P, v8, sign, intrinsic=True):
    """Terminal charges: the intrinsic Q at the internal nodes only."""
    q_int = _charges(P, v8[..., 4:], sign, intrinsic)
    return torch.cat([torch.zeros_like(q_int), q_int], dim=-1)


def _make_rc_stamp(sign):
    def stamp(P, v, ib, state, ctx):
        i_now, J = _jac(lambda v8: _rc_currents(P, v8, sign), v)
        ieq = i_now - _mv(J, v)
        a_vals = J.reshape(J.shape[:-2] + (64,))
        z_vals = -ieq
        new_state = dict(state)
        for k in range(8):
            new_state[f"v{k}"] = v[..., k]
        if ctx.mode == "tr":
            a_vals = a_vals + _state_vec(state, "cg", 64)
            z_vals = z_vals - _state_vec(state, "ch", 8)
        return a_vals, z_vals, new_state
    return stamp


def _make_rc_step_update(sign):
    def _step_update(P, v, ib, state, dt, t):
        out = dict(state)
        capmod = _capmod_on(P)
        _q, C = _jac(lambda v8: _rc_charges(P, v8, sign, capmod), v)
        ic_now = (_mv(_state_mat(state, "cg", 8), v)
                  + _state_vec(state, "ch", 8))
        G_new = 2.0 * C / dt
        h_new = -_mv(G_new, v) - ic_now
        _put(out, "cg", G_new.reshape(G_new.shape[:-2] + (64,)))
        _put(out, "ch", h_new)
        return out
    return _step_update


def _make_rc_ac_stamp(sign):
    def _ac_stamp(P, state, omega):
        v = _state_vec(state, "v", 8)
        _i, J = _jac(lambda v8: _rc_currents(P, v8, sign), v)
        _q, C = _jac(lambda v8: _rc_charges(P, v8, sign, _capmod_on(P)), v)
        z = v.new_zeros(v.shape[:-1] + (8,))
        return (J.reshape(J.shape[:-2] + (64,)),
                omega[..., None] * C.reshape(C.shape[:-2] + (64,)), z, z)
    return _ac_stamp


def _rc_pattern(pins, brs):
    rows, cols = [], []
    for r in pins:
        for c in pins:
            rows.append(r)
            cols.append(c)
    return rows, cols


def _rc_rhs(pins, brs):
    return list(pins)


_RC_STATE = tuple([(f"v{k}", 0.0) for k in range(8)] +
                  [(f"cg{k}", 0.0) for k in range(64)] +
                  [(f"ch{k}", 0.0) for k in range(8)])


def _make_rc_noise(sign):
    """Wave 7 for the parasitic variant: channel noise between the
    internal d'/s' nodes, plus 4kT·g thermal for each real series
    resistance (floored-to-short terminals are noiseless)."""
    core = _make_noise(sign)

    def _noise(P, v, ib, state, env, f):
        ch = core(P, v[..., 4:], ib, state, env, f)
        P2 = _with_dtemp(P)
        T = (_p(P2, "Temp") + _T0)[..., None]
        g = _rc_conductances(P2)
        gmax = (_mnf_scale(P2) / _R_FLOOR)[..., None]
        th = torch.where(g < gmax * (1.0 - 1e-9), 4.0 * _K_B * T * g, 0.0)
        return torch.cat([ch, th], dim=-1)

    return _noise


def _mk_rc(name, id_name, sign):
    return register(ModelDef(
        name=name, id_name=id_name, device_class=DeviceClass.NONLINEAR,
        pins=("D", "G", "S", "B"), defaults=dict(_DEFAULTS),
        param_order=_PARAMS,
        state_vars=_RC_STATE,
        pattern=_rc_pattern, rhs_pattern=_rc_rhs,
        stamp=_make_rc_stamp(sign), ac_stamp=_make_rc_ac_stamp(sign),
        step_update=_make_rc_step_update(sign), nonlinear=True,
        attrs=_PARAMS, attr_aliases=_ALIASES, n_internal=4,
        # channel between internal d'(4)/s'(6); series-R thermal between
        # each external pin and its internal node
        noise=_make_rc_noise(sign),
        noise_pairs=((4, 6), (0, 4), (1, 5), (2, 6), (3, 7)),
        # induced gate noise on the internal g'(5)-s'(6) pair, correlated
        # with the internal channel source d'(4)-s'(6)
        noise_corr=_make_noise_corr(sign, slice(4, 8)),
        noise_corr_pairs=(((5, 6), (4, 6)),),
    ))


BSIM3V32_NMOS_RC = _mk_rc("BSIM3v32 NMOS (terminal parasitics)",
                          "BSIM3_NMOS_RC", +1.0)
BSIM3V32_PMOS_RC = _mk_rc("BSIM3v32 PMOS (terminal parasitics)",
                          "BSIM3_PMOS_RC", -1.0)
