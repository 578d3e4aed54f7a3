"""Inputs and checks shared by ``test_torch_bsim3.py`` (which describes
them) and ``test_torch_bsim3_rc.py``; the card tests use its inputs."""

import functools

import numpy as np
import torch

from phy_engine_tpu_torch.models import MODEL_REGISTRY, StampCtx

torch.set_num_threads(1)

FAMILIES = ("BSIM3_NMOS", "BSIM3_PMOS", "BSIM3_NMOS_RC", "BSIM3_PMOS_RC")
B, NI = 2, 12
T, DT = 3.7e-9, 1e-10
ENV = {"g_min": 0.0, "temperature": 27.0}
TOL = 1e-10
TOL_NOISE = 1e-9        # the noise analysis' bound (test_torch_noise.py)

BASE = {"W": 10e-6, "L": 1e-6, "Kp": 2e-4, "Vth0": 0.7}
WAVES = {
    "defaults": {},
    "gate_leakage": {"aigb": 1e-3, "bigb": 2.0, "cigb": 0.5, "eigb": 0.1,
                     "aigd": 1e-3, "bigd": 2.0, "cigd": 0.5,
                     "aigs": 5e-4, "dwc": 1e-8, "dlc": 2e-8},
    "gidl_gisl_ii": {"agidl": 1e-3, "bgidl": 2.0, "cgidl": 0.5,
                     "egidl": 0.2, "agisl": 5e-4, "alpha0": 1e-2,
                     "beta0": 5.0},
    "rds": {"rdsw": 200.0, "prwg": 0.1, "prwb": 0.05, "prt": 0.01,
            "Temp": 60.0},
    "capmod_xpart": {"capmod": 1.0, "xpart": 0.4, "Cgs": 1e-14,
                     "cgso": 1e-10, "cgdo": 1e-10, "cgbo": 1e-11,
                     "k1": 0.5, "k2": 0.02, "keta": -0.02, "nch": 1.7e23,
                     "voffcv": -0.05, "vfbcv": -0.9},
    "binning": {"lref": 2e-6, "wref": 5e-6, "lvth0": 0.05e6,
                "wvth0": -0.02e6, "lkp": 50.0, "lu0": 1e3, "lvsat": 1e9,
                "lgamma": 0.1e6, "gamma": 0.4, "lphi": 0.1e6,
                "lketa": 0.2e6, "lvoff": -0.05e6, "rdsw": 200.0,
                "lrdsw": 100e6, "nch": 1.7e23, "lnch": 0.5e29, "lint": 5e-8,
                "wint": 1e-7},
    "sce_dibl_clm": {"dvt0": 2.2, "dvt1": 0.53, "dvt2": -0.03, "xj": 1.5e-7,
                     "dsub": 0.56, "etab": -0.07, "eta0": 0.05, "k3": 80.0,
                     "w0": 2.5e-6, "nlx": 1.7e-7, "voff": -0.08,
                     "cit": 1e-4, "nch": 1.7e23, "pclm": 1.3,
                     "pdiblc1": 0.39, "pdiblc2": 0.0086, "pdiblcb": -0.1,
                     "drout": 0.56, "pvag": 0.5, "pscbe1": 4.24e8,
                     "pscbe2": 1e-5, "mobmod": 1.0, "ua": 0.4, "ub": 0.01,
                     "uc": -0.05, "tox": 1.5e-8, "toxm": 1e-8, "delta": 0.02},
    "junctions": {"cj": 5e-4, "cjsw": 5e-10, "cjswg": 3e-10, "ad": 1e-12,
                  "as": 1e-12, "pd": 4e-6, "ps": 4e-6, "js": 1e-4,
                  "jsw": 1e-10, "tt": 1e-9, "isr": 1e-14, "tcj": 1e-3,
                  "tpb": 1e-3, "mjd": 0.4, "pbs": 0.9, "fc": 0.6,
                  "dtemp": 5.0, "m": 2.0, "nf": 2.0, "capmod": 1.0},
    "nqs": {"nqsmod": 1.0, "capmod": 1.0, "elm": 5.0, "Cgs": 1e-14},
    "terminal_rc": {"rd": 50.0, "rs": 30.0, "rg": 200.0, "rb": 500.0,
                    "rsh": 10.0, "nrd": 2.0, "nrs": 1.0, "capmod": 1.0},
}


def cases(families):
    """(family, wave) pairs: every wave, terminal_rc on _RC families."""
    return [(f, w) for f in families for w in WAVES
            if w != "terminal_rc" or f.endswith("_RC")]


ALL_CASES = cases(FAMILIES)


def _inputs(key, wave, seed):
    mdef = MODEL_REGISTRY[key]
    rng = np.random.default_rng(seed)
    ix = {p: i for i, p in enumerate(mdef.param_order)}
    vals = {**mdef.defaults, **BASE, **WAVES[wave]}
    P = np.array([vals[p] for p in mdef.param_order], np.float64)
    P = np.broadcast_to(P, (B, NI, P.size)).copy()
    P[..., ix["Vth0"]] *= np.exp(0.1 * rng.standard_normal((B, NI)))
    P[..., ix["W"]] *= np.exp(0.3 * rng.standard_normal((B, NI)))
    if WAVES[wave].get("nqsmod"):
        P[..., ix["nqsmod"]] = np.arange(NI) % 2       # half on, half off
    if "xpart" in WAVES[wave]:
        P[..., ix["xpart"]] = rng.choice([0.0, 0.4, 0.5, 1.0], (B, NI))
    ext = rng.uniform(-0.5, 3.5, (B, NI, 4))
    if mdef.n_internal:
        v = np.concatenate([ext, ext + rng.uniform(-0.05, 0.05, ext.shape)],
                           axis=-1)
    else:
        v = ext
    st = {}
    for name, _init in mdef.state_vars:
        if name[:2] in ("cg", "ng"):
            st[name] = 10 ** rng.uniform(-7, -3, (B, NI))
        elif name == "ntau":
            st[name] = 10 ** rng.uniform(-12, -9, (B, NI))
        elif name in ("vd", "vg", "vs", "vb") or name[0] == "v":
            st[name] = rng.uniform(-0.5, 3.5, (B, NI))
        else:
            st[name] = rng.standard_normal((B, NI)) * 1e-4
    w = 10 ** rng.uniform(3, 10.5, B)
    return P, v, st, w


@functools.lru_cache(maxsize=None)
def _jax_kernels(key):
    """One jitted function of the family's every hook, vmapped over lanes
    and instances (omega per lane).  (JAX is imported here: the card
    tests use this module's inputs on a machine without it.)"""
    import jax
    import jax.numpy as jnp
    from phy_engine_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
    from phy_engine_tpu.models.base import StampCtx as JStampCtx
    jm = JAX_REGISTRY[key]

    def one(P, v, st, w):
        out = {}
        ctx = JStampCtx(mode="tr", t=jnp.asarray(T), dt=jnp.asarray(DT),
                        env=ENV)
        out["tr"] = jm.stamp(P, v, None, st, ctx)
        out["step"] = jm.step_update(P, v, None, st, jnp.asarray(DT), T)
        out["ac"] = jm.ac_stamp(P, st, w)
        f = w / (2.0 * np.pi)
        out["noise"] = jm.noise(P, v, None, st, ENV, f)
        out["corr"] = jm.noise_corr(P, v, None, st, ENV, f, w)
        return out

    inst = jax.vmap(one, in_axes=(0, 0, 0, None))
    return jax.jit(jax.vmap(inst, in_axes=(0, 0, 0, 0)))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _per_instance(a, b, scale=None):
    """max over instances of max|a - b| / (the instance's largest |b|, or
    ``scale`` per instance)."""
    a = np.asarray(a, np.float64).reshape(B, NI, -1)
    b = np.asarray(b, np.float64).reshape(B, NI, -1)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    if scale is None:
        scale = np.abs(b).max(axis=-1)
    scale = np.maximum(scale, 1e-12 * scale.max(axis=-1, keepdims=True))
    return float((np.abs(a - b).max(axis=-1) / np.maximum(scale, 1e-300))
                 .max())


def _stack(st, prefix, k):
    return np.stack([np.asarray(st[f"{prefix}{i}"]) for i in range(k)], -1)


def _both_state(key, wave):
    return _inputs(key, wave, seed=ALL_CASES.index((key, wave)))[2]


def _both(key, wave):
    import jax.numpy as jnp
    P, v, st, w = _inputs(key, wave, seed=ALL_CASES.index((key, wave)))
    jout = _jax_kernels(key)(jnp.asarray(P), jnp.asarray(v),
                             {k: jnp.asarray(a) for k, a in st.items()},
                             jnp.asarray(w))
    tm = MODEL_REGISTRY[key]
    tst = {k: _t(a) for k, a in st.items()}
    wt = _t(np.repeat(w[:, None], NI, axis=1))
    tout = {mode: tm.stamp(_t(P), _t(v), None, tst,
                           StampCtx(mode=mode, t=T, dt=DT, env=ENV))
            for mode in ("tr", "op")}
    tout["step"] = tm.step_update(_t(P), _t(v), None, tst, DT, T)
    tout["ac"] = tm.ac_stamp(_t(P), tst, wt)
    tout["noise"] = tm.noise(_t(P), _t(v), None, tst, ENV, wt / (2 * np.pi))
    tout["corr"] = tm.noise_corr(_t(P), _t(v), None, tst, ENV,
                                 wt / (2 * np.pi), wt)
    return v, jout, tout


def check_family(key, wave):
    """Every hook of family ``key`` on parameter set ``wave`` against the
    JAX package; raises AssertionError naming the arrays past TOL."""
    v, j, t = _both(key, wave)
    k = len(MODEL_REGISTRY[key].pins) + MODEL_REGISTRY[key].n_internal
    vmax = np.abs(v).max(axis=-1)
    errs = {}
    (ta, tz, tst), (ja, jz, jst) = t["tr"], j["tr"]
    errs["tr A"] = _per_instance(ta, ja)
    jmax = np.abs(np.asarray(ja)).reshape(B, NI, -1).max(axis=-1)
    errs["tr z"] = _per_instance(tz, jz, jmax * vmax)
    assert set(tst) == set(jst)
    errs["tr state"] = max(_per_instance(tst[s], jst[s],
                                         np.abs(np.asarray(jst[s])))
                           for s in jst)
    # OP mode: the TR stamp less the companion (cg + ng, ch + nh) terms
    oa, oz, _ost = t["op"]
    st = _both_state(key, wave)
    G = sum(_stack(st, p, k * k) for p in ("cg", "ng") if f"{p}0" in st)
    h = sum(_stack(st, p, k) for p in ("ch", "nh") if f"{p}0" in st)
    errs["op A"] = _per_instance(oa.numpy() + G, ta.numpy())
    errs["op z"] = _per_instance(oz.numpy() - h, tz.numpy(), jmax * vmax)
    tst, jst = t["step"], j["step"]
    assert set(tst) == set(jst)
    G = _stack(jst, "cg", k * k)
    errs["step G"] = _per_instance(_stack(tst, "cg", k * k), G)
    errs["step h"] = _per_instance(_stack(tst, "ch", k), _stack(jst, "ch", k),
                                   np.abs(G).max(axis=-1) * vmax
                                   + np.abs(_stack(jst, "ch", k)).max(-1))
    if "ntau" in jst:
        errs["step nqs G"] = _per_instance(_stack(tst, "ng", 16),
                                           _stack(jst, "ng", 16))
        errs["step nqs tau"] = _per_instance(tst["ntau"], jst["ntau"])
        ng = np.abs(_stack(jst, "ng", 16)).max(-1)
        errs["step nqs h"] = _per_instance(
            _stack(tst, "nh", 4), _stack(jst, "nh", 4),
            ng * vmax + np.abs(_stack(jst, "nh", 4)).max(-1))
    for i, name in enumerate(("ac re", "ac im", "ac zr", "ac zi")):
        ref = np.asarray(j["ac"][i])
        if np.abs(ref).max() == 0.0:
            assert np.abs(t["ac"][i].numpy()).max() == 0.0
            continue
        errs[name] = _per_instance(t["ac"][i], ref)
    noise = np.asarray(j["noise"])
    assert t["noise"].shape == noise.shape
    errs["noise"] = _per_instance(t["noise"], noise)
    corr = np.asarray(j["corr"])
    assert t["corr"].shape == corr.shape
    on = noise[..., 0] >= 1e-12 * noise[..., 0].max(axis=-1, keepdims=True)
    d = np.abs(t["corr"].numpy() - corr).reshape(B, NI, -1).max(-1)
    scale = np.abs(corr).reshape(B, NI, -1).max(-1)
    errs["corr"] = float((d / np.maximum(scale, 1e-300))[on].max())
    bad = {k_: e for k_, e in errs.items()
           if not e <= (TOL_NOISE if k_ in ("noise", "corr") else TOL)}
    assert not bad, bad
