"""Port parity: the batched torch stamps, AC stamps, step updates and
convergence vetos of every analog family but BSIM3 (linear, waveform
sources, switch and relay, PN, BJT, MOSFET, full-bridge rectifier)
against the JAX package's per-instance kernels (vmapped over lanes and
instances), and their metadata; that every analog family, BSIM3's
included, is ported (BSIM3's kernels are held in test_torch_bsim3*.py).

Tolerance: 1e-12 relative per element (float64; the two libraries'
exp/log/sin may differ in the last ulps), against the larger magnitude
of the two results with a 1e-300 floor; non-finite entries (2C/dt at
dt = 0) must match exactly.  check_conv flags bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phy_engine_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from phy_engine_tpu.models.base import StampCtx as JStampCtx

from phy_engine_tpu_torch.models import MODEL_REGISTRY, StampCtx

# tiny tensors: torch's intra-op threads would only contend with the
# other test worker processes
torch.set_num_threads(1)

B, NI = 3, 40
ENV = {"g_min": 0.0, "r_open": 1e12}
ANALOG = sorted(k for k, m in MODEL_REGISTRY.items()
                if m.stamp is not None and not k.startswith("BSIM3"))
STEPPED = [k for k in ANALOG if MODEL_REGISTRY[k].step_update is not None]
VETOED = [k for k in ANALOG if MODEL_REGISTRY[k].check_conv is not None]


def _close(a, b, rtol=1e-12):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    assert np.array_equal(a[~fin], b[~fin], equal_nan=True)
    a, b = a[fin], b[fin]
    scale = np.maximum(np.abs(a), np.abs(b))
    bad = np.abs(a - b) > rtol * scale + 1e-300
    assert not bad.any(), (np.abs(a - b)[bad].max(), a[bad][:4], b[bad][:4])


def _params(key, rng):
    mdef = MODEL_REGISTRY[key]
    P = np.array([mdef.defaults[k] for k in mdef.param_order], np.float64)
    P = np.broadcast_to(P, (B, NI, P.size)).copy()
    if key == "R":
        P[..., 0] *= np.exp(0.5 * rng.standard_normal((B, NI)))
    elif key == "C":
        P[..., 0] = 10 ** rng.uniform(-12, -6, (B, NI))
    elif key == "VAC":
        P[..., 0] = rng.uniform(0.5, 3.0, (B, NI))
        P[..., 1] = 10 ** rng.uniform(2, 6, (B, NI))
        P[..., 2] = rng.uniform(-90, 90, (B, NI))
    elif key == "PN":
        P[..., 0] = 10 ** rng.uniform(-16, -12, (B, NI))     # Is
        P[..., 1] = rng.uniform(1.0, 2.0, (B, NI))           # N
        P[..., 2] = np.where(rng.random((B, NI)) < 0.5, 0.0, 1e-12)  # Isr
        P[..., 4] = rng.uniform(-20, 100, (B, NI))           # Temp
        P[..., 6] = rng.uniform(20, 60, (B, NI))             # Bv
        P[..., 7] = np.where(rng.random((B, NI)) < 0.8, 1.0, 0.0)  # Bv_set
        P[..., 9] = np.where(rng.random((B, NI)) < 0.5, 0.0, 1e-9)  # tt
    elif key == "FBR":
        P[..., 0] = 10 ** rng.uniform(-16, -12, (B, NI))
        P[..., 4] = rng.uniform(-20, 100, (B, NI))
        P[..., 9] = np.where(rng.random((B, NI)) < 0.5, 0.0, 1e-9)
    elif key in ("QNP", "QPN"):
        P[..., 0] = 10 ** rng.uniform(-17, -14, (B, NI))     # Is
        P[..., 1] = rng.uniform(1.0, 2.0, (B, NI))           # N
        P[..., 2] = rng.uniform(20.0, 300.0, (B, NI))        # BetaF
        P[..., 3] = rng.uniform(-20, 100, (B, NI))           # Temp
        P[..., 4] = rng.uniform(0.5, 2.0, (B, NI))           # Area
    elif key in ("NMOS", "PMOS"):
        P[..., 0] = 10 ** rng.uniform(-5, -2, (B, NI))       # Kp
        P[..., 1] = rng.uniform(0.0, 0.1, (B, NI))           # lambda
        P[..., 2] = rng.uniform(0.3, 2.0, (B, NI))           # Vth
    elif key in ("SAW", "SQW", "PULSE", "TRI"):
        names = MODEL_REGISTRY[key].param_order
        col = {n: i for i, n in enumerate(names)}
        P[..., col["Vh"]] = rng.uniform(1.0, 5.0, (B, NI))
        P[..., col["Vl"]] = rng.uniform(-2.0, 0.5, (B, NI))
        P[..., col["freq"]] = 10 ** rng.uniform(2, 5, (B, NI))
        P[..., col["phase"]] = rng.uniform(-3.0, 3.0, (B, NI))
        if "duty" in col:
            P[..., col["duty"]] = rng.uniform(0.1, 0.9, (B, NI))
        if "tr" in col:
            period = 1.0 / P[..., col["freq"]]
            for e in ("tr", "tf"):
                P[..., col[e]] = np.where(rng.random((B, NI)) < 0.2, 0.0,
                                          rng.uniform(0, 0.2, (B, NI))
                                          * period)
    elif key == "switch":
        P[..., 0] = (rng.random((B, NI)) < 0.5).astype(np.float64)
    elif key == "RELAY":
        P[..., 0] = rng.uniform(3.0, 6.0, (B, NI))
        P[..., 1] = rng.uniform(1.0, 3.0, (B, NI))
    elif key == "KL":
        P[..., :2] = 10 ** rng.uniform(-6, -2, (B, NI, 2))
        P[..., 2] = rng.uniform(0.1, 0.999, (B, NI))
    elif key in ("VDC", "IDC", "VCVS", "VCCS", "CCVS", "CCCS", "OPAMP"):
        P[..., 0] *= rng.uniform(-2.0, 2.0, (B, NI))
    elif key == "IAC":
        P[..., 0] = rng.uniform(-1.0, 1.0, (B, NI))
        P[..., 1] = 10 ** rng.uniform(2, 6, (B, NI))
        P[..., 2] = rng.uniform(-90, 90, (B, NI))
    else:                       # L, TX, TXCT: positive scale jitter
        P *= np.exp(0.5 * rng.standard_normal(P.shape))
    return P


def _voltages(key, rng):
    """Pin voltages: for PN one third forward (where vlimit clamps),
    one third reverse, one third in breakdown."""
    npins = len(MODEL_REGISTRY[key].pins)
    v = rng.uniform(-2.0, 2.0, (B, NI, npins))
    if key == "PN":
        band = np.arange(NI) % 3
        ud = np.where(band == 0, rng.uniform(0.6, 5.0, (B, NI)),
                      np.where(band == 1, rng.uniform(-15.0, -0.1, (B, NI)),
                               rng.uniform(-90.0, -40.0, (B, NI))))
        v[..., 1] = rng.uniform(-0.5, 0.5, (B, NI))
        v[..., 0] = v[..., 1] + ud
    elif key in ("QNP", "QPN"):
        # junction voltage (B-E, or E-B for PNP) forward, near the knee,
        # and reverse
        band = np.arange(NI) % 3
        vj = np.where(band == 0, rng.uniform(0.5, 3.0, (B, NI)),
                      np.where(band == 1, rng.uniform(0.2, 0.8, (B, NI)),
                               rng.uniform(-5.0, 0.0, (B, NI))))
        v[..., 2] = rng.uniform(-0.5, 0.5, (B, NI))
        v[..., 0] = v[..., 2] + (vj if key == "QNP" else -vj)
    elif key in ("NMOS", "PMOS", "RELAY", "FBR"):
        v = rng.uniform(-6.0, 6.0, (B, NI, npins))
    return v


def _state(key, rng):
    st = {}
    for name, _init in MODEL_REGISTRY[key].state_vars:
        base = name.rstrip("0123456789") if key == "FBR" else name
        if base in ("ud_last", "vj_last"):
            st[name] = rng.uniform(-1.0, 0.8, (B, NI))
        elif base in ("prev_g", "geq", "tr_prev_g", "gm", "gds", "req",
                      "req11", "req12", "req22"):
            st[name] = 10 ** rng.uniform(-6, 1, (B, NI))
        elif base == "engaged":
            st[name] = (rng.random((B, NI)) < 0.5).astype(np.float64)
        elif base == "r_contact":
            st[name] = np.where(rng.random((B, NI)) < 0.5, 0.0, 1e12)
        else:
            st[name] = rng.standard_normal((B, NI)) * 1e-3
    return st


def _inputs(key, seed):
    rng = np.random.default_rng(seed)
    return (_params(key, rng), _voltages(key, rng),
            rng.standard_normal((B, NI, max(1, MODEL_REGISTRY[key].nbranches)))
            * 1e-3, _state(key, rng))


def _vmap2(fn):
    return jax.vmap(jax.vmap(fn))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _tstate(st):
    return {k: _t(v) for k, v in st.items()}


def _jstate(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


@pytest.mark.parametrize("mode", ["tr", "op"])
@pytest.mark.parametrize("key", ANALOG)
def test_stamp_matches_jax(key, mode):
    P, v, ib, st = _inputs(key, seed=ANALOG.index(key) + 100 * (mode == "tr"))
    t, dt = 3.7e-7, 5e-8
    jm, tm = JAX_REGISTRY[key], MODEL_REGISTRY[key]
    jctx = JStampCtx(mode=mode, t=jnp.asarray(t), dt=jnp.asarray(dt), env=ENV)
    ja, jz, jst = _vmap2(lambda P_, v_, b_, s_: jm.stamp(P_, v_, b_, s_, jctx))(
        jnp.asarray(P), jnp.asarray(v), jnp.asarray(ib), _jstate(st))
    ta, tz, tst = tm.stamp(_t(P), _t(v), _t(ib), _tstate(st),
                           StampCtx(mode=mode, t=t, dt=dt, env=ENV))
    _close(ta, ja)
    _close(tz, jz)
    assert set(tst) == set(jst)
    for k in jst:
        _close(tst[k], jst[k])


@pytest.mark.parametrize("dt", [5e-8, 0.0])
@pytest.mark.parametrize("key", STEPPED)
def test_step_update_matches_jax(key, dt):
    P, v, ib, st = _inputs(key, seed=7 + int(dt > 0))
    t = 1e-6
    jm, tm = JAX_REGISTRY[key], MODEL_REGISTRY[key]
    jst = _vmap2(lambda P_, v_, b_, s_: jm.step_update(P_, v_, b_, s_,
                                                       jnp.asarray(dt), t))(
        jnp.asarray(P), jnp.asarray(v), jnp.asarray(ib), _jstate(st))
    tst = tm.step_update(_t(P), _t(v), _t(ib), _tstate(st), dt, t)
    assert set(tst) == set(jst)
    for k in jst:
        _close(tst[k], jst[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pn_check_conv_bit_exact(seed):
    P, v, _ib, st = _inputs("PN", seed=100 + seed)
    rng = np.random.default_rng(seed)
    # put a third of the lanes right at the veto threshold's edge
    ud_raw = v[..., 0] - v[..., 1]
    near = rng.random((B, NI)) < 0.33
    st["ud_last"] = np.where(near, ud_raw + rng.uniform(-0.06, 0.06, (B, NI)),
                             st["ud_last"])
    jflags = _vmap2(JAX_REGISTRY["PN"].check_conv)(
        jnp.asarray(P), jnp.asarray(v), _jstate(st))
    tflags = MODEL_REGISTRY["PN"].check_conv(_t(P), _t(v), _tstate(st))
    jf = np.asarray(jflags)
    assert np.array_equal(tflags.numpy(), jf)
    assert jf.any() and not jf.all()


@pytest.mark.parametrize("key", ANALOG)
def test_ac_stamp_matches_jax(key):
    """The small-signal stamp at a per-lane omega, from the saved
    operating-point states."""
    P, _v, _ib, st = _inputs(key, seed=300 + ANALOG.index(key))
    w = 10 ** np.random.default_rng(ANALOG.index(key)).uniform(0, 9, B)
    ac = JAX_REGISTRY[key].ac_stamp
    jout = jax.vmap(lambda P_, s_, w_: jax.vmap(
        lambda p, s: ac(p, s, w_))(P_, s_))(jnp.asarray(P), _jstate(st),
                                           jnp.asarray(w))
    tout = MODEL_REGISTRY[key].ac_stamp(
        _t(P), _tstate(st), _t(np.repeat(w[:, None], NI, axis=1)))
    assert len(tout) == 4
    for a, b in zip(tout, jout):
        _close(a, b)


@pytest.mark.parametrize("key", VETOED)
def test_check_conv_matches_jax(key):
    """Every family's convergence veto, a third of the lanes at the edge
    of its threshold."""
    P, v, _ib, st = _inputs(key, seed=400 + VETOED.index(key))
    rng = np.random.default_rng(VETOED.index(key))
    near = rng.random((B, NI)) < 0.33
    if key in ("QNP", "QPN"):
        sign = 1.0 if key == "QNP" else -1.0
        raw = (v[..., 0] - v[..., 2]) * sign
        st["vj_last"] = np.where(near, raw + rng.uniform(-0.1, 0.1, (B, NI)),
                                 st["vj_last"])
    elif key == "FBR":
        raw = v[..., 0] - v[..., 2]
        st["ud_last0"] = np.where(near, raw + rng.uniform(-0.1, 0.1, (B, NI)),
                                  st["ud_last0"])
    jflags = _vmap2(JAX_REGISTRY[key].check_conv)(
        jnp.asarray(P), jnp.asarray(v), _jstate(st))
    tflags = MODEL_REGISTRY[key].check_conv(_t(P), _t(v), _tstate(st))
    assert np.array_equal(tflags.numpy(), np.asarray(jflags))


def test_every_non_bsim3_analog_family_is_ported():
    """Every analog family of the JAX package, BSIM3's four included, is
    registered in the port with an AC stamp."""
    ported = {k for k, m in MODEL_REGISTRY.items() if m.stamp is not None}
    jax_analog = {k for k, m in JAX_REGISTRY.items() if m.stamp is not None}
    assert ported == jax_analog
    assert {"BSIM3_NMOS", "BSIM3_PMOS", "BSIM3_NMOS_RC",
            "BSIM3_PMOS_RC"} <= ported
    assert all(MODEL_REGISTRY[k].ac_stamp is not None for k in ported)
