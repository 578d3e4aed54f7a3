"""Port parity: ``dc_sweep``, ``temp_sweep``, ``monte_carlo`` and the
batched per-lane Newton behind them (``parallel/batch.py::batched_op`` /
``batched_transient``) against the JAX package's, on every circuit of
``tests/test_sweep.py`` and a batch with failing lanes.

Monte-Carlo randomness: the port draws from a ``torch.Generator``, the
JAX package from its PRNG, so the JAX run's sampled ``SweepResult.params``
are handed across (``params_from_numpy``) into the port's batched path;
the port's own ``monte_carlo`` is held to the closed form of its own
samples.

Tolerance met: traces, solutions and states within 1e-9 relative to
max|x| of the JAX result (states: of the larger of max|x| and the
variable's own largest magnitude), ``ok`` flags exactly.
"""

import numpy as np
import torch

from phy_engine_tpu.parallel import batch as jbatch
from phy_engine_tpu_torch.parallel import batch as tbatch

from torch_circuit_cases import TOL, assert_close, both
from torch_circuits import diode_load, divider

torch.set_num_threads(1)


def _sweep_both(spec, fn):
    j, t = both(spec)
    return j, t, fn(j), fn(t)


def _same_sweep(jr, tr, out=None):
    np.testing.assert_array_equal(tr.ok, jr.ok)
    np.testing.assert_array_equal(tr.values, jr.values)
    assert_close(tr.x, np.asarray(jr.x))
    if out is not None:
        assert_close(tr.out, np.asarray(jr.out), scale=np.abs(jr.x).max())
    for k in jr.params:
        np.testing.assert_array_equal(tr.params[k], np.asarray(jr.params[k]))


def test_dc_sweep_divider():
    vals = np.linspace(-2.0, 5.0, 15)
    j, t, jr, tr = _sweep_both(
        divider(1.0, 2e3, 3e3),
        lambda b: b.c.dc_sweep(b.devs["v"], "V", vals, out=b.nodes["mid"]))
    _same_sweep(jr, tr, out=True)
    assert tr.ok.all()
    assert np.allclose(tr.out, vals * 3e3 / 5e3, rtol=1e-12, atol=1e-12)
    assert_close(tr.trace(t.devs["v"]), np.asarray(jr.trace(j.devs["v"])))
    for b in (j, t):                  # the stored solution is untouched
        b.c.set_analyze_type(b.mod.AnalyzeType.OP)
        assert b.c.analyze()


def test_dc_sweep_diode():
    vals = np.array([0.2, 1.0, 3.0])
    _j, _t, jr, tr = _sweep_both(
        diode_load(0.0),
        lambda b: b.c.dc_sweep(b.devs["v"], "V", vals, out=b.nodes["d"]))
    _same_sweep(jr, tr, out=True)
    assert tr.ok.all()


def test_temp_sweep_diode():
    temps = np.array([-40.0, 0.0, 27.0, 85.0, 125.0])
    _j, _t, jr, tr = _sweep_both(
        diode_load(3.0, 10e3),
        lambda b: b.c.temp_sweep(temps, out=b.nodes["d"]))
    _same_sweep(jr, tr, out=True)
    dv = np.diff(tr.out) / np.diff(temps)
    assert np.all(dv > 0.5e-3) and np.all(dv < 4e-3)


def _lanes_through_port(j, t, jr, analysis="op", **tr_kw):
    """The JAX run's sampled params through the port's batched path."""
    ir = t.c.prepare()
    n = len(jr.values)
    pb = tbatch.params_from_numpy(ir, jr.params, "cpu")
    x0 = tbatch.batch_x(ir, n, "cpu")
    st0 = tbatch.batch_state(ir, n, "cpu")
    env = t.c._env_scalars()
    if analysis == "op":
        x, _st, ok = tbatch.batched_op(ir, pb, x0, st0, env)
        return x.numpy(), ok.numpy(), None
    x, _st, ok, xs = tbatch.batched_transient(ir, pb, x0, st0, env, 0.0,
                                              keep_trace=True, **tr_kw)
    return x.numpy(), ok.numpy(), xs.numpy()


def test_monte_carlo_op_matches_jax_on_its_samples():
    j, t = both(divider(2.0, 2e3, 3e3))
    jr = j.c.monte_carlo({"R": {"r": 0.2}}, n=64)
    x, ok, _ = _lanes_through_port(j, t, jr)
    np.testing.assert_array_equal(ok, np.asarray(jr.ok))
    assert_close(x, np.asarray(jr.x))
    r1 = jr.param_of(j.devs["r1"], "r")
    r2 = jr.param_of(j.devs["r2"], "r")
    mid = t.c._ir.index_of(t.nodes["mid"])
    assert np.allclose(x[:, mid], 2.0 * r2 / (r1 + r2), rtol=1e-12)


def _rc():
    return [("v", "VDC", {"V": 1.0}, ("top", "0")),
            ("r", "RESISTANCE", {"r": 1e3}, ("top", "out")),
            ("cl", "CAPACITOR", {"C": 1e-6}, ("out", "0"))]


def test_monte_carlo_tr_matches_jax_on_its_samples():
    tau = 1e-3
    j, t = both(_rc())
    jr = j.c.monte_carlo({"C": {"C": 0.1}}, n=4, analysis="tr",
                         t_stop=tau, t_step=tau / 200)
    x, ok, xs = _lanes_through_port(j, t, jr, "tr", dt=tau / 200,
                                    num_steps=200)
    np.testing.assert_array_equal(ok, np.asarray(jr.ok))
    assert_close(xs, np.asarray(jr.history))
    assert_close(x, np.asarray(jr.x))


def test_port_monte_carlo_follows_its_own_samples():
    """The port's monte_carlo: every lane's Vout is the closed form of
    its own sampled resistances; its TR lanes match single runs of the
    same engine at each lane's sampled C."""
    _j, t = both(divider(2.0, 2e3, 3e3))
    res = t.c.monte_carlo({"R": {"r": 0.2}}, n=64,
                          generator=torch.Generator().manual_seed(5))
    assert res.ok.all()
    r1 = res.param_of(t.devs["r1"], "r")
    r2 = res.param_of(t.devs["r2"], "r")
    assert np.std(r1) > 0.0
    assert np.allclose(res.trace(t.nodes["mid"]), 2.0 * r2 / (r1 + r2),
                       rtol=1e-12)
    tau = 1e-3
    _j, t = both(_rc())
    res = t.c.monte_carlo({"C": {"C": 0.1}}, n=3, analysis="tr",
                          t_stop=tau, t_step=tau / 100)
    assert res.ok.all() and res.history.shape == (3, 100, 3)
    for lane, c in enumerate(res.param_of(t.devs["cl"], "C")):
        _j, t2 = both([d if d[0] != "cl" else ("cl", "CAPACITOR", {"C": c},
                                               d[3]) for d in _rc()])
        t2.c.set_analyze_type(t2.mod.AnalyzeType.TR)
        t2.c.tr.t_stop, t2.c.tr.t_step = tau, tau / 100
        assert t2.c.analyze()
        assert_close(res.waveform(t.nodes["out"])[lane],
                     t2.c.tr_waveform(t2.nodes["out"]), 1e-12)


def _string(n=20):
    """VDC -> a series string of n diodes to ground (test_homotopy)."""
    spec = [("v", "VDC", {"V": 1.0}, ("n0", "0"))]
    for k in range(n):
        spec.append((f"d{k}", "PN_JUNCTION", {"Is": 1e-14 * 10 ** (k % 3)},
                     (f"n{k}", "0" if k == n - 1 else f"n{k + 1}")))
    return spec


def test_failing_lanes_take_their_states_as_under_vmap():
    """A batch with a lane whose stamp is non-finite (R = 0: the solve
    fails on its first iteration) and a lane that exhausts the 64
    iterations (100 V on the diode string) beside converging lanes: x,
    every state and the ok flags match the JAX package's vmap of its
    single-circuit Newton.  A failed lane keeps its last finite x but
    takes the failing iteration's states (the JAX loop carries them);
    the explicit-batch loop would keep the old ones."""
    spec = _string(6) + [("r", "RESISTANCE", {"r": 1e3}, ("n3", "0"))]
    j, t = both(spec)
    ir_j, ir_t = j.c.prepare(), t.c.prepare()
    volts = np.array([1.0, 3.0, 100.0, 2.0, 4.0])
    rs = np.array([1e3, 0.0, 1e3, 1e3, 5e2])
    pj = {k: np.array(np.broadcast_to(v, (5,) + v.shape))
          for k, v in ((f.mdef.id_name, f.P) for f in ir_j.families)}
    pj["VDC"][:, 0, 0] = volts
    pj["R"][:, 0, 0] = rs
    xj, stj, okj = jbatch.batched_op(
        ir_j, {k: np.asarray(v) for k, v in pj.items()},
        jbatch.batch_x(ir_j, 5), jbatch.batch_state(ir_j, 5),
        j.c._env_scalars())
    pt = tbatch.params_from_numpy(ir_t, pj, "cpu")
    xt, stt, okt = tbatch.batched_op(ir_t, pt, tbatch.batch_x(ir_t, 5, "cpu"),
                                     tbatch.batch_state(ir_t, 5, "cpu"),
                                     t.c._env_scalars())
    okj = np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert list(okj) == [True, False, False, True, True]
    xj = np.asarray(xj)
    assert not xj[1].any()                       # the R = 0 lane kept x0
    for lane in range(5):                        # each to its own max|x|
        scale = max(float(np.abs(xj[lane]).max()), 1.0)
        assert_close(xt[lane].numpy(), xj[lane], scale=scale)
        for k in stj:
            for v in stj[k]:
                a = stt[k][v][lane].numpy()
                b = np.asarray(stj[k][v])[lane]
                assert_close(a, b, TOL, max(scale, float(np.abs(b).max())))
    # the R = 0 lane's states moved off their initial values
    assert np.abs(stt["PN"]["geq"][1].numpy()).min() > 0.0
