"""Port parity: the flash batched engine of phy_engine_tpu_torch
(``digital/flash.py``, torch ops on the CPU) against the JAX package's.

:class:`FlashPlan` must be identical array for array; ``run_batched``
bit-identical on acyclic designs.  On the cyclic class (gate-level latch
feedback) the port's flash engine is held to the port's own levelled
tick: the JAX package's flash test on that class fails on its own
reference (ROADMAP.md queue 3)."""

import numpy as np
import pytest
import torch

import phy_engine_tpu as jpe
import phy_engine_tpu_torch as tpe
from phy_engine_tpu.digital import flash as jflash
from phy_engine_tpu_torch.digital import engine as tengine
from phy_engine_tpu_torch.digital import flash, turbo

import torch_digital_cases as dc
from test_torch_digital import SCHEDULES, fp16_schedule
from test_torch_verilog import built

torch.set_num_threads(1)


def _port_latch():
    rec = dc.Rec(lambda: tpe.Circuit(device="cpu"))
    return dc._synth(tpe, rec, dc.LATCH_SRC, "lat", ("en", "d", "s"))


def _jax_latch():
    rec = dc.Rec(jpe.Circuit)
    return dc._synth(jpe, rec, dc.LATCH_SRC, "lat", ("en", "d", "s"))


def _plans(name):
    """(JAX plan, port plan, JAX engine, port engine, compiled schedule)."""
    if name == "latch":
        (jc, ji, _jp), (tc, ti, _tp) = _jax_latch(), _port_latch()
        sched = [{ti["en"][0]: e, ti["d"][0]: 1} for e in (1, 0)]
        jsched = [{ji["en"][0]: e, ji["d"][0]: 1} for e in (1, 0)]
    else:
        (jc, ji, _jp, _jr), (tc, ti, _tp, _tr) = built(name)
        jsched, sched = SCHEDULES[name](ji), SCHEDULES[name](ti)
    jc.prepare()
    _e, fs, FV, FU = jc._compile_schedule(jsched)
    teng, tfs, _TFV, _TFU = tc._compile_schedule(sched)
    np.testing.assert_array_equal(tfs, fs)
    return (jflash.FlashPlan(jc._digital.ir, fs), flash.FlashPlan(teng.ir, fs),
            jc._digital, teng, (fs, FV, FU))


def _same_pass(t, j):
    ta, tb, truns, to0, tg = t
    ja, jb, jruns, jo0, jg = j
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_array_equal(tb, np.asarray(jb))
    assert ta.dtype == np.asarray(ja).dtype
    assert (truns, to0, tg) == (jruns, jo0, jg)


@pytest.mark.parametrize("name", ["snake", "fp16", "fsm", "latch"])
def test_plan_matches_jax(name):
    j, t, _je, _te, _sched = _plans(name)
    for a in ("S", "nf", "K", "cyc0", "n_cyc", "fix_budget"):
        assert getattr(t, a) == getattr(j, a), a
    np.testing.assert_array_equal(t.NEW, j.NEW)
    np.testing.assert_array_equal(t.forced_sig, j.forced_sig)
    for a in ("cone_passes", "full_passes", "cyclic_passes"):
        tp, jp = getattr(t, a), getattr(j, a)
        assert len(tp) == len(jp), a
        for x, y in zip(tp, jp):
            _same_pass(x, y)
    assert len(t.ff_segs) == len(j.ff_segs)
    for x, y in zip(t.ff_segs, j.ff_segs):
        for a, b in zip(x[:3], y[:3]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, np.asarray(b))
        assert x[3:] == y[3:]
    for x, y in zip(t.ff_meta, j.ff_meta):
        assert x[0] == y[0] and x[2:] == y[2:]
        np.testing.assert_array_equal(x[1], y[1])
    if name == "latch":
        assert t.cyclic_passes and t.fix_budget > 0


@pytest.mark.parametrize("name", ["fsm", "fp16"])
def test_run_batched_matches_jax(name):
    """Acyclic designs, B = 3 instances with their own schedules from the
    engine's state, a watch list: bit-identical to the JAX flash run."""
    j, t, je, te, (fs, FV, FU) = _plans(name)
    if name == "fp16":
        (jc, ji, _jp, _jr), _t = built("fp16")
        comp = [jc._compile_schedule(fp16_schedule(ji, ticks=5, seed=s))
                for s in (7, 8, 9)]
        FV = np.stack([c[2] for c in comp])
        FU = np.stack([c[3] for c in comp])
    else:
        rng = np.random.default_rng(4)
        FV = np.stack([FV, FV ^ rng.integers(0, 2 ** 32, FV.shape,
                                             dtype=np.uint32), FV])
        FU = np.stack([FU, FU, FU & rng.integers(0, 2 ** 32, FU.shape,
                                                 dtype=np.uint32)])
    watch = [int(s) for s in np.random.default_rng(1).choice(
        je.ir.n_signals, min(40, je.ir.n_signals), replace=False)]
    jv, ju = jflash.run_batched(j, je.sv, je.su, je.seq_state, FV, FU, watch)
    tv, tu = flash.run_batched(t, te.sv, te.su, te.seq_state, FV, FU, watch,
                               device="cpu")
    assert tv.shape == jv.shape == FV.shape[:2] + (len(watch),)
    assert tv.dtype == np.uint32
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tu, ju)


def test_cyclic_class_matches_levels_tick():
    """The incomplete-``always @*`` latch, B = 4 instances of random
    per-lane stimulus: flash (the route run_ticks_batched takes with a
    watch list) against the port's batched levelled tick."""
    c, ins, pn = _port_latch()
    rng = np.random.default_rng(11)
    names = {"en": ins["en"][0], "d": ins["d"][0], "s": ins["s"][0]}
    comp = [c._compile_schedule(
        [{names[n]: v for n, v in e.items()}
         for e in dc.random_codes(np.random.default_rng(s), list(names), 9,
                                  lanes=True)]) for s in rng.integers(0, 99, 4)]
    eng, fs = comp[0][0], comp[0][1]
    FV = np.stack([x[2] for x in comp])
    FU = np.stack([x[3] for x in comp])
    assert eng.ir.cyclic and not turbo.eligible(eng.ir)
    assert turbo.eligible(eng.ir, allow_cyclic=True)
    watch = [eng.ir.node_sig[id(n)] for n in pn["q"] + pn["y"]]
    fv, fu = eng.run_ticks_batched(fs, FV, FU, watch=watch)      # flash
    hv, hu, _last = eng.run_levels(fs, FV, FU, None, watch)
    np.testing.assert_array_equal(fv, tengine._u32(hv))
    np.testing.assert_array_equal(fu, tengine._u32(hu))
    assert (fu != 0xFFFFFFFF).any() and (fv != 0).any()


def test_run_batched_checks_forced_width():
    _j, t, _je, te, (fs, FV, FU) = _plans("fsm")
    with pytest.raises(ValueError, match="forced columns"):
        flash.run_batched(t, te.sv, te.su, te.seq_state, FV[None, :, :-1],
                          FU[None, :, :-1], [0], device="cpu")
