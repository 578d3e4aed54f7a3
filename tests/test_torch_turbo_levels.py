"""The turbo tick's gate-level schedule (``digital/turbo.py::
level_schedule``) on the CPU.

The schedule's invariants are checked here independently of its builder,
on every design of the parity tests; hand-made chunk tables with
in-chunk reads, later rewrites and a nonzero trash slot go through the
port (level order) and the JAX package's ``run_xla`` (chunk order) and
must agree bit for bit; tables whose result is undefined must raise."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from phy_engine_tpu.digital import turbo as jturbo

from phy_engine_tpu_torch.digital import turbo, turbo_cases

from test_torch_digital import SCHEDULES, _both, slab_to_planes
from test_torch_verilog import DESIGNS, built

C = turbo.CHUNK


def _port_plan(name):
    _jc, (tc, ti, _tp, _tr) = built(name)
    eng = tc.digital_engine()
    _e, fs, _FV, _FU = tc._compile_schedule(SCHEDULES[name](ti))
    return eng.plan(fs)


def _slots(tab, hi, cols):
    return tab[hi, cols] * C + tab[hi + 1, cols]


def _check_pass(tab, n, rec, off, col):
    """Every valid gate once, with the record its table column defines;
    each gate above the last earlier-chunk writer of each slot it reads;
    no level writing a slot that another of its gates reads."""
    valid = np.flatnonzero(tab[turbo._R_VALID, :n * C])
    assert sorted(col.tolist()) == valid.tolist()
    assert len(rec) == len(col) == off[-1]
    assert (np.diff(off) > 0).all()
    for k, hi in enumerate((turbo._R_AHI, turbo._R_BHI, turbo._R_OHI)):
        np.testing.assert_array_equal(rec[:, k], _slots(tab, hi, col))
    level = np.repeat(np.arange(len(off) - 1), np.diff(off))
    at = {int(c): int(lv) for c, lv in zip(col, level)}
    last = {}                     # slot -> column of its latest writer
    for ch in range(n):
        cols = [c for c in range(ch * C, (ch + 1) * C) if c in at]
        for c in cols:
            for s in (_slots(tab, turbo._R_AHI, c), _slots(tab, turbo._R_BHI, c)):
                if int(s) in last:
                    assert at[c] > at[last[int(s)]], (c, int(s))
        for c in cols:
            last[int(_slots(tab, turbo._R_OHI, c))] = c
    for lo, hi in zip(off[:-1], off[1:]):
        r = rec[lo:hi]
        for g in range(len(r)):
            others = np.delete(r[:, 2], g)
            assert r[g, 0] not in others and r[g, 1] not in others
        assert len(np.unique(r[:, 2])) == len(r)


@pytest.mark.parametrize("name", list(DESIGNS))
def test_schedule_invariants(name):
    plan = _port_plan(name)
    sc = plan.schedule
    _check_pass(plan.cone_tab, plan.n_cone, sc.cone_rec, sc.cone_off, sc.cone_col)
    _check_pass(plan.full_tab, plan.n_full, sc.full_rec, sc.full_off, sc.full_col)
    n_cone, n_full = sc.levels
    assert n_cone <= plan.n_cone and n_full <= plan.n_full
    assert len(sc.ff_rec) == int((plan.ff_tab[turbo._F_VALID] != 0).sum())
    assert len(sc.ff_seg) == len(plan.ff_ranges)
    if name == "rv32":
        assert n_cone <= 130 and n_full <= 200, (n_cone, n_full)


def _planes_to_slab(st):
    """(2, K) uint32 [V; U] -> the JAX (Khi, 512) f32 slab."""
    v, u = st[0].reshape(-1, C), st[1].reshape(-1, C)
    return np.concatenate([v & 0xFFFF, v >> 16, u & 0xFFFF, u >> 16],
                          axis=1).astype(np.float32)


def _random_state(plan, seed, upto):
    """Random V/U words (X and Z lanes included) in slots [0, upto)."""
    rng = np.random.default_rng(seed)
    st = np.zeros((2, plan.K), np.uint32)
    st[:, :upto] = rng.integers(0, 2 ** 32, (2, upto), dtype=np.uint64)
    st[1, :upto] &= rng.integers(0, 2 ** 32, upto, dtype=np.uint64) \
        .astype(np.uint32)
    return st


def _against_run_xla(jeng, teng, fs, FV, FU, st, **tables):
    """Port (level order, plain) and JAX run_xla (chunk order) from the
    start planes ``st`` with ``tables`` replacing the plans' own; returns
    the port's plan and its (T, K) uint32 history planes."""
    jplan = jturbo.TurboPlan(jeng.ir, fs)
    jplan.__dict__.update(tables)
    plan = turbo_cases.with_tables(teng.plan(fs), **tables)
    slab = _planes_to_slab(st)
    np.testing.assert_array_equal(slab_to_planes(slab), st)
    jv, ju = jplan.unpack_hist(*jturbo.run_xla(jplan, slab, FV, FU))
    hv, hu = turbo.run_turbo(plan, torch.from_numpy(st.view(np.int32))[None],
                             turbo.as_int32(FV)[None], turbo.as_int32(FU)[None])
    tv, tu = plan.unpack_hist(hv[0], hu[0])
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tu, ju)
    return plan, tv, tu


def test_reads_in_chunk_see_the_old_value():
    """Hand-made full pass on the FSM: a gate reading a slot that an
    earlier gate of its chunk writes gets the old value; later chunks
    rewrite slots read and written before.  Bit-identical to run_xla."""
    jeng, (fs, FV, FU), teng = _both("fsm")
    base = teng.plan(fs)
    x, y, z, w = range(4)
    chunks = [[("NOT", w, w, x), ("YES", x, x, y)],
              [("AND", x, y, z), ("XOR", y, z, w)],
              [("OR", z, w, x), ("NAND", x, y, y)]]
    st = _random_state(base, 11, base.trash)
    plan, _tv, _tu = _against_run_xla(jeng, teng, fs, FV, FU, st,
                                      full_tab=turbo_cases.gate_table(base, chunks),
                                      n_full=len(chunks), n_cone=0)
    sc = plan.schedule
    # the in-chunk reader runs a level before the writer of its slot
    level = np.repeat(np.arange(len(sc.full_off) - 1), np.diff(sc.full_off))
    at = dict(zip(sc.full_col.tolist(), level.tolist()))
    assert at[1] < at[0]
    assert sc.levels[0] == 0 and sc.full_zero


def test_every_gate_op_matches_run_xla():
    """fp16 with its full pass replaced by one chunk per gate op (random
    operands and outputs, so every kind of hazard across and within
    chunks), from random words: bit-identical to run_xla."""
    jeng, (fs, FV, FU), teng = _both("fp16")
    base = teng.plan(fs)
    chunks = turbo_cases.all_ops_chunks(base.S, 14)
    st = _random_state(base, 14, base.trash)
    plan, _tv, tu = _against_run_xla(
        jeng, teng, fs, FV, FU, st, n_cone=0, n_full=len(chunks),
        full_tab=turbo_cases.gate_table(base, chunks))
    assert sum(plan.schedule.levels) > 1 and (tu != 0).any()


@pytest.mark.parametrize("name,counts,zeroes", [
    ("fp16", {"n_full": 0}, "cone"),
    ("fp16", {"n_cone": 0}, "full"),
    ("snake", {"n_cone": 0, "n_full": 0}, "ff"),
], ids=["cone", "full", "ff"])
def test_trash_slot_is_zeroed_as_the_reference_does(name, counts, zeroes):
    """128 forced signals, so that the forced scatter has no padding, and
    only one pass whose padding zeroes the trash slot (the cone, the full
    pass or the flip-flop segments), from random words in every slot, the
    trash slot and the unused slots above it included: the trash slot
    reads 0, the slots above keep their words; bit-identical to
    run_xla."""
    jeng, _sched, teng = _both(name)
    rng = np.random.default_rng(13)
    fs = np.sort(rng.choice(teng.ir.n_signals, C, replace=False)).astype(np.int32)
    FV, FU = turbo_cases._words(rng, (5, C), True)
    base = turbo_cases.with_tables(teng.plan(fs), **counts)
    assert base.nf == base.nf_pad
    sc = base.schedule
    assert [sc.cone_zero, sc.full_zero, bool(sc.ff_seg[:, 2].any())] == \
        [zeroes == "cone", zeroes == "full", zeroes == "ff"]
    st = _random_state(base, 12, base.K)
    assert st[0, base.trash] != 0 and base.K > base.trash + 1
    _plan, tv, tu = _against_run_xla(jeng, teng, fs, FV, FU, st, **counts)
    assert (tv[:, base.trash] == 0).all() and (tu[:, base.trash] == 0).all()
    np.testing.assert_array_equal(tv[-1, base.trash + 1:],
                                  st[0, base.trash + 1:])


def _swap(plan):
    """Two gates of one chunk reading each other's output slots."""
    return turbo_cases.with_tables(plan, full_tab=turbo_cases.gate_table(
        plan, [[("YES", 0, 0, 1), ("YES", 1, 1, 0)]]), n_full=1)


def _trash_read(plan):
    return turbo_cases.with_tables(plan, full_tab=turbo_cases.gate_table(
        plan, [[("AND", plan.trash, 0, 1)]]), n_full=1)


@pytest.mark.parametrize("make,match", [
    (turbo_cases.double_write, "two gates of chunk 0 write"),
    (_swap, "read each other's output"),
    (_trash_read, "slot outside"),
], ids=["double_write", "swap", "trash_read"])
def test_undefined_tables_raise(make, match):
    plan = make(_port_plan("fp16"))
    with pytest.raises(ValueError, match=match):
        plan.schedule
    st0 = torch.zeros((1, 2, plan.K), dtype=torch.int32)
    fv = torch.zeros((1, 2, plan.nf), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        turbo.run_turbo(plan, st0, fv, fv)


@pytest.mark.parametrize("nt", [32, 256])
def test_level_rows_hold_each_level_in_its_rows(nt):
    """The kernel's row layout: level l's records in order across its
    ceil(w / nt) rows, the rest of those rows padding, the barrier flag
    on every record of a level's last row only."""
    plan = _port_plan("fp16")
    sc = plan.schedule
    rows = turbo.level_rows(sc.full_rec, sc.full_off, nt).reshape(-1, nt, 4)
    sync = rows[:, :, 3] & turbo._OP_SYNC
    assert ((sync == 0) | (sync == turbo._OP_SYNC)).all()
    assert (sync.min(axis=1) == sync.max(axis=1)).all()      # whole rows
    r = 0
    for lo, hi in zip(sc.full_off[:-1], sc.full_off[1:]):
        n = -(-(hi - lo) // nt)
        flat = rows[r:r + n].reshape(-1, 4)
        np.testing.assert_array_equal(flat[:hi - lo, :3], sc.full_rec[lo:hi, :3])
        np.testing.assert_array_equal(flat[:hi - lo, 3] & ~turbo._OP_SYNC,
                                      sc.full_rec[lo:hi, 3])
        assert (flat[hi - lo:, 3] & ~turbo._OP_SYNC == turbo._OP_PAD).all()
        assert (sync[r:r + n - 1] == 0).all() and (sync[r + n - 1] != 0).all()
        r += n
    assert r == len(rows)


def test_rows_are_as_wide_as_the_kernels_block():
    """The wrapper lays out each pass's rows ``turbo.THREADS`` records
    wide; the kernel reads them one record a thread of its fixed block."""
    src = (Path(turbo.__file__).parents[1] / "ops" / "csrc" /
           "turbo.cu").read_text()
    width = re.search(r"constexpr int THREADS = (\d+);", src)
    assert width is not None and int(width.group(1)) == turbo.THREADS
