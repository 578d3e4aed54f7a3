"""Inputs on which the turbo kernel is held against its plain version
(the card tests and ``chip_smoke.py`` share them).

Each case returns ``(plan, state0, FV, FU)``: a ``TurboPlan``, the
(B, 2, K) int32 start planes and the (B, T, nf) int32 forced planes, on
``device``.  Kernel and plain version must agree bit for bit on every
slot, tick, lane and plane: the engine is exact integer logic.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .. import workloads
from . import turbo
from .turbo import as_int32


def _words(rng, shape, xz: bool):
    """Random 32-lane words; with ``xz`` about a quarter of the lanes are
    X (v=0, u=1) or Z (v=1, u=1)."""
    v = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    if not xz:
        return v, np.zeros_like(v)
    u = (rng.integers(0, 2 ** 32, shape, dtype=np.uint64)
         & rng.integers(0, 2 ** 32, shape, dtype=np.uint64)).astype(np.uint32)
    return v, u


def fp16_case(B: int, T: int, seed: int, device):
    """The fp16 adder at -O1 with random V/U words, X and Z lanes
    included, in every signal slot of the start state and in every forced
    input of every tick."""
    c, _ins, _pn, _rep = workloads.synth_top(workloads.FP16_ADD_SRC,
                                             "fp16_add", "cpu")
    eng = c.digital_engine()
    _e, fs, _FV, _FU = c._compile_schedule([{}])
    plan = eng.plan(fs)
    rng = np.random.default_rng(seed)
    st = np.zeros((B, 2, plan.K), np.uint32)
    v, u = _words(rng, (B, plan.trash), True)
    st[:, 0, :plan.trash], st[:, 1, :plan.trash] = v, u
    FV, FU = _words(rng, (B, T, plan.nf), True)
    return (plan, as_int32(st).to(device), as_int32(FV).to(device),
            as_int32(FU).to(device))


def rv32_case(B: int, T: int, device, design=None, seed=None):
    """The RV32 core through ``T`` ticks of ``bench_digital.py``'s
    schedule (reset pulse, then clocks).  With ``seed`` None every
    instance starts from the all-X state; with a seed each instance
    starts from its own random V/U words, X and Z lanes included, in
    every signal slot."""
    d = design if design is not None else workloads.build_rv32("cpu")
    c = d.circuit
    eng = c.digital_engine()
    eng.reset_state()
    reset, body = workloads.rv32_schedules(d, (T + 1) // 2)
    _e, fs, FV, FU = c._compile_schedule((reset + body)[:T])
    plan = eng.plan(fs)
    st = np.repeat(plan.pack_state(eng.sv, eng.su, eng.seq_state)[None], B,
                   axis=0)
    if seed is not None:
        v, u = _words(np.random.default_rng(seed), (B, plan.trash), True)
        st[:, 0, :plan.trash] = v.view(np.int32)
        st[:, 1, :plan.trash] = u.view(np.int32)
    return (plan, torch.from_numpy(st).to(device),
            as_int32(np.repeat(FV[None], B, axis=0)).to(device),
            as_int32(np.repeat(FU[None], B, axis=0)).to(device))


def with_tables(plan, **tables):
    """A copy of ``plan`` with some of its chunk tables (``cone_tab``,
    ``full_tab``, ``ff_tab``) or counts replaced, its schedule and device
    tables not yet built."""
    out = copy.copy(plan)
    out.__dict__.update(tables)
    out._sched, out._dev = None, {}
    return out


def double_write(plan):
    """``plan`` with the second gate of the full pass's first chunk
    writing the first gate's output slot: a table whose result is
    undefined, which the schedule must refuse."""
    tab = plan.full_tab.copy()
    tab[turbo._R_OHI, 1] = tab[turbo._R_OHI, 0]
    tab[turbo._R_OLO, 1] = tab[turbo._R_OLO, 0]
    return with_tables(plan, full_tab=tab)


def gate_table(plan, chunks):
    """A combinational chunk table for ``plan``: chunk i holds the gates
    ``chunks[i]``, each (op, a, b, o), padded as the plans pad."""
    C = turbo.CHUNK
    tab = np.zeros((turbo._N_ROWS, len(chunks) * C), np.int32)
    for hi in (turbo._R_AHI, turbo._R_BHI, turbo._R_OHI):
        tab[hi], tab[hi + 1] = plan.trash >> 7, plan.trash & 127
    for i, gates in enumerate(chunks):
        for j, (op, a, b, o) in enumerate(gates):
            k = i * C + j
            for hi, s in ((turbo._R_AHI, a), (turbo._R_BHI, b),
                          (turbo._R_OHI, o)):
                tab[hi, k], tab[hi + 1, k] = s >> 7, s & 127
            ia, ib, io, core = turbo._GEN2_ENC[op]
            tab[turbo._R_INVA:turbo._R_VALID + 1, k] = -ia, -ib, -io, -1
            if core:
                tab[turbo._R_CORE0 + core - 1, k] = -1
    return tab


def all_ops_chunks(S: int, seed: int):
    """One chunk per basic gate op (every op of the encoding, 100 gates
    each), operands and outputs drawn at random among S signals: reads
    of slots written in the same chunk, in earlier and in later chunks
    all occur."""
    rng = np.random.default_rng(seed)
    chunks = []
    for op in turbo._GEN2_ENC:
        a, b = rng.integers(0, S, (2, 100))
        o = rng.choice(S, 100, replace=False)
        chunks.append([(op, int(x), int(y), int(z))
                       for x, y, z in zip(a, b, o)])
    return chunks


def all_ops_case(B: int, T: int, seed: int, device):
    """The fp16 adder's plan with its full pass replaced by
    :func:`all_ops_chunks` and no cone pass, from random V/U words with X
    and Z lanes in every signal slot and forced input."""
    plan, st0, FV, FU = fp16_case(B, T, seed, device)
    chunks = all_ops_chunks(plan.S, seed)
    plan = with_tables(plan, full_tab=gate_table(plan, chunks),
                       n_full=len(chunks), n_cone=0)
    return plan, st0, FV, FU
