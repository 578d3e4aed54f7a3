"""Inputs on which the turbo kernel is held against its plain version
(the card tests and ``chip_smoke.py`` share them).

Each case returns ``(plan, state0, FV, FU)``: a ``TurboPlan``, the
(B, 2, K) int32 start planes and the (B, T, nf) int32 forced planes, on
``device``.  Kernel and plain version must agree bit for bit on every
slot, tick, lane and plane: the engine is exact integer logic.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import workloads
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
    eng = c.prepare()
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
    eng = c.prepare()
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
