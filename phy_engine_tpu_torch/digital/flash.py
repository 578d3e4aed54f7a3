"""Batched digital engine on fast row gathers ("flash"; the port of
``phy_engine_tpu/digital/flash.py``).

* **State = (K, 2B) int32**: row k is signal slot k, columns are
  ``[v-plane words | u-plane words]`` for B instances (each word packs
  32 stimulus lanes, digital/logic.py).  One row gather returns every
  instance's both planes.
* **SSA slot renumbering** (:class:`FlashPlan`, built exactly as the
  JAX package builds it; the tests hold the arrays identical): forced
  INPUTs first, then per-FF-segment q / last-clock slots, then
  unproduced sources, then every expanded comb gate output in (level,
  sub-level) order with in-cone gates sorted first — so every *write*
  in the tick is a contiguous row slice and only operand *reads* are
  gathers.
* **Op-runs**: within a sub-level gates are sorted by opcode, so each
  Kleene core runs branch-free over a static row range.

Semantics are bit-identical to the levelled engine (digital/engine.py):
forced-input write, input-cone settle, per-segment flip-flop update
against a frozen pre-segment state, full settle.  Eligibility is
``turbo.eligible(ir, allow_cyclic=True)``: the feed-forward comb set +
DFF/DFF_ARSTN, plus gate-level latch feedback (``ir.cyclic``).  Cyclic
gates keep per-segment contiguous (non-SSA) slots and settle under a
bounded fixpoint (a host loop, one sync a pass) of Jacobi passes.
Because the topological leveller classifies every gate downstream of a
cycle as cyclic too, the SSA outputs cannot change during the fixpoint,
so only the Jacobi pass iterates.  The fixpoint runs until no column of
the whole batch changes, as the JAX package's does.

Every pass and the flip-flop update are torch ops on the plan's device
(gathers, bitwise ops, slice stores); the ``lax.scan`` over ticks is a
host loop.  ``run_batched(mesh=...)`` shards the instance columns over a
DeviceMesh axis as the JAX package's ``shard_map`` branch does: the batch
is padded with all-L instances as the JAX package pads it (to at least
``MIN_W // 2`` columns a rank when it must pad at all), each rank runs
its contiguous block (its own fixpoint), and the histories are
all-gathered.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from . import logic
from .engine import _COMB1, _COMB2
from .ir import DigitalIR
from .turbo import _GEN2_ENC, _expand_level

# The JAX package pads the instance columns up to a gather threshold of
# its accelerator.  The local run does not (no result depends on the
# column count); the mesh branch pads as the JAX package's does, so each
# rank's fixpoint sees the columns its JAX shard sees.
MIN_W = 256

# ops sorted key (stable run grouping)
_OP_ID = {op: i for i, op in enumerate(_GEN2_ENC)}
_UNARY = ("NOT", "YES", "IS_UNKNOWN")


def _unary(f):
    return lambda va, ua, vb, ub: f(va, ua)


# Kleene core per opcode: (va, ua, vb, ub) -> (v, u), digital/logic.py's
# formulas (the JAX package's flash spells out the same ones)
_CORES = {**_COMB2, "TRI": logic.op_tri_state,
          **{op: _unary(f) for op, f in _COMB1.items()}}


class FlashPlan:
    """Static compilation of a DigitalIR + forced-signal list into
    SSA-renumbered slots, per-sub-level op-runs, and FF segment maps
    (host numpy; :meth:`tables` puts the index arrays on a device)."""

    def __init__(self, ir: DigitalIR, forced_sig: np.ndarray):
        forced_sig = np.asarray(forced_sig, np.int32)
        S = ir.n_signals
        self.S = S
        self.nf = len(forced_sig)

        # ---- expand comb levels to basic gates (temps appended) -----
        next_temp = [S]

        def alloc_temp():
            t = next_temp[0]
            next_temp[0] += 1
            return t

        sublevels: List[List[Tuple[str, int, int, int]]] = []
        for level in ir.levels:
            sublevels.extend(_expand_level(level, alloc_temp))
        n_tot = next_temp[0]

        # ---- dirty-cone marking over expanded gates ------------------
        dirty = np.zeros(n_tot, bool)
        for inst, out_sigs in ir.inputs:
            for s in out_sigs:
                dirty[int(s)] = True
        in_cone: List[np.ndarray] = []
        for sub in sublevels:
            m = np.zeros(len(sub), bool)
            for k, (op, a, b, o) in enumerate(sub):
                if dirty[a] or (op not in _UNARY and dirty[b]):
                    m[k] = True
                    dirty[o] = True
            in_cone.append(m)

        # ---- slot renumbering ----------------------------------------
        # [forced][per-seg q][per-seg lc][sources][sub-level outputs...]
        NEW = np.full(n_tot, -1, np.int64)
        nxt = 0
        for s in forced_sig:
            if NEW[s] < 0:
                NEW[s] = nxt
                nxt += 1
        ff_fill = []               # (op, q_old_sigs, q0, lc0, n)
        for seg in ir.seq:
            q = seg.outputs[:, 0].astype(np.int64)
            n = len(q)
            for s in q:
                if NEW[s] >= 0:
                    raise ValueError("FF q driven twice")
                NEW[s] = nxt
                nxt += 1
            q0 = nxt - n
            lc0 = nxt
            nxt += n               # lc slots live only in new space
            ff_fill.append((seg.op, q, q0, lc0, n))
        # cyclic (gate-level latch feedback) records: one Jacobi unit
        # per IR segment — within a segment all gates read pre-segment
        # state; segments apply sequentially
        cyc_records: List[List[Tuple[str, int, int, int]]] = []
        for seg in ir.cyclic:
            two = seg.inputs.shape[1] > 1 and seg.op not in _UNARY
            gates = []
            for g in range(len(seg.outputs)):
                a = int(seg.inputs[g][0])
                b = int(seg.inputs[g][1]) if two else a
                gates.append((seg.op, a, b, int(seg.outputs[g][0])))
            cyc_records.append(gates)
        self.fix_budget = int(ir.cyclic_budget) if ir.cyclic else 0

        # sources: anything unproduced (non-forced INPUTs, consts, ...)
        produced = np.zeros(n_tot, bool)
        for sub in sublevels:
            for op, a, b, o in sub:
                produced[o] = True
        for seg in ir.seq:
            for s in seg.outputs[:, 0]:
                produced[int(s)] = True
        for gates in cyc_records:
            for _op, _a, _b, o in gates:
                produced[o] = True
        for s in range(S):
            if NEW[s] < 0 and not produced[s]:
                NEW[s] = nxt
                nxt += 1
        # cyclic outputs: a contiguous block (change detection slices
        # it) with per-segment contiguous sub-ranges
        self.cyc0 = nxt
        cyc_passes_old = []
        for gates in cyc_records:
            o0 = nxt
            for _op, _a, _b, o in gates:
                if NEW[o] >= 0:
                    raise ValueError("cyclic output driven twice")
                NEW[o] = nxt
                nxt += 1
            cyc_passes_old.append((gates, o0))
        self.n_cyc = nxt - self.cyc0
        # comb outputs, cone-first, op-sorted
        cone_passes, full_passes = [], []
        order_key = lambda g: _OP_ID[g[0]]  # noqa: E731
        for sub, cm in zip(sublevels, in_cone):
            cone = sorted((g for g, m in zip(sub, cm) if m), key=order_key)
            rest = sorted((g for g, m in zip(sub, cm) if not m),
                          key=order_key)
            gates = cone + rest
            o0 = nxt
            for op, a, b, o in gates:
                if NEW[o] >= 0:
                    raise ValueError("comb output driven twice")
                NEW[o] = nxt
                nxt += 1
            full_passes.append((gates, o0))
            if cone:
                cone_passes.append((cone, o0))
        if nxt != n_tot + sum(n for *_x, n in ff_fill):
            raise ValueError("slot renumbering left a gap")
        self.K = nxt
        self.NEW = NEW

        # finalize pass tables in new numbering
        def build_pass(gates, o0):
            a_idx = np.array([NEW[g[1]] for g in gates], np.int32)
            b_idx = np.array([NEW[g[2]] for g in gates], np.int32)
            runs = []
            i = 0
            while i < len(gates):
                j = i
                while j < len(gates) and gates[j][0] == gates[i][0]:
                    j += 1
                runs.append((gates[i][0], i, j - i))
                i = j
            return a_idx, b_idx, runs, int(o0), len(gates)

        self.cone_passes = [build_pass(g, o0) for g, o0 in cone_passes]
        self.full_passes = [build_pass(g, o0) for g, o0 in full_passes]
        self.cyclic_passes = [build_pass(g, o0) for g, o0 in
                              cyc_passes_old]

        # FF segment tables
        self.ff_segs = []          # (d_new, c_new, r_new|None, q0, lc0, n)
        self.ff_meta = []          # (op, q_old, q0, lc0, n) for commit
        for seg, (op, q_old, q0, lc0, n) in zip(ir.seq, ff_fill):
            d = NEW[seg.inputs[:, 0].astype(np.int64)].astype(np.int32)
            c = NEW[seg.inputs[:, 1].astype(np.int64)].astype(np.int32)
            r = (NEW[seg.inputs[:, 2].astype(np.int64)].astype(np.int32)
                 if op == "DFF_ARSTN" else None)
            self.ff_segs.append((d, c, r, q0, lc0, n))
            self.ff_meta.append((op, q_old, q0, lc0, n))
        self.forced_sig = forced_sig
        self._dev: Dict[torch.device, Dict] = {}

    # ---- device tables ---------------------------------------------------
    def tables(self, device):
        """The pass and FF index arrays as int64 tensors on ``device``
        (each pass's two operand lists as one gather list)."""
        device = torch.device(device)
        if device not in self._dev:
            def put(a):
                return torch.as_tensor(np.asarray(a, np.int64),
                                       device=device)

            def passes(ps):
                return [(put(np.concatenate([a, b])), runs, o0, g)
                        for a, b, runs, o0, g in ps]
            self._dev[device] = {
                "cone": passes(self.cone_passes),
                "full": passes(self.full_passes),
                "cyclic": passes(self.cyclic_passes),
                "ff": [(put(np.concatenate([d, c] + ([] if r is None
                                                      else [r]))),
                        r is not None, q0, lc0, n)
                       for d, c, r, q0, lc0, n in self.ff_segs]}
        return self._dev[device]

    # ---- state packing ---------------------------------------------------
    def pack_state(self, sv: np.ndarray, su: np.ndarray,
                   seq_state: Dict, B: int) -> np.ndarray:
        """(S,) uint32 planes + engine seq_state, replicated to B
        instance columns -> (K, 2B) int32 slab."""
        v = np.zeros(self.K, np.uint32)
        u = np.zeros(self.K, np.uint32)
        old = np.arange(self.S)
        NEW = self.NEW[:self.S].astype(np.int64)
        v[NEW] = np.asarray(sv, np.uint32)[old]
        u[NEW] = np.asarray(su, np.uint32)[old]
        for op, q_old, q0, lc0, n in self.ff_meta:
            st = seq_state.get(op, {})
            if "lc_v" in st:
                v[lc0:lc0 + n] = np.asarray(st["lc_v"], np.uint32)
                u[lc0:lc0 + n] = np.asarray(st["lc_u"], np.uint32)
        col = np.concatenate([np.repeat(v[:, None], B, 1),
                              np.repeat(u[:, None], B, 1)],
                             axis=1).view(np.int32)
        return col


# ---------------------------------------------------------------------------
# tick core (torch, in place on the (K, 2B) state)
# ---------------------------------------------------------------------------

def _comb_pass(st, passes, B: int):
    """Each pass reads every operand (one gather) before it stores."""
    for ab, runs, o0, g in passes:
        r = st[ab]
        va, ua = r[:g, :B], r[:g, B:]
        vb, ub = r[g:, :B], r[g:, B:]
        for op, i, n in runs:
            v, u = _CORES[op](va[i:i + n], ua[i:i + n],
                              vb[i:i + n], ub[i:i + n])
            st[o0 + i:o0 + i + n] = torch.cat([v, u], dim=1)


def _ff_pass(st, ff, B: int):
    for idx, has_r, q0, lc0, n in ff:
        rr = st[idx]                         # d, c[, r] rows
        rd, rc = rr[:n], rr[n:2 * n]
        dv, du = rd[:, :B] & ~rd[:, B:], rd[:, B:]
        cv, cu = rc[:, :B] & ~rc[:, B:], rc[:, B:]
        qv, qu = st[q0:q0 + n, :B], st[q0:q0 + n, B:]
        lcv, lcu = st[lc0:lc0 + n, :B], st[lc0:lc0 + n, B:]
        rise = (~lcv & ~lcu) & (cv & ~cu)
        known = ~cu
        lcv2 = (lcv & ~known) | (cv & known)
        lcu2 = lcu & ~known
        qv = (qv & ~rise) | (dv & rise)
        qu = (qu & ~rise) | (du & rise)
        if has_r:
            ra = rr[2 * n:]
            av, au = ra[:, :B] & ~ra[:, B:], ra[:, B:]
            a_l = ~av & ~au
            a_x = au
            qv = qv & ~a_l & ~a_x
            qu = (qu & ~a_l) | a_x
        st[q0:q0 + n] = torch.cat([qv, qu], dim=1)
        st[lc0:lc0 + n] = torch.cat([lcv2, lcu2], dim=1)


def _fixpoint(plan: FlashPlan, st, tabs, B: int):
    """Bounded Jacobi settle over the cyclic block: iterate the cyclic
    pass until the [cyc0, cyc0 + n_cyc) slot block stops changing (in
    every column) or ``fix_budget`` passes ran."""
    c0, c1 = plan.cyc0, plan.cyc0 + plan.n_cyc
    prev = st[c0:c1].clone()
    _comb_pass(st, tabs["cyclic"], B)                     # pass 1
    it = 1
    while it < plan.fix_budget and bool((st[c0:c1] != prev).any()):
        prev = st[c0:c1].clone()
        _comb_pass(st, tabs["cyclic"], B)
        it += 1


def tick(plan: FlashPlan, st, forced_blk, B: int, tabs=None):
    """One tick in place on ``st`` (K, 2B); ``forced_blk`` (nf, 2B) this
    tick's INPUT planes."""
    tabs = plan.tables(st.device) if tabs is None else tabs
    if plan.nf:
        st[:plan.nf] = forced_blk
    if plan.cyclic_passes:
        # with feedback, the pre-sequential settle is the FULL program
        # plus one Jacobi pass (the levelled tick's full pre-settle)
        _comb_pass(st, tabs["full"], B)
        _comb_pass(st, tabs["cyclic"], B)
        _ff_pass(st, tabs["ff"], B)
        _comb_pass(st, tabs["full"], B)
        _fixpoint(plan, st, tabs, B)
        return
    _comb_pass(st, tabs["cone"], B)
    _ff_pass(st, tabs["ff"], B)
    _comb_pass(st, tabs["full"], B)


def run_batched(plan: FlashPlan, sv, su, seq_state, FV, FU, watch,
                device="cuda", mesh=None, axis: str = "batch"):
    """B-instance batched run on ``device``, every instance from the
    given state; with ``mesh``, the instances shard over its ``axis``
    (see the module docstring) and every rank gets all B histories.

    FV/FU: uint32 (B, T, nf); watch: old-numbering signal indices.
    Returns (hv, hu) uint32 numpy (B, T, nw)."""
    FV = np.ascontiguousarray(np.asarray(FV, np.uint32))
    FU = np.ascontiguousarray(np.asarray(FU, np.uint32))
    B, T, nf = FV.shape
    if nf != plan.nf:
        raise ValueError(f"FV has {nf} forced columns, the plan {plan.nf}")
    if mesh is None:
        return _run_local(plan, sv, su, seq_state, FV, FU, watch, device)
    from ..parallel import mesh as pm
    ndev = pm.axis_size(mesh, axis)
    Bp, min_b = B, max(MIN_W // 2, ndev)
    if Bp % ndev or Bp < min_b:
        # a per-rank multiple that keeps each shard at MIN_W // 2 or more
        Bp = max(min_b, -(-B // ndev) * ndev)
        Bp = max(-(-Bp // ndev), MIN_W // 2) * ndev
    pad = np.zeros((Bp - B, T, nf), np.uint32)
    lo, hi = pm.shard_range(Bp, mesh, axis)
    hv, hu = _run_local(plan, sv, su, seq_state,
                        np.concatenate([FV, pad])[lo:hi],
                        np.concatenate([FU, pad])[lo:hi], watch, device)
    mdev = pm.mesh_device(mesh)
    return tuple(pm.gather_rows(torch.from_numpy(h.view(np.int32)).to(mdev),
                                mesh, axis)[:B].cpu().numpy().view(np.uint32)
                 for h in (hv, hu))


def _run_local(plan: FlashPlan, sv, su, seq_state, FV, FU, watch, device):
    B, T, nf = FV.shape
    FV = np.ascontiguousarray(FV)
    FU = np.ascontiguousarray(FU)
    device = torch.device(device)
    tabs = plan.tables(device)
    watch_new = torch.as_tensor(
        plan.NEW[np.asarray(watch, np.int64)], device=device)
    st = torch.from_numpy(plan.pack_state(sv, su, seq_state, B)).to(device)
    # xs layout (T, nf, 2B): v columns then u columns
    xs = torch.from_numpy(np.concatenate(
        [FV.transpose(1, 2, 0), FU.transpose(1, 2, 0)],
        axis=2).view(np.int32)).to(device)
    if not plan.cyclic_passes:
        # materialize macro temp slots (stale-temp reads in later cone
        # passes must see settled values)
        _comb_pass(st, tabs["full"], B)
    hist = []
    for i in range(T):
        tick(plan, st, xs[i], B, tabs)
        hist.append(st[watch_new])
    hist = torch.stack(hist).cpu().numpy()                # (T, nw, 2B)
    hv = np.ascontiguousarray(hist[:, :, :B].transpose(2, 0, 1))
    hu = np.ascontiguousarray(hist[:, :, B:].transpose(2, 0, 1))
    return hv.view(np.uint32), hu.view(np.uint32)
