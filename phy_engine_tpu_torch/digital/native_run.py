"""Native single-trace digital runner (host C++ sweep engine).

Role parity: the reference clocks digital circuits with a
single-threaded C++ event-driven engine (circuits/circuit.h:307-337);
its throughput story is CUDA batching.  The port mirrors that split:
``digital/turbo.py`` (the whole-tick CUDA kernel) and the levelled tick
carry the batched/lane-parallel axes on the card, while THIS module
lowers the same DigitalIR into flat gate tables and hands a whole
schedule to ``native/pe_digital.cpp`` — a tight bit-packed host loop for
sequential single-trace clocking (each tick depends on the last; no
batch axis exists to amortize launches).  ``DigitalEngine(...,
backend="native")`` selects it.

Bit-exact with the other backends: same two-plane Kleene kernels, same
tick ordering (forced inputs -> input-cone settle -> FF segments with
frozen reads -> full settle).  The library is built with g++ at first
use; a failed build raises.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .ir import DigitalIR


def _run_bounds(op: np.ndarray, sub: np.ndarray) -> np.ndarray:
    """Boundaries of maximal same-op stretches WITHIN one sub-level.

    Gates inside a run are mutually independent (sub-levels are
    independent sets), which is what licenses the native engine's
    8-wide AVX-512 gather/scatter evaluation (pe_digital.cpp run_vec);
    a run must therefore never span a sub-level boundary."""
    n = len(op)
    if n == 0:
        return np.zeros(1, np.int32)
    brk = np.nonzero((op[1:] != op[:-1]) | (sub[1:] != sub[:-1]))[0] + 1
    return np.concatenate(
        [[0], brk, [n]]).astype(np.int32)


def _flat_gates(levels, alloc_temp):
    """Lower IR levels to one flat (op_enc, a, b, o, sub_id) int32
    table.

    Sequential evaluation order preserves dataflow: levels are
    topological, and _expand_level emits macro temps in earlier
    sub-levels than their consumers.  sub_id tags each gate with its
    independent sub-level so run bounds can be (re)derived, including
    after narrow-cone filtering."""
    from .turbo import _expand_level, _GEN2_ENC

    ops: List[int] = []
    aa: List[int] = []
    bb: List[int] = []
    oo: List[int] = []
    ss: List[int] = []
    sid = 0
    for level in levels:
        for sub in _expand_level(level, alloc_temp):
            # gates within a sub-level are independent: sort by opcode
            # so the interpreter sees long same-op runs (one dispatch
            # + vectorized evaluation per run)
            enc = sorted(
                ((_GEN2_ENC[op], a, b, o) for op, a, b, o in sub),
                key=lambda t: t[0])
            for (ia, ib, io, core), a, b, o in enc:
                ops.append(core | ia << 3 | ib << 4 | io << 5)
                aa.append(a)
                bb.append(b)
                oo.append(o)
                ss.append(sid)
            sid += 1
    return (np.array(ops, np.int32), np.array(aa, np.int32),
            np.array(bb, np.int32), np.array(oo, np.int32),
            np.array(ss, np.int32))


class NativePlan:
    """DigitalIR lowered to flat tables for pe_digital_run."""

    def __init__(self, ir: DigitalIR):
        from .engine import _input_cone_levels

        S = ir.n_signals
        self.S = S
        extra = S
        self.ff_meta = []          # (op, q_idx, lc_idx) per IR segment
        d_rows, c_rows, r_rows, q_rows, lc_rows, ren_rows = \
            [], [], [], [], [], []
        seg_bounds = [0]
        for seg in ir.seq:
            n = len(seg.instances)
            lc = np.arange(extra, extra + n, dtype=np.int32)
            extra += n
            q = seg.outputs[:, 0].astype(np.int32)
            d = seg.inputs[:, 0].astype(np.int32)
            c = seg.inputs[:, 1].astype(np.int32)
            if seg.op == "DFF_ARSTN":
                r = seg.inputs[:, 2].astype(np.int32)
                ren = np.ones(n, np.int32)
            else:
                r = np.zeros(n, np.int32)
                ren = np.zeros(n, np.int32)
            d_rows.append(d)
            c_rows.append(c)
            r_rows.append(r)
            q_rows.append(q)
            lc_rows.append(lc)
            ren_rows.append(ren)
            seg_bounds.append(seg_bounds[-1] + n)
            self.ff_meta.append((seg.op, q, lc))

        self._next = [extra]

        def alloc_temp():
            t = self._next[0]
            self._next[0] += 1
            return t

        # cyclic (gate-level latch) segments: flat per-segment tables
        # evaluated gather-then-write (Jacobi) and iterated to fixpoint
        # with the levels engine's budget — see pe_digital.cpp
        self.fix_budget = int(ir.cyclic_budget) if ir.cyclic else 0
        cy_ops, cy_a, cy_b, cy_o, cy_seg = [], [], [], [], [0]
        if ir.cyclic:
            from .turbo import _GEN2_ENC
            for seg in ir.cyclic:
                two = seg.inputs.shape[1] > 1 and \
                    seg.op not in ("NOT", "YES", "IS_UNKNOWN")
                ia, ib, io, core = _GEN2_ENC[seg.op]
                enc = core | ia << 3 | ib << 4 | io << 5
                for g in range(len(seg.outputs)):
                    a = int(seg.inputs[g][0])
                    b = int(seg.inputs[g][1]) if two else a
                    cy_ops.append(enc)
                    cy_a.append(a)
                    cy_b.append(b)
                    cy_o.append(int(seg.outputs[g][0]))
                cy_seg.append(len(cy_ops))
        self.cyc = (np.array(cy_ops, np.int32), np.array(cy_a, np.int32),
                    np.array(cy_b, np.int32), np.array(cy_o, np.int32))
        self.cyc_seg = np.array(cy_seg, np.int32)
        self.max_cyc_seg = int(max((b - a for a, b in
                                    zip(cy_seg, cy_seg[1:])), default=0))

        # with feedback the pre-sequential settle is the FULL program
        # (engine.py: pre_fused = fused when has_fixpoint), so the
        # cone/narrow tables alias the full table
        if ir.cyclic:
            self.full = _flat_gates(ir.levels, alloc_temp)
            self.cone = self.full
        else:
            self.cone = _flat_gates(_input_cone_levels(ir), alloc_temp)
            self.full = _flat_gates(ir.levels, alloc_temp)
        self.cone_runs = _run_bounds(self.cone[0], self.cone[4])
        self.full_runs = (self.cone_runs if self.cone is self.full
                          else _run_bounds(self.full[0], self.full[4]))
        self.K = self._next[0]
        self._narrow_cache: Dict[bytes, tuple] = {}

        cat = (lambda rows: np.concatenate(rows)
               if rows else np.zeros(0, np.int32))
        self.ff_d = cat(d_rows)
        self.ff_c = cat(c_rows)
        self.ff_r = cat(r_rows)
        self.ff_q = cat(q_rows)
        self.ff_lc = cat(lc_rows)
        self.ff_ren = cat(ren_rows)
        self.seg = np.array(seg_bounds, np.int32)
        self.max_seg = int(max((b - a for a, b in
                                zip(seg_bounds, seg_bounds[1:])),
                               default=0))

    def pack_state(self, sv, su, seq_state: Dict) -> np.ndarray:
        """Engine planes + seq state -> uint64[K] (v | u<<32)."""
        st = np.zeros(self.K, np.uint64)
        st[:self.S] = (np.asarray(sv, np.uint64) |
                       (np.asarray(su, np.uint64) << np.uint64(32)))
        for op, q, lc in self.ff_meta:
            d = seq_state.get(op, {})
            if "lc_v" in d:
                st[lc] = (np.asarray(d["lc_v"], np.uint64) |
                          (np.asarray(d["lc_u"], np.uint64)
                           << np.uint64(32)))
        return st

    def commit_seq_state(self, st: np.ndarray, seq_state: Dict) -> Dict:
        """uint64[K] state -> the engine's seq_state (numpy uint32 leaves,
        the layout ``DigitalEngine.seq_state`` keeps between runs)."""
        v = (st & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        u = (st >> np.uint64(32)).astype(np.uint32)
        out = dict(seq_state)
        for op, q, lc in self.ff_meta:
            out[op] = {"q_v": v[q], "q_u": u[q], "lc_v": v[lc],
                       "lc_u": u[lc]}
        return out

    def _narrow(self, varying: np.ndarray):
        """Cone tables for ticks 1..T-1: full-table gates on paths from
        ``varying`` input signals to FF d/c/r pins.  Gates outside
        those paths hold their fixpoint from the previous full settle,
        so skipping them is bit-exact."""
        key = np.sort(varying).tobytes()
        hit = self._narrow_cache.get(key)
        if hit is not None:
            return hit
        op, a, b, o, sub = self.full
        fwd = np.zeros(self.K, bool)
        fwd[varying] = True
        gate_fwd = np.zeros(len(op), bool)
        for i in range(len(op)):
            if fwd[a[i]] or fwd[b[i]]:
                gate_fwd[i] = True
                fwd[o[i]] = True
        need = np.zeros(self.K, bool)
        need[self.ff_d] = True
        need[self.ff_c] = True
        need[self.ff_r[self.ff_ren != 0]] = True
        for i in range(len(op) - 1, -1, -1):
            if need[o[i]]:
                need[a[i]] = True
                need[b[i]] = True
        keep = gate_fwd & need[o]
        kop = np.ascontiguousarray(op[keep])
        ksub = np.ascontiguousarray(sub[keep])
        out = (kop,
               np.ascontiguousarray(a[keep]),
               np.ascontiguousarray(b[keep]),
               np.ascontiguousarray(o[keep]),
               _run_bounds(kop, ksub))
        self._narrow_cache[key] = out
        return out

    def run(self, st: np.ndarray, fsig: np.ndarray,
            FV: np.ndarray, FU: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
        """T ticks in one native call; st updated in place.
        Returns (HV, HU) history planes of shape (T, S)."""
        from ..native import digital_run as _native

        T = FV.shape[0]
        FV = np.ascontiguousarray(FV, np.uint32)
        FU = np.ascontiguousarray(FU, np.uint32)
        fsig = np.ascontiguousarray(fsig, np.int32)
        if self.fix_budget:
            # feedback: every tick's pre-settle is the full program
            narrow = self.full[:4] + (self.full_runs,)
        else:
            varies = ((FV != FV[0]).any(axis=0) |
                      (FU != FU[0]).any(axis=0))
            narrow = self._narrow(fsig[varies])
        HV = np.zeros((T, self.S), np.uint32)
        HU = np.zeros((T, self.S), np.uint32)
        _native(self, st, narrow, fsig, FV, FU, HV, HU)
        return HV, HU
