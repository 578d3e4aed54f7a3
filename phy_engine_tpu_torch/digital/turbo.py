"""Whole-tick digital engine ("turbo" path; port of
``phy_engine_tpu/digital/turbo.py``).

The gate graph of a feed-forward design is levelled, block macros
(FULL_ADDER, MUL2, ...) are expanded into basic 2-input gates across
sub-levels with fresh temp slots, and every sub-level is cut into
uniform 128-gate chunks.  A chunk is 16 static int32 rows (operand and
output slots as hi/lo halves, inversion masks, validity, core-select
masks) of one table.  :class:`TurboPlan` builds the tables exactly as
the JAX package does (the tests hold them identical).

One tick, in order (``_tick_core`` of the JAX package):

1. forced INPUT words are written to their slots;
2. the forward cone of the forced inputs settles, chunk by chunk;
3. each flip-flop segment (DFF / DFF_ARSTN, ``rst_en`` unifying both)
   computes every new ``q`` and last-clock word from a frozen
   pre-segment snapshot, then stores them;
4. the full combinational graph settles, chunk by chunk.

Within a chunk every gate reads its operands before any gate of the
chunk stores (a sub-level never depends on itself).  Padding slots of a
chunk store 0 to the trash slot.

The tick runs from a gate-level schedule that :func:`level_schedule`
derives from the chunk tables (:attr:`TurboPlan.schedule`): per
combinational pass one record ``{a, b, o, op}`` per valid gate, sorted
by level, where a gate's level exceeds that of every gate it must
follow under the chunk semantics (the last earlier writer of a slot it
reads, the earlier writer of the slot it writes, and each gate that
reads that slot's older value).  The gates of one level are then
independent, and running the levels in order, each gate storing right
after it computes, gives the chunk order's result bit for bit.  Per
flip-flop segment one record ``{d, c, r, q, lc, rst_en}`` per flip-flop.
Where a pass or segment has padding slots the schedule says so, and
the tick stores 0 to the trash slot there.

State layout of the port: ``(B, 2, K)`` int32, the V and U planes of K
signal slots, 32 stimulus lanes per word (bit i = lane i), for B
independent instances.  The TPU's ``(Khi, 512)`` f32 slab of u16 halves
is a device detail of the MXU program and is not carried over:
:meth:`TurboPlan.pack_state` / :meth:`TurboPlan.unpack_hist` convert at
the edges.

Two versions of the tick loop, both walking the schedule level by level:

* :func:`run_turbo_plain` — plain torch: direct index gathers and
  scatters on int32 tensors in place of the TPU's one-hot matmuls;
* :func:`run_turbo` — the wrapper: a CPU tensor goes to the plain
  version; a CUDA tensor launches the hand-written kernel of
  ``ops/csrc/turbo.cu`` or raises.  ``run_turbo.launches`` counts
  kernel launches.  B = 1 with ``watch=None`` is ``run_pallas``'s
  function; B > 1 with a ``watch`` list is ``run_xla_batch``'s.

Eligible designs: comb ops in the fused basic set or the expandable
block set, sequential devices only DFF/DFF_ARSTN, no latches, no
feedback cycles, no TICK_DELAY, no VERILOG_MODULE, no analog sampling.
Everything a synthesized netlist produces qualifies.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops._build import launcher
from ..trace import kernel_wrapper
from .ir import DigitalIR

CHUNK = 128

# basic fused gates: op -> (invert_a, invert_b, invert_out, core)
# cores: 0=AND 1=OR 2=XOR 3=CASE_EQ 4=TRI 5=RESOLVE2 6=IS_UNKNOWN
_GEN2_ENC = {
    "AND": (0, 0, 0, 0), "NAND": (0, 0, 1, 0),
    "OR": (0, 0, 0, 1), "NOR": (0, 0, 1, 1),
    "XOR": (0, 0, 0, 2), "XNOR": (0, 0, 1, 2),
    "IMP": (1, 0, 0, 1), "NIMP": (0, 1, 0, 0),
    "NOT": (0, 0, 1, 0), "YES": (0, 0, 0, 0),
    "CASE_EQ": (0, 0, 0, 3), "TRI": (0, 0, 0, 4),
    "RESOLVE2": (0, 0, 0, 5), "IS_UNKNOWN": (0, 0, 0, 6),
}
_N_CORES = 7
# block macros expandable into basic gates
_BLOCK_OPS = ("HALF_ADDER", "FULL_ADDER", "HALF_SUBTRACTOR",
              "FULL_SUBTRACTOR", "MUL2")
_TURBO_SEQ = ("DFF", "DFF_ARSTN")

# chunk table row indices
_R_AHI, _R_ALO, _R_BHI, _R_BLO, _R_OHI, _R_OLO = range(6)
_R_INVA, _R_INVB, _R_INVO, _R_VALID = 6, 7, 8, 9
_R_CORE0 = 10                       # rows 10..15: core one-hot masks 1..6
_N_ROWS = _R_CORE0 + (_N_CORES - 1)

# FF table rows
(_F_DHI, _F_DLO, _F_CHI, _F_CLO, _F_RHI, _F_RLO, _F_QHI, _F_QLO,
 _F_LHI, _F_LLO, _F_VALID, _F_RSTEN) = range(12)

# gate record {a, b, o, op}: op = inv_a | inv_b << 1 | inv_o << 2 | core << 3;
# in the kernel's rows (level_rows) also _OP_SYNC and _OP_PAD
_OP_CORE_SHIFT = 3
_OP_SYNC = 1 << 6          # the block barrier follows this record's row
_OP_PAD = 1 << 7           # a padding record: no gate
# flip-flop record columns
_FF_REC = ("d", "c", "r", "q", "lc", "rst_en")


def eligible(ir: DigitalIR, allow_cyclic: bool = False) -> bool:
    """True when the turbo tick computes this design (see module doc).
    ``allow_cyclic``: also accept gate-level feedback (``ir.cyclic`` of
    plain gates), which the flash engine settles by a bounded fixpoint;
    the turbo tick itself is strictly feed-forward."""
    if ir.vmods or ir.tick_delays is not None:
        return False
    if ir.cyclic:
        if not allow_cyclic:
            return False
        for seg in ir.cyclic:
            # each cyclic segment must be a plain gate row for the
            # fixpoint's Jacobi evaluation
            if seg.op not in _GEN2_ENC:
                return False
    if ir.samp_sig.size:
        return False
    for seg in ir.seq:
        if seg.op not in _TURBO_SEQ:
            return False
    for level in ir.levels:
        for seg in level:
            if seg.op not in _GEN2_ENC and seg.op not in _BLOCK_OPS:
                return False
    for inst, _sigs in ir.inputs:
        if inst.mdef.digital_op != "INPUT":
            return False
    return True


def _pad128(n: int) -> int:
    return max(CHUNK, ((n + CHUNK - 1) // CHUNK) * CHUNK)


def _expand_level(segs, alloc_temp):
    """One IR level -> list of sub-levels of (op, a, b, o) basic gates.

    Block macros expand with fresh temp slots; a temp is always
    produced in an earlier sub-level than its consumer so sequential
    chunk execution preserves dataflow."""
    subs: List[List[Tuple[str, int, int, int]]] = [[], [], []]

    def emit(k, op, a, b, o):
        while len(subs) <= k:
            subs.append([])
        subs[k].append((op, a, b, o))

    for seg in segs:
        op = seg.op
        for g in range(len(seg.outputs)):
            i = [int(x) for x in seg.inputs[g]]
            o = [int(x) for x in seg.outputs[g]]
            if op in _GEN2_ENC:
                a = i[0]
                b = i[1] if len(i) > 1 and seg.inputs.shape[1] > 1 else a
                if op in ("NOT", "YES", "IS_UNKNOWN"):
                    b = a
                emit(0, op, a, b, o[0])
            elif op == "HALF_ADDER":
                emit(0, "XOR", i[0], i[1], o[0])
                emit(0, "AND", i[0], i[1], o[1])
            elif op == "FULL_ADDER":
                x, g1, g2 = alloc_temp(), alloc_temp(), alloc_temp()
                emit(0, "XOR", i[0], i[1], x)
                emit(0, "AND", i[0], i[1], g1)
                emit(1, "XOR", x, i[2], o[0])
                emit(1, "AND", i[2], x, g2)
                emit(2, "OR", g1, g2, o[1])
            elif op == "HALF_SUBTRACTOR":
                emit(0, "XOR", i[0], i[1], o[0])
                emit(0, "NIMP", i[1], i[0], o[1])      # b & ~a
            elif op == "FULL_SUBTRACTOR":
                x, g1, g2 = alloc_temp(), alloc_temp(), alloc_temp()
                emit(0, "XOR", i[0], i[1], x)
                emit(0, "NIMP", i[1], i[0], g1)
                emit(1, "XOR", x, i[2], o[0])
                emit(1, "NIMP", i[2], x, g2)
                emit(2, "OR", g1, g2, o[1])
            elif op == "MUL2":
                a0, a1, b0, b1 = i[:4]
                t1, t2, t3, c1 = (alloc_temp(), alloc_temp(),
                                  alloc_temp(), alloc_temp())
                emit(0, "AND", a0, b0, o[0])
                emit(0, "AND", a1, b0, t1)
                emit(0, "AND", a0, b1, t2)
                emit(0, "AND", a1, b1, t3)
                emit(1, "XOR", t1, t2, o[1])
                emit(1, "AND", t1, t2, c1)
                emit(2, "XOR", t3, c1, o[2])
                emit(2, "AND", t3, c1, o[3])
            else:  # pragma: no cover — guarded by eligible()
                raise ValueError(op)
    return [s for s in subs if s]


class TurboPlan:
    """Static compilation of a DigitalIR + forced-signal list into
    uniform chunk tables (identical to the JAX package's)."""

    def __init__(self, ir: DigitalIR, forced_sig: np.ndarray):
        from .engine import _input_cone_levels

        S = ir.n_signals
        self.S = S
        extra = S
        # per-FF last-clock slots
        self.ff_meta = []
        ff_rows = []
        for seg in ir.seq:
            n = len(seg.instances)
            lc = np.arange(extra, extra + n, dtype=np.int32)
            extra += n
            q = seg.outputs[:, 0].astype(np.int32)
            d = seg.inputs[:, 0].astype(np.int32)
            c = seg.inputs[:, 1].astype(np.int32)
            if seg.op == "DFF_ARSTN":
                r = seg.inputs[:, 2].astype(np.int32)
                ren = np.full(n, -1, np.int32)
            else:
                r = None
                ren = np.zeros(n, np.int32)
            ff_rows.append((d, c, r, q, lc, ren))
            self.ff_meta.append((seg.op, q, lc))

        # temp slots for block expansion
        self._next_temp = [extra]

        def alloc_temp():
            t = self._next_temp[0]
            self._next_temp[0] += 1
            return t

        def lower_levels(levels):
            gates = []     # flat, chunk-boundary-safe order
            for level in levels:
                for sub in _expand_level(level, alloc_temp):
                    # each sub-level starts at a fresh chunk boundary
                    while len(gates) % CHUNK:
                        gates.append(None)
                    gates.extend(sub)
            while len(gates) % CHUNK:
                gates.append(None)
            return gates

        cone_gates = lower_levels(_input_cone_levels(ir))
        full_gates = lower_levels(ir.levels)

        self.trash = self._next_temp[0]
        self.K = _pad128(self.trash + 1)
        self.Khi = self.K // CHUNK

        def build_tab(gates):
            C = max(1, len(gates) // CHUNK)
            tab = np.zeros((_N_ROWS, C * CHUNK), np.int32)
            for r in (_R_AHI, _R_BHI, _R_OHI):
                tab[r, :] = self.trash >> 7
            for r in (_R_ALO, _R_BLO, _R_OLO):
                tab[r, :] = self.trash & 127
            for k, gate in enumerate(gates):
                if gate is None:
                    continue
                op, a, b, o = gate
                ia, ib, io, core = _GEN2_ENC[op]
                tab[_R_AHI, k] = a >> 7
                tab[_R_ALO, k] = a & 127
                tab[_R_BHI, k] = b >> 7
                tab[_R_BLO, k] = b & 127
                tab[_R_OHI, k] = o >> 7
                tab[_R_OLO, k] = o & 127
                tab[_R_INVA, k] = -ia
                tab[_R_INVB, k] = -ib
                tab[_R_INVO, k] = -io
                tab[_R_VALID, k] = -1
                if core > 0:
                    tab[_R_CORE0 + core - 1, k] = -1
            return tab, C

        self.cone_tab, self.n_cone = build_tab(cone_gates)
        if not any(g is not None for g in cone_gates):
            self.n_cone = 0
        self.full_tab, self.n_full = build_tab(full_gates)
        if not any(g is not None for g in full_gates):
            self.n_full = 0

        # FF chunks — one chunk range per IR segment: each segment reads
        # a frozen pre-segment state (simultaneous within a segment,
        # sequential across segments)
        self.ff_ranges: List[Tuple[int, int]] = []
        chunks_total = sum((len(d) + CHUNK - 1) // CHUNK
                           for d, *_ in ff_rows)
        W = max(1, chunks_total) * CHUNK
        ff = np.zeros((12, W), np.int32)
        for r in (_F_DHI, _F_CHI, _F_RHI, _F_QHI, _F_LHI):
            ff[r, :] = self.trash >> 7
        for r in (_F_DLO, _F_CLO, _F_RLO, _F_QLO, _F_LLO):
            ff[r, :] = self.trash & 127
        k = 0
        for d, c, r, q, lc, ren in ff_rows:
            n = len(d)
            c0 = k // CHUNK
            sl = slice(k, k + n)
            ff[_F_DHI, sl], ff[_F_DLO, sl] = d >> 7, d & 127
            ff[_F_CHI, sl], ff[_F_CLO, sl] = c >> 7, c & 127
            if r is not None:
                ff[_F_RHI, sl], ff[_F_RLO, sl] = r >> 7, r & 127
            ff[_F_QHI, sl], ff[_F_QLO, sl] = q >> 7, q & 127
            ff[_F_LHI, sl], ff[_F_LLO, sl] = lc >> 7, lc & 127
            ff[_F_VALID, sl] = -1
            ff[_F_RSTEN, sl] = ren
            k = (k + n + CHUNK - 1) // CHUNK * CHUNK
            self.ff_ranges.append((c0, k // CHUNK))
        self.ff_tab = ff

        # forced-input scatter rows (static; values arrive per tick)
        nf = len(forced_sig)
        self.nf = nf
        self.nf_pad = _pad128(max(nf, 1))
        f = np.full(self.nf_pad, self.trash, np.int32)
        f[:nf] = forced_sig
        self.f_hi = (f >> 7)[None, :]
        self.f_lo = (f & 127)[None, :]
        self._sched: Optional[LevelSchedule] = None
        self._dev: Dict[str, Dict[str, torch.Tensor]] = {}

    # -- counts -------------------------------------------------------------
    @property
    def n_chunks_per_tick(self) -> int:
        ff = sum(c1 - c0 for c0, c1 in self.ff_ranges)
        return self.n_cone + ff + self.n_full

    @property
    def schedule(self) -> "LevelSchedule":
        """The gate-level schedule of the tables (built on first use;
        raises ValueError where the tables fail its checks)."""
        if self._sched is None:
            self._sched = level_schedule(self)
        return self._sched

    # -- state layout -------------------------------------------------------
    def pack_state(self, sv: np.ndarray, su: np.ndarray,
                   seq_state: Dict) -> np.ndarray:
        """uint32 planes + engine seq_state -> (2, K) int32 [V; U]."""
        st = np.zeros((2, self.K), np.uint32)
        st[0, :self.S] = np.asarray(sv, np.uint32)
        st[1, :self.S] = np.asarray(su, np.uint32)
        for op, q, lc in self.ff_meta:
            s = seq_state.get(op, {})
            if "lc_v" in s:
                st[0, lc] = np.asarray(s["lc_v"], np.uint32)
                st[1, lc] = np.asarray(s["lc_u"], np.uint32)
        return st.view(np.int32)

    def unpack_hist(self, hv, hu):
        """(..., T, K) int32 history pair (torch or numpy) -> uint32
        numpy planes of the same shape."""
        def u32(x):
            if isinstance(x, torch.Tensor):
                x = x.cpu().numpy()
            return np.ascontiguousarray(x, np.int32).view(np.uint32)
        return u32(hv), u32(hu)

    def commit_seq_state(self, v_last: np.ndarray, u_last: np.ndarray,
                         seq_state: Dict) -> Dict:
        out = dict(seq_state)
        for op, q, lc in self.ff_meta:
            out[op] = {"q_v": v_last[q].copy(), "q_u": u_last[q].copy(),
                       "lc_v": v_last[lc].copy(), "lc_u": u_last[lc].copy()}
        return out

    def pad_forced(self, FV, FU):
        """(B, T, nf) int32 forced planes -> (B, T, nf_pad), zero in the
        padding."""
        def pad(x):
            out = x.new_zeros(x.shape[:-1] + (self.nf_pad,))
            out[..., :self.nf] = x
            return out
        return pad(FV), pad(FU)

    def tables(self, device) -> Dict[str, torch.Tensor]:
        """The schedule's arrays as int32 tensors on ``device`` (cached),
        and its passes in the kernel's rows (``cone``, ``full``:
        :func:`level_rows` at :data:`THREADS`)."""
        key = str(torch.device(device))
        if key not in self._dev:
            sc = self.schedule
            f = lambda a: torch.from_numpy(
                np.ascontiguousarray(a, np.int32)).to(device)
            self._dev[key] = {
                "cone_rec": f(sc.cone_rec), "full_rec": f(sc.full_rec),
                "cone": f(level_rows(sc.cone_rec, sc.cone_off, THREADS)),
                "full": f(level_rows(sc.full_rec, sc.full_off, THREADS)),
                "ff_rec": f(sc.ff_rec), "ff_seg": f(sc.ff_seg),
                "f_slot": f(sc.f_slot)}
        return self._dev[key]


# ---------------------------------------------------------------------------
# the gate-level schedule (host, numpy)
# ---------------------------------------------------------------------------

@dataclass
class LevelSchedule:
    """Gate-level schedule of one :class:`TurboPlan` (module doc).

    ``*_rec``: (G, 4) int32 gate records ``{a, b, o, op}`` sorted by
    level, ``*_off``: (L + 1,) int32 level bounds into them, ``*_col``:
    each record's table column (host only), ``*_zero``: the pass stores 0
    to the trash slot.  ``ff_rec``: (F, 6) int32 flip-flop records
    (``_FF_REC``), ``ff_seg``: (n_seg, 3) int32 ``{first, end, zero}``
    per segment.  ``f_slot``: (nf_pad,) int32 forced slots, padding
    entries at the trash slot.  ``build_s``: host seconds to build."""
    cone_rec: np.ndarray
    cone_off: np.ndarray
    cone_col: np.ndarray
    cone_zero: bool
    full_rec: np.ndarray
    full_off: np.ndarray
    full_col: np.ndarray
    full_zero: bool
    ff_rec: np.ndarray
    ff_seg: np.ndarray
    f_slot: np.ndarray
    build_s: float

    @property
    def levels(self) -> Tuple[int, int]:
        """Levels per tick of the cone and the full pass."""
        return len(self.cone_off) - 1, len(self.full_off) - 1

    @property
    def max_seg_ffs(self) -> int:
        seg = self.ff_seg
        return int((seg[:, 1] - seg[:, 0]).max()) if len(seg) else 0


def level_rows(rec, off, nt: int) -> np.ndarray:
    """The kernel's layout of one pass for a block of ``nt`` threads:
    level l's records fill ceil(w_l / nt) rows of ``nt``, record j of the
    level at row j // nt, column j % nt (the thread that runs it).
    Padding records carry ``_OP_PAD`` (and slot 0), every record of a
    level's last row ``_OP_SYNC``.  Returns (rows * nt, 4) int32."""
    w = np.diff(off)
    n_rows = -(-w // nt)
    first = np.cumsum(n_rows) - n_rows
    out = np.zeros((int(n_rows.sum()) * nt, 4), np.int32)
    out[:, 3] = _OP_PAD
    level = np.repeat(np.arange(len(w)), w)
    out[first[level] * nt + np.arange(len(rec)) - off[level]] = rec
    out.reshape(-1, nt, 4)[first + n_rows - 1, :, 3] |= _OP_SYNC
    return out


def _mask_rows(x, what: str):
    if not np.isin(x, (0, -1)).all():
        raise ValueError(f"{what}: a mask row holds a value other than 0 "
                         "or -1")
    return x != 0


def _slots_in(x, hi: int, what: str):
    if x.size and (x.min() < 0 or x.max() >= hi):
        raise ValueError(f"{what} outside [0, {hi})")


def _gate_levels(a, b, o, chunk, what: str) -> np.ndarray:
    """Level of each gate under the chunk semantics: one past every gate
    it must follow.  A gate follows the last writer of each slot it
    reads in an earlier chunk (read after write), the previous writer of
    the slot it writes (write after write), and every gate that reads
    the value its write replaces, in its own chunk or earlier (write
    after read).  Levels are the longest paths from the gates that
    follow none (Kahn's algorithm, one level a step)."""
    G = len(o)
    if G == 0:
        return np.zeros(0, np.int64)
    span = int(chunk.max()) + 1
    wkey = o.astype(np.int64) * span + chunk
    worder = np.argsort(wkey, kind="stable")
    ws, wo = wkey[worder], o[worder]
    dup = np.flatnonzero(ws[1:] == ws[:-1])
    if dup.size:
        g = worder[dup[0]]
        raise ValueError(f"{what}: two gates of chunk {chunk[g]} write "
                         f"slot {o[g]}")
    same = np.flatnonzero(wo[1:] == wo[:-1])
    src = [worder[same]]
    dst = [worder[same + 1]]
    reader = np.tile(np.arange(G), 2)
    rs = np.concatenate([a, b]).astype(np.int64)
    # the first write of the slot at or after the reader's chunk
    pos = np.searchsorted(ws, rs * span + chunk[reader])
    prev = np.maximum(pos - 1, 0)
    raw = (pos > 0) & (wo[prev] == rs)
    src.append(worder[prev[raw]])
    dst.append(reader[raw])
    nxt = np.minimum(pos, G - 1)
    war = (pos < G) & (wo[nxt] == rs)
    src.append(reader[war])
    dst.append(worder[nxt[war]])
    src, dst = np.concatenate(src), np.concatenate(dst)
    own = src != dst              # a gate reading its own output slot
    src, dst = src[own], dst[own]
    indeg = np.bincount(dst, minlength=G)
    by_src = np.argsort(src, kind="stable")
    succ = dst[by_src]
    ptr = np.searchsorted(src[by_src], np.arange(G + 1))
    level = np.full(G, -1, np.int64)
    front = np.flatnonzero(indeg == 0)
    lv = 0
    while front.size:
        level[front] = lv
        lo, n = ptr[front], ptr[front + 1] - ptr[front]
        idx = np.repeat(lo - np.cumsum(n) + n, n) + np.arange(n.sum())
        nxt = succ[idx]
        np.subtract.at(indeg, nxt, 1)
        nxt = np.unique(nxt)
        front = nxt[indeg[nxt] == 0]
        lv += 1
    if (level < 0).any():
        g = np.flatnonzero(level < 0)[0]
        raise ValueError(f"{what}: gates of chunk {chunk[g]} read each "
                         "other's output slots (no level order exists)")
    return level


def _comb_schedule(tab, n: int, trash: int, what: str):
    """(records, level bounds, table columns, zero) of one pass."""
    t = tab[:, :n * CHUNK]
    col = np.flatnonzero(_mask_rows(t[_R_VALID], what))
    g = t[:, col]
    a = g[_R_AHI] * CHUNK + g[_R_ALO]
    b = g[_R_BHI] * CHUNK + g[_R_BLO]
    o = g[_R_OHI] * CHUNK + g[_R_OLO]
    # valid gates never touch the trash slot, so where the pass stores 0
    # to it does not matter
    for name, x in (("a", a), ("b", b), ("o", o)):
        _slots_in(x, trash, f"{what}: a gate's {name} slot")
    inv = _mask_rows(g[_R_INVA:_R_INVO + 1], what)
    hot = _mask_rows(g[_R_CORE0:_N_ROWS], what)
    if (hot.sum(axis=0) > 1).any():
        raise ValueError(f"{what}: a gate selects two cores")
    core = (hot * np.arange(1, _N_CORES)[:, None]).sum(axis=0)
    op = (inv[0] | inv[1] << 1 | inv[2] << 2 | core << _OP_CORE_SHIFT)
    level = _gate_levels(a, b, o, col // CHUNK, what)
    # within a level by core, so that the kernel's warps mostly run one
    order = np.lexsort((col, core, level))
    rec = np.stack([a, b, o, op], axis=1)[order].astype(np.int32)
    n_lv = int(level.max()) + 1 if len(level) else 0
    off = np.searchsorted(level[order], np.arange(n_lv + 1)).astype(np.int32)
    # padding among the pass's chunks stores 0 to the trash slot
    return rec, off, col[order].astype(np.int32), len(col) < t.shape[1]


def _ff_schedule(plan):
    """(records, segments) of the flip-flop table."""
    recs, seg, first = [], [], 0
    for s, (c0, c1) in enumerate(plan.ff_ranges):
        what = f"FF segment {s}"
        t = plan.ff_tab[:, c0 * CHUNK:c1 * CHUNK]
        col = np.flatnonzero(_mask_rows(t[_F_VALID], what))
        g = t[:, col]
        sl = {k: g[hi] * CHUNK + g[hi + 1] for k, hi in (
            ("d", _F_DHI), ("c", _F_CHI), ("r", _F_RHI), ("q", _F_QHI),
            ("lc", _F_LHI))}
        ren = g[_F_RSTEN]
        _mask_rows(ren, what)
        for k in ("d", "c", "q", "lc"):
            _slots_in(sl[k], plan.trash, f"{what}: a flip-flop's {k} slot")
        # a DFF's reset input is the trash slot, read and masked off
        _slots_in(np.where(ren != 0, sl["r"], 0), plan.trash,
                  f"{what}: an enabled reset slot")
        _slots_in(sl["r"], plan.trash + 1, f"{what}: a reset slot")
        w = np.concatenate([sl["q"], sl["lc"]])
        if len(np.unique(w)) < len(w):
            raise ValueError(f"{what}: two flip-flops write one slot")
        recs.append(np.stack([sl[k] for k in _FF_REC[:-1]] + [ren], axis=1))
        seg.append((first, first + len(col), int(len(col) < t.shape[1])))
        first += len(col)
    rec = (np.concatenate(recs) if recs else np.zeros((0, 6))).astype(np.int32)
    return rec, np.array(seg, np.int32).reshape(-1, 3)


def level_schedule(plan: TurboPlan) -> LevelSchedule:
    """Build the gate-level schedule of ``plan``'s tables (module doc).
    Raises ValueError where the tables leave the result undefined (two
    gates of one chunk, or two flip-flops of one segment, write one
    slot) or outside what the schedule handles (a gate touching the
    trash slot, gates of one chunk reading each other's outputs,
    repeated forced slots)."""
    t0 = time.perf_counter()
    cone = _comb_schedule(plan.cone_tab, plan.n_cone, plan.trash, "cone")
    full = _comb_schedule(plan.full_tab, plan.n_full, plan.trash, "full")
    ff_rec, ff_seg = _ff_schedule(plan)
    f = (plan.f_hi[0] * CHUNK + plan.f_lo[0]).astype(np.int32)
    _slots_in(f[:plan.nf], plan.trash, "a forced slot")
    if len(np.unique(f[:plan.nf])) < plan.nf or (f[plan.nf:] != plan.trash).any():
        raise ValueError("forced slots repeat, or padding is not the trash "
                         "slot")
    return LevelSchedule(*cone, *full, ff_rec, ff_seg, f,
                         time.perf_counter() - t0)


def as_int32(planes) -> torch.Tensor:
    """uint32 numpy planes -> int32 torch tensor of the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(planes, np.uint32).view(np.int32))


# ---------------------------------------------------------------------------
# plain version of the tick loop (torch int32, any device)
# ---------------------------------------------------------------------------

def _chunk_logic(rows, va, ua, vb, ub):
    """All Kleene cores + per-gate select (``_chunk_logic`` of the JAX
    package); ``rows[r]`` is a (128,) int32 mask row, operands (B, 128)."""
    inv_a, inv_b = rows[_R_INVA], rows[_R_INVB]
    inv_o = rows[_R_INVO]
    va = (va & ~inv_a) | (~va & ~ua & inv_a)
    vb = (vb & ~inv_b) | (~vb & ~ub & inv_b)
    h_a, l_a = va & ~ua, ~va & ~ua
    h_b, l_b = vb & ~ub, ~vb & ~ub
    and_v = h_a & h_b
    and_u = ~(and_v | l_a | l_b)
    or_v = h_a | h_b
    or_u = ~(or_v | (l_a & l_b))
    known = ~ua & ~ub
    xor_v = (va ^ vb) & known
    xor_u = ~known
    ceq_v = ~(va ^ vb) & ~(ua ^ ub)
    ceq_u = torch.zeros_like(ceq_v)
    # TRI: a=data, b=en (logic.op_tri_state)
    eh, el = h_b, l_b
    tbv, tbu = h_a, ua                        # buffered data (op_yes)
    tri_v = (eh & tbv) | el
    tri_u = (eh & tbu) | el | ub
    # RESOLVE2 (logic.op_resolve2)
    az = ua & va
    bz = ub & vb
    eq = ~(va ^ vb) & ~(ua ^ ub)
    sel_b = az
    sel_a = ~az & bz
    sel_e = ~az & ~bz & eq
    conflict = ~az & ~bz & ~eq
    res_v = (sel_b & vb) | (sel_a & va) | (sel_e & va)
    res_u = (sel_b & ub) | (sel_a & ua) | (sel_e & ua) | conflict
    unk_v = ua
    unk_u = torch.zeros_like(ua)

    v, u = and_v, and_u
    for core, (cv, cu) in enumerate(((or_v, or_u), (xor_v, xor_u),
                                     (ceq_v, ceq_u), (tri_v, tri_u),
                                     (res_v, res_u), (unk_v, unk_u)),
                                    start=1):
        m = rows[_R_CORE0 + core - 1]
        v = (v & ~m) | (cv & m)
        u = (u & ~m) | (cu & m)
    v = (v & ~inv_o) | (~v & ~u & inv_o)
    return v, u


def _op_rows(op):
    """The mask rows ``_chunk_logic`` reads, (16, G) int32, from the
    records' op field."""
    rows = op.new_zeros((_N_ROWS, op.shape[0]))
    for r, bit in ((_R_INVA, 0), (_R_INVB, 1), (_R_INVO, 2)):
        rows[r] = -((op >> bit) & 1)
    core = op >> _OP_CORE_SHIFT
    for c in range(1, _N_CORES):
        rows[_R_CORE0 + c - 1] = -(core == c).to(op.dtype)
    return rows


def _pass_args(rec, off, zero: bool):
    """A pass's operands for :func:`_level_pass`, made once per run."""
    return ([rec[:, i].long() for i in range(3)], _op_rows(rec[:, 3]),
            off.tolist(), zero)


def _level_pass(V, U, slots, rows, off, zero: bool, trash: int):
    """One combinational pass, level by level: every gate of a level
    gathers, computes and stores (no gate of a level reads a slot that
    another of its gates writes)."""
    if zero:
        V[:, trash] = 0
        U[:, trash] = 0
    a, b, o = slots
    for lo, hi in zip(off[:-1], off[1:]):
        s = slice(lo, hi)
        v, u = _chunk_logic(rows[:, s], V[:, a[s]], U[:, a[s]],
                            V[:, b[s]], U[:, b[s]])
        V[:, o[s]] = v
        U[:, o[s]] = u


def _ff_pass(V, U, rec, zero: bool, trash: int):
    """One FF segment: every flip-flop gathers before any stores."""
    d, c, r, q, lc = (rec[:, i].long() for i in range(5))
    ren = rec[:, 5]

    def eff(idx):
        v, u = V[:, idx], U[:, idx]
        return v & ~u, u

    dv, du = eff(d)
    cv, cu = eff(c)
    av, au = eff(r)
    qv, qu = V[:, q], U[:, q]
    lcv, lcu = V[:, lc], U[:, lc]
    rise = (~lcv & ~lcu) & (cv & ~cu)
    known = ~cu
    lcv2 = (lcv & ~known) | (cv & known)
    lcu2 = lcu & ~known
    qv = (qv & ~rise) | (dv & rise)
    qu = (qu & ~rise) | (du & rise)
    # async reset-low overlay, gated per flip-flop by rst_en
    a_l = ~av & ~au & ren
    a_x = au & ren
    qv = qv & ~a_l & ~a_x
    qu = (qu & ~a_l) | a_x
    V[:, q], U[:, q] = qv, qu
    V[:, lc], U[:, lc] = lcv2, lcu2
    if zero:
        V[:, trash] = 0
        U[:, trash] = 0


def run_turbo_plain(plan: TurboPlan, state0, FVp, FUp, watch=None):
    """Plain torch tick loop over the schedule; arguments and result as
    :func:`run_turbo` (forced planes already padded to ``nf_pad``)."""
    sc = plan.schedule
    tabs = plan.tables(state0.device)
    V = state0[:, 0].clone()
    U = state0[:, 1].clone()
    B, T = FVp.shape[0], FVp.shape[1]
    f = tabs["f_slot"].long()
    cone = _pass_args(tabs["cone_rec"], sc.cone_off, sc.cone_zero)
    full = _pass_args(tabs["full_rec"], sc.full_off, sc.full_zero)
    segs = [(tabs["ff_rec"][s0:s1], bool(z)) for s0, s1, z in sc.ff_seg]
    w = None if watch is None else watch.long()
    width = plan.K if w is None else len(w)
    hv = state0.new_empty((B, T, width))
    hu = state0.new_empty((B, T, width))
    for t in range(T):
        # 1. forced INPUT values (padding stores 0 to the trash slot)
        V[:, f] = FVp[:, t]
        U[:, f] = FUp[:, t]
        # 2. pre-sequential settle of the forced-input cone
        _level_pass(V, U, *cone, plan.trash)
        # 3. flip-flops, one frozen snapshot per IR segment
        for rec, zero in segs:
            _ff_pass(V, U, rec, zero, plan.trash)
        # 4. full combinational settle
        _level_pass(V, U, *full, plan.trash)
        hv[:, t] = V if w is None else V[:, w]
        hu[:, t] = U if w is None else U[:, w]
    return hv, hu


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

# threads of the kernel's block (one block per instance) and the width of
# its rows: ops/csrc/turbo.cu's THREADS, which the kernel is built for
THREADS = 256


def state_words(plan: TurboPlan) -> int:
    """32-bit words of one instance's working state in the kernel: V and
    U planes plus the FF segment buffer (4 words per flip-flop of the
    largest segment)."""
    return 2 * plan.K + 4 * plan.schedule.max_seg_ffs


def _check(plan, state0, FV, FU):
    for name, x in (("state0", state0), ("FV", FV), ("FU", FU)):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
            raise TypeError(f"{name} must be an int32 tensor")
        if x.device != state0.device:
            raise ValueError(f"{name} lies on {x.device}, state0 on "
                             f"{state0.device}")
    B = state0.shape[0]
    if state0.dim() != 3 or tuple(state0.shape[1:]) != (2, plan.K) or B < 1:
        raise ValueError(f"state0 must be (B, 2, {plan.K}), got "
                         f"{tuple(state0.shape)}")
    for name, x in (("FV", FV), ("FU", FU)):
        if x.dim() != 3 or x.shape[0] != B or x.shape[2] != plan.nf:
            raise ValueError(f"{name} must be (B={B}, T, nf={plan.nf}), "
                             f"got {tuple(x.shape)}")
    if FV.shape != FU.shape:
        raise ValueError("FV and FU differ in shape")
    if FV.shape[1] < 1:
        raise ValueError("no ticks to run (T = 0)")
    if state0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {state0.device}")


@kernel_wrapper
def run_turbo(plan: TurboPlan, state0, FV, FU, watch=None,
              _force_global: bool = False):
    """Run T ticks of B independent instances of the design.

    ``state0``: (B, 2, K) int32 start planes (:meth:`TurboPlan.pack_state`
    per instance).  ``FV``/``FU``: (B, T, nf) int32 per-tick planes of the
    plan's forced signals.  ``watch``: None (record all K slots) or a
    sequence of signal indices to record.  Returns (hv, hu) int32 of shape
    (B, T, K) or (B, T, len(watch)) on ``state0``'s device.

    On the card the kernel keeps each instance's planes in shared memory
    when they fit a block's, else in a per-instance scratch in device
    memory; ``_force_global`` takes the latter for any design, so that
    the card tests can hold both placements against the plain version."""
    _check(plan, state0, FV, FU)
    plan.schedule                     # raises where the tables fail its checks
    dev = state0.device
    w = None
    if watch is not None:
        w = torch.as_tensor(np.asarray(watch, np.int32)).to(dev)
        if w.dim() != 1 or (len(w) and (int(w.min()) < 0
                                        or int(w.max()) >= plan.K)):
            raise ValueError("watch must be a 1-D list of signal indices "
                             f"in [0, {plan.K})")
    FVp, FUp = plan.pad_forced(FV, FU)
    if dev.type == "cpu":
        return run_turbo_plain(plan, state0, FVp, FUp, w)
    hv, hu = _launch(plan, state0.contiguous(), FVp.contiguous(),
                     FUp.contiguous(), w, _force_global)
    run_turbo.launches += 1
    return hv, hu


def _launch(plan, state0, FVp, FUp, w, force_global):
    dev = state0.device
    B, T = FVp.shape[0], FVp.shape[1]
    width = plan.K if w is None else len(w)
    hv = torch.empty((B, T, width), dtype=torch.int32, device=dev)
    hu = torch.empty_like(hv)
    sc = plan.schedule
    words = state_words(plan)
    with launcher(dev) as launch:
        limit = launch.query("pe_turbo_smem_limit")
        in_global = force_global or launch.query(
            "pe_turbo_shared_bytes", words, 0) > limit
        if in_global:
            scratch = torch.empty((B, words), dtype=torch.int32, device=dev)
        else:
            scratch = hv                  # unused by the shared placement
        tabs = plan.tables(dev)
        launch("pe_turbo_run", state0, FVp, FUp, tabs["f_slot"],
               tabs["cone"], tabs["full"], tabs["ff_rec"], tabs["ff_seg"], w,
               hv, hu, scratch, B, T, plan.K, words, plan.nf_pad,
               len(tabs["cone"]) // THREADS, len(tabs["full"]) // THREADS,
               len(sc.ff_seg), width, plan.trash,
               int(sc.cone_zero) | int(sc.full_zero) << 1,
               1 if in_global else 0)
    return hv, hu
