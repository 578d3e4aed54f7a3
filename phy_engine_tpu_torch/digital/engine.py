"""Digital engine of the port (``phy_engine_tpu/digital/engine.py``).

:class:`DigitalEngine` owns the digital IR of a netlist, the lane planes
(V, U — 32 stimulus lanes per uint32 word, kept on the host as numpy)
and the sequential state across ticks.  Two engines compute a tick:

* the **levelled tick** (:class:`LevelTick`, the JAX package's
  ``build_tick``): every device family — latches, gate feedback,
  TICK_DELAY, JK/T flip-flops, COUNTER4 / RANDOM4, INPUT8 / OUTPUT8,
  SCHMITT, CMP, VERILOG_MODULE outputs and analog sampling and drives.
  One body works on ``(B, n_signals)`` int32 planes on the engine's
  device, so it serves ``tick`` (B = 1, the mixed-signal
  ``digital_clk``) and the batch of ``run_ticks_batched`` alike;
* the **turbo tick** (:mod:`.turbo`): on the card the hand-written
  whole-tick kernel, for the designs ``turbo.eligible`` accepts.

Routing is by eligibility only: ``run_ticks`` / ``run_ticks_batched``
take the turbo kernel when ``turbo.eligible(ir)``; ``run_ticks_batched``
takes the flash engine (:mod:`.flash`) when ``turbo.eligible(ir,
allow_cyclic=True)`` and a watch list is given; everything else, and
every ``tick``, runs the levelled tick.  The Tsu/Th unsteady-state
automata and the VERILOG_MODULE pre-pass run on the host, as in the JAX
package.  ``run_ticks_batched(mesh=...)`` shards the instances over a
DeviceMesh axis: each rank runs its contiguous shard through the route
the local call takes, and the histories are all-gathered.

tick = sample analog pins -> force INPUT values -> transport delays
       -> input-cone pre-settle -> sequential devices (edge-triggered,
       d_ff.h:59-66) -> levelled combinational sweeps -> bounded
       fixpoint for latch / feedback groups (circuit.h:317) -> analog
       drive extraction (lane 0).

The JAX package's scatters (``.at[idx].set``) run in index order on its
CPU, so of two writes to one signal the last wins; a CUDA
``index_put_`` gives no order.  Every scatter here is deduplicated on
the host, keeping the last write.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..netlist.netlist import Netlist
from . import check_backend, logic, turbo
from .ir import DigitalIR, Segment, bind_analog_indices, lower_digital

FULL = 0xFFFFFFFF
_ONES = -1                  # int32 bit pattern of FULL


def _i32(a) -> np.ndarray:
    """uint32 numpy -> int32 numpy of the same bits."""
    return np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32)


def _u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy of the same bits (on the host)."""
    return t.cpu().numpy().view(np.uint32)


def last_writes(idx) -> np.ndarray:
    """Positions of the last occurrence of each distinct index, in
    position order: the writes that survive a sequential scatter."""
    idx = np.asarray(idx, np.int64).reshape(-1)
    _u, first_rev = np.unique(idx[::-1], return_index=True)
    return np.sort(idx.size - 1 - first_rev)


def _eff(v, u):
    """Z -> X mapping at device inputs (read_dn in every seq model)."""
    return v & ~u, u


def _is_h(v, u):
    return v & ~u


def _is_l(v, u):
    return ~v & ~u


def _bcast(mask):
    """bool tensor -> int32 plane with all lanes equal."""
    return torch.where(mask, _ONES, 0).to(torch.int32)


# ---------------------------------------------------------------------------
# combinational opcode kernels: (planes...) -> (v, u) per output
# ---------------------------------------------------------------------------

_COMB2 = {
    "AND": logic.op_and, "OR": logic.op_or, "XOR": logic.op_xor,
    "XNOR": logic.op_xnor, "NAND": logic.op_nand, "NOR": logic.op_nor,
    "IMP": logic.op_imp, "NIMP": logic.op_nimp,
    "CASE_EQ": logic.op_case_eq, "RESOLVE2": logic.op_resolve2,
}
_COMB1 = {"NOT": logic.op_not, "YES": logic.op_yes,
          "IS_UNKNOWN": logic.op_is_unknown}

# op -> (invert_a, invert_b, invert_out, core) with core 0=AND 1=OR 2=XOR
_GEN2_ENC = {
    "AND": (0, 0, 0, 0), "NAND": (0, 0, 1, 0),
    "OR": (0, 0, 0, 1), "NOR": (0, 0, 1, 1),
    "XOR": (0, 0, 0, 2), "XNOR": (0, 0, 1, 2),
    "IMP": (1, 0, 0, 1), "NIMP": (0, 1, 0, 0),
    # 1-input gates with b aliased to a
    "NOT": (0, 0, 1, 0), "YES": (0, 0, 0, 0),
}


class _Dev:
    """Host numpy arrays of one tick program, and their copies on each
    device they run on (made at first use)."""

    def __init__(self):
        self._np: Dict[str, np.ndarray] = {}
        self._on: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def put(self, name, arr):
        self._np[name] = np.asarray(arr)

    def on(self, device) -> Dict[str, torch.Tensor]:
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = {k: torch.as_tensor(v, device=device)
                                for k, v in self._np.items()}
        return self._on[device]


class _Scatter:
    """``planes[..., idx] = vals`` with the JAX package's sequential
    last-write-wins order, as an ``index_put_`` over distinct indices."""

    def __init__(self, dev: _Dev, name: str, idx):
        idx = np.asarray(idx, np.int64).reshape(-1)
        keep = last_writes(idx)
        self.name = name
        self.dedup = keep.size != idx.size
        dev.put(name, idx[keep])
        if self.dedup:
            dev.put(name + ".keep", keep)

    def __call__(self, t, planes, vals):
        if self.dedup:
            vals = vals[..., t[self.name + ".keep"]]
        planes[..., t[self.name]] = vals


class _FusedLevel:
    """Every basic 1/2-input gate of one level as one gather ->
    (conditional input inversion) -> {AND, OR, XOR} cores ->
    (conditional output inversion) -> scatter.  Cores and inversions that
    no gate of the level uses are skipped (their select masks would be
    zero)."""

    def __init__(self, dev: _Dev, key: str, gates):
        n = len(gates)
        inp = np.zeros((n, 2), np.int64)
        out = np.zeros(n, np.int64)
        masks = np.zeros((5, n), np.uint32)
        for k, (op, a, b, o) in enumerate(gates):
            ia, ib, io, core = _GEN2_ENC[op]
            inp[k] = a, b
            out[k] = o
            masks[0, k] = FULL if ia else 0
            masks[1, k] = FULL if ib else 0
            masks[2, k] = FULL if io else 0
            masks[3, k] = FULL if core == 1 else 0
            masks[4, k] = FULL if core == 2 else 0
        self.key = key
        dev.put(key + ".ab", np.concatenate([inp[:, 0], inp[:, 1]]))
        m = masks.view(np.int32)
        self.used = [bool(m[i].any()) for i in range(5)]
        self.has_and = bool(((m[3] == 0) & (m[4] == 0)).any())
        for i, name in enumerate(("inv_a", "inv_b", "inv_o", "m_or",
                                  "m_xor")):
            dev.put(f"{key}.{name}", m[i])
        self.n = n
        self.out = _Scatter(dev, key + ".out", out)

    def eval(self, t, sv, su):
        k, n = self.key, self.n
        ab = t[k + ".ab"]
        gv, gu = sv[:, ab], su[:, ab]
        va, vb, ua, ub = gv[:, :n], gv[:, n:], gu[:, :n], gu[:, n:]
        inv_a, inv_b, inv_o, m_or, m_xor = (
            t[f"{k}.{x}"] for x in ("inv_a", "inv_b", "inv_o", "m_or",
                                    "m_xor"))
        # conditional Kleene inversion (op_not: v' = ~v & ~u)
        if self.used[0]:
            va = (va & ~inv_a) | (~va & ~ua & inv_a)
        if self.used[1]:
            vb = (vb & ~inv_b) | (~vb & ~ub & inv_b)
        cores = []
        if self.has_and:
            and_v, and_u = logic.op_and(va, ua, vb, ub)
            keep = ~m_or & ~m_xor
            cores.append((and_v & keep, and_u & keep))
        if self.used[3]:
            or_v, or_u = logic.op_or(va, ua, vb, ub)
            cores.append((or_v & m_or, or_u & m_or))
        if self.used[4]:
            xor_v, xor_u = logic.op_xor(va, ua, vb, ub)
            cores.append((xor_v & m_xor, xor_u & m_xor))
        v, u = cores[0]
        for cv, cu in cores[1:]:
            v, u = v | cv, u | cu
        if self.used[2]:
            v = (v & ~inv_o) | (~v & ~u & inv_o)
        self.out(t, sv, v)
        self.out(t, su, u)


class _Seg:
    """A segment's index arrays on the device: ``in{j}`` its input
    columns, one last-write scatter per output column, ``an{j}`` the
    analog pin nodes and ``fp`` the float params where it has them."""

    def __init__(self, dev: _Dev, key: str, seg: Segment):
        self.op = seg.op
        self.key = key
        for j in range(seg.inputs.shape[1]):
            dev.put(f"{key}.in{j}", seg.inputs[:, j].astype(np.int64))
        self.outs = [_Scatter(dev, f"{key}.out{j}", seg.outputs[:, j])
                     for j in range(seg.outputs.shape[1])]
        if seg.anodes is not None:
            for j in range(seg.anodes.shape[1]):
                dev.put(f"{key}.an{j}", seg.anodes[:, j].astype(np.int64))
        if seg.fparams is not None:
            dev.put(key + ".fp", np.asarray(seg.fparams, np.float64))

    def read(self, t, sv, su, j):
        i = t[f"{self.key}.in{j}"]
        return sv[:, i], su[:, i]

    def write(self, t, sv, su, j, v, u):
        self.outs[j](t, sv, v)
        self.outs[j](t, su, u)


def _eval_comb_segment(s: _Seg, t, sv, su):
    """Evaluate one opcode segment in place."""
    op = s.op
    va, ua = s.read(t, sv, su, 0)
    if op in _COMB1:
        v, u = _COMB1[op](va, ua)
        s.write(t, sv, su, 0, v, u)
        return
    vb, ub = s.read(t, sv, su, 1)
    if op in _COMB2:
        v, u = _COMB2[op](va, ua, vb, ub)
        s.write(t, sv, su, 0, v, u)
        return
    if op == "TRI":
        v, u = logic.op_tri_state(va, ua, vb, ub)
        s.write(t, sv, su, 0, v, u)
        return
    if op == "HALF_ADDER":
        s_v, s_u = logic.op_xor(va, ua, vb, ub)
        c_v, c_u = logic.op_and(va, ua, vb, ub)
        s.write(t, sv, su, 0, s_v, s_u)
        s.write(t, sv, su, 1, c_v, c_u)
        return
    if op == "FULL_ADDER":
        vc, uc = s.read(t, sv, su, 2)
        xv, xu = logic.op_xor(va, ua, vb, ub)
        s_v, s_u = logic.op_xor(xv, xu, vc, uc)
        g1v, g1u = logic.op_and(va, ua, vb, ub)
        g2v, g2u = logic.op_and(vc, uc, xv, xu)
        c_v, c_u = logic.op_or(g1v, g1u, g2v, g2u)
        s.write(t, sv, su, 0, s_v, s_u)
        s.write(t, sv, su, 1, c_v, c_u)
        return
    if op == "HALF_SUBTRACTOR":
        d_v, d_u = logic.op_xor(va, ua, vb, ub)
        nav, nau = logic.op_not(va, ua)
        b_v, b_u = logic.op_and(nav, nau, vb, ub)
        s.write(t, sv, su, 0, d_v, d_u)
        s.write(t, sv, su, 1, b_v, b_u)
        return
    if op == "FULL_SUBTRACTOR":
        vc, uc = s.read(t, sv, su, 2)
        xv, xu = logic.op_xor(va, ua, vb, ub)
        d_v, d_u = logic.op_xor(xv, xu, vc, uc)
        nav, nau = logic.op_not(va, ua)
        nxv, nxu = logic.op_not(xv, xu)
        g1v, g1u = logic.op_and(nav, nau, vb, ub)
        g2v, g2u = logic.op_and(nxv, nxu, vc, uc)
        b_v, b_u = logic.op_or(g1v, g1u, g2v, g2u)
        s.write(t, sv, su, 0, d_v, d_u)
        s.write(t, sv, su, 1, b_v, b_u)
        return
    if op == "MUL2":
        a0v, a0u = va, ua
        a1v, a1u = vb, ub
        b0v, b0u = s.read(t, sv, su, 2)
        b1v, b1u = s.read(t, sv, su, 3)
        p0v, p0u = logic.op_and(a0v, a0u, b0v, b0u)
        t1v, t1u = logic.op_and(a1v, a1u, b0v, b0u)
        t2v, t2u = logic.op_and(a0v, a0u, b1v, b1u)
        p1v, p1u = logic.op_xor(t1v, t1u, t2v, t2u)
        c1v, c1u = logic.op_and(t1v, t1u, t2v, t2u)
        t3v, t3u = logic.op_and(a1v, a1u, b1v, b1u)
        p2v, p2u = logic.op_xor(t3v, t3u, c1v, c1u)
        p3v, p3u = logic.op_and(t3v, t3u, c1v, c1u)
        for k, (pv, pu) in enumerate(((p0v, p0u), (p1v, p1u),
                                      (p2v, p2u), (p3v, p3u))):
            s.write(t, sv, su, k, pv, pu)
        return
    raise ValueError(f"unknown comb op {op}")


def _latch_eval(s: _Seg, t, sv, su, st):
    """DLATCH (d_latch.h:57-70): en H -> q=d(eff), en X -> X, en L hold."""
    dv, du = _eff(*s.read(t, sv, su, 0))
    ev, eu = _eff(*s.read(t, sv, su, 1))
    en_h = _is_h(ev, eu)
    en_x = eu
    qv, qu = st["q_v"], st["q_u"]
    qv = (qv & ~en_h & ~en_x) | (dv & en_h)
    qu = (qu & ~en_h & ~en_x) | (du & en_h) | en_x
    s.write(t, sv, su, 0, qv, qu)
    return {"q_v": qv, "q_u": qu}


def _edge_and_hist(cv, cu, st):
    cv, cu = _eff(cv, cu)
    rise = _is_l(st["lc_v"], st["lc_u"]) & _is_h(cv, cu)
    known = ~cu
    lc_v = (st["lc_v"] & ~known) | (cv & known)
    lc_u = st["lc_u"] & ~known
    return rise, lc_v, lc_u


# clock input column per op (DFF / DFF_ARSTN / TFF / TBARFF: 1)
_CLK_COL = {"JKFF": 2, "COUNTER4": 0, "RANDOM4": 0}


def _eval_seq_segment(s: _Seg, t, sv, su, st, av_ext):
    """One sequential segment in place; returns its new state."""
    op = s.op

    if op == "SCHMITT":
        fp = t[s.key + ".fp"]
        volts = av_ext[t[s.key + ".an0"]]
        go_h = volts >= fp[:, 2]
        go_l = volts <= fp[:, 1]
        prev_v, prev_u = st["q_v"], st["q_u"]
        raw_v = torch.where(go_h, _ONES, torch.where(go_l, 0, prev_v))
        raw_u = torch.where(go_h | go_l, 0, prev_u)
        inv = fp[:, 0] > 0.5
        out_v = torch.where(inv, ~raw_v & ~raw_u, raw_v)
        s.write(t, sv, su, 0, out_v, raw_u)
        return {"q_v": raw_v, "q_u": raw_u}

    if op == "CMP":
        h = av_ext[t[s.key + ".an0"]] >= av_ext[t[s.key + ".an1"]]
        v = _bcast(h).expand(sv.shape[0], -1)
        s.write(t, sv, su, 0, v, torch.zeros_like(v))
        return st

    rise, lc_v, lc_u = _edge_and_hist(*s.read(t, sv, su, _CLK_COL.get(op, 1)),
                                      st)
    qv, qu = st.get("q_v"), st.get("q_u")

    if op in ("DFF", "DFF_ARSTN"):
        dv, du = _eff(*s.read(t, sv, su, 0))
        qv = (qv & ~rise) | (dv & rise)
        qu = (qu & ~rise) | (du & rise)
        if op == "DFF_ARSTN":
            av, au = _eff(*s.read(t, sv, su, 2))
            a_l = _is_l(av, au)
            a_x = au
            qv = qv & ~a_l & ~a_x
            qu = (qu & ~a_l) | a_x
        s.write(t, sv, su, 0, qv, qu)
        return {"q_v": qv, "q_u": qu, "lc_v": lc_v, "lc_u": lc_u}

    if op == "JKFF":
        jv, ju = _eff(*s.read(t, sv, su, 0))
        kv, ku = _eff(*s.read(t, sv, su, 1))
        s_ = _is_h(jv, ju) & _is_l(kv, ku)
        r_ = _is_l(jv, ju) & _is_h(kv, ku)
        t_ = _is_h(jv, ju) & _is_h(kv, ku)
        h_ = _is_l(jv, ju) & _is_l(kv, ku)
        x_ = ~(s_ | r_ | t_ | h_)
        tog = _is_l(qv, qu)          # enum->bool cast: toggling X gives L
        nv = s_ | (t_ & tog) | (h_ & qv)
        nu = (h_ & qu) | x_
        qv = (qv & ~rise) | (nv & rise)
        qu = (qu & ~rise) | (nu & rise)
        s.write(t, sv, su, 0, qv, qu)
        return {"q_v": qv, "q_u": qu, "lc_v": lc_v, "lc_u": lc_u}

    if op in ("TFF", "TBARFF"):
        tv, tu = _eff(*s.read(t, sv, su, 0))
        act = _is_h(tv, tu) if op == "TFF" else _is_l(tv, tu)
        t_x = tu
        tog = _is_l(qv, qu)
        nv = (act & tog) | (~act & ~t_x & qv)
        nu = (~act & ~t_x & qu) | t_x
        qv = (qv & ~rise) | (nv & rise)
        qu = (qu & ~rise) | (nu & rise)
        s.write(t, sv, su, 0, qv, qu)
        return {"q_v": qv, "q_u": qu, "lc_v": lc_v, "lc_u": lc_u}

    if op == "COUNTER4":
        # inputs: clk(0), en(1); outputs q3..q0 (counter4.h:112-160)
        env_, enu = s.read(t, sv, su, 1)
        en_h = env_                    # H or Z count as enabled
        en_x = ~env_ & enu             # X only
        bits = st["bits"]              # (B, n, 4) planes b0..b3
        un = st["un"]
        carry = rise & en_h & ~un
        new_bits = []
        for b in range(4):
            new_bits.append(bits[..., b] ^ carry)
            carry = bits[..., b] & carry
        bits = torch.stack(new_bits, dim=-1)
        un = un | (rise & en_x)
        for k in range(4):             # outputs: q3, q2, q1, q0
            s.write(t, sv, su, k, bits[..., 3 - k] & ~un, un)
        return {"bits": bits, "un": un, "lc_v": lc_v, "lc_u": lc_u}

    if op == "RANDOM4":
        # inputs: clk(0), reset_n(1) (random_generator4.h:114-160)
        rv, ru = s.read(t, sv, su, 1)
        rst_l = _is_l(rv, ru)
        rst_x = ~rv & ru               # X (Z counts as released)
        bits = st["bits"]
        un = st["un"]
        b3, b2 = bits[..., 3], bits[..., 2]
        feedback = ~(b3 ^ b2)          # (b3^b2)^1
        step = rise & ~rst_l & ~rst_x & ~un
        shifted = torch.stack([
            (feedback & step) | (bits[..., 0] & ~step),
            (bits[..., 0] & step) | (bits[..., 1] & ~step),
            (bits[..., 1] & step) | (bits[..., 2] & ~step),
            (bits[..., 2] & step) | (bits[..., 3] & ~step),
        ], dim=-1)
        # the JAX package tests the whole word: any lane in reset
        # clears every lane's bits
        bits = torch.where((rst_l != 0)[..., None], 0, shifted)
        un = (un | rst_x) & ~rst_l
        for k in range(4):
            s.write(t, sv, su, k, bits[..., 3 - k] & ~un, un)
        return {"bits": bits, "un": un, "lc_v": lc_v, "lc_u": lc_u}

    raise ValueError(f"unknown seq op {op}")


# ---------------------------------------------------------------------------
# the levelled tick
# ---------------------------------------------------------------------------

def _input_cone_levels(ir: DigitalIR):
    """Per level, the subset of comb gates in the forward cone of the
    tick's mutable sources (forced INPUTs, analog-sampled nets,
    transport-delay outputs).  The pre-sequential settle only needs
    these: everything else is already settled from the previous tick's
    final pass."""
    dirty = set()
    for inst, out_sigs in ir.inputs:
        dirty.update(int(s) for s in out_sigs)
    dirty.update(int(s) for s in np.asarray(ir.samp_sig).ravel())
    if ir.tick_delays is not None:
        dirty.update(int(s) for s in ir.tick_delays.outputs[:, 0])
    for vm in ir.vmods:            # embedded-module outputs are forced
        for s in vm[4]:
            dirty.update(int(x) for x in np.asarray(s).ravel())

    out = []
    for level in ir.levels:
        lvl = []
        for seg in level:
            keep = []
            for k in range(len(seg.outputs)):
                if any(int(x) in dirty for x in seg.inputs[k]
                       if int(x) >= 0):
                    keep.append(k)
                    for x in seg.outputs[k]:
                        if int(x) >= 0:
                            dirty.add(int(x))
            if keep:
                lvl.append(Segment(
                    op=seg.op,
                    inputs=seg.inputs[keep],
                    outputs=seg.outputs[keep],
                    instances=[seg.instances[k] for k in keep]
                    if seg.instances else [],
                    anodes=(seg.anodes[keep]
                            if seg.anodes is not None else None),
                    fparams=(seg.fparams[keep]
                             if seg.fparams is not None else None)))
        out.append(lvl)
    return out


class LevelTick:
    """The levelled tick of one bound IR (``build_tick`` of the JAX
    package) over ``(B, n_signals)`` int32 planes.

    ``__call__(sv, su, st, fs, fv, fu, av)``: planes (B, S) (left
    untouched), sequential state {key: {name: (B, k[, 4])}}, the forced
    signal list ``fs`` (a deduplicated int64 tensor) with its (B, nf) or
    (nf,) values, the analog node voltages ``av`` (float64, one set for
    every lane).  Returns (sv, su, state, drives); ``drives`` (lane 0's)
    is None when no digital output drives an analog net, else
    {"node": int numpy, "active": float64, "v": float64}."""

    def __init__(self, ir: DigitalIR):
        self.ir = ir
        dev = self.dev = _Dev()
        self.latch = [_Seg(dev, f"latch{i}", s) for i, s in
                      enumerate(x for x in ir.seq if x.op == "DLATCH")]
        self.seq = [_Seg(dev, f"seq{i}", s) for i, s in
                    enumerate(x for x in ir.seq if x.op != "DLATCH")]
        self.has_fixpoint = bool(ir.cyclic) or bool(self.latch)
        self.full = self._levels("full", ir.levels)
        # the pre-sequential settle shrinks to the input cone when no
        # latch / feedback fixpoint is involved (then the full pass must
        # run anyway)
        self.pre = (self.full if self.has_fixpoint
                    else self._levels("cone", _input_cone_levels(ir)))
        self.cyclic = [_Seg(dev, f"cyc{i}", s)
                       for i, s in enumerate(ir.cyclic)]
        self.budget = int(ir.cyclic_budget)
        if ir.samp_sig.size:
            dev.put("samp_node", ir.samp_node.astype(np.int64))
            dev.put("samp_hl", ir.samp_hl)
            dev.put("samp_ll", ir.samp_ll)
        self.samp = _Scatter(dev, "samp_sig", ir.samp_sig)
        self.delay = (_Seg(dev, "delay", ir.tick_delays)
                      if ir.tick_delays is not None else None)
        if ir.drv_sig.size:
            dev.put("drv_sig", ir.drv_sig.astype(np.int64))
            dev.put("drv_hl", ir.drv_hl)
            dev.put("drv_ll", ir.drv_ll)

    def _levels(self, tag, levels):
        out = []
        for li, level in enumerate(levels):
            gates, rest = [], []
            for si, seg in enumerate(level):
                if seg.op in _GEN2_ENC:
                    inp = seg.inputs
                    for k in range(len(seg.outputs)):
                        a = int(inp[k, 0])
                        b = int(inp[k, 1]) if inp.shape[1] > 1 else a
                        gates.append((seg.op, a, b, int(seg.outputs[k, 0])))
                else:
                    rest.append(_Seg(self.dev, f"{tag}{li}.{si}", seg))
            fused = (_FusedLevel(self.dev, f"{tag}{li}.f", gates)
                     if gates else None)
            out.append((fused, rest))
        return out

    def levels_count(self):
        """(pre-settle levels, full-settle levels) of a tick."""
        return len(self.pre), len(self.full)

    def comb_pass(self, t, sv, su, latch_st, levels=None):
        for fl, rest in (self.full if levels is None else levels):
            if fl is not None:
                fl.eval(t, sv, su)
            for s in rest:
                _eval_comb_segment(s, t, sv, su)
        new_latch = [_latch_eval(s, t, sv, su, latch_st[i])
                     for i, s in enumerate(self.latch)]
        for s in self.cyclic:
            _eval_comb_segment(s, t, sv, su)
        return new_latch

    def __call__(self, sv, su, st, fs, fv, fu, av):
        t = self.dev.on(sv.device)
        ir = self.ir
        sv, su = sv.clone(), su.clone()
        st = dict(st)
        av_ext = torch.cat([av, av.new_zeros(1)])

        # 1. analog->digital sampling (threshold per net)
        if ir.samp_sig.size:
            volts = av_ext[t["samp_node"]]
            h = volts >= t["samp_hl"]
            low = volts <= t["samp_ll"]
            self.samp(t, sv, _bcast(h))
            self.samp(t, su, torch.where(h | low, 0, _ONES).to(torch.int32))

        # 2. forced INPUT values (before_all_clk, input.h:94+)
        if fs.numel():
            sv[:, fs] = fv
            su[:, fs] = fu

        # 3. transport delays (tick_delay.h: out <- held; held <- in)
        if self.delay is not None:
            held = st["TICK_DELAY"]
            in_v, in_u = _eff(*self.delay.read(t, sv, su, 0))
            self.delay.write(t, sv, su, 0, held["h_v"], held["h_u"])
            st["TICK_DELAY"] = {"h_v": in_v, "h_u": in_u}

        # 4a. pre-sequential comb settle over the forced-input cone
        latch_st = [st[f"DLATCH{i}"] for i in range(len(self.latch))]
        latch_st = self.comb_pass(t, sv, su, latch_st, levels=self.pre)

        # 4b. sequential devices
        for s in self.seq:
            st[s.op] = _eval_seq_segment(s, t, sv, su, st.get(s.op, {}),
                                         av_ext)

        # 5/6. combinational settle
        if not self.has_fixpoint:
            latch_st = self.comb_pass(t, sv, su, latch_st)
        else:
            sv, su, latch_st = self._fixpoint(t, sv, su, latch_st)
        for i in range(len(self.latch)):
            st[f"DLATCH{i}"] = latch_st[i]

        # 7. drive extraction (lane 0)
        drives = None
        if ir.drv_sig.size:
            v0 = sv[0, t["drv_sig"]] & 1
            u0 = su[0, t["drv_sig"]] & 1
            is_z = (v0 == 1) & (u0 == 1)
            is_h = (v0 == 1) & (u0 == 0)
            drives = {"node": ir.drv_node,
                      "active": torch.where(is_z, 0.0, 1.0).to(av.dtype),
                      "v": torch.where(is_h, t["drv_hl"], t["drv_ll"])}
        return sv, su, st, drives

    def _fixpoint(self, t, sv, su, latch_st):
        """The bounded settle of the JAX package's ``while_loop``, per
        lane as under its vmap: a lane passes again while its last pass
        changed a plane (or on the first pass) and it is under
        ``cyclic_budget``; a lane that stops keeps its state.  One host
        sync a pass."""
        B = sv.shape[0]
        it = torch.zeros(B, dtype=torch.int64, device=sv.device)
        run = torch.full((B,), self.budget > 0, dtype=torch.bool,
                         device=sv.device)
        while bool(run.any()):
            nv, nu = sv.clone(), su.clone()
            nls = self.comb_pass(t, nv, nu, latch_st)
            changed = (nv != sv).any(dim=1) | (nu != su).any(dim=1)
            m = run[:, None]
            sv, su = torch.where(m, nv, sv), torch.where(m, nu, su)
            latch_st = [{k: torch.where(m, n[k], o[k]) for k in o}
                        for o, n in zip(latch_st, nls)]
            it = it + run
            run = run & changed & (it < self.budget)
        return sv, su, latch_st


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------

def _state_to(seq_state, device, B: int):
    """numpy uint32 seq_state -> int32 tensors with a lane axis of B."""
    return {k: {n: torch.from_numpy(_i32(a)).to(device)[None]
                .expand((B,) + a.shape).clone() for n, a in d.items()}
            for k, d in seq_state.items()}


def _state_from(st):
    """Lane 0 of a device seq_state -> numpy uint32."""
    return {k: {n: _u32(a[0]).copy() for n, a in d.items()}
            for k, d in st.items()}


class DigitalEngine:
    """Owns the digital IR, planes, and sequential state across ticks.

    ``device``: where the ticks run ("cuda" by default; "cpu" runs the
    levelled tick and the turbo tick's plain torch version there).
    ``backend``: what :meth:`tick` and :meth:`run_ticks` clock with —
    "device" (the turbo kernel when ``turbo.eligible``, else the
    levelled tick) or "native" (the host sweep engine,
    ``digital/native_run.py``; raises ``ValueError`` for a design it
    cannot run).  :meth:`run_ticks_batched` runs on the device either
    way."""

    def __init__(self, nl: Netlist, device="cuda", backend: str = "device"):
        self.nl = nl
        self.device = torch.device(device)
        self.backend = check_backend(backend)
        self.ir: Optional[DigitalIR] = lower_digital(nl)
        if self.ir is None:
            raise ValueError("the netlist has no digital devices")
        self.n_drive_slots = len(self.ir.drv_sig)
        self._plans: Dict[bytes, turbo.TurboPlan] = {}
        self._flash: Dict[bytes, object] = {}
        self._tick_fn: Optional[LevelTick] = None
        self._native_plan = None
        self._n_analog = 0
        self._us_code = None     # Tsu/Th unsteady-state automata
        self.reset_state()

    def bind(self, n_analog_nodes: int):
        """Resolve analog node indices; must follow analog lowering."""
        bind_analog_indices(self.ir)
        self._n_analog = n_analog_nodes
        self._tick_fn = None
        self.reset_state()

    @property
    def tick_fn(self) -> LevelTick:
        if self._tick_fn is None:
            self._tick_fn = LevelTick(self.ir)
        return self._tick_fn

    def _seq_template(self) -> Dict[str, Dict[str, np.ndarray]]:
        ir = self.ir
        X = lambda k: {"q_v": np.zeros(k, np.uint32),  # noqa: E731
                       "q_u": np.full(k, FULL, np.uint32)}
        st: Dict[str, Dict] = {}
        if ir.tick_delays is not None:
            k = len(ir.tick_delays.instances)
            st["TICK_DELAY"] = {"h_v": np.zeros(k, np.uint32),
                                "h_u": np.full(k, FULL, np.uint32)}
        li = 0
        for seg in ir.seq:
            k = len(seg.instances)
            if seg.op == "DLATCH":
                st[f"DLATCH{li}"] = X(k)
                li += 1
            elif seg.op in ("COUNTER4", "RANDOM4"):
                bits = np.zeros((k, 4), np.uint32)
                if seg.op == "RANDOM4" and seg.fparams is not None:
                    seeds = seg.fparams[:, 0].astype(np.uint32)
                    for i in range(k):
                        for j in range(4):
                            if (int(seeds[i]) >> j) & 1:
                                bits[i, j] = FULL
                st[seg.op] = {"bits": bits, "un": np.zeros(k, np.uint32),
                              "lc_v": np.zeros(k, np.uint32),
                              "lc_u": np.full(k, FULL, np.uint32)}
            elif seg.op == "SCHMITT":
                st[seg.op] = X(k)
            elif seg.op == "CMP":
                pass
            else:
                st[seg.op] = {**X(k), "lc_v": np.zeros(k, np.uint32),
                              "lc_u": np.full(k, FULL, np.uint32)}
        return st

    def reset_state(self):
        """Every signal X; every sequential device's state as at power-up
        (RANDOM4 from its seed)."""
        n = self.ir.n_signals
        self.sv = np.zeros(n, np.uint32)
        self.su = np.full(n, FULL, np.uint32)
        self.seq_state = self._seq_template()

    def load_state(self, sv, su, seq_state: Dict):
        """Carry planes and sequential state in from elsewhere (numpy
        uint32 arrays, e.g. the JAX engine's mid-run ``sv``, ``su`` and
        ``seq_state``, every kind: flip-flops, ``DLATCH{i}``,
        ``TICK_DELAY``, COUNTER4 / RANDOM4 bits, SCHMITT)."""
        n = self.ir.n_signals
        sv = np.asarray(sv, np.uint32).copy()
        su = np.asarray(su, np.uint32).copy()
        if sv.shape != (n,) or su.shape != (n,):
            raise ValueError(f"planes must be ({n},), got {sv.shape} "
                             f"and {su.shape}")
        want = self._seq_template()
        got = {op: {k: np.asarray(v, np.uint32).copy()
                    for k, v in d.items()}
               for op, d in seq_state.items() if op in want or d}
        if set(got) != set(want):
            raise ValueError(f"seq_state keys {sorted(got)}, the design "
                             f"has {sorted(want)}")
        for op, d in want.items():
            for k, a in d.items():
                if k not in got[op] or got[op][k].shape != a.shape:
                    raise ValueError(f"seq_state[{op!r}][{k!r}] must have "
                                     f"shape {a.shape}")
        self.sv, self.su, self.seq_state = sv, su, got
        self._writeback()

    # -- Tsu/Th unsteady-state automata (and.h:161-363) ----------------------

    def has_unsteady(self) -> bool:
        ir = self.ir
        return (ir is not None and ir.samp_sig.size > 0 and
                ir.samp_tsu is not None and
                bool(np.any((ir.samp_tsu > 0) | (ir.samp_th > 0))))

    def observe_analog(self, analog_v, t: float) -> None:
        """Advance the setup/hold unsteady-state automata for
        threshold-sampled nets at time ``t`` (and.h:161-363: a crossing
        puts the input in X with the target latched in USR; the target
        commits only after it has held for Tsu/Th of *transient* time,
        and reverts if the voltage falls back).  Called at every
        digital tick and at every accepted transient substep, so short
        X windows and early commits follow the analog trajectory rather
        than tick endpoints."""
        if not self.has_unsteady():
            return
        ir = self.ir
        if self._us_code is None:
            k = ir.samp_sig.size
            self._us_code = np.full(k, 2, np.int8)   # starts X
            self._us_usr = np.full(k, 2, np.int8)
            self._us_mark = np.zeros(k, np.float64)
        av = np.asarray(analog_v)
        for i in range(ir.samp_sig.size):
            tsu = float(ir.samp_tsu[i])
            th = float(ir.samp_th[i])
            if tsu <= 0.0 and th <= 0.0:
                continue                 # plain thresholding (in the tick)
            nidx = int(ir.samp_node[i])
            v = float(av[nidx]) if 0 <= nidx < len(av) else 0.0
            hl = float(ir.samp_hl[i])
            ll = float(ir.samp_ll[i])
            if t <= 0.0:
                # no transient time axis yet (OP interleave): setup/
                # hold windows are transient-time phenomena, so track
                # the raw threshold; the automaton takes over from this
                # settled state once TR advances the clock
                self._us_code[i] = 1 if v >= hl else (
                    0 if v <= ll else 2)
                self._us_usr[i] = 2
                self._us_mark[i] = 0.0
                continue
            code = int(self._us_code[i])
            usr = int(self._us_usr[i])
            mark = float(self._us_mark[i])
            if code == 0:                              # L
                if v >= hl:
                    if tsu > 0.0:
                        code, usr, mark = 2, 1, t
                    else:
                        code = 1
            elif code == 1:                            # H
                if v <= ll:
                    if th > 0.0:
                        code, usr, mark = 2, 0, t
                    else:
                        code = 0
            else:                                      # X
                if usr == 0:                           # pending L
                    if v <= ll:
                        if t - mark >= tsu:
                            code = 0
                    else:
                        code = 1                       # revert
                elif usr == 1:                         # pending H
                    if v >= hl:
                        if t - mark >= th:
                            code = 1
                    else:
                        code = 0                       # revert
                else:                                  # initial X
                    if v >= hl:
                        if t - mark >= th:
                            code = 1
                    elif v <= ll:
                        if t - mark >= tsu:
                            code = 0
                    else:
                        mark = t
            self._us_code[i] = code
            self._us_usr[i] = usr
            self._us_mark[i] = mark

    def _unsteady_forced(self):
        """(sigs, v, u) overriding the tick's raw thresholding with the
        automaton codes for Tsu/Th-active sampled nets."""
        if self._us_code is None:
            return None
        ir = self.ir
        act = (ir.samp_tsu > 0) | (ir.samp_th > 0)
        if not act.any():
            return None
        code = self._us_code[act]
        v = np.where(code == 1, np.uint32(FULL), np.uint32(0))
        u = np.where(code == 2, np.uint32(FULL), np.uint32(0))
        return (ir.samp_sig[act].astype(np.int32),
                v.astype(np.uint32), u.astype(np.uint32))

    def _forced_arrays_np(self):
        """Pack INPUT/INPUT8 attribute values into forced-signal arrays."""
        sigs, vs, us = [], [], []
        for inst, out_sigs in self.ir.inputs:
            if inst.mdef.digital_op == "INPUT":
                code = int(inst.params.get("boolean", 2)) & 3
                v = FULL if (code & 1) else 0
                u = FULL if (code & 2) else 0
                sigs.append(out_sigs[0])
                vs.append(v)
                us.append(u)
            else:  # INPUT8: pins b7..b0, value bit per pin
                val = int(inst.params.get("value", 0)) & 0xFF
                for k, s in enumerate(out_sigs):
                    bit = 7 - k
                    sigs.append(s)
                    vs.append(FULL if (val >> bit) & 1 else 0)
                    us.append(0)
        return (np.array(sigs, np.int32), np.array(vs, np.uint32),
                np.array(us, np.uint32))

    def _samp_map(self):
        """sig -> (analog node index, ll, hl) for threshold-sampled nets."""
        if not hasattr(self, "_smap"):
            self._smap = {int(s): (int(n), float(ll), float(hl))
                          for s, n, ll, hl in zip(
                              self.ir.samp_sig, self.ir.samp_node,
                              self.ir.samp_ll, self.ir.samp_hl)}
        return self._smap

    def _run_vmods(self, analog_v: np.ndarray, forced=None):
        """Host pre-pass: run embedded Verilog modules one behavioral
        tick (verilog_module.h:212-303) and return their outputs as
        forced-signal triples.  INPUT devices conceptually run first in
        the before-phase, so their forced values overlay the snapshot
        the module samples."""
        from ..verilog.simulate import simulate as bsim
        from ..verilog.fourstate import Val
        sigs, vs, us = [], [], []
        sv = self.sv.copy()
        su = self.su.copy()
        if forced is not None:
            f_sig, f_v, f_u = forced
            sv[np.asarray(f_sig)] = np.asarray(f_v)
            su[np.asarray(f_sig)] = np.asarray(f_u)
        smap = self._samp_map()
        for inst, in_ports, in_sigs, out_ports, out_sigs in self.ir.vmods:
            rt = inst.runtime["rt"]
            inst.runtime["tick"] += 1
            tick = inst.runtime["tick"]
            for pname, sig in zip(in_ports, in_sigs):
                if sig in smap:
                    nidx, ll, hl = smap[sig]
                    volt = analog_v[nidx] if 0 <= nidx < len(analog_v) \
                        else 0.0
                    code = 1 if volt >= hl else (0 if volt <= ll else 2)
                else:
                    code = int((sv[sig] & 1) | ((su[sig] & 1) << 1))
                w = rt.values[pname].width
                if code == 0:
                    rt.values[pname] = Val.from_int(0, w)
                elif code == 1:
                    rt.values[pname] = Val.from_int(1, w)
                else:
                    rt.values[pname] = Val.all_x(w)
            bsim(rt, tick)
            for pname, sig in zip(out_ports, out_sigs):
                val = rt.values[pname]
                code = val.bit(0)
                sigs.append(sig)
                vs.append(0xFFFFFFFF if (code & 1) else 0)
                us.append(0xFFFFFFFF if (code & 2) else 0)
        return sigs, vs, us

    def _forced_dev(self, fs, fv, fu):
        """Forced lists onto the device, deduplicated (last write wins)."""
        keep = last_writes(fs)
        fs = np.asarray(fs, np.int64)[keep]
        fv = _i32(np.asarray(fv, np.uint32)[..., keep])
        fu = _i32(np.asarray(fu, np.uint32)[..., keep])
        d = self.device
        return (torch.from_numpy(fs).to(d), torch.from_numpy(fv).to(d),
                torch.from_numpy(fu).to(d))

    def _analog(self, analog_v):
        if analog_v is None:
            analog_v = np.zeros(self._n_analog, np.float64)
        return torch.as_tensor(np.asarray(analog_v, np.float64),
                               dtype=torch.float64, device=self.device)

    def _planes(self, B: int):
        d = self.device
        sv = torch.from_numpy(_i32(self.sv)).to(d)[None].expand(B, -1)
        su = torch.from_numpy(_i32(self.su)).to(d)[None].expand(B, -1)
        return sv, su, _state_to(self.seq_state, d, B)

    def commit(self, sv, su, st):
        """Take lane 0 of device planes and state as the engine's state."""
        self.sv = _u32(sv[0]).copy()
        self.su = _u32(su[0]).copy()
        self.seq_state = _state_from(st)
        self._writeback()

    def tick(self, analog_v: np.ndarray):
        """One digital_clk() on the levelled tick (the host sweep engine
        with ``backend="native"``); returns the drive dict (or None)."""
        fs, fv, fu = self._forced_arrays_np()
        if self.backend == "native":
            self._native_check(for_tick=True)
            self._run_ticks_native(fs, fv[None], fu[None])
            return None
        us = self._unsteady_forced()
        if us is not None:
            # the automaton's 4-state codes supersede the tick's raw
            # thresholding for Tsu/Th-active sampled nets
            fs = np.concatenate([fs, us[0]])
            fv = np.concatenate([fv, us[1]])
            fu = np.concatenate([fu, us[2]])
        if self.ir.vmods:
            vsig, vv, vu = self._run_vmods(np.asarray(analog_v),
                                           (fs, fv, fu))
            if vsig:
                fs = np.concatenate([fs, np.array(vsig, np.int32)])
                fv = np.concatenate([fv, np.array(vv, np.uint32)])
                fu = np.concatenate([fu, np.array(vu, np.uint32)])
        sv, su, st = self._planes(1)
        sv, su, st, drives = self.tick_fn(
            sv, su, st, *self._forced_dev(fs, fv, fu),
            self._analog(analog_v))
        self.commit(sv, su, st)
        return drives

    def run_levels(self, forced_sig, FV, FU, analog_v=None, watch=None):
        """T ticks of B instances on the levelled tick, every one from
        the engine's current state (nothing is committed): FV/FU (B, T,
        nf) uint32.  Returns the int32 device history (B, T, n) of the
        watched signals (all when None) and the final device state
        (sv, su, seq_state), which :meth:`commit` takes."""
        B, T = FV.shape[:2]
        fs, FVd, FUd = self._forced_dev(forced_sig, FV, FU)
        av = self._analog(analog_v)
        sv, su, st = self._planes(B)
        w = (None if watch is None else
             torch.as_tensor(np.asarray(watch, np.int64), device=self.device))
        hv, hu = [], []
        for i in range(T):
            sv, su, st, _drv = self.tick_fn(sv, su, st, fs, FVd[:, i],
                                            FUd[:, i], av)
            hv.append(sv if w is None else sv[:, w])
            hu.append(su if w is None else su[:, w])
        return torch.stack(hv, 1), torch.stack(hu, 1), (sv, su, st)

    def run_ticks(self, forced_sig, forced_v, forced_u, analog_v=None):
        """Run T ticks on the device with a per-tick forced-input
        schedule (the turbo kernel when ``turbo.eligible``, else the
        levelled tick; the tick's analog inputs are ``analog_v``, zeros
        when None).

        ``forced_sig``: int32[S] signal indices (fixed across ticks);
        ``forced_v``/``forced_u``: uint32[T, S] per-tick bit planes.
        Returns the per-tick (sv, su) history [T, n_signals] uint32
        numpy; the final state is committed.  With ``backend="native"``
        the host sweep engine runs the T ticks in one call."""
        if self.ir.vmods:
            raise ValueError("run_ticks: VERILOG_MODULE devices need "
                             "per-tick host interaction; use tick()")
        if self.backend == "native":
            self._native_check(for_tick=False)
            return self._run_ticks_native(forced_sig, forced_v, forced_u)
        if turbo.eligible(self.ir):
            return self._run_ticks_turbo(forced_sig, forced_v, forced_u)
        FV = np.asarray(forced_v, np.uint32)[None]
        FU = np.asarray(forced_u, np.uint32)[None]
        hv, hu, last = self.run_levels(forced_sig, FV, FU, analog_v)
        self.commit(*last)
        return _u32(hv[0]), _u32(hu[0])

    def native_blocker(self, for_tick: bool) -> Optional[str]:
        """Why the host sweep engine cannot compute this design, or None
        when it can: pure gates and flip-flops, no VERILOG_MODULE, no
        analog sampling, and, for :meth:`tick`, which returns the drives,
        no analog drives."""
        ir = self.ir
        if ir.vmods:
            return "it has VERILOG_MODULE devices"
        if ir.samp_sig.size:
            return "it samples analog nets"
        if for_tick and ir.drv_sig.size:
            return "it drives analog nets"
        if not turbo.eligible(ir, allow_cyclic=True):
            return ("turbo.eligible(ir, allow_cyclic=True) is false (a "
                    "device other than gates, INPUT and DFF / DFF_ARSTN)")
        return None

    def _native_check(self, for_tick: bool) -> None:
        why = self.native_blocker(for_tick)
        if why is not None:
            raise ValueError(f"backend='native' cannot run this design: "
                             f"{why}")

    def _run_ticks_native(self, forced_sig, FV, FU):
        """T ticks on the host sweep engine (digital/native_run.py), one
        library call; commits the final state, returns (HV, HU) uint32
        (T, n_signals)."""
        from . import native_run
        if self._native_plan is None:
            self._native_plan = native_run.NativePlan(self.ir)
        plan = self._native_plan
        st = plan.pack_state(self.sv, self.su, self.seq_state)
        HV, HU = plan.run(st, np.asarray(forced_sig, np.int32),
                          np.asarray(FV, np.uint32), np.asarray(FU, np.uint32))
        self.sv = (st[:plan.S] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        self.su = (st[:plan.S] >> np.uint64(32)).astype(np.uint32)
        self.seq_state = plan.commit_seq_state(st, self.seq_state)
        self._writeback()
        return HV, HU

    def plan(self, forced_sig) -> turbo.TurboPlan:
        fs = np.asarray(forced_sig, np.int32)
        key = fs.tobytes()
        if key not in self._plans:
            self._plans[key] = turbo.TurboPlan(self.ir, fs)
        return self._plans[key]

    def flash_plan(self, forced_sig):
        from .flash import FlashPlan
        fs = np.asarray(forced_sig, np.int32)
        key = fs.tobytes()
        if key not in self._flash:
            self._flash[key] = FlashPlan(self.ir, fs)
        return self._flash[key]

    def _state0(self, plan: turbo.TurboPlan, B: int):
        st = torch.from_numpy(plan.pack_state(self.sv, self.su,
                                              self.seq_state))
        return st.to(self.device)[None].expand(B, 2, plan.K).contiguous()

    def _run_ticks_turbo(self, forced_sig, forced_v, forced_u):
        plan = self.plan(forced_sig)
        hv, hu = turbo.run_turbo(
            plan, self._state0(plan, 1),
            turbo.as_int32(forced_v)[None].to(self.device),
            turbo.as_int32(forced_u)[None].to(self.device))
        v, u = plan.unpack_hist(hv[0], hu[0])
        self.sv = v[-1, :plan.S].copy()
        self.su = u[-1, :plan.S].copy()
        self.seq_state = plan.commit_seq_state(v[-1], u[-1], self.seq_state)
        self._writeback()
        return v[:, :plan.S], u[:, :plan.S]

    def run_ticks_batched(self, forced_sig, FV, FU, watch=None, mesh=None,
                          axis: str = "batch"):
        """Run B independent instances of the design for T ticks each,
        every one from the engine's CURRENT state (nothing is committed
        back).  ``FV``/``FU``: uint32[B, T, S] per-instance schedules over
        the shared ``forced_sig`` list.  ``watch``: signal indices whose
        per-tick planes are recorded (all signals when None).  ``mesh`` /
        ``axis``: a DeviceMesh on the engine's device and the axis to
        shard the instances over — each rank runs its contiguous shard
        (padded to the rank count by repeating the last instance; flash
        pads per rank as the JAX package does) and every rank returns
        all B histories.  Returns (hist_v, hist_u) uint32 numpy [B, T,
        len(watch)]."""
        if self.ir.vmods:
            raise ValueError("run_ticks_batched: VERILOG_MODULE devices "
                             "need per-tick host interaction")
        FV = np.asarray(FV, np.uint32)
        FU = np.asarray(FU, np.uint32)
        if mesh is None:
            return self._run_batched_local(forced_sig, FV, FU, watch)
        from ..parallel import mesh as pm
        mdev = pm.mesh_device(mesh)
        if mdev.type != self.device.type or (
                self.device.index is not None and mdev != self.device):
            raise ValueError(f"run_ticks_batched(mesh=...): the engine "
                             f"lives on {self.device}, the rank on {mdev}")
        if watch is not None and not turbo.eligible(self.ir) \
                and turbo.eligible(self.ir, allow_cyclic=True):
            from . import flash
            return flash.run_batched(self.flash_plan(forced_sig), self.sv,
                                     self.su, self.seq_state, FV, FU, watch,
                                     device=self.device, mesh=mesh,
                                     axis=axis)
        B = FV.shape[0]
        D = pm.axis_size(mesh, axis)
        lo, hi = pm.shard_range(-(-B // D) * D, mesh, axis)
        shard = [np.ascontiguousarray(pm.pad_rows(torch.from_numpy(a), D)
                                      [lo:hi].numpy()) for a in (FV, FU)]
        hv, hu = self._run_batched_local(forced_sig, *shard, watch)
        return tuple(pm.gather_rows(torch.from_numpy(h.view(np.int32))
                                    .to(mdev), mesh, axis)[:B].cpu()
                     .numpy().view(np.uint32) for h in (hv, hu))

    def _run_batched_local(self, forced_sig, FV, FU, watch):
        if turbo.eligible(self.ir):
            plan = self.plan(forced_sig)
            FVd = turbo.as_int32(FV).to(self.device)
            hv, hu = turbo.run_turbo(
                plan, self._state0(plan, FV.shape[0]), FVd,
                turbo.as_int32(FU).to(self.device), watch=watch)
            v, u = plan.unpack_hist(hv, hu)
            if watch is None:
                v, u = v[..., :plan.S], u[..., :plan.S]
            return v, u
        if watch is not None and turbo.eligible(self.ir, allow_cyclic=True):
            from . import flash
            return flash.run_batched(self.flash_plan(forced_sig), self.sv,
                                     self.su, self.seq_state, FV, FU, watch,
                                     device=self.device)
        hv, hu, _last = self.run_levels(forced_sig, FV, FU, None, watch)
        return _u32(hv), _u32(hu)

    def _writeback(self):
        """Lane-0 readback into netlist nodes and OUTPUT devices."""
        code = (self.sv & 1) | ((self.su & 1) << 1)
        for node, sig in self._node_sig_objs():
            node.digital = int(code[sig])
        # OUTPUT devices capture their input value (output.h:83+)
        for inst, in_sigs in self.ir.outputs:
            if inst.mdef.digital_op == "OUTPUT":
                inst.params["value"] = int(code[in_sigs[0]])
            else:  # OUTPUT8
                val = 0
                unk = 0
                for k, s in enumerate(in_sigs):
                    bit = 7 - k
                    c = int(code[s])
                    if c == 1:
                        val |= (1 << bit)
                    elif c >= 2:
                        unk |= (1 << bit)
                inst.params["value"] = float(val)
                inst.params["unknown_mask"] = float(unk)

    def _node_sig_objs(self):
        if not hasattr(self, "_nso"):
            by_id = {}
            for node in self.nl.all_nodes():
                if id(node) in self.ir.node_sig:
                    by_id[id(node)] = node
            self._nso = [(by_id[k], s) for k, s in self.ir.node_sig.items()
                         if k in by_id]
        return self._nso

    def signal_code(self, node) -> int:
        """Current 4-state code of a digital net (lane 0)."""
        sig = self.ir.node_sig.get(id(node))
        if sig is None:
            return logic.X
        return (int(self.sv[sig]) & 1) | ((int(self.su[sig]) & 1) << 1)
