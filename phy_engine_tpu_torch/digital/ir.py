"""Digital netlist -> cone IR lowering (the port's copy of
``phy_engine_tpu/digital/ir.py``, ``bind_analog_indices`` included).

The reference's digital engine is an event-driven worklist over node
pointers (circuits/circuit.h:307-337 + per-gate ``update_digital_clk``).
The TPU-native recast lowers the gate graph ONCE into dense arrays:

* every digital net and every device output pin gets a *signal slot*;
  signals are stored as two uint32 bit-planes (V, U) — 32 independent
  stimulus lanes per word (see digital/logic.py);
* combinational gates are topologically levelled; each level is split
  into opcode segments evaluated by one vectorized kernel each.  Gates
  on feedback cycles (latch loops) go into a trailing fixpoint group
  iterated under ``lax.while_loop`` with the reference's oscillation
  budget idea (circuit.h:317);
* sequential devices (FFs, counters) are separate segments evaluated
  once per tick *before* the combinational settle — equivalent to the
  worklist order for synchronous designs (clock edges arrive from the
  before-phase INPUT models);
* mixed-signal boundary pins get threshold-sampling slots (analog->X/H/L
  via Ll/Hl, and.h:161-363 simplified: no Tsu/Th automaton yet) and
  drive slots (digital output -> analog branch constraint voltage).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..netlist.netlist import Netlist, Node, ModelInstance
from ..models.base import DeviceClass, UpdatePhase

# opcodes grouped by arity/kind
COMB_OPS_2 = ("AND", "OR", "XOR", "XNOR", "NAND", "NOR", "IMP", "NIMP",
              "CASE_EQ", "RESOLVE2")
COMB_OPS_1 = ("NOT", "YES", "IS_UNKNOWN")
COMB_OPS_3 = ("TRI",)       # i, en -> o
BLOCK_OPS = ("HALF_ADDER", "FULL_ADDER", "HALF_SUBTRACTOR",
             "FULL_SUBTRACTOR", "MUL2")
SEQ_OPS = ("DFF", "DFF_ARSTN", "DLATCH", "JKFF", "TFF", "TBARFF",
           "COUNTER4", "RANDOM4")
IO_OPS = ("INPUT", "OUTPUT", "INPUT8", "OUTPUT8")
SPECIAL_OPS = ("TICK_DELAY", "SCHMITT", "CMP")


@dataclass
class Segment:
    """One opcode group: index arrays into the signal planes."""
    op: str
    inputs: np.ndarray      # (n, max_in) signal indices
    outputs: np.ndarray     # (n, max_out) signal indices
    instances: List[ModelInstance] = field(default_factory=list)
    # analog node indices of the input pins (for SCHMITT/CMP which read
    # raw voltages); resolved by bind_analog_indices. -1 = not analog.
    anodes: Optional[np.ndarray] = None
    # per-instance static params needed in-kernel (thresholds etc.)
    fparams: Optional[np.ndarray] = None


@dataclass
class DigitalIR:
    n_signals: int
    levels: List[List[Segment]]          # acyclic comb gates, levelled
    cyclic: List[Segment]                # comb gates on feedback loops
    seq: List[Segment]                   # sequential devices
    inputs: List[Tuple[ModelInstance, List[int]]]     # INPUT/INPUT8 -> sigs
    outputs: List[Tuple[ModelInstance, List[int]]]    # OUTPUT/OUTPUT8 <- sigs
    tick_delays: Optional[Segment]
    # analog sampling: signal <- threshold(analog node voltage)
    samp_sig: np.ndarray     # (ns,) signal index
    samp_node: np.ndarray    # (ns,) analog node index (into MNA v)
    samp_ll: np.ndarray      # (ns,)
    samp_hl: np.ndarray
    # analog driving: drive slot <- signal value
    drv_sig: np.ndarray      # (nd,) signal index
    drv_node: np.ndarray     # (nd,) analog node index
    drv_ll: np.ndarray
    drv_hl: np.ndarray
    node_sig: Dict[int, int]             # id(Node) -> signal
    cyclic_budget: int = 64
    # setup/hold unsteady-state times per sampled net (and.h:22-23
    # Tsu/Th); 0 disables the automaton for that net
    samp_tsu: np.ndarray = None
    samp_th: np.ndarray = None
    # VERILOG_MODULE host devices: (inst, in_ports, in_sigs, out_ports,
    # out_sigs)
    vmods: List[Tuple] = field(default_factory=list)


def lower_digital(nl: Netlist) -> Optional[DigitalIR]:
    """Compile all digital devices into a DigitalIR (None if none)."""
    dmods = [m for m in nl.live_models()
             if m.mdef.device_class == DeviceClass.DIGITAL]
    if not dmods:
        return None

    # ---- signal allocation ------------------------------------------------
    node_sig: Dict[int, int] = {}
    n_signals = 0

    def sig_for_node(node: Optional[Node]) -> int:
        nonlocal n_signals
        if node is None:
            s = n_signals
            n_signals += 1
            return s
        key = id(node)
        if key not in node_sig:
            node_sig[key] = n_signals
            n_signals += 1
        return node_sig[key]

    # pure-digital nets share one signal; analog/hybrid nets get a
    # *sampling* signal per net (threshold-converted each tick), and
    # device outputs driving analog nets get private signals + drive slots.
    samp = {}       # id(node) -> (sig, ll, hl, node)
    drives = []     # (sig, node, ll, hl)

    def in_sig(inst: ModelInstance, pin_i: int) -> int:
        pin = inst.pins[pin_i]
        node = pin.node
        if node is None:
            return sig_for_node(None)       # floating input: X forever
        if node.is_ground or node.num_of_analog_node > 0:
            key = id(node)
            if key not in samp:
                s = sig_for_node(None)
                ll = float(inst.params.get("Ll", 0.0))
                hl = float(inst.params.get("Hl", 5.0))
                tsu = float(inst.params.get("Tsu", 0.0))
                th = float(inst.params.get("Th", 0.0))
                samp[key] = (s, ll, hl, node, tsu, th)
            return samp[key][0]
        return sig_for_node(node)

    def out_sig(inst: ModelInstance, pin_i: int) -> int:
        pin = inst.pins[pin_i]
        node = pin.node
        if node is None:
            return sig_for_node(None)
        if node.is_ground or node.num_of_analog_node > 0:
            s = sig_for_node(None)
            ll = float(inst.params.get("Ll", 0.0))
            hl = float(inst.params.get("Hl", 5.0))
            drives.append((s, node, ll, hl))
            return s
        return sig_for_node(node)

    # ---- build raw gate records -------------------------------------------
    comb_records = []      # (op, in_sigs, out_sigs, inst)
    seq_records = []
    io_in, io_out = [], []
    tick_records = []
    vmods = []             # VERILOG_MODULE host devices

    for inst in dmods:
        op = inst.mdef.digital_op
        if op == "VERILOG":
            # one pin per top port; direction from the compiled module
            ports = inst.params.get("_ports", [])
            in_ports, in_sigs_l, out_ports, out_sigs_l = [], [], [], []
            for pi, (pname, pdir, _w) in enumerate(ports):
                if pdir in ("input", "inout", None):
                    in_ports.append(pname)
                    in_sigs_l.append(in_sig(inst, pi))
                if pdir in ("output", "inout"):
                    out_ports.append(pname)
                    out_sigs_l.append(out_sig(inst, pi))
            vmods.append((inst, in_ports, in_sigs_l, out_ports,
                          out_sigs_l))
            continue
        ins = [in_sig(inst, i) for i in inst.mdef.din_pins]
        outs = [out_sig(inst, i) for i in inst.mdef.dout_pins]
        if op in ("INPUT", "INPUT8"):
            io_in.append((inst, outs))
        elif op in ("OUTPUT", "OUTPUT8"):
            io_out.append((inst, ins))
        elif op == "TICK_DELAY":
            tick_records.append((op, ins, outs, inst))
        elif op in SEQ_OPS or op in ("SCHMITT", "CMP"):
            # SCHMITT/CMP read raw analog voltages (per-device thresholds /
            # comparison) and are stateful or analog-only: evaluate them in
            # the sequential phase with bound analog node indices.
            seq_records.append((op, ins, outs, inst))
        else:
            comb_records.append((op, ins, outs, inst))

    # ---- topological levelling of comb gates ------------------------------
    # producer map: signal -> list of comb gate ids
    produced_by: Dict[int, List[int]] = {}
    for gi, (_op, _ins, outs, _inst) in enumerate(comb_records):
        for s in outs:
            produced_by.setdefault(s, []).append(gi)

    # signals produced by seq/io/tick/sampling are level-0 sources
    n_gates = len(comb_records)
    indeg = np.zeros(n_gates, dtype=np.int64)
    dependents: Dict[int, List[int]] = {}
    for gi, (_op, ins, _outs, _inst) in enumerate(comb_records):
        deps = set()
        for s in ins:
            for pj in produced_by.get(s, ()):
                if pj != gi:
                    deps.add(pj)
        indeg[gi] = len(deps)
        for pj in deps:
            dependents.setdefault(pj, []).append(gi)

    level_of = np.full(n_gates, -1, dtype=np.int64)
    from collections import deque
    dq = deque(int(i) for i in np.nonzero(indeg == 0)[0])
    for gi in dq:
        level_of[gi] = 0
    remaining = indeg.copy()
    order = []
    while dq:
        gi = dq.popleft()
        order.append(gi)
        for dj in dependents.get(gi, ()):
            remaining[dj] -= 1
            level_of[dj] = max(level_of[dj], level_of[gi] + 1)
            if remaining[dj] == 0:
                dq.append(dj)
    ordered = set(order)
    cyclic_ids = [gi for gi in range(n_gates) if gi not in ordered]

    def make_segments(gate_ids) -> List[Segment]:
        by_op: Dict[str, List[int]] = {}
        for gi in gate_ids:
            by_op.setdefault(comb_records[gi][0], []).append(gi)
        segs = []
        for op, gids in sorted(by_op.items()):
            max_in = max(len(comb_records[g][1]) for g in gids)
            max_out = max(len(comb_records[g][2]) for g in gids)
            ins = np.zeros((len(gids), max(1, max_in)), np.int32)
            outs = np.zeros((len(gids), max(1, max_out)), np.int32)
            insts = []
            for k, g in enumerate(gids):
                _op, i_s, o_s, inst = comb_records[g]
                ins[k, :len(i_s)] = i_s
                outs[k, :len(o_s)] = o_s
                insts.append(inst)
            segs.append(Segment(op=op, inputs=ins, outputs=outs,
                                instances=insts))
        return segs

    max_level = int(level_of[list(order)].max()) if order else -1
    by_level: Dict[int, List[int]] = {}
    for gi in order:
        by_level.setdefault(int(level_of[gi]), []).append(gi)
    levels = []
    for lv in range(max_level + 1):
        ids = by_level.get(lv)
        if ids:
            levels.append(make_segments(ids))
    cyclic = make_segments(cyclic_ids) if cyclic_ids else []

    def make_seq_segments(records) -> List[Segment]:
        by_op: Dict[str, List[int]] = {}
        for i, r in enumerate(records):
            by_op.setdefault(r[0], []).append(i)
        segs = []
        for op, ids in sorted(by_op.items()):
            max_in = max(len(records[i][1]) for i in ids)
            max_out = max(len(records[i][2]) for i in ids)
            ins = np.zeros((len(ids), max(1, max_in)), np.int32)
            outs = np.zeros((len(ids), max(1, max_out)), np.int32)
            insts = []
            for k, i in enumerate(ids):
                _op, i_s, o_s, inst = records[i]
                ins[k, :len(i_s)] = i_s
                outs[k, :len(o_s)] = o_s
                insts.append(inst)
            segs.append(Segment(op=op, inputs=ins, outputs=outs,
                                instances=insts))
        return segs

    seq = make_seq_segments(seq_records)
    ticks = make_seq_segments(tick_records)
    tick_seg = ticks[0] if ticks else None

    # ---- mixed-signal arrays ------------------------------------------------
    samp_list = list(samp.values())
    ns = len(samp_list)
    samp_sig = np.array([r[0] for r in samp_list], np.int32)
    samp_ll = np.array([r[1] for r in samp_list], np.float64)
    samp_hl = np.array([r[2] for r in samp_list], np.float64)
    samp_nodes = [r[3] for r in samp_list]
    samp_tsu = np.array([r[4] for r in samp_list], np.float64)
    samp_th = np.array([r[5] for r in samp_list], np.float64)

    nd = len(drives)
    drv_sig = np.array([s for s, _, _, _ in drives], np.int32)
    drv_ll = np.array([ll for _, _, ll, _ in drives], np.float64)
    drv_hl = np.array([hl for _, _, _, hl in drives], np.float64)
    drv_nodes = [n for _, n, _, _ in drives]

    ir = DigitalIR(
        n_signals=n_signals, levels=levels, cyclic=cyclic, seq=seq,
        inputs=io_in, outputs=io_out, tick_delays=tick_seg,
        vmods=vmods,
        samp_sig=samp_sig, samp_node=np.zeros(ns, np.int32),
        samp_ll=samp_ll, samp_hl=samp_hl,
        samp_tsu=samp_tsu, samp_th=samp_th,
        drv_sig=drv_sig, drv_node=np.zeros(nd, np.int32),
        drv_ll=drv_ll, drv_hl=drv_hl,
        node_sig=node_sig,
    )
    # analog node indices are resolved later (after analog lowering
    # assigns node_index) via bind_analog_indices
    ir._samp_nodes = samp_nodes          # type: ignore[attr-defined]
    ir._drv_nodes = drv_nodes            # type: ignore[attr-defined]
    return ir


def bind_analog_indices(ir: DigitalIR):
    """Resolve sampled/driven Node objects to MNA node indices.  Must run
    after engine.lower.lower_analog has assigned node_index."""
    ir.samp_node = np.array(
        [max(n.node_index, -1) for n in ir._samp_nodes], np.int32) \
        if ir._samp_nodes else np.zeros(0, np.int32)
    ir.drv_node = np.array(
        [max(n.node_index, -1) for n in ir._drv_nodes], np.int32) \
        if ir._drv_nodes else np.zeros(0, np.int32)
    # analog pin nodes for analog-reading sequential devices
    for seg in ir.seq:
        if seg.op in ("SCHMITT", "CMP"):
            an = np.full((len(seg.instances),
                          max(1, seg.inputs.shape[1])), -1, np.int32)
            for i, inst in enumerate(seg.instances):
                for j, pi in enumerate(inst.mdef.din_pins):
                    node = inst.pins[pi].node
                    if node is not None and not node.is_ground:
                        an[i, j] = node.node_index
            seg.anodes = an
        # pack per-instance float params used inside the kernel
        if seg.op == "SCHMITT":
            seg.fparams = np.array(
                [[float(m.params["inverted"]), float(m.params["Vth_low"]),
                  float(m.params["Vth_high"])] for m in seg.instances])
        elif seg.op == "RANDOM4":
            seg.fparams = np.array(
                [[float(m.params.get("seed", 1.0))] for m in seg.instances])
