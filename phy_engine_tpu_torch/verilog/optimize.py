"""Netlist-level synthesis optimization passes (O1+).

The first tier of the reference's pe_synth pipeline
(pe_synth.h:17595-17625 pass gating): YES-wire removal, double-inverter
fusion, constant propagation (4-state-safe), structural hashing
(strash), and dead-code elimination — run to fixpoint.  The heavier
passes (QM/Espresso/resub/rewrite/decompose) live in opt_graph.py /
opt_map.py and are driven from here at O2+, budgeted by
:class:`PassBudgets`.

Passes operate directly on the gate netlist produced by synth.py.
Protected nets (ports) are never deleted; when a pass would merge into a
protected net it re-drives the protected node instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from ..netlist.netlist import Netlist, Node, ModelInstance
from ..netlist import operations as ops
from ..models.base import DeviceClass
from ..digital import logic

# opcodes that are pure combinational functions of their inputs
_PURE = {"AND", "OR", "XOR", "XNOR", "NAND", "NOR", "IMP", "NIMP",
         "CASE_EQ", "RESOLVE2", "NOT", "YES", "IS_UNKNOWN", "TRI",
         "HALF_ADDER", "FULL_ADDER", "HALF_SUBTRACTOR",
         "FULL_SUBTRACTOR", "MUL2"}
_COMMUTATIVE = {"AND", "OR", "XOR", "XNOR", "NAND", "NOR", "CASE_EQ",
                "RESOLVE2"}

_TABLES2 = {"AND": logic.AND_TABLE, "OR": logic.OR_TABLE,
            "XOR": logic.XOR_TABLE, "XNOR": logic.XNOR_TABLE,
            "NAND": logic.NAND_TABLE, "NOR": logic.NOR_TABLE,
            "IMP": logic.IMP_TABLE, "NIMP": logic.NIMP_TABLE,
            "RESOLVE2": logic.RESOLVE2_TABLE}
_TABLES1 = {"NOT": logic.NOT_TABLE, "YES": logic.YES_TABLE}


class OptStats:
    def __init__(self):
        self.removed_gates = 0
        self.merged_nets = 0
        self.folded_const = 0
        self.strashed = 0
        self.rebuilt = 0            # gates emitted by the O2 graph tier
        self.graph_gates_saved = 0  # gate-count delta from the O2 tier
        self.tt_merged = 0          # nodes merged by the O3 TT sweep
        self.qm_rewritten = 0       # cones rebuilt by O3 QM minimization
        self.omax_restarts = 0      # restarts executed by the Omax loop
        self.omax_best_cost = 0.0   # winning cost under the cost model
        self.omax_verify_rejected = 0  # candidates failing opt-verify
        self.adders_extracted = 0   # HA/FA macro blocks extracted
        self.mul2_extracted = 0     # MUL2 macro blocks extracted
        self.espresso_rewritten = 0  # cones covered by espresso (O3)
        self.rewrite_applied = 0    # cut-rewrite acceptances (O3+)
        self.resub_applied = 0      # resubstitution acceptances (O3+)
        self.dc_minterms = 0        # don't-care minterms mined (XZ/ODC)
        self.bdd_decomposed = 0     # cones split by functional decomp
        self.omax_trace = []        # (restart, stage, cost) telemetry
        self.omax_summary = ""      # one-line Omax report
        self.passes = []            # (pass, before, after, elapsed_us)
                                    # — pe_synth_report.passes parity
        self.rounds_rolled_back = 0  # graph-tier rounds undone because
                                     # the netlist netted out worse

    def total(self):
        return (self.removed_gates + self.merged_nets +
                self.folded_const + self.strashed +
                self.graph_gates_saved)


def _is_gate(inst: ModelInstance) -> bool:
    return (inst.mdef.device_class == DeviceClass.DIGITAL and
            inst.mdef.digital_op in _PURE)


def _in_nodes(inst):
    return [inst.pins[i].node for i in inst.mdef.din_pins]


def _out_nodes(inst):
    return [inst.pins[i].node for i in inst.mdef.dout_pins]


def _readers(node: Node):
    """Input pins attached to this net."""
    out = []
    for pin in node.pins:
        if pin.index in pin.model.mdef.din_pins:
            out.append(pin)
    return out


def _drivers(node: Node):
    out = []
    for pin in node.pins:
        if pin.index in pin.model.mdef.dout_pins:
            out.append(pin)
    return out


def _const_code(inst: ModelInstance) -> Optional[int]:
    """INPUT devices created as constants by the synthesizer.

    Only synthesizer-tagged constants qualify — a plain INPUT is a
    runtime-settable external pin and must never be folded."""
    if inst.mdef.digital_op == "INPUT" and \
            inst.params.get("synth_const"):
        return int(inst.params.get("boolean", 2)) & 3
    return None


def _net_const(node: Node) -> Optional[int]:
    drv = _drivers(node)
    if len(drv) != 1:
        return None
    return _const_code(drv[0].model)


def _present(nl: Netlist, inst: ModelInstance) -> bool:
    pos = getattr(inst, "_pos", -1)
    return 0 <= pos < len(nl.models) and nl.models[pos] is inst


def dce(nl: Netlist, protected: Set[int], stats: OptStats) -> bool:
    """Remove gates (and FFs) whose every output is unread+unprotected.

    Worklist form (round-5 perf): deleting a gate enqueues the drivers
    of its fanin nets, so a dead CONE peels in one pass instead of one
    netlist-wide fixpoint round per logic level (the round-4 shape was
    the dominant -Omax cost on deep designs).  Fixpoint semantics are
    identical: gates on dead feedback cycles still survive (each reads
    the other), exactly as under the per-round rule."""
    from collections import deque
    changed = False
    removable: Dict[int, ModelInstance] = {}
    for inst in nl.live_models():
        if inst.mdef.device_class != DeviceClass.DIGITAL:
            continue
        if inst.mdef.digital_op in ("OUTPUT", "OUTPUT8", "VERILOG"):
            continue
        if not inst.mdef.dout_pins:
            continue
        removable[id(inst)] = inst
    work = deque(removable.values())
    queued = set(removable)
    while work:
        inst = work.popleft()
        queued.discard(id(inst))
        if not _present(nl, inst):
            continue
        outs = [inst.pins[i].node for i in inst.mdef.dout_pins]
        dead = True
        for n in outs:
            if n is None:
                continue
            if id(n) in protected or _readers(n) or \
                    n.num_of_analog_node > 0:
                dead = False
                break
        if not dead:
            continue
        fanins = [inst.pins[i].node for i in inst.mdef.din_pins]
        dead_nets = [n for n in outs if n is not None]
        ops.delete_model(nl, inst)
        for n in dead_nets:
            if not n.pins:
                ops.drop_node(nl, n)
        stats.removed_gates += 1
        changed = True
        for n in fanins:
            if n is None:
                continue
            for pin in n.pins:
                drv = pin.model
                if id(drv) in removable and id(drv) not in queued:
                    work.append(drv)
                    queued.add(id(drv))
    return changed


def yes_fuse(nl: Netlist, protected: Set[int], stats: OptStats) -> bool:
    """Remove YES buffers by merging their nets (yes-wire removal)."""
    changed = False
    for inst in list(nl.live_models()):
        if inst.mdef.digital_op != "YES":
            continue
        a = inst.pins[0].node
        b = inst.pins[1].node
        if a is None or b is None or a is b:
            continue
        if a.num_of_analog_node > 0 or b.num_of_analog_node > 0:
            continue
        # b must have no other driver
        if len(_drivers(b)) != 1:
            continue
        if id(b) in protected and id(a) in protected:
            continue
        if id(b) in protected:
            # merge a into b: move a's pins onto b (b's node survives)
            ops.delete_model(nl, inst)
            if len(_drivers(a)) == 0 and id(a) not in protected and \
                    _net_const(a) is None:
                pass
            ops.merge_node(nl, b, a)
        else:
            ops.delete_model(nl, inst)
            ops.merge_node(nl, a, b)
        stats.removed_gates += 1
        stats.merged_nets += 1
        changed = True
    return changed


def not_fuse(nl: Netlist, protected: Set[int], stats: OptStats) -> bool:
    """NOT(NOT(x)) -> x (double-inverter fusion)."""
    changed = False
    for inst in list(nl.live_models()):
        if inst.mdef.digital_op != "NOT":
            continue
        mid = inst.pins[1].node
        if mid is None or id(mid) in protected or \
                mid.num_of_analog_node > 0:
            continue
        readers = _readers(mid)
        if not readers or any(r.model.mdef.digital_op != "NOT"
                              for r in readers):
            continue
        src = inst.pins[0].node
        if src is None:
            continue
        # every reader is a second NOT: bypass both
        for r in list(readers):
            second = r.model
            out2 = second.pins[1].node
            if out2 is None:
                continue
            ops.delete_model(nl, second)
            if id(out2) in protected or out2.num_of_analog_node > 0:
                # re-drive protected net with a YES from src
                from ..models import YES
                g = ops.add_model(nl, YES)
                ops.add_to_node(nl, g, 0, src)
                ops.add_to_node(nl, g, 1, out2)
            else:
                ops.merge_node(nl, src, out2)
            stats.removed_gates += 1
            changed = True
    return changed


def const_prop(nl: Netlist, protected: Set[int], stats: OptStats) -> bool:
    """Fold gates whose inputs are all constant nets (4-state-safe).

    Constant nets are precomputed in one sweep over the models —
    per-net _drivers() scans are O(fanout), which explodes on the
    shared constant nets of large designs (100k+ reader pins)."""
    from ..models import INPUT
    changed = False
    live = list(nl.live_models())
    drv_count: Dict[int, int] = {}
    for inst in live:
        for i in inst.mdef.dout_pins:
            n = inst.pins[i].node
            if n is not None:
                drv_count[id(n)] = drv_count.get(id(n), 0) + 1
    const_of: Dict[int, int] = {}
    for inst in live:
        code = _const_code(inst)
        if code is not None:
            n = inst.pins[0].node
            if n is not None and drv_count.get(id(n), 0) == 1:
                const_of[id(n)] = code
    # worklist (round-5 perf): folding a gate can make its output net
    # constant, which re-enables its readers — so constant CONES fold
    # in one pass instead of one netlist-wide round per logic level.
    # drv_count/const_of are maintained incrementally; anything this
    # bookkeeping conservatively misses is caught by the caller's
    # round loop exactly as under the per-round rule.
    from collections import deque
    gates = [inst for inst in live if _is_gate(inst)]
    work = deque(gates)
    queued = {id(i) for i in gates}
    while work:
        inst = work.popleft()
        queued.discard(id(inst))
        if not _present(nl, inst):
            continue
        op = inst.mdef.digital_op
        ins = _in_nodes(inst)
        if any(n is None for n in ins):
            continue
        codes = [const_of.get(id(n)) for n in ins]
        if any(c is None for c in codes):
            continue
        outs = _out_nodes(inst)
        out_codes = _eval_const(op, codes)
        if out_codes is None:
            continue
        ops.delete_model(nl, inst)
        for n in outs:
            if n is not None:
                drv_count[id(n)] = drv_count.get(id(n), 1) - 1
        for n, code in zip(outs, out_codes):
            if n is None:
                continue
            src = ops.add_model(nl, INPUT, {"boolean": float(code),
                                            "synth_const": 1.0})
            ops.add_to_node(nl, src, 0, n)
            drv_count[id(n)] = drv_count.get(id(n), 0) + 1
            if drv_count[id(n)] == 1:
                const_of[id(n)] = code
                for pin in n.pins:
                    rdr = pin.model
                    if pin.index in rdr.mdef.din_pins and \
                            _is_gate(rdr) and id(rdr) not in queued:
                        work.append(rdr)
                        queued.add(id(rdr))
            else:
                const_of.pop(id(n), None)
        stats.folded_const += 1
        changed = True
    return changed


def _eval_const(op: str, codes: List[int]) -> Optional[List[int]]:
    import numpy as np
    U32 = np.uint32

    def pl(c):
        return U32(c & 1), U32((c >> 1) & 1)

    def code(v, u):
        return (int(v) & 1) | ((int(u) & 1) << 1)

    if op in _TABLES1:
        return [int(_TABLES1[op][codes[0]])]
    if op in _TABLES2:
        return [int(_TABLES2[op][codes[0], codes[1]])]
    if op == "XNOR":
        return [int(logic.XNOR_TABLE[codes[0], codes[1]])]
    if op == "IS_UNKNOWN":
        return [1 if codes[0] >= 2 else 0]
    if op == "CASE_EQ":
        return [1 if codes[0] == codes[1] else 0]
    if op == "TRI":
        va, ua = pl(codes[0])
        vb, ub = pl(codes[1])
        v, u = logic.op_tri_state(va, ua, vb, ub)
        return [code(v, u)]
    if op == "HALF_ADDER":
        a, b = codes
        s = int(logic.XOR_TABLE[a, b])
        c = int(logic.AND_TABLE[a, b])
        return [s, c]
    if op == "FULL_ADDER":
        a, b, ci = codes
        x = int(logic.XOR_TABLE[a, b])
        s = int(logic.XOR_TABLE[x, ci])
        c1 = int(logic.AND_TABLE[a, b])
        c2 = int(logic.AND_TABLE[ci, x])
        return [s, int(logic.OR_TABLE[c1, c2])]
    return None


def strash(nl: Netlist, protected: Set[int], stats: OptStats) -> bool:
    """Structural hashing: merge gates with identical op + input nets."""
    from ..models import YES
    changed = False
    seen: Dict[Tuple, ModelInstance] = {}
    for inst in list(nl.live_models()):
        if not _is_gate(inst) or inst.mdef.digital_op == "TRI":
            continue
        ins = _in_nodes(inst)
        if any(n is None for n in ins):
            continue
        # gates with a disconnected output are zombies awaiting DCE —
        # neither canonical nor mergeable (merging a live gate into one
        # would drop the live gate's net drivers)
        if any(n is None for n in _out_nodes(inst)):
            continue
        key_ids = [id(n) for n in ins]
        if inst.mdef.digital_op in _COMMUTATIVE:
            key_ids = sorted(key_ids)
        key = (inst.mdef.digital_op, tuple(key_ids))
        first = seen.get(key)
        if first is None:
            seen[key] = inst
            continue
        # merge inst's outputs onto first's
        f_outs = _out_nodes(first)
        i_outs = _out_nodes(inst)
        ops.delete_model(nl, inst)
        for fo, io in zip(f_outs, i_outs):
            if io is None or fo is None or fo is io:
                continue
            if id(io) in protected or io.num_of_analog_node > 0:
                g = ops.add_model(nl, YES)
                ops.add_to_node(nl, g, 0, fo)
                ops.add_to_node(nl, g, 1, io)
            else:
                ops.merge_node(nl, fo, io)
        stats.strashed += 1
        changed = True
    return changed


@dataclass
class PassBudgets:
    """Per-pass budgets, DC-inference gates, and growth guards
    (pe_synth_options:146-186 role: qm_max_*/resub_max_*/sweep_max_*/
    rewrite_max_candidates/decomp_*/infer_dc_from_*/dc_fsm_max_bits/
    max_total_*).  Field defaults are the pipeline's tuned values;
    per the reference convention a 0 budget disables that pass family.
    The budget axes map onto THIS pipeline's pass structure: our sweep/
    resub are global signature passes (bounded by pair/target counts,
    with exhaustive proofs over joint supports) rather than the
    reference's fixed truth-table windows."""
    qm_max_vars: int = 14          # output-cone 2-level max support
    qm_exact_vars: int = 10        # exhaustive QM+Petrick at/below this
    qm_max_gates: int = 300        # max gates per minimized cone
    qm_max_targets: int = 4000     # internal-SOP targets per round
    sop_max_vars: int = 10         # internal-cone SOP window
    resub_max_targets: int = 3000  # 0 disables resub
    resub_max_divisors: int = 20
    sweep_max_pairs: int = 4000    # 0 disables the equivalence sweep
    rewrite_max_candidates: int = 0  # 0 = unlimited candidate roots
    techmap_max_cut: int = 4       # cut size for rewrite/mapping
    decomp_min_vars: int = 9       # functional decomposition window
    decomp_max_vars: int = 14      # 0 disables decomposition
    infer_dc_from_xz: bool = True
    infer_dc_from_fsm: bool = True
    infer_dc_from_odc: bool = True
    dc_fsm_max_bits: int = 16      # max tagged state bits per cone
    max_total_models: int = 0      # growth guards; 0 disables
    max_total_logic_gates: int = 0


def optimize_netlist(nl: Netlist, protected_nodes, level: int = 1,
                     max_rounds: int = 50,
                     binary_ok: bool = False,
                     omax: Optional[dict] = None,
                     wires: bool = True,
                     adders: bool = True,
                     mul2: bool = True,
                     budgets: Optional[PassBudgets] = None) -> OptStats:
    """Run the optimization pipeline to fixpoint.

    O1: netlist-local passes (const-prop, YES/NOT fusion, strash, DCE).
    O2+: adds the gate-graph tier (tree factoring, XOR extraction,
    primitive selection — opt_graph.optimize_o2) between O1 fixpoints.
    """
    stats = OptStats()
    if level <= 0:
        return stats
    protected = {id(n) for n in protected_nodes}

    def o1_fixpoint():
        for _ in range(max_rounds):
            changed = False
            changed |= const_prop(nl, protected, stats)
            if wires:
                changed |= yes_fuse(nl, protected, stats)
            changed |= not_fuse(nl, protected, stats)
            changed |= strash(nl, protected, stats)
            changed |= dce(nl, protected, stats)
            if not changed:
                return

    o1_fixpoint()
    bgt = budgets or PassBudgets()
    if level >= 2:
        from .opt_graph import optimize_o2
        tt = level >= 3 and binary_ok

        # The graph tier decides improvement on its *extracted
        # subgraph* metric, which can diverge from the real netlist
        # model count (emit loses cross-region sharing that only the
        # following O1 fixpoint partially recovers), and a round that
        # inflates the netlist can still unlock a better final state
        # one round later.  So: let every round run, snapshot the
        # best-seen netlist (identity-preserving, so the caller's
        # port/model references survive a restore), and restore the
        # best at the end — QoR is then monotone in level.
        # the rollback metric is the reference's own optimization cost
        # (count_logic_gates, pe_synth.h:420-437): pure logic ops only —
        # macro blocks (adders/MUL2/FF/latch) are free, exactly as in
        # the reference's per-pass accounting; model bloat is bounded
        # separately by max_total_models
        _LOGIC = ("AND", "OR", "XOR", "XNOR", "NOT", "NAND", "NOR",
                  "IMP", "NIMP", "YES")

        def gate_count():
            return sum(1 for m in nl.live_models()
                       if m.mdef.digital_op in _LOGIC)

        best_count = gate_count()
        best_snap = nl.state_save()

        def consider() -> None:
            nonlocal best_count, best_snap
            c = gate_count()
            if c < best_count:
                best_count, best_snap = c, nl.state_save()

        # At O3+ macro extraction and the truth-table passes compete
        # both ways: extraction can claim a web the TT sweep would have
        # collapsed to almost nothing (the resub_sweep XOR-parity case
        # — an adder-SUM-shaped SOP that espresso reduces to 2 gates),
        # and the TT sweep can rewrite a web extraction would have made
        # free (the digit-lowered mul8x8 MUL2 case).  Neither order
        # dominates, so run BOTH from the same O1 state and let the
        # best-logic-gate snapshot pick the winner — QoR is then
        # monotone across levels by construction.
        seeded = True
        if tt:
            snap0 = nl.state_save()
            # order A: TT rounds with no macro pre-claim
            for _ in range(2):
                if not optimize_o2(nl, protected, stats, binary_ok,
                                   tt_passes=True, adders=adders,
                                   mul2=mul2, budgets=bgt):
                    break
                o1_fixpoint()
                consider()
            # order B: rewind, seed one O2-grade (macro-claiming) round,
            # then fall through to the TT rounds below
            nl.state_restore(snap0)
            seeded = optimize_o2(nl, protected, stats, binary_ok,
                                 tt_passes=False, adders=adders,
                                 mul2=mul2, budgets=bgt)
            if seeded:
                o1_fixpoint()
                consider()
            else:
                # no macros to claim: the netlist equals snap0, so the
                # generic loop below would deterministically replay
                # order A — skip it and continue from order A's best.
                # Re-save after restoring: state_restore aliases the
                # snapshot's param dicts into the live models, so the
                # same snapshot must not be restored twice around
                # further mutation (the omax tail + final rollback).
                nl.state_restore(best_snap)
                best_snap = nl.state_save()

        # two rounds at every tier: the emit + O1-fixpoint between
        # graph rounds unlocks reductions a single pass misses
        # (observed 2431 -> 2224 on the atomic-vector-assign case)
        if seeded:
            for _ in range(2):
                if not optimize_o2(nl, protected, stats, binary_ok,
                                   tt_passes=tt, adders=adders,
                                   mul2=mul2, budgets=bgt):
                    break
                o1_fixpoint()
                consider()
        if level >= 4:
            # the multi-start search runs after (and competes against)
            # the O3 result: omax re-extracts the current netlist as
            # its base cost and emits only strict improvements
            from .opt_graph import optimize_omax
            if optimize_omax(nl, protected, stats, binary_ok,
                             adders=adders, mul2=mul2, budgets=bgt,
                             **(omax or {})):
                o1_fixpoint()
                consider()
        # growth guards (max_total_* rollback role, pe_synth.h:178-181):
        # the best-seen snapshot is restored whenever the final netlist
        # regressed or breached a cap the best still satisfies
        def n_models():
            return sum(1 for _ in nl.live_models())
        exceeded = (
            (bgt.max_total_logic_gates and
             gate_count() > bgt.max_total_logic_gates) or
            (bgt.max_total_models and
             n_models() > bgt.max_total_models))
        if gate_count() > best_count or exceeded:
            nl.state_restore(best_snap)
            stats.rounds_rolled_back += 1
    return stats
