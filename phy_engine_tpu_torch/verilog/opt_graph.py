"""Gate-graph IR for the heavier synthesis optimization tiers (O2+).

The reference runs its O2..O4 passes (AND/OR tree flatten + absorption +
factoring, XOR extraction, primitive selection, truth-table
resubstitution / sweep, Quine-McCluskey two-level minimization —
pe_synth.h:17595-17625 pass gating) on its own in-memory gate structure
rather than on the netlist arenas.  This module does the same: extract
the pure-combinational core of the gate netlist into an index-based DAG,
optimize it, and re-emit gates.  (The port's copy of the JAX package's
``verilog/opt_graph.py``, pass for pass, with the mesh-sharded
equivalence check ``graphs_equivalent(mesh=...)`` over the port's
``parallel/tt_mesh.py``; the JAX package's optional verify mesh,
``PE_TPU_SYNTH_VERIFY_MESH``, is left out.)

4-state discipline: passes in `safe` mode use only Kleene-algebra
identities that hold for X/Z (associativity, commutativity, absorption,
idempotence, De Morgan, constant identities, structural XOR recognition).
Truth-table passes (resub, QM) assume binary-valued inputs and run only
when ``assume_binary_inputs`` is enabled (the reference exposes the same
relaxation switch, pe_synth.h options).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

# combinational single-output ops handled by the graph
_GRAPH_OPS = {"AND", "OR", "XOR", "XNOR", "NAND", "NOR", "IMP", "NIMP",
              "NOT", "YES"}
# ops whose output is a pure function usable as a *leaf* but whose body
# we do not touch (multi-driver / tri-state / X-introspection semantics)
CONST0, CONST1, CONSTX = -2, -3, -4
# macro block ops: graph node -> (block model, output pin index)
_MACRO_PINS = {"FA_S": 3, "FA_C": 4, "HA_S": 2, "HA_C": 3,
               "M2_P0": 4, "M2_P1": 5, "M2_P2": 6, "M2_P3": 7}


@dataclass
class GNode:
    op: str                   # PIN | CONST | gate op
    fanins: Tuple[int, ...] = ()
    # for PIN leaves: the Node object this leaf reads
    net: object = None
    const: int = 0            # for CONST: 4-state code


class GateGraph:
    def __init__(self):
        self.nodes: List[GNode] = []
        # protected output net -> graph index driving it
        self.outputs: Dict[int, Tuple[object, int]] = {}
        self._leaf_by_net: Dict[int, int] = {}
        self._const_idx: Dict[int, int] = {}

    # ---- construction -----------------------------------------------------
    def leaf(self, net) -> int:
        key = id(net)
        if key not in self._leaf_by_net:
            self.nodes.append(GNode("PIN", (), net))
            self._leaf_by_net[key] = len(self.nodes) - 1
        return self._leaf_by_net[key]

    def const(self, code: int) -> int:
        if code not in self._const_idx:
            self.nodes.append(GNode("CONST", (), None, code))
            self._const_idx[code] = len(self.nodes) - 1
        return self._const_idx[code]

    def gate(self, op: str, *fanins: int) -> int:
        self.nodes.append(GNode(op, tuple(fanins)))
        return len(self.nodes) - 1

    def set_output(self, net, idx: int):
        self.outputs[id(net)] = (net, idx)

    # ---- queries ----------------------------------------------------------
    def fanout_counts(self) -> List[int]:
        cnt = [0] * len(self.nodes)
        for n in self.nodes:
            for f in n.fanins:
                cnt[f] += 1
        for _, idx in self.outputs.values():
            cnt[idx] += 1
        return cnt

    def live_set(self) -> Set[int]:
        seen: Set[int] = set()
        stack = [idx for _, idx in self.outputs.values()]
        while stack:
            i = stack.pop()
            if i in seen:
                continue
            seen.add(i)
            stack.extend(self.nodes[i].fanins)
        return seen

    def gate_count(self) -> int:
        live = self.live_set()
        return sum(1 for i in live
                   if self.nodes[i].op not in ("PIN", "CONST"))


# ---------------------------------------------------------------------------
# extraction from / emission to the netlist
# ---------------------------------------------------------------------------

def extract(nl, protected_ids: Set[int]) -> Optional[GateGraph]:
    """Build a GateGraph from the combinational gates of ``nl``.

    A net is a graph *boundary* (leaf or output) if it is protected, has
    a non-graph driver (FF, INPUT, TRI, ...), feeds a non-graph reader,
    or touches the analog side.  Returns None if there is nothing to do.
    """
    from ..models.base import DeviceClass

    gate_of_net: Dict[int, object] = {}    # net id -> driving gate inst
    graph_gates = []
    for inst in nl.live_models():
        if inst.mdef.device_class != DeviceClass.DIGITAL:
            continue
        if inst.mdef.digital_op in _GRAPH_OPS:
            outs = [inst.pins[i].node for i in inst.mdef.dout_pins]
            if len(outs) != 1 or outs[0] is None:
                continue
            ins = [inst.pins[i].node for i in inst.mdef.din_pins]
            if any(n is None for n in ins):
                continue
            # multi-driven output nets are boundaries, skip their driver
            graph_gates.append(inst)
            gate_of_net[id(outs[0])] = inst

    if not graph_gates:
        return None

    # nets with >1 driver or external readers stay as boundaries
    from .optimize import _drivers, _readers, _net_const

    g = GateGraph()
    g._net_cache = {}
    building: Set[int] = set()

    # boundary-output nets: graph-gate-driven nets that the outside
    # world observes (protected, non-graph reader, analog-coupled).
    # Cones stop at these so shared logic is referenced, not duplicated.
    out_nets = {}
    for inst in graph_gates:
        onet = inst.pins[inst.mdef.dout_pins[0]].node
        key = id(onet)
        if len(_drivers(onet)) != 1:
            continue                    # multi-driven: left in place
        ext = (key in protected_ids or onet.num_of_analog_node > 0 or
               any(r.model.mdef.digital_op not in _GRAPH_OPS
                   for r in _readers(onet)))
        if ext:
            out_nets[key] = onet

    def build_net(net, root=False) -> int:
        key = id(net)
        if not root and key in out_nets:
            return g.leaf(net)
        inst = gate_of_net.get(key)
        if inst is None:
            code = _net_const(net)
            if code is not None:
                return g.const(code)
            return g.leaf(net)
        if len(_drivers(net)) != 1 or net.num_of_analog_node > 0:
            return g.leaf(net)
        if key in building:            # combinational loop: cut here
            return g.leaf(net)
        if key in g._net_cache:
            return g._net_cache[key]
        building.add(key)
        ins = [inst.pins[i].node for i in inst.mdef.din_pins]
        fi = [build_net(n) for n in ins]
        building.discard(key)
        idx = g.gate(inst.mdef.digital_op, *fi)
        if not root:
            g._net_cache[key] = idx
        return idx

    for key, onet in out_nets.items():
        g.set_output(onet, build_net(onet, root=True))
    if not g.outputs:
        return None
    return g


def emit(nl, g: GateGraph, stats) -> None:
    """Replace the extracted combinational core of ``nl`` with ``g``.

    Old graph gates whose outputs become dangling are swept by the O1
    DCE pass that runs after emission.
    """
    from ..netlist import operations as ops
    from .. import models as M

    MODEL = {"AND": M.AND, "OR": M.OR, "XOR": M.XOR, "XNOR": M.XNOR,
             "NAND": M.NAND, "NOR": M.NOR, "IMP": M.IMP, "NIMP": M.NIMP,
             "NOT": M.NOT, "YES": M.YES}
    macro_insts: Dict[Tuple, object] = {}

    live = g.live_set()
    order = _toposort(g, live)
    net_of: Dict[int, object] = {}
    # pre-bind output nets to their driving gate; when two outputs share
    # a gate (or an output is a leaf/const) the extras get YES buffers
    bound: Dict[int, object] = {}
    for _, (net, idx) in g.outputs.items():
        if idx not in bound and g.nodes[idx].op not in ("PIN", "CONST"):
            bound[idx] = net

    def netf(i) -> object:
        n = g.nodes[i]
        if n.op == "PIN":
            return n.net
        if i in net_of:
            return net_of[i]
        if n.op == "CONST":
            inp = ops.add_model(nl, M.INPUT,
                                {"boolean": float(n.const),
                                 "synth_const": 1.0})
            node = ops.create_node(nl)
            ops.add_to_node(nl, inp, 0, node)
            net_of[i] = node
            return node
        return net_of[i]

    for i in order:
        n = g.nodes[i]
        if n.op in ("PIN", "CONST"):
            continue
        out_net = bound.get(i)
        if out_net is None:
            out_net = ops.create_node(nl)
        # disconnect the old driver of a reused output net
        for pin in list(out_net.pins):
            if pin.index in pin.model.mdef.dout_pins:
                ops.remove_from_node(nl, pin.model, pin.index)
        if n.op in _MACRO_PINS:
            kind = n.op.split("_")[0]
            mkey = (kind, n.fanins)
            minst = macro_insts.get(mkey)
            if minst is None:
                mdl = {"FA": M.FULL_ADDER, "HA": M.HALF_ADDER,
                       "M2": M.MUL2}[kind]
                minst = ops.add_model(nl, mdl)
                for k, fi in enumerate(n.fanins):
                    ops.add_to_node(nl, minst, k, netf(fi))
                macro_insts[mkey] = minst
                stats.rebuilt += 1
            ops.add_to_node(nl, minst, _MACRO_PINS[n.op], out_net)
            net_of[i] = out_net
            continue
        inst = ops.add_model(nl, MODEL[n.op])
        for k, fi in enumerate(n.fanins):
            ops.add_to_node(nl, inst, k, netf(fi))
        ops.add_to_node(nl, inst, len(n.fanins), out_net)
        net_of[i] = out_net
        stats.rebuilt += 1

    # outputs that alias another output's gate: YES-buffer them
    for _, (net, idx) in g.outputs.items():
        if bound.get(idx) is not net:
            src = netf(idx)
            if src is net:
                continue
            buf = ops.add_model(nl, M.YES)
            ops.add_to_node(nl, buf, 0, src)
            ops.add_to_node(nl, buf, 1, net)
            for pin in list(net.pins):
                if (pin.model is not buf and
                        pin.index in pin.model.mdef.dout_pins):
                    ops.remove_from_node(nl, pin.model, pin.index)


def _toposort(g: GateGraph, live: Set[int]) -> List[int]:
    order: List[int] = []
    state: Dict[int, int] = {}

    for root in live:
        stack = [(root, 0)]
        while stack:
            i, phase = stack.pop()
            if phase == 0:
                if state.get(i):
                    continue
                state[i] = 1
                stack.append((i, 1))
                for f in g.nodes[i].fanins:
                    if not state.get(f):
                        stack.append((f, 0))
            else:
                if state[i] != 2:
                    state[i] = 2
                    order.append(i)
    return order


# ---------------------------------------------------------------------------
# O2+ passes
# ---------------------------------------------------------------------------
# Normalization: every gate is rewritten over {AND, OR, NOT, XOR} so the
# algebraic passes see one uniform system; primitive_select re-introduces
# the composite primitives (NAND/NOR/XNOR/IMP/NIMP) afterwards, mirroring
# the reference's input-inverter push / primitive selection pass.

_X = 2


class _Builder:
    """Hash-consed AND/OR/NOT/XOR graph builder with local Kleene-safe
    simplification applied at construction time."""

    def __init__(self, binary_ok: bool):
        self.nodes: List[GNode] = []
        self.cache: Dict[Tuple, int] = {}
        self.binary_ok = binary_ok
        self._const: Dict[int, int] = {}

    def const(self, code: int) -> int:
        if code not in self._const:
            self.nodes.append(GNode("CONST", (), None, code))
            self._const[code] = len(self.nodes) - 1
        return self._const[code]

    def leaf(self, net) -> int:
        key = ("PIN", id(net))
        if key not in self.cache:
            self.nodes.append(GNode("PIN", (), net))
            self.cache[key] = len(self.nodes) - 1
        return self.cache[key]

    def _raw(self, op: str, *fi: int) -> int:
        if op in ("AND", "OR", "XOR"):
            fi = tuple(sorted(fi))
        key = (op,) + tuple(fi)
        if key not in self.cache:
            self.nodes.append(GNode(op, tuple(fi)))
            self.cache[key] = len(self.nodes) - 1
        return self.cache[key]

    def const_of(self, i: int) -> Optional[int]:
        n = self.nodes[i]
        return n.const if n.op == "CONST" else None

    def NOT(self, a: int) -> int:
        n = self.nodes[a]
        if n.op == "NOT":
            return n.fanins[0]
        c = self.const_of(a)
        if c is not None:
            from ..digital import logic
            return self.const(int(logic.NOT_TABLE[c]))
        return self._raw("NOT", a)

    def _is_not_of(self, a: int, b: int) -> bool:
        """True if a == NOT(b) structurally."""
        n = self.nodes[a]
        return n.op == "NOT" and n.fanins[0] == b

    def AND(self, a: int, b: int) -> int:
        ca, cb = self.const_of(a), self.const_of(b)
        if ca is not None and cb is not None:
            from ..digital import logic
            return self.const(int(logic.AND_TABLE[ca, cb]))
        for c, x in ((ca, b), (cb, a)):
            if c == 0:
                return self.const(0)
            if c == 1:
                return x
            if c is not None:          # X/Z constant input
                pass
        if a == b:
            return a
        if self.binary_ok and (self._is_not_of(a, b) or
                               self._is_not_of(b, a)):
            return self.const(0)
        # absorption: AND(a, OR(a, x)) = a
        for u, v in ((a, b), (b, a)):
            nv = self.nodes[v]
            if nv.op == "OR" and u in nv.fanins:
                return u
        return self._raw("AND", a, b)

    def OR(self, a: int, b: int) -> int:
        ca, cb = self.const_of(a), self.const_of(b)
        if ca is not None and cb is not None:
            from ..digital import logic
            return self.const(int(logic.OR_TABLE[ca, cb]))
        for c, x in ((ca, b), (cb, a)):
            if c == 1:
                return self.const(1)
            if c == 0:
                return x
        if a == b:
            return a
        if self.binary_ok and (self._is_not_of(a, b) or
                               self._is_not_of(b, a)):
            return self.const(1)
        for u, v in ((a, b), (b, a)):
            nv = self.nodes[v]
            if nv.op == "AND" and u in nv.fanins:
                return u
        return self._raw("OR", a, b)

    def XOR(self, a: int, b: int) -> int:
        ca, cb = self.const_of(a), self.const_of(b)
        if ca is not None and cb is not None:
            from ..digital import logic
            return self.const(int(logic.XOR_TABLE[ca, cb]))
        for c, x in ((ca, b), (cb, a)):
            if c == 0:
                return x
            if c == 1:
                return self.NOT(x)
        if self.binary_ok:
            if a == b:
                return self.const(0)
            if self._is_not_of(a, b) or self._is_not_of(b, a):
                return self.const(1)
        return self._raw("XOR", a, b)


def _normalize(g: GateGraph, bld: _Builder) -> Dict[int, int]:
    """Rewrite g over {AND,OR,NOT,XOR} into bld; returns old->new map."""
    mp: Dict[int, int] = {}
    for i in _toposort(g, g.live_set()):
        n = g.nodes[i]
        if n.op == "PIN":
            mp[i] = bld.leaf(n.net)
        elif n.op == "CONST":
            mp[i] = bld.const(n.const)
        else:
            f = [mp[x] for x in n.fanins]
            if n.op == "AND":
                mp[i] = bld.AND(*f)
            elif n.op == "OR":
                mp[i] = bld.OR(*f)
            elif n.op == "XOR":
                mp[i] = bld.XOR(*f)
            elif n.op == "XNOR":
                mp[i] = bld.NOT(bld.XOR(*f))
            elif n.op == "NAND":
                mp[i] = bld.NOT(bld.AND(*f))
            elif n.op == "NOR":
                mp[i] = bld.NOT(bld.OR(*f))
            elif n.op == "IMP":
                mp[i] = bld.OR(bld.NOT(f[0]), f[1])
            elif n.op == "NIMP":
                mp[i] = bld.AND(f[0], bld.NOT(f[1]))
            elif n.op in ("NOT",):
                mp[i] = bld.NOT(f[0])
            elif n.op == "YES":
                mp[i] = f[0]
            else:
                raise AssertionError(n.op)
    return mp


def _collect_tree(bld: _Builder, i: int, op: str, fanout, out: List[int],
                  top: bool = False):
    """Flatten same-op trees through *private* (fanout<=1) interior
    nodes; nodes created after the fanout snapshot count as private."""
    n = bld.nodes[i]
    if n.op == op and (top or fanout.get(i, 1) <= 1):
        for f in n.fanins:
            _collect_tree(bld, f, op, fanout, out)
    else:
        out.append(i)


def _factor_pass(bld: _Builder, roots: List[int]) -> Dict[int, int]:
    """Single-literal common-factor extraction over OR-of-AND /
    AND-of-OR trees (distributivity — Kleene-safe), plus XOR
    recognition.  Returns a replacement map applied by re-normalizing."""
    fanout: Dict[int, int] = {}
    for n in bld.nodes:
        for f in n.fanins:
            fanout[f] = fanout.get(f, 0) + 1
    for r in roots:
        fanout[r] = fanout.get(r, 0) + 1

    repl: Dict[int, int] = {}
    done: Set[int] = set()

    def walk(i: int) -> int:
        while i in repl and repl[i] != i:
            i = repl[i]
        if i in done:
            return i
        n = bld.nodes[i]
        if n.op in ("PIN", "CONST"):
            return i
        f = [walk(x) for x in n.fanins]
        if n.op == "NOT":
            out = bld.NOT(f[0])
        elif n.op == "XOR":
            out = bld.XOR(*f)
        elif n.op in ("AND", "OR"):
            dual = "OR" if n.op == "AND" else "AND"
            cur = bld._raw(n.op, *f)
            terms: List[int] = []
            _collect_tree(bld, cur, n.op, fanout, terms, top=True)
            terms = [walk(t) for t in terms]
            # dedup (idempotence)
            seen = []
            for t in terms:
                if t not in seen:
                    seen.append(t)
            terms = seen
            # XOR recognition on 2-term OR-of-ANDs
            if n.op == "OR" and len(terms) == 2:
                x = _match_xor(bld, terms[0], terms[1])
                if x is not None:
                    repl[i] = x
                    done.add(x)
                    return x
            # common single literal among dual-op terms
            if len(terms) >= 2:
                lit = _common_literal(bld, terms, dual, fanout)
                if lit is not None:
                    rest = [_strip_literal(bld, t, lit, dual, fanout)
                            for t in terms]
                    inner = rest[0]
                    for t in rest[1:]:
                        inner = (bld.AND(inner, t) if n.op == "AND"
                                 else bld.OR(inner, t))
                    out = (bld.OR(lit, inner) if dual == "OR"
                           else bld.AND(lit, inner))
                    repl[i] = out
                    done.add(out)
                    return out
            out = terms[0]
            for t in terms[1:]:
                out = bld.AND(out, t) if n.op == "AND" else bld.OR(out, t)
        else:
            out = i
        repl[i] = out
        done.add(out)
        return out

    for r in roots:
        walk(r)
    return repl


def _group_lits(bld: _Builder, t: int, dual: str, fanout) -> List[int]:
    n = bld.nodes[t]
    if n.op != dual:
        return [t]
    out: List[int] = []
    _collect_tree(bld, t, dual, fanout, out, top=True)
    return out


def _common_literal(bld: _Builder, terms: List[int], dual: str,
                    fanout) -> Optional[int]:
    """A literal present in every term (terms are dual-op groups)."""
    common = set(_group_lits(bld, terms[0], dual, fanout))
    for t in terms[1:]:
        common &= set(_group_lits(bld, t, dual, fanout))
        if not common:
            return None
    return min(common) if common else None


def _strip_literal(bld: _Builder, t: int, lit: int, dual: str,
                   fanout) -> int:
    """Remove ``lit`` from the dual-op group ``t`` (t must contain it).

    A fully-stripped group becomes the identity of the *outer* op, i.e.
    the dual op's absorbing element is never produced here."""
    if t == lit:
        # factored term is the literal itself: identity of the dual op
        return bld.const(1 if dual == "AND" else 0)
    parts = _group_lits(bld, t, dual, fanout)
    parts.remove(lit)
    if not parts:
        return bld.const(1 if dual == "AND" else 0)
    out = parts[0]
    for p in parts[1:]:
        out = bld.AND(out, p) if dual == "AND" else bld.OR(out, p)
    return out


def _match_xor(bld: _Builder, t0: int, t1: int) -> Optional[int]:
    """OR(AND(a,~b), AND(~a,b)) -> XOR(a,b);
    OR(AND(a,b), AND(~a,~b)) -> XNOR(a,b).  Kleene-safe."""
    n0, n1 = bld.nodes[t0], bld.nodes[t1]
    if n0.op != "AND" or n1.op != "AND":
        return None
    if len(n0.fanins) != 2 or len(n1.fanins) != 2:
        return None

    def pol(i):
        n = bld.nodes[i]
        if n.op == "NOT":
            return n.fanins[0], True
        return i, False

    a0, i0 = pol(n0.fanins[0])
    b0, j0 = pol(n0.fanins[1])
    a1, i1 = pol(n1.fanins[0])
    b1, j1 = pol(n1.fanins[1])
    if {a0, b0} != {a1, b1} or a0 == b0:
        return None
    # align operand order of the second term
    if a1 != a0:
        a1, b1, i1, j1 = b1, a1, j1, i1
    # polarities: (i0,j0) vs (i1,j1)
    if i0 != i1 and j0 != j1:
        if i0 != j0:
            return bld.XOR(a0, b0)          # a^b
        return bld.NOT(bld.XOR(a0, b0))     # xnor
    return None


def _to_gategraph(bld: _Builder, out_map: Dict[int, Tuple[object, int]],
                  select_primitives: bool = True) -> GateGraph:
    """Convert a builder graph back to a GateGraph, folding NOT/AND/OR/
    XOR combinations into the composite primitives (NAND/NOR/XNOR/
    IMP/NIMP) where it saves a gate (single-fanout inner node)."""
    g = GateGraph()
    roots = [idx for (_, idx) in out_map.values()]

    # live + fanout over the builder graph
    live: Set[int] = set()
    stack = list(roots)
    while stack:
        i = stack.pop()
        if i in live:
            continue
        live.add(i)
        stack.extend(bld.nodes[i].fanins)
    fanout = {i: 0 for i in live}
    for i in live:
        for f in bld.nodes[i].fanins:
            fanout[f] += 1
    for r in roots:
        fanout[r] += 1

    memo: Dict[int, int] = {}

    def conv(i: int) -> int:
        if i in memo:
            return memo[i]
        n = bld.nodes[i]
        out: int
        if n.op == "PIN":
            out = g.leaf(n.net)
        elif n.op == "CONST":
            out = g.const(n.const)
        elif n.op == "NOT":
            inner = bld.nodes[n.fanins[0]]
            if (select_primitives and fanout.get(n.fanins[0], 2) == 1 and
                    inner.op in ("AND", "OR", "XOR")):
                f = [conv(x) for x in inner.fanins]
                out = g.gate({"AND": "NAND", "OR": "NOR",
                              "XOR": "XNOR"}[inner.op], *f)
            else:
                out = g.gate("NOT", conv(n.fanins[0]))
        elif n.op in ("AND", "OR"):
            a, b = n.fanins
            na, nb = bld.nodes[a], bld.nodes[b]
            if select_primitives and n.op == "AND":
                # AND(a, ~b) -> NIMP(a, b) when ~b is private
                if nb.op == "NOT" and fanout.get(b, 2) == 1:
                    out = g.gate("NIMP", conv(a), conv(nb.fanins[0]))
                elif na.op == "NOT" and fanout.get(a, 2) == 1:
                    out = g.gate("NIMP", conv(b), conv(na.fanins[0]))
                else:
                    out = g.gate("AND", conv(a), conv(b))
            elif select_primitives and n.op == "OR":
                # OR(~a, b) -> IMP(a, b) when ~a is private
                if na.op == "NOT" and fanout.get(a, 2) == 1:
                    out = g.gate("IMP", conv(na.fanins[0]), conv(b))
                elif nb.op == "NOT" and fanout.get(b, 2) == 1:
                    out = g.gate("IMP", conv(nb.fanins[0]), conv(a))
                else:
                    out = g.gate("OR", conv(a), conv(b))
            else:
                out = g.gate(n.op, conv(a), conv(b))
        elif n.op == "XOR":
            out = g.gate("XOR", *[conv(x) for x in n.fanins])
        else:
            raise AssertionError(n.op)
        memo[i] = out
        return out

    for _, (net, idx) in out_map.items():
        g.set_output(net, conv(idx))
    return g


def _stash_fsm(nl, bld) -> None:
    """Copy FSM reachable-state tags (synth._tag_fsm_bit) onto the
    builder, dropping tags whose net is no longer solely driven by the
    tagged FF (multi-driver nets carry resolved values the reachable
    set says nothing about)."""
    bits = getattr(nl, "_fsm_bits", None)
    bld.fsm_bits = {}
    bld.fsm_states = {}
    if not bits:
        return
    from .optimize import _drivers
    for key, (net, ff, group, bit, inv) in bits.items():
        drv = _drivers(net)
        if len(drv) == 1 and drv[0].model is ff:
            bld.fsm_bits[key] = (group, bit, inv)
    bld.fsm_states = dict(getattr(nl, "_fsm_states", {}))


def _apply_dc_gates(bld, b) -> None:
    """Install the DC-inference policy (infer_dc_from_* flags) on the
    builder; passes read these via getattr with permissive defaults."""
    bld.use_fsm_dc = b.infer_dc_from_fsm
    bld.use_odc = b.infer_dc_from_odc
    bld.use_xz_dc = b.infer_dc_from_xz
    bld.fsm_max_bits = b.dc_fsm_max_bits


def _fsm_dc_words(bld, leaves: List[int]):
    """Packed don't-care minterms for a cone from FSM reachable-state
    tags: a minterm is DC when, for some tagged register group with
    >=2 bits among the cone leaves, no reachable state value is
    consistent with the bit values the minterm assigns (pe_synth.h
    DC-mining tier's one-hot FSM inference role, generalized to any
    constant-coded state register).  Returns uint64 words or None."""
    import numpy as np
    tags = getattr(bld, "fsm_bits", None)
    if not tags or not getattr(bld, "use_fsm_dc", True):
        return None
    groups: Dict[str, List[Tuple[int, int, int]]] = {}
    for k, li in enumerate(leaves):
        net = bld.nodes[li].net
        if net is None:
            continue
        t = tags.get(id(net))
        if t is not None:
            groups.setdefault(t[0], []).append((k, t[1], t[2]))
    nsup = len(leaves)
    if nsup > 20:
        return None
    npat = 1 << nsup
    m = np.arange(npat, dtype=np.uint64)
    dc = None
    for gid, mem in groups.items():
        if len(mem) < 2 or len(mem) > getattr(bld, "fsm_max_bits", 16):
            continue
        states = bld.fsm_states.get(gid)
        if not states:
            continue
        allowed = np.zeros(npat, bool)
        for v in states:
            okm = np.ones(npat, bool)
            for (k, b, inv) in mem:
                bitval = ((v >> b) & 1) ^ inv
                okm &= (((m >> np.uint64(k)) & np.uint64(1)) ==
                        np.uint64(bitval))
            allowed |= okm
        dc = ~allowed if dc is None else (dc | ~allowed)
    if dc is None or not dc.any():
        return None
    buf = np.zeros(((npat + 63) // 64) * 64, np.uint8)
    buf[:npat] = dc.astype(np.uint8)
    return np.packbits(buf, bitorder="little").view(np.uint64)


def optimize_o2(nl, protected_ids: Set[int], stats,
                binary_ok: bool = False, rounds: int = 4,
                tt_passes: bool = False, adders: bool = True,
                mul2: bool = True, budgets=None) -> bool:
    """The O2/O3 graph tiers: normalize -> constant/identity/absorption
    folding -> tree factoring + XOR extraction (to fixpoint) ->
    [O3, binary inputs only: truth-table sweep] -> primitive selection
    -> re-emit.  Returns True if the netlist changed."""
    from .optimize import PassBudgets
    b = budgets or PassBudgets()
    g0 = extract(nl, protected_ids)
    if g0 is None:
        return False
    before = g0.gate_count()

    bld = _Builder(binary_ok)
    _stash_fsm(nl, bld)
    _apply_dc_gates(bld, b)
    mp = _normalize(g0, bld)
    out_map = {k: (net, mp[idx]) for k, (net, idx) in g0.outputs.items()}

    def factor_rounds(out_map):
        for _ in range(rounds):
            roots = [idx for (_, idx) in out_map.values()]
            repl = _factor_pass(bld, roots)
            new_map = {}
            changed = False
            for k, (net, idx) in out_map.items():
                j = idx
                while j in repl and repl[j] != j:
                    j = repl[j]
                if j != idx:
                    changed = True
                new_map[k] = (net, j)
            out_map = new_map
            if not changed:
                break
        return out_map

    # run the pass sequence, checkpointing after each stage; emit the
    # best graph seen (a stage that inflates must not discard the wins
    # of the stages around it).  Per-pass deltas + wall time land in
    # stats.passes (pe_synth_report.passes parity).
    import time as _time
    best_g = None
    best_count = None

    def checkpoint(out_map):
        nonlocal best_g, best_count
        g = _to_gategraph(bld, out_map)
        n = g.gate_count()
        if best_count is None or n < best_count:
            best_g, best_count = g, n
        return n

    def staged(name, fn, out_map, keep_worse=False):
        """Run a stage, record (pass, before, after, us), checkpoint,
        and roll back stages that regressed (the reference's
        max_total_* snapshot-rollback role, pe_synth.h:17644-17664)."""
        roots = [idx for (_, idx) in out_map.values()]
        pre = _live_gate_count(bld, roots)
        t0 = _time.monotonic()
        new_map = fn(out_map)
        us = int((_time.monotonic() - t0) * 1e6)
        roots = [idx for (_, idx) in new_map.values()]
        post = _live_gate_count(bld, roots)
        stats.passes.append((name, pre, post, us))
        checkpoint(new_map)
        if post > pre and not keep_worse:
            return out_map
        return new_map

    checkpoint(out_map)                  # normalize + re-selection only
    # factor FIRST: with tt_passes this puts the plain-O2 result into
    # the best-checkpoint candidate set, so O3 can never lose to O2
    # when the TT-rewritten graph happens to factor worse than the raw
    # one (QoR-table monotonicity)
    out_map = staged("factor", factor_rounds, out_map)
    if tt_passes and binary_ok:
        from .opt_map import cut_rewrite, resub
        if b.sweep_max_pairs:
            out_map = staged("tt_sweep",
                             lambda om: tt_sweep(
                                 bld, om, stats,
                                 max_pairs=b.sweep_max_pairs), out_map)
        if b.techmap_max_cut:
            out_map = staged("rewrite",
                             lambda om: cut_rewrite(
                                 bld, om, stats,
                                 max_cut=b.techmap_max_cut,
                                 max_candidates=b.rewrite_max_candidates),
                             out_map)
        if b.resub_max_targets:
            out_map = staged("resub",
                             lambda om: resub(
                                 bld, om, stats,
                                 max_divisors=b.resub_max_divisors,
                                 max_targets=b.resub_max_targets),
                             out_map)
        if b.qm_max_vars:
            out_map = staged("qm_2lvl",
                             lambda om: qm_cones(
                                 bld, om, stats,
                                 max_support=b.qm_max_vars,
                                 exact_support=b.qm_exact_vars,
                                 max_cone=b.qm_max_gates), out_map)
        from .opt_map import sop_rewrite, bdd_decompose
        if b.qm_max_vars and b.sop_max_vars:
            out_map = staged("qm_deep",
                             lambda om: sop_rewrite(
                                 bld, om, stats,
                                 max_vars=b.sop_max_vars,
                                 exact_vars=b.qm_exact_vars,
                                 max_targets=b.qm_max_targets),
                             out_map)
        if b.decomp_max_vars:
            out_map = staged("bdd_decomp",
                             lambda om: bdd_decompose(
                                 bld, om, stats,
                                 min_vars=b.decomp_min_vars,
                                 max_vars=b.decomp_max_vars), out_map)
        if b.techmap_max_cut:
            out_map = staged("rewrite2",
                             lambda om: cut_rewrite(
                                 bld, om, stats, rounds=1,
                                 max_cut=b.techmap_max_cut,
                                 max_candidates=b.rewrite_max_candidates),
                             out_map)
        out_map = staged("factor2", factor_rounds, out_map)

    best_g = macro_extract(best_g, stats, adders=adders, mul2=mul2)
    after = instance_count(best_g)
    if after >= before:
        return False
    emit(nl, best_g, stats)
    stats.graph_gates_saved += before - after
    return True


# ---------------------------------------------------------------------------
# O3: truth-table passes (binary-inputs relaxation required)
# ---------------------------------------------------------------------------
# The role of the reference's u64-packed truth-table batching
# (pe_synth_cuda_u64_cones.cu:26-113, host fallback in pe_synth.h): 64
# simulation patterns per word, vectorized over the whole graph with
# numpy — functionally-equivalent (or complementary) nodes are detected
# by signature, proven by exhaustive evaluation over their joint
# support, and merged.

def _live_order(bld: _Builder, roots: List[int]) -> List[int]:
    order: List[int] = []
    state: Dict[int, int] = {}
    for root in roots:
        stack = [(root, 0)]
        while stack:
            i, ph = stack.pop()
            if ph == 0:
                if state.get(i):
                    continue
                state[i] = 1
                stack.append((i, 1))
                for f in bld.nodes[i].fanins:
                    if not state.get(f):
                        stack.append((f, 0))
            elif state[i] != 2:
                state[i] = 2
                order.append(i)
    return order


def _sim_words(bld: _Builder, order: List[int], leaf_words: Dict[int, object]):
    """Vectorized evaluation: each node gets a numpy uint64 array (same
    shape for all leaves).  Returns (words, tainted) where tainted marks
    nodes whose cone contains a non-binary constant."""
    import numpy as np
    words: Dict[int, object] = {}
    tainted: Set[int] = set()
    for i in order:
        n = bld.nodes[i]
        if n.op == "PIN":
            words[i] = leaf_words[i]
        elif n.op == "CONST":
            shape = next(iter(leaf_words.values())).shape
            if n.const == 0:
                words[i] = np.zeros(shape, np.uint64)
            elif n.const == 1:
                words[i] = np.full(shape, ~np.uint64(0))
            else:
                words[i] = np.zeros(shape, np.uint64)
                tainted.add(i)
        else:
            f = n.fanins
            if any(x in tainted for x in f):
                tainted.add(i)
            if n.op == "NOT":
                words[i] = ~words[f[0]]
            elif n.op == "AND":
                words[i] = words[f[0]] & words[f[1]]
            elif n.op == "OR":
                words[i] = words[f[0]] | words[f[1]]
            elif n.op == "XOR":
                words[i] = words[f[0]] ^ words[f[1]]
            else:
                raise AssertionError(n.op)
    return words, tainted


def _supports(bld: _Builder, order: List[int]) -> Dict[int, int]:
    """Leaf support as bitsets (python ints keyed by leaf order)."""
    leaf_bit: Dict[int, int] = {}
    supp: Dict[int, int] = {}
    for i in order:
        n = bld.nodes[i]
        if n.op == "PIN":
            leaf_bit[i] = len(leaf_bit)
            supp[i] = 1 << leaf_bit[i]
        elif n.op == "CONST":
            supp[i] = 0
        else:
            s = 0
            for f in n.fanins:
                s |= supp[f]
            supp[i] = s
    return supp


def _exact_equal(bld: _Builder, a: int, b: int, supp: Dict[int, int],
                 neg: bool, max_support: int = 14) -> bool:
    """Exhaustively prove cone(a) == cone(b) (or its complement)."""
    import numpy as np
    union = supp[a] | supp[b]
    nsup = bin(union).count("1")
    if nsup > max_support:
        return False
    leaves = []
    bit = 0
    u = union
    while u:
        if u & 1:
            leaves.append(bit)
        u >>= 1
        bit += 1
    # identify leaf node indices for those bits
    # (supp maps node->bitset; leaves of interest have single-bit supp)
    leaf_nodes: Dict[int, int] = {}
    for i, s in supp.items():
        if bld.nodes[i].op == "PIN" and s and (s & (s - 1)) == 0:
            leaf_nodes[s.bit_length() - 1] = i

    npat = 1 << nsup
    nwords = max(1, npat // 64)
    leaf_words: Dict[int, object] = {}
    for k, lb in enumerate(leaves):
        pat = np.zeros(nwords, np.uint64)
        if k < 6:
            base = np.uint64(0)
            blk = 1 << k
            # standard cofactor pattern within a 64-bit word
            v = 0
            for p in range(64):
                if (p >> k) & 1:
                    v |= 1 << p
            pat[:] = np.uint64(v)
        else:
            idx = np.arange(nwords, dtype=np.uint64)
            sel = (idx >> np.uint64(k - 6)) & np.uint64(1)
            pat = np.where(sel == 1, ~np.uint64(0), np.uint64(0))
        leaf_words[leaf_nodes[lb]] = pat

    # evaluate both cones with the native TT backend
    from ..native import rows_equal
    order2 = _cone_order(bld, [a, b])
    vals = _eval_nodes(bld, order2, leaf_words, nwords)
    return rows_equal(vals[a], vals[b], npat, neg)


def tt_sweep(bld: _Builder, out_map: Dict[int, Tuple[object, int]],
             stats, seed: int = 0, max_pairs: int = 4000
             ) -> Dict[int, Tuple[object, int]]:
    """Merge functionally-equivalent (or complementary) nodes.

    Signature pass over 128 random patterns; candidates proven by
    exhaustive evaluation over their joint support (<=14 leaves).  The
    topologically-earlier node survives, so no cycles can form."""
    import numpy as np
    roots = [idx for (_, idx) in out_map.values()]
    order = _live_order(bld, roots)
    topo_pos = {i: k for k, i in enumerate(order)}

    rng = np.random.default_rng(seed)
    leaf_words = {i: rng.integers(0, 1 << 63, size=2, dtype=np.uint64)
                  for i in order if bld.nodes[i].op == "PIN"}
    if not leaf_words:
        return out_map
    words = _eval_nodes(bld, order, leaf_words, 2)
    tainted: Set[int] = set()
    for i in order:
        n = bld.nodes[i]
        if (n.op == "CONST" and n.const not in (0, 1)) or \
                any(f in tainted for f in n.fanins):
            tainted.add(i)
    supp = _supports(bld, order)

    # canonical signature: min(sig, ~sig) with polarity flag
    groups: Dict[bytes, List[Tuple[int, bool]]] = {}
    for i in order:
        n = bld.nodes[i]
        if n.op in ("PIN", "CONST") or i in tainted:
            continue
        w = words[i]
        wn = ~w
        pos = w.tobytes()
        neg = wn.tobytes()
        if pos <= neg:
            groups.setdefault(pos, []).append((i, False))
        else:
            groups.setdefault(neg, []).append((i, True))

    repl: Dict[int, int] = {}
    checked = 0
    for key, members in groups.items():
        if len(members) < 2 or checked > max_pairs:
            continue
        members.sort(key=lambda t: topo_pos[t[0]])
        canon, cpol = members[0]
        for j, jpol in members[1:]:
            if checked > max_pairs:
                break
            checked += 1
            neg = (jpol != cpol)
            if _exact_equal(bld, canon, j, supp, neg):
                repl[j] = bld.NOT(canon) if neg else canon
                stats.tt_merged += 1

    if not repl:
        return out_map
    # rebuild with substitution (bottom-up, re-simplifying)
    new_idx: Dict[int, int] = {}

    def sub(i: int) -> int:
        if i in new_idx:
            return new_idx[i]
        j = repl.get(i, i)
        if j != i:
            out = sub(j)
        else:
            n = bld.nodes[i]
            if n.op in ("PIN", "CONST"):
                out = i
            else:
                f = [sub(x) for x in n.fanins]
                out = {"NOT": lambda: bld.NOT(f[0]),
                       "AND": lambda: bld.AND(f[0], f[1]),
                       "OR": lambda: bld.OR(f[0], f[1]),
                       "XOR": lambda: bld.XOR(f[0], f[1])}[n.op]()
        new_idx[i] = out
        return out

    return {k: (net, sub(idx)) for k, (net, idx) in out_map.items()}


# ---------------------------------------------------------------------------
# O3: Quine-McCluskey two-level cone minimization (pe_synth.h:10202
# qm_implicant / Petrick analogue; binary-inputs relaxation required)
# ---------------------------------------------------------------------------

def _qm_primes(minterms: List[int], nvars: int) -> List[Tuple[int, int]]:
    """Prime implicants as (value, dc_mask) pairs.

    Dense-bitset form: each (level, dc-mask) group is a boolean
    presence array over the 2^nvars value space, and the QM combine
    step for bit b is one vectorized gather (`present[v] and
    present[v | b]`) instead of per-cube set probes — the pure-Python
    set version was the single hottest function in the -O3 profile
    (42 s tottime + 17 s of set.add on RV32).  Output is sorted by
    (combine level, mask, value), so downstream greedy-cover
    tie-breaking is deterministic.  Callers pass exact-tier cones only
    (nvars <= ~12); the sparse original handles anything larger."""
    if not minterms:
        return []
    # sparse ON-sets generate few cubes — the set version is cheaper
    # there (measured crossover ~1/8 density at nvars=10); dense wins
    # 3x at high density where cube counts explode
    if nvars > 16 or len(minterms) * 8 < (1 << nvars):
        return _qm_primes_sparse(minterms, nvars)
    import numpy as np
    size = 1 << nvars
    idx = np.arange(size, dtype=np.uint32)
    present = np.zeros((1, size), bool)
    present[0, np.asarray(list(minterms), np.int64)] = True
    masks = np.zeros(1, np.uint32)
    primes: List[Tuple[int, int]] = []
    gather_cols = [idx | np.uint32(1 << b) for b in range(nvars)]
    mirror_cols = [idx ^ np.uint32(1 << b) for b in range(nvars)]
    lo_col = [(idx & np.uint32(1 << b)) == 0 for b in range(nvars)]
    while masks.size:
        M = masks.size
        combined = np.zeros((M, size), bool)
        nxt: Dict[int, object] = {}
        for b in range(nvars):
            bit = 1 << b
            free = (masks & bit) == 0
            if not free.any():
                continue
            rows = np.nonzero(free)[0]
            sub = present[rows]
            # cube (v, mask) pairs with both v and v|bit present
            both = sub & lo_col[b][None, :] & sub[:, gather_cols[b]]
            any_rows = both.any(axis=1)
            if not any_rows.any():
                continue
            combined[rows] |= both
            combined[rows] |= both[:, mirror_cols[b]]
            for rpos in np.nonzero(any_rows)[0]:
                nm = int(masks[rows[rpos]]) | bit
                arr = nxt.get(nm)
                if arr is None:
                    nxt[nm] = both[rpos].copy()
                else:
                    arr |= both[rpos]
        rem = present & ~combined
        for r in range(M):
            if rem[r].any():
                mk = int(masks[r])
                primes.extend((int(v), mk) for v in idx[rem[r]])
        if nxt:
            items = sorted(nxt.items())
            masks = np.asarray([m for m, _ in items], np.uint32)
            present = np.stack([a for _, a in items])
        else:
            masks = np.zeros(0, np.uint32)
    return primes


def _qm_primes_sparse(minterms: List[int],
                      nvars: int) -> List[Tuple[int, int]]:
    """Set-based QM combine (the wide-cone fallback)."""
    cur = {(m, 0) for m in minterms}
    primes: Set[Tuple[int, int]] = set()
    while cur:
        nxt: Set[Tuple[int, int]] = set()
        combined: Set[Tuple[int, int]] = set()
        items = list(cur)
        by_mask: Dict[int, List[Tuple[int, int]]] = {}
        for it in items:
            by_mask.setdefault(it[1], []).append(it)
        for mask, group in by_mask.items():
            group_set = set(g[0] for g in group)
            for v, _ in group:
                for b in range(nvars):
                    bit = 1 << b
                    if mask & bit:
                        continue
                    if (v | bit) != v and (v | bit) in group_set:
                        nxt.add((v, mask | bit))
                        combined.add((v, mask))
                        combined.add((v | bit, mask))
        primes |= cur - combined
        cur = nxt
    return list(primes)


def _qm_cover(minterms: List[int], primes: List[Tuple[int, int]],
              nvars: int) -> List[Tuple[int, int]]:
    """Essential primes + greedy cover (Petrick-style exact cover is
    exponential; greedy matches the reference's large-cone fallback)."""
    def covers(p, m):
        v, mask = p
        return (m & ~mask) == (v & ~mask)

    cover_of: Dict[int, List[int]] = {m: [] for m in minterms}
    for pi, p in enumerate(primes):
        for m in minterms:
            if covers(p, m):
                cover_of[m].append(pi)

    chosen: Set[int] = set()
    uncovered = set(minterms)
    # essential primes
    for m, ps in cover_of.items():
        if len(ps) == 1:
            chosen.add(ps[0])
    for pi in chosen:
        uncovered -= {m for m in uncovered if covers(primes[pi], m)}
    # greedy
    while uncovered:
        best, best_cov = None, -1
        for pi, p in enumerate(primes):
            if pi in chosen:
                continue
            cov = sum(1 for m in uncovered if covers(p, m))
            if cov > best_cov:
                best, best_cov = pi, cov
        if best is None or best_cov <= 0:
            break
        chosen.add(best)
        uncovered -= {m for m in uncovered if covers(primes[best], m)}
    return [primes[pi] for pi in chosen]


def _build_sop(bld: _Builder, leaves: List[int],
               terms: List[Tuple[int, int]], nvars: int,
               invert: bool) -> int:
    if not terms:
        out = bld.const(0)
        return bld.NOT(out) if invert else out
    prods = []
    for v, mask in terms:
        lits = []
        for b in range(nvars):
            bit = 1 << b
            if mask & bit:
                continue
            lits.append(leaves[b] if (v & bit) else bld.NOT(leaves[b]))
        if not lits:
            prods.append(bld.const(1))
            continue
        p = lits[0]
        for q in lits[1:]:
            p = bld.AND(p, q)
        prods.append(p)
    out = prods[0]
    for p in prods[1:]:
        out = bld.OR(out, p)
    return bld.NOT(out) if invert else out


def _cone_tt(bld: _Builder, root: int, leaves: List[int]):
    """Truth table of the cone as a list of ints (bit m = f(minterm m))."""
    import numpy as np
    nvars = len(leaves)
    npat = 1 << nvars
    nwords = max(1, npat // 64)
    leaf_words: Dict[int, object] = {}
    for k in range(nvars):
        if k < 6:
            v = 0
            for p in range(64):
                if (p >> k) & 1:
                    v |= 1 << p
            leaf_words[leaves[k]] = np.full(nwords, np.uint64(v))
        else:
            idx = np.arange(nwords, dtype=np.uint64)
            sel = (idx >> np.uint64(k - 6)) & np.uint64(1)
            leaf_words[leaves[k]] = np.where(sel == 1, ~np.uint64(0),
                                             np.uint64(0))
    order2 = _cone_order(bld, [root])
    vals = _eval_nodes(bld, order2, leaf_words, nwords)
    return vals[root], npat


def _live_gate_count(bld: _Builder, roots: List[int]) -> int:
    return sum(1 for i in _live_order(bld, roots)
               if bld.nodes[i].op not in ("PIN", "CONST"))


class _LiveSet:
    """Incremental live-gate count over the append-only hash-consed
    builder graph (nodes are never mutated, so cone membership only
    changes when a ROOT slot changes).  Replaces the full-netlist DFS
    the QM/espresso accept loop used to run per candidate
    (`_live_gate_count(bld, trial)` — the dominant -O3 cost on deep
    designs) with two local cone walks: activate the candidate cone,
    peel the replaced cone by refcount, read the count, undo.

    `ref[i]` counts live readers of node i plus the number of root
    slots holding i; a node is live iff ref > 0.  `gates` is the count
    of live non-PIN/CONST nodes — exactly `_live_gate_count` of the
    current root multiset (asserted equivalent in tests)."""

    def __init__(self, bld: _Builder, roots: List[int]):
        self.bld = bld
        self.ref: Dict[int, int] = {}
        self.gates = 0
        self.root_count: Dict[int, int] = {}
        for r in roots:
            self._add(r)
            self.root_count[r] = self.root_count.get(r, 0) + 1

    def _add(self, i: int) -> None:
        nodes = self.bld.nodes
        ref = self.ref
        stack = [i]
        while stack:
            j = stack.pop()
            c = ref.get(j, 0)
            ref[j] = c + 1
            if c == 0:
                if nodes[j].op not in ("PIN", "CONST"):
                    self.gates += 1
                stack.extend(nodes[j].fanins)

    def _remove(self, i: int) -> None:
        nodes = self.bld.nodes
        ref = self.ref
        stack = [i]
        while stack:
            j = stack.pop()
            c = ref[j] - 1
            if c:
                ref[j] = c
            else:
                del ref[j]
                if nodes[j].op not in ("PIN", "CONST"):
                    self.gates -= 1
                stack.extend(nodes[j].fanins)

    def swap_cost_all(self, old: int, new: int) -> int:
        """Live gate count if EVERY root slot holding `old` were
        replaced by `new` (the accept loop's trial semantics).  Does
        not commit."""
        m = self.root_count.get(old, 0)
        if old == new or m == 0:
            return self.gates
        for _ in range(m):
            self._add(new)
        for _ in range(m):
            self._remove(old)
        g = self.gates
        for _ in range(m):
            self._add(old)
        for _ in range(m):
            self._remove(new)
        return g

    def swap_one(self, old: int, new: int) -> None:
        """Commit replacing ONE root slot `old` -> `new`."""
        if old != new:
            self._add(new)
            self._remove(old)
        c = self.root_count[old] - 1
        if c:
            self.root_count[old] = c
        else:
            del self.root_count[old]
        self.root_count[new] = self.root_count.get(new, 0) + 1


def qm_cones(bld: _Builder, out_map: Dict[int, Tuple[object, int]],
             stats, max_support: int = 14, exact_support: int = 10,
             max_cone: int = 300) -> Dict[int, Tuple[object, int]]:
    """Re-express small output cones as a minimized two-level SOP (or
    inverted SOP of the OFF-set, whichever is cheaper) when that lowers
    the global live gate count."""
    import numpy as np
    roots = [idx for (_, idx) in out_map.values()]
    order = _live_order(bld, roots)
    supp = _supports(bld, order)
    # taint: cones containing X/Z constants are not QM-able
    tainted: Set[int] = set()
    for i in order:
        n = bld.nodes[i]
        if n.op == "CONST" and n.const not in (0, 1):
            tainted.add(i)
        elif any(f in tainted for f in n.fanins):
            tainted.add(i)

    live = _LiveSet(bld, roots)
    cur_cost = live.gates
    new_map = dict(out_map)
    for k, (net, idx) in out_map.items():
        if idx in tainted:
            continue
        n = bld.nodes[idx]
        if n.op in ("PIN", "CONST"):
            continue
        s = supp.get(idx, 0)
        nsup = bin(s).count("1")
        if nsup == 0 or nsup > max_support:
            continue
        leaves = [i for i in order
                  if bld.nodes[i].op == "PIN" and (supp[i] & s)]
        if len(leaves) != nsup:
            continue
        tt, npat = _cone_tt(bld, idx, leaves)
        bits = np.unpackbits(
            tt.view(np.uint8), bitorder="little")[:npat]
        # FSM reachable-state don't-cares over this cone's leaves
        fdc = _fsm_dc_words(bld, leaves)
        if fdc is not None:
            dcb = np.unpackbits(fdc.view(np.uint8),
                                bitorder="little")[:npat].astype(bool)
            stats.dc_minterms += int(dcb.sum())
        else:
            dcb = np.zeros(npat, bool)
        dmt = [int(x) for x in np.nonzero(dcb)[0]]
        minterms = [m for m in range(npat) if bits[m] and not dcb[m]]
        off_mt_all = [m for m in range(npat)
                      if not bits[m] and not dcb[m]]
        variants = []
        if minterms and off_mt_all:
            if nsup <= exact_support:
                # exact: QM primes over ON+DC, cover the ON-set only
                on = _qm_cover(minterms,
                               _qm_primes(minterms + dmt, nsup), nsup)
                variants.append((on, False))
                off = _qm_cover(off_mt_all,
                                _qm_primes(off_mt_all + dmt, nsup),
                                nsup)
                variants.append((off, True))
            else:
                # heuristic: espresso EXPAND/IRREDUNDANT on both phases
                ones_mask = np.uint64((1 << npat) - 1) if npat < 64 \
                    else ~np.uint64(0)
                on = espresso_cover(tt, nsup, dc_words=fdc)
                if on is not None:
                    variants.append((on, False))
                off_words = (~np.asarray(tt, np.uint64) & ones_mask
                             if tt.size == 1
                             else ~np.asarray(tt, np.uint64))
                off = espresso_cover(off_words, nsup, dc_words=fdc)
                if off is not None:
                    variants.append((off, True))
                if variants:
                    stats.espresso_rewritten += 0  # counted on accept
        elif not minterms:
            variants.append(([], False))
        else:
            variants.append(([], True))

        best = None
        for terms, inv in variants:
            cand = _build_sop(bld, leaves, terms, nsup, inv)
            cost = live.swap_cost_all(idx, cand)
            if cost < cur_cost and (best is None or cost < best[1]):
                best = (cand, cost)
        if best is not None:
            new_map[k] = (net, best[0])
            live.swap_one(idx, best[0])
            cur_cost = best[1]
            if nsup <= exact_support:
                stats.qm_rewritten += 1
            else:
                stats.espresso_rewritten += 1
    return new_map


# ---------------------------------------------------------------------------
# native-batched evaluation plumbing
# ---------------------------------------------------------------------------

def _eval_nodes(bld: _Builder, order: List[int],
                leaf_fill: Dict[int, object], n_words: int):
    """Evaluate ``order`` (topo-sorted builder nodes) over packed words
    via the truth-table library (native/pe_tt.cpp).  ``leaf_fill``
    maps PIN node idx -> uint64[n_words]; unlisted leaves read zeros.
    Returns a dict idx -> row (view into the matrix)."""
    import numpy as np
    from ..native import (eval_graph, OP_LEAF, OP_NOT, OP_AND, OP_OR,
                          OP_XOR, OP_CONST0, OP_CONST1)
    pos = {idx: row for row, idx in enumerate(order)}
    n = len(order)
    op = np.zeros(n, np.int32)
    f0 = np.zeros(n, np.int32)
    f1 = np.zeros(n, np.int32)
    words = np.zeros((n, n_words), np.uint64)
    code = {"NOT": OP_NOT, "AND": OP_AND, "OR": OP_OR, "XOR": OP_XOR}
    for row, idx in enumerate(order):
        nd = bld.nodes[idx]
        if nd.op == "PIN":
            op[row] = OP_LEAF
            fill = leaf_fill.get(idx)
            if fill is not None:
                words[row] = fill
        elif nd.op == "CONST":
            # non-binary consts are handled by taint tracking upstream
            op[row] = OP_CONST1 if nd.const == 1 else OP_CONST0
        else:
            op[row] = code[nd.op]
            f0[row] = pos[nd.fanins[0]]
            if len(nd.fanins) > 1:
                f1[row] = pos[nd.fanins[1]]
    eval_graph(op, f0, f1, words)
    return {idx: words[row] for row, idx in enumerate(order)}


def _cone_order(bld: _Builder, roots: List[int]) -> List[int]:
    return _live_order(bld, roots)


# ---------------------------------------------------------------------------
# Omax (O4/O5): budgeted multi-start search + equivalence verification
# (pe_synth.h Omax loop: deterministic by default, randomized restarts,
#  gate_count/weighted cost models, exhaustive-or-random verification)
# ---------------------------------------------------------------------------

_DEFAULT_WEIGHTS = {"AND": 1.0, "OR": 1.0, "NOT": 0.5, "YES": 0.25,
                    "XOR": 1.5, "XNOR": 1.5, "NAND": 1.0, "NOR": 1.0,
                    "IMP": 1.0, "NIMP": 1.0}


def graph_cost(g: GateGraph, cost_model: str = "gate_count",
               weights: Optional[Dict[str, float]] = None) -> float:
    live = g.live_set()
    if cost_model == "weighted":
        w = dict(_DEFAULT_WEIGHTS)
        if weights:
            w.update(weights)
        return sum(w.get(g.nodes[i].op, 1.0) for i in live
                   if g.nodes[i].op not in ("PIN", "CONST"))
    return float(sum(1 for i in live
                     if g.nodes[i].op not in ("PIN", "CONST")))


def _eval_gategraph(g: GateGraph, leaf_words: Dict[int, object],
                    n_words: int) -> Dict[int, object]:
    """Evaluate a GateGraph (composite ops included) over packed words.
    ``leaf_words`` is keyed by id(net) of PIN leaves."""
    import numpy as np
    vals: Dict[int, object] = {}
    order = _toposort(g, g.live_set())
    ones = np.full(n_words, ~np.uint64(0))
    zeros = np.zeros(n_words, np.uint64)
    for i in order:
        n = g.nodes[i]
        if n.op == "PIN":
            vals[i] = leaf_words.get(id(n.net), zeros)
        elif n.op == "CONST":
            vals[i] = ones.copy() if n.const == 1 else zeros.copy()
        else:
            f = [vals[x] for x in n.fanins]
            if n.op == "AND":
                vals[i] = f[0] & f[1]
            elif n.op == "OR":
                vals[i] = f[0] | f[1]
            elif n.op == "XOR":
                vals[i] = f[0] ^ f[1]
            elif n.op == "XNOR":
                vals[i] = ~(f[0] ^ f[1])
            elif n.op == "NAND":
                vals[i] = ~(f[0] & f[1])
            elif n.op == "NOR":
                vals[i] = ~(f[0] | f[1])
            elif n.op == "IMP":
                vals[i] = ~f[0] | f[1]
            elif n.op == "NIMP":
                vals[i] = f[0] & ~f[1]
            elif n.op in ("NOT",):
                vals[i] = ~f[0]
            elif n.op == "YES":
                vals[i] = f[0]
            else:
                raise AssertionError(n.op)
    return vals


def _gategraph_to_tt(g: GateGraph, leaf_row: Dict[int, int],
                     next_row: int):
    """Lower a GateGraph to the flat (op, f0, f1) row form of
    ``native.eval_graph`` / ``parallel.tt_mesh.eval_graph_mesh``,
    expanding composite ops (NAND/NOR/XNOR/IMP/NIMP/YES) into basic
    rows.  ``leaf_row`` maps id(net) -> shared leaf row (extended in
    place so two graphs can share one pattern matrix).  Returns
    (rows: list[(op, f0, f1)], out_row per graph-output key, next_row).
    """
    from ..native import (OP_LEAF, OP_NOT, OP_AND, OP_OR, OP_XOR,
                          OP_CONST0, OP_CONST1)
    rows: List[Tuple[int, int, int]] = []
    row_of: Dict[int, int] = {}

    def alloc(op, a=0, b=0):
        nonlocal next_row
        rows.append((op, a, b))
        r = next_row
        next_row += 1
        return r

    for i in _toposort(g, g.live_set()):
        n = g.nodes[i]
        if n.op == "PIN":
            key = id(n.net)
            if key not in leaf_row:
                leaf_row[key] = alloc(OP_LEAF)
            row_of[i] = leaf_row[key]
            continue
        if n.op == "CONST":
            row_of[i] = alloc(OP_CONST1 if n.const == 1 else OP_CONST0)
            continue
        f = [row_of[x] for x in n.fanins]
        if n.op == "AND":
            row_of[i] = alloc(OP_AND, f[0], f[1])
        elif n.op == "OR":
            row_of[i] = alloc(OP_OR, f[0], f[1])
        elif n.op == "XOR":
            row_of[i] = alloc(OP_XOR, f[0], f[1])
        elif n.op == "NAND":
            row_of[i] = alloc(OP_NOT, alloc(OP_AND, f[0], f[1]))
        elif n.op == "NOR":
            row_of[i] = alloc(OP_NOT, alloc(OP_OR, f[0], f[1]))
        elif n.op == "XNOR":
            row_of[i] = alloc(OP_NOT, alloc(OP_XOR, f[0], f[1]))
        elif n.op == "IMP":
            row_of[i] = alloc(OP_OR, alloc(OP_NOT, f[0]), f[1])
        elif n.op == "NIMP":
            row_of[i] = alloc(OP_AND, f[0], alloc(OP_NOT, f[1]))
        elif n.op == "NOT":
            row_of[i] = alloc(OP_NOT, f[0])
        elif n.op == "YES":
            row_of[i] = row_of[n.fanins[0]]
        else:  # pragma: no cover
            raise AssertionError(n.op)
    outs = {k: row_of[idx] for k, (_, idx) in g.outputs.items()}
    return rows, outs, next_row


def graphs_equivalent_mesh(g0: GateGraph, g1: GateGraph, mesh,
                           n_words: int = 16384, seed: int = 0) -> bool:
    """Deep random-vector equivalence with the pattern words sharded
    over ``mesh`` (a DeviceMesh; ``parallel/tt_mesh.py`` — the
    reference's multi-GPU TT fan-out role, pe_synth_cuda_u64_cones.cu:
    671-1860): both graphs over n_words·64 random patterns (2^20 by
    default), drawn from numpy's ``default_rng(seed)`` as the JAX package
    draws them, so both packages test the same patterns."""
    import numpy as np
    from ..parallel.tt_mesh import eval_graph_mesh

    if set(g0.outputs) != set(g1.outputs):
        return False
    leaf_row: Dict[int, int] = {}
    rows0, outs0, nr = _gategraph_to_tt(g0, leaf_row, 0)
    rows1, outs1, nr = _gategraph_to_tt(g1, leaf_row, nr)
    # leaf rows were allocated inside rows0/rows1 in order; flatten
    all_rows = rows0 + rows1
    op = np.array([r[0] for r in all_rows], np.int32)
    f0 = np.array([r[1] for r in all_rows], np.int32)
    f1 = np.array([r[2] for r in all_rows], np.int32)
    words = np.zeros((nr, n_words), np.uint64)
    rng = np.random.default_rng(seed)
    for _key, row in leaf_row.items():
        words[row] = rng.integers(0, 1 << 63, n_words, dtype=np.uint64)
    out = eval_graph_mesh(op, f0, f1, words, mesh)
    for k in outs0:
        if not bool((out[outs0[k]] == out[outs1[k]]).all()):
            return False
    return True


def graphs_equivalent(g0: GateGraph, g1: GateGraph,
                      exhaustive_limit: int = 12,
                      random_words: int = 16, seed: int = 0,
                      mesh=None) -> bool:
    """Binary-domain equivalence of two graphs over the same output
    nets: exhaustive when the combined leaf count is small, else random
    vectors (the reference's Omax opt-verify scheme).  With ``mesh`` (a
    DeviceMesh) the random-vector tier runs deep (16k words = 2^20
    patterns) sharded over it via ``graphs_equivalent_mesh``."""
    import numpy as np
    leaves: Dict[int, object] = {}
    for g in (g0, g1):
        for n in g.nodes:
            if n.op == "PIN":
                leaves[id(n.net)] = n.net
    keys = sorted(leaves)
    nsup = len(keys)
    if nsup <= exhaustive_limit:
        npat = 1 << nsup
        n_words = max(1, npat // 64)
        lw: Dict[int, object] = {}
        for k, key in enumerate(keys):
            if k < 6:
                v = 0
                for p in range(64):
                    if (p >> k) & 1:
                        v |= 1 << p
                lw[key] = np.full(n_words, np.uint64(v))
            else:
                idx = np.arange(n_words, dtype=np.uint64)
                sel = (idx >> np.uint64(k - 6)) & np.uint64(1)
                lw[key] = np.where(sel == 1, ~np.uint64(0), np.uint64(0))
        tail = npat if npat < 64 else 0
    else:
        if mesh is not None:
            return graphs_equivalent_mesh(g0, g1, mesh, seed=seed)
        n_words = random_words
        rng = np.random.default_rng(seed)
        lw = {key: rng.integers(0, 1 << 63, n_words, dtype=np.uint64)
              for key in keys}
        tail = 0

    v0 = _eval_gategraph(g0, lw, n_words)
    v1 = _eval_gategraph(g1, lw, n_words)
    outs0 = {k: idx for k, (_, idx) in g0.outputs.items()}
    outs1 = {k: idx for k, (_, idx) in g1.outputs.items()}
    if set(outs0) != set(outs1):
        return False
    mask = np.uint64((1 << tail) - 1) if tail else ~np.uint64(0)
    for k in outs0:
        a = v0[outs0[k]]
        b = v1[outs1[k]]
        if tail:
            if (a[0] & mask) != (b[0] & mask):
                return False
        elif not bool((a == b).all()):
            return False
    return True


def optimize_omax(nl, protected_ids: Set[int], stats,
                  binary_ok: bool, restarts: int = 4,
                  time_budget_s: Optional[float] = None,
                  verify: bool = False,
                  cost_model: str = "gate_count",
                  weights: Optional[Dict[str, float]] = None,
                  seed: int = 0, adders: bool = True,
                  mul2: bool = True, budgets=None) -> bool:
    """Multi-start graph optimization: each restart runs the pass
    pipeline with a different TT seed and stage order; the best graph by
    the chosen cost model is (optionally verified then) emitted."""
    import time as _time
    from .optimize import PassBudgets
    b = budgets or PassBudgets()
    t0 = _time.monotonic()
    g0 = extract(nl, protected_ids)
    if g0 is None:
        return False
    base_cost = graph_cost(g0, cost_model, weights)

    orders = [("tt", "rewrite", "qm", "sop", "factor"),
              ("factor", "tt", "rewrite", "qm", "bdd"),
              ("tt", "rewrite", "sop", "factor", "qm"),
              ("qm", "rewrite", "tt", "bdd", "factor")]
    best_g: Optional[GateGraph] = None
    best_cost = base_cost
    tried = 0
    for r in range(max(1, restarts)):
        if time_budget_s is not None and \
                _time.monotonic() - t0 > time_budget_s:
            break
        tried += 1
        bld = _Builder(binary_ok)
        _stash_fsm(nl, bld)
        # opt-verify checks full binary-domain equivalence; FSM-DC
        # rewrites legitimately differ on unreachable states, so the
        # DC tier is disabled under verify (the candidates would only
        # be rejected after the work was spent)
        _apply_dc_gates(bld, b)
        bld.use_fsm_dc = b.infer_dc_from_fsm and not verify
        mp = _normalize(g0, bld)
        out_map = {k: (net, mp[idx])
                   for k, (net, idx) in g0.outputs.items()}

        def factor(om):
            for _ in range(3):
                roots = [idx for (_, idx) in om.values()]
                repl = _factor_pass(bld, roots)
                nm = {}
                ch = False
                for k, (net, idx) in om.items():
                    j = idx
                    while j in repl and repl[j] != j:
                        j = repl[j]
                    ch |= j != idx
                    nm[k] = (net, j)
                om = nm
                if not ch:
                    break
            return om

        for stage in orders[r % len(orders)]:
            if stage == "factor":
                out_map = factor(out_map)
            elif stage == "tt" and binary_ok and b.sweep_max_pairs:
                out_map = tt_sweep(bld, out_map, stats, seed=seed + r,
                                   max_pairs=b.sweep_max_pairs)
            elif stage == "rewrite" and binary_ok and b.techmap_max_cut:
                from .opt_map import cut_rewrite
                out_map = cut_rewrite(
                    bld, out_map, stats, rounds=1,
                    max_cut=b.techmap_max_cut,
                    max_candidates=b.rewrite_max_candidates)
            elif stage == "sop" and binary_ok and b.qm_max_vars and \
                    b.sop_max_vars:
                from .opt_map import sop_rewrite
                out_map = sop_rewrite(bld, out_map, stats,
                                      max_vars=b.sop_max_vars,
                                      exact_vars=b.qm_exact_vars,
                                      max_targets=b.qm_max_targets)
            elif stage == "bdd" and binary_ok and b.decomp_max_vars:
                from .opt_map import bdd_decompose
                out_map = bdd_decompose(bld, out_map, stats,
                                        min_vars=b.decomp_min_vars,
                                        max_vars=b.decomp_max_vars)
            elif stage == "qm" and binary_ok and b.qm_max_vars:
                out_map = qm_cones(bld, out_map, stats,
                                   max_support=b.qm_max_vars,
                                   exact_support=b.qm_exact_vars,
                                   max_cone=b.qm_max_gates)
            g = _to_gategraph(bld, out_map)
            c = graph_cost(g, cost_model, weights)
            stats.omax_trace.append((r, stage, c))
            if c < best_cost:
                if verify and not graphs_equivalent(g0, g, seed=seed):
                    stats.omax_verify_rejected += 1
                    continue
                best_g, best_cost = g, c

    stats.omax_restarts = tried
    stats.omax_best_cost = best_cost
    stats.omax_summary = (
        f"omax: restarts={tried} base={base_cost:.0f} "
        f"best={best_cost:.0f} cost_model={cost_model} "
        f"verify_rejected={stats.omax_verify_rejected}")
    if best_g is None:
        return False
    best_g = macro_extract(best_g, stats, adders=adders, mul2=mul2)
    emit(nl, best_g, stats)
    stats.graph_gates_saved += int(base_cost - best_cost)
    return True


# ---------------------------------------------------------------------------
# adder macro extraction (pe_synth optimize_adders analogue)
# ---------------------------------------------------------------------------
# Matches the exact structures the digital engine's HALF_ADDER /
# FULL_ADDER blocks compute (digital/engine.py): s = a^b [, ^cin];
# c = a&b  /  cout = (a&b) | (cin & (a^b)) — so the rewrite is bit-exact
# in 4-state semantics, not just for binary inputs.

def macro_extract(g: GateGraph, stats, adders: bool = True,
                  mul2: bool = True) -> GateGraph:
    if not (adders or mul2):
        return g
    live = g.live_set()
    nodes = g.nodes

    def key2(i):
        f = nodes[i].fanins
        return (min(f), max(f))

    xors: Dict[Tuple[int, int], int] = {}
    ands: Dict[Tuple[int, int], int] = {}
    ors: Dict[Tuple[int, int], int] = {}
    for i in live:
        n = nodes[i]
        if len(n.fanins) != 2:
            continue
        if n.op == "XOR":
            xors[key2(i)] = i
        elif n.op == "AND":
            ands[key2(i)] = i
        elif n.op == "OR":
            ors[key2(i)] = i

    repl: Dict[int, Tuple[str, Tuple[int, ...]]] = {}

    # 2x2 multipliers FIRST (the reference's pass order: wires -> mul2
    # -> adders, verilog2penl --report; adder extraction would
    # otherwise consume the XOR/AND halves of each MUL2 web — seen on
    # the mul2-structured 8x8 multiplier corpus case)
    # pe_synth optimize_mul2: the exact gate web the MUL2 block
    # computes — p0=a0b0, p1=a1b0^a0b1, c1=a1b0&a0b1,
    # p2=a1b1^c1, p3=a1b1&c1
    for (t1, t2), p1 in (list(xors.items()) if mul2 else []):
        if p1 in repl or t1 == t2:
            continue
        n1, n2 = nodes[t1], nodes[t2]
        if n1.op != "AND" or n2.op != "AND":
            continue
        if len(n1.fanins) != 2 or len(n2.fanins) != 2:
            continue
        c1 = ands.get((min(t1, t2), max(t1, t2)))
        if c1 is None:
            continue
        found = None
        for a1, b0 in (n1.fanins, n1.fanins[::-1]):
            for a0, b1 in (n2.fanins, n2.fanins[::-1]):
                if len({a0, a1, b0, b1}) != 4:
                    continue
                p0 = ands.get((min(a0, b0), max(a0, b0)))
                t3 = ands.get((min(a1, b1), max(a1, b1)))
                if p0 is None or t3 is None:
                    continue
                p2 = xors.get((min(t3, c1), max(t3, c1)))
                p3 = ands.get((min(t3, c1), max(t3, c1)))
                if p2 is None or p3 is None:
                    continue
                found = (a0, a1, b0, b1, p0, p2, p3)
                break
            if found:
                break
        if found is None:
            continue
        a0, a1, b0, b1, p0, p2, p3 = found
        if any(x in repl for x in (p0, p2, p3)):
            continue
        fan = (a0, a1, b0, b1)
        repl[p0] = ("M2_P0", fan)
        repl[p1] = ("M2_P1", fan)
        repl[p2] = ("M2_P2", fan)
        repl[p3] = ("M2_P3", fan)
        stats.mul2_extracted += 1

    # full adders next (their parts would otherwise match half adders;
    # skip nodes a MUL2 web already claimed)
    for (xa, xb), x in (list(xors.items()) if adders else []):
        if x in repl:
            continue
        and_ab = ands.get((xa, xb))
        if and_ab is None:
            continue
        # sum node: XOR(x, cin)
        for key, s in list(xors.items()):
            if x not in key or s == x:
                continue
            if s in repl:
                continue
            cin = key[0] if key[1] == x else key[1]
            if cin == x:
                continue
            and_cx = ands.get((min(cin, x), max(cin, x)))
            if and_cx is None:
                continue
            cout = ors.get((min(and_ab, and_cx), max(and_ab, and_cx)))
            if cout is None or cout in repl:
                continue
            fan = (xa, xb, cin)
            repl[s] = ("FA_S", fan)
            repl[cout] = ("FA_C", fan)
            stats.adders_extracted += 1

    # half adders: XOR + AND sharing fanins (skip FA-consumed nodes)
    for key, x in (xors.items() if adders else []):
        if x in repl:
            continue
        a = ands.get(key)
        if a is None or a in repl:
            continue
        # only profitable if both outputs are observable
        repl[x] = ("HA_S", key)
        repl[a] = ("HA_C", key)
        stats.adders_extracted += 1

    if not repl:
        return g

    out = GateGraph()
    memo: Dict[int, int] = {}

    def conv(i: int) -> int:
        if i in memo:
            return memo[i]
        n = nodes[i]
        r = repl.get(i)
        if r is not None:
            op, fan = r
            idx = out.gate(op, *[conv(f) for f in fan])
        elif n.op == "PIN":
            idx = out.leaf(n.net)
        elif n.op == "CONST":
            idx = out.const(n.const)
        else:
            idx = out.gate(n.op, *[conv(f) for f in n.fanins])
        memo[i] = idx
        return idx

    for k, (net, idx) in g.outputs.items():
        out.set_output(net, conv(idx))
    return out


# ---------------------------------------------------------------------------
# Espresso-style heuristic two-level cover (pe_synth.h espresso_solution
# EXPAND/IRREDUNDANT analogue) for cones beyond exact-QM reach
# ---------------------------------------------------------------------------

def _var_patterns(nvars: int):
    import numpy as np
    npat = 1 << nvars
    nwords = max(1, npat // 64)
    patt = []
    for k in range(nvars):
        if k < 6:
            v = 0
            for p in range(64):
                if (p >> k) & 1:
                    v |= 1 << p
            patt.append(np.full(nwords, np.uint64(v)))
        else:
            idx = np.arange(nwords, dtype=np.uint64)
            sel = (idx >> np.uint64(k - 6)) & np.uint64(1)
            patt.append(np.where(sel == 1, ~np.uint64(0), np.uint64(0)))
    return patt, npat, nwords


def _cube_cover(v: int, mask: int, nvars: int, patt, ones):
    cov = ones.copy()
    for k in range(nvars):
        bit = 1 << k
        if mask & bit:
            continue
        cov &= patt[k] if (v & bit) else ~patt[k]
    return cov


def espresso_cover(on_words, nvars: int,
                   max_minterms: int = 4096,
                   dc_words=None) -> Optional[List[Tuple[int, int]]]:
    """Greedy EXPAND + IRREDUNDANT over the ON-set truth table
    (uint64-packed).  ``dc_words``: optional don't-care minterms —
    cubes may cover them freely but need not (infer_dc_* roles).
    Returns (value, dc_mask) cubes or None when the ON-set is too
    large to enumerate."""
    import numpy as np
    patt, npat, nwords = _var_patterns(nvars)
    ones = np.full(nwords, ~np.uint64(0))
    if npat < 64:
        ones = ones & np.uint64((1 << npat) - 1)
    on = np.asarray(on_words, np.uint64) & ones
    if dc_words is not None:
        dc = np.asarray(dc_words, np.uint64) & ones
        on = on & ~dc
        off = ~(on | dc) & ones
    else:
        off = ~on & ones

    on_bits = np.unpackbits(on.view(np.uint8), bitorder="little")[:npat]
    minterms = np.nonzero(on_bits)[0]
    if len(minterms) == 0 or len(minterms) > max_minterms:
        return [] if len(minterms) == 0 else None

    covered = np.zeros(nwords, np.uint64)
    cubes: List[Tuple[int, int]] = []
    covs = []
    for m in minterms:
        m = int(m)
        w, b = m // 64, m % 64
        if (int(covered[w]) >> b) & 1:
            continue
        v, mask = m, 0
        cov = _cube_cover(v, mask, nvars, patt, ones)
        # EXPAND: raise literals while avoiding the OFF-set
        for k in range(nvars):
            bit = 1 << k
            trial = _cube_cover(v, mask | bit, nvars, patt, ones)
            if not np.any(trial & off):
                mask |= bit
                cov = trial
        cubes.append((v & ~mask, mask))
        covs.append(cov)
        covered |= cov

    def irredundant(cubes, covs):
        keep = []
        for i in range(len(cubes)):
            rest = np.zeros(nwords, np.uint64)
            for j in range(len(cubes)):
                if j != i and (j in keep or j > i):
                    rest |= covs[j]
            if np.any(covs[i] & on & ~rest):
                keep.append(i)
        return ([cubes[i] for i in keep], [covs[i] for i in keep])

    cubes, covs = irredundant(cubes, covs)

    # REDUCE -> re-EXPAND (different literal order) -> IRREDUNDANT:
    # the classic espresso escape from the first local minimum
    for rnd in range(2):
        changed = False
        order = list(range(nvars))
        order = order[::-1] if rnd == 0 else order[nvars // 2:] + \
            order[:nvars // 2]
        for i in range(len(cubes)):
            others = np.zeros(nwords, np.uint64)
            for j in range(len(cubes)):
                if j != i:
                    others |= covs[j]
            ess = covs[i] & on & ~others
            if not np.any(ess):
                continue
            # REDUCE: smallest cube containing the essential minterms
            v, mask = 0, 0
            for k in range(nvars):
                if not np.any(ess & ~patt[k]):
                    v |= 1 << k                    # var always 1
                elif np.any(ess & patt[k]):
                    mask |= 1 << k                 # var varies
            # re-EXPAND in the alternate order
            cov = _cube_cover(v, mask, nvars, patt, ones)
            for k in order:
                bit = 1 << k
                if mask & bit:
                    continue
                trial = _cube_cover(v, mask | bit, nvars, patt, ones)
                if not np.any(trial & off):
                    mask |= bit
                    cov = trial
            new_cube = (v & ~mask, mask)
            if new_cube != cubes[i]:
                changed = True
            cubes[i] = new_cube
            covs[i] = cov
        cubes, covs = irredundant(cubes, covs)
        if not changed:
            break

    # LAST-GASP (pe_synth.h espresso_solution final stage role): try to
    # merge cube pairs into their supercube when it avoids the OFF-set;
    # escapes minima the per-cube EXPAND order can't reach.
    import numpy as _np
    merged = True
    while merged and len(cubes) > 1:
        merged = False
        for i in range(len(cubes)):
            for j in range(i + 1, len(cubes)):
                vi, mi = cubes[i]
                vj, mj = cubes[j]
                mask = mi | mj | (vi ^ vj)
                v = vi & ~mask
                cov = _cube_cover(v, mask, nvars, patt, ones)
                if _np.any(cov & off):
                    continue
                cubes[i] = (v, mask)
                covs[i] = cov
                del cubes[j], covs[j]
                merged = True
                break
            if merged:
                break
    cubes, covs = irredundant(cubes, covs)
    return cubes


def instance_count(g: GateGraph) -> int:
    """Netlist instances the graph will emit: macro sibling nodes
    (FA_S/FA_C etc.) sharing fanins count as one block device."""
    live = g.live_set()
    seen_macros = set()
    n = 0
    for i in live:
        node = g.nodes[i]
        if node.op in ("PIN", "CONST"):
            continue
        if node.op in _MACRO_PINS:
            key = (node.op.split("_")[0], node.fanins)
            if key in seen_macros:
                continue
            seen_macros.add(key)
        n += 1
    return n
