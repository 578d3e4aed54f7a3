"""Logic synthesis: elaborated Verilog -> PE gate netlist (O0 lowering).

Counterpart of the reference's ``pe_synth.h`` entry
``synthesize_to_pe_netlist`` (pe_synth.h:17558) at optimization level O0:
a *correct* structural lowering — bit-blasted expression DAGs to 2-input
gates and adder blocks, always_ff to DFF/DFF_ARSTN (non-zero reset values
via the XOR-retiming trick), always_comb latches as combinational
feedback loops (which the TPU digital engine's fixpoint group evaluates
exactly like level-sensitive latches), ``#N`` delays to TICK_DELAY
chains.  The optimization pipeline (strash/DCE/QM/espresso/...) is a
later round; constant folding and trivial-gate elision happen inline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

from ..netlist.netlist import Netlist, Node
from ..netlist import operations as ops
from ..models import (AND, OR, NOT, XOR, XNOR, NAND, NOR, YES, INPUT,
                      TRI_STATE, RESOLVE2, D_FF, D_FF_ARSTN, FULL_ADDER,
                      HALF_ADDER, TICK_DELAY, CASE_EQ)
from .elaborate import InstanceState
from .fourstate import Val
from .simulate import EvalCtx, eval_expr, self_width, SimError
from .parser import CompileError

# a Net is a constant code 0/1/2 (int) or a Node
NetT = Union[int, Node]

C0, C1, CX = 0, 1, 2


@dataclass
class SynthOptions:
    opt_level: int = 0
    loop_unroll_limit: int = 4096
    # dynamic (signal-bounded) while/do-while/for loops unroll this many
    # guarded copies (pe_synth_options.loop_unroll_limit role:
    # "bounded unrolling for dynamic for/while in procedural blocks").
    # The synthesized circuit is correct whenever the runtime trip
    # count stays within the bound; raise it for wider data paths.
    dyn_loop_unroll: int = 16
    # Allow optimizations that are only sound when external inputs are
    # binary (never X/Z) — enables complement rules and truth-table
    # passes, mirroring the reference's assume_binary_inputs relaxation.
    assume_binary_inputs: bool = False
    # Omax (opt_level >= 4) knobs, mirroring pe_synth_options' Omax
    # budget/verify/cost fields.
    omax_restarts: int = 4
    omax_time_budget_s: Optional[float] = None
    omax_verify: bool = False
    omax_cost_model: str = "gate_count"     # or "weighted"
    omax_weights: Optional[dict] = None
    omax_seed: int = 0
    # Gate-level policy flags (pe_synth_options:110-146).  The raw
    # reference struct defaults every one of these to false; the
    # user-facing C surface (dll_main.cpp verilog_synth_options_
    # snapshot) defaults them all true, which is what we mirror —
    # strict mode is opt-out.
    allow_inout: bool = True                # inout top ports legal
    allow_multi_driver: bool = True         # RESOLVE2 chains vs error
    optimize_wires: bool = True             # YES-buffer removal
    optimize_mul2: bool = True              # MUL2 macro extraction
    optimize_adders: bool = True            # HA/FA macro extraction
    support_always_comb: bool = True        # pe_synth_options:112-113
    support_always_ff: bool = True
    # per-pass budgets / DC-inference gates / growth guards
    # (optimize.PassBudgets; None = the pipeline's tuned defaults)
    budgets: Optional[object] = None


@dataclass
class SynthReport:
    gate_count: int = 0
    ff_count: int = 0
    gate_count_pre_opt: int = 0
    opt_stats: Any = None
    warnings: List[str] = field(default_factory=list)


class SynthContext:
    def __init__(self, nl: Netlist, options: SynthOptions):
        self.nl = nl
        self.opt = options
        self.report = SynthReport()
        self._const_nodes: Dict[int, Node] = {}

    # ---- net helpers ------------------------------------------------------
    def new_node(self) -> Node:
        return ops.create_node(self.nl)

    def const_node(self, code: int) -> Node:
        """A net held at a constant by an INPUT device."""
        if code not in self._const_nodes:
            inp = ops.add_model(self.nl, INPUT,
                                {"boolean": float(code),
                                 "synth_const": 1.0})
            n = self.new_node()
            ops.add_to_node(self.nl, inp, 0, n)
            self._const_nodes[code] = n
        return self._const_nodes[code]

    def as_node(self, net: NetT) -> Node:
        if isinstance(net, Node):
            return net
        return self.const_node(net)

    # ---- gate emission with constant folding ------------------------------
    def gate2(self, mdef, a: NetT, b: NetT, out: Optional[Node] = None,
              fold=None) -> NetT:
        if isinstance(a, int) and isinstance(b, int) and fold is not None:
            code = fold(a, b)
            if out is not None:
                self.buf(code, out)
                return out
            return code
        g = ops.add_model(self.nl, mdef)
        ops.add_to_node(self.nl, g, 0, self.as_node(a))
        ops.add_to_node(self.nl, g, 1, self.as_node(b))
        o = out if out is not None else self.new_node()
        ops.add_to_node(self.nl, g, 2, o)
        self.report.gate_count += 1
        return o

    def g_and(self, a, b, out=None):
        from ..digital.logic import AND_TABLE
        if a is C0 or b is C0:
            return self._const_or_buf(C0, out)
        if a is C1 and not isinstance(b, int):
            return self._alias(b, out)
        if b is C1 and not isinstance(a, int):
            return self._alias(a, out)
        return self.gate2(AND, a, b, out,
                          fold=lambda x, y: int(AND_TABLE[x, y]))

    def g_or(self, a, b, out=None):
        from ..digital.logic import OR_TABLE
        if a is C1 or b is C1:
            return self._const_or_buf(C1, out)
        if a is C0 and not isinstance(b, int):
            return self._alias(b, out)
        if b is C0 and not isinstance(a, int):
            return self._alias(a, out)
        return self.gate2(OR, a, b, out,
                          fold=lambda x, y: int(OR_TABLE[x, y]))

    def g_xor(self, a, b, out=None):
        from ..digital.logic import XOR_TABLE
        if a is C0 and not isinstance(b, int):
            return self._alias(b, out)
        if b is C0 and not isinstance(a, int):
            return self._alias(a, out)
        if a is C1 and not isinstance(b, int):
            return self.g_not(b, out)
        if b is C1 and not isinstance(a, int):
            return self.g_not(a, out)
        return self.gate2(XOR, a, b, out,
                          fold=lambda x, y: int(XOR_TABLE[x, y]))

    def g_xnor(self, a, b, out=None):
        from ..digital.logic import XNOR_TABLE
        return self.gate2(XNOR, a, b, out,
                          fold=lambda x, y: int(XNOR_TABLE[x, y]))

    def g_case_eq(self, a, b, out=None):
        """4-state case equality (===): X/Z compare as themselves."""
        def fold(x, y):
            return 1 if x == y else 0
        return self.gate2(CASE_EQ, a, b, out, fold=fold)

    def g_not(self, a, out=None):
        from ..digital.logic import NOT_TABLE
        if isinstance(a, int):
            return self._const_or_buf(int(NOT_TABLE[a]), out)
        g = ops.add_model(self.nl, NOT)
        ops.add_to_node(self.nl, g, 0, a)
        o = out if out is not None else self.new_node()
        ops.add_to_node(self.nl, g, 1, o)
        self.report.gate_count += 1
        return o

    def buf(self, a: NetT, out: Node):
        """Drive `out` with the value of net a via a YES buffer."""
        g = ops.add_model(self.nl, YES)
        ops.add_to_node(self.nl, g, 0, self.as_node(a))
        ops.add_to_node(self.nl, g, 1, out)
        self.report.gate_count += 1
        return out

    def _const_or_buf(self, code: int, out: Optional[Node]):
        if out is None:
            return code
        return self.buf(code, out)

    def _alias(self, net: NetT, out: Optional[Node]):
        if out is None:
            return net
        return self.buf(net, out)

    def g_mux(self, c: NetT, f: NetT, t: NetT, out=None):
        """out = c ? t : f  (note arg order: false, true)."""
        if isinstance(c, int):
            if c == C1:
                return self._alias(t, out)
            if c == C0:
                return self._alias(f, out)
        if t is f and out is None:
            return t
        nc = self.g_not(c)
        a1 = self.g_and(c, t)
        a0 = self.g_and(nc, f)
        return self.g_or(a0, a1, out)

    def full_add(self, a: NetT, b: NetT, cin: NetT):
        """Returns (sum, cout), using FULL_ADDER blocks unless constant."""
        consts = [x for x in (a, b, cin) if isinstance(x, int)]
        if len(consts) == 3:
            total = sum(consts)
            if any(x == CX for x in consts):
                return CX, CX
            return total & 1, (total >> 1) & 1
        if cin is C0:
            if isinstance(b, int) and b == C0:
                return a, C0
            if isinstance(a, int) and a == C0:
                return b, C0
            g = ops.add_model(self.nl, HALF_ADDER)
            ops.add_to_node(self.nl, g, 0, self.as_node(a))
            ops.add_to_node(self.nl, g, 1, self.as_node(b))
            s = self.new_node()
            c = self.new_node()
            ops.add_to_node(self.nl, g, 2, s)
            ops.add_to_node(self.nl, g, 3, c)
            self.report.gate_count += 1
            return s, c
        g = ops.add_model(self.nl, FULL_ADDER)
        ops.add_to_node(self.nl, g, 0, self.as_node(a))
        ops.add_to_node(self.nl, g, 1, self.as_node(b))
        ops.add_to_node(self.nl, g, 2, self.as_node(cin))
        s = self.new_node()
        c = self.new_node()
        ops.add_to_node(self.nl, g, 3, s)
        ops.add_to_node(self.nl, g, 4, c)
        self.report.gate_count += 1
        return s, c


# ---------------------------------------------------------------------------
# bit-vector helpers over Net lists (LSB first)
# ---------------------------------------------------------------------------

def _const_bits(val: Val) -> List[NetT]:
    out = []
    for i in range(val.width):
        code = val.bit(i)
        out.append(CX if code >= 2 else code)
    return out


def _resize_bits(bits: List[NetT], width: int, signed: bool) -> List[NetT]:
    if len(bits) >= width:
        return bits[:width]
    fill = bits[-1] if (signed and bits) else C0
    return bits + [fill] * (width - len(bits))


class BitSynth:
    """Symbolic bit-level executor for one instance scope."""

    def __init__(self, ctx: SynthContext, inst: InstanceState,
                 sigbits: Dict[str, List[NetT]]):
        self.ctx = ctx
        self.inst = inst
        self.sigbits = sigbits        # signal -> LSB-first nets
        self._const_ctx = EvalCtx(params=inst.params, signals={},
                                  functions=inst.functions, inst=inst)

    # -- width helpers -------------------------------------------------------
    def width_of(self, expr) -> int:
        info = self._array_ref(expr)
        if info is not None:
            return info[1]
        return self_width(expr, self._const_ctx_sig())

    def _array_ref(self, expr) -> Optional[Tuple[int, int]]:
        """(depth, word_width) when expr is an index into a memory."""
        if expr[0] == "index" and expr[1][0] == "id":
            sig = self.inst.signals.get(expr[1][1])
            if sig is not None and sig.array_len:
                return sig.array_len, sig.width
        return None

    def _const_ctx_sig(self) -> EvalCtx:
        # width queries need signal widths but not values
        return EvalCtx(params=self.inst.params, signals={},
                       functions=self.inst.functions, inst=self.inst)

    def try_const(self, expr) -> Optional[Val]:
        """Evaluate expr if it is constant (params only)."""
        try:
            return eval_expr(expr, self._const_ctx)
        except Exception:
            return None

    # -- expression lowering ------------------------------------------------
    def lower(self, expr, env: Dict[str, List[NetT]],
              ctx_width: Optional[int] = None) -> List[NetT]:
        op = expr[0]
        if op == "num":
            bits = _const_bits(expr[1])
            if ctx_width and ctx_width > len(bits):
                bits = _resize_bits(bits, ctx_width, expr[1].signed)
            return bits
        if op == "id":
            name = expr[1]
            if name in env:
                bits = list(env[name])
            elif name in self.inst.params:
                bits = _const_bits(self.inst.params[name])
            elif "." in name:
                # hierarchical read inst.port: the value on the nets
                # bound to that child port connection
                bits = self._hier_bits(name, env)
            else:
                raise CompileError(f"synth: unknown signal {name!r}")
            signed = (name in self.inst.signals and
                      self.inst.signals[name].signed)
            if ctx_width and ctx_width > len(bits):
                bits = _resize_bits(bits, ctx_width, signed)
            return bits
        if op == "index":
            idx = self.try_const(expr[2])
            arr = self._array_ref(expr)
            if arr is not None:
                depth, w = arr
                flat = list(env[expr[1][1]])
                if idx is not None and idx.known:
                    i = idx.to_int()
                    if 0 <= i < depth:
                        return flat[i * w:(i + 1) * w]
                    return [CX] * w
                sel_bits = self.lower(expr[2], env)
                return [self._mux_select(flat[j::w], sel_bits)
                        for j in range(w)]
            base_bits = self.lower(expr[1], env)
            if idx is not None and idx.known:
                i = idx.to_int()
                return [base_bits[i] if 0 <= i < len(base_bits) else CX]
            # variable index -> mux tree
            sel_bits = self.lower(expr[2], env)
            return [self._mux_select(base_bits, sel_bits)]
        if op == "slice":
            hi = self.try_const(expr[2])
            lo = self.try_const(expr[3])
            if hi is None or lo is None:
                raise CompileError("synth: non-constant slice bounds")
            h, l = hi.to_signed_int(), lo.to_signed_int()
            if h < l:
                h, l = l, h
            base_bits = self.lower(expr[1], env)
            return [base_bits[i] if 0 <= i < len(base_bits) else CX
                    for i in range(l, h + 1)]
        if op == "pslice":
            base = self.try_const(expr[2])
            w = self.try_const(expr[3]).to_int()
            base_bits = self.lower(expr[1], env)
            if base is not None:
                b = base.to_signed_int()
                l = b if expr[4] == "+" else b - w + 1
                return [base_bits[i] if 0 <= i < len(base_bits) else CX
                        for i in range(l, l + w)]
            # variable base: out[k] = base_bits[sel (+/-) k] via a mux
            # tree per output bit (indexed part-select)
            sel_bits = self.lower(expr[2], env)
            out = []
            for k in range(w):
                if expr[4] == "+":
                    view = base_bits[k:] if k < len(base_bits) else []
                else:
                    # a[sel -: w]: bit k reads index sel-(w-1)+k
                    pad = w - 1 - k
                    view = [CX] * pad + base_bits
                out.append(self._mux_select(
                    view if view else [CX], sel_bits))
            return out
        if op == "concat":
            out: List[NetT] = []
            for part in reversed(expr[1]):      # LSB last in source
                out.extend(self.lower(part, env))
            return out
        if op == "repl":
            n = self.try_const(expr[1]).to_int()
            inner = self.lower(expr[2], env)
            return inner * n
        if op == "unary":
            return self._lower_unary(expr, env, ctx_width)
        if op == "binary":
            return self._lower_binary(expr, env, ctx_width)
        if op == "cond":
            c = self.reduce_or(self.lower(expr[1], env))
            w = max(self.width_of(expr), ctx_width or 0)
            t = _resize_bits(self.lower(expr[2], env, w), w, False)
            f = _resize_bits(self.lower(expr[3], env, w), w, False)
            return [self.ctx.g_mux(c, f[i], t[i]) for i in range(w)]
        if op == "call":
            return self._lower_call(expr, env, ctx_width)
        if op == "syscall":
            v = self.try_const(expr)
            if v is not None:
                return _const_bits(v)
            if expr[1] in ("$signed", "$unsigned"):
                return self.lower(expr[2][0], env, ctx_width)
            raise CompileError(f"synth: unsupported syscall {expr[1]}")
        if op == "cast":
            bits = self.lower(expr[3], env, expr[1])
            return _resize_bits(bits, expr[1],
                                self._expr_signed(expr[3]))
        raise CompileError(f"synth: unsupported expr {op}")

    def _hier_bits(self, name: str, env) -> List[NetT]:
        """inst.port -> bits of the parent expression bound to that
        child port (one level; covers the u0.y idiom)."""
        head, _, rest = name.partition(".")
        for child in self.inst.children:
            if child.name != head:
                continue
            for b in child.bindings:
                if b.port == rest:
                    w = child.signals[b.port].width
                    return _resize_bits(self.lower(b.expr, env, w),
                                        w, False)
        raise CompileError(f"synth: unresolved hierarchical {name!r}")

    def _expr_signed(self, expr) -> bool:
        """Verilog self-determined signedness of an expression, as far
        as shifts/compares need it: signed ids, $signed(...) casts, and
        parenthesized/conditional combinations thereof."""
        op = expr[0]
        if op == "id" and expr[1] in self.inst.signals:
            return self.inst.signals[expr[1]].signed
        if op == "id" and expr[1] in self.inst.params:
            return bool(getattr(self.inst.params[expr[1]], "signed",
                                False))
        if op == "syscall" and expr[1] == "$signed":
            return True
        if op == "syscall" and expr[1] == "$unsigned":
            return False
        if op == "num":
            return bool(getattr(expr[1], "signed", False))
        if op == "cond":
            return (self._expr_signed(expr[2]) and
                    self._expr_signed(expr[3]))
        if op == "cast":
            return (self._expr_signed(expr[3]) if expr[2] is None
                    else bool(expr[2]))
        if op == "unary" and expr[1] in ("+", "-", "~"):
            return self._expr_signed(expr[2])
        if op == "binary" and expr[1] in ("+", "-", "*", "/", "%",
                                          "&", "|", "^", "~^", "^~"):
            return (self._expr_signed(expr[2]) and
                    self._expr_signed(expr[3]))
        return False

    def _mux_select(self, bits: List[NetT], sel: List[NetT]) -> NetT:
        cur = list(bits)
        for k, s in enumerate(sel):
            if len(cur) <= 1:
                break
            nxt = []
            for i in range(0, len(cur), 2):
                a = cur[i]
                b = cur[i + 1] if i + 1 < len(cur) else CX
                nxt.append(self.ctx.g_mux(s, a, b))
            cur = nxt
        return cur[0] if cur else CX

    def reduce_or(self, bits: List[NetT]) -> NetT:
        acc: NetT = C0
        for b in bits:
            acc = self.ctx.g_or(acc, b)
        return acc

    def reduce_and(self, bits: List[NetT]) -> NetT:
        acc: NetT = C1
        for b in bits:
            acc = self.ctx.g_and(acc, b)
        return acc

    def reduce_xor(self, bits: List[NetT]) -> NetT:
        acc: NetT = C0
        for b in bits:
            acc = self.ctx.g_xor(acc, b)
        return acc

    def _lower_unary(self, expr, env, ctx_width):
        o = expr[1]
        if o == "~":
            bits = self.lower(expr[2], env, ctx_width)
            return [self.ctx.g_not(b) for b in bits]
        if o == "!":
            return [self.ctx.g_not(self.reduce_or(
                self.lower(expr[2], env)))]
        if o == "&":
            return [self.reduce_and(self.lower(expr[2], env))]
        if o == "|":
            return [self.reduce_or(self.lower(expr[2], env))]
        if o == "^":
            return [self.reduce_xor(self.lower(expr[2], env))]
        if o == "~&":
            return [self.ctx.g_not(self.reduce_and(
                self.lower(expr[2], env)))]
        if o == "~|":
            return [self.ctx.g_not(self.reduce_or(
                self.lower(expr[2], env)))]
        if o in ("~^", "^~"):
            return [self.ctx.g_not(self.reduce_xor(
                self.lower(expr[2], env)))]
        if o == "+":
            return self.lower(expr[2], env, ctx_width)
        if o == "-":
            bits = self.lower(expr[2], env, ctx_width)
            return self._negate(bits)
        raise CompileError(f"synth: unary {o}")

    def _negate(self, bits: List[NetT]) -> List[NetT]:
        inv = [self.ctx.g_not(b) for b in bits]
        out = []
        carry: NetT = C1
        for b in inv:
            s, carry = self.ctx.full_add(b, C0, carry)
            out.append(s)
        return out

    def _lower_binary(self, expr, env, ctx_width):
        o = expr[1]
        ctx = self._const_ctx_sig()
        if o in ("+", "-", "&", "|", "^", "~^", "^~", "*"):
            w = max(self.width_of(expr), ctx_width or 0)
            a = _resize_bits(self.lower(expr[2], env, w), w, False)
            b = _resize_bits(self.lower(expr[3], env, w), w, False)
            if o == "&":
                return [self.ctx.g_and(x, y) for x, y in zip(a, b)]
            if o == "|":
                return [self.ctx.g_or(x, y) for x, y in zip(a, b)]
            if o == "^":
                return [self.ctx.g_xor(x, y) for x, y in zip(a, b)]
            if o in ("~^", "^~"):
                return [self.ctx.g_xnor(x, y) for x, y in zip(a, b)]
            if o == "+":
                return self._add(a, b, w)
            if o == "-":
                return self._add(a, [self.ctx.g_not(x) for x in b], w,
                                 cin=C1)
            if o == "*":
                return self._mul(a, b, w)
        if o in ("/", "%"):
            w = max(self.width_of(expr), ctx_width or 0)
            a = _resize_bits(self.lower(expr[2], env, w), w, False)
            b = _resize_bits(self.lower(expr[3], env, w), w, False)
            q, r = self._divmod(a, b, w)
            return q if o == "/" else r
        if o == "**":
            # square-and-multiply over the exponent bits (wrapping
            # modulo 2^w like the behavioral engine); exponent bits
            # beyond ceil(log2(w)) + a margin cannot change a result
            # that survives the wrap unless the base is 0/1, so keep
            # them (cap at 16 to bound the network)
            w = max(self.width_of(expr), ctx_width or 0)
            a = _resize_bits(self.lower(expr[2], env, w), w, False)
            e = self.lower(expr[3], env)[:16]
            acc: List[NetT] = _resize_bits([C1], w, False)
            cur = a
            for s in e:
                mul = self._mul(acc, cur, w)
                acc = [self.ctx.g_mux(s, x, m)
                       for x, m in zip(acc, mul)]
                cur = self._mul(cur, cur, w)
            return acc
        if o in ("==", "!="):
            a = self.lower(expr[2], env)
            b = self.lower(expr[3], env)
            w = max(len(a), len(b))
            # equality extends SIGNED iff both operands are signed
            # (same rule as the ordering comparisons; a signed reg
            # against a negative integer localparam must sign-extend)
            sgn = (self._expr_signed(expr[2]) and
                   self._expr_signed(expr[3]))
            a = _resize_bits(a, w, sgn)
            b = _resize_bits(b, w, sgn)
            eqs = [self.ctx.g_xnor(x, y) for x, y in zip(a, b)]
            eq = self.reduce_and(eqs)
            return [eq if o == "==" else self.ctx.g_not(eq)]
        if o in ("===", "!=="):
            # 4-state case equality (case_eq.h): X/Z match literally
            a = self.lower(expr[2], env)
            b = self.lower(expr[3], env)
            w = max(len(a), len(b))
            sgn = (self._expr_signed(expr[2]) and
                   self._expr_signed(expr[3]))
            a = _resize_bits(a, w, sgn)
            b = _resize_bits(b, w, sgn)
            eqs = [self.ctx.g_case_eq(x, y) for x, y in zip(a, b)]
            eq = self.reduce_and(eqs)
            return [eq if o == "===" else self.ctx.g_not(eq)]
        if o in ("<", "<=", ">", ">="):
            a = self.lower(expr[2], env)
            b = self.lower(expr[3], env)
            w = max(len(a), len(b))
            # Verilog: comparison is signed iff BOTH operands are signed
            sgn = self._expr_signed(expr[2]) and self._expr_signed(expr[3])
            a = _resize_bits(a, w, sgn)
            b = _resize_bits(b, w, sgn)
            if sgn:
                # signed compare == unsigned compare with MSBs flipped
                a = a[:-1] + [self.ctx.g_not(a[-1])]
                b = b[:-1] + [self.ctx.g_not(b[-1])]
            # a - b: borrow out means a < b (unsigned)
            nb = [self.ctx.g_not(x) for x in b]
            carry: NetT = C1
            diff = []
            for x, y in zip(a, nb):
                s, carry = self.ctx.full_add(x, y, carry)
                diff.append(s)
            ge = carry                       # no borrow -> a >= b
            lt = self.ctx.g_not(ge)
            eq = self.reduce_and(
                [self.ctx.g_xnor(x, y) for x, y in zip(a, b)])
            if o == "<":
                return [lt]
            if o == ">=":
                return [ge]
            if o == ">":
                return [self.ctx.g_and(ge, self.ctx.g_not(eq))]
            return [self.ctx.g_or(lt, eq)]
        if o in ("&&", "||"):
            a = self.reduce_or(self.lower(expr[2], env))
            b = self.reduce_or(self.lower(expr[3], env))
            return [self.ctx.g_and(a, b) if o == "&&"
                    else self.ctx.g_or(a, b)]
        if o in ("<<", ">>", "<<<", ">>>"):
            w = max(self.width_of(expr[2], ) if False else
                    self_width(expr[2], ctx), ctx_width or 0)
            a = _resize_bits(self.lower(expr[2], env, w), w, False)
            shv = self.try_const(expr[3])
            signed = self._expr_signed(expr[2])
            fill_left = a[-1] if (o == ">>>" and signed) else C0
            if shv is not None and shv.known:
                sh = shv.to_int()
                if o == "<<" or o == "<<<":
                    return ([C0] * min(sh, w) + a)[:w]
                shifted = a[sh:] if sh < w else []
                return shifted + [fill_left] * (w - len(shifted))
            sel = self.lower(expr[3], env)
            cur = a
            for k, s in enumerate(sel):
                amt = 1 << k
                if amt >= 2 * w:
                    break
                if o in ("<<", "<<<"):
                    shifted = ([C0] * min(amt, w) + cur)[:w]
                else:
                    shifted = cur[amt:] + [fill_left] * min(amt, w)
                cur = [self.ctx.g_mux(s, cur[i], shifted[i])
                       for i in range(w)]
            return cur
        raise CompileError(f"synth: binary {o}")

    def _add(self, a: List[NetT], b: List[NetT], w: int,
             cin: NetT = C0) -> List[NetT]:
        out = []
        carry = cin
        for x, y in zip(a, b):
            s, carry = self.ctx.full_add(x, y, carry)
            out.append(s)
        return out[:w]

    def _divmod(self, a: List[NetT], b: List[NetT], w: int):
        """Unsigned restoring division network: (quotient, remainder).
        Division by zero yields all-ones / the dividend (the behavioral
        engine returns X there, which the cross-check treats as free)."""
        rem: List[NetT] = [C0] * w
        q: List[NetT] = [C0] * w
        for i in reversed(range(w)):
            rem = [a[i]] + rem[:w - 1]
            nb = [self.ctx.g_not(x) for x in b]
            carry: NetT = C1
            diff = []
            for x, y in zip(rem, nb):
                s, carry = self.ctx.full_add(x, y, carry)
                diff.append(s)
            ge = carry                   # no borrow -> rem >= b
            q[i] = ge
            rem = [self.ctx.g_mux(ge, r, d)
                   for r, d in zip(rem, diff)]
        return q, rem

    def _mul(self, a: List[NetT], b: List[NetT], w: int) -> List[NetT]:
        # digit lowering pays off once the graph tier's MUL2 extraction
        # runs (O2+); below that the shift-add form is smaller (its
        # adders are emitted as macro blocks already)
        if (self.ctx.opt.optimize_mul2 and self.ctx.opt.opt_level >= 2
                and len(a) >= 2 and len(b) >= 2):
            return self._mul_digits(a, b, w)
        acc: List[NetT] = [C0] * w
        for i, bi in enumerate(b):
            if bi is C0 or i >= w:
                continue
            part = [C0] * i + [self.ctx.g_and(x, bi) for x in a[:w - i]]
            acc = self._add(acc, _resize_bits(part, w, False), w)
        return acc

    def _mul_digits(self, a: List[NetT], b: List[NetT],
                    w: int) -> List[NetT]:
        """School multiplication over 2-bit digits: each digit product
        is the exact 8-gate MUL2 web (p0=a0b0, p1=a1b0^a0b1,
        c1=a1b0&a0b1, p2=a1b1^c1, p3=a1b1&c1) so the optimizer's MUL2
        extraction collapses it into one macro — the reference's own
        `*` lowering shape (pe_synth.h optimize_mul2_in_pe_netlist:1368
        finds 16 such webs in its 8x8 multiply)."""
        g = self.ctx
        acc: List[NetT] = [C0] * w
        da = a + [C0] * (len(a) & 1)
        db = b + [C0] * (len(b) & 1)
        for i in range(0, len(da), 2):
            if i >= w:
                break
            a0, a1 = da[i], da[i + 1]
            for j in range(0, len(db), 2):
                sh = i + j
                if sh >= w:
                    break
                b0, b1 = db[j], db[j + 1]
                if (a0 is C0 and a1 is C0) or (b0 is C0 and b1 is C0):
                    continue
                t1 = g.g_and(a1, b0)
                t2 = g.g_and(a0, b1)
                p0 = g.g_and(a0, b0)
                p1 = g.g_xor(t1, t2)
                c1 = g.g_and(t1, t2)
                t3 = g.g_and(a1, b1)
                p2 = g.g_xor(t3, c1)
                p3 = g.g_and(t3, c1)
                part = [C0] * sh + [p0, p1, p2, p3]
                acc = self._add(acc, _resize_bits(part, w, False), w)
        return acc

    def _lower_call(self, expr, env, ctx_width):
        f = self.inst.functions.get(expr[1])
        if f is None:
            raise CompileError(f"synth: unknown function {expr[1]}")
        # inline: bind args symbolically and execute the body
        local_env = dict(env)
        cctx = self._const_ctx
        for decl, a in zip(f.args, expr[2]):
            w = 1
            if decl.msb is not None:
                hi = eval_expr(decl.msb, cctx).to_signed_int()
                lo = eval_expr(decl.lsb, cctx).to_signed_int()
                w = abs(hi - lo) + 1
            local_env[decl.name] = _resize_bits(
                self.lower(a, env, w), w, False)
        rw = 1
        if f.ret.msb is not None:
            hi = eval_expr(f.ret.msb, cctx).to_signed_int()
            lo = eval_expr(f.ret.lsb, cctx).to_signed_int()
            rw = abs(hi - lo) + 1
        local_env[f.name] = [CX] * rw
        for lname, ldecl in f.locals.items():
            w = 1
            if ldecl.msb is not None:
                hi = eval_expr(ldecl.msb, cctx).to_signed_int()
                lo = eval_expr(ldecl.lsb, cctx).to_signed_int()
                w = abs(hi - lo) + 1
            local_env[lname] = [CX] * w
        local_env["__ret__"] = [C0]       # early-return guard flag
        self._func_stack.append(f.name)
        try:
            self.exec_stmt(f.body, local_env, None)
        finally:
            self._func_stack.pop()
        return local_env[f.name]

    # -- symbolic statement execution ---------------------------------------
    # break/continue/return lower to guard flags in the environment:
    # the normal if/case copy-merge machinery muxes the flags, and the
    # block handler guards every statement after a potentially-set flag
    # (pe_synth.h "bounded unrolling for dynamic for/while" +
    # break/continue support role).
    _FLAG_NAMES = ("__brk__", "__cont__", "__ret__")

    @property
    def _func_stack(self):
        return self.__dict__.setdefault("_fstack", [])

    def _flags_or(self, env):
        """OR of possibly-set abort flags; None when provably clear."""
        net = None
        for f in self._FLAG_NAMES:
            b = env.get(f)
            if b is None or b[0] is C0:
                continue
            net = b[0] if net is None else self.ctx.g_or(net, b[0])
        return net

    def _exec_guarded(self, c, stmt, env, nba):
        """Execute ``stmt`` as if under ``if (c)`` (copy-merge)."""
        if isinstance(c, int):
            if c == C1:
                self.exec_stmt(stmt, env, nba)
                return
            if c == C0:
                return
        env_t = dict(env)
        nba_t = dict(nba) if nba is not None else None
        env_f = dict(env)
        nba_f = dict(nba) if nba is not None else None
        self.exec_stmt(stmt, env_t, nba_t)
        self._merge(c, env, env_f, env_t, env_f, env_t)
        if nba is not None:
            self._merge(c, nba, nba_f, nba_t, env_f, env_t)

    def _exec_loop(self, cond, body, step, env, nba, do_first):
        """Bounded guarded unrolling of while/do-while/dynamic-for.
        Correct whenever the runtime trip count stays within
        ``dyn_loop_unroll`` (the reference's loop_unroll_limit
        semantics for dynamic loops)."""
        limit = max(1, getattr(self.ctx.opt, "dyn_loop_unroll", 64))
        saved_brk = env.get("__brk__")
        saved_cont = env.get("__cont__")
        env["__brk__"] = [C0]
        truncated = False
        for k in range(limit):
            env["__cont__"] = [C0]
            if do_first and k == 0:
                c: NetT = C1
            else:
                c = self.reduce_or(self.lower(cond, env))
            brk = env["__brk__"][0]
            ret = env.get("__ret__", [C0])[0]
            stop = self.ctx.g_or(brk, ret)
            act = self.ctx.g_and(c, self.ctx.g_not(stop))
            if act is C0:
                break
            self._exec_guarded(act, body, env, nba)
            if step is not None:
                # continue jumps TO the step, so only brk/ret gate it
                brk2 = env["__brk__"][0]
                ret2 = env.get("__ret__", [C0])[0]
                act2 = self.ctx.g_and(act, self.ctx.g_not(
                    self.ctx.g_or(brk2, ret2)))
                self._exec_guarded(act2, step, env, nba)
        else:
            # all `limit` copies emitted: check whether the guard is
            # provably false after the last one
            c = self.reduce_or(self.lower(cond, env))
            brk = env["__brk__"][0]
            ret = env.get("__ret__", [C0])[0]
            if self.ctx.g_and(c, self.ctx.g_not(
                    self.ctx.g_or(brk, ret))) is not C0:
                truncated = True
        if truncated:
            # the guard was still (possibly) active after the last
            # unrolled copy: runtime trips beyond the bound would be
            # silently dropped, so surface it (the reference's dynamic
            # loops share exactly this truncation semantics)
            self.ctx.report.warnings.append(
                f"dynamic loop unrolled {limit}x and the exit "
                "condition is not provably reached; raise "
                "dyn_loop_unroll if the runtime trip count can exceed "
                "the bound")
        if saved_brk is None:
            env.pop("__brk__", None)
        else:
            env["__brk__"] = saved_brk
        if saved_cont is None:
            env.pop("__cont__", None)
        else:
            env["__cont__"] = saved_cont

    def _exec_calltask(self, stmt, env, nba):
        """Inline a task call: bind inputs, run the body against the
        module environment (tasks may write module state), write
        outputs back."""
        name, args = stmt[1], stmt[2]
        t = self.inst.tasks.get(name)
        if t is None:
            raise CompileError(f"synth: unknown task {name}")
        cctx = self._const_ctx

        def decl_width(decl):
            if decl.msb is None:
                return 1
            hi = eval_expr(decl.msb, cctx).to_signed_int()
            lo = eval_expr(decl.lsb, cctx).to_signed_int()
            return abs(hi - lo) + 1

        shadow = {}
        outs = []
        for decl, a in zip(t.args, args):
            w = decl_width(decl)
            shadow[decl.name] = env.get(decl.name)
            d = decl.direction or "input"
            if d in ("input", "inout"):
                env[decl.name] = _resize_bits(self.lower(a, env, w),
                                              w, False)
            else:
                env[decl.name] = [CX] * w
            if d in ("output", "inout"):
                outs.append((a, decl.name, w))
        for lname, ldecl in t.locals.items():
            shadow[lname] = env.get(lname)
            env[lname] = [CX] * decl_width(ldecl)
        shadow["__ret__"] = env.get("__ret__")
        env["__ret__"] = [C0]
        self.exec_stmt(t.body, env, nba)
        out_bits = [(a, list(env[n]), w) for a, n, w in outs]
        for n, old in shadow.items():
            if old is None:
                env.pop(n, None)
            else:
                env[n] = old
        for a, bits, w in out_bits:
            self._assign_bits(a, bits, env, env)

    def exec_stmt(self, stmt, env: Dict[str, List[NetT]],
                  nba: Optional[Dict[str, List[NetT]]]):
        if stmt is None:
            return
        op = stmt[0]
        if op == "block":
            stmts = stmt[1]
            for si, s in enumerate(stmts):
                self.exec_stmt(s, env, nba)
                if si + 1 < len(stmts):
                    fl = self._flags_or(env)
                    if fl is not None:
                        # break/continue/return may be pending: guard
                        # the remainder of the block on "no flag set"
                        self._exec_guarded(
                            self.ctx.g_not(fl),
                            ("block", list(stmts[si + 1:])), env, nba)
                        return
            return
        if op == "break":
            env["__brk__"] = [C1]
            return
        if op == "continue":
            env["__cont__"] = [C1]
            return
        if op == "return":
            if stmt[1] is not None and self._func_stack:
                self._assign(("id", self._func_stack[-1]), stmt[1],
                             env, env)
            env["__ret__"] = [C1]
            return
        if op == "while":
            self._exec_loop(stmt[1], stmt[2], None, env, nba,
                            do_first=False)
            return
        if op == "do_while":
            self._exec_loop(stmt[2], stmt[1], None, env, nba,
                            do_first=True)
            return
        if op == "calltask":
            self._exec_calltask(stmt, env, nba)
            return
        if op == "blocking":
            self._assign(stmt[1], stmt[2], env, env)
            return
        if op == "nonblocking":
            tgt = nba if nba is not None else env
            self._assign(stmt[1], stmt[2], env, tgt)
            return
        if op == "if":
            cval = self.try_const(stmt[1])
            if cval is not None and cval.known:
                self.exec_stmt(stmt[2] if cval.to_int() else stmt[3],
                               env, nba)
                return
            c = self.reduce_or(self.lower(stmt[1], env))
            env_t = dict(env)
            nba_t = dict(nba) if nba is not None else None
            env_f = dict(env)
            nba_f = dict(nba) if nba is not None else None
            self.exec_stmt(stmt[2], env_t, nba_t)
            self.exec_stmt(stmt[3], env_f, nba_f)
            self._merge(c, env, env_f, env_t, env_f, env_t)
            if nba is not None:
                # a branch with no pending NBA for a signal holds the
                # signal's current value (FF reload) in that branch
                self._merge(c, nba, nba_f, nba_t, env_f, env_t)
            return
        if op == "case":
            self._exec_case(stmt, env, nba)
            return
        if op == "for":
            # constant unroll using the behavioral evaluator for the
            # loop variable (pe_synth.h loop_unroll_limit analogue)
            self._exec_for(stmt, env, nba)
            return
        if op == "systask":
            return
        if op == "delay":
            # #N -> TICK_DELAY chain is applied at the assign level in a
            # later pass; for now execute the body directly
            self.exec_stmt(stmt[2], env, nba)
            return
        raise CompileError(f"synth: unsupported statement {op}")

    def _exec_for(self, stmt, env, nba):
        init, cond, step, body = stmt[1], stmt[2], stmt[3], stmt[4]
        if init[0] != "blocking" or init[1][0] != "id":
            raise CompileError("synth: for-loop needs constant control")
        var = init[1][1]
        cctx = EvalCtx(params=dict(self.inst.params), signals={},
                       functions=self.inst.functions, inst=self.inst)
        try:
            cctx.params[var] = eval_expr(init[2], cctx)
            eval_expr(cond, cctx)       # probe: is the bound static?
        except SimError:
            # signal-dependent control: guarded bounded unrolling
            self._assign(init[1], init[2], env, env)
            self._exec_loop(cond, body, step, env, nba,
                            do_first=False)
            return
        count = 0
        saved_brk = env.get("__brk__")
        saved_cont = env.get("__cont__")
        env["__brk__"] = [C0]
        while True:
            c = eval_expr(cond, cctx)
            if not c.to_int():
                break
            env["__cont__"] = [C0]
            brk = env["__brk__"][0]
            ret = env.get("__ret__", [C0])[0]
            act = self.ctx.g_not(self.ctx.g_or(brk, ret))
            if act is C0:
                break                 # break/return already taken
            # expose the loop var as a constant to the body — both via
            # params (for try_const index folding) and via env (for
            # direct uses like slices of the loop variable, which would
            # otherwise read the local's X initializer)
            saved = self.inst.params.get(var)
            self.inst.params[var] = cctx.params[var]
            if var in env:
                env[var] = _const_bits(cctx.params[var])
            self._exec_guarded(act, body, env, nba)
            if saved is None:
                self.inst.params.pop(var, None)
            else:
                self.inst.params[var] = saved
            cctx.params[var] = eval_expr(step[2], cctx)
            count += 1
            if count > self.ctx.opt.loop_unroll_limit:
                raise CompileError("synth: loop unroll limit exceeded")
        if saved_brk is None:
            env.pop("__brk__", None)
        else:
            env["__brk__"] = saved_brk
        if saved_cont is None:
            env.pop("__cont__", None)
        else:
            env["__cont__"] = saved_cont

    def _exec_case(self, stmt, env, nba):
        kind, sel_expr, items, default = stmt[1], stmt[2], stmt[3], stmt[4]
        sel = self.lower(sel_expr, env)
        # build (match_net, body) list then mux from default upward
        branches = []
        for pats, body in items:
            conds = []
            for p in pats:
                pv = self.try_const(p)
                if pv is None:
                    pbits = self.lower(p, env)
                    w = max(len(sel), len(pbits))
                    a = _resize_bits(sel, w, False)
                    b = _resize_bits(pbits, w, False)
                    conds.append(self.reduce_and(
                        [self.ctx.g_xnor(x, y) for x, y in zip(a, b)]))
                else:
                    w = max(len(sel), pv.width)
                    a = _resize_bits(sel, w, False)
                    eqs = []
                    for i in range(w):
                        code = pv.bit(i)
                        if kind in ("casez", "casex") and code == 3:
                            continue          # z wildcard
                        if kind == "casex" and code == 2:
                            continue          # x wildcard
                        if code == 1:
                            eqs.append(a[i])
                        elif code == 0:
                            eqs.append(self.ctx.g_not(a[i]))
                        else:
                            eqs.append(CX)
                    conds.append(self.reduce_and(eqs) if eqs else C1)
            m = conds[0]
            for c2 in conds[1:]:
                m = self.ctx.g_or(m, c2)
            branches.append((m, body))
        # evaluate in priority order: default env, then later items win
        env_acc = dict(env)
        nba_acc = dict(nba) if nba is not None else None
        self.exec_stmt(default, env_acc, nba_acc)
        for m, body in reversed(branches):
            env_t = dict(env)
            nba_t = dict(nba) if nba is not None else None
            self.exec_stmt(body, env_t, nba_t)
            self._merge(m, env_acc, dict(env_acc), env_t, env_acc, env_t)
            if nba is not None:
                self._merge(m, nba_acc, dict(nba_acc), nba_t,
                            env_acc, env_t)
        env.clear()
        env.update(env_acc)
        if nba is not None:
            nba.clear()
            nba.update(nba_acc)
        return

    def _assign(self, lhs, rhs, read_env, write_env):
        if lhs[0] == "id":
            name = lhs[1]
            w = len(read_env.get(name, [])) or self.width_of(lhs)
            bits = _resize_bits(self.lower(rhs, read_env, w), w, False)
            write_env[name] = bits
            return
        if lhs[0] == "index":
            idx = self.try_const(lhs[2])
            name = lhs[1][1]
            cur = list(write_env.get(name, read_env.get(name, [])))
            arr = self._array_ref(lhs)
            if arr is not None:
                depth, w = arr
                val = _resize_bits(self.lower(rhs, read_env, w), w, False)
                if idx is not None and idx.known:
                    i = idx.to_int()
                    if 0 <= i < depth:
                        cur[i * w:(i + 1) * w] = val
                    write_env[name] = cur
                    return
                sel = self.lower(lhs[2], read_env)
                # demux write: word i = (sel==i) ? val : old
                for i in range(depth):
                    m = self._index_match(sel, i)
                    for j in range(w):
                        cur[i * w + j] = self.ctx.g_mux(
                            m, cur[i * w + j], val[j])
                write_env[name] = cur
                return
            val = self.lower(rhs, read_env, 1)
            if idx is not None and idx.known:
                i = idx.to_int()
                if 0 <= i < len(cur):
                    cur[i] = val[0]
                write_env[name] = cur
                return
            sel = self.lower(lhs[2], read_env)
            # demux write: bit i = (sel==i) ? val : old
            for i in range(len(cur)):
                m = self._index_match(sel, i)
                cur[i] = self.ctx.g_mux(m, cur[i], val[0])
            write_env[name] = cur
            return
        if lhs[0] == "slice":
            hi = self.try_const(lhs[2]).to_signed_int()
            lo = self.try_const(lhs[3]).to_signed_int()
            if hi < lo:
                hi, lo = lo, hi
            name = lhs[1][1]
            cur = list(write_env.get(name, read_env.get(name, [])))
            bits = _resize_bits(self.lower(rhs, read_env, hi - lo + 1),
                                hi - lo + 1, False)
            for k, i in enumerate(range(lo, hi + 1)):
                if 0 <= i < len(cur):
                    cur[i] = bits[k]
            write_env[name] = cur
            return
        if lhs[0] == "pslice":
            name = lhs[1][1]
            w = self.try_const(lhs[3]).to_int()
            cur = list(write_env.get(name, read_env.get(name, [])))
            bits = _resize_bits(self.lower(rhs, read_env, w), w, False)
            base = self.try_const(lhs[2])
            if base is not None and base.known:
                b = base.to_signed_int()
                l = b if lhs[4] == "+" else b - w + 1
                for k in range(w):
                    if 0 <= l + k < len(cur):
                        cur[l + k] = bits[k]
                write_env[name] = cur
                return
            # variable base: decoder write — bit i takes bits[k] when
            # the select equals the matching base index
            sel = self.lower(lhs[2], read_env)
            for i in range(len(cur)):
                v = cur[i]
                for k in range(w):
                    tgt = i - k if lhs[4] == "+" else i + (w - 1 - k)
                    if tgt < 0 or tgt >= (1 << len(sel)):
                        continue
                    m = self._index_match(sel, tgt)
                    v = self.ctx.g_mux(m, v, bits[k])
                cur[i] = v
            write_env[name] = cur
            return
        if lhs[0] == "concat":
            parts = lhs[1]
            widths = [self.width_of(p) for p in parts]
            total = sum(widths)
            bits = _resize_bits(self.lower(rhs, read_env, total), total,
                                False)
            pos = total
            for p, w in zip(parts, widths):
                pos -= w
                self._assign_bits(p, bits[pos:pos + w], read_env,
                                  write_env)
            return
        raise CompileError(f"synth: unsupported lvalue {lhs[0]}")

    def _assign_bits(self, lhs, bits, read_env, write_env):
        if lhs[0] == "id":
            name = lhs[1]
            w = len(read_env.get(name, [])) or self.width_of(lhs)
            write_env[name] = _resize_bits(bits, w, False)
            return
        raise CompileError("synth: complex concat lvalue element")

    def _index_match(self, sel: List[NetT], i: int) -> NetT:
        terms = []
        for k, s in enumerate(sel):
            want = (i >> k) & 1
            terms.append(s if want else self.ctx.g_not(s))
        return self.reduce_and(terms)

    def _merge(self, c: NetT, out_env, env_f, env_t,
               fb_f=None, fb_t=None):
        """out = c ? env_t[k] : env_f[k]; a missing key falls back to the
        same branch's signal value (hold), never the other branch's."""
        keys = set(env_f) | set(env_t)
        for k in keys:
            f = env_f.get(k)
            t = env_t.get(k)
            if f is None:
                f = (fb_f or {}).get(k, self.sigbits.get(k))
            if t is None:
                t = (fb_t or {}).get(k, self.sigbits.get(k))
            if f is None or t is None:
                out_env[k] = list(t if f is None else f)
                continue
            if f is t or f == t:
                out_env[k] = list(t)
                continue
            w = max(len(f), len(t))
            fb = _resize_bits(list(f), w, False)
            tb = _resize_bits(list(t), w, False)
            out_env[k] = [self.ctx.g_mux(c, fb[i], tb[i])
                          for i in range(w)]


# ---------------------------------------------------------------------------
# top-level synthesis
# ---------------------------------------------------------------------------

def synthesize_to_netlist(nl: Netlist, design, top_inst: InstanceState,
                          port_nets: Dict[str, List[Node]],
                          options: Optional[SynthOptions] = None
                          ) -> SynthReport:
    """Lower an elaborated instance tree into gate models in `nl`.

    ``port_nets``: top port name -> list of Nodes (LSB first; a single
    Node is accepted for 1-bit ports).
    """
    opt = options or SynthOptions()
    ctx = SynthContext(nl, opt)
    if not opt.allow_inout:
        for pname in top_inst.signals:
            sig = top_inst.signals[pname]
            if getattr(sig.decl, "direction", None) == "inout":
                raise CompileError(
                    f"synth: inout port {pname!r} (allow_inout off)")
    _synth_instance(ctx, top_inst, port_nets)
    _resolve_multi_drivers(ctx)
    ctx.report.gate_count_pre_opt = ctx.report.gate_count
    if opt.opt_level >= 1:
        from .optimize import optimize_netlist
        protected = []
        for nets in port_nets.values():
            protected.extend(nets if isinstance(nets, list) else [nets])
        stats = optimize_netlist(
            nl, protected, opt.opt_level,
            binary_ok=opt.assume_binary_inputs,
            wires=opt.optimize_wires,
            adders=opt.optimize_adders,
            mul2=opt.optimize_mul2,
            budgets=opt.budgets,
            omax={"restarts": opt.omax_restarts,
                  "time_budget_s": opt.omax_time_budget_s,
                  "verify": opt.omax_verify,
                  "cost_model": opt.omax_cost_model,
                  "weights": opt.omax_weights,
                  "seed": opt.omax_seed})
        ctx.report.opt_stats = stats
        # recount
        from ..models.base import DeviceClass
        ctx.report.gate_count = sum(
            1 for m in nl.live_models()
            if m.mdef.device_class == DeviceClass.DIGITAL and
            m.mdef.digital_op not in ("INPUT", "OUTPUT", "VERILOG"))
    return ctx.report


def _signal_nodes(ctx: SynthContext, inst: InstanceState,
                  port_nets: Dict[str, List[Node]]
                  ) -> Dict[str, List[NetT]]:
    sigbits: Dict[str, List[NetT]] = {}
    for name, sig in inst.signals.items():
        if name in inst.block_locals:
            continue               # locals get no module-visible nets
        if sig.array_len:
            # memory: array_len words flattened word-major into one bit
            # list; reads become per-bit mux trees, writes demux into
            # per-word enables, and FF lowering sees plain bit targets
            sigbits[name] = [ctx.new_node()
                             for _ in range(sig.array_len * sig.width)]
            continue
        if name in port_nets:
            nets = port_nets[name]
            if isinstance(nets, Node):
                nets = [nets]
            if len(nets) != sig.width:
                raise CompileError(
                    f"synth: port {name} width {sig.width} got "
                    f"{len(nets)} nets")
            sigbits[name] = list(nets)
        else:
            sigbits[name] = [ctx.new_node() for _ in range(sig.width)]
    return sigbits


def _synth_instance(ctx: SynthContext, inst: InstanceState,
                    port_nets: Dict[str, List[Node]]):
    sigbits = _signal_nodes(ctx, inst, port_nets)
    bs = BitSynth(ctx, inst, sigbits)

    # continuous assigns: drive the target nodes
    for lhs, rhs in inst.assigns:
        w = bs.width_of(lhs)
        tri = _tri_pattern(bs, rhs)
        if tri is not None:
            # assign y = en ? d : 'bz  ->  TRI_STATE per bit
            # (pe_synth tri-state lowering; Z branch may be either arm)
            en_expr, data_expr, active_high = tri
            en = bs.reduce_or(bs.lower(en_expr, sigbits))
            if not active_high:
                en = ctx.g_not(en)
            en_node = ctx.as_node(en)
            dbits = _resize_bits(bs.lower(data_expr, sigbits, w), w,
                                 False)
            nodes = _lvalue_nodes(ctx, bs, lhs, sigbits, w)
            from ..models import TRI_STATE
            for d, n in zip(dbits, nodes):
                g = ops.add_model(ctx.nl, TRI_STATE)
                ops.add_to_node(ctx.nl, g, 0, ctx.as_node(d))
                ops.add_to_node(ctx.nl, g, 1, en_node)
                ops.add_to_node(ctx.nl, g, 2, n)
                ctx.report.gate_count += 1
            continue
        bits = _resize_bits(bs.lower(rhs, sigbits, w), w, False)
        _drive_lvalue(ctx, bs, lhs, bits, sigbits)

    # always blocks
    for ab in inst.always_blocks:
        if ab.sensitivity is not None and any(
                e in ("pos", "neg") for e, _ in ab.sensitivity):
            if not ctx.opt.support_always_ff:
                raise CompileError(
                    "synth: always_ff blocks disabled "
                    "(support_always_ff off)")
            _synth_ff_block(ctx, bs, ab, sigbits)
        else:
            if not ctx.opt.support_always_comb:
                raise CompileError(
                    "synth: always_comb blocks disabled "
                    "(support_always_comb off)")
            _synth_comb_block(ctx, bs, ab, sigbits)

    # children
    for child in inst.children:
        child_ports: Dict[str, List[Node]] = {}
        for b in child.bindings:
            sig = child.signals[b.port]
            if b.direction == "input":
                bits = _resize_bits(
                    bs.lower(b.expr, sigbits, sig.width), sig.width, False)
                child_ports[b.port] = [ctx.as_node(x) for x in bits]
            else:
                # output: child drives parent lvalue nets; wider parent
                # targets get Verilog width adaptation (zero- or
                # sign-extension from the child MSB, matching the
                # behavioral child->parent resize in simulate.py)
                if b.expr[0] == "id" and b.expr[1] in sigbits:
                    pw = len(sigbits[b.expr[1]])
                    nets = _lvalue_nodes(ctx, bs, b.expr, sigbits, pw)
                else:
                    nets = _lvalue_nodes(ctx, bs, b.expr, sigbits,
                                         sig.width)
                if len(nets) > sig.width:
                    # wider parent: extend from the child MSB
                    ext, nets = nets[sig.width:], nets[:sig.width]
                    src = nets[-1] if sig.signed else C0
                    for n in ext:
                        ctx.buf(src, n)
                elif len(nets) < sig.width:
                    # narrower parent: child MSBs land on fresh dummy
                    # nets (NOT the shared const node, which they would
                    # otherwise corrupt as extra drivers)
                    nets = nets + [ctx.new_node()
                                   for _ in range(sig.width -
                                                  len(nets))]
                child_ports[b.port] = nets
        _synth_instance(ctx, child, child_ports)


def _tri_pattern(bs: BitSynth, rhs):
    """(en_expr, data_expr, en_active_high) when rhs is a conditional
    with an all-Z arm (tri-state driver idiom)."""
    if rhs[0] != "cond":
        return None
    for data_i, z_i, active in ((2, 3, True), (3, 2, False)):
        zv = bs.try_const(rhs[z_i])
        if zv is not None and zv.width > 0:
            m = (1 << zv.width) - 1
            if zv.v == m and zv.u == m:        # all bits Z
                return rhs[1], rhs[data_i], active
    return None


def _resolve_multi_drivers(ctx: SynthContext):
    """Nets with several digital drivers get a RESOLVE2 chain
    (pe_synth resolve_multi_driver_digital_nets): each driver moves to a
    private subnet and the chain's final output re-drives the net."""
    from ..models import RESOLVE2
    from ..models.base import DeviceClass
    nl = ctx.nl
    for node in list(nl.nodes):
        drv = [p for p in list(node.pins)
               if p.model.mdef.device_class == DeviceClass.DIGITAL
               and p.index in p.model.mdef.dout_pins
               and p.model.mdef.digital_op not in ("INPUT", "INPUT8")]
        if len(drv) < 2:
            continue
        if not ctx.opt.allow_multi_driver:
            raise CompileError(
                "synth: multi-driven net (allow_multi_driver off)")
        subnets = []
        for p in drv:
            n2 = ops.create_node(nl)
            m, idx = p.model, p.index
            ops.remove_from_node(nl, m, idx)
            ops.add_to_node(nl, m, idx, n2)
            subnets.append(n2)
        cur = subnets[0]
        for k, nx in enumerate(subnets[1:]):
            out = node if k == len(subnets) - 2 else ops.create_node(nl)
            r = ops.add_model(nl, RESOLVE2)
            ops.add_to_node(nl, r, 0, cur)
            ops.add_to_node(nl, r, 1, nx)
            ops.add_to_node(nl, r, 2, out)
            ctx.report.gate_count += 1
            cur = out


def _lvalue_nodes(ctx: SynthContext, bs: BitSynth, lhs,
                  sigbits, width: int) -> List[Node]:
    """Nets for an output-port connection target."""
    if lhs[0] == "id":
        nets = sigbits[lhs[1]]
        return [ctx.as_node(x) for x in _resize_bits(nets, width, False)]
    if lhs[0] == "slice":
        hi = bs.try_const(lhs[2]).to_signed_int()
        lo = bs.try_const(lhs[3]).to_signed_int()
        if hi < lo:
            hi, lo = lo, hi
        nets = sigbits[lhs[1][1]]
        return [ctx.as_node(nets[i]) for i in range(lo, hi + 1)]
    if lhs[0] == "index":
        i = bs.try_const(lhs[2]).to_int()
        nets = sigbits[lhs[1][1]]
        return [ctx.as_node(nets[i])]
    if lhs[0] == "pslice":
        base = bs.try_const(lhs[2])
        w = bs.try_const(lhs[3]).to_int()
        if base is None or not base.known:
            raise CompileError("synth: variable part-select "
                               "continuous-assign target")
        b = base.to_signed_int()
        lo = b if lhs[4] == "+" else b - w + 1
        nets = sigbits[lhs[1][1]]
        return [ctx.as_node(nets[i]) for i in range(lo, lo + w)
                if 0 <= i < len(nets)]
    if lhs[0] == "concat":
        out = []
        for p in reversed(lhs[1]):
            out.extend(_lvalue_nodes(ctx, bs, p, sigbits,
                                     bs.width_of(p)))
        return out
    raise CompileError("synth: unsupported output port target")


def _drive_lvalue(ctx: SynthContext, bs: BitSynth, lhs,
                  bits: List[NetT], sigbits):
    nodes = _lvalue_nodes(ctx, bs, lhs, sigbits, len(bits))
    for n, b in zip(nodes, bits):
        ctx.buf(b, n)


def _synth_comb_block(ctx: SynthContext, bs: BitSynth, ab, sigbits):
    """always_comb / always @*: feedback-style lowering — targets read
    their own output nets, so incomplete assignment becomes a latch loop
    handled by the digital engine's fixpoint group."""
    env = {k: list(v) for k, v in sigbits.items()}
    for name in bs.inst.block_locals:
        sig = bs.inst.signals[name]
        env[name] = [CX] * (sig.width * max(1, sig.array_len or 1))
    bs.exec_stmt(ab.body, env, None)
    for name, bits in env.items():
        if name not in sigbits:
            continue
        old = sigbits[name]
        if bits == old:
            continue
        for n, b in zip(old, bits):
            if b is not n:
                ctx.buf(b, ctx.as_node(n))


def _collect_const_assigns(bs: BitSynth, roots) -> Optional[Dict]:
    """name -> set of constant values ever assigned to it in the block
    (None entry = some RHS is non-constant).  Self-assignment
    (``state <= state``) counts as a hold, not a value.  Returns None
    when the whole block defeats the analysis (task calls can assign by
    side effect).  Feeds the FSM reachable-state DC inference
    (pe_synth.h DC-mining tier's one-hot FSM role, generalized to any
    constant-coded state register)."""
    vals: Dict[str, Optional[set]] = {}
    bad = False

    def lhs_ids(e, out):
        if isinstance(e, tuple):
            if e[0] == "id":
                out.append(e[1])
            for x in e[1:]:
                lhs_ids(x, out)
        elif isinstance(e, list):
            for x in e:
                lhs_ids(x, out)

    def note(lhs, rhs):
        if isinstance(lhs, tuple) and lhs[0] == "id":
            name = lhs[1]
            if vals.get(name, ()) is None:
                return
            if isinstance(rhs, tuple) and rhs[0] == "id" \
                    and rhs[1] == name:
                return                    # explicit hold
            v = bs.try_const(rhs)
            if v is None or any(v.bit(i) >= 2 for i in range(v.width)):
                vals[name] = None
                return
            vals.setdefault(name, set()).add(v.to_int())
        else:
            out: List[str] = []
            lhs_ids(lhs, out)
            for nm in out:
                vals[nm] = None

    def walk(st):
        nonlocal bad
        if st is None or not isinstance(st, tuple) or bad:
            return
        op = st[0]
        if op in ("blocking", "nonblocking"):
            note(st[1], st[2])
        elif op == "block":
            for s in st[1]:
                walk(s)
        elif op == "if":
            walk(st[2])
            walk(st[3])
        elif op == "case":
            for _pats, body in st[3]:
                walk(body)
            walk(st[4])
        elif op == "while":
            walk(st[2])
        elif op == "do_while":
            walk(st[1])
        elif op == "for":
            walk(st[1])
            walk(st[3])
            walk(st[4])
        elif op == "delay":
            walk(st[2])
        elif op == "calltask":
            bad = True

    for r in roots:
        walk(r)
    return None if bad else vals


def _tag_fsm_bit(nl, ff, net, group: str, bit: int, inv: int, states):
    """Record that ``net`` (driven by ``ff``) carries bit ``bit`` of a
    constant-coded state register whose reachable values are ``states``
    (inv=1: the net holds the complement).  Consumed by the O3+ DC
    mining (opt_graph._fsm_dc_words); process-local only — never
    persisted."""
    bits = getattr(nl, "_fsm_bits", None)
    if bits is None:
        bits = nl._fsm_bits = {}
        nl._fsm_states = {}
    bits[id(net)] = (net, ff, group, bit, inv)
    nl._fsm_states[group] = list(states)


def _synth_ff_block(ctx: SynthContext, bs: BitSynth, ab, sigbits):
    """always @(posedge clk [or negedge rst]) -> DFF / DFF_ARSTN."""
    clk_expr = None
    rst_edges = []
    for edge, x in ab.sensitivity:
        if edge == "pos" and clk_expr is None:
            clk_expr = x
        else:
            rst_edges.append((edge, x))
    body = ab.body
    reset_cond = None
    reset_stmt = None
    main_stmt = body
    # async-reset pattern: if (<rst cond>) ... else ...
    if rst_edges and body is not None:
        b = body
        if b[0] == "block" and len(b[1]) == 1:
            b = b[1][0]
        if b[0] == "if":
            reset_cond, reset_stmt, main_stmt = b[1], b[2], b[3]
    if clk_expr is None:
        # e.g. negedge-clocked FF: invert the clock
        edge, x = rst_edges.pop(0)
        clk_bits = bs.lower(x, sigbits)
        clk_net = ctx.g_not(clk_bits[0])
    else:
        clk_net = bs.lower(clk_expr, sigbits)[0]
    clk_node = ctx.as_node(clk_net)

    # symbolic next-state
    env = {k: list(v) for k, v in sigbits.items()}
    for _bl in bs.inst.block_locals:
        _sg = bs.inst.signals[_bl]
        env[_bl] = [CX] * (_sg.width * max(1, _sg.array_len or 1))
    nba: Dict[str, List[NetT]] = {}
    bs.exec_stmt(main_stmt if reset_cond is not None else body, env, nba)
    # blocking assigns to state regs inside always_ff count as state too
    targets = dict(nba)
    for name, bits in env.items():
        if name in sigbits and bits != sigbits[name] and name not in targets:
            targets[name] = bits

    # reset values
    reset_vals: Dict[str, List[int]] = {}
    reset_sym: Dict[str, List[NetT]] = {}
    arst_net = None
    if reset_cond is not None:
        renv = {k: list(v) for k, v in sigbits.items()}
        for _bl in bs.inst.block_locals:
            _sg = bs.inst.signals[_bl]
            renv[_bl] = [CX] * (_sg.width * max(1, _sg.array_len or 1))
        rnba: Dict[str, List[NetT]] = {}
        bs.exec_stmt(reset_stmt, renv, rnba)
        for name, bits in rnba.items():
            if all(isinstance(x, int) for x in bits):
                reset_vals[name] = bits
            else:
                # non-constant reset value: cannot be an async preset —
                # lowered as a synchronous load mux on D (semantics
                # match behavioral except when reset toggles with no
                # clock edge); pe_synth's async-reset-expr analysis
                reset_sym[name] = bits
                ctx.report.warnings.append(
                    f"non-constant async reset value for {name!r}: "
                    "lowered as synchronous load")
        # reset condition -> active-low arst_n net
        c = bs.lower(reset_cond, sigbits)
        cond_net = bs.reduce_or(c)
        arst_net = ctx.as_node(ctx.g_not(cond_net))

    # FSM reachable-state analysis: a register every assignment of
    # which is a compile-time constant can only ever hold one of those
    # constants (or its reset value); binary minterms outside that set
    # are don't-cares for any logic cone reading >=2 of its bits.
    fsm_sets = _collect_const_assigns(
        bs, [reset_stmt, main_stmt] if reset_cond is not None else [body])

    for name, bits in targets.items():
        if name not in sigbits:
            continue
        q_nodes = sigbits[name]
        rv = reset_vals.get(name)
        rsym = reset_sym.get(name)
        fsm_states = None
        if (fsm_sets is not None and arst_net is not None
                and rv is not None and rsym is None):
            vset = fsm_sets.get(name)
            sig = bs.inst.signals.get(name)
            if (vset and sig is not None and not sig.array_len
                    and 2 <= sig.width <= 24
                    and len(q_nodes) == sig.width
                    and all(b in (0, 1) for b in rv)):
                w = sig.width
                mask = (1 << w) - 1
                S = {v & mask for v in vset}
                S.add(sum((rv[i] if i < len(rv) else 0) << i
                          for i in range(w)))
                if len(S) < (1 << w):
                    fsm_states = sorted(S)
        if rsym is not None and arst_net is not None:
            # D = reset active ? reset_expr : next  (sync load)
            bits = [ctx.g_mux(arst_net, rsym[i] if i < len(rsym) else C0,
                              d) for i, d in enumerate(bits)]
        for i, (d_net, q_net) in enumerate(zip(bits, q_nodes)):
            q_node = ctx.as_node(q_net)
            if arst_net is not None and rv is not None:
                rbit = rv[i] if i < len(rv) else 0
                if rbit == 1:
                    # reset-to-1: store inverted (DFF_ARSTN resets to 0)
                    d_inv = ctx.g_not(d_net)
                    ff = ops.add_model(ctx.nl, D_FF_ARSTN)
                    ops.add_to_node(ctx.nl, ff, 0, ctx.as_node(d_inv))
                    ops.add_to_node(ctx.nl, ff, 1, clk_node)
                    ops.add_to_node(ctx.nl, ff, 2, arst_net)
                    qi = ctx.new_node()
                    ops.add_to_node(ctx.nl, ff, 3, qi)
                    ctx.g_not(qi, out=q_node)
                    if fsm_states is not None:
                        _tag_fsm_bit(ctx.nl, ff, qi,
                                     f"fsm{id(bs.inst)}:{name}", i, 1,
                                     fsm_states)
                else:
                    ff = ops.add_model(ctx.nl, D_FF_ARSTN)
                    ops.add_to_node(ctx.nl, ff, 0, ctx.as_node(d_net))
                    ops.add_to_node(ctx.nl, ff, 1, clk_node)
                    ops.add_to_node(ctx.nl, ff, 2, arst_net)
                    ops.add_to_node(ctx.nl, ff, 3, q_node)
                    if fsm_states is not None:
                        _tag_fsm_bit(ctx.nl, ff, q_node,
                                     f"fsm{id(bs.inst)}:{name}", i, 0,
                                     fsm_states)
            else:
                ff = ops.add_model(ctx.nl, D_FF)
                ops.add_to_node(ctx.nl, ff, 0, ctx.as_node(d_net))
                ops.add_to_node(ctx.nl, ff, 1, clk_node)
                ops.add_to_node(ctx.nl, ff, 2, q_node)
            ctx.report.ff_count += 1
