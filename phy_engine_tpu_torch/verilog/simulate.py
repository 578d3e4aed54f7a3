"""Behavioral 4-state simulator (event-driven runtime).

Mirrors the reference runtime semantics (digital.h:10352-11952):
tick-based simulation with a sequential phase (edge-triggered always
blocks, NBA queue) followed by delta-cycle combinational settling
(continuous assigns, always_comb/@*, port propagation both directions),
with ``initial`` blocks supporting ``#N`` tick delays.

Width semantics follow IEEE 1364 context-determined sizing: the
evaluator carries a context width into width-transparent operators so
idioms like ``{c, s} = a + b`` keep the carry bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import fourstate as fs
from .fourstate import Val
from .ast import AlwaysBlock, FunctionDef, TaskDef
from .parser import CompileError
from .elaborate import InstanceState, Signal

MAX_LOOP = 1 << 16          # runaway-loop guard (reference uses budgets);
                            # fuzz finding: at 1<<20 an unbounded while in
                            # an always block spins >10s of interpreted
                            # work before tripping — an effective hang
MAX_DELTA = 1024            # comb settle budget per tick


class SimError(Exception):
    pass


class _ReturnSignal(Exception):
    def __init__(self, value):
        self.value = value


class _BreakSignal(Exception):
    pass


class _ContinueSignal(Exception):
    pass


class _DisableSignal(Exception):
    def __init__(self, name):
        self.name = name


# ---------------------------------------------------------------------------
# expression evaluation
# ---------------------------------------------------------------------------

@dataclass
class EvalCtx:
    params: Dict[str, Val]
    signals: Dict[str, Any]               # name -> Val | List[Val]
    functions: Dict[str, FunctionDef] = field(default_factory=dict)
    inst: Any = None                      # InstanceState for widths
    locals: Optional[Dict[str, Any]] = None
    tick: int = 0
    rng: List[int] = field(default_factory=lambda: [0x12345678])
    rt: Any = None                        # Runtime for hierarchy walks

    def _hier_lookup(self, name: str):
        """Resolve inst.sub.sig hierarchical references (the reference
        resolves these through module_state children)."""
        if self.rt is None or "." not in name:
            return None
        parts = name.split(".")
        cur = self.rt
        for p in parts[:-1]:
            nxt = None
            for child, crt in zip(cur.inst.children, cur.children):
                if child.name == p:
                    nxt = crt
                    break
            if nxt is None:
                return None
            cur = nxt
        return cur.values.get(parts[-1])

    def lookup(self, name: str):
        if self.locals is not None and name in self.locals:
            return self.locals[name]
        if name in self.signals:
            return self.signals[name]
        if name in self.params:
            return self.params[name]
        h = self._hier_lookup(name)
        if h is not None:
            return h
        # hierarchical/generated names fall through
        raise SimError(f"unknown identifier {name!r}")

    def width_of_id(self, name: str) -> int:
        if self.locals is not None and name in self.locals:
            v = self.locals[name]
            return v.width if isinstance(v, Val) else 32
        if self.inst is not None and name in self.inst.signals:
            return self.inst.signals[name].width
        if name in self.params:
            return self.params[name].width
        if name in self.signals:
            v = self.signals[name]
            if isinstance(v, Val):
                return v.width
        return 32

    def signed_of_id(self, name: str) -> bool:
        if self.inst is not None and name in self.inst.signals:
            return self.inst.signals[name].signed
        if name in self.params:
            return self.params[name].signed
        return False


def self_width(expr: Any, ctx: EvalCtx) -> int:
    op = expr[0]
    if op == "num":
        return expr[1].width
    if op == "id":
        return ctx.width_of_id(expr[1])
    if op == "index":
        # array element keeps element width; bit select is 1
        if expr[1][0] == "id" and ctx.inst is not None:
            s = ctx.inst.signals.get(expr[1][1])
            if s is not None and s.array_len:
                return s.width
        return 1
    if op == "slice":
        hi = eval_expr(expr[2], ctx).to_signed_int()
        lo = eval_expr(expr[3], ctx).to_signed_int()
        return abs(hi - lo) + 1
    if op == "pslice":
        return eval_expr(expr[3], ctx).to_int()
    if op == "concat":
        return sum(self_width(e, ctx) for e in expr[1])
    if op == "repl":
        return eval_expr(expr[1], ctx).to_int() * self_width(expr[2], ctx)
    if op == "unary":
        if expr[1] in ("!", "&", "|", "^", "~&", "~|", "~^", "^~"):
            return 1
        return self_width(expr[2], ctx)
    if op == "binary":
        o = expr[1]
        if o in ("==", "!=", "===", "!==", "<", "<=", ">", ">=", "&&",
                 "||"):
            return 1
        if o in ("<<", ">>", "<<<", ">>>", "**"):
            return self_width(expr[2], ctx)
        return max(self_width(expr[2], ctx), self_width(expr[3], ctx))
    if op == "cond":
        return max(self_width(expr[2], ctx), self_width(expr[3], ctx))
    if op == "call":
        f = ctx.functions.get(expr[1])
        if f is None:
            raise SimError(f"unknown function {expr[1]!r}")
        if f.ret.msb is None:
            return 1
        hi = eval_expr(f.ret.msb, ctx).to_signed_int()
        lo = eval_expr(f.ret.lsb, ctx).to_signed_int()
        return abs(hi - lo) + 1
    if op == "syscall":
        if expr[1] in ("$signed", "$unsigned") and expr[2]:
            return self_width(expr[2][0], ctx)
        return 32
    if op == "cast":
        return expr[1]
    raise SimError(f"width: unsupported expr {op}")


_BINOPS = {
    "+": fs.v_add, "-": fs.v_sub, "*": fs.v_mul, "/": fs.v_div,
    "%": fs.v_mod, "**": fs.v_pow,
    "&": fs.v_and, "|": fs.v_or, "^": fs.v_xor, "~^": fs.v_xnor,
    "^~": fs.v_xnor,
    "==": fs.v_eq, "!=": fs.v_ne, "===": fs.v_case_eq,
    "!==": fs.v_case_ne,
    "<": fs.v_lt, "<=": fs.v_le, ">": fs.v_gt, ">=": fs.v_ge,
    "&&": fs.log_and, "||": fs.log_or,
    "<<": fs.v_shl, ">>": fs.v_shr, "<<<": fs.v_shl, ">>>": fs.v_ashr,
}
_CTX_TRANSPARENT = ("+", "-", "*", "/", "%", "&", "|", "^", "~^", "^~")


def eval_expr(expr: Any, ctx: EvalCtx, ctx_width: Optional[int] = None) -> Val:
    op = expr[0]
    if op == "num":
        v = expr[1]
        if ctx_width and ctx_width > v.width:
            return fs.resize(v, ctx_width)
        return v
    if op == "id":
        val = ctx.lookup(expr[1])
        if not isinstance(val, Val):
            raise SimError(f"{expr[1]!r} is an array; needs an index")
        if not val.signed and ctx.signed_of_id(expr[1]):
            val = Val(val.v, val.u, val.width, True)
        if ctx_width and ctx_width > val.width:
            return fs.resize(val, ctx_width)
        return val
    if op == "index":
        base = expr[1]
        if base[0] == "id":
            tgt = ctx.lookup(base[1])
            if isinstance(tgt, list):
                idx = eval_expr(expr[2], ctx)
                if idx.u:
                    # X index -> X element
                    w = tgt[0].width if tgt else 1
                    return Val.all_x(w)
                i = idx.to_int()
                if 0 <= i < len(tgt):
                    return tgt[i]
                return Val.all_x(tgt[0].width if tgt else 1)
        a = eval_expr(base, ctx)
        return fs.v_select_bit(a, eval_expr(expr[2], ctx))
    if op == "slice":
        a = eval_expr(expr[1], ctx)
        hi = eval_expr(expr[2], ctx).to_signed_int()
        lo = eval_expr(expr[3], ctx).to_signed_int()
        if hi < lo:
            hi, lo = lo, hi
        return fs.v_slice(a, hi, lo)
    if op == "pslice":
        a = eval_expr(expr[1], ctx)
        base = eval_expr(expr[2], ctx).to_signed_int()
        w = eval_expr(expr[3], ctx).to_int()
        if expr[4] == "+":
            return fs.v_slice(a, base + w - 1, base)
        return fs.v_slice(a, base, base - w + 1)
    if op == "concat":
        return fs.v_concat([eval_expr(e, ctx) for e in expr[1]])
    if op == "repl":
        n = eval_expr(expr[1], ctx).to_int()
        return fs.v_repl(n, eval_expr(expr[2], ctx))
    if op == "unary":
        o = expr[1]
        if o == "!":
            return fs.log_not(eval_expr(expr[2], ctx))
        if o == "~":
            return fs.v_not(eval_expr(expr[2], ctx, ctx_width))
        if o == "-":
            return fs.v_neg(eval_expr(expr[2], ctx, ctx_width))
        if o == "+":
            return eval_expr(expr[2], ctx, ctx_width)
        if o == "&":
            return fs.red_and(eval_expr(expr[2], ctx))
        if o == "|":
            return fs.red_or(eval_expr(expr[2], ctx))
        if o == "^":
            return fs.red_xor(eval_expr(expr[2], ctx))
        if o in ("~&",):
            return fs.v_not(fs.red_and(eval_expr(expr[2], ctx)))
        if o in ("~|",):
            return fs.v_not(fs.red_or(eval_expr(expr[2], ctx)))
        if o in ("~^", "^~"):
            return fs.v_not(fs.red_xor(eval_expr(expr[2], ctx)))
        raise SimError(f"unary {o!r}")
    if op == "binary":
        o = expr[1]
        fn = _BINOPS.get(o)
        if fn is None:
            raise SimError(f"binary {o!r}")
        if o in _CTX_TRANSPARENT:
            w = max(self_width(expr, ctx), ctx_width or 0)
            a = eval_expr(expr[2], ctx, w)
            b = eval_expr(expr[3], ctx, w)
            return fs.resize(fn(a, b), w, None)
        if o in ("<<", ">>", "<<<", ">>>"):
            w = max(self_width(expr[2], ctx), ctx_width or 0)
            a = eval_expr(expr[2], ctx, w)
            b = eval_expr(expr[3], ctx)
            return fn(a, b)
        a = eval_expr(expr[2], ctx)
        b = eval_expr(expr[3], ctx)
        return fn(a, b)
    if op == "cond":
        c = eval_expr(expr[1], ctx)
        t = eval_expr(expr[2], ctx, ctx_width)
        f = eval_expr(expr[3], ctx, ctx_width)
        return fs.v_cond(c, t, f)
    if op == "call":
        return call_function(expr[1], expr[2], ctx)
    if op == "syscall":
        return eval_syscall(expr[1], expr[2], ctx)
    if op == "cast":
        # SV cast type'(x) / N'(x): extension follows the operand's own
        # signedness; the result takes the target type's signedness
        v = eval_expr(expr[3], ctx)
        res = fs.resize(v, expr[1])
        sgn = v.signed if expr[2] is None else expr[2]
        return Val(res.v, res.u, expr[1], sgn)
    raise SimError(f"eval: unsupported expr {op}")


def eval_syscall(name: str, args: List[Any], ctx: EvalCtx) -> Val:
    if name == "$clog2":
        n = eval_expr(args[0], ctx).to_int()
        r = 0
        n -= 1
        while n > 0:
            n >>= 1
            r += 1
        return Val.from_int(r, 32, True)
    if name == "$bits":
        return Val.from_int(self_width(args[0], ctx), 32, True)
    if name == "$signed":
        v = eval_expr(args[0], ctx)
        return Val(v.v, v.u, v.width, True)
    if name == "$unsigned":
        v = eval_expr(args[0], ctx)
        return Val(v.v, v.u, v.width, False)
    if name in ("$urandom", "$random"):
        s = ctx.rng[0]
        s = (1103515245 * s + 12345) & 0xFFFFFFFF
        ctx.rng[0] = s
        return Val.from_int(s, 32)
    if name == "$time":
        return Val.from_int(ctx.tick, 64)
    # $display/$write etc. are statements; in expression context return 0
    return Val.from_int(0, 32)


def call_function(name: str, args: List[Any], ctx: EvalCtx) -> Val:
    f = ctx.functions.get(name)
    if f is None:
        raise SimError(f"unknown function {name!r}")
    # evaluate args in caller context
    locals_: Dict[str, Any] = {}
    for decl, a in zip(f.args, args):
        w = 1
        if decl.msb is not None:
            hi = eval_expr(decl.msb, ctx).to_signed_int()
            lo = eval_expr(decl.lsb, ctx).to_signed_int()
            w = abs(hi - lo) + 1
        locals_[decl.name] = fs.resize(eval_expr(a, ctx, w), w, decl.signed)
    # locals + return slot
    rw = 1
    if f.ret.msb is not None:
        hi = eval_expr(f.ret.msb, ctx).to_signed_int()
        lo = eval_expr(f.ret.lsb, ctx).to_signed_int()
        rw = abs(hi - lo) + 1
    locals_[name] = Val.all_x(rw)
    for lname, ldecl in f.locals.items():
        w = 1
        if ldecl.msb is not None:
            hi = eval_expr(ldecl.msb, ctx).to_signed_int()
            lo = eval_expr(ldecl.lsb, ctx).to_signed_int()
            w = abs(hi - lo) + 1
        if ldecl.array_dims:
            am, al = ldecl.array_dims[0]
            n = abs(eval_expr(am, ctx).to_signed_int() -
                    eval_expr(al, ctx).to_signed_int()) + 1
            locals_[lname] = [fs.resize(Val.all_x(w), w, ldecl.signed)
                              for _ in range(n)]
        else:
            locals_[lname] = fs.resize(Val.all_x(w), w, ldecl.signed)
    sub = EvalCtx(params=ctx.params, signals=ctx.signals,
                  functions=ctx.functions, inst=ctx.inst, locals=locals_,
                  tick=ctx.tick, rng=ctx.rng)
    try:
        exec_stmt(f.body, sub, None)
    except _ReturnSignal as r:
        if r.value is not None:
            locals_[name] = fs.resize(r.value, rw, f.ret.signed)
    except _DisableSignal as d:
        if d.name != name:
            raise
    out = locals_[name]
    return Val(out.v, out.u, out.width, f.ret.signed)


# ---------------------------------------------------------------------------
# statement execution
# ---------------------------------------------------------------------------

def assign_lvalue(lhs: Any, value: Val, ctx: EvalCtx,
                  nba: Optional[List] = None):
    """Assign to an lvalue; if nba is not None, defer (nonblocking)."""
    if nba is not None:
        nba.append((lhs, value))
        return
    _do_assign(lhs, value, ctx)


def _do_assign(lhs: Any, value: Val, ctx: EvalCtx):
    op = lhs[0]
    if op == "id":
        name = lhs[1]
        store = ctx.locals if (ctx.locals is not None and
                               name in ctx.locals) else ctx.signals
        cur = store.get(name)
        if cur is None and name in ctx.params:
            raise SimError(f"cannot assign to parameter {name!r}")
        if isinstance(cur, list):
            raise SimError(f"array {name!r} needs an index")
        w = cur.width if isinstance(cur, Val) else value.width
        sgn = cur.signed if isinstance(cur, Val) else value.signed
        store[name] = fs.resize(value, w, sgn)
        return
    if op == "index":
        base = lhs[1]
        if base[0] == "id":
            name = base[1]
            store = ctx.locals if (ctx.locals is not None and
                                   name in ctx.locals) else ctx.signals
            tgt = store.get(name)
            if isinstance(tgt, list):
                idx = eval_expr(lhs[2], ctx)
                if idx.u:
                    return
                i = idx.to_int()
                if 0 <= i < len(tgt):
                    tgt[i] = fs.resize(value, tgt[i].width, tgt[i].signed)
                return
            if isinstance(tgt, Val):
                idx = eval_expr(lhs[2], ctx)
                if idx.u:
                    return
                i = idx.to_int()
                store[name] = fs.insert_slice(tgt, i, i, value)
                return
        raise SimError("unsupported indexed lvalue")
    if op == "slice":
        base = lhs[1]
        if base[0] != "id":
            raise SimError("unsupported sliced lvalue")
        name = base[1]
        store = ctx.locals if (ctx.locals is not None and
                               name in ctx.locals) else ctx.signals
        tgt = store[name]
        hi = eval_expr(lhs[2], ctx).to_signed_int()
        lo = eval_expr(lhs[3], ctx).to_signed_int()
        if hi < lo:
            hi, lo = lo, hi
        store[name] = fs.insert_slice(tgt, hi, lo, value)
        return
    if op == "pslice":
        base = lhs[1]
        name = base[1]
        store = ctx.locals if (ctx.locals is not None and
                               name in ctx.locals) else ctx.signals
        tgt = store[name]
        b = eval_expr(lhs[2], ctx).to_signed_int()
        w = eval_expr(lhs[3], ctx).to_int()
        hi, lo = (b + w - 1, b) if lhs[4] == "+" else (b, b - w + 1)
        store[name] = fs.insert_slice(tgt, hi, lo, value)
        return
    if op == "concat":
        # MSB-first distribution
        parts = lhs[1]
        ctx2 = ctx
        pos = value.width
        for p in parts:
            w = self_width(p, ctx2)
            pos -= w
            _do_assign(p, fs.v_slice(value, pos + w - 1, pos), ctx2)
        return
    raise SimError(f"unsupported lvalue {op}")


def exec_stmt(stmt: Any, ctx: EvalCtx, nba: Optional[List]):
    if stmt is None:
        return
    op = stmt[0] if isinstance(stmt, tuple) else None
    if op == "block":
        label = stmt[2]
        # block-local declarations
        for decl in stmt[3]:
            if ctx.locals is None:
                break
            w = 1
            if decl.msb is not None:
                hi = eval_expr(decl.msb, ctx).to_signed_int()
                lo = eval_expr(decl.lsb, ctx).to_signed_int()
                w = abs(hi - lo) + 1
            ctx.locals.setdefault(decl.name, Val.all_x(w))
        try:
            for s in stmt[1]:
                exec_stmt(s, ctx, nba)
        except _DisableSignal as d:
            if d.name != label:
                raise
        return
    if op == "blocking":
        w = _lhs_width(stmt[1], ctx)
        val = eval_expr(stmt[2], ctx, w)
        _do_assign(stmt[1], fs.resize(val, w) if w else val, ctx)
        return
    if op == "nonblocking":
        w = _lhs_width(stmt[1], ctx)
        val = eval_expr(stmt[2], ctx, w)
        if nba is None:
            _do_assign(stmt[1], val, ctx)
        else:
            nba.append((stmt[1], fs.resize(val, w) if w else val))
        return
    if op == "if":
        c = fs.truthy(eval_expr(stmt[1], ctx))
        if c is True:
            exec_stmt(stmt[2], ctx, nba)
        elif c is False:
            exec_stmt(stmt[3], ctx, nba)
        else:
            # unknown condition: execute neither branch (the reference
            # merges; branchless merge is unsound for side effects)
            pass
        return
    if op == "case":
        kind = stmt[1]
        sel = eval_expr(stmt[2], ctx)
        for pats, body in stmt[3]:
            for p in pats:
                pv = eval_expr(p, ctx)
                if _case_match(kind, sel, pv):
                    exec_stmt(body, ctx, nba)
                    return
        exec_stmt(stmt[4], ctx, nba)
        return
    if op == "for":
        exec_stmt(stmt[1], ctx, nba)
        guard = 0
        while True:
            c = fs.truthy(eval_expr(stmt[2], ctx))
            if c is not True:
                break
            try:
                exec_stmt(stmt[4], ctx, nba)
            except _BreakSignal:
                break
            except _ContinueSignal:
                pass
            exec_stmt(stmt[3], ctx, nba)
            guard += 1
            if guard > MAX_LOOP:
                raise SimError("for-loop runaway")
        return
    if op == "while":
        guard = 0
        while fs.truthy(eval_expr(stmt[1], ctx)) is True:
            try:
                exec_stmt(stmt[2], ctx, nba)
            except _BreakSignal:
                break
            except _ContinueSignal:
                pass
            guard += 1
            if guard > MAX_LOOP:
                raise SimError("while-loop runaway")
        return
    if op == "repeat":
        n = eval_expr(stmt[1], ctx).to_int()
        for _ in range(min(n, MAX_LOOP)):
            try:
                exec_stmt(stmt[2], ctx, nba)
            except _BreakSignal:
                break
            except _ContinueSignal:
                continue
        return
    if op == "do_while":
        guard = 0
        while True:
            try:
                exec_stmt(stmt[1], ctx, nba)
            except _BreakSignal:
                break
            except _ContinueSignal:
                pass
            if fs.truthy(eval_expr(stmt[2], ctx)) is not True:
                break
            guard += 1
            if guard > MAX_LOOP:
                raise SimError("do-while runaway")
        return
    if op == "break":
        raise _BreakSignal()
    if op == "continue":
        raise _ContinueSignal()
    if op == "systask":
        name = stmt[1]
        if name in ("$display", "$write"):
            pass     # silent (reference has no IO either)
        return
    if op == "return":
        val = eval_expr(stmt[1], ctx) if stmt[1] is not None else None
        raise _ReturnSignal(val)
    if op == "disable":
        raise _DisableSignal(stmt[1])
    if op == "calltask":
        call_task(stmt[1], stmt[2], ctx, nba)
        return
    if op == "delay":
        # inside always/functions delays are ignored (reference lowers
        # them to tick scheduling only in initial blocks)
        exec_stmt(stmt[2], ctx, nba)
        return
    if op == "forever":
        raise SimError("forever only supported in initial blocks")
    raise SimError(f"unsupported statement {op}")


def _lhs_base(lhs: Any) -> Optional[str]:
    """Base signal name of an lvalue (None for concat targets)."""
    if lhs[0] == "id":
        return lhs[1]
    if lhs[0] in ("index", "slice", "pslice"):
        inner = lhs[1]
        return inner[1] if inner[0] == "id" else None
    return None


def _lhs_width(lhs: Any, ctx: EvalCtx) -> Optional[int]:
    try:
        return self_width(lhs, ctx)
    except Exception:
        return None


def _case_match(kind: str, sel: Val, pat: Val) -> bool:
    w = max(sel.width, pat.width)
    s = fs.resize(sel, w)
    p = fs.resize(pat, w)
    m = fs.mask(w)
    if kind == "case":
        return s.v == p.v and s.u == p.u
    if kind == "casez":
        # z/? in either side is a wildcard
        wild = (s.u & s.v) | (p.u & p.v)
        care = m & ~wild
        return (s.v & care & ~s.u) == (p.v & care & ~p.u) and \
            ((s.u & ~s.v) & care) == ((p.u & ~p.v) & care)
    # casex: x and z are wildcards
    wild = s.u | p.u
    care = m & ~wild
    return (s.v & care) == (p.v & care)


def call_task(name: str, args: List[Any], ctx: EvalCtx, nba):
    t = ctx.inst.tasks.get(name) if ctx.inst else None
    if t is None:
        raise SimError(f"unknown task {name!r}")
    locals_: Dict[str, Any] = {}
    outs = []
    for decl, a in zip(t.args, args):
        w = 1
        if decl.msb is not None:
            hi = eval_expr(decl.msb, ctx).to_signed_int()
            lo = eval_expr(decl.lsb, ctx).to_signed_int()
            w = abs(hi - lo) + 1
        if decl.direction in ("input", "inout"):
            locals_[decl.name] = fs.resize(eval_expr(a, ctx, w), w,
                                           decl.signed)
        else:
            locals_[decl.name] = fs.resize(Val.all_x(w), w,
                                           decl.signed)
        if decl.direction in ("output", "inout"):
            outs.append((decl.name, a))
    for lname, ldecl in t.locals.items():
        w = 1
        if ldecl.msb is not None:
            hi = eval_expr(ldecl.msb, ctx).to_signed_int()
            lo = eval_expr(ldecl.lsb, ctx).to_signed_int()
            w = abs(hi - lo) + 1
        locals_[lname] = fs.resize(Val.all_x(w), w, ldecl.signed)
    sub = EvalCtx(params=ctx.params, signals=ctx.signals,
                  functions=ctx.functions, inst=ctx.inst, locals=locals_,
                  tick=ctx.tick, rng=ctx.rng)
    try:
        exec_stmt(t.body, sub, nba)
    except _ReturnSignal:
        pass                       # `return` inside a task body
    except _DisableSignal as d:
        if d.name != name:
            raise
    for lname, lhs_expr in outs:
        _do_assign(lhs_expr, locals_[lname], ctx)


# ---------------------------------------------------------------------------
# runtime state + tick driver
# ---------------------------------------------------------------------------

class Runtime:
    """Per-instance mutable simulation state (module_state in the
    reference, digital.h:10407-10546)."""

    def __init__(self, inst: InstanceState):
        self.inst = inst
        self.values: Dict[str, Any] = {}
        for name, sig in inst.signals.items():
            if sig.array_len:
                self.values[name] = [Val.all_x(sig.width)
                                     for _ in range(sig.array_len)]
            else:
                self.values[name] = Val.all_x(sig.width)
        self.prev: Dict[str, Val] = {}
        self.edge_state: Dict[int, List[Val]] = {}
        self.pending: List[Tuple[int, Any]] = []      # (due_tick, stmt)
        self.initial_done = False
        self.children = [Runtime(c) for c in inst.children]
        # stable FNV-1a of the instance path: $random streams must
        # not depend on PYTHONHASHSEED (reproducibility across runs)
        h = 0x811C9DC5
        for ch in inst.path.encode():
            h = ((h ^ ch) * 0x01000193) & 0xFFFFFFFF
        self.rng = [h or 1]

    def ctx(self, tick: int) -> EvalCtx:
        return EvalCtx(params=self.inst.params, signals=self.values,
                       functions=self.inst.functions, inst=self.inst,
                       tick=tick, rng=self.rng, rt=self)

    def multi_assign_sigs(self):
        """Signal names with more than one continuous-assign driver
        (cached; used for per-delta net resolution)."""
        if not hasattr(self, "_multi_sigs"):
            counts: Dict[str, int] = {}
            for lhs, _rhs in self.inst.assigns:
                base = _lhs_base(lhs)
                if base is not None and not isinstance(
                        self.values.get(base), list):
                    counts[base] = counts.get(base, 0) + 1
            self._multi_sigs = {k for k, n in counts.items() if n > 1}
        return self._multi_sigs


def _run_initial(rt: Runtime, tick: int):
    """Run initial blocks; '#N' at statement level defers the remainder."""
    ctx = rt.ctx(tick)
    if not rt.initial_done:
        rt.initial_done = True
        for st in rt.inst.initials:
            _exec_initial(rt, st, tick, ctx)
    # fire pending scheduled continuations
    due = [s for t, s in rt.pending if t <= tick]
    rt.pending = [(t, s) for t, s in rt.pending if t > tick]
    for st in due:
        _exec_initial(rt, st, tick, ctx)
    for c in rt.children:
        _run_initial(c, tick)


def _exec_initial(rt: Runtime, stmt: Any, tick: int, ctx: EvalCtx):
    """Execute an initial-block statement supporting top-level delays."""
    if stmt is None:
        return
    if stmt[0] == "block":
        stmts = stmt[1]
        for i, s in enumerate(stmts):
            if s is not None and s[0] == "delay":
                amt = eval_expr(s[1], ctx).to_int()
                rest = list(stmts[i + 1:])
                if s[2] is not None:
                    rest.insert(0, s[2])
                if rest:
                    rt.pending.append((tick + max(amt, 1),
                                       ("block", rest, None, [])))
                return
            _exec_initial(rt, s, tick, ctx)
        return
    if stmt[0] == "delay":
        amt = eval_expr(stmt[1], ctx).to_int()
        if stmt[2] is not None:
            rt.pending.append((tick + max(amt, 1), stmt[2]))
        return
    if stmt[0] == "forever":
        # forever #N body: re-schedule each firing
        body = stmt[1]
        if body[0] == "delay":
            amt = eval_expr(body[1], ctx).to_int()
            rt.pending.append((tick + max(amt, 1),
                               ("_forever", stmt)))
            return
        raise SimError("unsupported forever form")
    if stmt[0] == "_forever":
        inner = stmt[1]
        body = inner[1]
        amt = eval_expr(body[1], ctx).to_int()
        if body[2] is not None:
            exec_stmt(body[2], ctx, None)
        rt.pending.append((tick + max(amt, 1), stmt))
        return
    exec_stmt(stmt, ctx, None)


def _sequential_phase(rt: Runtime, tick: int):
    """Edge-triggered always blocks with NBA collection."""
    ctx = rt.ctx(tick)
    nba: List = []
    for bi, ab in enumerate(rt.inst.always_blocks):
        if ab.sensitivity is None or not any(
                e in ("pos", "neg") for e, _ in ab.sensitivity):
            continue
        cur = [eval_expr(x, ctx) for _, x in ab.sensitivity]
        old = rt.edge_state.get(bi)
        fire = False
        if old is not None:
            for (edge, _x), o, c in zip(ab.sensitivity, old, cur):
                ob = o.bit(0)
                cb = c.bit(0)
                # IEEE 1364 9.7.3: posedge = 0->{1,x,z} or {x,z}->1;
                # negedge = 1->{0,x,z} or {x,z}->0
                if edge == "pos" and ((ob == 0 and cb != 0) or
                                      (ob in (2, 3) and cb == 1)):
                    fire = True
                elif edge == "neg" and ((ob == 1 and cb != 1) or
                                        (ob in (2, 3) and cb == 0)):
                    fire = True
                elif edge == "any" and (o.v != c.v or o.u != c.u):
                    fire = True
        rt.edge_state[bi] = cur
        if fire:
            exec_stmt(ab.body, ctx, nba)
    for lhs, val in nba:
        _do_assign(lhs, val, ctx)
    for c in rt.children:
        _sequential_phase(c, tick)


def _comb_pass(rt: Runtime, tick: int) -> bool:
    """One delta cycle: assigns + comb always + port propagation.
    Returns True if anything changed."""
    changed = False
    ctx = rt.ctx(tick)

    # parent -> child inputs
    for child, crt in zip(rt.inst.children, rt.children):
        for b in child.bindings:
            if b.direction in ("input", "inout"):
                v = eval_expr(b.expr, ctx)
                sig = child.signals[b.port]
                nv = fs.resize(v, sig.width, sig.signed)
                if crt.values[b.port] != nv:
                    crt.values[b.port] = nv
                    changed = True

    # continuous assigns; signals with several assign drivers resolve
    # contributions bitwise (Z yields, conflict -> X) like the
    # reference's per-delta multi-driver resolution
    multi = rt.multi_assign_sigs()
    contribs: Dict[str, List] = {}
    for lhs, rhs in rt.inst.assigns:
        w = _lhs_width(lhs, ctx)
        v = eval_expr(rhs, ctx, w)
        base = _lhs_base(lhs)
        if base is not None and base in multi:
            sig = rt.values[base]
            saved = sig
            rt.values[base] = Val.all_z(sig.width)
            _do_assign(lhs, fs.resize(v, w) if w else v, ctx)
            contribs.setdefault(base, []).append(rt.values[base])
            rt.values[base] = saved
            continue
        before = dict(rt.values)
        _do_assign(lhs, fs.resize(v, w) if w else v, ctx)
        if before != rt.values:
            changed = True
    for base, parts in contribs.items():
        new = parts[0]
        for p in parts[1:]:
            new = fs.v_resolve(new, p)
        new = fs.resize(new, rt.values[base].width,
                        rt.values[base].signed)
        if rt.values[base] != new:
            rt.values[base] = new
            changed = True

    # level-sensitive always blocks
    nba: List = []
    for ab in rt.inst.always_blocks:
        if ab.sensitivity is not None and any(
                e in ("pos", "neg") for e, _ in ab.sensitivity):
            continue
        before = dict(rt.values)
        exec_stmt(ab.body, ctx, nba)
        if before != rt.values:
            changed = True
    if nba:
        for lhs, val in nba:
            _do_assign(lhs, val, ctx)
        changed = True

    # children comb + child -> parent outputs
    for child, crt in zip(rt.inst.children, rt.children):
        if _comb_pass(crt, tick):
            changed = True
        cctx = crt.ctx(tick)
        for b in child.bindings:
            if b.direction in ("output", "inout"):
                v = crt.values[b.port]
                if isinstance(v, Val):
                    before = dict(rt.values)
                    try:
                        w = _lhs_width(b.expr, ctx)
                        _do_assign(b.expr,
                                   fs.resize(v, w) if w else v, ctx)
                    except SimError:
                        pass
                    if before != rt.values:
                        changed = True
    return changed


def _snapshot(rt: Runtime):
    for name, v in rt.values.items():
        if isinstance(v, Val):
            rt.prev[name] = v
    for c in rt.children:
        _snapshot(c)


def _propagate_inputs(rt: Runtime, tick: int):
    """Top-down parent->child input push (propagate_parent_to_child,
    digital.h:11343) so child FFs see this tick's clock before the
    sequential phase."""
    ctx = rt.ctx(tick)
    for child, crt in zip(rt.inst.children, rt.children):
        for b in child.bindings:
            if b.direction in ("input", "inout"):
                v = eval_expr(b.expr, ctx)
                sig = child.signals[b.port]
                crt.values[b.port] = fs.resize(v, sig.width, sig.signed)
        _propagate_inputs(crt, tick)


def simulate(rt: Runtime, tick: int, process_sequential: bool = True):
    """One simulation tick (digital.h:11945-11952)."""
    _run_initial(rt, tick)
    _propagate_inputs(rt, tick)
    if process_sequential:
        _sequential_phase(rt, tick)
    for _ in range(MAX_DELTA):
        if not _comb_pass(rt, tick):
            break
    _snapshot(rt)


def settle(rt: Runtime, tick: int = 0):
    """Combinational settle without a sequential phase (used right after
    elaboration, mirroring the reference's initial comb resolve)."""
    _run_initial(rt, tick)
    for _ in range(MAX_DELTA):
        if not _comb_pass(rt, tick):
            break
    # prime edge state so the first real tick sees current levels
    ctx = rt.ctx(tick)
    _prime_edges(rt, tick)
    _snapshot(rt)


def _prime_edges(rt: Runtime, tick: int):
    ctx = rt.ctx(tick)
    for bi, ab in enumerate(rt.inst.always_blocks):
        if ab.sensitivity is None:
            continue
        rt.edge_state[bi] = [eval_expr(x, ctx) for _, x in ab.sensitivity]
    for c in rt.children:
        _prime_edges(c, tick)
