"""Design building and elaboration.

Mirrors digital.h:10589-10605 (``build_design`` / ``find_module``) and
:11934 (``elaborate``): resolves parameters, evaluates declaration
ranges, unrolls generate-for/if, and builds the instance tree with port
bindings.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from .ast import Module, SignalDecl, Instance, GenerateFor, GenerateIf
from .parser import CompileError
from .fourstate import Val


@dataclass
class Design:
    modules: Dict[str, Module]


def build_design(modules: List[Module]) -> Design:
    out: Dict[str, Module] = {}
    for m in modules:
        if m.name in out:
            raise CompileError(f"duplicate module {m.name}", m.line)
        out[m.name] = m
    return Design(modules=out)


def find_module(design: Design, name: str) -> Module:
    if name not in design.modules:
        raise CompileError(f"module not found: {name}")
    return design.modules[name]


@dataclass
class Signal:
    decl: SignalDecl
    width: int
    signed: bool
    array_len: int = 0           # 0 = scalar signal


@dataclass
class PortBinding:
    port: str
    direction: str
    expr: Any                    # parent-side expression (lvalue for outs)


@dataclass
class InstanceState:
    module: Module
    name: str
    params: Dict[str, Val]
    signals: Dict[str, Signal]
    children: List["InstanceState"] = field(default_factory=list)
    bindings: List[PortBinding] = field(default_factory=list)
    parent: Optional["InstanceState"] = None
    # flattened content after generate unrolling
    assigns: List[Tuple[Any, Any]] = field(default_factory=list)
    always_blocks: List[Any] = field(default_factory=list)
    initials: List[Any] = field(default_factory=list)
    functions: Dict[str, Any] = field(default_factory=dict)
    tasks: Dict[str, Any] = field(default_factory=dict)
    path: str = ""
    # begin/end-local declarations hoisted by elaborate: static storage
    # with declared widths, but NOT module-visible nets for synthesis
    block_locals: Set[str] = field(default_factory=set)

    def signal_width(self, name: str) -> int:
        s = self.signals.get(name)
        return s.width if s else 1


def _const_eval(expr: Any, env: Dict[str, Val], inst_like=None) -> Val:
    """Constant-expression evaluation for parameters/ranges/genvars."""
    from .simulate import eval_expr, EvalCtx
    ctx = EvalCtx(params=env, signals={}, functions=(
        inst_like.functions if inst_like else {}), inst=inst_like)
    return eval_expr(expr, ctx)


def elaborate(design: Design, top: Module,
              param_overrides: Optional[Dict[str, Any]] = None,
              _name: str = "top", _depth: int = 0,
              _path: str = "") -> InstanceState:
    if _depth > 64:
        raise CompileError("instance depth limit exceeded (recursion?)")
    mod = top

    # 1. parameters
    params: Dict[str, Val] = {}
    for pname in mod.param_order:
        if param_overrides and pname in param_overrides:
            ov = param_overrides[pname]
            params[pname] = ov if isinstance(ov, Val) else \
                Val.from_int(int(ov), 32, True)
        else:
            params[pname] = _const_eval(mod.params[pname], params)
    for pname, pexpr in mod.localparams.items():
        params[pname] = _const_eval(pexpr, params)

    inst = InstanceState(module=mod, name=_name, params=params, signals={},
                         path=_path or _name)
    inst.functions = dict(mod.functions)
    inst.tasks = dict(mod.tasks)
    inst.assigns = list(mod.assigns)
    inst.always_blocks = list(mod.always_blocks)
    inst.initials = list(mod.initials)

    # 2. generate unrolling (adds signals/assigns/always/instances)
    gen_signals: Dict[str, SignalDecl] = {}
    gen_instances: List[Instance] = []
    _unroll_generates(mod.generates, params, inst, gen_signals,
                      gen_instances)

    # 3. signal widths
    def add_signal(decl: SignalDecl):
        if decl.kind == "genvar":
            return
        width = 1
        signed = decl.signed
        if decl.msb is not None:
            msb = _const_eval(decl.msb, params, inst).to_signed_int()
            lsb = _const_eval(decl.lsb, params, inst).to_signed_int()
            width = abs(msb - lsb) + 1
        alen = 0
        if decl.array_dims:
            am, al = decl.array_dims[0]
            amv = _const_eval(am, params, inst).to_signed_int()
            alv = _const_eval(al, params, inst).to_signed_int()
            alen = abs(amv - alv) + 1
        inst.signals[decl.name] = Signal(decl=decl, width=width,
                                         signed=signed, array_len=alen)

    for decl in mod.signals.values():
        add_signal(decl)
    for decl in gen_signals.values():
        add_signal(decl)

    # 3b. hoist block-local declarations (begin/end stmt[3] lists) out
    # of always/initial bodies so their declared widths govern runtime
    # and synthesis — block locals in this subset are static per scope
    # (module signals win on a name clash)
    def hoist_block_locals(stmt):
        if not isinstance(stmt, tuple):
            return
        if stmt and stmt[0] == "block" and len(stmt) >= 4:
            for decl in stmt[3]:
                if decl.name not in inst.signals:
                    add_signal(decl)
                    inst.block_locals.add(decl.name)
        for part in stmt[1:]:
            if isinstance(part, tuple):
                hoist_block_locals(part)
            elif isinstance(part, list):
                for x in part:
                    if isinstance(x, tuple):
                        hoist_block_locals(x)
                    elif (isinstance(x, (list, tuple)) and len(x) == 2
                          and isinstance(x[1], tuple)):
                        hoist_block_locals(x[1])

    for ab in inst.always_blocks:
        hoist_block_locals(ab.body)
    for st in inst.initials:
        hoist_block_locals(st)

    # 4. children
    for vi in list(mod.instances) + gen_instances:
        child_mod = find_module(design, vi.module)
        # resolve parameter overrides in *this* scope
        overrides: Dict[str, Val] = {}
        if vi.param_overrides:
            named = any(n is not None for n, _ in vi.param_overrides)
            if named:
                for n, e in vi.param_overrides:
                    overrides[n] = _const_eval(e, params, inst)
            else:
                for (n, e), pname in zip(vi.param_overrides,
                                         child_mod.param_order):
                    overrides[pname] = _const_eval(e, params, inst)
        child = elaborate(design, child_mod, overrides,
                          _name=vi.name, _depth=_depth + 1,
                          _path=f"{inst.path}.{vi.name}")
        child.parent = inst
        # port bindings
        conns = vi.connections
        named = any(n is not None for n, _ in conns)
        port_names = child_mod.ports
        if named:
            for pname, e in conns:
                if e is None:
                    continue
                if pname not in child.signals:
                    raise CompileError(
                        f"{vi.module}: no port {pname!r}", vi.line)
                d = child.signals[pname].decl.direction or "input"
                child.bindings.append(PortBinding(pname, d, e))
        else:
            for (pname_none, e), pname in zip(conns, port_names):
                if e is None:
                    continue
                d = child.signals[pname].decl.direction or "input"
                child.bindings.append(PortBinding(pname, d, e))
        inst.children.append(child)
    return inst


def _unroll_generates(items: List[Any], params: Dict[str, Val],
                      inst: InstanceState,
                      gen_signals: Dict[str, SignalDecl],
                      gen_instances: List[Instance]):
    for g in items:
        if isinstance(g, GenerateFor):
            # execute the for loop with the genvar in a const env
            env = dict(params)
            init = g.init
            if init[0] != "blocking":
                raise CompileError("unsupported generate-for init")
            gv = init[1][1]
            env[gv] = _const_eval(init[2], env)
            guard = 0
            while True:
                cond = _const_eval(g.cond, env)
                if not cond.to_int():
                    break
                idx = env[gv].to_signed_int()
                prefix = f"{g.label}[{idx}]." if g.label else f"_gen{idx}_"
                for sub in g.items:
                    _splice_generated(sub, env, prefix, inst, gen_signals,
                                      gen_instances)
                env[gv] = _const_eval(g.step[2], env)
                guard += 1
                if guard > 4096:
                    raise CompileError("generate-for runaway")
        elif isinstance(g, GenerateIf):
            cond = _const_eval(g.cond, params)
            chosen = g.then_items if cond.to_int() else g.else_items
            for sub in chosen:
                _splice_generated(sub, dict(params), "", inst, gen_signals,
                                  gen_instances)


def _subst_genvars(expr: Any, env: Dict[str, Val], params) -> Any:
    """Replace genvar identifiers with literal values inside expr."""
    if not isinstance(expr, tuple):
        return expr
    if expr[0] == "id" and expr[1] in env and expr[1] not in params:
        return ("num", env[expr[1]])
    return tuple(_subst_genvars(e, env, params) if isinstance(e, tuple)
                 else ([_subst_genvars(x, env, params) for x in e]
                       if isinstance(e, list) else e)
                 for e in expr)


def _splice_generated(sub: Module, env: Dict[str, Val], prefix: str,
                      inst: InstanceState,
                      gen_signals: Dict[str, SignalDecl],
                      gen_instances: List[Instance]):
    """Merge a generate-scope Module fragment into the parent instance,
    substituting genvar values."""
    params = inst.params

    def fix(e):
        return _subst_genvars(e, env, params)

    for name, decl in sub.signals.items():
        d2 = copy.deepcopy(decl)
        d2.name = prefix + name if prefix and name not in \
            inst.module.signals else name
        d2.msb = fix(d2.msb) if d2.msb is not None else None
        d2.lsb = fix(d2.lsb) if d2.lsb is not None else None
        gen_signals[d2.name] = d2

    def rename_ids(e):
        """Prefix locally generated names."""
        if not isinstance(e, tuple):
            return e
        if e[0] == "id":
            nm = e[1]
            if prefix and (prefix + nm) in gen_signals:
                return ("id", prefix + nm)
            return e
        return tuple(rename_ids(x) if isinstance(x, tuple)
                     else ([rename_ids(y) for y in x]
                           if isinstance(x, list) else x)
                     for x in e)

    for lhs, rhs in sub.assigns:
        inst.assigns.append((rename_ids(fix(lhs)), rename_ids(fix(rhs))))
    for ab in sub.always_blocks:
        ab2 = copy.deepcopy(ab)
        ab2.body = rename_ids(fix(ab2.body))
        if ab2.sensitivity:
            ab2.sensitivity = [(e, rename_ids(fix(x)))
                               for e, x in ab2.sensitivity]
        inst.always_blocks.append(ab2)
    for st in sub.initials:
        inst.initials.append(rename_ids(fix(st)))
    for vi in sub.instances:
        vi2 = copy.deepcopy(vi)
        vi2.name = prefix + vi2.name if prefix else vi2.name
        vi2.param_overrides = [(n, fix(e)) for n, e in vi2.param_overrides]
        vi2.connections = [(n, rename_ids(fix(e)) if e is not None else None)
                           for n, e in vi2.connections]
        gen_instances.append(vi2)
    _unroll_generates(sub.generates, env, inst, gen_signals, gen_instances)
