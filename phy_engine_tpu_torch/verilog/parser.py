"""Recursive-descent parser for the synthesizable Verilog subset.

Coverage mirrors the reference compiler (digital.h:1811-10349): modules
with ANSI/non-ANSI ports, parameters/localparams with overrides, vector
and array declarations, continuous assigns, always/always_ff/always_comb
with full statement set (if/case/casez/casex/for/while/repeat/do-while/
blocks/compound-assign/inc-dec/delay), functions and tasks, module
instances with named/positional connections, generate-for/if, and the
``$clog2/$bits/$signed/$unsigned/$urandom`` system calls.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from .lexer import lex, Token
from .ast import (Module, SignalDecl, AlwaysBlock, Instance, FunctionDef,
                  TaskDef, GenerateFor, GenerateIf)
from .fourstate import Val


from .errors import CompileError as CompileError  # noqa: F401
_ = CompileError


def parse_based_literal(text: str) -> Val:
    """Parse e.g. 8'hFF, 4'b10x1, 'd42 (digit grouping _ and ? == z)."""
    apos = text.index("'")
    size = text[:apos].strip()
    rest = text[apos + 1:].lstrip()
    signed = False
    if rest[0] in "sS":
        signed = True
        rest = rest[1:].lstrip()
    base = rest[0].lower()
    digits = rest[1:].replace("_", "").replace("?", "z").strip()
    radix = {"b": 2, "o": 8, "d": 10, "h": 16}[base]
    bits_per = {"b": 1, "o": 3, "d": 0, "h": 4}[base]
    negate = False
    if digits.startswith("-"):
        # reference accepts e.g. 4'sd-1 (two's-complement in width)
        negate = True
        digits = digits[1:]
    if base == "d":
        if negate:
            width = int(size) if size else 32
            return Val.make(-int(digits, 10), 0, width, signed)
        if any(ch in "xXzZ" for ch in digits):
            width = int(size) if size else 32
            if digits.lower().lstrip("xz") == "":
                return (Val.all_x(width) if "x" in digits.lower()
                        else Val.all_z(width))
            raise CompileError(f"bad decimal literal {text}")
        v = int(digits, 10)
        width = int(size) if size else 32
        return Val.make(v, 0, width, signed)
    v = u = 0
    for ch in digits:
        v <<= bits_per
        u <<= bits_per
        lc = ch.lower()
        if lc == "x":
            u |= (1 << bits_per) - 1
        elif lc == "z":
            v |= (1 << bits_per) - 1
            u |= (1 << bits_per) - 1
        else:
            v |= int(ch, radix)
    width = int(size) if size else max(len(digits) * bits_per, 1)
    if negate:
        if u:
            raise CompileError(f"negative literal with x/z: {text}")
        return Val.make(-v, 0, width, signed)
    # extend leading x/z per spec: if msb of literal is x/z it extends
    if not size:
        width = max(width, 1)
    else:
        lw = len(digits) * bits_per
        if width > lw and digits and digits[0].lower() in "xz":
            ext = ((1 << width) - 1) ^ ((1 << lw) - 1)
            if digits[0].lower() == "x":
                u |= ext
            else:
                v |= ext
                u |= ext
    return Val.make(v, u, width, signed)


_PREC = {
    "||": 2, "&&": 3, "|": 4, "^": 5, "~^": 5, "^~": 5, "&": 6,
    "==": 7, "!=": 7, "===": 7, "!==": 7,
    "<": 8, "<=": 8, ">": 8, ">=": 8,
    "<<": 9, ">>": 9, "<<<": 9, ">>>": 9,
    "+": 10, "-": 10,
    "*": 11, "/": 11, "%": 11,
    "**": 12,
}
_UNARY = {"+", "-", "!", "~", "&", "|", "^", "~&", "~|", "~^", "^~"}


class Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.pos = 0

    # -- token helpers ---------------------------------------------------
    def peek(self, k=0) -> Token:
        return self.toks[min(self.pos + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.pos]
        if t.kind != "eof":
            self.pos += 1
        return t

    def at(self, kind: str, text: Optional[str] = None) -> bool:
        t = self.peek()
        return t.kind == kind and (text is None or t.text == text)

    def accept(self, kind: str, text: Optional[str] = None):
        if self.at(kind, text):
            return self.next()
        return None

    # SV-only keywords that legacy code legitimately uses as plain
    # identifiers (block labels, signal names) — accepted where an id
    # is expected, unless the grammar already claimed them
    _SOFT_ID = {"bit", "byte", "int", "shortint", "longint", "automatic",
                "unique", "unique0", "priority"}

    def expect(self, kind: str, text: Optional[str] = None) -> Token:
        t = self.peek()
        if not self.at(kind, text):
            if kind == "id" and text is None and t.kind == "kw" and \
                    t.text in self._SOFT_ID:
                return self.next()
            raise CompileError(
                f"expected {text or kind}, got {t.text!r}", t.line)
        return self.next()

    def err(self, msg: str):
        raise CompileError(msg, self.peek().line)

    # -- top level ---------------------------------------------------------
    def parse_source(self) -> List[Module]:
        mods = []
        while not self.at("eof"):
            if self.at("kw", "module"):
                mods.append(self.parse_module())
            else:
                self.err(f"expected 'module', got {self.peek().text!r}")
        return mods

    def parse_module(self) -> Module:
        line = self.expect("kw", "module").line
        name = self.expect("id").text
        mod = Module(name=name, line=line)
        # parameter port list  #( parameter X = 1, ... )
        if self.accept("op", "#"):
            self.expect("op", "(")
            pkind = "parameter"
            while not self.at("op", ")"):
                if self.accept("kw", "localparam"):
                    pkind = "localparam"
                elif self.accept("kw", "parameter"):
                    pkind = "parameter"
                self._parse_data_type()
                pname = self.expect("id").text
                self.expect("op", "=")
                pexpr = self.parse_expr()
                if pkind == "parameter":
                    mod.params[pname] = pexpr
                    mod.param_order.append(pname)
                else:
                    mod.localparams[pname] = pexpr
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        # port list
        if self.accept("op", "("):
            if not self.at("op", ")"):
                self._parse_port_list(mod)
            self.expect("op", ")")
        self.expect("op", ";")
        while not self.at("kw", "endmodule"):
            self.parse_module_item(mod)
        self.expect("kw", "endmodule")
        return mod

    # SV integral types: name -> (width, default signedness)
    _INT_TYPES = {"int": (32, True), "integer": (32, True),
                  "byte": (8, True), "shortint": (16, True),
                  "longint": (64, True), "bit": (1, False)}

    def _accept_type_words(self):
        signed = False
        while True:
            if self.accept("kw", "signed"):
                signed = True
            elif self.accept("kw", "unsigned"):
                pass
            elif self.peek().kind == "kw" and (
                    self.peek().text in self._INT_TYPES or
                    self.peek().text in ("logic", "reg", "wire")):
                if self.peek().text in self._INT_TYPES:
                    signed = signed or self._INT_TYPES[self.peek().text][1]
                self.next()
            else:
                break
        return signed

    def _parse_data_type(self, default_kind="wire"):
        """Optional [type keywords] [signed|unsigned] [range] prefix of a
        declaration.  Returns (kind, signed, rng_or_None)."""
        kind = default_kind
        signed = None
        rng = None
        while True:
            t = self.peek()
            if t.kind != "kw":
                break
            if t.text in ("reg", "logic"):
                self.next()
                kind = "reg"
            elif t.text == "wire":
                self.next()
                kind = "wire"
            elif t.text in self._INT_TYPES:
                self.next()
                w, sgn = self._INT_TYPES[t.text]
                kind = "reg"
                if signed is None:
                    signed = sgn
                rng = (("num", Val.from_int(w - 1, 32)),
                       ("num", Val.from_int(0, 32)))
            elif t.text == "signed":
                self.next()
                signed = True
            elif t.text == "unsigned":
                self.next()
                signed = False
            else:
                break
        rng = self._accept_range() or rng
        return kind, bool(signed), rng

    def _accept_range(self):
        if self.at("op", "["):
            self.next()
            msb = self.parse_expr()
            self.expect("op", ":")
            lsb = self.parse_expr()
            self.expect("op", "]")
            return msb, lsb
        return None

    def _parse_port_list(self, mod: Module):
        # ANSI style: direction [type] [range] name, ... ; or legacy list
        if self.at("kw", "input") or self.at("kw", "output") or \
                self.at("kw", "inout"):
            direction = None
            kind = "wire"
            rng = None
            signed = False
            while True:
                if self.at("kw", "input") or self.at("kw", "output") or \
                        self.at("kw", "inout"):
                    direction = self.next().text
                    kind, signed, rng = self._parse_data_type()
                name = self.expect("id").text
                decl = SignalDecl(name=name, kind=kind, signed=signed,
                                  direction=direction)
                if rng:
                    decl.msb, decl.lsb = rng
                mod.signals[name] = decl
                mod.ports.append(name)
                if not self.accept("op", ","):
                    break
        else:
            while True:
                name = self.expect("id").text
                mod.ports.append(name)
                if not self.accept("op", ","):
                    break

    def parse_module_item(self, mod: Module):
        t = self.peek()
        if t.kind == "kw":
            kw = t.text
            if kw in ("input", "output", "inout"):
                self._parse_port_decl(mod)
                return
            if kw in ("wire", "reg", "logic", "integer", "genvar", "tri",
                      "wand", "wor", "supply0", "supply1") or \
                    kw in self._INT_TYPES:
                self._parse_net_decl(mod)
                return
            if kw in ("parameter", "localparam"):
                self._parse_param_decl(mod, kw)
                return
            if kw == "assign":
                self.next()
                while True:
                    lhs = self.parse_expr()
                    self.expect("op", "=")
                    rhs = self.parse_expr()
                    mod.assigns.append((lhs, rhs))
                    if not self.accept("op", ","):
                        break
                self.expect("op", ";")
                return
            if kw in ("always", "always_ff", "always_comb", "always_latch"):
                mod.always_blocks.append(self._parse_always())
                return
            if kw == "initial":
                self.next()
                mod.initials.append(self.parse_statement())
                return
            if kw == "function":
                self._parse_function(mod)
                return
            if kw == "task":
                self._parse_task(mod)
                return
            if kw == "generate":
                self.next()
                while not self.at("kw", "endgenerate"):
                    self._parse_generate_item(mod.generates)
                self.expect("kw", "endgenerate")
                return
            if kw == "for":
                self._parse_generate_item(mod.generates)
                return
            if kw == "if":
                self._parse_generate_item(mod.generates)
                return
            if kw in ("and", "or", "not", "xor", "nand", "nor", "xnor",
                      "buf"):
                self._parse_gate_primitive(mod)
                return
        if t.kind == "id":
            self._parse_instance(mod)
            return
        if self.accept("op", ";"):
            return
        self.err(f"unexpected {t.text!r} in module body")

    def _parse_port_decl(self, mod: Module):
        direction = self.next().text
        kind, signed, rng = self._parse_data_type()
        while True:
            name = self.expect("id").text
            decl = mod.signals.get(name) or SignalDecl(name=name)
            decl.kind = kind if kind == "reg" else decl.kind
            decl.direction = direction
            decl.signed = signed or decl.signed
            if rng:
                decl.msb, decl.lsb = rng
            mod.signals[name] = decl
            if name not in mod.ports:
                mod.ports.append(name)
            if not self.accept("op", ","):
                break
        self.expect("op", ";")

    def _parse_net_decl(self, mod: Module):
        kindw = self.next().text
        kind = {"wire": "wire", "tri": "wire", "wand": "wire", "wor": "wire",
                "supply0": "wire", "supply1": "wire", "reg": "reg",
                "logic": "reg", "integer": "integer",
                "genvar": "genvar"}.get(kindw, "reg")
        ityp = self._INT_TYPES.get(kindw)
        if ityp and self.accept("kw", "unsigned"):
            ityp = (ityp[0], False)
        elif ityp and self.accept("kw", "signed"):
            ityp = (ityp[0], True)
        signed = bool(self.accept("kw", "signed")) or \
            bool(ityp and ityp[1])
        rng = self._accept_range()
        if rng is None and ityp:
            rng = (("num", Val.from_int(ityp[0] - 1, 32)),
                   ("num", Val.from_int(0, 32)))
        while True:
            name = self.expect("id").text
            decl = mod.signals.get(name) or SignalDecl(name=name)
            decl.kind = kind
            decl.signed = signed or decl.signed
            if rng:
                decl.msb, decl.lsb = rng
            if kind == "integer":
                decl.msb, decl.lsb = ("num", Val.from_int(31, 32)), \
                    ("num", Val.from_int(0, 32))
                decl.signed = True
            # array dims
            while self.at("op", "["):
                self.next()
                am = self.parse_expr()
                self.expect("op", ":")
                al = self.parse_expr()
                self.expect("op", "]")
                decl.array_dims.append((am, al))
            mod.signals[name] = decl
            if self.accept("op", "="):
                rhs = self.parse_expr()
                if kind == "wire":
                    mod.assigns.append((("id", name), rhs))
                else:
                    mod.initials.append(("blocking", ("id", name), rhs))
            if not self.accept("op", ","):
                break
        self.expect("op", ";")

    def _parse_param_decl(self, mod: Module, kw: str):
        self.next()
        self._accept_type_words()
        self._accept_range()
        tgt = mod.params if kw == "parameter" else mod.localparams
        while True:
            name = self.expect("id").text
            self.expect("op", "=")
            tgt[name] = self.parse_expr()
            if kw == "parameter":
                mod.param_order.append(name)
            if not self.accept("op", ","):
                break
        self.expect("op", ";")

    def _parse_always(self) -> AlwaysBlock:
        t = self.next()
        kind = {"always": "always", "always_ff": "ff",
                "always_comb": "comb", "always_latch": "latch"}[t.text]
        sens = None
        if self.accept("op", "@"):
            if self.accept("op", "*"):
                sens = None
            elif self.accept("op", "("):
                if self.accept("op", "*"):
                    sens = None
                else:
                    sens = []
                    while True:
                        edge = "any"
                        if self.accept("kw", "posedge"):
                            edge = "pos"
                        elif self.accept("kw", "negedge"):
                            edge = "neg"
                        sens.append((edge, self.parse_expr()))
                        if self.accept("kw", "or") or self.accept("op", ","):
                            continue
                        break
                self.expect("op", ")")
        body = self.parse_statement()
        if kind == "always" and sens is not None and \
                any(e in ("pos", "neg") for e, _ in sens):
            kind = "ff"
        elif kind == "always" and sens is None:
            kind = "comb"
        return AlwaysBlock(kind=kind, sensitivity=sens, body=body,
                           line=t.line)

    # -- statements -----------------------------------------------------------
    def parse_statement(self) -> Any:
        t = self.peek()
        if self.accept("kw", "begin"):
            label = None
            if self.accept("op", ":"):
                label = self.expect("id").text
            stmts = []
            # block-local declarations (allowed anywhere in the block,
            # with optional initializers — SV interleaved decls)
            local_decls = []
            while not self.at("kw", "end"):
                if self.peek().kind == "kw" and (
                        self.peek().text in ("reg", "logic") or
                        self.peek().text in self._INT_TYPES):
                    mod_tmp = Module(name="_blk")
                    self._parse_net_decl(mod_tmp)
                    local_decls.extend(mod_tmp.signals.values())
                    stmts.extend(mod_tmp.initials)
                else:
                    stmts.append(self.parse_statement())
            self.expect("kw", "end")
            if self.accept("op", ":"):
                self.expect("id")          # end : label
            return ("block", stmts, label, local_decls)
        if t.kind == "kw" and t.text in ("unique", "unique0", "priority"):
            # qualifiers affect lint/X-semantics only in the reference;
            # parse and drop (pe_synth mines one-hot DC from them later)
            self.next()
            return self.parse_statement()
        if self.accept("kw", "break"):
            self.expect("op", ";")
            return ("break",)
        if self.accept("kw", "continue"):
            self.expect("op", ";")
            return ("continue",)
        if self.accept("kw", "if"):
            self.expect("op", "(")
            cond = self.parse_expr()
            self.expect("op", ")")
            then = self.parse_statement()
            els = None
            if self.accept("kw", "else"):
                els = self.parse_statement()
            return ("if", cond, then, els)
        if t.kind == "kw" and t.text in ("case", "casez", "casex"):
            kind = self.next().text
            self.expect("op", "(")
            expr = self.parse_expr()
            self.expect("op", ")")
            items = []
            default = None
            while not self.at("kw", "endcase"):
                if self.accept("kw", "default"):
                    self.accept("op", ":")
                    default = self.parse_statement()
                    continue
                pats = [self.parse_expr()]
                while self.accept("op", ","):
                    pats.append(self.parse_expr())
                self.expect("op", ":")
                items.append((pats, self.parse_statement()))
            self.expect("kw", "endcase")
            return ("case", kind, expr, items, default)
        if self.accept("kw", "for"):
            self.expect("op", "(")
            decls = []
            if self.peek().kind == "kw" and (
                    self.peek().text in ("reg", "logic") or
                    self.peek().text in self._INT_TYPES):
                # for (int i = 0; ...) — decl-init scoped to the loop
                mod_tmp = Module(name="_for")
                kindw = self.peek().text
                # _parse_net_decl consumes the trailing ';' of the init
                self._parse_net_decl(mod_tmp)
                decls = list(mod_tmp.signals.values())
                init = mod_tmp.initials[0] if mod_tmp.initials else None
                _ = kindw
            else:
                init = self._parse_simple_assign()
                self.expect("op", ";")
            cond = self.parse_expr()
            self.expect("op", ";")
            step = self._parse_simple_assign()
            self.expect("op", ")")
            body = self.parse_statement()
            loop = ("for", init, cond, step, body)
            if decls:
                return ("block", [loop], None, decls)
            return loop
        if self.accept("kw", "while"):
            self.expect("op", "(")
            cond = self.parse_expr()
            self.expect("op", ")")
            return ("while", cond, self.parse_statement())
        if self.accept("kw", "repeat"):
            self.expect("op", "(")
            cnt = self.parse_expr()
            self.expect("op", ")")
            return ("repeat", cnt, self.parse_statement())
        if self.accept("kw", "do"):
            body = self.parse_statement()
            self.expect("kw", "while")
            self.expect("op", "(")
            cond = self.parse_expr()
            self.expect("op", ")")
            self.expect("op", ";")
            return ("do_while", body, cond)
        if self.accept("kw", "forever"):
            return ("forever", self.parse_statement())
        if self.accept("op", "#"):
            amt = self.parse_primary()
            if self.at("op", ";"):
                self.next()
                return ("delay", amt, None)
            return ("delay", amt, self.parse_statement())
        if self.accept("op", ";"):
            return ("block", [], None, [])
        if t.kind == "sys":
            # system task call: $display etc. — parse and ignore most
            name = self.next().text
            args = []
            if self.accept("op", "("):
                if not self.at("op", ")"):
                    args.append(self.parse_expr())
                    while self.accept("op", ","):
                        args.append(self.parse_expr())
                self.expect("op", ")")
            self.expect("op", ";")
            return ("systask", name, args)
        if self.accept("kw", "disable"):
            name = self.expect("id").text
            self.expect("op", ";")
            return ("disable", name)
        if self.accept("kw", "return"):
            val = None
            if not self.at("op", ";"):
                val = self.parse_expr()
            self.expect("op", ";")
            return ("return", val)
        # assignment or task call
        stmt = self._parse_simple_assign(allow_task=True)
        self.expect("op", ";")
        return stmt

    def parse_lvalue(self) -> Any:
        """LHS parse that will not swallow a top-level <= as comparison."""
        if self.at("op", "{"):
            return self.parse_primary()     # concat lvalue
        return self.parse_postfix()

    def _parse_simple_assign(self, allow_task=False) -> Any:
        lhs = self.parse_lvalue()
        t = self.peek()
        if t.kind == "op" and t.text == "=":
            self.next()
            return ("blocking", lhs, self.parse_expr())
        if t.kind == "op" and t.text == "<=":
            self.next()
            return ("nonblocking", lhs, self.parse_expr())
        if t.kind == "op" and t.text in ("+=", "-=", "*=", "/=", "%=",
                                         "&=", "|=", "^=", "<<=", ">>=",
                                         "<<<=", ">>>="):
            op = self.next().text[:-1]
            rhs = self.parse_expr()
            return ("blocking", lhs, ("binary", op, lhs, rhs))
        if t.kind == "op" and t.text in ("++", "--"):
            op = self.next().text[0]
            one = ("num", Val.from_int(1, 32))
            return ("blocking", lhs, ("binary", op, lhs, one))
        if allow_task and lhs[0] in ("id", "call"):
            if lhs[0] == "call":
                return ("calltask", lhs[1], lhs[2])
            return ("calltask", lhs[1], [])
        self.err(f"expected assignment operator, got {t.text!r}")

    # -- functions/tasks ---------------------------------------------------
    def _parse_function(self, mod: Module):
        self.expect("kw", "function")
        automatic = bool(self.accept("kw", "automatic") or
                         (self.at("id") and
                          self.peek().text == "automatic" and self.next()))
        _kind, signed, rng = self._parse_data_type(default_kind="reg")
        name = self.expect("id").text
        ret = SignalDecl(name=name, kind="reg", signed=signed)
        if rng:
            ret.msb, ret.lsb = rng
        args: List[SignalDecl] = []
        locals_: dict = {}
        if self.accept("op", "("):
            while not self.at("op", ")"):
                self._parse_fn_arg(args)
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        self.expect("op", ";")
        # declarations then single statement (or block)
        while self.at("kw", "input") or self.at("kw", "reg") or \
                self.at("kw", "logic") or (
                    self.peek().kind == "kw" and
                    self.peek().text in self._INT_TYPES):
            if self.at("kw", "input"):
                self._parse_fn_arg_decl(args)
            else:
                mod_tmp = Module(name="_fn")
                self._parse_net_decl(mod_tmp)
                locals_.update(mod_tmp.signals)
        body = self.parse_statement()
        self.expect("kw", "endfunction")
        mod.functions[name] = FunctionDef(name=name, ret=ret, args=args,
                                          locals=locals_, body=body,
                                          automatic=automatic)

    def _parse_fn_arg(self, args: List[SignalDecl]):
        self.accept("kw", "input")
        _kind, signed, rng = self._parse_data_type(default_kind="reg")
        name = self.expect("id").text
        d = SignalDecl(name=name, kind="reg", signed=signed,
                       direction="input")
        if rng:
            d.msb, d.lsb = rng
        args.append(d)

    def _parse_fn_arg_decl(self, args: List[SignalDecl]):
        self.expect("kw", "input")
        _kind, signed, rng = self._parse_data_type(default_kind="reg")
        while True:
            name = self.expect("id").text
            d = SignalDecl(name=name, kind="reg", signed=signed,
                           direction="input")
            if rng:
                d.msb, d.lsb = rng
            args.append(d)
            if not self.accept("op", ","):
                break
        self.expect("op", ";")

    def _parse_task(self, mod: Module):
        self.expect("kw", "task")
        self.accept("kw", "automatic")
        name = self.expect("id").text
        args: List[SignalDecl] = []
        locals_: dict = {}
        if self.accept("op", "("):
            while not self.at("op", ")"):
                direction = "input"
                if self.at("kw", "input") or self.at("kw", "output") or \
                        self.at("kw", "inout"):
                    direction = self.next().text
                _kind, signed, rng = self._parse_data_type(
                    default_kind="reg")
                aname = self.expect("id").text
                d = SignalDecl(name=aname, kind="reg", signed=signed,
                               direction=direction)
                if rng:
                    d.msb, d.lsb = rng
                args.append(d)
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        self.expect("op", ";")
        while self.at("kw", "input") or self.at("kw", "output") or \
                self.at("kw", "reg") or self.at("kw", "logic") or (
                    self.peek().kind == "kw" and
                    self.peek().text in self._INT_TYPES):
            if self.at("kw", "input") or self.at("kw", "output"):
                direction = self.next().text
                _kind, signed, rng = self._parse_data_type(
                    default_kind="reg")
                while True:
                    aname = self.expect("id").text
                    d = SignalDecl(name=aname, kind="reg", signed=signed,
                                   direction=direction)
                    if rng:
                        d.msb, d.lsb = rng
                    args.append(d)
                    if not self.accept("op", ","):
                        break
                self.expect("op", ";")
            else:
                mod_tmp = Module(name="_task")
                self._parse_net_decl(mod_tmp)
                locals_.update(mod_tmp.signals)
        body = self.parse_statement()
        self.expect("kw", "endtask")
        mod.tasks[name] = TaskDef(name=name, args=args, locals=locals_,
                                  body=body)

    # -- generate -------------------------------------------------------------
    def _parse_generate_item(self, out: List[Any]):
        if self.accept("kw", "for"):
            self.expect("op", "(")
            init = self._parse_simple_assign()
            self.expect("op", ";")
            cond = self.parse_expr()
            self.expect("op", ";")
            step = self._parse_simple_assign()
            self.expect("op", ")")
            label = None
            items: List[Any] = []
            if self.accept("kw", "begin"):
                if self.accept("op", ":"):
                    label = self.expect("id").text
                sub = Module(name="_gen")
                while not self.at("kw", "end"):
                    self.parse_module_item(sub)
                self.expect("kw", "end")
                items.append(sub)
            else:
                sub = Module(name="_gen")
                self.parse_module_item(sub)
                items.append(sub)
            gv = init[1][1] if init[0] == "blocking" else None
            out.append(GenerateFor(genvar=gv, init=init, cond=cond,
                                   step=step, label=label, items=items))
            return
        if self.accept("kw", "if"):
            self.expect("op", "(")
            cond = self.parse_expr()
            self.expect("op", ")")
            then_items: List[Any] = []
            else_items: List[Any] = []

            def parse_branch(dst):
                if self.accept("kw", "begin"):
                    if self.accept("op", ":"):
                        self.expect("id")
                    sub = Module(name="_gen")
                    while not self.at("kw", "end"):
                        self.parse_module_item(sub)
                    self.expect("kw", "end")
                    dst.append(sub)
                else:
                    sub = Module(name="_gen")
                    self.parse_module_item(sub)
                    dst.append(sub)

            parse_branch(then_items)
            if self.accept("kw", "else"):
                parse_branch(else_items)
            out.append(GenerateIf(cond=cond, then_items=then_items,
                                  else_items=else_items))
            return
        self.err("unsupported generate item")

    # -- gate primitives (and g1(o, a, b); etc.) -------------------------------
    def _parse_gate_primitive(self, mod: Module):
        gate = self.next().text
        while True:
            if self.at("id"):
                self.next()       # optional instance name
            self.expect("op", "(")
            args = [self.parse_expr()]
            while self.accept("op", ","):
                args.append(self.parse_expr())
            self.expect("op", ")")
            out, ins = args[0], args[1:]
            opmap = {"and": "&", "or": "|", "xor": "^", "nand": "&",
                     "nor": "|", "xnor": "^"}
            if gate in ("not", "buf"):
                rhs = ("unary", "~", ins[0]) if gate == "not" else ins[0]
            else:
                rhs = ins[0]
                for e in ins[1:]:
                    rhs = ("binary", opmap[gate], rhs, e)
                if gate in ("nand", "nor", "xnor"):
                    rhs = ("unary", "~", rhs)
            mod.assigns.append((out, rhs))
            if not self.accept("op", ","):
                break
        self.expect("op", ";")

    # -- instances ---------------------------------------------------------
    def _parse_instance(self, mod: Module):
        mname = self.expect("id").text
        overrides: List[Tuple[Optional[str], Any]] = []
        if self.accept("op", "#"):
            self.expect("op", "(")
            if self.at("op", "."):
                while self.accept("op", "."):
                    pname = self.expect("id").text
                    self.expect("op", "(")
                    overrides.append((pname, self.parse_expr()))
                    self.expect("op", ")")
                    if not self.accept("op", ","):
                        break
            else:
                while not self.at("op", ")"):
                    overrides.append((None, self.parse_expr()))
                    if not self.accept("op", ","):
                        break
            self.expect("op", ")")
        while True:
            iname = self.expect("id").text
            # optional array of instances [msb:lsb] — not supported yet
            self.expect("op", "(")
            conns: List[Tuple[Optional[str], Any]] = []
            if self.at("op", "."):
                while self.accept("op", "."):
                    pname = self.expect("id").text
                    self.expect("op", "(")
                    e = None
                    if not self.at("op", ")"):
                        e = self.parse_expr()
                    self.expect("op", ")")
                    conns.append((pname, e))
                    if not self.accept("op", ","):
                        break
            elif not self.at("op", ")"):
                conns.append((None, self.parse_expr()))
                while self.accept("op", ","):
                    if self.at("op", ")"):
                        conns.append((None, None))
                        break
                    conns.append((None, self.parse_expr()))
            self.expect("op", ")")
            mod.instances.append(Instance(module=mname, name=iname,
                                          param_overrides=list(overrides),
                                          connections=conns,
                                          line=self.peek().line))
            if not self.accept("op", ","):
                break
        self.expect("op", ";")

    # -- expressions -----------------------------------------------------------
    def parse_expr(self) -> Any:
        return self.parse_ternary()

    def parse_ternary(self) -> Any:
        cond = self.parse_binary(0)
        if self.accept("op", "?"):
            t = self.parse_expr()
            self.expect("op", ":")
            f = self.parse_expr()
            return ("cond", cond, t, f)
        return cond

    def parse_binary(self, min_prec: int) -> Any:
        lhs = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind != "op" or t.text not in _PREC:
                return lhs
            prec = _PREC[t.text]
            if prec < min_prec:
                return lhs
            op = self.next().text
            rhs = self.parse_binary(prec + 1)
            lhs = ("binary", op, lhs, rhs)

    def parse_unary(self) -> Any:
        t = self.peek()
        if t.kind == "op" and t.text in _UNARY:
            op = self.next().text
            # reduction ~& ~| etc: lexer splits "~" "&"
            if op == "~" and self.peek().kind == "op" and \
                    self.peek().text in ("&", "|", "^"):
                op = "~" + self.next().text
            return ("unary", op, self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self) -> Any:
        e = self.parse_primary()
        while True:
            if self.at("op", "["):
                self.next()
                i1 = self.parse_expr()
                if self.accept("op", ":"):
                    i2 = self.parse_expr()
                    self.expect("op", "]")
                    e = ("slice", e, i1, i2)
                elif self.accept("op", "+:"):
                    wexpr = self.parse_expr()
                    self.expect("op", "]")
                    e = ("pslice", e, i1, wexpr, "+")
                elif self.accept("op", "-:"):
                    wexpr = self.parse_expr()
                    self.expect("op", "]")
                    e = ("pslice", e, i1, wexpr, "-")
                else:
                    self.expect("op", "]")
                    e = ("index", e, i1)
            else:
                return e

    def parse_primary(self) -> Any:
        t = self.peek()
        # SV casts: byte'(x), int'(x), N'(x)
        if t.kind == "kw" and t.text in self._INT_TYPES and \
                self.peek(1).kind == "op" and self.peek(1).text == "'":
            self.next()
            self.next()
            self.expect("op", "(")
            e = self.parse_expr()
            self.expect("op", ")")
            w, sgn = self._INT_TYPES[t.text]
            return ("cast", w, sgn, e)
        if t.kind == "num" and self.peek(1).kind == "op" and \
                self.peek(1).text == "'":
            w = int(t.text.replace("_", ""))
            self.next()
            self.next()
            self.expect("op", "(")
            e = self.parse_expr()
            self.expect("op", ")")
            return ("cast", w, None, e)
        if t.kind == "num":
            self.next()
            # possible sized literal: 8 'hFF handled by lexer as basednum
            return ("num", Val.from_int(int(t.text.replace("_", "")), 32,
                                        True))
        if t.kind == "basednum":
            self.next()
            return ("num", parse_based_literal(t.text))
        if t.kind == "fill":
            # unbased unsized '0/'1/'x/'z: 1-bit signed so assignment-
            # context resize replicates into every bit
            self.next()
            ch = t.text.lower()
            vu = {"0": (0, 0), "1": (1, 0), "x": (0, 1), "z": (1, 1)}[ch]
            return ("num", Val.make(vu[0], vu[1], 1, True))
        if t.kind == "string":
            self.next()
            v = 0
            for ch in t.text:
                v = (v << 8) | ord(ch)
            return ("num", Val.from_int(v, max(8 * len(t.text), 8)))
        if t.kind == "sys":
            name = self.next().text
            args = []
            if self.accept("op", "("):
                if not self.at("op", ")"):
                    args.append(self.parse_expr())
                    while self.accept("op", ","):
                        args.append(self.parse_expr())
                self.expect("op", ")")
            return ("syscall", name, args)
        if t.kind == "id" or (t.kind == "kw" and t.text in self._SOFT_ID):
            name = self.next().text
            if self.at("op", "("):
                self.next()
                args = []
                if not self.at("op", ")"):
                    args.append(self.parse_expr())
                    while self.accept("op", ","):
                        args.append(self.parse_expr())
                self.expect("op", ")")
                return ("call", name, args)
            # hierarchical name a.b — used for generate-scope access
            while self.at("op", ".") and self.peek(1).kind == "id":
                self.next()
                name += "." + self.expect("id").text
            return ("id", name)
        if self.accept("op", "("):
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        if self.accept("op", "{"):
            first = self.parse_expr()
            if self.at("op", "{"):
                # replication {N{expr}}
                self.next()
                inner = [self.parse_expr()]
                while self.accept("op", ","):
                    inner.append(self.parse_expr())
                self.expect("op", "}")
                self.expect("op", "}")
                body = inner[0] if len(inner) == 1 else ("concat", inner)
                return ("repl", first, body)
            parts = [first]
            while self.accept("op", ","):
                parts.append(self.parse_expr())
            self.expect("op", "}")
            return ("concat", parts)
        self.err(f"unexpected token {t.text!r} in expression")


def compile_source(src: str, preprocess_options=None) -> List[Module]:
    """preprocess -> lex -> parse (digital.h compile(), :10321-10349)."""
    from .preprocess import preprocess
    text = preprocess(src, preprocess_options)
    toks = lex(text)
    return Parser(toks).parse_source()
