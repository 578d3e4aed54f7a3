"""Verilog preprocessor.

Feature parity with the reference preprocessor (digital.h:144-872):
``\\`define`` (incl. function-like macros), ``\\`undef``, ``\\`ifdef`` /
``\\`ifndef`` / ``\\`else`` / ``\\`elsif`` / ``\\`endif``, ``\\`include``
via a user-supplied resolver callback, and macro expansion with a depth
limit.  Line mapping is preserved by emitting ``\\n`` for consumed
directive lines so diagnostics point at original source lines.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


from .errors import CompileError


class PreprocessError(CompileError):
    pass


@dataclass
class MacroDef:
    params: Optional[List[str]]
    body: str


@dataclass
class PreprocessOptions:
    defines: Dict[str, str] = field(default_factory=dict)
    # include_resolver(name) -> source text or None
    include_resolver: Optional[Callable[[str], Optional[str]]] = None
    max_include_depth: int = 16
    max_expand_depth: int = 64


_ID = r"[A-Za-z_][A-Za-z0-9_$]*"
_DIRECTIVE_RE = re.compile(r"^\s*`(" + _ID + r")(.*)$")
_MACRO_USE_RE = re.compile(r"`(" + _ID + r")")


def _strip_comments(src: str) -> str:
    """Remove // and /* */ comments, preserving newlines."""
    out = []
    i = 0
    n = len(src)
    while i < n:
        c = src[i]
        if c == "/" and i + 1 < n and src[i + 1] == "/":
            j = src.find("\n", i)
            i = n if j < 0 else j
        elif c == "/" and i + 1 < n and src[i + 1] == "*":
            j = src.find("*/", i + 2)
            if j < 0:
                raise PreprocessError("unterminated block comment")
            out.append("\n" * src.count("\n", i, j + 2))
            i = j + 2
        elif c == '"':
            j = i + 1
            while j < n and src[j] != '"':
                j += 2 if src[j] == "\\" else 1
            out.append(src[i:j + 1])
            i = j + 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _split_args(text: str) -> Tuple[List[str], int]:
    """Parse '(a, b, ...)' starting at text[0] == '('; returns args and
    consumed length."""
    depth = 0
    args = []
    cur = []
    for i, ch in enumerate(text):
        if ch == "(":
            depth += 1
            if depth == 1:
                continue
        elif ch == ")":
            depth -= 1
            if depth == 0:
                args.append("".join(cur).strip())
                return args, i + 1
        elif ch == "," and depth == 1:
            args.append("".join(cur).strip())
            cur = []
            continue
        if depth >= 1:
            cur.append(ch)
    raise PreprocessError("unterminated macro argument list")


def preprocess(src: str, options: Optional[PreprocessOptions] = None,
               _depth: int = 0) -> str:
    opt = options or PreprocessOptions()
    if _depth > opt.max_include_depth:
        raise PreprocessError("include depth limit exceeded")
    macros: Dict[str, MacroDef] = {
        k: MacroDef(None, v) for k, v in opt.defines.items()}
    return _run(_strip_comments(src), opt, macros, _depth)


def _run(src: str, opt: PreprocessOptions, macros: Dict[str, MacroDef],
         depth: int) -> str:
    out_lines: List[str] = []
    lines = src.split("\n")
    # conditional stack: (taken_now, any_taken, in_else)
    stack: List[List[bool]] = []

    def active() -> bool:
        return all(fr[0] for fr in stack)

    i = 0
    while i < len(lines):
        line = lines[i]
        # line continuation for `define
        m = _DIRECTIVE_RE.match(line)
        if m:
            name, rest = m.group(1), m.group(2)
            if name == "define":
                while rest.rstrip().endswith("\\") and i + 1 < len(lines):
                    rest = rest.rstrip()[:-1] + "\n" + lines[i + 1]
                    out_lines.append("")
                    i += 1
                if active():
                    dm = re.match(r"\s*(" + _ID + r")(\([^)]*\))?\s?(.*)",
                                  rest, re.S)
                    if not dm:
                        raise PreprocessError("malformed `define", i + 1)
                    mname = dm.group(1)
                    params = None
                    if dm.group(2):
                        params = [p.strip() for p in
                                  dm.group(2)[1:-1].split(",") if p.strip()]
                    macros[mname] = MacroDef(params, dm.group(3).strip())
                out_lines.append("")
                i += 1
                continue
            if name == "undef":
                if active():
                    macros.pop(rest.strip(), None)
                out_lines.append("")
                i += 1
                continue
            if name in ("ifdef", "ifndef"):
                sym = rest.strip()
                cond = (sym in macros) == (name == "ifdef")
                stack.append([cond and active(), cond, False])
                out_lines.append("")
                i += 1
                continue
            if name == "elsif":
                if not stack:
                    raise PreprocessError("`elsif without `ifdef", i + 1)
                fr = stack[-1]
                sym = rest.strip()
                cond = sym in macros
                fr[0] = (not fr[1]) and cond and (
                    active() if len(stack) == 1 else
                    all(f[0] for f in stack[:-1]))
                fr[1] = fr[1] or cond
                out_lines.append("")
                i += 1
                continue
            if name == "else":
                if not stack:
                    raise PreprocessError("`else without `ifdef", i + 1)
                fr = stack[-1]
                parent = all(f[0] for f in stack[:-1])
                fr[0] = (not fr[1]) and parent
                fr[2] = True
                out_lines.append("")
                i += 1
                continue
            if name == "endif":
                if not stack:
                    raise PreprocessError("`endif without `ifdef", i + 1)
                stack.pop()
                out_lines.append("")
                i += 1
                continue
            if name == "include":
                if active():
                    im = re.match(r'\s*"([^"]+)"', rest)
                    if not im:
                        raise PreprocessError("malformed `include", i + 1)
                    if opt.include_resolver is None:
                        raise PreprocessError(
                            f"`include {im.group(1)!r} but no resolver",
                            i + 1)
                    inc = opt.include_resolver(im.group(1))
                    if inc is None:
                        raise PreprocessError(
                            f"include not found: {im.group(1)}", i + 1)
                    if depth + 1 > opt.max_include_depth:
                        raise PreprocessError("include depth limit", i + 1)
                    # share the macro table: `define in the include is
                    # visible to the including file and vice versa
                    expanded = _run(_strip_comments(inc), opt, macros,
                                    depth + 1)
                    out_lines.append(expanded)
                else:
                    out_lines.append("")
                i += 1
                continue
            if name in ("timescale", "default_nettype", "celldefine",
                        "endcelldefine", "resetall"):
                out_lines.append("")
                i += 1
                continue
            # fall through: macro use at line start

        if not active():
            out_lines.append("")
            i += 1
            continue
        out_lines.append(_expand(line, macros, opt, 0, i + 1))
        i += 1

    if stack:
        raise PreprocessError("unterminated `ifdef")
    return "\n".join(out_lines)


def _expand(line: str, macros: Dict[str, MacroDef],
            opt: PreprocessOptions, depth: int, lineno: int) -> str:
    if depth > opt.max_expand_depth:
        raise PreprocessError("macro expansion depth exceeded", lineno)
    if "`" not in line:
        return line
    out = []
    i = 0
    while i < len(line):
        m = _MACRO_USE_RE.search(line, i)
        if not m:
            out.append(line[i:])
            break
        out.append(line[i:m.start()])
        name = m.group(1)
        mac = macros.get(name)
        if mac is None:
            raise PreprocessError(f"undefined macro `{name}", lineno)
        j = m.end()
        body = mac.body
        if mac.params is not None:
            while j < len(line) and line[j] in " \t":
                j += 1
            if j >= len(line) or line[j] != "(":
                raise PreprocessError(
                    f"macro `{name} expects arguments", lineno)
            args, used = _split_args(line[j:])
            j += used
            if len(mac.params) == 0 and args == [""]:
                args = []          # `ZERO() — empty parens, zero params
            if len(args) != len(mac.params):
                raise PreprocessError(
                    f"macro `{name}: {len(args)} args, expected "
                    f"{len(mac.params)}", lineno)
            for p, a in zip(mac.params, args):
                body = re.sub(r"\b" + re.escape(p) + r"\b", a, body)
        out.append(_expand(body, macros, opt, depth + 1, lineno))
        i = j
    return "".join(out)
