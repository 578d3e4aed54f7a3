"""Verilog lexer (reference: token tables in digital.h:89-140)."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional

KEYWORDS = {
    "module", "endmodule", "input", "output", "inout", "wire", "reg",
    "logic", "integer", "real", "parameter", "localparam", "assign",
    "always", "always_comb", "always_ff", "always_latch", "initial",
    "begin", "end", "if", "else", "case", "casez", "casex", "endcase",
    "default", "for", "while", "repeat", "do", "forever", "posedge",
    "negedge", "or", "and", "not", "xor", "nand", "nor", "xnor", "buf",
    "function", "endfunction", "task", "endtask", "return", "generate",
    "endgenerate", "genvar", "signed", "unsigned", "wand", "wor", "tri",
    "supply0", "supply1", "disable", "event",
    # SystemVerilog integral types / qualifiers (digital.h keyword table)
    "int", "byte", "shortint", "longint", "bit", "automatic",
    "unique", "unique0", "priority", "break", "continue",
}

# multi-char operators, longest first
OPERATORS = [
    "<<<=", ">>>=", "<<=", ">>=",
    "<<<", ">>>", "===", "!==", "**", "~^", "^~", "~&", "~|",
    "<=", ">=", "==", "!=", "&&", "||", "<<", ">>", "+:", "-:", "->",
    "++", "--", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=",
    "(", ")", "[", "]", "{", "}", ";", ",", ".", ":", "?", "@", "#",
    "=", "+", "-", "*", "/", "%", "&", "|", "^", "~", "!", "<", ">",
    "$", "'",
]

_NUM_RE = re.compile(
    r"(?:(\d+)\s*)?'\s*([sS]?)([bodhBODH])\s*(-?[0-9a-fA-FxXzZ_?]+)")
_FILL_RE = re.compile(r"'\s*([01xXzZ])(?![0-9a-zA-Z_])")
_DEC_RE = re.compile(r"\d[\d_]*")
_ID_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_$]*")
_SYS_RE = re.compile(r"\$[A-Za-z_][A-Za-z0-9_$]*")
_REAL_RE = re.compile(r"\d[\d_]*\.\d[\d_]*(?:[eE][+-]?\d+)?")


@dataclass
class Token:
    kind: str      # 'kw', 'id', 'num', 'basednum', 'op', 'string', 'sys'
    text: str
    line: int
    col: int

    def __repr__(self):  # pragma: no cover
        return f"{self.kind}:{self.text}"


from .errors import CompileError


class LexError(CompileError):
    def __init__(self, msg, line, col):
        Exception.__init__(self, f"line {line}:{col}: {msg}")
        self.line = line


def lex(src: str) -> List[Token]:
    toks: List[Token] = []
    line = 1
    col = 1
    i = 0
    n = len(src)
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            col = 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            col += 1
            continue
        if c == '"':
            j = i + 1
            while j < n and src[j] != '"':
                j += 2 if src[j] == "\\" else 1
            if j >= n:
                raise LexError("unterminated string", line, col)
            toks.append(Token("string", src[i + 1:j], line, col))
            col += j + 1 - i
            i = j + 1
            continue
        m = _NUM_RE.match(src, i)
        if m:
            toks.append(Token("basednum", m.group(0), line, col))
            col += m.end() - i
            i = m.end()
            continue
        m = _FILL_RE.match(src, i)
        if m:
            # unbased unsized fill literal '0 '1 'x 'z
            toks.append(Token("fill", m.group(1), line, col))
            col += m.end() - i
            i = m.end()
            continue
        m = _REAL_RE.match(src, i)
        if m:
            toks.append(Token("real", m.group(0), line, col))
            col += m.end() - i
            i = m.end()
            continue
        m = _DEC_RE.match(src, i)
        if m:
            toks.append(Token("num", m.group(0), line, col))
            col += m.end() - i
            i = m.end()
            continue
        m = _SYS_RE.match(src, i)
        if m:
            toks.append(Token("sys", m.group(0), line, col))
            col += m.end() - i
            i = m.end()
            continue
        m = _ID_RE.match(src, i)
        if m:
            text = m.group(0)
            kind = "kw" if text in KEYWORDS else "id"
            toks.append(Token(kind, text, line, col))
            col += m.end() - i
            i = m.end()
            continue
        for op in OPERATORS:
            if src.startswith(op, i):
                toks.append(Token("op", op, line, col))
                i += len(op)
                col += len(op)
                break
        else:
            raise LexError(f"unexpected character {c!r}", line, col)
    toks.append(Token("eof", "", line, col))
    return toks
