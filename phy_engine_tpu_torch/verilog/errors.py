"""Shared front-end diagnostic error base.

Every stage (preprocess, lex, parse, elaborate, synth) raises a
subclass of :class:`CompileError`, so embedders catch one type — the
same single-diagnostic-channel contract as the reference's compile
result error list (digital.h lex_result/compile errors)."""


class CompileError(Exception):
    def __init__(self, msg: str, line: int = 0):
        super().__init__(f"line {line}: {msg}" if line else msg)
        self.line = line
