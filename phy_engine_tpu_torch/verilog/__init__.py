"""Synthesizable-subset Verilog front-end (host-side compiler; the port's
copy of ``phy_engine_tpu/verilog``, pure Python, held identical by
``tests/test_torch_verilog.py``).

Capability parity with the reference's ``verilog/digital/digital.h``
(preprocess -> lex -> parse -> elaborate -> event-driven simulate) and
``pe_synth.h`` (synthesize to gate netlist).  This is compile-time host
code by design (SURVEY.md §7: "front-end stays host code"); only the
lowered gate cones run on the device.
"""

from .preprocess import preprocess, PreprocessOptions
from .lexer import lex
from .parser import compile_source, CompileError
from .elaborate import build_design, elaborate, find_module
from .simulate import simulate, settle, Runtime
from .fourstate import Val

__all__ = ["preprocess", "PreprocessOptions", "lex", "compile_source",
           "CompileError", "build_design", "elaborate", "find_module",
           "simulate", "settle", "Runtime", "Val"]
