"""AST node definitions for the Verilog subset.

Expressions and statements are plain tuples (fast to build/walk); module
structure uses dataclasses.  Mirrors the entity set of the reference
compiler (digital.h:1329-1623: expr_node / stmt_node / compiled_module)
without the hash-consing — the Python front-end is compile-time only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class SignalDecl:
    name: str
    kind: str = "wire"            # wire | reg | integer | genvar
    msb: Any = None               # expr or None (scalar)
    lsb: Any = None
    signed: bool = False
    array_dims: List[Tuple[Any, Any]] = field(default_factory=list)
    direction: Optional[str] = None   # input | output | inout | None


@dataclass
class AlwaysBlock:
    kind: str                      # 'always' | 'ff' | 'comb' | 'latch'
    # sensitivity: None = @* ; else list of (edge, expr) with edge in
    # ('pos','neg','any')
    sensitivity: Optional[List[Tuple[str, Any]]]
    body: Any
    line: int = 0


@dataclass
class Instance:
    module: str
    name: str
    param_overrides: List[Tuple[Optional[str], Any]]
    # connections: list of (port_name_or_None, expr_or_None)
    connections: List[Tuple[Optional[str], Any]]
    line: int = 0


@dataclass
class FunctionDef:
    name: str
    ret: SignalDecl
    args: List[SignalDecl]
    locals: Dict[str, SignalDecl]
    body: Any
    automatic: bool = False


@dataclass
class TaskDef:
    name: str
    args: List[SignalDecl]
    locals: Dict[str, SignalDecl]
    body: Any


@dataclass
class GenerateFor:
    genvar: str
    init: Any
    cond: Any
    step: Any
    label: Optional[str]
    items: List[Any]


@dataclass
class GenerateIf:
    cond: Any
    then_items: List[Any]
    else_items: List[Any]


@dataclass
class Module:
    name: str
    ports: List[str] = field(default_factory=list)
    signals: Dict[str, SignalDecl] = field(default_factory=dict)
    params: Dict[str, Any] = field(default_factory=dict)       # name->expr
    localparams: Dict[str, Any] = field(default_factory=dict)
    param_order: List[str] = field(default_factory=list)
    assigns: List[Tuple[Any, Any]] = field(default_factory=list)
    always_blocks: List[AlwaysBlock] = field(default_factory=list)
    initials: List[Any] = field(default_factory=list)
    instances: List[Instance] = field(default_factory=list)
    functions: Dict[str, FunctionDef] = field(default_factory=dict)
    tasks: Dict[str, TaskDef] = field(default_factory=dict)
    generates: List[Any] = field(default_factory=list)
    line: int = 0
