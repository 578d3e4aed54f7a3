"""VERILOG_MODULE: the behavioral simulator embedded as a netlist device
(the port's copy of ``phy_engine_tpu/models/verilog_module.py``).

Parity with ``model/models/digital/verilog_module.h:73-348``: wraps a
compiled design + elaborated instance state, exposes the top module's
ports as pins (one pin per port, in port-list order), samples inputs
(analog nets via Ll/Hl thresholds), runs one behavioral tick per
``digital_clk``, drives digital nets and requests analog drives for
output ports on analog nets.

Engine integration: the device is host-side (the behavioral simulator is
host Python, :mod:`..verilog.simulate`), bridged into the levelled tick
as forced-signal inputs — its inputs read the *previous* tick's settled
values (before_all_clk semantics) and its outputs enter this tick's
settle like INPUT devices.
"""

from __future__ import annotations

from typing import Dict, Optional

from .base import ModelDef, DeviceClass, UpdatePhase, register


def _ports_of(params) -> list:
    return params.get("_ports", [])


VERILOG_MODULE = register(ModelDef(
    name="VERILOG_MODULE", id_name="VERILOG",
    device_class=DeviceClass.DIGITAL,
    defaults={"Ll": 0.0, "Hl": 5.0},
    digital_op="VERILOG", update_phase=UpdatePhase.BEFORE,
    attrs=("Ll", "Hl"), dynamic_params=True,
    pin_names_fn=lambda params: [n for n, _d, _w in _ports_of(params)],
))


def make_verilog_module(source: str, top: Optional[str] = None,
                        name: str = "", params: Optional[Dict] = None,
                        Ll: float = 0.0, Hl: float = 5.0,
                        include_resolver=None):
    """compile -> build_design -> find_module -> elaborate -> wrap
    (verilog_module.h:308-348 ``make_verilog_module``)."""
    from ..verilog import (compile_source, build_design, elaborate,
                           find_module, settle, Runtime)
    from ..verilog.preprocess import PreprocessOptions
    from ..netlist.netlist import ModelInstance

    opts = PreprocessOptions(include_resolver=include_resolver) \
        if include_resolver else None
    mods = compile_source(source, opts)
    design = build_design(mods)
    topm = find_module(design, top) if top else mods[-1]
    inst_state = elaborate(design, topm, params)

    ports = []
    for pname in topm.ports:
        sig = inst_state.signals[pname]
        ports.append((pname, sig.decl.direction or "input", sig.width))

    minst = ModelInstance(VERILOG_MODULE, {
        "Ll": Ll, "Hl": Hl, "_ports": ports,
    }, name=name or (top or topm.name))
    rt = Runtime(inst_state)
    settle(rt, 0)
    minst.runtime = {
        "design": design, "inst_state": inst_state, "rt": rt,
        "tick": 0, "source": source, "top": topm.name,
    }
    return minst
