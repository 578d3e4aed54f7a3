"""Port parity: the Verilog front end and synthesis of phy_engine_tpu_torch
give the JAX package's gate netlist, gate for gate.

Each design is synthesized by both packages from the same source, with
the same port nets and INPUT devices made in the same order; the
SynthReports agree on gate and flip-flop counts and the netlists agree
model for model (id_name, each pin's net by its place in the netlist,
params)."""

import functools

import numpy as np
import pytest

import phy_engine_tpu as pe
from phy_engine_tpu import netops as jnetops
from phy_engine_tpu.models import INPUT as JINPUT
from phy_engine_tpu.verilog import (build_design as j_build_design,
                                    compile_source as j_compile_source,
                                    elaborate as j_elaborate,
                                    find_module as j_find_module)
from phy_engine_tpu.verilog.synth import (SynthOptions as JSynthOptions,
                                          synthesize_to_netlist as j_synth)

from phy_engine_tpu_torch import workloads
from phy_engine_tpu_torch.verilog import compile_source, build_design, elaborate, find_module

from test_fp16 import FP16_ADD_SRC
from test_riscv import _cpu_source
from test_snake import SNAKE_SRC

FSM_SRC = """
    module t(input clk, input rst_n, input d, output reg [1:0] q);
      always @(posedge clk or negedge rst_n)
        if (!rst_n) q <= 2'b00;
        else q <= {q[0], d ^ q[1]};
    endmodule
    """

# name -> (source, top module, ports driven by INPUT devices)
DESIGNS = {
    "snake": (SNAKE_SRC, "snake4", ("clk", "rst_n", "dir")),
    "fp16": (FP16_ADD_SRC, "fp16_add", ("a", "b")),
    "fsm": (FSM_SRC, "t", ("clk", "rst_n", "d")),
    "rv32": (workloads.RV32_SRC, "pe_rv32", ("clk", "rst_n")),
}


def jax_synth(src, top, inputs, opt_level=1):
    """The JAX package's counterpart of ``workloads.synth_top``: same
    nets, same INPUT devices, in the same order."""
    design = j_build_design(j_compile_source(src))
    topm = j_find_module(design, top)
    inst = j_elaborate(design, topm)
    c = pe.Circuit()
    nl = c.nl
    pn = {p: [jnetops.create_node(nl) for _ in range(inst.signals[p].width)]
          for p in topm.ports}
    ins = {}
    for name in inputs:
        ins[name] = []
        for n in pn[name]:
            m = jnetops.add_model(nl, JINPUT, {"boolean": 0.0})
            jnetops.add_to_node(nl, m, 0, n)
            ins[name].append(m)
    report = j_synth(nl, design, inst, pn, JSynthOptions(opt_level=opt_level))
    return c, ins, pn, report


@functools.lru_cache(maxsize=None)
def built(name, opt_level=1):
    """(JAX build, port build) of a design, each as (circuit, ins, nets,
    report); the port's circuit runs on the CPU."""
    src, top, inputs = DESIGNS[name]
    return (jax_synth(src, top, inputs, opt_level),
            workloads.synth_top(src, top, "cpu", opt_level, inputs=inputs))


def gate_list(nl):
    """Every live model as (id_name, pin nets by place, params)."""
    place = {id(n): i for i, n in enumerate([nl.ground_node] + nl.nodes)}
    out = []
    for m in nl.live_models():
        pins = tuple(place[id(p.node)] if p.node is not None else -1
                     for p in m.pins)
        out.append((m.mdef.id_name, pins,
                    tuple(sorted((k, float(v)) for k, v in m.params.items()))))
    return out


@pytest.mark.parametrize("name,opt_level", [
    ("snake", 0), ("snake", 1), ("fp16", 0), ("fp16", 1),
    ("fsm", 0), ("fsm", 1), ("rv32", 1)])
def test_synthesis_matches_jax(name, opt_level):
    (jc, _ji, _jp, jrep), (tc, _ti, _tp, trep) = built(name, opt_level)
    assert (trep.gate_count, trep.ff_count, trep.gate_count_pre_opt) == (
        jrep.gate_count, jrep.ff_count, jrep.gate_count_pre_opt)
    assert trep.gate_count > 0
    tg, jg = gate_list(tc.nl), gate_list(jc.nl)
    assert len(tg) == len(jg)
    assert sorted(tg) == sorted(jg)          # the gate multiset
    assert tg == jg                          # and the same order


def test_rv32_sizes():
    """The RV32 core at -O1: the size the kernel is designed around."""
    (_jc, _ji, _jp, jrep), (_tc, _ti, _tp, trep) = built("rv32", 1)
    assert (trep.gate_count, trep.ff_count) == (22051, 640)


def test_port_sources_are_the_tests():
    src, expect = _cpu_source()
    assert workloads.RV32_SRC == src
    assert workloads.RV32_EXPECT == expect == 4264
    assert workloads.FP16_ADD_SRC == FP16_ADD_SRC


def test_front_end_exports():
    mods = compile_source(FSM_SRC)
    design = build_design(mods)
    topm = find_module(design, "t")
    inst = elaborate(design, topm)
    assert list(topm.ports) == ["clk", "rst_n", "d", "q"]
    assert inst.signals["q"].width == 2


def test_logic_tables_match_jax():
    from phy_engine_tpu.digital import logic as jl
    from phy_engine_tpu_torch.digital import logic as tl
    for name in ("AND_TABLE", "OR_TABLE", "XOR_TABLE", "XNOR_TABLE",
                 "NAND_TABLE", "NOR_TABLE", "IMP_TABLE", "NIMP_TABLE",
                 "RESOLVE2_TABLE", "NOT_TABLE", "YES_TABLE"):
        np.testing.assert_array_equal(getattr(tl, name), getattr(jl, name))
    codes = np.arange(4, dtype=np.uint32)
    v, u = tl.code_to_planes(codes)
    np.testing.assert_array_equal(tl.planes_to_code(v, u), codes)
