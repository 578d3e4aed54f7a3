"""verilog2plsav: Verilog -> synthesized gates -> PhysicsLab .sav scene
(the port's copy of ``phy_engine_tpu/cli/verilog2plsav.py``; host work
only, it runs on a machine without a card).

CLI parity with ``src/verilog2plsav.cpp:343-420``:

    verilog2plsav OUT.sav IN.v [--top NAME] [-O0..-O5|-Omax]
                  [--loop-unroll N] [--report] [--time]
                  [--name SCENE_NAME]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .verilog2penl import make_resolver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="verilog2plsav", description=__doc__)
    ap.add_argument("output")
    ap.add_argument("input")
    ap.add_argument("--top", default=None)
    for lvl in range(6):
        ap.add_argument(f"-O{lvl}", dest="opt_level", action="store_const",
                        const=lvl)
    ap.add_argument("-Omax", dest="opt_level", action="store_const",
                    const=5)
    ap.add_argument("--loop-unroll", type=int, default=4096)
    ap.add_argument("--assume-binary-inputs", action="store_true",
                    help="enable X/Z-unsafe optimizations (O3+ truth-table passes)")
    ap.add_argument("--opt-verify", action="store_true",
                    help="Omax: verify candidate netlists (exhaustive <=12 inputs, else random vectors)")
    ap.add_argument("--omax-restarts", type=int, default=4)
    ap.add_argument("--omax-budget", type=float, default=None,
                    help="Omax wall-clock budget in seconds")
    ap.add_argument("--opt-cost", choices=("gate_count", "weighted"),
                    default="gate_count")
    ap.add_argument("--omax-seed", type=int, default=0)
    ap.add_argument("--name", default=None)
    ap.add_argument("--layout", choices=("fast", "quality"),
                    default="fast",
                    help="placement mode (quality = spectral embedding"
                         " + occupancy grid + force refinement)")
    ap.add_argument("--time", dest="timing", action="store_true")
    ap.add_argument("--report", action="store_true")
    from .verilog2penl import (add_budget_flags, add_weight_flags,
                               budgets_from_args, weights_from_args)
    add_budget_flags(ap)
    add_weight_flags(ap)
    args = ap.parse_args(argv)

    from .. import Netlist, netops
    from ..verilog import (compile_source, build_design, elaborate,
                           find_module)
    from ..verilog.preprocess import PreprocessOptions
    from ..verilog.synth import synthesize_to_netlist, SynthOptions
    from ..models import INPUT, OUTPUT
    from ..io.plsav import circuit_to_experiment

    t0 = time.perf_counter()
    with open(args.input) as f:
        src = f.read()
    resolver = make_resolver(os.path.dirname(os.path.abspath(args.input)))
    mods = compile_source(src, PreprocessOptions(include_resolver=resolver))
    design = build_design(mods)
    topm = find_module(design, args.top) if args.top else mods[-1]
    inst = elaborate(design, topm)

    nl = Netlist()
    port_nets = {}
    for pname in topm.ports:
        sig = inst.signals[pname]
        nets = [netops.create_node(nl, f"{pname}[{i}]")
                for i in range(sig.width)]
        port_nets[pname] = nets
        io = OUTPUT if sig.decl.direction == "output" else INPUT
        for i, n in enumerate(nets):
            m = netops.add_model(nl, io, name=f"{pname}[{i}]")
            netops.add_to_node(nl, m, 0, n)
    report = synthesize_to_netlist(
        nl, design, inst, port_nets,
        SynthOptions(opt_level=args.opt_level or 0,
                     loop_unroll_limit=args.loop_unroll,
                     assume_binary_inputs=args.assume_binary_inputs,
                     omax_restarts=args.omax_restarts,
                     omax_time_budget_s=args.omax_budget,
                     omax_verify=args.opt_verify,
                     omax_cost_model=args.opt_cost,
                     omax_weights=weights_from_args(args),
                     omax_seed=args.omax_seed,
                     budgets=budgets_from_args(args)))
    from ..io.plsav import ExportOptions
    ex = circuit_to_experiment(
        nl, options=ExportOptions(layout=args.layout),
        name=args.name or os.path.splitext(
            os.path.basename(args.output))[0])
    ex.save(args.output)
    dt = time.perf_counter() - t0
    if args.report:
        print(f"gates: {report.gate_count}  ffs: {report.ff_count}  "
              f"elements: {len(ex.elements)}  wires: {len(ex.wires)}",
              file=sys.stderr)
        st = report.opt_stats
        if st is not None and st.omax_summary:
            print(st.omax_summary, file=sys.stderr)
        for w in report.warnings:
            print(f"warning: {w}", file=sys.stderr)
    if args.timing:
        print(f"time: {dt * 1e3:.1f} ms", file=sys.stderr)
    return 0


def _main_checked(argv=None) -> int:
    from ..verilog.errors import CompileError
    try:
        return main(argv)
    except CompileError as e:
        print(f"verilog2plsav: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(_main_checked())
