"""verilog2penl: Verilog -> PE netlist file (the port's copy of
``phy_engine_tpu/cli/verilog2penl.py``; synthesis and the file are host
work, no tensor is built, so it runs on a machine without a card).

CLI parity with ``src/verilog2penl.cpp:64-120``:

    verilog2penl OUT.penl IN.v [--top NAME] [--module | --synth]
                 [-O0..-O5|-Omax] [--time] [--report]
                 [--loop-unroll N]

``--module`` embeds the design as a VERILOG_MODULE device (event-driven
runtime); ``--synth`` (default) lowers to primitive gates and runs the
optimization pipeline at the selected level (O1 netlist-local passes,
O2/O3 the graph tier, O4/O5/Omax the budgeted multi-start search —
see verilog/optimize.py and QOR.md for the recorded gate counts).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


_WEIGHT_OPS = ("NOT", "AND", "OR", "XOR", "XNOR", "NAND", "NOR",
               "IMP", "NIMP", "YES", "CASE_EQ", "IS_UNKNOWN")


def add_weight_flags(ap) -> None:
    """--opt-weight-<OP> N (verilog2penl.cpp:95-106): per-primitive
    weights for the Omax weighted cost model."""
    for op in _WEIGHT_OPS:
        ap.add_argument(f"--opt-weight-{op}", dest=f"w_{op}",
                        type=float, default=None, metavar="N")


def weights_from_args(args):
    w = {op: getattr(args, f"w_{op}") for op in _WEIGHT_OPS
         if getattr(args, f"w_{op}", None) is not None}
    return w or None


def add_budget_flags(ap) -> None:
    """Per-pass budget / DC / guard flags shared by both CLIs
    (verilog2penl.cpp:107-120 flag family)."""
    ap.add_argument("--qm-max-vars", type=int, default=None,
                    help="2-level minimize budget (0 disables)")
    ap.add_argument("--qm-exact-vars", type=int, default=None)
    ap.add_argument("--qm-max-gates", type=int, default=None)
    ap.add_argument("--qm-max-targets", type=int, default=None)
    ap.add_argument("--sop-max-vars", type=int, default=None)
    ap.add_argument("--resub-max-targets", type=int, default=None,
                    help="resub budget (0 disables)")
    ap.add_argument("--resub-max-divisors", type=int, default=None)
    ap.add_argument("--sweep-max-pairs", type=int, default=None,
                    help="equivalence-sweep budget (0 disables)")
    ap.add_argument("--rewrite-max-candidates", type=int, default=None,
                    help="cut-rewrite budget (0 = unlimited)")
    ap.add_argument("--techmap-max-cut", type=int, default=None)
    ap.add_argument("--decomp-min-vars", type=int, default=None)
    ap.add_argument("--decomp-max-vars", type=int, default=None,
                    help="decomposition window (0 disables)")
    ap.add_argument("--no-dc-xz", action="store_true",
                    help="disable X/Z don't-care inference")
    ap.add_argument("--no-dc-fsm", action="store_true",
                    help="disable FSM reachable-state don't-cares")
    ap.add_argument("--no-dc-odc", action="store_true",
                    help="disable observability don't-cares")
    ap.add_argument("--dc-fsm-max-bits", type=int, default=None)
    ap.add_argument("--max-total-models", type=int, default=None,
                    help="global growth guard (0 disables)")
    ap.add_argument("--max-total-logic-gates", type=int, default=None)


def budgets_from_args(args):
    """PassBudgets from parsed CLI flags (None = tuned default)."""
    from ..verilog.optimize import PassBudgets
    b = PassBudgets()
    for flag, field in (
            ("qm_max_vars", "qm_max_vars"),
            ("qm_exact_vars", "qm_exact_vars"),
            ("qm_max_gates", "qm_max_gates"),
            ("qm_max_targets", "qm_max_targets"),
            ("sop_max_vars", "sop_max_vars"),
            ("resub_max_targets", "resub_max_targets"),
            ("resub_max_divisors", "resub_max_divisors"),
            ("sweep_max_pairs", "sweep_max_pairs"),
            ("rewrite_max_candidates", "rewrite_max_candidates"),
            ("techmap_max_cut", "techmap_max_cut"),
            ("decomp_min_vars", "decomp_min_vars"),
            ("decomp_max_vars", "decomp_max_vars"),
            ("dc_fsm_max_bits", "dc_fsm_max_bits"),
            ("max_total_models", "max_total_models"),
            ("max_total_logic_gates", "max_total_logic_gates")):
        v = getattr(args, flag, None)
        if v is not None:
            setattr(b, field, v)
    if getattr(args, "no_dc_xz", False):
        b.infer_dc_from_xz = False
    if getattr(args, "no_dc_fsm", False):
        b.infer_dc_from_fsm = False
    if getattr(args, "no_dc_odc", False):
        b.infer_dc_from_odc = False
    return b


def make_resolver(base_dir: str):
    def resolve(name: str):
        p = os.path.join(base_dir, name)
        if os.path.exists(p):
            with open(p) as f:
                return f.read()
        return None
    return resolve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="verilog2penl", description=__doc__)
    ap.add_argument("output")
    ap.add_argument("input")
    ap.add_argument("--top", default=None)
    ap.add_argument("--module", action="store_true",
                    help="embed as VERILOG_MODULE instead of synthesizing")
    ap.add_argument("--synth", action="store_true", default=True)
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
    ap.add_argument("--time", dest="timing", action="store_true")
    ap.add_argument("--report", action="store_true")
    # export options (reference: --layout file|dir, --mode, --no-io)
    ap.add_argument("--layout", choices=("file", "dir"), default="file")
    ap.add_argument("--mode", choices=("full", "structure",
                                       "checkpoint"), default="full")
    ap.add_argument("--no-io", action="store_true",
                    help="do not generate INPUT/OUTPUT models")
    ap.add_argument("--overwrite", action="store_true",
                    help="overwrite an existing output file "
                         "(reference verilog2penl.cpp:64-120 semantics:"
                         " refuse by default)")
    add_budget_flags(ap)
    add_weight_flags(ap)
    args = ap.parse_args(argv)

    from .. import Netlist, netops
    from ..io import save

    t0 = time.perf_counter()
    with open(args.input) as f:
        src = f.read()
    resolver = make_resolver(os.path.dirname(os.path.abspath(args.input)))

    nl = Netlist()
    if args.module:
        from ..models import make_verilog_module, INPUT, OUTPUT
        vm = make_verilog_module(src, top=args.top,
                                 include_resolver=resolver)
        netops.add_model(nl, vm)
        ports = vm.params["_ports"]
        for pi, (pname, pdir, _w) in enumerate(ports):
            node = netops.create_node(nl, pname)
            netops.add_to_node(nl, vm, pi, node)
            if args.no_io:
                continue
            io = OUTPUT if pdir == "output" else INPUT
            m = netops.add_model(nl, io, name=pname)
            netops.add_to_node(nl, m, 0, node)
        report = None
    else:
        from ..verilog import (compile_source, build_design, elaborate,
                               find_module)
        from ..verilog.preprocess import PreprocessOptions
        from ..verilog.synth import synthesize_to_netlist, SynthOptions
        from ..models import INPUT, OUTPUT
        mods = compile_source(src, PreprocessOptions(
            include_resolver=resolver))
        design = build_design(mods)
        topm = find_module(design, args.top) if args.top else mods[-1]
        inst = elaborate(design, topm)
        port_nets = {}
        for pname in topm.ports:
            sig = inst.signals[pname]
            nets = [netops.create_node(nl, f"{pname}[{i}]")
                    for i in range(sig.width)]
            port_nets[pname] = nets
            if args.no_io:
                continue
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

    from ..io.penl import SaveOptions
    mode = {"full": "full", "structure": "structure_only",
            "checkpoint": "runtime_only"}[args.mode]
    layout = "directory" if args.layout == "dir" else "single_file"
    if os.path.exists(args.output) and not args.overwrite:
        print(f"error: output exists: {args.output} (use --overwrite)",
              file=sys.stderr)
        return 1
    save(args.output, nl, SaveOptions(mode=mode, layout=layout))
    dt = time.perf_counter() - t0
    if args.report and report is not None:
        print(f"gates: {report.gate_count}  ffs: {report.ff_count}",
              file=sys.stderr)
        st = report.opt_stats
        if st is not None:
            nz = {k: v for k, v in vars(st).items()
                  if v and k not in ("omax_trace", "omax_summary",
                                     "passes")}
            if nz:
                print("opt: " + " ".join(f"{k}={v}"
                                         for k, v in sorted(nz.items())),
                      file=sys.stderr)
            # per-pass gate deltas + wall time (pe_synth_report.passes)
            for name, before, after, us in st.passes:
                print(f"  pass {name:<10s} {before:>6d} -> {after:<6d}"
                      f" {us/1000.0:8.1f} ms", file=sys.stderr)
            if st.omax_summary:
                print(st.omax_summary, file=sys.stderr)
                for r, stage, cost in st.omax_trace:
                    print(f"  restart {r} after {stage}: cost={cost:.0f}",
                          file=sys.stderr)
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
        print(f"verilog2penl: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(_main_checked())
