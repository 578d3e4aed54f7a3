#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (phy_engine_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises, exit code non-zero):

0. device   — a CUDA card is required (no CPU fallback); its name and
              power limit from nvidia-smi.
1. build    — nvcc builds the hand-written kernels of
              phy_engine_tpu_torch/ops/csrc (gj.cu, lu_block.cu, turbo.cu,
              coo_spmm.cu; one nvcc per source, all at once; into build/, at first
              use), and prints ptxas's register / shared-memory lines for
              each kernel.
2. kernels  — each inverse / solve kernel (gj_inverse32, gj_solve32,
              lu_block_inverse32) against its plain torch version on the
              card at (B, n) = (256, 256) and (8, 128): random, MNA-border,
              singular-lane and block-singular-lane systems, within
              gj_cases.TOL (1e-4 relative to max|x| of the lane) of the
              plain version and of float64 numpy; a lane the kernel cannot
              invert (singular for all three, block-singular for the
              blocked inverse) non-finite in both.  Times each kernel, its
              plain version and torch.linalg.inv / torch.linalg.solve as
              the library call at the main path's shape (CUDA events);
              bound_ms from the function's least work (gj_bound).  Then
              every kernel at bench_mxu.py's (64, 512) and (16, 1024) on
              random systems, against its plain version and numpy, timed
              beside its plain version and the library call.  At each
              shape, each kernel's device time split by CUDA kernel
              (torch.profiler over one call; lu_block's panel and update
              launches, the GJ kernels' panel and update launches).
              lu_block_inverse32 on the four systems at n = 96 and 160,
              where n % 128 != 0.  Every kernel at phase 10's shape
              (16, 1152) against its plain version and numpy (lu_block
              on the four systems, GJ on all but block_singular).  The
              GJ kernels past one block (a
              thread-block cluster a lane): against their plain versions
              and numpy at (2, 1152) and (2, 2048), repeat runs
              bit-identical, and by the residual max|A X - I| (max|A x -
              b| / max|b| for the solve) at (1, 4096); each timed beside
              torch.linalg and its bound.  Then ops/gj.py::solve_batched
              (equilibration, padding, f64 refinement and the NaN reject
              around gj_solve32) on 256 random systems at n = 256 and at
              n = 200 (padded to 256), one lane rank-1: within 1e-7 of
              float64 numpy on the others, the rank-1 lane NaN,
              gj_solve32 launched three times a call (these launches are
              added to gj_solve32's count in the kernels line); timed
              beside torch.linalg.solve_ex on the same f64 systems.
3. ladder   — the 63-stage diode ladder, B = 6, 25 frozen-Newton steps,
              on the card and on the CPU (plain kernels) with the same
              params: traces within 1e-6 of max|trace|; once per refactor
              (inv = "gj" and "block").
4. determinism — phase 3 on the card again, per refactor: bit-identical.
5. main path — workloads.frozen_transient: 255 stages (256 unknowns),
              B = 256, 100 steps of 50 ns.  Every lane converges, x is
              finite; lanes 0-3 agree with a CPU run of those lanes to
              1e-6; circuit-steps/s (CUDA events); both GJ kernels' launch
              counts over this run are > 0, and each kernel's launches x
              its phase-2 time per call.
6. turbo    — the whole-tick digital kernel against its plain torch
              version, bit-identical on every slot, tick, lane and plane:
              (a) RV32 from reset, 8 ticks, B = 2; (b) the fp16 adder with
              random V/U words (X and Z lanes included), 16 ticks, B = 4,
              full history and a watch list; (c) case (b) with the state
              forced into the global-memory placement; (d) RV32, B = 128,
              each instance from its own random V/U start words, 8 ticks,
              watching phase 8's signals; (e) fp16's plan with one chunk
              per gate op (every op, random operands), in both
              placements.  Prints the RV32 schedule (levels per tick per
              pass, records, the host's build time), times kernel and
              plain version at (a) (CUDA events; bound_ms from (a)'s
              inputs), times the kernel on RV32 B = 1 x 404 ticks, full
              history, under its schedule and under two altered ones that
              keep the indices but not the function (each level a row
              with no gate; no level at all): us per tick and ns per
              level, where the time per level goes.  Then ptxas's register
              lines of the turbo kernel.
7. digital main path — Circuit.digital_run on the RV32 core (22,051
              gates + 640 flip-flops at -O1), one instance, reset plus 200
              clocks (404 ticks): result = 4264 and done = 1 on lane 0 of
              the last tick; the turbo kernel launched; wall time (CUDA
              events) and gate-evals/s = (gates + FFs) x ticks / wall;
              the kernel alone at B = 1 x 404 with the full history,
              beside its bound.
8. batched  — Circuit.digital_run_batch, 128 RV32 instances x 400 ticks
              from the common post-reset state, watching result and done:
              every instance ends with 4264; aggregate gate-evals/s and
              peak device memory; the kernel alone at B = 128 x 404 with
              the watch list, beside its bound.
9. block path — phase 5 with the blocked refactor,
              workloads.frozen_transient(..., inv="block"): every lane
              converges, x is finite; lu_block_inverse32 launched and
              gj_inverse32 never; lanes 0-3 agree with a CPU run of those
              lanes (inv="block") to 1e-6, and the final x with phase 5's
              to 1e-6 of max|x|; circuit-steps/s, launches, peak memory.
10. past 1024 — workloads.frozen_transient(stages=1151): 1152 unknowns,
              B = 16, 10 steps, with inv="gj" and inv="block" (the GJ
              kernels' panels and lu_block's panel rows split over
              clusters).  Every lane converges, the two final x agree to
              1e-6 of max|x|; refactors (inverse launches), bursts
              (gj_solve32 launches) and circuit-steps/s for each.
11. Circuit — the analog Circuit driver on the same 255-stage ladder
              (workloads.diode_ladder_netlist, 256 unknowns), every solve
              the per-lane dense f64 Newton (ops/linsolve.py::
              lu_solve_gauss, torch ops, no hand kernel): (a) OP, TR for
              100 steps of 50 ns, ACOP over 101 log-spaced points from
              2π·1 kHz to 2π·1 GHz (the split-real 512 x 512 system);
              (b) monte_carlo, 5 % R jitter, 256 lanes, TR for 100 steps
              of 50 ns; (c) temp_sweep over 256 temperatures from -40 to
              125 °C.  Each analysis ok and every lane converged; the
              card against the CPU path on (a)'s OP and first 10 TR steps,
              (b)'s lanes 0-3 over their first 10 steps and (c)'s lanes
              0-3, within 1e-6 of max|trace| (and three of (a)'s AC points
              on the card's own bias point).  Prints each analysis's wall
              (CUDA events), the lu_solve_gauss calls in it and their mean
              time (CUDA events around each call), and (b)'s
              circuit-steps/s.

12. BSIM3 — the port's copy of bench_bsim3.py: the 31-stage BSIM3
              inverter chain (62 BSIM3v3.2 devices a lane, 37 unknowns
              padded to 128), TROP seed by the gmin ladder on the card,
              then workloads.bsim3_transient, B = 256 lanes of Vth0 jitter,
              100 steps of 0.1 ns, solver "frozen", max_iter 256: every
              lane converges; gj_inverse32 and gj_solve32 launched at
              (256, 128); lanes 0-3 over the first 10 steps against a CPU
              run of the frozen path on the same 256 lanes (1e-6 of
              max|trace|) and, as
              bench_bsim3.py:288-305 records it, against the per-lane
              dense f64 transient on the CPU (per-sample, 1e-6 V floor;
              printed with its 1e-6 gate, as the bench prints it, not
              held).  Prints the seed's wall apart, circuit-steps/s,
              frozen iterations, refactors and bursts per iteration, how
              often the rescue ladder ran and what it left, the BSIM3
              stamps' and step updates' share of the wall (CUDA events
              around each call) and peak memory.  Times the BSIM3_NMOS
              stamp at (256, 31) with its Jacobian taken three ways:
              models/dual.py (the port's), torch.func.vmap over
              torch.func.jvp (torch.func.jacfwd's scheme) and one
              torch.func.jvp per terminal; held to 1e-12 of each other.
              Then the Circuit path on
              the same chain (g_min 1e-12): OP through gmin stepping from
              x = 0 on the card (printed: it fails the driver's residual
              check, as the JAX package's does), then, on the card and on
              the CPU from the TROP seed, OP, noise at stage 1's output
              (next to the switching point) over 101 log points 1 kHz -
              1 GHz, sens of that node, sens_ac over 21 points; each within
              1e-6 of the CPU's largest |value| (per family for the
              gradients; a family that is 0 on the CPU against the whole
              analysis's largest; an all-zero reference fails), with its
              wall and lu_solve_gauss calls.  Phase 2
              holds and times the GJ pair at (256, 128) for it.

13. levels  — the levelled digital tick (digital/engine.py LevelTick, torch
              ops, no hand kernel): every case of tests/torch_digital_cases
              .CASES (tests/test_torch_levels.py: each family of
              tests/test_digital.py, RANDOM4, the latch of an incomplete
              always @*) on the card and on the CPU, planes and node codes
              bit-identical; then the RV32 core (-O1) from power-up through
              24 ticks of the levelled tick (workloads.rv32_levels), every
              plane of every tick bit-identical to the turbo kernel's full
              history of the same schedule (the turbo kernel is the
              oracle here, its launches counted).  Prints ms a tick and
              device operations a tick (torch.profiler over one tick).
14. mixed   — the 8-bit SAR ADC (workloads.sar_adc, tests/test_adc.py's
              design) at tests/test_adc.py's voltages and rails on the card
              and on the CPU: equal codes (a comparator tie, where the
              trial DAC voltage equals the input, may differ and is held by
              the 1-LSB rule and printed), DAC voltages within 1e-6; the
              16-bit SAR (LSB 5 V / 65536) through 16 conversions at
              voltages drawn from numpy's default_rng(14) over (-0.1, 5.1)
              V, each code within 1 LSB of ideal and equal to a CPU run
              of the same voltages in a process of its own; prints
              conversions/s and the wall split between analyze() and
              digital_clk().  The Tsu/Th RC gate cases (tests/
              test_unsteady.py) through TR and the VERILOG_MODULE cases
              (tests/test_verilog_module.py), card against CPU.
15. flash   — the flash engine (digital/flash.py, torch ops): RV32,
              B = 128 x 100 ticks from power-up, watching phase 8's
              signals, bit-identical to the turbo kernel's watched history
              (the program runs 404 ticks to its result, 4264, which
              phases 7-8 hold; at 100 ticks every instance's watched
              signals agree); the latch-feedback design (the cyclic
              class), B = 128 x 16 ticks of random per-lane stimulus,
              bit-identical to the batched levelled tick.  Prints each
              wall and gate-evals/s.
20. synthesis and the host sweep engine (runs after 15, before 16) — (a)
              RV32 synthesized at -O2 on the host (verilog/opt_graph.py,
              opt_map.py: host Python and the g++-built truth-table
              library native/pe_tt.cpp): its live devices by type and
              its logic gates equal workloads.RV32_O2_COUNTS, which
              tests/test_torch_synth_rv32.py holds the JAX package to;
              prints the host seconds.  (b) Circuit.digital_run on the
              -O2 core, reset plus 200 clocks (404 ticks): result 4264,
              done 1, the turbo kernel launched (these launches join its
              count in the kernels line); wall and gate-evals/s beside
              phase 7's -O1 figures, the kernel alone at B = 1 x 404
              beside its bound; then digital_run_batch, B = 128, every
              result 4264; then the kernel against its plain version on
              the -O2 core, B = 2 x 8 ticks from reset, bit-identical
              (its difference joins max_abs_err in the kernels line).
              (c) The host sweep engine (DigitalEngine(backend="native"),
              native/pe_digital.cpp built by g++) on phase 6's -O1 core
              and on the -O2 core, 404 ticks from reset each: its full
              (T, S) history bit-identical to the turbo kernel's of the
              same schedule on the card; the first run builds the
              library and the plan, the second, timed, runs on the warm
              plan: host wall and gate-evals/s beside the card's
              Circuit.digital_run wall of the same core.  (d) The fp16
              adder at -O3 with assume_binary_inputs and at -O1, 4 x 32
              lanes of random binary operands (numpy default_rng(20)),
              one tick through the turbo kernel (run_ticks_batched with a
              watch list): the -O3 outputs equal the -O1 outputs, no X.
21. surfaces and persistence (runs after 20, before 16) — (a)
              cli.verilog2penl on pe_rv32 at -O2 (--report) on the host,
              io.load of the .penl onto the card: its live devices equal
              phase 20's -O2 core type by type, plus 33 OUTPUT devices;
              workloads.rv32_of_penl finds clk, rst_n and the ports by
              name; Circuit.digital_run over the 404-tick schedule
              launches the turbo kernel (these launches join its count in
              the kernels line): result 4264, done 1, and every net's V
              and U planes at every tick bit-identical to phase 20's -O2
              turbo history.  (b) The 255-stage ladder from element codes
              (workloads.diode_ladder_elements, api.Circuit on the card):
              10 TR steps of 50 ns uninterrupted against 5 steps, a
              runtime_only io.save, io.load into a fresh circuit and 5
              more, within 1e-6 of max|v|; a full save loads back to the
              same IR.  (c) The C ABI: native/pe_capi.c built by cc into
              build/ and loaded with ctypes; create_circuit of the same
              element stream, circuit_set_tr, circuit_analyze and
              circuit_sample within 1e-12 of (b)'s api.Circuit on the card
              and 1e-6 of the CPU; 100 set_model_digital + digital_clk
              calls of a 2-input AND through the C ABI (the host sweep
              engine, which the glue picks for pure gate circuits) timed
              against api.Circuit on the card's levelled tick; a
              verilog_runtime_* round trip (a counter, q = 5).  (d)
              cli.verilog2plsav on fp16_add at -O1 (a .sav with
              auto-layout: 2,427 elements, 60 Logic Inputs with 28
              constants, 16 Logic Outputs) loaded as an Experiment,
              experiment_to_circuit on the card; the operand and output
              bits mapped by the order of the INPUT / OUTPUT devices of
              cli.verilog2penl's netlist of the same design and level
              (the scene has no port names, and its constants are exported
              as switches, set here from that netlist); 8 binary operand
              pairs through sync_inputs, digital_clk (the levelled tick)
              and write_back, every output equal to phase 20's -O1 turbo
              outputs for the same words.
22. mesh (runs after 21, before 16) — parallel/ at world size 1 on
              make_mesh() (NCCL, one card): (a) parallel/dist_gj.py::
              dist_solve at (B, n) = (1, 4096), random and diagonally
              boosted (tests/test_dist_gj.py's systems), within 1e-9
              (relerr) of numpy's f64 solve; the wall, and panel_factor's
              share of it by CUDA events around each call (plain torch,
              launch-bound: its device operations a call by
              torch.profiler).  (b) Circuit(mesh=) on phase 11's ladder at
              256 unknowns: OP through newton_solve_dist and TR 20 x 50
              ns through transient_dist, within 1e-6 of max|x| of phase
              11's dense route (its OP and first 20 TR steps).  (c)
              sharded_batched_transient_shmap on the main-path ladder
              (B = 256, 5 % R jitter, 20 steps of 50 ns, solver hybrid):
              bit-identical to the unsharded transient_batched on the
              card; its gj_solve32 launches join the kernels line.  (d)
              digital_run_batch(mesh=) on phase 8's 128 RV32 instances x
              400 ticks: every watched code bit-identical to phase 8's
              call (run again beside it), every result 4264, through the
              turbo kernel (its launches join the kernels line).  (e)
              temp_sweep(mesh=) of phase 11's 256 temperatures equal to
              phase 11's (the ladder's VAC puts its OP at 0 V), and
              dc_sweep / temp_sweep / monte_carlo (op) with mesh= on the
              ladder driven by 1 V DC, 256 lanes each, bit-identical to
              the local runs.  (f) graphs_equivalent(mesh=) of phase 20's
              fp16 adder at -O1 against -O3 (workloads.comb_graph, ports
              named by bit; 2^20 patterns) true, and false with one output
              flipped; eval_graph_mesh on the RV32 -O2 core's
              combinational graph at 2^17 patterns bit-identical to
              native.eval_graph on the host.  Each part prints its wall.

16. sparse Circuit — first the COO product kernel (coo_spmm,
              csrc/coo_spmm.cu) at the mesh100k.dc cell's shape: B = 64
              lanes of values on the 100,001-unknown random-link mesh
              (torch_circuits.random_link_mesh_ir, 10,000 links; 540,001
              entries in range) against the plain twin
              (COOLayout.matvec_plain) on the same card tensors, bit for
              bit on rows up to 8 entries wide and within 1e-12 of max|y|
              elsewhere, a repeat bit-identical, its time and the plain
              twin's (CUDA events) beside its bytes bound.  Then the
              Circuit driver's sparse route (COO assembly and the f64
              Jacobi BiCGStab of ops/sparse.py, its products through
              coo_spmm, whose launches are counted for the kernels line) on
              workloads.random_mesh_netlist at 100,000 nodes and 400,000
              links (tests/test_sparse.py's generator), solver "auto": (a)
              DC; (b) with a PN_JUNCTION from node 1 to ground (Newton);
              (c) the diode removed, a 1 nF capacitor from every 1,000th
              node to ground, TR for 20 steps of 0.1 us.  Every analysis
              ok on the sparse route, no lu_solve_gauss call; (a) within
              1e-6 (per node, relative) of an independent solve (the MNA
              rebuilt from the netlist, scipy CG on its SPD reduction: a
              direct LU of a random graph fills in ~n^2); (a), (b) and
              (c)'s first 5 steps within 1e-6 of max|x| of the same
              sequence run by the port on the CPU in a process of its
              own.  Prints build and lowering seconds, BiCGStab
              iterations and time, each analysis's wall (CUDA events) and
              peak device memory.
17. 10^6 ladder — first the partitioned tridiagonal kernel
              (tridiag_part64, csrc/tridiag_part.cu) at the ladder1e6.dc
              cell's shape: a random diagonally dominant T of 10^6 rows
              and B = 16 right sides on the card, its factor and its solve
              against the plain twin (part_factor_plain /
              part_solve_plain) on the same card tensors, bit for bit, a
              repeat bit-identical, the residual |T x - b| within 1e-12 of
              |b|; the solve's time (CUDA events, P C C P) beside its bytes
              bound, the factor's, the twin's and one PCR solve's
              (tridiag_solve, the route border_solve took before) at the
              same shape.  Then its per-lane form at the
              mesh100k_l1000.dc cell's band: 64 lanes of a random
              diagonally dominant T of 10^5 rows each, the right side the
              band's rows of a (64, 10^5 + 1) array read in place, factor
              and solve bit for bit the twin, two right sides a lane at
              once too, a repeat bit-identical, a factor of 64 equal
              lanes bit for bit the shared kernel; the solve's time (P C
              C P) beside its bytes bound and PCRFactor.solve's (the
              chain preconditioner's band before), the factor's.
              Then workloads.ladder_dc (bench_ladder.py's
              default mode, the reference's 1000000xR.cpp): netlist,
              assemble_sparse on the card, the host's tridiagonal + border
              extraction, then ops/tridiag.py::border_solve (on the card
              the partitioned kernel, refine 4; its launches counted for
              the kernels line), five timed solves with varied right
              sides; the ramp within 1e-6 V of exact, the source current
              within 1e-9 + 1e-6 I of -V/(N R).
              Phases 17-19 each profile one more solve (torch.profiler):
              device operations, device time and the idle share of the
              solve's wall.
18. 10^8 ladder — workloads.ladder_direct (bench_ladder.py's direct mode,
              100000000xR.cpp): dl / du built on the card, host f64
              pivots (spike_host_pivots), SPIKE in 512 chunks (nbatch 4,
              refine 1); the ramp at nodes 0, N/2 and N-1 and the source
              current within the bench's native-f64 gate (1.2e-4 of V).
              Prints factor seconds, ms a solve (best of 3) and peak
              device memory.
19. sparse mesh — bench_sparse.py on the card: the 100k-node chain plus
              L random links (workloads.sparse_mesh_coo), BandedCOO and
              bicgstab_ell (tol 1e-10, max_iter 20,000): at L = 10^4 it
              converges and agrees with scipy SparseLU within 1e-6 of
              max|x|; at L = 10^3 the result is printed as the bench
              prints it (the JAX package does not converge there either).
              Solves/s and iterations, beside SparseLU's solves/s on the
              host (in a process of its own, started with phase 16).

Then it prints the nvidia-smi line, one JSON line with each kernel's
measurements (the GJ pair also at phase 12's shape, "...@256x128", with
phase 12's launches; coo_spmm with phase 16's, tridiag_part64 with
phase 17's), and, last, {"ok": true,
"device": {...}}.
"""

import copy
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

import phy_engine_tpu_torch as tpe  # noqa: E402
from phy_engine_tpu_torch import (ACSweepType, AnalyzeType, Circuit,
                                  Environment, workloads)
from phy_engine_tpu_torch.digital import turbo, turbo_cases
from phy_engine_tpu_torch.engine import analog
from phy_engine_tpu_torch.ops import (_build, gj, linsolve, lu_block, sparse,
                                      tridiag)
from phy_engine_tpu_torch.ops.gj_cases import TOL, lane_rel_err, singular_lane, system
from phy_engine_tpu_torch.parallel.batch import (batch_params, batch_state,
                                                 batch_x, batched_op,
                                                 batched_transient)

# inverse: the function is A -> A^-1 (else (A, b) -> x); fails_on: the
# gj_cases systems whose bad lane the kernel must leave non-finite
KERNELS = {
    "gj_inverse32": dict(
        wrapper=gj.gj_inverse32, plain=gj.gj_inverse32_plain,
        library=torch.linalg.inv,
        source="phy_engine_tpu_torch/ops/csrc/gj.cu",
        replaces="phy_engine_tpu/ops/gj.py:364",
        inverse=True, fails_on=("singular",)),
    "gj_solve32": dict(
        wrapper=gj.gj_solve32, plain=gj.gj_solve32_plain,
        library=lambda A, b: torch.linalg.solve(A, b),
        source="phy_engine_tpu_torch/ops/csrc/gj.cu",
        replaces="phy_engine_tpu/ops/gj.py:465",
        inverse=False, fails_on=("singular",)),
    "lu_block_inverse32": dict(
        wrapper=lu_block.lu_block_inverse32,
        plain=lu_block.lu_block_inverse32_plain,
        library=torch.linalg.inv,
        source="phy_engine_tpu_torch/ops/csrc/lu_block.cu",
        replaces="phy_engine_tpu/ops/lu_block.py:148",
        inverse=True, fails_on=("singular", "block_singular")),
}
CASES = ("random", "mna_border", "singular", "block_singular")
TURBO = dict(name="turbo_tick", wrapper=turbo.run_turbo,
             source="phy_engine_tpu_torch/ops/csrc/turbo.cu",
             replaces="phy_engine_tpu/digital/turbo.py:665")
COO = dict(name="coo_spmm", wrapper=sparse.coo_spmm,
           source="phy_engine_tpu_torch/ops/csrc/coo_spmm.cu",
           replaces="none (phy_engine_tpu/ops/sparse.py:28 coo_matvec, "
                    "fused by XLA)")
TRACE_TOL = 1e-6
TPART = dict(name="tridiag_part64", wrapper=tridiag.tridiag_part64,
             source="phy_engine_tpu_torch/ops/csrc/tridiag_part.cu",
             replaces="none (phy_engine_tpu/ops/tridiag.py:75 "
                      "tridiag_solve, PCR in XLA)")
AT128 = "@256x128"      # the GJ pair at phase 12's shape, (B, n) = (256, 128)

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and FP32
# on the CUDA cores (an FMA counts two).  32-bit bitwise logic: 64 results
# per SM per clock on compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput table), 132 SMs at 1.98 GHz
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
INT32_OPS = 132 * 64 * 1.98e9
# FP64 on the CUDA cores (the same data sheet; an FMA counts two)
FP64_FLOPS = 34e12


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke failed: {what}")


def say(phase, msg):
    print(f"phase {phase}: {msg}", flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def run_kernel(name, A, b, plain=False, library=False):
    f = KERNELS[name]["library" if library else "plain" if plain
                      else "wrapper"]
    return f(A) if KERNELS[name]["inverse"] else f(A, b)


def bound(nbytes, ops, rate):
    """Least time (ms) for the work and what sets it."""
    t_b, t_o = nbytes / HBM_BPS, ops / rate
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def gj_bound(name, B, n):
    """The least work of the function, not of the kernels' algorithm:
    inverting an n x n matrix takes 2n^3 flops (LU, then the inverse from
    its factors: LAPACK's getrf + getri), solving one system (2/3)n^3 +
    2n^2 (LU, then one right-hand side through both triangles: getrf +
    getrs).  Bytes: A (and b) read once, the result written once, f32."""
    if KERNELS[name]["inverse"]:
        flops, words = 2 * n ** 3, 2 * n * n
    else:
        flops, words = 2 * n ** 3 / 3 + 2 * n * n, n * n + 2 * n
    return bound(4 * B * words, B * flops, FP32_FLOPS)


def numpy_ref(name, A, b):
    A64 = A.astype(np.float64)
    if KERNELS[name]["inverse"]:
        return np.linalg.inv(A64)
    return np.linalg.solve(A64, b.astype(np.float64)[..., None])[..., 0]


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_split(fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler,
    after a warm-up call): {kernel name: (ms, launches)}, empty when the
    trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0)
        m = re.search(r"(\w+_kernel)(<\w+>)?", ev.key)
        if us and m:
            ms, count = split.get(m.group(0), (0.0, 0))
            split[m.group(0)] = (ms + us / 1e3, count + ev.count)
    return split


def say_split(name, B, n, Ad, bd):
    split = device_split(lambda: run_kernel(name, Ad, bd))
    say(2, f"{name} B={B} n={n} device time by kernel (torch.profiler): "
        + (", ".join(f"{k} {ms:.4f} ms / {c}" for k, (ms, c) in
                     sorted(split.items(), key=lambda kv: -kv[1][0]))
           or "not measured (no device time in the trace)"))


def hold(name, A, b, case, Ad, bd):
    """One kernel against its plain version and float64 numpy on one
    system; returns (rel err vs plain, vs numpy, max abs err vs plain)."""
    B = len(A)
    s = singular_lane(B)
    bad = case in KERNELS[name]["fails_on"]
    good = [i for i in range(B) if not bad or i != s]
    k = run_kernel(name, Ad, bd)
    p = run_kernel(name, Ad, bd, plain=True)
    torch.cuda.synchronize()
    k, p = k.cpu().numpy(), p.cpu().numpy()
    what = f"{name} {case} B={B} n={A.shape[1]}"
    check(np.isfinite(k[good]).all(), f"{what}: non-finite")
    e_plain = lane_rel_err(k[good], p[good]).max()
    e_np = lane_rel_err(k[good], numpy_ref(name, A[good], b[good])).max()
    check(e_plain <= TOL, f"{what}: kernel vs plain {e_plain:.3e} > {TOL}")
    check(e_np <= TOL, f"{what}: kernel vs numpy {e_np:.3e} > {TOL}")
    if bad:
        check(not np.isfinite(k[s]).all(), f"{what}: bad lane finite in "
              "the kernel")
        check(not np.isfinite(p[s]).all(), f"{what}: bad lane finite in "
              "the plain version")
    return e_plain, e_np, float(np.abs(k[good] - p[good]).max())


def phase2_kernels(dev):
    results = {k: {"max_abs_err": 0.0} for k in KERNELS}
    for B, n in ((256, 256), (8, 128)):
        for case in CASES:
            A, b = system(case, B, n, seed=B + n)
            Ad, bd = torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev)
            for name in KERNELS:
                e_plain, e_np, err = hold(name, A, b, case, Ad, bd)
                if (B, n) == (256, 256):
                    r = results[name]
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                say(2, f"{name} B={B} n={n} {case}: rel err vs plain "
                    f"{e_plain:.3e}, vs numpy {e_np:.3e}")
    # time each kernel and its plain version at the main path's shape:
    # plain, kernel, kernel, plain; then the library call that computes
    # the same function
    A, b = system("random", 256, 256, seed=1)
    Ad, bd = torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev)
    for name, r in results.items():
        t = [time_ms(lambda: run_kernel(name, Ad, bd, plain=True), 3),
             time_ms(lambda: run_kernel(name, Ad, bd), 20),
             time_ms(lambda: run_kernel(name, Ad, bd), 20),
             time_ms(lambda: run_kernel(name, Ad, bd, plain=True), 3)]
        r["ms"] = (t[1] + t[2]) / 2
        r["plain_ms"] = (t[0] + t[3]) / 2
        r["library_ms"] = time_ms(
            lambda: run_kernel(name, Ad, bd, library=True), 20)
        r["bound_ms"], r["bound_by"] = gj_bound(name, 256, 256)
        say(2, f"{name} B=256 n=256: kernel {t[1]:.4f} / {t[2]:.4f} ms "
            f"({100 * r['bound_ms'] / r['ms']:.1f} % of bound), "
            f"plain {t[0]:.4f} / {t[3]:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        say_split(name, 256, 256, Ad, bd)
    # the GJ pair at phase 12's shape, (B, n) = (256, 128): held on the
    # four systems, then timed as at (256, 256)
    for name in ("gj_inverse32", "gj_solve32"):
        r = results[name + AT128] = {"max_abs_err": 0.0}
        for case in CASES:
            if case == "block_singular":
                continue
            A, b = system(case, 256, 128, seed=7)
            Ad, bd = torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev)
            e_plain, e_np, err = hold(name, A, b, case, Ad, bd)
            r["max_abs_err"] = max(r["max_abs_err"], err)
            say(2, f"{name} B=256 n=128 {case}: rel err vs plain "
                f"{e_plain:.3e}, vs numpy {e_np:.3e}")
        A, b = system("random", 256, 128, seed=2)
        Ad, bd = torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev)
        t = [time_ms(lambda: run_kernel(name, Ad, bd, plain=True), 3),
             time_ms(lambda: run_kernel(name, Ad, bd), 20),
             time_ms(lambda: run_kernel(name, Ad, bd), 20),
             time_ms(lambda: run_kernel(name, Ad, bd, plain=True), 3)]
        r["ms"], r["plain_ms"] = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        r["library_ms"] = time_ms(
            lambda: run_kernel(name, Ad, bd, library=True), 20)
        r["bound_ms"], r["bound_by"] = gj_bound(name, 256, 128)
        say(2, f"{name} B=256 n=128 (phase 12's shape): kernel {t[1]:.4f} / "
            f"{t[2]:.4f} ms ({100 * r['bound_ms'] / r['ms']:.1f} % of bound), "
            f"plain {t[0]:.4f} / {t[3]:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    # every kernel at bench_mxu.py's larger shapes on random systems,
    # against its plain version and numpy, timed beside its plain version
    # (one timed rep at n = 1024) and the library call
    for B, n, plain_reps in ((64, 512, 3), (16, 1024, 1)):
        A, b = system("random", B, n, seed=B + n)
        Ad, bd = torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev)
        for name in KERNELS:
            e_plain, e_np, _err = hold(name, A, b, "random", Ad, bd)
            t_k = time_ms(lambda: run_kernel(name, Ad, bd), 10)
            t_p = time_ms(lambda: run_kernel(name, Ad, bd, plain=True),
                          plain_reps)
            t_lib = time_ms(lambda: run_kernel(name, Ad, bd, library=True),
                            10)
            b_ms, b_by = gj_bound(name, B, n)
            say(2, f"{name} B={B} n={n} random: rel err vs plain "
                f"{e_plain:.3e}, vs numpy {e_np:.3e}; kernel {t_k:.4f} ms "
                f"({100 * b_ms / t_k:.1f} % of bound), plain {t_p:.2f} ms, "
                f"library {t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            say_split(name, B, n, Ad, bd)
    # lu_block where n % 128 != 0: one super-panel of 96, and 128 + 32
    name = "lu_block_inverse32"
    for B, n in ((4, 96), (4, 160)):
        for case in CASES:
            A, b = system(case, B, n, seed=B + n)
            Ad, bd = torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev)
            e_plain, e_np, _err = hold(name, A, b, case, Ad, bd)
            say(2, f"{name} B={B} n={n} {case}: rel err vs plain "
                f"{e_plain:.3e}, vs numpy {e_np:.3e}")
    # every kernel at the shape phase 10 gives it, (16, 1152): lu_block's
    # panel over five blocks, the last 128 rows short; the GJ panel a
    # cluster of two.  GJ takes no block_singular system here: its
    # condition grows with n, and past n = 256 the plain version alone
    # lies beyond TOL of float64 numpy on it.
    B, n = 16, 1152
    for case in CASES:
        A, b = system(case, B, n, seed=B + n)
        Ad, bd = torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev)
        for name in KERNELS:
            if case == "block_singular" and name != "lu_block_inverse32":
                continue
            e_plain, e_np, _err = hold(name, A, b, case, Ad, bd)
            say(2, f"{name} B={B} n={n} {case} (phase 10's shape): rel err "
                f"vs plain {e_plain:.3e}, vs numpy {e_np:.3e}")
    for name in ("gj_inverse32", "gj_solve32"):
        gj_past_one_block(dev, name)
    return results


def gj_past_one_block(dev, name):
    """A GJ kernel where its panel launch is a thread-block cluster (n >
    1024): against its plain version and numpy at (2, 1152) and (2, 2048)
    with repeat runs bit-identical, by its residual at (1, 4096); each
    timed beside the library call and its bound."""
    for B, n in ((2, 1152), (2, 2048), (1, 4096)):
        A, b = system("random", B, n, seed=B + n)
        Ad, bd = torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev)
        if n < 4096:
            e_plain, e_np, _err = hold(name, A, b, "random", Ad, bd)
            same = torch.equal(run_kernel(name, Ad, bd),
                               run_kernel(name, Ad, bd))
            check(same, f"{name} B={B} n={n}: repeat run not bit-identical")
            what = (f"rel err vs plain {e_plain:.3e}, vs numpy {e_np:.3e}, "
                    "repeat run bit-identical")
        else:
            out = run_kernel(name, Ad, bd).double()
            A64 = Ad.double()
            if KERNELS[name]["inverse"]:
                res = float((A64 @ out - torch.eye(n, device=dev,
                                                   dtype=torch.float64))
                            .abs().max())
                what = f"max|A X - I| {res:.3e}"
            else:
                r = (A64 @ out[:, :, None])[:, :, 0] - bd.double()
                res = float(r.abs().max() / bd.double().abs().max())
                what = f"max|A x - b| / max|b| {res:.3e}"
            check(res <= TOL, f"{name} B={B} n={n}: residual {res:.3e} > "
                  f"{TOL}")
        t_k = time_ms(lambda: run_kernel(name, Ad, bd), 3)
        t_lib = time_ms(lambda: run_kernel(name, Ad, bd, library=True), 3)
        b_ms, b_by = gj_bound(name, B, n)
        say(2, f"{name} B={B} n={n} random (cluster panel): {what}; kernel "
            f"{t_k:.4f} ms ({100 * b_ms / t_k:.1f} % of bound), library "
            f"{t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    say_split(name, B, n, Ad, bd)


def gate_ops(rec):
    """Least logic instructions of a pass's gate records.  A three-input
    logic instruction (LOP3) combines at most three words into one, so a
    word that depends on m words takes at least ceil((m - 1) / 2) of
    them.  A two-operand gate's V word depends on both operands' V and U
    words: 2.  A one-operand gate's (NOT, YES: the operand twice) on its
    operand's two: 1.  IS_UNKNOWN's V word is its operand's U word: 0."""
    two = rec[:, 0] != rec[:, 1]
    unknown = (rec[:, 3] >> turbo._OP_CORE_SHIFT) == turbo._N_CORES - 1
    return int(np.where(two, 2, np.where(unknown, 0, 1)).sum())


def turbo_bound(plan, B, T, width):
    """Bytes: the schedule's compact records read once (4 words per gate,
    6 per flip-flop, 1 per forced slot), the start planes and the forced
    planes read once, the history written once.  Operations (see
    gate_ops): each gate's least count, and per flip-flop 4 with its
    reset enabled (the new q's V word depends on 9 words: V of q; V and U
    of d, clock, last clock and reset), else 3 (7 words); once per tick
    and instance."""
    sc = plan.schedule
    ff_ops = int(np.where(sc.ff_rec[:, 5] != 0, 4, 3).sum())
    tab_words = (4 * (len(sc.cone_rec) + len(sc.full_rec))
                 + 6 * len(sc.ff_rec) + plan.nf)
    words = tab_words + B * (2 * plan.K + 2 * T * plan.nf + 2 * T * width)
    ops = B * T * (gate_ops(sc.cone_rec) + gate_ops(sc.full_rec) + ff_ops)
    return bound(4 * words, ops, INT32_OPS)


def turbo_err(case, force_global=False, watch=None):
    """Kernel against plain version on one case: the largest absolute
    difference of any history word of either plane (0 when
    bit-identical)."""
    plan, st0, FV, FU = case
    w = None if watch is None else torch.tensor(watch, device=st0.device)
    hv, hu = turbo.run_turbo(plan, st0, FV, FU, watch=watch,
                             _force_global=force_global)
    pv, pu = turbo.run_turbo_plain(plan, st0, *plan.pad_forced(FV, FU), w)
    torch.cuda.synchronize()
    return int(max((hv.long() - pv.long()).abs().max(),
                   (hu.long() - pu.long()).abs().max()))


def turbo_kernel_ms(dev, rv32, B, ticks, watch=None):
    """The turbo kernel alone on RV32 from its all-X state through
    ``ticks`` ticks of the main path's schedule, B instances (CUDA
    events; not counted as main-path launches), and its bound_ms."""
    plan, st0, FV, FU = turbo_cases.rv32_case(B, ticks, dev, design=rv32)
    ms = time_ms(lambda: turbo.run_turbo(plan, st0, FV, FU, watch=watch), 3)
    width = plan.K if watch is None else len(watch)
    return ms, turbo_bound(plan, B, ticks, width)[0]


def gateless(plan, keep_levels):
    """A copy of ``plan`` (``plan`` itself untouched) whose passes run no
    gate: each level one padding record (``keep_levels``), else no level.
    Every index stays in range; the function does not."""
    sc = plan.schedule
    out = {}
    for p in ("cone", "full"):
        L = len(getattr(sc, p + "_off")) - 1 if keep_levels else 0
        out[p + "_rec"] = np.tile(np.array([0, 0, 0, turbo._OP_PAD],
                                           np.int32), (L, 1))
        out[p + "_off"] = np.arange(L + 1, dtype=np.int32)
    alt = copy.copy(plan)
    alt._sched, alt._dev = dataclasses.replace(sc, **out), {}
    return alt


def turbo_split(dev, rv32, ticks):
    """The kernel on RV32, B = 1 x ``ticks``, full history, under its
    schedule ("real"), with every level's gates taken out ("empty": the
    per-level loop, ring and barrier) and with no level ("none": the
    tick's fixed part, forced inputs, flip-flops and history).  Returns
    {name: ms} (CUDA events; not counted as main-path launches)."""
    plan, st0, FV, FU = turbo_cases.rv32_case(1, ticks, dev, design=rv32)
    plans = {"real": plan, "empty": gateless(plan, True),
             "none": gateless(plan, False)}
    return {k: time_ms(lambda: turbo.run_turbo(p, st0, FV, FU), 3)
            for k, p in plans.items()}


def rv32_watch(rv32):
    """The signals phase 8 watches: the result bus and done."""
    eng = rv32.circuit.digital_engine()
    return [eng.ir.node_sig[id(n)]
            for n in rv32.ports["result"] + rv32.ports["done"]]


def phase6_turbo(dev, rv32):
    errs = []

    def same(case, what, force_global=False, watch=None):
        errs.append(turbo_err(case, force_global, watch))
        check(errs[-1] == 0, f"turbo {what}: kernel != plain, max abs "
              f"err {errs[-1]}")

    case_a = turbo_cases.rv32_case(2, 8, dev, design=rv32)
    same(case_a, "(a) RV32 B=2 T=8")
    say(6, "(a) RV32 from reset, B=2, 8 ticks, full history: "
        "kernel bit-identical to plain")
    case_b = turbo_cases.fp16_case(4, 16, seed=6, device=dev)
    watch = list(range(0, case_b[0].S, 5))
    for force_global, tag in ((False, "b"), (True, "c")):
        placement = "global" if force_global else "shared"
        for w in (None, watch):
            same(case_b, f"({tag}) fp16 {placement} watch={w is not None}",
                 force_global, w)
        say(6, f"({tag}) fp16 adder, random V/U with X/Z lanes, B=4, 16 "
            f"ticks, {placement} placement, full history and watch: "
            "bit-identical")
    watch8 = rv32_watch(rv32)
    case_d = turbo_cases.rv32_case(128, 8, dev, design=rv32, seed=8)
    same(case_d, "(d) RV32 B=128 T=8 watch", watch=watch8)
    say(6, f"(d) RV32, B=128 each from its own random V/U start words "
        f"(X/Z lanes), 8 ticks, watching phase 8's {len(watch8)} signals: "
        "bit-identical")
    case_e = turbo_cases.all_ops_case(4, 6, seed=7, device=dev)
    for force_global in (False, True):
        same(case_e, f"(e) every gate op global={force_global}", force_global)
    say(6, "(e) fp16's plan with one chunk per gate op (all 14, random "
        "operands), random V/U with X/Z lanes, B=4, 6 ticks, both "
        "placements: bit-identical")
    r = {"max_abs_err": max(errs)}
    plan, st0, FV, FU = case_a
    sc = plan.schedule
    FVp, FUp = plan.pad_forced(FV, FU)
    t = [time_ms(lambda: turbo.run_turbo_plain(plan, st0, FVp, FUp), 1),
         time_ms(lambda: turbo.run_turbo(plan, st0, FV, FU), 10),
         time_ms(lambda: turbo.run_turbo(plan, st0, FV, FU), 10),
         time_ms(lambda: turbo.run_turbo_plain(plan, st0, FVp, FUp), 1)]
    r["ms"] = (t[1] + t[2]) / 2
    r["plain_ms"] = (t[0] + t[3]) / 2
    r["library_ms"] = None          # no PyTorch call computes a gate tick
    r["bound_ms"], r["bound_by"] = turbo_bound(plan, 2, 8, plan.K)
    n_cone, n_full = sc.levels
    widths = [np.diff(off) for off in (sc.cone_off, sc.full_off)]
    rows = sum(int((-(-w // turbo.THREADS)).sum()) for w in widths)
    say(6, f"RV32 schedule: {n_cone} cone + {n_full} full levels per tick "
        f"({plan.n_chunks_per_tick} chunks in the tables; median width "
        f"{np.median(widths[0]):g} / {np.median(widths[1]):g} gates, widest "
        f"{widths[0].max()} / {widths[1].max()}; {rows} rows of "
        f"{turbo.THREADS}), {len(sc.cone_rec) + len(sc.full_rec)} gate "
        f"records + {len(sc.ff_rec)} flip-flop records, built on the host "
        f"in {sc.build_s * 1e3:.1f} ms")
    say(6, f"RV32 B=2 T=8 (K={plan.K}, {4 * turbo.state_words(plan)} B of "
        f"state, {turbo.THREADS} threads a block): kernel {t[1]:.3f} / "
        f"{t[2]:.3f} ms, plain {t[0]:.1f} / {t[3]:.1f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    ticks = 404
    t = turbo_split(dev, rv32, ticks)
    levels = n_cone + n_full
    say(6, f"RV32 B=1 x {ticks} ticks, full history, {turbo.THREADS} threads "
        f"a block: {t['real']:.3f} ms ({t['real'] / ticks * 1e3:.2f} us/tick, "
        f"{t['real'] / ticks / levels * 1e6:.1f} ns/level); with no gate in "
        f"any level {t['empty']:.3f} ms "
        f"({(t['empty'] - t['none']) / ticks / levels * 1e6:.1f} ns/level "
        f"above the fixed part); with no level {t['none']:.3f} ms "
        f"({t['none'] / ticks * 1e3:.2f} us/tick fixed)")
    for line in ptxas_lines("turbo_kernel"):
        say(6, f"ptxas: {line}")
    return r


def ptxas_lines(kernel):
    """ptxas's spill and register lines of each instance of ``kernel``
    from the build's report."""
    out, entry = [], None
    for line in Path(str(_build.library_path()) + ".ptxas.txt").read_text() \
            .splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if kernel in line else None
        elif entry and ("spill" in line or "registers" in line):
            out.append(f"{entry}: {line.strip()}")
    return out


def ladder_run(ir, params, B, steps, device, inv):
    x, _st, ok, tr = analog.transient_batched(
        ir, {k: v.to(device) for k, v in params.items()},
        batch_x(ir, B, device), batch_state(ir, B, device),
        workloads.default_env(), 0.0, workloads.DT, steps, solver="frozen",
        keep_trace=True, inv=inv)
    return x, ok, tr


def frozen_path(phase, dev, smi, inv, launched, idle, results):
    """The analog main path at full width with the refactor ``inv``: the
    255-stage ladder, B = 256, 100 steps, after a 3-step warm-up, every
    kernel's count set to 0 just before and read just after.  Checks
    that every lane converges, x is finite, each kernel of ``launched``
    ran and none of ``idle`` did, and lanes 0-3 agree with a CPU run of
    those lanes; prints each launched kernel's launches x its per-call
    time from phase 2 (``results``).  Returns (x, launches)."""
    B, steps, stages, seed = 256, 100, workloads.N_STAGES, 0
    workloads.frozen_transient(batch=B, steps=3, stages=stages, device=dev,
                               seed=seed, inv=inv)              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS.values():
        k["wrapper"].launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    x, ok = workloads.frozen_transient(batch=B, steps=steps, stages=stages,
                                       device=dev, seed=seed, inv=inv)
    end.record()
    torch.cuda.synchronize()
    launches = {name: k["wrapper"].launches for name, k in KERNELS.items()}
    sec = start.elapsed_time(end) / 1e3
    what = f"frozen path (inv={inv})"
    check(tuple(x.shape) == (B, stages + 1), f"{what}: x shape {tuple(x.shape)}")
    check(bool(ok.all()), f"{what}: {int((~ok).sum())} lanes failed")
    check(bool(torch.isfinite(x).all()), f"{what}: non-finite x")
    for name in launched:
        check(launches[name] > 0, f"{what} never launched {name}")
    for name in idle:
        check(launches[name] == 0, f"{what} launched {name} "
              f"{launches[name]} times")
    # reference: lanes 0-3 alone through the CPU path
    ir = workloads.build_diode_ladder(stages)
    p_all = batch_params(ir, B, jitter={"R": {"r": workloads.R_JITTER}},
                         generator=torch.Generator().manual_seed(seed))
    p4 = {k: v[:4].clone() for k, v in p_all.items()}
    x4, ok4, _tr = ladder_run(ir, p4, 4, steps, "cpu", inv)
    rel = float((x[:4].cpu() - x4).abs().max() / x4.abs().max())
    check(bool(ok4.all()) and rel <= TRACE_TOL,
          f"{what}: lanes 0-3 vs CPU run {rel:.3e} > {TRACE_TOL}")
    say(phase, f"{stages}-stage ladder B={B} {steps} steps, inv={inv}: "
        f"{sec:.3f} s, {B * steps / sec:.1f} circuit-steps/s on {smi}; "
        f"launches {launches}; lanes 0-3 vs CPU {rel:.3e}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    say(phase, "launches x phase 2's per-call time at (256, 256): " + ", ".join(
        f"{name} {launches[name]} x {results[name]['ms']:.4f} ms = "
        f"{launches[name] * results[name]['ms'] / 1e3:.4f} s"
        for name in KERNELS if launches[name]) + f" of the {sec:.3f} s wall")
    return x, launches


def phase10_past_1024(dev, smi):
    """workloads.frozen_transient at 1152 unknowns, B = 16, 10 steps, with
    each refactor: every lane converges, both final x agree to 1e-6."""
    stages, B, steps = 1151, 16, 10
    xs = {}
    for inv, refactor in (("gj", "gj_inverse32"),
                          ("block", "lu_block_inverse32")):
        workloads.frozen_transient(batch=B, steps=1, stages=stages,
                                   device=dev, inv=inv)          # warm-up
        torch.cuda.synchronize()
        for k in KERNELS.values():
            k["wrapper"].launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        x, ok = workloads.frozen_transient(batch=B, steps=steps,
                                           stages=stages, device=dev, inv=inv)
        end.record()
        torch.cuda.synchronize()
        sec = start.elapsed_time(end) / 1e3
        what = f"{stages}-stage ladder (inv={inv})"
        check(tuple(x.shape) == (B, stages + 1),
              f"{what}: x shape {tuple(x.shape)}")
        check(bool(ok.all()), f"{what}: {int((~ok).sum())} lanes failed")
        check(bool(torch.isfinite(x).all()), f"{what}: non-finite x")
        n_ref = KERNELS[refactor]["wrapper"].launches
        n_burst = gj.gj_solve32.launches
        check(n_ref > 0, f"{what} never launched {refactor}")
        say(10, f"{stages}-stage ladder ({stages + 1} unknowns) B={B} "
            f"{steps} steps, inv={inv}: {sec:.3f} s, "
            f"{B * steps / sec:.1f} circuit-steps/s on {smi}; refactors "
            f"{n_ref} ({refactor}), bursts {n_burst} (gj_solve32)")
        xs[inv] = x
    rel = float((xs["block"] - xs["gj"]).abs().max() / xs["gj"].abs().max())
    check(rel <= TRACE_TOL, f"1152 unknowns: inv=block vs inv=gj final x "
          f"{rel:.3e} > {TRACE_TOL}")
    say(10, f"final x, inv=block vs inv=gj: rel err {rel:.3e}")


class Counted:
    """Swaps ``owner.name`` for a wrapper that times each call with CUDA
    events (``timed=True``) or only counts it, and restores it on exit.
    ``record(out, args, kwargs)`` sees each call's result."""

    def __init__(self, owner, name, timed=False, record=None):
        self.owner, self.name = owner, name
        self.timed, self.record = timed, record
        self.orig = getattr(owner, name)
        self.calls, self.events = 0, []

    def __enter__(self):
        def call(*args, **kwargs):
            self.calls += 1
            if self.timed:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = self.orig(*args, **kwargs)
            if self.timed:
                ev[1].record()
                self.events.append(ev)
            if self.record is not None:
                self.record(out, args, kwargs)
            return out
        object.__setattr__(self.owner, self.name, call)
        return self

    def __exit__(self, *exc):
        object.__setattr__(self.owner, self.name, self.orig)

    def seconds(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3

    def take(self):
        """(calls, mean ms a call) since the last take."""
        torch.cuda.synchronize()
        n = len(self.events)
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        self.events = []
        return n, (ms / n if n else 0.0)


def gauss_calls():
    """Counts and times ``ops/linsolve.py::lu_solve_gauss`` (the dense f64
    solve of the Circuit driver, reached through ``dense_solve`` and
    ``GaussSolve``): CUDA events around each call, read by ``take``."""
    return Counted(linsolve, "lu_solve_gauss", timed=True)


def timed(fn):
    """(fn's result, wall s by CUDA events after a synchronize)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / 1e3


def phase11_circuit(dev, smi, stages=workloads.N_STAGES, lanes=256,
                    steps=100, temps=256, n_check=10):
    """The analog Circuit driver on the diode ladder (see the module
    docstring, phase 11).  Returns, for phase 22, the OP, the first 20 TR
    steps and the temperature sweep (grid, x, ok)."""
    dt = workloads.DT
    n = stages + 1
    c = Circuit(workloads.diode_ladder_netlist(stages), device=dev)
    ref = Circuit(workloads.diode_ladder_netlist(stages), device="cpu")
    env = c._env_scalars()

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        return torch.as_tensor(tree).cpu()

    def held(what, card, host):
        rel = float(np.abs(card - host).max()
                    / (np.abs(host).max() or 1.0))     # all-zero: absolute
        check(rel <= TRACE_TOL,
              f"{what}: card vs CPU {rel:.3e} > {TRACE_TOL}")
        return rel

    with gauss_calls() as gauss:
        def report(what, sec, extra=""):
            calls, ms = gauss.take()
            say(11, f"{what}: wall {sec:.3f} s on {smi}; lu_solve_gauss "
                f"{calls} calls, {ms:.3f} ms a call ({calls * ms / 1e3:.3f}"
                f" s){extra}")

        # (a) one circuit: OP, TR, ACOP
        c.set_analyze_type(AnalyzeType.OP)
        ok, sec = timed(c.analyze)
        check(ok, "Circuit OP failed")
        x_op = c._x.cpu().numpy()
        report(f"(a) OP, {n} unknowns", sec)
        c.tr.t_step, c.tr.t_stop = dt, steps * dt
        c.set_analyze_type(AnalyzeType.TR)
        ok, sec = timed(c.analyze)
        check(ok and c.tr_history.shape == (steps, n)
              and np.isfinite(c.tr_history).all(), f"Circuit TR: ok {ok}")
        out = dict(x_op=x_op, tr=c.tr_history[:20].copy())
        report(f"(a) TR, {steps} steps of {dt:g} s", sec,
               f", {steps / sec:.1f} circuit-steps/s")
        ref.set_analyze_type(AnalyzeType.OP)
        check(ref.analyze(), "CPU Circuit OP failed")
        ref_op = ref._x.numpy()
        ref.tr.t_step, ref.tr.t_stop = dt, n_check * dt
        ref.set_analyze_type(AnalyzeType.TR)
        check(ref.analyze(), "CPU Circuit TR failed")
        gauss.take()
        rel_a = held("(a) OP and TR",
                     np.vstack([x_op, c.tr_history[:n_check]]),
                     np.vstack([ref_op, ref.tr_history]))
        c.ac.sweep = ACSweepType.LOG
        c.ac.omega_start, c.ac.omega_stop = 2 * np.pi * 1e3, 2 * np.pi * 1e9
        c.ac.points = 101
        c.set_analyze_type(AnalyzeType.ACOP)
        ok, sec = timed(c.analyze)
        xs = np.stack([x for _w, x in c.ac_sweep_results])
        check(ok and xs.shape == (101, n) and np.isfinite(xs).all(),
              f"Circuit ACOP: ok {ok}")
        report(f"(a) ACOP, {len(xs)} points, a {2 * n} x {2 * n} real "
               "system each", sec)
        pick = [0, 50, 100]
        w = torch.tensor([c.ac_sweep_results[k][0] for k in pick],
                         dtype=torch.float64)
        re, im = analog.ac_sweep(c._ir, cpu(c._params()), cpu(c._states), w)
        gauss.take()
        rel_ac = held("(a) AC points 0, 50, 100", xs[pick],
                      re.numpy() + 1j * im.numpy())
        say(11, f"(a) card vs CPU: OP and TR steps 1-{n_check} {rel_a:.3e}, "
            f"AC points 0, 50, 100 {rel_ac:.3e}")

        # (b) Monte-Carlo transient: one lane a circuit
        mc = dict(jitter={"R": {"r": workloads.R_JITTER}}, n=lanes,
                  generator=torch.Generator().manual_seed(0), analysis="tr",
                  t_stop=steps * dt, t_step=dt)
        res, sec = timed(lambda: c.monte_carlo(**mc))
        check(res.history.shape == (lanes, steps, n)
              and np.isfinite(res.history).all(), "MC TR: non-finite trace")
        check(bool(res.ok.all()), f"MC TR: {int((~res.ok).sum())} of "
              f"{lanes} lanes failed")
        report(f"(b) monte_carlo TR, {lanes} lanes x {steps} steps", sec,
               f", {lanes * steps / sec:.1f} circuit-steps/s")
        ir = ref.prepare()
        p4 = {k: torch.as_tensor(v[:4]) for k, v in res.params.items()}
        _x, _st, ok4, xs4 = batched_transient(
            ir, p4, batch_x(ir, 4, "cpu"), batch_state(ir, 4, "cpu"), env,
            0.0, dt, n_check, keep_trace=True)
        gauss.take()
        check(bool(ok4.all()), "MC TR: a CPU lane failed")
        rel_b = held("(b) lanes 0-3", res.history[:4, :n_check], xs4.numpy())

        # (c) temperature sweep: one OP a lane
        t_grid = np.linspace(-40.0, 125.0, temps)
        res, sec = timed(lambda: c.temp_sweep(t_grid))
        check(bool(res.ok.all()) and np.isfinite(res.x).all(),
              f"temp_sweep: {int((~res.ok).sum())} of {temps} lanes failed")
        out.update(temps=t_grid, temp_x=res.x, temp_ok=res.ok)
        report(f"(c) temp_sweep, {temps} temperatures", sec)
        p4 = {k: torch.as_tensor(v[:4]) for k, v in res.params.items()}
        x4, _st, ok4 = batched_op(ir, p4, batch_x(ir, 4, "cpu"),
                                  batch_state(ir, 4, "cpu"), env)
        gauss.take()
        check(bool(ok4.all()), "temp_sweep: a CPU lane failed")
        rel_c = held("(c) lanes 0-3", res.x[:4], x4.numpy())
    say(11, f"card vs CPU: (b) lanes 0-3 steps 1-{n_check} {rel_b:.3e}, "
        f"(c) lanes 0-3 {rel_c:.3e}")
    return out


def _jac_vmap(f, v):
    """torch.func.jacfwd's scheme over a whole family: torch.func.vmap over
    the k unit tangents of one torch.func.jvp; J (..., r, c) as
    ``models/dual.py::jacobian`` returns it."""
    k = v.shape[-1]
    eye = torch.eye(k, dtype=v.dtype, device=v.device)
    basis = eye.reshape((k,) + (1,) * (v.dim() - 1) + (k,)) \
        .expand((k,) + v.shape)
    out, jt = torch.func.vmap(lambda t: torch.func.jvp(f, (v,), (t,)),
                              out_dims=(None, 0))(basis)
    return out, jt.movedim(0, -1)


def _jac_jvps(f, v):
    """One torch.func.jvp per input, each with one unit tangent."""
    cols = []
    for c in range(v.shape[-1]):
        t = torch.zeros_like(v)
        t[..., c] = 1.0
        out, jt = torch.func.jvp(f, (v,), (t,))
        cols.append(jt)
    return out, torch.stack(cols, dim=-1)


def jacobian_routes(dev, smi, ir, x, lanes, reps=5):
    """The BSIM3_NMOS stamp (TR mode) at the main path's shape, at the
    bias ``x`` (lanes, n), with ``models/bsim3.py``'s Jacobian taken by
    dual.jacobian, by torch.func.vmap(jvp) and by one torch.func.jvp a
    terminal: ms a call (CUDA events, after a warm-up) and the largest
    difference from dual's stamp relative to its max|entry|."""
    from phy_engine_tpu_torch.models import bsim3, dual
    from phy_engine_tpu_torch.models.base import StampCtx
    fam = next(f for f in ir.families if f.mdef.id_name == "BSIM3_NMOS")
    params = workloads.bsim3_params(ir, lanes, dev)
    x_ext = analog._ext(x)
    st = batch_state(ir, lanes, dev)
    ctx = StampCtx(mode="tr", t=0.0, dt=workloads.BSIM3_DT,
                   env=workloads.default_env())
    out, ms = {}, {}
    try:
        for name, jac in (("dual", dual.jacobian), ("vmap_jvp", _jac_vmap),
                          ("jvp_each", _jac_jvps)):
            bsim3._jac = jac
            call = lambda: analog._stamp_family(ir, fam, params, x_ext, st,
                                                ctx)
            ms[name] = time_ms(call, reps)
            out[name] = call()[:2]
    finally:
        bsim3._jac = dual.jacobian
    err = {}
    for name in ("vmap_jvp", "jvp_each"):
        err[name] = max(float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(out[name], out["dual"]))
        check(err[name] <= 1e-12, f"BSIM3 stamp by {name} differs from "
              f"dual.jacobian's: {err[name]:.3e}")
    n_inst = params["BSIM3_NMOS"].shape[1]
    say(12, f"BSIM3_NMOS stamp at ({lanes}, {n_inst}) by its Jacobian route "
        f"on {smi}: dual.jacobian {ms['dual']:.3f} ms, torch.func.vmap(jvp) "
        f"{ms['vmap_jvp']:.3f} ms ({err['vmap_jvp']:.1e} from dual's), one "
        f"torch.func.jvp a terminal {ms['jvp_each']:.3f} ms "
        f"({err['jvp_each']:.1e})")


def phase12_bsim3(dev, smi, results, steps=100, lanes=256, n_check=10):
    """The BSIM3 inverter chain (see the module docstring, phase 12).
    Returns the GJ pair's launches in the timed transient."""
    from phy_engine_tpu_torch.models import MODEL_REGISTRY
    stages = workloads.BSIM3_STAGES
    ir = workloads.build_bsim3_ir(stages)
    n, nn = ir.n_unknowns, ir.n_nodes
    npad = analog._npad(n)
    start, seed_s = timed(lambda: workloads.bsim3_seed(ir, dev))
    say(12, f"{stages}-stage BSIM3 chain ({2 * stages} BSIM3 devices a lane, "
        f"{n} unknowns, padded to {npad}): TROP seed, "
        f"{len(workloads.BSIM3_GMIN_LADDER)} gmin rungs 1e-2 .. 1e-12 of the "
        f"per-lane dense f64 Newton at the nominal point, converged: wall "
        f"{seed_s:.3f} s on {smi}")
    fams = [MODEL_REGISTRY[k] for k in ("BSIM3_NMOS", "BSIM3_PMOS")]
    hooks = [Counted(m, h, timed=True) for m in fams
             for h in ("stamp", "step_update")]
    rescued = []

    def took(out, args, kwargs):
        rescued.append(int(out[2].sum()))

    frozen = Counted(analog, "_frozen_resid_cached")
    rescue = Counted(analog, "newton_solve_batched", record=took)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS.values():
        k["wrapper"].launches = 0
    with frozen, rescue, hooks[0], hooks[1], hooks[2], hooks[3]:
        xs, sec = timed(lambda: workloads.bsim3_transient(
            batch=lanes, steps=steps, device=dev, start=start))
    launches = {name: KERNELS[name]["wrapper"].launches
                for name in ("gj_inverse32", "gj_solve32")}
    peak = torch.cuda.max_memory_allocated() / 2**20
    check(tuple(xs.shape) == (steps, lanes, n), f"BSIM3 chain xs shape "
          f"{tuple(xs.shape)}")
    check(bool(torch.isfinite(xs).all()), "BSIM3 chain: non-finite x")
    for name, count in launches.items():
        check(count > 0, f"BSIM3 chain never launched {name}")
    check(KERNELS["lu_block_inverse32"]["wrapper"].launches == 0,
          "BSIM3 chain launched lu_block_inverse32")
    b3 = sum(h.seconds() for h in hooks)
    iters = frozen.calls
    say(12, f"frozen transient B={lanes} x {steps} steps of "
        f"{workloads.BSIM3_DT:g} s, max_iter 256: every lane converged; wall "
        f"{sec:.3f} s, {lanes * steps / sec:.1f} circuit-steps/s on {smi}; "
        f"{iters} frozen iterations ({iters / steps:.1f} a step); refactors "
        f"{launches['gj_inverse32']} (gj_inverse32), bursts "
        f"{launches['gj_solve32']} (gj_solve32) at (B, n) = ({lanes}, "
        f"{npad}): {launches['gj_inverse32'] / iters:.3f} + "
        f"{launches['gj_solve32'] / iters:.3f} launches a frozen iteration; "
        f"peak device memory {peak:.0f} MiB")
    say(12, f"rescue ladder (newton_solve_batched 'hybrid'): ran on "
        f"{rescue.calls} of {steps} steps, lanes it left unconverged "
        f"{sum(lanes - r for r in rescued) if rescued else 0}; BSIM3 stamp "
        f"+ step update {b3:.3f} s = {100 * b3 / sec:.1f} % of the wall "
        f"({hooks[0].calls + hooks[2].calls} stamp, "
        f"{hooks[1].calls + hooks[3].calls} step-update calls) on {smi}")
    say(12, "launches x phase 2's per-call time at (256, 128): " + ", ".join(
        f"{name} {launches[name]} x {results[name + AT128]['ms']:.4f} ms = "
        f"{launches[name] * results[name + AT128]['ms'] / 1e3:.4f} s"
        for name in launches) + f" of the {sec:.3f} s wall")

    # lanes 0-3 on the CPU: the same frozen path over the same 256 lanes
    # (its refactor decisions span the batch, so fewer lanes would be
    # another computation), and the bench's per-lane dense f64 reference
    # (bench_bsim3.py:288-305), over the first steps
    p_cpu = workloads.bsim3_params(ir, lanes, "cpu")
    start_cpu = (start[0].cpu(), {k: {v: a.cpu() for v, a in d.items()}
                                  for k, d in start[1].items()})
    (xs_c, ok_c), cpu_s = timed(lambda: workloads.bsim3_run(
        ir, p_cpu, start_cpu, n_check))
    check(bool(ok_c.all()), "BSIM3 chain: a CPU lane failed")
    card = xs[:n_check].cpu()
    rel = float((card[:, :4] - xs_c[:, :4]).abs().max()
                / xs_c[:, :4].abs().max())
    rel_all = float((card - xs_c).abs().max() / xs_c.abs().max())
    check(rel <= TRACE_TOL, f"BSIM3 chain lanes 0-3 vs CPU frozen {rel:.3e} "
          f"> {TRACE_TOL}")
    p4 = {k: v[:4].clone() for k, v in p_cpu.items()}
    x_b = start_cpu[0].expand(4, -1).clone()
    st_b = {k: {v: a.expand((4,) + a.shape[1:]).clone() for v, a in d.items()}
            for k, d in start_cpu[1].items()}
    (_x, _st, okd, xsd), ref_s = timed(lambda: analog.transient(
        ir, p4, x_b, st_b, workloads.default_env(), 0.0, workloads.BSIM3_DT,
        n_check))
    check(bool(okd.all()), "BSIM3 chain: a dense f64 CPU lane failed")
    ref = xsd.transpose(0, 1)[:, :, :nn].numpy()
    acc = card[:, :4, :nn].numpy()
    floor = 1e-6
    rel_b = float((np.abs(acc - ref) / (np.abs(ref) + floor)).max())
    say(12, f"lanes 0-3, steps 1-{n_check}: vs a CPU run of the frozen path "
        f"on the same {lanes} lanes {rel:.3e} (<= {TRACE_TOL}; all {lanes} "
        f"lanes {rel_all:.3e}; {cpu_s:.1f} s); bench record "
        f"(bench_bsim3.py:288-305) vs the per-lane dense f64 transient on the "
        f"CPU, per-sample relative error with a {floor:g} V floor: "
        f"{rel_b:.3e}, quality_gate_1e6 {rel_b <= 1e-6} ({ref_s:.1f} s); "
        f"card {smi}")
    jacobian_routes(dev, smi, ir, xs[-1], lanes)

    # the Circuit path on the same chain, card against CPU, with the
    # seed's last g_min (1e-12) as the environment's: at g_min = 0 the OP
    # of 31 stages whose input sits at the switching point does not hold
    # (Newton from a converged point drifts off).  From x = 0 the gmin
    # ladder converges on every rung but its end point fails the driver's
    # row-wise residual check (rel ~3.5e-5 > 1e-6 on a stage output at
    # ~2e-12 V, whose row scale is ~5e-14 A), as the JAX package's Circuit
    # does on this chain; so the analyses then start from the TROP seed,
    # written into the netlist's node voltages and branch currents (the
    # Circuit's warm start), where the OP converges by plain Newton.  The
    # output is stage 1's, next to the 1.5 V switching point (AC gain ~1e3
    # at 1 kHz): from stage 2 on the outputs sit at the rails, where the AC
    # magnitude and every sens_ac gradient are 0.
    out = {}
    x_seed = start[0][0].cpu().numpy()
    with gauss_calls() as gauss:
        for where in (dev, "cpu"):
            c = Circuit(workloads.bsim3_chain_netlist(stages),
                        env=Environment(g_min=workloads.BSIM3_GMIN_LADDER[-1]),
                        device=where)
            node = c.nl.nodes[3]          # vdd, bias, in, stage 1
            c.ac.sweep = ACSweepType.LOG
            c.ac.omega_start, c.ac.omega_stop = 2 * np.pi * 1e3, \
                2 * np.pi * 1e9
            r = {}
            c.set_analyze_type(AnalyzeType.OP)
            if where == dev:
                cold, cold_s = timed(c.analyze)
                calls, ms = gauss.take()
                say(12, f"Circuit OP from x = 0 (gmin stepping): ok {cold}, "
                    f"wall {cold_s:.3f} s on {smi}; lu_solve_gauss {calls} "
                    f"calls, {ms:.3f} ms a call")
            ir_c = c.prepare()
            for i, nd in enumerate(ir_c.node_list):
                nd.voltage = complex(x_seed[i])
            for fam in ir_c.families:
                for inst in fam.instances:
                    for br in inst.branches:
                        br.current = complex(x_seed[br.index])
            c.prepare(force=True)
            r["op"], r["op_s"] = timed(c.analyze)
            check(r["op"], f"BSIM3 chain Circuit OP from the seed failed on "
                  f"{where}")
            r["x"] = c._x.cpu().numpy()
            r["op_calls"] = gauss.take()
            c.ac.points = 101
            r["noise"], r["noise_s"] = timed(lambda: c.noise(node))
            r["noise_calls"] = gauss.take()
            r["sens"], r["sens_s"] = timed(lambda: c.sens(node))
            r["sens_calls"] = gauss.take()
            c.ac.points = 21
            r["sens_ac"], r["sens_ac_s"] = timed(lambda: c.sens_ac(node))
            r["sens_ac_calls"] = gauss.take()
            out[where] = r
    g, h = out[dev], out["cpu"]

    def held(what, a, b, scale=None):
        """Card ``a`` against CPU ``b`` relative to max|b|; a family whose
        gradients are all 0 on the CPU (a capacitor at DC) is held
        against the whole analysis's ``scale``.  A comparison with no
        nonzero reference fails: zeros against zeros prove nothing."""
        a, b = np.asarray(a), np.asarray(b)
        s_ = float(np.abs(b).max()) or (scale or 0.0)
        check(s_ > 0.0, f"BSIM3 Circuit {what}: the CPU reference is all 0")
        e = float(np.abs(a - b).max() / s_)
        check(np.isfinite(a).all() and e <= TRACE_TOL,
              f"BSIM3 Circuit {what}: card vs CPU {e:.3e} > {TRACE_TOL}")
        return e

    def held_grads(what, card, host):
        scale = max(float(np.abs(v).max()) for v in host.values())
        check(scale > 0.0, f"BSIM3 Circuit {what}: every gradient is 0")
        return max(held(f"{what} {k}", card[k], v, scale)
                   for k, v in host.items())

    errs = {"op": held("OP", g["x"], h["x"]),
            "noise": max(held("onoise", g["noise"].onoise_psd,
                              h["noise"].onoise_psd),
                         *(held(f"noise {k}", g["noise"].contribs[k], v)
                           for k, v in h["noise"].contribs.items())),
            "sens": held_grads("sens", g["sens"].grads, h["sens"].grads),
            "sens_ac": max(held("sens_ac |V|", g["sens_ac"][1],
                                h["sens_ac"][1]),
                           held_grads("sens_ac", g["sens_ac"][2].grads,
                                      h["sens_ac"][2].grads))}
    for what, key in (("OP from the TROP seed", "op"),
                      ("noise at stage 1's output, 101 points 1 kHz "
                       "- 1 GHz", "noise"),
                      ("sens of that node at the OP", "sens"),
                      ("sens_ac of that node, 21 points", "sens_ac")):
        calls, ms = g[f"{key}_calls"]
        say(12, f"Circuit {what}: wall "
            f"{g[f'{key}_s']:.3f} s on {smi} (CPU {h[f'{key}_s']:.3f} s); "
            f"lu_solve_gauss {calls} calls, {ms:.3f} ms a call; card vs CPU "
            f"{errs[key]:.3e}")
    return launches


def device_ops(fn):
    """(device operations, device ms) of one call of ``fn``: the kernels
    and copies that torch.profiler traces on the card (0 and 0.0 when the
    trace holds no device time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n, us = 0, 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0)
        if t:
            n += ev.count
            us += t
    return n, us / 1e3


def cases_card_vs_cpu(phase, dev, names, what):
    """Each case of tests/torch_digital_cases on the card and on the CPU:
    planes and node codes bit-identical, voltages to its VTOL."""
    import torch_digital_cases as dc
    t0 = time.perf_counter()
    for name in names:
        card = dc.run_case(tpe, name, lambda: Circuit(device=dev))
        host = dc.run_case(tpe, name, lambda: Circuit(device="cpu"))
        try:
            dc.assert_same(card, host)
        except AssertionError as e:
            raise RuntimeError(f"chip_smoke failed: {what} case {name}: card "
                               f"vs CPU: {e}") from None
    say(phase, f"{what}: {len(names)} cases ({', '.join(names)}) on the "
        f"card and on the CPU: planes and node codes bit-identical, node "
        f"voltages within {dc.VTOL:g}; {time.perf_counter() - t0:.1f} s")
    return dc


def phase13_levels(dev, smi, rv32, cycles=10):
    """The levelled tick (see the module docstring, phase 13)."""
    import torch_digital_cases as dc
    cases_card_vs_cpu(13, dev, list(dc.CASES), "tests/test_torch_levels.py")
    eng = rv32.circuit.digital_engine()
    t0 = time.perf_counter()
    eng.reset_state()
    _ = eng.tick_fn
    build_s = time.perf_counter() - t0
    reset, body = workloads.rv32_schedules(rv32, cycles)
    _e, fs, FV, FU = rv32.circuit._compile_schedule(reset + body)
    eng.run_levels(fs, FV[None, :2], FU[None, :2])            # warm-up
    turbo.run_turbo.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (fs, FV, FU), (hv, hu) = workloads.rv32_levels(rv32, cycles)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    T = len(FV)
    check(turbo.run_turbo.launches == 0, "the levelled RV32 run launched the "
          "turbo kernel")
    # the oracle: the turbo kernel's full history of the same schedule
    eng.reset_state()
    plan = eng.plan(fs)
    tv, tu = turbo.run_turbo(plan, eng._state0(plan, 1),
                             turbo.as_int32(FV)[None].to(dev),
                             turbo.as_int32(FU)[None].to(dev))
    n_turbo = turbo.run_turbo.launches
    check(n_turbo > 0, "phase 13's oracle never launched the turbo kernel")
    v, u = plan.unpack_hist(tv[0], tu[0])
    lv = hv.cpu().numpy().view(np.uint32)
    lu = hu.cpu().numpy().view(np.uint32)
    check(np.array_equal(lv, v[:, :plan.S]) and np.array_equal(lu, u[:, :plan.S]),
          "levelled RV32 history != the turbo kernel's")
    eng.reset_state()
    ops, dev_ms = device_ops(lambda: eng.run_levels(fs, FV[None, :1],
                                                    FU[None, :1]))
    pre, full = eng.tick_fn.levels_count()
    say(13, f"RV32 -O1 ({rv32.gates} gates + FFs) through the levelled tick, "
        f"{T} ticks from power-up: every plane of every tick bit-identical to "
        f"the turbo kernel's history (turbo launches {n_turbo}); "
        f"{pre} + {full} levels a tick, tick built in {build_s:.2f} s on the "
        f"host")
    say(13, f"levelled tick: wall {sec * 1e3:.1f} ms for {T} ticks "
        f"({sec * 1e3 / T:.2f} ms a tick, {rv32.gates * T / sec:.4e} "
        f"gate-evals/s) on {smi}; {ops} device operations a tick, "
        f"{dev_ms:.3f} ms of device time a tick (torch.profiler over the "
        f"first tick)")


def sar_conversions(volts, where):
    """The 16-bit SAR on ``where`` through one conversion per voltage:
    (wall s, {"analyze": s, "digital_clk": s}, codes, lu_solve_gauss
    calls)."""
    if str(where) == "cpu":
        torch.set_num_threads(1)        # n = 50: one thread is fastest
    adc = workloads.sar_adc(16, where)
    spent = {"analyze": 0.0, "digital_clk": 0.0}
    c = adc.circuit
    for name in spent:
        def timed(f=getattr(c, name), name=name):
            t0 = time.perf_counter()
            out = f()
            spent[name] += time.perf_counter() - t0
            return out
        setattr(c, name, timed)
    with Counted(linsolve, "lu_solve_gauss") as gauss:
        t0 = time.perf_counter()
        codes = [workloads.sar_convert(adc, float(v))[0] for v in volts]
        if str(where) != "cpu":
            torch.cuda.synchronize()
        return time.perf_counter() - t0, spent, codes, gauss.calls


def phase14_mixed(dev, smi, n16=16, seed=14):
    """Mixed signal (see the module docstring, phase 14)."""
    lsb8 = workloads.SAR_VREF / 256
    card, host = workloads.sar_adc(8, dev), workloads.sar_adc(8, "cpu")
    ties = []
    for v_in in (0.7, 1.23, 2.5, 3.9, 4.97, -0.5, 5.5):
        (kc, kv), (hc, hv) = (workloads.sar_convert(card, v_in),
                              workloads.sar_convert(host, v_in))
        ideal = min(max(v_in, 0.0), workloads.SAR_VREF - lsb8) / lsb8
        check(abs(kc - ideal) <= 1.0 + 1e-9 and abs(hc - ideal) <= 1.0 + 1e-9,
              f"SAR8 at {v_in} V: codes {kc} / {hc}, ideal {ideal:.3f}")
        if kc != hc:
            # a comparator tie: the trial DAC voltage equals v_in
            check(float(v_in / lsb8).is_integer(), f"SAR8 at {v_in} V: card "
                  f"code {kc} != CPU code {hc}")
            ties.append((v_in, kc, hc))
            continue
        check(abs(kv - hv) <= 1e-6 * max(abs(hv), lsb8),
              f"SAR8 at {v_in} V: DAC {kv} vs {hv}")
    say(14, "SAR8 at tests/test_adc.py's 5 voltages and 2 rails: card codes "
        "equal the CPU's, DAC voltages within 1e-6, every code within 1 LSB"
        + ("" if not ties else "; comparator ties held by the 1-LSB rule: "
           + ", ".join(f"{v} V card {a} CPU {b}" for v, a, b in ties)))
    volts = np.random.default_rng(seed).uniform(-0.1, 5.1, n16)
    lsb = workloads.SAR_VREF / 2 ** 16
    # the CPU run in a process of its own, beside the card's
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as pool:
        cpu_run = pool.submit(sar_conversions, volts, "cpu")
        sec, spent, codes, gauss = sar_conversions(volts, dev)
        cpu_sec, _spent, cpu_codes, _gauss = cpu_run.result()
    check(codes == cpu_codes, "SAR16: card codes != CPU codes at "
          + ", ".join(f"{v:.6f} V" for v, a, b in zip(volts, codes, cpu_codes)
                      if a != b))
    ideal = np.clip(volts, 0.0, workloads.SAR_VREF - lsb) / lsb
    err = np.abs(np.asarray(codes) - ideal).max()
    check(err <= 1.0 + 1e-9, f"SAR16 code off ideal by {err:.3f} LSB")
    say(14, f"SAR16 (LSB {lsb * 1e6:.2f} uV), {n16} conversions at seeded "
        f"voltages in (-0.1, 5.1) V: codes equal the CPU run's, max "
        f"|code - ideal| {err:.3f} LSB; card wall {sec:.2f} s "
        f"({n16 / sec:.2f} conversions/s on {smi}): analyze() "
        f"{spent['analyze']:.2f} s, digital_clk() {spent['digital_clk']:.2f} "
        f"s, lu_solve_gauss calls {gauss}; CPU wall {cpu_sec:.2f} s (another "
        f"process, at the same time)")
    import torch_digital_cases as dc
    cases_card_vs_cpu(14, dev, [n for n in dc.MIXED if n.startswith("unst")],
                      "Tsu/Th RC gate through TR (tests/test_unsteady.py)")
    cases_card_vs_cpu(14, dev, ["vmod_counter", "vmod_drives_analog"],
                      "VERILOG_MODULE (tests/test_verilog_module.py)")
    rec = dc.run_case(tpe, "vmod_counter", lambda: Circuit(device=dev))
    lsbs = [x[1][0] for x in rec.items if x[0] == "codes"][2::2]
    check(lsbs == [1, 0, 1, 0], f"VERILOG_MODULE counter LSBs {lsbs}")


def phase15_flash(dev, smi, rv32, B=128, ticks=100):
    """The flash engine (see the module docstring, phase 15)."""
    from phy_engine_tpu_torch.digital import flash
    eng = rv32.circuit.digital_engine()
    eng.reset_state()
    reset, body = workloads.rv32_schedules(rv32, (ticks - 4) // 2)
    _e, fs, FV, FU = rv32.circuit._compile_schedule(reset + body)
    watch = rv32_watch(rv32)
    t0 = time.perf_counter()
    plan = flash.FlashPlan(eng.ir, fs)
    build_s = time.perf_counter() - t0
    FVb = np.repeat(FV[None], B, axis=0)
    FUb = np.repeat(FU[None], B, axis=0)
    turbo.run_turbo.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fv, fu = flash.run_batched(plan, eng.sv, eng.su, eng.seq_state, FVb, FUb,
                               watch, device=dev)
    sec = time.perf_counter() - t0
    check(turbo.run_turbo.launches == 0, "flash launched the turbo kernel")
    tplan = eng.plan(fs)
    hv, hu = turbo.run_turbo(tplan, eng._state0(tplan, B),
                             turbo.as_int32(FVb).to(dev),
                             turbo.as_int32(FUb).to(dev), watch=watch)
    tv, tu = tplan.unpack_hist(hv, hu)
    check(np.array_equal(fv, tv) and np.array_equal(fu, tu),
          "flash RV32 watched history != the turbo kernel's")
    check(bool((fv == fv[:1]).all()) and bool((fu == fu[:1]).all()),
          f"flash RV32: the {B} instances' watched histories differ")
    say(15, f"flash RV32 B={B} x {ticks} ticks from power-up, watching phase "
        f"8's {len(watch)} signals: bit-identical to the turbo kernel's "
        f"watched history, every instance's alike; plan "
        f"{plan.K} slots, {len(plan.cone_passes)} + {len(plan.full_passes)} "
        f"passes a tick, built in {build_s:.2f} s; wall {sec:.2f} s "
        f"({sec / ticks * 1e3:.1f} ms a tick), {rv32.gates * B * ticks / sec:.4e} "
        f"gate-evals/s on {smi}")
    import torch_digital_cases as dc
    rec = dc.Rec(lambda: Circuit(device=dev))
    c, ins, pn = dc._synth(tpe, rec, dc.LATCH_SRC, "lat", ("en", "d", "s"))
    names = {n: ins[n][0] for n in ("en", "d", "s")}
    comp = [c._compile_schedule([{names[n]: v for n, v in e.items()} for e in
                                 dc.random_codes(np.random.default_rng(s),
                                                 list(names), 16, lanes=True)])
            for s in range(B)]
    leng, lfs = comp[0][0], comp[0][1]
    LFV = np.stack([x[2] for x in comp])
    LFU = np.stack([x[3] for x in comp])
    check(bool(leng.ir.cyclic) and turbo.eligible(leng.ir, allow_cyclic=True),
          "the latch design is not in flash's cyclic class")
    lwatch = [leng.ir.node_sig[id(n)] for n in pn["q"] + pn["y"]]
    t0 = time.perf_counter()
    av, au = leng.run_ticks_batched(lfs, LFV, LFU, watch=lwatch)     # flash
    f_sec = time.perf_counter() - t0
    t0 = time.perf_counter()
    bv, bu, _last = leng.run_levels(lfs, LFV, LFU, None, lwatch)
    bv, bu = bv.cpu().numpy().view(np.uint32), bu.cpu().numpy().view(np.uint32)
    l_sec = time.perf_counter() - t0
    check(np.array_equal(av, bv) and np.array_equal(au, bu),
          "flash != the levelled tick on the latch-feedback design")
    say(15, f"latch feedback (incomplete always @*, the cyclic class), "
        f"B={B} x 16 ticks of random per-lane stimulus: flash bit-identical "
        f"to the batched levelled tick; flash {f_sec * 1e3:.1f} ms, levelled "
        f"tick {l_sec * 1e3:.1f} ms")


# ---------------------------------------------------------------------------
# synthesis at -O2 and above, the host sweep engine (phase 20)
# ---------------------------------------------------------------------------

def fp16_outputs(dev, syn, words):
    """One tick of the synthesized fp16 adder through the turbo kernel,
    B = len(words) instances of 32 lanes: ``words[i][port][bit]`` is the
    lane word of that input bit.  Returns (v, u) of the ``y`` bits,
    (B, 16) uint32, and the kernel's launches."""
    c = syn.circuit
    comp = [c._compile_schedule([{m: (int(w[p][i]), 0) for p in ("a", "b")
                                  for i, m in enumerate(syn.ins[p])}])
            for w in words]
    eng, fs = comp[0][:2]
    check(turbo.eligible(eng.ir), "the fp16 netlist is not turbo-eligible")
    watch = [eng.ir.node_sig[id(n)] for n in syn.nets["y"]]
    before = turbo.run_turbo.launches
    v, u = eng.run_ticks_batched(fs, np.stack([x[2] for x in comp]),
                                 np.stack([x[3] for x in comp]), watch=watch)
    return v[:, 0], u[:, 0], turbo.run_turbo.launches - before


def node_planes(eng, nl, hv, hu):
    """The (T, n_nets) V and U planes of every net of ``nl`` (in
    ``nl.nodes`` order) in an engine's (T, S) history."""
    sigs = [eng.ir.node_sig[id(n)] for n in nl.nodes]
    return np.asarray(hv)[:, sigs], np.asarray(hu)[:, sigs]


def phase20_synth(dev, smi, rv32, o1, cycles=200):
    """Synthesis and the host sweep engine (see the module docstring,
    phase 20).  ``rv32``: phase 6's -O1 core; ``o1``: phase 7's wall and
    kernel ms.  Returns the turbo launches of (b), the main path's, the
    kernel's largest difference from its plain version on the -O2 core,
    and for phase 21 the -O2 core's 404-tick turbo history by net
    (``node_planes``), the fp16 operand words of (d) and the -O1 adder's
    outputs."""
    from phy_engine_tpu_torch.digital.engine import DigitalEngine
    ticks = 4 + 2 * cycles
    # (a) synthesis at -O2
    syn = workloads.synth_counts("rv32", 2, device=dev)
    want = workloads.RV32_O2_COUNTS
    check((syn.counts, syn.logic_gates) == want,
          f"RV32 -O2 devices {syn.counts}, {syn.logic_gates} logic gates; "
          f"expected {want}")
    rv2 = workloads.rv32_of(syn)
    say(20, f"RV32 synthesized at -O2: {sum(syn.counts.values())} live devices, "
        f"{syn.logic_gates} logic gates (-O1: {rv32.gates} gates + FFs, -O2: "
        f"{rv2.gates}), equal to workloads.RV32_O2_COUNTS; {syn.seconds:.1f} s "
        f"on the host; {smi}")
    # (b) the -O2 core on the card
    workloads.rv32_run(1, 2, design=rv2)                         # warm-up
    torch.cuda.synchronize()
    turbo.run_turbo.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res, done = workloads.rv32_run(1, cycles, design=rv2)
    end.record()
    torch.cuda.synchronize()
    n1 = turbo.run_turbo.launches
    sec = start.elapsed_time(end) / 1e3
    walls = {"-O1": o1["wall_ms"], "-O2": sec * 1e3}
    check(n1 > 0, "the -O2 core's digital_run never launched the turbo kernel")
    check(int(res[0]) == rv2.expect and int(done[0]) == 1,
          f"RV32 -O2 result {int(res[0])} done {int(done[0])}, expected "
          f"{rv2.expect} and 1")
    say(20, f"RV32 -O2 Circuit.digital_run {ticks} ticks: result {int(res[0])}, "
        f"done {int(done[0])}; wall {sec * 1e3:.1f} ms "
        f"({rv2.gates * ticks / sec:.4e} gate-evals/s) against -O1's "
        f"{o1['wall_ms']:.1f} ms (phase 7) on {smi}; turbo launches {n1}")
    k_ms, b_ms = turbo_kernel_ms(dev, rv2, 1, ticks)
    say(20, f"the kernel alone on the -O2 core, B=1 x {ticks} ticks, full "
        f"history: {k_ms:.3f} ms ({k_ms / ticks * 1e3:.2f} us per tick) "
        f"against -O1's {o1['kernel_ms']:.3f} ms; bound {b_ms:.4f} ms")
    B = 128
    before = turbo.run_turbo.launches
    start.record()
    res, done = workloads.rv32_run(B, cycles, design=rv2)
    end.record()
    torch.cuda.synchronize()
    sec = start.elapsed_time(end) / 1e3
    n128 = turbo.run_turbo.launches - before
    check(n128 > 0, "the -O2 core's digital_run_batch never launched turbo")
    check(bool((res == rv2.expect).all()) and bool((done == 1).all()),
          f"batched RV32 -O2: {int((res != rv2.expect).sum())} of {B} "
          "instances did not end with the expected result")
    say(20, f"RV32 -O2 digital_run_batch B={B} x {2 * cycles} ticks: all {B} "
        f"results {rv2.expect}; wall {sec * 1e3:.1f} ms, aggregate "
        f"{rv2.gates * (B * 2 * cycles + 4) / sec:.4e} gate-evals/s on {smi}; "
        f"turbo launches {n128}")
    err = turbo_err(turbo_cases.rv32_case(2, 8, dev, design=rv2))
    check(err == 0, f"turbo on the -O2 core: kernel != plain, max abs err "
          f"{err}")
    say(20, "RV32 -O2 from reset, B=2, 8 ticks, full history: kernel "
        "bit-identical to plain")
    # (c) the host sweep engine on both cores against the card's turbo
    for level, d in (("-O1", rv32), ("-O2", rv2)):
        reset, body = workloads.rv32_schedules(d, cycles)
        eng, fs, FV, FU = d.circuit._compile_schedule(reset + body)
        nat = DigitalEngine(d.circuit.nl, dev, backend="native")
        t0 = time.perf_counter()
        nat.run_ticks(fs, FV, FU)          # builds the library and the plan
        first_s = time.perf_counter() - t0
        nat.reset_state()
        t0 = time.perf_counter()
        nv, nu = nat.run_ticks(fs, FV, FU)
        nat_s = time.perf_counter() - t0
        eng.reset_state()
        tv, tu = eng.run_ticks(fs, FV, FU)
        check(np.array_equal(nv, tv) and np.array_equal(nu, tu),
              f"the host sweep engine's RV32 {level} history != the turbo "
              "kernel's")
        if level == "-O2":
            o2_planes = node_planes(eng, d.circuit.nl, tv, tu)
        say(20, f"host sweep engine (native/pe_digital.cpp), RV32 {level} "
            f"{ticks} ticks from reset: full ({ticks}, {nv.shape[1]}) "
            f"history bit-identical to the turbo kernel's on the card; host "
            f"wall {nat_s * 1e3:.1f} ms on the second run "
            f"({d.gates * ticks / nat_s:.4e} gate-evals/s) against the "
            f"card's {walls[level]:.1f} ms (Circuit.digital_run, {smi}); "
            f"first run (g++ build, plan, narrowed cones) {first_s:.2f} s")
    # (d) fp16 at -O3 (binary inputs) against -O1 on binary vectors
    s1 = workloads.synth_counts("fp16_add", 1, device=dev)
    s3 = workloads.synth_counts("fp16_add", 3, binary=True, device=dev)
    rng = np.random.default_rng(20)
    words = [{p: rng.integers(0, 1 << 32, 16, dtype=np.uint64)
              for p in ("a", "b")} for _ in range(4)]
    v1, u1, n_1 = fp16_outputs(dev, s1, words)
    v3, u3, n_3 = fp16_outputs(dev, s3, words)
    check(n_1 > 0 and n_3 > 0, "fp16 never launched the turbo kernel")
    check(not u1.any() and not u3.any(), "an fp16 output is X on binary "
          "inputs")
    check(np.array_equal(v3, v1), "fp16 -O3 outputs != -O1 outputs")
    say(20, f"fp16 adder -O3 (assume_binary_inputs: {s3.logic_gates} logic "
        f"gates, {sum(s3.counts.values())} live devices, synthesized in "
        f"{s3.seconds:.1f} s on the host) against -O1 ({s1.logic_gates} "
        f"logic gates): 4 x 32 lanes of random binary operands through the "
        f"turbo kernel, every output bit equal, none X")
    return n1 + n128, err, dict(o2_planes=o2_planes, fp16_words=words,
                                fp16_y=v1, fp16=(s1, s3), rv2=rv2)


# ---------------------------------------------------------------------------
# the user surfaces and persistence (phase 21)
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "phy_engine_tpu_torch" / "data"
LADDER_STEPS = 10          # (b) and (c): TR steps of workloads.DT
CLK_CALLS = 100            # (c): digital_clk calls timed per route
FP16_PAIRS = 8             # (d): operand pairs through the scene


def capi_lib():
    """The port's C ABI library (native/pe_capi.c) built into build/,
    loaded into this interpreter and initialized, with the argument
    types phase 21 calls it with."""
    import ctypes as C
    from phy_engine_tpu_torch import native
    lib = C.CDLL(str(native.build_capi()))
    vp, sz, szp = C.c_void_p, C.c_size_t, C.POINTER(C.c_size_t)
    for name, args, res in (
            ("phy_engine_init", [C.c_char_p], C.c_int),
            ("phy_engine_last_error", [], C.c_char_p),
            ("create_circuit", [C.POINTER(C.c_int), sz, C.POINTER(C.c_int),
                                sz, C.POINTER(C.c_double), C.POINTER(szp),
                                C.POINTER(szp), szp], vp),
            ("destroy_circuit", [vp, szp, szp], None),
            ("circuit_set_analyze_type", [vp, C.c_uint32], C.c_int),
            ("circuit_set_tr", [vp, C.c_double, C.c_double], C.c_int),
            ("circuit_analyze", [vp], C.c_int),
            ("circuit_digital_clk", [vp], C.c_int),
            ("circuit_set_model_digital", [vp, sz, sz, sz, C.c_uint8],
             C.c_int),
            ("circuit_sample_layout", [vp, szp, szp, sz, szp, szp, szp],
             C.c_int),
            ("circuit_sample_digital_state_u8",
             [vp, szp, szp, sz, C.POINTER(C.c_double), szp,
              C.POINTER(C.c_double), szp, C.POINTER(C.c_uint8), szp],
             C.c_int),
            ("verilog_runtime_create", [C.c_char_p, sz, C.c_char_p, sz, vp,
                                        vp, sz], vp),
            ("verilog_runtime_tick", [vp], C.c_int),
            ("verilog_runtime_port_count", [vp], sz),
            ("verilog_runtime_copy_port_name", [vp, sz, C.c_char_p, sz],
             C.c_int),
            ("verilog_runtime_get_port_value", [vp, sz], C.c_uint8),
            ("verilog_runtime_set_port_value", [vp, sz, C.c_uint8], C.c_int),
            ("verilog_runtime_destroy", [vp], None)):
        f = getattr(lib, name)
        f.argtypes, f.restype = args, res
    check(lib.phy_engine_init(str(ROOT).encode()) == 0,
          f"phy_engine_init: {lib.phy_engine_last_error()}")
    return lib


def capi_create(lib, codes, wires, props):
    """create_circuit; returns (handle, vec_pos, chunk_pos, components)."""
    import ctypes as C
    n = len(codes)
    vec, chunk = C.POINTER(C.c_size_t)(), C.POINTER(C.c_size_t)()
    comp = C.c_size_t()
    h = lib.create_circuit((C.c_int * n)(*codes), n,
                           (C.c_int * len(wires))(*wires), len(wires),
                           (C.c_double * max(1, len(props)))(*props),
                           C.byref(vec), C.byref(chunk), C.byref(comp))
    check(bool(h), f"create_circuit: {lib.phy_engine_last_error()}")
    return h, vec, chunk, comp.value


def capi_sample(lib, h, vec, chunk, n):
    """(pin voltages, 4-state codes) of every component, in order."""
    import ctypes as C
    ords = [(C.c_size_t * (n + 1))() for _ in range(3)]
    check(lib.circuit_sample_layout(h, vec, chunk, n, *ords) == 0,
          "circuit_sample_layout failed")
    v, c, d = (o[n] for o in ords)
    volts = (C.c_double * max(1, v))()
    curs = (C.c_double * max(1, c))()
    digs = (C.c_uint8 * max(1, d))()
    check(lib.circuit_sample_digital_state_u8(
        h, vec, chunk, n, volts, ords[0], curs, ords[1], digs, ords[2]) == 0,
        "circuit_sample_digital_state_u8 failed")
    return np.array(volts[:v]), list(digs[:d])


def ladder_circuit(device):
    """workloads.diode_ladder_elements as an api.Circuit on ``device``."""
    from phy_engine_tpu_torch import api
    codes, wires, props = workloads.diode_ladder_elements()
    els, k = [], 0
    for code in codes:
        n = api.PROPERTY_ARITY[code]
        els.append(api.Element(code, tuple(props[k:k + n])))
        k += n
    return api.Circuit(els, [api.Wire(*wires[i:i + 4])
                             for i in range(0, len(wires), 4)],
                       device=device)


def ladder_tr(c, steps):
    """``steps`` more TR steps of workloads.DT on an api.Circuit."""
    c.set_analyze_type(AnalyzeType.TR.value)
    c.set_tr(workloads.DT, steps * workloads.DT)
    c.analyze()                      # raises PhyEngineError on a failure
    return c


def pin_volts(c):
    return np.array([v for comp in c.sample().components
                     for v in comp.pin_voltages])


def rel_to(a, ref):
    return float(np.abs(np.asarray(a) - ref).max() / np.abs(ref).max())


def same_ir(a, b):
    """Two lowered analog IRs are equal, array for array."""
    if (a.n_unknowns, a.n_nodes, a.n_branches) != (b.n_unknowns, b.n_nodes,
                                                   b.n_branches):
        return False
    return all(fa.mdef.id_name == fb.mdef.id_name and all(
        np.array_equal(getattr(fa, k), getattr(fb, k))
        for k in ("pin_nodes", "br_idx", "a_rows", "a_cols", "z_rows"))
        for fa, fb in zip(a.families, b.families)) and \
        len(a.families) == len(b.families)


def phase21_surfaces(dev, smi, p20, cycles=200):
    """The user surfaces and persistence (see the module docstring, phase
    21).  ``p20``: phase 20's -O2 history by net and fp16 data.  Returns
    the turbo launches of (a)."""
    import ctypes
    import tempfile
    from phy_engine_tpu_torch import api, io as tio
    from phy_engine_tpu_torch.cli.verilog2penl import main as v2penl
    from phy_engine_tpu_torch.cli.verilog2plsav import main as v2plsav
    from phy_engine_tpu_torch.io import plsav
    ticks = 4 + 2 * cycles
    tmp = tempfile.TemporaryDirectory()
    td = Path(tmp.name)

    # (a) verilog2penl -> .penl -> io.load -> digital_run on the card
    t0 = time.perf_counter()
    penl = td / "rv32_o2.penl"
    check(v2penl([str(penl), str(DATA / "pe_rv32.v"), "--top", "pe_rv32",
                  "--synth", "-O2", "--report"]) == 0,
          "verilog2penl failed on pe_rv32 -O2")
    cli_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = tio.load(str(penl), device=dev)
    load_s = time.perf_counter() - t0
    counts, logic = workloads.device_counts(c.nl)
    outputs = counts.pop("OUTPUT", 0)
    check((counts, logic) == workloads.RV32_O2_COUNTS and outputs == 33,
          f"the loaded -O2 core: {counts}, {logic} logic gates, {outputs} "
          f"OUTPUT devices; expected phase 20's and 33")
    d = workloads.rv32_of_penl(c)
    reset, body = workloads.rv32_schedules(d, cycles)
    before = turbo.run_turbo.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = c.digital_run(reset + body)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    n_a = turbo.run_turbo.launches - before
    res = int(tr.bus_values(d.ports["result"])[-1])
    done = int(tr.node_codes(d.ports["done"][0])[-1])
    hv, hu = node_planes(c.digital_engine(), c.nl, tr.sv, tr.su)
    ov, ou = p20["o2_planes"]
    check(n_a > 0, "the loaded -O2 core never launched the turbo kernel")
    check(res == workloads.RV32_EXPECT and done == 1,
          f"loaded RV32 -O2: result {res} done {done}")
    check(hv.shape == ov.shape and np.array_equal(hv, ov)
          and np.array_equal(hu, ou),
          "the loaded -O2 core's history != phase 20's turbo history")
    say(21, f"(a) verilog2penl pe_rv32 -O2 --report: {cli_s:.1f} s on the "
        f"host, {penl.stat().st_size / 2**20:.1f} MiB; io.load on the card "
        f"{load_s:.2f} s: live devices equal phase 20's -O2 core type by "
        f"type plus {outputs} OUTPUT; Circuit.digital_run {ticks} ticks "
        f"(plan build included) {run_s * 1e3:.1f} ms on {smi}: result "
        f"{res}, done {done}, every net of every tick ({hv.shape[0]} x "
        f"{hv.shape[1]}, V and U planes) bit-identical to phase 20's turbo "
        f"history; turbo launches {n_a}")

    # (b) a checkpoint on the card
    t0 = time.perf_counter()
    full = ladder_tr(ladder_circuit(dev), LADDER_STEPS)
    ref = pin_volts(full)
    half = ladder_tr(ladder_circuit(dev), LADDER_STEPS // 2)
    ck = td / "ladder_ckpt.penl"
    tio.save(str(ck), half.core, tio.SaveOptions(mode="runtime_only"))
    resumed = ladder_circuit(dev)
    tio.load(str(ck), circuit=resumed.core)
    check(abs(resumed.core.tr_duration - half.core.tr_duration) == 0,
          "the checkpoint lost the transient clock")
    rel_b = rel_to(pin_volts(ladder_tr(resumed, LADDER_STEPS // 2)), ref)
    check(rel_b <= TRACE_TOL, f"resumed ladder vs uninterrupted: {rel_b:.3e}"
          f" > {TRACE_TOL}")
    fp = td / "ladder_full.penl"
    tio.save(str(fp), full.core)
    back = tio.load(str(fp), device=dev)
    check(same_ir(back.prepare(), full.core.prepare()),
          "the full save of the ladder did not load back to the same IR")
    say(21, f"(b) 255-stage ladder (256 unknowns) from element codes on the "
        f"card: {LADDER_STEPS} TR steps uninterrupted against "
        f"{LADDER_STEPS // 2} + runtime_only checkpoint ({ck.stat().st_size}"
        f" B) + io.load into a fresh circuit + {LADDER_STEPS // 2}: rel err "
        f"{rel_b:.3e}; the full save ({fp.stat().st_size} B) loads back to "
        f"the same IR; {time.perf_counter() - t0:.1f} s")

    # (c) the C ABI on the card
    t0 = time.perf_counter()
    lib = capi_lib()
    build_s = time.perf_counter() - t0
    h, vec, chunk, n = capi_create(lib, *workloads.diode_ladder_elements())
    check(lib.circuit_set_analyze_type(h, AnalyzeType.TR.value) == 0 and
          lib.circuit_set_tr(h, workloads.DT,
                             LADDER_STEPS * workloads.DT) == 0,
          "circuit_set_* failed")
    check(lib.circuit_analyze(h) == 0,
          f"circuit_analyze: {lib.phy_engine_last_error()}")
    volts, _digs = capi_sample(lib, h, vec, chunk, n)
    lib.destroy_circuit(h, vec, chunk)
    rel_card = rel_to(volts, ref)
    rel_cpu = rel_to(volts, pin_volts(ladder_tr(ladder_circuit("cpu"),
                                                LADDER_STEPS)))
    check(rel_card <= 1e-12, f"C ABI vs api.Circuit on the card: "
          f"{rel_card:.3e} > 1e-12")
    check(rel_cpu <= TRACE_TOL, f"C ABI vs the CPU: {rel_cpu:.3e}")
    say(21, f"(c) C ABI (build_capi + phy_engine_init {build_s:.2f} s): "
        f"create_circuit of the ladder's {n} components, circuit_set_tr, "
        f"circuit_analyze ({LADDER_STEPS} TR steps), circuit_sample: pin "
        f"voltages vs api.Circuit on the card rel {rel_card:.3e}, vs the "
        f"CPU rel {rel_cpu:.3e}")
    gate = ([200, 200, 204, 201], [0, 0, 2, 0, 1, 0, 2, 1, 2, 2, 3, 0],
            [1.0, 0.0])
    h, vec, chunk, n = capi_create(lib, *gate)
    backend = ctypes.cast(h, ctypes.py_object).value.core.digital_backend
    check(backend == "native", f"the glue chose {backend} for a gate circuit")
    lib.circuit_digital_clk(h)           # builds the host engine's plan
    t0 = time.perf_counter()
    for i in range(CLK_CALLS):
        lib.circuit_set_model_digital(h, 1, 0, 0, i & 1)
        check(lib.circuit_digital_clk(h) == 0, "circuit_digital_clk failed")
    host_us = (time.perf_counter() - t0) / CLK_CALLS * 1e6
    c_out = capi_sample(lib, h, vec, chunk, n)[1]
    lib.destroy_circuit(h, vec, chunk)
    g = api.Circuit([api.Element(200, (1.0,)), api.Element(200, (0.0,)),
                     api.Element(204), api.Element(201)],
                    [api.Wire(*gate[1][i:i + 4]) for i in range(0, 12, 4)],
                    device=dev)
    g.digital_clk()                      # lowers, builds the tick
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(CLK_CALLS):
        g.set_model_digital(1, i & 1)
        g.digital_clk()
    torch.cuda.synchronize()
    card_us = (time.perf_counter() - t0) / CLK_CALLS * 1e6
    g_out = [s for comp in g.sample().components
             for s in comp.digital_states]
    check(c_out == g_out and c_out[-1] == (CLK_CALLS - 1) & 1,
          f"AND gate: C ABI {c_out} vs api.Circuit on the card {g_out}")
    say(21, f"(c) {CLK_CALLS} set_model_digital + digital_clk calls of a "
        f"2-input AND: C ABI on the host sweep engine {host_us:.1f} us a "
        f"call, api.Circuit on the card's levelled tick {card_us:.1f} us a "
        f"call ({card_us / host_us:.2f}x); equal final states; {smi}")
    src = b"""module cnt(input clk, input rst_n, output [3:0] q);
  reg [3:0] r;
  always @(posedge clk or negedge rst_n)
    if (!rst_n) r <= 4'd0; else r <= r + 4'd1;
  assign q = r;
endmodule
"""
    rt = lib.verilog_runtime_create(src, len(src), b"cnt", 3, None, None, 0)
    check(bool(rt), f"verilog_runtime_create: {lib.phy_engine_last_error()}")
    ports = {}
    for i in range(lib.verilog_runtime_port_count(rt)):
        buf = ctypes.create_string_buffer(64)
        lib.verilog_runtime_copy_port_name(rt, i, buf, 64)
        ports[buf.value.decode()] = i
    lib.verilog_runtime_set_port_value(rt, ports["rst_n"], 0)
    lib.verilog_runtime_tick(rt)
    lib.verilog_runtime_set_port_value(rt, ports["rst_n"], 1)
    for _ in range(5):
        for level in (1, 0):
            lib.verilog_runtime_set_port_value(rt, ports["clk"], level)
            lib.verilog_runtime_tick(rt)
    q = lib.verilog_runtime_get_port_value(rt, ports["q"])
    lib.verilog_runtime_destroy(rt)
    check(q == 5, f"verilog_runtime counter: q = {q} after 5 clocks")
    say(21, f"(c) verilog_runtime_* round trip: ports {sorted(ports)}, q = "
        f"{q} after reset and 5 clocks")

    # (d) a PhysicsLab scene of the fp16 adder on the card
    t0 = time.perf_counter()
    sav, net = td / "fp16_add.sav", td / "fp16_add.penl"
    args = [str(DATA / "fp16_add.v"), "--top", "fp16_add", "-O1"]
    check(v2plsav([str(sav), *args]) == 0 and v2penl([str(net), *args]) == 0,
          "the CLIs failed on fp16_add -O1")
    cli_s = time.perf_counter() - t0
    ex = plsav.Experiment.load(str(sav))
    live = tio.load(str(net), device="cpu").nl.live_models()
    ins = [m for m in live if m.mdef.digital_op == "INPUT"]
    outs = [m for m in live if m.mdef.digital_op == "OUTPUT"]
    li = [e for e in ex.elements if e.model_id == "Logic Input"]
    lo = [e for e in ex.elements if e.model_id == "Logic Output"]
    check((len(ex.elements), len(li), len(lo)) == (2427, 60, 16)
          and len(ins) == 60 and len(outs) == 16,
          f"fp16 scene: {len(ex.elements)} elements, {len(li)} Logic "
          f"Inputs, {len(lo)} Logic Outputs")
    t0 = time.perf_counter()
    sc, _idx = plsav.experiment_to_circuit(ex, device=dev)
    words, y = p20["fp16_words"][0], p20["fp16_y"][0]

    def bit(name):                       # "a[3]" -> ("a", 3)
        port, i = name[:-1].split("[")
        return port, int(i)

    for lane in range(FP16_PAIRS):
        for el, m in zip(li, ins):
            if m.params.get("synth_const"):
                val = int(m.params["boolean"])
            else:
                port, i = bit(m.name)
                val = (int(words[port][i]) >> lane) & 1
            el.properties["开关"] = float(val)
        plsav.sync_inputs(ex, sc)
        sc.digital_clk()
        plsav.write_back(ex, sc)
        got = [el.properties["状态"] for el in lo]
        want = [float((int(y[bit(m.name)[1]]) >> lane) & 1) for m in outs]
        check(got == want, f"fp16 scene, pair {lane}: {got} != {want}")
    scene_s = time.perf_counter() - t0
    n_const = sum(1 for m in ins if m.params.get("synth_const"))
    say(21, f"(d) verilog2plsav fp16_add -O1: {len(ex.elements)} elements "
        f"({len(li)} Logic Inputs, {n_const} of them constants, {len(lo)} "
        f"Logic Outputs, {len(ex.wires)} wires, auto-laid-out), the two CLIs "
        f"{cli_s:.1f} s; experiment_to_circuit on the card, {FP16_PAIRS} "
        f"operand pairs through sync_inputs / digital_clk (levelled tick) / "
        f"write_back {scene_s:.2f} s: every output equal to phase 20's -O1 "
        f"turbo outputs")
    tmp.cleanup()
    return n_a


# ---------------------------------------------------------------------------
# the mesh paths (phase 22)
# ---------------------------------------------------------------------------

def port_bit_key(syn):
    """Names a synthesized design's port nets by (port, bit) and every
    other net by its identity (``workloads.comb_graph``'s ``key``)."""
    pb = {id(n): (p, i) for p, ns in syn.nets.items() for i, n in enumerate(ns)}
    return lambda net: pb.get(id(net), id(net))


def phase22_mesh(dev, smi, rv32, p11, p20, n=4096, lanes=256, steps=20,
                 B=128, cycles=200, patterns=2 ** 17):
    """The mesh paths on a one-rank NCCL mesh (see the module docstring,
    phase 22).  ``rv32``: phase 6's -O1 core; ``p11`` / ``p20``: phases
    11 and 20's results.  Returns the kernel launches of (c) and (d)."""
    import torch.distributed as dist
    from phy_engine_tpu_torch import native
    from phy_engine_tpu_torch.parallel import dist_gj
    from phy_engine_tpu_torch.parallel.mesh import (
        axis_size, make_mesh, sharded_batched_transient_shmap)
    from phy_engine_tpu_torch.parallel.tt_mesh import eval_graph_mesh
    from phy_engine_tpu_torch.verilog import opt_graph as og
    mesh = make_mesh()
    check(dist.get_backend() == "nccl" and axis_size(mesh) == 1
          and dist.get_world_size() == 1,
          f"make_mesh(): backend {dist.get_backend()}, world "
          f"{dist.get_world_size()}")
    say(22, f"make_mesh(): {mesh} on {dev}, backend nccl, world size 1")

    # (a) the cooperative solve at (1, 4096) against numpy's f64 solve
    rng = np.random.default_rng(22)
    A = rng.standard_normal((1, n, n)) + 4.0 * np.sqrt(n) * np.eye(n)
    b = rng.standard_normal((1, n))
    dist_gj.dist_solve(mesh, A[:, :256, :256], b[:, :256])       # warm-up
    with Counted(dist_gj, "panel_factor", timed=True) as panels:
        x, sec = timed(lambda: dist_gj.dist_solve(mesh, A, b, refine=2))
    panel_ms = panels.seconds() * 1e3
    xref = np.linalg.solve(A[0], b[0])
    err = float(np.max(np.abs(x.cpu().numpy()[0] - xref) / (1 + np.abs(xref))))
    check(err <= 1e-9, f"(a) dist_solve vs numpy {err:.3e} > 1e-9")
    Fp = torch.as_tensor(A[:, :, :gj.NB], dtype=torch.float32, device=dev)
    kr = torch.full((1, n), -1, dtype=torch.int64, device=dev)
    pv = torch.ones((1, n), dtype=torch.float32, device=dev)
    n_ops, one_ms = device_ops(lambda: gj.panel_factor(Fp, kr, pv, 0))
    say(22, f"(a) dist_solve (B, n) = (1, {n}), refine 2: wall {sec:.3f} s on "
        f"{smi}; panel_factor {panels.calls} calls, {panel_ms:.1f} ms = "
        f"{100 * panel_ms / (sec * 1e3):.1f} % of the wall ({n_ops} device "
        f"operations, {one_ms:.3f} ms of device time a call); x vs numpy f64 "
        f"{err:.3e} (relerr)")

    # (b) Circuit(mesh=) on phase 11's ladder: OP and TR, distributed
    c = Circuit(workloads.diode_ladder_netlist(), device=dev, mesh=mesh)
    c.set_analyze_type(AnalyzeType.OP)
    ok_op, s_op = timed(c.analyze)
    x_op = c._x.cpu().numpy()
    c.tr.t_step, c.tr.t_stop = workloads.DT, steps * workloads.DT
    c.set_analyze_type(AnalyzeType.TR)
    ok_tr, s_tr = timed(c.analyze)
    check(ok_op and ok_tr and c.tr_history.shape == p11["tr"].shape,
          f"(b) Circuit(mesh=) OP ok {ok_op}, TR ok {ok_tr}")
    got = np.vstack([x_op, c.tr_history])
    ref = np.vstack([p11["x_op"], p11["tr"]])
    rel_b = float(np.abs(got - ref).max() / np.abs(ref).max())
    check(rel_b <= TRACE_TOL, f"(b) mesh OP / TR vs phase 11 {rel_b:.3e}")
    say(22, f"(b) Circuit(mesh=) on the {workloads.N_STAGES}-stage ladder "
        f"({c._ir.n_unknowns} unknowns): OP (newton_solve_dist) {s_op:.3f} s, "
        f"TR {steps} x {workloads.DT:g} s (transient_dist) {s_tr:.3f} s "
        f"({steps / s_tr:.2f} circuit-steps/s) on {smi}; vs phase 11's dense "
        f"route {rel_b:.3e} of max|x|")

    # (c) the per-shard delta-Newton transient at full width
    ir = workloads.build_diode_ladder()
    params = batch_params(ir, lanes, jitter={"R": {"r": workloads.R_JITTER}},
                          generator=torch.Generator().manual_seed(22),
                          device=dev)
    env = workloads.default_env()
    args = (params, batch_x(ir, lanes, dev), batch_state(ir, lanes, dev), env,
            0.0, workloads.DT, steps)
    (x_l, _s, ok_l, _x), s_l = timed(lambda: analog.transient_batched(
        ir, *args, solver="hybrid"))
    gj.gj_solve32.launches = 0
    (x_m, _s, ok_m), s_m = timed(lambda: sharded_batched_transient_shmap(
        ir, mesh, *args, solver="hybrid"))
    n_gj = gj.gj_solve32.launches
    check(n_gj > 0, "(c) the sharded transient never launched gj_solve32")
    check(bool(ok_l.all()) and ok_m, f"(c) ok: local {int(ok_l.sum())} of "
          f"{lanes}, mesh {ok_m}")
    check(torch.equal(x_m, x_l), "(c) sharded transient != unsharded, max "
          f"diff {float((x_m - x_l).abs().max()):.3e}")
    say(22, f"(c) sharded_batched_transient_shmap, ladder B={lanes} x {steps} "
        f"steps, solver hybrid: {s_m:.3f} s against the unsharded "
        f"transient_batched's {s_l:.3f} s on {smi}; bit-identical; gj_solve32 "
        f"launches {n_gj}")

    # (d) phase 8's 128 RV32 instances, sharded
    eng = rv32.circuit.digital_engine()
    watch = rv32.ports["result"] + rv32.ports["done"]
    reset, body = workloads.rv32_schedules(rv32, cycles)
    eng.reset_state()
    rv32.circuit.digital_run(reset)
    local = rv32.circuit.digital_run_batch([body] * B, watch)
    turbo.run_turbo.launches = 0
    codes, s_d = timed(lambda: rv32.circuit.digital_run_batch(
        [body] * B, watch, mesh=mesh))
    n_t = turbo.run_turbo.launches
    last = codes[:, -1].astype(np.int64)
    res = ((last[:, :32] == 1).astype(np.int64)
           << np.arange(32, dtype=np.int64)).sum(axis=1)
    check(n_t > 0, "(d) the sharded batch never launched the turbo kernel")
    check(np.array_equal(codes, local), "(d) sharded RV32 codes != phase 8's")
    check(bool((res == rv32.expect).all()), "(d) a sharded RV32 instance did "
          "not end with the expected result")
    say(22, f"(d) digital_run_batch(mesh=) RV32 B={B} x {2 * cycles} ticks: "
        f"{codes.shape[1]} x {codes.shape[2]} watched codes a instance "
        f"bit-identical to phase 8's call, all results {rv32.expect}; wall "
        f"{s_d * 1e3:.1f} ms on {smi}; turbo launches {n_t}")

    # (e) the sweeps with mesh=: phase 11's ladder (its VAC's OP is 0 V)
    # and the same ladder driven by 1 V DC, 256 lanes each
    c = Circuit(workloads.diode_ladder_netlist(), device=dev)
    ts = c.temp_sweep(p11["temps"], mesh=mesh)
    check(np.array_equal(ts.x, p11["temp_x"])
          and np.array_equal(ts.ok, p11["temp_ok"]),
          "(e) temp_sweep(mesh=) != phase 11's temp_sweep")
    cd = Circuit(workloads.diode_ladder_netlist(dc=1.0), device=dev)
    r0 = next(m for m in cd.nl.live_models() if m.mdef.id_name == "R")
    runs = {
        "dc_sweep": lambda **kw: cd.dc_sweep(
            r0, "r", np.linspace(50.0, 150.0, lanes), **kw),
        "temp_sweep": lambda **kw: cd.temp_sweep(
            np.linspace(-40.0, 125.0, lanes), **kw),
        "monte_carlo": lambda **kw: cd.monte_carlo(
            {"R": {"r": workloads.R_JITTER}}, lanes,
            generator=torch.Generator().manual_seed(22), **kw)}
    walls = []
    for name, run in runs.items():
        loc, s1 = timed(run)
        shd, s2 = timed(lambda: run(mesh=mesh))
        check(bool(loc.ok.all()), f"(e) {name}: {int((~loc.ok).sum())} of "
              f"{lanes} local lanes failed")
        check(np.array_equal(shd.x, loc.x) and np.array_equal(shd.ok, loc.ok),
              f"(e) {name}(mesh=) != the local {name}")
        walls.append(f"{name} {s2:.3f} s (local {s1:.3f} s)")
    say(22, f"(e) with mesh=, {lanes} lanes, bit-identical to the local runs: "
        f"temp_sweep on phase 11's ladder equal to phase 11's; on the 1 V DC "
        f"ladder {', '.join(walls)} on {smi}")

    # (f) the truth-table checks sharded over the mesh
    s1, s3 = p20["fp16"]
    names = {}
    g1, g3 = (workloads.comb_graph(s.circuit.nl, s.nets["y"],
                                   key=port_bit_key(s), names=names)
              for s in (s1, s3))
    eq, s_eq = timed(lambda: og.graphs_equivalent(g1, g3, exhaustive_limit=0,
                                                  mesh=mesh))
    k, (net, idx) = next(iter(g3.outputs.items()))
    g3.outputs[k] = (net, g3.gate("NOT", idx))          # one output flipped
    check(eq and not og.graphs_equivalent(g1, g3, exhaustive_limit=0,
                                          mesh=mesh),
          f"(f) fp16 -O1 vs -O3 equivalent {eq}, or a flipped output passed")
    rv2 = p20["rv2"]
    nl = rv2.circuit.nl
    g = workloads.comb_graph(nl, workloads.ff_cone_outputs(
        nl, [n for p in ("result", "done") for n in rv2.ports[p]]))
    leaf_row = {}
    rows, _outs, nr = og._gategraph_to_tt(g, leaf_row, 0)
    op, f0, f1 = (np.array([r[k] for r in rows], np.int32) for k in range(3))
    words = np.zeros((nr, patterns // 64), np.uint64)
    for row in leaf_row.values():
        words[row] = rng.integers(0, 2 ** 64, patterns // 64, dtype=np.uint64)
    tt_m, s_tt = timed(lambda: eval_graph_mesh(op, f0, f1, words, mesh))
    t0 = time.perf_counter()
    tt_n = native.eval_graph(op.copy(), f0, f1, words.copy())
    s_nat = time.perf_counter() - t0
    check(np.array_equal(tt_m, tt_n), "(f) eval_graph_mesh != "
          "native.eval_graph on the RV32 -O2 graph")
    say(22, f"(f) graphs_equivalent(mesh=) fp16 -O1 ({g1.gate_count()} graph "
        f"gates) vs -O3 ({g3.gate_count() - 1}): equivalent over 2^20 patterns in "
        f"{s_eq:.3f} s, one flipped output caught; eval_graph_mesh on the "
        f"RV32 -O2 graph ({nr} rows, {len(leaf_row)} leaves, {patterns} "
        f"patterns) {s_tt:.3f} s on {smi}, bit-identical to native.eval_graph "
        f"({s_nat:.3f} s on the host)")
    dist.destroy_process_group()
    return {"gj_solve32": n_gj, TURBO["name"]: n_t}


# ---------------------------------------------------------------------------
# large systems (phases 2's solve_batched and 16-19)
# ---------------------------------------------------------------------------

MESH_NODES, MESH_LINKS, MESH_SEED = 100_000, 400_000, 16
MESH_STEPS, MESH_DT, MESH_C, MESH_CAP_EVERY = 20, 1e-7, 1e-9, 1000
MESH_CPU_STEPS = 5      # the CPU reference's TR steps (its ~6 s a step)


def phase2_solve_batched(dev, smi, B=256):
    """``ops/gj.py::solve_batched`` (see the module docstring, phase 2):
    B random systems at n = 256 and n = 200 (padded to 256), one lane
    singular.  Returns gj_solve32's launches under it."""
    launches = 0
    for n in (256, 200):
        rng = np.random.default_rng(n)
        A = rng.standard_normal((B, n, n)) + 5.0 * np.eye(n)
        s = singular_lane(B)
        A[s] = 0.0
        A[s, 0, :] = 1.0                                   # rank 1
        b = rng.standard_normal((B, n))
        Ad, bd = torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev)
        gj.gj_solve32.launches = 0
        x = gj.solve_batched(Ad, bd)
        torch.cuda.synchronize()
        n_launch = gj.gj_solve32.launches
        launches += n_launch
        check(n_launch == 3, f"solve_batched n={n}: gj_solve32 launched "
              f"{n_launch} times, not 3 (a solve and two refinement passes)")
        x = x.cpu().numpy()
        good = [i for i in range(B) if i != s]
        xe = np.linalg.solve(A[good], b[good][..., None])[..., 0]
        err = float(np.max(np.abs(x[good] - xe)
                           / np.maximum(np.abs(xe), 1e-9)))
        check(err <= 1e-7, f"solve_batched n={n}: rel err vs numpy f64 "
              f"{err:.3e} > 1e-7")
        check(not np.isfinite(x[s]).all(), f"solve_batched n={n}: the "
              "singular lane came back finite")
        ms = time_ms(lambda: gj.solve_batched(Ad, bd), 10)
        # solve_ex: the same LU solve without the error check that raises
        # on the singular lane
        lib_ms = time_ms(lambda: torch.linalg.solve_ex(Ad, bd), 10)
        say(2, f"solve_batched B={B} n={n}{' (padded to 256)' if n % 128 else ''}"
            f": rel err vs numpy f64 {err:.3e} on {B - 1} lanes, the "
            f"singular lane NaN; gj_solve32 launches {n_launch}; "
            f"{ms:.4f} ms a call, torch.linalg.solve_ex (f64, same systems) "
            f"{lib_ms:.4f} ms, on {smi}")
    gj.gj_solve32.launches = 0
    return launches


def wall(fn, device):
    """(fn's result, wall s): CUDA events on the card, the host clock on
    the CPU."""
    if torch.device(device).type == "cuda":
        return timed(fn)
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def mesh_sequence(device, steps=MESH_STEPS, oracle=False):
    """Phase 16's sequence on one device (see the module docstring): the
    random mesh through ``Circuit`` with solver "auto", (a) DC, (b) DC
    with a PN_JUNCTION from node 1 to ground, (c) the diode removed, a
    capacitor from every MESH_CAP_EVERY-th node to ground, TR for
    ``steps`` steps.  After each netlist edit the lowering and the sparse
    layout are built (and timed) apart from the analysis.  Returns each
    solution, each analysis's ok, route, wall, BiCGStab iterations and
    seconds inside BiCGStab, the set-up seconds, the lu_solve_gauss
    calls and, with ``oracle``, (a)'s independent solve (cg_oracle)."""
    from phy_engine_tpu_torch.models import CAPACITOR, PN_JUNCTION
    card = torch.device(device).type == "cuda"
    if not card:
        torch.set_num_threads(4)
    out = {"iters": {}, "sec": {}, "ok": {}, "method": {}, "setup": {},
           "bicg_s": {}}
    t0 = time.perf_counter()
    nl, nodes = workloads.random_mesh_netlist(MESH_NODES, MESH_LINKS,
                                              MESH_SEED)
    out["build_s"] = time.perf_counter() - t0
    c = Circuit(nl, device=device)
    its = []

    def count_iters(res, _args, _kwargs):
        its.append(res[2])

    def run(tag, bicg):
        _, out["setup"][tag] = wall(
            lambda: analog.coo_layout(c.prepare(), c._drives), device)
        its.clear()
        bicg.events = []
        ok, sec = wall(c.analyze, device)
        out["ok"][tag], out["sec"][tag] = bool(ok), sec
        out["method"][tag] = c._method()
        out["iters"][tag] = [int(i.sum()) for i in its]
        out["bicg_s"][tag] = bicg.seconds() if card else None

    with Counted(analog, "bicgstab", timed=card, record=count_iters) as bicg, \
            Counted(linsolve, "lu_solve_gauss") as gauss:
        c.set_analyze_type(AnalyzeType.DC)
        run("a", bicg)
        out["n"] = c._ir.n_unknowns
        out["x_a"] = c._x.cpu().numpy()
        if oracle:
            t0 = time.perf_counter()
            out["oracle"] = cg_oracle(c)
            out["oracle_s"] = time.perf_counter() - t0
        d = tpe.netops.add_model(nl, PN_JUNCTION, {})
        tpe.netops.add_to_node(nl, d, 0, nodes[1])
        tpe.netops.add_to_node(nl, d, 1, nl.ground_node)
        run("b", bicg)
        out["x_b"] = c._x.cpu().numpy()
        out["v_diode"] = c.node_voltage(nodes[1]).real
        tpe.netops.delete_model(nl, d)
        for k in range(0, MESH_NODES, MESH_CAP_EVERY):
            cap = tpe.netops.add_model(nl, CAPACITOR, {"C": MESH_C})
            tpe.netops.add_to_node(nl, cap, 0, nodes[k])
            tpe.netops.add_to_node(nl, cap, 1, nl.ground_node)
        c.tr.t_step, c.tr.t_stop = MESH_DT, steps * MESH_DT
        c.set_analyze_type(AnalyzeType.TR)
        run("c", bicg)
        out["hist"] = c.tr_history
    out["gauss"] = gauss.calls
    return out


def cg_oracle(c):
    """Node voltages of the mesh's DC point by an independent route: the
    MNA rebuilt from the netlist objects (torch_circuits.mesh_mna), the
    VDC's node eliminated (its voltage known), and scipy's conjugate
    gradients on the remaining symmetric positive definite system to a
    1e-13 relative residual.  (A direct factorization is out of reach: a
    random graph has no small separators, so its LU fills in ~n^2 and
    takes ~n^3.)  Returns (the node voltages, the full MNA's relative
    residual at them)."""
    import scipy.sparse.linalg as spl
    from torch_circuits import mesh_mna
    A, rhs = mesh_mna(c)
    ir = c.prepare()
    nn = ir.n_nodes
    src = [m for m in c.nl.live_models() if m.mdef.id_name == "VDC"]
    check(len(src) == 1, "the mesh has one VDC")
    k = src[0].branches[0].index
    p0 = src[0].pins[0].node.node_index
    G = A[:nn, :nn].tocsr()
    free = np.setdiff1d(np.arange(nn), [p0])
    v_src = rhs[k]
    Gff = G[free][:, free]
    b = -np.asarray(G[free][:, [p0]].todense()).ravel() * v_src
    M = spl.LinearOperator(Gff.shape, matvec=lambda v, d=Gff.diagonal(): v / d)
    try:
        vf, info = spl.cg(Gff, b, rtol=1e-13, atol=0.0, maxiter=100_000, M=M)
    except TypeError:                         # scipy < 1.12
        vf, info = spl.cg(Gff, b, tol=1e-13, atol=0.0, maxiter=100_000, M=M)
    check(info == 0, f"the CG oracle did not converge (info {info})")
    v = np.zeros(nn)
    v[free] = vf
    v[p0] = v_src
    x = np.zeros(ir.n_unknowns)
    x[:nn] = v
    x[k] = -(G[p0] @ v)[0]
    res = np.linalg.norm(A @ x - rhs) / np.linalg.norm(rhs)
    return v, float(res)


def coo_spmm_kernel(dev, smi, lanes=64, reps=20):
    """Phase 16's first part: coo_spmm against the plain twin at the
    mesh100k.dc cell's shape (see the module docstring).  Returns the
    kernel's measurements for the kernels line."""
    from torch_circuits import random_link_mesh_ir
    lay = analog.coo_layout(random_link_mesh_ir(100_000, 10_000))
    n, nnz = lay.n, lay.perm.size
    check((n, nnz) == (100_001, 540_001) and lay.wide.size == 0,
          f"the mesh cell's pattern: {n} unknowns, {nnz} entries in range, "
          f"{lay.wide.size} wide rows")
    g = torch.Generator(device=dev).manual_seed(16)
    vals = torch.randn((lanes, lay.nnz), generator=g, device=dev,
                       dtype=torch.float64)
    x = torch.randn((lanes, n), generator=g, device=dev, dtype=torch.float64)
    prod = lay.bind(vals)
    y, y2 = prod(x), prod(x)
    plain = lay.matvec_plain(vals, x)
    narrow = torch.as_tensor(np.diff(lay.rowptr) <= 8, device=dev)
    check(torch.equal(y, y2), "coo_spmm: a repeat run is not bit-identical")
    check(torch.equal(y[:, narrow], plain[:, narrow]), "coo_spmm differs "
          "from the plain twin on rows up to 8 entries wide")
    err = float((y - plain).abs().max())
    scale = float(plain.abs().max())
    check(err <= 1e-12 * scale, f"coo_spmm vs the plain twin {err:.3e} > "
          f"1e-12 of max|y| {scale:.3e}")
    t = [time_ms(lambda: lay.matvec_plain(vals, x), reps),
         time_ms(lambda: prod(x), reps), time_ms(lambda: prod(x), reps),
         time_ms(lambda: lay.matvec_plain(vals, x), reps)]
    # the least bytes of a pass: the values and x read once, y written
    # once, the pattern (rowptr, columns; int32) read once
    nbytes = 8 * lanes * (nnz + 2 * n) + 4 * (n + 1 + nnz)
    r = {"max_abs_err": err, "ms": (t[1] + t[2]) / 2,
         "plain_ms": (t[0] + t[3]) / 2, "library_ms": None}
    r["bound_ms"], r["bound_by"] = bound(nbytes, 2 * lanes * nnz, FP64_FLOPS)
    say(16, f"coo_spmm at (B, n) = ({lanes}, {n}), {nnz} entries: "
        f"{r['ms']:.4f} ms a product ({100 * r['bound_ms'] / r['ms']:.1f} % "
        f"of its {r['bound_ms']:.4f} ms {r['bound_by']} bound, "
        f"{nbytes / 1e6:.1f} MB), plain twin {r['plain_ms']:.4f} ms "
        f"(P C C P: {', '.join(f'{v:.4f}' for v in t)}) on {smi}; max "
        f"|y - plain| {err:.3e} of max|y| {scale:.3e}, rows <= 8 wide bit "
        "for bit, repeat bit-identical")
    return r


def phase16_mesh(dev, smi, cpu_run):
    """The Circuit sparse route at 100k nodes (see the module docstring,
    phase 16).  ``cpu_run``: the future of mesh_sequence("cpu",
    MESH_CPU_STEPS).  Returns coo_spmm's measurements (``coo_spmm_kernel``)
    and its launches on the main path."""
    r = coo_spmm_kernel(dev, smi)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sparse.coo_spmm.launches = 0
    card = mesh_sequence(dev, oracle=True)
    n_coo = sparse.coo_spmm.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    iters = sum(sum(card["iters"][tag]) for tag in ("a", "b", "c"))
    check(n_coo >= 2 * iters, f"mesh: {n_coo} coo_spmm launches for "
          f"{iters} BiCGStab iterations (two products an iteration)")
    n = card["n"]
    for tag, what in (("a", "DC"), ("b", "DC with the diode"),
                      ("c", f"TR {MESH_STEPS} steps")):
        check(card["ok"][tag], f"mesh (16{tag}) {what}: analyze() failed")
        check(card["method"][tag] == "sparse", f"mesh (16{tag}): solver "
              f"'auto' picked {card['method'][tag]!r} at {n} unknowns")
    check(card["gauss"] == 0, f"mesh: {card['gauss']} lu_solve_gauss calls "
          "on the sparse route")
    check(card["hist"].shape == (MESH_STEPS, n)
          and np.isfinite(card["hist"]).all(), "mesh TR: bad trace")
    check(0.0 < card["v_diode"] < 1.0, f"mesh (16b): the diode's node at "
          f"{card['v_diode']} V")
    say(16, f"random mesh {MESH_NODES} nodes / {MESH_LINKS} links (seed "
        f"{MESH_SEED}), {n} unknowns: netlist built in {card['build_s']:.2f} "
        f"s on the host; solver 'auto' took the sparse route in (a)-(c); "
        "lu_solve_gauss calls 0")
    for tag, what in (("a", "(a) DC"), ("b", "(b) DC + PN_JUNCTION, Newton"),
                      ("c", f"(c) TR {MESH_STEPS} x {MESH_DT:g} s, "
                            f"{MESH_NODES // MESH_CAP_EVERY} capacitors")):
        its = card["iters"][tag]
        say(16, f"{what}: lowering + sparse layout {card['setup'][tag]:.2f} "
            f"s, then analyze() {card['sec'][tag]:.3f} s (CUDA events) on "
            f"{smi}; {len(its)} BiCGStab solves, {sum(its)} iterations "
            f"({', '.join(map(str, its[:25]))}{' ...' if len(its) > 25 else ''})"
            f", {card['bicg_s'][tag]:.3f} s inside BiCGStab, "
            f"{card['bicg_s'][tag] / max(sum(its), 1) * 1e3:.3f} ms an "
            "iteration")
    v_ref, res = card["oracle"]
    v = card["x_a"][:len(v_ref)]
    rel = float(np.max(np.abs(v - v_ref) / np.maximum(np.abs(v_ref), 1e-9)))
    check(rel <= 1e-6, f"mesh (16a) vs the CG oracle: {rel:.3e} > 1e-6")
    say(16, f"(a) vs scipy CG on the rebuilt MNA (its residual {res:.2e}, "
        f"{card['oracle_s']:.1f} s on the host): max rel err {rel:.3e} over "
        f"{len(v)} node voltages")
    host = cpu_run.result()
    k = host["hist"].shape[0]
    for tag, a, b in (("a", card["x_a"], host["x_a"]),
                      ("b", card["x_b"], host["x_b"]),
                      ("c", card["hist"][:k], host["hist"])):
        check(host["ok"][tag] and host["method"][tag] == "sparse",
              f"mesh (16{tag}) on the CPU failed")
        err = float(np.abs(a - b).max() / np.abs(b).max())
        check(err <= TRACE_TOL, f"mesh (16{tag}): card vs CPU {err:.3e} > "
              f"{TRACE_TOL}")
        say(16, f"({tag}){f' steps 1-{k}' if tag == 'c' else ''} card vs the "
            f"port on the CPU: {err:.3e} of max|x| (CPU analyze() "
            f"{host['sec'][tag]:.2f} s, {sum(host['iters'][tag])} "
            "iterations, another process)")
    say(16, f"peak device memory {peak:.0f} MiB on {smi}; coo_spmm "
        f"launches {n_coo} ({iters} BiCGStab iterations), x "
        f"{r['ms']:.4f} ms = {n_coo * r['ms'] / 1e3:.4f} s at the mesh "
        "cell's shape")
    return r, n_coo


def tridiag_part_kernel(dev, smi, lanes=16, n=10 ** 6, reps=20):
    """Phase 17's first part: tridiag_part64 against its plain twin at the
    ladder1e6.dc cell's shape (see the module docstring).  Returns the
    kernel's measurements for the kernels line."""
    g = torch.Generator(device=dev).manual_seed(17)
    f64 = dict(generator=g, device=dev, dtype=torch.float64)
    dl, du = -torch.rand(n, **f64), -torch.rand(n, **f64)
    d = dl.abs() + du.abs() + 0.5 + torch.rand(n, **f64)
    b = torch.randn((lanes, n), **f64)
    fac = tridiag.PartitionFactor(dl, d, du)
    levels, direct = tridiag.part_factor_plain(dl, d, du)
    same = all(torch.equal(u, v) for lk, lp in zip(fac.levels, levels)
               for u, v in zip(lk[1:], lp[1:]))
    same &= all(torch.equal(u, v) for u, v in zip(fac.direct[1:], direct[1:]))
    check(same, "tridiag_part64: the card's factor differs from the twin's")
    x, x2 = fac.solve(b), fac.solve(b)
    plain = tridiag.part_solve_plain(fac.levels, fac.direct, b)
    err = float((x - plain).abs().max())
    check(torch.equal(x, x2), "tridiag_part64: a repeat run is not "
          "bit-identical")
    check(torch.equal(x, plain), f"tridiag_part64 differs from the plain "
          f"twin by {err:.3e}")
    res = float((tridiag.tridiag_matvec(dl, d, du, x) - b).abs().max())
    check(res <= 1e-12 * float(b.abs().max()), f"tridiag_part64: residual "
          f"{res:.3e}")
    twin = lambda: tridiag.part_solve_plain(fac.levels, fac.direct, b)
    t = [time_ms(twin, 3), time_ms(lambda: fac.solve(b), reps),
         time_ms(lambda: fac.solve(b), reps), time_ms(twin, 3)]
    factor_ms = time_ms(lambda: tridiag.PartitionFactor(dl, d, du), reps)
    pcr_ms = time_ms(lambda: tridiag.tridiag_solve(dl, d, du, b), 3)
    # the least bytes of a solve: b read once, x written once, the factor
    # (every level's arrays) read once
    fbytes = 8 * sum(v.numel() for lev in fac.levels for v in lev[1:])
    fbytes += 8 * sum(v.numel() for v in fac.direct[1:])
    nbytes = 8 * 2 * lanes * n + fbytes
    r = {"max_abs_err": err, "ms": (t[1] + t[2]) / 2,
         "plain_ms": (t[0] + t[3]) / 2, "library_ms": None}
    # 12 operations a row and lane: two multiplies and a subtraction in
    # each of the two sweeps of each of the two passes
    r["bound_ms"], r["bound_by"] = bound(nbytes, 12 * lanes * n, FP64_FLOPS)
    say(17, f"tridiag_part64 at (B, n) = ({lanes}, {n}), levels "
        f"{tridiag.part_sizes(n)}: {r['ms']:.4f} ms a solve "
        f"({100 * r['bound_ms'] / r['ms']:.1f} % of its "
        f"{r['bound_ms']:.4f} ms {r['bound_by']} bound, "
        f"{nbytes / 1e6:.1f} MB), factor {factor_ms:.4f} ms, plain twin "
        f"{r['plain_ms']:.4f} ms (P C C P: "
        f"{', '.join(f'{v:.4f}' for v in t)}), PCR (tridiag_solve) "
        f"{pcr_ms:.4f} ms, on {smi}; bit for bit the twin, factor and "
        f"solve; repeat bit-identical; max |T x - b| {res:.3e}")
    return r


def tridiag_part_lanes_kernel(dev, smi, lanes=64, n=10 ** 5, reps=20):
    """Phase 17's second part: tridiag_part64 with one T a lane at the
    mesh100k_l1000.dc cell's band (see the module docstring).  Returns
    the solve's and the factor's ms and the bytes bound's."""
    g = torch.Generator(device=dev).manual_seed(171)
    f64 = dict(generator=g, device=dev, dtype=torch.float64)
    dl, du = -torch.rand((lanes, n), **f64), -torch.rand((lanes, n), **f64)
    d = dl.abs() + du.abs() + 0.5 + torch.rand((lanes, n), **f64)
    # the band's rows of the right side, as the chain preconditioner
    # reads them: rows n + 1 apart
    b = torch.randn((lanes, n + 1), **f64)[:, :n]
    fac = tridiag.PartitionFactor(dl, d, du)
    levels, direct = tridiag.part_factor_plain(dl, d, du)
    same = all(torch.equal(u, v) for lk, lp in zip(fac.levels, levels)
               for u, v in zip(lk[1:], lp[1:]))
    same &= all(torch.equal(u, v) for u, v in zip(fac.direct[1:], direct[1:]))
    check(same, "tridiag_part64 per lane: the card's factor differs from "
          "the twin's")
    x, x2 = fac.solve(b), fac.solve(b)
    plain = tridiag.part_solve_plain(fac.levels, fac.direct, b)
    check(torch.equal(x, x2), "tridiag_part64 per lane: a repeat run is "
          "not bit-identical")
    check(torch.equal(x, plain), "tridiag_part64 per lane differs from the "
          f"plain twin by {float((x - plain).abs().max()):.3e}")
    bk = torch.randn((2 * lanes, n), **f64)
    check(torch.equal(fac.solve(bk), tridiag.part_solve_plain(
        fac.levels, fac.direct, bk)), "tridiag_part64 per lane, two right "
        "sides a lane: differs from the twin")
    one = [v[:1].expand(lanes, n).contiguous() for v in (dl, d, du)]
    shared = tridiag.PartitionFactor(dl[0], d[0], du[0])
    check(torch.equal(tridiag.PartitionFactor(*one).solve(b),
                      shared.solve(b.contiguous())),
          "tridiag_part64: a factor of equal lanes differs from the shared "
          "one")
    res = float((tridiag.tridiag_matvec(dl, d, du, x) - b).abs().max())
    check(res <= 1e-12 * float(b.abs().max()), "tridiag_part64 per lane: "
          f"residual {res:.3e}")
    pcr = tridiag.PCRFactor(dl, d, du)
    t = [time_ms(lambda: pcr.solve(b), reps),
         time_ms(lambda: fac.solve(b), reps),
         time_ms(lambda: fac.solve(b), reps),
         time_ms(lambda: pcr.solve(b), reps)]
    dense_ms = time_ms(lambda: fac.solve(b.contiguous()), reps)
    del pcr
    factor_ms = time_ms(lambda: tridiag.PartitionFactor(dl, d, du), reps)
    # the least bytes of a solve: b read once, x written once, every
    # level's factor once
    fbytes = 8 * sum(v.numel() for lev in fac.levels for v in lev[1:])
    fbytes += 8 * sum(v.numel() for v in fac.direct[1:])
    nbytes = 8 * 2 * lanes * n + fbytes
    ms = (t[1] + t[2]) / 2
    bound_ms, by = bound(nbytes, 12 * lanes * n, FP64_FLOPS)
    say(17, f"tridiag_part64 per lane at (B, n) = ({lanes}, {n}), levels "
        f"{tridiag.part_sizes(n)}, b's rows {n + 1} apart: {ms:.4f} ms a "
        f"solve ({bound_ms / ms * 100:.1f} % of its {bound_ms:.4f} ms {by} "
        f"bound, {nbytes / 1e6:.1f} MB), {dense_ms:.4f} ms with b "
        f"contiguous and its copy, factor {factor_ms:.4f} ms; "
        f"PCRFactor.solve {(t[0] + t[3]) / 2:.4f} ms (P C C P: "
        f"{', '.join(f'{v:.4f}' for v in t)}), on {smi}; bit for bit the "
        "twin, factor and solve, at one and two right sides a lane; "
        "repeat bit-identical; equal lanes bit for bit the shared kernel; "
        f"max |T x - b| {res:.3e}")
    return {"ms": ms, "factor_ms": factor_ms, "bound_ms": bound_ms,
            "pcr_ms": (t[0] + t[3]) / 2}


def phase17_ladder(dev, smi):
    """The 10^6-resistor ladder (see the module docstring, phase 17).
    Returns the kernel's measurements and its launches in the ladder."""
    r17 = tridiag_part_kernel(dev, smi)
    tridiag_part_lanes_kernel(dev, smi)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = tridiag.tridiag_part64.launches
    r = workloads.ladder_dc(10 ** 6, device=dev)
    launched = tridiag.tridiag_part64.launches - before
    check(launched > 0, "the 10^6 ladder never launched tridiag_part64")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    V = workloads.LADDER_V
    check(r["max_ramp_err"] < r["tol"] * V, f"10^6 ladder: ramp error "
          f"{r['max_ramp_err']:.3e} >= {r['tol']} V")
    check(r["i_err"] < 1e-9 + r["tol"] * r["i_exp"], f"10^6 ladder: source "
          f"current {r['i_src']:.9e}, expected {-r['i_exp']:.9e}")
    best = min(r["solve_s"])
    say(17, f"10^6-resistor ladder (1000000xR.cpp): netlist + IR "
        f"{r['build_s']:.2f} s, assemble_sparse on the card + fetch "
        f"{r['assemble_s'] * 1e3:.1f} ms, host extraction "
        f"{r['extract_s'] * 1e3:.1f} ms; border_solve (refine 4) "
        f"{best * 1e3:.2f} ms a solve (best of {len(r['solve_s'])}: "
        f"{', '.join(f'{s * 1e3:.2f}' for s in r['solve_s'])} ms), "
        f"{1.0 / best:.2f} solves/s on {smi}; max ramp error "
        f"{r['max_ramp_err']:.3e} V (gate {r['tol'] * V:.1e}), source "
        f"current {r['i_src']:.9e} A; peak device memory {peak:.0f} MiB; "
        f"tridiag_part64 launches {launched}")
    say_idle(17, "border_solve", r["again"], best)
    return r17, launched


def say_idle(phase, what, fn, wall_s):
    """One more call of ``fn`` under torch.profiler: its device operations
    and device time beside ``wall_s``, the call's wall without the
    profiler, and the device's idle share of that wall."""
    n_ops, dev_ms = device_ops(fn)
    idle = (f"idle {100 * (1 - dev_ms / (wall_s * 1e3)):.1f} % of the "
            f"{wall_s * 1e3:.2f} ms wall" if dev_ms else
            "idle share not measured (no device time in the trace)")
    say(phase, f"{what}: {n_ops} device operations, {dev_ms:.3f} ms of "
        f"device time a call (torch.profiler); {idle}")


def phase18_ladder(dev, smi):
    """The 10^8-resistor ladder (see the module docstring, phase 18)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r = workloads.ladder_direct(10 ** 8, chunks=512, nbatch=4, refine=1,
                                device=dev)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    V = workloads.LADDER_V
    check(r["max_ramp_err"] < r["tol"] * V, f"10^8 ladder: sampled ramp "
          f"error {r['max_ramp_err']:.3e} >= {r['tol'] * V:.3e} V")
    check(r["i_err"] < 1e-9 + r["tol"] * r["i_exp"], f"10^8 ladder: source "
          f"current {r['i_src']:.9e}, expected {-r['i_exp']:.9e}")
    best = min(r["solve_s"])
    say(18, f"10^8-resistor ladder (100000000xR.cpp), SPIKE 512 chunks, "
        f"nbatch 4, refine 1: host pivots {r['pivots_s']:.2f} s, factor "
        f"{r['factor_s']:.2f} s (pivots included); {best * 1e3:.1f} ms a "
        f"solve (best of {len(r['solve_s'])}: "
        f"{', '.join(f'{s * 1e3:.1f}' for s in r['solve_s'])} ms) on {smi}; "
        f"ramp at nodes 0, N/2, N-1 {r['v_sampled'].tolist()}, max error "
        f"{r['max_ramp_err']:.3e} V (gate {r['tol'] * V:.2e}); source "
        f"current {r['i_src']:.9e} A; peak device memory {peak:.2f} GiB")
    say_idle(18, "a SPIKE bordered solve", r["again"], best)


def splu_cases(links_cases, n=MESH_NODES):
    """bench_sparse.py's host denominator for each L: scipy SparseLU, one
    factor + solve at L = 10^4 (~200 s: fill-in), three below."""
    out = {}
    for links in links_cases:
        rows, cols, vals, z = workloads.sparse_mesh_coo(n, links)
        out[links] = workloads.sparse_mesh_splu(
            rows, cols, vals, z, solves=1 if links >= 10_000 else 3)
    return out


def phase19_sparse_mesh(dev, smi, splu_run, links_cases=(10_000, 1_000)):
    """bench_sparse.py on the card (see the module docstring, phase 19)."""
    results = {}
    for links in links_cases:
        rows, cols, vals, z = workloads.sparse_mesh_coo(MESH_NODES, links)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = workloads.sparse_mesh_solve(rows, cols, vals, z, device=dev)
        r["total_s"] = time.perf_counter() - t0
        r["peak"] = torch.cuda.max_memory_allocated() / 2 ** 20
        results[links] = r
        if links >= 10_000:
            check(r["ok"], f"mesh L={links}: bicgstab_ell did not converge "
                  f"({r['iters']} iterations)")
    splu = splu_run.result()
    for links in links_cases:
        r = results[links]
        ts, x_lu, scale = splu[links]
        lu_sps = 1.0 / (sum(ts) / len(ts))
        head = (f"mesh {MESH_NODES} nodes + {links} links, nnz "
                f"{len(workloads.sparse_mesh_coo(MESH_NODES, links)[0])}: ")
        if not r["ok"]:
            say(19, head + f"bicgstab not converged in cap ({r['iters']} "
                f"iterations, max_iter 20000 a pass; the JAX package does "
                f"not converge here either), {r['total_s']:.2f} s; scipy "
                f"SparseLU {lu_sps:.3f} solves/s on the host (another "
                f"process)")
            continue
        x = r["x"] / r["scale"]
        ref = x_lu / scale
        rel = float(np.abs(x - ref).max() / np.abs(ref).max())
        check(rel <= 1e-6, f"mesh L={links}: vs scipy SparseLU {rel:.3e} "
              "> 1e-6")
        sps = 1.0 / (sum(r["solve_s"]) / len(r["solve_s"]))
        say(19, head + f"bicgstab_ell {sps:.3f} solves/s ("
            f"{', '.join(f'{s * 1e3:.1f}' for s in r['solve_s'])} ms), "
            f"{r['iters']} iterations, "
            f"{sum(r['solve_s']) / len(r['solve_s']) / r['iters'] * 1e3:.3f}"
            f" ms an iteration, on {smi}; rel err vs scipy SparseLU "
            f"{rel:.3e}; SparseLU {lu_sps:.4f} solves/s on the host "
            f"(another process); peak device memory {r['peak']:.0f} MiB")
        say_idle(19, f"L={links} bicgstab_ell", r["again"], min(r["solve_s"]))


def large_systems(dev, smi):
    """Phases 16-19.  The CPU references run beside them in processes of
    their own — phase 16's sequence on the CPU and phase 19's scipy
    SparseLU (minutes at L = 10^4) — which a failure terminates.  Returns
    {kernel: (measurements, launches)} of phases 16 and 17."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(2, mp_context=mp.get_context("spawn"))
    try:
        cpu_run = pool.submit(mesh_sequence, "cpu", MESH_CPU_STEPS)
        splu_run = pool.submit(splu_cases, (10_000, 1_000))
        kernels = {}
        for phase, fn, args in ((16, phase16_mesh, (dev, smi, cpu_run)),
                                (17, phase17_ladder, (dev, smi)),
                                (18, phase18_ladder, (dev, smi)),
                                (19, phase19_sparse_mesh,
                                 (dev, smi, splu_run))):
            t0 = time.perf_counter()
            out = fn(*args)
            if phase in (16, 17):
                kernels[(COO, TPART)[phase - 16]["name"]] = out
            say(phase, f"phase {phase} took {time.perf_counter() - t0:.1f} s")
        return kernels
    except BaseException:
        for proc in list((pool._processes or {}).values()):
            proc.terminate()
        raise
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def main():
    # phase 0: device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); the port has no CPU fallback here")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    say(0, f"{kind}, {torch.cuda.device_count()} device(s); nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 1: build the kernels from the checkout's sources
    fresh = not _build.library_path().is_file()
    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    say(1, f"{'built' if fresh else 'reused'} {so.name} from "
        f"{', '.join(_build.SOURCES)}: {time.perf_counter() - t0:.2f} s")
    for line in (Path(str(so) + ".ptxas.txt").read_text().splitlines()
                 if fresh else []):
        if "Compiling entry" in line or "registers" in line:
            say(1, line.strip())

    # phase 2: each kernel against its plain version; solve_batched
    results = phase2_kernels(dev)
    launches_sb = phase2_solve_batched(dev, smi)

    # phases 3-4: small ladder, card against CPU, then the card again
    ir = workloads.build_diode_ladder(63)
    params = batch_params(ir, 6, jitter={"R": {"r": workloads.R_JITTER}},
                          generator=torch.Generator().manual_seed(3))
    for inv in analog.FROZEN_INVERSES:
        x_c, ok_c, tr_c = ladder_run(ir, params, 6, 25, "cpu", inv)
        x_g, ok_g, tr_g = ladder_run(ir, params, 6, 25, dev, inv)
        check(bool(ok_c.all()) and bool(ok_g.all()),
              f"small ladder (inv={inv}): a lane failed")
        rel = float((tr_g.cpu() - tr_c).abs().max() / tr_c.abs().max())
        check(rel <= TRACE_TOL, f"small ladder (inv={inv}) card vs CPU "
              f"{rel:.3e} > {TRACE_TOL}")
        say(3, f"63-stage ladder B=6 25 steps, inv={inv}: card vs CPU trace "
            f"rel err {rel:.3e}")
        x_g2, ok_g2, tr_g2 = ladder_run(ir, params, 6, 25, dev, inv)
        check(torch.equal(x_g, x_g2) and torch.equal(tr_g, tr_g2),
              f"repeated card run (inv={inv}) is not bit-identical")
        say(4, f"inv={inv}: repeated card run bit-identical")

    # phase 5: the main path at full width
    x5, launches = frozen_path(5, dev, smi, "gj",
                               launched=("gj_inverse32", "gj_solve32"),
                               idle=("lu_block_inverse32",),
                               results=results)

    # solve_batched's launches of gj_solve32 (phase 2) count with phase 5's
    launches["gj_solve32"] += launches_sb

    # the RV32 core, synthesized once for phases 6-8
    t0 = time.perf_counter()
    rv32 = workloads.build_rv32(device=dev)
    say(6, f"RV32 synthesized at -O1: {rv32.gates} gates + FFs, "
        f"{time.perf_counter() - t0:.1f} s on the host")

    # phase 6: the turbo kernel against its plain version
    results[TURBO["name"]] = phase6_turbo(dev, rv32)

    # phase 7: the digital main path, one instance
    cycles = 200
    ticks = 4 + 2 * cycles
    workloads.rv32_run(1, 2, design=rv32)                        # warm-up
    torch.cuda.synchronize()
    turbo.run_turbo.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res, done = workloads.rv32_run(1, cycles, design=rv32)
    end.record()
    torch.cuda.synchronize()
    launches[TURBO["name"]] = turbo.run_turbo.launches
    sec = start.elapsed_time(end) / 1e3
    check(launches[TURBO["name"]] > 0, "digital main path never launched "
          "the turbo kernel")
    check(int(res[0]) == rv32.expect and int(done[0]) == 1,
          f"RV32 result {int(res[0])} done {int(done[0])}, expected "
          f"{rv32.expect} and 1")
    say(7, f"RV32 Circuit.digital_run {ticks} ticks: result {int(res[0])}, "
        f"done {int(done[0])}; wall {sec * 1e3:.1f} ms, "
        f"{rv32.gates * ticks / sec:.4e} gate-evals/s on {smi}; turbo "
        f"launches {launches[TURBO['name']]}")
    k_ms, b_ms = turbo_kernel_ms(dev, rv32, 1, ticks)
    say(7, f"the kernel alone, B=1 x {ticks} ticks, full history: "
        f"{k_ms:.3f} ms ({k_ms / ticks * 1e3:.2f} us per tick), "
        f"{100 * k_ms / (sec * 1e3):.1f} % of the wall above; bound "
        f"{b_ms:.4f} ms ({100 * b_ms / k_ms:.2f} % of it)")
    o1 = {"wall_ms": sec * 1e3, "kernel_ms": k_ms}           # for phase 20

    # phase 8: 128 instances through digital_run_batch
    B = 128
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    turbo.run_turbo.launches = 0
    start.record()
    res, done = workloads.rv32_run(B, cycles, design=rv32)
    end.record()
    torch.cuda.synchronize()
    sec = start.elapsed_time(end) / 1e3
    n8 = turbo.run_turbo.launches
    check(n8 > 0, "batched path never launched the turbo kernel")
    check(res.shape == (B,) and bool((res == rv32.expect).all())
          and bool((done == 1).all()),
          f"batched RV32: {int((res != rv32.expect).sum())} of {B} "
          "instances did not end with the expected result")
    say(8, f"RV32 digital_run_batch B={B} x {2 * cycles} ticks (+4 reset "
        f"ticks): all {B} results {rv32.expect}; wall {sec * 1e3:.1f} ms, "
        f"aggregate {rv32.gates * (B * 2 * cycles + 4) / sec:.4e} "
        f"gate-evals/s on {smi}; turbo launches {n8}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    watch = rv32_watch(rv32)
    k_ms, b_ms = turbo_kernel_ms(dev, rv32, B, ticks, watch)
    say(8, f"the kernel alone, B={B} x {ticks} ticks, watching "
        f"{len(watch)} signals: {k_ms:.3f} ms "
        f"({k_ms / ticks * 1e3:.2f} us per tick), "
        f"{rv32.gates * B * ticks / (k_ms / 1e3):.4e} gate-evals/s; bound "
        f"{b_ms:.4f} ms ({100 * b_ms / k_ms:.2f} % of it)")

    # phase 9: the main path with the blocked refactor
    name = "lu_block_inverse32"
    x9, launches9 = frozen_path(9, dev, smi, "block", launched=(name,),
                                idle=("gj_inverse32",), results=results)
    launches[name] = launches9[name]
    rel9 = float((x9 - x5).abs().max() / x5.abs().max())
    check(rel9 <= TRACE_TOL, f"block path final x vs phase 5's {rel9:.3e} "
          f"> {TRACE_TOL}")
    say(9, f"final x vs phase 5's (inv=gj): rel err {rel9:.3e}")

    # phase 10: the frozen transient past 1024 unknowns, both refactors
    phase10_past_1024(dev, smi)

    # phase 11: the analog Circuit driver at the ladder's full width
    t0 = time.perf_counter()
    p11 = phase11_circuit(dev, smi)
    say(11, f"phase 11 took {time.perf_counter() - t0:.1f} s")

    # phase 12: the BSIM3 inverter chain, and the Circuit path on it
    t0 = time.perf_counter()
    launches12 = phase12_bsim3(dev, smi, results)
    for name, count in launches12.items():
        launches[name + AT128] = count
    say(12, f"phase 12 took {time.perf_counter() - t0:.1f} s")

    # phases 13-15: the levelled tick, mixed signal, the flash engine
    for phase, fn, args in ((13, phase13_levels, (dev, smi, rv32)),
                            (14, phase14_mixed, (dev, smi)),
                            (15, phase15_flash, (dev, smi, rv32))):
        t0 = time.perf_counter()
        fn(*args)
        say(phase, f"phase {phase} took {time.perf_counter() - t0:.1f} s")

    # phase 20: synthesis at -O2 and above, and the host sweep engine
    t0 = time.perf_counter()
    n20, err20, p20 = phase20_synth(dev, smi, rv32, o1)
    launches[TURBO["name"]] += n20
    results[TURBO["name"]]["max_abs_err"] = max(
        results[TURBO["name"]]["max_abs_err"], err20)
    say(20, f"phase 20 took {time.perf_counter() - t0:.1f} s")

    # phase 21: the user surfaces and persistence
    t0 = time.perf_counter()
    launches[TURBO["name"]] += phase21_surfaces(dev, smi, p20)
    say(21, f"phase 21 took {time.perf_counter() - t0:.1f} s")

    # phase 22: the mesh paths at world size 1 (NCCL)
    t0 = time.perf_counter()
    n22 = phase22_mesh(dev, smi, rv32, p11, p20)
    for name, count in n22.items():
        launches[name] += count
    say(22, f"phase 22 took {time.perf_counter() - t0:.1f} s")

    # phases 16-19: large systems.  The CPU references run beside them in
    # processes of their own: phase 16's sequence on the CPU and phase
    # 19's scipy SparseLU (minutes at L = 10^4)
    for name, (r, count) in large_systems(dev, smi).items():
        results[name], launches[name] = r, count

    print(smi)
    meta = {k: dict(source=v["source"], replaces=v["replaces"])
            for k, v in KERNELS.items()}
    for name in launches12:
        meta[name + AT128] = meta[name]
    for k in (TURBO, COO, TPART):
        meta[k["name"]] = dict(source=k["source"], replaces=k["replaces"])
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": meta[name]["source"],
         "replaces": meta[name]["replaces"], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in results.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
