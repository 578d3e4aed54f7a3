"""The mesh cases of ``tests/test_torch_parallel.py``, run as the ranks of
a gloo world; this module imports only the port (and numpy).

    python tests/torch_mesh_cases.py RANK WORLD STORE OUTDIR

Every rank runs every case on ``make_mesh(device_type="cpu")`` (a 2 x 2
("batch", "sweep") mesh at four ranks) and rank 0 writes each case's
arrays to ``OUTDIR/<case>.npz``; the tests compare them with the port's
local runs and the JAX package's.  The circuit descriptions, designs,
schedules and systems are built here from seeds, and the tests build the
other side from the same functions.
"""

import sys
import time
from importlib import import_module
from pathlib import Path

import numpy as np
import torch

NB = 128


# ---------------------------------------------------------------------------
# inputs shared with the tests (numpy, seeded)
# ---------------------------------------------------------------------------

def rand_system(B, n, seed=0, cond_boost=0.0):
    """tests/test_dist_gj.py's random diagonally boosted systems."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    A += (np.sqrt(n) * 4) * np.eye(n)
    if cond_boost:
        A *= np.exp(rng.uniform(-cond_boost, cond_boost, (B, n, 1)))
        A *= np.exp(rng.uniform(-cond_boost, cond_boost, (B, 1, n)))
    return A, rng.standard_normal((B, n))


def zero_leading_panel(n, seed=11):
    """test_dist_gj's structurally zero leading panel, A = [[0, I], [I, G]]
    with n / 2 voltage-source rows and their branch currents first (the
    whole of panel 0 at n = 256, its test's size) and mixed row scales."""
    kv = nn = n // 2
    rng = np.random.default_rng(seed)
    q1, _ = np.linalg.qr(rng.standard_normal((nn, nn)))
    G = (q1 * np.logspace(0, -8, nn)) @ q1.T
    A = np.zeros((n, n))
    A[:kv, kv:] = np.eye(kv)
    A[kv:, :kv] = np.eye(kv)
    A[kv:, kv:] = G
    dr = np.logspace(-6, 6, n)
    rng.shuffle(dr)
    return (A * dr[:, None])[None], (rng.standard_normal(n) * dr)[None]


def sparse_system(n, seed=0):
    """A random sparse diagonally dominant system (2 % fill)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.02)
    return A + 30.0 * np.eye(n), rng.standard_normal(n)


def relerr(x, A, b):
    """test_dist_gj's measure against numpy's f64 solve."""
    xref = np.linalg.solve(A, b[..., None])[..., 0]
    return np.max(np.abs(np.asarray(x) - xref) / (1 + np.abs(xref)))


def r_ladder(n=512, seed=2):
    """test_parallel's tensor-parallel ladder: VDC 8 V, n - 1 random
    resistors in series, 100 Ohm to ground."""
    rs = np.random.default_rng(seed).uniform(50, 500, n - 1)
    spec = [("v", "VDC", {"V": 8.0}, ("n0", "0"))]
    spec += [(f"r{k}", "RESISTANCE", {"r": float(r)}, (f"n{k}", f"n{k + 1}"))
             for k, r in enumerate(rs)]
    return spec + [("rl", "RESISTANCE", {"r": 100.0}, (f"n{n - 1}", "0"))]


def diode_chain(n=120, seed=5):
    """test_dist_gj's autoroute circuit: an R chain with a diode to
    ground at every 17th node."""
    rng = np.random.default_rng(seed)
    spec = [("v", "VDC", {"V": 2.5}, ("n0", "0"))]
    spec += [(f"r{i}", "RESISTANCE", {"r": float(rng.uniform(30, 300))},
              (f"n{i}", f"n{i + 1}")) for i in range(n - 1)]
    spec += [(f"d{i}", "PN_JUNCTION", {}, (f"n{i}", "0"))
             for i in range(0, n, 17)]
    return spec


def rc_diode_ladder():
    """test_dist_gj's transient circuit: 12 RC stages, a diode on every
    third (its test runs 20 steps of 0.1 us; the mesh case runs 10)."""
    spec = [("v", "VDC", {"V": 3.0}, ("n0", "0"))]
    for k in range(12):
        spec += [(f"r{k}", "RESISTANCE", {"r": 1e3}, (f"n{k}", f"n{k + 1}")),
                 (f"c{k}", "CAPACITOR", {"C": 1e-9}, (f"n{k + 1}", "0"))]
        if k % 3 == 0:
            spec.append((f"d{k}", "PN_JUNCTION", {}, (f"n{k + 1}", "0")))
    return spec


def rc_corner():
    """test_parallel's cooperative AC circuit: RC low-pass, corner at
    omega = 1e3."""
    return [("v", "VAC", {"Vp": 1.0, "freq": 1e3}, ("top", "0")),
            ("r", "RESISTANCE", {"r": 1e3}, ("top", "out")),
            ("c", "CAPACITOR", {"C": 1e-6}, ("out", "0"))]


def rc_divider():
    """test_sharded_sweeps_match_local's AC circuit."""
    return [("v", "VAC", {"Vp": 1.0, "phase": 0.0}, ("top", "0")),
            ("r", "RESISTANCE", {"r": 1e3}, ("top", "out")),
            ("r2", "RESISTANCE", {"r": 2e3}, ("out", "0")),
            ("c", "CAPACITOR", {"C": 1e-9}, ("out", "0"))]


def diode_sweep():
    """test_sharded_sweeps_match_local's DC / temperature / MC circuit."""
    return [("v", "VDC", {"V": 2.0}, ("top", "0")),
            ("r", "RESISTANCE", {"r": 1e3}, ("top", "out")),
            ("d", "PN_JUNCTION", {}, ("out", "0"))]


SWEEP_VALS = np.linspace(0.5, 3.0, 11)        # 11 lanes over 4 ranks: pads
SWEEP_TEMPS = np.array([-40.0, 27.0, 125.0])  # 3 lanes: pads
MC_LANES = 16
AC_POINTS = 13                                # pads to 16

COUNTER = """
module counter(input clk, input rst_n, input en, output reg [3:0] q);
  always @(posedge clk or negedge rst_n)
    if (!rst_n) q <= 4'd0; else if (en) q <= q + 4'd1;
endmodule
"""

LATCH = """
module lmix(input en, input [3:0] d, input clk, input rst_n,
            output [3:0] y, output reg [3:0] r);
  reg [3:0] q;
  always @* if (en) q = d;            // inferred latch -> ir.cyclic
  assign y = q ^ {q[2:0], q[3]};
  always @(posedge clk or negedge rst_n)
    if (!rst_n) r <= 4'd0; else r <= q + r;
endmodule
"""


def synth(pe, src, top, inputs, **circuit_kw):
    """``src`` at -O1 in package ``pe`` as the JAX tests build it: one net
    per port bit, an INPUT per bit of ``inputs`` in that order.  Returns
    (circuit, {name: [INPUT]}, {port: [net]})."""
    v = import_module(pe.__name__ + ".verilog")
    sy = import_module(pe.__name__ + ".verilog.synth")
    design = v.build_design(v.compile_source(src))
    topm = v.find_module(design, top)
    inst = v.elaborate(design, topm)
    c = pe.Circuit(**circuit_kw)
    nl = c.nl
    pn = {p: [pe.netops.create_node(nl)
              for _ in range(inst.signals[p].width)] for p in topm.ports}
    ms = {}
    for name in inputs:
        ms[name] = []
        for node in pn[name]:
            m = pe.netops.add_model(nl, pe.models.INPUT, {"boolean": 0.0})
            pe.netops.add_to_node(nl, m, 0, node)
            ms[name].append(m)
    sy.synthesize_to_netlist(nl, design, inst, pn, sy.SynthOptions(
        opt_level=1))
    return c, ms, pn


def counter_schedules(ms, B=8, cyc=9, seed=21):
    """test_digital_batch_flash_sharded's enable schedules."""
    en = np.random.default_rng(seed).integers(0, 2, (B, cyc))
    clk, rst, e_ = ms["clk"][0], ms["rst_n"][0], ms["en"][0]
    out = []
    for b in range(B):
        s = [{}, {clk: 1}, {clk: 0}, {rst: 1}]
        for k in range(cyc):
            e = int(en[b, k])
            s += [{clk: 1, rst: 1, e_: e}, {clk: 0, rst: 1, e_: e}]
        out.append(s)
    return out


def latch_schedules(ms, B=4, cyc=6, seed=31):
    """test_digital_batch_flash_cyclic_latch's schedules (tick 0 all X)."""
    rng = np.random.default_rng(seed)
    dat = rng.integers(0, 16, (B, 3 * cyc))
    ens = rng.integers(0, 2, (B, 3 * cyc))
    clk, rst, en = ms["clk"][0], ms["rst_n"][0], ms["en"][0]
    out = []
    for b in range(B):
        s = [{}, {clk: 1}, {clk: 0}, {rst: 1}]
        for k in range(3 * cyc):
            e, dv = int(ens[b, k]), int(dat[b, k])
            lo = {clk: 0, rst: 1, en: e}
            hi = {clk: 1, rst: 1, en: e}
            for i in range(4):
                lo[ms["d"][i]] = hi[ms["d"][i]] = (dv >> i) & 1
            s += [lo, hi]
        out.append(s)
    return out


def random_graph(seed=5, n_leaf=6, n_gate=150, W=37):
    """A random topological gate graph and leaf words (test_parallel's
    test_tt_eval_mesh_bit_exact draws)."""
    from phy_engine_tpu_torch.native import (OP_AND, OP_CONST0, OP_CONST1,
                                             OP_NOT, OP_OR, OP_XOR)
    rng = np.random.default_rng(seed)
    n = n_leaf + n_gate
    op = np.zeros(n, np.int32)
    f0 = np.zeros(n, np.int32)
    f1 = np.zeros(n, np.int32)
    for g in range(n_leaf, n):
        op[g] = rng.choice([OP_NOT, OP_AND, OP_OR, OP_XOR, OP_CONST0,
                            OP_CONST1])
        f0[g] = rng.integers(0, g)
        f1[g] = rng.integers(0, g)
    words = np.zeros((n, W), np.uint64)
    words[:n_leaf] = rng.integers(0, 2 ** 64, (n_leaf, W), dtype=np.uint64)
    return op, f0, f1, words


def xor_graphs(og, nets, out_net):
    """test_graphs_equivalent_mesh_deep_verify's three graphs over 20
    leaves: an XOR reduction, its SOP form, and the XOR form with one
    gate flipped."""
    def build(xor_form, flip=False):
        g = og.GateGraph()
        leaves = [g.leaf(n) for n in nets]
        mixed = []
        for a, b in zip(leaves[::2], leaves[1::2]):
            if xor_form:
                mixed.append(g.gate("XOR", a, b))
            else:
                na, nb = g.gate("NOT", a), g.gate("NOT", b)
                mixed.append(g.gate("OR", g.gate("AND", a, nb),
                                    g.gate("AND", na, b)))
        acc = mixed[0]
        for m in mixed[1:]:
            acc = g.gate("OR" if not flip or m is not mixed[-1] else "AND",
                         acc, m)
        g.set_output(out_net, acc)
        return g
    return build(True), build(False), build(True, flip=True)


# ---------------------------------------------------------------------------
# the cases (run on every rank; rank 0's return value is saved)
# ---------------------------------------------------------------------------

def case_dist_solve(mesh):
    from phy_engine_tpu_torch.parallel.dist_gj import (
        dist_solve, make_dist_delta_solver)
    out = {}
    A, b = rand_system(2, 4 * NB, seed=1)
    out["rand"] = dist_solve(mesh, A, b, refine=2).numpy()
    A, b = zero_leading_panel(4 * NB)
    out["leading"] = dist_solve(mesh, A, b, refine=2).numpy()
    # eight panels over four ranks: two panels a rank, block-cyclic
    A, b = rand_system(1, 8 * NB, seed=6)
    out["cyclic"] = dist_solve(mesh, A, b, refine=2).numpy()
    A, b = sparse_system(8 * NB)
    rows, cols = np.nonzero(A)
    solver = make_dist_delta_solver(mesh, 8 * NB, 8 * NB)
    x, rel = solver(torch.as_tensor(rows), torch.as_tensor(cols),
                    torch.as_tensor(A[rows, cols]), torch.as_tensor(b))
    out["delta"], out["delta_rel"] = x.numpy(), rel.numpy()
    return out


def case_tp_assembly(mesh):
    from phy_engine_tpu_torch import workloads
    from phy_engine_tpu_torch.engine.lower import lower_analog
    from phy_engine_tpu_torch.parallel.mesh import tp_assemble_sparse
    ir = lower_analog(workloads.r_ladder_netlist(
        1001, np.random.default_rng(5).uniform(50, 150, 1001)))
    rows, cols, vals, Z = tp_assemble_sparse(
        ir, mesh, {f.mdef.id_name: f.P for f in ir.families},
        np.zeros(ir.n_unknowns),
        {f.mdef.id_name: f.state0 for f in ir.families},
        workloads.default_env())
    return dict(rows=rows.numpy(), cols=cols.numpy(), vals=vals.numpy(),
                Z=Z.numpy())


def case_tp_solve_op(mesh):
    from torch_circuits import build_port
    from phy_engine_tpu_torch.engine import analog
    from phy_engine_tpu_torch.parallel.mesh import tp_solve_op
    b = build_port(r_ladder(), "cpu", solver="dense")
    ir = b.c.prepare()
    x, _st, ok = tp_solve_op(ir, mesh, b.c._params(),
                             analog.initial_x(ir, "cpu"),
                             analog.initial_state(ir, "cpu"),
                             b.c._env_scalars())
    return dict(x=x.numpy(), ok=np.array(ok))


def case_sharded_transients(mesh):
    from phy_engine_tpu_torch import workloads
    from phy_engine_tpu_torch.engine.lower import lower_analog
    from phy_engine_tpu_torch.parallel.batch import (batch_params,
                                                     batch_state, batch_x)
    from phy_engine_tpu_torch.parallel.mesh import (
        gather_rows, sharded_batched_transient,
        sharded_batched_transient_shmap)
    ir = lower_analog(workloads.rectifier_netlist())
    env = workloads.default_env()
    B = 16
    params = batch_params(ir, B, jitter={"R": {"r": 0.05}},
                          generator=torch.Generator().manual_seed(7),
                          device="cpu")
    out = {f"p_{k}": v.numpy() for k, v in params.items()}
    for name, fn in (("plain", sharded_batched_transient),
                     ("shmap", sharded_batched_transient_shmap)):
        x, _st, ok = fn(ir, mesh, params, batch_x(ir, B, "cpu"),
                        batch_state(ir, B, "cpu"), env, 0.0, 1e-6, 2)
        out[f"{name}_rows"] = gather_rows(torch.tensor([x.shape[0]]),
                                          mesh).numpy()
        out[f"{name}_x"] = gather_rows(x, mesh).numpy()
        out[f"{name}_ok"] = np.array(ok)
    return out


def case_circuit_mesh(mesh):
    from torch_circuits import build_port
    out = {}
    b = build_port(diode_chain(), "cpu", mesh=mesh)
    b.c.set_analyze_type(b.mod.AnalyzeType.OP)
    out["op_ok"] = np.array(b.c.analyze())
    out["op_x"] = b.c._x.numpy()
    # the stored state feeds a follow-up analysis (adaptive TR stays on
    # the rank)
    b.c.set_analyze_type(b.mod.AnalyzeType.TR)
    b.c.tr.t_stop, b.c.tr.t_step, b.c.tr.adaptive = 1e-7, 1e-8, True
    out["op_then_tr_ok"] = np.array(b.c.analyze())
    b = build_port(rc_diode_ladder(), "cpu", mesh=mesh)
    b.c.tr.t_stop, b.c.tr.t_step = 1e-6, 1e-7
    b.c.set_analyze_type(b.mod.AnalyzeType.TR)
    out["tr_ok"] = np.array(b.c.analyze())
    out["tr_hist"] = b.c.tr_history
    out["tr_duration"] = np.array(b.c.tr_duration)
    b = build_port(rc_corner(), "cpu", mesh=mesh)
    b.c.set_analyze_type(b.mod.AnalyzeType.ACOP)
    b.c.ac.sweep = b.mod.ACSweepType.SINGLE
    b.c.ac.omega = 1.0 / (1e3 * 1e-6)
    out["acop_ok"] = np.array(b.c.analyze())
    out["acop_x"] = b.c.ac_sweep_results[0][1]
    return out


def sweep_runs(c, v, out, mesh=None):
    """The four sweeps of test_sharded_sweeps_match_local on ``c`` (the
    AC one on its own circuit); returns {name: array}."""
    res = {"dc": c.dc_sweep(v, "V", SWEEP_VALS, out=out, mesh=mesh),
           "temp": c.temp_sweep(SWEEP_TEMPS, out=out, mesh=mesh),
           "mc": c.monte_carlo({"R": {"r": 0.1}}, n=MC_LANES,
                               generator=torch.Generator().manual_seed(0),
                               mesh=mesh)}
    arrs = {}
    for k, r in res.items():
        arrs[f"{k}_x"] = r.x
        arrs[f"{k}_ok"] = r.ok
    return arrs


def ac_grid_run(mesh=None):
    from torch_circuits import build_port
    b = build_port(rc_divider(), "cpu", mesh=mesh)
    b.c.ac.sweep = b.mod.ACSweepType.LOG
    b.c.ac.omega_start, b.c.ac.omega_stop = 1e3, 1e8
    b.c.ac.points = AC_POINTS
    b.c.set_analyze_type(b.mod.AnalyzeType.AC)
    ok = b.c.analyze()
    return (np.array(ok), np.array([w for w, _x in b.c.ac_sweep_results]),
            np.stack([x for _w, x in b.c.ac_sweep_results]))


def case_sweeps(mesh):
    from torch_circuits import build_port
    b = build_port(diode_sweep(), "cpu")
    out = sweep_runs(b.c, b.devs["v"], b.nodes["out"], mesh)
    out["ac_ok"], out["ac_w"], out["ac_x"] = ac_grid_run(mesh)
    return out


def case_digital(mesh):
    import phy_engine_tpu_torch as tpe
    c, ms, pn = synth(tpe, COUNTER, "counter", ("clk", "rst_n", "en"),
                      device="cpu")
    counter = c.digital_run_batch(counter_schedules(ms), pn["q"],
                                  mesh=mesh, axis="batch")
    c, ms, pn = synth(tpe, LATCH, "lmix", ("en", "clk", "rst_n", "d"),
                      device="cpu")
    latch = c.digital_run_batch(latch_schedules(ms), pn["y"] + pn["r"],
                                mesh=mesh, axis="batch")
    # the latch design over every mesh axis (the flash route, 4 ranks)
    latch_all = c.digital_run_batch(latch_schedules(ms), pn["y"] + pn["r"],
                                    mesh=mesh, axis=("batch", "sweep"))
    return dict(counter=counter, latch=latch, latch_all=latch_all)


def case_truth_tables(mesh):
    from phy_engine_tpu_torch.parallel.tt_mesh import eval_graph_mesh
    from phy_engine_tpu_torch.verilog import opt_graph as og
    op, f0, f1, words = random_graph()
    out = {"tt": eval_graph_mesh(op, f0, f1, words, mesh)}
    nets = [object() for _ in range(20)]
    g_xor, g_sop, g_bad = xor_graphs(og, nets, object())
    out["equal"] = np.array([
        og.graphs_equivalent(g_xor, g_sop, exhaustive_limit=0, mesh=mesh),
        og.graphs_equivalent(g_xor, g_bad, exhaustive_limit=0, mesh=mesh)])
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def main(rank, world, store, outdir):
    import torch.distributed as dist
    from phy_engine_tpu_torch.parallel.dryrun import init_rank
    from phy_engine_tpu_torch.parallel.mesh import make_mesh
    init_rank(rank, world, store)
    try:
        mesh = make_mesh(device_type="cpu")
        for name, fn in CASES.items():
            t0 = time.perf_counter()
            res = fn(mesh)
            if rank == 0:
                np.savez(Path(outdir) / f"{name}.npz", **res)
            print(f"{name}: {time.perf_counter() - t0:.2f} s", flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
