"""Port parity: ``parallel/`` over a four-rank gloo world on the CPU.

The module's fixture runs ``tests/torch_mesh_cases.py`` once as four
gloo ranks on a ``FileStore`` in ``tmp_path`` (one intra-op thread each;
~30 s); rank 0 writes every case's arrays, and the tests below hold them
against the port's local runs and the JAX package's (its own
``tests/test_parallel.py`` / ``test_dist_gj.py`` cases, on a four-device
slice of the suite's virtual CPU mesh where the comparison needs the
same D).

Tolerances: ``dist_solve`` x within 1e-9 (``relerr``, test_dist_gj's
measure) of numpy, of the port at D = 1 and of the JAX package at D = 4;
``tp_assemble_sparse``, the sweeps and the digital batches bit-identical
to the local runs (and the digital ones to the JAX package's levelled
engine); the sharded transients within 1e-9 of the unsharded run (JAX's
own bound); ``Circuit(mesh=)`` OP and TR within 1e-6 of the JAX package
and 1e-9 of the port's local route; truth tables bit-identical to
``native.eval_graph``.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import phy_engine_tpu as jpe
import phy_engine_tpu_torch as tpe
from phy_engine_tpu.engine import circuit as jcircuit
from phy_engine_tpu_torch.engine import analog as tanalog
from phy_engine_tpu_torch.engine.lower import lower_analog
from phy_engine_tpu_torch.parallel import dryrun
from phy_engine_tpu_torch.parallel.batch import batch_state, batch_x

import torch_mesh_cases as mc
from torch_circuits import build, build_port

torch.set_num_threads(1)
HERE = Path(__file__).resolve().parent
WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    dryrun.spawn_ranks(WORLD, lambda r: [
        str(HERE / "torch_mesh_cases.py"), str(r), str(WORLD),
        str(out / "store"), str(out)], timeout=400)
    return lambda case: np.load(out / f"{case}.npz")


@pytest.fixture(scope="module")
def local_mesh():
    from phy_engine_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(device_type="cpu")


def _jax_mesh(d=WORLD):
    return Mesh(np.array(jax.devices()[:d]), ("d",))


def test_dist_solve_four_ranks(ranks, local_mesh):
    """D = 4 against numpy, the port at D = 1 and the JAX package at
    D = 4, including a matrix of two panels a rank, and the COO delta
    solver of the distributed Newton at two panels a rank."""
    from phy_engine_tpu.parallel.dist_gj import dist_solve as jdist
    from phy_engine_tpu_torch.parallel.dist_gj import dist_solve
    r = ranks("dist_solve")
    cases = {"rand": (mc.rand_system(2, 4 * mc.NB, seed=1), 1e-10),
             "leading": (mc.zero_leading_panel(4 * mc.NB), 1e-10),
             "cyclic": (mc.rand_system(1, 8 * mc.NB, seed=6), 1e-10)}
    for name, ((A, b), bound) in cases.items():
        x4 = r[name]
        assert mc.relerr(x4, A, b) < bound, name
        x1 = dist_solve(local_mesh, A, b, refine=2).numpy()
        assert np.max(np.abs(x4 - x1) / (1 + np.abs(x1))) < 1e-9, name
    A, b = cases["rand"][0]
    xj = np.asarray(jdist(_jax_mesh(), A, b, refine=2))
    assert np.max(np.abs(r["rand"] - xj) / (1 + np.abs(xj))) < 1e-9
    # the COO delta solver with two panels a rank (where the JAX
    # package's placement goes wrong, ROADMAP queue 3)
    A, b = mc.sparse_system(8 * mc.NB)
    assert mc.relerr(r["delta"][None], A[None], b[None]) < 1e-10
    assert float(r["delta_rel"]) < 1e-12


def test_tp_assemble_sparse_bit_identical(ranks):
    """1001 resistors over four ranks (padded to 1004): the padded
    pattern's values, without the padding entries, are the local
    assembly's bit for bit, and so is Z."""
    r = ranks("tp_assembly")
    from phy_engine_tpu_torch import workloads
    from phy_engine_tpu_torch.models.base import StampCtx
    ir = lower_analog(workloads.r_ladder_netlist(
        1001, np.random.default_rng(5).uniform(50, 150, 1001)))
    p = {f.mdef.id_name: torch.as_tensor(f.P)[None] for f in ir.families}
    st = {f.mdef.id_name: {k: torch.as_tensor(v)[None]
                           for k, v in f.state0.items()}
          for f in ir.families}
    ctx = StampCtx(mode="op", t=0.0, dt=0.0, env=workloads.default_env())
    rows, cols, vals, Z, _ = tanalog.assemble_sparse(
        ir, p, torch.zeros((1, ir.n_unknowns), dtype=torch.float64), st, ctx)
    keep = []                         # padded entry layout: family by family
    k = 0
    for fam in ir.families:
        n, K = fam.a_rows.shape
        pad = (-n) % WORLD
        keep.append(np.arange(k, k + n * K))
        k += (n + pad) * K
    keep.append(np.arange(k, r["vals"].size))        # gmin diagonal
    keep = np.concatenate(keep)
    assert np.array_equal(r["rows"][keep], rows.numpy())
    assert np.array_equal(r["cols"][keep], cols.numpy())
    assert np.array_equal(r["vals"][keep], vals[0].numpy())
    assert np.array_equal(r["Z"], Z[0].numpy())
    assert not np.any(r["vals"][np.setdiff1d(np.arange(r["vals"].size),
                                             keep)])


def test_tp_solve_op(ranks):
    """The 512-resistor ladder's OP with its instances over four ranks
    against the local DC of both packages (test_parallel's 1e-9)."""
    r = ranks("tp_solve_op")
    assert bool(r["ok"])
    ref = {}
    for pe, mod in ((jpe, jcircuit), (tpe, tpe.engine.circuit)):
        kw = {"device": "cpu"} if pe is tpe else {}
        b = build(pe, mod, mc.r_ladder(), solver="dense", **kw)
        b.c.set_analyze_type(b.mod.AnalyzeType.DC)
        assert b.c.analyze()
        ref[pe.__name__] = np.array([b.nodes[f"n{k}"].voltage.real
                                     for k in range(512)])
    idx = np.arange(512)                 # nodes n0..n511 in creation order
    for v in ref.values():
        assert np.allclose(r["x"][idx], v, atol=1e-9)


def test_sharded_transients_hold_a_shard(ranks):
    """Both sharded transients: no rank holds more than B/4 lanes, and the
    gathered x is within 1e-9 of the unsharded run."""
    r = ranks("sharded_transients")
    from phy_engine_tpu_torch import workloads
    from phy_engine_tpu_torch.parallel.batch import batched_transient
    ir = lower_analog(workloads.rectifier_netlist())
    B = 16
    params = {k[2:]: torch.as_tensor(v) for k, v in r.items()
              if k.startswith("p_")}
    env = workloads.default_env()
    refs = {"plain": batched_transient(ir, params, batch_x(ir, B, "cpu"),
                                       batch_state(ir, B, "cpu"), env, 0.0,
                                       1e-6, 2)[0],
            "shmap": tanalog.transient_batched(
                ir, params, batch_x(ir, B, "cpu"), batch_state(ir, B, "cpu"),
                env, 0.0, 1e-6, 2, solver="hybrid")[0]}
    for name, xr in refs.items():
        assert bool(r[f"{name}_ok"])
        assert r[f"{name}_rows"].tolist() == [B // WORLD] * WORLD
        assert np.allclose(r[f"{name}_x"], xr.numpy(), atol=1e-9), name


def test_circuit_mesh_op_tr_ac(ranks):
    """Circuit(mesh=) OP (distributed Newton), TR (transient_dist) and
    cooperative ACOP (one omega < four ranks) against the JAX package's
    local Circuit (1e-6; ACOP 1e-8, test_ac_cooperative_single_system's
    bound) and the port's (1e-9)."""
    r = ranks("circuit_mesh")
    assert bool(r["op_ok"]) and bool(r["op_then_tr_ok"])
    assert bool(r["tr_ok"]) and bool(r["acop_ok"])
    for pe, mod in ((jpe, jcircuit), (tpe, tpe.engine.circuit)):
        kw = {"device": "cpu"} if pe is tpe else {}
        tol = 1e-9 if pe is tpe else 1e-6
        b = build(pe, mod, mc.diode_chain(), **kw)
        b.c.set_analyze_type(b.mod.AnalyzeType.OP)
        assert b.c.analyze()
        x = np.asarray(b.c._x if pe is jpe else b.c._x.numpy())
        assert np.max(np.abs(r["op_x"] - x)) < tol * max(1, np.abs(x).max())
        b = build(pe, mod, mc.rc_diode_ladder(), **kw)
        b.c.tr.t_stop, b.c.tr.t_step = 1e-6, 1e-7
        b.c.set_analyze_type(b.mod.AnalyzeType.TR)
        assert b.c.analyze()
        assert r["tr_hist"].shape == b.c.tr_history.shape
        assert np.allclose(r["tr_hist"], b.c.tr_history, rtol=tol,
                           atol=1e-12)
        assert np.isclose(float(r["tr_duration"]), b.c.tr_duration)
    hm = r["acop_x"][1]                  # node "out": top, out, branch
    assert abs(abs(hm) - 1.0 / np.sqrt(2.0)) < 1e-6
    j = build(jpe, jcircuit, mc.rc_corner())
    j.c.set_analyze_type(j.mod.AnalyzeType.ACOP)
    j.c.ac.sweep = j.mod.ACSweepType.SINGLE
    j.c.ac.omega = 1.0 / (1e3 * 1e-6)
    assert j.c.analyze()
    assert abs(hm - j.c.node_voltage(j.nodes["out"])) < 1e-8   # its test's


def test_sharded_sweeps_bit_identical(ranks):
    """dc_sweep (11 lanes), temp_sweep (3), monte_carlo (16) and the AC
    grid (13 points), each padded over four ranks: bit-identical to the
    port's local runs."""
    r = ranks("sweeps")
    b = build_port(mc.diode_sweep(), "cpu")
    local = mc.sweep_runs(b.c, b.devs["v"], b.nodes["out"])
    for k, v in local.items():
        assert np.array_equal(r[k], v), k
    assert all(r[f"{k}_ok"].all() for k in ("dc", "temp", "mc"))
    ok, w, x = mc.ac_grid_run()
    assert bool(r["ac_ok"]) and bool(ok) and len(w) == mc.AC_POINTS
    assert np.array_equal(r["ac_w"], w) and np.array_equal(r["ac_x"], x)


def _jax_levels(monkeypatch, src, top, inputs, sched, watch):
    monkeypatch.setenv("PE_TPU_DIGITAL", "levels")
    c, ms, pn = mc.synth(jpe, src, top, inputs)
    return np.asarray(c.digital_run_batch(sched(ms), sum(
        (pn[w] for w in watch), [])))


def _port_levels(src, top, inputs, sched, watch):
    """The port's levelled tick on the whole batch."""
    c, ms, pn = mc.synth(tpe, src, top, inputs, device="cpu")
    eng = c.digital_engine()
    compiled = [c._compile_schedule(s) for s in sched(ms)]
    fs = compiled[0][1]
    nodes = sum((pn[w] for w in watch), [])
    idx = [eng.ir.node_sig.get(id(n), 0) for n in nodes]
    hv, hu, _ = eng.run_levels(fs, np.stack([k[2] for k in compiled]),
                               np.stack([k[3] for k in compiled]), None,
                               idx)
    return ((hv.numpy() & 1) | ((hu.numpy() & 1) << 1)).astype(np.int8)


@pytest.mark.parametrize("design", ["counter", "latch"])
def test_sharded_digital_batches_bit_identical(ranks, monkeypatch, design):
    """The counter (turbo route) and the latch design (flash, cyclic)
    sharded over four ranks: bit-identical to the JAX package's levelled
    engine and the port's levelled tick (the latch also over both mesh
    axes)."""
    r = ranks("digital")
    if design == "counter":
        args = (mc.COUNTER, "counter", ("clk", "rst_n", "en"),
                mc.counter_schedules, ("q",))
    else:
        args = (mc.LATCH, "lmix", ("en", "clk", "rst_n", "d"),
                mc.latch_schedules, ("y", "r"))
    ref = _jax_levels(monkeypatch, *args)
    assert np.array_equal(r[design], ref)
    assert np.array_equal(_port_levels(*args), ref)
    if design == "latch":
        assert np.array_equal(r["latch_all"], ref)


def test_truth_tables_bit_identical(ranks):
    """eval_graph_mesh over four ranks against native.eval_graph, and
    graphs_equivalent(mesh=) verdicts against the JAX package's."""
    from phy_engine_tpu.verilog import opt_graph as jog
    from phy_engine_tpu_torch.native import eval_graph
    r = ranks("truth_tables")
    op, f0, f1, words = mc.random_graph()
    assert np.array_equal(r["tt"], eval_graph(op.copy(), f0, f1,
                                              words.copy()))
    nets = [object() for _ in range(20)]
    g_xor, g_sop, g_bad = mc.xor_graphs(jog, nets, object())
    want = [jog.graphs_equivalent(g_xor, g_sop, exhaustive_limit=0),
            jog.graphs_equivalent(g_xor, g_bad, exhaustive_limit=0)]
    assert want == [True, False]
    assert r["equal"].tolist() == want


def test_dryrun_multichip_four():
    dryrun.dryrun_multichip(WORLD)
