"""The port's program spans and counters (``phy_engine_tpu_torch/trace.py``)
on the two DC routes, and the span readings of ``port_bench/spans.py`` on
hand-built traces.

With a profiler active the spans nest as the host's calls do; with none
they record nothing and change no answer; ``host_syncs`` counts every read
through ``host_read``; ``bicgstab.iterations_launched`` counts what every
lane ran on the device."""

import math
import random
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from phy_engine_tpu_torch import trace, workloads
from phy_engine_tpu_torch.engine import analog
from phy_engine_tpu_torch.engine.lower import lower_analog
from phy_engine_tpu_torch.models.base import StampCtx
from phy_engine_tpu_torch.ops import sparse, tridiag

from port_bench import spans as S
from port_bench import spec
from port_bench.trace import JOB, DeviceOp, Trace

F64 = torch.float64
LANES = 3


# ---------------------------------------------------------------------------
# the two routes at a small size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    """A random-link mesh lowered by the port, its source swept over
    LANES values (the benchmark's DC route at a small size)."""
    nl, _nodes = workloads.random_mesh_netlist(300, 900, seed=5)
    ir = lower_analog(nl)
    lanes = lambda a: a[None].repeat((LANES,) + (1,) * a.dim())
    params = {k: lanes(v) for k, v in analog.initial_params(ir, "cpu").items()}
    params["VDC"] = params["VDC"] * torch.tensor(
        [0.5, 1.0, 1.5], dtype=F64)[:, None, None]
    states = {k: {s: lanes(a) for s, a in d.items()}
              for k, d in analog.initial_state(ir, "cpu").items()}
    x0 = lanes(analog.initial_x(ir, "cpu"))
    ctx = StampCtx(mode="op", t=0.0, dt=0.0, env=workloads.default_env())
    return ir, params, x0, states, ctx


def _mesh_solve(mesh):
    ir, params, x0, states, ctx = mesh
    x, _st, ok = analog.newton_solve(ir, params, x0, states, ctx,
                                     method="sparse")
    return x, ok


@pytest.fixture(scope="module")
def ladder():
    """A series-ladder core with its source's border, LANES source values
    (the benchmark's ladder route at a small size)."""
    n = 500
    g = 1.0 / 30.0
    d = torch.full((n,), 2 * g, dtype=F64)
    d[-1] = g
    off = torch.full((n,), -g, dtype=F64)
    e = torch.zeros(n, dtype=F64)
    e[0] = 1.0
    v = torch.tensor([1.5, 3.0, 4.5], dtype=F64)
    return off, d, off, torch.zeros(LANES, n, dtype=F64), e, v


def _ladder_solve(ladder, refine=4):
    dl, d, du, z, e, v = ladder
    return tridiag.border_solve(dl, d, du, z, e, v, refine=refine)


def _profiled(fn):
    """(fn's result, [(name, start_ns, end_ns)] of the ``pe.*`` ranges)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(JOB):
            out = fn()
    _window, spans = S.program_spans(prof.profiler.kineto_results.events(),
                                     JOB)
    return out, spans


def _parents(spans):
    """{index: the innermost other span containing it, or None}."""
    out = {}
    for i, (_n, s, e) in enumerate(spans):
        best = None
        for j, (_m, s2, e2) in enumerate(spans):
            if j != i and s2 <= s and e <= e2 and (
                    best is None or s2 >= spans[best][1]):
                best = j
        out[i] = None if best is None else spans[best][0]
    return out


def _delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in after}


MESH_PARENTS = {
    "pe.newton_solve": {None},
    "pe.assemble": {"pe.newton_solve"},
    "pe.bicgstab": {"pe.newton_solve"},
    "pe.bicgstab.burst": {"pe.bicgstab"},
    "pe.sync.bicgstab_stop": {"pe.bicgstab"},
    "pe.coo_matvec": {"pe.bicgstab", "pe.bicgstab.burst"},
    "pe.sync.shadow": {"pe.bicgstab"},
    "pe.sync.bicgstab_conv": {"pe.bicgstab"},
}
LADDER_PARENTS = {
    "pe.border_solve": {None},
    "pe.refine": {"pe.border_solve"},
    "pe.tridiag_part": {"pe.border_solve", "pe.refine"},
}


@pytest.mark.parametrize("route", ["mesh", "ladder"])
def test_profiled_routes_record_the_spans_nested(route, mesh, ladder):
    if route == "mesh":
        _out, spans = _profiled(lambda: _mesh_solve(mesh))
        want = MESH_PARENTS
    else:
        _out, spans = _profiled(lambda: _ladder_solve(ladder))
        want = LADDER_PARENTS
    names = [s[0] for s in spans]
    assert set(names) == set(want)
    for i, parent in _parents(spans).items():
        assert parent in want[names[i]], (names[i], parent)
    if route == "ladder":
        # the factor and six solves
        assert names.count("pe.tridiag_part") == 7
        assert names.count("pe.refine") == 4
        # each refinement pass holds its base solve
        assert all(p == "pe.refine" for i, p in _parents(spans).items()
                   if names[i] == "pe.tridiag_part" and spans[i][1] > spans[
                       names.index("pe.refine")][1])
    else:
        bursts = names.count("pe.bicgstab.burst")
        assert bursts == names.count("pe.sync.bicgstab_stop") > 1
        # two products an iteration, the first residual and the last
        products = names.count("pe.coo_matvec")
        assert products % 2 == 0 and products >= 2 * bursts


@pytest.mark.parametrize("route", ["mesh", "ladder"])
def test_no_profiler_no_span_and_the_same_answers(route, mesh, ladder,
                                                  monkeypatch):
    solve = ((lambda: _mesh_solve(mesh)) if route == "mesh"
             else (lambda: _ladder_solve(ladder)))
    profiled, spans = _profiled(solve)
    assert spans
    assert trace.span("pe.anything") is trace._NULL

    def refuse(name):
        raise AssertionError(f"a range {name!r} opened with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    plain = solve()
    for a, b in zip(plain, profiled):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", ["mesh", "ladder"])
def test_host_syncs_count_every_sync_site(route, mesh, ladder):
    before = trace.counters()
    if route == "mesh":
        _out, spans = _profiled(lambda: _mesh_solve(mesh))
    else:
        _out, spans = _profiled(lambda: _ladder_solve(ladder))
    d = _delta(before, trace.counters())
    names = [s[0] for s in spans]
    assert d["host_syncs"] == sum(n.startswith("pe.sync.") for n in names)
    if route == "mesh":
        stops = names.count("pe.sync.bicgstab_stop")
        assert stops == math.ceil(d["bicgstab.iterations_launched"]
                                  / sparse.CHECK_EVERY)
        # and the shadow's copy and the read of whether Jacobi converged
        assert d["host_syncs"] == stops + 2
    else:
        # the partitioned solves and the residual write no scalar
        assert d["host_syncs"] == 0


def _lanes_system(n=400, seed=2):
    """A diagonally weighted random COO system with LANES right sides."""
    rng = np.random.default_rng(seed)
    m = 4 * n
    rows = np.concatenate([np.arange(n), rng.integers(0, n, m)])
    cols = np.concatenate([np.arange(n), rng.integers(0, n, m)])
    vals = np.concatenate([np.full(n, 6.0), rng.uniform(-1, 1, m)])
    b = rng.standard_normal((LANES, n)) * np.array([[1.0], [1e-3], [1e3]])
    t = lambda a: torch.as_tensor(a)
    return t(rows), t(cols), t(vals), t(b), n


@pytest.mark.parametrize("tol", [1e-6, 1e-10, 1e-13])
def test_iterations_launched_cover_the_slowest_lane(tol):
    rows, cols, vals, b, n = _lanes_system()
    before = trace.counters()
    _x, _ok, it = sparse.bicgstab(rows, cols, vals, b, n, tol=tol)
    launched = _delta(before, trace.counters())[
        "bicgstab.iterations_launched"]
    top = int(it.max())
    assert top <= launched < top + sparse.CHECK_EVERY


def test_counters_carry_the_kernels_launches(monkeypatch):
    from phy_engine_tpu_torch.digital import turbo
    from phy_engine_tpu_torch.ops import gj, lu_block
    wrappers = (gj.gj_solve32, gj.gj_inverse32, lu_block.lu_block_inverse32,
                turbo.run_turbo, sparse.coo_spmm, tridiag.tridiag_part64)
    for k, fn in enumerate(wrappers):
        monkeypatch.setattr(fn, "launches", 11 + k)
    c = trace.counters()
    assert [c[f"{fn.__name__}.launches"] for fn in wrappers] == \
        list(range(11, 17))


def test_trace_imports_no_kernel_module():
    """``trace.py`` imports no module of the package, so none of ``ops/``
    or ``digital/``: the kernels' wrappers register themselves when they
    are imported.  Loaded by its path on its own, outside the package, it
    runs, and its counters hold only what was counted."""
    import ast
    import importlib.util
    tree = ast.parse(open(trace.__file__).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            assert node.level == 0, ast.unparse(node)
            names = [node.module]
        elif isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        else:
            continue
        assert not any(n.startswith("phy_engine_tpu") for n in names), \
            ast.unparse(node)
    spec = importlib.util.spec_from_file_location("pe_trace_alone",
                                                  trace.__file__)
    alone = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(alone)
    alone.count("x")
    assert alone.counters() == {"x": 1}


@pytest.mark.parametrize("t", [
    torch.tensor(True), torch.tensor(False), torch.tensor(7),
    torch.tensor([3, 0, 1]), torch.tensor(2.5, dtype=F64)])
def test_host_read_returns_what_the_bare_read_returns(t):
    before = trace.counters().get("host_syncs", 0)
    got = trace.host_read(t, "test")
    assert got == t.tolist() and type(got) is type(t.tolist())
    if t.dim() == 0 and t.dtype == torch.bool:
        assert got is bool(t)
    assert trace.counters()["host_syncs"] == before + 1


def test_counters_lose_no_update_across_threads():
    before = trace.counters().get("test.threads", 0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                trace.count("test.threads")
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert trace.counters()["test.threads"] == before + 16 * 2000


# ---------------------------------------------------------------------------
# the span readings on hand-built traces
# ---------------------------------------------------------------------------

HAND_SPANS = [("pe.newton_solve", 0, 90), ("pe.assemble", 5, 20),
              ("pe.bicgstab", 20, 90), ("pe.bicgstab.burst", 25, 60),
              ("pe.coo_matvec", 30, 40), ("pe.sync.bicgstab_stop", 60, 80)]
# (name, start, duration, its launching operator's start)
HAND_OPS = [("a", 10, 5, 6), ("b", 22, 8, 21), ("c", 35, 10, 31),
            ("d", 50, 12, 45), ("e", 85, 5, 82)]


def _hand(steps=1, counters=None):
    ops = [DeviceOp(name=n, start_ns=s, dur_ns=d, owner="aten::x",
                    owner_id=k) for k, (n, s, d, _l) in enumerate(HAND_OPS)]
    t = Trace(window_ns=100, ops=ops, steps=steps, calls=[("bicgstab", 16)],
              counters=dict(counters or {}))
    stacks = S.open_at(HAND_SPANS, [lt for *_x, lt in HAND_OPS])
    return t, stacks


def test_open_spans_at_each_launch():
    _t, stacks = _hand()
    assert stacks == [
        ("pe.newton_solve", "pe.assemble"),
        ("pe.newton_solve", "pe.bicgstab"),
        ("pe.newton_solve", "pe.bicgstab", "pe.bicgstab.burst",
         "pe.coo_matvec"),
        ("pe.newton_solve", "pe.bicgstab", "pe.bicgstab.burst"),
        ("pe.newton_solve", "pe.bicgstab")]


def test_open_at_agrees_with_a_search_of_every_span():
    rng = random.Random(3)

    def nest(lo, hi, depth):
        out, t = [], lo
        while depth and t < hi - 2:
            a = rng.randint(t, hi - 2)
            b = rng.randint(a + 1, hi)
            out.append((f"pe.{depth}.{a}", a, b))
            out += nest(a, b, depth - 1)
            t = b
        return out
    spans = sorted(nest(0, 1000, 4), key=lambda x: (x[1], -x[2]))
    times = [rng.randint(-5, 1005) for _ in range(300)]
    brute = [tuple(n for n, a, b in spans if a <= q < b) for q in times]
    assert S.open_at(spans, times) == brute


def test_idle_split_and_busy_shares_worked_by_hand():
    t, stacks = _hand()
    assert t.busy_ns() == 40
    idle = S.idle_by_host(t.ops, 0, 100, HAND_SPANS)
    # gaps: 0-10 before the first op (caller), 15-22 in pe.assemble,
    # 30-35 in pe.coo_matvec, 45-50 in the burst, 62-85 in the stop
    # read, 90-100 after the last op (caller)
    assert (idle["sync"], idle["launch"], idle["caller"]) == (23, 17, 20)
    assert idle["by_span"] == {"caller": 20, "pe.assemble": 7,
                               "pe.coo_matvec": 5, "pe.bicgstab.burst": 5,
                               "pe.sync.bicgstab_stop": 23}
    assert sum(idle[k] for k in ("sync", "launch", "caller")) == (
        t.window_ns - t.busy_ns())
    assert S.busy_under(t.ops, stacks, "pe.coo_matvec") == 10
    assert S.busy_under(t.ops, stacks, "pe.assemble") == 5
    assert S.busy_under(t.ops, stacks, "pe.bicgstab") == 35
    assert S.busy_under(t.ops, stacks, "pe.refine") == 0


@pytest.mark.parametrize("steps", [1, 2])
def test_readings_worked_by_hand(steps):
    t, stacks = _hand(steps, {"host_syncs": 6,
                              "bicgstab.iterations_launched": 32})
    r = S.readings(t, 0, 100, HAND_SPANS, stacks)
    assert r == {"dc_host_syncs_per_sweep": 6 / steps,
                 "bicgstab_iterations_launched": 32 / steps,
                 "dc_sync_idle_pct": 23.0, "dc_matvec_busy_pct": 25.0,
                 "dc_assembly_busy_pct": 12.5,
                 "ladder_launch_idle_pct": 17.0,
                 "ladder_refine_busy_pct": 0.0}


def test_readings_of_the_ladder_spans_by_hand():
    spans = [("pe.border_solve", 0, 100), ("pe.pcr", 0, 20),
             ("pe.refine", 30, 60), ("pe.pcr", 35, 55)]
    ops = [DeviceOp(name="k", start_ns=s, dur_ns=d, owner="aten::x",
                    owner_id=i) for i, (s, d) in
           enumerate([(5, 20), (32, 3), (40, 30), (75, 5)])]
    t = Trace(window_ns=100, ops=ops, steps=1, calls=[])
    stacks = S.open_at(spans, [1, 31, 36, 70])
    r = S.readings(t, 0, 100, spans, stacks)
    # busy 58; under pe.refine the ops launched at 31 and 36: 33
    assert r["ladder_refine_busy_pct"] == pytest.approx(100 * 33 / 58)
    # gaps: 0-5 caller, 25-32 in pe.border_solve, 35-40 in pe.refine,
    # 70-75 in pe.border_solve, 80-100 after the last op (caller)
    assert r["ladder_launch_idle_pct"] == pytest.approx(17.0)
    assert r["dc_sync_idle_pct"] == 0.0
    assert r["dc_host_syncs_per_sweep"] is None


@pytest.mark.parametrize("t", [
    Trace(window_ns=0, ops=[], steps=1, calls=[]),
    Trace(window_ns=100, ops=[], steps=1, calls=[]),
    Trace(window_ns=100, ops=[DeviceOp("k", 1, 5, "aten::x", 0)], steps=0,
          calls=[], counters={"host_syncs": 4})])
def test_readings_are_none_on_an_empty_trace(t):
    r = S.readings(t, 0, t.window_ns, HAND_SPANS, [()] * len(t.ops))
    assert set(r.values()) == {None}


def test_existing_readers_read_the_same_with_the_spans_beside():
    t, _stacks = _hand(1, {"host_syncs": 6, "refactors": 2, "bursts": 1,
                           "steps": 1})
    readers = {n: m for n, m in spec.metrics().items()
               if {"sparse", "pcr"} & set(m.ROUTES)}
    plain = {n: m.read(t) for n, m in readers.items()}
    t2, stacks = _hand(1, {"host_syncs": 6, "refactors": 2, "bursts": 1,
                           "steps": 1})
    S.readings(t2, 0, 100, HAND_SPANS, stacks)
    S.idle_by_host(t2.ops, 0, 100, HAND_SPANS)
    assert {n: m.read(t2) for n, m in readers.items()} == plain
    assert plain["dc_device_idle_pct"] == pytest.approx(60.0)
    assert plain["bicgstab_iterations"] == 16
