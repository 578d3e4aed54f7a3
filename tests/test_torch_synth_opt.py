"""Port parity: synthesis at -O2 and above (``verilog/opt_graph.py``,
``opt_map.py`` and the O2+ driver of ``optimize.py``).

Every synthesis that ``tests/test_synth_opt.py`` runs
(``torch_synth_cases.RUNS_OPT``: the design, its level and options; its
7-segment decoder and 8 x 8 multiplier are in
``test_torch_synth_budgets.py``) is made by both packages from the same
source.  The live devices agree in order, type, wiring (nets numbered by
first use) and params; ``OptStats`` and the pass report agree field for
field, the pass report's elapsed microseconds excepted; and a netlist of
-O2 and above, clocked on the JAX test's stimulus by the port's levelled
tick on the CPU and by the JAX levels engine, gives bit-identical
histories.  The unit
functions (Espresso, QM, ``graphs_equivalent``, ``macro_extract``,
``_LiveSet``, ``bdd_decompose``) are held against the JAX package on
seeded inputs."""

import random

import numpy as np
import pytest

import phy_engine_tpu as jpe
import phy_engine_tpu_torch as tpe
from phy_engine_tpu.verilog import opt_graph as jog
from phy_engine_tpu.verilog import opt_map as jom
from phy_engine_tpu.verilog.optimize import OptStats as JOptStats
from phy_engine_tpu_torch.verilog import opt_graph as tog
from phy_engine_tpu_torch.verilog import opt_map as tom
from phy_engine_tpu_torch.verilog.optimize import OptStats as TOptStats

import torch_synth_cases as sc


X_CODE = 2


def _port_circuit():
    return tpe.Circuit(device="cpu")


def _jax_history(c, sched):
    tr = c.digital_run(sched)
    return np.asarray(tr.sv), np.asarray(tr.su)


def _port_history(c, sched):
    eng, fs, FV, FU = c._compile_schedule(sched)
    hv, hu, _last = eng.run_levels(fs, FV[None], FU[None])
    return (hv[0].numpy().view(np.uint32), hu[0].numpy().view(np.uint32))


# histories already compared, by (design, device list): two runs that
# synthesize the same netlist clock it once.  Only -O2 and above are
# clocked: the -O0 / -O1 netlists (equal device for device to the JAX
# package's all the same) are the tiers of earlier slices, and the JAX
# levels engine's trace and compile, seconds a netlist, is most of these
# tests' time
_CLOCKED = set()


def check_run(design, opts, monkeypatch):
    """One synthesis in both packages: the same devices, OptStats and
    pass report, and, at -O2 and above, bit-identical histories on the
    JAX test's stimulus (the port's levelled tick against the JAX levels
    engine)."""
    monkeypatch.setenv("PE_TPU_DIGITAL", "levels")
    jc, jins, _jp, jrep = sc.synth(jpe, jpe.Circuit, design, opts)
    tc, tins, _tp, trep = sc.synth(tpe, _port_circuit, design, opts)
    td, jd = sc.device_list(tc.nl), sc.device_list(jc.nl)
    assert len(td) == len(jd)
    assert td == jd
    assert (trep.gate_count, trep.ff_count, trep.gate_count_pre_opt) == (
        jrep.gate_count, jrep.ff_count, jrep.gate_count_pre_opt)
    assert sc.stats_fields(trep.opt_stats) == sc.stats_fields(jrep.opt_stats)
    key = (design, tuple(td))
    if opts["opt_level"] < 2 or key in _CLOCKED:
        return trep
    tv, tu = _port_history(tc, sc.schedule(design, tins))
    jv, ju = _jax_history(jc, sc.schedule(design, jins))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tu, ju)
    _CLOCKED.add(key)
    return trep


@pytest.mark.parametrize("design,opts", sc.RUNS_OPT,
                         ids=[sc.run_id(d, o) for d, o in sc.RUNS_OPT])
def test_synthesis_matches_jax(design, opts, monkeypatch):
    check_run(design, opts, monkeypatch)


def test_o2_keeps_x_and_counters_clock():
    """What the JAX tests assert of these designs holds in the port: an X
    input stays X at O2, and the O3 counter counts and wraps."""
    c, ins, pn, _rep = sc.synth(tpe, _port_circuit, "xprop",
                                {"opt_level": 2})
    tr = c.digital_run(sc.schedule("xprop", ins))
    assert int(tr.node_codes(pn["y"][0])[-1]) == X_CODE
    c, ins, pn, _rep = sc.synth(tpe, _port_circuit, "counter_wrap", sc.B3)
    tr = c.digital_run(sc.schedule("counter_wrap", ins))
    q = tr.bus_values(pn["q"])[3::2]          # after each rising edge
    assert list(q) == [k & 15 for k in range(1, 17)]
    wrap = tr.node_codes(pn["wrap"][0])[3::2]
    assert list(wrap) == [1 if (k & 15) == 15 else 0 for k in range(1, 17)]


def test_support_flags_raise_alike():
    from phy_engine_tpu.verilog.parser import CompileError as JErr
    from phy_engine_tpu_torch.verilog.parser import CompileError as TErr
    for name, flag in (("ff", "support_always_ff"),
                       ("mux", "support_always_comb")):
        opts = {flag: False}
        with pytest.raises(JErr, match=flag) as je:
            sc.synth(jpe, jpe.Circuit, name, opts)
        with pytest.raises(TErr, match=flag) as te:
            sc.synth(tpe, _port_circuit, name, opts)
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# the unit functions
# ---------------------------------------------------------------------------

def _random_on(rng, nvars, density):
    patt, npat, nwords = tog._var_patterns(nvars)
    bits = rng.random(npat) < density
    on = np.packbits(bits, bitorder="little")
    return np.pad(on, (0, nwords * 8 - on.size)).view(np.uint64)


def test_espresso_cover_matches_jax():
    """Random ON-sets at 4, 6 and 9 variables and three densities (the
    JAX test's sweep without its 12-variable row): the port's cover is the
    JAX package's, cube for cube, and covers exactly the ON-set."""
    rng = np.random.default_rng(31)
    for nvars in (4, 6, 9):
        patt, npat, nwords = tog._var_patterns(nvars)
        ones = np.full(nwords, ~np.uint64(0))
        if npat < 64:
            ones = ones & np.uint64((1 << npat) - 1)
        for density in (0.1, 0.5, 0.9):
            on = _random_on(rng, nvars, density)
            cubes = tog.espresso_cover(on.copy(), nvars)
            assert cubes == jog.espresso_cover(on.copy(), nvars)
            cover = np.zeros(nwords, np.uint64)
            for v, m in cubes:
                cover |= tog._cube_cover(v, m, nvars, patt, ones)
            assert ((cover & ones) == (on & ones)).all(), (nvars, density)
    # the last-gasp merge and the don't-care set (the JAX unit cases)
    for on, dc in ((np.array([0b00001111], np.uint64), None),
                   (np.array([0b00001000], np.uint64),
                    np.array([0b10100110], np.uint64))):
        assert tog.espresso_cover(on, 3, dc_words=dc) == \
            jog.espresso_cover(on, 3, dc_words=dc)
    assert len(tog.espresso_cover(np.array([0b00001111], np.uint64), 3)) == 1


def test_qm_matches_jax():
    rng = np.random.default_rng(5)
    for nvars in range(2, 9):
        for density in (0.2, 0.5, 0.8):
            mts = [m for m in range(1 << nvars) if rng.random() < density]
            if not mts:
                continue
            tp = tog._qm_primes(mts, nvars)
            assert tp == jog._qm_primes(mts, nvars)
            assert tog._qm_cover(mts, tp, nvars) == \
                jog._qm_cover(mts, tp, nvars)


class _Net:
    pass


def _and_pair(og):
    na, nb, nout = _Net(), _Net(), _Net()
    g0 = og.GateGraph()
    g0.set_output(nout, g0.gate("AND", g0.leaf(na), g0.leaf(nb)))
    g1 = og.GateGraph()
    g1.set_output(nout, g1.gate("OR", g1.leaf(na), g1.leaf(nb)))
    g2 = og.GateGraph()
    g2.set_output(nout, g2.gate("NOT", g2.gate(
        "NAND", g2.leaf(na), g2.leaf(nb))))
    return g0, g1, g2


def _wide_pair(og, nleaves=16, flip=False):
    """Two 16-leaf parity trees (past the exhaustive limit: the random
    vector tier); ``flip`` makes the second one an XNOR at the root."""
    nets = [_Net() for _ in range(nleaves)]
    out = _Net()
    gs = []
    for k in range(2):
        g = og.GateGraph()
        acc = g.leaf(nets[0])
        for n in nets[1:]:
            acc = g.gate("XOR", acc, g.leaf(n))
        if flip and k == 1:
            acc = g.gate("NOT", acc)
        g.set_output(out, acc)
        gs.append(g)
    return gs


def test_graphs_equivalent_matches_jax():
    for og in (tog, jog):
        g0, g1, g2 = _and_pair(og)
        assert not og.graphs_equivalent(g0, g1)
        assert og.graphs_equivalent(g0, g2)      # ~(a NAND b) == a & b
        assert og.graphs_equivalent(*_wide_pair(og))
        assert not og.graphs_equivalent(*_wide_pair(og, flip=True))
    # the deep check on a one-rank gloo mesh gives the same verdicts
    from phy_engine_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(device_type="cpu")
    assert tog.graphs_equivalent(*_wide_pair(tog), exhaustive_limit=0,
                                 mesh=mesh)
    assert not tog.graphs_equivalent(*_wide_pair(tog, flip=True),
                                     exhaustive_limit=0, mesh=mesh)


def _adder_graph(og, bits=4):
    """A ripple adder and a 2x2 multiplier web as gates (the shapes
    macro_extract claims)."""
    g = og.GateGraph()
    a = [g.leaf(_Net()) for _ in range(bits)]
    b = [g.leaf(_Net()) for _ in range(bits)]
    c = None
    for i in range(bits):
        x = g.gate("XOR", a[i], b[i])
        if c is None:
            s, c = x, g.gate("AND", a[i], b[i])
        else:
            s = g.gate("XOR", x, c)
            c = g.gate("OR", g.gate("AND", a[i], b[i]), g.gate("AND", c, x))
        g.set_output(_Net(), s)
    g.set_output(_Net(), c)
    t1 = g.gate("AND", a[1], b[0])
    t2 = g.gate("AND", a[0], b[1])
    c1 = g.gate("AND", t1, t2)
    t3 = g.gate("AND", a[1], b[1])
    for idx in (g.gate("AND", a[0], b[0]), g.gate("XOR", t1, t2),
                g.gate("XOR", t3, c1), g.gate("AND", t3, c1)):
        g.set_output(_Net(), idx)
    return g


def _graph_shape(g):
    return ([(n.op, n.fanins, n.const) for n in g.nodes],
            sorted(idx for _, idx in g.outputs.values()))


def test_macro_extract_matches_jax():
    got = []
    for og, stats in ((tog, TOptStats()), (jog, JOptStats())):
        g = og.macro_extract(_adder_graph(og), stats)
        got.append((_graph_shape(g), stats.adders_extracted,
                    stats.mul2_extracted))
    assert got[0] == got[1]
    assert got[0][1] > 0 and got[0][2] == 1


def _random_builder(og, rng):
    bld = og._Builder(binary_ok=True)
    pool = [bld.leaf(object()) for _ in range(6)]
    for _ in range(40):
        op = rng.choice(["AND", "OR", "XOR", "NOT"])
        if op == "NOT":
            pool.append(bld.NOT(rng.choice(pool)))
        else:
            a, b = rng.choice(pool), rng.choice(pool)
            pool.append(getattr(bld, op)(a, b))
    return bld, pool


def test_liveset_matches_jax():
    """The JAX test's random walk, run on both packages' builders from one
    seed: the same graphs, the same counts at every probe and commit."""
    trace = []
    for og in (tog, jog):
        rng = random.Random(7)
        out = []
        for trial in range(20):
            bld, pool = _random_builder(og, rng)
            roots = [rng.choice(pool) for _ in range(5)]
            if trial % 3 == 0:
                roots.append(roots[0])
            live = og._LiveSet(bld, roots)
            assert live.gates == og._live_gate_count(bld, roots)
            out.append(live.gates)
            cur = list(roots)
            for _ in range(15):
                old, new = rng.choice(cur), rng.choice(pool)
                got = live.swap_cost_all(old, new)
                assert got == og._live_gate_count(
                    bld, [new if r == old else r for r in cur])
                out.append(got)
                if rng.random() < 0.5:
                    cur[cur.index(old)] = new
                    live.swap_one(old, new)
                    assert live.gates == og._live_gate_count(bld, cur)
                    out.append(live.gates)
        trace.append(out)
    assert trace[0] == trace[1]


def test_bdd_decompose_flat_sop_matches_jax():
    """MAJ5(a) ^ MAJ5(b) over 10 variables as a flat SOP (the JAX unit
    test): both packages decompose it to the same gate count, and the
    port's result is exhaustively equal to the SOP."""
    nv = 10
    minterms = [m for m in range(1 << nv)
                if (sum((m >> i) & 1 for i in range(5)) >= 3) ^
                (sum((m >> (5 + i)) & 1 for i in range(5)) >= 3)]
    res = []
    for og, om, stats in ((tog, tom, TOptStats()), (jog, jom, JOptStats())):
        bld = og._Builder(binary_ok=True)
        leaves = [bld.leaf(_Net()) for _ in range(nv)]
        root = og._build_sop(bld, leaves, [(m, 0) for m in minterms], nv,
                             False)
        before = og._live_gate_count(bld, [root])
        out = om.bdd_decompose(bld, {0: (None, root)}, stats)
        root2 = next(iter(out.values()))[1]
        after = og._live_gate_count(bld, [root2])
        res.append((before, after, stats.bdd_decomposed))
        if og is tog:
            w1, npat = om._cone_tt_words(bld, root, leaves)
            w2, _ = om._cone_tt_words(bld, root2, leaves)
            np.testing.assert_array_equal(om._tt_bits(w1, npat),
                                          om._tt_bits(w2, npat))
    assert res[0] == res[1]
    assert res[0][2] >= 1 and res[0][1] < res[0][0] // 2
