"""The chain cell ``mesh100k_l1000.dc``: its configuration, its family
(``circuits/random_link_mesh_chain.py``) on the CPU at a small size, its
two counter readers, and its entries in BENCHMARK.json."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import check, run, spec
from port_bench.trace import Trace

import pb_tiny

REPO = Path(spec.ROOT).parent
CELL = "mesh100k_l1000.dc"
READERS = {"chain_applies_per_sweep": "chain.applies",
           "dc_host_syncs_per_sweep": "host_syncs"}


def _tiny():
    """The chain cell at 2,000 nodes and 20 links, two lanes."""
    return pb_tiny.mesh_cell(CELL, links=20, lanes=2)


def test_the_chain_configuration_is_the_mesh_at_10_3_links():
    """The configuration is the mesh cell's but for its name, link count,
    family and the note on its links; the cell is the mesh cell's but for
    the configuration and why."""
    mesh, chain = spec.cell("mesh100k.dc"), spec.cell(CELL)
    differ = {k for k in mesh.config if mesh.config[k] != chain.config[k]}
    assert differ == {"name", "source", "links", "circuit", "assumed"}
    assert set(mesh.config) == set(chain.config)
    assert chain.config["links"] == 1000 and chain.config["reduced"] == []
    assert mesh.config["assumed"][0] == chain.config["assumed"][0]
    assert mesh.config["assumed"][2:] == chain.config["assumed"][3:]
    assert chain.config["source"].startswith(mesh.config["source"] + "#L")
    assert {k for k in mesh.cell if mesh.cell[k] != chain.cell[k]} == {
        "config", "why"}
    fam = spec.family(chain)
    assert {"RATE", "FAILED", "ZERO", "Bench"} <= set(vars(fam))
    assert fam.RATE == spec.family(mesh).RATE and fam.FAILED in fam.ZERO
    assert set(READERS) <= set(spec.metrics_for(chain))


def test_benchmark_json_lists_the_chain_cell():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg, = [c for c in b["configs"] if c["name"] == "random_links_100k_l1000"]
    c = spec.cell(CELL)
    assert (cfg["source"], cfg["reduced"]) == (c.config["source"], [])
    assert cfg["file"] == "port_bench/configs/random_links_100k_l1000.json"
    w, = [w for w in b["workloads"] if w["name"] == CELL]
    keys = ("config", "traffic", "chips", "why")
    assert [w[k] for k in keys] == [c.cell[k] for k in keys]
    metrics = {m["name"]: m for m in b["end_to_end"] + b["per_layer"]}
    for name in ("dc_solves_per_s", "bicgstab_iterations",
                 "dc_device_idle_pct", "dc_ops_per_iteration"):
        assert metrics[name]["workloads"] == ["mesh100k.dc", CELL]
    readers = spec.metrics()
    for name in READERS:
        m, r = metrics[name], readers[name]
        assert m["workloads"] == [CELL]
        keys = ("layer", "unit", "better", "source", "moves")
        assert [m[k] for k in keys] == [getattr(r, k.upper()) for k in keys]


@pytest.mark.parametrize("name", sorted(READERS))
def test_counter_readers_read_per_sweep_or_nothing(name):
    """The window's count over its sweeps; None where the family hands
    the window no such counter (the Jacobi mesh family's ``counters()``
    is empty) or there is no sweep."""
    r = spec.metrics()[name]
    t = Trace(window_ns=10, ops=[], steps=1, calls=[],
              counters={READERS[name]: 180, "steps": 4})
    assert r.read(t) == 45.0
    for counters in ({"steps": 4}, {READERS[name]: 180, "steps": 0}):
        assert r.read(Trace(window_ns=10, ops=[], steps=1, calls=[],
                            counters=counters)) is None


def test_the_chain_family_counts_and_needs_no_jacobi_in_the_window():
    """The warm-up escalates once; the window's jobs run the chain
    preconditioner alone, the counters reach the readers, and the answers
    are correct."""
    c = _tiny()
    fam = spec.family(c)
    b = fam.Bench(c, 5, "cpu")
    w = run.Window(b, 5, 0.0, True, 2)
    assert w.counters["bicgstab.escalations"] == 0
    assert w.counters["chain.factors"] == w.jobs == 2
    assert w.counters["chain.applies"] == 2 * w.counters[
        "bicgstab.iterations_launched"] > 0
    readers = spec.metrics_for(c)
    applies = readers["chain_applies_per_sweep"].read(w.trace)
    syncs = readers["dc_host_syncs_per_sweep"].read(w.trace)
    assert applies == w.counters["chain.applies"] / 2
    assert 0 < syncs < applies
    assert readers["bicgstab_iterations"].read(w.trace) < 100
    values = run.compare(fam, b, w, 5)
    limits = dict(c.cell["check"]["limits"], **{z: 0 for z in fam.ZERO})
    assert check.verdict(values, limits)[0], values


def test_the_chain_family_refuses_a_program_that_does_not_converge(
        monkeypatch):
    """A program whose warm-up job leaves lanes unconverged (here the
    sparse solver held to 5 iterations) cannot run the chain cell: set-up
    raises, before any window."""
    from phy_engine_tpu_torch.engine import analog
    real = analog.bicgstab
    monkeypatch.setattr(analog, "bicgstab",
                        lambda *a, **kw: real(*a, **dict(kw, max_iter=5)))
    c = _tiny()
    with pytest.raises(RuntimeError, match="did not converge"):
        spec.family(c).Bench(c, 5, "cpu")


def test_a_chain_run_loads_no_jax_module():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"sys.path.insert(0, {str(spec.ROOT / 'tests')!r})\n"
        "import pb_tiny\nfrom port_bench import run\n"
        f"c = pb_tiny.mesh_cell({CELL!r}, links=20, lanes=2)\n"
        "out = run.bench(c, 7, 0.0, True, 'cpu')\n"
        "assert out['correct'], out\n"
        "assert 'chain_applies_per_sweep' in out['metrics'], out\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "phy_engine_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)
