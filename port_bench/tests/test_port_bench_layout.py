"""Cells, configurations, traffic mixes, circuit families and metrics are
found by file name, a new one is added by adding its file, and
BENCHMARK.json agrees with the files."""

import json
import shutil
from pathlib import Path

import pytest

from port_bench import spec
from port_bench.trace import Trace

REPO = Path(spec.ROOT).parent
KINDS = ("cells", "configs", "traffic", "metrics", "circuits")


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_cell_resolves():
    for name in spec.names("cells"):
        c = spec.cell(name)
        assert c.config["name"] == c.cell["config"]
        assert spec.metrics_for(c), name
        fam = spec.family(c)
        assert {"RATE", "FAILED", "ZERO", "Bench"} <= set(vars(fam)), name
        assert fam.FAILED in fam.ZERO


def test_bad_and_missing_names_raise():
    with pytest.raises(ValueError):
        spec.cell("../cells/x")
    with pytest.raises(FileNotFoundError):
        spec.cell("no.such.cell")


@pytest.fixture
def copy(tmp_path):
    for kind in KINDS:
        shutil.copytree(spec.ROOT / kind, tmp_path / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_a_cell_a_config_and_a_mix_are_added_as_files(copy):
    cfg = json.loads((copy / "configs" / "diode_ladder_255.json").read_text())
    cfg.update(name="diode_ladder_63", stages=63)
    (copy / "configs" / "diode_ladder_63.json").write_text(json.dumps(cfg))
    mix = json.loads((copy / "traffic" / "mc128.json").read_text())
    mix.update(drive={"Vp": 0.2})
    (copy / "traffic" / "mc128_small.json").write_text(json.dumps(mix))
    cell = json.loads((copy / "cells" / "ladder1151.mc128.json").read_text())
    cell.update(config="diode_ladder_63", traffic="mc128_small")
    (copy / "cells" / "ladder63.mc128_small.json").write_text(json.dumps(cell))
    assert "ladder63.mc128_small" in spec.names("cells", copy)
    c = spec.cell("ladder63.mc128_small", copy)
    assert c.config["stages"] == 63 and c.traffic["drive"] == {"Vp": 0.2}
    assert set(spec.metrics_for(c, copy)) == {
        n for n, m in spec.metrics().items() if "frozen" in m.ROUTES}


def test_a_circuit_family_is_added_as_a_file(copy):
    """A family in a file of its own, named by a configuration, runs a
    cell: here a copy of the mesh's family under another name."""
    src = (copy / "circuits" / "random_link_mesh.py").read_text()
    (copy / "circuits" / "mesh_copy.py").write_text(
        src.replace('RATE = ("dc_solves_per_s"',
                    'RATE = ("copy_solves_per_s"'))
    cfg = json.loads((copy / "configs" / "random_links_100k_l10000.json")
                     .read_text())
    cfg.update(name="mesh_copy_300", circuit="mesh_copy", nodes=300, links=30)
    mix = json.loads((copy / "traffic" / "dc_sweep64.json").read_text())
    (copy / "traffic" / "dc_sweep2.json").write_text(json.dumps(
        dict(mix, lanes=2)))
    (copy / "configs" / "mesh_copy_300.json").write_text(json.dumps(cfg))
    cell = json.loads((copy / "cells" / "mesh100k.dc.json").read_text())
    cell.update(config="mesh_copy_300", traffic="dc_sweep2",
                check=dict(cell["check"], positions=16))
    (copy / "cells" / "mesh300.dc.json").write_text(json.dumps(cell))
    assert "mesh_copy" in spec.names("circuits", copy)
    c = spec.cell("mesh300.dc", copy)
    fam = spec.family(c, copy)
    assert fam.RATE[0] == "copy_solves_per_s"
    b = fam.Bench(c, 3, "cpu")
    (at, whole), fails = b.job(3, 0)
    assert at.shape == (2, 16) and whole.shape == (301,) and int(fails) == 0
    values = b.compare(3, [(at.numpy(), whole.numpy())])
    assert values["v_gap_max"] < 1e-5 and values["ref_unconverged"] == 0


def test_an_unknown_circuit_family_raises():
    c = spec.cell("mesh100k.dc")
    with pytest.raises(FileNotFoundError):
        spec.family(spec.Cell(c.name, c.cell,
                              dict(c.config, circuit="no_such"), c.traffic))

def test_a_metric_is_added_as_a_file(copy):
    (copy / "metrics" / "jobs_traced.py").write_text(
        '"""A test metric."""\n'
        "from .. import roofline\n"
        'LAYER = "device"\nUNIT = "jobs"\nBETTER = "higher"\n'
        'SOURCE = "device_trace"\nMOVES = "circuit_steps_per_s"\n'
        'ROUTES = ("frozen",)\n\n'
        "def read(t):\n    return 1.0 if t.ops else None\n")
    got = spec.metrics(copy)
    assert "jobs_traced" in got
    empty = Trace(window_ns=1, ops=[], steps=1, calls=[])
    assert got["jobs_traced"].read(empty) is None


def test_readers_find_nothing_in_an_empty_trace():
    empty = Trace(window_ns=10, ops=[], steps=4, calls=[],
                  counters={"refactors": 0, "bursts": 0, "steps": 0})
    for name, m in spec.metrics().items():
        assert m.read(empty) is None, name


def test_benchmark_json_agrees_with_the_files():
    b = _bench()
    assert b["command"] == ["python3", "port_bench/run.py"]
    assert b["paths"] == ["port_bench"]
    cells = {w["name"]: w for w in b["workloads"]}
    assert set(cells) <= set(spec.names("cells"))
    rates, routes = {}, {}
    for name, w in cells.items():
        c = spec.cell(name)
        keys = ("config", "traffic", "chips", "why")
        assert [w[k] for k in keys] == [c.cell[k] for k in keys]
        rates[name] = spec.family(c).RATE
        routes[name] = c.traffic["solver"]
    for cfg in b["configs"]:
        c = json.loads((REPO / cfg["file"]).read_text())
        assert (c["name"], c["source"], c["reduced"]) == (
            cfg["name"], cfg["source"], cfg["reduced"])
    assert {cfg["name"] for cfg in b["configs"]} == {
        w["config"] for w in cells.values()}
    readers = spec.metrics()
    listed = {n for n, r in readers.items()
              if set(r.ROUTES) & set(routes.values())}
    assert {m["name"] for m in b["per_layer"]} == listed
    for m in b["per_layer"]:
        r = readers[m["name"]]
        keys = ("layer", "unit", "better", "source", "moves")
        assert [m[k] for k in keys] == [getattr(r, k.upper()) for k in keys]
        assert set(m["workloads"]) == {n for n in cells
                                       if routes[n] in r.ROUTES}
        assert all(rates[n][0] == r.MOVES for n in m["workloads"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert set(e2e) == {r for r, _ in rates.values()} | {"setup_s"}
    for name, (rate, unit) in rates.items():
        assert e2e[rate]["unit"] == unit
        assert name in e2e[rate].get("workloads", cells)


def test_benchmark_json_keeps_the_contracts_shapes():
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("port_bench/") and len(c["source"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and name.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in b["end_to_end"] + b["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(b)) <= 64 * 1024
