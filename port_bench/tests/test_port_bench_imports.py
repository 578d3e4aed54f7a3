"""The benchmark loads neither JAX nor the JAX package, and its reference
loads nothing of the program.  Top-level module names are compared whole:
``phy_engine_tpu_torch`` is the port, ``phy_engine_tpu`` the JAX package."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from port_bench import run, spec

PKG = Path(spec.ROOT)
REPO = PKG.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "phy_engine_tpu", "__graft_entry__"}


def _top_imports(path: Path):
    """Top-level names of the absolute imports of a source file."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        assert not (_top_imports(path) & FORBIDDEN), path


def test_run_checks_whole_top_level_names():
    assert set(run.FORBIDDEN) == FORBIDDEN
    assert "phy_engine_tpu_torch" not in run.FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        assert "phy_engine_tpu_torch" not in _top_imports(path), path
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                # relative imports reach only the numpy description
                assert node.module in (None, "ladder", "mesh"), (
                    path, node.module)
    for name in ("ladder.py", "mesh.py"):
        assert _top_imports(PKG / name) <= {"__future__", "dataclasses",
                                            "numpy"}, name


def _loaded_after(code: str):
    p = subprocess.run(
        [sys.executable, "-c",
         "import sys\nsys.path.insert(0, %r)\n" % str(REPO) + code +
         "\nimport json\nprint(json.dumps(sorted({m.split('.')[0] "
         "for m in list(sys.modules)})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_module():
    loaded = _loaded_after(
        "sys.path.insert(0, %r)\n" % str(PKG / "tests") +
        "import pb_tiny\nfrom port_bench import run\n"
        "for c in (pb_tiny.cell(), pb_tiny.mesh_cell()):\n"
        "    out = run.bench(c, 7, 0.0, True, 'cpu')\n"
        "    assert out['correct'], out")
    assert "phy_engine_tpu_torch" in loaded
    assert not (loaded & FORBIDDEN), loaded & FORBIDDEN


def test_the_reference_alone_loads_nothing_of_the_program():
    loaded = _loaded_after(
        "import numpy as np\n"
        "from port_bench import ladder, spec\n"
        "from port_bench.reference import ladder_tr\n"
        "c = spec.cell('ladder255.mc4096').config\n"
        "lad = ladder.build(dict(c, stages=8, links=2))\n"
        "ladder_tr.transient(lad, lad.r_nom[None], 3, 5e-8)\n"
        "from port_bench import mesh\n"
        "from port_bench.reference import mesh_dc\n"
        "c = spec.cell('mesh100k.dc').config\n"
        "mesh_dc.solve(mesh.build(dict(c, nodes=50, links=5)))")
    assert not (loaded & (FORBIDDEN | {"phy_engine_tpu_torch"}))
