"""Guards of the PyTorch port: it never pulls in JAX (or triton) and never
points into the JAX package's directory, its kernel loader never hands
back a stand-in, and ``chip_smoke.py`` fails loudly — with no success
line — where there is no card or no repo."""

import ast
import contextlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from phy_engine_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]

def _run(args, cwd, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax():
    """Every module of the package, found by walking it (a module added
    later is covered too), imports without pulling in jax, the JAX
    package or triton."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import phy_engine_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                              pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert 'phy_engine_tpu_torch.digital.turbo' in mods, mods\n"
        "assert 'phy_engine_tpu_torch.verilog.synth' in mods, mods\n"
        "assert 'phy_engine_tpu_torch.ops.lu_block' in mods, mods\n"
        "for m in ('engine.circuit', 'models.sources', 'models.controller',\n"
        "          'parallel.batch', 'ops.linsolve', 'engine.noise',\n"
        "          'engine.sens', 'models.bsim3', 'models.dual',\n"
        "          'digital.engine', 'digital.flash', 'digital.ir',\n"
        "          'models.verilog_module', 'ops.sparse', 'ops.tridiag',\n"
        "          'verilog.opt_graph', 'verilog.opt_map', 'native',\n"
        "          'digital.native_run', 'parallel.mesh', 'parallel.dist_gj',\n"
        "          'parallel.dist_newton', 'parallel.tt_mesh',\n"
        "          'parallel.dryrun'):\n"
        "    assert 'phy_engine_tpu_torch.' + m in mods, mods\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'phy_engine_tpu', 'triton'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = _run(["-c", code], cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr


def test_make_mesh_on_cuda_raises_without_a_card():
    """make_mesh(device_type="cuda") without a card raises and starts no
    process group: it never falls back to gloo."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    code = (
        "import torch.distributed as dist\n"
        "from phy_engine_tpu_torch.parallel.mesh import make_mesh\n"
        "try:\n"
        "    make_mesh(device_type='cuda')\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('make_mesh(cuda) returned a mesh')\n"
        "assert not dist.is_initialized(), dist.get_backend()\n"
        "m = make_mesh(device_type='cpu')\n"
        "assert dist.get_backend() == 'gloo' and m.device_type == 'cpu'\n")
    res = _run(["-c", code], cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr


def _no_success_line(res):
    lines = res.stdout.strip().splitlines()
    return not any('"ok": true' in ln for ln in lines)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    res = _run(["chip_smoke.py"], cwd=ROOT)
    assert res.returncode != 0
    assert _no_success_line(res), res.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(["chip_smoke.py"], cwd=tmp_path)
    assert res.returncode != 0
    assert _no_success_line(res), res.stdout


def test_kernel_loader_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _build.load_library()


def test_kernel_launcher_passes_pointers_and_the_stream_and_raises(
        monkeypatch):
    """``_build.launcher`` over a stand-in library and device: a tensor
    goes as its data pointer, the device's stream, taken once, ends every
    launch; a non-zero return raises with the library's error string; a
    query returns its count and raises on a negative one."""
    calls, streams = [], []

    class Lib:
        def pe_ok(self, *args):
            calls.append(args)
            return 0

        def pe_bad(self, *args):
            return 700

        def pe_count(self, n):
            return n

        def pe_cuda_error_string(self, err):
            return b"an illegal memory access was encountered"

    class Stream:
        cuda_stream = 1234

    monkeypatch.setattr(_build, "load_library", Lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: streams.append(dev) or Stream())
    t = torch.zeros(3)
    with _build.launcher("cuda:0") as launch:
        launch("pe_ok", t, None, 5)
        launch("pe_ok", t)
        assert launch.query("pe_count", 7) == 7
        with pytest.raises(RuntimeError,
                           match=r"pe_bad failed: CUDA error 700 \(an il"):
            launch("pe_bad", t)
        with pytest.raises(RuntimeError, match="pe_count failed: CUDA error 3"):
            launch.query("pe_count", -3)
    assert streams == ["cuda:0"]
    (p1, none, five, s1), (p2, s2) = calls
    assert p1 == p2 == t.data_ptr() and none is None and five == 5
    assert s1.value == s2.value == 1234


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").iterdir())


_JAX_DIR = re.compile(r"(?<![\w.])phy_engine_tpu(?:[/\\]|$)")


def _code_strings(tree):
    """The string constants of a module's code (docstrings excepted)."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and \
                    isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_port_names_no_path_in_the_jax_package(monkeypatch, tmp_path):
    """No file of the port points into ``phy_engine_tpu/``: no string its
    code uses names that directory, no C++ / CUDA source includes from
    it, and the sources the loaders compile (the kernels of ``ops/csrc``
    and the host libraries of ``native``) are the port's own files."""
    pkg = ROOT / "phy_engine_tpu_torch"
    bad = []
    for path in sorted(pkg.rglob("*.py")):
        for s in _code_strings(ast.parse(path.read_text())):
            if _JAX_DIR.search(s):
                bad.append(f"{path.relative_to(ROOT)}: {s!r}")
    for path in sorted(p for ext in ("*.cpp", "*.cu", "*.h", "*.cuh")
                       for p in pkg.rglob(ext)):
        for line in path.read_text().splitlines():
            if line.lstrip().startswith("#include") and "phy_engine_tpu" in line:
                bad.append(f"{path.relative_to(ROOT)}: {line.strip()}")
    assert not bad, bad

    from phy_engine_tpu_torch import native
    srcs = [_build.CSRC / name for name in _build.SOURCES]
    srcs += [native.SRC_DIR / src for src, _flags in native.LIBS.values()]
    for src in srcs:
        assert src.resolve().is_relative_to(pkg), src
    # what the host build hands g++: the port's sources, into build/
    cmds = []
    real_run = subprocess.run

    def run(cmd, *a, **k):
        cmds.append(cmd)
        return real_run(cmd, *a, **k)

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.subprocess, "run", run)
    for name in native.LIBS:
        assert native.build(name).parent == tmp_path
    assert len(cmds) == len(native.LIBS)
    for cmd in cmds:
        cpp = [Path(a) for a in cmd if a.endswith(".cpp")]
        assert cpp and all(p.resolve().is_relative_to(pkg) for p in cpp), cmd
