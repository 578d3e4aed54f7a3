"""Guards of the PyTorch port: it never pulls in JAX (or triton), its
kernel loader never hands back a stand-in, and ``chip_smoke.py`` fails
loudly — with no success line — where there is no card or no repo."""

import os
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
        "          'models.verilog_module', 'ops.sparse', 'ops.tridiag'):\n"
        "    assert 'phy_engine_tpu_torch.' + m in mods, mods\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'phy_engine_tpu', 'triton'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
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


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").iterdir())
