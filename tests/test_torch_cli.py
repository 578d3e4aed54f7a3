"""The port's CLIs (``python -m phy_engine_tpu_torch.cli.verilog2penl`` /
``verilog2plsav``) against the JAX package's: ``tests/test_cli.py``'s
three cases and ``tests/test_synth_budgets.py::
test_cli_budget_and_export_flags`` through the port, and the files each
port CLI writes equal to the JAX CLI's for the same arguments (the
``.sav`` under the same ``random`` seed)."""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

from phy_engine_tpu.cli.verilog2penl import main as jv2penl
from phy_engine_tpu.cli.verilog2plsav import main as jv2plsav
from phy_engine_tpu_torch.cli.verilog2penl import main as v2penl
from phy_engine_tpu_torch.cli.verilog2plsav import main as v2plsav
from phy_engine_tpu_torch.io import load

from test_cli import SRC as BLINK
from test_synth_budgets import SRC as BLK

ROOT = Path(__file__).resolve().parents[1]


def _kinds(path):
    return [m.mdef.id_name for m in load(str(path),
                                         device="cpu").nl.live_models()]


def test_verilog2penl_synth(tmp_path):
    vfile = tmp_path / "blink.v"
    vfile.write_text(BLINK)
    out = tmp_path / "blink.penl"
    assert v2penl([str(out), str(vfile), "--top", "blink", "--report"]) == 0
    kinds = _kinds(out)
    assert "DFF_ARSTN" in kinds
    assert kinds.count("INPUT") >= 2
    # the reference's default: an existing output is not overwritten
    assert v2penl([str(out), str(vfile), "--top", "blink"]) == 1
    assert v2penl([str(out), str(vfile), "--top", "blink",
                   "--overwrite"]) == 0


def test_verilog2penl_module(tmp_path):
    vfile = tmp_path / "blink.v"
    vfile.write_text(BLINK)
    out = tmp_path / "blink_vm.penl"
    assert v2penl([str(out), str(vfile), "--top", "blink", "--module"]) == 0
    assert "VERILOG" in _kinds(out)


def test_verilog2plsav(tmp_path):
    vfile = tmp_path / "blink.v"
    vfile.write_text(BLINK)
    out = tmp_path / "blink.sav"
    assert v2plsav([str(out), str(vfile), "--top", "blink"]) == 0
    with open(out, encoding="utf-8") as f:
        root = json.load(f)
    ids = [e["ModelID"] for e in json.loads(
        root["Experiment"]["StatusSave"])["Elements"]]
    assert "D Flipflop" in ids
    assert "Logic Input" in ids


def _port_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "phy_engine_tpu_torch.cli.verilog2penl",
         *map(str, args)], capture_output=True, text=True, timeout=600,
        cwd=ROOT)


def test_cli_budget_and_export_flags(tmp_path):
    """The budget flag family and the --mode / --layout / --no-io export
    options, the port's CLI run as a module."""
    vfile = tmp_path / "blk.v"
    vfile.write_text(BLK)
    out_dir = tmp_path / "out_penl"
    r = _port_cli(out_dir, vfile, "--top", "blk", "--synth", "-O3",
                  "--assume-binary-inputs", "--sweep-max-pairs", "0",
                  "--qm-max-vars", "6", "--no-dc-odc", "--layout", "dir",
                  "--mode", "full", "--report")
    assert r.returncode == 0, r.stderr
    assert "tt_sweep" not in r.stderr      # budget 0 disabled the pass
    assert "gates:" in r.stderr
    assert (out_dir / "structure.json").exists()
    assert (out_dir / "runtime.json").exists()
    out2 = tmp_path / "noio.penl"
    r2 = _port_cli(out2, vfile, "--top", "blk", "--no-io")
    assert r2.returncode == 0, r2.stderr
    assert not {"INPUT", "OUTPUT"} & set(_kinds(out2))
    r3 = _port_cli(tmp_path / "bad.penl", tmp_path / "bad.v")
    assert r3.returncode != 0


PENL_CASES = {
    "blink-O0": (BLINK, ["--top", "blink"]),
    "blink-O1-report": (BLINK, ["--top", "blink", "-O1", "--report"]),
    "blink-module": (BLINK, ["--top", "blink", "--module"]),
    "blk-O3-budgets-dir": (BLK, ["--top", "blk", "-O3",
                                 "--assume-binary-inputs",
                                 "--sweep-max-pairs", "0",
                                 "--qm-max-vars", "6", "--no-dc-odc",
                                 "--layout", "dir"]),
    "blk-O2-structure-noio": (BLK, ["--top", "blk", "-O2", "--mode",
                                    "structure", "--no-io"]),
    "blk-O1-checkpoint": (BLK, ["--top", "blk", "-O1", "--mode",
                                "checkpoint"]),
}


def _read(path):
    if path.is_dir():
        return {p.name: p.read_text() for p in sorted(path.iterdir())}
    return path.read_text(encoding="utf-8")


@pytest.mark.parametrize("case", sorted(PENL_CASES))
def test_penl_equals_jax_cli(tmp_path, case, capfd):
    """The same arguments give the same file and the same report."""
    src, args = PENL_CASES[case]
    vfile = tmp_path / "in.v"
    vfile.write_text(src)
    got = []
    for tag, fn in (("jax", jv2penl), ("torch", v2penl)):
        out = tmp_path / f"{tag}.penl"
        assert fn([str(out), str(vfile), *args]) == 0
        got.append((_read(out), capfd.readouterr().err))
    assert got[0][0] == got[1][0]
    # the reports agree but for the per-pass wall times
    strip = [[line.rsplit(" ms", 1)[0].rsplit(None, 1)[0] if " ms" in line
              else line for line in err.splitlines()] for _, err in got]
    assert strip[0] == strip[1]


@pytest.mark.parametrize("args", [["-O1"], ["-O0", "--layout", "quality",
                                            "--name", "scene"]])
def test_sav_equals_jax_cli(tmp_path, args):
    vfile = tmp_path / "blink.v"
    vfile.write_text(BLINK)
    got = []
    for tag, fn in (("jax", jv2plsav), ("torch", v2plsav)):
        out = tmp_path / tag / "blink.sav"
        out.parent.mkdir()
        random.seed(2024)
        assert fn([str(out), str(vfile), "--top", "blink", *args]) == 0
        got.append(out.read_text(encoding="utf-8"))
    assert got[0] == got[1]
    assert os.path.getsize(tmp_path / "torch" / "blink.sav") > 0
