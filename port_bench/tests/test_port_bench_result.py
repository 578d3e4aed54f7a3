"""The last line's schema, the trace's arithmetic, and a run without a
card."""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import run, spec
from port_bench.trace import DeviceOp, Trace

import pb_tiny

REPO = Path(spec.ROOT).parent


def _op(name, start, dur, owner="aten::add", bmm=None, oid=1):
    return DeviceOp(name=name, start_ns=start, dur_ns=dur, owner=owner,
                    owner_id=oid, bmm=bmm)


def test_trace_busy_idle_and_gj_split():
    ops = [_op("gj_panel_kernel<2, false>", 0, 10, "pe_gj_inverse32"),
           _op("void gj_update_kernel<true>(float const*)", 10, 30,
               "pe_gj_inverse32"),
           _op("elementwise", 50, 10),                       # idle 40..50
           _op("gj_panel_kernel<2, false>", 60, 5, "pe_gj_solve32"),
           _op("void gj_update_kernel<false>(float const*)", 62, 8,
               "pe_gj_solve32")]
    t = Trace(window_ns=100, ops=ops, steps=2,
              calls=[("pe_gj_inverse32", 4, 128),
                        ("pe_gj_solve32", 4, 128)],
              counters={"refactors": 1, "bursts": 1, "steps": 2})
    assert t.busy_ns() == 40 + 10 + 10
    assert dict(t.idle_gaps()) == {"aten::add": 10}
    assert t.gj_ns() == {"inverse": 40, "solve": 13}
    m = spec.metrics()
    assert m["device_idle_pct"].read(t) == 40.0
    assert m["device_ops_per_step"].read(t) == 2.5
    assert m["refactors_per_step"].read(t) == 0.5
    assert m["gj_inverse_roofline"].read(t) > 0
    assert m["ns_gemm_roofline"].read(t) is None


def test_ns_gemm_counts_each_product_once_and_skips_matvecs():
    sq = (8, 128, 128, 128)
    mv = (8, 128, 128, 1)
    ops = [_op("gemm_a", 0, 100, "aten::bmm", sq, oid=7),
           _op("gemm_b", 100, 100, "aten::bmm", sq, oid=7),
           _op("gemv", 200, 50, "aten::bmm", mv, oid=8)]
    t = Trace(window_ns=300, ops=ops, steps=1, calls=[])
    from port_bench import roofline
    want = 100.0 * roofline.bmm_s(8, 128, 128, 128) / 200e-9
    assert math.isclose(spec.metrics()["ns_gemm_roofline"].read(t), want)


def _out(traced, c=None):
    out = run.bench(c or pb_tiny.cell(), 12345678901, 0.0, traced, "cpu")
    return run.result_line(out, traced, "cpu", "cpu", 1)


@pytest.mark.parametrize("kind, rate, attempted", [
    ("transient", "circuit_steps_per_s", 4), ("dc", "dc_solves_per_s", 3)])
def test_result_line_schema(kind, rate, attempted):
    res = _out(False, pb_tiny.cell() if kind == "transient"
               else pb_tiny.mesh_cell())
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True
    assert res["attempted"] == attempted and res["failed"] == 0
    assert set(res["metrics"]) == {rate, "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}, name
    json.loads(json.dumps(res, allow_nan=False))


@pytest.mark.parametrize("kind", ["transient", "dc"])
def test_traced_result_line_schema(kind):
    res = _out(True, pb_tiny.cell() if kind == "transient"
               else pb_tiny.mesh_cell())
    assert list(res)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU trace holds no device operation: only the counters read
    assert set(res["metrics"]) <= set(spec.names("metrics"))


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "mesh100k.dc",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0
    assert p.stdout == ""


@pytest.mark.parametrize("kind", ["transient", "dc"])
def test_readings_write_the_program_and_the_control(tmp_path, monkeypatch,
                                                    kind):
    from port_bench import readings
    tiny = pb_tiny.cell() if kind == "transient" else pb_tiny.mesh_cell()
    monkeypatch.setattr(spec, "cell", lambda name: tiny)
    out = tmp_path / "r.jsonl"
    assert readings.main(["--workload", "x", "--seeds", "3,4", "--jobs", "2",
                          "--out", str(out), "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [d["seed"] for d in lines] == [3, 4]
    fam = spec.family(tiny)
    for d in lines:
        assert set(d["program"]) == set(tiny.cell["check"]["limits"]) | set(
            fam.ZERO)
        assert len(d["job_s"]) == 2
        for name in tiny.cell["check"]["limits"]:
            # at 31 stages the transient's float32 arithmetic sits inside
            # the program's SPICE tolerances; the DC solve's does not
            assert d["control"][name] > (d["program"][name] if kind == "dc"
                                         else 0.0)
