"""On the card: the trace gives each device kernel to the call that
launched it, and the readers find what they read."""

import pytest
import torch

from port_bench import spec
from port_bench import trace as tr


@pytest.mark.card
def test_trace_gives_kernels_to_their_calls(cuda):
    from torch.profiler import record_function

    from phy_engine_tpu_torch.engine import analog

    g = torch.Generator(device=cuda).manual_seed(5)
    B, n = 8, 256
    A = (torch.rand((B, n, n), generator=g, device=cuda)
         + n * torch.eye(n, device=cuda)).contiguous()
    b = torch.rand((B, n), generator=g, device=cuda)
    # as the harness warms up: a first launch is traced under the CUDA
    # runtime's lazy loading, not under its operator
    analog.FROZEN_INVERSES["gj"](A)
    analog.gj_solve32(A, b)
    torch.bmm(A, A)
    torch.cuda.synchronize()
    calls = []
    prof = tr.profiler()
    with tr.marks(calls), prof, record_function(tr.JOB):
        analog.FROZEN_INVERSES["gj"](A)
        analog.gj_solve32(A, b)
        torch.bmm(A, A)
        torch.cuda.synchronize()
    t = tr.reduce(prof, 1, calls)
    assert calls == [("pe_gj_inverse32", B, n), ("pe_gj_solve32", B, n)]
    ns = t.gj_ns()
    assert ns["inverse"] > 0 and ns["solve"] > 0
    # each call: n / 32 panels, each followed by its update
    names = [op.name for op in t.ops if "gj_" in op.name]
    assert len(names) == 4 * n // 32
    assert sum("gj_update_kernel<true>" in x for x in names) == n // 32
    assert sum("gj_update_kernel<false>" in x for x in names) == n // 32
    gemms = [op for op in t.ops if "gemm" in op.name]
    assert gemms and {op.owner for op in gemms} == {"aten::bmm"}
    assert {op.bmm for op in gemms} == {(B, n, n, n)}
    readers = spec.metrics()
    for name in ("gj_inverse_roofline", "gj_solve_roofline",
                 "ns_gemm_roofline"):
        v = readers[name].read(t)
        assert v is not None and 0.0 < v < 105.0, (name, v)
    assert 0.0 <= readers["device_idle_pct"].read(t) < 100.0


@pytest.mark.card
def test_dc_readers_read_a_traced_solve(cuda):
    """A traced DC sweep on the card at a tenth of the cell's nodes: the
    wrapper records the solver's iterations, the readers read them."""
    import pb_tiny

    from port_bench import run
    out = run.bench(pb_tiny.mesh_cell(nodes=10000, links=1000), 9, 0.0, True,
                    cuda)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == {"bicgstab_iterations", "dc_ops_per_iteration",
                      "dc_device_idle_pct"}
    assert m["bicgstab_iterations"] >= 8 and m["dc_ops_per_iteration"] > 1
    assert 0.0 <= m["dc_device_idle_pct"] < 100.0
    assert 0.0 < out["busy_s"] <= out["traced_s"]
