"""CUDA tests of the PyTorch port: the hand-written kernels against their
plain torch versions, the small frozen transient (both refactors) on the
card against the CPU path, RV32 through Circuit.digital_run on the
card, the analog Circuit driver's analyses on the card against the
CPU, and BSIM3 (its hooks, the chain's rescue ladder, noise and
sensitivity) on the card against the CPU, and the levelled digital tick,
mixed signal (the SAR ADC, the Tsu/Th automata, VERILOG_MODULE) and the
flash engine on the card against the CPU and the turbo kernel, RV32
synthesized at -O2 through the turbo kernel against the levelled tick and
the host sweep engine, and the -O2 core written by ``cli.verilog2penl``
and loaded by ``io.load`` through the turbo kernel.  Marked
``cuda``; each skips on a host without a CUDA
device.  This file imports neither JAX nor the JAX package, so it runs
on a machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: kernels ``gj_cases.TOL`` (1e-4) relative to max|x| of the
lane (the blocked kernels sum in another order than their plain
versions; a repeat run of a kernel is bit-identical); the transient 1e-6
relative to max|trace|; the turbo kernel none (bit-identical: exact
integer logic); the Circuit driver's analyses 1e-6 relative to
max|x| of the CPU result (the same f64 algorithm; the card's sin/exp may
differ in the last ulps), repeat runs bit-identical.
"""

import functools

import numpy as np
import pytest
import torch

from phy_engine_tpu_torch import workloads
from phy_engine_tpu_torch.digital import turbo, turbo_cases
from phy_engine_tpu_torch.engine import analog
from phy_engine_tpu_torch.ops import gj, lu_block
from phy_engine_tpu_torch.ops.gj_cases import TOL, lane_rel_err, singular_lane, system
from phy_engine_tpu_torch.parallel.batch import batch_params, batch_state, batch_x

import phy_engine_tpu_torch as tpe
from phy_engine_tpu_torch.engine import circuit as tcircuit

from torch_circuits import (build, build_port, diode_load, divider,
                            mesh_routes_run, random_link_mesh_ir)
import bsim3_cases
import torch_digital_cases as dc

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "mna_border", "singular"])
@pytest.mark.parametrize("B,n", [(8, 128), (16, 256), (3, 512)])
def test_kernels_match_plain(cuda, B, n, case):
    A, b = system(case, B, n, seed=B + n)
    Ad, bd = torch.from_numpy(A).to(cuda), torch.from_numpy(b).to(cuda)
    s = singular_lane(B)
    good = [i for i in range(B) if case != "singular" or i != s]
    before = (gj.gj_solve32.launches, gj.gj_inverse32.launches)
    pairs = ((gj.gj_solve32(Ad, bd), gj.gj_solve32_plain(Ad, bd)),
             (gj.gj_inverse32(Ad), gj.gj_inverse32_plain(Ad)))
    torch.cuda.synchronize()
    assert (gj.gj_solve32.launches, gj.gj_inverse32.launches) == (
        before[0] + 1, before[1] + 1)
    for kern, plain in pairs:
        k, p = kern.cpu().numpy(), plain.cpu().numpy()
        assert np.isfinite(k[good]).all()
        assert lane_rel_err(k[good], p[good]).max() <= TOL
        if case == "singular":
            assert not np.isfinite(k[s]).all()
            assert not np.isfinite(p[s]).all()


GJ_KERNELS = {"inverse": (gj.gj_inverse32, gj.gj_inverse32_plain),
              "solve": (gj.gj_solve32, gj.gj_solve32_plain)}


def _gj_call(fn, kind, Ad, bd):
    return fn(Ad) if kind == "inverse" else fn(Ad, bd)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,case", [
    (4, 256, "random"), (4, 256, "mna_border"), (4, 256, "singular"),
    (4, 256, "block_singular"),
    (2, 1024, "random"), (2, 1024, "mna_border"), (2, 1024, "singular"),
    (3, 384, "mna_border"), (2, 640, "random"), (2, 768, "singular"),
    (2, 1152, "random"), (2, 1152, "mna_border"), (2, 1152, "singular"),
    (2, 2048, "random"), (1, 4096, "random")])
@pytest.mark.parametrize("kind", ["inverse", "solve"])
def test_gj_kernel_matches_plain_and_numpy(cuda, kind, B, n, case):
    """The blocked kernels against their plain versions and float64 numpy,
    one launch per call, at n = 256 (one panel row a thread), 384 (a
    second row for half the threads), 640 and 768 (three rows), 1024
    (four rows), and past one block: a cluster of two blocks at 1152 (768
    and 384 rows) and 2048, four at 4096; the global pivot search inverts
    the block-singular lane.
    (That lane's condition number grows with n: at
    n = 1024 it is 5.6e4 and the plain version alone lies 2e-4 from
    float64 numpy, beyond TOL, so the case runs at n = 256.)"""
    A, b = system(case, B, n, seed=B + n + 1)
    Ad, bd = torch.from_numpy(A).to(cuda), torch.from_numpy(b).to(cuda)
    kern, plain = GJ_KERNELS[kind]
    s = singular_lane(B)
    good = [i for i in range(B) if case != "singular" or i != s]
    before = kern.launches
    k = _gj_call(kern, kind, Ad, bd)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    p = _gj_call(plain, kind, Ad, bd)
    k, p = k.cpu().numpy(), p.cpu().numpy()
    A64 = A[good].astype(np.float64)
    ref = (np.linalg.inv(A64) if kind == "inverse" else
           np.linalg.solve(A64, b[good].astype(np.float64)[..., None])[..., 0])
    assert np.isfinite(k[good]).all()
    assert lane_rel_err(k[good], p[good]).max() <= TOL
    assert lane_rel_err(k[good], ref).max() <= TOL
    if case == "singular":
        assert not np.isfinite(k[s]).all()
        assert not np.isfinite(p[s]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["inverse", "solve"])
def test_gj_kernel_is_deterministic(cuda, kind):
    A, b = system("mna_border", 16, 256, seed=5)
    Ad, bd = torch.from_numpy(A).to(cuda), torch.from_numpy(b).to(cuda)
    kern, _plain = GJ_KERNELS[kind]
    assert torch.equal(_gj_call(kern, kind, Ad, bd),
                       _gj_call(kern, kind, Ad, bd))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["inverse", "solve"])
def test_gj_cluster_kernel_is_deterministic(cuda, kind):
    A, b = system("random", 2, 2048, seed=6)
    Ad, bd = torch.from_numpy(A).to(cuda), torch.from_numpy(b).to(cuda)
    kern, _plain = GJ_KERNELS[kind]
    assert torch.equal(_gj_call(kern, kind, Ad, bd),
                       _gj_call(kern, kind, Ad, bd))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["inverse", "solve"])
@pytest.mark.parametrize("n", [6144, 8192])
def test_gj_cluster_kernel_residual_at_six_and_eight_blocks(cuda, kind, n):
    """Clusters of six and eight blocks (8192, the largest n the kernels
    take) on one random lane, by the residual in float64: max|A X - I|
    for the inverse, max|A x - b| / max|b| for the solve."""
    A, b = system("random", 1, n, seed=n)
    Ad, bd = torch.from_numpy(A).to(cuda), torch.from_numpy(b).to(cuda)
    out = _gj_call(GJ_KERNELS[kind][0], kind, Ad, bd).double()
    A64 = Ad.double()
    if kind == "inverse":
        eye = torch.eye(n, dtype=torch.float64, device=cuda)
        res = float((A64 @ out - eye).abs().max())
    else:
        r = (A64 @ out[:, :, None])[:, :, 0] - bd.double()
        res = float(r.abs().max() / bd.double().abs().max())
    assert res <= TOL, res


@pytest.mark.cuda
def test_gj_wrappers_reject_what_the_kernel_does_not_take(cuda):
    n = gj.MAX_N + gj.NB                        # 8320: past 8 blocks of 1024
    Ad = torch.zeros((1, n, n), device=cuda)
    bd = torch.zeros((1, n), device=cuda)
    with pytest.raises(ValueError, match="n <= 8192"):
        gj.gj_inverse32(Ad)
    with pytest.raises(ValueError, match="n <= 8192"):
        gj.gj_solve32(Ad, bd)
    A, _b = system("random", 1, 128)
    buf = torch.empty(128 * 128 + 4, device=cuda)
    shifted = buf[1:1 + 128 * 128].view(1, 128, 128)
    shifted.copy_(torch.from_numpy(A).to(cuda))
    with pytest.raises(ValueError, match="aligned"):
        gj.gj_inverse32(shifted)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "mna_border", "singular",
                                  "block_singular"])
@pytest.mark.parametrize("B,n", [(8, 128), (4, 256), (2, 1024), (4, 96),
                                 (4, 160), (2, 512)])
def test_lu_block_kernel_matches_plain(cuda, B, n, case):
    A, _b = system(case, B, n, seed=B + n)
    Ad = torch.from_numpy(A).to(cuda)
    s = singular_lane(B)
    bad = case in ("singular", "block_singular")
    good = [i for i in range(B) if not bad or i != s]
    before = lu_block.lu_block_inverse32.launches
    k = lu_block.lu_block_inverse32(Ad)
    p = lu_block.lu_block_inverse32_plain(Ad)
    torch.cuda.synchronize()
    assert lu_block.lu_block_inverse32.launches == before + 1
    k, p = k.cpu().numpy(), p.cpu().numpy()
    assert np.isfinite(k[good]).all()
    assert lane_rel_err(k[good], p[good]).max() <= TOL
    ref = np.linalg.inv(A[good].astype(np.float64))
    assert lane_rel_err(k[good], ref).max() <= TOL
    if bad:
        assert not np.isfinite(k[s]).all()
        assert not np.isfinite(p[s]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "mna_border", "singular",
                                  "block_singular"])
@pytest.mark.parametrize("n", [96, 160, 256, 1024])
def test_lu_block_kernel_repeat_runs_are_bit_identical(cuda, n, case):
    """One super-panel of 96 (n % 128 != 0), 128 + 32, 2 x 128, and eight
    super-panels split over a cluster of four blocks."""
    A, _b = system(case, 2, n, seed=n + 1)
    Ad = torch.from_numpy(A).to(cuda)
    a = lu_block.lu_block_inverse32(Ad)
    b = lu_block.lu_block_inverse32(Ad)
    torch.cuda.synchronize()
    assert torch.equal(torch.nan_to_num(a, 1.0, 2.0, 3.0),
                       torch.nan_to_num(b, 1.0, 2.0, 3.0))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2080, 6144, 6176])
def test_lu_block_kernel_past_the_widest_on_chip_panel(cuda, n):
    """The kernel's plans past n = 2048 (one lane, random): 64-wide
    super-panels at 2080, 32-wide at 6144 (the largest panel on chip),
    and at 6176 the panel in global scratch with 128-wide super-panels,
    the last one 32 wide.  Against the plain version on the card and
    float64 numpy; a repeat run bit-identical."""
    A, _b = system("random", 1, n, seed=n)
    Ad = torch.from_numpy(A).to(cuda)
    k = lu_block.lu_block_inverse32(Ad)
    again = lu_block.lu_block_inverse32(Ad)
    p = lu_block.lu_block_inverse32_plain(Ad)
    torch.cuda.synchronize()
    assert torch.equal(k, again)
    k, p = k.cpu().numpy(), p.cpu().numpy()
    assert np.isfinite(k).all()
    assert lane_rel_err(k, p).max() <= TOL
    ref = np.linalg.inv(A.astype(np.float64))
    assert lane_rel_err(k, ref).max() <= TOL


@pytest.mark.cuda
def test_lu_block_kernel_is_deterministic(cuda):
    A, _b = system("random", 16, 256, seed=3)
    Ad = torch.from_numpy(A).to(cuda)
    assert torch.equal(lu_block.lu_block_inverse32(Ad),
                       lu_block.lu_block_inverse32(Ad))


@pytest.mark.cuda
def test_lu_block_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    A, _b = system("random", 2, 128)
    Ad = torch.from_numpy(A).to(cuda)
    with pytest.raises(ValueError):
        lu_block.lu_block_inverse32(Ad, nb=16)        # the kernel takes 32
    buf = torch.empty(Ad.numel() + 4, device=cuda)
    shifted = buf[1:1 + Ad.numel()].view(2, 128, 128)
    shifted.copy_(Ad)
    with pytest.raises(ValueError):                   # not 16-byte aligned
        lu_block.lu_block_inverse32(shifted)


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices(cuda):
    A, b = system("random", 2, 128)
    with pytest.raises(ValueError):
        gj.gj_solve32(torch.from_numpy(A).to(cuda), torch.from_numpy(b))


@pytest.mark.cuda
@pytest.mark.parametrize("inv", ["gj", "block"])
def test_frozen_transient_card_matches_cpu(cuda, inv):
    ir = workloads.build_diode_ladder(63)
    params = batch_params(ir, 4, jitter={"R": {"r": 0.05}},
                          generator=torch.Generator().manual_seed(11))
    traces = []
    for dev in ("cpu", cuda):
        _x, _st, ok, tr = analog.transient_batched(
            ir, {k: v.to(dev) for k, v in params.items()},
            batch_x(ir, 4, dev), batch_state(ir, 4, dev),
            workloads.default_env(), 0.0, workloads.DT, 10, solver="frozen",
            keep_trace=True, inv=inv)
        assert bool(ok.all())
        traces.append(tr.cpu())
    rel = (traces[1] - traces[0]).abs().max() / traces[0].abs().max()
    assert rel <= 1e-6, float(rel)


@pytest.mark.cuda
@pytest.mark.parametrize("inv", ["gj", "block"])
def test_frozen_transient_past_1024_unknowns_card_matches_cpu(cuda, inv):
    """The 1151-stage ladder (1152 unknowns: the GJ panel launches are
    clusters, lu_block's panel rows split over five blocks), B = 2, 3
    steps: every lane converges, card against CPU to 1e-6."""
    ir = workloads.build_diode_ladder(1151)
    params = batch_params(ir, 2, jitter={"R": {"r": 0.05}},
                          generator=torch.Generator().manual_seed(12))
    out = []
    for dev in ("cpu", cuda):
        x, _st, ok = analog.transient_batched(
            ir, {k: v.to(dev) for k, v in params.items()},
            batch_x(ir, 2, dev), batch_state(ir, 2, dev),
            workloads.default_env(), 0.0, workloads.DT, 3, solver="frozen",
            inv=inv)[:3]
        assert bool(ok.all())
        out.append(x.cpu())
    rel = (out[1] - out[0]).abs().max() / out[0].abs().max()
    assert rel <= 1e-6, float(rel)


@pytest.mark.cuda
@pytest.mark.parametrize("force_global", [False, True],
                         ids=["shared", "global"])
def test_turbo_kernel_matches_plain_fp16(cuda, force_global):
    """Random V/U words with X and Z lanes, B = 4, 16 ticks, in both
    state placements; full history and a watch list."""
    plan, st0, FV, FU = turbo_cases.fp16_case(4, 16, seed=5, device=cuda)
    watch = list(range(0, plan.S, 7))
    for w in (None, watch):
        before = turbo.run_turbo.launches
        hv, hu = turbo.run_turbo(plan, st0, FV, FU, watch=w,
                                 _force_global=force_global)
        pv, pu = turbo.run_turbo_plain(plan, st0, *plan.pad_forced(FV, FU),
                                       None if w is None else
                                       torch.tensor(w, device=cuda))
        torch.cuda.synchronize()
        assert turbo.run_turbo.launches == before + 1
        assert torch.equal(hv, pv) and torch.equal(hu, pu)


@pytest.mark.cuda
@pytest.mark.parametrize("force_global", [False, True],
                         ids=["shared", "global"])
def test_turbo_kernel_matches_plain_every_op(cuda, force_global):
    """Every basic gate op on random X/Z words (turbo_cases.all_ops_case),
    so that each branch of the kernel's core switch is held."""
    plan, st0, FV, FU = turbo_cases.all_ops_case(4, 6, seed=7, device=cuda)
    hv, hu = turbo.run_turbo(plan, st0, FV, FU, _force_global=force_global)
    pv, pu = turbo.run_turbo_plain(plan, st0, *plan.pad_forced(FV, FU))
    torch.cuda.synchronize()
    assert torch.equal(hv, pv) and torch.equal(hu, pu)


@pytest.mark.cuda
def test_turbo_kernel_matches_plain_rv32(cuda):
    plan, st0, FV, FU = turbo_cases.rv32_case(2, 8, device=cuda)
    hv, hu = turbo.run_turbo(plan, st0, FV, FU)
    pv, pu = turbo.run_turbo_plain(plan, st0, *plan.pad_forced(FV, FU))
    torch.cuda.synchronize()
    assert torch.equal(hv, pv) and torch.equal(hu, pu)


@pytest.fixture(scope="module")
def rv32():
    return workloads.build_rv32(device="cpu")


def _rv32_watch(d):
    """The signals chip_smoke.py's batched phase watches: result, done."""
    eng = d.circuit.digital_engine()
    return [eng.ir.node_sig[id(n)]
            for n in d.ports["result"] + d.ports["done"]]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,seed,watched", [(1, 404, None, False),
                                              (128, 8, 8, True)],
                         ids=["1x404_full", "128x8_random_watch"])
def test_turbo_kernel_matches_plain_rv32_main_shapes(cuda, rv32, B, T, seed,
                                                     watched):
    """RV32 through the main path's 404 ticks from reset with the full
    history, and 128 instances each from its own random V/U start words
    (X and Z lanes) with the batched path's watch list."""
    plan, st0, FV, FU = turbo_cases.rv32_case(B, T, cuda, design=rv32,
                                              seed=seed)
    watch = _rv32_watch(rv32) if watched else None
    hv, hu = turbo.run_turbo(plan, st0, FV, FU, watch=watch)
    pv, pu = turbo.run_turbo_plain(plan, st0, *plan.pad_forced(FV, FU),
                                   None if watch is None else
                                   torch.tensor(watch, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(hv, pv) and torch.equal(hu, pu)


@pytest.mark.cuda
def test_turbo_kernel_is_deterministic(cuda, rv32):
    plan, st0, FV, FU = turbo_cases.rv32_case(4, 32, cuda, design=rv32,
                                              seed=3)
    a = turbo.run_turbo(plan, st0, FV, FU)
    b = turbo.run_turbo(plan, st0, FV, FU)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_turbo_wrapper_raises_on_a_schedule_that_fails_its_checks(cuda):
    plan, st0, FV, FU = turbo_cases.fp16_case(2, 4, seed=1, device=cuda)
    bad = turbo_cases.double_write(plan)
    before = turbo.run_turbo.launches
    with pytest.raises(ValueError, match="write slot"):
        turbo.run_turbo(bad, st0, FV, FU)
    assert turbo.run_turbo.launches == before


@pytest.mark.cuda
def test_rv32_digital_run_on_the_card(cuda):
    d = workloads.build_rv32(device=cuda)
    res, done = workloads.rv32_run(1, 200, design=d)
    assert int(res[0]) == d.expect == 4264 and int(done[0]) == 1
    res, done = workloads.rv32_run(4, 200, design=d)
    assert (res == 4264).all() and (done == 1).all()


@pytest.fixture(scope="module")
def rv32_o2():
    return workloads.build_rv32(device="cuda", opt_level=2)


@pytest.mark.cuda
def test_rv32_o2_turbo_on_the_card_matches_levels_on_the_cpu(cuda, rv32_o2):
    """RV32 synthesized at -O2, 24 ticks from power-up: the turbo kernel
    on the card against the levelled tick on the CPU, every signal."""
    from phy_engine_tpu_torch.digital.engine import DigitalEngine
    d = rv32_o2
    reset, body = workloads.rv32_schedules(d, 10)
    eng, fs, FV, FU = d.circuit._compile_schedule(reset + body)
    eng.reset_state()
    before = turbo.run_turbo.launches
    tv, tu = eng.run_ticks(fs, FV, FU)
    assert turbo.run_turbo.launches == before + 1
    cpu = DigitalEngine(d.circuit.nl, "cpu")
    lv, lu, _last = cpu.run_levels(fs, FV[None], FU[None])
    np.testing.assert_array_equal(tv, lv[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(tu, lu[0].numpy().view(np.uint32))


@pytest.mark.cuda
def test_rv32_o2_native_matches_turbo_on_the_card(cuda, rv32_o2):
    """RV32 at -O2, reset plus 200 clocks: the host sweep engine's full
    history equals the turbo kernel's on the card, and both end at
    ``result`` 4264; 4 instances through digital_run_batch too."""
    from phy_engine_tpu_torch.digital.engine import DigitalEngine
    d = rv32_o2
    reset, body = workloads.rv32_schedules(d, 200)
    eng, fs, FV, FU = d.circuit._compile_schedule(reset + body)
    eng.reset_state()
    tv, tu = eng.run_ticks(fs, FV, FU)
    nat = DigitalEngine(d.circuit.nl, cuda, backend="native")
    before = turbo.run_turbo.launches
    nv, nu = nat.run_ticks(fs, FV, FU)
    assert turbo.run_turbo.launches == before
    np.testing.assert_array_equal(nv, tv)
    np.testing.assert_array_equal(nu, tu)
    res, done = workloads.rv32_run(1, 200, design=d)
    assert int(res[0]) == d.expect == 4264 and int(done[0]) == 1
    res, done = workloads.rv32_run(4, 200, design=d)
    assert (res == 4264).all() and (done == 1).all()


@pytest.mark.cuda
def test_rv32_o2_penl_turbo_on_the_card_matches_levels_on_the_cpu(cuda,
                                                                   tmp_path):
    """RV32 through ``cli.verilog2penl -O2``, ``io.load`` on the card and
    ``Circuit.digital_run``, 24 ticks from power-up: the turbo kernel's
    history against the levelled tick on the CPU of the same file."""
    from pathlib import Path
    from phy_engine_tpu_torch import io as tio
    from phy_engine_tpu_torch.cli.verilog2penl import main as v2penl
    src = Path(workloads.__file__).parent / "data" / "pe_rv32.v"
    penl = tmp_path / "rv32_o2.penl"
    assert v2penl([str(penl), str(src), "--top", "pe_rv32", "-O2"]) == 0
    runs = {}
    for where in (cuda, "cpu"):
        d = workloads.rv32_of_penl(tio.load(str(penl), device=where))
        reset, body = workloads.rv32_schedules(d, 10)
        runs[str(where)] = d.circuit._compile_schedule(reset + body)
    eng, fs, FV, FU = runs[str(cuda)]
    before = turbo.run_turbo.launches
    tv, tu = eng.run_ticks(fs, FV, FU)
    assert turbo.run_turbo.launches == before + 1
    ceng, cfs, cFV, cFU = runs["cpu"]
    np.testing.assert_array_equal(cfs, fs)
    lv, lu, _last = ceng.run_levels(cfs, cFV[None], cFU[None])
    np.testing.assert_array_equal(tv, lv[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(tu, lu[0].numpy().view(np.uint32))


# ---------------------------------------------------------------------------
# the analog Circuit driver on the card
# ---------------------------------------------------------------------------

def _rectifier():
    return [("v", "VAC", {"Vp": 5.0, "freq": 1e3}, ("in", "0")),
            ("d", "PN_JUNCTION", {}, ("in", "out")),
            ("r", "RESISTANCE", {"r": 1e3}, ("out", "0")),
            ("cap", "CAPACITOR", {"C": 1e-6}, ("out", "0"))]


def _rlc():
    return [("v", "VAC", {"Vp": 1.0}, ("n1", "0")),
            ("r", "RESISTANCE", {"r": 10.0}, ("n1", "n2")),
            ("l", "INDUCTOR", {"L": 1e-3}, ("n2", "n3")),
            ("cap", "CAPACITOR", {"C": 1e-6}, ("n3", "0"))]


def _setup(t_step=None, t_stop=None, adaptive=False, ac=None):
    def setup(b):
        if t_step is not None:
            b.c.tr.t_step, b.c.tr.t_stop = t_step, t_stop
            b.c.tr.adaptive = adaptive
        if ac is not None:
            b.c.ac.sweep = b.mod.ACSweepType.LOG
            b.c.ac.omega_start, b.c.ac.omega_stop, b.c.ac.points = ac
    return setup


CIRCUIT_CASES = {
    "divider_dc": (divider(), "DC", _setup()),
    "diode_op": (diode_load(5.0), "OP", _setup()),
    "rectifier_tr": (_rectifier(), "TR", _setup(5e-6, 2e-3)),
    "rectifier_adaptive_tr": (_rectifier(), "TR", _setup(5e-5, 1e-3, True)),
    "rlc_ac": (_rlc(), "AC", _setup(ac=(1e2, 1e6, 25))),
    "diode_acop": (diode_load(5.0, tt=1e-9), "ACOP",
                   _setup(ac=(1e3, 1e10, 15))),
}


def _circuit_run(name, device):
    spec, at, setup = CIRCUIT_CASES[name]
    b = build_port(spec, device)
    setup(b)
    b.c.set_analyze_type(getattr(b.mod.AnalyzeType, at))
    ok = b.c.analyze()
    out = [b.c._x.cpu().numpy()]
    if b.c.tr_history is not None:
        out += [b.c.tr_history, b.c.tr_times]
    if b.c.ac_sweep_results:
        out.append(np.stack([x for _w, x in b.c.ac_sweep_results]))
    return ok, out


def _circuit_close(card, host, tol=1e-6):
    for a, b in zip(card, host):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CIRCUIT_CASES))
def test_circuit_card_matches_cpu(cuda, name):
    ok_c, host = _circuit_run(name, "cpu")
    ok_g, card = _circuit_run(name, cuda)
    assert ok_c and ok_g
    _circuit_close(card, host)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["diode_op", "rectifier_tr", "diode_acop"])
def test_circuit_card_repeat_runs_are_bit_identical(cuda, name):
    _ok, first = _circuit_run(name, cuda)
    _ok, second = _circuit_run(name, cuda)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


def _sweeps(device):
    b = build_port(diode_load(0.0), device)
    dc = b.c.dc_sweep(b.devs["v"], "V", np.linspace(-2.0, 5.0, 9))
    temp = b.c.temp_sweep(np.linspace(-40.0, 125.0, 7))
    mc = b.c.monte_carlo({"R": {"r": 0.1}}, 6,
                         generator=torch.Generator().manual_seed(1))
    tr = b.c.monte_carlo({"R": {"r": 0.1}}, 3, analysis="tr",
                         generator=torch.Generator().manual_seed(2),
                         t_stop=2e-6, t_step=5e-8)
    for r in (dc, temp, mc, tr):
        assert r.ok.all()
    return [dc.x, temp.x, mc.x, mc.params["R"], tr.history]


@pytest.mark.cuda
def test_circuit_sweeps_card_matches_cpu(cuda):
    """dc_sweep, temp_sweep and monte_carlo (op and tr; the draws come from
    the same CPU generator) on the card against the CPU."""
    _circuit_close(_sweeps(cuda), _sweeps("cpu"))


@pytest.mark.cuda
def test_circuit_defaults_to_the_card(cuda):
    b = build(tpe, tcircuit, divider())            # no device argument
    assert b.c.device.type == "cuda"
    b.c.set_analyze_type(b.mod.AnalyzeType.DC)
    assert b.c.analyze()
    assert b.c._x.is_cuda
    assert np.isclose(b.c.node_voltage(b.nodes["mid"]).real, 3.0)


@pytest.mark.cuda
def test_circuit_unported_routes_raise_on_the_card(cuda):
    """The mesh routes on a one-rank NCCL mesh agree with the local routes
    (name kept from when they raised)."""
    assert mesh_routes_run(cuda) == 4


# ---------------------------------------------------------------------------
# BSIM3, noise and sensitivity on the card
# ---------------------------------------------------------------------------

def _bsim3_hooks(key, wave, device):
    """Every hook of a BSIM3 family on ``bsim3_cases``' inputs."""
    from phy_engine_tpu_torch.models import MODEL_REGISTRY, StampCtx
    P, v, st, w = bsim3_cases._inputs(key, wave, seed=0)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    m, ts, wt = MODEL_REGISTRY[key], {k: t(a) for k, a in st.items()}, \
        t(np.repeat(w[:, None], bsim3_cases.NI, axis=1))
    ctx = StampCtx(mode="tr", t=bsim3_cases.T, dt=bsim3_cases.DT,
                   env=bsim3_cases.ENV)
    a, z, _ = m.stamp(t(P), t(v), None, ts, ctx)
    step = m.step_update(t(P), t(v), None, ts, bsim3_cases.DT, bsim3_cases.T)
    out = {"A": a, "z": z, "noise": m.noise(t(P), t(v), None, ts,
                                            bsim3_cases.ENV, wt / 6.283),
           "corr": m.noise_corr(t(P), t(v), None, ts, bsim3_cases.ENV,
                                wt / 6.283, wt)}
    out.update(zip(("ac_re", "ac_im"), m.ac_stamp(t(P), ts, wt)[:2]))
    out.update({f"step {k}": step[k] for k in ("cg0", "cg5", "ch1")})
    return {k: v.cpu().numpy() for k, v in out.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("key,wave", [("BSIM3_NMOS", "capmod_xpart"),
                                      ("BSIM3_PMOS", "nqs"),
                                      ("BSIM3_NMOS_RC", "terminal_rc"),
                                      ("BSIM3_PMOS_RC", "junctions")])
def test_bsim3_hooks_card_match_cpu(cuda, key, wave):
    """A BSIM3 family's stamp, AC stamp, step update and noise hooks on
    the card against the CPU: 1e-10 relative to each array's largest
    |entry| (the card's exp/log may differ in the last ulps)."""
    g, h = _bsim3_hooks(key, wave, cuda), _bsim3_hooks(key, wave, "cpu")
    for name, ref in h.items():
        assert np.isfinite(g[name]).all(), name
        err = np.abs(g[name] - ref).max() / (np.abs(ref).max() or 1.0)
        assert err <= 1e-10, (name, err)


@pytest.mark.cuda
def test_bsim3_chain_rescue_ladder_on_the_card(cuda):
    """The card twin of test_torch_bsim3_chain.py's ladder test: the
    5-stage chain, B = 4, 15 steps at max_iter = 40 (the port's own
    draw): the rescue ladder runs on both devices and converges every lane
    it takes; traces agree to 1e-6 of max|trace|."""
    ir = workloads.build_bsim3_ir(5)
    runs = {}
    for where in (cuda, "cpu"):
        rescues = []
        orig = analog.newton_solve_batched

        def counted(*args, **kwargs):
            out = orig(*args, **kwargs)
            rescues.append(int((~out[2]).sum()))
            return out

        start = workloads.bsim3_seed(ir, where)
        params = workloads.bsim3_params(ir, 4, where)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(analog, "newton_solve_batched", counted)
            xs, ok = workloads.bsim3_run(ir, params, start, 15, max_iter=40)
        assert len(rescues) > 0 and all(r == 0 for r in rescues), rescues
        assert bool(ok.all())
        runs[str(where)] = xs.cpu().numpy()
    ref = runs["cpu"]
    card = runs[str(cuda)]
    assert np.abs(card - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.cuda
def test_bsim3_noise_and_sens_card_match_cpu(cuda):
    """Circuit.noise on the BSIM3 stages and Circuit.sens / sens_ac on the
    BSIM3 common-source stage, card against CPU: 1e-6 relative to the
    largest |value| (per family for the gradients)."""
    from torch_circuits import TIGHT, bsim3_cs_stage, bsim3_stages
    res = {}
    for where in (cuda, "cpu"):
        b = build_port(bsim3_stages(), where, env=TIGHT)
        b.c.ac = tcircuit.ACSettings(sweep=tcircuit.ACSweepType.LOG,
                                     omega_start=6.283e1,
                                     omega_stop=6.283e10, points=9)
        nz = b.c.noise(b.nodes["out"], src=b.devs["vg"])
        s = build_port(bsim3_cs_stage(), where, env=TIGHT)
        s.c.ac = tcircuit.ACSettings(sweep=tcircuit.ACSweepType.LOG,
                                     omega_start=6.283e3,
                                     omega_stop=6.283e10, points=5)
        dc = s.c.sens(s.nodes["d"])
        _f, mag, ac = s.c.sens_ac(s.nodes["d"])
        res[str(where)] = (nz, dc, mag, ac)
    (gn, gd, gm, ga), (hn, hd, hm, ha) = res[str(cuda)], res["cpu"]

    def close(a, b, what):
        err = np.abs(np.asarray(a) - np.asarray(b)).max() / \
            (np.abs(np.asarray(b)).max() or 1.0)
        assert err <= 1e-6, (what, err)

    close(gn.onoise_psd, hn.onoise_psd, "onoise")
    close(gn.gain2, hn.gain2, "gain2")
    for k, v in hn.contribs.items():
        close(gn.contribs[k], v, f"noise {k}")
    close(gm, hm, "sens_ac |V|")
    for k, v in hd.grads.items():
        close(gd.grads[k], v, f"sens {k}")
        close(ga.grads[k], ha.grads[k], f"sens_ac {k}")


# ---------------------------------------------------------------------------
# the levelled tick, mixed signal and the flash engine on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", list(dc.CASES_ALL))
def test_digital_case_card_matches_cpu(cuda, name):
    """Every case of tests/test_torch_levels.py and tests/test_torch_mixed.py
    (torch_digital_cases) on the card against the CPU: planes and codes
    bit-identical, voltages to dc.VTOL."""
    card = dc.run_case(tpe, name, lambda: tpe.Circuit(device=cuda))
    host = dc.run_case(tpe, name, lambda: tpe.Circuit(device="cpu"))
    dc.assert_same(card, host)


@pytest.mark.cuda
def test_levels_tick_rv32_matches_turbo_on_the_card(cuda):
    """RV32 from power-up, 24 ticks through the levelled tick on the card,
    against the turbo kernel's full history of the same schedule."""
    d = workloads.build_rv32(device=cuda)
    (fs, FV, FU), (hv, hu) = workloads.rv32_levels(d, 10)
    assert hv.is_cuda and hv.shape[0] == 24
    eng = d.circuit.digital_engine()
    eng.reset_state()
    plan = eng.plan(fs)
    tv, tu = turbo.run_turbo(plan, eng._state0(plan, 1),
                             turbo.as_int32(FV)[None].to(cuda),
                             turbo.as_int32(FU)[None].to(cuda))
    v, u = plan.unpack_hist(tv[0], tu[0])
    np.testing.assert_array_equal(hv.cpu().numpy().view(np.uint32),
                                  v[:, :plan.S])
    np.testing.assert_array_equal(hu.cpu().numpy().view(np.uint32),
                                  u[:, :plan.S])


@pytest.mark.cuda
def test_flash_matches_turbo_and_levels_on_the_card(cuda):
    """fp16 (acyclic), three instances of random per-lane stimulus, a
    watch list: flash on the card against the turbo kernel and against
    flash on the CPU; the latch-feedback design (the cyclic class), B = 8:
    flash against the batched levelled tick."""
    from phy_engine_tpu_torch.digital import flash
    c, ins, _pn, _r = workloads.synth_top(workloads.FP16_ADD_SRC, "fp16_add",
                                          cuda, inputs=("a", "b"))
    names = {f"{p}{i}": m for p in ("a", "b") for i, m in enumerate(ins[p])}
    comp = [c._compile_schedule(
        [{names[n]: v for n, v in e.items()} for e in
         dc.random_codes(np.random.default_rng(s), list(names), 5,
                         lanes=True)]) for s in (1, 2, 3)]
    eng, fs = comp[0][0], comp[0][1]
    FV = np.stack([x[2] for x in comp])
    FU = np.stack([x[3] for x in comp])
    watch = list(range(0, eng.ir.n_signals, 7))
    plan = eng.flash_plan(fs)
    card = flash.run_batched(plan, eng.sv, eng.su, eng.seq_state, FV, FU,
                             watch, device=cuda)
    host = flash.run_batched(plan, eng.sv, eng.su, eng.seq_state, FV, FU,
                             watch, device="cpu")
    tv, tu = eng.run_ticks_batched(fs, FV, FU, watch=watch)       # turbo
    for a, b in zip(card, host):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(card[0], tv)
    np.testing.assert_array_equal(card[1], tu)
    rec = dc.Rec(lambda: tpe.Circuit(device=cuda))
    c, ins, pn = dc._synth(tpe, rec, dc.LATCH_SRC, "lat", ("en", "d", "s"))
    names = {n: ins[n][0] for n in ("en", "d", "s")}
    comp = [c._compile_schedule(
        [{names[n]: v for n, v in e.items()} for e in
         dc.random_codes(np.random.default_rng(s), list(names), 12,
                         lanes=True)]) for s in range(8)]
    eng, fs = comp[0][0], comp[0][1]
    FV = np.stack([x[2] for x in comp])
    FU = np.stack([x[3] for x in comp])
    watch = [eng.ir.node_sig[id(n)] for n in pn["q"] + pn["y"]]
    fv, fu = eng.run_ticks_batched(fs, FV, FU, watch=watch)       # flash
    hv, hu, _last = eng.run_levels(fs, FV, FU, None, watch)
    assert hv.is_cuda
    np.testing.assert_array_equal(fv, hv.cpu().numpy().view(np.uint32))
    np.testing.assert_array_equal(fu, hu.cpu().numpy().view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("bits,volts", [(8, (0.7, 1.23, 3.9, 4.97, -0.5,
                                             5.5)),
                                        (16, (1.2345, 3.98765))])
def test_sar_adc_card_matches_cpu(cuda, bits, volts):
    """The SAR ADC on the card and on the CPU: equal codes, DAC voltages
    within 1e-6, each code within 1 LSB of ideal (tests/test_adc.py's
    voltages but 2.5 V, a comparator tie at 8 bits, which chip_smoke.py
    holds by the 1-LSB rule)."""
    card, host = workloads.sar_adc(bits, cuda), workloads.sar_adc(bits, "cpu")
    assert card.circuit.prepare().n_drive_slots == bits
    lsb = workloads.SAR_VREF / 2 ** bits
    for v_in in volts:
        (kc, kv), (hc, hv) = (workloads.sar_convert(card, v_in),
                              workloads.sar_convert(host, v_in))
        assert kc == hc, (v_in, kc, hc)
        assert abs(kv - hv) <= 1e-6 * max(abs(hv), lsb)
        ideal = min(max(v_in, 0.0), workloads.SAR_VREF - lsb) / lsb
        assert abs(kc - ideal) <= 1.0 + 1e-9
    assert card.circuit._x.is_cuda


# ---------------------------------------------------------------------------
# large systems: the sparse route, SPIKE / PCR, solve_batched, BiCGStab
# ---------------------------------------------------------------------------

def _mesh_circuit(device, extra=None):
    from phy_engine_tpu_torch.models import CAPACITOR, PN_JUNCTION
    nl, nodes = workloads.random_mesh_netlist(400, 1600, 3)
    if extra == "diode":
        d = tpe.netops.add_model(nl, PN_JUNCTION, {})
        tpe.netops.add_to_node(nl, d, 0, nodes[1])
        tpe.netops.add_to_node(nl, d, 1, nl.ground_node)
    if extra == "caps":
        for k in range(3, len(nodes), 20):
            cap = tpe.netops.add_model(nl, CAPACITOR, {"C": 1e-9})
            tpe.netops.add_to_node(nl, cap, 0, nodes[k])
            tpe.netops.add_to_node(nl, cap, 1, nl.ground_node)
    c = tpe.Circuit(nl, solver="sparse", device=device)
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("extra,at", [(None, "DC"), ("diode", "DC"),
                                      ("caps", "TR")])
def test_sparse_route_card_matches_cpu(cuda, extra, at):
    """The Circuit's sparse route (random mesh 400 / 1600) on the card
    against the CPU, within 1e-6 of max|x| (BiCGStab's 1e-10 residual
    stop, two platforms' rounding); no dense solve on either."""
    out = []
    from phy_engine_tpu_torch.ops import linsolve
    with pytest.MonkeyPatch.context() as mp:
        def refuse(*_a, **_k):
            raise AssertionError("the sparse route made a dense solve")
        mp.setattr(linsolve, "lu_solve_gauss", refuse)
        for dev in (cuda, "cpu"):
            c = _mesh_circuit(dev, extra)
            c.tr.t_step, c.tr.t_stop = 1e-7, 1e-6
            c.set_analyze_type(getattr(tpe.AnalyzeType, at))
            assert c.analyze()
            assert c._method() == "sparse"
            out.append(c.tr_history if at == "TR" else c._x.cpu().numpy())
    card, host = out
    assert np.abs(card - host).max() <= 1e-6 * np.abs(host).max()


@pytest.mark.cuda
def test_spike_and_pcr_card_match_cpu(cuda):
    from phy_engine_tpu_torch.ops import tridiag
    rng = np.random.default_rng(7)
    n = 1003
    dl = rng.uniform(-1, 0, n)
    du = rng.uniform(-1, 0, n)
    d = np.abs(dl) + np.abs(du) + rng.uniform(0.5, 1.5, n)
    b = rng.standard_normal(n)
    dp = tridiag.spike_host_pivots(dl, d, du, 8)
    outs = []
    for dev in (cuda, "cpu"):
        t = [torch.as_tensor(a, device=dev) for a in (dl, d, du, b)]
        res = [tridiag.tridiag_solve(*t)]
        for kw in (dict(inner="thomas"), dict(inner="pcr"),
                   dict(inner="thomas", dp=dp, nbatch=2)):
            fac = tridiag.SpikeFactor(t[0], None if "dp" in kw else t[1],
                                      t[2], chunks=8, **kw)
            res += [fac.solve(t[3]), fac.matvec(t[3])]
        outs.append([r.cpu().numpy() for r in res])
    for card, host in zip(*outs):
        assert np.allclose(card, host, rtol=1e-10, atol=1e-12)


@pytest.mark.cuda
def test_solve_batched_launches_gj_solve32(cuda):
    rng = np.random.default_rng(0)
    for n in (128, 200):
        A = rng.standard_normal((8, n, n)) + 5 * np.eye(n)
        A[3] = 0.0
        A[3, 0, :] = 1.0                                  # singular lane
        b = rng.standard_normal((8, n))
        before = gj.gj_solve32.launches
        x = gj.solve_batched(torch.from_numpy(A).to(cuda),
                             torch.from_numpy(b).to(cuda))
        assert gj.gj_solve32.launches == before + 3      # solve + 2 passes
        x = x.cpu().numpy()
        good = [i for i in range(8) if i != 3]
        xe = np.linalg.solve(A[good], b[good][..., None])[..., 0]
        assert np.max(np.abs(x[good] - xe) / np.maximum(np.abs(xe), 1e-9)) \
            < 1e-7
        assert not np.isfinite(x[3]).all()


@pytest.mark.cuda
def test_bicgstab_ell_bit_identical_run_to_run(cuda):
    from phy_engine_tpu_torch.ops import sparse
    rows, cols, vals, z = workloads.sparse_mesh_coo(5000, 800)
    ell = sparse.BandedCOO(rows, cols, len(z))
    v = torch.as_tensor(vals, device=cuda)
    zz = torch.as_tensor(z, device=cuda)
    runs = [sparse.bicgstab_ell(ell, v, zz, max_iter=20000) for _ in range(2)]
    assert bool(runs[0][1])
    assert torch.equal(runs[0][0], runs[1][0])
    assert int(runs[0][2]) == int(runs[1][2])
    x, ok, _it = sparse.bicgstab(rows, cols, v, zz, len(z), max_iter=20000)
    x2, _ok, _it = sparse.bicgstab(rows, cols, v, zz, len(z), max_iter=20000)
    assert torch.equal(x, x2)


@functools.lru_cache(maxsize=2)
def _mesh_layout(nodes: int, links: int):
    """The random-link mesh (``torch_circuits.random_link_mesh_ir``)
    lowered by the port: its sparse route's COO layout (ground-row
    entries and ground-dummy columns included)."""
    return analog.coo_layout(random_link_mesh_ir(nodes, links))


def _hub_layout():
    """A 3,000-node mesh with node 0 tied to 10,000 resistors: a row of
    20,000 + entries, over ``sparse.ROW_THREAD_MAX``, among narrow ones."""
    from phy_engine_tpu_torch.ops import sparse
    rows, cols, _v, z = workloads.sparse_mesh_coo(3000, 400, seed=5)
    other = np.random.default_rng(6).integers(1, 3000, 10_000)
    zero = np.zeros_like(other)
    rows = np.concatenate([rows, zero, other, zero, other])
    cols = np.concatenate([cols, zero, other, other, zero])
    return sparse.COOLayout(rows, cols, len(z))


def _spmm_case(case):
    """(layout, values, x) as numpy: per-lane values at B = 64 on the
    mesh (also in float32), one lane of 1-D values and x, (nnz,) values
    shared by 64 lanes, and the hub row at B = 4."""
    lay = {"mesh20k": lambda: _mesh_layout(20_000, 2_000),
           "mesh100k": lambda: _mesh_layout(100_000, 10_000),
           "hub": _hub_layout}.get(case, lambda: _mesh_layout(20_000, 2_000))()
    rng = np.random.default_rng(len(case))
    B = {"one_lane": 1, "hub": 4}.get(case, 64)
    vals = rng.standard_normal((B, lay.nnz)) * 10.0 ** rng.uniform(
        -3, 3, (B, lay.nnz))
    x = rng.standard_normal((B, lay.n))
    if case == "shared":
        vals = vals[0]
    if case == "one_lane":
        vals, x = vals[0], x[0]
    if case == "float32":
        vals, x = vals.astype(np.float32), x.astype(np.float32)
    return lay, vals, x


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mesh20k", "mesh100k", "one_lane",
                                  "shared", "hub", "float32"])
def test_coo_spmm_matches_plain(cuda, case):
    """The kernel against the plain twin on the same CUDA tensors: bit
    for bit on rows up to eight entries wide; on wider ones to 1e-12 of
    max|y| in float64 and to 32 float32 ulps of the row's |A| |x| in
    float32; a repeat run bit-identical; one launch a product (two with a
    row over ``ROW_THREAD_MAX``)."""
    from phy_engine_tpu_torch.ops import sparse
    lay, vals, x = _spmm_case(case)
    v, xd = torch.as_tensor(vals, device=cuda), torch.as_tensor(x, device=cuda)
    prod = lay.bind(v)
    before = sparse.coo_spmm.launches
    y, y2 = prod(xd), prod(xd)
    torch.cuda.synchronize()
    per = 1 + (lay.wide.size > 0)
    assert per == (2 if case == "hub" else 1)
    assert sparse.coo_spmm.launches - before == 2 * per
    plain = lay.matvec_plain(v, xd)
    assert y.shape == plain.shape and y.dtype == plain.dtype == v.dtype
    assert torch.equal(y, y2)
    narrow = torch.as_tensor(np.diff(lay.rowptr) <= 8, device=cuda)
    assert torch.equal(y[..., narrow], plain[..., narrow])
    if case == "float32":
        tol = 32 * torch.finfo(torch.float32).eps * lay.matvec_plain(
            v.abs(), xd.abs())
        assert bool(((y - plain).abs() <= tol).all())
    else:
        assert float((y - plain).abs().max()) <= 1e-12 * float(
            plain.abs().max())
    if case == "mesh100k":
        # the mesh100k.dc cell's pattern: 540,001 entries in range, rows
        # of 5, 7 and 9-13 entries
        widths = dict(zip(*np.unique(np.diff(lay.rowptr),
                                     return_counts=True)))
        assert (lay.n, lay.perm.size) == (100_001, 540_001)
        assert widths == {2: 1, 4: 1, 5: 81_874, 7: 16_376, 9: 1_627,
                          11: 118, 13: 4}


@pytest.mark.cuda
def test_coo_spmm_refuses_what_it_does_not_take(cuda):
    from phy_engine_tpu_torch.ops import sparse
    lay, vals, x = _spmm_case("hub")
    v, xd = torch.as_tensor(vals, device=cuda), torch.as_tensor(x, device=cuda)
    prod = lay.bind(v)
    before = sparse.coo_spmm.launches
    with pytest.raises(TypeError):
        prod(xd.half())
    with pytest.raises(TypeError):
        prod(xd.float())                        # float64 values, float32 x
    with pytest.raises(TypeError):
        lay.bind(v.half())(xd.half())
    with pytest.raises(ValueError, match="contiguous"):
        prod(xd.t().contiguous().t())
    with pytest.raises(ValueError):
        prod(xd.cpu())
    with pytest.raises(ValueError):
        lay.bind(v.cpu())(xd)
    assert sparse.coo_spmm.launches == before


def _leaky_mesh(n_nodes=2000, links=300, seed=4):
    """A small random-link mesh with every node leaking to ground, three
    lanes of scaled values and right sides: (rows, cols, vals_b, z_b, n)."""
    rows, cols, vals, z = workloads.sparse_mesh_coo(n_nodes, links, seed)
    n = len(z)
    leak = np.arange(n - 1)                     # every node to ground
    rows = np.concatenate([rows, leak])
    cols = np.concatenate([cols, leak])
    vals = np.concatenate([vals, np.full(n - 1, 1e-3)])
    vals_b = np.stack([vals * s for s in (1.0, 3.0, 0.5)])
    z_b = np.stack([z, 2.0 * z, -z])
    return rows, cols, vals_b, z_b, n


@pytest.mark.cuda
def test_bicgstab_card_matches_cpu_one_launch_a_product(cuda):
    """The f64 BiCGStab on the card against the CPU within 1e-7 of max|x|
    (``test_bicgstab_vs_jax_and_scipy``'s tolerance), three lanes, every
    product one launch: the first residual, two an iteration, the last."""
    from phy_engine_tpu_torch import trace
    from phy_engine_tpu_torch.ops import sparse
    rows, cols, vals_b, z_b, n = _leaky_mesh()
    out = {}
    for dev in ("cpu", cuda):
        before = trace.counters()
        out[str(dev)] = sparse.bicgstab(
            rows, cols, torch.as_tensor(vals_b, device=dev),
            torch.as_tensor(z_b, device=dev), n)
        after = trace.counters()
    x_cpu, ok_cpu, _ = out["cpu"]
    x, ok, _it = out[str(cuda)]
    assert bool(ok.all()) and bool(ok_cpu.all())
    scale = float(x_cpu.abs().max())
    assert float((x.cpu() - x_cpu).abs().max()) <= 1e-7 * scale
    launched = (after["bicgstab.iterations_launched"]
                - before.get("bicgstab.iterations_launched", 0))
    assert after["coo_spmm.launches"] - before["coo_spmm.launches"] == \
        2 * launched + 2


@pytest.mark.cuda
def test_bicgstab_card_takes_strided_b_and_float32(cuda):
    """A right side that is a transposed view runs on the card and gives
    the contiguous run's x bit for bit; a float32 solve runs through the
    float32 kernel and converges (tol 1e-5) to an x whose float64
    residual is under 1e-4 of |b|."""
    from phy_engine_tpu_torch.ops import sparse
    rows, cols, vals_b, z_b, n = _leaky_mesh()
    v = torch.as_tensor(vals_b, device=cuda)
    zc = torch.as_tensor(z_b, device=cuda)
    zt = torch.as_tensor(np.ascontiguousarray(z_b.T), device=cuda).t()
    assert not zt.is_contiguous() and torch.equal(zt, zc)
    x, ok, _ = sparse.bicgstab(rows, cols, v, zc, n)
    x_t, ok_t, _ = sparse.bicgstab(rows, cols, v, zt, n)
    assert bool(ok.all()) and bool(ok_t.all()) and torch.equal(x, x_t)
    before = sparse.coo_spmm.launches
    x32, ok32, _ = sparse.bicgstab(rows, cols, v.float(), zc.float(), n,
                                   tol=1e-5)
    assert x32.dtype == torch.float32 and bool(ok32.all())
    assert sparse.coo_spmm.launches > before
    r = (sparse.coo_matvec(rows, cols, v.cpu(), x32.double().cpu(), n)
         - zc.cpu())
    assert float((torch.linalg.vector_norm(r, dim=-1)
                  / torch.linalg.vector_norm(zc.cpu(), dim=-1)).max()) <= 1e-4


@pytest.mark.cuda
def test_chain_preconditioner_card_matches_cpu(cuda):
    """The random-link mesh at 2,000 nodes and 20 links, where Jacobi
    fails: on the card and on the CPU ``bicgstab`` escalates once to the
    chain preconditioner and converges, both within 1e-5 of max|x| of
    scipy's direct solve (``tests/test_torch_sparse_chain.py``'s
    tolerance) and of each other; the marked layout's next solve on the
    card runs the chain alone, and a repeat of it is bit-identical.  With
    values (B, nnz) the band is factored one T a lane, on the card by the
    per-lane kernel, to the same tolerance."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    from phy_engine_tpu_torch import trace
    from phy_engine_tpu_torch.ops import sparse, tridiag
    rows, cols, vals, z = workloads.sparse_mesh_coo(2000, 20)
    n = len(z)
    xe = spl.splu(sp.csc_matrix((vals, (rows, cols)), shape=(n, n))).solve(z)
    scale = np.abs(xe).max()
    zb = np.stack([z, 0.7 * z])
    out, lays = {}, {}
    for dev in ("cpu", cuda):
        lays[str(dev)] = lay = sparse.COOLayout(rows, cols, n)
        before = trace.counters().get("bicgstab.escalations", 0)
        out[str(dev)] = sparse.bicgstab(
            None, None, torch.as_tensor(vals, device=dev),
            torch.as_tensor(zb, device=dev), n, layout=lay)
        assert trace.counters()["bicgstab.escalations"] == before + 1
        assert lay.chain_first
    for x, ok, it in out.values():
        assert bool(ok.all()) and int(it.max()) > 400
        x = x.cpu().numpy()
        assert np.abs(x[0] - xe).max() <= 1e-5 * scale
        assert np.abs(x[1] - 0.7 * xe).max() <= 1e-5 * scale
    assert float((out[str(cuda)][0].cpu() - out["cpu"][0]).abs().max()) \
        <= 1e-5 * scale
    lay = lays[str(cuda)]
    args = (None, None, torch.as_tensor(vals, device=cuda),
            torch.as_tensor(zb, device=cuda), n)
    x1, ok1, it1 = sparse.bicgstab(*args, layout=lay)
    x2, ok2, it2 = sparse.bicgstab(*args, layout=lay)
    assert bool(ok1.all()) and int(it1.max()) < 100
    assert torch.equal(x1, x2) and torch.equal(it1, it2)
    # values (B, nnz), lane 1's the pattern's scaled by 2: the band one T
    # a lane (the per-lane kernel on the card), the same answers within
    # the tolerance, on the card and the CPU
    vb = np.stack([vals, 2.0 * vals])
    want = np.stack([xe, 0.35 * xe])
    for dev in ("cpu", cuda):
        lay = lays[str(dev)]
        pre = sparse.ChainPreconditioner(lay, torch.as_tensor(vb, device=dev))
        assert pre.tri.lanes == 2
        launches = tridiag.tridiag_part64.launches
        x, ok, it = sparse.bicgstab(None, None, torch.as_tensor(vb, device=dev),
                                    torch.as_tensor(zb, device=dev), n,
                                    layout=lay)
        moved = tridiag.tridiag_part64.launches - launches
        assert moved > 0 if str(dev) != "cpu" else moved == 0
        assert bool(ok.all()) and int(it.max()) < 100
        out[str(dev)] = x.cpu().numpy()
        assert np.abs(out[str(dev)] - want).max() <= 1e-5 * scale
    assert np.abs(out[str(cuda)] - out["cpu"]).max() <= 1e-5 * scale


@pytest.mark.cuda
def test_circuit_float32_sparse_route_runs_on_the_card(cuda):
    """``Circuit(dtype=float32)`` on the sparse route runs its products
    through the float32 kernel and ends as the same Circuit does on the
    CPU (an OP that does not reach the float64 residual check)."""
    from phy_engine_tpu_torch.ops import sparse
    ok = {}
    for dev in ("cpu", cuda):
        nl, _nodes = workloads.random_mesh_netlist(300, 1200, seed=3)
        c = tpe.Circuit(nl, dtype=torch.float32, device=dev,
                        solver="sparse")
        before = sparse.coo_spmm.launches
        ok[str(dev)] = c.analyze()
        launched = sparse.coo_spmm.launches - before
        assert launched == 0 if dev == "cpu" else launched > 0
    assert ok["cpu"] == ok[str(cuda)]


def _tridiag_case(n, lanes, seed=19):
    """A random diagonally dominant T (n,) and right sides b, (n,) when
    ``lanes`` is None, else (lanes, n), as numpy float64."""
    rng = np.random.default_rng(seed + n)
    dl, du = -rng.uniform(0, 1, n), -rng.uniform(0, 1, n)
    d = np.abs(dl) + np.abs(du) + rng.uniform(0.5, 1.5, n)
    b = rng.standard_normal((n,) if lanes is None else (lanes, n))
    return dl, d, du, b


def _tridiag_ref(dl, d, du, b):
    """scipy's sparse LU of T for every right side, float64."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    A = sp.diags([dl[1:], d, du[:-1]], [-1, 0, 1], format="csc")
    x = spl.splu(A).solve(np.atleast_2d(b).T).T
    return x.reshape(b.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 1, 16])
@pytest.mark.parametrize("n", [20, 1000, 100_000])
def test_tridiag_part_matches_plain_and_scipy(cuda, n, lanes):
    """The partitioned kernel against its plain twin on the same card
    tensors, factor and solve bit for bit, and against scipy within 1e-12
    of max|x|: n below one chunk (the direct level alone), n not a
    multiple of a chunk (1000 = 31 x 32 + 8), n = 10^5 (three levels);
    b 1-D, one lane and 16 lanes.  A repeat run is bit-identical; the
    launches are the factor's 2L + 1 and the solve's 2L + 1 a call."""
    from phy_engine_tpu_torch.ops import tridiag
    arrs = _tridiag_case(n, lanes)
    dl, d, du, b = (torch.as_tensor(a, device=cuda) for a in arrs)
    before = tridiag.tridiag_part64.launches
    fac = tridiag.PartitionFactor(dl, d, du)
    x, x2 = fac.solve(b), fac.solve(b)
    torch.cuda.synchronize()
    L = len(tridiag.part_sizes(n)) - 1
    assert L == {20: 0, 1000: 1, 100_000: 3}[n]
    assert tridiag.tridiag_part64.launches - before == 3 * (2 * L + 1)
    levels, direct = tridiag.part_factor_plain(dl, d, du)
    for got, want in zip(fac.levels + [fac.direct], levels + [direct]):
        assert got[0] == want[0]
        for u, v in zip(got[1:], want[1:]):
            assert torch.equal(u, v)
    plain = tridiag.part_solve_plain(fac.levels, fac.direct, b)
    assert x.shape == b.shape and x.dtype == torch.float64
    assert torch.equal(x, x2)
    assert torch.equal(x, plain)
    ref = _tridiag_ref(*arrs)
    assert np.abs(x.cpu().numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.cuda
def test_tridiag_part_refuses_what_it_does_not_take(cuda):
    """float32, non-contiguous and mixed-device inputs raise before any
    launch is counted, to the shared and to the per-lane entry, as does a
    per-lane solve whose rows are not a multiple of the lanes."""
    from phy_engine_tpu_torch.ops import tridiag
    dl, d, du, b = (torch.as_tensor(a, device=cuda)
                    for a in _tridiag_case(1000, 4))
    fac = tridiag.PartitionFactor(dl, d, du)
    before = tridiag.tridiag_part64.launches
    with pytest.raises(TypeError):
        tridiag.PartitionFactor(dl.float(), d.float(), du.float())
    with pytest.raises(TypeError):
        fac.solve(b.float())
    with pytest.raises(ValueError, match="contiguous"):
        fac.solve(b.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        tridiag.PartitionFactor(dl, torch.stack([d, d], 1)[:, 0], du)
    with pytest.raises(ValueError):
        fac.solve(b.cpu())
    with pytest.raises(ValueError):
        tridiag.PartitionFactor(dl, d.cpu(), du)
    with pytest.raises(ValueError):
        tridiag.PartitionFactor(dl.cpu(), d.cpu(), du.cpu()).solve(b)
    with pytest.raises(ValueError):
        fac.solve(b[:, :-1].contiguous())
    # the per-lane entry: T (4, n)
    T = [torch.stack([v] * 4) for v in (dl, d, du)]
    lanes = tridiag.PartitionFactor(*T)
    before = tridiag.tridiag_part64.launches
    with pytest.raises(TypeError):
        tridiag.PartitionFactor(*(v.float() for v in T))
    with pytest.raises(TypeError):
        lanes.solve(b.float())
    with pytest.raises(ValueError, match="contiguous"):
        lanes.solve(b.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        tridiag.PartitionFactor(T[0], T[1].t().contiguous().t(), T[2])
    with pytest.raises(ValueError):
        lanes.solve(b.cpu())
    with pytest.raises(ValueError):
        tridiag.PartitionFactor(T[0], T[1].cpu(), T[2])
    with pytest.raises(ValueError):
        tridiag.PartitionFactor(*(v.cpu() for v in T)).solve(b)
    with pytest.raises(ValueError):
        lanes.solve(b[:3])
    with pytest.raises(ValueError):
        lanes.solve(torch.cat([b, b[:1]]))
    assert tridiag.tridiag_part64.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("per", [1, 2])
@pytest.mark.parametrize("lanes,n", [(3, 20), (3, 1000), (64, 100_000)])
def test_tridiag_part_per_lane_matches_plain_and_scipy(cuda, lanes, n, per):
    """The per-lane kernel, T (lanes, n), against its plain twin on the
    same card tensors, factor and solve bit for bit, and each lane against
    scipy within 1e-12 of max|x|: the direct level alone, one level, and
    the chain cell's band (three levels); ``per`` right sides a lane,
    the band's rows of a wider array (rows n + 1 apart) at ``per`` 1, and
    the same rows as (per, lanes, n).  A repeat run is bit-identical; the
    launches are the factor's 2L + 1 and the solve's 2L + 1 a call."""
    from phy_engine_tpu_torch.ops import tridiag
    rng = np.random.default_rng(n + lanes)
    dl, du = -rng.uniform(0, 1, (lanes, n)), -rng.uniform(0, 1, (lanes, n))
    d = np.abs(dl) + np.abs(du) + rng.uniform(0.5, 1.5, (lanes, n))
    b = rng.standard_normal((per * lanes, n + (per == 1)))
    T = [torch.as_tensor(v, device=cuda) for v in (dl, d, du)]
    bd = torch.as_tensor(b, device=cuda)[:, :n]
    before = tridiag.tridiag_part64.launches
    fac = tridiag.PartitionFactor(*T)
    x, x2 = fac.solve(bd), fac.solve(bd)
    torch.cuda.synchronize()
    L = len(tridiag.part_sizes(n)) - 1
    assert tridiag.tridiag_part64.launches - before == 3 * (2 * L + 1)
    levels, direct = tridiag.part_factor_plain(*T)
    for got, want in zip(fac.levels + [fac.direct], levels + [direct]):
        assert got[0] == want[0]
        for u, v in zip(got[1:], want[1:]):
            assert torch.equal(u, v)
    plain = tridiag.part_solve_plain(fac.levels, fac.direct, bd)
    assert x.shape == bd.shape and x.is_contiguous()
    assert torch.equal(x, x2) and torch.equal(x, plain)
    # the same rows as (per, lanes, n)
    x3 = fac.solve(bd.reshape(per, lanes, n))
    assert torch.equal(x3.reshape(x.shape), x)
    xc = x.cpu().numpy()
    for r in sorted({0, lanes - 1, per * lanes - 1}):
        k = r % lanes
        ref = _tridiag_ref(dl[k], d[k], du[k], b[r, :n])
        assert np.abs(xc[r] - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 100_000])
def test_tridiag_part_per_lane_of_equal_lanes_is_the_shared_kernel(cuda, n):
    """A per-lane factor whose lanes all hold one T: its levels are the
    shared kernel's factor lane by lane, and its answers the shared
    kernel's, bit for bit, for right sides contiguous and with rows n + 1
    apart."""
    from phy_engine_tpu_torch.ops import tridiag
    dl, d, du, b = (torch.as_tensor(a, device=cuda)
                    for a in _tridiag_case(n, 8))
    shared = tridiag.PartitionFactor(dl, d, du)
    lanes = tridiag.PartitionFactor(*(v.expand(4, n).contiguous()
                                      for v in (dl, d, du)))
    for got, want in zip(lanes.levels + [lanes.direct],
                         shared.levels + [shared.direct]):
        for u, v in zip(got[1:], want[1:]):
            for k in range(4):
                assert torch.equal(u[k], v)
    assert torch.equal(lanes.solve(b), shared.solve(b))
    # rows n + 1 apart: read in place by the per-lane form, copied for
    # the shared one
    wide = torch.cat([b, b[:, :1]], 1)[:, :n]
    assert torch.equal(lanes.solve(wide), shared.solve(wide))
    assert torch.equal(shared.solve(wide), shared.solve(b))


@pytest.mark.cuda
def test_border_solve_on_the_card_takes_the_kernel_and_meets_the_reference(
        cuda):
    """The series ladder at 10^5 resistors, 16 lanes of source values,
    through ``border_solve`` (refine 4) on the card: the factor and every
    one of its six solves through the partitioned kernel, no host sync;
    the answers' gaps from ``port_bench/reference/series_dc.py`` within
    1e-6 (``check.dc_gaps``: voltages against the source value, the
    current against the reference's), as the CPU's are (the kernel's
    plain twin, the same algorithm); the two agree to 1e-8 of the source
    (the dot products and the residual round differently on the two
    devices, and the ladder's condition, ~N^2, amplifies it)."""
    from phy_engine_tpu_torch import trace
    from phy_engine_tpu_torch.models.base import StampCtx
    from phy_engine_tpu_torch.ops import tridiag
    from port_bench import check
    from port_bench.reference import series_dc
    N = 10 ** 5
    ir = workloads.ladder_ir(N)
    one = {k: v[None] for k, v in analog.initial_params(ir, "cpu").items()}
    st = {k: {s: a[None] for s, a in dd.items()}
          for k, dd in analog.initial_state(ir, "cpu").items()}
    ctx = StampCtx(mode="op", t=0.0, dt=0.0, env=workloads.default_env())
    rows, cols, vals, Z, _ = analog.assemble_sparse(
        ir, one, analog.initial_x(ir, "cpu")[None], st, ctx)
    dl, d, du, e, z, rb = workloads.ladder_extract(
        rows.numpy(), cols.numpy(), vals[0].numpy(), Z[0].numpy(),
        ir.n_unknowns)
    volts = np.linspace(0.5, 1.5, 16)
    V = workloads.LADDER_V
    out = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
        zb = t(z)[None] * t(volts)[:, None]
        before = trace.counters()
        v, i = tridiag.border_solve(t(dl), t(d), t(du), zb, t(e),
                                    t(rb * volts), refine=4)
        out[str(dev)] = torch.cat([v, i[:, None]], 1).cpu().numpy()
        after = trace.counters()
    L = len(tridiag.part_sizes(N)) - 1
    assert after["tridiag_part64.launches"] - \
        before["tridiag_part64.launches"] == (2 * L + 1) * (1 + 6)
    assert after.get("host_syncs", 0) == before.get("host_syncs", 0)
    unit = series_dc.solve(N, workloads.LADDER_R)
    for x in out.values():
        gaps = check.dc_gaps(x, np.arange(N + 1), unit, V * volts, N)
        assert gaps["v_gap_max"] <= 1e-6 and gaps["i_gap_max"] <= 1e-6, gaps
    x = out[str(cuda)]
    assert np.abs(x[:, :N] - out["cpu"][:, :N]).max() <= 1e-8 * V
