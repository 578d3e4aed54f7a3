"""The check has teeth: a run on the CPU, with the program's answers broken
underneath the harness, comes out not correct; on the card, the control
(the reference in the next lower precision in the program's place) fails
the limits of each cell of BENCHMARK.json at the cell's own size."""

import json

import pytest
import torch

from port_bench import run, spec

import pb_tiny

SEED = 2 ** 31 + 11


def _bench(c=None):
    return run.bench(c or pb_tiny.cell(), SEED, 0.0, False, "cpu")


def test_sound_run_is_correct():
    out = _bench()
    assert out["correct"], out["checks"]


def _unchanged(real):
    def fake(ir, params, x0, st0, env, t0, dt, steps, **kw):
        ok = torch.ones(x0.shape[0], dtype=torch.bool)
        return x0, st0, ok, x0
    return fake


def _half_batch(real):
    def fake(ir, params, x0, st0, env, t0, dt, steps, **kw):
        h = x0.shape[0] // 2
        half = lambda a: a[:h]
        x, st, ok, xs = real(ir, {k: half(v) for k, v in params.items()},
                             half(x0), {k: {v: half(a) for v, a in d.items()}
                                        for k, d in st0.items()},
                             env, t0, dt, steps, **kw)
        x = torch.cat([x, x.mean(dim=0, keepdim=True).expand(
            x0.shape[0] - h, -1)])
        ok = torch.ones(x0.shape[0], dtype=torch.bool)
        return x, st, ok, x
    return fake


def _altered(real):
    def fake(ir, params, x0, st0, env, t0, dt, steps, **kw):
        x, st, ok, xs = real(ir, params, x0, st0, env, t0, dt, steps, **kw)
        x = x.clone()
        x[:, 3] += 0.05              # 50 mV on one node, where produced
        return x, st, ok, x
    return fake


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
def test_broken_transient_is_not_correct(monkeypatch, fault):
    from phy_engine_tpu_torch.engine import analog
    monkeypatch.setattr(analog, "transient_batched",
                        fault(analog.transient_batched))
    out = _bench()
    assert out["correct"] is False, out["checks"]


def test_one_lane_with_another_lanes_parameters_is_not_correct(monkeypatch):
    """The batch's last lane runs with the first lane's resistances (a
    grid that ends one block short, a lane that reads another's
    parameters): one lane in sixteen, which the 90th percentile of twelve
    sampled lanes does not see and the widest lane does."""
    from phy_engine_tpu_torch.engine import analog
    real = analog.transient_batched

    def fake(ir, params, x0, st0, env, t0, dt, steps, **kw):
        params = {k: v.clone() for k, v in params.items()}
        params["R"][-1] = params["R"][0]
        return real(ir, params, x0, st0, env, t0, dt, steps, **kw)
    monkeypatch.setattr(analog, "transient_batched", fake)
    out = _bench(pb_tiny.cell(lanes=16, check_lanes=12))
    assert out["correct"] is False
    checks = out["checks"]
    assert checks["x_gap_p90"]["value"] <= checks["x_gap_p90"]["limit"]
    assert checks["x_gap_max"]["value"] > checks["x_gap_max"]["limit"]


def test_failed_lanes_are_not_correct(monkeypatch):
    from phy_engine_tpu_torch.engine import analog
    real = analog.transient_batched

    def fake(*a, **kw):
        x, st, ok, xs = real(*a, **kw)
        ok = ok.clone()
        ok[0] = False
        return x, st, ok, xs
    monkeypatch.setattr(analog, "transient_batched", fake)
    out = _bench()
    assert out["correct"] is False
    assert out["checks"]["failed_lanes"]["value"] == 1


def _dc_run(c=None):
    """A window of two sweeps."""
    from port_bench import check
    c = c or pb_tiny.mesh_cell()
    fam = spec.family(c)
    b = fam.Bench(c, SEED, "cpu")
    w = run.Window(b, SEED, 0.0, False, 2)
    values = run.compare(fam, b, w, SEED)
    limits = dict(c.cell["check"]["limits"], **{z: 0 for z in fam.ZERO})
    return check.verdict(values, limits)


def test_sound_dc_run_is_correct():
    ok, checks = _dc_run()
    assert ok, checks


def _dc_unchanged(real):
    def fake(ir, params, x0, st0, ctx, **kw):
        return x0, st0, torch.ones(x0.shape[0], dtype=torch.bool)
    return fake


def _dc_altered(real):
    def fake(*a, **kw):
        x, st, ok = real(*a, **kw)
        x = x.clone()
        x[-1, 7] += 1e-3             # 1 mV on one node of the last lane
        return x, st, ok
    return fake


def _dc_one_lane_failed(real):
    def fake(*a, **kw):
        x, st, ok = real(*a, **kw)
        ok = ok.clone()
        ok[-1] = False
        return x, st, ok
    return fake


def _dc_stale(real):
    """Every lane answers for the configuration's source value, whatever
    the sweep asked for (an answer cached from the warm-up)."""
    def fake(ir, params, x0, st0, ctx, **kw):
        p = dict(params)
        p["VDC"] = params["VDC"].clone()
        p["VDC"][...] = 1.0
        return real(ir, p, x0, st0, ctx, **kw)
    return fake


def _dc_failed(real):
    def fake(*a, **kw):
        x, st, ok = real(*a, **kw)
        return x, st, torch.zeros_like(ok)
    return fake


@pytest.mark.parametrize("fault", [_dc_unchanged, _dc_altered, _dc_stale,
                                   _dc_failed, _dc_one_lane_failed])
def test_broken_dc_solve_is_not_correct(monkeypatch, fault):
    from phy_engine_tpu_torch.engine import analog
    monkeypatch.setattr(analog, "newton_solve", fault(analog.newton_solve))
    ok, checks = _dc_run()
    assert ok is False, checks


def _series_run():
    return _dc_run(pb_tiny.series_cell())


def test_sound_ladder_dc_run_is_correct():
    ok, checks = _series_run()
    assert ok, checks


def _pcr_unchanged(real):
    def fake(dl, d, du, z, e, rhs_b, refine=2):
        return torch.zeros_like(z), torch.zeros_like(rhs_b)
    return fake


def _pcr_altered(real):
    def fake(*a, **kw):
        v, i = real(*a, **kw)
        v = v.clone()
        v[-1, 3:] += 1e-6            # a microvolt on the last lane's nodes
        return v, i
    return fake


def _pcr_stale(real):
    """Every solve answers for the first right side it was given."""
    seen = []

    def fake(dl, d, du, z, e, rhs_b, refine=2):
        seen.append((z, rhs_b))
        return real(dl, d, du, *seen[0][:1], e, seen[0][1], refine=refine)
    return fake


def _pcr_nan(real):
    def fake(*a, **kw):
        v, i = real(*a, **kw)
        v = v.clone()
        v[-1, -1] = float("nan")
        return v, i
    return fake


@pytest.mark.parametrize("fault", [_pcr_unchanged, _pcr_altered,
                                   _pcr_stale, _pcr_nan])
def test_broken_ladder_dc_solve_is_not_correct(monkeypatch, fault):
    from phy_engine_tpu_torch.ops import tridiag
    monkeypatch.setattr(tridiag, "border_solve", fault(tridiag.border_solve))
    ok, checks = _series_run()
    assert ok is False, checks


def _listed_cells():
    b = json.loads((spec.ROOT.parent / "BENCHMARK.json").read_text())
    return [w["name"] for w in b["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", _listed_cells())
def test_control_fails_the_limits(cuda, name):
    """On the card, at the cell's own size, on three seeds: the program's
    window of a few jobs passes the limits, the control in its place on
    the same answers fails them."""
    from port_bench import check
    c = spec.cell(name)
    fam = spec.family(c)
    b = fam.Bench(c, 31, cuda)
    limits = dict(c.cell["check"]["limits"], **{z: 0 for z in fam.ZERO})
    for seed in (31, 32, 33):
        w = run.Window(b, seed, 0.0, False, 2)
        sound = run.compare(fam, b, w, seed)
        control = dict(b.compare(seed, w.kept, control=True),
                       **{fam.FAILED: 0})
        assert check.verdict(sound, limits)[0], (seed, sound)
        assert not check.verdict(control, limits)[0], (seed, control)
