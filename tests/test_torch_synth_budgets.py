"""Port parity: the synthesis runs of ``tests/test_synth_budgets.py`` (per-pass
budgets, growth guards, the FSM don't-care gate), and the 7-segment decoder
and the 8 x 8 multiplier (-O1 to -O4) of ``tests/test_synth_opt.py``, each
made by both packages and compared as ``test_torch_synth_opt.check_run``
does: devices, OptStats, pass report and, at -O2 and above, clocked
histories."""

import pytest

import phy_engine_tpu_torch as tpe
from phy_engine_tpu_torch import workloads

import torch_synth_cases as sc
from test_torch_synth_opt import _port_circuit, check_run


@pytest.mark.parametrize("design,opts", sc.RUNS_BUDGETS,
                         ids=[sc.run_id(d, o) for d, o in sc.RUNS_BUDGETS])
def test_synthesis_matches_jax(design, opts, monkeypatch):
    rep = check_run(design, opts, monkeypatch)
    names = [p[0] for p in rep.opt_stats.passes]
    budgets = opts.get("budgets", {})
    if budgets.get("sweep_max_pairs") == 0:           # 0 disables a pass
        assert not {"tt_sweep", "resub", "qm_2lvl", "qm_deep",
                    "bdd_decomp"} & set(names)
        assert "factor" in names
    elif design == "blk" and not budgets:
        assert {"tt_sweep", "rewrite", "resub", "qm_2lvl", "qm_deep",
                "bdd_decomp"} <= set(names)
    if design == "mul8x8" and opts["opt_level"] >= 2:
        assert rep.opt_stats.mul2_extracted >= 16
    if design == "seg7" and opts["opt_level"] == 3:
        assert rep.opt_stats.tt_merged > 0 and rep.opt_stats.qm_rewritten > 0


def test_levels_monotone_on_mul():
    """test_opt_levels_monotone_on_mul in the port: the logic-gate count
    never rises from -O1 to -O4, and -O2 leaves none (all 16 MUL2 webs)."""
    counts = []
    for opts in sc.MUL8_LEVELS:
        c = sc.synth(tpe, _port_circuit, "mul8x8", opts)[0]
        counts.append(workloads.device_counts(c.nl)[1])
    assert counts[1] <= counts[0]
    assert counts[2] <= counts[1]
    assert counts[3] <= counts[2]
    assert counts[1] == 0


def test_fsm_dc_flag_gates_the_tier():
    """infer_dc_from_fsm=False gives more gates than True (the JAX test's
    claim), in the port."""
    got = []
    for flag in (True, False):
        c = sc.synth(tpe, _port_circuit, "fsm_dc",
                     {**sc.B3, "budgets": {"infer_dc_from_fsm": flag}})[0]
        got.append(sum(1 for m in c.nl.live_models()
                       if m.mdef.digital_op not in ("INPUT", "OUTPUT")))
    assert got[0] < got[1], got
