"""Port parity: the RV32 core (``phy_engine_tpu_torch/data/pe_rv32.v``)
synthesized at -O2 by both packages, device for device, and clocked in the
port: the host sweep engine runs it from reset to the core's ``result``
(4264) and agrees bit for bit with the levelled tick.  RV32 at -O3 and
-Omax stays out of the CPU tests (minutes of synthesis a package)."""

import functools

import numpy as np

from phy_engine_tpu_torch import workloads
from phy_engine_tpu_torch.digital.engine import DigitalEngine

import torch_synth_cases as sc
from test_torch_verilog import jax_synth


@functools.lru_cache(maxsize=None)
def port_o2():
    return workloads.synth_counts("rv32", 2, device="cpu")


def test_rv32_o2_matches_jax():
    src, top, inputs = workloads.SYNTH_DESIGNS["rv32"]
    jc, _ji, _jp, jrep = jax_synth(src, top, inputs, opt_level=2)
    syn = port_o2()
    td, jd = sc.device_list(syn.circuit.nl), sc.device_list(jc.nl)
    assert len(td) == len(jd)
    assert td == jd
    trep = syn.report
    assert (trep.gate_count, trep.ff_count, trep.gate_count_pre_opt) == (
        jrep.gate_count, jrep.ff_count, jrep.gate_count_pre_opt)
    assert sc.stats_fields(trep.opt_stats) == sc.stats_fields(jrep.opt_stats)
    assert (syn.counts, syn.logic_gates) == \
        workloads.RV32_O2_COUNTS
    assert workloads.device_counts(jc.nl) == \
        workloads.RV32_O2_COUNTS
    assert sum(syn.counts.values()) == 21940 and syn.logic_gates == 20992


def test_rv32_o2_runs_to_its_result():
    """reset + 200 clocks on the host sweep engine end at ``result`` 4264,
    ``done`` 1; its first 24 ticks equal the levelled tick's."""
    d = workloads.rv32_of(port_o2())
    reset, body = workloads.rv32_schedules(d, 200)
    _e, fs, FV, FU = d.circuit._compile_schedule(reset + body)
    nat = DigitalEngine(d.circuit.nl, "cpu", backend="native")
    hv, hu = nat.run_ticks(fs, FV, FU)
    sig = [nat.ir.node_sig[id(n)] for n in d.ports["result"]]
    bits = (hv[-1, sig] & 1) | ((hu[-1, sig] & 1) << 1)
    assert (bits <= 1).all()
    assert int((bits.astype(np.int64) << np.arange(32)).sum()) == d.expect
    done = nat.ir.node_sig[id(d.ports["done"][0])]
    assert (hv[-1, done] & 1, hu[-1, done] & 1) == (1, 0)
    eng = d.circuit.digital_engine()
    eng.reset_state()
    lv, lu, _last = eng.run_levels(fs, FV[None, :24], FU[None, :24])
    np.testing.assert_array_equal(hv[:24], lv[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(hu[:24], lu[0].numpy().view(np.uint32))
