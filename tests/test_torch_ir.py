"""Port parity: the stamp IR of phy_engine_tpu_torch equals the JAX
package's, array for array, on the diode-ladder workload and on a
netlist with every analog family (the BSIM3 chain in
test_torch_bsim3_chain.py); every family's metadata, noise hooks
included, equals the JAX package's."""

import numpy as np
import pytest

import __graft_entry__ as g
from phy_engine_tpu.engine import analog as jan
from phy_engine_tpu.models import MODEL_REGISTRY as JAX_REGISTRY

from phy_engine_tpu_torch import workloads
from phy_engine_tpu_torch.engine import analog as tan
from phy_engine_tpu_torch.models import MODEL_REGISTRY

FAMILY_ARRAYS = ("P", "pin_nodes", "br_idx", "a_rows", "a_cols", "z_rows")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stages", [63, 255])
def test_diode_ladder_ir_identical(stages):
    ref = g._build_diode_ladder(stages)
    ir = workloads.build_diode_ladder(stages)
    assert (ir.n_unknowns, ir.n_nodes, ir.n_branches, ir.n_drive_slots,
            ir.nonlinear) == (ref.n_unknowns, ref.n_nodes, ref.n_branches,
                              ref.n_drive_slots, ref.nonlinear)
    assert ([f.mdef.id_name for f in ir.families]
            == [f.mdef.id_name for f in ref.families])
    for fam, rfam in zip(ir.families, ref.families):
        for name in FAMILY_ARRAYS:
            _same(getattr(fam, name), getattr(rfam, name))
        assert list(fam.state0) == list(rfam.state0)
        for k in fam.state0:
            _same(fam.state0[k], rfam.state0[k])
    for a, b in zip(tan._sparse_pattern(ir), jan._sparse_pattern(ref)):
        _same(a, b)


@pytest.mark.parametrize("stages,links", [(63, 63), (255, 255), (20, 7)])
def test_ladder_links_identical(stages, links):
    assert workloads.ladder_links(stages, links) == g._ladder_links(stages,
                                                                    links)


ANALOG = sorted(k for k, m in MODEL_REGISTRY.items() if m.stamp is not None)


@pytest.mark.parametrize("key", ANALOG)
def test_model_metadata_identical(key):
    m, r = MODEL_REGISTRY[key], JAX_REGISTRY[key]
    assert (m.name, m.pins, m.nbranches, m.param_order, m.nonlinear,
            m.n_internal, m.device_class.value, m.attrs) == (
        r.name, r.pins, r.nbranches, r.param_order, r.nonlinear,
        r.n_internal, r.device_class.value, r.attrs)
    assert m.defaults == r.defaults
    assert m.state_vars == r.state_vars
    pins = [3, -1, 5, 11, 2][:len(m.pins)]
    brs = [7, 9, 13][:m.nbranches]
    assert m.pattern(pins, brs) == r.pattern(pins, brs)
    assert m.rhs_pattern(pins, brs) == r.rhs_pattern(pins, brs)
    for hook in ("step_update", "check_conv", "ac_stamp", "noise",
                 "noise_corr"):
        assert (getattr(m, hook) is None) == (getattr(r, hook) is None)
    assert (m.noise_pairs, m.noise_corr_pairs) == (r.noise_pairs,
                                                   r.noise_corr_pairs)


# every analog family, several instances each, sharing nets
ZOO = [("v", "VDC", {"V": 2.0}, ("a", "0")),
       ("vac", "VAC", {"Vp": 1.0}, ("b", "a")),
       ("r", "RESISTANCE", {}, ("b", "c")),
       ("r2", "RESISTANCE", {"r": 33.0}, ("c", "0")),
       ("c", "CAPACITOR", {}, ("c", "d")),
       ("l", "INDUCTOR", {}, ("d", "0")),
       ("i", "IDC", {}, ("0", "d")),
       ("ia", "IAC", {}, ("d", "e")),
       ("e", "VCVS", {}, ("e", "0", "c", "0")),
       ("g", "VCCS", {}, ("f", "0", "e", "0")),
       ("h", "CCVS", {}, ("g", "0", "f", "0")),
       ("fc", "CCCS", {}, ("h", "0", "g", "0")),
       ("oa", "OP_AMP", {}, ("h", "i", "i", "0")),
       ("tx", "TRANSFORMER", {}, ("i", "0", "j", "0")),
       ("txct", "TRANSFORMER_CENTER_TAP", {}, ("j", "0", "k", "0", "l")),
       ("kl", "COUPLED_INDUCTORS", {}, ("k", "0", "l", "0")),
       ("saw", "SAWTOOTH", {}, ("m", "0")),
       ("sq", "SQUARE", {}, ("n", "m")),
       ("pu", "PULSE", {}, ("o", "n")),
       ("tri", "TRIANGLE", {}, ("p", "o")),
       ("sw", "SWITCH", {}, ("p", "q")),
       ("rel", "RELAY", {}, ("p", "0", "q", "r")),
       ("d", "PN_JUNCTION", {}, ("r", "0")),
       ("d2", "PN_JUNCTION", {"Is": 1e-12}, ("q", "r")),
       ("qn", "BJT_NPN", {}, ("r", "s", "0")),
       ("qp", "BJT_PNP", {}, ("s", "0", "r")),
       ("mn", "NMOSFET", {}, ("t", "s", "0")),
       ("mp", "PMOSFET", {}, ("t", "s", "a")),
       ("fbr", "FULL_BRIDGE_RECTIFIER", {}, ("t", "a", "u", "0")),
       ("b3n", "BSIM3V32_NMOS", {}, ("u", "t", "0", "0")),
       ("b3p", "BSIM3V32_PMOS", {"W": 2e-6}, ("u", "t", "a", "a")),
       ("b3nr", "BSIM3V32_NMOS_RC", {"rd": 10.0}, ("v", "u", "0", "0")),
       ("b3pr", "BSIM3V32_PMOS_RC", {}, ("v", "u", "a", "a")),
       ("b3n2", "BSIM3V32_NMOS", {"Vth0": 0.5}, ("v", "t", "0", "0")),
       ("r3", "RESISTANCE", {"r": 1e4}, ("u", "t"))]


def test_every_family_lowering_identical():
    from torch_circuit_cases import build
    ref = build("jax", ZOO).c.prepare()
    ir = build("torch", ZOO).c.prepare()
    assert (ir.n_unknowns, ir.n_nodes, ir.n_branches, ir.nonlinear) == (
        ref.n_unknowns, ref.n_nodes, ref.n_branches, ref.nonlinear)
    assert ([f.mdef.id_name for f in ir.families]
            == [f.mdef.id_name for f in ref.families])
    assert {f.mdef.id_name for f in ir.families} >= set(ANALOG)
    for fam, rfam in zip(ir.families, ref.families):
        for name in FAMILY_ARRAYS:
            _same(getattr(fam, name), getattr(rfam, name))
        assert list(fam.state0) == list(rfam.state0)
        for k in fam.state0:
            _same(fam.state0[k], rfam.state0[k])
    for a, b in zip(tan._sparse_pattern(ir), jan._sparse_pattern(ref)):
        _same(a, b)
