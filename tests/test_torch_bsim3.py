"""Port parity of the four BSIM3v3.2 families (``models/bsim3.py``):
stamp, AC stamp, step update, noise and correlated noise hooks against
the JAX package's per-instance kernels (vmapped over lanes and
instances, one jit per family), at random biases, on parameter sets
taken from each wave of ``tests/test_bsim3*.py``: defaults, gate leakage,
GIDL/GISL with impact ionization, rdsw/prwg/prwb, capMod with xpart,
binning, SCE/DIBL/CLM/SCBE with mobMod, junction caps and currents with
dtemp and multiplicity, NQS; the ``_RC`` variants also with nonzero
rd/rs/rg/rb.  Each set runs with nqsmod 0 on half the instances and 1
on the other half where it enables NQS.  The OP-mode stamp is the TR one
less the companion terms (its JAX counterpart, the bare Jacobian, is
held through the AC stamp's real part).  The ``_RC`` families run in
``test_torch_bsim3_rc.py`` (each family's JAX side traces for ~45 s).

Tolerance: 1e-10 relative to the instance's largest |entry| of the same
array (its Jacobian, C matrix, AC stamp; the noise hooks' PSDs to 1e-9,
the bound of the noise analysis), or to 1e-12 of the
largest over the lane's instances where that is larger: a device cut off
so deep that its Jacobian is ~1e-43 S (1e-30 of its neighbours') has no
relative accuracy to hold.  The induced-gate hook's S_ig grows as
1/(gm + gds + gmb), so it is held on the instances that conduct (channel
noise above 1e-12 of the lane's largest).  Values that are
sums of cancelling terms — the RHS ``-(i - J v)`` and the companion
history ``-(G v) - i_c`` — are held relative to the largest term they
sum, max|J| · max|v| per instance (the rounding of that sum is the same
size in both packages).
"""

import pytest

from phy_engine_tpu.models import MODEL_REGISTRY as JAX_REGISTRY

from phy_engine_tpu_torch.models import MODEL_REGISTRY

import bsim3_cases


@pytest.mark.parametrize("key,wave",
                         bsim3_cases.cases(("BSIM3_NMOS", "BSIM3_PMOS")))
def test_bsim3_family_matches_jax(key, wave):
    bsim3_cases.check_family(key, wave)


def test_bsim3_families_registered():
    import phy_engine_tpu_torch as pe
    for key, name in zip(bsim3_cases.FAMILIES,
                         ("BSIM3V32_NMOS", "BSIM3V32_PMOS",
                          "BSIM3V32_NMOS_RC", "BSIM3V32_PMOS_RC")):
        assert getattr(pe.models, name) is MODEL_REGISTRY[key]
        m, r = MODEL_REGISTRY[key], JAX_REGISTRY[key]
        assert m.check_conv is None and r.check_conv is None
        assert m.attr_aliases == r.attr_aliases
        assert (m.noise_pairs, m.noise_corr_pairs) == (r.noise_pairs,
                                                       r.noise_corr_pairs)
