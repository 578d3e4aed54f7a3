"""Port parity of the BSIM3v3.2 terminal-parasitic families
(``BSIM3_NMOS_RC`` / ``BSIM3_PMOS_RC``: D/G/S/B series resistances on
four internal nodes), every hook against the JAX package on every
parameter set of ``test_torch_bsim3.py`` plus nonzero rd/rs/rg/rb, rsh
and nrd/nrs; inputs, tolerances and checks in ``bsim3_cases.py``."""

import pytest

import bsim3_cases


@pytest.mark.parametrize("key,wave", bsim3_cases.cases(("BSIM3_NMOS_RC",
                                                        "BSIM3_PMOS_RC")))
def test_bsim3_rc_family_matches_jax(key, wave):
    bsim3_cases.check_family(key, wave)
