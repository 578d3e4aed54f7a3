"""Port parity of the sensitivity analysis through BSIM3 (see
``test_torch_sens.py`` for what is held): a common-source BSIM3 stage
(capMod 1) on a resistive bias chain, ``Circuit.sens`` of the drain
voltage at the OP, and
``Circuit.sens_ac`` of the drain over five points from 1 kHz to 10 GHz —
the gradient through the Jacobian of the BSIM3 currents and charges (the
port's forward-mode Jacobian inside ``torch.autograd``'s reverse sweep,
the JAX package's ``jax.jacfwd`` inside ``jax.grad``), the bias point and
the AC solve.  The JAX side runs ``engine/sens.py``'s ``sens_op`` /
``sens_ac`` under ``jax.disable_jit()`` after its ``Circuit``'s OP, as
its ``Circuit.sens`` / ``sens_ac`` do under ``jax.jit``: compiling
BSIM3's Jacobian inside a gradient takes ~5 minutes on a CPU, running it
op by op half that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phy_engine_tpu.engine import sens as jsens

import torch_circuit_cases as cases
import torch_circuits
from test_torch_sens import TWO_PI, assert_same_sens, run
from torch_circuits import TIGHT

torch.set_num_threads(1)

STAGE = torch_circuits.bsim3_cs_stage()
AC = ("LOG", TWO_PI * 1e3, TWO_PI * 1e10, 5)


def run_jax(what):
    """The JAX package's sensitivity of the drain, op by op."""
    b = cases.build("jax", STAGE, env=TIGHT)
    c = b.c
    c.ac = b.mod.ACSettings(sweep=b.mod.ACSweepType.LOG, omega_start=AC[1],
                            omega_stop=AC[2], points=AC[3])
    c.prepare()
    assert c._analyze_op(mode="op")
    args = (c._ir, c._params(), c._x, c._states, c._env_scalars(),
            c._out_index(b.nodes["d"]))
    with jax.disable_jit():
        if what == "sens":
            return jsens.SensResult(c._ir, jsens.sens_op(*args), args[1]), \
                None, b
        omegas = jnp.asarray(c._omega_grid())
        mag, grads = jsens.sens_ac(*args, omegas)
    return (jsens.SensResult(c._ir, grads, args[1]),
            (np.asarray(omegas) / TWO_PI, np.asarray(mag)), b)


@pytest.mark.parametrize("what", ["sens", "sens_ac"])
def test_bsim3_sens_matches_jax(what):
    j = run_jax(what)
    t = run("torch", STAGE, "d", what, TIGHT, AC if what == "sens_ac"
            else None)
    g = j[0].grads["BSIM3_NMOS"]
    assert np.abs(g).max() > 0.0
    assert_same_sens(j, t)
