"""Device model protocol (port of ``phy_engine_tpu/models/base.py``).

A device *family* is a :class:`ModelDef`: host metadata (pins, branches,
parameter order, state variables, static COO patterns) plus batched torch
kernels.  Where the JAX package vmaps a per-instance scalar kernel, the
port's kernels take the whole family at once: ``P`` is ``(..., n_inst,
n_params)``, ``v`` ``(..., n_inst, n_pins)``, ``ib`` ``(..., n_inst,
n_br)`` and each state variable ``(..., n_inst)``; the leading dims are
the Monte-Carlo batch (or absent).

* ``pattern(pins, brs)`` -> static COO (rows, cols) of one instance;
* ``rhs_pattern(pins, brs)`` -> static RHS rows of one instance;
* ``stamp(P, v, ib, state, ctx)`` -> (A_vals (..., n_inst, K),
  z_vals (..., n_inst, Kz), new_state);
* ``ac_stamp(P, state, omega)`` -> (A_re, A_im (..., n_inst, K), z_re,
  z_im (..., n_inst, Kz)): the small-signal stamp, ``omega`` a tensor of
  ``P[..., 0]``'s shape (nonlinear families read their saved operating
  point from ``state``);
* ``step_update(P, v, ib, state, dt, t)`` -> new_state (transient
  companion recurrence between accepted steps);
* ``check_conv(P, v, state)`` -> (..., n_inst) bool convergence veto;
* ``noise(P, v, ib, state, env, f)`` -> (..., n_inst, len(noise_pairs))
  one-sided current-noise PSDs [A^2/Hz] at the bias point, ``f`` a
  frequency tensor of ``P[..., 0]``'s shape;
* ``noise_corr(P, v, ib, state, env, f, omega)`` -> (..., n_inst,
  len(noise_corr_pairs), 4) correlated source groups.

Digital families carry metadata only (``digital_op``, ``din_pins``,
``dout_pins``): their behaviour lives in :mod:`..digital`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple


class DeviceClass(enum.Enum):
    """Mirrors ``model_device_type`` of the reference (model_refs/base.h)."""
    LINEAR = "linear"
    NONLINEAR = "non_linear"
    DIGITAL = "digital"


class UpdatePhase(enum.Enum):
    """Digital scheduling class, mirrors ``digital_update_method_t``
    (node.h): update_table / before_all_clk / after_all_clk."""
    TABLE = 0
    BEFORE = 1
    AFTER = 2


@dataclass
class StampCtx:
    """Context threaded to the device kernels.

    ``mode`` is 'op'|'dc'|'tr'|'trop'; ``t`` and ``dt`` are host floats
    (0.0 outside TR); ``env`` holds the environment scalars.
    """
    mode: str
    t: float = 0.0
    dt: float = 0.0
    env: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class ModelDef:
    name: str                       # e.g. "Resistance"
    id_name: str                    # e.g. "R"
    device_class: DeviceClass
    pins: Tuple[str, ...] = ()
    defaults: Dict[str, Any] = field(default_factory=dict)
    nbranches: int = 0
    # order in which float params are packed into the P row
    param_order: Tuple[str, ...] = ()
    # (state_name, init) pairs; init is a float or fn(params) -> float
    state_vars: Tuple[Tuple[str, Any], ...] = ()
    pattern: Optional[Callable] = None
    rhs_pattern: Optional[Callable] = None
    stamp: Optional[Callable] = None
    ac_stamp: Optional[Callable] = None
    step_update: Optional[Callable] = None
    check_conv: Optional[Callable] = None
    nonlinear: bool = False
    # internal unknowns per instance, appended to the pin vector
    n_internal: int = 0

    # ---- noise hooks (an extension of the JAX package: the reference
    #      has no noise analysis, bsim3v32.h:28-29) ----
    # noise(P, v, ib, state, env, f): one-sided current-noise PSD [A^2/Hz]
    # per source at the OP bias (v = pin voltages incl. internal nodes,
    # ib = branch currents), last dim len(noise_pairs).
    noise: Optional[Callable] = None
    # per-source (pin_i, pin_j) index pairs into the instance pin vector:
    # the noise current source is connected between them.
    noise_pairs: Tuple[Tuple[int, int], ...] = ()
    # noise_corr(P, v, ib, state, env, f, omega): per group (S_aa, S_bb,
    # Re S_ab, Im S_ab), the one-sided cross-PSDs [A^2/Hz] between current
    # sources on pair_a and pair_b, last dims (len(noise_corr_pairs), 4).
    # Contribution: S_aa|Ga|^2 + S_bb|Gb|^2 + 2 Re(Ga conj(Gb) S_ab) with
    # Ga / Gb the adjoint transfers.
    noise_corr: Optional[Callable] = None
    # ((pair_a, pair_b), ...) with each pair = (pin_i, pin_j).
    noise_corr_pairs: Tuple[Tuple[Tuple[int, int],
                                  Tuple[int, int]], ...] = ()

    # ---- digital metadata ----
    digital_op: Optional[str] = None       # opcode key into digital engine
    update_phase: UpdatePhase = UpdatePhase.TABLE
    # pin indices (into .pins) that are digital inputs / outputs; pin
    # ordering itself matches the reference headers exactly.
    din_pins: Tuple[int, ...] = ()
    dout_pins: Tuple[int, ...] = ()
    # externally visible attribute names in reference order
    attrs: Tuple[str, ...] = ()
    # alternate attribute spellings -> canonical param name
    attr_aliases: Dict[str, str] = field(default_factory=dict)
    # devices with variable pin counts
    dynamic_params: bool = False
    pin_names_fn: Optional[Callable] = None
    nbranches_fn: Optional[Callable] = None

    def num_pins(self, params) -> int:
        return len(self.pin_names_for(params))

    def pin_names_for(self, params) -> Sequence[str]:
        if self.pin_names_fn is not None:
            return self.pin_names_fn(params)
        return self.pins

    def num_branches(self, params) -> int:
        if self.nbranches_fn is not None:
            return self.nbranches_fn(params)
        return self.nbranches

    def attr_names(self, params) -> list:
        return list(self.attrs) if self.attrs else list(self.defaults)

    def init_state_row(self, params) -> Dict[str, float]:
        out = {}
        for sname, init in self.state_vars:
            out[sname] = float(init(params)) if callable(init) else float(init)
        return out

    def pack_params(self, params) -> list:
        return [float(params[k]) for k in self.param_order]

    @property
    def is_analog(self) -> bool:
        return self.stamp is not None

    def __repr__(self):  # pragma: no cover
        return f"ModelDef({self.id_name})"


# Global registry: id_name -> ModelDef  (reference: builtin_registry.h)
MODEL_REGISTRY: Dict[str, ModelDef] = {}


def register(mdef: ModelDef) -> ModelDef:
    MODEL_REGISTRY[mdef.id_name] = mdef
    return mdef
