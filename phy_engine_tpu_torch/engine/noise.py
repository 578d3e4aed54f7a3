"""Small-signal noise analysis, SPICE .NOISE class (port of
``phy_engine_tpu/engine/noise.py``; the reference engine has none).

The adjoint-network method: at each frequency the linearized AC system
A(ω) (``analog.assemble_ac`` around the saved OP linearizations) is solved
once transposed, Aᵀ(ω) y = e_out, and the transfer impedance from a noise
current injected between nodes (p, q) to the output voltage is y_p − y_q,
so every device noise source costs one gather.  The output PSD is

    S_vout(ω) = Σ_sources |y_p − y_q|² · S_i(ω),

with S_i from each family's ``noise`` hook (``noise_pairs`` its
terminals) and the correlated groups of ``noise_corr``.  Where the JAX
package vmaps one frequency, the ω grid is a leading batch dimension of
``assemble_ac``, of every hook and of one batched split-real f64 solve.
Input-referred noise divides by |v_out / e_src|² from a unit excitation
on the ``src_row`` branch row, solved in the same batch.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops.linsolve import dense_solve
from .analog import _ext, _family_index, assemble_ac, split_real
from .lower import AnalogIR


def _masked(fam, t):
    """t (W, n_inst, ...) times the family's per-instance mask, when it
    has one (``parallel.mesh.tp_pad_ir``'s padding)."""
    msk = getattr(fam, "mask", None)
    if msk is None:
        return t
    m = torch.as_tensor(msk, dtype=t.dtype, device=t.device)
    return t * m.reshape((-1,) + (1,) * (t.dim() - 2))


def _unit(W: int, n2: int, row: int, like):
    e = like.new_zeros((W, n2))
    e[:, row] = 1.0
    return e


def noise_sweep(ir: AnalogIR, params, x_op, states, omegas, out_idx: int,
                src_row: Optional[int] = None, env: Optional[Dict] = None):
    """Output-noise sweep of one circuit over the grid ``omegas`` (W,).

    ``params`` / ``states`` are the circuit's ({family: (n_inst, ...)}),
    ``x_op`` (n,) its operating point.  Returns ``(onoise, gain2,
    contribs)``: the (W,) output voltage noise PSD [V²/Hz] at node
    ``out_idx``; the (W,) squared gain |v_out / e_src|² from a unit
    excitation on branch row ``src_row`` (ones when None); and {family
    id_name: (W,) PSD}, the per-family breakdown."""
    n = ir.n_unknowns
    W = omegas.shape[0]
    Ar, Ai, _zr, _zi = assemble_ac(ir, params, states, omegas)
    # adjoint: Aᵀ y = e_out, split-real (Aᵀ = Arᵀ + jAiᵀ)
    y = dense_solve(split_real(Ar.transpose(1, 2), Ai.transpose(1, 2)),
                    _unit(W, 2 * n, out_idx, omegas))
    yr, yi = _ext(y[:, :n]), _ext(y[:, n:])            # ground = slot n
    f = omegas / (2.0 * np.pi)
    x_ext = _ext(x_op)
    onoise = omegas.new_zeros(W)
    contribs = {}

    def family_inputs(fam):
        key = fam.mdef.id_name
        pins, brs = _family_index(ir, fam, x_op.device)
        P = params[key].expand((W,) + params[key].shape)
        st = {k: v.expand((W,) + v.shape)
              for k, v in states.get(key, {}).items()}
        return (pins, P, x_ext[pins].expand((W,) + pins.shape),
                x_ext[brs].expand((W,) + brs.shape), st,
                f[:, None].expand(W, pins.shape[0]))

    def gain(pins, pair):
        """(W, n_inst) transfers y_p - y_q of each instance's pair."""
        p, q = pins[:, pair[0]], pins[:, pair[1]]
        return yr[:, p] - yr[:, q], yi[:, p] - yi[:, q]

    for fam in ir.families:
        if fam.mdef.noise is None or not fam.mdef.noise_pairs:
            continue
        pins, P, vp, vb, st, fw = family_inputs(fam)
        psd = fam.mdef.noise(P, vp, vb, st, env, fw).clamp(min=0.0)
        psd = _masked(fam, psd)
        g2 = []
        for pair in fam.mdef.noise_pairs:
            gr, gi = gain(pins, pair)
            g2.append(gr * gr + gi * gi)
        c = (torch.stack(g2, dim=2) * psd).sum(dim=(1, 2))
        contribs[fam.mdef.id_name] = c
        onoise = onoise + c

    # correlated source groups:
    # S_aa|Ga|² + S_bb|Gb|² + 2·Re(Ga·conj(Gb)·S_ab)
    for fam in ir.families:
        if fam.mdef.noise_corr is None or not fam.mdef.noise_corr_pairs:
            continue
        pins, P, vp, vb, st, fw = family_inputs(fam)
        S = fam.mdef.noise_corr(P, vp, vb, st, env, fw,
                                omegas[:, None].expand(fw.shape))
        S = _masked(fam, S)
        terms = []
        for g, (pa, pb) in enumerate(fam.mdef.noise_corr_pairs):
            ga_r, ga_i = gain(pins, pa)
            gb_r, gb_i = gain(pins, pb)
            saa = S[:, :, g, 0].clamp(min=0.0)
            sbb = S[:, :, g, 1].clamp(min=0.0)
            sr_, si_ = S[:, :, g, 2], S[:, :, g, 3]
            # Re(Ga·conj(Gb)·(sr + j·si)) = sr·X − si·Y
            X = ga_r * gb_r + ga_i * gb_i
            Y = ga_i * gb_r - ga_r * gb_i
            terms.append(saa * (ga_r ** 2 + ga_i ** 2) +
                         sbb * (gb_r ** 2 + gb_i ** 2) +
                         2.0 * (sr_ * X - si_ * Y))
        # a correlated group can lower the total below the sum of its
        # parts but never below zero: clamp the family aggregate
        c = torch.stack(terms, dim=2).sum(dim=(1, 2)).clamp(min=0.0)
        key = fam.mdef.id_name
        contribs[key] = contribs[key] + c if key in contribs else c
        onoise = onoise + c

    if src_row is None:
        return onoise, torch.ones_like(onoise), contribs
    xg = dense_solve(split_real(Ar, Ai), _unit(W, 2 * n, src_row, omegas))
    return onoise, xg[:, out_idx] ** 2 + xg[:, n + out_idx] ** 2, contribs


def integrate_psd(freqs, psd) -> float:
    """Total noise power over the sweep band: trapezoid of the PSD in f
    [V²]; its square root is the integrated RMS noise."""
    return float(np.trapezoid(np.asarray(psd, np.float64),
                              np.asarray(freqs, np.float64)))


class NoiseResult:
    """Sweep result: PSDs are one-sided, in V²/Hz (host numpy arrays)."""

    def __init__(self, freqs, onoise, gain2, contribs):
        def host(a):
            return a.detach().cpu().numpy() if torch.is_tensor(a) \
                else np.asarray(a)
        self.freqs = host(freqs)
        self.onoise_psd = host(onoise)
        self.gain2 = host(gain2)
        self.inoise_psd = self.onoise_psd / np.maximum(self.gain2, 1e-300)
        self.contribs = {k: host(v) for k, v in contribs.items()}

    def onoise_total(self) -> float:
        return integrate_psd(self.freqs, self.onoise_psd)

    def inoise_total(self) -> float:
        return integrate_psd(self.freqs, self.inoise_psd)
