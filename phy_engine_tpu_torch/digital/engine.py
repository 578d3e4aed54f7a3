"""Digital engine of the port (the turbo subset of
``phy_engine_tpu/digital/engine.py``).

:class:`DigitalEngine` owns the digital IR of a netlist, the lane planes
(V, U — 32 stimulus lanes per uint32 word, host numpy) and the flip-flop
state across runs.  Every tick runs on the turbo path
(:mod:`.turbo`): on the card it is the hand-written whole-tick kernel.
A design the turbo tick cannot compute (latches, feedback cycles,
TICK_DELAY, VERILOG_MODULE, analog sampling) raises; there is no other
engine to fall back to in the port yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..netlist.netlist import Netlist
from . import logic, turbo
from .ir import DigitalIR, Segment, lower_digital

FULL = 0xFFFFFFFF


def _input_cone_levels(ir: DigitalIR):
    """Per level, the subset of comb gates in the forward cone of the
    tick's mutable sources (forced INPUTs, analog-sampled nets,
    transport-delay outputs).  The pre-sequential settle only needs
    these: everything else is already settled from the previous tick's
    final pass."""
    dirty = set()
    for inst, out_sigs in ir.inputs:
        dirty.update(int(s) for s in out_sigs)
    dirty.update(int(s) for s in np.asarray(ir.samp_sig).ravel())
    if ir.tick_delays is not None:
        dirty.update(int(s) for s in ir.tick_delays.outputs[:, 0])
    for vm in ir.vmods:            # embedded-module outputs are forced
        for s in vm[4]:
            dirty.update(int(x) for x in np.asarray(s).ravel())

    out = []
    for level in ir.levels:
        lvl = []
        for seg in level:
            keep = []
            for k in range(len(seg.outputs)):
                if any(int(x) in dirty for x in seg.inputs[k]
                       if int(x) >= 0):
                    keep.append(k)
                    for x in seg.outputs[k]:
                        if int(x) >= 0:
                            dirty.add(int(x))
            if keep:
                lvl.append(Segment(
                    op=seg.op,
                    inputs=seg.inputs[keep],
                    outputs=seg.outputs[keep],
                    instances=[seg.instances[k] for k in keep]
                    if seg.instances else [],
                    anodes=(seg.anodes[keep]
                            if seg.anodes is not None else None),
                    fparams=(seg.fparams[keep]
                             if seg.fparams is not None else None)))
        out.append(lvl)
    return out


class DigitalEngine:
    """Owns the digital IR, planes, and sequential state across runs.

    ``device``: where the ticks run ("cuda" by default; "cpu" runs the
    turbo tick's plain torch version)."""

    def __init__(self, nl: Netlist, device="cuda"):
        self.nl = nl
        self.device = torch.device(device)
        self.ir: Optional[DigitalIR] = lower_digital(nl)
        if self.ir is None:
            raise ValueError("the netlist has no digital devices")
        if not turbo.eligible(self.ir):
            raise ValueError(
                "design not eligible for the turbo tick (latches, feedback "
                "cycles, TICK_DELAY, VERILOG_MODULE or analog sampling); "
                "the levelled engine that runs those is not ported yet "
                "(ROADMAP.md queue 1 item 12)")
        self._plans: Dict[bytes, turbo.TurboPlan] = {}
        self.reset_state()

    def reset_state(self):
        """Every signal X; every flip-flop's q and last clock X."""
        n = self.ir.n_signals
        self.sv = np.zeros(n, np.uint32)
        self.su = np.full(n, FULL, np.uint32)
        st: Dict[str, Dict] = {}
        for seg in self.ir.seq:
            k = len(seg.instances)
            st[seg.op] = {"q_v": np.zeros(k, np.uint32),
                          "q_u": np.full(k, FULL, np.uint32),
                          "lc_v": np.zeros(k, np.uint32),
                          "lc_u": np.full(k, FULL, np.uint32)}
        self.seq_state = st

    def load_state(self, sv, su, seq_state: Dict):
        """Carry planes and flip-flop state in from elsewhere (numpy
        uint32 arrays, e.g. the JAX engine's mid-run state)."""
        n = self.ir.n_signals
        sv = np.asarray(sv, np.uint32).copy()
        su = np.asarray(su, np.uint32).copy()
        if sv.shape != (n,) or su.shape != (n,):
            raise ValueError(f"planes must be ({n},), got {sv.shape} "
                             f"and {su.shape}")
        self.sv, self.su = sv, su
        self.seq_state = {op: {k: np.asarray(v, np.uint32).copy()
                               for k, v in d.items()}
                          for op, d in seq_state.items()}
        self._writeback()

    def plan(self, forced_sig) -> turbo.TurboPlan:
        fs = np.asarray(forced_sig, np.int32)
        key = fs.tobytes()
        if key not in self._plans:
            self._plans[key] = turbo.TurboPlan(self.ir, fs)
        return self._plans[key]

    def _state0(self, plan: turbo.TurboPlan, B: int):
        st = torch.from_numpy(plan.pack_state(self.sv, self.su,
                                              self.seq_state))
        return st.to(self.device)[None].expand(B, 2, plan.K).contiguous()

    def run_ticks(self, forced_sig, forced_v, forced_u):
        """Run T ticks on the device with a per-tick forced-input
        schedule.

        ``forced_sig``: int32[S] signal indices (fixed across ticks);
        ``forced_v``/``forced_u``: uint32[T, S] per-tick bit planes.
        Returns the per-tick (sv, su) history [T, n_signals] uint32
        numpy; the final state is committed."""
        plan = self.plan(forced_sig)
        hv, hu = turbo.run_turbo(
            plan, self._state0(plan, 1),
            turbo.as_int32(forced_v)[None].to(self.device),
            turbo.as_int32(forced_u)[None].to(self.device))
        v, u = plan.unpack_hist(hv[0], hu[0])
        self.sv = v[-1, :plan.S].copy()
        self.su = u[-1, :plan.S].copy()
        self.seq_state = plan.commit_seq_state(v[-1], u[-1], self.seq_state)
        self._writeback()
        return v[:, :plan.S], u[:, :plan.S]

    def run_ticks_batched(self, forced_sig, FV, FU, watch=None):
        """Run B independent instances of the design for T ticks each,
        every one from the engine's CURRENT state (nothing is committed
        back).  ``FV``/``FU``: uint32[B, T, S] per-instance schedules over
        the shared ``forced_sig`` list.  ``watch``: signal indices whose
        per-tick planes are recorded (all signals when None).  Returns
        (hist_v, hist_u) uint32 numpy [B, T, len(watch)]."""
        plan = self.plan(forced_sig)
        FV = turbo.as_int32(FV).to(self.device)
        hv, hu = turbo.run_turbo(
            plan, self._state0(plan, FV.shape[0]), FV,
            turbo.as_int32(FU).to(self.device), watch=watch)
        v, u = plan.unpack_hist(hv, hu)
        if watch is None:
            v, u = v[..., :plan.S], u[..., :plan.S]
        return v, u

    def _writeback(self):
        """Lane-0 readback into netlist nodes and OUTPUT devices."""
        code = (self.sv & 1) | ((self.su & 1) << 1)
        for node, sig in self._node_sig_objs():
            node.digital = int(code[sig])
        # OUTPUT devices capture their input value (output.h:83+)
        for inst, in_sigs in self.ir.outputs:
            if inst.mdef.digital_op == "OUTPUT":
                inst.params["value"] = int(code[in_sigs[0]])
            else:  # OUTPUT8
                val = 0
                unk = 0
                for k, s in enumerate(in_sigs):
                    bit = 7 - k
                    c = int(code[s])
                    if c == 1:
                        val |= (1 << bit)
                    elif c >= 2:
                        unk |= (1 << bit)
                inst.params["value"] = float(val)
                inst.params["unknown_mask"] = float(unk)

    def _node_sig_objs(self):
        if not hasattr(self, "_nso"):
            by_id = {}
            for node in self.nl.all_nodes():
                if id(node) in self.ir.node_sig:
                    by_id[id(node)] = node
            self._nso = [(by_id[k], s) for k, s in self.ir.node_sig.items()
                         if k in by_id]
        return self._nso

    def signal_code(self, node) -> int:
        """Current 4-state code of a digital net (lane 0)."""
        sig = self.ir.node_sig.get(id(node))
        if sig is None:
            return logic.X
        return (int(self.sv[sig]) & 1) | ((int(self.su[sig]) & 1) << 1)
