"""The ``Circuit`` driver of the port, for digital-only netlists (the
digital entry points of ``phy_engine_tpu/engine/circuit.py``:
``digital_run``, ``digital_run_batch`` and :class:`DigitalTrace`).

Analog and mixed-signal netlists come with a later slice; ``prepare``
raises on them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.base import DeviceClass
from ..netlist.netlist import Netlist


class Circuit:
    """``device``: where the digital ticks run ("cuda" by default)."""

    def __init__(self, netlist: Optional[Netlist] = None, device="cuda"):
        self.nl = netlist if netlist is not None else Netlist()
        self.device = device
        self._digital = None         # DigitalEngine, built by prepare()
        self._version = None

    def prepare(self, force: bool = False):
        """Lower the netlist (cached on its structural version) and return
        the digital engine."""
        if self._digital is None or force or self._version != self.nl.version:
            analog = [m.mdef.name for m in self.nl.live_models()
                      if m.mdef.device_class != DeviceClass.DIGITAL]
            if analog:
                raise NotImplementedError(
                    f"analog devices in the netlist ({sorted(set(analog))}): "
                    "the port's Circuit runs digital-only netlists; analog "
                    "and mixed-signal circuits come with the Circuit-driver "
                    "slice (ROADMAP.md queue 1 item 9)")
            from ..digital.engine import DigitalEngine
            self._digital = DigitalEngine(self.nl, self.device)
            self._version = self.nl.version
        return self._digital

    def digital_run(self, schedule) -> "DigitalTrace":
        """Run ``len(schedule)`` digital ticks in one device program.

        ``schedule``: per tick, a dict {INPUT model -> value} overriding
        that device's attribute for the tick; unlisted INPUT devices
        hold their current attribute value.  A value is either a 4-state
        code (0/1/2/3, broadcast to all 32 stimulus lanes) or a tuple
        ``(v_word, u_word)`` of 32-bit planes giving each lane its own
        4-state value.  Returns a :class:`DigitalTrace`."""
        eng, fs, FV, FU = self._compile_schedule(schedule)
        return DigitalTrace(eng, eng.run_ticks(fs, FV, FU))

    def _compile_schedule(self, schedule):
        eng = self._digital or self.prepare()
        ir = eng.ir
        sig_of = {}
        base = {}
        for inst, out_sigs in ir.inputs:
            if inst.mdef.digital_op == "INPUT":
                sig_of[id(inst)] = out_sigs[0]
                base[out_sigs[0]] = int(
                    inst.params.get("boolean", 2)) & 3
        fs = sorted(base)
        pos = {s: k for k, s in enumerate(fs)}
        T = len(schedule)
        FV = np.zeros((T, len(fs)), np.uint32)
        FU = np.zeros((T, len(fs)), np.uint32)
        FULL32 = np.uint32(0xFFFFFFFF)
        for t, entry in enumerate(schedule):
            codes = dict(base)
            for inst, code in entry.items():
                s = sig_of.get(id(inst))
                if s is None:
                    raise ValueError("not a digital INPUT device")
                codes[s] = code
            for s, code in codes.items():
                if isinstance(code, tuple):
                    FV[t, pos[s]] = np.uint32(code[0] & 0xFFFFFFFF)
                    FU[t, pos[s]] = np.uint32(code[1] & 0xFFFFFFFF)
                else:
                    code = int(code) & 3
                    FV[t, pos[s]] = FULL32 if (code & 1) else 0
                    FU[t, pos[s]] = FULL32 if (code & 2) else 0
        return eng, np.array(fs, np.int32), FV, FU

    def digital_run_batch(self, schedules, watch_nodes):
        """Run B independent copies of the design, one schedule each (all
        the same length), from the current state.  ``watch_nodes``: nets
        whose per-tick 4-state codes are recorded.  Returns int8 codes of
        shape [B, T, len(watch_nodes)] (lane 0)."""
        compiled = [self._compile_schedule(s) for s in schedules]
        eng, fs = compiled[0][:2]
        FV = np.stack([c[2] for c in compiled])
        FU = np.stack([c[3] for c in compiled])
        watch = [eng.ir.node_sig.get(id(n), 0) for n in watch_nodes]
        hv, hu = eng.run_ticks_batched(fs, FV, FU, watch=watch)
        v = (hv & 1).astype(np.int8)
        u = (hu & 1).astype(np.int8)
        return v | (u << 1)

    def node_digital(self, node) -> int:
        return self.prepare().signal_code(node)


class DigitalTrace:
    """Per-tick 4-state history from Circuit.digital_run (lane 0)."""

    def __init__(self, eng, hist):
        sv, su = hist
        self._eng = eng
        self.sv = np.asarray(sv)
        self.su = np.asarray(su)

    def __len__(self):
        return self.sv.shape[0]

    def node_codes(self, node, lane: int = 0) -> np.ndarray:
        """4-state code of a net at every tick (one stimulus lane)."""
        sig = self._eng.ir.node_sig.get(id(node))
        if sig is None:
            return np.full(len(self), 2, np.int8)
        v = ((self.sv[:, sig] >> np.uint32(lane)) & 1).astype(np.int8)
        u = ((self.su[:, sig] >> np.uint32(lane)) & 1).astype(np.int8)
        return v | (u << 1)

    def bus_values(self, nodes, lane: int = 0) -> np.ndarray:
        """Unsigned value of a bus (LSB-first node list) per tick;
        unknown bits read as 0."""
        out = np.zeros(len(self), np.int64)
        for i, n in enumerate(nodes):
            c = self.node_codes(n, lane)
            out |= ((c == 1).astype(np.int64)) << i
        return out

    def bus_values_lanes(self, nodes) -> np.ndarray:
        """(T, 32) bus values across every stimulus lane."""
        T = len(self)
        out = np.zeros((T, 32), np.int64)
        for i, n in enumerate(nodes):
            sig = self._eng.ir.node_sig.get(id(n))
            if sig is None:
                continue
            v = self.sv[:, sig]
            u = self.su[:, sig]
            for lane in range(32):
                bit = ((v >> np.uint32(lane)) & 1) & ~((u >> np.uint32(lane)) & 1)
                out[:, lane] |= bit.astype(np.int64) << i
        return out
