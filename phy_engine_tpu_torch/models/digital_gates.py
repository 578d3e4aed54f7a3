"""Digital device metadata (the port's copy of
``phy_engine_tpu/models/digital_gates.py``).

One :class:`ModelDef` per device in ``model/models/digital/`` — logical
gates, IO, and combinational/sequential blocks.  Pin *order* matches the
reference headers exactly (it is part of the public API: pins are
addressed by index); ``din_pins``/``dout_pins`` mark which indices are
inputs/outputs for the digital engine.

All behaviour lives in :mod:`phy_engine_tpu_torch.digital.engine`, which lowers
these by ``digital_op`` into opcode-segmented dense arrays; the per-pin
analog<->digital threshold automata (Ll/Hl with Tsu/Th unsteady-state
tracking, and.h:155-363) are handled generically by the mixed-signal
bridge.  Sequential blocks use rising-edge semantics with binary-clock
history, matching d_ff.h:59-66.
"""

from __future__ import annotations

from .base import ModelDef, DeviceClass, UpdatePhase, register

_GATE_DEFAULTS = {"Ll": 0.0, "Hl": 5.0, "Tsu": 1e-9, "Th": 5e-10}
_LH = {"Ll": 0.0, "Hl": 5.0}


def _dig(name, id_name, op, pins, din, dout, phase=UpdatePhase.TABLE,
         defaults=None, attrs=None, state=()):
    defaults = dict(_GATE_DEFAULTS if defaults is None else defaults)
    if attrs is None:
        attrs = tuple(defaults)
    return register(ModelDef(
        name=name, id_name=id_name, device_class=DeviceClass.DIGITAL,
        pins=tuple(pins), defaults=defaults,
        digital_op=op, update_phase=phase,
        din_pins=tuple(din), dout_pins=tuple(dout), attrs=tuple(attrs),
        state_vars=tuple(state),
    ))


# ---- 2-input gates (digital/logical/*.h) ---------------------------------
AND = _dig("AND", "AND", "AND", ("iA", "iB", "o"), (0, 1), (2,))
OR = _dig("OR", "OR", "OR", ("iA", "iB", "o"), (0, 1), (2,))
XOR = _dig("XOR", "XOR", "XOR", ("iA", "iB", "o"), (0, 1), (2,))
XNOR = _dig("XNOR", "XNOR", "XNOR", ("iA", "iB", "o"), (0, 1), (2,))
NAND = _dig("NAND", "NAND", "NAND", ("iA", "iB", "o"), (0, 1), (2,))
NOR = _dig("NOR", "NOR", "NOR", ("iA", "iB", "o"), (0, 1), (2,))
IMP = _dig("IMPLICATION", "IMP", "IMP", ("iA", "iB", "o"), (0, 1), (2,))
NIMP = _dig("NON_IMPLICATION", "NIMP", "NIMP", ("iA", "iB", "o"),
            (0, 1), (2,))
CASE_EQ = _dig("CASE_EQ", "CASE_EQ", "CASE_EQ", ("iA", "iB", "o"),
               (0, 1), (2,))
RESOLVE2 = _dig("RESOLVE2", "RESOLVE2", "RESOLVE2", ("iA", "iB", "o"),
                (0, 1), (2,))

# ---- 1-input gates --------------------------------------------------------
NOT = _dig("NOT", "NOT", "NOT", ("i", "o"), (0,), (1,))
YES = _dig("YES", "YES", "YES", ("i", "o"), (0,), (1,))
IS_UNKNOWN = _dig("IS_UNKNOWN", "IS_UNKNOWN", "IS_UNKNOWN", ("i", "o"),
                  (0,), (1,))

# ---- tri-state (logical/tri_state.h) --------------------------------------
TRI_STATE = _dig("TRI", "TRI", "TRI", ("i", "en", "o"), (0, 1), (2,),
                 defaults=dict(_LH), attrs=("Ll", "Hl"))

# ---- IO --------------------------------------------------------------------
INPUT = _dig("INPUT", "INPUT", "INPUT", ("o",), (), (0,),
             phase=UpdatePhase.BEFORE,
             defaults={"boolean": 2.0, "synth_const": 0.0, **_LH},
             attrs=("boolean",),
             state=(("value", 2.0),))
OUTPUT = _dig("OUTPUT", "OUTPUT", "OUTPUT", ("i",), (0,), (),
              defaults={"value": 2.0, **_LH}, attrs=("value",),
              state=(("value", 2.0),))
EIGHT_BIT_INPUT = _dig(
    "EIGHT_BIT_INPUT", "EIGHT_BIT_INPUT", "INPUT8",
    ("b7", "b6", "b5", "b4", "b3", "b2", "b1", "b0"),
    (), (0, 1, 2, 3, 4, 5, 6, 7), phase=UpdatePhase.BEFORE,
    defaults={"value": 0.0, **_LH}, attrs=("value",))
EIGHT_BIT_DISPLAY = _dig(
    "EIGHT_BIT_DISPLAY", "EIGHT_BIT_DISPLAY", "OUTPUT8",
    ("b7", "b6", "b5", "b4", "b3", "b2", "b1", "b0"),
    (0, 1, 2, 3, 4, 5, 6, 7), (),
    defaults={"value": 0.0, "unknown_mask": 255.0, **_LH},
    attrs=("value", "unknown_mask"))

# ---- transport delay (logical/tick_delay.h: 1 tick, before_all_clk) -------
TICK_DELAY = _dig("TICK_DELAY", "TICK_DELAY", "TICK_DELAY", ("i", "o"),
                  (0,), (1,), phase=UpdatePhase.BEFORE,
                  defaults=dict(_LH), attrs=("Ll", "Hl"),
                  state=(("held", 2.0),))

# ---- analog-threshold input (logical/schmitt_trigger.h) -------------------
SCHMITT_TRIGGER = _dig(
    "SCHMITT_TRIGGER", "SCHMITT_TRIGGER", "SCHMITT", ("i", "o"), (0,), (1,),
    defaults={"inverted": 0.0, "Vth_low": 5.0 / 3.0,
              "Vth_high": 10.0 / 3.0, **_LH},
    attrs=("inverted", "Vth_low", "Vth_high", "out"),
    state=(("out", 2.0),))

# ---- sequential blocks (digital/combinational/*.h) -------------------------
_FF_STATE = (("q", 2.0), ("last_clk", 2.0))
D_FF = _dig("DFF", "DFF", "DFF", ("d", "clk", "q"), (0, 1), (2,),
            defaults=dict(_LH), attrs=("Ll", "Hl"), state=_FF_STATE)
D_FF_ARSTN = _dig("DFF_ARSTN", "DFF_ARSTN", "DFF_ARSTN",
                  ("d", "clk", "arst_n", "q"), (0, 1, 2), (3,),
                  defaults=dict(_LH), attrs=("Ll", "Hl"), state=_FF_STATE)
D_LATCH = _dig("DLATCH", "DLATCH", "DLATCH", ("d", "en", "q"), (0, 1), (2,),
               defaults=dict(_LH), attrs=("Ll", "Hl"), state=(("q", 2.0),))
JK_FF = _dig("JKFF", "JKFF", "JKFF", ("j", "k", "clk", "q"), (0, 1, 2), (3,),
             defaults=dict(_LH), attrs=("Ll", "Hl"), state=_FF_STATE)
T_FF = _dig("TFF", "TFF", "TFF", ("t", "clk", "q"), (0, 1), (2,),
            defaults=dict(_LH), attrs=("Ll", "Hl"), state=_FF_STATE)
T_BAR_FF = _dig("TBARFF", "TBARFF", "TBARFF", ("t", "clk", "q"), (0, 1), (2,),
                defaults=dict(_LH), attrs=("Ll", "Hl"), state=_FF_STATE)

# ---- combinational macro blocks --------------------------------------------
HALF_ADDER = _dig("HALF_ADDER", "HALF_ADDER", "HALF_ADDER",
                  ("ia", "ib", "s", "c"), (0, 1), (2, 3),
                  defaults=dict(_LH), attrs=("Ll", "Hl"))
FULL_ADDER = _dig("FULL_ADDER", "FULL_ADDER", "FULL_ADDER",
                  ("ia", "ib", "cin", "s", "cout"), (0, 1, 2), (3, 4),
                  defaults=dict(_LH), attrs=("Ll", "Hl"))
HALF_SUBTRACTOR = _dig("HALF_SUBTRACTOR", "HALF_SUBTRACTOR",
                       "HALF_SUBTRACTOR", ("ia", "ib", "d", "b"),
                       (0, 1), (2, 3),
                       defaults=dict(_LH), attrs=("Ll", "Hl"))
FULL_SUBTRACTOR = _dig("FULL_SUBTRACTOR", "FULL_SUBTRACTOR",
                       "FULL_SUBTRACTOR", ("ia", "ib", "bin", "d", "bout"),
                       (0, 1, 2), (3, 4),
                       defaults=dict(_LH), attrs=("Ll", "Hl"))
MUL2 = _dig("MUL2", "MUL2", "MUL2",
            ("a0", "a1", "b0", "b1", "p0", "p1", "p2", "p3"),
            (0, 1, 2, 3), (4, 5, 6, 7),
            defaults=dict(_LH), attrs=("Ll", "Hl"))
COUNTER4 = _dig("COUNTER4", "COUNTER4", "COUNTER4",
                ("q3", "q2", "q1", "q0", "clk", "en"),
                (4, 5), (0, 1, 2, 3),
                defaults=dict(_LH), attrs=("Ll", "Hl"),
                state=(("count", 0.0), ("last_clk", 2.0)))
RANDOM_GENERATOR4 = _dig("RANDOM_GENERATOR4", "RANDOM_GENERATOR4", "RANDOM4",
                         ("q3", "q2", "q1", "q0", "clk", "reset_n"),
                         (4, 5), (0, 1, 2, 3),
                         defaults={**_LH, "seed": 1.0},
                         attrs=("Ll", "Hl", "seed"),
                         state=(("lfsr", 1.0), ("last_clk", 2.0)))
