"""PhysicsLab ``.sav`` (plsav) scene interop (the port's copy of
``phy_engine_tpu/io/plsav.py``; scenes are equal to the JAX package's
under the same ``random`` seed).

Capability parity with ``phy_lab_wrapper/`` (SURVEY.md §2.6):

* :class:`Experiment` — the scene JSON document (elements with
  ModelID/Identifier/Properties, wires with Source/SourcePin/Target/
  TargetPin/ColorName, camera defaults, the circuit scene template whose
  element list + wires live in the embedded ``StatusSave`` JSON string —
  physicslab.h:320-1293);
* :func:`experiment_to_circuit` — PL scene -> api.Circuit (the
  element-code mapping of pe_sim.h:154-271), with input sync and
  write-back of solved voltages/currents/logic states
  (pe_sim.h:534-607);
* :func:`circuit_to_experiment` — PE netlist -> PL scene export
  (pe_to_pl.h:376-534) with per-net wire generation and grid placement.
"""

from __future__ import annotations

import json
import random
import string
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..netlist.netlist import Netlist
from ..api import Circuit, Element, Wire, ElementCode, DigitalState

# ---------------------------------------------------------------------------
# ModelID tables (PL element names <-> our element codes).
# Property keys use PhysicsLab's native (Chinese) names.
# ---------------------------------------------------------------------------

PL_TO_CODE: Dict[str, int] = {
    "Ground Component": ElementCode.GROUND,
    "Resistor": ElementCode.RESISTOR,
    "Basic Capacitor": ElementCode.CAPACITOR,
    "Basic Inductor": ElementCode.INDUCTOR,
    "Battery Source": ElementCode.VDC,
    "Sinewave Source": ElementCode.VAC,
    "Logic Input": ElementCode.DIGITAL_INPUT,
    "Logic Output": ElementCode.DIGITAL_OUTPUT,
    "Yes Gate": ElementCode.DIGITAL_YES,
    "No Gate": ElementCode.DIGITAL_NOT,
    "And Gate": ElementCode.DIGITAL_AND,
    "Or Gate": ElementCode.DIGITAL_OR,
    "Xor Gate": ElementCode.DIGITAL_XOR,
    "Xnor Gate": ElementCode.DIGITAL_XNOR,
    "Nand Gate": ElementCode.DIGITAL_NAND,
    "Nor Gate": ElementCode.DIGITAL_NOR,
    "Imp Gate": ElementCode.DIGITAL_IMP,
    "Nimp Gate": ElementCode.DIGITAL_NIMP,
    "Half Adder": ElementCode.DIGITAL_HALF_ADDER,
    "Full Adder": ElementCode.DIGITAL_FULL_ADDER,
    "Half Subtractor": ElementCode.DIGITAL_HALF_SUBTRACTOR,
    "Full Subtractor": ElementCode.DIGITAL_FULL_SUBTRACTOR,
    "Multiplier": ElementCode.DIGITAL_MUL2,
    "D Flipflop": ElementCode.DIGITAL_DFF,
    "T Flipflop": ElementCode.DIGITAL_TFF,
    "Real-T Flipflop": ElementCode.DIGITAL_T_BAR_FF,
    "JK Flipflop": ElementCode.DIGITAL_JKFF,
    "Counter": ElementCode.DIGITAL_COUNTER4,
    "Random Generator": ElementCode.DIGITAL_RANDOM_GENERATOR4,
    "8bit Input": ElementCode.DIGITAL_EIGHT_BIT_INPUT,
    "8bit Display": ElementCode.DIGITAL_EIGHT_BIT_DISPLAY,
    "Schmitt Trigger": ElementCode.DIGITAL_SCHMITT_TRIGGER,
    "Comparator": ElementCode.COMPARATOR,
    "Operational Amplifier": ElementCode.OP_AMP,
    "Relay Component": ElementCode.RELAY,
    "Transformer": ElementCode.TRANSFORMER,
    "Mutual Inductor": ElementCode.COUPLED_INDUCTORS,
    "Diode": ElementCode.PN_JUNCTION,
    "Transistor": ElementCode.BJT_NPN,
    "N-MOSFET": ElementCode.NMOSFET,
    "P-MOSFET": ElementCode.PMOSFET,
    "Simple Switch": ElementCode.SWITCH_SPST,
    "Square Source": ElementCode.SQUARE,
    "Sawtooth Source": ElementCode.SAWTOOTH,
    "Triangle Source": ElementCode.TRIANGLE,
    "Pulse Source": ElementCode.PULSE,
}

CODE_TO_PL: Dict[int, str] = {}
for mid, code in PL_TO_CODE.items():
    CODE_TO_PL.setdefault(int(code), mid)

# which ModelIDs are "big" elements in the PL grid (pe_to_pl.h mapping)
BIG_ELEMENTS = {"Half Adder", "Full Adder", "Half Subtractor",
                "Full Subtractor", "Multiplier", "D Flipflop",
                "T Flipflop", "Real-T Flipflop", "JK Flipflop",
                "Counter", "Random Generator", "8bit Input",
                "8bit Display"}

WIRE_COLORS = ("黑", "蓝", "红", "绿", "黄")


def _rand_identifier(n: int = 33) -> str:
    return "".join(random.choice(string.hexdigits.lower())
                   for _ in range(n))


def _default_properties(model_id: str) -> Dict[str, Any]:
    """Minimal property defaults per ModelID (physicslab.h:559-640)."""
    if model_id == "Logic Input":
        return {"高电平": 3.0, "低电平": 0.0, "锁定": 1.0, "开关": 0.0}
    if model_id == "Logic Output":
        return {"状态": 0.0, "高电平": 3.0, "低电平": 0.0, "锁定": 1.0}
    if model_id == "Resistor":
        return {"电阻": 1000.0, "锁定": 1.0}
    if model_id == "Basic Capacitor":
        return {"电容": 1e-5, "锁定": 1.0}
    if model_id == "Basic Inductor":
        return {"电感": 1e-5, "锁定": 1.0}
    if model_id == "Battery Source":
        return {"电压": 3.0, "内阻": 0.0, "锁定": 1.0}
    if model_id == "8bit Input":
        return {"高电平": 3.0, "低电平": 0.0, "十进制": 0.0, "锁定": 1.0}
    if model_id == "8bit Display":
        return {"高电平": 3.0, "低电平": 0.0, "状态": 0.0, "锁定": 1.0}
    return {"高电平": 3.0, "低电平": 0.0, "锁定": 1.0}


@dataclass
class PLElement:
    model_id: str
    identifier: str = ""
    properties: Dict[str, Any] = field(default_factory=dict)
    statistics: Dict[str, Any] = field(default_factory=dict)
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rotation: str = "0,180,0"
    is_big: bool = False

    def __post_init__(self):
        if not self.identifier:
            self.identifier = _rand_identifier()
        if not self.properties:
            self.properties = _default_properties(self.model_id)

    def to_json(self) -> Dict[str, Any]:
        x, y, z = self.position
        return {
            "ModelID": self.model_id,
            "Identifier": self.identifier,
            "Label": None,
            "IsBroken": False,
            "IsLocked": bool(self.properties.get("锁定", 0.0)),
            "Properties": self.properties,
            "Statistics": self.statistics,
            "Position": f"{x},{z},{y}",
            "Rotation": self.rotation,
            "DiagramPosition": {"X": 0, "Y": 0, "Magnitude": 0.0},
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "PLElement":
        pos = (0.0, 0.0, 0.0)
        p = d.get("Position", "")
        if isinstance(p, str) and p.count(",") == 2:
            try:
                x, z, y = (float(v) for v in p.split(","))
                pos = (x, y, z)
            except ValueError:
                pass
        return PLElement(
            model_id=d.get("ModelID", ""),
            identifier=d.get("Identifier", "") or _rand_identifier(),
            properties=dict(d.get("Properties") or {}),
            statistics=dict(d.get("Statistics") or {}),
            position=pos,
            rotation=d.get("Rotation", "0,180,0"),
        )


@dataclass
class PLWire:
    source: str
    source_pin: int
    target: str
    target_pin: int
    color: str = "蓝"

    def to_json(self) -> Dict[str, Any]:
        return {"Source": self.source, "SourcePin": self.source_pin,
                "Target": self.target, "TargetPin": self.target_pin,
                "ColorName": self.color}

    @staticmethod
    def from_json(d) -> "PLWire":
        return PLWire(d.get("Source", ""), d.get("SourcePin", 0),
                      d.get("Target", ""), d.get("TargetPin", 0),
                      d.get("ColorName", "蓝"))


class Experiment:
    """A PhysicsLab circuit scene."""

    def __init__(self, name: str = "phy_engine_tpu_torch"):
        self.name = name
        self.elements: List[PLElement] = []
        self.wires: List[PLWire] = []
        self.camera = {"Mode": 0, "Distance": 2.7,
                       "VisionCenter": "0,1.08,-0.45",
                       "TargetRotation": "50,0,0"}
        self.xyz_precision = 3

    # -- construction ---------------------------------------------------
    def add_element(self, model_id: str, position=(0.0, 0.0, 0.0),
                    properties: Optional[Dict] = None) -> PLElement:
        el = PLElement(model_id=model_id, position=position,
                       properties=properties or {})
        el.is_big = model_id in BIG_ELEMENTS
        self.elements.append(el)
        return el

    def add_wire(self, src: PLElement, src_pin: int, dst: PLElement,
                 dst_pin: int, color: str = "蓝") -> PLWire:
        w = PLWire(src.identifier, src_pin, dst.identifier, dst_pin,
                   color)
        self.wires.append(w)
        return w

    def find(self, identifier: str) -> Optional[PLElement]:
        for el in self.elements:
            if el.identifier == identifier:
                return el
        return None

    def merge(self, other: "Experiment"):
        self.elements.extend(other.elements)
        self.wires.extend(other.wires)

    # -- (de)serialization -------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        status = {
            "SimulationSpeed": 1.0,
            "Elements": [el.to_json() for el in self.elements],
            "Wires": [w.to_json() for w in self.wires],
        }
        return {
            "Type": 0,
            "Experiment": {
                "ID": None,
                "Type": 0,
                "Components": len(self.elements),
                "Subject": None,
                "StatusSave": json.dumps(status, ensure_ascii=False),
                "CameraSave": json.dumps(self.camera,
                                         ensure_ascii=False),
                "Version": 2404,
                "CreationDate": 0,
                "InternalName": self.name,
                "Visits": 0,
            },
            "ID": None,
            "Summary": {"Subject": self.name, "Language": "English"},
            "CreationDate": 0,
            "InternalName": self.name,
        }

    def dump(self) -> str:
        return json.dumps(self.to_json(), ensure_ascii=False)

    def save(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.dump())

    @staticmethod
    def load_from_json(root: Dict[str, Any]) -> "Experiment":
        ex = Experiment()
        exp = root.get("Experiment", root)
        ex.name = root.get("InternalName", exp.get("InternalName", ""))
        status = exp.get("StatusSave", "")
        if isinstance(status, str) and status:
            status = json.loads(status)
        elif not isinstance(status, dict):
            status = {}
        for ej in status.get("Elements", []):
            el = PLElement.from_json(ej)
            el.is_big = el.model_id in BIG_ELEMENTS
            ex.elements.append(el)
        for wj in status.get("Wires", []):
            ex.wires.append(PLWire.from_json(wj))
        cam = exp.get("CameraSave", "")
        if isinstance(cam, str) and cam:
            try:
                ex.camera = json.loads(cam)
            except ValueError:
                pass
        return ex

    @staticmethod
    def load(path: str) -> "Experiment":
        with open(path, encoding="utf-8") as f:
            return Experiment.load_from_json(json.load(f))


# ---------------------------------------------------------------------------
# scene -> engine (pe_sim.h:154-271,326-607)
# ---------------------------------------------------------------------------

def _element_to_code_and_props(el: PLElement):
    code = PL_TO_CODE.get(el.model_id)
    if code is None:
        raise ValueError(f"unsupported PL ModelID {el.model_id!r}")
    p = el.properties
    hi = float(p.get("高电平", 3.0))
    lo = float(p.get("低电平", 0.0))
    if code == ElementCode.RESISTOR:
        props = (float(p.get("电阻", 1000.0)),)
    elif code == ElementCode.CAPACITOR:
        props = (float(p.get("电容", 1e-5)),)
    elif code == ElementCode.INDUCTOR:
        props = (float(p.get("电感", 1e-5)),)
    elif code == ElementCode.VDC:
        props = (float(p.get("电压", 3.0)),)
    elif code == ElementCode.DIGITAL_INPUT:
        sw = float(p.get("开关", 0.0))
        props = (float(DigitalState.H) if sw != 0.0
                 else float(DigitalState.L),)
    elif code == ElementCode.DIGITAL_EIGHT_BIT_INPUT:
        props = (float(p.get("十进制", 0.0)),)
    elif code == ElementCode.COMPARATOR:
        props = (lo, hi)
    else:
        props = ()
    return int(code), props


def experiment_to_circuit(ex: Experiment, device="cuda"
                          ) -> Tuple[Circuit, List[int]]:
    """Build an api.Circuit on ``device`` from a scene.  Returns
    (circuit, element indices aligned with ex.elements)."""
    elements = []
    index_of = {}
    for i, el in enumerate(ex.elements):
        code, props = _element_to_code_and_props(el)
        index_of[el.identifier] = i
        elements.append(Element(code, props))
    wires = []
    for w in ex.wires:
        if w.source in index_of and w.target in index_of:
            wires.append(Wire(index_of[w.source], w.source_pin,
                              index_of[w.target], w.target_pin))
    return (Circuit(elements, wires, device=device),
            list(range(len(ex.elements))))


def sync_inputs(ex: Experiment, circuit: Circuit):
    """Push PL switch/input states into the engine (pe_sim.h:534)."""
    comp = 0
    for el in ex.elements:
        code = PL_TO_CODE.get(el.model_id)
        if code == ElementCode.GROUND:
            continue
        if code == ElementCode.DIGITAL_INPUT:
            sw = float(el.properties.get("开关", 0.0))
            circuit.set_model_digital(comp, DigitalState.H if sw != 0.0
                                      else DigitalState.L)
        elif code == ElementCode.DIGITAL_EIGHT_BIT_INPUT:
            circuit.set_model_double_by_name(
                comp, "value", float(el.properties.get("十进制", 0.0)))
        comp += 1


def write_back(ex: Experiment, circuit: Circuit, hi: float = 3.0,
               lo: float = 0.0, out_l: float = 0.0, out_h: float = 1.0,
               out_x: float = 0.5, out_z: float = 0.5):
    """Write solved voltages / logic states into the scene
    (pe_sim.h:568: the out_l/out_h/out_x/out_z floats are the
    write_back_options L/H/X/Z mapping of dll_api.h
    pl_pe_circuit_write_back_to_pl_ex)."""
    del hi, lo
    sample = circuit.sample()
    state_map = {0: out_l, 1: out_h, 2: out_x, 3: out_z}
    comp = 0
    for el in ex.elements:
        code = PL_TO_CODE.get(el.model_id)
        if code == ElementCode.GROUND:
            continue
        cs = sample.components[comp]
        if cs.pin_voltages:
            el.statistics["电压"] = cs.pin_voltages[0]
        if cs.branch_currents:
            el.statistics["电流"] = cs.branch_currents[0]
        if code == ElementCode.DIGITAL_OUTPUT and cs.digital_states:
            st = cs.digital_states[0]
            el.properties["状态"] = state_map.get(st, out_x)
        comp += 1


# ---------------------------------------------------------------------------
# engine -> scene (pe_to_pl.h:376-534)
# ---------------------------------------------------------------------------

@dataclass
class ExportOptions:
    include_linear: bool = True
    include_ground: bool = True
    spacing: float = 0.16
    layout: str = "fast"            # fast | quality (auto_layout.h modes)


_PE_TO_PL_ID = {
    "R": "Resistor", "C": "Basic Capacitor", "L": "Basic Inductor",
    "VDC": "Battery Source",
    "INPUT": "Logic Input", "OUTPUT": "Logic Output",
    "YES": "Yes Gate", "NOT": "No Gate", "AND": "And Gate",
    "OR": "Or Gate", "XOR": "Xor Gate", "XNOR": "Xnor Gate",
    "NAND": "Nand Gate", "NOR": "Nor Gate", "IMP": "Imp Gate",
    "NIMP": "Nimp Gate",
    "HALF_ADDER": "Half Adder", "FULL_ADDER": "Full Adder",
    "HALF_SUBTRACTOR": "Half Subtractor",
    "FULL_SUBTRACTOR": "Full Subtractor", "MUL2": "Multiplier",
    "DFF": "D Flipflop", "TFF": "T Flipflop", "TBARFF": "Real-T Flipflop",
    "JKFF": "JK Flipflop", "COUNTER4": "Counter",
    "RANDOM4": "Random Generator",
    "EIGHT_BIT_INPUT": "8bit Input", "EIGHT_BIT_DISPLAY": "8bit Display",
    "SCHMITT": "Schmitt Trigger", "CMP": "Comparator",
}

# devices whose PE pins don't map 1:1 onto the PL element's pins:
# PE pin index -> PL pin index (missing = dropped), pe_to_pl.h:99-118
_PE_TO_PL_PINMAP = {
    # DFF_ARSTN (d, clk, arst_n, q) -> D Flipflop (d, clk, q): reset
    # dropped (PL has no async-reset FF)
    "DFF_ARSTN": ("D Flipflop", {0: 0, 1: 1, 3: 2}),
}


def circuit_to_experiment(nl: Netlist,
                          options: Optional[ExportOptions] = None,
                          name: str = "export") -> Experiment:
    """Convert a PE netlist into a PL scene with per-net star wiring."""
    opt = options or ExportOptions()
    ex = Experiment(name=name)
    pe_el: Dict[int, PLElement] = {}
    pin_maps: Dict[int, Dict[int, int]] = {}
    warnings = []
    for inst in nl.live_models():
        key = inst.mdef.digital_op or inst.mdef.id_name
        if key in _PE_TO_PL_PINMAP:
            mid, pmap = _PE_TO_PL_PINMAP[key]
            pin_maps[id(inst)] = pmap
        else:
            mid = _PE_TO_PL_ID.get(key) or _PE_TO_PL_ID.get(
                inst.mdef.id_name)
        if mid is None:
            warnings.append(f"no PL mapping for {inst.mdef.id_name}")
            continue
        el = ex.add_element(mid)
        pe_el[id(inst)] = el
    # ground elements: one per ground connection point
    gnd_el = None
    if opt.include_ground and nl.ground_node.pins:
        gnd_el = ex.add_element("Ground Component")
    # wires per net: star from the first attached pin
    for node in nl.all_nodes():
        endpoints = []
        for p in node.pins:
            if id(p.model) not in pe_el:
                continue
            pmap = pin_maps.get(id(p.model))
            if pmap is not None:
                if p.index not in pmap:
                    continue            # dropped pin (e.g. arst_n)
                endpoints.append((pe_el[id(p.model)], pmap[p.index]))
            else:
                endpoints.append((pe_el[id(p.model)], p.index))
        if node.is_ground and gnd_el is not None and endpoints:
            endpoints.insert(0, (gnd_el, 0))
        for k in range(1, len(endpoints)):
            (ea, pa), (eb, pb) = endpoints[0], endpoints[k]
            ex.add_wire(ea, pa, eb, pb)
    if getattr(opt, "layout", "fast") == "quality":
        from .layout import auto_layout_quality
        auto_layout_quality(ex, spacing=opt.spacing)
    else:
        from .layout import auto_layout
        auto_layout(ex, spacing=opt.spacing)
    ex._warnings = warnings          # type: ignore[attr-defined]
    return ex
