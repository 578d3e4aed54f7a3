"""User-facing API with surface parity to the reference Python package
(the port's copy of ``phy_engine_tpu/api.py``).

Mirrors ``python/phy_engine/`` (circuit.py / builder.py / verilog.py):
element-code + wire-quad circuit construction (the C ABI's
``create_circuit[_ex]`` contract, dll_api.h:143-170), per-component
sampling with prefix layouts (dll_api.h:183-233), a NetlistBuilder, and a
standalone VerilogRuntime.  No ctypes/ABI layer is needed — the engine is
in-process — but the same programs port over by changing the import.

``Circuit(elements, wires, device="cuda", digital_backend="device")``
builds the port's core :class:`~phy_engine_tpu_torch.engine.circuit.Circuit`
on ``device`` with that digital backend; any other keyword is accepted
and ignored, as in the JAX package.  ``VerilogRuntime`` is host code.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Dict, List, Optional, Sequence, Tuple

from .netlist.netlist import Node, ModelInstance
from .netlist import operations as ops
from .engine.circuit import Circuit as CoreCircuit, AnalyzeType, \
    ACSweepType
from . import models as M


class DigitalState(IntEnum):
    L = 0
    H = 1
    X = 2
    Z = 3


class ElementCode(IntEnum):
    GROUND = 0
    RESISTOR = 1
    CAPACITOR = 2
    INDUCTOR = 3
    VDC = 4
    VAC = 5
    IDC = 6
    IAC = 7
    VCCS = 8
    VCVS = 9
    CCCS = 10
    CCVS = 11
    SWITCH_SPST = 12
    PN_JUNCTION = 13
    TRANSFORMER = 14
    COUPLED_INDUCTORS = 15
    TRANSFORMER_CENTER_TAP = 16
    OP_AMP = 17
    RELAY = 18
    COMPARATOR = 19
    SAWTOOTH = 20
    SQUARE = 21
    PULSE = 22
    TRIANGLE = 23
    BJT_NPN = 50
    BJT_PNP = 51
    NMOSFET = 52
    PMOSFET = 53
    FULL_BRIDGE_RECTIFIER = 54
    BSIM3V32_NMOS = 55
    BSIM3V32_PMOS = 56
    DIGITAL_INPUT = 200
    DIGITAL_OUTPUT = 201
    DIGITAL_OR = 202
    DIGITAL_YES = 203
    DIGITAL_AND = 204
    DIGITAL_NOT = 205
    DIGITAL_XOR = 206
    DIGITAL_XNOR = 207
    DIGITAL_NAND = 208
    DIGITAL_NOR = 209
    DIGITAL_TRI = 210
    DIGITAL_IMP = 211
    DIGITAL_NIMP = 212
    DIGITAL_HALF_ADDER = 220
    DIGITAL_FULL_ADDER = 221
    DIGITAL_HALF_SUBTRACTOR = 222
    DIGITAL_FULL_SUBTRACTOR = 223
    DIGITAL_MUL2 = 224
    DIGITAL_DFF = 225
    DIGITAL_TFF = 226
    DIGITAL_T_BAR_FF = 227
    DIGITAL_JKFF = 228
    DIGITAL_COUNTER4 = 229
    DIGITAL_RANDOM_GENERATOR4 = 230
    DIGITAL_EIGHT_BIT_INPUT = 231
    DIGITAL_EIGHT_BIT_DISPLAY = 232
    DIGITAL_SCHMITT_TRIGGER = 233
    VERILOG_MODULE = 300
    VERILOG_NETLIST = 301


# (ModelDef, positional property names) per element code
_CODE_TABLE: Dict[int, Tuple] = {
    ElementCode.RESISTOR: (M.RESISTANCE, ("r",)),
    ElementCode.CAPACITOR: (M.CAPACITOR, ("C",)),
    ElementCode.INDUCTOR: (M.INDUCTOR, ("L",)),
    ElementCode.VDC: (M.VDC, ("V",)),
    ElementCode.VAC: (M.VAC, ("Vp", "freq", "phase")),
    ElementCode.IDC: (M.IDC, ("I",)),
    ElementCode.IAC: (M.IAC, ("Ip", "freq", "phase")),
    ElementCode.VCCS: (M.VCCS, ("g",)),
    ElementCode.VCVS: (M.VCVS, ("mu",)),
    ElementCode.CCCS: (M.CCCS, ("alpha",)),
    ElementCode.CCVS: (M.CCVS, ("r",)),
    ElementCode.SWITCH_SPST: (M.SWITCH, ("cut_through",)),
    ElementCode.PN_JUNCTION: (M.PN_JUNCTION,
                              ("Is", "N", "Isr", "Nr", "Temp", "Ibv",
                               "Bv", "Area", "tt")),
    ElementCode.TRANSFORMER: (M.TRANSFORMER, ("n",)),
    ElementCode.COUPLED_INDUCTORS: (M.COUPLED_INDUCTORS,
                                    ("L1", "L2", "k")),
    ElementCode.TRANSFORMER_CENTER_TAP: (M.TRANSFORMER_CENTER_TAP,
                                         ("n_half",)),
    ElementCode.OP_AMP: (M.OP_AMP, ("mu",)),
    ElementCode.RELAY: (M.RELAY, ("Von", "Voff")),
    ElementCode.COMPARATOR: (M.COMPARATOR, ("Ll", "Hl")),
    ElementCode.SAWTOOTH: (M.SAWTOOTH, ("Vh", "Vl", "freq", "phase")),
    ElementCode.SQUARE: (M.SQUARE, ("Vh", "Vl", "freq", "duty", "phase")),
    ElementCode.PULSE: (M.PULSE, ("Vh", "Vl", "freq", "duty", "phase",
                                  "tr", "tf")),
    ElementCode.TRIANGLE: (M.TRIANGLE, ("Vh", "Vl", "freq", "phase")),
    ElementCode.BJT_NPN: (M.BJT_NPN, ("Is", "N", "BetaF", "Temp", "Area")),
    ElementCode.BJT_PNP: (M.BJT_PNP, ("Is", "N", "BetaF", "Temp", "Area")),
    ElementCode.NMOSFET: (M.NMOSFET, ("Kp", "lambda", "Vth")),
    ElementCode.PMOSFET: (M.PMOSFET, ("Kp", "lambda", "Vth")),
    ElementCode.FULL_BRIDGE_RECTIFIER: (M.FULL_BRIDGE_RECTIFIER, ()),
    ElementCode.BSIM3V32_NMOS: (M.BSIM3V32_NMOS,
                                ("W", "L", "Kp", "lambda", "Vth0",
                                 "gamma", "phi", "Cgs", "Cgd", "Cgb",
                                 "diode_Is", "diode_N", "Temp")),
    ElementCode.BSIM3V32_PMOS: (M.BSIM3V32_PMOS,
                                ("W", "L", "Kp", "lambda", "Vth0",
                                 "gamma", "phi", "Cgs", "Cgd", "Cgb",
                                 "diode_Is", "diode_N", "Temp")),
    ElementCode.DIGITAL_INPUT: (M.INPUT, ("boolean",)),
    ElementCode.DIGITAL_OUTPUT: (M.OUTPUT, ()),
    ElementCode.DIGITAL_OR: (M.OR, ()),
    ElementCode.DIGITAL_YES: (M.YES, ()),
    ElementCode.DIGITAL_AND: (M.AND, ()),
    ElementCode.DIGITAL_NOT: (M.NOT, ()),
    ElementCode.DIGITAL_XOR: (M.XOR, ()),
    ElementCode.DIGITAL_XNOR: (M.XNOR, ()),
    ElementCode.DIGITAL_NAND: (M.NAND, ()),
    ElementCode.DIGITAL_NOR: (M.NOR, ()),
    ElementCode.DIGITAL_TRI: (M.TRI_STATE, ()),
    ElementCode.DIGITAL_IMP: (M.IMP, ()),
    ElementCode.DIGITAL_NIMP: (M.NIMP, ()),
    ElementCode.DIGITAL_HALF_ADDER: (M.HALF_ADDER, ()),
    ElementCode.DIGITAL_FULL_ADDER: (M.FULL_ADDER, ()),
    ElementCode.DIGITAL_HALF_SUBTRACTOR: (M.HALF_SUBTRACTOR, ()),
    ElementCode.DIGITAL_FULL_SUBTRACTOR: (M.FULL_SUBTRACTOR, ()),
    ElementCode.DIGITAL_MUL2: (M.MUL2, ()),
    ElementCode.DIGITAL_DFF: (M.D_FF, ()),
    ElementCode.DIGITAL_TFF: (M.T_FF, ()),
    ElementCode.DIGITAL_T_BAR_FF: (M.T_BAR_FF, ()),
    ElementCode.DIGITAL_JKFF: (M.JK_FF, ()),
    ElementCode.DIGITAL_COUNTER4: (M.COUNTER4, ()),
    ElementCode.DIGITAL_RANDOM_GENERATOR4: (M.RANDOM_GENERATOR4,
                                            ("seed",)),
    ElementCode.DIGITAL_EIGHT_BIT_INPUT: (M.EIGHT_BIT_INPUT, ("value",)),
    ElementCode.DIGITAL_EIGHT_BIT_DISPLAY: (M.EIGHT_BIT_DISPLAY, ()),
    ElementCode.DIGITAL_SCHMITT_TRIGGER: (
        M.SCHMITT_TRIGGER, ("inverted", "Vth_low", "Vth_high", "Ll",
                            "Hl")),
}

PROPERTY_ARITY: Dict[int, int] = {
    int(code): len(props) for code, (mdef, props) in _CODE_TABLE.items()}
PROPERTY_ARITY[int(ElementCode.GROUND)] = 0
PROPERTY_ARITY[int(ElementCode.VERILOG_MODULE)] = 0
PROPERTY_ARITY[int(ElementCode.VERILOG_NETLIST)] = 0
PROPERTY_ARITY[int(ElementCode.DIGITAL_COUNTER4)] = 1
PROPERTY_ARITY[int(ElementCode.DIGITAL_EIGHT_BIT_DISPLAY)] = 0


@dataclass(frozen=True)
class Wire:
    element_a: int
    pin_a: int
    element_b: int
    pin_b: int


@dataclass
class Element:
    code: int
    properties: Tuple[float, ...] = ()
    verilog_source: Optional[str] = None
    verilog_top: Optional[str] = None

    def normalized_code(self) -> int:
        return int(self.code)


@dataclass
class ComponentSample:
    code: int
    pin_voltages: List[float]
    branch_currents: List[float]
    digital_states: List[int]


@dataclass
class CircuitSample:
    components: List[ComponentSample]


class PhyEngineError(Exception):
    pass


def _as_element(spec) -> Element:
    if isinstance(spec, Element):
        return spec
    return Element(code=int(spec))


class Circuit:
    """Element-code circuit (python/phy_engine/circuit.py:244-483)."""

    def __init__(self, elements: Sequence, wires: Sequence[Wire] = (),
                 device="cuda", digital_backend: str = "device",
                 **_ignored):
        self._elements = [_as_element(e) for e in elements]
        self._core = CoreCircuit(device=device,
                                 digital_backend=digital_backend)
        nl = self._core.nl
        self._insts: List[Optional[ModelInstance]] = []
        self._pin_lists: List[List] = []

        for el in self._elements:
            code = el.normalized_code()
            if code == ElementCode.GROUND:
                self._insts.append(None)
                self._pin_lists.append([nl.ground_node])
                continue
            if code in (ElementCode.VERILOG_MODULE,
                        ElementCode.VERILOG_NETLIST):
                if not el.verilog_source:
                    raise PhyEngineError("verilog element needs source")
                if code == ElementCode.VERILOG_MODULE:
                    inst = M.make_verilog_module(
                        el.verilog_source, top=el.verilog_top)
                    ops.add_model(nl, inst)
                    self._insts.append(inst)
                    self._pin_lists.append(list(inst.pins))
                else:
                    inst, pins = self._build_verilog_netlist(el)
                    self._insts.append(inst)
                    self._pin_lists.append(pins)
                continue
            if code not in _CODE_TABLE:
                raise PhyEngineError(f"unsupported element code {code}")
            mdef, props = _CODE_TABLE[code]
            params = {}
            for name, val in zip(props, el.properties):
                params[name] = float(val)
            inst = ops.add_model(nl, mdef, params)
            self._insts.append(inst)
            self._pin_lists.append(list(inst.pins))

        for w in wires:
            self._connect(w)
        # Component indices span every non-ground element (matching the
        # sample layouts): VERILOG_NETLIST elements have no ModelInstance
        # but still occupy a component slot with their port pins
        # (dll_api.h treats code 301 as an ordinary element).
        self._live = [ei for ei, inst in enumerate(self._insts)
                      if inst is not None or
                      self._elements[ei].normalized_code() !=
                      ElementCode.GROUND]
        self.component_count = len(self._live)

    def _build_verilog_netlist(self, el: Element):
        """code 301: synthesize to primitive gates; top ports become the
        element's pins (1-bit ports)."""
        from .verilog import (compile_source, build_design, elaborate,
                              find_module)
        from .verilog.synth import synthesize_to_netlist, SynthOptions
        nl = self._core.nl
        mods = compile_source(el.verilog_source)
        design = build_design(mods)
        topm = find_module(design, el.verilog_top) if el.verilog_top \
            else mods[-1]
        inst_state = elaborate(design, topm)
        port_nets = {}
        pin_nodes = []
        for pname in topm.ports:
            sig = inst_state.signals[pname]
            nets = [ops.create_node(nl) for _ in range(sig.width)]
            port_nets[pname] = nets
            pin_nodes.append(nets[0])      # LSB is the exposed pin
        g = _SYNTH_CONFIG
        so = SynthOptions(
            opt_level=g.opt_level,
            assume_binary_inputs=g.assume_binary_inputs,
            allow_inout=g.allow_inout,
            allow_multi_driver=g.allow_multi_driver,
            optimize_wires=g.optimize_wires,
            optimize_mul2=g.optimize_mul2,
            optimize_adders=g.optimize_adders,
            loop_unroll_limit=g.loop_unroll_limit)
        synthesize_to_netlist(nl, design, inst_state, port_nets, so)
        return None, [_FakePin(n) for n in pin_nodes]

    def _pin_node(self, ei: int, pi: int):
        pins = self._pin_lists[ei]
        if pi >= len(pins):
            raise PhyEngineError(
                f"element {ei} has no pin {pi}")
        p = pins[pi]
        if isinstance(p, Node):
            return None, p
        if isinstance(p, _FakePin):
            return None, p.node
        return p, p.node

    def _connect(self, w: Wire):
        nl = self._core.nl
        pa, na = self._pin_node(w.element_a, w.pin_a)
        pb, nb = self._pin_node(w.element_b, w.pin_b)

        def attach(pin, node):
            if pin is None:
                return node
            ops.add_to_node(nl, pin.model, pin.index, node)
            return pin.node

        if na is not None and nb is not None:
            ops.merge_node(nl, na, nb)
        elif na is not None:
            attach(pb, na)
        elif nb is not None:
            attach(pa, nb)
        else:
            node = ops.create_node(nl)
            attach(pa, node)
            attach(pb, node)

    # -- settings -----------------------------------------------------------
    def set_analyze_type(self, at) -> None:
        if isinstance(at, AnalyzeType):
            self._core.set_analyze_type(at)
        else:
            self._core.set_analyze_type(AnalyzeType(int(at)))

    def set_tr(self, t_step: float, t_stop: float) -> None:
        self._core.tr.t_step = t_step
        self._core.tr.t_stop = t_stop

    def set_ac_omega(self, omega: float) -> None:
        self._core.ac.sweep = ACSweepType.SINGLE
        self._core.ac.omega = omega

    def set_temperature(self, temp_c: float) -> None:
        self._core.env.temperature = temp_c

    def set_tnom(self, tnom_c: float) -> None:
        self._core.env.norm_temperature = tnom_c

    def set_model_double_by_name(self, component_index: int, name: str,
                                 value: float) -> None:
        inst = self._component(component_index)
        if not inst.set_attribute(name, float(value)):
            raise PhyEngineError(f"no attribute {name!r}")

    def set_model_digital(self, component_index: int, value) -> None:
        inst = self._component(component_index)
        if isinstance(value, bool):
            value = DigitalState.H if value else DigitalState.L
        inst.set_attribute("boolean", float(int(value)))

    def set_model_double(self, component_index: int, attr_index: int,
                         value: float) -> None:
        """Set an attribute by positional index (the reference's
        set_property(model, attribute_index, value) used by
        analyze_circuit, dll_main.cpp:2923-2924)."""
        inst = self._component(component_index)
        if not inst.set_attribute(int(attr_index), float(value)):
            raise PhyEngineError(f"no attribute index {attr_index}")

    def _component(self, index: int) -> ModelInstance:
        if not (0 <= index < len(self._live)):
            raise PhyEngineError(f"bad component index {index}")
        inst = self._insts[self._live[index]]
        if inst is None:
            raise PhyEngineError(
                f"component {index} has no settable model")
        return inst

    # -- analysis -----------------------------------------------------------
    def analyze(self) -> None:
        if not self._core.analyze():
            raise PhyEngineError("analyze failed (no convergence)")

    def digital_clk(self) -> None:
        self._core.digital_clk()

    # -- sampling (dll_api.h:183-233 layout) ---------------------------------
    def sample_layout(self):
        pin_counts, branch_counts, dig_counts = [], [], []
        for ei, inst in enumerate(self._insts):
            if inst is None and self._elements[ei].normalized_code() == \
                    ElementCode.GROUND:
                continue
            pins = self._pin_lists[ei]
            pin_counts.append(len(pins))
            branch_counts.append(len(inst.branches) if inst else 0)
            dig_counts.append(len(pins))
        return pin_counts, branch_counts, dig_counts

    def sample(self) -> CircuitSample:
        comps = []
        for ei, inst in enumerate(self._insts):
            code = self._elements[ei].normalized_code()
            if code == ElementCode.GROUND and inst is None and \
                    len(self._pin_lists[ei]) == 1 and \
                    isinstance(self._pin_lists[ei][0], Node):
                continue
            volts, digs = [], []
            for p in self._pin_lists[ei]:
                node = p if isinstance(p, Node) else \
                    (p.node if p.node is not None else None)
                if node is None:
                    volts.append(0.0)
                    digs.append(int(DigitalState.X))
                else:
                    volts.append(self._core.node_voltage(node).real
                                 if not node.is_ground else 0.0)
                    digs.append(int(node.digital))
            currents = [br.current.real for br in
                        (inst.branches if inst else [])]
            comps.append(ComponentSample(code=code, pin_voltages=volts,
                                         branch_currents=currents,
                                         digital_states=digs))
        return CircuitSample(components=comps)

    def analyze_and_sample(self) -> CircuitSample:
        self.analyze()
        return self.sample()

    def noise(self, out_element: int, out_pin: int = 0,
              src_element: Optional[int] = None):
        """Output noise sweep at element ``out_element``'s pin
        ``out_pin`` over the configured AC grid (engine extension —
        the reference has no noise analysis; its bsim3v32.h:28-29 TODO
        asks for the infrastructure).  ``src_element``: optional
        V-source element for the input-referred PSD.  Returns
        ``engine.noise.NoiseResult``."""
        _p, node = self._pin_node(out_element, out_pin)
        if node is None or node.is_ground:
            raise PhyEngineError("noise output pin is unconnected/ground")
        src = None
        if src_element is not None:
            src = self._insts[src_element]
            if src is None:
                raise PhyEngineError("noise src is not a device")
        res = self._core.noise(node, src=src)
        if res is None:
            raise PhyEngineError("noise bias point failed to converge")
        return res

    def sens(self, out_element: int, out_pin: int = 0):
        """DC sensitivity (.SENS class, engine extension — the
        reference has none): d V(out)/d(param) for every parameter of
        every device, via one reverse-mode adjoint sweep
        (engine/sens.py).  Returns ``engine.sens.SensResult``."""
        _p, node = self._pin_node(out_element, out_pin)
        if node is None or node.is_ground:
            raise PhyEngineError("sens output pin is unconnected/ground")
        res = self._core.sens(node)
        if res is None:
            raise PhyEngineError("sens bias point failed to converge")
        return res

    def sens_ac(self, out_element: int, out_pin: int = 0):
        """AC magnitude sensitivity over the configured AC grid
        (engine extension).  Returns ``(freqs, mag, SensResult)``."""
        _p, node = self._pin_node(out_element, out_pin)
        if node is None or node.is_ground:
            raise PhyEngineError("sens output pin is unconnected/ground")
        res = self._core.sens_ac(node)
        if res is None:
            raise PhyEngineError("sens bias point failed to converge")
        return res

    def dc_sweep(self, element: int, prop_name: str, values,
                 out_element: Optional[int] = None, out_pin: int = 0):
        """Stepped .DC over one element property (engine extension) —
        the whole grid solves as one batched device program.  Returns
        ``engine.circuit.SweepResult``."""
        inst = self._insts[element]
        if inst is None:
            raise PhyEngineError("swept element is not a device")
        out = None
        if out_element is not None:
            _p, out = self._pin_node(out_element, out_pin)
        return self._core.dc_sweep(inst, prop_name, values, out=out)

    def temp_sweep(self, temps, out_element: Optional[int] = None,
                   out_pin: int = 0):
        """Global temperature sweep (engine extension)."""
        out = None
        if out_element is not None:
            _p, out = self._pin_node(out_element, out_pin)
        return self._core.temp_sweep(temps, out=out)

    def monte_carlo(self, jitter, n: int, **kw):
        """Monte-Carlo over parameter jitter (engine extension);
        see ``engine.circuit.Circuit.monte_carlo``."""
        return self._core.monte_carlo(jitter, n, **kw)

    def four(self, fundamental: float, out_element: int,
             out_pin: int = 0, harmonics: int = 9):
        """Fourier/THD analysis of the last transient (.FOUR class,
        engine extension).  Returns ``engine.circuit.FourierResult``."""
        _p, node = self._pin_node(out_element, out_pin)
        if node is None or node.is_ground:
            raise PhyEngineError("four output pin is unconnected/ground")
        return self._core.four(fundamental, node, harmonics=harmonics)

    # context manager parity
    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    @property
    def core(self) -> CoreCircuit:
        return self._core


class _FakePin:
    __slots__ = ("node",)

    def __init__(self, node):
        self.node = node


# ---------------------------------------------------------------------------
# NetlistBuilder (python/phy_engine/builder.py:30-224)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BuilderPinRef:
    element: int
    pin: int


@dataclass(frozen=True)
class BuilderElementRef:
    index: int
    name: Optional[str] = None

    def pin(self, pin_index: int) -> BuilderPinRef:
        return BuilderPinRef(self.index, pin_index)


@dataclass(frozen=True)
class BuilderNodeRef:
    index: int
    name: Optional[str] = None


class NetlistBuilder:
    def __init__(self):
        self._elements: List[Element] = []
        self._names: Dict[str, int] = {}
        self._nodes: List[List[Tuple[int, int]]] = []
        self._node_names: Dict[str, int] = {}
        self._deleted: set = set()

    def add_element(self, code, properties=(), name: Optional[str] = None,
                    verilog_source=None, verilog_top=None
                    ) -> BuilderElementRef:
        idx = len(self._elements)
        self._elements.append(Element(
            code=int(code), properties=tuple(properties),
            verilog_source=verilog_source, verilog_top=verilog_top))
        if name:
            if name in self._names:
                raise PhyEngineError(f"duplicate element name {name!r}")
            self._names[name] = idx
        return BuilderElementRef(idx, name)

    def create_node(self, name: Optional[str] = None) -> BuilderNodeRef:
        idx = len(self._nodes)
        self._nodes.append([])
        if name:
            self._node_names[name] = idx
        return BuilderNodeRef(idx, name)

    def add_to_node(self, element, pin_index: int, node) -> None:
        ei = self._resolve_element(element)
        ni = self._resolve_node(node)
        self._nodes[ni].append((ei, pin_index))

    def connect(self, a, b, node_name: Optional[str] = None
                ) -> BuilderNodeRef:
        pa = a if isinstance(a, BuilderPinRef) else None
        pb = b if isinstance(b, BuilderPinRef) else None
        node = self.create_node(node_name)
        if pa:
            self._nodes[node.index].append((pa.element, pa.pin))
        if pb:
            self._nodes[node.index].append((pb.element, pb.pin))
        return node

    def connect_pins(self, pin_a: BuilderPinRef,
                     pin_b: BuilderPinRef) -> BuilderNodeRef:
        return self.connect(pin_a, pin_b)

    def merge_nodes(self, dst, src) -> BuilderNodeRef:
        di = self._resolve_node(dst)
        si = self._resolve_node(src)
        self._nodes[di].extend(self._nodes[si])
        self._nodes[si] = []
        return BuilderNodeRef(di)

    def delete_model(self, element) -> None:
        self._deleted.add(self._resolve_element(element))

    def build(self, **kwargs) -> Circuit:
        keep = [i for i in range(len(self._elements))
                if i not in self._deleted]
        remap = {old: new for new, old in enumerate(keep)}
        elements = [self._elements[i] for i in keep]
        wires: List[Wire] = []
        for endpoints in self._nodes:
            pts = [(remap[ei], pi) for ei, pi in endpoints
                   if ei in remap]
            for k in range(1, len(pts)):
                wires.append(Wire(pts[0][0], pts[0][1],
                                  pts[k][0], pts[k][1]))
        return Circuit(elements, wires, **kwargs)

    def iter_elements(self):
        for i in range(len(self._elements)):
            if i not in self._deleted:
                yield BuilderElementRef(i)

    def iter_nodes(self):
        for i in range(len(self._nodes)):
            yield BuilderNodeRef(i)

    def _resolve_element(self, element) -> int:
        if isinstance(element, BuilderElementRef):
            return element.index
        if isinstance(element, str):
            if element not in self._names:
                raise PhyEngineError(f"no element named {element!r}")
            return self._names[element]
        return int(element)

    def _resolve_node(self, node) -> int:
        if isinstance(node, BuilderNodeRef):
            return node.index
        if isinstance(node, str):
            if node not in self._node_names:
                raise PhyEngineError(f"no node named {node!r}")
            return self._node_names[node]
        return int(node)


# ---------------------------------------------------------------------------
# VerilogRuntime (python/phy_engine/verilog.py:91-263)
# ---------------------------------------------------------------------------

class VerilogPortDir(IntEnum):
    INPUT = 0
    OUTPUT = 1
    INOUT = 2
    UNKNOWN = 3


@dataclass
class VerilogPort:
    name: str
    direction: VerilogPortDir
    width: int


class VerilogRuntime:
    """Standalone behavioral runtime (tick/step/port access by name)."""

    def __init__(self, source: str, top: Optional[str] = None,
                 include_resolver=None, **_ignored):
        from .verilog import (compile_source, build_design, elaborate,
                              find_module, settle, Runtime)
        from .verilog.preprocess import PreprocessOptions
        opts = PreprocessOptions(include_resolver=include_resolver) \
            if include_resolver else None
        from .verilog.preprocess import preprocess
        self.preprocessed = preprocess(source, opts)
        mods = compile_source(source, opts)
        self._design = build_design(mods)
        self._top = find_module(self._design, top) if top else mods[-1]
        self._inst = elaborate(self._design, self._top)
        self._rt = Runtime(self._inst)
        settle(self._rt, 0)
        self._tick = 0

    @classmethod
    def from_file(cls, path: str, top: Optional[str] = None, **kw):
        with open(path) as f:
            return cls(f.read(), top=top, **kw)

    @property
    def top_module_name(self) -> str:
        return self._top.name

    def ports(self) -> List[VerilogPort]:
        out = []
        for pname in self._top.ports:
            sig = self._inst.signals[pname]
            d = {"input": VerilogPortDir.INPUT,
                 "output": VerilogPortDir.OUTPUT,
                 "inout": VerilogPortDir.INOUT}.get(
                     sig.decl.direction, VerilogPortDir.UNKNOWN)
            out.append(VerilogPort(pname, d, sig.width))
        return out

    def signals(self) -> List[str]:
        return list(self._inst.signals)

    def modules(self) -> List[str]:
        """Compiled module names (verilog_runtime_module_count/
        copy_module_name, dll_api.h:290-301)."""
        return list(self._design.modules)

    def get_tick(self) -> int:
        return self._tick

    def step_at(self, tick: int, process_sequential: bool = True) -> None:
        """Simulate at an explicit tick value (verilog_runtime_step)."""
        from .verilog import simulate
        self._tick = int(tick)
        simulate(self._rt, self._tick, process_sequential)

    def tick(self) -> int:
        from .verilog import simulate
        self._tick += 1
        simulate(self._rt, self._tick)
        return self._tick

    def step(self, n: int = 1) -> int:
        for _ in range(n):
            self.tick()
        return self._tick

    def reset(self) -> None:
        from .verilog import settle, Runtime
        self._rt = Runtime(self._inst)
        settle(self._rt, 0)
        self._tick = 0

    def set_value(self, name: str, value: int) -> None:
        from .verilog.fourstate import Val
        cur = self._rt.values[name]
        self._rt.values[name] = Val.from_int(int(value), cur.width)

    def set_state(self, name: str, code: int) -> None:
        """Set a 1-bit signal to a 4-state code."""
        from .verilog.fourstate import Val
        cur = self._rt.values[name]
        v = code & 1
        u = (code >> 1) & 1
        m = (1 << cur.width) - 1
        self._rt.values[name] = Val(m if v else 0, m if u else 0,
                                    cur.width)

    def get_value(self, name: str) -> int:
        return self._rt.values[name].to_int()

    def get_state(self, name: str) -> int:
        return self._rt.values[name].bit(0)

    def is_known(self, name: str) -> bool:
        return self._rt.values[name].known

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ---------------------------------------------------------------------------
# global Verilog synth config (verilog_synth_set_* parity)
# ---------------------------------------------------------------------------

@dataclass
class VerilogSynthConfig:
    """Process-global defaults consumed by code-301 (VERILOG_NETLIST)
    element builds — dll_main.cpp's g_verilog_synth_* snapshot
    (dll_api.h:253-268).  Defaults mirror the reference's dll surface:
    opt_level 0, every policy flag permissive, loop unroll 64."""
    opt_level: int = 0
    assume_binary_inputs: bool = False
    allow_inout: bool = True
    allow_multi_driver: bool = True
    optimize_wires: bool = True
    optimize_mul2: bool = True
    optimize_adders: bool = True
    loop_unroll_limit: int = 64


_SYNTH_CONFIG = VerilogSynthConfig()

_SYNTH_FIELDS = ("opt_level", "assume_binary_inputs", "allow_inout",
                 "allow_multi_driver", "optimize_wires",
                 "optimize_mul2", "optimize_adders",
                 "loop_unroll_limit")


def get_verilog_synth_config(**_kw) -> VerilogSynthConfig:
    return VerilogSynthConfig(
        **{f: getattr(_SYNTH_CONFIG, f) for f in _SYNTH_FIELDS})


def set_verilog_synth_config(**kw) -> None:
    for f in _SYNTH_FIELDS:
        if kw.get(f) is not None:
            setattr(_SYNTH_CONFIG, f, kw[f])
