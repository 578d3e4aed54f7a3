"""Plain-argument glue for the embeddable C ABI (native/pe_capi.c; the
port's copy of ``phy_engine_tpu/capi.py``).

Role parity: the reference ships ``dll_api.h`` + ``dll_main.cpp`` — a
C surface over the engine for embedders (PhysicsLab, wasm hosts).
Here the engine is Python/PyTorch, so the C shim embeds CPython and calls
THIS module; every function takes/returns only ints, floats, strings
and flat lists so the C marshaling stays trivial.

Covered subset (dll_api.h:143-316): create_circuit / create_circuit_ex
(element codes + wire quads + positional property stream),
analyze-type/TR/AC control, analyze, digital_clk, set_model_digital,
sample layouts + samples (4-state u8), and the verilog_runtime_*
family.

Circuits and scenes built here run on ``DEVICE`` ("cuda"; a host
program that shares the library's interpreter, a test for one, may set
``capi.DEVICE = "cpu"`` before it builds).  Embedders call the library
per tick from a game loop (dll_api.h:238-252), so ``digital_clk`` runs on
the host sweep engine (``digital_backend="native"``) wherever that engine
computes the design, as the JAX glue's ``PE_TPU_DIGITAL=native`` does,
and on the device's levelled tick elsewhere.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from . import api

DEVICE = "cuda"


def _native_where_eligible(c: "api.Circuit") -> "api.Circuit":
    """Clock ``c``'s digital part on the host sweep engine when that
    engine computes it (pure gates and flip-flops, no analog coupling,
    no VERILOG_MODULE); leave every other circuit on the device."""
    core = c.core
    try:
        eng = core.digital_engine()
    except ValueError:                   # no digital devices
        return c
    if eng.native_blocker(for_tick=True) is None:
        core.digital_backend = eng.backend = "native"
    return c


def last_api_version() -> int:
    return 1


def props_needed(codes: Sequence[int]) -> int:
    """Exact positional property count for an element stream."""
    n = 0
    for code in codes:
        n += api.PROPERTY_ARITY.get(int(code), 0)
    return n


def _consume_properties(codes: Sequence[int], props: Sequence[float],
                        texts: Optional[Sequence[str]] = None,
                        src_idx: Optional[Sequence[int]] = None,
                        top_idx: Optional[Sequence[int]] = None):
    elements = []
    p = 0
    for k, code in enumerate(codes):
        code = int(code)
        if code == 0:
            elements.append(api.Element(api.ElementCode.GROUND))
            continue
        if code in (int(api.ElementCode.VERILOG_MODULE),
                    int(api.ElementCode.VERILOG_NETLIST)):
            if texts is None or src_idx is None:
                raise api.PhyEngineError(
                    "verilog elements need create_circuit_ex")
            src = texts[src_idx[k]]
            top = texts[top_idx[k]] if top_idx is not None and \
                0 <= top_idx[k] < len(texts) else None
            elements.append(api.Element(code, (), verilog_source=src,
                                        verilog_top=top or None))
            continue
        spec = api._CODE_TABLE.get(code)
        if spec is None:
            raise api.PhyEngineError(f"unsupported element code {code}")
        n = len(spec[1])
        elements.append(api.Element(code, tuple(props[p:p + n])))
        p += n
    return elements


def create_circuit(codes: Sequence[int], wires_flat: Sequence[int],
                   props: Sequence[float]):
    """elements + (ele1,pin1,ele2,pin2)* + positional properties ->
    api.Circuit handle."""
    elements = _consume_properties(codes, props)
    wires = [api.Wire(*wires_flat[i:i + 4])
             for i in range(0, len(wires_flat), 4)]
    return _native_where_eligible(api.Circuit(elements, wires,
                                              device=DEVICE))


def create_circuit_ex(codes, wires_flat, props, texts, src_idx,
                      top_idx):
    elements = _consume_properties(codes, props, texts, src_idx,
                                   top_idx)
    wires = [api.Wire(*wires_flat[i:i + 4])
             for i in range(0, len(wires_flat), 4)]
    return _native_where_eligible(api.Circuit(elements, wires,
                                              device=DEVICE))


def circuit_component_count(c) -> int:
    return c.component_count


def circuit_set_analyze_type(c, at: int) -> int:
    c.set_analyze_type(at)
    return 0


def circuit_set_tr(c, t_step: float, t_stop: float) -> int:
    c.set_tr(t_step, t_stop)
    return 0


def circuit_set_ac_omega(c, omega: float) -> int:
    c.set_ac_omega(omega)
    return 0


def circuit_set_temperature(c, t: float) -> int:
    c.set_temperature(t)
    return 0


def circuit_set_tnom(c, t: float) -> int:
    c.set_tnom(t)
    return 0


def circuit_set_model_double_by_name(c, comp: int, name: str,
                                     value: float) -> int:
    c.set_model_double_by_name(comp, name, value)
    return 0


def circuit_set_model_digital(c, comp: int, state: int) -> int:
    c.set_model_digital(comp, state)
    return 0


def circuit_analyze(c) -> int:
    c.analyze()
    return 0


def circuit_digital_clk(c) -> int:
    c.digital_clk()
    return 0


def circuit_sample_layout(c) -> List[List[int]]:
    """[voltage_ord, current_ord, digital_ord] prefix sums,
    each of length comp_size + 1 (dll_api.h:182-192)."""
    def prefix(counts):
        out = [0]
        for n in counts:
            out.append(out[-1] + int(n))
        return out

    v_cnt, c_cnt, d_cnt = c.sample_layout()
    return [prefix(v_cnt), prefix(c_cnt), prefix(d_cnt)]


def circuit_sample_u8(c) -> List[list]:
    """[voltages, currents, digital_codes] flattened in component
    order; digital codes are 4-state 0..3 (circuit_sample_digital_
    state_u8 semantics — the 0/1-only variant clamps in C)."""
    s = c.sample()
    volts: List[float] = []
    curs: List[float] = []
    digs: List[int] = []
    for comp in s.components:
        volts.extend(float(v) for v in comp.pin_voltages)
        curs.extend(float(x) for x in comp.branch_currents)
        digs.extend(int(d) for d in comp.digital_states)
    return [volts, curs, digs]


def analyze_circuit(c, changed_ele: Sequence[int],
                    changed_ind: Sequence[int],
                    changed_prop: Sequence[float]) -> List[list]:
    """Property updates + analyze + sample in one call
    (dll_api.h:237-252): changed_ele[i] is a component index,
    changed_ind[i] an attribute index, changed_prop[i] the new value."""
    for e, i, p in zip(changed_ele, changed_ind, changed_prop):
        c.set_model_double(int(e), int(i), float(p))
    c.analyze()
    return circuit_sample_u8(c)


# -- global verilog synth defaults (dll_api.h:253-268) ------------------------

def verilog_synth_set(name: str, value: int) -> int:
    api.set_verilog_synth_config(**{name: int(value)})
    return 0


def verilog_synth_get(name: str) -> int:
    return int(getattr(api.get_verilog_synth_config(), name))


# -- verilog runtime ---------------------------------------------------------

def verilog_runtime_create(src: str, top: str):
    return api.VerilogRuntime(src, top=top or None)


def verilog_runtime_tick(rt) -> int:
    return rt.tick()


def verilog_runtime_reset(rt) -> int:
    rt.reset()
    return 0


def verilog_runtime_port_count(rt) -> int:
    return len(rt.ports())


def verilog_runtime_port_name(rt, i: int) -> str:
    return rt.ports()[i].name


def verilog_runtime_port_dir(rt, i: int) -> int:
    # dll_api.h port_dir: 0=unknown 1=input 2=output 3=inout
    d = rt.ports()[i].direction
    return {api.VerilogPortDir.INPUT: 1,
            api.VerilogPortDir.OUTPUT: 2,
            api.VerilogPortDir.INOUT: 3}.get(d, 0)


def verilog_runtime_signal_count(rt) -> int:
    return len(rt.signals())


def verilog_runtime_signal_name(rt, i: int) -> str:
    return rt.signals()[i]


def verilog_runtime_get_signal_value(rt, i: int) -> int:
    return rt.get_value(rt.signals()[i])


def verilog_runtime_get_signal_state(rt, i: int) -> int:
    return rt.get_state(rt.signals()[i])


def verilog_runtime_set_signal_value(rt, i: int, state: int) -> int:
    rt.set_state(rt.signals()[i], state)
    return 0


def verilog_runtime_module_count(rt) -> int:
    return len(rt.modules())


def verilog_runtime_module_name(rt, i: int) -> str:
    return rt.modules()[i]


def verilog_runtime_preprocessed(rt) -> str:
    return rt.preprocessed


def verilog_runtime_get_tick(rt) -> int:
    return rt.get_tick()


def verilog_runtime_step(rt, tick: int, process_sequential: int) -> int:
    rt.step_at(tick, bool(process_sequential))
    return 0


def verilog_runtime_top_module_name(rt) -> str:
    return rt.top_module_name


def verilog_runtime_get_port_state(rt, i: int) -> int:
    return rt.get_state(rt.ports()[i].name)


def verilog_runtime_set_port_state(rt, i: int, code: int) -> int:
    rt.set_state(rt.ports()[i].name, code)
    return 0


def verilog_runtime_get_port_value(rt, i: int) -> int:
    return rt.get_value(rt.ports()[i].name)


def verilog_runtime_set_port_value(rt, i: int, value: int) -> int:
    rt.set_value(rt.ports()[i].name, value)
    return 0


# -- PhysicsLab experiment handles (dll_api.h:318-443) -----------------------

def pl_experiment_create(type_value: int):
    from .io import plsav
    del type_value                     # circuit scenes only (type 0)
    return plsav.Experiment()


def pl_experiment_load_from_string(sav_json: str):
    import json
    from .io import plsav
    return plsav.Experiment.load_from_json(json.loads(sav_json))


def pl_experiment_load_from_file(path: str):
    from .io import plsav
    return plsav.Experiment.load(path)


def pl_experiment_dump(ex, indent: int) -> str:
    import json
    return json.dumps(ex.to_json(), ensure_ascii=False,
                      indent=indent if indent > 0 else None)


def pl_experiment_save(ex, path: str, indent: int) -> int:
    with open(path, "w", encoding="utf-8") as f:
        f.write(pl_experiment_dump(ex, indent))
    return 0


def pl_experiment_element_count(ex) -> int:
    return len(ex.elements)


def pl_experiment_add_circuit_element(ex, model_id: str, x: float,
                                      y: float, z: float,
                                      element_xyz_coords: int,
                                      is_big_element: int,
                                      participate_in_layout: int) -> str:
    el = ex.add_element(model_id, position=(x, y, z))
    if is_big_element:
        el.is_big = True
    if not participate_in_layout:
        el.statistics["__fixed__"] = 1.0
    return el.identifier


def pl_experiment_connect(ex, src_id: str, src_pin: int, dst_id: str,
                          dst_pin: int, color_value: int) -> int:
    from .io import plsav
    src = ex.find(src_id)
    dst = ex.find(dst_id)
    if src is None or dst is None:
        raise api.PhyEngineError("unknown element identifier")
    color = plsav.WIRE_COLORS[color_value % len(plsav.WIRE_COLORS)]
    ex.add_wire(src, src_pin, dst, dst_pin, color)
    return 0


def pl_experiment_clear_wires(ex) -> int:
    ex.wires.clear()
    return 0


def pl_experiment_set_xyz_precision(ex, decimals: int) -> int:
    ex.xyz_precision = int(decimals)
    return 0


def pl_experiment_set_element_xyz(ex, enabled: int, ox: float,
                                  oy: float, oz: float) -> int:
    ex.element_xyz = {"enabled": bool(enabled),
                      "origin": (ox, oy, oz)}
    return 0


def pl_experiment_set_camera(ex, vx: float, vy: float, vz: float,
                             rx: float, ry: float, rz: float) -> int:
    ex.camera["VisionCenter"] = f"{vx},{vy},{vz}"
    ex.camera["TargetRotation"] = f"{rx},{ry},{rz}"
    return 0


def _find_el(ex, element_id: str):
    el = ex.find(element_id)
    if el is None:
        raise api.PhyEngineError(f"unknown element {element_id!r}")
    return el


def pl_experiment_set_element_property_number(ex, element_id: str,
                                              key: str,
                                              value: float) -> int:
    _find_el(ex, element_id).properties[key] = float(value)
    return 0


def pl_experiment_set_element_label(ex, element_id: str,
                                    label: str) -> int:
    _find_el(ex, element_id).statistics["__label__"] = label
    return 0


def pl_experiment_set_element_position(ex, element_id: str, x: float,
                                       y: float, z: float,
                                       element_xyz_coords: int) -> int:
    del element_xyz_coords
    _find_el(ex, element_id).position = (x, y, z)
    return 0


def pl_experiment_merge(dst, src, ox: float, oy: float,
                        oz: float) -> int:
    for el in src.elements:
        x, y, z = el.position
        el.position = (x + ox, y + oy, z + oz)
    dst.merge(src)
    return 0


def pl_experiment_auto_layout(ex, c0x: float, c0y: float, c0z: float,
                              c1x: float, c1y: float, c1z: float,
                              z_fixed: float, backend_value: int,
                              mode_value: int, step_x: float,
                              step_y: float, margin_x: float,
                              margin_y: float):
    """[grid_w, grid_h, fixed_obstacles, placed, skipped] — the out
    params of dll_api.h pl_experiment_auto_layout.  backend_value is
    accepted for signature parity (one backend here)."""
    del backend_value, z_fixed, margin_x, margin_y
    from .io import layout
    origin = (min(c0x, c1x), min(c0y, c1y))
    spacing = max(step_x, step_y) or 0.16
    if mode_value >= 1:
        st = layout.auto_layout_quality(ex, spacing=spacing,
                                        origin=origin)
    else:
        st = layout.auto_layout(ex, spacing=spacing, origin=origin)
    placed = st.placed
    return [st.columns, st.rows, 0, placed,
            max(0, len(ex.elements) - placed)]


# -- PhysicsLab -> PE simulation handle (pe_sim.h role) ----------------------

class _PLPeCircuit:
    """Scene-simulation handle pairing an api.Circuit with the scene
    it was built from (pl_pe_circuit_* family)."""

    def __init__(self, ex):
        from .io import plsav
        c, self.indices = plsav.experiment_to_circuit(ex, device=DEVICE)
        self.circuit = _native_where_eligible(c)
        self.experiment = ex


def pl_pe_circuit_build(ex):
    return _PLPeCircuit(ex)


def pl_pe_circuit_comp_size(h) -> int:
    return h.circuit.component_count


def pl_pe_circuit_set_analyze_type(h, at: int) -> int:
    h.circuit.set_analyze_type(at)
    return 0


def pl_pe_circuit_set_tr(h, t_step: float, t_stop: float) -> int:
    h.circuit.set_tr(t_step, t_stop)
    return 0


def pl_pe_circuit_set_ac_omega(h, omega: float) -> int:
    h.circuit.set_ac_omega(omega)
    return 0


def pl_pe_circuit_analyze(h) -> int:
    h.circuit.analyze()
    return 0


def pl_pe_circuit_digital_clk(h) -> int:
    h.circuit.digital_clk()
    return 0


def pl_pe_circuit_sync_inputs_from_pl(h, ex=None) -> int:
    from .io import plsav
    plsav.sync_inputs(ex if ex is not None else h.experiment,
                      h.circuit)
    return 0


def pl_pe_circuit_write_back_to_pl(h, ex=None) -> int:
    from .io import plsav
    plsav.write_back(ex if ex is not None else h.experiment, h.circuit)
    return 0


def pl_pe_circuit_write_back_to_pl_ex(h, ex, lo: float, hi: float,
                                      x: float, z: float) -> int:
    from .io import plsav
    plsav.write_back(ex if ex is not None else h.experiment, h.circuit,
                     out_l=lo, out_h=hi, out_x=x, out_z=z)
    return 0


def pl_pe_circuit_sample_layout(h):
    return circuit_sample_layout(h.circuit)


def pl_pe_circuit_sample_u8(h):
    return circuit_sample_u8(h.circuit)


# -- PE -> PhysicsLab export (pe_to_pl.h role) -------------------------------

def pe_to_pl_convert(c, fixed_x: float, fixed_y: float, fixed_z: float,
                     element_xyz_coords: int, keep_pl_macros: int,
                     include_linear: int, include_ground: int,
                     generate_wires: int,
                     keep_unknown_as_placeholders: int,
                     drop_dangling_logic_inputs: int):
    """api.Circuit handle -> Experiment handle (pe_to_pl_convert)."""
    del (fixed_x, fixed_y, fixed_z, element_xyz_coords, keep_pl_macros,
         keep_unknown_as_placeholders, drop_dangling_logic_inputs)
    from .io import plsav
    opt = plsav.ExportOptions(include_linear=bool(include_linear),
                              include_ground=bool(include_ground))
    ex = plsav.circuit_to_experiment(c._core.nl, opt)
    if not generate_wires:
        ex.wires.clear()
    return ex
