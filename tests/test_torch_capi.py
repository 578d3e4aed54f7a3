"""The port's embeddable C ABI (``phy_engine_tpu_torch/native/pe_capi.c``
over ``phy_engine_tpu_torch/capi.py``) against the JAX package's library:
the eleven cases of ``tests/test_capi.py``, ``test_capi_full.py`` and
``test_capi_verilog.py`` driven through both libraries with ctypes in one
process, the port's circuits on the CPU (``capi.DEVICE = "cpu"``), every
output equal to the JAX library's (analog values to 1e-9)."""

import ctypes
import json
import random
import shutil

import numpy as np
import pytest

import phy_engine_tpu.native as jnative
from phy_engine_tpu_torch import capi, native

import test_capi
from test_capi import _bind_pl, _take_str
from test_capi_full import TWO_MODS
from test_capi_verilog import ASYNC_DFF, MDRV

szp = ctypes.POINTER(ctypes.c_size_t)
TOL = 1e-9


def _bind_full(lib):
    """The argument types test_capi_full.py and test_capi_verilog.py
    declare on top of test_capi._load's."""
    lib.circuit_set_tnom.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.circuit_sample.argtypes = [
        ctypes.c_void_p, szp, szp, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_double), szp,
        ctypes.POINTER(ctypes.c_double), szp,
        ctypes.POINTER(ctypes.c_bool), szp]
    lib.analyze_circuit.argtypes = [
        ctypes.c_void_p, szp, szp, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), szp,
        ctypes.POINTER(ctypes.c_double), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_double), szp,
        ctypes.POINTER(ctypes.c_double), szp,
        ctypes.POINTER(ctypes.c_bool), szp]
    for name in ("opt_level", "assume_binary_inputs", "allow_inout",
                 "allow_multi_driver", "optimize_wires",
                 "optimize_mul2", "optimize_adders"):
        getattr(lib, f"verilog_synth_set_{name}").argtypes = [ctypes.c_uint8]
        getattr(lib, f"verilog_synth_get_{name}").restype = ctypes.c_uint8
    lib.verilog_synth_set_loop_unroll_limit.argtypes = [ctypes.c_size_t]
    lib.verilog_synth_get_loop_unroll_limit.restype = ctypes.c_size_t
    for name in ("module_count", "signal_count", "preprocessed_size",
                 "top_module_name_size"):
        f = getattr(lib, f"verilog_runtime_{name}")
        f.argtypes = [ctypes.c_void_p]
        f.restype = ctypes.c_size_t
    for name in ("module_name_size", "signal_name_size", "port_name_size"):
        f = getattr(lib, f"verilog_runtime_{name}")
        f.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        f.restype = ctypes.c_size_t
    for name in ("copy_module_name", "copy_signal_name"):
        getattr(lib, f"verilog_runtime_{name}").argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
            ctypes.c_size_t]
    lib.verilog_runtime_copy_preprocessed.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.verilog_runtime_get_tick.argtypes = [ctypes.c_void_p]
    lib.verilog_runtime_get_tick.restype = ctypes.c_uint64
    lib.verilog_runtime_step.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint8]
    lib.verilog_runtime_get_signal_value.argtypes = [ctypes.c_void_p,
                                                     ctypes.c_size_t]
    lib.verilog_runtime_get_signal_value.restype = ctypes.c_uint8
    lib.verilog_runtime_set_signal_value.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint8]
    lib.create_circuit_ex.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_char_p), szp, ctypes.c_size_t,
        szp, szp, ctypes.POINTER(szp), ctypes.POINTER(szp), szp]
    lib.create_circuit_ex.restype = ctypes.c_void_p
    return _bind_pl(lib)


@pytest.fixture(scope="module")
def libs():
    """(JAX library, the port's library), both bound and initialized in
    this interpreter.  The port's builds from its own source into
    build/phy_engine_tpu_torch/; a failed build raises (the JAX tests
    skip only without a C compiler, and so does this)."""
    if shutil.which("cc") is None:
        pytest.skip("no C compiler for the ABI shim")
    path = native.build_capi()
    assert path.parent == native.BUILD_DIR
    jlib = _bind_full(test_capi._load())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "build_capi", lambda: str(path))
        tlib = _bind_full(test_capi._load())
    prev = capi.DEVICE
    capi.DEVICE = "cpu"
    yield jlib, tlib
    capi.DEVICE = prev


def both(libs, case):
    """``case(lib)`` on each library; the outputs must agree."""
    j, t = (case(lib) for lib in libs)
    _agree(j, t)
    return t


def _agree(a, b):
    if isinstance(a, float) or isinstance(b, float):
        assert b == pytest.approx(a, rel=TOL, abs=TOL)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _agree(x, y)
    else:
        assert a == b


def _core(h):
    """The api.Circuit behind a C handle (a strong PyObject reference)."""
    return ctypes.cast(h, ctypes.py_object).value


def _create(lib, codes, wires, props):
    n = len(codes)
    vec, chunk, comp = szp(), szp(), ctypes.c_size_t()
    h = lib.create_circuit((ctypes.c_int * n)(*codes), n,
                           (ctypes.c_int * len(wires))(*wires), len(wires),
                           (ctypes.c_double * max(1, len(props)))(*props),
                           ctypes.byref(vec), ctypes.byref(chunk),
                           ctypes.byref(comp))
    assert h, lib.phy_engine_last_error()
    return h, vec, chunk, comp.value


def _sample(lib, h, vec, chunk, n):
    """(layouts, voltages, currents, 4-state codes) through the ABI."""
    ords = [(ctypes.c_size_t * (n + 1))() for _ in range(3)]
    assert lib.circuit_sample_layout(h, vec, chunk, n, *ords) == 0
    v_ord, c_ord, d_ord = ords
    volts = (ctypes.c_double * max(1, v_ord[n]))()
    curs = (ctypes.c_double * max(1, c_ord[n]))()
    digs = (ctypes.c_uint8 * max(1, d_ord[n]))()
    assert lib.circuit_sample_digital_state_u8(
        h, vec, chunk, n, volts, v_ord, curs, c_ord, digs, d_ord) == 0
    return ([list(o) for o in ords], list(volts[:v_ord[n]]),
            list(curs[:c_ord[n]]), list(digs[:d_ord[n]]))


DIVIDER = ([0, 4, 1, 1], [1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 0, 0, 1, 1, 0, 0],
           [6.0, 1000.0, 2000.0])


def test_capi_resistor_divider(libs):
    def case(lib):
        h, vec, chunk, n = _create(lib, *DIVIDER)
        assert lib.circuit_set_analyze_type(h, 0) == 0
        assert lib.circuit_analyze(h) == 0, lib.phy_engine_last_error()
        out = (n,) + _sample(lib, h, vec, chunk, n)
        lib.destroy_circuit(h, vec, chunk)
        return out

    n, ords, volts, _curs, _digs = both(libs, case)
    assert n == 3
    assert np.allclose(sorted(volts[ords[0][1]:ords[0][2]]), [4.0, 6.0])


def test_capi_digital_gate(libs):
    """A pure gate circuit: the port's glue clocks it on the host sweep
    engine, the JAX glue too (PE_TPU_DIGITAL=native)."""
    def case(lib):
        h, vec, chunk, n = _create(lib, [200, 200, 204, 201],
                                   [0, 0, 2, 0, 1, 0, 2, 1, 2, 2, 3, 0],
                                   [1.0, 0.0])
        states = []
        assert lib.circuit_digital_clk(h) == 0, lib.phy_engine_last_error()
        states.append(_sample(lib, h, vec, chunk, n)[3])
        assert lib.circuit_set_model_digital(h, 1, 0, 0, 1) == 0
        assert lib.circuit_digital_clk(h) == 0
        states.append(_sample(lib, h, vec, chunk, n)[3])
        lib.destroy_circuit(h, vec, chunk)
        return states

    assert [s[-1] for s in both(libs, case)] == [0, 1]
    h, vec, chunk, _n = _create(libs[1], [200, 201], [0, 0, 1, 0], [1.0])
    assert _core(h).core.digital_backend == "native"
    libs[1].destroy_circuit(h, vec, chunk)


def test_capi_verilog_runtime(libs):
    src = b"""
module cnt(input clk, input rst_n, output [3:0] q);
  reg [3:0] r;
  always @(posedge clk or negedge rst_n)
    if (!rst_n) r <= 4'd0; else r <= r + 4'd1;
  assign q = r;
endmodule
"""

    def case(lib):
        rt = lib.verilog_runtime_create(src, len(src), b"cnt", 3, None,
                                        None, 0)
        assert rt, lib.phy_engine_last_error()
        names = {}
        for i in range(lib.verilog_runtime_port_count(rt)):
            buf = ctypes.create_string_buffer(64)
            lib.verilog_runtime_copy_port_name(rt, i, buf, 64)
            names[buf.value.decode()] = (i, lib.verilog_runtime_port_dir(
                rt, i))
        clk, rst = names["clk"][0], names["rst_n"][0]
        lib.verilog_runtime_set_port_value(rt, rst, 0)
        lib.verilog_runtime_tick(rt)
        lib.verilog_runtime_set_port_value(rt, rst, 1)
        qs = []
        for _ in range(5):
            for level in (1, 0):
                lib.verilog_runtime_set_port_value(rt, clk, level)
                lib.verilog_runtime_tick(rt)
            qs.append(lib.verilog_runtime_get_port_value(rt,
                                                         names["q"][0]))
        lib.verilog_runtime_destroy(rt)
        return sorted(names.items()), qs

    names, qs = both(libs, case)
    assert dict(names)["q"][1] == 2 and qs == [1, 2, 3, 4, 5]


def test_capi_pl_scene_sim_write_back(libs, tmp_path):
    def case(lib):
        random.seed(21)
        ex = lib.pl_experiment_create(0)
        assert ex, lib.phy_engine_last_error()

        def add(mid):
            return _take_str(lib, lib.pl_experiment_add_circuit_element(
                ex, mid, len(mid), 0.0, 0.0, 0.0, 0, 0, 1))

        i_in, i_yes, i_out = (add(m) for m in (b"Logic Input", b"Yes Gate",
                                               b"Logic Output"))
        for a, pa, b, pb in ((i_in, 0, i_yes, 0), (i_yes, 1, i_out, 0)):
            assert lib.pl_experiment_connect(ex, a.encode(), len(a), pa,
                                             b.encode(), len(b), pb, 0) == 0
        key = "开关".encode()
        assert lib.pl_experiment_set_element_property_number(
            ex, i_in.encode(), len(i_in), key, len(key), 1.0) == 0
        h = lib.pl_pe_circuit_build(ex)
        assert h, lib.phy_engine_last_error()
        n = lib.pl_pe_circuit_comp_size(h)
        assert lib.pl_pe_circuit_sync_inputs_from_pl(h, ex) == 0
        for _ in range(2):
            assert lib.pl_pe_circuit_digital_clk(h) == 0, \
                lib.phy_engine_last_error()
        assert lib.pl_pe_circuit_write_back_to_pl(h, ex) == 0
        outs = [(ctypes.c_size_t * 1)() for _ in range(5)]
        assert lib.pl_experiment_auto_layout(
            ex, 0.0, 0.0, 0.0, 2.0, 2.0, 0.0, 0.0, 0, 0,
            0.16, 0.16, 0.0, 0.0, *outs) == 0
        # a new scene is named after its package (JAX: "phy_engine_tpu"),
        # the one field in which the two scenes differ
        doc = _take_str(lib, lib.pl_experiment_dump(ex, 0))
        name = json.loads(doc)["InternalName"]
        doc = doc.replace(json.dumps(name), '"<package>"')
        path = str(tmp_path / "scene.sav").encode()
        assert lib.pl_experiment_save(ex, path, len(path), 0) == 0
        ex2 = lib.pl_experiment_load_from_file(path, len(path))
        assert ex2, lib.phy_engine_last_error()
        count = lib.pl_experiment_element_count(ex2)
        for f, x in ((lib.pl_pe_circuit_destroy, h),
                     (lib.pl_experiment_destroy, ex2),
                     (lib.pl_experiment_destroy, ex)):
            f(x)
        return (n, [o[0] for o in outs], doc, count), name

    (jout, jname), (tout, tname) = (case(lib) for lib in libs)
    _agree(jout, tout)
    assert (jname, tname) == ("phy_engine_tpu", "phy_engine_tpu_torch")
    n, outs, doc, count = tout
    status = json.loads(json.loads(doc)["Experiment"]["StatusSave"])
    out_el = [e for e in status["Elements"]
              if e["ModelID"] == "Logic Output"][0]
    assert (n, outs[3], count) == (3, 3, 3)
    assert out_el["Properties"]["状态"] == 1.0


def test_capi_pe_to_pl_convert(libs):
    def case(lib):
        random.seed(22)
        h, vec, chunk, _n = _create(lib, *DIVIDER)
        ex = lib.pe_to_pl_convert(h, 0.0, 0.0, 0.0, 0, 0, 1, 1, 1, 0, 0)
        assert ex, lib.phy_engine_last_error()
        doc = _take_str(lib, lib.pl_experiment_dump(ex, 0))
        lib.pl_experiment_destroy(ex)
        lib.destroy_circuit(h, vec, chunk)
        return doc

    status = json.loads(json.loads(both(libs, case))["Experiment"][
        "StatusSave"])
    mids = sorted(e["ModelID"] for e in status["Elements"])
    assert "Battery Source" in mids and mids.count("Resistor") == 2
    assert status["Wires"]


def test_capi_analyze_circuit_one_shot(libs):
    def case(lib):
        h, vec, chunk, n = _create(lib, *DIVIDER)
        assert lib.circuit_set_analyze_type(h, 0) == 0
        assert lib.circuit_set_tnom(h, 27.0) == 0
        ords = [(ctypes.c_size_t * (n + 1))() for _ in range(3)]
        assert lib.circuit_sample_layout(h, vec, chunk, n, *ords) == 0
        v_ord, c_ord, d_ord = ords
        volts = (ctypes.c_double * v_ord[n])()
        curs = (ctypes.c_double * max(1, c_ord[n]))()
        digs = (ctypes.c_bool * max(1, d_ord[n]))()
        assert lib.analyze_circuit(
            h, vec, chunk, n, (ctypes.c_int * 1)(2),
            (ctypes.c_size_t * 1)(0), (ctypes.c_double * 1)(1000.0), 1,
            volts, v_ord, curs, c_ord, digs, d_ord) == 0, \
            lib.phy_engine_last_error()
        first = list(volts)
        volts2 = (ctypes.c_double * v_ord[n])()
        assert lib.circuit_sample(h, vec, chunk, n, volts2, v_ord, curs,
                                  c_ord, digs, d_ord) == 0
        lib.destroy_circuit(h, vec, chunk)
        return first, list(volts2), list(curs), list(digs)

    first, again, _curs, _digs = both(libs, case)
    assert first == again
    assert np.allclose(sorted(first[4:6]), [0.0, 3.0], atol=1e-9)


def test_capi_synth_config_roundtrip(libs):
    def case(lib):
        out = [lib.verilog_synth_get_opt_level(),
               lib.verilog_synth_get_allow_multi_driver(),
               lib.verilog_synth_get_loop_unroll_limit()]
        lib.verilog_synth_set_opt_level(2)
        lib.verilog_synth_set_loop_unroll_limit(128)
        lib.verilog_synth_set_optimize_adders(0)
        try:
            out += [lib.verilog_synth_get_opt_level(),
                    lib.verilog_synth_get_loop_unroll_limit(),
                    lib.verilog_synth_get_optimize_adders()]
        finally:
            lib.verilog_synth_set_opt_level(0)
            lib.verilog_synth_set_loop_unroll_limit(64)
            lib.verilog_synth_set_optimize_adders(1)
        return out

    assert both(libs, case) == [0, 1, 64, 2, 128, 0]


def _build_ex(lib, codes, wires, props, texts, src_idx, top_idx):
    """create_circuit_ex; (handle or None, error, vec, chunk, count)."""
    n = len(codes)
    texts_b = [t.encode() for t in texts]
    vec, chunk, comp = szp(), szp(), ctypes.c_size_t()
    h = lib.create_circuit_ex(
        (ctypes.c_int * n)(*codes), n,
        (ctypes.c_int * len(wires))(*wires), len(wires),
        (ctypes.c_double * max(1, len(props)))(*props),
        (ctypes.c_char_p * len(texts))(*texts_b),
        (ctypes.c_size_t * len(texts))(*[len(t) for t in texts_b]),
        len(texts), (ctypes.c_size_t * n)(*src_idx),
        (ctypes.c_size_t * n)(*top_idx), ctypes.byref(vec),
        ctypes.byref(chunk), ctypes.byref(comp))
    return h, lib.phy_engine_last_error(), vec, chunk, comp.value


MDRV_CASE = ([301, 200, 200, 200, 200, 201], [1, 0, 0, 0, 2, 0, 0, 1, 3, 0,
                                              0, 2, 4, 0, 0, 3, 0, 4, 5, 0],
             [1.0, 1.0, 0.0, 0.0], [MDRV], [0] * 6, [2 ** 63] * 6)


def test_capi_synth_multi_driver_policy(libs):
    def case(lib):
        lib.verilog_synth_set_allow_multi_driver(0)
        try:
            h, err, *_ = _build_ex(lib, *MDRV_CASE)
        finally:
            lib.verilog_synth_set_allow_multi_driver(1)
        h2, _err, vec, chunk, comp = _build_ex(lib, *MDRV_CASE)
        assert h2, lib.phy_engine_last_error()
        lib.destroy_circuit(h2, vec, chunk)
        return bool(h), b"multi-driven" in err, comp

    assert both(libs, case) == (False, True, 6)


def test_capi_runtime_introspection(libs):
    src = TWO_MODS.encode()

    def string(lib, size_fn, copy_fn, *idx):
        sz = size_fn(*idx)
        buf = ctypes.create_string_buffer(sz + 1)
        assert copy_fn(*idx, buf, sz + 1) >= 0
        return buf.value.decode()

    def case(lib):
        rt = lib.verilog_runtime_create(src, len(src), b"top2", 4, None,
                                        None, 0)
        assert rt, lib.phy_engine_last_error()
        mods = [string(lib, lib.verilog_runtime_module_name_size,
                       lib.verilog_runtime_copy_module_name, rt, i)
                for i in range(lib.verilog_runtime_module_count(rt))]
        top = lib.verilog_runtime_top_module_name_size(rt)
        text = string(lib, lib.verilog_runtime_preprocessed_size,
                      lib.verilog_runtime_copy_preprocessed, rt)
        sig = {string(lib, lib.verilog_runtime_signal_name_size,
                      lib.verilog_runtime_copy_signal_name, rt, i): i
               for i in range(lib.verilog_runtime_signal_count(rt))}
        assert lib.verilog_runtime_set_signal_value(rt, sig["r"], 0) == 0
        ticks = [lib.verilog_runtime_get_tick(rt)]
        t = 0
        for _ in range(2):
            for level in (1, 0):
                t += 1
                lib.verilog_runtime_set_port_value(rt, 0, level)
                assert lib.verilog_runtime_step(rt, t, 1) == 0
        ticks.append(lib.verilog_runtime_get_tick(rt))
        r = lib.verilog_runtime_get_signal_value(rt, sig["r"])
        lib.verilog_runtime_destroy(rt)
        return mods, top, text, sorted(sig.items()), ticks, r

    mods, top, text, _sig, ticks, r = both(libs, case)
    assert set(mods) == {"half", "top2"} and top == 4
    assert "WIDTH" not in text and (ticks, r) == ([0, 4], 2)


def _digital_run(lib, spec, steps):
    """Build through create_circuit_ex, then per step set (component,
    state) pairs, clock, and read every component's digital states."""
    h, err, vec, chunk, n = _build_ex(lib, *spec)
    assert h, err

    def setd(comp_i, v):
        assert lib.circuit_set_model_digital(h, comp_i, 0, 0, v) == 0

    out = []
    for sets, clocks in steps:
        for comp_i, v in sets:
            setd(comp_i, v)
        for level in clocks:
            if level is not None:
                setd(2, level)
            assert lib.circuit_digital_clk(h) == 0, \
                lib.phy_engine_last_error()
        out.append(_sample(lib, h, vec, chunk, n)[3])
    lib.destroy_circuit(h, vec, chunk)
    return n, out


def _port_backend(tlib, spec):
    """The digital backend the port's glue chose for ``spec``."""
    h, err, vec, chunk, _n = _build_ex(tlib, *spec)
    assert h, err
    backend = _core(h).core.digital_backend
    tlib.destroy_circuit(h, vec, chunk)
    return backend


def test_capi_verilog_netlist_async_reset_dff(libs):
    spec = ([301, 200, 200, 200, 201], [1, 0, 0, 2, 2, 0, 0, 0, 3, 0, 0, 1,
                                        0, 3, 4, 0],
            [0.0, 0.0, 0.0], [ASYNC_DFF], [0] * 5, [2 ** 63] * 5)
    clock = (0, 1)                   # component 2 is clk
    steps = [([(3, 0)], clock), ([(3, 1), (1, 1)], clock),
             ([(1, 0)], clock)]
    n, out = both(libs, lambda lib: _digital_run(lib, spec, steps))
    assert n == 5 and [s[-1] for s in out] == [0, 1, 0]
    # gates and DFF_ARSTN: the host sweep engine
    assert _port_backend(libs[1], spec) == "native"


def test_capi_verilog_netlist_multi_driver(libs):
    steps = [([], (None,)), ([(2, 0)], (None,)), ([(4, 1)], (None,)),
             ([(2, 1)], (None,))]
    n, out = both(libs, lambda lib: _digital_run(lib, MDRV_CASE, steps))
    assert n == 6 and [s[-1] for s in out] == [1, 3, 0, 2]
    # the tri-state drivers and their resolver are gate rows the host
    # sweep engine runs too
    assert _port_backend(libs[1], MDRV_CASE) == "native"


INV = """
module inv(input a, output y);
  assign y = ~a;
endmodule
"""


def test_capi_backend_by_eligibility(libs):
    """A VERILOG_MODULE element needs the host runtime beside the tick,
    which the host sweep engine cannot give: the port's glue leaves that
    circuit on the device's levelled tick, with the JAX library's
    outputs."""
    spec = ([300, 200, 201], [1, 0, 0, 0, 0, 1, 2, 0], [0.0], [INV],
            [0] * 3, [2 ** 63] * 3)
    steps = [([], (None,)), ([(1, 1)], (None,))]
    n, out = both(libs, lambda lib: _digital_run(lib, spec, steps))
    assert n == 3 and [s[-1] for s in out] == [1, 0]
    assert _port_backend(libs[1], spec) == "device"


def test_capi_failed_build_raises(monkeypatch, tmp_path):
    """A C shim that does not compile raises with the compiler's output;
    nothing is left in the build directory."""
    if shutil.which("cc") is None:
        pytest.skip("no C compiler for the ABI shim")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    (tmp_path / native.CAPI_SRC).write_text("this is not C\n")
    with pytest.raises(RuntimeError, match="cc failed"):
        native.build_capi()
    assert not list((tmp_path / "build").glob("*.so"))
