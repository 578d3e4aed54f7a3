/* Embeddable C ABI over the PyTorch + CUDA engine (the port's copy of
 * phy_engine_tpu/native/pe_capi.c).
 *
 * Role parity: the reference ships a C surface (dll_api.h:14-444,
 * implemented by dll_main.cpp) so PhysicsLab / wasm hosts can drive
 * the engine without C++.  This build's engine is Python/PyTorch, so the
 * shim embeds CPython and forwards into phy_engine_tpu_torch.capi — the
 * function names, argument conventions (element codes, wire quads,
 * positional property streams, prefix-sum sample layouts, 4-state u8
 * digital codes) mirror dll_api.h, and the exported C symbols are the
 * JAX package's library's.
 *
 * Handles returned to C are strong PyObject references.  Every entry
 * point takes the GIL (PyGILState), so the library is usable both
 * from plain C programs (the shim initializes the interpreter) and
 * from inside an existing Python process via dlopen/ctypes (the
 * interpreter is reused).
 *
 * Build (phy_engine_tpu_torch.native.build_capi does this into
 * build/phy_engine_tpu_torch/):
 *   cc -O2 -shared -fPIC -Wl,-Bsymbolic pe_capi.c -I<python include>
 *      -L<python LIBDIR> -lpython3.x -o libphyengine_torch_<hash>.so
 * -Bsymbolic binds the library's calls to its own definitions, so a
 * process that has also loaded the JAX package's library (same symbol
 * names) never reaches that one's glue from this one.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdarg.h>
#include <string.h>
#include <stdlib.h>

static PyObject* g_glue = NULL;
static __thread char g_err[1024];

const char* phy_engine_last_error(void) { return g_err; }

void phy_engine_clear_error(void) { g_err[0] = 0; }

void phy_engine_string_free(char* s) { free(s); }

static void set_err_from_py(void) {
    PyObject *t = NULL, *v = NULL, *tb = NULL;
    PyErr_Fetch(&t, &v, &tb);
    if (v != NULL) {
        PyObject* s = PyObject_Str(v);
        if (s != NULL) {
            const char* c = PyUnicode_AsUTF8(s);
            if (c != NULL) {
                strncpy(g_err, c, sizeof(g_err) - 1);
                g_err[sizeof(g_err) - 1] = 0;
            }
            Py_DECREF(s);
        }
    }
    Py_XDECREF(t);
    Py_XDECREF(v);
    Py_XDECREF(tb);
    PyErr_Clear();
}

/* Initialize (or attach to) the interpreter and import the glue.
 * repo_root: directory containing the phy_engine_tpu_torch package; NULL
 * if the package is already importable. Returns 0 on success. */
int phy_engine_init(const char* repo_root) {
    if (!Py_IsInitialized()) { Py_InitializeEx(0); }
    PyGILState_STATE g = PyGILState_Ensure();
    int rc = 0;
    if (repo_root != NULL && repo_root[0]) {
        PyObject* sys_path = PySys_GetObject("path");   /* borrowed */
        PyObject* p = PyUnicode_FromString(repo_root);
        if (sys_path && p) { PyList_Insert(sys_path, 0, p); }
        Py_XDECREF(p);
    }
    if (g_glue == NULL) {
        g_glue = PyImport_ImportModule("phy_engine_tpu_torch.capi");
        if (g_glue == NULL) {
            set_err_from_py();
            rc = -1;
        }
    }
    PyGILState_Release(g);
    return rc;
}

/* -- small marshaling helpers -------------------------------------------- */

static PyObject* int_list(const int* a, size_t n) {
    PyObject* l = PyList_New((Py_ssize_t)n);
    for (size_t i = 0; i < n; ++i) {
        PyList_SET_ITEM(l, (Py_ssize_t)i, PyLong_FromLong(a[i]));
    }
    return l;
}

static PyObject* size_list(const size_t* a, size_t n) {
    PyObject* l = PyList_New((Py_ssize_t)n);
    for (size_t i = 0; i < n; ++i) {
        PyList_SET_ITEM(l, (Py_ssize_t)i,
                        PyLong_FromSize_t(a[i]));
    }
    return l;
}

static PyObject* dbl_list(const double* a, size_t n) {
    PyObject* l = PyList_New((Py_ssize_t)n);
    for (size_t i = 0; i < n; ++i) {
        PyList_SET_ITEM(l, (Py_ssize_t)i, PyFloat_FromDouble(a[i]));
    }
    return l;
}

static PyObject* call(const char* fn, PyObject* args) {
    /* args: new reference (tuple), consumed here */
    if (g_glue == NULL) {
        strncpy(g_err, "phy_engine_init not called", sizeof(g_err));
        Py_XDECREF(args);
        return NULL;
    }
    PyObject* f = PyObject_GetAttrString(g_glue, fn);
    if (f == NULL) { set_err_from_py(); Py_XDECREF(args); return NULL; }
    PyObject* r = PyObject_CallObject(f, args);
    Py_DECREF(f);
    Py_XDECREF(args);
    if (r == NULL) { set_err_from_py(); }
    return r;
}

/* -- circuit construction ------------------------------------------------- */

static void fill_pos(size_t comp_size, size_t** vec_pos,
                     size_t** chunk_pos) {
    /* the reference returns arena locations; component index is the
     * only coordinate here, so vec_pos[i]=i, chunk_pos[i]=0 */
    if (vec_pos != NULL) {
        *vec_pos = (size_t*)malloc(sizeof(size_t) * (comp_size + 1));
        for (size_t i = 0; i < comp_size; ++i) { (*vec_pos)[i] = i; }
    }
    if (chunk_pos != NULL) {
        *chunk_pos = (size_t*)calloc(comp_size + 1, sizeof(size_t));
    }
}

static size_t props_needed(const int* elements, size_t ele_size) {
    /* exact positional property count for the element stream, so the
     * caller's array is never over-read */
    PyObject* r = call("props_needed",
                       Py_BuildValue("(N)",
                                     int_list(elements, ele_size)));
    size_t n = 0;
    if (r != NULL) {
        n = PyLong_AsSize_t(r);
        if (PyErr_Occurred()) { set_err_from_py(); n = 0; }
        Py_DECREF(r);
    }
    return n;
}

void* create_circuit(int* elements, size_t ele_size, int* wires,
                     size_t wires_size, double* properties,
                     size_t** vec_pos, size_t** chunk_pos,
                     size_t* comp_size) {
    PyGILState_STATE g = PyGILState_Ensure();
    size_t nprop = props_needed(elements, ele_size);
    PyObject* r = call("create_circuit", Py_BuildValue(
        "(NNN)", int_list(elements, ele_size),
        int_list(wires, wires_size),
        dbl_list(properties, properties ? nprop : 0)));
    void* out = NULL;
    if (r != NULL) {
        PyObject* cc = PyObject_GetAttrString(r, "component_count");
        size_t n = cc ? (size_t)PyLong_AsSize_t(cc) : 0;
        Py_XDECREF(cc);
        if (comp_size != NULL) { *comp_size = n; }
        fill_pos(n, vec_pos, chunk_pos);
        out = (void*)r;                   /* strong reference */
    }
    PyGILState_Release(g);
    return out;
}

void* create_circuit_ex(int* elements, size_t ele_size, int* wires,
                        size_t wires_size, double* properties,
                        char const* const* texts,
                        size_t const* text_sizes, size_t text_count,
                        size_t const* element_src_index,
                        size_t const* element_top_index,
                        size_t** vec_pos, size_t** chunk_pos,
                        size_t* comp_size) {
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* tl = PyList_New((Py_ssize_t)text_count);
    for (size_t i = 0; i < text_count; ++i) {
        PyList_SET_ITEM(tl, (Py_ssize_t)i, PyUnicode_FromStringAndSize(
            texts[i], (Py_ssize_t)text_sizes[i]));
    }
    size_t nprop = props_needed(elements, ele_size);
    PyObject* r = call("create_circuit_ex", Py_BuildValue(
        "(NNNNNN)", int_list(elements, ele_size),
        int_list(wires, wires_size),
        dbl_list(properties, properties ? nprop : 0), tl,
        size_list(element_src_index, ele_size),
        size_list(element_top_index, ele_size)));
    void* out = NULL;
    if (r != NULL) {
        PyObject* cc = PyObject_GetAttrString(r, "component_count");
        size_t n = cc ? (size_t)PyLong_AsSize_t(cc) : 0;
        Py_XDECREF(cc);
        if (comp_size != NULL) { *comp_size = n; }
        fill_pos(n, vec_pos, chunk_pos);
        out = (void*)r;
    }
    PyGILState_Release(g);
    return out;
}

void destroy_circuit(void* circuit, size_t* vec_pos,
                     size_t* chunk_pos) {
    if (circuit != NULL) {
        PyGILState_STATE g = PyGILState_Ensure();
        Py_DECREF((PyObject*)circuit);
        PyGILState_Release(g);
    }
    free(vec_pos);
    free(chunk_pos);
}

/* -- int-returning single calls ------------------------------------------ */
/* NOTE: ctypes releases the GIL around foreign calls, so the argument
 * tuple MUST be built after PyGILState_Ensure — hence variadic. */

static int call_int(const char* fn, const char* fmt, ...) {
    PyGILState_STATE g = PyGILState_Ensure();
    va_list ap;
    va_start(ap, fmt);
    PyObject* args = Py_VaBuildValue(fmt, ap);
    va_end(ap);
    PyObject* r = call(fn, args);
    int rc = -1;
    if (r != NULL) {
        rc = (int)PyLong_AsLong(r);
        if (PyErr_Occurred()) { set_err_from_py(); rc = -1; }
        Py_DECREF(r);
    }
    PyGILState_Release(g);
    return rc;
}

int circuit_set_analyze_type(void* c, unsigned at) {
    return call_int("circuit_set_analyze_type", "(OI)", (PyObject*)c, at);
}

int circuit_set_tr(void* c, double t_step, double t_stop) {
    return call_int("circuit_set_tr", "(Odd)", (PyObject*)c, t_step, t_stop);
}

int circuit_set_ac_omega(void* c, double omega) {
    return call_int("circuit_set_ac_omega", "(Od)", (PyObject*)c, omega);
}

int circuit_set_temperature(void* c, double t) {
    return call_int("circuit_set_temperature", "(Od)", (PyObject*)c, t);
}

int circuit_set_tnom(void* c, double t) {
    return call_int("circuit_set_tnom", "(Od)", (PyObject*)c, t);
}

int circuit_set_model_double_by_name(void* c, size_t vec_pos,
                                     size_t chunk_pos,
                                     char const* name,
                                     size_t name_size, double value) {
    (void)chunk_pos;
    return call_int("circuit_set_model_double_by_name", "(Ons#d)", (PyObject*)c, (Py_ssize_t)vec_pos, name,
        (Py_ssize_t)name_size, value);
}

int circuit_set_model_digital(void* c, size_t vec_pos,
                              size_t chunk_pos, size_t attribute_index,
                              unsigned char state) {
    (void)chunk_pos;
    (void)attribute_index;
    return call_int("circuit_set_model_digital", "(Onb)", (PyObject*)c, (Py_ssize_t)vec_pos, state);
}

int circuit_analyze(void* c) {
    return call_int("circuit_analyze", "(O)", (PyObject*)c);
}

int circuit_digital_clk(void* c) {
    return call_int("circuit_digital_clk", "(O)", (PyObject*)c);
}

/* -- sampling -------------------------------------------------------------- */

static int copy_size_row(PyObject* row, size_t* out, size_t cap) {
    Py_ssize_t n = PyList_Size(row);
    if ((size_t)n > cap) { n = (Py_ssize_t)cap; }
    for (Py_ssize_t i = 0; i < n; ++i) {
        out[i] = PyLong_AsSize_t(PyList_GET_ITEM(row, i));
    }
    return 0;
}

int circuit_sample_layout(void* c, size_t* vec_pos, size_t* chunk_pos,
                          size_t comp_size, size_t* voltage_ord,
                          size_t* current_ord, size_t* digital_ord) {
    (void)vec_pos;
    (void)chunk_pos;
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* r = call("circuit_sample_layout",
                       Py_BuildValue("(O)", (PyObject*)c));
    int rc = -1;
    if (r != NULL && PyList_Check(r) && PyList_Size(r) == 3) {
        copy_size_row(PyList_GET_ITEM(r, 0), voltage_ord,
                      comp_size + 1);
        copy_size_row(PyList_GET_ITEM(r, 1), current_ord,
                      comp_size + 1);
        copy_size_row(PyList_GET_ITEM(r, 2), digital_ord,
                      comp_size + 1);
        rc = 0;
    }
    Py_XDECREF(r);
    PyGILState_Release(g);
    return rc;
}

static int sample_impl(void* c, double* voltage, size_t* voltage_ord,
                       double* current, size_t* current_ord,
                       unsigned char* digital, size_t* digital_ord,
                       size_t comp_size, int four_state) {
    (void)voltage_ord;
    (void)current_ord;
    (void)digital_ord;
    (void)comp_size;
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* r = call("circuit_sample_u8",
                       Py_BuildValue("(O)", (PyObject*)c));
    int rc = -1;
    if (r != NULL && PyList_Check(r) && PyList_Size(r) == 3) {
        PyObject* vs = PyList_GET_ITEM(r, 0);
        PyObject* cs = PyList_GET_ITEM(r, 1);
        PyObject* ds = PyList_GET_ITEM(r, 2);
        for (Py_ssize_t i = 0; i < PyList_Size(vs); ++i) {
            voltage[i] = PyFloat_AsDouble(PyList_GET_ITEM(vs, i));
        }
        for (Py_ssize_t i = 0; i < PyList_Size(cs); ++i) {
            current[i] = PyFloat_AsDouble(PyList_GET_ITEM(cs, i));
        }
        for (Py_ssize_t i = 0; i < PyList_Size(ds); ++i) {
            long d = PyLong_AsLong(PyList_GET_ITEM(ds, i));
            digital[i] = four_state ? (unsigned char)(d & 3)
                                    : (unsigned char)(d == 1 ? 1 : 0);
        }
        rc = 0;
    }
    Py_XDECREF(r);
    PyGILState_Release(g);
    return rc;
}

int circuit_sample_u8(void* c, size_t* vec_pos, size_t* chunk_pos,
                      size_t comp_size, double* voltage,
                      size_t* voltage_ord, double* current,
                      size_t* current_ord, unsigned char* digital,
                      size_t* digital_ord) {
    (void)vec_pos;
    (void)chunk_pos;
    return sample_impl(c, voltage, voltage_ord, current, current_ord,
                       digital, digital_ord, comp_size, 0);
}

int circuit_sample(void* c, size_t* vec_pos, size_t* chunk_pos,
                   size_t comp_size, double* voltage,
                   size_t* voltage_ord, double* current,
                   size_t* current_ord, _Bool* digital,
                   size_t* digital_ord) {
    /* bool variant of circuit_sample_u8 (dll_api.h:196): _Bool is one
     * byte on every supported ABI, so the u8 0/1 writer is reusable */
    (void)vec_pos;
    (void)chunk_pos;
    return sample_impl(c, voltage, voltage_ord, current, current_ord,
                       (unsigned char*)digital, digital_ord, comp_size,
                       0);
}

int analyze_circuit(void* c, size_t* vec_pos, size_t* chunk_pos,
                    size_t comp_size, int* changed_ele,
                    size_t* changed_ind, double* changed_prop,
                    size_t prop_size, double* voltage,
                    size_t* voltage_ord, double* current,
                    size_t* current_ord, _Bool* digital,
                    size_t* digital_ord) {
    /* property updates + analyze + sample in one call
     * (dll_api.h:237-252, dll_main.cpp:2899-2934) */
    (void)vec_pos;
    (void)chunk_pos;
    (void)comp_size;
    (void)voltage_ord;
    (void)current_ord;
    (void)digital_ord;
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* r = call("analyze_circuit", Py_BuildValue(
        "(ONNN)", (PyObject*)c,
        int_list(changed_ele, prop_size),
        size_list(changed_ind, prop_size),
        dbl_list(changed_prop, prop_size)));
    int rc = -1;
    if (r != NULL && PyList_Check(r) && PyList_Size(r) == 3) {
        PyObject* vs = PyList_GET_ITEM(r, 0);
        PyObject* cs = PyList_GET_ITEM(r, 1);
        PyObject* ds = PyList_GET_ITEM(r, 2);
        for (Py_ssize_t i = 0; i < PyList_Size(vs); ++i) {
            voltage[i] = PyFloat_AsDouble(PyList_GET_ITEM(vs, i));
        }
        for (Py_ssize_t i = 0; i < PyList_Size(cs); ++i) {
            current[i] = PyFloat_AsDouble(PyList_GET_ITEM(cs, i));
        }
        for (Py_ssize_t i = 0; i < PyList_Size(ds); ++i) {
            long d = PyLong_AsLong(PyList_GET_ITEM(ds, i));
            digital[i] = d == 1;
        }
        rc = 0;
    }
    Py_XDECREF(r);
    PyGILState_Release(g);
    return rc;
}

/* -- global verilog synth defaults (dll_api.h:253-268) --------------------- */

static void synth_set(const char* name, long v) {
    call_int("verilog_synth_set", "(sl)", name, v);
}

static long synth_get(const char* name) {
    return (long)call_int("verilog_synth_get", "(s)", name);
}

void verilog_synth_set_opt_level(unsigned char level) {
    synth_set("opt_level", level);
}
unsigned char verilog_synth_get_opt_level(void) {
    long v = synth_get("opt_level");
    return v < 0 ? 0 : (unsigned char)v;
}
void verilog_synth_set_assume_binary_inputs(_Bool v) {
    synth_set("assume_binary_inputs", v);
}
_Bool verilog_synth_get_assume_binary_inputs(void) {
    return synth_get("assume_binary_inputs") == 1;
}
void verilog_synth_set_allow_inout(_Bool v) {
    synth_set("allow_inout", v);
}
_Bool verilog_synth_get_allow_inout(void) {
    return synth_get("allow_inout") == 1;
}
void verilog_synth_set_allow_multi_driver(_Bool v) {
    synth_set("allow_multi_driver", v);
}
_Bool verilog_synth_get_allow_multi_driver(void) {
    return synth_get("allow_multi_driver") == 1;
}
void verilog_synth_set_optimize_wires(_Bool v) {
    synth_set("optimize_wires", v);
}
_Bool verilog_synth_get_optimize_wires(void) {
    return synth_get("optimize_wires") == 1;
}
void verilog_synth_set_optimize_mul2(_Bool v) {
    synth_set("optimize_mul2", v);
}
_Bool verilog_synth_get_optimize_mul2(void) {
    return synth_get("optimize_mul2") == 1;
}
void verilog_synth_set_optimize_adders(_Bool v) {
    synth_set("optimize_adders", v);
}
_Bool verilog_synth_get_optimize_adders(void) {
    return synth_get("optimize_adders") == 1;
}
void verilog_synth_set_loop_unroll_limit(size_t n) {
    synth_set("loop_unroll_limit", (long)n);
}
size_t verilog_synth_get_loop_unroll_limit(void) {
    long v = synth_get("loop_unroll_limit");
    return v < 0 ? 0 : (size_t)v;
}

int circuit_sample_digital_state_u8(
    void* c, size_t* vec_pos, size_t* chunk_pos, size_t comp_size,
    double* voltage, size_t* voltage_ord, double* current,
    size_t* current_ord, unsigned char* digital, size_t* digital_ord) {
    (void)vec_pos;
    (void)chunk_pos;
    return sample_impl(c, voltage, voltage_ord, current, current_ord,
                       digital, digital_ord, comp_size, 1);
}

/* -- verilog runtime ------------------------------------------------------- */

void* verilog_runtime_create(char const* src, size_t src_size,
                             char const* top, size_t top_size,
                             char const* const* include_dirs,
                             size_t const* include_dir_sizes,
                             size_t include_dir_count) {
    (void)include_dirs;
    (void)include_dir_sizes;
    (void)include_dir_count;
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* r = call("verilog_runtime_create", Py_BuildValue(
        "(s#s#)", src, (Py_ssize_t)src_size, top ? top : "",
        (Py_ssize_t)(top ? top_size : 0)));
    PyGILState_Release(g);
    return (void*)r;
}

void verilog_runtime_destroy(void* rt) {
    if (rt != NULL) {
        PyGILState_STATE g = PyGILState_Ensure();
        Py_DECREF((PyObject*)rt);
        PyGILState_Release(g);
    }
}

int verilog_runtime_tick(void* rt) {
    return call_int("verilog_runtime_tick", "(O)", (PyObject*)rt);
}

int verilog_runtime_reset(void* rt) {
    return call_int("verilog_runtime_reset", "(O)", (PyObject*)rt);
}

size_t verilog_runtime_port_count(void* rt) {
    int n = call_int("verilog_runtime_port_count", "(O)", (PyObject*)rt);
    return n < 0 ? 0 : (size_t)n;
}

size_t verilog_runtime_signal_count(void* rt) {
    int n = call_int("verilog_runtime_signal_count", "(O)", (PyObject*)rt);
    return n < 0 ? 0 : (size_t)n;
}

static int copy_str(const char* fn, void* rt, size_t idx, char* out,
                    size_t out_size, int with_idx) {
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* r = call(fn, with_idx
                       ? Py_BuildValue("(On)", (PyObject*)rt,
                                       (Py_ssize_t)idx)
                       : Py_BuildValue("(O)", (PyObject*)rt));
    int rc = -1;
    if (r != NULL) {
        const char* s = PyUnicode_AsUTF8(r);
        if (s != NULL && out != NULL) {
            strncpy(out, s, out_size);
            if (out_size) { out[out_size - 1] = 0; }
            rc = (int)strlen(s);
        }
        Py_DECREF(r);
    }
    PyGILState_Release(g);
    return rc;
}

static size_t str_size(const char* fn, void* rt, size_t idx,
                       int with_idx) {
    /* byte length of a glue-returned string (for the *_name_size /
     * preprocessed_size introspection family) */
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* r = call(fn, with_idx
                       ? Py_BuildValue("(On)", (PyObject*)rt,
                                       (Py_ssize_t)idx)
                       : Py_BuildValue("(O)", (PyObject*)rt));
    size_t n = 0;
    if (r != NULL) {
        Py_ssize_t sz = 0;
        if (PyUnicode_AsUTF8AndSize(r, &sz) != NULL) {
            n = (size_t)sz;
        }
        Py_DECREF(r);
    }
    PyGILState_Release(g);
    return n;
}

int verilog_runtime_copy_port_name(void* rt, size_t i, char* out,
                                   size_t out_size) {
    return copy_str("verilog_runtime_port_name", rt, i, out,
                    out_size, 1);
}

size_t verilog_runtime_port_name_size(void* rt, size_t i) {
    return str_size("verilog_runtime_port_name", rt, i, 1);
}

size_t verilog_runtime_top_module_name_size(void* rt) {
    return str_size("verilog_runtime_top_module_name", rt, 0, 0);
}

size_t verilog_runtime_module_count(void* rt) {
    int n = call_int("verilog_runtime_module_count", "(O)",
                     (PyObject*)rt);
    return n < 0 ? 0 : (size_t)n;
}

size_t verilog_runtime_module_name_size(void* rt, size_t i) {
    return str_size("verilog_runtime_module_name", rt, i, 1);
}

int verilog_runtime_copy_module_name(void* rt, size_t i, char* out,
                                     size_t out_size) {
    return copy_str("verilog_runtime_module_name", rt, i, out,
                    out_size, 1);
}

size_t verilog_runtime_signal_name_size(void* rt, size_t i) {
    return str_size("verilog_runtime_signal_name", rt, i, 1);
}

int verilog_runtime_copy_signal_name(void* rt, size_t i, char* out,
                                     size_t out_size) {
    return copy_str("verilog_runtime_signal_name", rt, i, out,
                    out_size, 1);
}

size_t verilog_runtime_preprocessed_size(void* rt) {
    return str_size("verilog_runtime_preprocessed", rt, 0, 0);
}

int verilog_runtime_copy_preprocessed(void* rt, char* out,
                                      size_t out_size) {
    return copy_str("verilog_runtime_preprocessed", rt, 0, out,
                    out_size, 0);
}

unsigned long long verilog_runtime_get_tick(void* rt) {
    int n = call_int("verilog_runtime_get_tick", "(O)", (PyObject*)rt);
    return n < 0 ? 0 : (unsigned long long)n;
}

int verilog_runtime_step(void* rt, unsigned long long tick,
                         unsigned char process_sequential) {
    return call_int("verilog_runtime_step", "(OKb)", (PyObject*)rt,
                    tick, process_sequential);
}

unsigned char verilog_runtime_get_signal_value(void* rt, size_t i) {
    /* multi-bit signals report their integer value truncated to u8;
     * an unknown value falls back to the 1-bit 4-state code */
    int v = call_int("verilog_runtime_get_signal_value", "(On)",
                     (PyObject*)rt, (Py_ssize_t)i);
    if (v < 0) {
        phy_engine_clear_error();
        v = call_int("verilog_runtime_get_signal_state", "(On)",
                     (PyObject*)rt, (Py_ssize_t)i);
    }
    return v < 0 ? 2 : (unsigned char)v;
}

int verilog_runtime_set_signal_value(void* rt, size_t i,
                                     unsigned char state) {
    return call_int("verilog_runtime_set_signal_value", "(Onb)",
                    (PyObject*)rt, (Py_ssize_t)i, state);
}

int verilog_runtime_copy_top_module_name(void* rt, char* out,
                                         size_t out_size) {
    return copy_str("verilog_runtime_top_module_name", rt, 0, out,
                    out_size, 0);
}

unsigned char verilog_runtime_port_dir(void* rt, size_t i) {
    int d = call_int("verilog_runtime_port_dir", "(On)", (PyObject*)rt, (Py_ssize_t)i);
    return d < 0 ? 0 : (unsigned char)d;
}

unsigned char verilog_runtime_get_port_value(void* rt, size_t i) {
    /* multi-bit ports report their integer value truncated to u8; an
     * unknown value falls back to the 1-bit 4-state code (X=2) */
    int v = call_int("verilog_runtime_get_port_value", "(On)", (PyObject*)rt, (Py_ssize_t)i);
    if (v < 0) {
        phy_engine_clear_error();
        v = call_int("verilog_runtime_get_port_state", "(On)", (PyObject*)rt, (Py_ssize_t)i);
    }
    return v < 0 ? 2 : (unsigned char)v;
}

int verilog_runtime_set_port_value(void* rt, size_t i,
                                   unsigned char state) {
    return call_int("verilog_runtime_set_port_value", "(Onb)", (PyObject*)rt, (Py_ssize_t)i, state);
}

/* -- PhysicsLab experiment handles (dll_api.h:318-443) -------------------- */

static void* call_handle(const char* fn, const char* fmt, ...) {
    PyGILState_STATE g = PyGILState_Ensure();
    va_list ap;
    va_start(ap, fmt);
    PyObject* args = Py_VaBuildValue(fmt, ap);
    va_end(ap);
    PyObject* r = call(fn, args);
    PyGILState_Release(g);
    return (void*)r;                      /* strong reference or NULL */
}

static char* call_strdup(const char* fn, const char* fmt, ...) {
    PyGILState_STATE g = PyGILState_Ensure();
    va_list ap;
    va_start(ap, fmt);
    PyObject* args = Py_VaBuildValue(fmt, ap);
    va_end(ap);
    PyObject* r = call(fn, args);
    char* out = NULL;
    if (r != NULL) {
        const char* s = PyUnicode_AsUTF8(r);
        if (s != NULL) { out = strdup(s); }
        Py_DECREF(r);
    }
    PyGILState_Release(g);
    return out;                           /* phy_engine_string_free() */
}

static void handle_destroy(void* h) {
    if (h != NULL) {
        PyGILState_STATE g = PyGILState_Ensure();
        Py_DECREF((PyObject*)h);
        PyGILState_Release(g);
    }
}

void* pl_experiment_create(int type_value) {
    return call_handle("pl_experiment_create", "(i)", type_value);
}

void* pl_experiment_load_from_string(char const* sav_json,
                                     size_t sav_json_size) {
    return call_handle("pl_experiment_load_from_string", "(s#)",
                       sav_json, (Py_ssize_t)sav_json_size);
}

void* pl_experiment_load_from_file(char const* path,
                                   size_t path_size) {
    return call_handle("pl_experiment_load_from_file", "(s#)", path,
                       (Py_ssize_t)path_size);
}

void pl_experiment_destroy(void* ex) { handle_destroy(ex); }

char* pl_experiment_dump(void* ex, int indent) {
    return call_strdup("pl_experiment_dump", "(Oi)", (PyObject*)ex,
                       indent);
}

int pl_experiment_save(void* ex, char const* path, size_t path_size,
                       int indent) {
    return call_int("pl_experiment_save", "(Os#i)", (PyObject*)ex,
                    path, (Py_ssize_t)path_size, indent);
}

char* pl_experiment_add_circuit_element(void* ex, char const* model_id,
                                        size_t model_id_size, double x,
                                        double y, double z,
                                        unsigned char element_xyz,
                                        unsigned char is_big,
                                        unsigned char in_layout) {
    return call_strdup("pl_experiment_add_circuit_element",
                       "(Os#dddiii)", (PyObject*)ex, model_id,
                       (Py_ssize_t)model_id_size, x, y, z,
                       (int)element_xyz, (int)is_big, (int)in_layout);
}

int pl_experiment_connect(void* ex, char const* src_id,
                          size_t src_id_size, int src_pin,
                          char const* dst_id, size_t dst_id_size,
                          int dst_pin, int color_value) {
    return call_int("pl_experiment_connect", "(Os#is#ii)",
                    (PyObject*)ex, src_id, (Py_ssize_t)src_id_size,
                    src_pin, dst_id, (Py_ssize_t)dst_id_size, dst_pin,
                    color_value);
}

int pl_experiment_clear_wires(void* ex) {
    return call_int("pl_experiment_clear_wires", "(O)", (PyObject*)ex);
}

size_t pl_experiment_element_count(void* ex) {
    int n = call_int("pl_experiment_element_count", "(O)",
                     (PyObject*)ex);
    return n < 0 ? 0 : (size_t)n;
}

int pl_experiment_set_xyz_precision(void* ex, int decimals) {
    return call_int("pl_experiment_set_xyz_precision", "(Oi)",
                    (PyObject*)ex, decimals);
}

int pl_experiment_set_element_xyz(void* ex, unsigned char enabled,
                                  double ox, double oy, double oz) {
    return call_int("pl_experiment_set_element_xyz", "(Oiddd)",
                    (PyObject*)ex, (int)enabled, ox, oy, oz);
}

int pl_experiment_set_camera(void* ex, double vx, double vy, double vz,
                             double rx, double ry, double rz) {
    return call_int("pl_experiment_set_camera", "(Odddddd)",
                    (PyObject*)ex, vx, vy, vz, rx, ry, rz);
}

int pl_experiment_set_element_property_number(
    void* ex, char const* element_id, size_t element_id_size,
    char const* key, size_t key_size, double value) {
    return call_int("pl_experiment_set_element_property_number",
                    "(Os#s#d)", (PyObject*)ex, element_id,
                    (Py_ssize_t)element_id_size, key,
                    (Py_ssize_t)key_size, value);
}

int pl_experiment_set_element_label(void* ex, char const* element_id,
                                    size_t element_id_size,
                                    char const* label,
                                    size_t label_size) {
    return call_int("pl_experiment_set_element_label", "(Os#s#)",
                    (PyObject*)ex, element_id,
                    (Py_ssize_t)element_id_size, label,
                    (Py_ssize_t)label_size);
}

int pl_experiment_set_element_position(void* ex,
                                       char const* element_id,
                                       size_t element_id_size,
                                       double x, double y, double z,
                                       unsigned char coords) {
    return call_int("pl_experiment_set_element_position", "(Os#dddi)",
                    (PyObject*)ex, element_id,
                    (Py_ssize_t)element_id_size, x, y, z, (int)coords);
}

int pl_experiment_merge(void* dst, void* src, double ox, double oy,
                        double oz) {
    return call_int("pl_experiment_merge", "(OOddd)", (PyObject*)dst,
                    (PyObject*)src, ox, oy, oz);
}

int pl_experiment_auto_layout(void* ex, double c0x, double c0y,
                              double c0z, double c1x, double c1y,
                              double c1z, double z_fixed,
                              int backend_value, int mode_value,
                              double step_x, double step_y,
                              double margin_x, double margin_y,
                              size_t* out_grid_w, size_t* out_grid_h,
                              size_t* out_fixed_obstacles,
                              size_t* out_placed,
                              size_t* out_skipped) {
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* r = call("pl_experiment_auto_layout", Py_BuildValue(
        "(Odddddddiidddd)", (PyObject*)ex, c0x, c0y, c0z, c1x, c1y,
        c1z, z_fixed, backend_value, mode_value, step_x, step_y,
        margin_x, margin_y));
    int rc = -1;
    if (r != NULL && PyList_Check(r) && PyList_Size(r) == 5) {
        size_t* outs[5] = {out_grid_w, out_grid_h,
                           out_fixed_obstacles, out_placed,
                           out_skipped};
        for (int i = 0; i < 5; ++i) {
            if (outs[i] != NULL) {
                outs[i][0] = PyLong_AsSize_t(PyList_GET_ITEM(r, i));
            }
        }
        rc = 0;
    }
    Py_XDECREF(r);
    PyGILState_Release(g);
    return rc;
}

/* -- PhysicsLab -> PE simulation handle ----------------------------------- */

void* pl_pe_circuit_build(void* ex) {
    return call_handle("pl_pe_circuit_build", "(O)", (PyObject*)ex);
}

void pl_pe_circuit_destroy(void* h) { handle_destroy(h); }

size_t pl_pe_circuit_comp_size(void* h) {
    int n = call_int("pl_pe_circuit_comp_size", "(O)", (PyObject*)h);
    return n < 0 ? 0 : (size_t)n;
}

int pl_pe_circuit_set_analyze_type(void* h, unsigned at) {
    return call_int("pl_pe_circuit_set_analyze_type", "(OI)",
                    (PyObject*)h, at);
}

int pl_pe_circuit_set_tr(void* h, double t_step, double t_stop) {
    return call_int("pl_pe_circuit_set_tr", "(Odd)", (PyObject*)h,
                    t_step, t_stop);
}

int pl_pe_circuit_set_ac_omega(void* h, double omega) {
    return call_int("pl_pe_circuit_set_ac_omega", "(Od)", (PyObject*)h,
                    omega);
}

int pl_pe_circuit_analyze(void* h) {
    return call_int("pl_pe_circuit_analyze", "(O)", (PyObject*)h);
}

int pl_pe_circuit_digital_clk(void* h) {
    return call_int("pl_pe_circuit_digital_clk", "(O)", (PyObject*)h);
}

int pl_pe_circuit_sync_inputs_from_pl(void* h, void* ex) {
    return call_int("pl_pe_circuit_sync_inputs_from_pl", "(OO)",
                    (PyObject*)h, (PyObject*)ex);
}

int pl_pe_circuit_write_back_to_pl(void* h, void* ex) {
    return call_int("pl_pe_circuit_write_back_to_pl", "(OO)",
                    (PyObject*)h, (PyObject*)ex);
}

int pl_pe_circuit_write_back_to_pl_ex(void* h, void* ex, double lo,
                                      double hi, double x, double z) {
    return call_int("pl_pe_circuit_write_back_to_pl_ex", "(OOdddd)",
                    (PyObject*)h, (PyObject*)ex, lo, hi, x, z);
}

static PyObject* plpe_circuit_attr(void* h) {
    /* borrowed handle -> new ref to its .circuit for sample reuse */
    return PyObject_GetAttrString((PyObject*)h, "circuit");
}

int pl_pe_circuit_sample_layout(void* h, size_t* voltage_ord,
                                size_t* current_ord,
                                size_t* digital_ord) {
    PyGILState_STATE g = PyGILState_Ensure();
    size_t n = 0;
    PyObject* c = plpe_circuit_attr(h);
    int rc = -1;
    if (c != NULL) {
        PyObject* cc = PyObject_GetAttrString(c, "component_count");
        n = cc ? (size_t)PyLong_AsSize_t(cc) : 0;
        Py_XDECREF(cc);
        rc = circuit_sample_layout((void*)c, NULL, NULL, n,
                                   voltage_ord, current_ord,
                                   digital_ord);
        Py_DECREF(c);
    } else { set_err_from_py(); }
    PyGILState_Release(g);
    return rc;
}

static int plpe_sample(void* h, double* voltage, size_t* voltage_ord,
                       double* current, size_t* current_ord,
                       unsigned char* digital, size_t* digital_ord,
                       int four_state) {
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* c = plpe_circuit_attr(h);
    int rc = -1;
    if (c != NULL) {
        rc = four_state
            ? circuit_sample_digital_state_u8((void*)c, NULL, NULL, 0,
                                              voltage, voltage_ord,
                                              current, current_ord,
                                              digital, digital_ord)
            : circuit_sample_u8((void*)c, NULL, NULL, 0, voltage,
                                voltage_ord, current, current_ord,
                                digital, digital_ord);
        Py_DECREF(c);
    } else { set_err_from_py(); }
    PyGILState_Release(g);
    return rc;
}

int pl_pe_circuit_sample_u8(void* h, double* voltage,
                            size_t* voltage_ord, double* current,
                            size_t* current_ord, unsigned char* digital,
                            size_t* digital_ord) {
    return plpe_sample(h, voltage, voltage_ord, current, current_ord,
                       digital, digital_ord, 0);
}

int pl_pe_circuit_sample_digital_state_u8(
    void* h, double* voltage, size_t* voltage_ord, double* current,
    size_t* current_ord, unsigned char* digital, size_t* digital_ord) {
    return plpe_sample(h, voltage, voltage_ord, current, current_ord,
                       digital, digital_ord, 1);
}

/* -- PE -> PhysicsLab export ---------------------------------------------- */

void* pe_to_pl_convert(void* circuit, double fixed_x, double fixed_y,
                       double fixed_z, unsigned char element_xyz,
                       unsigned char keep_pl_macros,
                       unsigned char include_linear,
                       unsigned char include_ground,
                       unsigned char generate_wires,
                       unsigned char keep_unknown_placeholders,
                       unsigned char drop_dangling_logic_inputs) {
    return call_handle("pe_to_pl_convert", "(Odddiiiiiii)",
                       (PyObject*)circuit, fixed_x, fixed_y, fixed_z,
                       (int)element_xyz, (int)keep_pl_macros,
                       (int)include_linear, (int)include_ground,
                       (int)generate_wires,
                       (int)keep_unknown_placeholders,
                       (int)drop_dangling_logic_inputs);
}
