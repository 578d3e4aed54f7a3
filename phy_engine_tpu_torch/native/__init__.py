"""Host libraries of the port: the truth-table library (``pe_tt.cpp``)
that the synthesis passes at -O2 and above evaluate gate cones with, the
digital sweep engine (``pe_digital.cpp``) that ``digital/native_run.py``
clocks a design with, and the embeddable C ABI (``pe_capi.c``, which
embeds CPython and calls ``phy_engine_tpu_torch.capi``; :func:`build_capi`).

All are host code, built by ``g++`` / ``cc`` (no nvcc, no card) from
this package's own sources at first use into ``build/phy_engine_tpu_torch/``
at the root of the checkout (listed in ``.gitignore``).  A library's file
name carries a hash of its source and build command and a tag of the
host's CPU (``-march=native`` code runs only where it was built), so an
edited source is rebuilt, an unchanged one reused, and another host builds
its own.  Builds run under a file lock, so concurrent processes build
once.  A failed build raises with the compiler's output; nothing falls
back.

``eval_graph_plain`` / ``rows_equal_plain`` are the numpy row loops of
the same functions, kept beside the library for the tests to hold it
against; no caller takes them in the library's place.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import sysconfig
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "phy_engine_tpu_torch"
# library name -> (source, g++ flags)
LIBS = {
    "pe_tt": ("pe_tt.cpp", ("-O3", "-march=native", "-fopenmp", "-shared",
                            "-fPIC", "-std=c++17")),
    "pe_digital": ("pe_digital.cpp", ("-O3", "-march=native",
                                      "-funroll-loops", "-shared", "-fPIC",
                                      "-std=c++17")),
}
# the C ABI, built by cc against this interpreter (:func:`build_capi`)
CAPI = "pe_capi"
CAPI_SRC = "pe_capi.c"

OP_LEAF, OP_NOT, OP_AND, OP_OR, OP_XOR, OP_CONST0, OP_CONST1 = range(7)

_lock = threading.Lock()
_loaded = {}


def _host_tag() -> str:
    """The CPU this process runs on: machine and ISA flags."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:
        pass
    return hashlib.sha256(f"{platform.machine()} {flags}".encode()
                          ).hexdigest()[:8]


def _source(name: str) -> Path:
    return SRC_DIR / (CAPI_SRC if name == CAPI else LIBS[name][0])


def _command(name: str, out: str) -> list:
    """The compiler command that builds library ``name`` into ``out``.
    The C ABI compiles and links against this interpreter; -Bsymbolic
    binds its calls to its own definitions, never to those of the JAX
    package's library, which exports the same names."""
    if name != CAPI:
        return ["g++", *LIBS[name][1], "-o", out, str(_source(name))]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = (sysconfig.get_config_var("LDVERSION")
           or sysconfig.get_config_var("VERSION"))
    return ["cc", "-O2", "-shared", "-fPIC", "-Wl,-Bsymbolic", "-o", out,
            str(_source(name)), f"-I{sysconfig.get_path('include')}",
            f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-lpython{ver}"]


def library_path(name: str) -> Path:
    """Where library ``name`` of the current source lives (built or not)."""
    h = hashlib.sha256(" ".join(_command(name, "")).encode())
    h.update(_source(name).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}_{_host_tag()}.so"


def build(name: str) -> Path:
    """Compile library ``name`` unless this source is built for this host;
    returns its path.  Raises with the compiler's output on failure."""
    so = library_path(name)
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"lib{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.is_file():                 # another process built it
            return so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = _command(name, tmp)
            try:
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=300)
            except OSError as e:
                raise RuntimeError(f"{cmd[0]} not runnable, {name} cannot be "
                                   f"built: {e}") from e
            if res.returncode != 0:
                raise RuntimeError(f"{cmd[0]} failed ({res.returncode}) "
                                   f"building {name}:\n{' '.join(cmd)}\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


def _declare(name: str, lib) -> None:
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    if name == "pe_tt":
        lib.pe_tt_eval_graph.argtypes = [i32p, i32p, i32p, i32, u64p, i32]
        lib.pe_tt_eval_graph.restype = None
        lib.pe_tt_rows_equal.argtypes = [u64p, u64p, i32, i64, i32]
        lib.pe_tt_rows_equal.restype = i32
    else:
        tab = [i32p] * 5 + [i32]             # op, a, b, o, runs, n_runs
        lib.pe_digital_run.argtypes = [
            i32, i32, i32, u64p,
            *tab, *tab, *tab, *tab,           # cone, narrow, full, cyclic
            i32,                              # fixpoint budget
            *[i32p] * 7, i32,                 # flip-flop rows, segments
            i32p, i32, u32p, u32p,            # forced signals and planes
            u32p, u32p, u64p, u64p, u64p]     # history, scratch
        lib.pe_digital_run.restype = None


def load(name: str) -> ctypes.CDLL:
    """Library ``name`` ("pe_tt" or "pe_digital"), built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _declare(name, lib)
            _loaded[name] = lib
    return lib


def build_capi() -> Path:
    """Build (unless built) the embeddable C ABI library from
    ``pe_capi.c`` and return its path; load it with ``ctypes.CDLL`` and
    call ``phy_engine_init`` first.  Raises on a failed build."""
    return build(CAPI)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# the truth-table library
# ---------------------------------------------------------------------------

def _graph_args(op, f0, f1, words):
    return (np.ascontiguousarray(op, np.int32),
            np.ascontiguousarray(f0, np.int32),
            np.ascontiguousarray(f1, np.int32),
            np.ascontiguousarray(words, dtype=np.uint64))


def eval_graph(op, f0, f1, words: np.ndarray) -> np.ndarray:
    """Evaluate a topologically-ordered gate graph over packed pattern
    words.  ``words`` is (n_nodes, n_words) uint64 with leaf rows
    pre-filled (const rows are filled here).  Returns the same array,
    evaluated in place."""
    op, f0, f1, words = _graph_args(op, f0, f1, words)
    n_nodes, n_words = words.shape
    load("pe_tt").pe_tt_eval_graph(
        _ptr(op, ctypes.c_int32), _ptr(f0, ctypes.c_int32),
        _ptr(f1, ctypes.c_int32), np.int32(n_nodes),
        _ptr(words, ctypes.c_uint64), np.int32(n_words))
    return words


def eval_graph_plain(op, f0, f1, words: np.ndarray) -> np.ndarray:
    """:func:`eval_graph` as a numpy row loop."""
    op, f0, f1, words = _graph_args(op, f0, f1, words)
    for i in range(words.shape[0]):
        o = op[i]
        if o == OP_LEAF:
            continue
        if o == OP_NOT:
            words[i] = ~words[f0[i]]
        elif o == OP_AND:
            words[i] = words[f0[i]] & words[f1[i]]
        elif o == OP_OR:
            words[i] = words[f0[i]] | words[f1[i]]
        elif o == OP_XOR:
            words[i] = words[f0[i]] ^ words[f1[i]]
        elif o == OP_CONST0:
            words[i] = 0
        elif o == OP_CONST1:
            words[i] = ~np.uint64(0)
    return words


def rows_equal(a: np.ndarray, b: np.ndarray, npat: int, neg: bool) -> bool:
    """Whether rows ``a`` and ``b`` (``~b`` when ``neg``) agree on the
    first ``npat`` patterns."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    return bool(load("pe_tt").pe_tt_rows_equal(
        _ptr(a, ctypes.c_uint64), _ptr(b, ctypes.c_uint64),
        np.int32(a.size), np.int64(npat), np.int32(1 if neg else 0)))


def rows_equal_plain(a: np.ndarray, b: np.ndarray, npat: int,
                     neg: bool) -> bool:
    """:func:`rows_equal` in numpy."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    bv = ~b if neg else b
    if npat % 64:
        mask = np.uint64((1 << (npat % 64)) - 1)
        head = bool((a[:-1] == bv[:-1]).all()) if a.size > 1 else True
        return head and bool((a[-1] & mask) == (bv[-1] & mask))
    return bool((a == bv).all())


# ---------------------------------------------------------------------------
# the digital sweep engine
# ---------------------------------------------------------------------------

def _pin_i32(keep, a):
    a = np.ascontiguousarray(a, np.int32)
    keep.append(a)
    return _ptr(a, ctypes.c_int32)


def _table_args(keep, tab, runs):
    op, a, b, o = tab[:4]
    return tuple(_pin_i32(keep, x) for x in (op, a, b, o, runs)) + (
        np.int32(len(runs) - 1),)


def _plan_static_args(plan):
    """The plan's fixed argument tail (int32 tables and their pointers),
    converted once and pinned on the plan."""
    cached = getattr(plan, "_cargs", None)
    if cached is not None:
        return cached
    keep = []
    args = (_table_args(keep, plan.cone, plan.cone_runs),
            _table_args(keep, plan.full, plan.full_runs),
            _table_args(keep, plan.cyc, plan.cyc_seg),
            tuple(_pin_i32(keep, x) for x in (
                plan.ff_d, plan.ff_c, plan.ff_r, plan.ff_q, plan.ff_lc,
                plan.ff_ren, plan.seg)) + (np.int32(len(plan.seg) - 1),))
    plan._cargs = (args, keep)
    return plan._cargs


def digital_run(plan, st, narrow, fsig, FV, FU, HV, HU) -> None:
    """One native call running len(FV) ticks of a ``NativePlan``.

    ``st``: uint64[K] packed state (v | u << 32), updated in place;
    ``narrow``: (op, a, b, o, runs) cone tables for ticks 1..T-1;
    ``HV``/``HU``: (T, S) uint32 history, written."""
    lib = load("pe_digital")
    (cone_a, full_a, cyc_a, ff_a), _pins = _plan_static_args(plan)
    # narrow tables come from plan._narrow_cache (or are plan.full):
    # their pointers are cached by the table object's identity
    ncache = getattr(plan, "_cnarrow", None)
    if ncache is None:
        ncache = plan._cnarrow = {}
    nkey = id(narrow[1])
    nargs = ncache.get(nkey)
    if nargs is None:
        keep = []
        nargs = ncache[nkey] = (_table_args(keep, narrow, narrow[4]), keep)
    keep = []
    fix = int(plan.fix_budget)
    bufs = getattr(plan, "_cbufs", None)
    if bufs is None:
        # scratch the library overwrites before use on every call
        bufs = plan._cbufs = (
            np.zeros(max(1, 6 * plan.max_seg), np.uint64),
            np.zeros(plan.K if fix else 1, np.uint64),
            np.zeros(max(1, plan.max_cyc_seg), np.uint64))
    scratch, snap, cy_tmp = bufs
    lib.pe_digital_run(
        np.int32(plan.K), np.int32(plan.S), np.int32(FV.shape[0]),
        _ptr(st, ctypes.c_uint64),
        *cone_a, *nargs[0], *full_a, *cyc_a,
        np.int32(fix), *ff_a,
        _pin_i32(keep, fsig), np.int32(FV.shape[1]),
        _ptr(FV, ctypes.c_uint32), _ptr(FU, ctypes.c_uint32),
        _ptr(HV, ctypes.c_uint32), _ptr(HU, ctypes.c_uint32),
        _ptr(scratch, ctypes.c_uint64), _ptr(snap, ctypes.c_uint64),
        _ptr(cy_tmp, ctypes.c_uint64))
