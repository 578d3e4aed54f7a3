"""Build and load the hand-written CUDA kernels of ``csrc/``.

``nvcc`` compiles each source of ``csrc/`` (``gj.cu``, ``lu_block.cu``,
``turbo.cu``, ``coo_spmm.cu``, ``tridiag_part.cu``) for Hopper
(``sm_90a``), one process per source, all started together, and links
the objects into one shared library with a plain C interface, which
``ctypes`` loads — no PyTorch headers, so the build takes seconds.
The library is written, at first use, to ``build/phy_engine_tpu_torch/``
at the root of the checkout (listed in ``.gitignore``), named by a hash
of the sources and flags so an edited source is rebuilt and an unchanged
one is reused.  ``ptxas``'s report (registers, shared memory, spills of
every kernel) is kept beside it as ``<library>.ptxas.txt``.

:func:`load_library` raises when there is no CUDA device or no
``nvcc``; it never returns a stand-in.  :func:`launcher` is the only way
the wrappers call the library: it makes the device current, takes its
stream once for a run of launches, and turns a CUDA error code into an
exception.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("gj.cu", "lu_block.cu", "turbo.cu", "coo_spmm.cu",
           "tridiag_part.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "phy_engine_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIB = None


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.is_file():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "phy_engine_tpu_torch cannot be built")
    return nvcc


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library of the current sources lives (built or not)."""
    return BUILD_DIR / f"libpe_kernels_{_source_hash()}.so"


def build() -> Path:
    """Compile the kernels (if this source hash is not built yet) and
    return the shared library's path."""
    so = library_path()
    if so.is_file():
        return so
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs, procs = [], []
        for name in SOURCES:
            obj = tmp / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(str(obj))
        logs = [proc.communicate()[0] for _cmd, proc in procs]
        for (cmd, proc), out in zip(procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        lib = tmp / "lib.so"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib), *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        Path(str(so) + ".ptxas.txt").write_text("".join(logs))
        os.replace(lib, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use.  Raises without CUDA."""
    global _LIB
    if _LIB is not None:
        return _LIB
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CUDA kernels of "
                           "phy_engine_tpu_torch cannot run here")
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pe_gj_solve32.argtypes = [p] * 10 + [i, i, p]
    lib.pe_gj_solve32.restype = i
    lib.pe_gj_inverse32.argtypes = [p] * 8 + [i, i, p]
    lib.pe_gj_inverse32.restype = i
    lib.pe_lu_block_inverse32.argtypes = [p] * 5 + [i, i, p]
    lib.pe_lu_block_inverse32.restype = i
    lib.pe_lu_block_panel_floats.argtypes = [i, i]
    lib.pe_lu_block_panel_floats.restype = ctypes.c_longlong
    lib.pe_turbo_smem_limit.argtypes = []
    lib.pe_turbo_smem_limit.restype = i
    lib.pe_turbo_shared_bytes.argtypes = [i] * 2
    lib.pe_turbo_shared_bytes.restype = ctypes.c_longlong
    lib.pe_turbo_run.argtypes = [p] * 12 + [i] * 12 + [p]
    lib.pe_turbo_run.restype = i
    ll = ctypes.c_longlong
    for fn in (lib.pe_coo_spmm64, lib.pe_coo_spmm32):
        fn.argtypes = [p] * 4 + [ll, p, ll, p] + [i] * 4 + [p]
        fn.restype = i
    lib.pe_tridiag_part_factor64.argtypes = [p] * 3 + [i] + [p] * 8
    lib.pe_tridiag_part_direct_factor64.argtypes = [p] * 3 + [i] + [p] * 4
    lib.pe_tridiag_part_reduce64.argtypes = [p, p, i, i] + [p] * 7
    lib.pe_tridiag_part_expand64.argtypes = [p, p, i, i] + [p] * 7
    lib.pe_tridiag_part_direct64.argtypes = [p, p, i, i] + [p] * 5
    lib.pe_tridiag_part_factor_lanes64.argtypes = [p] * 3 + [i, i] + [p] * 8
    lib.pe_tridiag_part_direct_factor_lanes64.argtypes = (
        [p] * 3 + [i, i] + [p] * 4)
    lib.pe_tridiag_part_reduce_lanes64.argtypes = [p, p, i, i, i, ll] + [p] * 7
    lib.pe_tridiag_part_expand_lanes64.argtypes = [p, p, i, i, i, ll] + [p] * 7
    lib.pe_tridiag_part_direct_lanes64.argtypes = [p, p, i, i, i, ll] + [p] * 5
    for fn in (lib.pe_tridiag_part_factor64,
               lib.pe_tridiag_part_direct_factor64,
               lib.pe_tridiag_part_reduce64, lib.pe_tridiag_part_expand64,
               lib.pe_tridiag_part_direct64,
               lib.pe_tridiag_part_factor_lanes64,
               lib.pe_tridiag_part_direct_factor_lanes64,
               lib.pe_tridiag_part_reduce_lanes64,
               lib.pe_tridiag_part_expand_lanes64,
               lib.pe_tridiag_part_direct_lanes64):
        fn.restype = i
    lib.pe_cuda_error_string.argtypes = [i]
    lib.pe_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


class Launch:
    """The library's calls on one device: ``launch(fn, *args)`` passes a
    tensor as its data pointer, appends the stream and raises on a CUDA
    error; ``launch.query(fn, *args)`` is a host-side call that returns a
    count, or minus a CUDA error code, which raises."""

    def __init__(self, lib, stream):
        self.lib, self.stream = lib, stream

    def _raise(self, fn, err):
        raise RuntimeError(f"{fn} failed: CUDA error {err} "
                           f"({self.lib.pe_cuda_error_string(err).decode()})")

    def __call__(self, fn, *args):
        err = getattr(self.lib, fn)(*[a.data_ptr() if torch.is_tensor(a)
                                      else a for a in args], self.stream)
        if err != 0:
            self._raise(fn, err)

    def query(self, fn, *args):
        v = getattr(self.lib, fn)(*args)
        if v < 0:
            self._raise(fn, -v)
        return v


@contextlib.contextmanager
def launcher(device):
    """A :class:`Launch` for a run of calls on ``device``, made current,
    and its current stream, taken once for the run (taken a launch, they
    cost ~18 us of the host's time each, which the device waits out where
    the launches are small: 0.3 ms of a ladder sweep's 6.6, measured on an
    H100)."""
    lib = load_library()
    with torch.cuda.device(device):
        yield Launch(lib, ctypes.c_void_p(
            torch.cuda.current_stream(device).cuda_stream))
