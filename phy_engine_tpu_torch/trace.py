"""The port's program spans and counters.

* ``span(name)`` marks a stretch of the host's work.  Under an active
  ``torch.profiler`` session it is a ``record_function`` range, so it
  lands on the profiler's timeline, on the same clock as the CUDA
  activity: every device operation and every idle stretch of the device
  can be set against what the host was doing then.  With no profiler it
  is one cheap check and a shared no-op context.  Spans are on exactly
  when someone profiles; there is no switch.
* ``count(name, n)`` adds to a host-side integer counter (always on; it
  never reads a tensor).  ``counters()`` is a snapshot of every counter,
  together with the launch counters of the hand-written kernels'
  wrappers (``gj_solve32``, ``gj_inverse32``, ``lu_block_inverse32``,
  ``run_turbo``, ``coo_spmm``, ``tridiag_part64``), which stay attributes
  of their wrappers: each wrapper registers itself with
  ``@kernel_wrapper`` when its module is imported, so this module
  imports none of them.
* ``host_read(t, site)`` is an explicit read of the device (what
  ``t.tolist()``, ``bool(t)`` or ``t.item()`` return) inside the span
  ``pe.sync.<site>``, counted in ``host_syncs``; ``sync_site(site)`` is
  the same span and count around any other call that waits for the
  device (a copy from pageable host memory, a scalar written into a
  tensor).  The count is of sites passed: on a CUDA tensor each waits
  for the device, on a CPU tensor none does.

Spans at the layer boundaries (nested as the host's calls):
``pe.newton_solve`` > ``pe.assemble``, ``pe.bicgstab`` >
``pe.bicgstab.burst`` > ``pe.coo_matvec``, ``pe.chain_apply``,
``pe.sync.*``; ``pe.bicgstab`` > ``pe.chain_factor``,
``pe.bicgstab.escalate`` (the chain preconditioner's pass after Jacobi
failed); ``pe.border_solve`` > ``pe.tridiag_part`` (the partitioned
solve's factor and first two solves), ``pe.refine`` > ``pe.tridiag_part``;
``pe.chain_factor`` and ``pe.chain_apply`` > ``pe.tridiag_part`` (the
chain's band in float64); ``pe.pcr`` (``tridiag_solve``).  Counters: ``host_syncs``; ``bicgstab.iterations_launched`` (iterations that every
lane of a BiCGStab call ran on the device, stopped lanes included);
``bicgstab.escalations`` (Jacobi solves that failed and ran again with
the chain preconditioner); ``chain.factors``, ``chain.applies``.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from collections import Counter

import torch

_NULL = contextlib.nullcontext()
_COUNTS: Counter = Counter()
_LOCK = threading.Lock()
_KERNELS: list = []
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``record_function`` range under an active profiler, else a
    shared no-op context."""
    if not _profiling():
        return _NULL
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[name] += n


def kernel_wrapper(fn):
    """Decorator: ``fn`` is a hand-written kernel's wrapper, which adds
    its launches to ``fn.launches`` (0 here); ``counters()`` reports it."""
    fn.launches = 0
    _KERNELS.append(fn)
    return fn


def counters() -> dict:
    """{name: count} of every counter, and the registered wrappers'
    launches as ``<wrapper>.launches``."""
    with _LOCK:
        out = dict(_COUNTS)
    for fn in _KERNELS:
        out[f"{fn.__name__}.launches"] = fn.launches
    return out


def sync_site(site: str):
    """Span ``pe.sync.<site>`` and one ``host_syncs`` around a call that
    waits for the device."""
    count("host_syncs")
    return span(f"pe.sync.{site}")


def host_read(t: torch.Tensor, site: str):
    """``t.tolist()`` (a Python scalar for a 0-d tensor: what ``bool``,
    ``int`` or ``.item()`` give) inside ``sync_site(site)``."""
    with sync_site(site):
        return t.tolist()
