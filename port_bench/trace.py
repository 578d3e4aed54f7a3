"""The traced run: ``torch.profiler`` over one whole job, reduced to what
the per-layer readers need.

A circuit family's wrappers (``marks``) record what its readers need of
the program's calls.  The transient's wrappers around the port's two
Gauss-Jordan entry points and around ``torch.bmm`` record each call's
shapes; a product's
shapes ride in the name of a profiler range around it.  The profiler does
not record shapes itself: that doubles a traced job's time, where the
benchmark's ranges add about a seventh (NVIDIA H100, one job of
ladder255.mc4096).  A device operation belongs to the innermost
profiler range (an ``aten`` operator) that was open on the host when it
was launched.  The port's kernels, launched through ``ctypes`` from its
own CUDA library, reach the trace without that link, so the Gauss-Jordan
kernels are told apart by name and stream order: each call launches
panel, update, panel, update, ..., and the update kernel's template
argument says inverse or solve.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import Counter
from dataclasses import dataclass, field

JOB = "port_bench.job"
GJ_NAMES = {"gj_inverse32": "pe_gj_inverse32", "gj_solve32": "pe_gj_solve32"}
BMM = "port_bench.bmm"                   # range around torch.bmm, + "BxMxKxN"
NAME = 64                                # a kernel's name as an owner
_GJ_UPDATE = re.compile(r"gj_update_kernel<(true|false)>")


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    owner: str               # the launching operator or mark
    owner_id: int            # that operator's call (its correlation id)
    bmm: tuple = None        # (B, m, k, n) when the owner is torch.bmm


@dataclass
class Trace:
    """One traced job and the counters of the whole window."""
    window_ns: int                        # the traced job, host clock
    ops: list                             # [DeviceOp] inside the job, by start
    steps: int                            # the traced job's steps (a solve: 1)
    calls: list                           # [(mark, ...)] the family's marks
    counters: dict = field(default_factory=dict)   # over the window
    kinds: dict = field(default_factory=dict)      # device activity counts

    def busy_ns(self) -> int:
        """Union of the device operations' intervals."""
        busy, end = 0, None
        for op in self.ops:
            s, e = op.start_ns, op.start_ns + op.dur_ns
            if end is None or s >= end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def idle_gaps(self):
        """Idle time before each device operation, by the host operator
        that launched the operation that ended the gap: {name: ns}."""
        out = Counter()
        end = None
        for op in self.ops:
            if end is not None and op.start_ns > end:
                out[op.owner] += op.start_ns - end
            e = op.start_ns + op.dur_ns
            end = e if end is None else max(end, e)
        return out

    def gj_ns(self):
        """Device time of the Gauss-Jordan kernels by function:
        {"inverse": ns, "solve": ns}."""
        out = {"inverse": 0, "solve": 0}
        panel = 0
        for op in self.ops:
            if "gj_panel_kernel" in op.name:
                panel += op.dur_ns
                continue
            m = _GJ_UPDATE.search(op.name)
            if m:
                out["inverse" if m.group(1) == "true" else "solve"] += (
                    panel + op.dur_ns)
                panel = 0
        return out


@contextlib.contextmanager
def marks(calls: list):
    """Wrap the port's Gauss-Jordan entry points as the frozen path calls
    them, recording (kernel entry, B, n) of each call in ``calls``, and
    ``torch.bmm``, opening a range named by its shapes around each call."""
    import torch
    from torch.profiler import record_function
    from phy_engine_tpu_torch.engine import analog

    def wrap(fn, mark):
        def call(A32, *rest):
            calls.append((mark, int(A32.shape[0]), int(A32.shape[1])))
            return fn(A32, *rest)
        return call

    def bmm(a, b, *rest, **kw):
        B, m, k = a.shape
        with record_function(f"{BMM} {B}x{m}x{k}x{b.shape[-1]}"):
            return real_bmm(a, b, *rest, **kw)

    inv, solve, real_bmm = (analog.FROZEN_INVERSES["gj"], analog.gj_solve32,
                            torch.bmm)
    analog.FROZEN_INVERSES["gj"] = wrap(inv, GJ_NAMES["gj_inverse32"])
    analog.gj_solve32 = wrap(solve, GJ_NAMES["gj_solve32"])
    torch.bmm = bmm
    try:
        yield
    finally:
        analog.FROZEN_INVERSES["gj"], analog.gj_solve32 = inv, solve
        torch.bmm = real_bmm


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _ns(e):
    """(start, duration) in ns of a profiler event, on any torch version."""
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.duration_ns()
    return int(e.start_us() * 1000), int(e.duration_us() * 1000)


def kind(name: str) -> str:
    return ("memcpy" if name.startswith("Memcpy") else
            "memset" if name.startswith("Memset") else "kernel")


def reduce(prof, steps: int, calls: list) -> Trace:
    """The device operations inside the traced job's range, each with the
    host operator that launched it.  Device-side copies of host ranges
    (named as the range) are not operations."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    owners, dev, host_names, bmms = {}, [], set(), []
    window = None
    for e in events:
        if e.device_type() == DeviceType.CPU:
            name = e.name()
            host_names.add(name)
            if name == JOB:
                s, d = _ns(e)
                window = (s, s + d)
            elif name.startswith(BMM):
                s, d = _ns(e)
                bmms.append((s, s + d, tuple(
                    int(v) for v in name.split()[-1].split("x"))))
            c = e.correlation_id()
            if c:
                owners[c] = e
        else:
            dev.append(e)
    if window is None:
        raise RuntimeError(f"the trace holds no {JOB!r} range")
    bmms.sort()
    starts = [b[0] for b in bmms]

    def bmm_of(e):
        """The shapes of the benchmark's range around host operator e."""
        s, d = _ns(e)
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and bmms[i][1] >= s + d:
            return bmms[i][2]
        return None

    lo, hi = window
    ops, kinds = [], Counter()
    for e in dev:
        name = e.name()
        if name in host_names:
            kinds["range"] += 1
            continue
        kinds[kind(name)] += 1
        s, d = _ns(e)
        if s + d <= lo or s >= hi:
            continue
        link = e.linked_correlation_id()
        own = owners.get(link)
        # a kernel launched outside the profiler's reach (the port's own
        # CUDA library) has no host operator: it is named by itself
        oname = own.name() if own is not None else name.split("(")[0][:NAME]
        ops.append(DeviceOp(
            name=name, start_ns=max(s, lo), dur_ns=min(s + d, hi) - max(s, lo),
            owner=oname, owner_id=link,
            bmm=bmm_of(own) if oname == "aten::bmm" else None))
    ops.sort(key=lambda o: o.start_ns)
    return Trace(window_ns=hi - lo, ops=ops, steps=steps,
                 calls=list(calls), kinds=dict(kinds))
