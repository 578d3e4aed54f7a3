"""The program's own spans and counters in a profiled job, read on the
profiler's clock.

    python3 port_bench/spans.py --workload <cell> --seeds 1,2,3 \
        --out FILE [--sync-debug]

The port opens ``torch.profiler.record_function`` ranges named ``pe.*``
at its layer boundaries whenever a profiler is active
(``phy_engine_tpu_torch/trace.py``), and keeps host-side counters
(``trace.counters()``).  This command sets up the cell once, then for
each seed profiles one job as ``run.py --trace 1`` profiles the window's
first one, and prints one JSON line: the readings below, the existing
per-layer readers on the same trace, the idle time split by what the
host was doing, the traced and an untraced job's seconds, and the
check's numbers for the traced job.  ``--sync-debug`` then runs one more
job under ``torch.cuda.set_sync_debug_mode("warn")`` and lists every
call site that synchronised, by the innermost frame inside the port and
the innermost frame of all.

Readings (``None`` where the trace or the counters hold nothing):

- ``dc_host_syncs_per_sweep``: ``host_syncs`` over the job / steps;
- ``bicgstab_iterations_launched``: ``bicgstab.iterations_launched`` /
  steps;
- ``dc_sync_idle_pct``: device idle in gaps that began while the host
  was inside a ``pe.sync.*`` span, % of the traced job;
- ``dc_matvec_busy_pct``, ``dc_assembly_busy_pct``,
  ``ladder_refine_busy_pct``: device busy time of the operations launched
  under ``pe.coo_matvec``, ``pe.assemble``, ``pe.refine``, % of busy;
- ``ladder_launch_idle_pct``: idle in gaps that began inside another
  ``pe.*`` span (the host launching slower than the device runs), % of
  the traced job.

The functions below work on ``trace.Trace`` as ``trace.reduce`` gives
it, with the spans beside it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PREFIX = "pe."
SYNC = "pe.sync."


def program_spans(events, job: str):
    """(lo, hi) of the range ``job`` and the ``pe.*`` host ranges on the
    thread that opened it, [(name, start_ns, end_ns)] by start."""
    from torch.autograd import DeviceType

    from port_bench.trace import _ns
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    jobs = [e for e in cpu if e.name() == job]
    if not jobs:
        raise RuntimeError(f"the trace holds no {job!r} range")
    s, d = _ns(jobs[0])
    thread = jobs[0].start_thread_id()
    spans = []
    for e in cpu:
        if e.name().startswith(PREFIX) and e.start_thread_id() == thread:
            a, b = _ns(e)
            spans.append((e.name(), a, a + b))
    spans.sort(key=lambda x: (x[1], -x[2]))
    return (s, s + d), spans


def open_at(spans, times):
    """For each time (any order), the names of the spans open then,
    outermost first.  The spans of one thread nest, so one sweep with a
    stack finds them."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [()] * len(times)
    stack, k = [], 0
    for i in order:
        q = times[i]
        while k < len(spans) and spans[k][1] <= q:
            while stack and stack[-1][2] <= spans[k][1]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][2] <= q:
            stack.pop()
        out[i] = tuple(s[0] for s in stack)
    return out


def launch_stacks(events, ops, spans):
    """For each device operation of ``ops``, the program spans open when
    its launching host operator started (``()`` where it has none)."""
    from torch.autograd import DeviceType

    from port_bench.trace import _ns
    start = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and e.correlation_id():
            start[e.correlation_id()] = _ns(e)[0]
    have = [i for i, op in enumerate(ops) if op.owner_id in start]
    stacks = [()] * len(ops)
    for i, st in zip(have, open_at(spans, [start[ops[i].owner_id]
                                           for i in have])):
        stacks[i] = st
    return stacks


def busy_under(ops, stacks, prefix: str) -> int:
    """Device busy time (ns, the union of intervals) of the operations
    (by start) launched while a span whose name starts with ``prefix``
    was open."""
    from port_bench.trace import Trace
    under = [op for op, st in zip(ops, stacks)
             if any(n.startswith(prefix) for n in st)]
    return Trace(window_ns=0, ops=under, steps=0, calls=[]).busy_ns()


def gaps(ops, lo: int, hi: int):
    """[(start, length)] of the device's idle stretches in [lo, hi]: before
    the first operation, between operations, after the last."""
    out, end = [], lo
    for op in ops:
        if op.start_ns > end:
            out.append((end, op.start_ns - end))
        end = max(end, op.start_ns + op.dur_ns)
    if hi > end:
        out.append((end, hi - end))
    return out


def idle_by_host(ops, lo: int, hi: int, spans):
    """The traced job's idle time (ns) by what the host was doing when
    each gap began: ``sync`` (inside a ``pe.sync.*`` span), ``launch``
    (inside another ``pe.*`` span), ``caller`` (outside every program
    span, and the stretches before the first operation and after the
    last), and ``by_span``: {innermost span, or "caller": ns}."""
    g = gaps(ops, lo, hi)
    first = ops[0].start_ns if ops else hi
    last = max((op.start_ns + op.dur_ns for op in ops), default=lo)
    out = {"sync": 0, "launch": 0, "caller": 0, "by_span": Counter()}
    for (s, n), st in zip(g, open_at(spans, [s for s, _n in g])):
        if s < first or s >= last or not st:
            out["caller"] += n
            out["by_span"]["caller"] += n
            continue
        out["sync" if any(x.startswith(SYNC) for x in st)
            else "launch"] += n
        out["by_span"][st[-1]] += n
    return out


def readings(t, lo: int, hi: int, spans, stacks) -> dict:
    """The seven readings of a traced job ``t`` (``trace.Trace``) with its
    spans and each operation's open spans; ``None`` where there is
    nothing to read."""
    steps, cnt = t.steps, t.counters
    out = dict.fromkeys((
        "dc_host_syncs_per_sweep", "bicgstab_iterations_launched",
        "dc_sync_idle_pct", "dc_matvec_busy_pct", "dc_assembly_busy_pct",
        "ladder_launch_idle_pct", "ladder_refine_busy_pct"))
    if steps:
        for name, key in (("dc_host_syncs_per_sweep", "host_syncs"),
                          ("bicgstab_iterations_launched",
                           "bicgstab.iterations_launched")):
            if key in cnt:
                out[name] = cnt[key] / steps
    if not t.ops or not steps or t.window_ns <= 0 or not spans:
        return out
    busy = t.busy_ns()
    idle = idle_by_host(t.ops, lo, hi, spans)
    out["dc_sync_idle_pct"] = 100.0 * idle["sync"] / t.window_ns
    out["ladder_launch_idle_pct"] = 100.0 * idle["launch"] / t.window_ns
    for name, prefix in (("dc_matvec_busy_pct", "pe.coo_matvec"),
                         ("dc_assembly_busy_pct", "pe.assemble"),
                         ("ladder_refine_busy_pct", "pe.refine")):
        out[name] = 100.0 * busy_under(t.ops, stacks, prefix) / busy
    return out


def program_counters() -> dict:
    """The program's counters, or {} where the program keeps none."""
    try:
        from phy_engine_tpu_torch import trace
    except ImportError:
        return {}
    return trace.counters()


class SyncSites:
    """Collects, while active, every synchronising call that the CUDA
    sync debug mode warns of: {(innermost frame in the port, innermost
    frame): count}."""

    def __init__(self):
        self.sites = Counter()

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        stack = [f for f in traceback.extract_stack()[:-1]
                 if not f.filename.endswith("warnings.py")]

        def where(f):
            if f is None:
                return None
            p = Path(f.filename)
            try:
                p = p.relative_to(ROOT)
            except ValueError:
                pass
            return f"{p}:{f.lineno} {f.name}"
        port = [f for f in stack if "phy_engine_tpu_torch" in f.filename]
        self.sites[(where(port[-1] if port else None),
                    where(stack[-1] if stack else None))] += 1

    def run(self, fn, device):
        import torch
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = self._show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize(device)
        return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--sync-debug", action="store_true")
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from torch.profiler import record_function

    from port_bench import check, run, spec
    from port_bench import trace as tr

    run.cache_dirs()
    c = spec.cell(a.workload)
    fam = spec.family(c)
    seeds = [int(x) for x in a.seeds.split(",")]
    t0 = time.perf_counter()
    b = fam.Bench(c, seeds[0], a.device)
    setup_s = time.perf_counter() - t0
    limits = dict(c.cell["check"]["limits"], **{z: 0 for z in fam.ZERO})
    with open(a.out, "a") as f:
        for seed in seeds:
            calls, before = [], program_counters()
            prof = tr.profiler()
            t0 = time.perf_counter()
            with b.marks(calls), prof, record_function(tr.JOB):
                keep, fail = b.job(seed, 0)
                run.sync(b.device)
            traced_s = time.perf_counter() - t0
            after = program_counters()
            t0 = time.perf_counter()
            b.job(seed, 1)
            run.sync(b.device)
            plain_s = time.perf_counter() - t0
            calls = [tuple(int(v) if hasattr(v, "item") else v for v in cl)
                     for cl in calls]
            t = tr.reduce(prof, b.steps, calls)
            t.counters = {k: after[k] - before.get(k, 0) for k in after}
            t.counters["steps"] = b.steps
            events = prof.profiler.kineto_results.events()
            (lo, hi), spans = program_spans(events, tr.JOB)
            stacks = launch_stacks(events, t.ops, spans)
            idle = idle_by_host(t.ops, lo, hi, spans)
            values = b.compare(seed, [run._host(keep)])
            values[fam.FAILED] = int(fail)
            correct, checks = check.verdict(values, limits)
            line = {
                "cell": a.workload, "seed": seed, "setup_s": setup_s,
                "traced_job_s": traced_s, "job_s": plain_s,
                "readings": readings(t, lo, hi, spans, stacks),
                "existing": {n: m.read(t)
                             for n, m in spec.metrics_for(c).items()},
                "ops": len(t.ops), "busy_s": t.busy_ns() * 1e-9,
                "window_s": t.window_ns * 1e-9,
                "idle_s": {k: idle[k] * 1e-9
                           for k in ("sync", "launch", "caller")},
                "idle_by_span_s": [[n, ns * 1e-9] for n, ns in
                                   idle["by_span"].most_common(12)],
                "spans": dict(Counter(s[0] for s in spans)),
                "counters": t.counters, "correct": correct,
                "checks": checks}
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
        if a.sync_debug:
            sites = SyncSites()
            sites.run(lambda: b.job(seeds[0], 2), b.device)
            line = {"cell": a.workload, "sync_sites": [
                [port, inner, n] for (port, inner), n in
                sites.sites.most_common()]}
            f.write(json.dumps(line) + "\n")
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
