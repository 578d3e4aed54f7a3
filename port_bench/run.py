"""Benchmark of the PyTorch and CUDA port (``phy_engine_tpu_torch``).

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One process on one card, in this order: set-up (import the port, build the
cell's circuit and lower it, warm up, which builds the port's kernels on a
checkout's first run), then a closed loop of jobs for ``--seconds``, one
after another, then the correctness check against the plain reference,
then one JSON line on standard output.  ``--trace 1`` runs the first job
of the window under ``torch.profiler`` and reports the per-layer metrics
in place of the end-to-end ones.

The cell (``cells/<workload>.json``) names its configuration and traffic
mix, and the configuration its circuit family (``circuits/``), which says
what a job is and how it is checked; see ``spec.py``.  Caches of the
program live under ``build/`` in the checkout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "phy_engine_tpu", "__graft_entry__")
NAME_CHARS = 96             # a kernel's name as the breakdown gives it


def forbidden_loaded():
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``phy_engine_tpu_torch`` is not ``phy_engine_tpu``)."""
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def cache_dirs():
    """Fixed cache directories inside the checkout."""
    base = ROOT / "build" / "port_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _host(kept):
    """A job's kept answers on the host: a tensor, or a tuple of them."""
    if isinstance(kept, tuple):
        return tuple(_host(k) for k in kept)
    return kept.cpu().numpy()


class Window:
    """A closed loop of jobs for ``seconds`` (at least one job): the
    rate's work and time, the counters, the kept answers and, when
    traced, the first job's trace."""

    def __init__(self, b, seed: int, seconds: float, traced: bool,
                 min_jobs: int = 1):
        import torch

        from port_bench import trace as tr

        before = b.counters()
        kept, fails, self.job_s = [], [], []
        prof, calls = None, []
        jobs = 0
        t_start = t_end = time.perf_counter()
        while True:
            if traced and jobs == 0:
                from torch.profiler import record_function
                prof = tr.profiler()
                with b.marks(calls), prof, record_function(tr.JOB):
                    keep, fail = b.job(seed, jobs)
                    sync(b.device)
            else:
                keep, fail = b.job(seed, jobs)
            kept.append(keep)
            fails.append(fail)
            sync(b.device)
            jobs += 1
            t_prev, t_end = t_end, time.perf_counter()
            self.job_s.append(t_end - t_prev)
            if t_end - t_start >= seconds and jobs >= min_jobs:
                break
        self.jobs, self.seconds = jobs, t_end - t_start
        self.work = jobs * b.work
        after = b.counters()
        self.counters = {k: after[k] - before[k] for k in after}
        self.counters["steps"] = jobs * b.steps
        self.memory_peak = (torch.cuda.max_memory_allocated(b.device)
                            if torch.device(b.device).type == "cuda" else 0)
        self.kept = [_host(k) for k in kept]
        self.failed = int(sum(int(f) for f in fails))
        self.trace = None
        if traced:
            calls = [tuple(int(v) if hasattr(v, "item") else v for v in call)
                     for call in calls]
            self.trace = tr.reduce(prof, b.steps, calls)
            self.trace.counters = self.counters
        if torch.device(b.device).type == "cuda":
            torch.cuda.empty_cache()


def compare(fam, b, w: Window, seed: int) -> dict:
    """The numbers compared: the window's answers against the float64
    reference, and the program's count of failures."""
    values = b.compare(seed, w.kept)
    values[fam.FAILED] = w.failed
    return values


def bench(c, seed: int, seconds: float, traced: bool, device="cuda"):
    """Set up, warm up, run the window and check it; returns the result's
    fields (without the device's name).  ``c`` is a ``spec.Cell``."""
    from port_bench import check, spec

    fam = spec.family(c)
    b = fam.Bench(c, seed, device)
    setup_s = time.perf_counter() - T0
    w = Window(b, seed, seconds, traced)
    print(f"jobs {w.jobs} window {w.seconds!r} s, each {w.job_s!r}",
          file=sys.stderr, flush=True)
    out = {"attempted": w.jobs * b.answers, "failed": w.failed,
           "memory_peak_bytes": int(w.memory_peak)}
    if traced:
        t = w.trace
        out["metrics"] = {}
        for name, m in spec.metrics_for(c).items():
            v = m.read(t)
            if v is not None:
                out["metrics"][name] = {"value": v, "unit": m.UNIT}
        out["busy_s"] = t.busy_ns() * 1e-9
        out["traced_s"] = t.window_ns * 1e-9
        out["breakdown"] = breakdown(t)
        print(f"trace kinds {t.kinds!r}", file=sys.stderr, flush=True)
    else:
        rate, unit = fam.RATE
        out["metrics"] = {rate: {"value": w.work / w.seconds, "unit": unit},
                          "setup_s": {"value": setup_s, "unit": "s"}}
    values = compare(fam, b, w, seed)
    limits = dict(c.cell["check"]["limits"], **{z: 0 for z in fam.ZERO})
    out["correct"], out["checks"] = check.verdict(values, limits)
    return out


def breakdown(t):
    """The ten device operations that took most time, and the ten longest
    idle stretches by the host operator the device waited for."""
    by_name = Counter()
    for op in t.ops:
        by_name[op.name[:NAME_CHARS]] += op.dur_ns
    gaps = t.idle_gaps()

    def top(counts):
        return [[n, ns * 1e-9] for n, ns in counts.most_common(10)]
    return {"device_ops": top(by_name), "idle_gaps": top(gaps)}


def result_line(out: dict, traced: bool, platform: str, kind: str,
                count: int) -> dict:
    """The last line's object; the numbers compared come last."""
    device = {"platform": platform, "kind": kind, "count": count,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if traced:
        device.update(busy_s=out["busy_s"], window_s=out["traced_s"])
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if traced:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    return result


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    from port_bench import check, spec
    c = spec.cell(a.workload)

    import torch
    need = int(c.cell["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"port_bench: the cell needs {need} CUDA device(s), found "
              f"{have}", file=sys.stderr)
        return 2

    out = bench(c, a.seed, a.seconds, bool(a.trace), "cuda")
    found = forbidden_loaded()
    if found:
        print(f"port_bench: modules that must not load were loaded: {found}",
              file=sys.stderr)
        return 3
    print(f"card {power_limit()}", file=sys.stderr)
    result = result_line(out, bool(a.trace), "gpu",
                         torch.cuda.get_device_name(0), need)
    check.say(out["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
