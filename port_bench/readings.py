"""Readings that the correctness limits are set from, on the card.

    python3 port_bench/readings.py --workload <cell> --seeds 1,2,3 \
        --jobs N --out FILE

One process: the cell's set-up once, then for each seed a window of N jobs
at the cell's own size, compared with the float64 reference as a run
compares it (the program's reading), and the reference in the next lower
precision put in the program's place on the same answers (the control's
reading).  One JSON line a seed, on standard output and in FILE.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--jobs", type=int, default=1)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from port_bench import run, spec

    run.cache_dirs()
    c = spec.cell(a.workload)
    fam = spec.family(c)
    seeds = [int(x) for x in a.seeds.split(",")]
    b = fam.Bench(c, seeds[0], a.device)
    with open(a.out, "a") as f:
        for seed in seeds:
            w = run.Window(b, seed, 0.0, False, a.jobs)
            t = time.perf_counter()
            values = run.compare(fam, b, w, seed)
            t_ref = time.perf_counter() - t
            control = b.compare(seed, w.kept, control=True)
            line = {"cell": a.workload, "seed": seed, "program": values,
                    "control": control, "job_s": w.job_s, "ref_s": t_ref,
                    "counters": w.counters, "memory_peak": w.memory_peak}
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
