"""The traffic generator: jobs drawn from the seed.

A traffic mix (``traffic/<name>.json``) fixes what a job is.  For a
Monte-Carlo transient: the lanes of a job, the transient's steps and step
size, the lognormal jitter of each element kind and any change to the
drive; job j of a run with seed s draws its lanes from
``numpy.random.default_rng`` seeded with (s, 0, j).  For repeated DC
sweeps: the lanes of a job and the span of the source's value that
they sweep, offset by a draw from (s, 3, j).  Every seed gets
the same sizes, and the same seed the same inputs.
"""

from __future__ import annotations

import numpy as np

from .ladder import Ladder


WARM_JOB = 2 ** 40          # the warm-up's job index: no window reaches it


def _key(seed: int, *more: int):
    # SeedSequence takes non-negative words; keep the sign apart
    return [abs(int(seed)), int(seed < 0), *map(int, more)]


def resistances(lad: Ladder, mix: dict, seed: int, job: int) -> np.ndarray:
    """Job ``job``'s (lanes, n_r) resistances: each nominal value times
    exp(sigma N(0, 1)), one draw per lane and resistor."""
    sigma = float(mix["jitter"].get("R", 0.0))
    rng = np.random.default_rng(_key(seed, 0, job))
    z = rng.standard_normal((int(mix["lanes"]), lad.n_r))
    return lad.r_nom * np.exp(sigma * z)


def sweep(mix: dict, seed: int, job: int) -> np.ndarray:
    """Job ``job``'s scales of the source's value, one a lane: the mix's
    ``lanes`` values evenly spaced across its ``span``, all offset by one
    draw from (seed, 3, job) of under one step, so that no two jobs ask
    for the same value and every job does the same work."""
    lo, hi = (float(v) for v in mix["span"])
    B = int(mix["lanes"])
    u = np.random.default_rng(_key(seed, 3, job)).random()
    return lo + (hi - lo) * (np.arange(B) + u) / B


def check_positions(seed: int, n: int, k: int, keep=()) -> np.ndarray:
    """The k unknowns (of n) of every answer that are kept for the
    correctness check, drawn once a run from (seed, 4): those in
    ``keep`` and k - len(keep) others, sorted."""
    keep = np.unique(np.asarray(keep, np.int64))
    others = np.setdiff1d(np.arange(n), keep)
    rng = np.random.default_rng(_key(seed, 4))
    drawn = rng.choice(others, size=k - len(keep), replace=False)
    return np.sort(np.concatenate([keep, drawn]))


def check_lanes(mix: dict, seed: int, job: int, k: int) -> np.ndarray:
    """The k lanes of job ``job`` that are kept for the correctness check
    (sorted, distinct, k >= 2): its first and its last lane, the edges of
    the batch, and k - 2 others drawn apart from the job's inputs."""
    B = int(mix["lanes"])
    rng = np.random.default_rng(_key(seed, 1, job))
    inner = rng.choice(np.arange(1, B - 1), size=k - 2, replace=False)
    return np.sort(np.concatenate([[0, B - 1], inner]))


def check_sample(seed: int, jobs: int, k: int, n: int):
    """After the window: which n (>= 2) of the jobs x k kept lanes are
    compared, as (job, index into the job's kept lanes) pairs: both edge
    lanes of one job drawn from the seed, and n - 2 others."""
    rng = np.random.default_rng(_key(seed, 2))
    j = int(rng.integers(jobs))
    edges = [j * k, j * k + k - 1]
    rest = np.setdiff1d(np.arange(jobs * k), edges)
    pick = np.concatenate([edges, rng.choice(
        rest, size=min(n, jobs * k) - 2, replace=False)])
    return [(int(p // k), int(p % k)) for p in np.sort(pick)]
