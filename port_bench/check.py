"""The verdict that decides ``correct`` from the numbers compared.

Which numbers a cell compares, and how, is its circuit family's
(``circuits/``): each is held to the limit that the cell's file gives it
(``check.limits``), and the family's counts of failures to 0.  The limits
are set from readings of the program and of the control (PERF.md).
"""

from __future__ import annotations

import sys

import numpy as np


def dc_gaps(x, idx, ref_unit, volts, n_nodes: int) -> dict:
    """The gaps of a DC sweep's answers x (L, K), at unknowns idx (K,) of
    the reference's order (nodes, then the source's current), from the
    reference's answer at 1 V (n + 1,) times each answer's source value
    ``volts`` (L,): the widest node-voltage gap against the source value
    (``v_gap_max``), and the widest gap of the source's current against
    the reference's (``i_gap_max``)."""
    x = np.asarray(x, np.float64)
    if not np.isfinite(x).all():
        return {"v_gap_max": float("inf"), "i_gap_max": float("inf")}
    idx = np.asarray(idx)
    v = np.asarray(volts, np.float64)[:, None]
    ref = v * ref_unit[idx][None]
    gap = np.abs(x - ref)
    node = idx < n_nodes
    dv = (gap[:, node] / np.abs(v)).max() if node.any() else 0.0
    di = ((gap[:, ~node] / np.abs(ref[:, ~node])).max() if (~node).any()
          else 0.0)
    return {"v_gap_max": float(dv), "i_gap_max": float(di)}


def verdict(values: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) for every limit; a value that
    is missing or not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and bool(np.isfinite(v)) and v <= limit
        ok &= good
        out[name] = {"value": v if v is None or np.isfinite(v) else str(v),
                     "limit": limit}
    return ok, out


def say(checks: dict):
    """Each number beside its limit, as the last lines on standard error."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
