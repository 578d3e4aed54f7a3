"""``pe_gj_solve32`` against its roofline: the least time of each call's
(B, n) from ``roofline.gj_solve_s``, summed over the traced job's calls,
over the device time of the kernels of those calls."""

from .. import roofline

LAYER = "GJ kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "circuit_steps_per_s"
ROUTES = ("frozen",)


def read(t):
    calls = [(B, n) for mark, B, n in t.calls if mark == "pe_gj_solve32"]
    ns = t.gj_ns()["solve"]
    if not calls or not ns:
        return None
    least = sum(roofline.gj_solve_s(B, n) for B, n in calls)
    return 100.0 * least / (ns * 1e-9)
