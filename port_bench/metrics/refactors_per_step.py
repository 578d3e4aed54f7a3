"""Refactors a TR step: launches of the port's ``gj_inverse32`` (its own
counter, counted where the call reaches the kernel) over the window's
steps.  More lanes in a job can only raise it: a refactor serves every
lane at once."""

LAYER = "frozen Newton"
UNIT = "refactors/step"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "circuit_steps_per_s"
ROUTES = ("frozen",)


def read(t):
    steps = t.counters.get("steps", 0)
    return t.counters["refactors"] / steps if steps else None
