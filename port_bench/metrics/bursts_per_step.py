"""Burst iterations a TR step: launches of the port's ``gj_solve32`` (its
own counter) over the window's steps; a burst is a direct solve of the
fresh Jacobian when some lane's residual grew."""

LAYER = "frozen Newton"
UNIT = "bursts/step"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "circuit_steps_per_s"
ROUTES = ("frozen",)


def read(t):
    steps = t.counters.get("steps", 0)
    return t.counters["bursts"] / steps if steps else None
