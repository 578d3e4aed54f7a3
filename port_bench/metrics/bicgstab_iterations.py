"""BiCGStab iterations a DC sweep: the iteration count of the slowest
lane that the engine's sparse solver returns, read by the benchmark's
wrapper around it in the traced job; every lane of a sweep iterates
together until the last converges."""

LAYER = "sparse solver"
UNIT = "iterations/sweep"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "dc_solves_per_s"
ROUTES = ("sparse",)


def read(t):
    its = [c[1] for c in t.calls if c[0] == "bicgstab"]
    return sum(its) / t.steps if its and t.steps else None
