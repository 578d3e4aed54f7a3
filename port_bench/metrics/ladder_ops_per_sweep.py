"""Device operations (kernels, copies, fills) of the traced ladder sweep:
the dispatch count of parallel cyclic reduction, its border and its
refinement passes for every lane at once, which the host launches one by
one."""

LAYER = "tridiagonal solver"
UNIT = "ops/sweep"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "ladder_solves_per_s"
ROUTES = ("pcr",)


def read(t):
    return len(t.ops) / t.steps if t.ops and t.steps else None
