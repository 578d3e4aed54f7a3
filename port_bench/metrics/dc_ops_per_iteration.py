"""Device operations (kernels, copies, fills) of the traced DC sweep over
its BiCGStab iterations: the dispatch count of the sparse route (the
assembly once, then each iteration's products, reductions and updates),
which the host launches one by one."""

LAYER = "sparse solver"
UNIT = "ops/iteration"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "dc_solves_per_s"
ROUTES = ("sparse",)


def read(t):
    its = sum(c[1] for c in t.calls if c[0] == "bicgstab")
    return len(t.ops) / its if t.ops and its else None
