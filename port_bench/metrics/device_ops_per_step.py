"""Device operations (kernels, copies, fills) a TR step in the traced job:
the dispatch count of assembly, stamps and the Newton loop, which the
host launches one by one."""

LAYER = "assembly, stamps and dispatch"
UNIT = "ops/step"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "circuit_steps_per_s"
ROUTES = ("frozen",)


def read(t):
    return len(t.ops) / t.steps if t.ops and t.steps else None
