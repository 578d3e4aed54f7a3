"""Chain preconditioner applications a DC sweep: the program's
``chain.applies`` counter over the window's sweeps (two an iteration of
a BiCGStab pass that runs the chain preconditioner).  None where the
family hands no such counter to the window (Jacobi's cells)."""

LAYER = "sparse solver"
UNIT = "applies/sweep"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "dc_solves_per_s"
ROUTES = ("sparse",)


def read(t):
    steps = t.counters.get("steps", 0)
    applies = t.counters.get("chain.applies")
    return applies / steps if applies is not None and steps else None
