"""Host synchronisations a DC sweep: the program's ``host_syncs``
counter (every ``pe.sync.*`` site passed: the stop reads, the shadow's
copy, the read of whether Jacobi converged) over the window's sweeps; a
sync that slips into the chain preconditioner's applications shows here.
None where the family hands no such counter to the window."""

LAYER = "sparse solver"
UNIT = "syncs/sweep"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "dc_solves_per_s"
ROUTES = ("sparse",)


def read(t):
    steps = t.counters.get("steps", 0)
    syncs = t.counters.get("host_syncs")
    return syncs / steps if syncs is not None and steps else None
