"""Share of the traced ladder sweep in which no operation ran on the
device."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "ladder_solves_per_s"
ROUTES = ("pcr",)


def read(t):
    if not t.ops or t.window_ns <= 0:
        return None
    return 100.0 * (1.0 - t.busy_ns() / t.window_ns)
