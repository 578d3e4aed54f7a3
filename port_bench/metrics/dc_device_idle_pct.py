"""Share of the traced DC sweep in which no operation ran on the device."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "dc_solves_per_s"
ROUTES = ("sparse",)


def read(t):
    if not t.ops or t.window_ns <= 0:
        return None
    return 100.0 * (1.0 - t.busy_ns() / t.window_ns)
