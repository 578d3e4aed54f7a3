"""Digital side of the port: 4-state logic, the gate IR and the turbo
whole-tick engine."""

# what DigitalEngine.tick / run_ticks clock with (see DigitalEngine)
BACKENDS = ("device", "native")


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown digital backend {backend!r}, expected "
                         f"one of {BACKENDS}")
    return backend
