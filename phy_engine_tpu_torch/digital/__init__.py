"""Digital side of the port: 4-state logic, the gate IR and the turbo
whole-tick engine."""
