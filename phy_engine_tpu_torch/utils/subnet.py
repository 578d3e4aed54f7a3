"""Floating-subnet detection (the port's copy of
``phy_engine_tpu/utils/subnet.py``, host-only).

Parity with ``circuits/floating_subnet/detect.h:13-108``: BFS from the
ground node over the pin->model->pin adjacency; every analog connected
component not reachable from ground is reported (such components make
the MNA singular unless Gmin is applied).
"""

from __future__ import annotations

from collections import deque
from typing import List

from ..netlist.netlist import Netlist, Node


def detect_floating_subnets(nl: Netlist) -> List[List[Node]]:
    """Returns a list of ungrounded connected components (analog nets)."""
    visited = set()

    def bfs(start: Node):
        comp = []
        dq = deque([start])
        visited.add(id(start))
        while dq:
            node = dq.popleft()
            comp.append(node)
            for pin in node.pins:
                for other_pin in pin.model.pins:
                    n2 = other_pin.node
                    if n2 is not None and id(n2) not in visited:
                        visited.add(id(n2))
                        dq.append(n2)
        return comp

    bfs(nl.ground_node)
    out = []
    for node in nl.nodes:
        if id(node) in visited or node.num_of_analog_node <= 0:
            continue
        out.append(bfs(node))
    return out
