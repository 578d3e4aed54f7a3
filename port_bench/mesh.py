"""The upstream's random-link resistor mesh as a plain element list (numpy
only): benchmark/0001.models/100000_random_links_cpu.cpp:120-165, as the
JAX package's ``bench_sparse.py`` (``build_coo``, :33-72) rebuilt it.

``nodes`` nodes joined in a chain by resistors of ``r_chain``, node 0
grounded through one more; ``links`` resistors of ``r_link`` between node
pairs drawn uniformly from ``numpy.random.default_rng(link_seed)`` (a pair
drawn twice on one node moves its second end one node on); a DC source of
``vdc`` from node ``nodes - 1`` to ground.  Unknowns: the node voltages,
then the source's branch current.  Both sides of the benchmark read this
list: the reference builds its own conductance matrix from it, the port's
side a netlist.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

GROUND = -1


@dataclass(frozen=True)
class Mesh:
    nodes: int
    r_a: np.ndarray          # (n_r,) first node of each resistor (GROUND: -1)
    r_b: np.ndarray          # (n_r,) second node
    r_val: np.ndarray        # (n_r,) resistance
    src: int                 # the node the DC source drives
    vdc: float               # the source's value in the configuration

    @property
    def n_unknowns(self) -> int:
        return self.nodes + 1


def build(config: dict) -> Mesh:
    n, links = int(config["nodes"]), int(config["links"])
    rng = np.random.default_rng(int(config["link_seed"]))
    a = rng.integers(0, n, links)
    b = rng.integers(0, n, links)
    b = np.where(a == b, (b + 1) % n, b)
    chain = np.arange(n - 1)
    r_a = np.concatenate([[GROUND], chain, a]).astype(np.int64)
    r_b = np.concatenate([[0], chain + 1, b]).astype(np.int64)
    r_val = np.concatenate([np.full(n, float(config["r_chain"])),
                            np.full(links, float(config["r_link"]))])
    return Mesh(nodes=n, r_a=r_a, r_b=r_b, r_val=r_val, src=n - 1,
                vdc=float(config["vdc"]))
