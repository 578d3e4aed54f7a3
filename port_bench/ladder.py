"""The random-link diode ladder as a plain element list (numpy only).

A configuration file (``configs/<name>.json``) states the circuit; this
module turns it into index arrays that both sides of the benchmark read:
the reference builds its own MNA from them, and the port's side builds a
netlist from them.  Neither takes anything from the other.

The circuit (the JAX package's ``bench.py`` headline, no public
deployment; see PERF.md): a sine source drives node 0; ``stages`` nodes
are joined in a chain by ``stages - 1`` resistors of ``r_chain``;
``links`` long-range resistors of ``r_link`` join random node pairs more
than one stage apart; every node has a PN junction and a capacitor
``c_node`` to ground.  Unknowns: the ``stages`` node voltages, then the
source's branch current.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def link_pairs(stages: int, links: int, seed: int):
    """The random long-range links: pairs (a, b) with |a - b| > 1 drawn
    from ``numpy.random.default_rng(seed)``, repeats kept."""
    rng = np.random.default_rng(seed)
    pairs = []
    while len(pairs) < links:
        a, b = rng.integers(0, stages, 2)
        if abs(int(a) - int(b)) > 1:
            pairs.append((int(a), int(b)))
    return pairs


@dataclass(frozen=True)
class Ladder:
    stages: int              # node count; unknowns = stages + 1
    r_a: np.ndarray          # (n_r,) resistor pin A node, chain first
    r_b: np.ndarray          # (n_r,) resistor pin B node
    r_nom: np.ndarray        # (n_r,) nominal resistance
    c_node: float            # capacitor at every node, to ground
    pn: dict                 # PN junction parameters at every node
    drive: dict              # {"Vp", "freq", "phase"} of the sine source

    @property
    def n_unknowns(self) -> int:
        return self.stages + 1

    @property
    def n_r(self) -> int:
        return int(self.r_nom.shape[0])


def build(config: dict, drive: dict = None) -> Ladder:
    """The element list of ``config``; ``drive`` overrides keys of the
    configuration's drive (a traffic mix may scale the amplitude)."""
    n = int(config["stages"])
    chain = [(i, i + 1) for i in range(n - 1)]
    links = link_pairs(n, int(config["links"]), int(config["link_seed"]))
    pairs = np.asarray(chain + links, np.int64).reshape(-1, 2)
    r_nom = np.concatenate([np.full(len(chain), float(config["r_chain"])),
                            np.full(len(links), float(config["r_link"]))])
    drv = dict(config["drive"])
    drv.update(drive or {})
    if drv.get("kind", "VAC") != "VAC":
        raise ValueError(f"unknown drive {drv.get('kind')!r}")
    return Ladder(stages=n, r_a=pairs[:, 0], r_b=pairs[:, 1], r_nom=r_nom,
                  c_node=float(config["c_node"]), pn=dict(config["pn"]),
                  drive={k: float(drv[k]) for k in ("Vp", "freq", "phase")})
