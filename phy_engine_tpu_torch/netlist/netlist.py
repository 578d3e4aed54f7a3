"""Host-side netlist data structures (port of
``phy_engine_tpu/netlist/netlist.py``, with its identity-preserving
snapshot / restore, which synthesis at -O2 and above rolls back with,
and its deep copy).

Mirrors the reference's netlist (``include/phy_engine/netlist/
netlist.h``): model instances with pins and branch unknowns, nets with
their connected pins, and the ground node.  Compile-time data only: the
netlist is lowered once by :mod:`phy_engine_tpu_torch.engine.lower`.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

from ..models.base import ModelDef

X = 2    # 4-state digital unknown (logic code of ``digital.logic.X``)


class Pin:
    """One connection point of a model instance (model/pin/pin.h:16-21)."""

    __slots__ = ("name", "node", "model", "index")

    def __init__(self, name: str, model: "ModelInstance", index: int):
        self.name = name
        self.model = model
        self.index = index
        self.node: Optional[Node] = None


class Node:
    """A circuit net (model/node/node.h:255-307): connected pins and the
    count of analog devices on it (``num_of_analog_node``)."""

    __slots__ = ("pins", "num_of_analog_node", "is_ground", "voltage",
                 "digital", "node_index", "name", "_uid", "_pos")

    _uid_counter = itertools.count()

    def __init__(self, is_ground: bool = False, name: str = ""):
        self.pins: List[Pin] = []
        self.num_of_analog_node = 0
        self.is_ground = is_ground
        self.voltage = 0.0 + 0.0j     # last solved analog voltage
        self.digital = X              # 4-state digital value (logic code)
        self.node_index = -1          # assigned at lowering; -1 = ground
        self.name = name
        self._uid = next(Node._uid_counter)

    @property
    def is_analog(self) -> bool:
        return self.num_of_analog_node > 0


class Branch:
    """An MNA branch unknown (model/branch/branch.h:7-11)."""

    __slots__ = ("index", "current")

    def __init__(self):
        self.index = -1
        self.current = 0.0 + 0.0j


class ModelInstance:
    """One placed device: a family (:class:`ModelDef`) plus parameters."""

    __slots__ = ("mdef", "params", "pins", "branches", "name", "describe",
                 "enabled", "runtime", "_uid", "_pos")

    _uid_counter = itertools.count()

    def __init__(self, mdef: ModelDef, params: Optional[Dict[str, Any]] = None,
                 name: str = ""):
        self.mdef = mdef
        self.params: Dict[str, Any] = dict(mdef.defaults)
        if params:
            unknown = set(params) - set(self.params)
            if unknown and not mdef.dynamic_params:
                raise KeyError(f"unknown parameter(s) {unknown} for model "
                               f"{mdef.name}")
            self.params.update(params)
        names = mdef.pin_names_for(self.params)
        self.pins = [Pin(name, self, i) for i, name in enumerate(names)]
        self.branches = [Branch()
                         for _ in range(mdef.num_branches(self.params))]
        self.name = name
        self.describe = ""
        self.enabled = True
        # per-instance device state read back after a solve
        self.runtime: Dict[str, Any] = {}
        self._uid = next(ModelInstance._uid_counter)

    # -- attribute API (reference: set/get_attribute by index or name,
    #    model_refs/base.h + per-model *_define overloads).  An edit
    #    changes ``params`` only: no structural version bump, and the
    #    Circuit repacks parameters at every analysis. ---------------------
    def attribute_names(self) -> List[str]:
        return self.mdef.attr_names(self.params)

    def _resolve_attr_key(self, key):
        """index or name (display names like "Cut Through" match the
        canonical param key case/space-insensitively)."""
        if isinstance(key, int):
            names = self.attribute_names()
            if not (0 <= key < len(names)):
                return None
            key = names[key]
        key = self.mdef.attr_aliases.get(key, key)
        if key in self.params or self.mdef.dynamic_params:
            return key
        norm = key.lower().replace(" ", "_")
        for k in self.params:
            if k.lower().replace(" ", "_") == norm:
                return k
        return None

    def set_attribute(self, key, value) -> bool:
        key = self._resolve_attr_key(key)
        if key is None:
            return False
        self.params[key] = value
        return True

    def get_attribute(self, key):
        key = self._resolve_attr_key(key)
        return None if key is None else self.params.get(key)


class Netlist:
    """The circuit graph.  Structural mutations bump :attr:`version`."""

    def __init__(self):
        self.models: List[ModelInstance] = []
        self.nodes: List[Node] = []
        self.ground_node = Node(is_ground=True, name="0")
        self.version = 0

    def touch(self):
        self.version += 1

    def live_models(self) -> List[ModelInstance]:
        return [m for m in self.models if m is not None and m.enabled]

    def all_nodes(self, include_ground: bool = True) -> List[Node]:
        out = ([self.ground_node] if include_ground else [])
        out.extend(self.nodes)
        return out

    def model_count(self) -> int:
        return sum(1 for m in self.models if m is not None)

    def node_count(self) -> int:
        return len(self.nodes)

    # -- in-place state snapshot/rollback ------------------------------
    # Identity-preserving undo for optimization tiers: unlike copy(),
    # outside references to surviving models/nodes (port nets, INPUT /
    # OUTPUT devices held by the synthesizer) stay valid across a
    # restore.  Models/nodes created after the snapshot simply drop out
    # of the lists and are garbage-collected.
    def state_save(self):
        mstate = [(m, m.enabled, dict(m.params),
                   [p.node for p in m.pins])
                  for m in self.models if m is not None]
        nstate = [(n, list(n.pins), n.num_of_analog_node)
                  for n in self.all_nodes()]
        return (list(self.models), list(self.nodes), mstate, nstate)

    def state_restore(self, snap) -> None:
        # the snapshot's param dicts become the live models' own, so a
        # snapshot is restored at most once around further edits
        models, nodes, mstate, nstate = snap
        self.models[:] = models
        self.nodes[:] = nodes
        for m, enabled, params, pnodes in mstate:
            m.enabled = enabled
            m.params = params
            for p, nd in zip(m.pins, pnodes):
                p.node = nd
        for n, pins, naa in nstate:
            n.pins[:] = pins
            n.num_of_analog_node = naa
        self.touch()

    # -- deep copy (reference: netlist copy ctor w/ node remap,
    #    netlist.h:351-536) ---------------------------------------------
    def copy(self) -> "Netlist":
        import copy as _copy
        new = Netlist()
        node_map: Dict[int, Node] = {id(self.ground_node): new.ground_node}
        for n in self.nodes:
            nn = Node(name=n.name)
            nn.voltage = n.voltage
            nn.digital = n.digital
            nn.num_of_analog_node = n.num_of_analog_node
            node_map[id(n)] = nn
            new.nodes.append(nn)
        for m in self.models:
            if m is None:
                new.models.append(None)
                continue
            nm = ModelInstance(m.mdef, _copy.deepcopy(m.params), m.name)
            nm.describe = m.describe
            nm.enabled = m.enabled
            nm.runtime = _copy.deepcopy(m.runtime)
            for old_pin, new_pin in zip(m.pins, nm.pins):
                if old_pin.node is not None:
                    tgt = node_map[id(old_pin.node)]
                    new_pin.node = tgt
                    tgt.pins.append(new_pin)
            new.models.append(nm)
        new.version = self.version
        return new
