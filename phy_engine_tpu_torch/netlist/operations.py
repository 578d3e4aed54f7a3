"""Netlist operations (port of ``phy_engine_tpu/netlist/operations.py``):
``add_model`` / ``delete_model`` / ``get_model`` / ``create_node`` /
``drop_node`` / ``add_to_node`` / ``remove_from_node`` / ``merge_node`` /
``add_netlist`` (reference ``netlist/operation.h:49-338``)."""

from __future__ import annotations

import copy
from typing import Optional, Union

from .netlist import Netlist, Node, ModelInstance, Pin
from ..models.base import ModelDef, DeviceClass


def add_model(nl: Netlist, mdef_or_inst, params=None, name: str = "") -> ModelInstance:
    """Place a device.  Accepts a ModelDef (+params) or a prebuilt instance."""
    if isinstance(mdef_or_inst, ModelInstance):
        inst = mdef_or_inst
    elif isinstance(mdef_or_inst, ModelDef):
        inst = ModelInstance(mdef_or_inst, params, name)
    else:
        raise TypeError(f"cannot add {type(mdef_or_inst)} to netlist")
    inst._pos = len(nl.models)
    nl.models.append(inst)
    nl.touch()
    return inst


def delete_model(nl: Netlist, inst: ModelInstance) -> bool:
    """Remove a device (tombstone, like operation.h:91-128) and detach pins."""
    pos = getattr(inst, "_pos", -1)
    if not (0 <= pos < len(nl.models)) or nl.models[pos] is not inst:
        try:                           # fallback for foreign instances
            pos = nl.models.index(inst)
        except ValueError:
            return False
    for pin in inst.pins:
        if pin.node is not None:
            remove_from_node(nl, inst, pin.index, pin.node)
    nl.models[pos] = None
    nl.touch()
    return True


def get_model(nl: Netlist, pos: int) -> Optional[ModelInstance]:
    if 0 <= pos < len(nl.models):
        return nl.models[pos]
    return None


def create_node(nl: Netlist, name: str = "") -> Node:
    node = Node(name=name)
    node._pos = len(nl.nodes)
    nl.nodes.append(node)
    nl.touch()
    return node


def drop_node(nl: Netlist, node: Node) -> bool:
    """Remove a net from the list in O(1) (swap-with-last)."""
    pos = getattr(node, "_pos", -1)
    if not (0 <= pos < len(nl.nodes)) or nl.nodes[pos] is not node:
        return False               # already dropped (stale position)
    last = nl.nodes[-1]
    nl.nodes[pos] = last
    last._pos = pos
    nl.nodes.pop()
    return True


def _pin_of(inst: ModelInstance, pin: Union[int, str, Pin]) -> Pin:
    if isinstance(pin, Pin):
        return pin
    if isinstance(pin, str):
        for p in inst.pins:
            if p.name == pin:
                return p
        raise KeyError(f"no pin named {pin!r} on {inst.mdef.name}")
    return inst.pins[pin]


def add_to_node(nl: Netlist, inst: ModelInstance, pin: Union[int, str, Pin],
                node: Node) -> None:
    """Connect a pin to a net.  Analog-class devices make the net analog;
    digital devices never do (operation.h:167-217)."""
    p = _pin_of(inst, pin)
    if p.node is node:
        return
    if p.node is not None:
        remove_from_node(nl, inst, p, p.node)
    p.node = node
    node.pins.append(p)
    if inst.mdef.device_class != DeviceClass.DIGITAL:
        node.num_of_analog_node += 1
    nl.touch()


def remove_from_node(nl: Netlist, inst: ModelInstance, pin: Union[int, str, Pin],
                     node: Optional[Node] = None) -> None:
    p = _pin_of(inst, pin)
    node = node or p.node
    if node is None or p.node is not node:
        return
    node.pins.remove(p)
    p.node = None
    if inst.mdef.device_class != DeviceClass.DIGITAL:
        node.num_of_analog_node -= 1
    nl.touch()


def merge_node(nl: Netlist, keep: Node, absorb: Node) -> Node:
    """Merge net ``absorb`` into ``keep`` (operation.h:251-259).

    Ground wins: merging anything with the ground node yields ground.
    """
    if keep is absorb:
        return keep
    if absorb.is_ground and not keep.is_ground:
        keep, absorb = absorb, keep
    for p in list(absorb.pins):
        p.node = keep
        keep.pins.append(p)
    keep.num_of_analog_node += absorb.num_of_analog_node
    absorb.pins.clear()
    absorb.num_of_analog_node = 0
    drop_node(nl, absorb)
    nl.touch()
    return keep


def _copy(src: Netlist) -> Netlist:
    """Deep copy with node remap (reference: the netlist copy constructor,
    netlist.h:351-536), as ``Netlist.copy`` of the JAX package builds it."""
    new = Netlist()
    node_map = {id(src.ground_node): new.ground_node}
    for n in src.nodes:
        nn = Node(name=n.name)
        nn.voltage = n.voltage
        nn.digital = n.digital
        nn.num_of_analog_node = n.num_of_analog_node
        node_map[id(n)] = nn
        new.nodes.append(nn)
    for m in src.models:
        if m is None:
            new.models.append(None)
            continue
        nm = ModelInstance(m.mdef, copy.deepcopy(m.params), m.name)
        nm.describe = m.describe
        nm.enabled = m.enabled
        nm.runtime = copy.deepcopy(m.runtime)
        for old_pin, new_pin in zip(m.pins, nm.pins):
            if old_pin.node is not None:
                tgt = node_map[id(old_pin.node)]
                new_pin.node = tgt
                tgt.pins.append(new_pin)
        new.models.append(nm)
    new.version = src.version
    return new


def add_netlist(dst: Netlist, src: Netlist) -> dict:
    """Graft a copy of ``src`` into ``dst`` (operation.h:261-338).

    Returns a mapping {id(src node/model): new object} so callers can
    stitch ports.  The source ground merges into the destination ground.
    """
    src_copy = _copy(src)
    remap = {id(src.ground_node): dst.ground_node}
    for orig, copied in zip(src.nodes, src_copy.nodes):
        dst.nodes.append(copied)
        remap[id(orig)] = copied
    for orig, copied in zip(src.models, src_copy.models):
        if copied is None:
            continue
        dst.models.append(copied)
        remap[id(orig)] = copied
    # reconnect copied ground pins to dst ground
    for p in list(src_copy.ground_node.pins):
        p.node = dst.ground_node
        dst.ground_node.pins.append(p)
        dst.ground_node.num_of_analog_node += 1
    dst.touch()
    return remap
