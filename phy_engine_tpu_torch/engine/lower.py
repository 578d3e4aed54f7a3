"""Netlist -> stamp IR lowering (port of ``phy_engine_tpu/engine/lower.py``).

The host-side compiler: analog nodes get contiguous indices (ground = -1),
branch unknowns get indices past the node count, and the instances of
each device family are packed into numpy arrays — parameter matrix
``P``, pin/branch index matrices, the static COO scatter pattern of the
matrix and RHS stamps (ground mapped to the dummy slot N), and the
initial state.  The output is identical, array for array, to the JAX
package's ``lower_analog``; the tests hold it so.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ..netlist.netlist import Netlist, Node, ModelInstance
from ..models.base import ModelDef


@dataclass
class FamilyIR:
    mdef: ModelDef
    instances: List[ModelInstance]
    P: np.ndarray            # (n, n_params) float
    pin_nodes: np.ndarray    # (n, npins) int32 node index, -1 = ground
    br_idx: np.ndarray       # (n, nbr) int32 global unknown index
    a_rows: np.ndarray       # (n, K) int32, ground mapped to N (dummy)
    a_cols: np.ndarray       # (n, K)
    z_rows: np.ndarray       # (n, Kz)
    state0: Dict[str, np.ndarray]  # each (n,)


@dataclass
class AnalogIR:
    n_nodes: int
    n_branches: int
    n_drive_slots: int       # hybrid digital->analog drive branch rows
    families: List[FamilyIR]
    node_index: Dict[int, int]            # id(Node) -> index
    node_list: List[Node]                 # index -> Node
    nonlinear: bool
    version: int = 0
    # host-built scatter plans and their device copies (engine.analog)
    cache: Optional[Dict[Any, Any]] = None

    @property
    def n_unknowns(self) -> int:
        return self.n_nodes + self.n_branches + self.n_drive_slots

    def index_of(self, node: Node) -> int:
        if node.is_ground:
            return -1
        return self.node_index.get(id(node), -1)


def _map_ground(idx: np.ndarray, n_total: int) -> np.ndarray:
    """Map ground (-1) to the dummy slot n_total (scatter target N)."""
    return np.where(idx < 0, n_total, idx).astype(np.int32)


def lower_analog(nl: Netlist, max_drive_slots: Optional[int] = None) -> AnalogIR:
    """Compile the netlist's analog portion to stamp IR."""
    # ---- node indexing (analog nets only; circuit.h:481-506) ----------
    node_index: Dict[int, int] = {}
    node_list: List[Node] = []
    for node in nl.nodes:
        if node.is_ground or node.num_of_analog_node <= 0:
            node.node_index = -1
            continue
        node.node_index = len(node_list)
        node_index[id(node)] = node.node_index
        node_list.append(node)
    nl.ground_node.node_index = -1

    # ---- internal nodes (appended to the node region per instance) ----
    internal_idx: Dict[int, List[int]] = {}
    for inst in nl.live_models():
        if inst.mdef.is_analog and inst.mdef.n_internal:
            idxs = []
            for k in range(inst.mdef.n_internal):
                nd = Node(name=f"{inst.mdef.id_name}.int{k}")
                nd.num_of_analog_node = 1
                nd.node_index = len(node_list)
                node_index[id(nd)] = nd.node_index
                node_list.append(nd)
                idxs.append(nd.node_index)
            internal_idx[id(inst)] = idxs
    n_nodes = len(node_list)

    # ---- branch assignment --------------------------------------------
    n_branches = 0
    groups: Dict[str, List[ModelInstance]] = {}
    for inst in nl.live_models():
        if not inst.mdef.is_analog:
            continue
        for br in inst.branches:
            br.index = n_nodes + n_branches
            n_branches += 1
        groups.setdefault(inst.mdef.id_name, []).append(inst)

    n_drive = max_drive_slots or 0
    n_total = n_nodes + n_branches + n_drive

    # ---- per-family packing ---------------------------------------------
    families: List[FamilyIR] = []
    nonlinear = False
    for key, instances in groups.items():
        mdef = instances[0].mdef
        if mdef.nonlinear:
            nonlinear = True
        n = len(instances)
        npins = len(instances[0].pins)
        nint = mdef.n_internal
        nbr = len(instances[0].branches)
        P = np.zeros((n, max(1, len(mdef.param_order))), dtype=np.float64)
        pin_nodes = np.full((n, max(1, npins + nint)), -1, dtype=np.int32)
        br_idx = np.zeros((n, max(1, nbr)), dtype=np.int32)
        a_rows_l, a_cols_l, z_rows_l = [], [], []
        state0: Dict[str, List[float]] = {s: [] for s, _ in mdef.state_vars}
        for i, inst in enumerate(instances):
            if mdef.param_order:
                P[i, :] = mdef.pack_params(inst.params)
            pidx = []
            for j, pin in enumerate(inst.pins):
                gi = -1
                if pin.node is not None and not pin.node.is_ground:
                    gi = node_index.get(id(pin.node), -1)
                pin_nodes[i, j] = gi
                pidx.append(gi)
            for k, gi in enumerate(internal_idx.get(id(inst), ())):
                pin_nodes[i, npins + k] = gi
                pidx.append(gi)
            bidx = [br.index for br in inst.branches]
            for j, b in enumerate(bidx):
                br_idx[i, j] = b
            rows, cols = mdef.pattern(pidx, bidx)
            zrows = mdef.rhs_pattern(pidx, bidx)
            a_rows_l.append(rows)
            a_cols_l.append(cols)
            z_rows_l.append(zrows)
            st = mdef.init_state_row(inst.params)
            for s in state0:
                state0[s].append(st[s])
        families.append(FamilyIR(
            mdef=mdef, instances=instances, P=P,
            pin_nodes=pin_nodes, br_idx=br_idx,
            a_rows=_map_ground(np.asarray(a_rows_l, np.int64), n_total),
            a_cols=_map_ground(np.asarray(a_cols_l, np.int64), n_total),
            z_rows=_map_ground(np.asarray(z_rows_l, np.int64), n_total),
            state0={s: np.asarray(v, np.float64) for s, v in state0.items()},
        ))

    return AnalogIR(
        n_nodes=n_nodes, n_branches=n_branches, n_drive_slots=n_drive,
        families=families, node_index=node_index, node_list=node_list,
        nonlinear=nonlinear, version=nl.version,
    )
