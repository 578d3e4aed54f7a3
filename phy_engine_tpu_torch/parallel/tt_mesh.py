"""Mesh-sharded u64 truth-table evaluation (port of
``phy_engine_tpu/parallel/tt_mesh.py``).

The embarrassingly parallel axis of the synthesis truth-table checks is
the PATTERN WORDS: every rank evaluates the same topologically ordered
gate graph over its contiguous shard of the packed pattern matrix, and
the shards are all-gathered.  The JAX package walks the nodes one at a
time in a ``fori_loop`` and carries each u64 word as two u32 planes (a
TPU has no u64); here the words travel as int64 bit patterns (the
bitwise ops are exact on them, and torch's uint64 coverage on CUDA is
partial) and the graph is evaluated a topological level at a time — every
node of a level at once, a gather of its fanins and one store — which is
the same function, bit for bit, in far fewer launches.

Used by ``verilog.opt_graph.graphs_equivalent(..., mesh=...)``: deep
random-vector equivalence (2^20 patterns by default) sharded over the
mesh.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..native import OP_AND, OP_CONST0, OP_LEAF, OP_NOT, OP_OR, OP_XOR
from .mesh import axis_size, gather_rows, mesh_axes, mesh_device, \
    shard_range


def graph_levels(op, f0, f1) -> List[np.ndarray]:
    """The non-leaf rows grouped by topological level (a row's level is
    one more than its fanins'; leaves sit at level 0 and are never
    written).  Raises ``ValueError`` when a row reads one at or after
    itself: the node walk it replaces reads only earlier rows."""
    op = np.asarray(op, np.int64)
    f0 = np.asarray(f0, np.int64)
    f1 = np.asarray(f1, np.int64)
    n = op.shape[0]
    reads0 = (op == OP_NOT) | (op == OP_AND) | (op == OP_OR) | (op == OP_XOR)
    reads1 = (op == OP_AND) | (op == OP_OR) | (op == OP_XOR)
    rows = np.arange(n)
    if np.any(reads0 & (f0 >= rows)) or np.any(reads1 & (f1 >= rows)):
        raise ValueError("eval_graph_mesh: the graph is not topologically "
                         "ordered (a row reads a row at or after itself)")
    level = np.zeros(n, np.int64)
    for i in np.nonzero(op != OP_LEAF)[0]:
        lv = 0
        if reads0[i]:
            lv = level[f0[i]]
        if reads1[i]:
            lv = max(lv, level[f1[i]])
        level[i] = lv + 1
    gates = np.nonzero(op != OP_LEAF)[0]
    return [gates[level[gates] == k] for k in range(1, int(level.max(
        initial=0)) + 1)]


def _eval_levels(op, f0, f1, W, levels):
    """In place on W (n_nodes, w) int64: every level's rows from its
    fanins' rows."""
    dev = W.device
    for rows in levels:
        r = torch.as_tensor(rows, device=dev)
        o = torch.as_tensor(op[rows], device=dev)[:, None]
        a = W[torch.as_tensor(f0[rows], device=dev)]
        b = W[torch.as_tensor(f1[rows], device=dev)]
        ones = torch.full_like(a, -1)
        out = torch.where(o == OP_NOT, ~a,
              torch.where(o == OP_AND, a & b,
              torch.where(o == OP_OR, a | b,
              torch.where(o == OP_XOR, a ^ b,
              torch.where(o == OP_CONST0, torch.zeros_like(a), ones)))))
        W[r] = out


def eval_graph_mesh(op: np.ndarray, f0: np.ndarray, f1: np.ndarray,
                    words: np.ndarray, mesh, axis=None) -> np.ndarray:
    """Evaluate a topologically ordered gate graph over u64 pattern words
    with the word axis sharded over ``mesh`` (``axis``: one mesh axis, or
    all of them by default).

    Same contract as ``native.eval_graph``: ``words`` is (n_nodes,
    n_words) uint64 with the leaf rows filled; returns the evaluated
    matrix (every rank gets all of it).  n_words is padded to a multiple
    of the rank count (the padding words are dropped)."""
    axes = mesh_axes(mesh, axis)
    D = axis_size(mesh, axes)
    n_nodes, n_words = words.shape
    wp = -(-n_words // D) * D
    lo, hi = shard_range(wp, mesh, axes)
    local = np.zeros((n_nodes, hi - lo), np.uint64)
    take = words[:, lo:min(hi, n_words)]
    local[:, :take.shape[1]] = take
    W = torch.from_numpy(local.view(np.int64)).to(mesh_device(mesh))
    op = np.asarray(op, np.int64)
    _eval_levels(op, np.asarray(f0, np.int64), np.asarray(f1, np.int64), W,
                 graph_levels(op, f0, f1))
    out = gather_rows(W, mesh, axes, dim=1)[:, :n_words]
    return out.cpu().numpy().view(np.uint64)
