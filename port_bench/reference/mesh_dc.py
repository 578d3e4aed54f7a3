"""The plain reference of the random-link mesh's DC solve: the conductance
matrix built from the element list (``mesh.Mesh``), the source's node
fixed at its voltage and eliminated, and conjugate gradients on the
symmetric positive definite system that remains, in plain PyTorch.  It
imports nothing of the program.

A direct factorization of a chain with random long links fills in (tens
of millions of entries at 10^5 nodes); conjugate gradients in float64
reach the rounding of the system's right side, and the comparison needs
no more.
"""

from __future__ import annotations

import warnings

import torch

CHECK_EVERY = 32             # iterations between reads of the residual


def _matrix(m, dtype, device):
    """The reduced conductance matrix (CSR, over every node but the
    source's) and the column of couplings to the source's node."""
    a = torch.as_tensor(m.r_a, device=device)
    b = torch.as_tensor(m.r_b, device=device)
    g = 1.0 / torch.as_tensor(m.r_val, dtype=torch.float64, device=device)
    n = m.nodes
    # every resistor stamps +g on both diagonals, -g off them; ground drops
    rows = torch.cat([a, b, a, b])
    cols = torch.cat([a, b, b, a])
    vals = torch.cat([g, g, -g, -g])
    off_ground = (rows >= 0) & (cols >= 0)
    rows, cols, vals = rows[off_ground], cols[off_ground], vals[off_ground]
    couple = torch.zeros(n, dtype=torch.float64, device=device)
    to_src = (cols == m.src) & (rows != m.src)
    couple.index_add_(0, rows[to_src], vals[to_src])
    inner = (rows != m.src) & (cols != m.src)
    # renumber: the source's node leaves, the others keep their order
    shift = lambda i: i - (i > m.src).long()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        G = torch.sparse_coo_tensor(
            torch.stack([shift(rows[inner]), shift(cols[inner])]),
            vals[inner], (n - 1, n - 1),
            check_invariants=True).coalesce().to_sparse_csr()
    others = torch.arange(n, device=device) != m.src
    return G.to(dtype), couple[others].to(dtype), G


def _cg(G, rhs, tol: float, max_iter: int):
    x = torch.zeros_like(rhs)
    r = rhs.clone()
    p = r.clone()
    rr = r @ r
    bn = torch.sqrt(rhs @ rhs)
    for k in range(max_iter):
        if k % CHECK_EVERY == 0 and bool(torch.sqrt(rr) <= tol * bn):
            break
        Gp = G @ p
        alpha = rr / (p @ Gp)
        x = x + alpha * p
        r = r - alpha * Gp
        rr_new = r @ r
        p = r + (rr_new / rr) * p
        rr = rr_new
    return x


def solve(m, dtype=torch.float64, device="cpu", max_iter: int = 20000):
    """The mesh's DC answer for a source of 1 V: (x (n + 1,) float64, the
    node voltages then the source's branch current; converged), computed
    in ``dtype``.  Converged: the float64 residual of the reduced system
    under 1e-11 of its right side.  The answer for a source of V is V
    times this one: the circuit is linear."""
    Gd, couple, G64 = _matrix(m, dtype, device)
    rhs = -couple                                  # the source's node at 1 V
    eps = torch.finfo(dtype).eps
    v = _cg(Gd, rhs, 10 * eps, max_iter).to(torch.float64)
    rhs64 = rhs.to(torch.float64)
    res = torch.linalg.vector_norm(G64 @ v - rhs64) / torch.linalg.vector_norm(
        rhs64)
    nodes = torch.cat([v[:m.src], torch.ones(1, dtype=torch.float64,
                                              device=device), v[m.src:]])
    # the source's current: KCL at its node, the current into the source
    # from the node counted positive
    i_src = -(_row_current(m, nodes))
    x = torch.cat([nodes, i_src.reshape(1)])
    return x.cpu(), bool(res < 1e-11)


def _row_current(m, nodes):
    """The current that leaves the source's node through its resistors."""
    a = torch.as_tensor(m.r_a, device=nodes.device)
    b = torch.as_tensor(m.r_b, device=nodes.device)
    g = 1.0 / torch.as_tensor(m.r_val, dtype=torch.float64,
                              device=nodes.device)
    va = torch.where(a >= 0, nodes[a.clamp(min=0)], 0.0)
    vb = torch.where(b >= 0, nodes[b.clamp(min=0)], 0.0)
    cur = g * (va - vb)                    # from a to b
    out = torch.where(a == m.src, cur, 0.0) - torch.where(b == m.src, cur, 0.0)
    return out.sum()
