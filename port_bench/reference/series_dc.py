"""The plain reference of the series resistor ladder's DC solve: node 0
held at the source's voltage, the tridiagonal conductance system of the
other nodes solved by the Thomas algorithm in a plain loop, and the
source's current from KCL at node 0.  NumPy scalars only; it imports
nothing of the program."""

from __future__ import annotations

import numpy as np


def solve(n_res: int, r: float, dtype=np.float64) -> np.ndarray:
    """The answer for a source of 1 V across ``n_res`` resistors of ``r``
    in series to ground: (n_res + 1,) float64, the node voltages (node 0
    at the source) then the source's branch current, computed in
    ``dtype``.  The answer for V volts is V times this one."""
    f = dtype
    g, one, zero = f(1.0 / r), f(1.0), f(0.0)
    m = n_res - 1                       # nodes 1 .. n_res - 1
    # row k (node k + 1): -g v_k + 2g v_(k+1) - g v_(k+2) = 0, v_0 = 1
    cp = np.empty(m, dtype)
    dp = np.empty(m, dtype)
    diag, off = f(2) * g, -g
    c_prev, d_prev = zero, zero
    for k in range(m):
        rhs = g * one if k == 0 else zero
        den = diag - off * c_prev
        c_prev = off / den
        d_prev = (rhs - off * d_prev) / den
        cp[k], dp[k] = c_prev, d_prev
    v = np.empty(n_res, dtype)
    v[0] = one
    x = zero
    for k in range(m - 1, -1, -1):
        x = dp[k] - cp[k] * x
        v[k + 1] = x
    i_src = -(g * (v[0] - v[1]))
    return np.concatenate([v.astype(np.float64), [np.float64(i_src)]])
