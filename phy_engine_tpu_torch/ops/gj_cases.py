"""Test systems for the inverse and solve kernels (Gauss-Jordan and
blocked Gauss-Jordan), made with numpy from a seed.

Shared by the CPU parity tests and ``chip_smoke.py``, which hold the
kernels and their plain versions to the same systems:

* ``random``     — standard normal plus 4·sqrt(n) on the diagonal
                   (well conditioned);
* ``mna_border`` — the same with a voltage-source border: the last 8
                   rows/columns are zero except ±1 couplings to the first
                   16 nodes, so the border has structural-zero diagonals
                   and needs pivoting (``__graft_entry__.py:301-308``);
* ``singular``   — ``random`` with one lane's column 3 set to zero; that
                   lane must come out non-finite.
* ``block_singular`` — ``random`` with one lane's leading 32 x 32 block set
                   to zero and the rest untouched: the matrix stays
                   nonsingular, so the global-pivot GJ inverts the lane,
                   but the blocked inverse (``ops.lu_block``, whose pivot
                   search stays inside each diagonal block) must make it
                   non-finite.

Tolerance of a kernel or plain result against float64 numpy or against
another float32 elimination: ``TOL`` relative to max|x| of the lane —
two f32 eliminations accumulate their rounding in different orders.
"""

from __future__ import annotations

import numpy as np

TOL = 1e-4
BORDER = 8
BLOCK = 32        # the blocked inverse's diagonal block (lu_block.NB_BLOCK)


def singular_lane(B: int) -> int:
    return min(1, B - 1)


def system(case: str, B: int, n: int, seed: int = 0):
    """(A (B, n, n), b (B, n)) float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) + 4.0 * np.sqrt(n) * np.eye(n)
    b = rng.standard_normal((B, n))
    if case == "mna_border":
        kv = BORDER
        A[:, -kv:, :] = 0.0
        A[:, :, -kv:] = 0.0
        for k in range(kv):
            A[:, n - kv + k, 2 * k] = 1.0
            A[:, n - kv + k, 2 * k + 1] = -1.0
            A[:, 2 * k, n - kv + k] = 1.0
            A[:, 2 * k + 1, n - kv + k] = -1.0
    elif case == "singular":
        A[singular_lane(B), :, 3] = 0.0
    elif case == "block_singular":
        A[singular_lane(B), :BLOCK, :BLOCK] = 0.0
    elif case != "random":
        raise ValueError(case)
    return A.astype(np.float32), b.astype(np.float32)


def lane_rel_err(x, ref):
    """max |x - ref| / max |ref| per lane, over the trailing dims."""
    x = np.asarray(x, np.float64).reshape(len(ref), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    return np.abs(x - ref).max(axis=1) / np.abs(ref).max(axis=1)
