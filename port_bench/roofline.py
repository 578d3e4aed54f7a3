"""The yardstick of the kernels' roofline shares: published peaks and the
least work of each function, kept with the benchmark so that a change to
the program cannot move them.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit.  The
float32 peak is that of the CUDA cores: the port runs its factor path in
full float32 with TF32 off.  A program that moves to split-TF32 products
needs a benchmark change that re-bases these shares on the tensor-core
peak.

Counts are of the function, not of an algorithm: inverting an n x n
matrix takes 2 n^3 flops (LU, then the inverse from its factors), solving
one system (2/3) n^3 + 2 n^2 (LU, then one right-hand side through both
triangles); the operands are read once and the result written once, in
float32.  A matrix product (B, m, k) x (B, k, n) takes 2 B m n k flops
and reads and writes each operand once.
"""

from __future__ import annotations

FP32_FLOPS = 67e12            # float32 on the CUDA cores, dense
HBM_BPS = 3.35e12             # HBM3 bytes/s
F32_BYTES = 4


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the chip could take: the larger of the bytes over the
    memory peak and the operations over the float32 peak."""
    return max(nbytes / HBM_BPS, flops / FP32_FLOPS)


def gj_inverse_s(B: int, n: int) -> float:
    return least_seconds(F32_BYTES * B * 2 * n * n, B * 2.0 * n ** 3)


def gj_solve_s(B: int, n: int) -> float:
    return least_seconds(F32_BYTES * B * (n * n + 2 * n),
                         B * (2.0 * n ** 3 / 3.0 + 2.0 * n * n))


def bmm_s(B: int, m: int, k: int, n: int) -> float:
    return least_seconds(F32_BYTES * B * (m * k + k * n + m * n),
                         2.0 * B * m * n * k)
