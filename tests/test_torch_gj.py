"""Port parity of the Gauss-Jordan kernels' plain versions
(``gj_solve32_plain`` / ``gj_inverse32_plain``) against the JAX
package's ``gj_solve32`` / ``gj_inverse32`` on the CPU (their XLA path,
the plain reference of the two Pallas kernels) and against float64
numpy; and the wrappers' CPU routing and input checks.  The CUDA
kernels are held to the plain versions in ``test_torch_cuda.py``.

Tolerance: ``gj_cases.TOL`` (1e-4) relative to max|x| of the lane, since
the two f32 eliminations accumulate in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phy_engine_tpu.ops import gj as jgj

from phy_engine_tpu_torch.ops import gj
from phy_engine_tpu_torch.ops.gj_cases import TOL, lane_rel_err, singular_lane, system

# tiny tensors: torch's intra-op threads would only contend with the
# other test worker processes
torch.set_num_threads(1)


def _np_solve(A, b):
    return np.linalg.solve(A.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]


def _np_inv(A):
    return np.linalg.inv(A.astype(np.float64))


@pytest.mark.parametrize("case", ["random", "mna_border"])
@pytest.mark.parametrize("n", [128, 256])
def test_solve_plain_matches_jax_and_numpy(n, case):
    A, b = system(case, 4, n, seed=n)
    x = gj.gj_solve32_plain(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    xj = np.asarray(jgj.gj_solve32(jnp.asarray(A), jnp.asarray(b)))
    ref = _np_solve(A, b)
    assert x.dtype == np.float32 and x.shape == (4, n)
    assert lane_rel_err(x, xj).max() <= TOL
    assert lane_rel_err(x, ref).max() <= TOL
    assert lane_rel_err(xj, ref).max() <= TOL


@pytest.mark.parametrize("case", ["random", "mna_border"])
@pytest.mark.parametrize("n", [128, 256])
def test_inverse_plain_matches_jax_and_numpy(n, case):
    A, _b = system(case, 4, n, seed=n + 1)
    X = gj.gj_inverse32_plain(torch.from_numpy(A)).numpy()
    Xj = np.asarray(jgj.gj_inverse32(jnp.asarray(A)))
    ref = _np_inv(A)
    assert X.dtype == np.float32 and X.shape == (4, n, n)
    assert lane_rel_err(X, Xj).max() <= TOL
    assert lane_rel_err(X, ref).max() <= TOL
    assert lane_rel_err(Xj, ref).max() <= TOL


def test_singular_lane_nonfinite_in_both_packages():
    B, n = 4, 128
    A, b = system("singular", B, n, seed=5)
    s = singular_lane(B)
    others = [i for i in range(B) if i != s]
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    outs = {
        "solve": (gj.gj_solve32_plain(At, bt).numpy(),
                  np.asarray(jgj.gj_solve32(jnp.asarray(A), jnp.asarray(b)))),
        "inverse": (gj.gj_inverse32_plain(At).numpy(),
                    np.asarray(jgj.gj_inverse32(jnp.asarray(A)))),
    }
    for name, (mine, ref) in outs.items():
        for out in (mine, ref):
            assert not np.isfinite(out[s]).all(), name
            assert np.isfinite(out[others]).all(), name
        assert lane_rel_err(mine[others], ref[others]).max() <= TOL, name


def test_wrappers_route_cpu_tensors_to_plain_versions():
    gj.gj_solve32.launches = 0
    gj.gj_inverse32.launches = 0
    A, b = system("mna_border", 2, 128, seed=9)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    assert torch.equal(gj.gj_solve32(At, bt), gj.gj_solve32_plain(At, bt))
    assert torch.equal(gj.gj_inverse32(At), gj.gj_inverse32_plain(At))
    assert gj.gj_solve32.launches == 0
    assert gj.gj_inverse32.launches == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    A, b = system("random", 2, 128)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    with pytest.raises(TypeError):
        gj.gj_solve32(At.double(), bt)
    with pytest.raises(TypeError):
        gj.gj_inverse32(At.half())
    with pytest.raises(ValueError):
        gj.gj_inverse32(At[:, :100, :100].contiguous())     # n % 128
    with pytest.raises(ValueError):
        gj.gj_inverse32(At.transpose(1, 2))                  # not contiguous
    with pytest.raises(ValueError):
        gj.gj_solve32(At, bt[:1])                            # batch mismatch
    with pytest.raises(ValueError):
        gj.gj_solve32(At[0], bt[0])                          # not batched


# ---------------------------------------------------------------------------
# solve_batched: tests/test_gj.py:20-93's cases, port against the JAX
# package (its XLA route on the CPU) and float64 numpy
# ---------------------------------------------------------------------------

def _np_solve64(A, b):
    return np.linalg.solve(A, b[..., None])[..., 0]


def _both_batched(A, b, **kw):
    x = gj.solve_batched(torch.from_numpy(A), torch.from_numpy(b), **kw)
    xj = np.asarray(jgj.solve_batched(jnp.asarray(A), jnp.asarray(b), **kw))
    assert x.dtype == torch.float64 and x.shape == b.shape
    return x.numpy(), xj


def _zero_diagonal_mna(n, seed):
    """Voltage-source rows: structural zeros on the diagonal."""
    rng = np.random.default_rng(seed)
    A = np.zeros((2, n, n))
    for bi in range(2):
        for i in range(n - 2):
            g = 10 ** rng.uniform(-3, 2)
            j = int(rng.integers(0, n - 2))
            A[bi, i, i] += g
            A[bi, j, j] += g
            A[bi, i, j] -= g
            A[bi, j, i] -= g
        for i in range(n - 2):
            A[bi, i, i] += 1e-2
        A[bi, n - 2, 0] = A[bi, 0, n - 2] = 1.0
        A[bi, n - 1, 5] = A[bi, 5, n - 1] = 1.0
    return A, rng.standard_normal((2, n))


def test_solve_batched_random_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((4, 128, 128)) + 5 * np.eye(128)
    b = rng.standard_normal((4, 128))
    x, xj = _both_batched(A, b)
    xe = _np_solve64(A, b)
    for got in (x, xj):
        assert np.max(np.abs(got - xe) / np.maximum(np.abs(xe), 1e-9)) < 1e-7
    assert np.max(np.abs(x - xj) / np.maximum(np.abs(xe), 1e-9)) < 1e-7


def test_solve_batched_zero_diagonal_pivoting_matches_jax():
    A, b = _zero_diagonal_mna(130, 1)             # pads to 256
    x, xj = _both_batched(A, b)
    xe = _np_solve64(A, b)
    for got in (x, xj):
        assert np.max(np.abs(got - xe) / np.maximum(np.abs(xe), 1e-9)) < 1e-6


@pytest.mark.parametrize("n", [4, 60, 128, 200])
def test_solve_batched_padding_sizes_match_jax(n):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((3, n, n)) + 4 * np.eye(n)
    b = rng.standard_normal((3, n))
    x, xj = _both_batched(A, b)
    xe = _np_solve64(A, b)
    assert np.max(np.abs(x - xe)) < 1e-6
    assert np.max(np.abs(x - xj)) < 1e-6


def test_solve_batched_extreme_scaling_matches_jax():
    """Rows / cols spanning 1e-12..1e3 (gmin against a big conductance):
    the port's scales are exact powers of two (frexp), the JAX package's
    come from exp2 (inexact on XLA's CPU for |e| >= 13); both hold 1e-6."""
    rng = np.random.default_rng(3)
    n = 128
    A = rng.standard_normal((1, n, n)) + 10 * np.eye(n)
    A = A * (10.0 ** rng.uniform(-12, 3, n))[None, :, None] \
        * (10.0 ** rng.uniform(-6, 6, n))[None, None, :]
    b = rng.standard_normal((1, n)) * (10.0 ** rng.uniform(-12, 3, n))[None]
    x, xj = _both_batched(A, b, refine=3)
    xe = _np_solve64(A, b)
    for got in (x, xj):
        assert np.max(np.abs(got - xe) / np.maximum(np.abs(xe), 1e-12)) < 1e-6


def test_solve_batched_singular_lane_is_nan_as_in_jax():
    rng = np.random.default_rng(4)
    n = 128
    sing = np.zeros((n, n))
    sing[0, :] = 1.0                                # rank 1
    A = np.stack([rng.standard_normal((n, n)) + 5 * np.eye(n), sing])
    b = rng.standard_normal((2, n))
    x, xj = _both_batched(A, b)
    for got in (x, xj):
        assert np.all(np.isfinite(got[0]))
        assert not np.all(np.isfinite(got[1]))


def test_solve_batched_keeps_dtype_and_scales_exactly():
    A = torch.eye(128, dtype=torch.float32)[None] * 3.0
    b = torch.ones((1, 128), dtype=torch.float32)
    x = gj.solve_batched(A, b)
    assert x.dtype == torch.float32
    assert torch.equal(x, torch.full((1, 128), 1.0 / 3.0))
    for dt in (torch.float32, torch.float64):
        v = torch.tensor([1e-300 if dt == torch.float64 else 1e-30, 0.7,
                          1.0, 3.0, 8192.0, 3e5], dtype=dt)
        p = gj.pow2_recip_floor(v)
        ref = torch.exp2(-torch.floor(torch.log2(v.double()))).to(dt)
        assert torch.equal(p, ref)
