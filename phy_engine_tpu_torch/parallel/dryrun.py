"""The multi-rank dry run (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``): every mesh path of the port, one
step on tiny shapes, in a world of ``n`` gloo ranks on the CPU.

Like the JAX package's (a CPU dry run in a child interpreter by design),
``dryrun_multichip(n)`` runs nothing in the calling process: it starts
``n`` processes, one a rank, joined by a ``FileStore`` in a fresh
temporary directory, and raises if any of them fails.  Each rank asserts
the world size, so a degraded one-rank world cannot pass.

``spawn_ranks`` / ``init_rank`` are the spawner and the rank prologue;
the tests' mesh cases use them too.  On a host with several cards the
port's mesh runs under ``torchrun --nproc-per-node=N``, which initializes
the process group that ``make_mesh`` then uses.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Callable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[2]     # holds the package


def init_rank(rank: int, world: int, store: str, timeout_s: float = 300.0):
    """Join the gloo world ``world`` as ``rank`` through the FileStore at
    ``store``, with one intra-op thread (ranks share the host's cores)."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))


def spawn_ranks(n: int, argv: Callable[[int], Sequence[str]],
                timeout: float = 600.0, cwd=None) -> List[str]:
    """Run ``python argv(rank)`` for rank 0..n-1 at once, with the package
    importable; wait for all of them (killing the rest when one fails or
    the timeout passes).  Returns their standard outputs; raises
    ``RuntimeError`` with every rank's output on a failure."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, *argv(r)], cwd=cwd, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs, failed = [], False
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                out, failed = "(timed out)", True
            outs.append(out)
            failed = failed or p.returncode != 0
            if failed:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        text = "\n".join(f"--- rank {r} ---\n{o}" for r, o in enumerate(outs))
        raise RuntimeError(f"a rank of {n} failed\n{text}")
    return outs


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> None:
    """Every mesh path over an ``n_devices``-rank gloo world (see the
    module docstring)."""
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        spawn_ranks(n_devices, lambda r: [
            "-m", "phy_engine_tpu_torch.parallel.dryrun", str(r),
            str(n_devices), store], timeout=timeout)


def _dryrun_body(n_devices: int) -> None:
    """The steps of the JAX package's ``_dryrun_body``, on this rank."""
    from .. import workloads
    from ..engine import analog
    from ..engine.circuit import AnalyzeType, Circuit
    from ..engine.lower import lower_analog
    from .batch import batch_params, batch_state, batch_x
    from .dist_gj import dist_solve
    from .mesh import (axis_size, make_mesh, sharded_batched_transient,
                       sharded_batched_transient_shmap, tp_assemble_sparse,
                       tp_solve_op)

    assert dist.get_world_size() == n_devices, (
        f"world of {dist.get_world_size()} ranks, wanted {n_devices}")
    mesh = make_mesh(device_type="cpu")
    per = axis_size(mesh)
    assert per == n_devices, f"mesh of {per} ranks, wanted {n_devices}"
    ir = lower_analog(workloads.rectifier_netlist())
    env = workloads.default_env()

    def jittered(B):
        return batch_params(ir, B, jitter={"R": {"r": 0.05}},
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")

    batch = -(-max(2 * n_devices, per) // per) * per
    x2, _st, ok = sharded_batched_transient(
        ir, mesh, jittered(batch), batch_x(ir, batch, "cpu"),
        batch_state(ir, batch, "cpu"), env, 0.0, 1e-6, 2)
    assert ok, "sharded transient did not converge"
    assert x2.shape[0] == batch // per and bool(torch.isfinite(x2).all())

    # every rank runs the delta-Newton / Gauss-Jordan pipeline on its
    # shard only
    bs = 2 * per
    xs2, _sts, oks = sharded_batched_transient_shmap(
        ir, mesh, jittered(bs), batch_x(ir, bs, "cpu"),
        batch_state(ir, bs, "cpu"), env, 0.0, 1e-6, 2)
    assert oks, "per-shard transient did not converge"
    assert xs2.shape[0] == bs // per, xs2.shape

    # the instances of one circuit sharded across the mesh
    c = Circuit(workloads.r_ladder_netlist(4 * per), solver="dense",
                device="cpu")
    c.set_analyze_type(AnalyzeType.DC)
    ir2 = c.prepare()
    xt, _stt, okt = tp_solve_op(ir2, mesh, c._params(),
                                analog.initial_x(ir2, "cpu"),
                                analog.initial_state(ir2, "cpu"),
                                c._env_scalars())
    assert okt and bool(torch.isfinite(xt).all()), "sharded OP failed"

    # mask-padded sharded assembly (an instance count that does not
    # divide the mesh)
    ir3 = lower_analog(workloads.r_ladder_netlist(
        4 * per + 2, 50.0 + np.arange(4 * per + 2)))
    _r, _c, vals, Z = tp_assemble_sparse(
        ir3, mesh, {f.mdef.id_name: f.P for f in ir3.families},
        np.zeros(ir3.n_unknowns), {f.mdef.id_name: f.state0
                                   for f in ir3.families}, env)
    assert bool(torch.isfinite(vals).all() and torch.isfinite(Z).all())

    # the cooperative single-system factorization, with an MNA voltage
    # source border (structural-zero diagonals)
    nD = 128 * per
    rng = np.random.default_rng(0)
    Ad = rng.standard_normal((nD, nD)) + 4.0 * np.sqrt(nD) * np.eye(nD)
    kv = 8
    Ad[-kv:, :] = 0.0
    Ad[:, -kv:] = 0.0
    for k in range(kv):
        Ad[nD - kv + k, 2 * k], Ad[nD - kv + k, 2 * k + 1] = 1.0, -1.0
        Ad[2 * k, nD - kv + k], Ad[2 * k + 1, nD - kv + k] = 1.0, -1.0
    bd = rng.standard_normal(nD)
    xd = dist_solve(mesh, Ad, bd, refine=2).numpy()
    xref = np.linalg.solve(Ad, bd)
    assert np.max(np.abs(xd - xref) / (1.0 + np.abs(xref))) < 1e-8, \
        "cooperative dist_solve mismatch"

    # the distributed fixed-step transient through Circuit(mesh=...)
    c.mesh = mesh
    c.tr.t_step, c.tr.t_stop = 1e-7, 2e-7
    c.set_analyze_type(AnalyzeType.TR)
    assert c.analyze(), "distributed transient failed"
    assert c.tr_history.shape[0] == 2
    assert np.all(np.isfinite(c.tr_history))


if __name__ == "__main__":
    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_rank(rank, world, store)
    try:
        _dryrun_body(world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"dryrun rank {rank} of {world} ok")
