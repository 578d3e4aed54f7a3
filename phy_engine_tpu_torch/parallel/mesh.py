"""Multi-device scaling over a ``torch.distributed`` process group (port
of ``phy_engine_tpu/parallel/mesh.py``).

The JAX package runs SPMD under ``shard_map`` / ``jit`` over a device
``Mesh`` with axes ``("batch", "sweep")``: one body per device, joined by
``psum``.  The PyTorch idiom for SPMD is one process per device in a
``torch.distributed`` group, and that is how the port runs: **every rank
calls the same function on the same host inputs**, takes its own shard of
the work, and joins the others through the collectives below (gloo on the
CPU, NCCL on the card).  A ``DeviceMesh`` of the group stands for the
JAX ``Mesh``; :func:`make_mesh` builds it, and every function here also
takes a 1-D ``DeviceMesh`` with any dim name.

The return contract (what a rank gets back):

* by default every rank returns what the JAX controller gets, replicated:
  results sharded over the batch are all-gathered (``gather_rows``);
* ``sharded_batched_transient`` and ``sharded_batched_transient_shmap``
  return the rank's own contiguous batch shard — the shard JAX's
  ``P(("batch", "sweep"))`` places on that device — plus the replicated
  global ``ok``, so no rank ever holds more than B/D lanes.

Every host branch taken inside a collective region reads only an
all-reduced value (flags are reduced as int32: NCCL takes no bool), so
all ranks take the same path.

The mesh axes (the JAX package's):

* ``"batch"`` — independent circuits (Monte-Carlo, corners), the
  data-parallel axis; no communication in the hot loop;
* ``"sweep"`` — AC frequency points and parameter sweeps, the second
  embarrassingly parallel axis;
* the instances of one huge circuit (``tp_pad_ir`` /
  ``tp_assemble_sparse`` / ``tp_solve_op``): each rank stamps its slice of
  every family, the stamp values are summed across ranks, the MNA system
  and the solution are replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import F64
from ..engine import analog
from ..engine.lower import AnalogIR
from ..models.base import StampCtx

AXES = ("batch", "sweep")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

def mesh_shape(n: int) -> Tuple[int, int]:
    """The JAX package's factoring of n devices into (batch, sweep): the
    sweep axis is the largest power of two s with s * s <= n dividing n,
    the batch axis gets the larger factor n // s."""
    s = 1
    while n % (s * 2) == 0 and (s * 2) * (s * 2) <= n:
        s *= 2
    return n // s, s


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              device_type: str = "cuda"):
    """A ``("batch", "sweep")`` ``DeviceMesh`` over the process group.

    Uses the default process group when one is initialized (by torchrun,
    or by a spawner such as ``parallel.dryrun``); otherwise starts a world
    of size 1 on an in-memory ``HashStore`` — one process on one device.
    The backend follows ``device_type``: NCCL for "cuda", gloo for "cpu",
    with no fallback from one to the other.  On "cuda" the rank's device
    is ``cuda:{rank}`` (made current); a world larger than the card count
    raises.  ``shape`` defaults to :func:`mesh_shape` of the world size
    and must cover the whole world."""
    from torch.distributed.device_mesh import DeviceMesh

    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be one of {sorted(BACKENDS)}, "
                         f"got {device_type!r}")
    backend = BACKENDS[device_type]
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda'): no CUDA device; "
                           "the CPU mesh is make_mesh(device_type='cpu')")
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()!r}, "
                           f"device_type={device_type!r} needs {backend!r}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if device_type == "cuda":
        if world > torch.cuda.device_count():
            raise RuntimeError(f"world size {world} > "
                               f"{torch.cuda.device_count()} CUDA devices")
        torch.cuda.set_device(rank)
    shape = tuple(shape) if shape is not None else mesh_shape(world)
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} does not cover the world of "
                         f"{world} ranks")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=AXES)


def mesh_device(mesh) -> torch.device:
    """The calling rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_axes(mesh, axes=None) -> Tuple[str, ...]:
    """Normalize an axis spec: None = every mesh dim, a name, or names."""
    if axes is None:
        return tuple(mesh.mesh_dim_names)
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def _dim(mesh, name: str) -> int:
    return list(mesh.mesh_dim_names).index(name)


def axis_size(mesh, axes=None) -> int:
    """Number of ranks along ``axes`` (all mesh dims by default)."""
    return int(np.prod([mesh.size(_dim(mesh, a))
                        for a in mesh_axes(mesh, axes)]))


def axis_index(mesh, axes=None) -> int:
    """The rank's row-major flat coordinate over ``axes`` (what
    ``lax.axis_index`` gives over several axes)."""
    coord = mesh.get_coordinate()
    idx = 0
    for a in mesh_axes(mesh, axes):
        d = _dim(mesh, a)
        idx = idx * mesh.size(d) + coord[d]
    return idx


def psum(t, mesh, axes=None):
    """Sum of ``t`` over the ranks along ``axes``: one ``all_reduce`` per
    named axis group (issued at any group size, so a one-rank mesh runs
    the same collectives).  Returns a new tensor; bool tensors are
    reduced as int32 (NCCL takes no bool)."""
    out = t.to(torch.int32) if t.dtype == torch.bool else t.clone()
    for a in mesh_axes(mesh, axes):
        dist.all_reduce(out, group=mesh.get_group(a))
    return out


def psum_many(tensors: Sequence[torch.Tensor], mesh, axes=None):
    """``psum`` of several tensors of one dtype through one flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = psum(flat, mesh, axes)
    out, k = [], 0
    for t in tensors:
        out.append(flat[k:k + t.numel()].reshape(t.shape))
        k += t.numel()
    return out


def all_true(mesh, axes, *flags) -> Tuple[bool, ...]:
    """Host booleans: each flag (a bool tensor, reduced over its
    elements, or a bool) true on every rank along ``axes``."""
    dev = mesh_device(mesh)
    v = torch.stack([torch.as_tensor(f, device=dev).all().to(torch.int32)
                     for f in flags])
    n = axis_size(mesh, axes)
    return tuple(bool(k == n) for k in psum(v, mesh, axes).tolist())


def gather_rows(t, mesh, axes=None, dim: int = 0):
    """``all_gather`` of every rank's ``t`` along ``axes``, concatenated
    along ``dim`` in the flat ``axis_index`` order (each rank's ``t``
    must have the same shape).  Bool tensors travel as uint8."""
    is_bool = t.dtype == torch.bool
    out = t.to(torch.uint8) if is_bool else t.contiguous()
    for a in reversed(mesh_axes(mesh, axes)):       # innermost axis first
        parts = [torch.empty_like(out)
                 for _ in range(mesh.size(_dim(mesh, a)))]
        dist.all_gather(parts, out, group=mesh.get_group(a))
        out = torch.cat(parts, dim=dim)
    return out.bool() if is_bool else out


def shard_range(n: int, mesh, axes=None) -> Tuple[int, int]:
    """[start, stop) of the rank's contiguous shard of n (n % D == 0)."""
    D = axis_size(mesh, axes)
    if n % D:
        raise ValueError(f"{n} does not divide over {D} ranks")
    d = axis_index(mesh, axes)
    return d * (n // D), (d + 1) * (n // D)


def pad_rows(t, D: int):
    """``t`` with its leading dim padded to a multiple of D by repeating
    the last row."""
    pad = (-t.shape[0]) % D
    if pad:
        t = torch.cat([t, t[-1:].expand((pad,) + t.shape[1:])])
    return t


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# batch-sharded transients (the rank's shard comes back)
# ---------------------------------------------------------------------------

def _own_shard(mesh, axes, params_b, x_b, states_b):
    dev = mesh_device(mesh)
    lo, hi = shard_range(x_b.shape[0], mesh, axes)

    def take(a):
        return torch.as_tensor(a)[lo:hi].to(dev)
    return (_tree_map(take, params_b), take(x_b), _tree_map(take, states_b))


def sharded_batched_transient(ir: AnalogIR, mesh, params_b, x_b, states_b,
                              env, t0, dt, num_steps: int):
    """A batch of transients sharded over every mesh axis (the sweep axis
    folded into the batch): each rank runs ``parallel.batch.
    batched_transient`` (the per-lane dense Newton) on its contiguous
    shard of the B lanes (B % D == 0).

    Returns (x, states, ok_global): the rank's own (B/D, ...) shard of x
    and states, and the all-reduced every-lane-converged flag."""
    from .batch import batched_transient
    axes = mesh_axes(mesh)
    p, x, st = _own_shard(mesh, axes, params_b, x_b, states_b)
    x2, st2, ok, _last = batched_transient(ir, p, x, st, env, t0, dt,
                                           num_steps)
    return x2, st2, all_true(mesh, axes, ok)[0]


def sharded_batched_transient_shmap(ir: AnalogIR, mesh, params_b, x_b,
                                    states_b, env, t0, dt, num_steps: int,
                                    solver: str = "hybrid"):
    """Batch-sharded transient where every rank runs the whole explicit-
    batch delta-Newton pipeline — sparse residual assembly and the batched
    Gauss-Jordan solve (``gj_solve32`` on the card) — on ONLY its shard
    (``analog.transient_batched``).  Per-shard Newton loops run
    independently; the one collective is the final reduction that makes
    the convergence flag global.

    Returns (x, states, ok_global) as ``sharded_batched_transient``."""
    axes = mesh_axes(mesh)
    p, x, st = _own_shard(mesh, axes, params_b, x_b, states_b)
    x2, st2, ok, _last = analog.transient_batched(
        ir, p, x, st, env, t0, dt, num_steps, solver=solver)
    return x2, st2, all_true(mesh, axes, ok)[0]


# ---------------------------------------------------------------------------
# mask-padded instance sharding of one circuit
# ---------------------------------------------------------------------------

def tp_pad_ir(ir: AnalogIR, n_dev: int):
    """Pad every family's instance axis to a multiple of ``n_dev`` so every
    family shards.  Padded instances repeat the last real instance with
    ``mask = 0``: the assembler multiplies their stamp values to zero
    (``analog.apply_mask``), so their scatter targets are harmless.  The
    padded IR gets a fresh plan cache (its patterns are longer).

    Returns (padded_ir, pad_params) where ``pad_params(params)`` pads a
    parameter dict ({family: (n_inst, n_params)}, numpy or tensors) the
    same way."""
    pads = {}
    fams = []
    for fam in ir.families:
        n = len(fam.P)
        pad = (-n) % n_dev

        def rep(a, _p=pad):
            a = np.asarray(a)
            if _p == 0:
                return a
            return np.concatenate([a, np.repeat(a[-1:], _p, axis=0)])

        f2 = dataclasses.replace(
            fam, P=rep(fam.P), pin_nodes=rep(fam.pin_nodes),
            br_idx=rep(fam.br_idx), a_rows=rep(fam.a_rows),
            a_cols=rep(fam.a_cols), z_rows=rep(fam.z_rows),
            state0={k: rep(v) for k, v in fam.state0.items()})
        f2.mask = np.concatenate([np.ones(n), np.zeros(pad)])
        pads[fam.mdef.id_name] = pad
        fams.append(f2)
    ir2 = dataclasses.replace(ir, families=fams, cache=None)

    def pad_params(params):
        out = {}
        for key, P in params.items():
            P = torch.as_tensor(np.asarray(P) if not torch.is_tensor(P)
                                else P)
            p = pads.get(key, 0)
            if p:
                P = torch.cat([P, P[-1:].expand((p,) + P.shape[1:])])
            out[key] = P
        return out

    return ir2, pad_params


def pad_states(ir2: AnalogIR, states):
    """Pad each family's state vectors ({family: {var: (n_inst,)}}) to
    the padded IR's instance count by repeating the last instance; a
    family with no given state takes the padded IR's ``state0``."""
    out = {}
    for fam in ir2.families:
        key = fam.mdef.id_name
        st = states.get(key, fam.state0)
        out[key] = {}
        for k, v in st.items():
            v = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v)
            pad = len(fam.P) - v.shape[0]
            if pad:
                v = torch.cat([v, v[-1:].expand((pad,) + v.shape[1:])])
            out[key][k] = v
    return out


def sharded_stamper(mesh, axes=None):
    """A family stamp for ``analog.assemble_sparse(stamp=...)``: the rank
    stamps only its contiguous slice of the (padded) instance axis, every
    rank's values are placed in a zero (B, n_inst, ...) array and summed
    across ranks (one flat ``psum`` per family), and the mask applies.
    Each entry then has exactly one non-zero contributor, so the values —
    and the assembly's fixed-order sums after them — are bit-identical to
    the local stamp of the padded IR for any number of ranks."""
    axes = mesh_axes(mesh, axes)

    def stamp(ir, fam, params, x_ext, states, ctx):
        pins, brs = analog._family_index(ir, fam, x_ext.device)
        key = fam.mdef.id_name
        lo, hi = shard_range(len(fam.P), mesh, axes)
        st = states.get(key, {})
        a, z, st2 = fam.mdef.stamp(
            params[key][:, lo:hi], x_ext[:, pins[lo:hi]],
            x_ext[:, brs[lo:hi]], {k: v[:, lo:hi] for k, v in st.items()},
            ctx)
        names = sorted(st2)
        local = [a, z] + [st2[k] for k in names]
        full = []
        for t in local:
            f = t.new_zeros((t.shape[0], len(fam.P)) + t.shape[2:])
            f[:, lo:hi] = t
            full.append(f.to(F64) if f.dtype != F64 else f)
        full = psum_many(full, mesh, axes)
        full = [f.to(t.dtype) for f, t in zip(full, local)]
        a, z = analog.apply_mask(fam, full[0], full[1])
        return a, z, dict(zip(names, full[2:]))

    return stamp


def tp_assemble_sparse(ir: AnalogIR, mesh, params, x, states, env,
                       mode: str = "op"):
    """Instance-sharded sparse MNA assembly of ONE circuit: populations
    are mask-padded (``tp_pad_ir``) and split across every rank of the
    mesh; each rank stamps its slice (``sharded_stamper``).  ``params``:
    {family: (n_inst, n_params)}; ``x``: (n,); ``states``: {family: {var:
    (n_inst,)}}.  Returns the replicated padded-pattern (rows (nnz,), cols
    (nnz,), vals (nnz,), Z (n,)): the local assembly of the padded IR,
    bit for bit; dropping the padding entries gives the local assembly of
    ``ir`` itself."""
    D = axis_size(mesh)
    dev = mesh_device(mesh)
    ir2, pad_params = tp_pad_ir(ir, D)
    p = {k: v.to(dev, F64)[None] for k, v in pad_params(params).items()}
    st = _tree_map(lambda v: v.to(dev, F64)[None], pad_states(ir2, states))
    xv = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                         dtype=F64).to(dev)[None]
    ctx = StampCtx(mode=mode, t=0.0, dt=0.0, env=env)
    rows, cols, vals, Z, _st = analog.assemble_sparse(
        ir2, p, xv, st, ctx, stamp=sharded_stamper(mesh))
    return rows, cols, vals[0], Z[0]


def tp_solve_op(ir: AnalogIR, mesh, params, x0, states0, env,
                mode: str = "op"):
    """Operating point of ONE circuit with its device instances sharded
    across the mesh (``tp_assemble_sparse``'s stamping) and the dense
    MNA system and solution replicated: the per-lane dense Newton of
    ``analog.newton_solve`` with the sharded stamp.  Returns (x (n,),
    padded states, ok) replicated on every rank."""
    D = axis_size(mesh)
    dev = mesh_device(mesh)
    ir2, pad_params = tp_pad_ir(ir, D)
    p = {k: v.to(dev, F64)[None] for k, v in pad_params(params).items()}
    st = _tree_map(lambda v: v.to(dev, F64)[None], pad_states(ir2, states0))
    x = torch.as_tensor(np.asarray(x0) if not torch.is_tensor(x0) else x0,
                        dtype=F64).to(dev)[None]
    ctx = StampCtx(mode=mode, t=0.0, dt=0.0, env=env)
    x2, st2, ok = analog.newton_solve(ir2, p, x, st, ctx,
                                      stamp=sharded_stamper(mesh))
    return x2[0], _tree_map(lambda v: v[0], st2), bool(ok[0])
