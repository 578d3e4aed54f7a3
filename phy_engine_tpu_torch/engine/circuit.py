"""The ``Circuit`` driver: the user-facing analysis orchestrator (port of
``phy_engine_tpu/engine/circuit.py``).

API parity with ``phy_engine::circult`` (circuits/circuit.h:60-177):
``set_analyze_type`` / analysis settings / ``analyze()`` / ``reset()``,
with results sampled back onto the netlist objects (node voltages, branch
currents, device runtime state), plus the JAX package's extensions:
gmin stepping, adaptive TR, ``.DC`` / temperature sweeps, Monte-Carlo,
``.FOUR``, ``.TF``, ``.PZ``, ``.NOISE`` and ``.SENS``.  Digital devices
run through ``digital_clk`` (one tick of the levelled engine, alternating
with ``analyze()`` on a mixed-signal netlist: analog nets are sampled at
the tick and digital outputs on analog nets drive them as ideal sources in
every later analysis) and ``digital_run`` / ``digital_run_batch`` (many
ticks: the turbo kernel where it applies, else the levelled or the flash
engine).

``analyze()`` lowers the netlist once per structural version; parameter
edits (``set_attribute``) repack the parameter matrices at the next
analysis without relowering.  The persistent transient clock
``tr_duration`` carries across calls like the reference's.  Every tensor
lives on ``Circuit.device`` ("cuda" unless the caller passes "cpu").

OP, DC, TROP, TR and adaptive TR take the dense route (dense assembly,
the f64 Gauss-Jordan) below ``sparse_threshold`` unknowns and the sparse
route (COO assembly, the f64 BiCGStab of ``ops/sparse.py``, Jacobi or,
once Jacobi fails on the pattern, the chain preconditioner; no dense
matrix) at or above it, or as ``solver`` forces; AC, noise, sens and
the sweeps stay dense, as in the JAX package.

With ``mesh=`` (a ``parallel.mesh.make_mesh`` DeviceMesh; every rank of
the process group builds the same Circuit and calls the same analyses),
OP / DC and fixed-step TR of a pure-analog circuit run fully distributed
(``parallel/dist_newton.py``: instance-sharded stamping and the
cooperative column-sharded factorization), and AC shards its omega grid
over the mesh — or, with fewer points than ranks, factors each point's
system cooperatively.  Adaptive TR and mixed signal stay on the
single-device path.  The sweeps and ``digital_run_batch`` take their own
``mesh=``: their lanes shard over it and every rank gets the whole
result.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import F64
from ..models.base import DeviceClass, StampCtx
from ..netlist.netlist import Netlist, Node
from ..ops.linsolve import dense_solve
from ..parallel.batch import (batch_state, batch_x, batched_op,
                              batched_transient, jitter_params)
from . import analog
from .environment import Environment
from .lower import AnalogIR, lower_analog


class AnalyzeType(enum.Enum):
    """analyze.h:7-16."""
    OP = 0
    DC = 1
    AC = 2
    ACOP = 3
    TR = 4
    TROP = 5


class ACSweepType(enum.Enum):
    """analyzer/AC.h:7-25."""
    SINGLE = 0
    LINEAR = 1
    LOG = 2


@dataclass
class ACSettings:
    sweep: ACSweepType = ACSweepType.SINGLE
    omega: float = 1.0
    omega_start: float = 1.0
    omega_stop: float = 1e6
    points: int = 10


@dataclass
class TRSettings:
    t_stop: float = 1e-3
    t_step: float = 1e-6
    # adaptive stepping (the reference's unwired adapt_step, realized
    # as bounded step-halving): t_step is the max/initial step
    adaptive: bool = False
    dt_min: float = 0.0              # 0 -> t_step / 1024
    max_attempts: int = 0            # 0 -> 4x the fixed-step count


# DigitalEngine's backends (digital.BACKENDS), checked when a Circuit is
# built, before any digital device is lowered
DIGITAL_BACKENDS = ("device", "native")


def _mesh_device(mesh, device):
    """The rank's device on ``mesh``; ``device`` must name the same."""
    from ..parallel.mesh import mesh_device
    mdev = mesh_device(mesh)
    want = torch.device(device)
    if want.type != mdev.type or (want.index is not None
                                  and want.index != mdev.index):
        raise ValueError(f"Circuit(mesh=...) runs on the rank's device "
                         f"{mdev}, not {want}")
    return mdev


def _one(tree):
    """One circuit's tensors with a lane dimension of 1."""
    if torch.is_tensor(tree):
        return tree[None]
    return {k: _one(v) for k, v in tree.items()}


def _lane0(tree):
    if torch.is_tensor(tree):
        return tree[0]
    return {k: _lane0(v) for k, v in tree.items()}


class Circuit:
    def __init__(self, netlist: Optional[Netlist] = None,
                 env: Optional[Environment] = None, dtype=F64,
                 solver: str = "auto", sparse_threshold: int = 2048,
                 mesh=None, gmin_steps: int = 8, device="cuda",
                 digital_backend: str = "device"):
        """``solver``: 'auto' | 'dense' | 'sparse' ('auto' takes the sparse
        route at n >= ``sparse_threshold``, the reference's CUDA node
        threshold policy, circuit.h:115-121).  ``gmin_steps``: the
        gmin-stepping ladder's length on an OP/DC Newton failure (0
        disables).  ``device``: where every analysis runs.
        ``digital_backend``: the digital engine's ``backend`` ("device"
        or "native", the host sweep engine; see ``DigitalEngine``).
        ``mesh``: a ``parallel.mesh.make_mesh`` DeviceMesh (see the module
        docstring); the circuit then lives on the rank's device, and a
        ``device`` of another type or index raises."""
        if mesh is not None:
            device = _mesh_device(mesh, device)
        if solver not in ("auto", "dense", "sparse"):
            raise ValueError(f"unknown solver {solver!r}")
        self.nl = netlist if netlist is not None else Netlist()
        self.env = env if env is not None else Environment()
        self.solver = solver
        self.sparse_threshold = int(sparse_threshold)
        self.gmin_steps = int(gmin_steps)
        self.dtype = dtype
        self.device = torch.device(device)
        self.mesh = mesh
        if digital_backend not in DIGITAL_BACKENDS:
            raise ValueError(f"unknown digital backend {digital_backend!r}, "
                             f"expected one of {DIGITAL_BACKENDS}")
        self.digital_backend = digital_backend
        self.at = AnalyzeType.OP
        self.ac = ACSettings()
        self.tr = TRSettings()
        self.tr_duration = 0.0     # persistent transient clock
        self.ac_sweep_results: List[Tuple[float, np.ndarray]] = []
        self.tr_history: Optional[np.ndarray] = None  # (steps, N) waveforms
        self.tr_times: Optional[np.ndarray] = None

        self._ir: Optional[AnalogIR] = None
        self._x = None               # last solution vector (n,)
        self._states = None          # {family: {var: (n_inst,)}}
        self._digital = None         # DigitalEngine of the digital devices
        self._drives = None          # last digital->analog drive arrays

    # -- settings (reference: set_analyze_type / get_analyze_setting) ----
    def set_analyze_type(self, at: AnalyzeType):
        self.at = at

    def get_netlist(self) -> Netlist:
        return self.nl

    # -- compilation -------------------------------------------------------
    def prepare(self, force: bool = False) -> AnalogIR:
        """Lower the netlist (cached on its structural version) and seed
        the solution from node voltages and branch currents (a warm
        restart) and the device states from the instances' runtime."""
        if self._ir is not None and not force \
                and self._ir.version == self.nl.version:
            return self._ir
        self._digital = None
        n_drive = 0
        if any(m.mdef.device_class == DeviceClass.DIGITAL
               for m in self.nl.live_models()):
            from ..digital.engine import DigitalEngine
            self._digital = DigitalEngine(self.nl, self.device,
                                          self.digital_backend)
            n_drive = self._digital.n_drive_slots
        ir = lower_analog(self.nl, max_drive_slots=n_drive)
        ir.version = self.nl.version
        self._ir = ir
        if self._digital is not None:
            self._digital.bind(ir.n_nodes)
        self._drives = None
        x = np.zeros(ir.n_unknowns)
        warm = False
        for i, node in enumerate(ir.node_list):
            x[i] = node.voltage.real
            warm = warm or node.voltage.real != 0.0
        for fam in ir.families:
            for inst in fam.instances:
                for br in inst.branches:
                    if br.index >= 0 and br.current.real != 0.0:
                        x[br.index] = br.current.real
                        warm = True
        self._x = (torch.as_tensor(x, dtype=self.dtype, device=self.device)
                   if warm else analog.initial_x(ir, self.device, self.dtype))
        st = {k: {v: a.clone() for v, a in d.items()}    # not IR's state0
              for k, d in analog.initial_state(ir, "cpu", self.dtype).items()}
        for fam in ir.families:
            key = fam.mdef.id_name
            for i, inst in enumerate(fam.instances):
                for sname in st[key]:
                    if sname in inst.runtime:
                        st[key][sname][i] = float(inst.runtime[sname])
        self._states = {k: {v: a.to(self.device) for v, a in d.items()}
                        for k, d in st.items()}
        return ir

    def digital_engine(self):
        """The digital engine of the netlist's digital devices."""
        self.prepare()
        if self._digital is None:
            raise ValueError("no digital content")
        return self._digital

    def _params(self) -> Dict[str, torch.Tensor]:
        """Repack the parameter matrices from the instances' params."""
        ir = self.prepare()
        out = {}
        for fam in ir.families:
            P = np.zeros((len(fam.instances),
                          max(1, len(fam.mdef.param_order))))
            for i, inst in enumerate(fam.instances):
                if fam.mdef.param_order:
                    P[i, :] = fam.mdef.pack_params(inst.params)
            out[fam.mdef.id_name] = torch.as_tensor(P, dtype=self.dtype,
                                                    device=self.device)
        return out

    def _env_scalars(self):
        return analog.env_scalars(self.env)

    def _method(self) -> str:
        if self.solver in ("dense", "sparse"):
            return self.solver
        n = self._ir.n_unknowns if self._ir is not None else 0
        return "sparse" if n >= self.sparse_threshold else "dense"

    def _newton(self, mode: str, params, x, st, env, max_iter=None):
        ctx = StampCtx(mode=mode, t=float(self.tr_duration), dt=0.0, env=env)
        kw = {} if max_iter is None else {"max_iter": max_iter}
        x2, st2, ok = analog.newton_solve(self._ir, _one(params), x[None],
                                          _one(st), ctx, drives=self._drives,
                                          method=self._method(), **kw)
        return x2[0], _lane0(st2), bool(ok[0])

    # -- analysis ----------------------------------------------------------
    def analyze(self) -> bool:
        ir = self.prepare()
        at = self.at
        if at in (AnalyzeType.OP, AnalyzeType.DC):
            return self._analyze_op("op" if at == AnalyzeType.OP else "dc")
        if at == AnalyzeType.TROP:
            ok = self._analyze_op("trop")
            return ok and self._analyze_tr()
        if at == AnalyzeType.TR:
            return self._analyze_tr()
        if at == AnalyzeType.ACOP:
            if not self._analyze_op("op"):
                return False
            return self._analyze_ac()
        if at == AnalyzeType.AC:
            if ir.nonlinear:
                # bias point first so nonlinear devices save their
                # linearization (circuit.h:199-209)
                if not self._analyze_op("op"):
                    return False
            return self._analyze_ac()
        raise ValueError(f"unsupported analyze type {at}")

    def _analyze_op(self, mode: str) -> bool:
        params = self._params()
        if (self.mesh is not None and mode in ("op", "dc")
                and self._drives is None):
            # distributed route: sharded stamping + cooperative
            # column-sharded factorization over the mesh
            from ..parallel.dist_newton import newton_solve_dist
            x, st_pad, ok = newton_solve_dist(
                self._ir, self.mesh, params, self._x, self._states,
                self._env_scalars(), mode=mode)
            # drop the instance padding so the stored state feeds later
            # single-device analyses
            st = self._unpad_states(self._ir, st_pad) if ok else self._states
        else:
            x, st, ok = self._newton(mode, params, self._x, self._states,
                                     self._env_scalars())
            if not ok and self.gmin_steps > 0:
                x, st, ok = self._gmin_stepping(mode, params)
        if ok:
            self._x, self._states = x, st
            self._writeback(x.cpu().numpy())
        return ok

    def _gmin_stepping(self, mode: str, params):
        """Gmin-stepping homotopy (convergence aid on OP/DC failure — the
        reference has none; its solve() simply returns false,
        circuit.h:892-985).  A large conductance from every node to ground
        makes the system near-linear; the ladder walks it back down to the
        environment's g_min (never below SPICE's GMIN = 1e-12, where a
        genuinely floating node is defined), warm-starting each rung from
        the previous solution, each with a 1024-iteration budget (junction
        vlimit walks at 2·Ut an iteration).  The end point must then pass
        a row-wise residual check: a Δx-stationary point is not
        necessarily a solution."""
        env = dict(self._env_scalars())
        g_final = max(float(env.get("g_min", 0.0)), 1e-12)
        ladder = np.logspace(-2.0, np.log10(g_final), self.gmin_steps)
        x, st = self._x, self._states
        for g in ladder:
            env["g_min"] = float(g)
            x2, st2, ok = self._newton(mode, params, x, st, env,
                                       max_iter=1024)
            if not ok:
                return x, st, False
            x, st = x2, st2
        ctx = StampCtx(mode="op" if mode in ("op", "dc") else mode,
                       t=float(self.tr_duration), dt=0.0, env=env)
        rel = float(self._row_residual(ctx, params, x, st).max())
        if not np.isfinite(rel) or rel > 1e-6:
            return x, st, False
        return x, st, True

    @staticmethod
    def _unpad_states(ir, st_pad):
        """Truncate ``tp_pad_ir``'s instance padding back to the real
        instance counts."""
        return {fam.mdef.id_name: {k: v[:len(fam.instances)]
                                   for k, v in st_pad.get(
                                       fam.mdef.id_name, {}).items()}
                for fam in ir.families}

    def _row_residual(self, ctx, params, x, st):
        """|A x - Z| / (|A| |x| + |Z|) row by row at (x, st) — densely on
        the dense route; on the sparse route from the COO values through
        the layout's row plans (a dense A at 1e5 unknowns would be 80 GB):
        the same formula, each row summed in a fixed order."""
        if self._method() == "sparse":
            _r, _c, vals, Z, _ = analog.assemble_sparse(
                self._ir, _one(params), x[None], _one(st), ctx, self._drives)
            lay = analog.coo_layout(self._ir, self._drives)
            vals, Z = vals[0], Z[0]
            resid = (lay.matvec(vals, x) - Z).abs()
            row_scale = lay.matvec(vals.abs(), x.abs()) + Z.abs()
        else:
            A, Z, _ = analog.assemble(self._ir, _one(params), x[None],
                                      _one(st), ctx, self._drives)
            A, Z = A[0], Z[0]
            resid = (A @ x - Z).abs()
            row_scale = A.abs() @ x.abs() + Z.abs()
        return resid / row_scale.clamp(min=1e-30)

    def _analyze_tr(self) -> bool:
        if self.tr.adaptive:
            return self._analyze_tr_adaptive()
        params = self._params()
        dt = self.tr.t_step
        num_steps = max(1, int(round(self.tr.t_stop / dt)))
        if self.mesh is not None and self._drives is None \
                and self._digital is None:
            return self._analyze_tr_dist(params, dt, num_steps)
        x, st, ok, xs = analog.transient(
            self._ir, _one(params), self._x[None], _one(self._states),
            self._env_scalars(), self.tr_duration, dt, num_steps,
            drives=self._drives, method=self._method())
        ok = bool(ok[0])
        if ok:
            self._x, self._states = x[0], _lane0(st)
            self.tr_history = xs[0].cpu().numpy()
            self.tr_times = self.tr_duration + dt * np.arange(1, num_steps + 1)
            self.tr_duration += num_steps * dt
            self._writeback(self._x.cpu().numpy())
            self._observe_tr_substeps()
        return ok

    def _analyze_tr_dist(self, params, dt: float, num_steps: int) -> bool:
        """Fixed-step TR with sharded stamping and the cooperative
        factorization in every Newton iteration."""
        from ..parallel.dist_newton import transient_dist
        x, st_pad, ok, xs = transient_dist(
            self._ir, self.mesh, params, self._x, self._states,
            self._env_scalars(), self.tr_duration, dt, num_steps)
        if ok:
            self._x = x
            self._states = self._unpad_states(self._ir, st_pad)
            self.tr_history = np.asarray(xs)
            self.tr_times = self.tr_duration + dt * np.arange(1, num_steps + 1)
            self.tr_duration += num_steps * dt
            self._writeback(x.cpu().numpy())
        return ok

    def _analyze_tr_adaptive(self) -> bool:
        """Step-halving transient: t_step is the max step; failed Newton
        solves retry at dt/2 down to dt_min."""
        params = self._params()
        dt0 = self.tr.t_step
        n_fixed = max(1, int(round(self.tr.t_stop / dt0)))
        max_attempts = self.tr.max_attempts or 4 * n_fixed
        dt_min = self.tr.dt_min or dt0 / 1024.0
        x, st, ok, ts, xs, acc = analog.transient_adaptive(
            self._ir, _one(params), self._x[None], _one(self._states),
            self._env_scalars(), self.tr_duration, dt0,
            self.tr_duration + self.tr.t_stop, max_attempts, dt_min,
            drives=self._drives, method=self._method())
        if ok:
            self._x, self._states = x[0], _lane0(st)
            self.tr_history = xs[0].cpu().numpy()[acc]
            self.tr_times = ts[acc]
            self.tr_duration += self.tr.t_stop
            self._writeback(self._x.cpu().numpy())
            self._observe_tr_substeps()
        return ok

    def _omega_grid(self) -> np.ndarray:
        a = self.ac
        if a.sweep == ACSweepType.SINGLE:
            return np.array([a.omega])
        if a.sweep == ACSweepType.LINEAR:
            return np.linspace(a.omega_start, a.omega_stop, a.points)
        return np.logspace(np.log10(a.omega_start), np.log10(a.omega_stop),
                           a.points)

    def _tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.float64),
                               dtype=self.dtype, device=self.device)

    def _analyze_ac(self) -> bool:
        grid = self._omega_grid()
        params = self._params()
        if self.mesh is not None:
            from ..parallel import mesh as pm
            D = pm.axis_size(self.mesh)
            if len(grid) < D:
                # too few omegas to occupy the mesh as a sweep axis:
                # factor each point's 2n-real system with its columns
                # sharded over the mesh instead
                from ..parallel.dist_newton import ac_solve_dist
                try:
                    xs = ac_solve_dist(self._ir, self.mesh, params,
                                       self._states, grid)
                except RuntimeError:
                    return False
            else:
                # shard the grid (padded by repeating its last point)
                w = pm.pad_rows(self._tensor(grid), D)
                lo, hi = pm.shard_range(len(w), self.mesh)
                re, im = analog.ac_sweep(self._ir, params, self._states,
                                         w[lo:hi])
                xs = pm.gather_rows(torch.cat([re, im], dim=1),
                                    self.mesh)[:len(grid)].cpu().numpy()
                n = self._ir.n_unknowns
                xs = xs[:, :n] + 1j * xs[:, n:]
        else:
            xs_re, xs_im = analog.ac_sweep(self._ir, params, self._states,
                                           self._tensor(grid))
            xs = xs_re.cpu().numpy() + 1j * xs_im.cpu().numpy()
        if not np.all(np.isfinite(xs)):
            return False
        self.ac_sweep_results = [(float(w), xs[i])
                                 for i, w in enumerate(grid)]
        # write back the last sweep point like capture_solution_vector
        self._writeback_complex(xs[-1])
        return True

    # -- noise and sensitivity (extensions of the JAX package) ------------
    def noise(self, out_node: Node, src=None):
        """Small-signal noise sweep over the AC ω grid (SPICE .NOISE):
        the output voltage noise PSD [V²/Hz] at ``out_node`` by the
        adjoint-network method (``engine/noise.py``); ``src`` an optional
        V-source whose branch row gives the unit excitation for the
        input-referred PSD.  Runs an OP first so nonlinear devices hold
        their bias-point linearizations.  Returns a ``NoiseResult`` or
        None when the bias point fails."""
        from .noise import NoiseResult, noise_sweep
        self.prepare()
        if not self._analyze_op("op"):
            return None
        out_idx = self._node_index(out_node)
        src_row = None if src is None else self._src_row(src, "noise")
        grid = self._omega_grid()
        onoise, gain2, contribs = noise_sweep(
            self._ir, self._params(), self._x, self._states,
            self._tensor(grid), out_idx, src_row, self._env_scalars())
        return NoiseResult(grid / (2.0 * np.pi), onoise, gain2, contribs)

    def sens(self, out):
        """SPICE .SENS (DC): d(out)/d(param) for every parameter of every
        device at the OP, one reverse sweep through the assembly and the
        adjoint solve (``engine/sens.py``).  ``out`` is a Node (its
        voltage) or a branch device such as a V source (its branch
        current).  Returns a ``SensResult`` or None when the bias point
        fails."""
        from .sens import SensResult, sens_op
        self.prepare()
        if not self._analyze_op("op"):
            return None
        params = self._params()
        grads = sens_op(self._ir, params, self._x, self._states,
                        self._env_scalars(), self._out_index(out),
                        self._drives)
        return SensResult(self._ir, grads, params)

    def sens_ac(self, out):
        """SPICE .SENS (AC): d|V(out)|/d(param) over the AC ω grid,
        chained through the bias point and the saved small-signal
        linearizations.  Returns ``(freqs, mag, SensResult)`` — each row
        value an (nω,) array — or None when the bias point fails."""
        from .sens import SensResult, sens_ac
        self.prepare()
        if not self._analyze_op("op"):
            return None
        params = self._params()
        grid = self._omega_grid()
        mag, grads = sens_ac(self._ir, params, self._x, self._states,
                             self._env_scalars(), self._out_index(out),
                             self._tensor(grid), self._drives)
        return (grid / (2.0 * np.pi), mag.cpu().numpy(),
                SensResult(self._ir, grads, params))

    # -- sweeps ------------------------------------------------------------
    def _node_index(self, node: Node) -> int:
        ir = self.prepare()
        for i, nd in enumerate(ir.node_list):
            if nd is node:
                return i
        raise ValueError("node is not part of the lowered circuit")

    def _out_index(self, out) -> int:
        """Unknown-vector index of an output spec: a Node (its voltage) or
        a branch device (its branch current)."""
        if isinstance(out, Node):
            return self._node_index(out)
        brs = getattr(out, "branches", ())
        if brs and brs[0].index >= 0:
            return int(brs[0].index)
        raise ValueError("output must be a node or a branch device")

    def _run_batched_op(self, params_b, nv: int, mesh=None):
        """Shared tail of the sweep analyses: every lane's OP from x = 0
        and the initial device states — with ``mesh``, each rank solves
        its contiguous shard of the lanes (padded to the rank count by
        repeating the last lane) and the results are all-gathered, the
        padding dropped."""
        ir = self._ir
        pb, dev = params_b, self.device
        if mesh is not None:
            from ..parallel import mesh as pm
            dev = pm.mesh_device(mesh)
            D = pm.axis_size(mesh)
            pb = {k: pm.pad_rows(v, D) for k, v in params_b.items()}
            lo, hi = pm.shard_range(len(next(iter(pb.values()))), mesh)
            pb = {k: v[lo:hi].to(dev) for k, v in pb.items()}
        B = len(next(iter(pb.values())))
        x, _st, ok = batched_op(ir, pb, batch_x(ir, B, dev, self.dtype),
                                batch_state(ir, B, dev, self.dtype),
                                self._env_scalars())
        if mesh is not None:
            x = pm.gather_rows(x, mesh)[:nv]
            ok = pm.gather_rows(ok, mesh)[:nv]
        return (x.cpu().numpy(), ok.cpu().numpy(),
                {k: v.cpu().numpy() for k, v in params_b.items()})

    def _sweep_params(self, nv: int):
        return {k: P.expand((nv,) + P.shape).clone()
                for k, P in self._params().items()}

    def _family_col(self, inst, pname: str):
        ir = self.prepare()
        for fam in ir.families:
            if inst in fam.instances:
                return (fam.mdef.id_name, fam.instances.index(inst),
                        fam.mdef.param_order.index(pname))
        raise ValueError("instance is not part of the lowered circuit")

    def dc_sweep(self, inst, pname: str, values, out=None, mesh=None):
        """SPICE .DC — step one device parameter (classically a source
        voltage) over a grid, solving the operating point at every grid
        value in one batched program (a lane per value).  ``out``:
        optional Node or branch device whose (nv,) trace the result's
        ``out`` holds.  Mixed-signal circuits are not swept (digital
        drives are per-tick state).  Does not disturb the circuit's stored
        solution.  ``mesh``: a DeviceMesh — the grid's lanes shard over
        every axis of it (see `_run_batched_op`).  Returns a
        :class:`SweepResult`."""
        ir = self.prepare()
        if ir.n_drive_slots:
            raise ValueError("dc_sweep does not support mixed-signal "
                             "circuits (use digital_clk interleave)")
        key, i, j = self._family_col(inst, pname)
        vals = np.asarray(values, np.float64)
        nv = len(vals)
        params_b = self._sweep_params(nv)
        params_b[key][:, i, j] = self._tensor(vals)
        x, ok, pb = self._run_batched_op(params_b, nv, mesh)
        res = SweepResult(ir, vals, x, ok, pb)
        if out is not None:
            res.out = res.trace(out)
        return res

    def temp_sweep(self, temps, out=None, mesh=None):
        """Global temperature sweep (.STEP TEMP class): the OP at every
        temperature in one batched program, each lane setting the ``Temp``
        parameter of every family that has one.  ``mesh``: as in
        `dc_sweep`.  Returns a :class:`SweepResult` (``values`` = temps in
        °C)."""
        ir = self.prepare()
        if ir.n_drive_slots:
            raise ValueError("temp_sweep does not support mixed-signal "
                             "circuits")
        temps = np.asarray(temps, np.float64)
        nv = len(temps)
        tj = self._tensor(temps)
        params_b = self._sweep_params(nv)
        for fam in ir.families:
            if "Temp" in fam.mdef.param_order:
                j = fam.mdef.param_order.index("Temp")
                params_b[fam.mdef.id_name][:, :, j] = tj[:, None]
        x, ok, pb = self._run_batched_op(params_b, nv, mesh)
        res = SweepResult(ir, temps, x, ok, pb)
        if out is not None:
            res.out = res.trace(out)
        return res

    def monte_carlo(self, jitter, n: int,
                    generator: Optional[torch.Generator] = None,
                    analysis: str = "op", t_stop: float = 0.0,
                    t_step: float = 0.0, mesh=None):
        """Monte-Carlo over lognormal parameter jitter as one batched
        program.  ``jitter``: {family id_name: {param: rel_sigma}}, each
        named column multiplied by exp(sigma · N(0, 1)) drawn per lane and
        instance from ``generator`` (default: seed 0).  ``analysis``:
        'op', or 'tr' (fixed-step transient of ``t_stop`` / ``t_step``,
        waveforms kept per lane).  Returns a :class:`SweepResult` whose
        ``params`` hold the sampled values; for 'tr' ``history`` is
        (n, steps, N).  ``mesh``: 'op' lanes shard over it as in
        `dc_sweep` ('tr' with its waveforms stays on the rank; the
        final-state sharded transient is ``parallel.mesh.
        sharded_batched_transient``)."""
        ir = self.prepare()
        if ir.n_drive_slots:
            raise ValueError("monte_carlo does not support "
                             "mixed-signal circuits")
        if analysis not in ("op", "tr"):
            raise ValueError("analysis must be 'op' or 'tr'")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params_b = jitter_params(ir, self._params(), n, jitter, generator,
                                 self.device)
        if analysis == "op":
            x, ok, pb = self._run_batched_op(params_b, n, mesh)
            return SweepResult(ir, np.arange(n), x, ok, pb)
        dt = t_step or self.tr.t_step
        steps = max(1, int(round((t_stop or self.tr.t_stop) / dt)))
        x, _st, ok, xs = batched_transient(
            ir, params_b, batch_x(ir, n, self.device, self.dtype),
            batch_state(ir, n, self.device, self.dtype),
            self._env_scalars(), 0.0, dt, steps, keep_trace=True)
        res = SweepResult(ir, np.arange(n), x.cpu().numpy(),
                          ok.cpu().numpy(),
                          {k: v.cpu().numpy() for k, v in params_b.items()})
        res.history = xs.cpu().numpy()
        res.times = dt * np.arange(1, steps + 1)
        return res

    # -- post-processing and small-signal analyses -------------------------
    def four(self, fundamental: float, out, harmonics: int = 9):
        """SPICE .FOUR — Fourier analysis of the last transient waveform
        at ``out``: the final ``1/fundamental`` window of ``tr_history``,
        linearly resampled onto a uniform grid.  Returns a
        :class:`FourierResult` (harmonics 0..``harmonics``, THD)."""
        if self.tr_history is None or self.tr_times is None:
            raise ValueError("run a transient first (.FOUR analyzes "
                             "tr_history)")
        idx = self._out_index(out)
        t = np.asarray(self.tr_times, np.float64)
        y = np.asarray(self.tr_history[:, idx], np.float64)
        T = 1.0 / float(fundamental)
        t_end = t[-1]
        t_start = t_end - T
        if t_start < t[0] - 1e-15:
            raise ValueError("transient shorter than one fundamental "
                             "period")
        m = max(64, 16 * (harmonics + 1))
        tg = np.linspace(t_start, t_end, m, endpoint=False)
        yg = np.interp(tg, t, y)
        coeff = np.fft.rfft(yg) / m
        n_avail = min(harmonics, m // 2 - 1)
        amps = np.zeros(harmonics + 1)
        phases = np.zeros(harmonics + 1)
        amps[0] = coeff[0].real
        for k in range(1, n_avail + 1):
            amps[k] = 2.0 * np.abs(coeff[k])
            # SPICE phase convention: component as A·cos(kωt + φ)
            # relative to the window start
            phases[k] = np.degrees(np.angle(coeff[k]))
        return FourierResult(float(fundamental), amps, phases)

    def _src_row(self, src, what: str) -> int:
        brs = getattr(src, "branches", ())
        if not brs or brs[0].index < 0:
            raise ValueError(f"{what} src must be a branch device (V source)")
        return int(brs[0].index)

    def tf(self, out_node: Node, src):
        """SPICE .TF — DC small-signal transfer function.  Returns ``(gain,
        rin, rout)``: gain = dV(out)/dV(src), rin the input resistance
        seen by the V-source ``src``, rout the output resistance at
        ``out_node`` with the source shorted.  Runs an OP first; solves
        the DC-linearized system with a unit E on the source row and with
        a unit current into ``out_node``."""
        ir = self.prepare()
        if not self._analyze_op("op"):
            return None
        out_idx = self._node_index(out_node)
        src_row = self._src_row(src, "tf")
        Ar = analog.assemble_ac(ir, self._params(), self._states,
                                self._tensor([0.0]))[0]
        n = ir.n_unknowns
        b = torch.zeros((2, n), dtype=self.dtype, device=self.device)
        b[0, src_row] = 1.0
        b[1, out_idx] = 1.0
        xs = dense_solve(Ar.expand(2, n, n), b).cpu().numpy()
        # the source branch current under unit E: rin = -E/i (the branch
        # constraint is v = E with current flowing out of +)
        i_src = float(xs[0, src_row])
        rin = float("inf") if i_src == 0.0 else -1.0 / i_src
        return float(xs[0, out_idx]), rin, float(xs[1, out_idx])

    def pz(self, out_node: Node, src):
        """SPICE .PZ — poles and zeros of v(out)/e(src).  Every AC stamp is
        G + jωC, so one assembly at ω = 1 gives G = Re A and C = Im A;
        poles solve det(G + sC) = 0, zeros the bordered pencil
        det([[G + sC, b_src], [e_outᵀ, 0]]) = 0 (scipy on the host).
        Returns ``(poles, zeros)`` in rad/s (finite eigenvalues only).
        Runs an OP first."""
        import scipy.linalg as sla
        ir = self.prepare()
        if not self._analyze_op("op"):
            return None
        out_idx = self._node_index(out_node)
        src_row = self._src_row(src, "pz")
        Ar, Ai, _zr, _zi = analog.assemble_ac(ir, self._params(),
                                              self._states,
                                              self._tensor([1.0]))
        G = Ar[0].cpu().numpy()
        C = Ai[0].cpu().numpy()
        n = ir.n_unknowns

        def finite_eigs(M0, M1):
            # det(M0 + s·M1) = 0  ->  M0 v = s·(−M1) v, s = λ directly
            lam = sla.eigvals(M0, -M1)
            lam = lam[np.isfinite(lam)]
            # scipy encodes some infinite generalized eigenvalues as huge
            # finite numbers when M1 is nearly singular; clip by magnitude
            # against the pencil scale
            scale = (np.linalg.norm(M0, np.inf) /
                     max(np.linalg.norm(M1, np.inf), 1e-300))
            return lam[np.abs(lam) < 1e6 * max(scale, 1.0)]

        poles = finite_eigs(G, C)
        b = np.zeros((n, 1))
        b[src_row, 0] = 1.0
        c_row = np.zeros((1, n))
        c_row[0, out_idx] = 1.0
        M0 = np.block([[G, b], [c_row, np.zeros((1, 1))]])
        M1 = np.block([[C, np.zeros((n, 1))], [np.zeros((1, n + 1))]])
        return poles, finite_eigs(M0, M1)

    # -- digital -----------------------------------------------------------
    def digital_clk(self) -> bool:
        """One digital tick (circuit.h:298-354): sample the analog nets at
        the present solution, run the levelled tick, and keep its drive
        requests for the following analyses."""
        if self._digital is None:
            self.prepare()
        if self._digital is None:
            return True
        analog_v = self._node_voltages()
        # advance the Tsu/Th unsteady-state automata at tick time (TR
        # substeps between ticks feed them too — _analyze_tr)
        self._digital.observe_analog(analog_v, self.tr_duration)
        self._drives = self._digital.tick(analog_v)
        return True

    def _observe_tr_substeps(self):
        """Feed every accepted TR substep's solution into the digital
        Tsu/Th automata so setup/hold X windows follow the analog
        trajectory between ticks (and.h:161-363)."""
        eng = self._digital
        if eng is None or not eng.has_unsteady():
            return
        if self.tr_history is None or self.tr_times is None:
            return
        n = self._ir.n_nodes
        for t, row in zip(np.asarray(self.tr_times),
                          np.asarray(self.tr_history)):
            eng.observe_analog(row[:n], float(t))

    def digital_inputs(self) -> Dict[str, object]:
        """Named runtime-settable INPUT devices (synth constants are
        excluded)."""
        return {m.name: m for m in self.nl.live_models()
                if m.mdef.digital_op == "INPUT"
                and not m.params.get("synth_const") and m.name}

    def digital_outputs(self) -> Dict[str, object]:
        """Named OUTPUT/display devices."""
        return {m.name: m for m in self.nl.live_models()
                if m.mdef.digital_op in ("OUTPUT", "OUTPUT8") and m.name}

    def digital_run(self, schedule) -> "DigitalTrace":
        """Run ``len(schedule)`` digital ticks in one device program.

        ``schedule``: per tick, a dict {INPUT model -> value} overriding
        that device's attribute for the tick; unlisted INPUT devices
        hold their current attribute value.  A value is either a 4-state
        code (0/1/2/3, broadcast to all 32 stimulus lanes) or a tuple
        ``(v_word, u_word)`` of 32-bit planes giving each lane its own
        4-state value.  Analog-sampled nets read the present node
        voltages; VERILOG_MODULE devices need digital_clk().  Returns a
        :class:`DigitalTrace`."""
        eng, fs, FV, FU = self._compile_schedule(schedule)
        return DigitalTrace(eng, eng.run_ticks(fs, FV, FU,
                                               self._node_voltages()))

    def _compile_schedule(self, schedule):
        eng = self.digital_engine()
        ir = eng.ir
        sig_of = {}
        base = {}
        for inst, out_sigs in ir.inputs:
            if inst.mdef.digital_op == "INPUT":
                sig_of[id(inst)] = out_sigs[0]
                base[out_sigs[0]] = int(
                    inst.params.get("boolean", 2)) & 3
        fs = sorted(base)
        pos = {s: k for k, s in enumerate(fs)}
        T = len(schedule)
        FV = np.zeros((T, len(fs)), np.uint32)
        FU = np.zeros((T, len(fs)), np.uint32)
        FULL32 = np.uint32(0xFFFFFFFF)
        for t, entry in enumerate(schedule):
            codes = dict(base)
            for inst, code in entry.items():
                s = sig_of.get(id(inst))
                if s is None:
                    raise ValueError("not a digital INPUT device")
                codes[s] = code
            for s, code in codes.items():
                if isinstance(code, tuple):
                    FV[t, pos[s]] = np.uint32(code[0] & 0xFFFFFFFF)
                    FU[t, pos[s]] = np.uint32(code[1] & 0xFFFFFFFF)
                else:
                    code = int(code) & 3
                    FV[t, pos[s]] = FULL32 if (code & 1) else 0
                    FU[t, pos[s]] = FULL32 if (code & 2) else 0
        return eng, np.array(fs, np.int32), FV, FU

    def digital_run_batch(self, schedules, watch_nodes, mesh=None,
                          axis: str = "batch"):
        """Run B independent copies of the design, one schedule each (all
        the same length), from the current state.  ``watch_nodes``: nets
        whose per-tick 4-state codes are recorded.  ``mesh`` / ``axis``:
        shard the instances over that DeviceMesh axis (each rank runs its
        contiguous shard; every rank gets all B histories).  Returns int8
        codes of shape [B, T, len(watch_nodes)] (lane 0)."""
        compiled = [self._compile_schedule(s) for s in schedules]
        eng, fs = compiled[0][:2]
        FV = np.stack([c[2] for c in compiled])
        FU = np.stack([c[3] for c in compiled])
        watch = [eng.ir.node_sig.get(id(n), 0) for n in watch_nodes]
        hv, hu = eng.run_ticks_batched(fs, FV, FU, watch=watch, mesh=mesh,
                                       axis=axis)
        v = (hv & 1).astype(np.int8)
        u = (hu & 1).astype(np.int8)
        return v | (u << 1)

    def node_digital(self, node) -> int:
        """4-state code (0=L,1=H,2=X,3=Z) of a digital net."""
        return self.digital_engine().signal_code(node)

    # -- result access -----------------------------------------------------
    def _node_voltages(self) -> np.ndarray:
        ir = self.prepare()
        if self._x is None:
            return np.zeros(ir.n_nodes)
        return self._x.cpu().numpy()[:ir.n_nodes]

    def _writeback(self, x: np.ndarray):
        ir = self._ir
        for i, node in enumerate(ir.node_list):
            node.voltage = complex(x[i])
        for fam in ir.families:
            st = {k: v.cpu().numpy()
                  for k, v in self._states[fam.mdef.id_name].items()}
            for i, inst in enumerate(fam.instances):
                for br in inst.branches:
                    br.current = complex(x[br.index])
                inst.runtime = {k: float(v[i]) for k, v in st.items()}

    def _writeback_complex(self, x: np.ndarray):
        ir = self._ir
        for i, node in enumerate(ir.node_list):
            node.voltage = complex(x[i])
        for fam in ir.families:
            for inst in fam.instances:
                for br in inst.branches:
                    br.current = complex(x[br.index])

    def node_voltage(self, node: Node) -> complex:
        if node.is_ground:
            return 0.0 + 0.0j
        return node.voltage

    def tr_waveform(self, node: Node) -> np.ndarray:
        """Time series of a node voltage over the last TR run."""
        idx = self._ir.index_of(node)
        if idx < 0:
            return np.zeros(0 if self.tr_history is None
                            else self.tr_history.shape[0])
        return self.tr_history[:, idx]

    def reset(self):
        """reset() (circuit.h:446-465): clear solution + transient clock."""
        self.tr_duration = 0.0
        self.ac_sweep_results = []
        self.tr_history = None
        self._ir = None
        self._x = None
        self._states = None
        self._digital = None
        self._drives = None
        for n in self.nl.all_nodes():
            n.voltage = 0.0 + 0.0j


class FourierResult:
    """Result of Circuit.four: harmonic amplitudes (index k = harmonic k of
    the fundamental; index 0 = DC), phases in degrees, and total harmonic
    distortion."""

    def __init__(self, f0: float, amps: np.ndarray, phases: np.ndarray):
        self.fundamental = f0
        self.amps = amps
        self.phases = phases

    @property
    def thd(self) -> float:
        """sqrt(Σ_{k≥2} A_k²) / A_1 (the SPICE .FOUR THD, as a ratio)."""
        a1 = self.amps[1]
        if a1 == 0.0:
            return float("inf")
        return float(np.sqrt(np.sum(self.amps[2:] ** 2)) / a1)


class SweepResult:
    """Result of Circuit.dc_sweep / temp_sweep / monte_carlo.

    ``values`` — the sweep grid (or lane indices for MC); ``x`` — (nv, N)
    solutions; ``ok`` — (nv,) per-point convergence; ``params`` — the
    per-lane parameter matrices actually used (family id → (nv, n_inst,
    n_param)).  For MC transients, ``history`` is (nv, steps, N) and
    ``times`` the step times."""

    def __init__(self, ir, values, x, ok, params):
        self.ir = ir
        self.values = np.asarray(values)
        self.x = x
        self.ok = ok
        self.params = params
        self.out = None
        self.history = None
        self.times = None

    def _idx(self, out) -> int:
        if isinstance(out, Node):
            i = self.ir.index_of(out)
            if i < 0:
                raise ValueError("node is not a lowered analog net")
            return i
        brs = getattr(out, "branches", ())
        if brs and brs[0].index >= 0:
            return int(brs[0].index)
        raise ValueError("output must be a node or a branch device")

    def trace(self, out) -> np.ndarray:
        """(nv,) value of a node voltage / branch current per point."""
        return self.x[:, self._idx(out)]

    def waveform(self, out) -> np.ndarray:
        """(nv, steps) transient waveforms (MC 'tr' only)."""
        if self.history is None:
            raise ValueError("no transient history on this result")
        return self.history[:, :, self._idx(out)]

    def param_of(self, inst, pname: str) -> np.ndarray:
        """(nv,) the sampled/swept parameter value per lane."""
        for fam in self.ir.families:
            if inst in fam.instances:
                i = fam.instances.index(inst)
                j = fam.mdef.param_order.index(pname)
                return self.params[fam.mdef.id_name][:, i, j]
        raise KeyError("instance is not part of the lowered circuit")


class DigitalTrace:
    """Per-tick 4-state history from Circuit.digital_run (lane 0)."""

    def __init__(self, eng, hist):
        sv, su = hist
        self._eng = eng
        self.sv = np.asarray(sv)
        self.su = np.asarray(su)

    def __len__(self):
        return self.sv.shape[0]

    def node_codes(self, node, lane: int = 0) -> np.ndarray:
        """4-state code of a net at every tick (one stimulus lane)."""
        sig = self._eng.ir.node_sig.get(id(node))
        if sig is None:
            return np.full(len(self), 2, np.int8)
        v = ((self.sv[:, sig] >> np.uint32(lane)) & 1).astype(np.int8)
        u = ((self.su[:, sig] >> np.uint32(lane)) & 1).astype(np.int8)
        return v | (u << 1)

    def bus_values(self, nodes, lane: int = 0) -> np.ndarray:
        """Unsigned value of a bus (LSB-first node list) per tick;
        unknown bits read as 0."""
        out = np.zeros(len(self), np.int64)
        for i, n in enumerate(nodes):
            c = self.node_codes(n, lane)
            out |= ((c == 1).astype(np.int64)) << i
        return out

    def bus_values_lanes(self, nodes) -> np.ndarray:
        """(T, 32) bus values across every stimulus lane."""
        T = len(self)
        out = np.zeros((T, 32), np.int64)
        for i, n in enumerate(nodes):
            sig = self._eng.ir.node_sig.get(id(n))
            if sig is None:
                continue
            v = self.sv[:, sig]
            u = self.su[:, sig]
            for lane in range(32):
                bit = ((v >> np.uint32(lane)) & 1) & ~((u >> np.uint32(lane)) & 1)
                out[:, lane] |= bit.astype(np.int64) << i
        return out
