"""Auto-layout for PhysicsLab scenes (the port's copy of
``phy_engine_tpu/io/layout.py``: host Python and numpy, positions equal to
the JAX package's).

Counterpart of ``phy_lab_wrapper/auto_layout/auto_layout.h:70-160``:
grid placement inside a bounding box with IO-aware columns (input-like
elements left, output-like right, auto_layout.h:908-910) and BFS
signal-flow levelling in between (the reference's spectral-ish weighted
embedding is the 'quality' mode; this is the 'fast' mode).
"""

from __future__ import annotations

from collections import deque, defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

INPUT_LIKE = {"Logic Input", "8bit Input", "Battery Source",
              "Sinewave Source", "Square Source", "Sawtooth Source",
              "Triangle Source", "Pulse Source"}
OUTPUT_LIKE = {"Logic Output", "8bit Display"}


@dataclass
class LayoutStats:
    columns: int = 0
    rows: int = 0
    placed: int = 0


def auto_layout(ex, spacing: float = 0.16, origin=(0.0, 0.0),
                max_rows: int = 32) -> LayoutStats:
    """Place ex.elements on a grid by signal-flow level."""
    n = len(ex.elements)
    if n == 0:
        return LayoutStats()
    idx = {el.identifier: i for i, el in enumerate(ex.elements)}
    succ: Dict[int, List[int]] = defaultdict(list)
    pred: Dict[int, List[int]] = defaultdict(list)
    for w in ex.wires:
        a = idx.get(w.source)
        b = idx.get(w.target)
        if a is None or b is None or a == b:
            continue
        succ[a].append(b)
        pred[b].append(a)

    level = [-1] * n
    dq = deque()
    for i, el in enumerate(ex.elements):
        if el.model_id in INPUT_LIKE or not pred[i]:
            level[i] = 0
            dq.append(i)
    while dq:
        i = dq.popleft()
        for j in succ[i]:
            if level[j] < level[i] + 1:
                level[j] = level[i] + 1
                if level[j] < n:
                    dq.append(j)
    maxl = max((l for l in level if l >= 0), default=0)
    for i, el in enumerate(ex.elements):
        if level[i] < 0:
            level[i] = maxl
        if el.model_id in OUTPUT_LIKE:
            level[i] = maxl + 1

    by_level: Dict[int, List[int]] = defaultdict(list)
    for i in range(n):
        by_level[level[i]].append(i)
    ox, oy = origin
    cols = 0
    rows = 0
    for li, col in enumerate(sorted(by_level)):
        members = by_level[col]
        cols += 1
        for r, i in enumerate(members):
            el = ex.elements[i]
            step = spacing * (2.0 if el.is_big else 1.0)
            x = ox + li * spacing * 2.0
            y = oy + (r % max_rows) * step + (r // max_rows) * 0.02
            el.position = (round(x, 3), round(y, 3), 0.0)
            rows = max(rows, r + 1)
    return LayoutStats(columns=cols, rows=rows, placed=n)


# ---------------------------------------------------------------------------
# quality mode: spectral embedding + occupancy snap + force refinement
# (auto_layout.h:614-1366 layout modes spectral/force; occupancy at
#  :179-330)
# ---------------------------------------------------------------------------

def _weighted_adjacency(ex, idx):
    import numpy as np
    n = len(ex.elements)
    rows, cols, w = [], [], []
    for wire in ex.wires:
        a = idx.get(wire.source)
        b = idx.get(wire.target)
        if a is None or b is None or a == b:
            continue
        rows += [a, b]
        cols += [b, a]
        w += [1.0, 1.0]
    A = np.zeros((n, n))
    if rows:
        np.add.at(A, (rows, cols), w)
    return A


def _top_eigenvectors(A, k: int, iters: int, seed: int):
    """Power iteration with deflation on the degree-normalized
    adjacency (auto_layout.h top_eigenvectors)."""
    import numpy as np
    n = A.shape[0]
    deg = A.sum(axis=1)
    inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)),
                        0.0)
    N = A * inv_sqrt[:, None] * inv_sqrt[None, :]
    rng = np.random.default_rng(seed)
    vecs = []
    for _ in range(k):
        v = rng.uniform(-1.0, 1.0, n)
        for b in vecs:
            v -= (v @ b) * b
        nv = np.linalg.norm(v)
        v = v / nv if nv > 0 else v
        for _ in range(iters):
            w = N @ v
            for b in vecs:
                w -= (w @ b) * b
            nw = np.linalg.norm(w)
            if nw <= 1e-18:
                v = rng.uniform(-1.0, 1.0, n)
                for b in vecs:
                    v -= (v @ b) * b
                nv = np.linalg.norm(v)
                v = v / nv if nv > 0 else v
                continue
            v = w / nw
        vecs.append(v)
    return vecs


class _Occupancy:
    """Grid occupancy with footprints + spiral free-cell search
    (auto_layout.h occupancy/choose_cell)."""

    def __init__(self, w: int, h: int):
        self.w = w
        self.h = h
        self.cells = {}

    def fits(self, cx: int, cy: int, fw: int, fh: int) -> bool:
        if cx < 0 or cy < 0 or cx + fw > self.w or cy + fh > self.h:
            return False
        return all((cx + dx, cy + dy) not in self.cells
                   for dx in range(fw) for dy in range(fh))

    def place(self, i: int, cx: int, cy: int, fw: int, fh: int):
        for dx in range(fw):
            for dy in range(fh):
                self.cells[(cx + dx, cy + dy)] = i

    def nearest_free(self, cx: int, cy: int, fw: int, fh: int,
                     max_radius: int):
        if self.fits(cx, cy, fw, fh):
            return cx, cy
        for r in range(1, max_radius + 1):
            for dx in range(-r, r + 1):
                for dy in (-r, r):
                    if self.fits(cx + dx, cy + dy, fw, fh):
                        return cx + dx, cy + dy
            for dy in range(-r + 1, r):
                for dx in (-r, r):
                    if self.fits(cx + dx, cy + dy, fw, fh):
                        return cx + dx, cy + dy
        return None


def auto_layout_quality(ex, spacing: float = 0.16, origin=(0.0, 0.0),
                        seed: int = 0xC0FFEE, iters: int = 64,
                        force_iterations: int = 100,
                        force_attraction: float = 0.05,
                        force_repulsion: float = 0.01) -> LayoutStats:
    """'quality' placement (auto_layout.h mode::spectral + force):

    1. spectral embedding — eigenvectors 2..3 of the degree-normalized
       wire adjacency give a connectivity-respecting 2D coordinate;
    2. force refinement — a few spring/repulsion steps tighten edges;
    3. occupancy snap — positions quantize onto a grid with 2x2
       footprints for big elements and spiral search to the nearest
       free cell.
    """
    import numpy as np
    n = len(ex.elements)
    if n == 0:
        return LayoutStats()
    idx = {el.identifier: i for i, el in enumerate(ex.elements)}
    A = _weighted_adjacency(ex, idx)
    vecs = _top_eigenvectors(A, 3, iters, seed)
    if len(vecs) >= 3:
        xs, ys = vecs[1].copy(), vecs[2].copy()
    else:
        rng = np.random.default_rng(seed)
        xs = rng.uniform(-1, 1, n)
        ys = rng.uniform(-1, 1, n)

    # force refinement (auto_layout.h force settings)
    for _ in range(force_iterations):
        fx = np.zeros(n)
        fy = np.zeros(n)
        rows, cols = np.nonzero(A)
        dx = xs[cols] - xs[rows]
        dy = ys[cols] - ys[rows]
        np.add.at(fx, rows, force_attraction * dx)
        np.add.at(fy, rows, force_attraction * dy)
        # local repulsion (all-pairs is fine at PhysicsLab scales)
        ddx = xs[:, None] - xs[None, :]
        ddy = ys[:, None] - ys[None, :]
        d2 = ddx * ddx + ddy * ddy + 1e-6
        fx += force_repulsion * (ddx / d2).sum(axis=1)
        fy += force_repulsion * (ddy / d2).sum(axis=1)
        xs += fx
        ys += fy

    # normalize to a grid; side scales with element count
    side = max(2, int(np.ceil(np.sqrt(n * 4.0))))
    def to_cell(v, lo, hi):
        if hi - lo < 1e-12:
            return np.zeros_like(v, dtype=int)
        t = (v - lo) / (hi - lo)
        return np.clip((t * (side - 1)).round().astype(int), 0,
                       side - 1)

    cx = to_cell(xs, xs.min(), xs.max())
    cy = to_cell(ys, ys.min(), ys.max())

    occ = _Occupancy(side + 2, side + 2)
    ox, oy = origin
    placed = 0
    order = np.argsort(-A.sum(axis=1))    # well-connected first
    maxr = side + 2
    for i in order:
        el = ex.elements[int(i)]
        fw = fh = 2 if el.is_big else 1
        cell = occ.nearest_free(int(cx[i]), int(cy[i]), fw, fh, maxr)
        if cell is None:
            cell = (0, 0)
        occ.place(int(i), cell[0], cell[1], fw, fh)
        el.position = (round(ox + cell[0] * spacing, 3),
                       round(oy + cell[1] * spacing, 3), 0.0)
        placed += 1
    return LayoutStats(columns=side, rows=side, placed=placed)


# ---------------------------------------------------------------------------
# layout locator (phy_lab_wrapper/layout_locator.h): corner markers ->
# affine scene frame
# ---------------------------------------------------------------------------

@dataclass
class CornerLocator:
    """Affine frame from four corner marker elements: locate(u, v)
    maps normalized [0,1]^2 scene coordinates into native positions
    (layout_locator.h corner_locator semantics)."""

    left_top: Tuple[float, float, float]
    left_bottom: Tuple[float, float, float]
    right_top: Tuple[float, float, float]
    right_bottom: Tuple[float, float, float]
    x_axis: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    y_axis: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @classmethod
    def from_experiment(cls, ex, left_top_model_id: str,
                        left_bottom_model_id: str,
                        right_top_model_id: str,
                        right_bottom_model_id: str) -> "CornerLocator":
        def find(mid):
            for el in ex.elements:
                if el.model_id == mid:
                    return tuple(el.position)
            return None

        corners = {name: find(mid) for name, mid in (
            ("left_top", left_top_model_id),
            ("left_bottom", left_bottom_model_id),
            ("right_top", right_top_model_id),
            ("right_bottom", right_bottom_model_id))}
        missing = [k for k, v in corners.items() if v is None]
        if missing:
            raise ValueError(
                f"corner_locator: missing marker(s): {missing}")
        lt, lb, rt, rb = (corners["left_top"], corners["left_bottom"],
                          corners["right_top"],
                          corners["right_bottom"])

        def sub(a, b):
            return tuple(x - y for x, y in zip(a, b))

        def avg(a, b):
            return tuple((x + y) * 0.5 for x, y in zip(a, b))

        x_axis = avg(sub(rt, lt), sub(rb, lb))
        y_axis = avg(sub(lt, lb), sub(rt, rb))
        return cls(lt, lb, rt, rb, x_axis, y_axis)

    def locate(self, u: float, v: float) -> Tuple[float, float, float]:
        """left_bottom + u*x_axis + v*y_axis."""
        return tuple(o + u * xa + v * ya for o, xa, ya in
                     zip(self.left_bottom, self.x_axis, self.y_axis))

    def grid(self, nx: int, ny: int):
        """nx*ny lattice positions across the frame (row-major,
        bottom-left origin) — the tetris-board placement helper the
        reference's layout_locator smoke test exercises."""
        out = []
        for j in range(ny):
            for i in range(nx):
                u = i / max(1, nx - 1)
                v = j / max(1, ny - 1)
                out.append(self.locate(u, v))
        return out
