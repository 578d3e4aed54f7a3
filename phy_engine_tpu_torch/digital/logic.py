"""4-state logic (L/H/X/Z) as bit-plane algebra (the port's copy of
``phy_engine_tpu/digital/logic.py``, on numpy integers).

Semantics are bit-exact with the reference truth tables in
``model/node/node.h:78-235``:

* ``&``: L dominates; H&H=H; any X/Z with non-L partner gives X
  (Z behaves as X at gate inputs).
* ``|``: H dominates; L|L=L; otherwise X.
* ``~``: ~L=H, ~H=L, ~X=~Z=X.
* ``^``: binary when both known, else X.

Encoding: state code = V + 2*U with planes  V(value), U(uncertain):
L=(0,0)->0, H=(1,0)->1, X=(0,1)->2, Z=(1,1)->3 — matching the reference's
enum values (node.h:25-36).

The plane representation packs 32 independent simulation lanes per uint32
word (the TPU-native recast of the CUDA u64 cone batching in
``src/pe_synth_cuda_u64_cones.cu:26-113``).  Every op below is pure
bitwise and works on numpy or torch integers alike.
"""

from __future__ import annotations

import numpy as np

# state codes (match reference enum order)
L, H, X, Z = 0, 1, 2, 3
STATE_CHARS = "01XZ"        # display: L->0, H->1


def code_to_planes(code):
    """code array -> (V, U) planes (same dtype)."""
    return code & 1, (code >> 1) & 1


def planes_to_code(v, u):
    return (v & 1) | ((u & 1) << 1)


# ---------------------------------------------------------------------------
# plane-wise gate kernels.  All take/return (V, U) uint32 planes; each bit
# position is an independent lane.
# ---------------------------------------------------------------------------

def _is_h(v, u):
    return v & ~u


def _is_l(v, u):
    return ~v & ~u


def op_and(va, ua, vb, ub):
    h = _is_h(va, ua) & _is_h(vb, ub)
    l = _is_l(va, ua) | _is_l(vb, ub)
    u = ~(h | l)
    return h, u


def op_or(va, ua, vb, ub):
    h = _is_h(va, ua) | _is_h(vb, ub)
    l = _is_l(va, ua) & _is_l(vb, ub)
    u = ~(h | l)
    return h, u


def op_not(va, ua):
    return _is_l(va, ua), ua


def op_yes(va, ua):
    # buffer: L->L, H->H, X/Z->X
    return _is_h(va, ua), ua


def op_xor(va, ua, vb, ub):
    known = ~ua & ~ub
    return (va ^ vb) & known, ~known


def op_xnor(va, ua, vb, ub):
    known = ~ua & ~ub
    return ~(va ^ vb) & known, ~known


def op_nand(va, ua, vb, ub):
    h, u = op_and(va, ua, vb, ub)
    return op_not(h, u)


def op_nor(va, ua, vb, ub):
    h, u = op_or(va, ua, vb, ub)
    return op_not(h, u)


def op_imp(va, ua, vb, ub):
    """implication a->b == (~a)|b (digital/logical/implication.h)."""
    na, nu = op_not(va, ua)
    return op_or(na, nu, vb, ub)


def op_nimp(va, ua, vb, ub):
    """non-implication a&(~b)."""
    nb, nu = op_not(vb, ub)
    return op_and(va, ua, nb, nu)


def op_case_eq(va, ua, vb, ub):
    """Verilog === : exact 4-state equality, always binary result."""
    eq = ~(va ^ vb) & ~(ua ^ ub)
    return eq, eq & 0


def op_is_unknown(va, ua):
    return ua, ua & 0


def op_mux(vs, us, va, ua, vb, ub):
    """2:1 mux: sel L -> a, sel H -> b, sel X/Z -> X unless a==b known."""
    sh = _is_h(vs, us)
    sl = _is_l(vs, us)
    v = (sl & va) | (sh & vb)
    u = (sl & ua) | (sh & ub)
    # unknown select: result X unless both inputs equal and known
    both_known_eq = ~ua & ~ub & ~(va ^ vb)
    xsel = us
    v = (v & ~xsel) | (xsel & both_known_eq & va)
    u = (u & ~xsel) | (xsel & ~both_known_eq)
    return v, u


def op_tri_state(vd, ud, ve, ue):
    """tri-state buffer: en H -> data(buffered, X/Z->X), en L -> Z, en X -> X."""
    eh = _is_h(ve, ue)
    el = _is_l(ve, ue)
    bv, bu = op_yes(vd, ud)
    v = (eh & bv) | el          # Z has V=1
    u = (eh & bu) | el | ue     # Z has U=1; en X -> X (V=0,U=1)
    return v, u


def op_resolve2(va, ua, vb, ub):
    """2-driver net resolution: Z yields the other driver; equal wins;
    conflict -> X (digital/logical/resolve2.h)."""
    az = ua & va
    bz = ub & vb
    eq = ~(va ^ vb) & ~(ua ^ ub)
    sel_b = az
    sel_a = ~az & bz
    sel_e = ~az & ~bz & eq
    conflict = ~az & ~bz & ~eq
    v = (sel_b & vb) | (sel_a & va) | (sel_e & va)
    u = (sel_b & ub) | (sel_a & ua) | (sel_e & ua) | conflict
    return v, u


# ---------------------------------------------------------------------------
# scalar (code-based) reference tables, used by the host-side behavioral
# simulator and tests.  Built from the plane kernels on numpy to guarantee
# the two representations agree.
# ---------------------------------------------------------------------------

def _build_table2(fn):
    t = np.zeros((4, 4), dtype=np.uint8)
    for a in range(4):
        for b in range(4):
            va, ua = np.uint32(a & 1), np.uint32((a >> 1) & 1)
            vb, ub = np.uint32(b & 1), np.uint32((b >> 1) & 1)
            v, u = fn(va, ua, vb, ub)
            t[a, b] = (int(v) & 1) | ((int(u) & 1) << 1)
    return t


def _build_table1(fn):
    t = np.zeros(4, dtype=np.uint8)
    for a in range(4):
        va, ua = np.uint32(a & 1), np.uint32((a >> 1) & 1)
        v, u = fn(va, ua)
        t[a] = (int(v) & 1) | ((int(u) & 1) << 1)
    return t


AND_TABLE = _build_table2(op_and)
OR_TABLE = _build_table2(op_or)
XOR_TABLE = _build_table2(op_xor)
XNOR_TABLE = _build_table2(op_xnor)
NAND_TABLE = _build_table2(op_nand)
NOR_TABLE = _build_table2(op_nor)
IMP_TABLE = _build_table2(op_imp)
NIMP_TABLE = _build_table2(op_nimp)
RESOLVE2_TABLE = _build_table2(op_resolve2)
NOT_TABLE = _build_table1(op_not)
YES_TABLE = _build_table1(op_yes)


def logic_and(a, b):
    return int(AND_TABLE[a, b])


def logic_or(a, b):
    return int(OR_TABLE[a, b])


def logic_xor(a, b):
    return int(XOR_TABLE[a, b])


def logic_not(a):
    return int(NOT_TABLE[a])


def resolve(a, b):
    return int(RESOLVE2_TABLE[a, b])


def state_char(code: int) -> str:
    return STATE_CHARS[code & 3]
