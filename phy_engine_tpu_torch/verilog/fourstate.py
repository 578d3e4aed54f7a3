"""4-state vector value algebra for the Verilog runtime.

A value is ``Val(v, u, width, signed)`` where integer bit-planes follow
the engine-wide encoding (digital/logic.py): bit code = v + 2u, so
0=(0,0), 1=(1,0), X=(0,1), Z=(1,1).  Unsized Python ints hold arbitrary
widths.

Semantics follow IEEE 1364 as implemented by the reference runtime
(digital.h eval_expr): arithmetic/relational/shift with any unknown
operand bit yields all-X; bitwise ops propagate per-bit via the same
truth tables as the gate engine; ``===``/``!==`` compare exact codes;
logical ops reduce through 0/1/X.
"""

from __future__ import annotations

from dataclasses import dataclass


def mask(width: int) -> int:
    return (1 << width) - 1


@dataclass(frozen=True)
class Val:
    v: int
    u: int
    width: int
    signed: bool = False

    @staticmethod
    def make(v, u, width, signed=False) -> "Val":
        m = mask(width)
        return Val(v & m, u & m, width, signed)

    @staticmethod
    def from_int(x: int, width: int, signed: bool = False) -> "Val":
        return Val.make(x, 0, width, signed)

    @staticmethod
    def all_x(width: int) -> "Val":
        m = mask(width)
        return Val(0, m, width, False)

    @staticmethod
    def all_z(width: int) -> "Val":
        m = mask(width)
        return Val(m, m, width, False)

    @property
    def known(self) -> bool:
        return self.u == 0

    def to_int(self) -> int:
        """Unsigned integer interpretation (X/Z bits read as 0)."""
        return self.v & ~self.u & mask(self.width)

    def to_signed_int(self) -> int:
        x = self.to_int()
        if self.signed and self.width > 0 and (x >> (self.width - 1)) & 1:
            x -= (1 << self.width)
        return x

    def arith_int(self) -> int:
        return self.to_signed_int() if self.signed else self.to_int()

    def bit(self, i: int) -> int:
        """4-state code of bit i (out of range -> X)."""
        if i < 0 or i >= self.width:
            return 2
        return ((self.v >> i) & 1) | (((self.u >> i) & 1) << 1)

    def __repr__(self):  # pragma: no cover
        return f"Val({self.fmt()})"

    def fmt(self) -> str:
        out = []
        for i in reversed(range(self.width)):
            out.append("01xz"[self.bit(i)])
        return f"{self.width}'b" + "".join(out)


ZERO1 = Val(0, 0, 1)
ONE1 = Val(1, 0, 1)
X1 = Val(0, 1, 1)


def resize(a: Val, width: int, signed=None) -> Val:
    """Truncate or extend (sign-extend if signed, else zero/X-extend of
    the top bit's unknown-ness is NOT propagated — standard zero ext)."""
    if signed is None:
        signed = a.signed
    if width == a.width:
        return Val(a.v, a.u, width, signed)
    if width < a.width:
        return Val.make(a.v, a.u, width, signed)
    # extend
    if a.signed and a.width > 0:
        top_v = (a.v >> (a.width - 1)) & 1
        top_u = (a.u >> (a.width - 1)) & 1
        ext = mask(width) ^ mask(a.width)
        v = a.v | (ext if top_v else 0)
        u = a.u | (ext if top_u else 0)
        return Val(v, u, width, signed)
    return Val(a.v, a.u, width, signed)


def _binary_ctx(a: Val, b: Val):
    w = max(a.width, b.width)
    signed = a.signed and b.signed
    return resize(a, w, None), resize(b, w, None), w, signed


# ---- bitwise ---------------------------------------------------------------

def v_and(a: Val, b: Val) -> Val:
    a, b, w, s = _binary_ctx(a, b)
    ha, hb = a.v & ~a.u, b.v & ~b.u
    la, lb = ~a.v & ~a.u, ~b.v & ~b.u
    h = ha & hb
    l = la | lb
    u = ~(h | l)
    return Val.make(h, u, w, s)


def v_or(a: Val, b: Val) -> Val:
    a, b, w, s = _binary_ctx(a, b)
    ha, hb = a.v & ~a.u, b.v & ~b.u
    la, lb = ~a.v & ~a.u, ~b.v & ~b.u
    h = ha | hb
    l = la & lb
    u = ~(h | l)
    return Val.make(h, u, w, s)


def v_xor(a: Val, b: Val) -> Val:
    a, b, w, s = _binary_ctx(a, b)
    known = ~a.u & ~b.u
    return Val.make((a.v ^ b.v) & known, ~known, w, s)


def v_xnor(a: Val, b: Val) -> Val:
    a, b, w, s = _binary_ctx(a, b)
    known = ~a.u & ~b.u
    return Val.make(~(a.v ^ b.v) & known, ~known, w, s)


def v_not(a: Val) -> Val:
    h = ~a.v & ~a.u
    return Val.make(h, a.u, a.width, a.signed)


# ---- reductions ------------------------------------------------------------

def red_and(a: Val) -> Val:
    m = mask(a.width)
    if (~a.v & ~a.u) & m:
        return ZERO1
    if a.u & m:
        return X1
    return ONE1


def red_or(a: Val) -> Val:
    m = mask(a.width)
    if a.v & ~a.u & m:
        return ONE1
    if a.u & m:
        return X1
    return ZERO1


def red_xor(a: Val) -> Val:
    if a.u:
        return X1
    return Val(bin(a.v & mask(a.width)).count("1") & 1, 0, 1)


# ---- logical ---------------------------------------------------------------

def truthy(a: Val):
    """Verilog truth: 1 if any known 1 bit; 0 if all known 0; else None."""
    m = mask(a.width)
    if a.v & ~a.u & m:
        return True
    if (a.u & m) == 0:
        return False
    return None


def log_not(a: Val) -> Val:
    t = truthy(a)
    return X1 if t is None else (ZERO1 if t else ONE1)


def log_and(a: Val, b: Val) -> Val:
    ta, tb = truthy(a), truthy(b)
    if ta is False or tb is False:
        return ZERO1
    if ta is None or tb is None:
        return X1
    return ONE1


def log_or(a: Val, b: Val) -> Val:
    ta, tb = truthy(a), truthy(b)
    if ta is True or tb is True:
        return ONE1
    if ta is None or tb is None:
        return X1
    return ZERO1


# ---- arithmetic (any unknown -> all X, IEEE 1364 semantics) ---------------

def _arith(a: Val, b: Val, fn, wout=None) -> Val:
    a2, b2, w, s = _binary_ctx(a, b)
    w = wout if wout is not None else w
    if a.u or b.u:
        return Val.all_x(w)
    return Val.from_int(fn(a2.arith_int() if s else a2.to_int(),
                           b2.arith_int() if s else b2.to_int()) , w, s)


def v_add(a, b):
    return _arith(a, b, lambda x, y: x + y)


def v_sub(a, b):
    return _arith(a, b, lambda x, y: x - y)


def v_mul(a, b):
    return _arith(a, b, lambda x, y: x * y)


def v_div(a, b):
    def fn(x, y):
        if y == 0:
            return None
        q = abs(x) // abs(y)
        return -q if (x < 0) != (y < 0) else q
    a2, b2, w, s = _binary_ctx(a, b)
    if a.u or b.u or b2.to_int() == 0:
        return Val.all_x(w)
    x = a2.arith_int() if s else a2.to_int()
    y = b2.arith_int() if s else b2.to_int()
    return Val.from_int(fn(x, y), w, s)


def v_mod(a, b):
    a2, b2, w, s = _binary_ctx(a, b)
    if a.u or b.u or b2.to_int() == 0:
        return Val.all_x(w)
    x = a2.arith_int() if s else a2.to_int()
    y = b2.arith_int() if s else b2.to_int()
    r = abs(x) % abs(y)
    return Val.from_int(-r if x < 0 else r, w, s)


def v_neg(a: Val) -> Val:
    if a.u:
        return Val.all_x(a.width)
    return Val.from_int(-a.arith_int(), a.width, a.signed)


def v_pow(a, b):
    return _arith(a, b, lambda x, y: x ** y if y >= 0 and y < 64 else 0)


# ---- comparisons -----------------------------------------------------------

def _cmp(a: Val, b: Val, fn) -> Val:
    a2, b2, w, s = _binary_ctx(a, b)
    if a.u or b.u:
        return X1
    x = a2.arith_int() if s else a2.to_int()
    y = b2.arith_int() if s else b2.to_int()
    return ONE1 if fn(x, y) else ZERO1


def v_eq(a, b):
    return _cmp(a, b, lambda x, y: x == y)


def v_ne(a, b):
    return _cmp(a, b, lambda x, y: x != y)


def v_lt(a, b):
    return _cmp(a, b, lambda x, y: x < y)


def v_le(a, b):
    return _cmp(a, b, lambda x, y: x <= y)


def v_gt(a, b):
    return _cmp(a, b, lambda x, y: x > y)


def v_ge(a, b):
    return _cmp(a, b, lambda x, y: x >= y)


def v_case_eq(a: Val, b: Val) -> Val:
    a2, b2, w, _ = _binary_ctx(a, b)
    same = (a2.v == b2.v) and (a2.u == b2.u)
    return ONE1 if same else ZERO1


def v_case_ne(a, b):
    r = v_case_eq(a, b)
    return ZERO1 if r.v else ONE1


# ---- shifts ----------------------------------------------------------------

def v_shl(a: Val, b: Val) -> Val:
    if b.u:
        return Val.all_x(a.width)
    sh = min(b.to_int(), a.width)      # shift >= width yields 0
    return Val.make(a.v << sh, a.u << sh, a.width, a.signed)


def v_shr(a: Val, b: Val) -> Val:
    if b.u:
        return Val.all_x(a.width)
    sh = min(b.to_int(), a.width)
    return Val.make(a.v >> sh, a.u >> sh, a.width, False)


def v_ashr(a: Val, b: Val) -> Val:
    if b.u:
        return Val.all_x(a.width)
    sh = min(b.to_int(), a.width)
    if not a.signed:
        return v_shr(a, b)
    top_v = (a.v >> (a.width - 1)) & 1 if a.width else 0
    top_u = (a.u >> (a.width - 1)) & 1 if a.width else 0
    fill = mask(a.width) ^ mask(max(a.width - sh, 0))
    v = (a.v >> sh) | (fill if top_v else 0)
    u = (a.u >> sh) | (fill if top_u else 0)
    return Val.make(v, u, a.width, a.signed)


# ---- structure -------------------------------------------------------------

def v_concat(parts) -> Val:
    """parts: list of Val, MSB-first (Verilog {a, b, c})."""
    v = u = 0
    w = 0
    for p in parts:
        v = (v << p.width) | (p.v & mask(p.width))
        u = (u << p.width) | (p.u & mask(p.width))
        w += p.width
    return Val(v, u, w, False)


def v_repl(n: int, a: Val) -> Val:
    return v_concat([a] * n)


def v_slice(a: Val, hi: int, lo: int) -> Val:
    """Bit-slice [hi:lo]; out-of-range bits read X."""
    w = hi - lo + 1
    if lo >= 0 and hi < a.width:
        return Val.make(a.v >> lo, a.u >> lo, w, False)
    v = u = 0
    for k, i in enumerate(range(lo, hi + 1)):
        code = a.bit(i)
        v |= (code & 1) << k
        u |= ((code >> 1) & 1) << k
    return Val(v, u, w, False)


def v_select_bit(a: Val, idx: Val) -> Val:
    if idx.u:
        return X1
    return v_slice(a, idx.to_int(), idx.to_int())


def v_cond(c: Val, t: Val, f: Val) -> Val:
    """Ternary: unknown condition merges t/f bitwise (equal bits kept)."""
    tc = truthy(c)
    w = max(t.width, f.width)
    t2, f2 = resize(t, w), resize(f, w)
    if tc is True:
        return t2
    if tc is False:
        return f2
    agree = ~(t2.v ^ f2.v) & ~t2.u & ~f2.u
    return Val.make(t2.v & agree, ~agree, w, t.signed and f.signed)


def insert_slice(tgt: Val, hi: int, lo: int, src: Val) -> Val:
    """Write src into tgt[hi:lo], returning the new value."""
    w = hi - lo + 1
    src = resize(src, w)
    m = mask(w) << lo
    v = (tgt.v & ~m) | ((src.v & mask(w)) << lo)
    u = (tgt.u & ~m) | ((src.u & mask(w)) << lo)
    return Val.make(v, u, tgt.width, tgt.signed)


def v_resolve(a: Val, b: Val) -> Val:
    """Two-driver net resolution: Z yields the other driver, agreement
    keeps the value, disagreement or X gives X (node.h multi-driver
    semantics / resolve2.h), bitwise over the packed planes."""
    w = max(a.width, b.width)
    m = mask(w)
    # widen with Z so missing bits never clobber the other driver
    def widen(x):
        ext = m & ~mask(x.width)
        return x.v | ext, x.u | ext
    av, au = widen(a)
    bv, bu = widen(b)
    az = au & av
    bz = bu & bv
    u0 = au | bu | (av ^ bv)
    v0 = av & bv & ~u0
    sel_a = az            # a floats: take b
    sel_b = bz & ~az      # b floats: take a
    rest = m & ~az & ~(bz & ~az)
    rv = (sel_a & bv) | (sel_b & av) | (rest & v0)
    ru = (sel_a & bu) | (sel_b & au) | (rest & u0)
    return Val.make(rv, ru, w)
