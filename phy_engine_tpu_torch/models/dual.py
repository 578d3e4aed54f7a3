"""Forward-mode AD over whole device families: the port's ``jax.jacfwd``.

:func:`jacobian` evaluates a family function once on :class:`Dual`
numbers — a primal tensor and a tangent tensor with the k unit
directions along a new leading dimension — and reads the per-instance
Jacobian off the tangents.  Every primitive's derivative rule is JAX's
(``jax._src.lax.lax``): ``abs`` takes +1 at 0, ``maximum`` / ``minimum``
split a tie in half, ``pow`` is y·x^(y-1), ``sqrt`` 0.5/ans, and
``where`` selects tangents as it selects values.  The device models stay
plain torch code; their derivatives are never written by hand.

It exists beside ``torch.func`` because it is faster: an op between a
dual and a plain tensor, which a device model mostly holds, is two torch
ops here.  The BSIM3_NMOS stamp at (256 lanes, 31 instances) took
39.4 ms this way, 135.0 ms through ``torch.func.vmap`` of
``torch.func.jvp`` (``jacfwd``'s scheme) and 513.4 ms through one
``torch.func.jvp`` a terminal, all three equal to 1.1e-15 (NVIDIA H100
80GB HBM3, 700 W; ``chip_smoke.py`` phase 12).  Every value is a torch
op on ordinary tensors, so reverse-mode autograd runs through a Jacobian
taken here (the sensitivity analysis).
"""

from __future__ import annotations

import torch


def _split(x):
    return (x.p, x.t) if isinstance(x, Dual) else (x, None)


def _lift(t, p):
    """Tangent ``t`` (k, ...) aligned to a primal of shape ``p.shape``."""
    missing = p.dim() - (t.dim() - 1)
    if missing > 0:
        t = t.reshape((t.shape[0],) + (1,) * missing + t.shape[1:])
    return t


def _make(p, t):
    return p if t is None else Dual(p, _lift(t, p))


def _add_t(ta, tb):
    if ta is None:
        return tb
    return ta if tb is None else ta + tb


def _add(a, b):
    (pa, ta), (pb, tb) = _split(a), _split(b)
    return _make(pa + pb, _add_t(ta, tb))


def _sub(a, b):
    (pa, ta), (pb, tb) = _split(a), _split(b)
    return _make(pa - pb, _add_t(ta, None if tb is None else -tb))


def _mul(a, b):
    (pa, ta), (pb, tb) = _split(a), _split(b)
    return _make(pa * pb, _add_t(None if ta is None else ta * pb,
                                 None if tb is None else pa * tb))


def _div(a, b):
    (pa, ta), (pb, tb) = _split(a), _split(b)
    t = None if ta is None else ta / pb
    if tb is not None:
        t = _add_t(t, (-tb * pa) * (1.0 / (pb * pb)))
    return _make(pa / pb, t)


def _pow(a, b):
    (pa, ta), (pb, tb) = _split(a), _split(b)
    if tb is not None:
        raise NotImplementedError("Dual: a differentiated exponent")
    out = pa ** pb
    if ta is None:
        return out
    if isinstance(pb, int):
        jac = 0.0 if pb == 0 else pb * pa ** (pb - 1)
    else:
        jac = pb * pa ** (pb - 1.0)
    return Dual(out, ta * jac)


def _where(c, a, b):
    (pa, ta), (pb, tb) = _split(a), _split(b)
    p = torch.where(c, pa, pb)
    if ta is None and tb is None:
        return p
    return Dual(p, _lift(torch.where(c, 0.0 if ta is None else ta,
                                     0.0 if tb is None else tb), p))


def _balanced(x, z, y):
    """JAX's _balanced_eq: 1 where x == z (0.5 where y == z too), else 0."""
    return torch.where(x == z, torch.where(y == z, 0.5, 1.0), 0.0)


def _extremum(op):
    def f(a, b):
        (pa, ta), (pb, tb) = _split(a), _split(b)
        if not torch.is_tensor(pb):
            pb = torch.as_tensor(pb, dtype=pa.dtype, device=pa.device)
        if not torch.is_tensor(pa):
            pa = torch.as_tensor(pa, dtype=pb.dtype, device=pb.device)
        p = op(pa, pb)
        t = None if ta is None else ta * _balanced(pa, p, pb)
        if tb is not None:
            t = _add_t(t, tb * _balanced(pb, p, pa))
        return _make(p, t)
    return f


_max = _extremum(torch.maximum)
_min = _extremum(torch.minimum)


def _clamp(x, min=None, max=None):
    """``jnp.clip``: maximum, then minimum."""
    if min is not None:
        x = _max(x, min)
    return x if max is None else _min(x, max)


def _unary(fn, rule):
    def f(x):
        p, t = _split(x)
        out = fn(p)
        return out if t is None else Dual(out, rule(t, p, out))
    return f


def _stacker(fn):
    def f(xs, dim=0):
        parts = [_split(x) for x in xs]
        p = fn([q for q, _ in parts], dim=dim)
        if all(t is None for _, t in parts):
            return p
        k = next(t for _, t in parts if t is not None).shape[0]
        ts = [torch.zeros((k,) + q.shape, dtype=q.dtype, device=q.device)
              if t is None else _lift(t, q).expand((k,) + q.shape)
              for q, t in parts]
        return Dual(p, fn(ts, dim=dim if dim < 0 else dim + 1))
    return f


def _reflect(fn):
    return lambda a, b: fn(b, a)


def _compare(op):
    return lambda a, b: op(_split(a)[0], _split(b)[0])


# torch functions called on a Dual, and a plain tensor's arithmetic with a
# Dual on its right (torch hands those to __torch_function__ as the
# method, operands in order)
_HANDLERS = {
    torch.where: _where,
    torch.maximum: _max, torch.minimum: _min, torch.clamp: _clamp,
    torch.sqrt: _unary(torch.sqrt, lambda t, x, ans: t * (0.5 / ans)),
    torch.exp: _unary(torch.exp, lambda t, x, ans: t * ans),
    torch.log1p: _unary(torch.log1p, lambda t, x, ans: t / (x + 1.0)),
    torch.stack: _stacker(torch.stack), torch.cat: _stacker(torch.cat),
    torch.full_like: lambda x, v, **kw: torch.full_like(_split(x)[0], v,
                                                         **kw),
    torch.zeros_like: lambda x, **kw: torch.zeros_like(_split(x)[0], **kw),
    torch.Tensor.add: _add, torch.Tensor.sub: _sub,
    torch.Tensor.mul: _mul, torch.Tensor.div: _div,
}


class Dual:
    """A primal tensor ``p`` and its tangents ``t`` of shape (k,) +
    p.shape, one per direction."""

    __slots__ = ("p", "t")

    def __init__(self, p, t):
        self.p, self.t = p, t

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        h = _HANDLERS.get(func)
        if h is None:
            raise NotImplementedError(f"Dual has no rule for {func}")
        return h(*args, **(kwargs or {}))

    __add__ = __radd__ = _add
    __sub__ = _sub
    __rsub__ = _reflect(_sub)
    __mul__ = __rmul__ = _mul
    __truediv__ = _div
    __rtruediv__ = _reflect(_div)
    __pow__ = _pow
    __gt__ = _compare(torch.gt)
    __ge__ = _compare(torch.ge)
    __lt__ = _compare(torch.lt)
    __le__ = _compare(torch.le)

    def __neg__(self):
        return Dual(-self.p, -self.t)

    def abs(self):
        return Dual(self.p.abs(), torch.where(self.p >= 0.0, self.t, -self.t))

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        if idx[0] is not Ellipsis:
            raise IndexError("Dual indexing must start with ...")
        return Dual(self.p[idx], self.t[idx])

    @property
    def shape(self):
        return self.p.shape

    @property
    def dtype(self):
        return self.p.dtype

    @property
    def device(self):
        return self.p.device


def jacobian(f, v):
    """(f(v), J) with J[..., r, c] = d f(v)[..., r] / d v[..., c] for a
    function of ``v`` (..., k) that is elementwise over the leading dims
    (each instance's k inputs to its outputs)."""
    k = v.shape[-1]
    eye = torch.eye(k, dtype=v.dtype, device=v.device)
    tangent = eye.reshape((k,) + (1,) * (v.dim() - 1) + (k,)) \
        .expand((k,) + v.shape)
    out = f(Dual(v, tangent))
    return out.p, out.t.expand((k,) + out.p.shape).movedim(0, -1)
