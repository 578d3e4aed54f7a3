"""The Newton-Schulz refresh's float32 matrix products (``torch.bmm`` of
two (B, n, n) operands in ``_ns_refresh``) against their roofline: the
least time of each product from ``roofline.bmm_s``, summed, over the
device time of the kernels those calls launched.  Matrix-vector products
(a last dimension of 1) are not counted."""

from .. import roofline

LAYER = "factor path"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "circuit_steps_per_s"
ROUTES = ("frozen",)


def read(t):
    least, seen, ns = 0.0, set(), 0
    for op in t.ops:
        if op.bmm is None:
            continue
        B, m, k, n = op.bmm
        if n == 1 or k == 1:
            continue
        ns += op.dur_ns
        if op.owner_id not in seen:
            seen.add(op.owner_id)
            least += roofline.bmm_s(B, m, k, n)
    return 100.0 * least / (ns * 1e-9) if ns else None
