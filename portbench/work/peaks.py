"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates), the yardstick of every roofline share.  They assume the card's
full 700 W: the traced run prints the card's ``power.limit`` beside each
share."""

HBM_BYTES_PER_S = 3.35e12
# float32 outside the tensor cores: 67 TFLOP/s counting a fused
# multiply-add as two operations; an add or a compare is one instruction,
# issued at most at the FMA instruction rate
SCALAR_OPS_PER_S = 67e12 / 2
POWER_W = 700.0


def bound(nbytes: float, ops: float) -> dict:
    """The least time for ``nbytes`` moved and ``ops`` scalar operations:
    the larger of the two, and which one it is."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = ops / SCALAR_OPS_PER_S
    return {"seconds": max(bytes_s, ops_s), "bytes": nbytes, "ops": ops,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations"}


def width_bytes(n_values: int) -> int:
    """Bytes of the narrowest integer type that holds ``n_values``
    distinct values."""
    for nbytes in (1, 2, 4):
        if n_values <= 1 << (8 * nbytes):
            return nbytes
    return 8
