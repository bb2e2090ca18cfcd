"""float32 arithmetic that rounds as XLA's CPU backend does, in torch ops.

The JAX package scores drift windows with a jitted float32 kernel
(``avenir_tpu/monitor/drift.py`` ``_score_kernel``) compiled by XLA for the
CPU.  Its report strings (``repr(round(stat, 6))``) and alert levels depend
on the last bits of those statistics, and three things in XLA's arithmetic
differ from what ``torch.log`` / ``torch.sum`` give:

* ``log`` is an inlined Cephes polynomial (the same one as Eigen's
  ``plog_float``), its multiply-adds contracted to FMAs, and its input's
  subnormals flushed to zero (-> ``-inf``).  :func:`xla_log_f32`
  reproduces it bit for bit on every float32 input we swept
  (``tests/test_torch_xla_math.py``); ``torch.log`` is within 1 ulp of the
  correctly rounded log, which differs from XLA's in about 11% of inputs.
* A reduction over a row runs left to right, one element at a time
  (:func:`seq_row_sum`, :func:`seq_cumsum`); a product that feeds it is
  fused into the accumulation, ``acc = fma(a, b, acc)``
  (:func:`fma_row_sum`, and :func:`fma_matmul` for a small dot).  Longer
  rows add in vector lanes (:func:`lane_sum`) or in windows of 32
  (:func:`window_sum`), by their length (:func:`reduce_row_sum`).
  ``torch.sum`` and ``torch.cumsum`` add in other orders.
* Operands that depend only on compile-time constants are folded by XLA
  before the kernel runs (a log correctly rounded, a division by a
  constant turned into a multiply by its folded reciprocal); callers
  compute those with :func:`folded_log_f32` and plain float32 division.

An FMA of float32 operands is computed as the float64 ``a*b + c`` rounded
to float32 (:func:`fma_f32`): the product is exact in float64, so only
the sum rounds twice, and a double rounding that differs from one
rounding needs the float64 sum to fall exactly halfway between two
float32 values — rare, and bounded by the tests.  Plain torch ops, no
kernel: nothing here replaces a Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(v: float) -> float:
    return float(np.float32(v))


# Cephes' log coefficients as XLA's CPU backend states them, rounded to
# float32 (the float64 FMA must see the float32 operands)
_LOG_P = tuple(_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = _f32(-2.12194440e-4)
_LOG_Q2 = _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)
_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a*b + c`` with one rounding of the float64 sum (see the
    module docstring); ``b`` and ``c`` may be float32 tensors or floats
    that float32 holds exactly."""
    a64 = a.double()
    b64 = b.double() if torch.is_tensor(b) else b
    c64 = c.double() if torch.is_tensor(c) else c
    return (a64 * b64 + c64).float()


def xla_log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of float32 ``x`` as XLA's CPU backend computes it.

    Frexp to a mantissa in [0.5, 1) and an exponent, the SQRTHF fold, the
    three-way Cephes polynomial with every multiply-add an FMA, then
    ``y = fma(y, x^3, q1*e)``, ``t -= x^2/2``, ``t += y``,
    ``t = fma(q2, e, t)``.  Subnormal inputs of either sign count as 0
    (XLA runs with denormals flushed): ``log(+-0) = -inf``,
    ``log(inf) = inf``, other negative and NaN inputs give NaN."""
    x = x.float()
    # clamp below at the smallest normal (the polynomial's own clamp), as
    # raw bits: exponent and mantissa split with integer ops
    t = torch.clamp(x, min=_MIN_NORMAL)
    bits = t.view(torch.int32)
    emm0 = (bits >> 23) - 0x7F
    mant = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    e = emm0.float() + 1.0
    fold = mant < _SQRTHF
    e = e - fold.float()
    t0 = (mant - 1.0) + torch.where(fold, mant, torch.zeros_like(mant))
    x2 = t0 * t0
    x3 = x2 * t0
    p = _LOG_P
    y = fma_f32(t0, p[0], p[1])
    y1 = fma_f32(t0, p[3], p[4])
    y2 = fma_f32(t0, p[6], p[7])
    y = fma_f32(y, t0, p[2])
    y1 = fma_f32(y1, t0, p[5])
    y2 = fma_f32(y2, t0, p[8])
    y = fma_f32(y, x3, y1)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, e * _LOG_Q1)
    t0 = t0 - x2 * 0.5          # exact: the FMA and the plain form agree
    t0 = t0 + y
    t0 = fma_f32(e, _LOG_Q2, t0)
    zero = x.abs() < _MIN_NORMAL      # subnormals of either sign are 0
    t0 = torch.where(zero, torch.full_like(t0, -float("inf")), t0)
    t0 = torch.where(x == float("inf"), x, t0)
    return torch.where((x <= -_MIN_NORMAL) | torch.isnan(x),
                       torch.full_like(t0, float("nan")), t0)


# Cephes' expf as XLA's CPU backend emits it, every constant float32:
# the input clamp, log2(e), the two-part ln(2) and the degree-5 polynomial
_EXP_LO = _f32(-87.80000305175781)
_EXP_HI = _f32(88.80000305175781)
_LOG2E = _f32(1.4426950216293335)
_EXP_C1 = _f32(0.693359375)
_EXP_C2 = _f32(-0.00021219444170128554)
_EXP_P = tuple(_f32(v) for v in (
    0.00019875691214110702, 0.001398199936375022, 0.008333452045917511,
    0.04166579619050026, 0.1666666567325592, 0.5))


def xla_exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``e**x`` of float32 ``x`` as XLA's CPU backend computes it.

    Clamp ``x`` to [-87.8, 88.8]; ``n = floor(fma(x, log2e, 0.5))``
    clamped to [-127, 127]; ``r = fma(-n, c1, x)``, ``r = fma(-n, c2, r)``;
    ``p`` the Cephes polynomial in ``r`` by FMAs; ``y = fma(r*r, p, r) +
    1``; the result ``y * 2**n`` with the power built from its exponent
    bits, so ``n = -127`` gives 0.  Results below the smallest normal are
    flushed to 0 (XLA runs with denormals flushed), above the largest
    float they are ``inf``; NaN stays NaN."""
    x = x.float()
    t = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.floor(fma_f32(t, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma_f32(-n, _EXP_C1, t)
    r = fma_f32(-n, _EXP_C2, r)
    p = _EXP_P
    y = torch.full_like(r, p[0])
    for c in p[1:]:
        y = fma_f32(y, r, c)
    y = fma_f32(r * r, y, r) + 1.0
    # 2**n from its bit pattern (n = -127 is +0.0; a NaN input's y is NaN
    # whatever its n)
    n = torch.nan_to_num(n)
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    # y * 2**n is exact in float64; below the smallest normal it flushes
    out = y.double() * scale.double()
    out = torch.where(out.abs() < _MIN_NORMAL, torch.zeros_like(out), out)
    return out.float()


def folded_log_f32(x: np.ndarray) -> np.ndarray:
    """float32 log of host constants as XLA's constant folder computes it
    (the float64 log rounded to float32: correctly rounded but for a rare
    double rounding)."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log(x.astype(np.float64)).astype(np.float32)


def seq_row_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sums over the last axis, added left to right."""
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def lane_sum(x: torch.Tensor, width: int) -> torch.Tensor:
    """Row sums of float32 ``x`` as a ``width``-lane vectorised loop adds
    them: lane j accumulates columns j, j + width, ... of the first
    ``width * (n // width)`` columns, the lanes add as a tree of halves
    (``((l0+l4)+(l2+l6))+((l1+l5)+(l3+l7))`` for 8), and the remaining
    columns add to that left to right.  ``width`` 1 is left to right."""
    n = x.shape[1] // width * width if width > 1 else 0
    if n == 0:
        return seq_row_sum(x)
    acc = x[:, 0:width]
    for s in range(width, n, width):
        acc = acc + x[:, s:s + width]
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    total = acc[:, 0]
    for j in range(n, x.shape[1]):
        total = total + x[:, j]
    return total


WINDOW = 32


def window_sum(x: torch.Tensor, width: int = 1) -> torch.Tensor:
    """Row sums of float32 ``x`` in the order of XLA's CPU tree-reduction
    rewrite of a long reduction: a row of more than WINDOW columns is
    padded with zeros at both ends (half the padding, rounded down, in
    front) to whole windows of WINDOW, each window summed (in ``width``
    lanes when there is no padding, else left to right), and the window
    sums reduced the same way in turn; WINDOW or fewer add left to
    right."""
    while x.shape[1] > WINDOW:
        n = x.shape[1]
        off = (-n % WINDOW) // 2
        w = width if n % WINDOW == 0 else 1
        x = torch.stack([lane_sum(x[:, max(lo, 0):lo + WINDOW], w)
                         for lo in range(-off, n, WINDOW)], dim=1)
        width = 1
    return seq_row_sum(x)


def reduce_row_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sums over the last axis of a 2-D ``x`` as XLA's CPU backend
    emits a reduce of the minor axis by itself (read off the compiled
    ``avenir_tpu/sequence/markov.py`` ``_log_odds_kernel`` for row lengths
    1-256 and 1-1000 rows): up to 29 columns left to right, 30-32 in 8
    lanes (:func:`lane_sum`), more in windows of WINDOW each added left to
    right (:func:`window_sum`)."""
    T = x.shape[-1]
    if T <= 29:
        return seq_row_sum(x)
    return lane_sum(x, 8) if T <= WINDOW else window_sum(x, 1)


def fma_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a @ b`` of small matrices as XLA's CPU dot emitter
    computes it: each output an FMA chain over the contracted index from
    0 (:func:`fma_f32`).  One float64 pass an index over every output."""
    a64, b64 = a.double(), b.double()
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k in range(a.shape[1]):
        acc = (a64[:, k:k + 1] * b64[k:k + 1, :] + acc.double()).float()
    return acc


def fma_row_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``sum(a * b)`` over the last axis as XLA fuses it: left to
    right, ``acc = fma(a[..., j], b[..., j], acc)``.  One float64 pass a
    column over every leading index at once."""
    a64, b64 = a.double(), b.double()
    acc = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    for j in range(a.shape[-1]):
        acc = (a64[..., j] * b64[..., j] + acc.double()).float()
    return acc


def seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """float32 running sums over the last axis, added left to right."""
    out = torch.empty_like(x, dtype=torch.float32)
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out


# XLA's log1p (the elemental emitter's Cephes rational approximation below
# |x| < sqrt(2) - 1, log(1 + x) above), coefficients rounded to float32
_LOG1P_SMALL = _f32(0.41421356237309504880)
_LOG1P_DEN = tuple(_f32(v) for v in (
    1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))
_LOG1P_NUM = tuple(_f32(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))


def xla_log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + x)`` of float32 ``x`` as XLA's CPU backend computes it.

    Below ``|x| < sqrt(2) - 1``: numerator and denominator polynomials
    in ``x`` by FMAs (Horner, the denominator's leading 1 exact), their
    quotient, then ``x + fma(x^2, -1/2, (x * x^2) * q)``; above it
    :func:`xla_log_f32` of the rounded ``1 + x``."""
    x = x.float()
    large = xla_log_f32(x + 1.0)
    den = torch.ones_like(x)
    for c in _LOG1P_DEN:
        den = fma_f32(den, x, c)
    num = torch.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = fma_f32(num, x, c)
    x2 = x * x
    small = fma_f32(x2, -0.5, (x * x2) * (num / den))
    small = x + small
    return torch.where(x.abs() < _LOG1P_SMALL, small, large)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (XLA's ``vsqrtps``),
    through float64: ``torch.sqrt`` of a float32 tensor on the CPU is
    within half an ulp plus a little, and misses it in about one input
    in a thousand."""
    return torch.sqrt(x.double()).float()


# Giles' single-precision erfinv as XLA states it: the polynomial for
# w = -log1p(-x^2) < 5 and the one for w >= 5, highest degree first
_ERFINV_LT5 = tuple(_f32(v) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_GE5 = tuple(_f32(v) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def xla_erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """``erfinv`` of float32 ``x`` as XLA's CPU backend computes
    ``chlo.erf_inv``: ``l = log1p(-(x*x))`` (:func:`xla_log1p_f32`), the
    argument ``-l - 2.5`` or ``sqrt(-l) - 3`` (:func:`sqrt_f32`), the degree-8 polynomial by
    FMAs, times ``x``; ``+-1`` gives ``+-inf``."""
    x = x.float()
    lg = xla_log1p_f32(x * -x)
    lt = lg > -5.0
    w = torch.where(lt, -2.5 - lg, sqrt_f32(-lg) - 3.0)
    zero = torch.zeros_like(x)

    def coef(i):
        return torch.where(lt, zero + _ERFINV_LT5[i], zero + _ERFINV_GE5[i])
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma_f32(p, w, coef(i))
    out = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)
