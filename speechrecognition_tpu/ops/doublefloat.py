"""Double-float (two-float32) arithmetic for device-side score accumulation.

The reference accumulates acoustic and path scores in C++ ``double``
(src/sietill/Mixtures.cpp:590-628, Recognizer.cpp:103-232). This module
provides the classic error-free-transformation toolkit (Dekker 1971,
Knuth TAOCP vol. 2) on float32 pairs ``(hi, lo)`` with
``|lo| ≤ ulp(hi)/2``, giving ≈49 bits of effective mantissa — enough that
every decode decision margin above ~1e-12 relative is resolved exactly as
the reference's float64 would resolve it (verified transcript-exact on the
full 13,117-utterance test corpus, tools/full_parity.py --dtype df32).

All functions are shape-polymorphic elementwise jnp ops, so they fuse into
the surrounding scan/matmul programs; comparisons are lexicographic on
(hi, lo), which equals numeric comparison because pairs are normalized.

The transforms are exact only if the compiler neither contracts a multiply
and an add into an FMA (``split`` would then compute ``fma(a, 4097, -a)``)
nor reassociates. XLA's CPU and GPU backends do neither: on the GPU they
emit ``mul.rn.f32``, which ptxas may not contract. ``chip_smoke.df32_exact``
checks this bitwise on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

#: Dekker splitting constant for float32 (2^12 + 1): splits a 24-bit
#: mantissa into two 12-bit halves so products are exact in float32
_SPLIT = 4097.0


class DF(NamedTuple):
    """A double-float value: hi + lo with |lo| <= ulp(hi)/2."""

    hi: jnp.ndarray
    lo: jnp.ndarray

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def shape(self):
        return self.hi.shape


def df(hi, lo=None) -> DF:
    hi = jnp.asarray(hi, jnp.float32)
    return DF(hi, jnp.zeros_like(hi) if lo is None else jnp.asarray(lo, jnp.float32))


def from_f64(x) -> DF:
    """Split a float64 array into an exact (hi, lo) float32 pair
    (exact whenever |x| is within float32 range, which all scores are)."""
    import numpy as np

    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return DF(jnp.asarray(hi), jnp.asarray(lo))


def to_f64(a: DF):
    import numpy as np

    return (np.asarray(a.hi, np.float64) + np.asarray(a.lo, np.float64))


# -- error-free transformations ----------------------------------------------


def two_sum(a, b) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """s = fl(a+b); e = exact error. Knuth's branch-free version."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """two_sum requiring |a| >= |b| (used for renormalization)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dekker split of a float32 into two non-overlapping 12-bit halves."""
    t = a * _SPLIT
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """p = fl(a*b); e = exact error, via Dekker splitting (no FMA needed)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# -- double-float arithmetic ---------------------------------------------------


def add(a: DF, b: DF) -> DF:
    """Full double-float addition (Dekker/Linnainmaa, ~11 flops)."""
    s, e = two_sum(a.hi, b.hi)
    t, f = two_sum(a.lo, b.lo)
    e = e + t
    s, e = fast_two_sum(s, e)
    e = e + f
    s, e = fast_two_sum(s, e)
    return DF(s, e)


def add_f(a: DF, b) -> DF:
    """DF + plain float32."""
    s, e = two_sum(a.hi, b)
    e = e + a.lo
    s, e = fast_two_sum(s, e)
    return DF(s, e)


def neg(a: DF) -> DF:
    return DF(-a.hi, -a.lo)


def sub(a: DF, b: DF) -> DF:
    return add(a, neg(b))


def mul(a: DF, b: DF) -> DF:
    p, e = two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    p, e = fast_two_sum(p, e)
    return DF(p, e)


def mul_f(a: DF, b) -> DF:
    p, e = two_prod(a.hi, b)
    e = e + a.lo * b
    p, e = fast_two_sum(p, e)
    return DF(p, e)


def sq_f(x) -> DF:
    """Exact square of a float32 as a DF."""
    p, e = two_prod(x, x)
    return DF(p, e)


# -- comparison / selection ----------------------------------------------------


def less(a: DF, b: DF):
    """a < b, exact (lexicographic on normalized pairs)."""
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def less_equal(a: DF, b: DF):
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo <= b.lo))


def where(cond, a: DF, b: DF) -> DF:
    return DF(jnp.where(cond, a.hi, b.hi), jnp.where(cond, a.lo, b.lo))


def minimum(a: DF, b: DF) -> DF:
    return where(less(a, b), a, b)


def min_axis(a: DF, axis) -> DF:
    """Exact min along axes via iterated pairwise reduction.

    Implemented as argmin on hi with lo tie-break through a single
    lexicographic reduce: sort-free, one pass. We reduce one axis at a
    time with jnp.minimum-style selects over splits in half (log steps),
    which XLA maps to a tree reduce.
    """
    if isinstance(axis, int):
        axis = (axis,)
    out = a
    # normalize negative axes against the original rank, then reduce from
    # the highest axis down so earlier indices stay valid
    rank = a.hi.ndim
    axes = sorted([ax % rank for ax in axis], reverse=True)
    for ax in axes:
        out = _min_one_axis(out, ax)
    return out


def _min_one_axis(a: DF, ax: int) -> DF:
    n = a.hi.shape[ax]
    hi, lo = a.hi, a.lo
    while n > 1:
        half = n // 2
        odd = n - 2 * half
        i0 = [slice(None)] * hi.ndim
        i1 = [slice(None)] * hi.ndim
        it = [slice(None)] * hi.ndim
        i0[ax] = slice(0, half)
        i1[ax] = slice(half, 2 * half)
        it[ax] = slice(2 * half, n)
        a0 = DF(hi[tuple(i0)], lo[tuple(i0)])
        a1 = DF(hi[tuple(i1)], lo[tuple(i1)])
        m = minimum(a0, a1)
        if odd:
            hi = jnp.concatenate([m.hi, hi[tuple(it)]], axis=ax)
            lo = jnp.concatenate([m.lo, lo[tuple(it)]], axis=ax)
            n = half + 1
        else:
            hi, lo = m.hi, m.lo
            n = half
    sq = [slice(None)] * hi.ndim
    sq[ax] = 0
    return DF(hi[tuple(sq)], lo[tuple(sq)])
