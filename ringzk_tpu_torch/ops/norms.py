"""Exact integer norms of centered polynomials (int32, or int64 on wide
rings).

Port of ``ringzk_tpu.ops.norms``. ``norm2_squared``, ``norm1`` and
``norm_inf`` return the JAX package's values on int32 input, as 32-bit
limbs (int64 tensors in [0, 2^32), the storage convention of :mod:`.u64`),
most significant first. On int64 input the JAX functions cast to int32
first and so truncate every coefficient past 2^31; here the int64 values
are summed exactly, in more limbs (see each function). Neither package
takes a square root: the reference's norm_2 is only ever compared with an
integer bound.

``norm2_leq``: isqrt(S) <= B iff
S <= B^2 + 2B, so the check compares an exact integer sum of squares and
never takes a square root or touches a float. The JAX package keeps 96
bits; here any row with a coefficient outside [-bound, bound] rejects first
(norm_2 >= max |coeff|), and the survivors' squares (each at most
min(bound, 2^31)^2 <= 2^62) are summed in chunks short enough for an int64
sum. The chunks' sums add exactly as two limbs (S = hi * 2^31 + lo), so
every bound the JAX package answers is answered here too. The coefficient
test compares x itself, never |x|: abs(-2^63) wraps to -2^63 in int64,
which the JAX package's int64 path lets through.

Under a ring whose coefficient axis is split over ranks (``ntt.lanes``),
each rank holds a lane block: the per-row coefficient test and both limbs
of the partial sums are all-reduced over the ranks before the carry and
the compare, so the verdict is that of the whole row, on every rank.
"""

from __future__ import annotations

import torch

from ..utils.profiling import annotate
from . import ntt, u64

_LIMB = 31
_LOW = (1 << _LIMB) - 1


@annotate("norm")
def norm2_leq(x: torch.Tensor, bound: int, dim: int = -1) -> torch.Tensor:
    """Boolean tensor: integer-sqrt(sum x^2) <= bound, exactly."""
    limit = bound * bound + 2 * bound
    if x.dtype == torch.int64 and bound >= 2**31:
        raise ValueError(f"wide-ring norm bound {bound} >= 2^31: the exact norm path "
                         "needs int32-range bounds")
    x = x.to(torch.int64)
    coeff_ok = ((x >= -bound) & (x <= bound)).all(dim)
    cap = min(bound, 2**31)                   # survivors' |x| (int32 inputs: <= 2^31)
    xc = torch.clamp(x, -cap, cap)
    sq = xc * xc                              # each <= cap^2 <= 2^62
    chunk = (2**63 - 1) // max(cap * cap, 1)  # squares an int64 sum takes
    hi = lo = 0
    for part in sq.split(chunk, dim):
        s = part.sum(dim)                     # <= 2^63 - 1
        hi, lo = hi + (s >> _LIMB), lo + (s & _LOW)
    if dim % x.dim() == x.dim() - 1:          # the ring axis: whole rows
        coeff_ok = ntt.ring_all(coeff_ok)
        hi, lo = ntt.ring_sum(hi), ntt.ring_sum(lo)
    hi, lo = hi + (lo >> _LIMB), lo & _LOW
    lim_hi, lim_lo = limit >> _LIMB, limit & _LOW
    if lim_hi >= 2**63:                       # beyond any sum of int64 chunks
        return coeff_ok
    return coeff_ok & ((hi < lim_hi) | ((hi == lim_hi) & (lo <= lim_lo)))


def _whole_rows(x: torch.Tensor, dim: int) -> bool:
    """Whether ``dim`` is the ring axis, which a split ring spreads over
    its ranks (the reductions along it then take every rank's lanes)."""
    return dim % x.dim() == x.dim() - 1


def _magnitude(x: torch.Tensor):
    """|x| of int64 x as (hi, lo) 32-bit limbs, hi in [0, 2^31], exact at
    -2^63: -x = ~x + 1, and ~x of a negative x is in [0, 2^63)."""
    nx = torch.where(x < 0, ~x, x)
    one = (x < 0).to(torch.int64)
    lo = (nx & u64.MASK32) + one
    return (nx >> 32) + (lo >> 32), lo & u64.MASK32


def _limbs(x: torch.Tensor, columns, dim: int, ndigits: int) -> tuple:
    """Exact sum along ``dim`` of the columns (base-2^16 weights), as
    ndigits / 2 limbs; along the ring axis summed over a split ring's
    ranks too."""
    digits = u64.column_digits(columns, dim, ndigits)
    if _whole_rows(x, dim) and ntt._split_ring() is not None:
        digits = u64.carry_digits(list(ntt.ring_sum(torch.stack(digits)).unbind(0)))
    return u64.digits_to_limbs(digits)


def norm2_squared(x: torch.Tensor, dim: int = -1) -> tuple:
    """Exact sum of squared coefficients along ``dim``.

    int32 (or narrower) input: the JAX package's (hi, mid, lo) 96-bit limb
    triple. int64 input: five limbs (l4, l3, l2, l1, l0), the sum being
    sum_i l_i 2^(32 i): room for N * 2^126 at any N below 2^34, -2^63
    included. The JAX package (``norm2_squared`` through
    ``u64.sum_squares``) truncates int64 input to int32 instead. ``dim`` is
    the JAX function's ``axis``."""
    if x.dtype != torch.int64:
        a = x.to(torch.int64).abs()           # |-2^31| = 2^31 in int64
        return _limbs(x, u64.square_columns(u64.split16(a, 2)), dim, 6)
    hi, lo = _magnitude(x)
    return _limbs(x, u64.square_columns(u64.split16(lo, 2) + u64.split16(hi, 2)), dim, 10)


def norm1(x: torch.Tensor, dim: int = -1) -> tuple:
    """Exact L1 norm (sum |c_i|) along ``dim``.

    int32 input: the JAX package's (hi, lo) 64-bit pair. int64 input: three
    limbs (hi, mid, lo), room for N * 2^63 at any N below 2^33; the JAX
    package truncates it to int32 first."""
    if x.dtype != torch.int64:
        return _limbs(x, [x.to(torch.int64).abs()], dim, 4)
    hi, lo = _magnitude(x)
    return _limbs(x, [lo, torch.zeros_like(lo), hi], dim, 6)


def norm_inf(x: torch.Tensor, dim: int = -1):
    """max |c_i| along ``dim``, exactly.

    int32 input: one int64 tensor. It equals the JAX package's int32
    result except where a row holds -2^31, whose int32 abs wraps there: the
    port gives 2^31. int64 input: a (hi, lo) limb pair, with room for the
    one magnitude 2^63 that int64 cannot hold; the JAX package truncates the
    input to int32 first. No abs is taken of int64 values: max |c| is the
    larger of max c and -min c, and -min c is taken as ~min c + 1."""
    split = _whole_rows(x, dim) and ntt._split_ring() is not None
    if x.dtype != torch.int64:
        out = x.to(torch.int64).abs().amax(dim)
        return ntt.ring_max(out) if split else out
    mx, mn = x.amax(dim), x.amin(dim)
    if split:
        mx, mn = ntt.ring_max(mx), ntt.ring_min(mn)
    nm = ~mn                                  # -min c - 1, in [0, 2^63) when min c < 0
    neg_wins = nm >= mx                       # -min c > max c
    hi_n, lo_n = _magnitude(mn)
    hi = torch.where(neg_wins, hi_n, mx >> 32)
    lo = torch.where(neg_wins, lo_n, mx & u64.MASK32)
    return hi, lo
