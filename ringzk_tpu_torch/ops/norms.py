"""Exact integer L2-norm checks on centered polynomials (int32, or int64 on
wide rings).

Port of ``ringzk_tpu.ops.norms.norm2_leq``. isqrt(S) <= B iff
S <= B^2 + 2B, so the check compares an exact integer sum of squares and
never takes a square root or touches a float. The JAX package keeps 96
bits; here any row with a coefficient outside [-bound, bound] rejects first
(norm_2 >= max |coeff|), and the survivors' squares (each at most
min(bound, 2^31)^2 <= 2^62) are summed in chunks short enough for an int64
sum. The chunks' sums add exactly as two limbs (S = hi * 2^31 + lo), so
every bound the JAX package answers is answered here too. The coefficient
test compares x itself, never |x|: abs(-2^63) wraps to -2^63 in int64,
which the JAX package's int64 path lets through.
"""

from __future__ import annotations

import torch

_LIMB = 31
_LOW = (1 << _LIMB) - 1


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
    hi, lo = hi + (lo >> _LIMB), lo & _LOW
    lim_hi, lim_lo = limit >> _LIMB, limit & _LOW
    if lim_hi >= 2**63:                       # beyond any sum of int64 chunks
        return coeff_ok
    return coeff_ok & ((hi < lim_hi) | ((hi == lim_hi) & (lo <= lim_lo)))
