"""The kernel work of a wide ring's round trip (2^32 <= q < 2^63), where
the port transforms in K7 and K8 and launches no K1, K2, K3, K5 or K6.

A wide ring's prime set is the port's three primes extended, in order, by
its extension primes until the product covers 2 * ACC_MAX * N * (q/2)^2;
a product with a smaller exact bound takes the fewest primes that cover
it. The primes and both rules are frozen copies of
``ringzk_tpu_torch/ops/ntt.py``'s ``PRIMES``, ``EXT_PRIMES``,
``RingContext._wide_prime_list`` and ``primes_needed`` (as of the commit
that made the harness count wide rings), so that the yardstick stays what
it is when the program changes. Each entry is (kernel, what, bound) by
the frozen ``k7_bound`` and ``k8_bound``.
"""

from __future__ import annotations

from .bounds import k7_bound, k8_bound

PRIMES = (998244353, 754974721, 167772161)
EXT_PRIMES = (469762049, 2013265921, 2130706433, 1811939329, 2113929217)
ACC_MAX = 16   # RingContext.ACC_MAX: NTT-domain terms summed before an inverse


def is_wide(scheme) -> bool:
    """Whether a scheme (or the port's Params) is on a wide ring, modulus
    >= 2^32: int64 residues, K7 and K8."""
    return scheme.modulus >= 2**32


def primes(scheme) -> tuple:
    """The ring's CRT primes at degree N."""
    bound = scheme.n_deg * (scheme.modulus // 2 + 1) ** 2 * ACC_MAX * 2
    out, prod = [], 1
    for p in PRIMES + EXT_PRIMES:
        out.append(p)
        prod *= p
        if prod > bound:
            break
    return tuple(out)


def primes_needed(scheme, bound: int) -> int:
    """The fewest leading primes whose product exceeds 2 * bound."""
    prod = 1
    for i, p in enumerate(primes(scheme)):
        prod *= p
        if prod > 2 * bound:
            return i + 1
    raise ValueError(f"bound 2^{bound.bit_length()} exceeds the ring's CRT range")


def key_matvec(scheme, what: str, rows: int, blocks) -> list:
    """A key matvec on the NTT path (``mat.matvec``): K7 of v [rows, k, N]
    at every prime, one K8 a row block of ``blocks`` (a1: n rows, a2: l)."""
    s, num = scheme, len(primes(scheme))
    out = [("K7", what, k7_bound(rows * s.k, num, s.n_deg))]
    return out + [("K8", f"{what}, {name} rows", k8_bound(rows * height, num, s.n_deg))
                  for name, height in blocks]


def d_times(scheme, what: str, rows_d: int, rows_m: int, num: int) -> list:
    """t + d m on a wide ring (``RingContext.scalar_mul_add``'s composed
    chain): K7 of d over rows_d, K7 of m over rows_m, one K8 of the
    products, at ``num`` primes."""
    n = scheme.n_deg
    return [("K7", f"{what}: d", k7_bound(rows_d, num, n)),
            ("K7", f"{what}: m", k7_bound(rows_m, num, n)),
            ("K8", what, k8_bound(rows_m, num, n))]


def d_primes(scheme) -> tuple:
    """(primes of d r, primes of d c): d kappa-sparse ternary, r within b,
    c any residue (the protocols' bounds of the two products)."""
    s = scheme
    kd = min(s.kappa, s.n_deg)
    return primes_needed(s, kd * s.b), primes_needed(s, kd * (s.modulus // 2 + 1))
