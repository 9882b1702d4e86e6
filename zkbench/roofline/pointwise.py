"""The NTT-domain pointwise work of one opening-proof round trip of B
proofs on a wide ring (2^32 <= q < 2^63), counted from the protocol's
shapes: every modular product and accumulate that the functions under the
program's ``pointwise`` ranges (``mat.matvec_hat``, ``RingContext.dot_hat``,
``mat.scalar_mul_hat``) run between the transforms.

The count is the arithmetic's, not the program's: a key matvec of k terms
into a row block of height R is, at each prime and coefficient, k R
products and (k - 1) R accumulates, however they are launched. The key
matvecs A r (two row blocks), a1 y and a1 z run at the ring's primes, the
products d r and c1 d at ``wide.d_primes``. Bytes: every operand residue
read once at 4 B a prime (a matvec's vector images once, both row blocks
sharing them), the key's const images once a batch, every result written
once. Operations: a ``MULMOD`` a product and an ``ADDMOD`` an accumulate,
through the frozen ``bound`` at ``PEAK``. A narrow ring runs these
products only in its g products and inside K5, and is not counted here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

from . import wide
from .bounds import PEAK, bound

PROTOCOLS = ("open",)   # the protocols whose round trip is counted


class Step(NamedTuple):
    """One product's pointwise work: the shape [primes, B, rows, N] of
    each pass of products and of accumulates, and the bytes it moves."""

    what: str
    products: list
    accumulates: list
    nbytes: int


def key_matvec(scheme, what: str, rows: int, blocks) -> Step:
    """The key's row ``blocks`` (name, height) times v [rows, k, N] at
    the ring's primes: k products and k - 1 accumulates a block."""
    s, num = scheme, len(wide.primes(scheme))
    products, accumulates = [], []
    for _, height in blocks:
        shape = (num, rows, height, s.n_deg)
        products += [shape] * s.k
        accumulates += [shape] * (s.k - 1)
    height = sum(h for _, h in blocks)
    nbytes = 4 * num * s.n_deg * (rows * s.k + height * s.k + rows * height)
    return Step(what, products, accumulates, nbytes)


def d_times(scheme, what: str, rows: int, height: int, num: int) -> Step:
    """d [rows, N] times each of m's [rows, height, N] at ``num`` primes."""
    shape = (num, rows, height, scheme.n_deg)
    return Step(what, [shape], [], 4 * num * scheme.n_deg * rows * (1 + 2 * height))


def steps(scheme, batch: int) -> list:
    """The round trip's products in the order it runs them; none on a
    narrow ring."""
    s, b = scheme, batch
    if not wide.is_wide(s):
        return []
    blocks = (("a1", s.n), ("a2", s.l))
    resp, ver = wide.d_primes(s)
    return [key_matvec(s, "A r", b, blocks), key_matvec(s, "a1 y", b, blocks[:1]),
            d_times(s, "d r", b, s.k, resp), key_matvec(s, "a1 z", b, blocks[:1]),
            d_times(s, "c1 d", b, s.n, ver)]


def work(scheme, batch: int) -> list:
    """(what, least ms, what bounds it) of each product of the round trip."""
    out = []
    for st in steps(scheme, batch):
        products = sum(math.prod(shape) for shape in st.products)
        accumulates = sum(math.prod(shape) for shape in st.accumulates)
        ms, by = bound(st.nbytes, products * PEAK.mulmod + accumulates * PEAK.addmod, PEAK.rate)
        out.append((st.what, ms, by))
    return out
