"""Plain arithmetic of Z_q[x]/(x^N + 1) for the benchmark's reference.

Independent of the program under test: it imports torch alone. A product
of two polynomials is the negacyclic matrix of one times the other,
computed exactly for every modulus m <= 2^63 - 1: both operands are
reduced to [0, m), cut into as many 16-bit limbs as m - 1 needs (2 below
2^32, 3 below 2^48, 4 up to 2^63), and each limb pair is one float64
matrix product, whose entries are integers below K * 2^32 for a
contraction of K terms (N, or k N for a matvec), exact in float64's 53
bits while K < 2^21. The limb products of equal weight are added in
int64 (below 2^55) and recombined mod m by Horner's rule in base 2^16,
each step a mulmod by 2^16 and an addmod that no int64 value overflows.

``mul(a, b, m)`` with m = q is the ring's product. The benchmark's control
(``zkbench/control.py``) calls it with m = 2^32, which gives the exact
product over Z wrapped to 32 bits: what a 32-bit accumulator would hold.
"""

from __future__ import annotations

import torch

LIMB = 16
LOW = (1 << LIMB) - 1
LOW31 = (1 << 31) - 1
# rows of per-row negacyclic matrices built at once (N = 1024: 8 MB each)
ROW_BLOCK = 32


def centered(v: torch.Tensor, q: int) -> torch.Tensor:
    """Any int64 -> its residue mod q in [-(q-1)/2, (q-1)/2] (q odd)."""
    u = torch.remainder(v, q)
    return torch.where(u > q // 2, u - q, u)


def wrap32(v: torch.Tensor) -> torch.Tensor:
    """A residue mod 2^32 in [0, 2^32) -> the signed 32-bit integer it is."""
    return torch.where(v >= 2**31, v - 2**32, v)


def negacyclic_matrix(a: torch.Tensor) -> torch.Tensor:
    """[..., N] -> [..., N, N] with (M @ v)[k] = sum_j a[k - j] v[j], where
    a[-i] = -a[N - i] (x^N = -1)."""
    n = a.shape[-1]
    k = torch.arange(n, device=a.device)
    diff = k[:, None] - k[None, :]
    m = a[..., torch.remainder(diff, n)]
    return torch.where(diff >= 0, m, -m)


def n_limbs(m: int) -> int:
    """16-bit limbs that cover every residue in [0, m)."""
    return max(1, -(-(m - 1).bit_length() // LIMB))


def _limbs(v: torch.Tensor, m: int) -> list:
    """v mod m in [0, m), as its 16-bit limbs in float64, lowest first."""
    u = torch.remainder(v.to(torch.int64), m)
    return [((u >> (LIMB * i)) & LOW).to(torch.float64) for i in range(n_limbs(m))]


def _addmod(a: torch.Tensor, b: torch.Tensor, m: int) -> torch.Tensor:
    """(a + b) mod m for a, b in [0, m), m < 2^63: a + b is formed only
    where it stays below m."""
    gap = m - b
    return torch.where(a >= gap, a - gap, a + b)


def _shl16(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * 2^16) mod m for a in [0, m): one shift where a * 2^16 < 2^63,
    else sixteen doublings mod m."""
    if m <= 1 << (63 - LIMB):
        return torch.remainder(a << LIMB, m)
    for _ in range(LIMB):
        a = _addmod(a, a, m)
    return a


def _combine(prods: dict, m: int) -> torch.Tensor:
    """sum of the limb products prods[(i, j)] * 2^(16 (i + j)) mod m, in
    [0, m); each product exact, below 2^53."""
    top = max(i + j for i, j in prods)
    weights = [sum(p for (i, j), p in prods.items() if i + j == s) for s in range(top + 1)]
    acc = torch.remainder(weights[top], m)
    for w in reversed(weights[:top]):
        acc = _addmod(_shl16(acc, m), torch.remainder(w, m), m)
    return acc


def _exact(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x).to(torch.int64)


def mul(a: torch.Tensor, b: torch.Tensor, m: int) -> torch.Tensor:
    """(a * b) mod (x^N + 1, m), in [0, m): a [..., N], b [..., N] with
    broadcastable leading axes, int64 values of any sign."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    n = a.shape[-1]
    a = a.expand(shape + (n,)).reshape(-1, n)
    b = b.expand(shape + (n,)).reshape(-1, n)
    out = torch.empty_like(b, dtype=torch.int64)
    for i in range(0, b.shape[0], ROW_BLOCK):
        mats = [negacyclic_matrix(x) for x in _limbs(a[i:i + ROW_BLOCK], m)]
        vecs = [x.unsqueeze(-1) for x in _limbs(b[i:i + ROW_BLOCK], m)]
        out[i:i + ROW_BLOCK] = _combine(
            {(s, t): _exact(torch.matmul(x, y).squeeze(-1))
             for s, x in enumerate(mats) for t, y in enumerate(vecs)}, m)
    return out.reshape(shape + (n,))


def mat_vec(key: torch.Tensor, v: torch.Tensor, m: int) -> torch.Tensor:
    """(key . v) mod m in [0, m): key [rows, k, N] (one matrix of
    polynomials), v [R, k, N] -> [R, rows, N]. The key's negacyclic
    matrices are built once, and each limb pair is one matrix product over
    all R rows."""
    rows, k, n = key.shape

    def big(limb):   # [rows, k, N] -> [rows N, k N]
        return negacyclic_matrix(limb).permute(0, 2, 1, 3).reshape(rows * n, k * n)

    keys = [big(x) for x in _limbs(key, m)]
    vecs = _limbs(v.reshape(v.shape[0], k * n), m)
    out = _combine({(s, t): _exact(x @ y.T) for s, x in enumerate(keys)
                    for t, y in enumerate(vecs)}, m)      # [rows*N, R]
    return out.T.reshape(v.shape[0], rows, n)


def norm2_leq(x: torch.Tensor, bound: int) -> torch.Tensor:
    """isqrt(sum of squares over the last axis) <= bound, exactly, for any
    int64 x and bound < 2^31: every coefficient in [-bound, bound] (else
    the sum alone exceeds the limit; a comparison, since |-2^63| is not an
    int64) and the sum of squares <= bound^2 + 2 bound, compared in base
    2^31 so that no sum overflows (each square < 2^62, N <= 2^24 terms)."""
    x = x.to(torch.int64)
    inside = ((x >= -bound) & (x <= bound)).all(-1)
    xc = torch.clamp(x, -bound, bound)
    sq = xc * xc
    lo = (sq & LOW31).sum(-1)
    hi = (sq >> 31).sum(-1) + (lo >> 31)
    lo = lo & LOW31
    lim = bound * bound + 2 * bound
    return inside & ((hi < lim >> 31) | ((hi == lim >> 31) & (lo <= lim & LOW31)))
