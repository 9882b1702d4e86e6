"""Plain arithmetic of Z_q[x]/(x^N + 1) for the benchmark's reference.

Independent of the program under test: it imports torch alone. A product
of two polynomials is the negacyclic matrix of one times the other,
computed exactly: both operands are reduced to [0, m), cut into 16-bit
limbs, and each limb pair is one float64 matrix product, whose entries are
integers below N * 2^32 <= 2^45 for N <= 8192 and so exact in float64's 53
bits. The limb products are recombined mod m in int64.

``mul(a, b, m)`` with m = q is the ring's product. The benchmark's control
(``zkbench/control.py``) calls it with m = 2^32, which gives the exact
product over Z wrapped to 32 bits: what a 32-bit accumulator would hold.
"""

from __future__ import annotations

import torch

LIMB = 16
LOW = (1 << LIMB) - 1
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


def _limbs(v: torch.Tensor, m: int):
    u = torch.remainder(v.to(torch.int64), m)
    return (u & LOW).to(torch.float64), (u >> LIMB).to(torch.float64)


def _combine(p_ll, p_lh, p_hl, p_hh, m: int) -> torch.Tensor:
    """sum of limb products p_xy * 2^(16 (x + y)) mod m; each p exact."""
    s16 = (1 << LIMB) % m
    s32 = (1 << 2 * LIMB) % m
    ll, hh = torch.remainder(p_ll, m), torch.remainder(p_hh, m)
    mid = torch.remainder(p_lh + p_hl, m)
    return torch.remainder(ll + torch.remainder(mid * s16, m) + torch.remainder(hh * s32, m), m)


def _exact(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x).to(torch.int64)


def mul(a: torch.Tensor, b: torch.Tensor, m: int) -> torch.Tensor:
    """(a * b) mod (x^N + 1, m), in [0, m): a [..., N], b [..., N] with
    broadcastable leading axes, int64 values of any sign (|v| < 2^62)."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    n = a.shape[-1]
    a = a.expand(shape + (n,)).reshape(-1, n)
    b = b.expand(shape + (n,)).reshape(-1, n)
    out = torch.empty_like(b, dtype=torch.int64)
    for i in range(0, b.shape[0], ROW_BLOCK):
        al, ah = _limbs(a[i:i + ROW_BLOCK], m)
        bl, bh = _limbs(b[i:i + ROW_BLOCK], m)
        ml, mh = negacyclic_matrix(al), negacyclic_matrix(ah)

        def mv(mat, vec):
            return _exact(torch.matmul(mat, vec.unsqueeze(-1)).squeeze(-1))

        out[i:i + ROW_BLOCK] = _combine(mv(ml, bl), mv(ml, bh), mv(mh, bl), mv(mh, bh), m)
    return out.reshape(shape + (n,))


def mat_vec(key: torch.Tensor, v: torch.Tensor, m: int) -> torch.Tensor:
    """(key . v) mod m in [0, m): key [rows, k, N] (one matrix of
    polynomials), v [R, k, N] -> [R, rows, N]. The key's negacyclic
    matrices are built once, and each limb pair is one matrix product over
    all R rows."""
    rows, k, n = key.shape

    def big(limb):   # [rows, k, N] -> [rows N, k N]
        return negacyclic_matrix(limb).permute(0, 2, 1, 3).reshape(rows * n, k * n)

    kl, kh = (big(x) for x in _limbs(key, m))
    vl, vh = _limbs(v.reshape(v.shape[0], k * n), m)
    p = [_exact(x @ y.T) for x in (kl, kh) for y in (vl, vh)]   # ll, lh, hl, hh
    out = _combine(p[0], p[1], p[2], p[3], m)                   # [rows*N, R]
    return out.T.reshape(v.shape[0], rows, n)


def norm2_leq(x: torch.Tensor, bound: int) -> torch.Tensor:
    """isqrt(sum of squares over the last axis) <= bound, exactly: every
    |coefficient| <= bound (else the sum alone exceeds the limit) and the
    sum of squares <= bound^2 + 2 bound."""
    x = x.to(torch.int64)
    inside = (x.abs() <= bound).all(-1)
    xc = torch.clamp(x, -bound, bound)
    return inside & ((xc * xc).sum(-1) <= bound * bound + 2 * bound)
