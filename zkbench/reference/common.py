"""What the open and sum references share: the scheme's bounds, the key
matrices, and ring arithmetic at a chosen accumulator width.

The formulas are ring-zk's (src/params.rs: sigma = b * 11 * kappa *
isqrt(k N), the commit bound 4 sigma isqrt(N), the verify bound 2 sigma
isqrt(N)), and the key's shape is BDLOP's (src/commit.rs): a1 = [I_n |
A1'], a2 = [0_{l x n} | I_l | A2'], with A1', A2' the benchmark's own
uniform draws. The prover's Gaussian masks are clamped to 16 sigma, as
the program states.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import ring


class Scheme(NamedTuple):
    """A configuration's parameters (its file's ``params``) at degree n_deg."""

    modulus: int
    b: int
    n: int
    k: int
    l: int
    kappa: int
    n_deg: int

    @classmethod
    def of(cls, cfg: dict) -> "Scheme":
        p = cfg["params"]
        return cls(p["modulus"], p["b"], p["n"], p["k"], p["l"], p["kappa"], cfg["N"])

    @property
    def sigma(self) -> int:
        return self.b * 11 * self.kappa * math.isqrt(self.k * self.n_deg)

    @property
    def commit_bound(self) -> int:
        return 4 * self.sigma * math.isqrt(self.n_deg)

    @property
    def verify_bound(self) -> int:
        return 2 * self.sigma * math.isqrt(self.n_deg)

    @property
    def mask_bound(self) -> int:
        return 16 * self.sigma


def key_matrices(s: Scheme, a1p: torch.Tensor, a2p: torch.Tensor):
    """(a1 [n, k, N], a2 [l, k, N]) int64 from the uniform parts a1p
    [n, k-n, N] and a2p [l, k-n-l, N]."""
    dev = a1p.device

    def eye(rows):
        e = torch.zeros((rows, rows, s.n_deg), dtype=torch.int64, device=dev)
        e[torch.arange(rows), torch.arange(rows), 0] = 1
        return e

    a1 = torch.cat([eye(s.n), a1p.to(torch.int64)], dim=1)
    a2 = torch.cat([torch.zeros((s.l, s.n, s.n_deg), dtype=torch.int64, device=dev), eye(s.l),
                    a2p.to(torch.int64)], dim=1)
    return a1, a2


class Arith:
    """Centered products, sums and differences mod q, exact for every odd
    q < 2^63 and any int64 operands. ``wrap32`` keeps each product's exact
    integer sum to 32 bits first, as a 32-bit accumulator would: the
    control's lower precision."""

    def __init__(self, q: int, wrap32: bool = False):
        self.q, self.wrap = q, wrap32

    def _finish(self, fn, *args):
        if self.wrap:
            return ring.centered(ring.wrap32(fn(*args, 2**32)), self.q)
        return ring.centered(fn(*args, self.q), self.q)

    def mul(self, a, b):
        """a * b, [..., N] each (broadcast)."""
        return self._finish(ring.mul, a, b)

    def key(self, key, v):
        """key [rows, k, N] . v [..., k, N] -> [..., rows, N]."""
        lead = v.shape[:-2]
        out = self._finish(ring.mat_vec, key, v.reshape((-1,) + tuple(v.shape[-2:])))
        return out.reshape(lead + tuple(out.shape[-2:]))

    def add(self, a, b):
        """Each operand centered first: the sum of two centered residues
        is below q < 2^63."""
        return ring.centered(self._cen(a) + self._cen(b), self.q)

    def sub(self, a, b):
        return ring.centered(self._cen(a) - self._cen(b), self.q)

    def _cen(self, a):
        return ring.centered(a.to(torch.int64), self.q)


def same(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per row (leading axis): every value equal."""
    return (a.to(torch.int64) == b.to(torch.int64)).reshape(a.shape[0], -1).all(-1)


def select_challenge(s: Scheme, keys: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """The challenge [R, N] that the sampler's draws give (src/prove.rs's
    challenge space, kernel K4's rule): the signs [R, N] at the min(kappa,
    N) lanes of the largest keys [R, N] (uint32, held as int32 bit
    patterns), ties to the lower lane, zero elsewhere. One composite key,
    key * N + (N - 1 - lane), orders the lanes without ties, so a plain
    top-k of it is the selection."""
    n = s.n_deg
    u = keys.to(torch.int64) & 0xFFFFFFFF
    score = u * n + (n - 1 - torch.arange(n, device=u.device))
    pos = torch.topk(score, min(s.kappa, n), dim=-1).indices
    return torch.zeros_like(u).scatter_(1, pos, signs.to(torch.int64).gather(1, pos))


def is_challenge(s: Scheme, d: torch.Tensor) -> torch.Tensor:
    """Per row of d [R, N]: exactly min(kappa, N) coefficients, each +-1."""
    d = d.to(torch.int64)
    nz = d != 0
    return (nz.sum(-1) == min(s.kappa, s.n_deg)) & ((d >= -1) & (d <= 1)).all(-1)


def norms_ok(x: torch.Tensor, bound: int) -> torch.Tensor:
    """Per row of x [R, ..., N]: every polynomial's norm within bound."""
    return ring.norm2_leq(x, bound).reshape(x.shape[0], -1).all(-1)


def within(x: torch.Tensor, bound: int) -> torch.Tensor:
    """Per row: every coefficient in [-bound, bound] (compared, not by its
    absolute value: |-2^63| is not an int64)."""
    x = x.to(torch.int64)
    return ((x >= -bound) & (x <= bound)).reshape(x.shape[0], -1).all(-1)
