"""K5: the fused ``t + d * m`` mod q (``csrc/scalar_mul_add.cu``).

Counterpart of both ``scalar_mul_add_pallas`` and
``scalar_mul_add_pallas_v2``: d int32 [B, N], m and t int32 [B, rows, N]
-> centered int32 [B, rows, N], over the first ``num`` CRT primes. m and t
may hold any int32.

The plain version is the composed chain of ``RingContext.scalar_mul_add``
on the plain K1 and K2 versions: fwd_const(d), fwd(m), dot_hat, inv and
the centered add of t.
"""

from __future__ import annotations

import torch

from . import check, launch, on_cuda
from .ntt import MAX_N, MIN_N, fwd_all_plain, inv_all_plain, kernel_consts, twiddle_pairs
from .. import zq


def scalar_mul_add_plain(ring, d: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
                         num: int) -> torch.Tensor:
    """Plain version of K5: the composed chain on the plain K1/K2."""
    b, rows, n = m.shape
    dh = ring.to_const(fwd_all_plain(ring, d, num))
    mh = fwd_all_plain(ring, m.reshape(b * rows, n), num).reshape(num, b, rows, n)
    prod = ring.dot_hat(dh.unsqueeze(-2), mh)
    dm = inv_all_plain(ring, prod.reshape(num, b * rows, n)).reshape(b, rows, n)
    return zq.add_centered(ring.qctx, t, dm)


def scalar_mul_add(ring, d: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
                   num: int) -> torch.Tensor:
    """K5: d int32 [B, N], m, t int32 [B, rows, N] -> int32 [B, rows, N]."""
    b, rows, n = m.shape
    check("scalar_mul_add", d, torch.int32, (b, ring.n))
    check("scalar_mul_add", m, torch.int32, (b, rows, ring.n))
    check("scalar_mul_add", t, torch.int32, (b, rows, ring.n))
    if not 1 <= num <= ring.num_primes:
        raise ValueError(f"scalar_mul_add: num={num} outside 1..{ring.num_primes}")
    if not on_cuda("scalar_mul_add", d, m, t):
        return scalar_mul_add_plain(ring, d, m, t, num)
    if not MIN_N <= n <= MAX_N:
        raise ValueError(f"scalar_mul_add: N={n} outside {MIN_N}..{MAX_N}")
    out = torch.empty_like(m)
    launch("scalar_mul_add", "rz_scalar_mul_add", d.device, d, m, t, out,
           twiddle_pairs(ring, d.device), kernel_consts(ring, num, d.device), num, b, rows, n)
    return out
