"""K7 and K8: the wide-ring forward and inverse NTT (``csrc/ntt_wide.cu``).

Wide rings (2^32 <= q < 2^63) carry int64 residues and up to eight CRT
primes (``RingContext.primes``). K7 ``fwd_wide_all``: any int64 [rows, N]
-> NTT images [num, rows, N], uint32 bit patterns stored as int32
(counterpart of ``fwd_wide_all_pallas``). K8 ``inv_wide_all``: images
[num, rows, N] -> centered int64 [rows, N] mod q via the per-prime inverse
transforms, Garner's digits and the 64-bit mod-q fold (counterpart of
``inv_wide_all_pallas``).

The plain versions repeat the JAX package's algebra: x mod p_i = (lo mod
p_i) + (hi signed) * (2^32 mod p_i) on the limbs of x, the butterflies of
K1/K2's plain versions, and ``RingContext._crt_to_pair`` on the Mont64
twins. The kernels compute the same unique residues by another exact
route (see the source): the register-resident transform of
``csrc/ntt_regs.cuh``, in the lazy or the strict butterfly form per prime
(:func:`lazy_butterflies`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import check, device_cache, launch, on_cuda
from .ntt import MAX_N, MIN_N, fwd_stages_plain, inv_all_plain, twiddle_pairs
from ..mont64 import Mont64Ctx
from ..u64 import MASK32

_Q, _M_MOD_Q, _HALF_Q, _K, _K_SHOUP, _HALF_DIGITS, _INV, _W = 64, 66, 68, 72, 88, 104, 112, 128
SMEM_MAX = 227 * 1024  # shared memory a block may take; K8 holds num * N words


def lazy_butterflies(p: int) -> bool:
    """Whether the kernels run prime p's stages in Harvey's lazy form
    (values up to 4p in a word), else the strict one: the rule of the
    Pallas kernels' ``_fwd_stages``/``_inv_stages``."""
    return 4 * p < 2**32


def wide_consts(ring, num: int) -> torch.Tensor:
    """The constant block of K7 and K8 for the first ``num`` primes, 256
    uint32 slots stored as int32 in a CPU tensor, which the kernels take
    by value (``csrc/ntt_wide.cu`` documents it)."""

    def make():
        ps = ring.primes[:num]
        c = np.zeros(256, np.uint64)
        for i, p in enumerate(ps):
            n_inv, n_inv_shoup = ring._tables[i][2]
            mc = ring.mont[i]
            c[8 * i: 8 * i + 8] = [p, (1 << 32) // p, (-(1 << 32)) % p, n_inv, n_inv_shoup,
                                   mc.pinv_neg, mc.r2, lazy_butterflies(p)]
        q = ring.q

        def put64(slot, v):
            c[slot], c[slot + 1] = v & MASK32, v >> 32

        put64(_Q, q)
        put64(_M_MOD_Q, math.prod(ps) % q)
        put64(_HALF_Q, q // 2)
        c[_HALF_DIGITS: _HALF_DIGITS + num] = ring._garner(num)["half_digits"]
        for i, p in enumerate(ps):
            k = math.prod(ps[:i]) % q
            put64(_K + 2 * i, k)
            put64(_K_SHOUP + 2 * i, (k << 64) // q)
            if i > 0:
                inv = pow(math.prod(ps[:i]), -1, p)
                c[_INV + 2 * i: _INV + 2 * i + 2] = [inv, (inv << 32) // p]
            for j in range(i):
                w = math.prod(ps[:j]) % p
                c[_W + 16 * i + 2 * j: _W + 16 * i + 2 * j + 2] = [w, (w << 32) // p]
        return torch.from_numpy(c.astype(np.uint32).view(np.int32))

    return device_cache(ring, ("wide_consts", num), make)


def fwd_wide_all_plain(ring, x: torch.Tensor, num: int) -> torch.Tensor:
    """Plain version of K7: x int64 [rows, N] -> int32 [num, rows, N]."""
    lo, hi = Mont64Ctx.split_i64(x)
    residues = []
    for i in range(num):
        ctx = ring.mont[i]
        shift = ctx.h_to_mont((1 << 32) % ctx.p)
        residues.append(ctx.add(ctx.reduce_u32(lo),
                                ctx.mont_mul(ctx.reduce_i32_centered(hi), shift)))
    return fwd_stages_plain(ring, residues)


# Plain version of K8: int32 [num, rows, N] -> centered int64 [rows, N]. K2's
# plain version computes it: on a wide ring its Garner step is _crt_to_pair.
inv_wide_all_plain = inv_all_plain


def _check_n(name: str, n: int) -> None:
    if not MIN_N <= n <= MAX_N:
        raise ValueError(f"{name}: N={n} outside {MIN_N}..{MAX_N}")


def fwd_wide_all(ring, x: torch.Tensor, num: int) -> torch.Tensor:
    """K7: any int64 [rows, N] -> int32 [num, rows, N] NTT images."""
    rows, n = x.shape
    check("fwd_wide_all", x, torch.int64, (rows, ring.n))
    if not 1 <= num <= ring.num_primes:
        raise ValueError(f"fwd_wide_all: num={num} outside 1..{ring.num_primes}")
    if not on_cuda("fwd_wide_all", x):
        return fwd_wide_all_plain(ring, x, num)
    _check_n("fwd_wide_all", n)
    out = torch.empty((num, rows, n), dtype=torch.int32, device=x.device)
    launch("ntt_fwd_wide", "rz_ntt_fwd_wide", x.device, x, out, twiddle_pairs(ring, x.device),
           wide_consts(ring, num), num, rows, n)
    return out


def inv_wide_all(ring, xhat: torch.Tensor) -> torch.Tensor:
    """K8: int32 [num, rows, N] NTT images, each in [0, p_i) -> centered
    int64 [rows, N]."""
    num, rows, n = xhat.shape
    check("inv_wide_all", xhat, torch.int32, (num, rows, ring.n))
    if not 1 <= num <= ring.num_primes:
        raise ValueError(f"inv_wide_all: num={num} outside 1..{ring.num_primes}")
    if not on_cuda("inv_wide_all", xhat):
        return inv_wide_all_plain(ring, xhat)
    _check_n("inv_wide_all", n)
    if 4 * num * n > SMEM_MAX:
        raise ValueError(f"inv_wide_all: num={num} planes of N={n} take {4 * num * n} bytes of "
                         f"shared memory, more than a block's {SMEM_MAX}")
    out = torch.empty((rows, n), dtype=torch.int64, device=xhat.device)
    launch("ntt_inv_wide", "rz_ntt_inv_wide", xhat.device, xhat, out,
           twiddle_pairs(ring, xhat.device), wide_consts(ring, num), num, rows, n)
    return out
