"""K1 and K2: forward and inverse NTT over the CRT primes (``csrc/ntt.cu``).

K1 ``fwd_all``: centered int32 [rows, N] -> NTT images [num, rows, N],
uint32 bit patterns stored as int32 (counterpart of ``fwd_all_pallas``).
K2 ``inv_all``: images [num, rows, N] -> centered int32 [rows, N] mod q
via per-prime inverse transforms, Garner's CRT and the mod-q fold
(counterpart of ``inv_all_pallas``).

The plain versions run the same butterflies as strided views of the row,
on the int64 Montgomery twins; every stage reduces to [0, p).
"""

from __future__ import annotations

import numpy as np
import torch

from . import check, device_cache, launch, on_cuda
from ..u64 import narrow, widen

_GARNER = 24  # offset of the Garner block in the constant array (ntt_stages.cuh)
# Ring degrees of the register-resident transform (csrc/ntt_regs.cuh, K5, K7
# and K8): a thread holds at least one 16-byte vector of a row.
MIN_N, MAX_N = 4, 8192


def twiddles(ring, device) -> torch.Tensor:
    """[primes, 4, N] int32: psi_rev, its Shoup companion, psi_inv_rev, its
    Shoup companion, per prime (``_prime_tables`` of the ring)."""

    def make():
        rows = []
        for p, (psi_rev, psi_inv_rev, _, _, _) in zip(ring.primes, ring._tables):
            shoup = lambda w: ((w.astype(object) << 32) // p).astype(np.uint32)
            rows.append(np.stack([psi_rev, shoup(psi_rev), psi_inv_rev, shoup(psi_inv_rev)]))
        return torch.from_numpy(np.stack(rows).view(np.int32)).to(device)

    return device_cache(ring, ("twiddles", str(device)), make)


def twiddle_pairs(ring, device) -> torch.Tensor:
    """[primes, 2, N, 2] int32: per prime the forward table (psi_rev, its
    Shoup companion) and the inverse one (psi_inv_rev, its companion) as
    (w, w') pairs, the uint2 table ``csrc/ntt_regs.cuh`` reads (K5, K7,
    K8)."""

    def make():
        tw = twiddles(ring, device)
        return torch.stack([tw[:, 0:2], tw[:, 2:4]], dim=1).transpose(-1, -2).contiguous()

    return device_cache(ring, ("twiddle_pairs", str(device)), make)


def kernel_consts(ring, num: int, device) -> torch.Tensor:
    """The constant block ``csrc/ntt_stages.cuh`` documents, for the first
    ``num`` primes (read by K1, K2 and K5)."""

    def make():
        c = np.zeros(40, np.uint64)
        for i, p in enumerate(ring.primes[:num]):
            n_inv, n_inv_shoup = ring._tables[i][2]
            mc = ring.mont[i]
            c[8 * i: 8 * i + 7] = [p, (1 << 32) // p, (-(1 << 32)) % p, n_inv, n_inv_shoup,
                                   mc.pinv_neg, mc.r2]
        g = ring._garner(num)
        qc = ring.qctx
        c[_GARNER: _GARNER + 4] = [qc.p, qc.pinv_neg, qc.r1, g["m_mod_q"]]
        c[28: 28 + num] = g["half_digits"]
        c[31: 31 + num - 1] = g["k_mont"]
        prod = 1
        for i in range(1, num):
            p = ring.primes[i]
            prod *= ring.primes[i - 1]
            inv = pow(prod, -1, p)
            c[33 + i - 1] = inv
            c[35 + i - 1] = (inv << 32) // p
        if num > 2:
            p0_mod_p2 = ring.primes[0] % ring.primes[2]
            c[37:39] = [p0_mod_p2, (p0_mod_p2 << 32) // ring.primes[2]]
        return torch.from_numpy(c.astype(np.uint32).view(np.int32)).to(device)

    return device_cache(ring, ("consts", num, str(device)), make)


def fwd_stages_one(ctx, tw, a: torch.Tensor) -> torch.Tensor:
    """The forward stages at one prime: ``ctx`` its Montgomery twin, ``tw``
    its int64 twiddle rows [4, N], a int64 [rows, N] (uint32 values) ->
    int64 [rows, N], bit-reversed order. MontCtx's strict butterflies: a
    value outside [0, p) wraps as the JAX package's does."""
    rows, n = a.shape
    for s in range(n.bit_length() - 1):
        m, t = 1 << s, n >> (s + 1)
        a = a.view(rows, m, 2, t)
        w = tw[0, m: 2 * m].view(1, m, 1)
        ws = tw[1, m: 2 * m].view(1, m, 1)
        lo, hi = a[:, :, 0], a[:, :, 1]
        prod = ctx.shoup_mul(w, ws, hi)
        a = torch.stack([ctx.add(lo, prod), ctx.sub(lo, prod)], dim=2).view(rows, n)
    return a


def inv_stages_one(ctx, tw, a: torch.Tensor) -> torch.Tensor:
    """The inverse stages at one prime, without the N^-1 scaling
    (arguments as :func:`fwd_stages_one`)."""
    rows, n = a.shape
    for s in range(n.bit_length() - 1):
        t, h = 1 << s, n >> (s + 1)
        a = a.view(rows, h, 2, t)
        w = tw[2, h: 2 * h].view(1, h, 1)
        ws = tw[3, h: 2 * h].view(1, h, 1)
        lo, hi = a[:, :, 0], a[:, :, 1]
        a = torch.stack(
            [ctx.add(lo, hi), ctx.shoup_mul(w, ws, ctx.sub(lo, hi))], dim=2
        ).view(rows, n)
    return a


def fwd_stages_plain(ring, residues) -> torch.Tensor:
    """The forward stages of the plain versions: ``residues[i]`` int64
    [rows, N] in [0, p_i) for the first len(residues) primes -> int32
    [num, rows, N] NTT images."""
    tw = widen(twiddles(ring, residues[0].device))
    return narrow(torch.stack([fwd_stages_one(ring.mont[i], tw[i], a)
                               for i, a in enumerate(residues)]))


def fwd_all_plain(ring, x: torch.Tensor, num: int) -> torch.Tensor:
    """Plain version of K1: x int32 [rows, N] -> int32 [num, rows, N]."""
    return fwd_stages_plain(ring, [ring.mont[i].reduce_i32_centered(x) for i in range(num)])


def inv_all_plain(ring, xhat: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: int32 [num, rows, N] -> centered [rows, N],
    int32 (int64 on wide rings, where it is also K8's plain version)."""
    tw = widen(twiddles(ring, xhat.device))
    ys = []
    for i in range(xhat.shape[0]):
        ctx = ring.mont[i]
        n_inv, n_inv_shoup = ring._tables[i][2]
        ys.append(ctx.shoup_mul(n_inv, n_inv_shoup, inv_stages_one(ctx, tw[i], widen(xhat[i]))))
    return ring._crt_to_centered(ys)


def fwd_all(ring, x: torch.Tensor, num: int) -> torch.Tensor:
    """K1: centered int32 [rows, N] -> int32 [num, rows, N] NTT images."""
    rows, n = x.shape
    check("fwd_all", x, torch.int32, (rows, ring.n))
    if not 1 <= num <= ring.num_primes:
        raise ValueError(f"fwd_all: num={num} outside 1..{ring.num_primes}")
    if not on_cuda("fwd_all", x):
        return fwd_all_plain(ring, x, num)
    out = torch.empty((num, rows, n), dtype=torch.int32, device=x.device)
    launch("ntt_fwd", "rz_ntt_fwd", x.device, x, out, twiddles(ring, x.device),
           kernel_consts(ring, num, x.device), num, rows, n)
    return out


def inv_all(ring, xhat: torch.Tensor) -> torch.Tensor:
    """K2: int32 [num, rows, N] NTT images -> centered int32 [rows, N]."""
    num, rows, n = xhat.shape
    check("inv_all", xhat, torch.int32, (num, rows, ring.n))
    if not 1 <= num <= ring.num_primes:
        raise ValueError(f"inv_all: num={num} outside 1..{ring.num_primes}")
    if not on_cuda("inv_all", xhat):
        return inv_all_plain(ring, xhat)
    out = torch.empty((rows, n), dtype=torch.int32, device=xhat.device)
    launch("ntt_inv", "rz_ntt_inv", xhat.device, xhat, out, twiddles(ring, xhat.device),
           kernel_consts(ring, num, xhat.device), num, rows, n)
    return out
