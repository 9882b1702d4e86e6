"""K9: the single-prime strict NTT, forward and inverse (``csrc/ntt_one.cu``).

``fwd_one``: uint32 [rows, N] (int32 bits) -> the image at prime i of the
ring's primes, bit-reversed order (counterpart of ``fwd_one_pallas``, the
function of the JAX package's ``ntt._fwd_one``). ``inv_one``: the inverse
with the N^-1 scaling and no CRT (``inv_one_pallas``, ``ntt._inv_one``).
The input is taken as given, with no reduction: residues in [0, p) give
the unique residues, other values wrap as MontCtx's add and sub wrap them.

The plain versions are K1/K2's plain stage loops at prime i
(:func:`fwd_stages_one`, :func:`inv_stages_one`) without the CRT. The
kernel runs the register-resident transform in its wrap butterfly form.
"""

from __future__ import annotations

import numpy as np
import torch

from . import check, device_cache, launch, on_cuda
from .ntt import check_n, fwd_stages_one, inv_stages_one, twiddle_pairs, twiddles
from ..u64 import narrow, widen


def one_consts(ring, i: int) -> torch.Tensor:
    """Prime i's constants on the CPU, which the kernel takes by value
    (``csrc/ntt_one.cu`` ``OneConsts``): p, N^-1 mod p, its Shoup
    companion."""

    def make():
        n_inv, n_inv_shoup = ring._tables[i][2]
        c = np.array([ring.primes[i], n_inv, n_inv_shoup], np.uint64)
        return torch.from_numpy(c.astype(np.uint32).view(np.int32))

    return device_cache(ring, ("one_consts", i), make)


def fwd_one_plain(ring, i: int, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K9's forward: int32 bits [rows, N] -> [rows, N]."""
    tw = widen(twiddles(ring, x.device)[i])
    return narrow(fwd_stages_one(ring.mont[i], tw, widen(x)))


def inv_one_plain(ring, i: int, xh: torch.Tensor) -> torch.Tensor:
    """Plain version of K9's inverse: int32 bits [rows, N] -> [rows, N]."""
    ctx = ring.mont[i]
    tw = widen(twiddles(ring, xh.device)[i])
    n_inv, n_inv_shoup = ring._tables[i][2]
    return narrow(ctx.shoup_mul(n_inv, n_inv_shoup, inv_stages_one(ctx, tw, widen(xh))))


def _run(counter: str, fn: str, plain, ring, i: int, x: torch.Tensor) -> torch.Tensor:
    rows, n = x.shape
    check(counter, x, torch.int32, (rows, ring.n))
    if not 0 <= i < ring.num_primes:
        raise ValueError(f"{counter}: prime index {i} outside 0..{ring.num_primes - 1}")
    if not on_cuda(counter, x):
        return plain(ring, i, x)
    check_n(counter, n)
    out = torch.empty_like(x)
    launch(counter, fn, x.device, x, out, twiddle_pairs(ring, x.device)[i], one_consts(ring, i),
           rows, n)
    return out


def fwd_one(ring, i: int, x: torch.Tensor) -> torch.Tensor:
    """K9 forward at prime i: int32 bits [rows, N] -> [rows, N]."""
    return _run("ntt_fwd_one", "rz_ntt_fwd_one", fwd_one_plain, ring, i, x)


def inv_one(ring, i: int, xh: torch.Tensor) -> torch.Tensor:
    """K9 inverse at prime i (with N^-1): int32 bits [rows, N] -> [rows, N]."""
    return _run("ntt_inv_one", "rz_ntt_inv_one", inv_one_plain, ring, i, xh)
