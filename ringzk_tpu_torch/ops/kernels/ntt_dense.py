"""K10: the single-prime NTT as one int8 matrix product (``csrc/ntt_dense.cu``).

``dense_apply``: x int32 [rows, N], the dense operator of prime i int8
[4N, 4N] (``ops/ntt_dense.py``) -> [0, p) int32 bits [rows, N]: four
balanced digits of each x, one int8 product, the per-plane fold mod p
(counterpart of ``dense_apply_pallas`` in ``archive/ntt_dense_kernel.py``).
The kernel takes x once per 32-deep slice of j and multiplies its four
digits u with the sixteen N x N blocks M[u*N + j, w*N + c] of the
operator (``dense_planes``), packed once by ``matvec.pack_planes`` into
the tiles K3 reads and kept on the operator tensor.

Torch has no integer matmul on CUDA, so the plain version multiplies the
digit planes in float64, as K3's does. That is exact: every sum is at most
4N * 128^2 = 2^26 at N=1024, far below 2^53.
"""

from __future__ import annotations

import numpy as np
import torch

from . import check, device_cache, launch, on_cuda
from .matvec import packed_operator
from ..u64 import narrow

DIGITS = 4  # input digits and operator planes (dout is 4 for every NTT prime)


def shifts_mont(ring, i: int) -> tuple:
    """256^w * R mod p_i for w < 4: the weights of the fold."""
    ctx = ring.mont[i]
    return tuple(ctx.h_to_mont(pow(256, w, ctx.p)) for w in range(DIGITS))


def dense_consts(ring, i: int, device) -> torch.Tensor:
    """K10's constant block: p, -p^-1 mod 2^32, floor(2^32/p), (-2^32) mod p,
    256^w * R mod p for w < 4 (int32 bits)."""

    def make():
        ctx = ring.mont[i]
        p = ctx.p
        c = np.array([p, ctx.pinv_neg, (1 << 32) // p, (-(1 << 32)) % p, *shifts_mont(ring, i)],
                     np.uint64)
        return torch.from_numpy(c.astype(np.uint32).view(np.int32)).to(device)

    return device_cache(ring, ("dense_consts", i, str(device)), make)


def dense_planes(m: torch.Tensor, n: int) -> torch.Tensor:
    """The operator [4N, 4N] as its sixteen blocks [u, w, j, c] =
    M[u*N + j, w*N + c] (a view): the planes K10 multiplies digit u of x
    with, accumulating output plane w."""
    return m.reshape(DIGITS, n, DIGITS, n).permute(0, 2, 1, 3)


def dense_apply_plain(ring, i: int, m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K10: float64 digit-plane product, int64 planes, the
    per-plane fold on the Montgomery twins."""
    from ..conv_mxu import balanced_digits
    from ..ntt_dense import _fold_planes

    rows, n = x.shape
    lhs = balanced_digits(x, DIGITS).permute(1, 0, 2).reshape(rows, DIGITS * n)  # (u, j)
    h = (lhs.to(torch.float64) @ m.to(torch.float64)).to(torch.int64)
    return narrow(_fold_planes(ring.mont[i], shifts_mont(ring, i), h.view(rows, DIGITS, n)))


def dense_apply(ring, i: int, m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K10: x int32 [rows, N], operator int8 [4N, 4N] of prime i -> [0, p)
    int32 bits [rows, N]."""
    rows, n = x.shape
    check("ntt_dense", x, torch.int32, (rows, ring.n))
    check("ntt_dense", m, torch.int8, (DIGITS * n, DIGITS * n))
    if not 0 <= i < ring.num_primes:
        raise ValueError(f"ntt_dense: prime index {i} outside 0..{ring.num_primes - 1}")
    if not on_cuda("ntt_dense", x, m):
        return dense_apply_plain(ring, i, m, x)
    if n < 32:
        raise ValueError(f"ntt_dense: the kernel takes N >= 32, got {n}")
    if x.data_ptr() % 16:  # the kernel copies 16-byte aligned rows of x
        x = x.clone()
    packed = packed_operator(m, dense_planes(m, n))
    out = torch.empty_like(x)
    launch("ntt_dense", "rz_ntt_dense", x.device, x, packed, out,
           dense_consts(ring, i, x.device), rows, n)
    return out
