"""The int8 digit matvec with its mod-q fold, in both operator layouts.

K3 (``csrc/matvec_digits.cu``), counterpart of ``matvec_digits_pallas``:
v int32 [B, kN] (balanced base-256 digits taken on the fly), operator int8
[kN, KEY_DIGITS*rowsN], out centered int32 [B, rowsN].

K6 (``csrc/matvec_colblock.cu``), counterpart of
``matvec_digits_colblock``: the same function over the blocked operator
int8 [KEY_DIGITS, kN, rowsN], the layout keys past the resident gate store
(``conv_mxu.maybe_blocked_layout``).

Both kernels read the operator packed: ``pack_planes`` turns a key's
digit planes [KEY_DIGITS, kN, rowsN] into one block per 64-column tile and
32-deep k step, in the K-major core-matrix layout the kernels' wgmma
descriptors name (``csrc/matvec_tiles.cuh``). Both stored layouts of one
key pack to the same tensor, which the wrapper builds on a key's first
launch and keeps on the operator tensor (``packed_operator``); the stored
layouts themselves do not change. K10 packs its operator the same way.

Torch has no integer matmul on CUDA, so the plain versions multiply the
digit planes in float64. That is exact: every plane sum is at most
kN * 128^2 < 2^53.
"""

from __future__ import annotations

import numpy as np
import torch

from . import check, device_cache, launch, on_cuda

MAX_V_DIGITS = 4  # the bias trick needs capacity(ndig) + bias < 2^32
TILE_N, TILE_K = 64, 32  # the kernels' operator tile: columns, contraction


def pack_planes(planes: torch.Tensor) -> torch.Tensor:
    """Digit planes int8 [..., kN, rowsN] (D planes in all) -> the packed
    operator int8 [ceil(rowsN/64), ceil(kN/32), D, 2, 64, 16]: for each
    64-column tile and 32-deep k step, plane by plane, the two 16-byte k
    halves of every column (k contiguous), zero past kN and rowsN."""
    kn, rows_n = planes.shape[-2:]
    planes = planes.reshape(-1, kn, rows_n)
    d = planes.shape[0]
    ks, nt = -(-kn // TILE_K), -(-rows_n // TILE_N)
    padded = planes.new_zeros((d, ks * TILE_K, nt * TILE_N))
    padded[:, :kn, :rows_n] = planes
    return padded.reshape(d, ks, 2, 16, nt, TILE_N).permute(4, 1, 0, 2, 5, 3).contiguous()


def unpack_planes(packed: torch.Tensor, kn: int, rows_n: int) -> torch.Tensor:
    """Inverse of ``pack_planes``: the digit planes [D, kN, rowsN]."""
    nt, ks, d = packed.shape[:3]
    planes = packed.permute(2, 1, 3, 5, 0, 4).reshape(d, ks * TILE_K, nt * TILE_N)
    return planes[:, :kn, :rows_n]


def key_planes(w: torch.Tensor, rows_n: int) -> torch.Tensor:
    """The digit planes [D, kN, rowsN] of a key's operator, blocked
    [D, kN, rowsN] (itself) or side by side [kN, D*rowsN] (a view)."""
    if w.dim() == 3:
        return w
    return w.reshape(w.shape[0], w.shape[1] // rows_n, rows_n).permute(1, 0, 2)


def packed_operator(w: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """The packed twin of operator ``w``, ``pack_planes(planes)`` for a view
    ``planes`` of ``w``: built on its first launch and kept on ``w`` until
    ``w`` is written to."""
    hit = getattr(w, "_rz_packed", None)
    if hit is None or hit[0] != w._version:
        hit = (w._version, pack_planes(planes))
        w._rz_packed = hit
    return hit[1]


def fold_consts(ring, device) -> torch.Tensor:
    """[q, -q^-1 mod 2^32, RADIX^s*R mod q for s < 8, (2^32*RADIX^s) mod q
    for s < 8] as int32 bit patterns: the fold constants ``matvec_digits.cu``
    reads."""
    from .. import conv_mxu

    def make():
        c = [ring.qctx.p, ring.qctx.pinv_neg]
        c += [conv_mxu._shift_mont(ring, s) for s in range(8)]
        c += [conv_mxu._shift_neg_corr(ring, s) for s in range(8)]
        return torch.from_numpy(np.array(c, np.uint32).view(np.int32)).to(device)

    return device_cache(ring, ("fold", str(device)), make)


def _fold_groups(ring, plane, v_digits: int):
    """int64 shift groups G_s = sum_{dv + dw = s} plane(dv, dw), folded mod
    q with one Montgomery product each: centered int32."""
    from .. import conv_mxu

    qc = ring.qctx
    groups = [None] * (v_digits + conv_mxu.KEY_DIGITS - 1)
    for dv in range(v_digits):
        for dw in range(conv_mxu.KEY_DIGITS):
            p = plane(dv, dw)
            groups[dv + dw] = p if groups[dv + dw] is None else groups[dv + dw] + p
    acc = None
    for s, g in enumerate(groups):
        # mont_mul takes the two's-complement bits of the group sum; a
        # negative sum's excess 2^32*RADIX^s is subtracted back
        term = qc.mont_mul(g & 0xFFFFFFFF, conv_mxu._shift_mont(ring, s))
        term = qc.sub(term, torch.where(g < 0, conv_mxu._shift_neg_corr(ring, s), 0))
        acc = term if acc is None else qc.add(acc, term)
    return ring.to_centered(acc)


def matvec_digits_plain(ring, w_digits, rows_n: int, v, v_digits: int):
    """Plain version of K3: float64 plane products, int64 shift groups, the
    single-REDC fold on the Montgomery twins."""
    from .. import conv_mxu

    bflat, kn = v.shape
    vd = conv_mxu.balanced_digits(v, v_digits)                     # [dv, B, kN]
    prod = (vd.reshape(v_digits * bflat, kn).to(torch.float64)
            @ w_digits.to(torch.float64)).to(torch.int64)
    prod = prod.reshape(v_digits, bflat, conv_mxu.KEY_DIGITS, rows_n)
    return _fold_groups(ring, lambda dv, dw: prod[dv, :, dw], v_digits)


def matvec_digits_colblock_plain(ring, w3, rows_n: int, v, v_digits: int):
    """Plain version of K6: the float64 product of every input digit plane
    with every blocked key plane, then K3's int64 shift groups and fold."""
    from .. import conv_mxu

    bflat, kn = v.shape
    vd = conv_mxu.balanced_digits(v, v_digits).to(torch.float64)  # [dv, B, kN]
    prod = torch.matmul(vd.reshape(1, v_digits * bflat, kn), w3.to(torch.float64))
    prod = prod.to(torch.int64).reshape(conv_mxu.KEY_DIGITS, v_digits, bflat, rows_n)
    return _fold_groups(ring, lambda dv, dw: prod[dw, dv], v_digits)


def _run(name: str, fn: str, plain, ring, w, w_shape: tuple, rows_n: int, v, v_digits: int):
    """K3's and K6's wrapper: check the arguments, then the plain version
    for CPU tensors or the kernel, on the packed operator, for CUDA ones."""
    bflat, kn = v.shape
    check(name, v, torch.int32, (bflat, kn))
    check(name, w, torch.int8, w_shape)
    if not 1 <= v_digits <= MAX_V_DIGITS:
        raise ValueError(f"{name}: v_digits={v_digits} outside 1..{MAX_V_DIGITS}")
    if not on_cuda(name, v, w):
        return plain(ring, w, rows_n, v, v_digits)
    if rows_n % 2 or kn % 4:
        raise ValueError(f"{name}: rows_n must be even and kN a multiple of 4 "
                         f"(rows_n={rows_n}, kN={kn})")
    if v.data_ptr() % 16:  # the kernel copies 16-byte aligned rows of v
        v = v.clone()
    packed = packed_operator(w, key_planes(w, rows_n))
    out = torch.empty((bflat, rows_n), dtype=torch.int32, device=v.device)
    launch(name, fn, v.device, v, packed, out, fold_consts(ring, v.device), bflat, kn, rows_n,
           v_digits)
    return out


def matvec_digits(ring, w_digits, rows_n: int, v, v_digits: int):
    """K3: v int32 [B, kN], operator int8 [kN, 4*rows_n] -> int32 [B, rows_n]."""
    from ..conv_mxu import KEY_DIGITS

    return _run("matvec_digits", "rz_matvec_digits", matvec_digits_plain, ring, w_digits,
                (v.shape[-1], KEY_DIGITS * rows_n), rows_n, v, v_digits)


def matvec_digits_colblock(ring, w3, rows_n: int, v, v_digits: int):
    """K6: v int32 [B, kN], blocked operator int8 [4, kN, rows_n] -> int32
    [B, rows_n]."""
    from ..conv_mxu import KEY_DIGITS

    return _run("matvec_colblock", "rz_matvec_colblock", matvec_digits_colblock_plain, ring,
                w3, (KEY_DIGITS, v.shape[-1], rows_n), rows_n, v, v_digits)
