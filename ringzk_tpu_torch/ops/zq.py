"""Centered mod-q scalar arithmetic.

Ring elements are centered residues in [-(q-1)/2, (q-1)/2], stored as int32
on narrow rings (q < 2^32) and as int64 on wide ones. Since a narrow q ~
2^31.7, centered sums overflow int32, so add and sub round-trip through the
unsigned [0, q) domain, as ``ringzk_tpu.ops.zq`` does, with the int64 twins
of :mod:`.montgomery`: on the CPU that chain itself, on a CUDA device one
kernel pass (:mod:`.kernels.modq`, whose plain version is the chain). On
wide rings the context is a :class:`.mont64.Mont64Ctx` (``is64``), and add
and sub wrap centered int64 sums directly.
"""

from __future__ import annotations

import torch

from ..utils.profiling import annotate
from .kernels import modq
from .montgomery import MontCtx
from .u64 import MASK32, narrow


def to_unsigned(ctx: MontCtx, a):
    """Centered int32 (|a| <= q/2) -> int64 in [0, q)."""
    ai = a.to(torch.int64)
    u = ai & MASK32
    # a < 0: true residue a + q = u - (2^32 - q) in uint32 wrap space
    return torch.where(ai < 0, (u - (2**32 - ctx.p)) & MASK32, u)


def to_centered(ctx: MontCtx, u):
    """int64 in [0, q) -> centered int32."""
    return narrow(u - torch.where(u > ctx.p // 2, ctx.p, 0))


@annotate("modq")
def add_centered(ctx, a, b):
    """(a + b) mod q on centered operands, result centered: int32 for a
    MontCtx, int64 for a Mont64Ctx (dispatched on ``ctx.is64``)."""
    if getattr(ctx, "is64", False):
        return ctx.add_centered_i64(a, b)
    return modq.modq_add(ctx, a, b)


@annotate("modq")
def sub_centered(ctx, a, b):
    if getattr(ctx, "is64", False):
        return ctx.sub_centered_i64(a, b)
    return modq.modq_sub(ctx, a, b)


def neg_centered(ctx: MontCtx, a):
    """(-a) mod q on centered int32 operands, result centered."""
    return to_centered(ctx, ctx.neg(to_unsigned(ctx, a)))


def reduce_centered(ctx: MontCtx, a):
    """Any int32 value (-2^31 included) -> its centered residue mod q."""
    return to_centered(ctx, ctx.reduce_i32_centered(a))
