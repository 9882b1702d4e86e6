"""The narrow ring's centred mod-q add and sub (``csrc/modq.cu``).

No TPU kernel: the JAX package's ``zq.add_centered`` / ``sub_centered`` are
a few jnp operations that XLA fuses. ``modq_add`` / ``modq_sub``: int32 a,
b of broadcastable shapes and a narrow :class:`..montgomery.MontCtx` ->
centred int32 (a ± b) mod q. Any int32 operand gives the plain version's
value, centred or not.

The plain version is the JAX package's chain in int64: both operands to
uint32 residues (:func:`..zq.to_unsigned`), ``MontCtx.add`` or ``sub``,
back to centred int32 (:func:`..zq.to_centered`).
"""

from __future__ import annotations

import torch

from . import launch, on_cuda
from .. import zq


def modq_add_plain(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return zq.to_centered(ctx, ctx.add(zq.to_unsigned(ctx, a), zq.to_unsigned(ctx, b)))


def modq_sub_plain(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return zq.to_centered(ctx, ctx.sub(zq.to_unsigned(ctx, a), zq.to_unsigned(ctx, b)))


def _operand(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and on a 16-byte boundary (the kernel moves 16-byte
    vectors): a copy only where t is not so already."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _modq(name: str, plain, ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if getattr(ctx, "is64", False):
        raise ValueError(f"{name}: a wide ring's context (q = {ctx.q}); its centred "
                         "add and sub are Mont64Ctx.add_centered_i64 / sub_centered_i64")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError(f"{name}: need int32 operands, got {a.dtype} and {b.dtype}")
    if not on_cuda(name, a, b):
        return plain(ctx, a, b)
    if a.shape != b.shape:
        # broadcast_tensors, not broadcast_shapes: the latter imports sympy
        # at its first call, seconds of a process's set-up
        a, b = torch.broadcast_tensors(a, b)
    a, b = _operand(a), _operand(b)
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    if out.numel():
        launch(name, f"rz_{name}", a.device, a, b, out, ctx.p, out.numel())
    return out


def modq_add(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod q, centred int32: the kernel on a CUDA device, the plain
    version on the CPU."""
    return _modq("modq_add", modq_add_plain, ctx, a, b)


def modq_sub(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod q, centred int32."""
    return _modq("modq_sub", modq_sub_plain, ctx, a, b)
