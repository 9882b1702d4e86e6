"""K4: challenge support selection (``csrc/challenge_select.cu``).

Counterpart of ``challenge_select_pallas``: keys u [rows, N] (uint32 bit
patterns stored as int32), signs int32 [rows, N] -> the ternary challenge
int32 [rows, N] with the signs on the top-kappa lanes of u (ties at the
threshold taken in ascending lane order) and 0 elsewhere.
"""

from __future__ import annotations

import torch

from . import check, launch, on_cuda

MIN_N, MAX_N = 4, 8192  # a warp of 4-key vectors per row up to 1024; 8 warps at 8192


def challenge_select_plain(u: torch.Tensor, signs: torch.Tensor, kappa: int) -> torch.Tensor:
    """Plain version of K4, on sampling._mask_topk."""
    from ..sampling import _mask_topk

    return torch.where(_mask_topk(u, kappa), signs, 0).to(torch.int32)


def challenge_select(u: torch.Tensor, signs: torch.Tensor, kappa: int) -> torch.Tensor:
    """K4. Requires 1 <= kappa < N (the kappa >= N clamp is the caller's)."""
    rows, n = u.shape
    check("challenge_select", u, torch.int32, (rows, n))
    check("challenge_select", signs, torch.int32, (rows, n))
    if not 1 <= kappa < n:
        raise ValueError(f"challenge_select: need 1 <= kappa < N, got kappa={kappa} N={n}")
    if not on_cuda("challenge_select", u, signs):
        return challenge_select_plain(u, signs, kappa)
    if n & (n - 1) or not MIN_N <= n <= MAX_N:
        raise ValueError(f"challenge_select: N={n} must be a power of two in {MIN_N}..{MAX_N}")
    out = torch.empty_like(u)
    launch("challenge_select", "rz_challenge_select", u.device, u, signs, out,
           rows, n, kappa)
    return out
