"""Random samplers for the commitment scheme and sigma protocols.

Port of ``ringzk_tpu.ops.sampling``: uniform coefficients in [-bound,
bound], Gaussian coefficients truncated toward zero, challenge
polynomials with exactly kappa coefficients equal to +-1, and differences
of two challenges (the relaxation factors f). Every sampler
takes an explicit ``torch.Generator`` (on the device it draws for) and
appends the ring axis N itself. Torch's streams differ from
``jax.random``'s, so tests inject the draws instead of comparing them.
"""

from __future__ import annotations

import torch

from ..utils.profiling import annotate
from .kernels import challenge as challenge_kernel
from .u64 import narrow, widen


@annotate("sample")
def uniform_centered(gen: torch.Generator, shape: tuple, n: int, bound: int,
                     device) -> torch.Tensor:
    """Uniform iid coefficients in [-bound, bound], ``shape + (n,)``: int32
    for bounds up to 2^31 - 2, int64 above (wide rings), as in the JAX
    package."""
    if not 0 < bound <= 2**62:
        raise ValueError(f"bound out of range: {bound}")
    dtype = torch.int32 if bound <= 2**31 - 2 else torch.int64
    return torch.randint(-bound, bound + 1, tuple(shape) + (n,), generator=gen,
                         device=device, dtype=torch.int64).to(dtype)


@annotate("sample")
def gaussian_rounded(gen: torch.Generator, shape: tuple, n: int, sigma: float,
                     device) -> torch.Tensor:
    """Iid N(0, sigma) float32 draws truncated toward zero to int32."""
    g = torch.randn(tuple(shape) + (n,), generator=gen, device=device,
                    dtype=torch.float32) * torch.tensor(sigma, dtype=torch.float32)
    return torch.trunc(g).to(torch.int32)


def challenge_draws(gen: torch.Generator, shape: tuple, n: int, device):
    """The challenge sampler's raw draws: (signs, selection keys). signs:
    iid +-1 int32 ``shape + (n,)``; u: iid uint32 keys of the same shape,
    stored as int32 bit patterns (the default two-draw form)."""
    full = tuple(shape) + (n,)
    signs = 2 * torch.randint(0, 2, full, generator=gen, device=device,
                              dtype=torch.int32) - 1
    u = narrow(torch.randint(0, 2**32, full, generator=gen, device=device,
                             dtype=torch.int64))
    return signs, u


@annotate("challenge")
def challenge(gen: torch.Generator, shape: tuple, n: int, kappa: int, device,
              signs: torch.Tensor | None = None,
              u: torch.Tensor | None = None) -> torch.Tensor:
    """Sample from C = {c : ||c||_inf = 1, ||c||_1 = kappa}: kappa nonzero
    +-1 coefficients on the top-kappa lanes of the keys u (kernel K4).
    kappa >= N clamps to N (every coefficient +-1). ``signs`` and ``u``
    inject the draws; absent, they come from ``gen``."""
    if kappa < 1:
        raise ValueError(f"kappa must be >= 1, got {kappa}")
    kappa = min(kappa, n)
    if (signs is None) != (u is None):
        raise ValueError("challenge: inject both signs and u, or neither")
    if signs is None:
        signs, u = challenge_draws(gen, shape, n, device)
    if kappa == n:
        return signs
    out = challenge_kernel.challenge_select(
        u.reshape(-1, n).contiguous(), signs.reshape(-1, n).contiguous(), kappa
    )
    return out.reshape(signs.shape)


def challenge_difference(gen: torch.Generator, shape: tuple, n: int, kappa: int, device,
                         signs: tuple | None = None, u: tuple | None = None) -> torch.Tensor:
    """Sample from C-bar = {c - c' : c != c' in C} (invertible in R_q):
    two challenges through :func:`challenge` (K4), c' negated where it
    equals c (still in C, and != c since kappa > 0), then c - c'.
    ``signs`` and ``u`` inject the draws of both challenges as pairs
    ``(first, second)``; absent, they come from ``gen``, first c, then c'."""
    if (signs is None) != (u is None):
        raise ValueError("challenge_difference: inject both signs and u, or neither")
    s1, s2 = signs if signs is not None else (None, None)
    u1, u2 = u if u is not None else (None, None)
    c1 = challenge(gen, shape, n, kappa, device, signs=s1, u=u1)
    c2 = challenge(gen, shape, n, kappa, device, signs=s2, u=u2)
    eq = (c1 == c2).all(-1, keepdim=True)
    return c1 - torch.where(eq, -c2, c2)


def _mask_topk(u: torch.Tensor, kappa: int) -> torch.Tensor:
    """Top-kappa lane mask of uint32 keys (int32 bit patterns): keys above
    the kappa-th largest key, plus the first (kappa - #above) keys equal to
    it in ascending lane order. ``torch.topk`` gives no order among ties,
    so it only supplies the threshold value; the lane rule is explicit."""
    uu = widen(u)
    thr = torch.topk(uu, kappa, dim=-1).values[..., -1:]
    gt = uu > thr
    eq = uu == thr
    need = kappa - gt.sum(-1, keepdim=True)
    eqi = eq.to(torch.int64)
    rank = torch.cumsum(eqi, dim=-1) - eqi   # ties in lower lanes
    return gt | (eq & (rank < need))
