"""Proof of Opening a commitment (paper section 4.4), batched-first.

Port of ``ringzk_tpu.protocols.open``. Prover knows an opening (x, r) of c:
  P->V:  c,  t = a1 . y            with y ~ N(0, sigma)^k
  V->P:  d  ~ challenge space C
  P->V:  z = y + d * r
  V:     ||z_i|| <= 2 sigma sqrt(N)  and  a1 . z == t + c1 * d
Every phase that draws takes an explicit ``torch.Generator`` and accepts
its draws injected instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import mat, sampling
from ..ops.ntt import degree, get_ring, lanes
from ..params import Params
from ..utils.profiling import annotate
from . import commit as commit_mod
from .commit import Commitment, CommitmentKey, Opening, matvec_key, verify_ok


def gaussian_bound(params: Params, n_deg: int) -> int:
    """Static clamp bound for prover Gaussians: 16 sigma (a float32 N(0,1)
    draw beyond it has probability < 1e-56); it gives the digit
    decomposition a static bound."""
    return 16 * params.standard_deviation(n_deg)


@annotate("sample")
def sample_y(gen: torch.Generator, params: Params, n_deg: int, batch_shape: tuple,
             device) -> torch.Tensor:
    sigma = params.standard_deviation(n_deg)
    y = sampling.gaussian_rounded(gen, tuple(batch_shape) + (params.k,), n_deg, sigma, device)
    b = gaussian_bound(params, n_deg)
    return torch.clamp(y, -b, b)


class OpenProofResponseContext(NamedTuple):
    """Prover-private state between moves 1 and 3."""

    opening: Opening
    y: torch.Tensor  # [..., k, N]


class OpenProofCommitment(NamedTuple):
    """First prover->verifier message."""

    c: Commitment
    t: torch.Tensor  # [..., n, N]


class OpenProofVerificationContext(NamedTuple):
    """Verifier-private state."""

    c1: torch.Tensor  # [..., n, N]
    t: torch.Tensor   # [..., n, N]
    d: torch.Tensor   # [..., N]


class OpenProofChallenge(NamedTuple):
    d: torch.Tensor  # [..., N]


class OpenProofResponse(NamedTuple):
    z: torch.Tensor  # [..., k, N]


@annotate("open_proof/commit")
def _prover_commit(gen, ck, x, params, r=None, y=None):
    """prover_commit() that also returns the commit's A.r."""
    n_deg = degree(x)
    ring = get_ring(n_deg, params.modulus)
    opening, c, ar = commit_mod._commit(gen, ck, x, params, r)
    if y is None:
        y = sample_y(gen, params, n_deg, tuple(x.shape[:-2]), x.device)
    y = lanes(y)
    t = matvec_key(ring, ck, "a1", y, gaussian_bound(params, n_deg))
    return (OpenProofResponseContext(opening=opening, y=y),
            OpenProofCommitment(c=c, t=t), ar)


def prover_commit(gen: torch.Generator, ck: CommitmentKey, x: torch.Tensor,
                  params: Params, r: torch.Tensor | None = None,
                  y: torch.Tensor | None = None):
    """Move 1. x: [..., l, N] -> (response context, proof commitment):
    commit to x, draw y ~ N(0, sigma)^k, send t = a1 . y. ``r`` and ``y``
    inject the draws."""
    rctx, pcom, _ = _prover_commit(gen, ck, x, params, r, y)
    return rctx, pcom


@annotate("open_proof/generate_challenge")
def generate_challenge(gen: torch.Generator, commitment: OpenProofCommitment,
                       params: Params, signs: torch.Tensor | None = None,
                       u: torch.Tensor | None = None):
    """Move 2: draw d from the challenge space; retain (c1, t, d).
    ``signs`` and ``u`` inject the challenge draws."""
    t = commitment.t
    d = lanes(sampling.challenge(gen, tuple(t.shape[:-2]), degree(t), params.kappa,
                                 t.device, signs=signs, u=u))
    c1, _ = commitment.c.c1_c2(params)
    return (OpenProofVerificationContext(c1=c1, t=t, d=d), OpenProofChallenge(d=d))


@annotate("open_proof/create_response")
def create_response(ctx: OpenProofResponseContext, challenge: OpenProofChallenge,
                    params: Params) -> OpenProofResponse:
    """Move 3: z = y + d * r. d*r has |integer coeffs| <= min(kappa, N) * b,
    so a CRT prime subset (usually one prime) is exact."""
    n_deg = degree(ctx.y)
    ring = get_ring(n_deg, params.modulus)
    num = ring.primes_needed(min(params.kappa, n_deg) * params.b)
    return OpenProofResponse(z=ring.scalar_mul_add(challenge.d, ctx.opening.r, ctx.y, num))


@annotate("open_proof/verify")
def verify(ck: CommitmentKey, response: OpenProofResponse,
           vctx: OpenProofVerificationContext, params: Params) -> torch.Tensor:
    """Move 4. Returns bool [...]: the norm bound on every z_i AND
    a1 . z == t + c1 * d."""
    z = response.z
    n_deg = degree(z)
    ring = get_ring(n_deg, params.modulus)
    ok_norm = verify_ok(params, n_deg, z)
    # z clamped to the verify bound: a passing z has every |coeff| within it
    lhs = matvec_key(ring, ck, "a1", z, params.verify_bound(n_deg))
    # c1 is an arbitrary residue from the wire, d is kappa-sparse ternary
    num = ring.primes_needed(min(params.kappa, n_deg) * (ring.q // 2 + 1))
    rhs = ring.scalar_mul_add(vctx.d, vctx.c1, vctx.t, num)
    return ok_norm & mat.poly_equal(lhs, rhs, struct_axes=1)


@annotate("open_proof/roundtrip")
def roundtrip(gen: torch.Generator, ck: CommitmentKey, x: torch.Tensor, params: Params,
              chains: int = 1):
    """The full 3-move protocol plus the standalone opening check, the unit
    of the headline benchmark. Returns (ok, opening_ok), bool [...]. The
    opening check reuses the commit's A.r. ``chains`` splits the leading
    batch axis into that many independent chains, run one after another,
    each with its own generator (``commit.chained_roundtrip``)."""
    if chains > 1:
        return commit_mod.chained_roundtrip(
            lambda gi, xc: roundtrip(gi, ck, xc, params), gen, (x,), chains, (3,))
    rctx, pcom, ar = _prover_commit(gen, ck, x, params)
    opening_ok = commit_mod.verify(ck, pcom.c, rctx.opening, params,
                                   honest_r_bound=params.b, ar=ar)
    vctx, chal = generate_challenge(gen, pcom, params)
    resp = create_response(rctx, chal, params)
    return verify(ck, resp, vctx, params), opening_ok
