"""Proof of Linear Relation x' = g * x (paper section 4.4), batched-first.

Port of ``ringzk_tpu.protocols.linear``. The prover holds openings of two
commitments c (to x) and cp (to x' = g*x) and proves the relation for a
public scalar polynomial g:
  P->V:  c, cp, g,  t = a1.y,  tp = a1.yp,  u = g*(a2.y) - a2.yp
  V->P:  d ~ C
  P->V:  z = y + d*r,  zp = yp + d*rp
  V:     norms of z, zp;  a1.z == t + c1*d;  a1.zp == tp + c1p*d;
         g*(a2.z) - a2.zp == (g*c2 - c2p)*d + u
Every phase that draws takes an explicit ``torch.Generator`` and accepts
its draws injected instead; the products t + d*m run in kernel K5.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import mat, sampling
from ..ops.ntt import degree, get_ring, lanes
from ..params import Params
from ..utils.profiling import annotate
from . import commit as commit_mod
from .commit import Commitment, CommitmentKey, Opening, matvec_key_siblings, verify_ok
from .open import gaussian_bound, sample_y


class LinearProofResponseContext(NamedTuple):
    """Prover-private state between moves 1 and 3."""

    opening: Opening     # of c (to x)
    opening_p: Opening   # of cp (to g*x)
    y: torch.Tensor      # [..., k, N]
    yp: torch.Tensor     # [..., k, N]


class LinearProofCommitment(NamedTuple):
    """First prover->verifier message."""

    c: Commitment
    cp: Commitment
    g: torch.Tensor   # [..., N]
    t: torch.Tensor   # [..., n, N]
    tp: torch.Tensor  # [..., n, N]
    u: torch.Tensor   # [..., l, N]


class LinearProofVerificationContext(NamedTuple):
    """Verifier-private state."""

    c1: torch.Tensor
    c2: torch.Tensor
    c1p: torch.Tensor
    c2p: torch.Tensor
    g: torch.Tensor
    t: torch.Tensor
    tp: torch.Tensor
    u: torch.Tensor
    d: torch.Tensor


class LinearProofChallenge(NamedTuple):
    d: torch.Tensor


class LinearProofResponse(NamedTuple):
    z: torch.Tensor   # [..., k, N]
    zp: torch.Tensor  # [..., k, N]


@annotate("linear_proof/commit")
def _prover_commit(gen, ck, g, x, params, r=None, rp=None, y=None, yp=None):
    """prover_commit() that also returns both commits' A.r: (response
    context, proof commitment, A.r of c, A.r of cp)."""
    n_deg = degree(x)
    ring = get_ring(n_deg, params.modulus)
    g_hat = ring.fwd_const(g)
    gx = ring.inv(mat.scalar_mul_hat(ring, g_hat, ring.fwd(x)))
    opening_p, cp, arp = commit_mod._commit(gen, ck, gx, params, rp)
    opening, c, ar = commit_mod._commit(gen, ck, x, params, r)
    batch = tuple(x.shape[:-2])
    if y is None:
        y = sample_y(gen, params, n_deg, batch, x.device)
    if yp is None:
        yp = sample_y(gen, params, n_deg, batch, x.device)
    y, yp = lanes(y), lanes(yp)
    ay, ayp = matvec_key_siblings(ring, ck, (y, yp), gaussian_bound(params, n_deg))
    t, a2y = mat.split_rows(ay, params.n)
    tp, a2yp = mat.split_rows(ayp, params.n)
    # depth-one rule: a2.y is reduced mod q before the product with g
    u = mat.sub_centered(ring, ring.inv(mat.scalar_mul_hat(ring, g_hat, ring.fwd(a2y))), a2yp)
    return (LinearProofResponseContext(opening=opening, opening_p=opening_p, y=y, yp=yp),
            LinearProofCommitment(c=c, cp=cp, g=g, t=t, tp=tp, u=u), ar, arp)


def prover_commit(gen: torch.Generator, ck: CommitmentKey, g: torch.Tensor,
                  x: torch.Tensor, params: Params, r: torch.Tensor | None = None,
                  rp: torch.Tensor | None = None, y: torch.Tensor | None = None,
                  yp: torch.Tensor | None = None):
    """Move 1. g: [..., N], x: [..., l, N] -> (response context, proof
    commitment). Draws, in order: rp (the commit to g*x), r (the commit to
    x), y, yp; each may be injected instead."""
    rctx, pcom, _, _ = _prover_commit(gen, ck, g, x, params, r, rp, y, yp)
    return rctx, pcom


@annotate("linear_proof/generate_challenge")
def generate_challenge(gen: torch.Generator, commitment: LinearProofCommitment,
                       params: Params, signs: torch.Tensor | None = None,
                       u: torch.Tensor | None = None):
    """Move 2: draw d from the challenge space. ``signs`` and ``u`` inject
    the challenge draws."""
    t = commitment.t
    d = lanes(sampling.challenge(gen, tuple(t.shape[:-2]), degree(t), params.kappa,
                                 t.device, signs=signs, u=u))
    c1, c2 = commitment.c.c1_c2(params)
    c1p, c2p = commitment.cp.c1_c2(params)
    return (LinearProofVerificationContext(c1=c1, c2=c2, c1p=c1p, c2p=c2p, g=commitment.g,
                                           t=t, tp=commitment.tp, u=commitment.u, d=d),
            LinearProofChallenge(d=d))


@annotate("linear_proof/create_response")
def create_response(ctx: LinearProofResponseContext, challenge: LinearProofChallenge,
                    params: Params) -> LinearProofResponse:
    """Move 3: z = y + d*r, zp = yp + d*rp."""
    n_deg = degree(ctx.y)
    ring = get_ring(n_deg, params.modulus)
    num = ring.primes_needed(min(params.kappa, n_deg) * params.b)
    return LinearProofResponse(
        z=ring.scalar_mul_add(challenge.d, ctx.opening.r, ctx.y, num),
        zp=ring.scalar_mul_add(challenge.d, ctx.opening_p.r, ctx.yp, num),
    )


@annotate("linear_proof/verify")
def verify(ck: CommitmentKey, response: LinearProofResponse,
           vctx: LinearProofVerificationContext, params: Params) -> torch.Tensor:
    """Move 4. Returns bool [...]."""
    z, zp = response.z, response.zp
    n_deg = degree(z)
    ring = get_ring(n_deg, params.modulus)
    ok = verify_ok(params, n_deg, z) & verify_ok(params, n_deg, zp)
    g_hat = ring.fwd_const(vctx.g)
    # c1*d terms: wire values are any residue, d is kappa-sparse ternary
    num_d = ring.primes_needed(min(params.kappa, n_deg) * (ring.q // 2 + 1))
    az, azp = matvec_key_siblings(ring, ck, (z, zp), params.verify_bound(n_deg))
    a1z, a2z = mat.split_rows(az, params.n)
    a1zp, a2zp = mat.split_rows(azp, params.n)
    eq1 = mat.poly_equal(a1z, ring.scalar_mul_add(vctx.d, vctx.c1, vctx.t, num_d),
                         struct_axes=1)
    eq2 = mat.poly_equal(a1zp, ring.scalar_mul_add(vctx.d, vctx.c1p, vctx.tp, num_d),
                         struct_axes=1)
    # g*(a2.z) - a2.zp == (g*c2 - c2p)*d + u, each product of depth one
    lhs = mat.sub_centered(ring, ring.inv(mat.scalar_mul_hat(ring, g_hat, ring.fwd(a2z))),
                           a2zp)
    gc2_c2p = ring.inv(ring.sub_hat(mat.scalar_mul_hat(ring, g_hat, ring.fwd(vctx.c2)),
                                    ring.fwd(vctx.c2p)))
    eq3 = mat.poly_equal(lhs, ring.scalar_mul_add(vctx.d, gc2_c2p, vctx.u, num_d),
                         struct_axes=1)
    return ok & eq1 & eq2 & eq3


@annotate("linear_proof/roundtrip")
def roundtrip(gen: torch.Generator, ck: CommitmentKey, g: torch.Tensor, x: torch.Tensor,
              params: Params, chains: int = 1):
    """The full 3-move protocol plus both opening checks. Returns (ok,
    opening_ok), bool [...]. The opening checks reuse each commit's A.r.
    ``chains`` splits the leading batch axis of g and x into independent
    chains (``commit.chained_roundtrip``)."""
    if chains > 1:
        return commit_mod.chained_roundtrip(
            lambda gi, gc, xc: roundtrip(gi, ck, gc, xc, params), gen, (g, x), chains, (2, 3))
    rctx, pcom, ar, arp = _prover_commit(gen, ck, g, x, params)
    opening_ok = commit_mod.verify(ck, pcom.c, rctx.opening, params,
                                   honest_r_bound=params.b, ar=ar)
    opening_ok &= commit_mod.verify(ck, pcom.cp, rctx.opening_p, params,
                                    honest_r_bound=params.b, ar=arp)
    vctx, chal = generate_challenge(gen, pcom, params)
    resp = create_response(rctx, chal, params)
    return verify(ck, resp, vctx, params), opening_ok
