"""Proof of Sum x' = sum_i g_i * x_i, the linear proof over VL summands.

Port of ``ringzk_tpu.protocols.sum``. The summands are a structure axis V
ahead of the message rows -- xs: [..., V, l, N], gs: [..., V, N] -- so all
commitments and responses run as one batched program:
  P->V:  cp, {c_i}, {g_i},  tp = a1.yp,  {t_i = a1.y_i},
         u = sum_i g_i*(a2.y_i) - a2.yp
  V->P:  d ~ C
  P->V:  {z_i = y_i + d*r_i},  zp = yp + d*rp
  V:     norms; per-i a1.z_i == t_i + c1_i*d; a1.zp == tp + c1p*d;
         sum_i g_i*(a2.z_i) - a2.zp == (sum_i g_i*c2_i - c2p)*d + u
Every phase that draws takes an explicit ``torch.Generator`` and accepts
its draws injected instead; the products t + d*m run in kernel K5.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import mat, sampling
from ..ops.ntt import RingContext, degree, get_ring, lanes
from ..params import Params
from ..utils.profiling import annotate
from . import commit as commit_mod
from .commit import (Commitment, CommitmentKey, Opening, matvec_key, stack_siblings_ok,
                     verify_ok)
from .open import gaussian_bound, sample_y


class SumProofResponseContext(NamedTuple):
    """Prover-private state between moves 1 and 3."""

    openings: Opening    # batched over V: x [..., V, l, N], r [..., V, k, N]
    opening_p: Opening
    yp: torch.Tensor     # [..., k, N]
    ys: torch.Tensor     # [..., V, k, N]


class SumProofCommitment(NamedTuple):
    """First prover->verifier message."""

    cp: Commitment       # [..., n+l, N]
    cs: Commitment       # [..., V, n+l, N]
    gs: torch.Tensor     # [..., V, N]
    tp: torch.Tensor     # [..., n, N]
    ts: torch.Tensor     # [..., V, n, N]
    u: torch.Tensor      # [..., l, N]


class SumProofVerificationContext(NamedTuple):
    """Verifier-private state."""

    c1p: torch.Tensor    # [..., n, N]
    c2p: torch.Tensor    # [..., l, N]
    c1s: torch.Tensor    # [..., V, n, N]
    c2s: torch.Tensor    # [..., V, l, N]
    gs: torch.Tensor
    ts: torch.Tensor
    tp: torch.Tensor
    u: torch.Tensor
    d: torch.Tensor


class SumProofChallenge(NamedTuple):
    d: torch.Tensor


class SumProofResponse(NamedTuple):
    zp: torch.Tensor     # [..., k, N]
    zs: torch.Tensor     # [..., V, k, N]


def _matvec_key_v1(ring: RingContext, ck: CommitmentKey, vs: torch.Tensor,
                   vp: torch.Tensor, bound: int):
    """Full-key matvec of the summand stack vs [..., V, k, N] and the
    singleton vp [..., k, N]: one concatenated [..., V+1, ...] dispatch on
    the digit path, two otherwise. The same integers either way."""
    if stack_siblings_ok(ck, bound):
        out = matvec_key(ring, ck, "a", torch.cat([vs, vp.unsqueeze(-3)], dim=-3), bound)
        return out[..., :-1, :, :], out[..., -1, :, :]
    return matvec_key(ring, ck, "a", vs, bound), matvec_key(ring, ck, "a", vp, bound)


@annotate("sum_proof/commit")
def _prover_commit(gen, ck, gs, xs, params, rs=None, rp=None, ys=None, yp=None):
    """prover_commit() that also returns both commits' A.r: (response
    context, proof commitment, A.r of the cs, A.r of cp)."""
    if gs.shape[-2] != xs.shape[-3] or gs.shape[-2] < 1:
        raise ValueError(f"gs/xs summand axes disagree: {tuple(gs.shape)} vs "
                         f"{tuple(xs.shape)}")
    vl = gs.shape[-2]
    n_deg = degree(xs)
    ring = get_ring(n_deg, params.modulus)
    batch = tuple(xs.shape[:-3])
    gs_hat = ring.fwd_const(gs)
    # xp = sum_i g_i * x_i: depth-one products, reduced over V exactly for
    # any summand count (sum_to_centered chunks at ACC_MAX)
    xp = ring.sum_to_centered(mat.scalar_mul_hat(ring, gs_hat, ring.fwd(xs)), -3)
    opening_p, cp, arp = commit_mod._commit(gen, ck, xp, params, rp)
    openings, cs, ars = commit_mod._commit(gen, ck, xs, params, rs)
    gbound = gaussian_bound(params, n_deg)
    if ys is None:
        ys = sample_y(gen, params, n_deg, batch + (vl,), xs.device)
    if yp is None:
        yp = sample_y(gen, params, n_deg, batch, xs.device)
    ys, yp = lanes(ys), lanes(yp)
    ays, ayp = _matvec_key_v1(ring, ck, ys, yp, gbound)
    ts, a2ys = mat.split_rows(ays, params.n)
    tp, a2yp = mat.split_rows(ayp, params.n)
    # u = sum_i g_i*(a2.y_i) - a2.yp, a2.y_i reduced mod q first
    u = mat.sub_centered(
        ring, ring.sum_to_centered(mat.scalar_mul_hat(ring, gs_hat, ring.fwd(a2ys)), -3), a2yp)
    return (SumProofResponseContext(openings=openings, opening_p=opening_p, yp=yp, ys=ys),
            SumProofCommitment(cp=cp, cs=cs, gs=gs, tp=tp, ts=ts, u=u), ars, arp)


def prover_commit(gen: torch.Generator, ck: CommitmentKey, gs: torch.Tensor,
                  xs: torch.Tensor, params: Params, rs: torch.Tensor | None = None,
                  rp: torch.Tensor | None = None, ys: torch.Tensor | None = None,
                  yp: torch.Tensor | None = None):
    """Move 1. gs: [..., V, N], xs: [..., V, l, N] -> (response context,
    proof commitment). Draws, in order: rp (the commit to the sum), rs (the
    V commits), ys, yp; each may be injected instead."""
    rctx, pcom, _, _ = _prover_commit(gen, ck, gs, xs, params, rs, rp, ys, yp)
    return rctx, pcom


@annotate("sum_proof/generate_challenge")
def generate_challenge(gen: torch.Generator, commitment: SumProofCommitment,
                       params: Params, signs: torch.Tensor | None = None,
                       u: torch.Tensor | None = None):
    """Move 2: draw d from the challenge space. ``signs`` and ``u`` inject
    the challenge draws."""
    tp = commitment.tp
    d = lanes(sampling.challenge(gen, tuple(tp.shape[:-2]), degree(tp), params.kappa,
                                 tp.device, signs=signs, u=u))
    c1s, c2s = commitment.cs.c1_c2(params)
    c1p, c2p = commitment.cp.c1_c2(params)
    return (SumProofVerificationContext(c1p=c1p, c2p=c2p, c1s=c1s, c2s=c2s,
                                        gs=commitment.gs, ts=commitment.ts, tp=tp,
                                        u=commitment.u, d=d),
            SumProofChallenge(d=d))


@annotate("sum_proof/create_response")
def create_response(ctx: SumProofResponseContext, challenge: SumProofChallenge,
                    params: Params) -> SumProofResponse:
    """Move 3: z_i = y_i + d*r_i (d broadcast over V and k), zp = yp + d*rp."""
    n_deg = degree(ctx.yp)
    ring = get_ring(n_deg, params.modulus)
    num = ring.primes_needed(min(params.kappa, n_deg) * params.b)
    return SumProofResponse(
        zs=ring.scalar_mul_add(challenge.d, ctx.openings.r, ctx.ys, num),
        zp=ring.scalar_mul_add(challenge.d, ctx.opening_p.r, ctx.yp, num),
    )


@annotate("sum_proof/verify")
def verify(ck: CommitmentKey, response: SumProofResponse,
           vctx: SumProofVerificationContext, params: Params) -> torch.Tensor:
    """Move 4. Returns bool [...]. A summand count that differs between
    the response and the context raises ValueError."""
    zs, zp = response.zs, response.zp
    n_deg = degree(zs)
    ring = get_ring(n_deg, params.modulus)
    if zs.shape[-3] != vctx.ts.shape[-3] or zs.shape[-3] != vctx.c1s.shape[-3]:
        raise ValueError(f"summand count mismatch: zs {zs.shape[-3]} vs ts "
                         f"{vctx.ts.shape[-3]} vs cs {vctx.c1s.shape[-3]}")
    ok = verify_ok(params, n_deg, zs).all(-1) & verify_ok(params, n_deg, zp)
    gs_hat = ring.fwd_const(vctx.gs)
    num_d = ring.primes_needed(min(params.kappa, n_deg) * (ring.q // 2 + 1))
    azs, azp = _matvec_key_v1(ring, ck, zs, zp, params.verify_bound(n_deg))
    a1zs, a2zs = mat.split_rows(azs, params.n)
    a1zp, a2zp = mat.split_rows(azp, params.n)
    # per-i: a1.z_i == t_i + c1_i*d (d broadcast over V)
    rhs1 = ring.scalar_mul_add(vctx.d, vctx.c1s, vctx.ts, num_d)
    eq1 = mat.poly_equal(a1zs, rhs1, struct_axes=1).all(-1)
    eq2 = mat.poly_equal(a1zp, ring.scalar_mul_add(vctx.d, vctx.c1p, vctx.tp, num_d),
                         struct_axes=1)
    # sum_i g_i*(a2.z_i) - a2.zp == (sum_i g_i*c2_i - c2p)*d + u
    lhs = mat.sub_centered(
        ring, ring.sum_to_centered(mat.scalar_mul_hat(ring, gs_hat, ring.fwd(a2zs)), -3), a2zp)
    gc2 = mat.sub_centered(
        ring, ring.sum_to_centered(mat.scalar_mul_hat(ring, gs_hat, ring.fwd(vctx.c2s)), -3),
        vctx.c2p)
    eq3 = mat.poly_equal(lhs, ring.scalar_mul_add(vctx.d, gc2, vctx.u, num_d), struct_axes=1)
    return ok & eq1 & eq2 & eq3


@annotate("sum_proof/roundtrip")
def roundtrip(gen: torch.Generator, ck: CommitmentKey, gs: torch.Tensor, xs: torch.Tensor,
              params: Params, chains: int = 1):
    """The full 3-move protocol plus the opening checks of cp and every
    c_i. Returns (ok, opening_ok), bool [...]. The opening checks reuse
    the commits' A.r. ``chains`` splits the leading batch axis of gs and xs
    into independent chains (``commit.chained_roundtrip``)."""
    if chains > 1:
        return commit_mod.chained_roundtrip(
            lambda gi, gc, xc: roundtrip(gi, ck, gc, xc, params), gen, (gs, xs), chains, (3, 4))
    rctx, pcom, ars, arp = _prover_commit(gen, ck, gs, xs, params)
    opening_ok = commit_mod.verify(ck, pcom.cp, rctx.opening_p, params,
                                   honest_r_bound=params.b, ar=arp)
    opening_ok &= commit_mod.verify(ck, pcom.cs, rctx.openings, params,
                                    honest_r_bound=params.b, ar=ars).all(-1)
    vctx, chal = generate_challenge(gen, pcom, params)
    resp = create_response(rctx, chal, params)
    return verify(ck, resp, vctx, params), opening_ok
