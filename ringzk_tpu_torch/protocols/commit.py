"""BDLOP commitment scheme (paper section 4.1), batched-first.

Port of ``ringzk_tpu.protocols.commit``:
    a1 = [I_n | A1'],             A1' uniform n x (k-n)
    a2 = [0_{l x n} | I_l | A2'],  A2' uniform l x (k-n-l)
    c  = [a1; a2] . r + [0_n; x],  r uniform with coefficients in [-b, b].
Keys carry their NTT images and, where the digit engine applies, the int8
digit operators the key matvecs run on (kernel K3, or K6 for the blocked
layout of N >= 1024 keys). A batch of independent keys (``keygen``'s
``batch_shape``) carries a prefix on every field and takes the NTT path
(K1, K2), whose key-batch prefix broadcasts right-aligned against the
batch of the vector it multiplies (``mat.matvec_hat``). On wide rings (q >=
2^32) keys and messages are centered int64 and every key matvec takes the
NTT path (K7, K8). Under a ring split over ranks (the sp axis,
``parallel/protocol_sp.py``) every tensor is a rank's lane block: the
protocols read the ring degree through ``ntt.degree`` and cut each draw,
made or injected at full width, with ``ntt.lanes``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import conv_mxu, mat, norms, sampling, zq
from ..ops.ntt import RingContext, degree, get_ring, lanes
from ..params import Params
from ..utils.profiling import annotate

# Largest ring degree for which the digit operators are built (operator
# memory grows as N^2: 4 * kN * (n+l)N int8, ~400 MB at N=4096).
MXU_MAX_N = 4096


class CommitmentKey(NamedTuple):
    """a1: [*batch, n, k, N], a2: [*batch, l, k, N] centered (the ring's
    dtype); *_hat: NTT images in const form [P, *batch, rows, k, N];
    *_dig: int8 digit operators of an unbatched key, [kN, D*rowsN] (K3) or,
    past the resident gate, the blocked [D, kN, rowsN] (K6;
    ``conv_mxu.maybe_blocked_layout`` chooses), or None (the NTT path is
    used then: always for a batch of keys)."""

    a1: torch.Tensor
    a2: torch.Tensor
    a1_hat: torch.Tensor
    a2_hat: torch.Tensor
    a1_dig: Optional[torch.Tensor] = None
    a2_dig: Optional[torch.Tensor] = None

    @property
    def n_deg(self) -> int:
        return degree(self.a1)

    def a_hat(self) -> torch.Tensor:
        """[a1; a2] in the NTT domain: [P, *batch, n+l, k, N] (a method, as
        in the JAX package)."""
        return torch.cat([self.a1_hat, self.a2_hat], dim=-3)


class Commitment(NamedTuple):
    """c = [c1; c2]: [..., n+l, N] centered (int32; int64 on wide rings)."""

    c: torch.Tensor

    def c1_c2(self, params: Params):
        """(c1: first n rows, c2: last l rows)."""
        return mat.split_rows(self.c, params.n)


class Opening(NamedTuple):
    """x: [..., l, N], r: [..., k, N] centered (int64 x on wide rings); f:
    optional relaxation factor polynomial [..., N] (None == identity, as
    everywhere in the reference)."""

    x: torch.Tensor
    r: torch.Tensor
    f: Optional[torch.Tensor] = None


def _digits_ok(ring: RingContext, params: Params, n_deg: int) -> bool:
    """Whether the int8 digit engine applies to keys of this shape: the ring
    is narrow (the digit fold is uint32 Montgomery and its int32 output
    cannot carry wide residues, even for a small sampling bound), int32
    group sums stay exact and KEY_DIGITS digits cover the key residues."""
    return (
        not ring.wide
        and n_deg <= MXU_MAX_N
        and conv_mxu.KEY_DIGITS * params.k * n_deg * (conv_mxu.RADIX // 2) ** 2 < 2**31
        and params.q <= conv_mxu.digit_capacity(conv_mxu.KEY_DIGITS)
    )


def build_key(a1: torch.Tensor, a2: torch.Tensor, params: Params) -> CommitmentKey:
    """CommitmentKey from the key matrices a1 [*batch, n, k, N], a2
    [*batch, l, k, N]: the const-form NTT images and, for one unbatched key
    where they apply, the digit operators in the layout
    ``conv_mxu.maybe_blocked_layout`` chooses. A batch of keys gets none
    (the JAX package's ``batch_shape == ()`` condition)."""
    if a1.shape[:-3] != a2.shape[:-3]:
        raise ValueError(f"a1 and a2 key batches differ: {tuple(a1.shape)} vs "
                         f"{tuple(a2.shape)}")
    n_deg = a1.shape[-1]
    ring = get_ring(n_deg, params.modulus)
    a1_dig = a2_dig = None
    if a1.dim() == 3 and _digits_ok(ring, params, n_deg):
        a1_dig = conv_mxu.maybe_blocked_layout(conv_mxu.operator_planes(a1, ring), n_deg)
        a2_dig = conv_mxu.maybe_blocked_layout(conv_mxu.operator_planes(a2, ring), n_deg)
    return CommitmentKey(a1=a1, a2=a2, a1_hat=ring.fwd_const(a1),
                         a2_hat=ring.fwd_const(a2), a1_dig=a1_dig, a2_dig=a2_dig)


def resolve_device(device) -> torch.device:
    """The device a key is built on: ``device`` as given, or the CUDA card
    when it is None. Raises when there is no card and the caller did not
    name a device: nothing drops to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to build on the CPU")
    return torch.device("cuda")


@annotate("commit_scheme/keygen")
def keygen(gen: torch.Generator, params: Params, n_deg: int, device=None,
           a1p: torch.Tensor | None = None, a2p: torch.Tensor | None = None,
           batch_shape: tuple = ()) -> CommitmentKey:
    """Generate commitment key(s) on ``device`` (default: the CUDA card);
    ``batch_shape`` prefixes independent keys. ``a1p`` [*batch_shape, n,
    k-n, N] and ``a2p`` [*batch_shape, l, k-n-l, N] inject the uniform
    parts; absent, they come from ``gen``, which must draw on that
    device."""
    device = resolve_device(device)
    params.validate()
    ring = get_ring(n_deg, params.modulus)  # rejects unsupported rings up front
    if ring.wide and params.commit_bound(n_deg) >= 2**31:
        raise ValueError(f"commit bound {params.commit_bound(n_deg)} >= 2^31 at N={n_deg}: "
                         "wide-ring norm checks need int32-range bounds")
    n, k, l, q = params.n, params.k, params.l, params.q
    batch_shape = tuple(batch_shape)

    def eye_poly(rows):
        e = torch.zeros((rows, rows, n_deg), dtype=ring.dtype, device=device)
        e[torch.arange(rows), torch.arange(rows), 0] = 1
        return e.expand(batch_shape + e.shape)

    if a1p is None:
        a1p = sampling.uniform_centered(gen, batch_shape + (n, k - n), n_deg, q, device)
    if a2p is None:
        a2p = sampling.uniform_centered(gen, batch_shape + (l, k - n - l), n_deg, q, device)
    a1 = torch.cat([eye_poly(n), a1p.to(device, ring.dtype)], dim=-2)
    z_ln = torch.zeros(batch_shape + (l, n, n_deg), dtype=ring.dtype, device=device)
    a2 = torch.cat([z_ln, eye_poly(l), a2p.to(device, ring.dtype)], dim=-2)
    return build_key(a1, a2, params)


@annotate("key_matvec")
def matvec_key(ring: RingContext, ck: CommitmentKey, which: str, v: torch.Tensor,
               bound: int) -> torch.Tensor:
    """(key matrix . v) mod q -> centered [..., rows, N] (the ring's dtype).

    which: 'a1', 'a2', or 'a' ([a1; a2] as two row-block matvecs).
    ``bound`` is an exact bound on |v| that sizes the digit decomposition;
    v is clamped to it first, which is sound at every call site (honest
    inputs respect it, and adversarial inputs beyond it fail the norm
    checks). Keys without a digit operator take the exact NTT path, where
    'a' transforms v once for both row blocks (the JAX package gets that
    reuse from XLA's common-subexpression elimination)."""
    ndig = conv_mxu.digits_for_bound(bound)
    v_hat = None
    outs = []
    for name in (("a1", "a2") if which == "a" else (which,)):
        dig = getattr(ck, f"{name}_dig")
        if dig is not None and ndig <= conv_mxu.KEY_DIGITS:
            rows = getattr(ck, name).shape[-3]
            outs.append(conv_mxu.matvec_digits(ring, dig, rows,
                                               torch.clamp(v, -bound, bound), ndig))
        else:
            if v_hat is None:
                v_hat = ring.fwd(v)
            outs.append(mat.matvec(ring, getattr(ck, f"{name}_hat"), v_hat))
    return torch.cat(outs, dim=-2) if len(outs) > 1 else outs[0]


def stack_siblings_ok(ck: CommitmentKey, bound: int) -> bool:
    """Whether sibling vectors may share one full-key matvec: only on the
    digit path, which flattens any leading axes into the row batch of K3 or
    K6, whichever layout the key holds. The NTT path is excluded: a batch
    of keys broadcasts right-aligned against the vectors' batch
    (``mat.matvec_hat``), so a stack axis would meet the key-batch axis.
    The JAX package's default level: sum's V+1 stack is one dispatch per
    row block, linear's pairs are not stacked (``matvec_key_siblings``)."""
    return (ck.a1_dig is not None and ck.a2_dig is not None
            and conv_mxu.digits_for_bound(bound) <= conv_mxu.KEY_DIGITS)


def matvec_key_siblings(ring: RingContext, ck: CommitmentKey, vs, bound: int):
    """Full-key matvec of sibling vectors of one shape [..., k, N]: one
    dispatch per vector, the JAX package's default for linear's pairs."""
    return [matvec_key(ring, ck, "a", v, bound) for v in vs]


def commit_ok(params: Params, n_deg: int, r: torch.Tensor) -> torch.Tensor:
    """Commit constraint ||r_i||_2 <= 4 sigma sqrt(N) for every r_i:
    r [..., k, N] -> bool [...]."""
    return norms.norm2_leq(r, params.commit_bound(n_deg)).all(-1)


def verify_ok(params: Params, n_deg: int, z: torch.Tensor) -> torch.Tensor:
    """Verification constraint ||z_i||_2 <= 2 sigma sqrt(N)."""
    return norms.norm2_leq(z, params.verify_bound(n_deg)).all(-1)


def _zero_pad_rows(x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """[0_n; x] along the rows axis: [..., l, N] -> [..., n+l, N]."""
    zeros = torch.zeros(tuple(x.shape[:-2]) + (n_rows, x.shape[-1]),
                        dtype=x.dtype, device=x.device)
    return torch.cat([zeros, x], dim=-2)


@annotate("commit_scheme/commit")
def _commit(gen: torch.Generator, ck: CommitmentKey, x: torch.Tensor, params: Params,
            r: torch.Tensor | None = None):
    """commit() that also returns the matvec A.r, for callers that verify
    their own opening and reuse it: (Opening, Commitment, A.r). Structure
    axes ahead of [l, N] (the sum proof's summands V) are batch axes here:
    r and A.r keep them."""
    n_deg = degree(x)
    ring = get_ring(n_deg, params.modulus)
    batch = tuple(x.shape[:-2])
    if r is None:
        r = sampling.uniform_centered(gen, batch + (params.k,), n_deg, params.b, x.device)
    r = lanes(r)
    # Static reachability: any |coeff| <= b draw has norm_2 <= b*sqrt(N); when
    # that can exceed the commit bound, one masked backup resample round runs
    # (never for a valid parameter set: sigma >= 11*kappa*b).
    cb = params.commit_bound(n_deg)
    if n_deg * params.b * params.b > cb * cb + 2 * cb:
        ok = commit_ok(params, n_deg, r)
        r2 = lanes(sampling.uniform_centered(gen, batch + (params.k,), n_deg, params.b,
                                             x.device))
        r = torch.where(ok[..., None, None], r, r2)
    ar = matvec_key(ring, ck, "a", r, params.b)
    c = zq.add_centered(ring.qctx, ar, _zero_pad_rows(x, params.n))
    return Opening(x=x, r=r), Commitment(c=c), ar


def commit(gen: torch.Generator, ck: CommitmentKey, x: torch.Tensor, params: Params,
           r: torch.Tensor | None = None):
    """Commit to x [..., l, N] -> (Opening, Commitment). ``r`` [..., k, N]
    injects the randomness; absent, it comes from ``gen``."""
    opening, com, _ = _commit(gen, ck, x, params, r)
    return opening, com


@annotate("commit_scheme/verify")
def verify(ck: CommitmentKey, com: Commitment, opening: Opening, params: Params, *,
           honest_r_bound: int | None = None,
           ar: torch.Tensor | None = None) -> torch.Tensor:
    """Opening verification including the relaxation factor f,
    f . c == [a1; a2] . r + f . [0_n; x] (f None: the identity), and the
    commit norm constraint. Returns bool [...].

    ``honest_r_bound``: an exact bound on |r|, sound only when the caller
    made the opening itself; it sizes the digit decomposition. ``ar``: the
    commit's own A.r for that same r, reused instead of recomputed (the
    JAX package gets this reuse from XLA's common-subexpression
    elimination). The verdict is the same either way; leave both None for
    openings from the wire."""
    x, r, f = opening
    n_deg = degree(x)
    ring = get_ring(n_deg, params.modulus)
    ok = commit_ok(params, n_deg, r)
    if ar is None:
        # adversarial r: clamp bound = the commit constraint itself
        ar = matvec_key(ring, ck, "a", r,
                        honest_r_bound if honest_r_bound is not None
                        else params.commit_bound(n_deg))
    zfull = _zero_pad_rows(x, params.n)
    if f is None:
        lhs, rhs = com.c, zq.add_centered(ring.qctx, ar, zfull)
    else:
        # the products with f run through K1 (or K7), the pointwise
        # product and K2 (or K8), each of depth one
        f_hat = ring.fwd_const(f.to(ring.dtype))
        rhs = zq.add_centered(ring.qctx, ar,
                              ring.inv(mat.scalar_mul_hat(ring, f_hat, ring.fwd(zfull))))
        lhs = ring.inv(mat.scalar_mul_hat(ring, f_hat, ring.fwd(com.c)))
    return ok & mat.poly_equal(lhs, rhs, struct_axes=1)


def chain_generators(gen: torch.Generator, chains: int) -> list:
    """``chains`` generators on ``gen``'s device, each seeded from a 63-bit
    draw of ``gen``: the port's analog of ``jax.random.split(key, chains)``.
    The seeds are read back to the host once."""
    seeds = torch.randint(0, 2**63 - 1, (chains,), generator=gen, device=gen.device,
                          dtype=torch.int64).tolist()
    return [torch.Generator(device=gen.device).manual_seed(s) for s in seeds]


def chained_roundtrip(fn, gen: torch.Generator, inputs, chains: int, min_ndims):
    """Run ``fn(gen_i, *input_slices)`` over ``chains`` independent splits
    of the leading batch axis and concatenate the (ok, op_ok) pairs.

    The slices are contiguous, in order, as the JAX package splits them;
    each chain draws from its own generator (:func:`chain_generators`), as
    each JAX chain consumes its own key split. Chains run one after
    another on the current stream. Same per-proof semantics and work; the
    draws differ from the unchained call.

    ``min_ndims`` gives each input's rank WITH a proof-batch axis (e.g. 3
    for open's x [B, l, N]): the leading axis of an unbatched input is a
    protocol STRUCTURE axis (message rows l, summands V), and splitting it
    would silently prove a different statement -- rejected here.
    """
    inputs = tuple(torch.as_tensor(a) for a in inputs)
    if any(a.ndim < 1 for a in inputs):
        raise ValueError("chained roundtrips need batched array inputs")
    b = inputs[0].shape[0]
    if (any(a.ndim < m for a, m in zip(inputs, min_ndims))
            or any(a.shape[0] != b for a in inputs) or b % chains):
        raise ValueError(
            f"chains={chains} needs a shared leading proof-batch axis divisible by it "
            f"(shapes {[tuple(a.shape) for a in inputs]}; an unbatched call cannot be "
            "chained)")
    split = [a.split(b // chains) for a in inputs]
    outs = [fn(gi, *(a[i] for a in split))
            for i, gi in enumerate(chain_generators(gen, chains))]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
