"""Matrices of ring elements as dense tensors: [..., rows, cols, N] centered
residues (int32; int64 on wide rings).

Port of ``ringzk_tpu.ops.mat``: the NTT-path matvec the sigma protocols
run (the exact fallback for keys without a digit operator), the scalar
product of a stack, centered add and sub, row splitting and exact
equality; and the reference's ``Mat`` algebra on top of them, which no
protocol calls: the constructors and shape helpers, the full matrix
product ``dot`` (exact for any contraction length), ``add``, ``sub``,
``componentwise_mul`` and the NTT-domain equality ``equal_mod_q_hat``.
Every function takes the narrow and the wide rings (int32 or int64
residues). NTT-domain forms carry a leading prime axis: [P, ..., rows,
cols, N].
"""

from __future__ import annotations

import torch

from ..utils.profiling import annotate
from . import ntt, zq
from .ntt import RingContext


@annotate("pointwise")
def matvec_hat(ring: RingContext, a_hat: torch.Tensor, v_hat: torch.Tensor) -> torch.Tensor:
    """NTT-domain (matrix . vector): a_hat [P, *A, rows, k, N] (const form),
    v_hat [P, *B, k, N] (plain form), broadcast batch prefixes. Returns
    [P, *, rows, N]. k must be <= RingContext.ACC_MAX for CRT exactness."""
    k = a_hat.shape[-2]
    if v_hat.shape[-2] != k:
        raise ValueError(f"matvec_hat: contraction mismatch {tuple(a_hat.shape)} . "
                         f"{tuple(v_hat.shape)}")
    if k > ring.ACC_MAX:
        raise ValueError(f"matvec_hat: contraction length {k} exceeds "
                         f"ACC_MAX={ring.ACC_MAX}; use mat.matvec")
    v_hat = v_hat.unsqueeze(-3)  # [P, *B, 1, k, N]
    out = ring.dot_hat(a_hat[..., :, 0, :], v_hat[..., :, 0, :])
    for t in range(1, k):
        out = ring.add_hat(out, ring.dot_hat(a_hat[..., :, t, :], v_hat[..., :, t, :]))
    return out


def matvec(ring: RingContext, a_hat: torch.Tensor, v_hat: torch.Tensor) -> torch.Tensor:
    """Centered (matrix . vector), exact for any contraction length: the
    contraction is chunked at ACC_MAX terms, each partial reduced out of
    the NTT domain before the centered partials are added mod q."""
    k = a_hat.shape[-2]
    if v_hat.shape[-2] != k:
        raise ValueError(f"matvec: contraction mismatch {tuple(a_hat.shape)} . "
                         f"{tuple(v_hat.shape)}")
    out = None
    for start in range(0, k, ring.ACC_MAX):
        stop = min(start + ring.ACC_MAX, k)
        part = ring.inv(matvec_hat(ring, a_hat[..., :, start:stop, :],
                                   v_hat[..., start:stop, :]))
        out = part if out is None else zq.add_centered(ring.qctx, out, part)
    return out


@annotate("pointwise")
def scalar_mul_hat(ring: RingContext, g_hat: torch.Tensor, m_hat: torch.Tensor) -> torch.Tensor:
    """Multiply every entry of an NTT-domain stack by the polynomial g:
    g_hat [P, *, N] const form, m_hat [P, *, rows, N] plain form; g
    broadcasts over the rows axis; the result is in plain form."""
    return ring.dot_hat(g_hat.unsqueeze(-2), m_hat)


@annotate("modq")
def add_centered(ring: RingContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise ring addition on centered tensors."""
    return zq.add_centered(ring.qctx, a, b)


@annotate("modq")
def sub_centered(ring: RingContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return zq.sub_centered(ring.qctx, a, b)


def split_rows(x: torch.Tensor, r: int):
    """(first r rows, remaining rows) along the rows axis -2."""
    return x[..., :r, :], x[..., r:, :]


@annotate("modq")
def poly_equal(a: torch.Tensor, b: torch.Tensor, struct_axes: int = 2) -> torch.Tensor:
    """Exact equality of centered poly stacks, reduced over the trailing
    ``struct_axes`` structure axes plus the ring axis (over every rank's
    lane block under a split ring, ``ntt.ring_all``)."""
    eq = a == b
    for _ in range(struct_axes + 1):
        eq = eq.all(-1)
    return ntt.ring_all(eq)


# -- constructors and shape helpers (the reference's Mat) ---------------------


def from_element(rows: int, cols: int, poly: torch.Tensor) -> torch.Tensor:
    """Matrix with every entry the polynomial poly [..., N]: [..., rows,
    cols, N] (an expanded view)."""
    return poly[..., None, None, :].expand(tuple(poly.shape[:-1]) + (rows, cols, poly.shape[-1]))


def diag(rows: int, cols: int, poly: torch.Tensor) -> torch.Tensor:
    """Matrix with poly [..., N] on the diagonal and zero elsewhere."""
    eye = torch.eye(rows, cols, dtype=poly.dtype, device=poly.device)[..., None]
    return eye * poly[..., None, None, :]


def from_vec(polys: torch.Tensor) -> torch.Tensor:
    """Column matrix: [..., rows, N] -> [..., rows, 1, N]."""
    return polys[..., :, None, :]


def one_d_mat_to_vec(m: torch.Tensor) -> torch.Tensor:
    """[..., rows, 1, N] -> [..., rows, N]."""
    if m.shape[-2] != 1:
        raise ValueError(f"one_d_mat_to_vec: not a column matrix {tuple(m.shape)}")
    return m[..., :, 0, :]


def new_with(gen: torch.Generator, rows: int, cols: int, n: int, sampler) -> torch.Tensor:
    """Matrix filled by ``sampler(gen, (rows, cols), n)`` -> [rows, cols,
    N]; the JAX function takes a PRNG key where this takes a generator
    (e.g. a ``functools.partial`` of ``sampling.uniform_centered`` with its
    bound and device)."""
    return sampler(gen, (rows, cols), n)


def dim(m: torch.Tensor) -> tuple:
    """(rows, cols) of a [..., rows, cols, N] stack."""
    return m.shape[-3], m.shape[-2]


def extend_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stack below: [r1, c, N] + [r2, c, N] -> [r1+r2, c, N]."""
    return torch.cat([a, b], dim=-3)


def extend_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stack right: [r, c1, N] + [r, c2, N] -> [r, c1+c2, N]."""
    return torch.cat([a, b], dim=-2)


# -- the algebra ---------------------------------------------------------------


def dot(ring: RingContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product over the ring: [..., m, n, N] . [..., n, p, N] ->
    centered [..., m, p, N]: a to the const-form NTT domain, b to the
    plain one, every (i, t, j) product pointwise, then the sum over the
    contraction t out of the NTT domain (``sum_to_centered``, chunked at
    ACC_MAX terms, so exact for any contraction length)."""
    n_c = a.shape[-2]
    if b.shape[-3] != n_c:
        raise ValueError(f"dot: contraction mismatch {tuple(a.shape)} . {tuple(b.shape)}")
    a_hat = ring.fwd_const(a)          # [P, ..., m, n, N]
    b_hat = ring.fwd(b)                # [P, ..., n, p, N]
    prod = ring.dot_hat(a_hat[..., :, :, None, :], b_hat[..., None, :, :, :])
    return ring.sum_to_centered(prod, axis=-3)


def add(ring: RingContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise matrix addition mod q, centered."""
    return zq.add_centered(ring.qctx, a, b)


def sub(ring: RingContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise matrix subtraction mod q, centered."""
    return zq.sub_centered(ring.qctx, a, b)


def componentwise_mul(ring: RingContext, m: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Every entry of m [..., rows, cols, N] (or [..., rows, N]) times the
    polynomial g [..., N], broadcast over m's structure axes: one product
    of depth one in the NTT domain."""
    g_hat = ring.fwd_const(g)
    idx = (...,) + (None,) * (m.dim() - g.dim()) + (slice(None),)
    return ring.inv(ring.dot_hat(g_hat[idx], ring.fwd(m)))


def equal_mod_q_hat(ring: RingContext, a_hat: torch.Tensor, b_hat: torch.Tensor,
                    struct_axes: int = 1) -> torch.Tensor:
    """Ring equality of two plain-form NTT-domain stacks by one inverse
    transform of their difference: a == b in R_q iff inv(a_hat - b_hat) ==
    0. Reduced over ``struct_axes`` structure axes plus the ring axis (and
    over every rank's lanes under a split ring, ``ntt.ring_all``)."""
    eq = ring.inv(ring.sub_hat(a_hat, b_hat)) == 0
    for _ in range(struct_axes + 1):
        eq = eq.all(-1)
    return ntt.ring_all(eq)
