"""Negacyclic NTT polynomial multiplication over Z_q[x]/(x^N + 1) via CRT.

Port of ``ringzk_tpu.ops.ntt``. q = 3515337053 has no 2N-th root of
unity, so products are computed exactly over three NTT-friendly 30-bit
primes and reconstructed mod q (Garner's CRT). On narrow rings (q < 2^32)
the transforms run in kernels K1 and K2 (``ops/kernels/ntt.py``) and the
fused ``t + d * m`` of the sigma protocols in kernel K5
(``ops/kernels/scalar_mul_add.py``). Wide rings (2^32 <= q < 2^63, the
reference's full ZqI64 domain) carry int64 residues, extend the prime set
with EXT_PRIMES until the CRT range covers the products, fold mod q on the
64-bit twins (``ops/mont64.py``) and transform in kernels K7 and K8
(``ops/kernels/ntt_wide.py``). The pointwise algebra between transforms
runs on the int64 Montgomery twins on both. The single-prime transforms
:func:`fwd_one` and :func:`inv_one` (the JAX package's ``_fwd_one`` and
``_inv_one``) run in kernel K9 (``ops/kernels/ntt_one.py``).

Shapes: a polynomial batch is ``[..., N]`` of centered residues (int32, or
int64 on wide rings); its NTT-domain image is ``[P, ..., N]``, uint32 bit
patterns stored as int32.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..utils.profiling import annotate
from . import zq
from .kernels import ntt as ntt_kernel
from .kernels import ntt_one as ntt_one_kernel
from .kernels import ntt_wide as ntt_wide_kernel
from .kernels import scalar_mul_add as scalar_mul_add_kernel
from .mont64 import Mont64Ctx
from .montgomery import MontCtx
from .u64 import narrow, widen

PRIMES = (998244353, 754974721, 167772161)   # 119*2^23+1, 45*2^24+1, 5*2^25+1
GENERATORS = (3, 11, 3)
NUM_PRIMES = len(PRIMES)
M_PROD = PRIMES[0] * PRIMES[1] * PRIMES[2]

# Extension primes of wide rings, appended to PRIMES until the CRT range
# covers 2 * ACC_MAX * N * (q/2)^2: p = c * 2^s + 1 with s >= 23 and
# p < 2^31 (Shoup butterflies). Narrow rings always use exactly PRIMES.
EXT_PRIMES = (469762049, 2013265921, 2130706433, 1811939329, 2113929217)
EXT_GENERATORS = (3, 31, 3, 13, 5)


def _bit_reverse(i: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (i & 1)
        i >>= 1
    return r


@functools.lru_cache(maxsize=None)
def _prime_tables(p: int, g: int, n: int):
    """Twiddle tables for modulus p, ring degree n (numpy uint32), the same
    arrays as ``ringzk_tpu.ops.ntt._prime_tables``:

    psi_rev[i]     = psi^{bitrev(i)} mod p,   psi a primitive 2n-th root
    psi_inv_rev[i] = psi^{-bitrev(i)} mod p
    n_inv_scale    = (N^{-1} mod p, Shoup companion)
    w_fwd, w_inv   = the lane-resident [2, logn, n] planes of the TPU
                     kernels: w_fwd[0, s, i] = psi_rev[2^s + (i >> (logn-s))]
    """
    ctx = MontCtx.make(p)
    logn = n.bit_length() - 1
    assert 1 << logn == n, "N must be a power of two"
    assert (p - 1) % (2 * n) == 0, f"prime {p} lacks 2N-th roots for N={n}"
    assert p < 2**31, "Shoup butterflies require p < 2^31"
    psi = pow(g, (p - 1) // (2 * n), p)
    assert pow(psi, n, p) == p - 1, f"generator {g} not primitive for {p}"
    psi_inv = pow(psi, -1, p)
    psi_rev = np.empty(n, dtype=np.uint32)
    psi_inv_rev = np.empty(n, dtype=np.uint32)
    for i in range(n):
        br = _bit_reverse(i, logn)
        psi_rev[i] = pow(psi, br, p)
        psi_inv_rev[i] = pow(psi_inv, br, p)
    n_inv = pow(n, -1, p)
    n_inv_scale = (n_inv, ctx.h_shoup(n_inv))

    def shoup_plane(w):
        return ((w.astype(object) << 32) // p).astype(np.uint32)

    lanes = np.arange(n)
    w_fwd = np.empty((2, logn, n), dtype=np.uint32)
    for s in range(logn):
        w_fwd[0, s] = psi_rev[(1 << s) + (lanes >> (logn - s))]
    w_fwd[1] = shoup_plane(w_fwd[0])
    w_inv = np.empty((2, logn, n), dtype=np.uint32)
    for s in range(logn):
        w_inv[0, s] = psi_inv_rev[(n >> (s + 1)) + (lanes >> (s + 1))]
    w_inv[1] = shoup_plane(w_inv[0])
    return psi_rev, psi_inv_rev, n_inv_scale, w_fwd, w_inv


@dataclasses.dataclass(frozen=True)
class RingContext:
    """All static state for exact arithmetic in Z_q[x]/(x^N + 1), odd q <
    2^63. Residues are presented as centered int32 in [-(q-1)/2, (q-1)/2],
    int64 on wide rings (:attr:`wide`)."""

    n: int
    q: int

    # Max NTT-domain accumulation terms guaranteed exact (k-dim matvecs etc.)
    ACC_MAX = 16

    def __post_init__(self):
        if self.n & (self.n - 1) or self.n < 2:
            raise ValueError(f"N must be a power of two >= 2, got {self.n}")
        if self.q % 2 == 0 or self.q >= 2**63:
            raise ValueError("q must be odd and < 2^63 (the ZqI64 domain)")
        # |integer conv coeff| <= N*(q/2)^2 per product, up to ACC_MAX terms
        bound = self.n * (self.q // 2 + 1) ** 2 * self.ACC_MAX * 2
        if not self.wide:
            if bound > M_PROD:
                raise ValueError("CRT bound exceeded; add primes or shrink N*q^2")
        else:
            prod = 1
            for p, _ in self._wide_prime_list():
                prod *= p
            if bound > prod:
                raise ValueError(f"q={self.q} at N={self.n} exceeds the full CRT range")

    @property
    def wide(self) -> bool:
        """True for q >= 2^32: centered residues are int64, the mod-q fold
        runs on 64-bit limb pairs, and the prime set extends past PRIMES as
        needed. The NTT domain itself is the same."""
        return self.q >= 2**32

    @property
    def dtype(self) -> torch.dtype:
        """The dtype of centered residues."""
        return torch.int64 if self.wide else torch.int32

    def _wide_prime_list(self):
        bound = self.n * (self.q // 2 + 1) ** 2 * self.ACC_MAX * 2
        out = []
        prod = 1
        for p, g in zip(PRIMES + EXT_PRIMES, GENERATORS + EXT_GENERATORS):
            out.append((p, g))
            prod *= p
            if prod > bound:
                break
        return tuple(out)

    @functools.cached_property
    def primes(self):
        """The ring's CRT prime set (PRIMES on narrow rings)."""
        if not self.wide:
            return PRIMES
        return tuple(p for p, _ in self._wide_prime_list())

    @functools.cached_property
    def generators(self):
        if not self.wide:
            return GENERATORS
        return tuple(g for _, g in self._wide_prime_list())

    @property
    def num_primes(self) -> int:
        return len(self.primes)

    @functools.cached_property
    def mont(self):
        return tuple(MontCtx.make(p) for p in self.primes)

    @functools.cached_property
    def qctx(self):
        """Mod-q context: MontCtx on narrow rings, Mont64Ctx (64-bit limb
        pairs) on wide ones; ops.zq dispatches on it."""
        return Mont64Ctx.make(self.q) if self.wide else MontCtx.make(self.q)

    @functools.cached_property
    def _tables(self):
        return tuple(
            _prime_tables(p, g, self.n) for p, g in zip(self.primes, self.generators)
        )

    def _garner(self, num: int):
        """Constants for Garner mixed-radix CRT over the first ``num`` primes
        and the final mod-q fold: uint32 Montgomery constants on narrow
        rings; on wide ones k_mont holds (lo, hi) Mont64 pairs (K_i * 2^64
        mod q) and m_mod_q a plain (lo, hi) pair."""
        cache = self.__dict__.setdefault("_garner_cache", {})
        if num in cache:
            return cache[num]
        ps = self.primes[:num]
        prod = 1
        for p in ps:
            prod *= p
        rem = prod // 2
        c_mont, k_mont, half_digits = [], [], []
        acc = 1
        for i, p in enumerate(ps):
            if i > 0:
                c_mont.append(MontCtx.make(p).h_to_mont(pow(acc, -1, p)))
                k_mont.append(self.qctx.h_to_mont(acc % self.q))
            half_digits.append(rem % p)
            rem //= p
            acc *= p
        m_mod_q = prod % self.q
        out = dict(
            c_mont=c_mont,
            k_mont=k_mont,
            m_mod_q=(m_mod_q & 0xFFFFFFFF, m_mod_q >> 32) if self.wide else m_mod_q,
            half_digits=tuple(half_digits),
        )
        cache[num] = out
        return out

    # -- forward / inverse transforms -------------------------------------

    @annotate("ntt_fwd")
    def fwd(self, x: torch.Tensor, num: int | None = None) -> torch.Tensor:
        """Centered [..., N] -> plain NTT domain [num, ..., N]: K1 on int32,
        K7 on wide rings (any int64).

        Data stays in plain residue form; multiplicative operands go through
        :meth:`fwd_const`. ``num`` selects a CRT prime subset for products
        with small exact bounds (see :meth:`primes_needed`)."""
        if num is None:
            num = self.num_primes
        lead = x.shape[:-1]
        x2d = x.to(self.dtype).reshape(-1, self.n).contiguous()
        fwd_all = ntt_wide_kernel.fwd_wide_all if self.wide else ntt_kernel.fwd_all
        return fwd_all(self, x2d, num).reshape((num,) + lead + (self.n,))

    @annotate("ntt_fwd")
    def fwd_const(self, x: torch.Tensor, num: int | None = None) -> torch.Tensor:
        """fwd() then per-prime to-Montgomery: the form of the multiplicative
        operand of dot_hat and scalar products."""
        return self.to_const(self.fwd(x, num))

    def to_const(self, h: torch.Tensor) -> torch.Tensor:
        """Plain NTT images [P, ..., N] -> const (Montgomery) form."""
        return torch.stack(
            [narrow(self.mont[i].to_mont(widen(h[i]))) for i in range(h.shape[0])]
        )

    def primes_needed(self, bound: int) -> int:
        """Smallest prime-subset size whose CRT range covers |coeff| <= bound."""
        prod = 1
        for i, p in enumerate(self.primes):
            prod *= p
            if prod > 2 * bound:
                return i + 1
        raise ValueError(f"bound 2^{bound.bit_length()} exceeds full CRT range")

    @annotate("ntt_inv")
    def inv(self, xhat: torch.Tensor) -> torch.Tensor:
        """Plain NTT domain [P, ..., N] -> centered [..., N]: K2 (int32), K8
        on wide rings (int64).

        DEPTH-ONE RULE: between fwd() and inv(), apply at most ONE ring
        multiplication per term (plus <= ACC_MAX accumulated terms)."""
        num = xhat.shape[0]
        lead = xhat.shape[1:-1]
        x3d = xhat.reshape(num, -1, self.n).contiguous()
        inv_all = ntt_wide_kernel.inv_wide_all if self.wide else ntt_kernel.inv_all
        return inv_all(self, x3d).reshape(lead + (self.n,))

    def _crt_to_centered(self, ys):
        """Garner reconstruction of [y mod p_i] (int64 in [0, p_i)) ->
        centered residues mod q (int32, int64 on wide rings), for any
        prime-subset size len(ys)."""
        if self.wide:
            return self.qctx.to_centered_i64(*self._crt_to_pair(ys))
        num = len(ys)
        g = self._garner(num)
        vs, gt = self._crt_digits(ys, g)
        qc = self.qctx
        acc = qc.reduce_u32(vs[0])
        for i in range(1, num):
            acc = qc.add(acc, qc._mont_mul_lt_p(vs[i], g["k_mont"][i - 1]))
        acc = qc.sub(acc, torch.where(gt, g["m_mod_q"], 0))
        return self.to_centered(acc)

    def _crt_digits(self, ys, g):
        """Garner mixed-radix digits x = v0 + v1*p0 + v2*p0*p1 + ... with
        0 <= v_i < p_i, and gt = (x > floor(M/2)) by a lexicographic digit
        compare (most significant digit last)."""
        num = len(ys)
        vs = [ys[0]]
        for i in range(1, num):
            mi = self.mont[i]
            t = mi.sub(ys[i], mi.reduce_u32(vs[0]))
            acc_prod = 1
            for j in range(1, i):
                acc_prod *= self.primes[j - 1]
                pj_mont = mi.h_to_mont(acc_prod % mi.p)
                t = mi.sub(t, mi._mont_mul_lt_p(mi.reduce_u32(vs[j]), pj_mont))
            vs.append(mi._mont_mul_lt_p(t, g["c_mont"][i - 1]))
        hs = g["half_digits"]
        gt = vs[-1] > hs[-1]
        eq = vs[-1] == hs[-1]
        for i in range(num - 2, -1, -1):
            gt = gt | (eq & (vs[i] > hs[i]))
            eq = eq & (vs[i] == hs[i])
        return vs, gt

    def _crt_to_pair(self, ys):
        """Wide-ring Garner reconstruction to a [0, q) (lo, hi) limb pair:
        x mod q = sum_i v_i * K_i - [x > M/2] * (M mod q), each v_i * K_i a
        Mont64 REDC (``Mont64Ctx.redc_small``)."""
        num = len(ys)
        g = self._garner(num)
        vs, gt = self._crt_digits(ys, g)
        qc = self.qctx
        acc_lo, acc_hi = vs[0], torch.zeros_like(vs[0])  # v0 < p0 < q
        for i in range(1, num):
            t_lo, t_hi = qc.redc_small(vs[i], *g["k_mont"][i - 1])
            acc_lo, acc_hi = qc.add(acc_lo, acc_hi, t_lo, t_hi)
        m_lo, m_hi = g["m_mod_q"]
        return qc.sub(acc_lo, acc_hi, torch.where(gt, m_lo, 0), torch.where(gt, m_hi, 0))

    def to_centered(self, u: torch.Tensor) -> torch.Tensor:
        """int64 in [0, q) -> centered int32 in [-(q-1)/2, q/2] (narrow)."""
        return zq.to_centered(self.qctx, u)

    # -- NTT-domain (pointwise) algebra: inputs/outputs [P, ..., N] -------

    @annotate("pointwise")
    def dot_hat(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Pointwise product; exactly one operand in const (Montgomery) form,
        the result in plain form. Operands share the prime-subset size."""
        if a.shape[0] != b.shape[0]:
            raise ValueError(f"dot_hat: prime axes differ {a.shape} vs {b.shape}")
        return torch.stack(
            [narrow(self.mont[i]._mont_mul_lt_p(widen(a[i]), widen(b[i])))
             for i in range(a.shape[0])]
        )

    def add_hat(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.shape[0] != b.shape[0]:
            raise ValueError(f"add_hat: prime axes differ {a.shape} vs {b.shape}")
        return torch.stack(
            [narrow(self.mont[i].add(widen(a[i]), widen(b[i])))
             for i in range(a.shape[0])]
        )

    def sub_hat(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.shape[0] != b.shape[0]:
            raise ValueError(f"sub_hat: prime axes differ {a.shape} vs {b.shape}")
        return torch.stack(
            [narrow(self.mont[i].sub(widen(a[i]), widen(b[i])))
             for i in range(a.shape[0])]
        )

    def sum_hat(self, a: torch.Tensor, axis: int) -> torch.Tensor:
        """Add-mod reduce of an NTT-domain stack [P, ...] along ``axis`` (an
        index into the full array, never the prime axis 0). At most ACC_MAX
        terms: a longer sum of depth-one products can leave the CRT range,
        and inv() would wrap silently; use :meth:`sum_to_centered`."""
        axis = axis % a.dim()
        if axis == 0:
            raise ValueError("sum_hat: cannot reduce the prime axis")
        size = a.shape[axis]
        if size > self.ACC_MAX:
            raise ValueError(
                f"sum_hat over {size} terms exceeds ACC_MAX={self.ACC_MAX} "
                "(CRT exactness); use sum_to_centered for chunked reduction"
            )
        out = a.select(axis, 0)
        for j in range(1, size):
            out = self.add_hat(out, a.select(axis, j))
        return out

    @annotate("ntt_inv")
    def sum_to_centered(self, a: torch.Tensor, axis: int) -> torch.Tensor:
        """Exact ``inv(sum_hat(a, axis))`` for any axis length, centered:
        chunks of ACC_MAX terms are reconstructed out of the NTT
        domain and the centered partials added mod q."""
        axis = axis % a.dim()
        if axis == 0:
            raise ValueError("sum_to_centered: cannot reduce the prime axis")
        size = a.shape[axis]
        out = None
        for start in range(0, size, self.ACC_MAX):
            part = self.inv(self.sum_hat(a.narrow(axis, start, min(self.ACC_MAX, size - start)),
                                         axis))
            out = part if out is None else zq.add_centered(self.qctx, out, part)
        return out

    def polymul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Exact negacyclic product of centered polys [..., N] mod q."""
        return self.inv(self.dot_hat(self.fwd_const(a), self.fwd(b)))

    @annotate("scalar_mul_add")
    def scalar_mul_add(self, d, m, t, num: int | None = None) -> torch.Tensor:
        """``t + d * m`` mod q, centered: d [..., N] broadcast over the
        structure axes of m, t [..., *struct, N] (rows; summands x rows in
        the sum proof), which are flattened to one rows axis. On narrow
        rings it runs in K5, whose plain version is the JAX package's
        default composed chain (fwd_const(d), fwd(m), dot_hat, inv, centered
        add); wide rings run that chain itself, on K7 and K8, as the JAX
        package does. ``num`` is the caller's exact CRT bound for d*m."""
        if num is None:
            num = self.num_primes
        nbatch = d.dim() - 1
        if tuple(m.shape[:nbatch]) != tuple(d.shape[:-1]):
            raise ValueError(
                f"scalar_mul_add: d batch {tuple(d.shape[:-1])} does not prefix "
                f"m shape {tuple(m.shape)}"
            )
        if t.shape != m.shape:
            raise ValueError(
                f"scalar_mul_add: t shape {tuple(t.shape)} != m shape {tuple(m.shape)}"
            )
        n = self.n
        if self.wide:
            mf = m.reshape(tuple(d.shape[:-1]) + (-1, n))
            dm = self.inv(self.dot_hat(self.fwd_const(d, num).unsqueeze(-2), self.fwd(mf, num)))
            return zq.add_centered(self.qctx, t.reshape(mf.shape), dm).reshape(m.shape)
        d2 = d.to(torch.int32).reshape(-1, n).contiguous()
        m3 = m.to(torch.int32).reshape(d2.shape[0], -1, n).contiguous()
        t3 = t.to(torch.int32).reshape(m3.shape).contiguous()
        return scalar_mul_add_kernel.scalar_mul_add(self, d2, m3, t3, num).reshape(m.shape)


@functools.lru_cache(maxsize=None)
def _get_ring_cached(n: int, q: int) -> RingContext:
    return RingContext(n=n, q=q)


# Ring override (see parallel/ring_sp.py): while active, protocol code
# asking for a ring of the SAME (n, q) receives the override instead, e.g.
# an SpRing whose transforms split the coefficient axis over a group of
# ranks. This is how the sp axis reaches the protocol layer without a ring
# argument threaded through every call site. Other (n, q) pairs fall
# through to the cache.
_RING_OVERRIDE: list = []


class ring_override:
    """Context manager installing ``ring`` as the get_ring result for its
    (n, q) while the block runs. Nestable."""

    def __init__(self, ring: RingContext):
        self.ring = ring

    def __enter__(self):
        _RING_OVERRIDE.append(self.ring)
        return self.ring

    def __exit__(self, *exc):
        _RING_OVERRIDE.pop()


def get_ring(n: int, q: int) -> RingContext:
    for ov in reversed(_RING_OVERRIDE):
        if ov.n == n and ov.q == q:
            return ov
    return _get_ring_cached(n, q)


# A ring whose coefficient axis is split (parallel/ring_sp.SpRing, the only
# ring the port installs as an override) holds only its lane block
# [..., N/sp] on each rank, so the protocol layer reads the ring degree,
# cuts its full-width draws and reduces over the ring axis through the
# helpers below. Each is the identity (no collective) while no override is
# active.


def _split_ring():
    """The innermost active override, or None."""
    return _RING_OVERRIDE[-1] if _RING_OVERRIDE else None


def degree(x: torch.Tensor) -> int:
    """The ring degree of the polynomials ``x`` [..., width]: the global
    N of an active split ring whose lane block is ``width`` wide, else the
    width itself."""
    ov = _split_ring()
    if ov is not None and x.shape[-1] == ov.n_loc:
        return ov.n
    return x.shape[-1]


def lanes(full: torch.Tensor) -> torch.Tensor:
    """This rank's lane block of a full-width [..., N] tensor under an
    active split ring (a contiguous copy); ``full`` itself otherwise."""
    ov = _split_ring()
    return full if ov is None else ov.lanes(full)


def ring_all(flag: torch.Tensor) -> torch.Tensor:
    """AND of a bool tensor over the split ring's ranks (an int32 MIN
    all-reduce: no collective reduces bools on every backend)."""
    ov = _split_ring()
    return flag if ov is None else ov.all_reduce(flag.to(torch.int32), "min").bool()


def ring_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of an integer tensor over the split ring's ranks."""
    ov = _split_ring()
    return t if ov is None else ov.all_reduce(t, "sum")


def ring_min(t: torch.Tensor) -> torch.Tensor:
    """Minimum of an integer tensor over the split ring's ranks."""
    ov = _split_ring()
    return t if ov is None else ov.all_reduce(t, "min")


def ring_max(t: torch.Tensor) -> torch.Tensor:
    """Maximum of an integer tensor over the split ring's ranks."""
    ov = _split_ring()
    return t if ov is None else ov.all_reduce(t, "max")


def fwd_one(ring: RingContext, i: int, x: torch.Tensor) -> torch.Tensor:
    """Forward NTT at prime ``i`` of ``ring.primes`` (a wide ring's
    extension primes included), in K9: uint32 [..., N] stored as int32,
    taken as given ([0, p_i) for residues; other values wrap as the JAX
    package's strict butterflies wrap them) -> its image [..., N] in
    bit-reversed order. The counterpart of the JAX package's
    ``ntt._fwd_one``; the protocols transform all primes at once (K1, K7)."""
    return ntt_one_kernel.fwd_one(ring, i, x.reshape(-1, ring.n).contiguous()).reshape(x.shape)


def inv_one(ring: RingContext, i: int, xh: torch.Tensor) -> torch.Tensor:
    """Inverse NTT at prime ``i`` with the N^-1 scaling, in K9: an image
    [..., N] (int32 bits) -> [0, p_i) [..., N], natural order, no CRT. The
    counterpart of ``ntt._inv_one``."""
    return ntt_one_kernel.inv_one(ring, i, xh.reshape(-1, ring.n).contiguous()).reshape(xh.shape)


# Pairwise-coprime 26-bit moduli for the exact golden-model convolution,
# extended until their product covers twice the coefficient bound N*(q/2)^2.
_SB_MODULI = (1 << 26, (1 << 26) - 1, (1 << 26) - 3)


@functools.lru_cache(maxsize=None)
def _sb_moduli(n: int, q: int):
    import math

    bound = 2 * n * (q // 2 + 1) ** 2
    ms = list(_SB_MODULI)
    prod = ms[0] * ms[1] * ms[2]
    cand = (1 << 26) - 4
    while prod <= bound:
        if all(math.gcd(cand, m) == 1 for m in ms):
            ms.append(cand)
            prod *= cand
        cand -= 1
        assert cand > 1 << 25, "modulus pool exhausted"
    return tuple(ms)


def negacyclic_schoolbook(a, b, q):
    """Exact negacyclic product golden model (tests only), numpy in and
    out: the schoolbook product with x^N == -1, computed as CRT over int64
    ``np.convolve`` passes. Returns centered int64 residues mod q."""
    a = np.asarray(a, dtype=object)
    b = np.asarray(b, dtype=object)
    n = a.shape[-1]
    shape = np.broadcast_shapes(a.shape, b.shape)
    af = np.broadcast_to(a, shape).reshape(-1, n)
    bf = np.broadcast_to(b, shape).reshape(-1, n)

    ms = _sb_moduli(n, q)
    prod_m = 1
    for m in ms:
        prod_m *= m
    if n * max(ms) ** 2 >= 2**63:
        raise ValueError(f"N={n} too large for the int64 CRT golden model")
    basis = []
    for m in ms:
        rest = prod_m // m
        basis.append(rest * pow(rest, -1, m))

    rows = []
    for ai, bi in zip(af, bf):
        x = 0
        for m, e in zip(ms, basis):
            am = np.asarray([int(v) % m for v in ai], dtype=np.int64)
            bm = np.asarray([int(v) % m for v in bi], dtype=np.int64)
            c = np.convolve(am, bm)
            folded = c[:n].copy()
            folded[: n - 1] -= c[n:]  # x^N == -1
            x = x + e * (folded.astype(object) % m)
        x = x % prod_m
        x = np.where(x > prod_m // 2, x - prod_m, x)
        rows.append(x)
    out = np.mod(np.stack(rows).reshape(shape), q)
    half = q // 2
    out = np.where(out > half, out - q, out)
    return out.astype(np.int64)
