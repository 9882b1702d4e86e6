"""The kernel work of one sum-proof round trip of B proofs over V
summands at degree N, counted from the protocol's shapes; on a wide ring
``wide_work``.

Each entry is (kernel, what, least ms) by the frozen bound functions, as
the port launches them at this commit (ringzk_tpu_torch/protocols/
{commit,sum}.py; the shapes chip_smoke.py's K12_PATH_SHAPES and K5_SHAPES
record): the g products' forward transforms over the B V summands at three
primes (gs and xs in the commit, a2 y_i for u; gs, a2 z_i and c2_i in the
verify) and their four inverses over B after the sum over V; the key
matvecs (the V + 1 commitments at one digit, the V + 1 masks and the V + 1
responses at their digits, each in two row blocks); the challenge; the
products t + d m (zs and zp at one prime; t_i + c1_i d, tp + c1p d and the
relation's d term at two).
"""

from __future__ import annotations

from . import wide
from .bounds import (digits_for_bound, k1_bound, k2_bound, k4_bound, k5_bound, k7_bound,
                     k8_bound, matvec_bound)

PRIMES_G = 3   # the g products' CRT primes on the default ring


def work(scheme, batch: int, vl: int) -> list:
    s = scheme
    if wide.is_wide(s):
        return wide_work(s, batch, vl)
    matvec = "K3" if s.n_deg <= 512 else "K6"
    kn, n = s.k * s.n_deg, s.n_deg
    one, mask, ver = (digits_for_bound(x) for x in (s.b, s.mask_bound, s.verify_bound))
    out = [("K1", "forward, g products", k1_bound(batch * vl, PRIMES_G, n))] * 6
    out += [("K2", "inverse, g products", k2_bound(batch, PRIMES_G, n))] * 4
    for what, rows, nd in (("A rp", batch, one), ("A r_i", batch * vl, one),
                           ("A y", batch * (vl + 1), mask), ("A z", batch * (vl + 1), ver)):
        out += [(matvec, f"{what}, a1 rows", matvec_bound(rows, kn, s.n * n, nd)),
                (matvec, f"{what}, a2 rows", matvec_bound(rows, kn, s.l * n, nd))]
    out += [("K4", "challenge", k4_bound(batch, n)),
            ("K5", "zs", k5_bound(batch, vl * s.k, 1, n)),
            ("K5", "zp", k5_bound(batch, s.k, 1, n)),
            ("K5", "t_i + c1_i d", k5_bound(batch, vl * s.n, 2, n)),
            ("K5", "tp + c1p d", k5_bound(batch, s.n, 2, n)),
            ("K5", "relation's d term", k5_bound(batch, s.l, 2, n))]
    return [(k, what, ms) for k, what, (ms, _) in out]


def wide_work(scheme, batch: int, vl: int) -> list:
    """On a wide ring (``protocols/{commit,sum}.py`` on ``ops/ntt.py``'s
    wide path), every transform at the ring's primes but the products with
    d: K7 of gs (commit and verify) and of xs, a2 y_i, a2 z_i and c2_i for
    the g products, a K8 of each sum over V (xp, u, the relation's two
    sides); the key matvecs of rp, r_i, y_i, yp, z_i and zp, each K7 of v
    and a K8 a row block (the V stack and the single vector apart, as no
    digit operator joins them); the challenge; zs, zp, t_i + c1_i d,
    tp + c1p d and the relation's d term, each K7 of d and of m and a K8,
    at their primes."""
    s, b, v, n = scheme, batch, vl, scheme.n_deg
    num = len(wide.primes(s))
    blocks = (("a1", s.n), ("a2", s.l))
    resp, ver = wide.d_primes(s)
    fwd, inv = (("K7", k7_bound), ("K8", k8_bound))

    def g(kernel, what, rows):
        name, fn = kernel
        return [(name, f"{what}, g products", fn(rows, num, n))]

    out = (g(fwd, "gs, commit", b * v) + g(fwd, "xs", b * v * s.l) + g(inv, "xp", b * s.l)
           + wide.key_matvec(s, "A rp", b, blocks) + wide.key_matvec(s, "A r_i", b * v, blocks)
           + wide.key_matvec(s, "A y_i", b * v, blocks) + wide.key_matvec(s, "A yp", b, blocks)
           + g(fwd, "a2 y_i", b * v * s.l) + g(inv, "u", b * s.l)
           + [("K4", "challenge", k4_bound(b, n))]
           + wide.d_times(s, "zs", b, b * v * s.k, resp)
           + wide.d_times(s, "zp", b, b * s.k, resp)
           + g(fwd, "gs, verify", b * v)
           + wide.key_matvec(s, "A z_i", b * v, blocks) + wide.key_matvec(s, "A zp", b, blocks)
           + wide.d_times(s, "t_i + c1_i d", b, b * v * s.n, ver)
           + wide.d_times(s, "tp + c1p d", b, b * s.n, ver)
           + g(fwd, "a2 z_i", b * v * s.l) + g(inv, "relation's lhs", b * s.l)
           + g(fwd, "c2_i", b * v * s.l) + g(inv, "relation's gc2", b * s.l)
           + wide.d_times(s, "relation's d term", b, b * s.l, ver))
    return [(k, what, ms) for k, what, (ms, _) in out]
