"""The kernel work of one sum-proof round trip of B proofs over V
summands at degree N on a narrow ring, counted from the protocol's shapes.

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

from .bounds import digits_for_bound, k1_bound, k2_bound, k4_bound, k5_bound, matvec_bound

PRIMES_G = 3   # the g products' CRT primes on the default ring


def work(scheme, batch: int, vl: int) -> list:
    s = scheme
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
