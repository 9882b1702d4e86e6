"""The kernel work of one opening-proof round trip of B proofs at degree
N on a narrow ring, counted from the protocol's shapes.

Each entry is (kernel, what, least ms) by the frozen bound functions: the
key matvecs A r (two row blocks, one digit: |r| <= b), a1 y and a1 z
(their digits from the mask and verify bounds), the challenge selection,
and the two products t + d m (the response at one prime, the verify's
t + c1 d at two), as the port launches them at this commit: K3 at N = 512,
K6 above (ringzk_tpu_torch/protocols/{commit,open}.py).
"""

from __future__ import annotations

from .bounds import digits_for_bound, k4_bound, k5_bound, matvec_bound


def work(scheme, batch: int, vl: int = 0) -> list:
    s = scheme
    matvec = "K3" if s.n_deg <= 512 else "K6"
    kn, n = s.k * s.n_deg, s.n_deg
    out = [(matvec, "A r, a1 rows", matvec_bound(batch, kn, s.n * n, digits_for_bound(s.b))),
           (matvec, "A r, a2 rows", matvec_bound(batch, kn, s.l * n, digits_for_bound(s.b))),
           (matvec, "a1 y", matvec_bound(batch, kn, s.n * n, digits_for_bound(s.mask_bound))),
           (matvec, "a1 z", matvec_bound(batch, kn, s.n * n, digits_for_bound(s.verify_bound))),
           ("K4", "challenge", k4_bound(batch, n)),
           ("K5", "z = y + d r", k5_bound(batch, s.k, 1, n)),
           ("K5", "t + c1 d", k5_bound(batch, s.n, 2, n))]
    return [(k, what, ms) for k, what, (ms, _) in out]
