"""The kernel work of one opening-proof round trip of B proofs at degree
N, counted from the protocol's shapes; on a wide ring ``wide_work``.

Each entry is (kernel, what, least ms) by the frozen bound functions: the
key matvecs A r (two row blocks, one digit: |r| <= b), a1 y and a1 z
(their digits from the mask and verify bounds), the challenge selection,
and the two products t + d m (the response at one prime, the verify's
t + c1 d at two), as the port launches them at this commit: K3 at N = 512,
K6 above (ringzk_tpu_torch/protocols/{commit,open}.py).
"""

from __future__ import annotations

from . import wide
from .bounds import digits_for_bound, k4_bound, k5_bound, matvec_bound


def work(scheme, batch: int, vl: int = 0) -> list:
    s = scheme
    if wide.is_wide(s):
        return wide_work(s, batch)
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


def wide_work(scheme, batch: int) -> list:
    """On a wide ring (``protocols/{commit,open}.py`` on ``ops/ntt.py``'s
    wide path): the key matvecs A r, a1 y and a1 z each as K7 of v and a K8
    a row block; the challenge; z = y + d r and the verify's t + c1 d each
    as K7 of d and of m and a K8, at their primes."""
    s, b = scheme, batch
    blocks = (("a1", s.n), ("a2", s.l))
    resp, ver = wide.d_primes(s)
    out = (wide.key_matvec(s, "A r", b, blocks)
           + wide.key_matvec(s, "a1 y", b, blocks[:1])
           + [("K4", "challenge", k4_bound(b, s.n_deg))]
           + wide.d_times(s, "z = y + d r", b, b * s.k, resp)
           + wide.key_matvec(s, "a1 z", b, blocks[:1])
           + wide.d_times(s, "t + c1 d", b, b * s.n, ver))
    return [(k, what, ms) for k, what, (ms, _) in out]
