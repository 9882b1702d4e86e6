"""Plain reference of the opening proof's round trip (ring-zk
src/prove/open.rs), row by row.

``check`` takes what one sampled proof's round trip produced (the message
it opened, its opening r, its commitment c, the verifier's c1, t and d,
the challenge sampler's keys and signs, the response z and both
verdicts) and works out again, exactly, what each must be: c = [a1; a2]
r + [0; x], t = a1 y with y = z - d r recovered and held to the mask
bound, d the signs at the kappa lanes of the largest keys (K4's
selection), and each verdict
(||z_i|| <= 2 sigma sqrt(N) and a1 z = t + c1 d; ||r_i|| <= 4 sigma
sqrt(N) and the commitment equation). ``produce`` is the reference in the
program's place, used by the control: the round trip of sampled rows
from its own draws, in the arithmetic it is given.
"""

from __future__ import annotations

import torch

from .common import Arith, Scheme, is_challenge, norms_ok, same, select_challenge, within

# the tensors a sampled proof contributes, by name, with their row shapes
FIELDS = ("x_in", "x", "r", "c", "c1", "t", "keys", "signs", "d", "z")


def verdict(s: Scheme, ar: Arith, a1, z, c1, t, d) -> torch.Tensor:
    """The verifier's verdict on rows: z [R, k, N], c1 and t [R, n, N]."""
    lhs = ar.key(a1, z)
    rhs = ar.add(t, ar.mul(d[:, None, :], c1))
    return norms_ok(z, s.verify_bound) & same(lhs, rhs)


def opening(s: Scheme, ar: Arith, a, x, r, c) -> torch.Tensor:
    """The opening check on rows: c [R, n+l, N], x [R, l, N], r [R, k, N]."""
    pad = torch.zeros((x.shape[0], s.n, s.n_deg), dtype=torch.int64, device=x.device)
    want = ar.add(ar.key(a, r), torch.cat([pad, x.to(torch.int64)], dim=1))
    return norms_ok(r, s.commit_bound) & same(c, want)


def check(s: Scheme, rows: dict, a1, a2, ar: Arith) -> dict:
    """{check name: bool [R], True where the row's output differs from the
    reference's; the verdicts are ``verdicts``'s."""
    a = torch.cat([a1, a2], dim=0)
    r, z, d = (rows[k].to(torch.int64) for k in ("r", "z", "d"))
    y = z - ar.mul(d[:, None, :], r)              # |d r| <= kappa b: exact when centered
    pad = torch.zeros((r.shape[0], s.n, s.n_deg), dtype=torch.int64, device=r.device)
    c_want = ar.add(ar.key(a, r), torch.cat([pad, rows["x"].to(torch.int64)], dim=1))
    return {
        "message": ~same(rows["x"], rows["x_in"]),
        "opening_draw": ~within(r, s.b),
        "commitment": ~same(rows["c"], c_want),
        "context": ~same(rows["c1"], rows["c"][:, :s.n]),
        "challenge": ~(is_challenge(s, d) & same(d, select_challenge(s, rows["keys"],
                                                                     rows["signs"]))),
        "mask": ~within(y, s.mask_bound),
        "first_message": ~same(rows["t"], ar.key(a1, y)),
    }


def verdicts(s: Scheme, rows: dict, a1, a2, ar: Arith):
    """(the verifier's verdict, the opening check's) on the rows, as the
    reference gives them."""
    a = torch.cat([a1, a2], dim=0)
    return (reverify(s, rows, a1, a2, ar),
            opening(s, ar, a, rows["x"], rows["r"].to(torch.int64), rows["c"]))


def challenge_draws(s: Scheme, rows: int, gen: torch.Generator, dev) -> tuple:
    """The challenge sampler's draws for ``rows`` proofs: uint32 keys and
    +-1 signs, [rows, N] each."""
    keys = torch.randint(0, 2**32, (rows, s.n_deg), generator=gen, device=dev)
    signs = 2 * torch.randint(0, 2, (rows, s.n_deg), generator=gen, device=dev) - 1
    return keys, signs


def produce(s: Scheme, x: torch.Tensor, a1, a2, ar: Arith, gen: torch.Generator) -> dict:
    """One round trip of the rows x [R, l, N], drawn from ``gen``, computed
    in ``ar``: the fields ``check`` reads."""
    a = torch.cat([a1, a2], dim=0)
    rr, dev = x.shape[0], x.device
    r = torch.randint(-s.b, s.b + 1, (rr, s.k, s.n_deg), generator=gen, device=dev)
    y = torch.randn((rr, s.k, s.n_deg), generator=gen, device=dev, dtype=torch.float32)
    y = torch.clamp(torch.trunc(y * s.sigma).to(torch.int64), -s.mask_bound, s.mask_bound)
    keys, signs = challenge_draws(s, rr, gen, dev)
    d = select_challenge(s, keys, signs)
    pad = torch.zeros((rr, s.n, s.n_deg), dtype=torch.int64, device=dev)
    c = ar.add(ar.key(a, r), torch.cat([pad, x.to(torch.int64)], dim=1))
    c1 = c[:, :s.n]
    t = ar.key(a1, y)
    z = y + ar.mul(d[:, None, :], r)
    return {"x_in": x, "x": x, "r": r, "c": c, "c1": c1, "t": t, "keys": keys, "signs": signs,
            "d": d, "z": z,
            "ok": verdict(s, ar, a1, z, c1, t, d), "op": opening(s, ar, a, x, r, c)}


def reverify(s: Scheme, rows: dict, a1, a2, ar: Arith) -> torch.Tensor:
    """The reference's verdict on (possibly tampered) rows."""
    return verdict(s, ar, a1, rows["z"].to(torch.int64), rows["c1"], rows["t"],
                   rows["d"].to(torch.int64))

