"""Plain reference of the sum proof's round trip (ring-zk
src/prove/sum.rs), row by row: x' = sum_i g_i x_i over V summands.

``check`` takes what one sampled proof's round trip produced and works
out again, exactly: the committed sum xp = sum_i g_i x_i (the g
products), every commitment [a1; a2] r + [0; x], the masks y_i = z_i -
d r_i and yp = zp - d rp held to their bound, t_i = a1 y_i, tp = a1 yp,
u = sum_i g_i (a2 y_i) - a2 yp, the challenge selected from the
sampler's keys and signs (K4), and both verdicts: the
norms of every z, a1 z_i = t_i + c1_i d, a1 zp = tp + c1p d and
sum_i g_i (a2 z_i) - a2 zp = (sum_i g_i c2_i - c2p) d + u; the openings'
norms and equations. ``produce`` is the reference in the program's place,
used by the control.
"""

from __future__ import annotations

import torch

from .common import Arith, Scheme, is_challenge, norms_ok, same, select_challenge, within
from .open import challenge_draws, opening

FIELDS = ("x_in", "g_in", "xs", "rs", "cs", "xp", "rp", "cp", "gs", "c1s", "c2s", "c1p",
          "c2p", "ts", "tp", "u", "keys", "signs", "d", "zs", "zp")


def g_sum(ar: Arith, gs, vs):
    """sum_i g_i v_i: gs [R, V, N], vs [R, V, rows, N] -> [R, rows, N],
    added mod q one summand at a time (V centered residues of a modulus
    near 2^63 would overflow int64 if summed first)."""
    prod = ar.mul(gs[:, :, None, :], vs)
    out = prod[:, 0]
    for i in range(1, prod.shape[1]):
        out = ar.add(out, prod[:, i])
    return out


def verdict(s: Scheme, ar: Arith, a1, a2, rows: dict) -> torch.Tensor:
    zs, zp, d = (rows[k].to(torch.int64) for k in ("zs", "zp", "d"))
    gs = rows["gs"].to(torch.int64)
    rr, v = zs.shape[:2]
    ok = norms_ok(zs, s.verify_bound) & norms_ok(zp, s.verify_bound)
    eq1 = same(ar.key(a1, zs).reshape(rr, -1),
               ar.add(rows["ts"], ar.mul(d[:, None, None, :], rows["c1s"])).reshape(rr, -1))
    eq2 = same(ar.key(a1, zp), ar.add(rows["tp"], ar.mul(d[:, None, :], rows["c1p"])))
    lhs = ar.sub(g_sum(ar, gs, ar.key(a2, zs)), ar.key(a2, zp))
    gc2 = ar.sub(g_sum(ar, gs, rows["c2s"].to(torch.int64)), rows["c2p"])
    eq3 = same(lhs, ar.add(ar.mul(d[:, None, :], gc2), rows["u"]))
    return ok & eq1 & eq2 & eq3


def openings(s: Scheme, ar: Arith, a, rows: dict) -> torch.Tensor:
    rr, v = rows["xs"].shape[:2]
    flat = {k: rows[k].reshape((rr * v,) + tuple(rows[k].shape[2:])) for k in ("xs", "rs", "cs")}
    each = opening(s, ar, a, flat["xs"], flat["rs"].to(torch.int64), flat["cs"])
    return opening(s, ar, a, rows["xp"], rows["rp"].to(torch.int64), rows["cp"]) & \
        each.reshape(rr, v).all(-1)


def check(s: Scheme, rows: dict, a1, a2, ar: Arith) -> dict:
    """{check name: bool [R], True where the row's output differs from the
    reference's; the verdicts are ``verdicts``'s."""
    a = torch.cat([a1, a2], dim=0)
    rs, rp, zs, zp, d = (rows[k].to(torch.int64) for k in ("rs", "rp", "zs", "zp", "d"))
    gs = rows["gs"].to(torch.int64)
    rr = rs.shape[0]
    ys = zs - ar.mul(d[:, None, None, :], rs)
    yp = zp - ar.mul(d[:, None, :], rp)
    xp = g_sum(ar, gs, rows["xs"].to(torch.int64))

    def commit(x, r):
        pad = torch.zeros(tuple(x.shape[:-2]) + (s.n, s.n_deg), dtype=torch.int64,
                          device=x.device)
        return ar.add(ar.key(a, r), torch.cat([pad, x.to(torch.int64)], dim=-2))

    u = ar.sub(g_sum(ar, gs, ar.key(a2, ys)), ar.key(a2, yp))
    n = s.n
    return {
        "message": ~(same(rows["xs"], rows["x_in"]) & same(rows["gs"], rows["g_in"])),
        "sum_message": ~same(rows["xp"], xp),
        "opening_draw": ~(within(rs, s.b) & within(rp, s.b)),
        "commitment": ~(same(rows["cs"].reshape(rr, -1), commit(rows["xs"], rs).reshape(rr, -1))
                        & same(rows["cp"], commit(rows["xp"], rp))),
        "context": ~(same(rows["c1s"], rows["cs"][:, :, :n]) & same(rows["c2s"], rows["cs"][:, :, n:])
                     & same(rows["c1p"], rows["cp"][:, :n]) & same(rows["c2p"], rows["cp"][:, n:])),
        "challenge": ~(is_challenge(s, d) & same(d, select_challenge(s, rows["keys"],
                                                                     rows["signs"]))),
        "mask": ~(within(ys, s.mask_bound) & within(yp, s.mask_bound)),
        "first_message": ~(same(rows["ts"].reshape(rr, -1), ar.key(a1, ys).reshape(rr, -1))
                           & same(rows["tp"], ar.key(a1, yp)) & same(rows["u"], u)),
    }


def verdicts(s: Scheme, rows: dict, a1, a2, ar: Arith):
    """(the verifier's verdict, the opening checks') on the rows, as the
    reference gives them."""
    return verdict(s, ar, a1, a2, rows), openings(s, ar, torch.cat([a1, a2], dim=0), rows)


def produce(s: Scheme, inputs: tuple, a1, a2, ar: Arith, gen: torch.Generator) -> dict:
    """One round trip of the rows (gs [R, V, N], xs [R, V, l, N]), drawn
    from ``gen``, computed in ``ar``: the fields ``check`` reads."""
    gs, xs = (t.to(torch.int64) for t in inputs)
    a = torch.cat([a1, a2], dim=0)
    rr, v = xs.shape[:2]
    dev = xs.device

    def uniform(*shape):
        return torch.randint(-s.b, s.b + 1, shape, generator=gen, device=dev)

    def gauss(*shape):
        y = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return torch.clamp(torch.trunc(y * s.sigma).to(torch.int64), -s.mask_bound, s.mask_bound)

    def commit(x, r):
        pad = torch.zeros(tuple(x.shape[:-2]) + (s.n, s.n_deg), dtype=torch.int64, device=dev)
        return ar.add(ar.key(a, r), torch.cat([pad, x], dim=-2))

    xp = g_sum(ar, gs, xs)
    rp, rs = uniform(rr, s.k, s.n_deg), uniform(rr, v, s.k, s.n_deg)
    cp, cs = commit(xp, rp), commit(xs, rs)
    ys, yp = gauss(rr, v, s.k, s.n_deg), gauss(rr, s.k, s.n_deg)
    keys, signs = challenge_draws(s, rr, gen, dev)
    d = select_challenge(s, keys, signs)
    n = s.n
    rows = {"x_in": xs, "g_in": gs, "xs": xs, "rs": rs, "cs": cs, "xp": xp, "rp": rp, "cp": cp,
            "gs": gs, "c1s": cs[:, :, :n], "c2s": cs[:, :, n:], "c1p": cp[:, :n],
            "c2p": cp[:, n:], "ts": ar.key(a1, ys), "tp": ar.key(a1, yp),
            "u": ar.sub(g_sum(ar, gs, ar.key(a2, ys)), ar.key(a2, yp)), "keys": keys,
            "signs": signs, "d": d,
            "zs": ys + ar.mul(d[:, None, None, :], rs), "zp": yp + ar.mul(d[:, None, :], rp)}
    rows["ok"] = verdict(s, ar, a1, a2, rows)
    rows["op"] = openings(s, ar, a, rows)
    return rows


def reverify(s: Scheme, rows: dict, a1, a2, ar: Arith) -> torch.Tensor:
    """The reference's verdict on (possibly tampered) rows."""
    return verdict(s, ar, a1, a2, rows)
