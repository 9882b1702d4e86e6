"""Sum-proof traffic on one card: each batch is one call of
``ringzk_tpu_torch.protocols.sum.roundtrip`` on B statements from the
pool, x' = sum_i g_i x_i over V summands (the commits to x' and to every
x_i, their opening checks, the challenge, the responses, the verify), at
the mix's chain count.

The benchmark makes gs [B, V, N] and xs [B, V, l, N], uniform in [-q, q]
on the card, from the seed (``core.uniform``). Its taps keep the sampled
rows of what the round trip hands its opening checks (cp, xp, rp; cs, xs,
rs), the challenge sampler's draws (keys, signs) and its verifier (zs, zp
and the verifier's context).
"""

from __future__ import annotations

import sys
from types import SimpleNamespace

from zkbench import core

_open = core.load_module(core.HERE / "drivers" / "open.py", "drivers.open")

PROTOCOL = "sum"
COMMIT_RANGE = "sum_proof/commit"
VERIFY_RANGES = ("commit_scheme/verify", "sum_proof/verify")
VERDICTS = ("ok", "op")
CONTEXT = ("c1p", "c2p", "c1s", "c2s", "gs", "ts", "tp", "u", "d")

# as open's: the verdict pair, both kept; the batch stays on this card
local, verified, verdict_fields, sync, extra_checks = (
    _open.local, _open.verified, _open.verdict_fields, _open.sync, _open.extra_checks)


def make_inputs(params, n_deg: int, traffic: dict, batch: int, gen, device) -> tuple:
    vl = traffic["vl"]
    return (core.uniform(gen, params.q, (batch, vl, n_deg), device),
            core.uniform(gen, params.q, (batch, vl, params.l, n_deg), device))


def input_fields(rows: tuple) -> dict:
    return {"g_in": rows[0], "x_in": rows[1]}


def setup(ck, params, gen, traffic, dist, device):
    from ringzk_tpu_torch.protocols import commit as commit_mod
    from ringzk_tpu_torch.protocols import sum as sum_mod

    return SimpleNamespace(ck=ck, params=params, gen=gen, chains=traffic["chains"],
                           mods=(commit_mod, sum_mod), verify=sum_mod.verify, dist=dist)


def install(tap, st):
    """Wrap the opening checks, the challenge's draws and the verifier the
    round trip calls; returns the function that puts them back."""
    commit_mod, sum_mod = st.mods
    orig_check, orig_verify = commit_mod.verify, sum_mod.verify
    undo_draws = _open.tap_challenge(tap)

    def check(ck, com, opening, params, **kw):
        if com.c.dim() == 4:    # the V commitments, [B, V, n+l, N]
            tap.grab(cs=com.c, xs=opening.x, rs=opening.r)
        else:                   # the commitment to the sum
            tap.grab(cp=com.c, xp=opening.x, rp=opening.r)
        return orig_check(ck, com, opening, params, **kw)

    def verify(ck, resp, vctx, params):
        tap.grab(zs=resp.zs, zp=resp.zp, **{f: getattr(vctx, f) for f in CONTEXT})
        return orig_verify(ck, resp, vctx, params)

    commit_mod.verify, sum_mod.verify = check, verify

    def restore():
        commit_mod.verify, sum_mod.verify = orig_check, orig_verify
        undo_draws()

    return restore


def call(st, inputs: tuple):
    _, sum_mod = st.mods
    return sum_mod.roundtrip(st.gen, st.ck, inputs[0], inputs[1], st.params, chains=st.chains)


def tampered(st, rows: dict) -> dict:
    """The program's verdicts on the forged and norm-violating copies of
    the sampled responses: {name: (verdicts, the fields replaced)}."""
    from ringzk_tpu_torch.protocols.sum import SumProofResponse, SumProofVerificationContext

    from zkbench.tamper import tampered as copies

    n_deg = rows["zs"].shape[-1]
    resp = SumProofResponse(zp=core.response_rows(st.params, rows["zp"]),
                            zs=core.response_rows(st.params, rows["zs"]))
    vctx = SumProofVerificationContext(**{f: rows[f].contiguous() for f in CONTEXT})
    out = {}
    for name, bad in copies("sum", resp, st.params.verify_bound(n_deg) + 1,
                            core.is_wide(st.params)).items():
        out[name] = (st.verify(st.ck, bad, vctx, st.params), {"zs": bad.zs, "zp": bad.zp})
    return out


def run(ctx):
    return core.single(ctx, sys.modules[__name__])
