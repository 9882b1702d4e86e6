"""Opening-proof traffic on one card: each batch is one call of
``ringzk_tpu_torch.protocols.open.roundtrip`` on B messages from the pool
(the commits, their opening checks, the challenge, the response, the
verify), at the mix's chain count.

The benchmark makes the messages [B, l, N], uniform in [-q, q] on the
card, from the seed (``core.uniform``: int32, int64 on wide rings). Its
taps keep the sampled rows of what the round trip hands its opening check
(c, x, r), the challenge sampler's draws that K4 selects from (keys,
signs) and its verifier (z, c1, t, d); on wide rings the forged copies
include one whose first z coefficient is -2^63.
"""

from __future__ import annotations

import sys
from types import SimpleNamespace

import torch

from zkbench import core

PROTOCOL = "open"
COMMIT_RANGE = "open_proof/commit"
VERIFY_RANGES = ("commit_scheme/verify", "open_proof/verify")
VERDICTS = ("ok", "op")


def make_inputs(params, n_deg: int, traffic: dict, batch: int, gen, device) -> tuple:
    return (core.uniform(gen, params.q, (batch, params.l, n_deg), device),)


def input_fields(rows: tuple) -> dict:
    return {"x_in": rows[0]}


def setup(ck, params, gen, traffic, dist, device):
    from ringzk_tpu_torch.protocols import commit as commit_mod
    from ringzk_tpu_torch.protocols import open as open_mod

    return SimpleNamespace(ck=ck, params=params, gen=gen, chains=traffic["chains"],
                           mods=(commit_mod, open_mod), verify=open_mod.verify, dist=dist)


def local(st, inputs: tuple) -> tuple:
    return inputs


def tap_challenge(tap):
    """Wrap the challenge sampler's draws (``ops.sampling.challenge_draws``,
    which ``sampling.challenge`` looks up when it draws d for K4) so that
    the tap keeps the sampled rows' keys and signs; returns the function
    that puts it back."""
    from ringzk_tpu_torch.ops import sampling

    orig = sampling.challenge_draws

    def draws(gen, shape, n, device):
        signs, u = orig(gen, shape, n, device)
        tap.grab(keys=u, signs=signs)
        return signs, u

    sampling.challenge_draws = draws

    def restore():
        sampling.challenge_draws = orig

    return restore


def install(tap, st):
    """Wrap the opening check, the challenge's draws and the verifier the
    round trip calls; returns the function that puts them back."""
    commit_mod, open_mod = st.mods
    orig_check, orig_verify = commit_mod.verify, open_mod.verify
    undo_draws = tap_challenge(tap)

    def check(ck, com, opening, params, **kw):
        tap.grab(c=com.c, x=opening.x, r=opening.r)
        return orig_check(ck, com, opening, params, **kw)

    def verify(ck, resp, vctx, params):
        tap.grab(z=resp.z, c1=vctx.c1, t=vctx.t, d=vctx.d)
        return orig_verify(ck, resp, vctx, params)

    commit_mod.verify, open_mod.verify = check, verify

    def restore():
        commit_mod.verify, open_mod.verify = orig_check, orig_verify
        undo_draws()

    return restore


def call(st, inputs: tuple):
    _, open_mod = st.mods
    return open_mod.roundtrip(st.gen, st.ck, inputs[0], st.params, chains=st.chains)


def verified(ret) -> torch.Tensor:
    ok, op = ret
    return ok & op


def verdict_fields(ret) -> dict:
    ok, op = ret
    return {"ok": ok, "op": op}


def sync(ret) -> None:
    core.sync_device(ret[0].device)


def tampered(st, rows: dict) -> dict:
    """The program's verdicts on the forged and norm-violating copies of
    the sampled responses: {name: (verdicts, the fields replaced)}."""
    from ringzk_tpu_torch.protocols.open import OpenProofResponse, OpenProofVerificationContext

    from zkbench.tamper import tampered as copies

    n_deg = rows["z"].shape[-1]
    resp = OpenProofResponse(z=core.response_rows(st.params, rows["z"]))
    vctx = OpenProofVerificationContext(c1=rows["c1"].contiguous(), t=rows["t"].contiguous(),
                                        d=rows["d"].contiguous())
    out = {}
    for name, bad in copies("open", resp, st.params.verify_bound(n_deg) + 1,
                            core.is_wide(st.params)).items():
        out[name] = (st.verify(st.ck, bad, vctx, st.params), {"z": bad.z})
    return out


def extra_checks(st, win) -> dict:
    return {}


def run(ctx):
    return core.single(ctx, sys.modules[__name__])
