"""The op ranges (``ringzk_tpu_torch.utils.profiling.OPS``) that each
proof's round trip records, under the qualified names the phases give
them (``open_proof/verify/key_matvec``): the phase-level ops of the table
in PERF.md. Shared by the CPU profiling tests and the card's."""

from __future__ import annotations

# The op ranges each proof's phases run, by the phase each is recorded under.
PHASE_OPS = {
    "commit_scheme/commit": ("sample", "key_matvec", "modq"),
    "commit_scheme/verify": ("norm", "modq"),
    "{p}_proof/commit": ("sample", "key_matvec"),
    "{p}_proof/generate_challenge": ("challenge",),
    "{p}_proof/create_response": ("scalar_mul_add",),
    "{p}_proof/verify": ("norm", "key_matvec", "scalar_mul_add", "modq"),
}
# linear and sum also run the g products in both commit and verify
G_OPS = ("ntt_fwd", "pointwise", "ntt_inv", "modq")
# SpRing's own transforms and t + d m carry no op range
SP_BARE = ("ntt_fwd", "ntt_inv", "scalar_mul_add")


def phase_names(proto: str) -> set:
    """The six phase ranges of one round trip of ``proto``."""
    return {f"{proto}_proof/{p}" for p in ("commit", "generate_challenge", "create_response",
                                            "verify")} | {"commit_scheme/commit",
                                                          "commit_scheme/verify"}


def want_op_names(proto: str, path: str) -> set:
    """The op ranges a round trip of ``proto`` on ``path`` ("roundtrip",
    "chained", "api" or "sp") records at the phase level. Ops nested in an
    op (K5's plain version calls ``pointwise`` and ``modq``) are not
    listed: where they appear depends on the kernel that runs."""
    want = set()
    for phase, ops in PHASE_OPS.items():
        if phase == "commit_scheme/verify" and path == "api":
            continue
        if proto != "open" and phase.endswith(("_proof/commit", "_proof/verify")):
            ops = ops + G_OPS
        want |= {f"{phase.format(p=proto)}/{op}" for op in ops}
    if path == "sp":
        want = {n for n in want if n.rsplit("/", 1)[1] not in SP_BARE}
        if proto == "sum":   # sum_to_centered carries ntt_inv on every ring
            want |= {"sum_proof/commit/ntt_inv", "sum_proof/verify/ntt_inv"}
    return want
