"""Verified proofs over the whole measured window: every proof whose
verify and opening verdicts were both true, over the time from the first
launch to the last batch's synchronised verdicts (all ranks' proofs in a
multi-card cell, on rank 0's clock)."""


def read(obs):
    return obs.verified / obs.elapsed_s if obs.elapsed_s > 0 and obs.verified else None
