"""Share of the traced window (host wall, after a spin) in which no
operation ran on the card (rank 0's card in a multi-card cell)."""


def read(obs):
    t = obs.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)
