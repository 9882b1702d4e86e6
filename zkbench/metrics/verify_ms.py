"""Device ms a batch under the opening checks' and the proof's verify
ranges (VERIFY_RANGES of the cell's drivers/ module, nested ranges included), from the
traced window."""


def read(obs):
    t = obs.trace
    if t is None:
        return None
    ms = sum(t.nested_ms(r) for r in obs.driver.VERIFY_RANGES)
    return ms / t.batches if ms > 0 else None
