"""Device ms a batch under the proof's commit range (COMMIT_RANGE of
the cell's drivers/ module, ranges nested in it included), from the traced window."""


def read(obs):
    t = obs.trace
    if t is None:
        return None
    ms = t.nested_ms(obs.driver.COMMIT_RANGE)
    return ms / t.batches if ms > 0 else None
