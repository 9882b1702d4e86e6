"""Share of the program's device time (the traced window's, less the
benchmark's own) that runs outside every op range of the program
(``spans.OPS``): work under a phase range alone, or under none. Nothing
to read when the trace holds no op range."""

from zkbench.spans import OPS, own_ms


def read(obs):
    t = obs.trace
    if t is None:
        return None
    program = t.device_ms - t.kinds.get("harness", 0.0)
    held = own_ms(t, OPS)
    if held is None or program <= 0:
        return None
    return 100.0 * (program - held) / program
