"""Share of the traced window's device time in work that is none of the
port's kernels K1-K11 (by the frozen kernel names), no collective and not
the benchmark's own: the plain torch passes of the ring algebra."""


def read(obs):
    t = obs.trace
    if t is None or t.device_ms <= 0:
        return None
    return 100.0 * t.kinds.get("other", 0.0) / t.device_ms
