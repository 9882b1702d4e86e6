"""The port's kernels K1-K8 against their roofline: the least time of the
work one batch gives them (``roofline/<protocol>.py``, by the frozen
bound functions against published H100 peaks) times the traced batches,
over those kernels' device time in the traced window. Nothing to read
when the trace holds none of their time."""

KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8")


def read(obs):
    t = obs.trace
    if t is None:
        return None
    spent = sum(t.kinds.get(k, 0.0) for k in KERNELS)
    if spent <= 0:
        return None
    return 100.0 * t.batches * sum(ms for k, _, ms in obs.work if k in KERNELS) / spent
