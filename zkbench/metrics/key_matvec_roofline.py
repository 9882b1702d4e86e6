"""The key matvec against its roofline, whatever implements it: the least
time of a batch's K3 and K6 work (``roofline/<protocol>.py``, by the
frozen bound functions against published H100 peaks) times the traced
batches, over the device time under the program's ``…/key_matvec`` ranges
(nested ranges included). Nothing to read without those ranges."""

from zkbench.spans import nested_ms

KERNELS = ("K3", "K6")


def read(obs):
    t = obs.trace
    if t is None:
        return None
    spent = nested_ms(t, ("key_matvec",))
    least = sum(ms for k, _, ms in obs.work if k in KERNELS)
    if not spent or least <= 0:
        return None
    return 100.0 * t.batches * least / spent
