"""The wide ring's transforms against their roofline, whatever implements
them: the least time of a batch's K7 and K8 work (``roofline/<protocol>.py``
on ``roofline/wide.py``, by the frozen bound functions against published
H100 peaks) times the traced batches, over the device time under the
program's ``…/ntt_fwd`` and ``…/ntt_inv`` ranges (each range's own: K7, K8
and the plain conversions beside them). Nothing to read without those
ranges or where the work lists no K7 or K8 (a narrow ring)."""

from zkbench.spans import own_ms

KERNELS = ("K7", "K8")


def read(obs):
    t = obs.trace
    if t is None:
        return None
    spent = own_ms(t, ("ntt_fwd", "ntt_inv"))
    least = sum(ms for k, _, ms in obs.work if k in KERNELS)
    if not spent or least <= 0:
        return None
    return 100.0 * t.batches * least / spent
