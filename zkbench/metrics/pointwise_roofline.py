"""The NTT-domain pointwise products against their roofline, whatever
implements them: the least time of a batch's pointwise work
(``roofline/pointwise.py``: the open round trip's products and
accumulates on a wide ring, by the frozen bound against published H100
peaks) times the traced batches, over the device time under the
program's ``…/pointwise`` ranges (each range's own). Nothing to read
without those ranges, on a narrow ring, or for a protocol it does not
count."""

from zkbench.reference.common import Scheme
from zkbench.roofline import pointwise
from zkbench.spans import own_ms


def read(obs):
    t = obs.trace
    if t is None or obs.driver.PROTOCOL not in pointwise.PROTOCOLS:
        return None
    batch = obs.cell.traffic["batch"] // obs.world
    least = sum(ms for _, ms, _ in pointwise.work(Scheme.of(obs.cell.cfg), batch))
    spent = own_ms(t, ("pointwise",))
    if not spent or least <= 0:
        return None
    return 100.0 * t.batches * least / spent
