"""Device ms a batch under the program's pointwise ranges
(``…/pointwise``: ``RingContext.dot_hat``, ``mat.scalar_mul_hat`` and
``mat.matvec_hat``, the plain Montgomery products between transforms:
the g products), from the traced window."""

from zkbench.spans import per_batch


def read(obs):
    return per_batch(obs.trace, ("pointwise",))
