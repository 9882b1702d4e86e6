"""Device ms a batch under the program's key matvec ranges
(``…/key_matvec``: ``protocols/commit.matvec_key``, its kernel K3 or K6,
the clamp, the digit split and fold or the NTT path), the ranges nested in
them included, from the traced window."""

from zkbench.spans import per_batch


def read(obs):
    return per_batch(obs.trace, ("key_matvec",), nested=True)
