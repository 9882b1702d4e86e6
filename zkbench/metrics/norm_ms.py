"""Device ms a batch under the program's norm ranges (``…/norm``:
``ops/norms.norm2_leq``, the exact l2 bound checks of r and z), from the
traced window."""

from zkbench.spans import per_batch


def read(obs):
    return per_batch(obs.trace, ("norm",))
