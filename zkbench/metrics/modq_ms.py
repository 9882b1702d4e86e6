"""Device ms a batch under the program's centred mod-q ranges (``…/modq``:
``ops/zq.add_centered``, ``sub_centered`` and their ``ops/mat`` forms,
and ``mat.poly_equal``, the equality checks), from the traced window."""

from zkbench.spans import per_batch


def read(obs):
    return per_batch(obs.trace, ("modq",))
