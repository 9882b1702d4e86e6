"""What the per-layer readers of the program's op ranges take from a
traced window (``trace.Trace``): device ms by range name over the ranges
whose recorded name ends in an op.

The program records an op range as ``<the range it ran in>/<op>``
(``open_proof/verify/key_matvec``), or as just ``<op>`` outside every
range; a name with a ``/`` that ends in no op is a phase's. OPS is the
list of ops as of the commit that added these readers, frozen here: the
yardstick stays what it is when the program changes. Where the trace holds
no op range at all (a program without them), every reader finds nothing.
"""

from __future__ import annotations

OPS = ("key_matvec", "ntt_fwd", "ntt_inv", "pointwise", "scalar_mul_add", "challenge",
       "sample", "norm", "modq")


def leaf(name: str) -> str:
    return name.rpartition("/")[2]


def names(trace, ops) -> list:
    """Every range name of the trace that ends in one of ``ops``: those
    that ran device work and those that only held ranges that did."""
    return sorted(n for n in set(trace.ranges) | set(trace.parents) if leaf(n) in ops)


def own_ms(trace, ops) -> float | None:
    """Device ms of the work under the ranges that end in ``ops``, each
    range's own (the ranges nested in them left out), summed over the
    window; None when the trace holds no such range."""
    found = names(trace, ops)
    return sum(trace.ranges.get(n, 0.0) for n in found) if found else None


def nested_ms(trace, ops) -> float | None:
    """As :func:`own_ms`, with the ranges nested in each one included."""
    found = names(trace, ops)
    return sum(trace.nested_ms(n) for n in found) if found else None


def per_batch(trace, ops, nested: bool = False) -> float | None:
    """Device ms a batch under the ranges that end in ``ops``; None when
    the trace holds none of them or no time under them."""
    if trace is None:
        return None
    ms = (nested_ms if nested else own_ms)(trace, ops)
    return ms / trace.batches if ms else None
