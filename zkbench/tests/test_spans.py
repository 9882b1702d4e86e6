"""The readers of the program's op ranges (``metrics/{key_matvec_ms,
key_matvec_roofline,norm_ms,modq_ms,pointwise_ms,sample_ms,
unranged_pct}.py``) on a synthetic traced window, against values worked
out by hand; and nothing read where the window holds none of their
ranges, as from a program that records none."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from zkbench import core
from zkbench.trace import Trace

READERS = ("key_matvec_ms", "key_matvec_roofline", "norm_ms", "modq_ms", "pointwise_ms",
           "sample_ms", "unranged_pct")
# own device ms over a window of 2 batches, by recorded range name
RANGES = {
    "open_proof/commit": 2.0, "commit_scheme/commit": 1.0,
    "commit_scheme/commit/key_matvec": 10.0, "commit_scheme/commit/sample": 3.0,
    "commit_scheme/commit/modq": 4.0, "open_proof/commit/key_matvec": 6.0,
    "open_proof/generate_challenge/challenge": 1.0, "open_proof/verify/norm": 5.0,
    "open_proof/verify/key_matvec": 8.0, "open_proof/verify/key_matvec/ntt_fwd": 2.0,
    "open_proof/verify/modq": 2.0, "sum_proof/verify/pointwise": 7.0,
}
PHASES = {"open_proof/roundtrip": None, "open_proof/commit": "open_proof/roundtrip",
          "commit_scheme/commit": "open_proof/commit",
          "open_proof/generate_challenge": "open_proof/roundtrip",
          "open_proof/verify": "open_proof/roundtrip", "sum_proof/verify": None}
# the program's device ms is 60 (65 less the harness's 5); 48 of it under op ranges
KINDS = {"K3": 20.0, "other": 40.0, "harness": 5.0}
WORK = [("K3", "A r", 1.5), ("K3", "a1 y", 1.0), ("K5", "t + c1 d", 9.0), ("K6", "a1 z", 0.1)]


def reader(name):
    return core.load_module(core.HERE / "metrics" / f"{name}.py", f"metrics.{name}")


def trace(ranges: dict, parents: dict, kinds: dict = KINDS) -> Trace:
    return Trace(batches=2, window_s=0.1, busy_s=0.09, kinds=dict(kinds), ranges=dict(ranges),
                 parents=dict(parents))


def obs(t):
    return SimpleNamespace(trace=t, work=WORK)


def op_parents(ranges: dict) -> dict:
    """Each op range under the name it was recorded beneath, as
    ``profiling.range_parents`` gives them; the phases as PHASES."""
    out = dict(PHASES)
    for name in ranges:
        if name not in out:
            out[name] = name.rpartition("/")[0] or None
    return out


@pytest.mark.parametrize("name,want", [
    ("key_matvec_ms", (10 + 6 + 8 + 2) / 2),          # nested ntt_fwd included
    ("key_matvec_roofline", 100 * 2 * (1.5 + 1.0 + 0.1) / 26),
    ("norm_ms", 5 / 2),
    ("modq_ms", (4 + 2) / 2),
    ("pointwise_ms", 7 / 2),
    ("sample_ms", (3 + 1) / 2),                        # the sampler's and the challenge's
    ("unranged_pct", 100 * (60 - 48) / 60),
])
def test_reader_on_a_synthetic_window(name, want):
    assert reader(name).read(obs(trace(RANGES, op_parents(RANGES)))) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_without_op_ranges(name):
    """The phase ranges alone (a program that records no op range), an
    untraced run, and a window whose ranges hold no device time."""
    phases = {k: v for k, v in RANGES.items() if k in PHASES}
    assert reader(name).read(obs(trace(phases, PHASES))) is None
    assert reader(name).read(obs(None)) is None
    assert reader(name).read(obs(trace({}, {}, {"other": 1.0}))) is None


def test_one_reader_absent_while_the_rest_read():
    """pointwise_ms finds nothing in a window with no pointwise range (the
    open cells), while the others still read."""
    ranges = {k: v for k, v in RANGES.items() if not k.endswith("/pointwise")}
    o = obs(trace(ranges, op_parents(ranges)))
    assert reader("pointwise_ms").read(o) is None
    assert reader("norm_ms").read(o) == pytest.approx(2.5)
    assert reader("unranged_pct").read(o) == pytest.approx(100 * (60 - 41) / 60)


def test_roofline_reads_nothing_without_matvec_kernel_work():
    """A protocol whose work lists no K3 or K6 (the NTT path) gives the
    key matvec no bound to hold it to."""
    o = SimpleNamespace(trace=trace(RANGES, op_parents(RANGES)),
                        work=[("K5", "t + c1 d", 9.0)])
    assert reader("key_matvec_roofline").read(o) is None
