"""The port's timing helpers (``ringzk_tpu_torch/utils/benchtime.py``)
against the JAX package's ``utils/benchtime.py``: the three checks of
tests/test_benchtime.py on torch tensors, the same records from the same
window times, and the same fingerprint keys."""

from typing import NamedTuple

import pytest
import torch

from ringzk_tpu.utils import benchtime as jbenchtime
from ringzk_tpu_torch.utils import benchtime


class Pair(NamedTuple):
    ok: torch.Tensor
    count: int


def test_timed_row_and_windows_record():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    dt, dts = benchtime.timed_row(fn, (torch.ones(4),), iters=2, windows=3)
    # first call + warmup(3) + 3 windows x 2 iters
    assert len(calls) == 1 + 3 + 6
    assert dts == sorted(dts) and dt == dts[1]
    rec = benchtime.windows_record(100, dt, dts)
    assert set(rec) == {"min", "median", "max"}
    assert rec["min"] <= rec["median"] <= rec["max"]
    assert rec["median"] == round(100 / dt, 1)


def test_fetch_forced_pass_orders_and_annotates():
    def fn(x):
        return x * 2

    recs = [({}, fn, (torch.ones(3),), 10), ({}, fn, (torch.ones(3),), 20)]
    benchtime.fetch_forced_pass(recs, iters=1)
    assert recs[0][0]["ff_order"] == 0 and recs[1][0]["ff_order"] == 1
    assert recs[0][0]["fetch_forced"] > 0 and recs[1][0]["fetch_forced"] > 0


def test_engine_fingerprint_shape(monkeypatch):
    monkeypatch.setenv("RINGZK_TESTFLAG", "1")
    fp = benchtime.engine_fingerprint()
    assert fp["flags"].get("RINGZK_TESTFLAG") == "1"
    assert set(fp) == set(jbenchtime.engine_fingerprint())
    assert fp["platform"] == "cpu" and fp["prng"] == "mt19937" and fp["device"] == "cpu"
    assert fp["flags"] == jbenchtime.engine_fingerprint()["flags"]


@pytest.mark.parametrize("dts", [[0.001, 0.002, 0.004], [1.5e-5, 1.7e-5, 2.0e-5, 2.1e-5, 9e-5],
                                 [0.3]])
def test_windows_record_equals_jax(dts):
    median = dts[len(dts) // 2]
    for batch in (1, 131072, 49152):
        assert (benchtime.windows_record(batch, median, dts)
                == jbenchtime.windows_record(batch, median, dts))


def test_fetch_forced_pass_equals_jax(monkeypatch):
    """The same window times give the same records."""
    dts = iter([0.002, 0.0031, 0.002, 0.0031])
    monkeypatch.setattr(benchtime, "fetch_forced_dt", lambda fn, args, iters: next(dts))
    monkeypatch.setattr(jbenchtime, "fetch_forced_dt", lambda fn, args, iters: next(dts))
    ours = [({"median": 1.0}, None, (), 131072), ({}, None, (), 24576)]
    theirs = [({"median": 1.0}, None, (), 131072), ({}, None, (), 24576)]
    benchtime.fetch_forced_pass(ours, iters=3)
    jbenchtime.fetch_forced_pass(theirs, iters=3)
    assert [r[0] for r in ours] == [r[0] for r in theirs]


def test_timed_row_walks_named_tuples():
    """Results that are (nested) NamedTuples and tuples are waited for and
    fetched through their first tensor."""
    calls = []

    def fn(x):
        calls.append(1)
        return (Pair(ok=x > 0, count=3), x)

    dt, dts = benchtime.timed_row(fn, (torch.arange(4),), iters=1, windows=5, warmup=0)
    assert len(calls) == 1 + 0 + 5 and len(dts) == 5 and dt == dts[2]
    assert next(benchtime._tensors(fn(torch.arange(2)))).dtype == torch.bool
    assert benchtime.fetch_forced_dt(fn, (torch.arange(4),), iters=2) > 0
