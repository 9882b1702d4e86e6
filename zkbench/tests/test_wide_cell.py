"""The wide ring's cell, ``open-q2e33-n1024-b49152`` (q = 2^33+9, N=1024,
B=49152): found at a small size without an edit, correct on the CPU, its
control and broken paths not; the pointwise work it counts equal to what a
round trip runs; and the two readers it adds, ``pointwise_roofline`` and
``ntt_roofline``, on a synthetic traced window."""

from __future__ import annotations

import collections
import math
from types import SimpleNamespace

import pytest
import torch

from zkbench import control, core
from zkbench.reference.common import Scheme
from zkbench.roofline import pointwise
from zkbench.roofline.bounds import HBM_BPS
from zkbench.trace import Trace

from .helpers import SMALL_B, SMALL_N, cpu_cell, driver, run_cpu
from .test_faults import FAULTS, _patch

CELL = "open-q2e33-n1024-b49152"
SPEC = core.load_spec()


def reader(name):
    return core.load_module(core.HERE / "metrics" / f"{name}.py", f"metrics.{name}")


def test_small_checkout_takes_the_cell_without_an_edit(small):
    """The configuration and the mix at N=64, B=8, all else as committed."""
    c = cpu_cell(CELL, small)
    full = core.find_cell(SPEC, CELL)
    assert (c.cfg["N"], c.traffic["batch"]) == (SMALL_N, SMALL_B)
    assert dict(c.cfg, N=full.cfg["N"]) == full.cfg
    assert dict(c.traffic, batch=full.traffic["batch"]) == full.traffic
    assert core.is_wide(core.params_of(c.cfg)) and full.cfg["params"]["modulus"] == 2**33 + 9


def test_cell_is_correct_on_the_cpu(small):
    line = run_cpu(CELL, small)
    checks = {k: v["value"] for k, v in line["checks"].items()}
    assert line["correct"], checks
    assert checks["rows_compared"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("wrap32", [True, False], ids=["control", "exact"])
def test_control_is_not_correct(small, wrap32):
    c = cpu_cell(CELL, small)
    dev = torch.device("cpu")
    rows, tampered, expected, (a1p, a2p), drv = control.control_rows(c, 2**31 + 23, 4, dev, wrap32)
    judged = core.reference_check(c, drv, rows, a1p, a2p, tampered, expected, dev)
    assert core.passed(judged["checks"]) is not wrap32, judged


@pytest.mark.parametrize("fault", FAULTS)
def test_broken_path_is_not_correct(monkeypatch, small, fault):
    _patch(monkeypatch, CELL, fault)
    line = run_cpu(CELL, small, seconds=0.3)
    assert line["correct"] is False, line["checks"]
    if fault == "challenge_first_lanes":
        assert line["failed"] == 0, line


def pointwise_calls(monkeypatch) -> list:
    """Record ("product" or "accumulate", result shape) of every call of
    ``RingContext.dot_hat`` and ``add_hat``, and of ``mat.scalar_mul_hat``
    as the product it is (its own ``dot_hat`` left out)."""
    from ringzk_tpu_torch.ops import mat, ntt

    seen, inside = [], []

    def record(owner, attr, kind, outer=False):
        orig = getattr(owner, attr)

        def wrapped(*args):
            if outer:
                inside.append(True)
            try:
                out = orig(*args)
            finally:
                if outer:
                    inside.pop()
            if outer or not inside:
                seen.append((kind, tuple(out.shape)))
            return out
        monkeypatch.setattr(owner, attr, wrapped)

    record(ntt.RingContext, "dot_hat", "product")
    record(ntt.RingContext, "add_hat", "accumulate")
    record(mat, "scalar_mul_hat", "product", outer=True)
    return seen


def test_counted_work_is_what_a_round_trip_runs(monkeypatch, small):
    """A wide open round trip on the CPU: the products and accumulates
    that ``roofline/pointwise.py`` counts, shape by shape."""
    from ringzk_tpu_torch.protocols.commit import keygen

    c = cpu_cell(CELL, small)
    drv, params, n_deg, tr = driver(c), core.params_of(c.cfg), c.cfg["N"], c.traffic
    dev = torch.device("cpu")
    a1p, a2p = core.key_parts(params, n_deg, 7, dev)
    ck = keygen(None, params, n_deg, device=dev, a1p=a1p, a2p=a2p)
    inputs = core.make_pool(drv, params, n_deg, tr, tr["batch"], 7, dev)[0]
    st = drv.setup(ck=ck, params=params, gen=core.generator(dev, 7, "proofs"), traffic=tr,
                   dist=None, device=dev)
    seen = pointwise_calls(monkeypatch)
    ok, op = drv.call(st, inputs)
    assert bool(ok.all()) and bool(op.all())
    want = collections.Counter()
    for step in pointwise.steps(Scheme.of(c.cfg), tr["batch"]):
        want.update(("product", s) for s in step.products)
        want.update(("accumulate", s) for s in step.accumulates)
    assert collections.Counter(seen) == want
    assert {s[0] for _, s in seen} == {3, 1, 2}     # the ring's primes; d r's; c1 d's


def test_counted_work_at_the_cells_size():
    """By hand, per B N coefficients: 41 products, 24 accumulates and 52
    residues of 4 B (A r 9 + 6, a1 y and a1 z 9 + 3 each, d r 1 + 3 + 3,
    c1 d 2 + 2 + 2), and the key's images once (3 primes, k = 3, 4 row
    blocks of height 1: 36 N residues), bytes-bound: 10.47 GB, 3.125 ms."""
    c = core.find_cell(SPEC, CELL)
    s, b = Scheme.of(c.cfg), c.traffic["batch"]
    bn = b * s.n_deg
    found = pointwise.steps(s, b)
    assert sum(math.prod(x) for st in found for x in st.products) == 41 * bn
    assert sum(math.prod(x) for st in found for x in st.accumulates) == 24 * bn
    nbytes = 4 * (52 * bn + 36 * s.n_deg)
    assert sum(st.nbytes for st in found) == nbytes
    work = pointwise.work(s, b)
    assert {by for _, _, by in work} == {"bytes"}
    assert sum(ms for _, ms, _ in work) == pytest.approx(nbytes / HBM_BPS * 1e3)
    narrow = core.find_cell(SPEC, "open-n1024-b131072")
    assert pointwise.work(Scheme.of(narrow.cfg), narrow.traffic["batch"]) == []


# own device ms over a window of 2 batches, by recorded range name
RANGES = {
    "open_proof/commit": 1.0, "commit_scheme/commit/key_matvec/ntt_fwd": 3.0,
    "commit_scheme/commit/key_matvec/pointwise": 300.0,
    "commit_scheme/commit/key_matvec/ntt_inv": 2.0, "open_proof/commit/key_matvec/ntt_fwd": 1.5,
    "open_proof/commit/key_matvec/pointwise": 200.0,
    "open_proof/create_response/scalar_mul_add/ntt_fwd": 4.0,
    "open_proof/create_response/scalar_mul_add/pointwise": 20.0,
    "open_proof/create_response/scalar_mul_add/ntt_inv": 1.0, "open_proof/verify/norm": 5.0,
}


def obs(cell: str, ranges: dict | None, protocol: str = "open"):
    c = core.find_cell(SPEC, cell)
    work = core.load_module(core.HERE / "roofline" / "open.py", "roofline.open").work(
        Scheme.of(c.cfg), c.traffic["batch"])
    t = None if ranges is None else Trace(
        batches=2, window_s=1.0, busy_s=0.99, kinds={"other": 600.0}, ranges=dict(ranges),
        parents={n: n.rpartition("/")[0] or None for n in ranges})
    return SimpleNamespace(trace=t, work=work, cell=c, world=1,
                           driver=SimpleNamespace(PROTOCOL=protocol))


def test_readers_on_a_synthetic_window():
    o = obs(CELL, RANGES)
    least_pw = sum(ms for _, ms, _ in pointwise.work(Scheme.of(o.cell.cfg), 49152))
    least_ntt = sum(ms for k, _, ms in o.work if k in ("K7", "K8"))
    assert least_pw == pytest.approx(3.1251135)
    assert least_ntt == pytest.approx(5.9513838)
    assert reader("pointwise_roofline").read(o) == pytest.approx(100 * 2 * least_pw / 520)
    assert reader("ntt_roofline").read(o) == pytest.approx(100 * 2 * least_ntt / 11.5)


@pytest.mark.parametrize("name", ["pointwise_roofline", "ntt_roofline"])
def test_readers_read_nothing_where_they_count_nothing(name):
    """No trace, no op range (a program that records none), a narrow
    ring's cells; and pointwise_roofline on a protocol it does not count."""
    phases = {"open_proof/commit": 1.0, "open_proof/verify": 2.0}
    assert reader(name).read(obs(CELL, None)) is None
    assert reader(name).read(obs(CELL, phases)) is None
    for narrow in ("open-n512-b131072", "open-n1024-b131072", "sum-n1024-vl4-b24576"):
        assert reader(name).read(obs(narrow, RANGES)) is None
    assert reader("pointwise_roofline").read(obs(CELL, RANGES, "sum")) is None


def test_only_the_new_cell_lists_the_new_readers():
    for name in ("pointwise_roofline", "ntt_roofline"):
        entry = next(m for m in SPEC["per_layer"] if m["name"] == name)
        assert entry["workloads"] == [CELL] and entry["moves"] == "proofs_per_s"
    cell = core.find_cell(SPEC, CELL)
    assert [m["name"] for m in cell.per_layer] == ["pointwise_roofline", "ntt_roofline"]
    assert [m["name"] for m in cell.end_to_end] == ["proofs_per_s", "peak_mem_gib", "setup_s"]
