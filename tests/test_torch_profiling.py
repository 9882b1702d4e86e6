"""The port's phase ranges (``ringzk_tpu_torch/utils/profiling.py``): the
JAX package's 15 ``@annotate`` names, recorded under ``torch.profiler`` on
the paths the round trips, the chained round trips, the object API and
``protocol_sp`` actually run, with ``commit_scheme/commit`` nested in
``<proof>_proof/commit`` as in the JAX package.

The names are read from the JAX package's source with a regex; only the
Timer layout check imports the JAX package's module.
"""

import json
import re
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import ringzk_tpu_torch as rt
from ringzk_tpu_torch.ops import sampling
from ringzk_tpu_torch.parallel import protocol_sp
from ringzk_tpu_torch.protocols import commit as commit_mod
from ringzk_tpu_torch.protocols import linear, open as open_mod, sum as sum_mod
from ringzk_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
N, B, VL = 16, 2, 2
PARAMS = rt.Params()
MODS = {"open": open_mod, "linear": linear, "sum": sum_mod}
SP = {"open": protocol_sp.open_roundtrip_sp, "linear": protocol_sp.linear_roundtrip_sp,
      "sum": protocol_sp.sum_roundtrip_sp}
API = {"open": (rt.OpenProofProver, rt.OpenProofVerifier),
       "linear": (rt.LinearProofProver, rt.LinearProofVerifier),
       "sum": (rt.SumProofProver, rt.SumProofVerifier)}
# commit_scheme/commit ranges inside one <proof>_proof/commit: linear and
# sum commit twice (to x and to g.x; to the summands and to their sum)
COMMITS = {"open": 1, "linear": 2, "sum": 2}


def jax_names() -> list:
    names = []
    for src in sorted((REPO / "ringzk_tpu" / "protocols").glob("*.py")):
        names += re.findall(r'^@annotate\("([^"]+)"\)', src.read_text(), re.M)
    return names


def proof_names(proto: str) -> set:
    return {f"{proto}_proof/{phase}"
            for phase in ("commit", "generate_challenge", "create_response", "verify")}


@pytest.fixture(scope="module")
def setup():
    gen = torch.Generator().manual_seed(5)
    ck = commit_mod.keygen(gen, PARAMS, N, device="cpu")

    def centered(shape):
        return sampling.uniform_centered(gen, shape[:-1], shape[-1], PARAMS.q, "cpu")

    data = {"open": (centered((B, PARAMS.l, N)),),
            "linear": (centered((B, N)), centered((B, PARAMS.l, N))),
            "sum": (centered((B, VL, N)), centered((B, VL, PARAMS.l, N)))}
    return ck, data


@pytest.fixture(scope="module")
def sp_mesh(tmp_path_factory):
    """A one-rank gloo group and its dp 1 x sp 1 grid."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path_factory.mktemp('sp')}/rdzv",
                            world_size=1, rank=0)
    try:
        yield protocol_sp.make_sp_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def ranges(prof) -> list:
    """(name, enclosing range names from the innermost out) of every range
    event the profile recorded."""
    known = set(jax_names())
    out = []
    for e in prof.events():
        if e.name in known:
            up, parents = e.cpu_parent, []
            while up is not None:
                if up.name in known:
                    parents.append(up.name)
                up = up.cpu_parent
            out.append((e.name, parents))
    return out


def test_jax_package_has_fifteen_ranges():
    names = jax_names()
    assert len(names) == len(set(names)) == 15
    assert {n for n in names if n.startswith("commit_scheme/")} == {
        "commit_scheme/keygen", "commit_scheme/commit", "commit_scheme/verify"}


def _run(path, proto, ck, data, sp_mesh):
    gen = torch.Generator().manual_seed(7)
    mod = MODS[proto]
    if path == "roundtrip":
        return mod.roundtrip(gen, ck, *data, PARAMS)
    if path == "chained":
        return mod.roundtrip(gen, ck, *data, PARAMS, chains=B)
    if path == "sp":
        return SP[proto](sp_mesh, gen, ck, *data, PARAMS)
    prover_cls, verifier_cls = API[proto]
    prover, verifier = prover_cls(ck, PARAMS), verifier_cls(ck, PARAMS)
    rctx, pcom = prover.commit(gen, *data)
    vctx, chal = verifier.generate_challenge(gen, pcom)
    return verifier.verify(prover.create_response(rctx, chal), vctx), None


@pytest.mark.parametrize("path", ["roundtrip", "chained", "api", "sp"])
@pytest.mark.parametrize("proto", ["open", "linear", "sum"])
def test_paths_record_the_jax_ranges(setup, request, proto, path):
    """Each path records its proof's four ranges and the commit scheme's,
    every commit_scheme/commit inside <proof>_proof/commit, and no range of
    another proof."""
    ck, data = setup
    mesh = request.getfixturevalue("sp_mesh") if path == "sp" else None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ok, _ = _run(path, proto, ck, data[proto], mesh)
    assert bool(ok.all())
    got = ranges(prof)
    names = {name for name, _ in got}
    want = proof_names(proto) | {"commit_scheme/commit"}
    if path != "api":
        want.add("commit_scheme/verify")   # the opening checks of the round trip
    assert names == want
    chains = B if path == "chained" else 1
    commits = [parents for name, parents in got if name == "commit_scheme/commit"]
    assert len(commits) == COMMITS[proto] * chains
    assert all(parents == [f"{proto}_proof/commit"] for parents in commits)
    for name, parents in got:
        if name != "commit_scheme/commit":
            assert parents == [], (name, parents)
    assert sum(name == f"{proto}_proof/verify" for name, _ in got) == chains


def test_keygen_and_round_trips_record_all_fifteen(setup):
    ck, data = setup
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rt.generate_commitment_key(torch.Generator().manual_seed(1), PARAMS, N, device="cpu")
        for proto, mod in MODS.items():
            mod.roundtrip(torch.Generator().manual_seed(2), ck, *data[proto], PARAMS)
    assert {name for name, _ in ranges(prof)} == set(jax_names())


def test_annotate_wraps():
    @profiling.annotate("test/range")
    def f(a, b=2):
        """doc"""
        return a + b

    assert f.__name__ == "f" and f.__doc__ == "doc" and f(1, b=3) == 4
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f(1)
    assert [e.name for e in prof.events() if e.name == "test/range"] == ["test/range"]


def test_device_trace_writes_chrome_trace(setup, tmp_path):
    ck, data = setup
    with profiling.device_trace(str(tmp_path), device="cpu") as prof:
        open_mod.roundtrip(torch.Generator().manual_seed(3), ck, *data["open"], PARAMS)
    assert {name for name, _ in ranges(prof)} >= proof_names("open")
    (trace,) = tmp_path.glob("trace_*.json")
    names = {ev.get("name") for ev in json.loads(trace.read_text())["traceEvents"]}
    assert proof_names("open") <= names


def test_timer_report_matches_jax_layout():
    from ringzk_tpu.utils.profiling import Timer as JaxTimer

    phases = {"commit": 0.0123, "verify": 0.5, "challenge": 0.000456, "a" * 40: 1.25}
    ours, theirs = profiling.Timer(), JaxTimer()
    ours.phases, theirs.phases = dict(phases), dict(phases)
    assert ours.report() == theirs.report()
    t = profiling.Timer()
    with t.phase("x"):
        pass
    with t.phase("x"):
        pass
    assert list(t.phases) == ["x"] and re.fullmatch(r"x {31} +\d+\.\d\d ms +100\.0%", t.report())


def _ev(name, start, end, stream=7, span=False, device=True, parent=None):
    from types import SimpleNamespace

    from torch.autograd.profiler_util import Interval

    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, time_range=Interval(start, end), device_resource_id=stream,
                           device_type=kind, is_user_annotation=span, cpu_parent=parent)


def test_device_ranges_attributes_work_to_the_innermost_span():
    """Each kernel counts for the shortest span on its stream that holds it;
    the spans themselves, work before ``since_us``, work outside every span
    and work on another stream's spans count for none."""
    events = [
        _ev("outer", 5, 30, span=True), _ev("inner", 10, 20, span=True),
        _ev("other", 40, 50, span=True), _ev("early", 0, 3, span=True),
        _ev("k", 5, 8), _ev("k", 10, 12), _ev("k", 15, 20), _ev("k", 25, 30),
        _ev("k", 40, 45), _ev("k", 60, 61), _ev("k", 11, 12, stream=9), _ev("k", 1, 2),
        _ev("aten::add", 10, 12, device=False),
    ]
    got = profiling.device_ranges(events, since_us=4)
    assert got == pytest.approx({"outer": 0.008, "inner": 0.007, "other": 0.005})
    assert {e.name for e in profiling.device_work(events)} == {"k"}
    assert len(profiling.device_work(events)) == 8


def test_range_parents_skip_ops_between_ranges():
    outer = _ev("open_proof/commit", 0, 10, span=True, device=False)
    op = _ev("aten::cat", 1, 9, device=False, parent=outer)
    inner = _ev("commit_scheme/commit", 2, 8, span=True, device=False, parent=op)
    gpu = _ev("commit_scheme/commit", 2, 8, span=True)
    assert profiling.range_parents([outer, op, inner, gpu]) == {
        "open_proof/commit": None, "commit_scheme/commit": "open_proof/commit"}
