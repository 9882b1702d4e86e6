"""The port's ranges (``ringzk_tpu_torch/utils/profiling.py``): the JAX
package's 15 ``@annotate`` names, recorded under ``torch.profiler`` on the
paths the round trips, the chained round trips, the object API and
``protocol_sp`` actually run, with ``commit_scheme/commit`` nested in
``<proof>_proof/commit`` as in the JAX package; the op ranges of the ring
algebra and the key matvec, each recorded under the range it ran in; and
the gate that keeps every range out of ``record_function`` while no
profiler listens.

The names are read from the JAX package's source with a regex; no test
here imports the JAX package.
"""

import json
import re
import threading
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import ringzk_tpu_torch as rt
from ringzk_tpu_torch.ops import mat, sampling
from ringzk_tpu_torch.ops.ntt import get_ring
from ringzk_tpu_torch.parallel import mesh as mesh_mod
from ringzk_tpu_torch.parallel import protocol_sp
from ringzk_tpu_torch.protocols import commit as commit_mod
from ringzk_tpu_torch.protocols import linear, open as open_mod, sum as sum_mod
from ringzk_tpu_torch.utils import profiling
from range_names import want_op_names

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


def recorded(prof) -> list:
    """(recorded name, the name of the range it ran in or None) of every
    range instance of the program on the host side of a profile (not
    torch's own, such as ``gloo:all_reduce``)."""
    out = []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA or not e.is_user_annotation
                or ":" in e.name):
            continue
        up = e.cpu_parent
        while up is not None and not up.is_user_annotation:
            up = up.cpu_parent
        out.append((e.name, None if up is None else up.name))
    return out


@pytest.mark.parametrize("path", ["roundtrip", "chained", "api", "sp"])
@pytest.mark.parametrize("proto", ["open", "linear", "sum"])
def test_paths_record_the_op_ranges(setup, request, proto, path):
    """Each path records the op ranges its phases run under the phase's
    name (``open_proof/verify/key_matvec``), an op nested in an op under
    the outer op's recorded name, one round-trip range around the whole
    call (chains included), and no recorded name under two parents."""
    ck, data = setup
    mesh = request.getfixturevalue("sp_mesh") if path == "sp" else None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ok, _ = _run(path, proto, ck, data[proto], mesh)
    assert bool(ok.all())
    got = recorded(prof)
    names = {name for name, _ in got}
    assert want_op_names(proto, path) <= names, sorted(want_op_names(proto, path) - names)
    parents = {}
    for name, up in got:
        parents.setdefault(name, set()).add(up)
    assert all(len(ups) == 1 for ups in parents.values()), {
        n: ups for n, ups in parents.items() if len(ups) > 1}
    phases = set(jax_names()) | {f"{proto}_proof/roundtrip", "mesh/all_verified"}
    for name, ups in parents.items():
        head, _, leaf = name.rpartition("/")
        if name in phases:
            continue
        assert leaf in profiling.OPS, name
        assert ups == ({head} if head else {None}), (name, ups)
        assert f"/{leaf}/" not in f"/{head}/", name    # a re-entered op opens no range
    trips = [up for name, up in got if name == f"{proto}_proof/roundtrip"]
    assert trips == ([] if path == "api" else [None])


def test_enabled_only_under_a_profiler():
    assert not profiling.enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.enabled()
    assert not profiling.enabled()


def _count_record_function(monkeypatch) -> list:
    names, real = [], torch.profiler.record_function

    def counting(name, *args, **kwargs):
        names.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return names


def test_ranges_enter_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler on, neither form enters ``record_function`` nor
    keeps any state on its thread; under one, each enters it once."""
    names = _count_record_function(monkeypatch)

    @profiling.annotate("norm")
    def f(a):
        with profiling.span("modq"):
            return a + 1

    state = []

    def off():
        assert f(1) == 2
        state.append(hasattr(profiling._local, "stack"))

    t = threading.Thread(target=off)
    t.start()
    t.join()
    assert names == [] and state == [False]
    with profile(activities=[ProfilerActivity.CPU]):
        assert f(1) == 2
    assert names == ["norm", "norm/modq"]
    assert profiling._open_ranges() == []


def test_reentered_op_opens_one_range():
    """``sum_to_centered`` calling ``inv`` is one ``ntt_inv`` range;
    ``mat.add_centered`` calling ``zq.add_centered`` one ``modq``; a phase
    re-entered under itself one range."""
    ring = get_ring(N, PARAMS.modulus)
    gen = torch.Generator().manual_seed(4)
    x = sampling.uniform_centered(gen, (3, 2), N, PARAMS.q, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ring.sum_to_centered(ring.fwd(x), -2)
        mat.add_centered(ring, x, x)
        with profiling.span("open_proof/roundtrip"):
            with profiling.span("open_proof/roundtrip"):
                pass
    got = [name for name, _ in recorded(prof)]
    assert sorted(got) == ["modq", "ntt_fwd", "ntt_inv", "open_proof/roundtrip"]


def test_nested_sums_keep_an_op_with_its_phase():
    """One op under two phases: each phase's device ms with its nested
    ranges (``range_parents`` + ``device_ranges``, as the benchmark sums
    them) equals the sum over its own instances."""
    commit = _ev("open_proof/commit", 0, 50, span=True, device=False)
    verify = _ev("open_proof/verify", 60, 120, span=True, device=False)
    mv_c = _ev("open_proof/commit/key_matvec", 10, 40, span=True, device=False, parent=commit)
    mv_v = _ev("open_proof/verify/key_matvec", 70, 110, span=True, device=False, parent=verify)
    events = [commit, verify, mv_c, mv_v,
              _ev("open_proof/commit", 100, 190, span=True),
              _ev("open_proof/commit/key_matvec", 120, 160, span=True),
              _ev("open_proof/verify", 200, 300, span=True),
              _ev("open_proof/verify/key_matvec", 210, 280, span=True),
              _ev("k", 100, 110), _ev("k", 120, 140), _ev("k", 140, 160), _ev("k", 180, 190),
              _ev("k", 200, 205), _ev("k", 210, 280), _ev("k", 290, 300)]
    own = profiling.device_ranges(events)
    parents = profiling.range_parents(events)

    def nested(name):
        return own.get(name, 0.0) + sum(nested(c) for c, up in parents.items() if up == name)

    assert parents == {"open_proof/commit": None, "open_proof/verify": None,
                       "open_proof/commit/key_matvec": "open_proof/commit",
                       "open_proof/verify/key_matvec": "open_proof/verify"}
    assert own == pytest.approx({"open_proof/commit": 0.020,
                                 "open_proof/commit/key_matvec": 0.040,
                                 "open_proof/verify": 0.015,
                                 "open_proof/verify/key_matvec": 0.070})
    assert nested("open_proof/commit") == pytest.approx(0.060)
    assert nested("open_proof/verify") == pytest.approx(0.085)


def test_dp_all_reduce_recorded_once_a_step(setup, sp_mesh):
    """``mesh/all_verified`` over a one-rank gloo group: one range a dp
    step, inside no other range."""
    ck, data = setup
    m = mesh_mod.make_mesh(device="cpu")
    step = mesh_mod.open_step_fn(m, ck, PARAMS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for seed in (8, 9):
            _, all_ok = step(torch.Generator().manual_seed(seed), *data["open"])
            assert bool(all_ok)
    got = recorded(prof)
    assert [up for name, up in got if name == "mesh/all_verified"] == [None, None]
    assert sum(name == "open_proof/roundtrip" for name, _ in got) == 2
