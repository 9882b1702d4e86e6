"""The harness at any modulus the port accepts: its draws (int32 on the
narrow ring, unchanged; int64 from a sampling bound of 2^31 on) and the
kernel work it counts (the narrow lists unchanged; on a wide ring what
the port's wide path launches)."""

from __future__ import annotations

import collections
import hashlib
import json

import pytest
import torch

from zkbench import core
from zkbench.reference.common import Scheme
from zkbench.roofline import wide
from zkbench.roofline.bounds import k4_bound, k7_bound, k8_bound

from .helpers import Q33, WIDE_CELLS, cpu_cell, driver

SPEC = core.load_spec()
SEED = 2**31 + 2022
# sha256 of the key's parts and of a pool of 8 messages a batch at SEED, on
# the CPU, and of each cell's work list, as the harness gave them before
# it drew int64 on wide rings
KEY = {"rzk-default-n512": "db80c4677243f95bb8de70a0f3a41024efdce38a937337acb171143ac60df414",
       "rzk-default-n1024": "58efead85df5e74ed3dd61d25e2f6ed22323927b7b1b4ac64f516a723a47d2c2"}
POOL = {"open-n512-b131072": "f030017cda77b8bace3b31ab7ec125e2870db362293d8d259d41451b52546d77",
        "sum-n1024-vl4-b24576": "cf95a790181cca22e5afdef865ab0cafa223298ee79469ff9bc6ef6f80e8b4d2",
        "open-n1024-b131072": "c7ca5fcb8458b9859fc8ea0911f31469e5f5cd77a81d613167ccac845be034d6"}
WORK = {"open-n512-b131072": "1275ee3edcc5c56ed8eacbf76ff4b8d821cca5df5123ceb6e443d806cbe5b62c",
        "sum-n1024-vl4-b24576": "d088d33add4cb0296cedc0518cb12ee6ac7b1e47a5bdc77f2924a59a166dc969",
        "open-n1024-b131072": "3e900eb5607b84d7d6a618417515cf7ec3712d855dcf27488f90df513718895e"}


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def test_the_draw_dtype_follows_the_bound():
    assert core.draw_dtype(2**31 - 1) == torch.int32
    assert core.draw_dtype(2**31) == torch.int64
    gen = torch.Generator().manual_seed(1)
    x = core.uniform(gen, Q33 // 2, (4096,), "cpu")
    assert x.dtype == torch.int64 and x.abs().max() <= Q33 // 2 and x.abs().max() >= 2**31


@pytest.mark.parametrize("cell", sorted(POOL))
def test_narrow_draws_are_the_parents(cell):
    c = core.find_cell(SPEC, cell)
    params = core.params_of(c.cfg)
    dev = torch.device("cpu")
    assert digest(core.key_parts(params, c.cfg["N"], SEED, dev)) == KEY[c.entry["config"]]
    pool = core.make_pool(driver(c), params, c.cfg["N"], c.traffic, 8, SEED, dev)
    assert digest([t for batch in pool for t in batch]) == POOL[cell]


@pytest.mark.parametrize("cell", sorted(WORK))
def test_narrow_work_is_the_parents(cell):
    c = core.find_cell(SPEC, cell)
    roof = core.load_module(core.HERE / "roofline" / f"{driver(c).PROTOCOL}.py",
                            f"roofline.{driver(c).PROTOCOL}")
    work = roof.work(Scheme.of(c.cfg), c.traffic["batch"], c.traffic.get("vl", 0))
    assert hashlib.sha256(json.dumps(work).encode()).hexdigest() == WORK[cell]


def launches(monkeypatch) -> list:
    """Record (kernel, bound ms) of every launch of the protocol kernels'
    wrappers: K4, K7 and K8 by their shapes, any other by name alone."""
    from ringzk_tpu_torch.ops.kernels import challenge, matvec, ntt, ntt_wide, scalar_mul_add

    seen = []

    def record(mod, attr, entry):
        orig = getattr(mod, attr)

        def wrapped(*args):
            seen.append(entry(*args))
            return orig(*args)
        monkeypatch.setattr(mod, attr, wrapped)

    record(ntt_wide, "fwd_wide_all",
           lambda ring, x, num: ("K7", k7_bound(x.shape[0], num, ring.n)[0]))
    record(ntt_wide, "inv_wide_all",
           lambda ring, xh: ("K8", k8_bound(xh.shape[1], xh.shape[0], ring.n)[0]))
    record(challenge, "challenge_select",
           lambda u, signs, kappa: ("K4", k4_bound(u.shape[0], u.shape[1])[0]))
    for mod, attr, name in ((ntt, "fwd_all", "K1"), (ntt, "inv_all", "K2"),
                            (matvec, "matvec_digits", "K3"),
                            (scalar_mul_add, "scalar_mul_add", "K5"),
                            (matvec, "matvec_digits_colblock", "K6")):
        record(mod, attr, lambda *args, name=name: (name, None))
    return seen


@pytest.mark.parametrize("cell", [w["name"] for w in WIDE_CELLS])
def test_wide_work_is_what_the_port_launches(monkeypatch, small, cell):
    """A wide round trip on the CPU, each kernel wrapper recorded: the
    roofline's list is K4, K7 and K8 alone, at the shapes and prime counts
    the port gave them (3 primes at q = 2^33+9)."""
    from ringzk_tpu_torch.protocols.commit import keygen

    c = cpu_cell(cell, small)
    drv, params, n_deg, tr = driver(c), core.params_of(c.cfg), c.cfg["N"], c.traffic
    dev = torch.device("cpu")
    a1p, a2p = core.key_parts(params, n_deg, 5, dev)
    ck = keygen(None, params, n_deg, device=dev, a1p=a1p, a2p=a2p)
    inputs = core.make_pool(drv, params, n_deg, tr, tr["batch"], 5, dev)[0]
    st = drv.setup(ck=ck, params=params, gen=core.generator(dev, 5, "proofs"), traffic=tr,
                   dist=None, device=dev)
    seen = launches(monkeypatch)
    ok, op = drv.call(st, inputs)
    assert bool(ok.all()) and bool(op.all())
    roof = core.load_module(core.HERE / "roofline" / f"{drv.PROTOCOL}.py",
                            f"roofline.{drv.PROTOCOL}")
    work = roof.work(Scheme.of(c.cfg), tr["batch"], tr.get("vl", 0))
    assert {k for k, _, _ in work} == {"K4", "K7", "K8"}
    assert collections.Counter(seen) == collections.Counter((k, ms) for k, _, ms in work)
    assert [len(wide.primes(Scheme.of(dict(c.cfg, N=n)))) for n in (n_deg, 1024)] == [3, 3]
