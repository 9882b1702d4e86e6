"""On the card: one short run of each one-card cell is correct, and the
control at the cell's own batch is not. Skips without a card."""

from __future__ import annotations

import json

import pytest
import torch

from zkbench import control, core

from .helpers import run_cli

ONE_CARD = [w["name"] for w in core.load_spec()["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_short_run_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rc, out, err = run_cli("--workload", cell, "--seed", "3141592653", "--seconds", "3")
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_control_at_cell_size_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = core.find_cell(core.load_spec(), cell)
    c.batch = c.traffic["batch"]
    dev = torch.device("cuda")
    rows, tampered, expected, (a1p, a2p), drv = control.control_rows(c, 2718281828, 8, dev)
    judged = core.reference_check(c, drv, rows, a1p, a2p, tampered, expected, dev)
    assert not core.passed(judged["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("n_deg", [512, 1024])
def test_k4_on_the_card_is_the_references_selection(n_deg):
    """K4 on the card selects what the reference selects, ties included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ringzk_tpu_torch.ops import sampling

    from zkbench.reference.common import Scheme, select_challenge

    s = Scheme(3515337053, 1, 1, 3, 1, 36, n_deg)
    gen = torch.Generator(device="cuda").manual_seed(n_deg)
    for distinct in (3, 2**32):
        keys = torch.randint(0, distinct, (4096, n_deg), generator=gen, device="cuda")
        keys = keys * (2**32 // distinct)
        keys = torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32)
        signs = (2 * torch.randint(0, 2, (4096, n_deg), generator=gen, device="cuda")
                 - 1).to(torch.int32)
        got = sampling.challenge(None, (4096,), n_deg, 36, "cuda", signs=signs, u=keys)
        assert torch.equal(got.to(torch.int64), select_challenge(s, keys, signs)), distinct
