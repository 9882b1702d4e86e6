"""The comparison that decides ``correct``: the control (the reference in
the program's place, one precision lower) and runs with the timed path
broken underneath come out as not correct; a sound run does not."""

from __future__ import annotations

import pytest
import torch

from zkbench import control, core

from .helpers import DP, WIDE_CELLS, cpu_cell, run_cpu

# the narrow ring's open and sum cells, and the same mixes on the wide ring
CELLS = ["open-n512-b131072", "sum-n1024-vl4-b24576"] + [w["name"] for w in WIDE_CELLS]


@pytest.mark.parametrize("wrap32", [True, False], ids=["control", "exact"])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(small, cell, wrap32):
    c = cpu_cell(cell, small)
    dev = torch.device("cpu")
    rows, tampered, expected, (a1p, a2p), drv = control.control_rows(c, 2**31 + 5, 4, dev, wrap32)
    judged = core.reference_check(c, drv, rows, a1p, a2p, tampered, expected, dev)
    assert core.passed(judged["checks"]) is not wrap32, judged


def _patch(monkeypatch, cell: str, fault: str) -> None:
    from ringzk_tpu_torch.protocols import commit as commit_mod
    from ringzk_tpu_torch.protocols import open as open_mod
    from ringzk_tpu_torch.protocols import sum as sum_mod

    mod = open_mod if cell.startswith("open") else sum_mod
    orig_resp, orig_rt, orig_commit = mod.create_response, mod.roundtrip, commit_mod._commit

    if fault == "state_unchanged":      # the response step hands its masks back as they were
        def resp(ctx, chal, params):
            if mod is open_mod:
                return open_mod.OpenProofResponse(z=ctx.y)
            return sum_mod.SumProofResponse(zp=ctx.yp, zs=ctx.ys)
        monkeypatch.setattr(mod, "create_response", resp)
    elif fault == "answer_altered":     # one coefficient of every response off by one
        def resp(ctx, chal, params):
            out = orig_resp(ctx, chal, params)
            name = "z" if mod is open_mod else "zp"
            z = getattr(out, name).clone()
            z[..., 0, 0] += 1
            return out._replace(**{name: z})
        monkeypatch.setattr(mod, "create_response", resp)
    elif fault == "commitment_altered":
        def commit(*args, **kw):
            opening, com, ar = orig_commit(*args, **kw)
            c = com.c.clone()
            c[..., -1, 0] += 1
            return opening, com._replace(c=c), ar
        monkeypatch.setattr(commit_mod, "_commit", commit)
    elif fault == "half_batch":         # half the batch proved, its verdicts stand for the rest
        def rt(gen, ck, *args, **kw):
            *data, params = args
            half = data[0].shape[0] // 2
            ok, op = orig_rt(gen, ck, *(d[:half] for d in data), params, **kw)
            return torch.cat([ok, ok]), torch.cat([op, op])
        monkeypatch.setattr(mod, "roundtrip", rt)
    elif fault == "challenge_first_lanes":  # K4 picks lanes 0..kappa-1: valid, but not its rule
        from ringzk_tpu_torch.ops.kernels import challenge as k4

        def select(u, signs, kappa):
            out = torch.zeros_like(signs)
            out[:, :kappa] = signs[:, :kappa]
            return out
        monkeypatch.setattr(k4, "challenge_select", select)
    elif fault == "verdict_flipped":
        def rt(*args, **kw):
            ok, op = orig_rt(*args, **kw)
            return ~ok, op
        monkeypatch.setattr(mod, "roundtrip", rt)


FAULTS = ["state_unchanged", "answer_altered", "commitment_altered", "half_batch",
          "challenge_first_lanes", "verdict_flipped"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(monkeypatch, small, cell, fault):
    _patch(monkeypatch, cell, fault)
    line = run_cpu(cell, small, seconds=0.3)
    assert line["correct"] is False, line["checks"]
    if fault == "challenge_first_lanes":    # its proofs verify: only the selection shows it
        assert line["failed"] == 0, line


def test_exchange_left_out_is_not_correct(monkeypatch, small):
    """The dp cell over four gloo ranks on the CPU, with rank 0 (this
    process) answering its own flag instead of the all-reduce's."""
    from ringzk_tpu_torch.parallel import mesh as mesh_mod

    orig = mesh_mod.all_verified

    def local_only(mesh, ok):
        orig(mesh, ok)               # the others still meet this rank
        return ok.all()

    sound = run_cpu(DP["name"], small, seed=2**31 + 17)
    assert sound["correct"], sound["checks"]
    monkeypatch.setattr(mesh_mod, "all_verified", local_only)
    broken = run_cpu(DP["name"], small, seed=2**31 + 17)
    assert broken["correct"] is False and broken["checks"]["exchange_wrong"]["value"] > 0
