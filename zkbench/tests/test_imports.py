"""No module a run loads is jax's or the JAX package's, compared by whole
top-level names; the reference imports nothing of either nor of the port."""

from __future__ import annotations

import subprocess
import sys

from zkbench import core

from .helpers import run_cli


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ringzk_tpu_torch_fake_probe", object())
    assert "ringzk_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ringzk_tpu.fake_probe", object())
    assert "ringzk_tpu" in core.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {root!r});"
            "import zkbench.reference.open, zkbench.reference.sum, zkbench.roofline.open,"
            " zkbench.roofline.sum, zkbench.tamper;"
            "bad = {{m.split('.')[0] for m in sys.modules}} & "
            "{{'jax', 'jaxlib', 'flax', 'ringzk_tpu', 'ringzk_tpu_torch'}};"
            "print(sorted(bad)); sys.exit(1 if bad else 0)").format(root=str(core.ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def test_a_run_loads_no_jax(small):
    """A whole run of a cell, in a process of its own on the CPU at a small
    size, loads no module of jax, jaxlib, flax or the JAX package (run.py
    checks the same at its start and once the window closed)."""
    code = ("import sys; sys.path.insert(0, {root!r}); from pathlib import Path;"
            "from zkbench import core; from zkbench.tests.helpers import run_cpu;"
            "line = run_cpu('open-n512-b131072', Path({small!r}), seed=4000000001, seconds=0.3);"
            "bad = core.forbidden_modules(); print(line['correct'], bad);"
            "sys.exit(0 if line['correct'] and not bad else 1)").format(
                root=str(core.ROOT), small=str(small))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr[-3000:]


def test_no_card_no_result():
    """Without a card (as here) a run exits with another code than 0 and
    prints no result."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, out, err = run_cli("--workload", "open-n512-b131072", "--seed", "1", "--seconds", "1")
    assert rc == 3 and out.strip() == ""
