"""The port's examples (``examples_torch/custom_modulus.py`` and
``examples_torch/two_party.py``) on the CPU, and each custom_modulus key
engine against the one the JAX package's ``keygen`` picks at the same
Params and N=64."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

import ringzk_tpu as rz
from ringzk_tpu_torch.protocols.commit import keygen

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples_torch"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


custom_modulus = _load("custom_modulus")


def _run(script):
    return subprocess.run([sys.executable, str(EXAMPLES / script), "--device", "cpu"],
                          capture_output=True, text=True, timeout=300, cwd=REPO)


def test_custom_modulus_runs_on_cpu():
    run = _run("custom_modulus.py")
    assert run.returncode == 0, run.stderr
    lines = run.stdout.splitlines()
    assert len(lines) == len(custom_modulus.CONFIGS)
    assert all(line.endswith("16/16 proofs ok=True") for line in lines)
    engines = [line.split("key engine=")[1].split("  ")[0] for line in lines]
    assert engines == ["int8 digits", "int8 digits", "CRT-NTT", "int8 digits", "wide ring",
                       "wide ring"]


def test_two_party_runs_on_cpu():
    run = _run("two_party.py")
    assert run.returncode == 0, run.stderr
    assert "two-party open proof verified: True" in run.stdout


def _jax_engine(params):
    wide = params.modulus >= 2**32
    with jax.enable_x64(wide):
        ck = rz.keygen(jax.random.PRNGKey(1), params, custom_modulus.N)
    if ck.a1_dig is not None:
        return "int8 digits"
    return "wide ring" if wide else "CRT-NTT"


@pytest.mark.parametrize("i", range(len(custom_modulus.CONFIGS)))
def test_key_engine_equals_jax(i):
    name, params = custom_modulus.CONFIGS[i]
    ck = keygen(torch.Generator().manual_seed(1), params, custom_modulus.N, device="cpu")
    assert custom_modulus.key_engine(ck, params) == _jax_engine(params), name
