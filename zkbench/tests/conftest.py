"""The benchmark's own tests: ``python -m pytest zkbench/tests -q`` from the
root of the repository. They run on the CPU at a small ring degree and
batch; those marked ``cuda`` need a card and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (the port's kernels); skips where none is present")


@pytest.fixture(scope="session")
def small(tmp_path_factory):
    """A checkout of the benchmark at a small size (helpers.small_checkout)."""
    from zkbench.tests.helpers import small_checkout

    return small_checkout(tmp_path_factory.mktemp("small") / "checkout")
