"""The plain reference: its ring arithmetic against Python's integers,
and its judgement of the port on the CPU at a small degree."""

from __future__ import annotations

import random

import pytest
import torch

from zkbench.reference import ring
from zkbench.reference.common import Scheme, select_challenge

from .helpers import Q33, WIDE_CELLS, run_cpu

Q = 3515337053
Q63 = 2**63 - 25   # the largest prime below 2^63


def naive(a: list, b: list, m: int) -> list:
    n = len(a)
    out = [0] * n
    for i in range(n):
        for j in range(n):
            k, s = (i + j, 1) if i + j < n else (i + j - n, -1)
            out[k] += s * a[i] * b[j]
    return [v % m for v in out]


@pytest.mark.parametrize("m", [Q, 2**32, Q33, Q63])
@pytest.mark.parametrize("n", [8, 64])
def test_products_are_exact(n, m):
    """Residues across the whole of [-m/2, m/2] (and two int64 extremes,
    which reduce first), against Python's integers: 2, 2, 3 and 4 limbs."""
    rnd = random.Random(n * 7 + m % 97)
    half = max(m // 2, Q // 2)
    a = [[rnd.randint(-half, half) for _ in range(n)] for _ in range(3)]
    b = [[rnd.randint(-half, half) for _ in range(n)] for _ in range(3)]
    a[0][0], b[1][n - 1] = -2**63, 2**63 - 1
    got = ring.mul(torch.tensor(a), torch.tensor(b), m)
    assert got.tolist() == [naive(x, y, m) for x, y in zip(a, b)]
    key = torch.tensor(a).reshape(1, 3, n)
    mv = ring.mat_vec(key, torch.tensor(b).reshape(1, 3, n), m)
    want = [sum(v) % m for v in zip(*(naive(x, y, m) for x, y in zip(a, b)))]
    assert mv.reshape(-1).tolist() == want


def test_norm_is_the_integer_square_root():
    x = torch.tensor([[3, 4], [3, 5], [0, 6], [-2**63, 0]])
    assert ring.norm2_leq(x, 5).tolist() == [True, True, False, False]
    # sums of squares past 2^63, compared exactly
    big = 2**31 - 1
    wide = torch.tensor([[big] * 4, [big, 0, 0, 0], [2**30] * 3 + [2**30 - 1], [2**30] * 4])
    assert ring.norm2_leq(wide, 2**31 - 1).tolist() == [False, True, True, False]


@pytest.mark.parametrize("cell", ["open-n512-b131072", "sum-n1024-vl4-b24576",
                                  "open-n1024-b131072"] + [w["name"] for w in WIDE_CELLS])
def test_reference_agrees_with_the_port(small, cell):
    line = run_cpu(cell, small)
    checks = {k: v["value"] for k, v in line["checks"].items()}
    assert line["correct"], checks
    assert checks["rows_compared"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("distinct", [3, 2**32], ids=["ties", "uniform"])
def test_challenge_selection_is_the_ports_rule(distinct):
    """The reference's top-kappa selection, ties to the lower lane, gives
    the port's challenge from the same draws (keys with few distinct
    values make ties on every row)."""
    from ringzk_tpu_torch.ops import sampling

    s = Scheme(Q, 1, 1, 3, 1, 36, 64)
    gen = torch.Generator().manual_seed(distinct)
    keys = torch.randint(0, distinct, (256, 64), generator=gen) * (2**32 // distinct)
    keys = torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32)
    signs = (2 * torch.randint(0, 2, (256, 64), generator=gen) - 1).to(torch.int32)
    got = sampling.challenge(None, (256,), 64, 36, "cpu", signs=signs, u=keys)
    assert torch.equal(got.to(torch.int64), select_challenge(s, keys, signs))
