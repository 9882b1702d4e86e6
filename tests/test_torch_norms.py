"""The port's exact norm check against the JAX package where N * bound^2
passes 2^63: the survivors' squares are summed in chunks.

Integers throughout: the verdicts must be equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringzk_tpu import params as jparams
from ringzk_tpu.ops import norms as jnorms
from ringzk_tpu.protocols import commit as jcommit
from ringzk_tpu_torch import Params
from ringzk_tpu_torch.ops import norms as tnorms
from ringzk_tpu_torch.protocols import commit as tcommit


def edge_rows(n: int, bound: int) -> np.ndarray:
    """Rows on both sides of the limit bound^2 + 2 bound: the sum of squares
    exactly at it, one past it, and each with one coefficient at and past
    the bound."""
    limit = bound * bound + 2 * bound
    base = math.isqrt(limit // n)
    rest = limit - n * base * base          # < 2 * base * n + n
    x = np.full((6, n), base, np.int64)
    # raise coefficients of row 0 by one (adds 2 base + 1 each) while the
    # sum stays at or under the limit
    ups = rest // (2 * base + 1)
    x[0, :ups] += 1
    x[1] = x[0]
    x[1, ups] += 1                          # now past the limit
    x[2, :] = 0
    x[2, 0] = bound                         # one coefficient at the bound
    x[3, :] = 0
    x[3, 0] = bound + 1                     # just past it
    x[4, :] = 0
    x[5] = -x[0]
    big = x.astype(object)
    assert (big[0] ** 2).sum() <= limit < (big[1] ** 2).sum()
    return x


@pytest.mark.parametrize("n,bound", [(8192, 44_478_720), (4096, 2**31 - 1), (512, 2**31),
                                     (64, 3_037_000_500)])
def test_norm2_leq_large_bounds_match_jax(n, bound):
    """int32 rows at bounds whose N * bound^2 is past 2^63: on both sides of
    the limit, at the coefficient bound, and at int32's extremes."""
    x = edge_rows(n, bound)
    x = np.clip(x, -(2**31), 2**31 - 1).astype(np.int32)
    x = np.concatenate([x, np.full((1, n), 2**31 - 1, np.int32),
                        np.full((1, n), -(2**31), np.int32)])
    got = tnorms.norm2_leq(torch.from_numpy(x), bound).numpy()
    want = np.asarray(jnorms.norm2_leq(x, bound))
    np.testing.assert_array_equal(got, want)


def test_norm2_leq_limit_edges_match_jax():
    """The chunked path on rows just inside and just outside the limit."""
    n, bound = 8192, 44_478_720
    x = edge_rows(n, bound).astype(np.int32)
    got = tnorms.norm2_leq(torch.from_numpy(x), bound).tolist()
    assert got == np.asarray(jnorms.norm2_leq(x, bound)).tolist()
    assert got == [True, False, True, False, True, True]


@pytest.mark.parametrize("b,n", [(2, 8192), (5, 4096)])
def test_commit_ok_past_int64_matches_jax(b, n):
    """commit_ok at parameters whose N * bound^2 passes 2^63: zero openings
    and rows around the bound, as the JAX package answers them."""
    tp, jp = Params(b=b), jparams.Params(b=b)
    bound = tp.commit_bound(n)
    assert bound == jp.commit_bound(n) and n * bound * bound >= 2**63
    rows = edge_rows(n, bound).astype(np.int32)
    r = np.zeros((len(rows) + 1, tp.k, n), np.int32)
    r[1:, 0] = rows
    got = tcommit.commit_ok(tp, n, torch.from_numpy(r)).tolist()
    want = np.asarray(jcommit.commit_ok(jp, n, jnp.asarray(r))).tolist()
    assert got == want
    assert got == [True, True, False, True, False, True, True]


def test_norm2_leq_wide_row_past_int64_matches_jax():
    """A wide ring's int64 rows at a bound whose N * bound^2 passes 2^63."""
    n, bound = 8192, 2**31 - 1
    x = edge_rows(n, bound)
    x = np.concatenate([x, np.full((1, n), -(2**63), np.int64),
                        np.full((1, n), 2**62, np.int64)])
    got = tnorms.norm2_leq(torch.from_numpy(x), bound).tolist()
    with jax.enable_x64(True):
        want = np.asarray(jnorms.norm2_leq(jnp.asarray(x), bound)).tolist()
    assert got == want == [True, False, True, False, True, True, False, False]
