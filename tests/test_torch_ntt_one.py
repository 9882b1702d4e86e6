"""K9's plain version (the single-prime strict NTT) against the JAX package.

The port's ``ntt.fwd_one``/``inv_one`` run K9's plain version on CPU
tensors; they must equal the JAX package's ``ntt._fwd_one``/``_inv_one``
and its Pallas kernels ``fwd_one_pallas``/``inv_one_pallas`` (interpret
mode) bit for bit, on residues in [0, p) and on any uint32 bit pattern
(taken as given, where the strict butterflies wrap), and on rows crafted
to reach that wrap (tests/ntt_wrap_rows.py). Integers: the tolerance is
zero.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringzk_tpu.ops import ntt as jntt
from ringzk_tpu.ops.pallas import ntt_kernel
from ringzk_tpu_torch.ops import ntt as tntt
from ringzk_tpu_torch.ops.kernels import check_aligned
from ringzk_tpu_torch.ops.kernels import ntt_one as k_one
from ringzk_tpu_torch.ops.kernels.ntt import twiddles
from ntt_wrap_rows import wrap_rows

torch.set_num_threads(2)
Q = 3_515_337_053
Q63 = 9223372036854775783   # the largest prime below 2^63: two extension primes


def draw(rng, shape, p: int, full: bool) -> np.ndarray:
    """uint32 residues in [0, p), or any uint32 bit pattern."""
    hi = 2**32 if full else p
    return rng.integers(0, hi, size=shape, dtype=np.uint64).astype(np.uint32)


def both_ways(jring, tring, i: int, x: np.ndarray) -> None:
    """fwd_one and inv_one of x: the port against _fwd_one/_inv_one and the
    Pallas kernels in interpret mode."""
    ctx = jring.mont[i]
    _, _, n_inv_scale, w_fwd, w_inv = jring._tables[i]
    jx, tx = jnp.asarray(x), torch.from_numpy(x.view(np.int32))
    want = np.asarray(jntt._fwd_one(ctx, jnp.asarray(w_fwd), jx))
    np.testing.assert_array_equal(tntt.fwd_one(tring, i, tx).numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        np.asarray(ntt_kernel.fwd_one_pallas(ctx, jnp.asarray(w_fwd), jx, interpret=True)), want)
    want = np.asarray(jntt._inv_one(ctx, jnp.asarray(w_inv), n_inv_scale, jx))
    np.testing.assert_array_equal(tntt.inv_one(tring, i, tx).numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        np.asarray(ntt_kernel.inv_one_pallas(ctx, jnp.asarray(w_inv), n_inv_scale, jx,
                                             interpret=True)), want)


@pytest.mark.parametrize("n", [128, 512])
@pytest.mark.parametrize("i", [0, 1, 2])
@pytest.mark.parametrize("full", [False, True], ids=["residues", "any-uint32"])
def test_fwd_inv_one_match_jax(n, i, full):
    rng = np.random.default_rng(100 * n + 10 * i + full)
    jring, tring = jntt.get_ring(n, Q), tntt.get_ring(n, Q)
    x = draw(rng, (5, n), jring.primes[i], full)
    x[0, :3] = [0, jring.primes[i] - 1, 2**32 - 1 if full else 1]
    both_ways(jring, tring, i, x)


def test_nondivisible_batch():
    """A [3, 7, 128] batch: the lead axes reshape to rows and back."""
    rng = np.random.default_rng(9)
    n = 128
    jring, tring = jntt.get_ring(n, Q), tntt.get_ring(n, Q)
    for i in range(3):
        both_ways(jring, tring, i, draw(rng, (3, 7, n), jring.primes[i], full=i == 2))


def test_round_trip_and_k1_plane():
    """inv_one(fwd_one(x)) == x on residues, and fwd_one of x in [0, p) is
    plane i of K1's images of the same x."""
    rng = np.random.default_rng(10)
    ring = tntt.get_ring(64, Q)
    for i, p in enumerate(ring.primes):
        x = torch.from_numpy(draw(rng, (4, 64), p, False).view(np.int32))
        h = tntt.fwd_one(ring, i, x)
        assert torch.equal(tntt.inv_one(ring, i, h), x)
        assert torch.equal(h, ring.fwd(x)[i])


@pytest.mark.parametrize("i", [3, 4])
def test_extension_prime_matches_jax(i):
    """A wide ring's extension primes (q = 2^63 - 25 adds 469762049 and
    2013265921), with JAX's x64 scoped to the JAX side."""
    rng = np.random.default_rng(20 + i)
    n = 128
    tring = tntt.get_ring(n, Q63)
    with jax.enable_x64(True):
        jring = jntt.get_ring(n, Q63)
        assert jring.primes == tring.primes and len(tring.primes) > i
        for full in (False, True):
            both_ways(jring, tring, i, draw(rng, (5, n), tring.primes[i], full))


def test_wrapper_checks_input():
    ring = tntt.get_ring(16, Q)
    with pytest.raises(ValueError):
        k_one.fwd_one(ring, 0, torch.zeros((2, 16), dtype=torch.int64))
    with pytest.raises(ValueError):
        k_one.inv_one(ring, 3, torch.zeros((2, 16), dtype=torch.int32))
    with pytest.raises(ValueError):
        k_one.fwd_one(ring, 0, torch.zeros((2, 8), dtype=torch.int32))


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
def test_check_aligned(offset):
    """A launch raises for a tensor whose data does not start on a 16-byte
    boundary (the kernels move 16-byte vectors), before the card sees it."""
    x = torch.zeros(64, dtype=torch.int32)[offset:]
    if offset % 4:
        with pytest.raises(ValueError, match="16-byte"):
            check_aligned("ntt_fwd_one", torch.zeros(4, dtype=torch.int32), x)
    else:
        check_aligned("ntt_fwd_one", torch.zeros(4, dtype=torch.int32), x)


def first_stage_differs(x: np.ndarray, p: int, w: int, ws: int) -> tuple:
    """Whether a difference taken as min(d, d + p) differs from MontCtx.sub
    on some first-stage pair of the forward (lane j with j + N/2, the
    difference x[j] - w x[j + N/2] after the Shoup product by the stage's
    twiddle w) and of the inverse (lane 2k with 2k + 1), in uint64 numpy."""
    m = 2**32
    x = x.astype(np.uint64)
    h = x.shape[-1] // 2

    def differs(a, b):
        d = (a - b) % m
        mont_sub = np.where(a < b, (d + p) % m, d)
        return bool((np.minimum(d, (d + p) % m) != mont_sub).any())

    hi = x[..., h:]
    pr = (w * hi - ((ws * hi) >> np.uint64(32)) * p) % m
    pr = np.where(pr >= p, pr - p, pr)
    return differs(x[..., :h], pr), differs(x[..., 0::2], x[..., 1::2])


@pytest.mark.parametrize("n", [4, 16, 128])
@pytest.mark.parametrize("q, i", [(Q, 0), (Q, 1), (Q, 2), (Q63, 3), (Q63, 4)])
def test_wrap_rows_match_jax(n, q, i):
    """The crafted wrap rows through the port's plain versions equal JAX's
    _fwd_one/_inv_one and its Pallas kernels (interpret) bit for bit, at
    the base primes and a wide ring's extension primes (2013265921 at or
    above 2^30). Their first-stage pairs reach values where min(d, d + p)
    differs from MontCtx.sub, forward and inverse, so K9's card test on
    the same rows holds the strict butterflies' subtract to MontCtx's."""
    rng = np.random.default_rng(1000 * n + 10 * i + (q == Q63))
    tring = tntt.get_ring(n, q)
    p = tring.primes[i]
    x = wrap_rows(3, n, p, rng)
    tw = twiddles(tring, "cpu")[i].numpy().view(np.uint32)
    assert first_stage_differs(x, p, int(tw[0, 1]), int(tw[1, 1])) == (True, True)
    with jax.enable_x64(True) if q == Q63 else contextlib.nullcontext():
        both_ways(jntt.get_ring(n, q), tring, i, x)
