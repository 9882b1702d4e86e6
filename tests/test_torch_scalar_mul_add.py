"""The port's fused t + d*m (K5's plain version) against the JAX package.

Same inputs, made from a seeded numpy generator, go through the port's
``RingContext.scalar_mul_add`` and the JAX package's, which on the CPU is
the composed chain (fwd_const, fwd, dot_hat, inv, centered add); at N=128
also through both Pallas kernels it replaces, ``scalar_mul_add_pallas``
(K5) and ``scalar_mul_add_pallas_v2`` (K5b), in interpret mode. Every value
is an integer, so the tolerance is zero.
"""

import numpy as np
import pytest
import torch

from ringzk_tpu.ops import ntt as jntt
from ringzk_tpu.ops.pallas import ntt_kernel
from ringzk_tpu_torch.ops import ntt as tntt
from ringzk_tpu_torch.ops.kernels import ntt as tntt_kernels
from ringzk_tpu_torch.ops.kernels import scalar_mul_add as k_sma

torch.set_num_threads(2)
Q = 3_515_337_053
I32 = np.iinfo(np.int32)


def inputs(n, rows, num, batch=3, extremes=False, seed=0):
    """d, m, t as the protocols give them: d kappa-sparse ternary against
    honest r (num=1) or against any wire value (num=2); both full-range for
    num=3."""
    rng = np.random.default_rng(1000 * n + 10 * rows + num + seed)
    d = rng.integers(-1, 2, size=(batch, n)) * (rng.random((batch, n)) < 36 / n)
    if num == 3:
        d = rng.integers(-(Q // 2), Q // 2 + 1, size=(batch, n))
    mmax = 1 if num == 1 else Q // 2
    m = rng.integers(-mmax, mmax + 1, size=(batch, rows, n))
    t = rng.integers(-(Q // 2), Q // 2 + 1, size=(batch, rows, n))
    if extremes:
        d = rng.integers(-(Q // 2), Q // 2 + 1, size=(batch, n))
        m = rng.choice([I32.min, I32.max, I32.min + 1, -1, 0], size=(batch, rows, n))
        t = rng.choice([I32.min, I32.max, I32.min + 1, Q // 2, -(Q // 2)], size=(batch, rows, n))
    return tuple(np.asarray(a, np.int32) for a in (d, m, t))


@pytest.mark.parametrize("n,rows,num", [(128, 3, 1), (128, 1, 2), (512, 3, 3),
                                        (512, 12, 1), (512, 4, 2)])
def test_scalar_mul_add_matches_jax(n, rows, num):
    d, m, t = inputs(n, rows, num)
    want = np.asarray(jntt.get_ring(n, Q).scalar_mul_add(d, m, t, num))
    ring = tntt.get_ring(n, Q)
    got = ring.scalar_mul_add(*(torch.from_numpy(a) for a in (d, m, t)), num)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scalar_mul_add_int32_extremes_match_jax():
    """m and t at the int32 extremes (m is c1 off the wire), full-range d."""
    n, rows, num = 128, 3, 3
    d, m, t = inputs(n, rows, num, extremes=True)
    want = np.asarray(jntt.get_ring(n, Q).scalar_mul_add(d, m, t, num))
    got = tntt.get_ring(n, Q).scalar_mul_add(*(torch.from_numpy(a) for a in (d, m, t)), num)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows,num,extremes", [(3, 1, False), (1, 2, False), (2, 3, True)])
def test_scalar_mul_add_matches_pallas_interpret(rows, num, extremes):
    """Both TPU kernels K5 replaces, run interpreted, at N=128."""
    n = 128
    d, m, t = inputs(n, rows, num, batch=5, extremes=extremes, seed=1)
    jring = jntt.get_ring(n, Q)
    got = tntt.get_ring(n, Q).scalar_mul_add(*(torch.from_numpy(a) for a in (d, m, t)), num)
    for fn in (ntt_kernel.scalar_mul_add_pallas, ntt_kernel.scalar_mul_add_pallas_v2):
        want = np.asarray(fn(jring, d, m, t, num, interpret=True))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn.__name__)


@pytest.mark.parametrize("q", [32749, 2**32 - 5])
@pytest.mark.parametrize("rows,num", [(3, 1), (1, 2), (2, 3)])
def test_scalar_mul_add_narrow_moduli_match_jax(q, rows, num):
    """The fold constants of K5 (``kernel_consts`` c[24..38]) depend on q:
    at the JAX package's other narrow moduli, N=128, d over the whole
    centered range of q and m, t over the whole int32 range, the plain K5
    against the composed chain and against ``scalar_mul_add_pallas_v2``
    (interpret)."""
    n = 128
    rng = np.random.default_rng(q % 1000 + 10 * rows + num)
    full = np.iinfo(np.int32)
    d = rng.integers(-(q // 2), q // 2 + 1, size=(4, n)).astype(np.int32)
    m = rng.integers(full.min, full.max, size=(4, rows, n), endpoint=True).astype(np.int32)
    t = rng.integers(full.min, full.max, size=(4, rows, n), endpoint=True).astype(np.int32)
    jring = jntt.get_ring(n, q)
    got = tntt.get_ring(n, q).scalar_mul_add(*(torch.from_numpy(a) for a in (d, m, t)), num)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jring.scalar_mul_add(d, m, t, num)))
    want = ntt_kernel.scalar_mul_add_pallas_v2(jring, d, m, t, num, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_twiddle_pairs_interleave_the_tables():
    """The kernel's uint2 table: per prime [forward, inverse][N] of (w, w')
    pairs from the four twiddle rows."""
    ring = tntt.get_ring(64, Q)
    tw = k_sma.twiddle_pairs(ring, "cpu")
    rows = tntt_kernels.twiddles(ring, "cpu")
    assert tw.shape == (ring.num_primes, 2, 64, 2) and tw.is_contiguous()
    for i in range(ring.num_primes):
        for which in (0, 1):
            assert torch.equal(tw[i, which, :, 0], rows[i, 2 * which])
            assert torch.equal(tw[i, which, :, 1], rows[i, 2 * which + 1])


def test_structure_axes_flatten_like_jax():
    """d [B, N] broadcast over m [B, V, k, N] (the sum proof's response)."""
    n = 64
    rng = np.random.default_rng(5)
    d = rng.integers(-1, 2, size=(2, n)).astype(np.int32)
    m = rng.integers(-1, 2, size=(2, 4, 3, n)).astype(np.int32)
    t = rng.integers(-(Q // 2), Q // 2 + 1, size=(2, 4, 3, n)).astype(np.int32)
    want = np.asarray(jntt.get_ring(n, Q).scalar_mul_add(d, m, t, 1))
    got = tntt.get_ring(n, Q).scalar_mul_add(*(torch.from_numpy(a) for a in (d, m, t)), 1)
    assert got.shape == (2, 4, 3, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_checks_input():
    ring = tntt.get_ring(16, Q)
    d = torch.zeros((2, 16), dtype=torch.int32)
    m = torch.zeros((2, 3, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        k_sma.scalar_mul_add(ring, d.to(torch.int64), m, m, 1)
    with pytest.raises(ValueError):
        k_sma.scalar_mul_add(ring, d, m, m, 4)
    with pytest.raises(ValueError):
        k_sma.scalar_mul_add(ring, d[:1], m, m, 1)
    with pytest.raises(ValueError):
        k_sma.scalar_mul_add(ring, d, m, m.transpose(0, 1).contiguous().transpose(0, 1), 1)
    with pytest.raises(ValueError):
        ring.scalar_mul_add(d, m[:1], m[:1], 1)
