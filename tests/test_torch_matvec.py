"""The port's digit matvec (K3), NTT matvec and norms against the JAX package.

Integers throughout: the tolerance is zero. The JAX side runs its XLA
path, and once its Pallas kernel in interpret mode.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringzk_tpu.ops import conv_mxu as jconv
from ringzk_tpu.ops import norms as jnorms
from ringzk_tpu.ops import ntt as jntt
from ringzk_tpu.ops.pallas import matvec_kernel
from ringzk_tpu_torch.ops import conv_mxu as tconv
from ringzk_tpu_torch.ops import mat as tmat
from ringzk_tpu_torch.ops import norms as tnorms
from ringzk_tpu_torch.ops import ntt as tntt
from ringzk_tpu_torch.ops.kernels import matvec as k_mv

torch.set_num_threads(2)
Q = 3_515_337_053


def key(rng, rows, k, n):
    return rng.integers(-(Q // 2), Q // 2 + 1, size=(rows, k, n)).astype(np.int32)


def test_digit_helpers_match_jax():
    for bound in (1, 127, 128, 32639, 32640, 247104, 679536, 8355967, 8355968, Q // 2):
        assert tconv.digits_for_bound(bound) == jconv.digits_for_bound(bound)
    for nd in (1, 2, 3, 4):
        assert tconv.digit_capacity(nd) == jconv.digit_capacity(nd)
    rng = np.random.default_rng(5)
    for nd in (1, 3, 4):
        cap = tconv.digit_capacity(nd)
        v = rng.integers(-cap, cap + 1, size=(7, 33)).astype(np.int32)
        v[0, :2] = [cap, -cap]
        np.testing.assert_array_equal(tconv.balanced_digits(torch.from_numpy(v), nd).numpy(),
                                      np.asarray(jconv.balanced_digits(v, nd)))


@pytest.mark.parametrize("rows,n", [(1, 16), (2, 128), (1, 512)])
def test_operator_digits_match_jax(rows, n):
    rng = np.random.default_rng(rows * n)
    a = key(rng, rows, 3, n)
    ring = tntt.get_ring(n, Q)
    got = tconv.build_operator_digits_device(torch.from_numpy(a), ring)
    want = jconv.build_operator_digits_device(a, jntt.get_ring(n, Q))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,v_digits,bound", [(16, 1, 1), (128, 3, 679536), (512, 1, 1),
                                              (512, 3, 247104)])
def test_matvec_digits_matches_jax_and_ntt_path(n, v_digits, bound):
    """K3's plain version == the JAX digit matvec == the port's NTT matvec
    (the independent exact fallback)."""
    rng = np.random.default_rng(n + v_digits)
    rows, k = 2, 3
    a = key(rng, rows, k, n)
    v = rng.integers(-bound, bound + 1, size=(5, k, n)).astype(np.int32)
    tring, jring = tntt.get_ring(n, Q), jntt.get_ring(n, Q)
    ta, tv = torch.from_numpy(a), torch.from_numpy(v)
    w = tconv.build_operator_digits_device(ta, tring)
    got = tconv.matvec_digits(tring, w, rows, tv, v_digits)
    jw = jconv.build_operator_digits_device(a, jring)
    want = np.asarray(jconv.matvec_digits(jring, jw, rows, v, v_digits))
    np.testing.assert_array_equal(got.numpy(), want)
    ntt_path = tmat.matvec(tring, tring.fwd_const(ta), tring.fwd(tv))
    np.testing.assert_array_equal(ntt_path.numpy(), want)


def test_matvec_digits_matches_pallas_interpret():
    """One small call of the TPU kernel itself, in interpret mode."""
    rng = np.random.default_rng(9)
    n, rows = 128, 1
    a = key(rng, rows, 3, n)
    v = rng.integers(-679536, 679537, size=(4, 3, n)).astype(np.int32)
    jring = jntt.get_ring(n, Q)
    jw = jconv.build_operator_digits_device(a, jring)
    want = np.asarray(matvec_kernel.matvec_digits_pallas(jring, jw, rows, jnp.asarray(v), 3,
                                                          interpret=True))
    tring = tntt.get_ring(n, Q)
    w = tconv.build_operator_digits_device(torch.from_numpy(a), tring)
    got = tconv.matvec_digits(tring, w, rows, torch.from_numpy(v), 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_matvec_ntt_path_long_contraction_matches_schoolbook():
    """mat.matvec chunks contractions past ACC_MAX terms."""
    rng = np.random.default_rng(13)
    n, k = 16, 20
    a = key(rng, 2, k, n)
    v = rng.integers(-(Q // 2), Q // 2 + 1, size=(3, k, n)).astype(np.int32)
    tring = tntt.get_ring(n, Q)
    got = tmat.matvec(tring, tring.fwd_const(torch.from_numpy(a)),
                      tring.fwd(torch.from_numpy(v)))
    # sum_t a[row, t] * v[b, t], exact over the integers, then mod q
    prods = tntt.negacyclic_schoolbook(a[None], v[:, None], Q).astype(object)
    want = np.mod(prods.sum(axis=-2), Q)
    want = np.where(want > Q // 2, want - Q, want).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_checks_input():
    ring = tntt.get_ring(16, Q)
    w = torch.zeros((48, 4 * 16), dtype=torch.int8)
    with pytest.raises(ValueError):
        k_mv.matvec_digits(ring, w, 16, torch.zeros((2, 48), dtype=torch.int64), 1)
    with pytest.raises(ValueError):
        k_mv.matvec_digits(ring, w, 16, torch.zeros((2, 48), dtype=torch.int32), 5)
    with pytest.raises(ValueError):
        k_mv.matvec_digits(ring, w[:, :32], 16, torch.zeros((2, 48), dtype=torch.int32), 1)


def test_norm2_leq_matches_jax():
    rng = np.random.default_rng(17)
    n, bound = 512, 679536
    x = rng.integers(-bound // 30, bound // 30, size=(12, n)).astype(np.int32)
    x[1:3] = 0
    x[1, 0] = bound                       # one coefficient at the bound
    x[2, 0] = bound + 1                   # just above: rejects
    x[3] = 2**31 - 1                      # adversarial full range
    x[4] = -(2**31)
    edge = math.isqrt((bound * bound + 2 * bound) // n)
    x[5] = edge                           # sum of squares at the limit: accepts
    x[6] = edge + 1                       # just past it: rejects
    x[7, :] = 0
    got = tnorms.norm2_leq(torch.from_numpy(x), bound).numpy()
    want = np.asarray(jnorms.norm2_leq(x, bound))
    np.testing.assert_array_equal(got, want)
    assert want[0] and want[1] and not want[2] and not want[3] and not want[4]
    assert want[5] and not want[6]
    # N * bound^2 past 2^63: answered as the JAX package answers it
    np.testing.assert_array_equal(tnorms.norm2_leq(torch.from_numpy(x), 2**31).numpy(),
                                  np.asarray(jnorms.norm2_leq(x, 2**31)))


def test_split_rows_and_poly_equal():
    x = torch.arange(2 * 3 * 4, dtype=torch.int32).reshape(2, 3, 4)
    top, rest = tmat.split_rows(x, 1)
    assert top.shape == (2, 1, 4) and rest.shape == (2, 2, 4)
    y = x.clone()
    y[1, 2, 3] += 1
    assert tmat.poly_equal(x, y, struct_axes=1).tolist() == [True, False]
