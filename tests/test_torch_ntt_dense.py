"""K10's plain version (the dense int8 NTT) against the archived JAX engine.

``archive/ntt_mxu.py`` and ``archive/ntt_dense_kernel.py`` are the JAX
package's retired dense engine and its Pallas kernel. They are loaded by
path under the names they had inside the package, so that their relative
imports resolve; no file changes. The port's tables must be the same bytes,
and its transforms (``ntt_dense.fwd_one_dense``/``inv_one_dense``, K10's
plain version on CPU tensors) must equal the archived engine, the Pallas
kernel in interpret mode and the strict ``ntt._fwd_one``/``_inv_one``, bit
for bit. Integers: the tolerance is zero.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ringzk_tpu.ops.pallas  # noqa: F401  (the parent packages of the archived modules)
from ringzk_tpu.ops import ntt as jntt
from ringzk_tpu_torch.ops import ntt as tntt
from ringzk_tpu_torch.ops import ntt_dense
from ringzk_tpu_torch.ops.kernels import ntt_dense as k_dense

torch.set_num_threads(2)
Q = 3_515_337_053
ARCHIVE = Path(__file__).resolve().parents[1] / "archive"
EDGE = 2_139_062_143   # the 4-digit balanced capacity


def _load(name: str, fname: str):
    spec = importlib.util.spec_from_file_location(name, ARCHIVE / fname)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


mxu = _load("ringzk_tpu.ops.ntt_mxu", "ntt_mxu.py")
dense_kernel = _load("ringzk_tpu.ops.pallas.ntt_dense_kernel", "ntt_dense_kernel.py")


@pytest.mark.parametrize("n", [64, 128])
def test_tables_match_archive(n):
    for p, g in zip(jntt.PRIMES, jntt.GENERATORS):
        want, got = mxu._tables_dense(p, g, n), ntt_dense._tables_dense(p, g, n)
        assert (got["din"], got["dout"]) == (want["din"], want["dout"]) == (4, 4)
        assert got["mf"].dtype == got["mi"].dtype == np.int8
        np.testing.assert_array_equal(got["mf"], want["mf"])
        np.testing.assert_array_equal(got["mi"], want["mi"])
        assert got["shifts_mont"] == want["shifts_mont"]


@pytest.mark.parametrize("n,i", [(64, 0), (64, 1), (64, 2), (128, 0), (128, 1), (128, 2),
                                 (512, 0)])
def test_dense_matches_archive_pallas_and_strict(n, i):
    rng = np.random.default_rng(10 * n + i)
    jring, tring = jntt.get_ring(n, Q), tntt.get_ring(n, Q)
    ctx = jring.mont[i]
    _, _, n_inv_scale, w_fwd, w_inv = jring._tables[i]
    t = mxu._tables_dense(jring.primes[i], jntt.GENERATORS[i], n)
    x = rng.integers(-(Q // 2), Q // 2 + 1, size=(6, n)).astype(np.int32)
    x[0, :4] = [EDGE, -EDGE, Q // 2, -(Q // 2)]
    jx = jnp.asarray(x)

    want = np.asarray(mxu.fwd_one_dense(jring, i, jx))
    got = ntt_dense.fwd_one_dense(tring, i, torch.from_numpy(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    fwd_table = {"din": 4, "dout": 4, "m": jnp.asarray(t["mf"]), "shifts_mont": t["shifts_mont"]}
    np.testing.assert_array_equal(
        np.asarray(dense_kernel.dense_apply_pallas(ctx, fwd_table, jx, n, interpret=True)), want)
    xr = ctx.reduce_i32_centered(jx)
    np.testing.assert_array_equal(np.asarray(jntt._fwd_one(ctx, jnp.asarray(w_fwd), xr)), want)

    xh = np.array(want)
    want_i = np.asarray(mxu.inv_one_dense(jring, i, jnp.asarray(xh)))
    got_i = ntt_dense.inv_one_dense(tring, i, torch.from_numpy(xh.view(np.int32)))
    np.testing.assert_array_equal(got_i.numpy().view(np.uint32), want_i)
    inv_table = {"din": 4, "dout": 4, "m": jnp.asarray(t["mi"]), "shifts_mont": t["shifts_mont"]}
    np.testing.assert_array_equal(
        np.asarray(dense_kernel.dense_apply_pallas(ctx, inv_table, jnp.asarray(xh.view(np.int32)),
                                                   n, interpret=True)), want_i)
    np.testing.assert_array_equal(
        np.asarray(jntt._inv_one(ctx, jnp.asarray(w_inv), n_inv_scale, jnp.asarray(xh))), want_i)
    np.testing.assert_array_equal(want_i, np.asarray(xr))


def test_dense_equals_k9_plain_on_lead_axes():
    """K10's plain version against K9's on a [2, 3, N] batch: fwd of
    centered x equals K9's fwd of x mod p, and the inverses agree."""
    rng = np.random.default_rng(5)
    n = 64
    ring = tntt.get_ring(n, Q)
    x = torch.from_numpy(rng.integers(-(Q // 2), Q // 2 + 1, size=(2, 3, n)).astype(np.int32))
    for i, p in enumerate(ring.primes):
        xr = torch.remainder(x.to(torch.int64), p).to(torch.int32)
        h = ntt_dense.fwd_one_dense(ring, i, x)
        assert h.shape == x.shape
        assert torch.equal(h, tntt.fwd_one(ring, i, xr))
        assert torch.equal(ntt_dense.inv_one_dense(ring, i, h), tntt.inv_one(ring, i, h))


def test_bal_digits_host_and_limits():
    a = np.array([0, 1, -1, 127, 128, -128, -129, EDGE, -EDGE], np.int64)
    d = ntt_dense._bal_digits_host(a, 4)
    assert d.min() >= -128 and d.max() <= 127
    np.testing.assert_array_equal((d * (256 ** np.arange(4))[:, None]).sum(0), a)
    np.testing.assert_array_equal(d, mxu._bal_digits_host(a, 4))
    with pytest.raises(AssertionError):
        ntt_dense._bal_digits_host(np.array([EDGE + 1]), 4)
    big = tntt.get_ring(2048, Q)
    with pytest.raises(ValueError, match="DENSE_MAX_N"):
        ntt_dense.fwd_one_dense(big, 0, torch.zeros((1, 2048), dtype=torch.int32))
    ring = tntt.get_ring(64, Q)
    m = ntt_dense.operator(ring, 0, "mf", "cpu")
    with pytest.raises(ValueError):
        k_dense.dense_apply(ring, 0, m[:, :-1].contiguous(),
                            torch.zeros((1, 64), dtype=torch.int32))
    with pytest.raises(ValueError):
        k_dense.dense_apply(ring, 0, m, torch.zeros((1, 64), dtype=torch.int64))


@pytest.mark.parametrize("n", [32, 64, 512])
def test_dense_operator_packs_and_unpacks(n):
    """K10's operator [4N, 4N] as the sixteen planes (u, w) it multiplies
    digit u of x with into output plane w: they pack into the K-major tiles
    the kernel reads and unpack to the stored operator."""
    from ringzk_tpu_torch.ops.kernels import matvec as k_mv

    ring = tntt.get_ring(n, Q)
    for which in ("mf", "mi"):
        m = ntt_dense.operator(ring, 0, which, "cpu")
        planes = k_dense.dense_planes(m, n)
        assert all(torch.equal(planes[u, w], m[u * n:(u + 1) * n, w * n:(w + 1) * n])
                   for u in range(4) for w in range(4))
        packed = k_mv.pack_planes(planes)
        assert packed.shape == (-(-n // 64), n // 32, 16, 2, 64, 16)
        back = k_mv.unpack_planes(packed, n, n).reshape(4, 4, n, n)
        assert torch.equal(back.permute(0, 2, 1, 3).reshape(4 * n, 4 * n), m)
