"""The port's blocked digit operator and K6 against the JAX package.

Keys of ring degree N >= 1024 (at the default parameters) store their
digit planes in the blocked layout [4, kN, rowsN], whose matvec is K6. Here
K6's plain version meets the JAX package's column-blocked Pallas kernel
(interpret mode) and, independently, K3's plain version on the side-by-side
layout of the same key; the layout rule meets keygen and interop.
Integers throughout: the tolerance is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringzk_tpu.ops import conv_mxu as jconv
from ringzk_tpu.ops import ntt as jntt
from ringzk_tpu.ops.pallas import matvec_kernel
from ringzk_tpu_torch import Params, interop
from ringzk_tpu_torch.ops import conv_mxu as tconv
from ringzk_tpu_torch.ops import mat as tmat
from ringzk_tpu_torch.ops import ntt as tntt
from ringzk_tpu_torch.ops.kernels import matvec as k_mv
from ringzk_tpu_torch.protocols import commit as commit_mod

torch.set_num_threads(2)
Q = 3_515_337_053
N_DEG = 1024


def key(rng, rows, k, n):
    return rng.integers(-(Q // 2), Q // 2 + 1, size=(rows, k, n)).astype(np.int32)


def inputs(rng, batch, kn, v_digits):
    cap = tconv.digit_capacity(v_digits)
    v = rng.integers(-cap, cap + 1, size=(batch, kn)).astype(np.int32)
    v[0, :2] = [cap, -cap]
    return v


@pytest.mark.parametrize("v_digits,batch", [(1, 5), (2, 3), (3, 5), (4, 2)])
def test_colblock_plain_matches_pallas_interpret(v_digits, batch):
    """K6's plain version, reached through conv_mxu.matvec_digits on the
    blocked operator, equals the TPU kernel (interpret mode) bit for bit;
    every batch is ragged against the kernel's 128-row tile."""
    rng = np.random.default_rng(60 + v_digits)
    a = key(rng, 1, 3, N_DEG)
    v = inputs(rng, batch, 3 * N_DEG, v_digits).reshape(batch, 3, N_DEG)
    jring = jntt.get_ring(N_DEG, Q)
    jw3 = matvec_kernel.to_blocked_layout(jconv.build_operator_digits_device(a, jring))
    want = np.asarray(matvec_kernel.matvec_digits_colblock(jring, jw3, 1, jnp.asarray(v),
                                                           v_digits, interpret=True))
    tring = tntt.get_ring(N_DEG, Q)
    w3 = tconv.operator_planes(torch.from_numpy(a), tring).contiguous()
    np.testing.assert_array_equal(w3.numpy(), np.asarray(jw3))
    got = tconv.matvec_digits(tring, w3, 1, torch.from_numpy(v), v_digits)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows", [1, 2])
def test_colblock_plain_matches_k3_plain(rows):
    """The two layouts of one key, checked independently: K6's plain version
    on the blocked planes equals K3's on the side-by-side operator, and
    to_blocked_layout maps the one onto the other."""
    rng = np.random.default_rng(70 + rows)
    ring = tntt.get_ring(N_DEG, Q)
    a = torch.from_numpy(key(rng, rows, 3, N_DEG))
    w3 = tconv.operator_planes(a, ring).contiguous()
    w2 = tconv.build_operator_digits_device(a, ring)
    assert w3.shape == (4, 3 * N_DEG, rows * N_DEG) and w2.shape == (3 * N_DEG, 4 * rows * N_DEG)
    assert torch.equal(tconv.to_blocked_layout(w2), w3)
    for v_digits in (1, 2, 3, 4):
        v = torch.from_numpy(inputs(rng, 3, 3 * N_DEG, v_digits))
        got = k_mv.matvec_digits_colblock(ring, w3, rows * N_DEG, v, v_digits)
        assert torch.equal(got, k_mv.matvec_digits(ring, w2, rows * N_DEG, v, v_digits)), v_digits


def test_blocked_operator_matches_ntt_path(monkeypatch):
    """conv_mxu.matvec_digits routes the blocked operator to K6 (never K3),
    with leading axes flattened into its batch, and agrees with the exact NTT
    matvec."""
    rng = np.random.default_rng(80)
    ring = tntt.get_ring(N_DEG, Q)
    a = torch.from_numpy(key(rng, 1, 3, N_DEG))
    w3 = tconv.operator_planes(a, ring).contiguous()
    v = torch.from_numpy(rng.integers(-1000, 1001, size=(2, 3, 3, N_DEG)).astype(np.int32))
    called = []
    monkeypatch.setattr(k_mv, "matvec_digits", lambda *args: called.append(args))
    got = tconv.matvec_digits(ring, w3, 1, v, 2)
    assert not called and got.shape == (2, 3, 1, N_DEG)
    want = tmat.matvec(ring, ring.fwd_const(a), ring.fwd(v))
    assert torch.equal(got, want)


def test_layout_rule():
    """Blocked exactly past the JAX package's 8 MiB resident gate, with
    dimensions that are multiples of 128."""
    assert tconv.W_VMEM_BUDGET == matvec_kernel.W_VMEM_BUDGET
    assert not tconv.blocked_layout_ok(1, 3, 512)
    for n in (1024, 2048, 4096):
        assert tconv.blocked_layout_ok(1, 3, n)
    assert matvec_kernel.blocked_layout_ok(1, 3, 1024, jconv.KEY_DIGITS)
    assert tconv.blocked_layout_ok(1, 40, 256)       # 10.5 MB, aligned
    assert not tconv.blocked_layout_ok(1, 600, 64)   # 9.8 MB, N not a multiple of 128
    assert not tconv.blocked_layout_ok(1, 2, 512)    # 2 MB


@pytest.mark.parametrize("n_deg,shape", [(512, (3 * 512, 4 * 512)),
                                         (1024, (4, 3 * 1024, 1024))])
def test_keygen_and_interop_store_one_layout(n_deg, shape):
    """keygen stores the side-by-side operator at N=512 and the blocked one
    at N=1024; interop builds the same key, layout included."""
    params = Params()
    gen = torch.Generator().manual_seed(n_deg)
    ck = commit_mod.keygen(gen, params, n_deg, "cpu")
    assert ck.a1_dig.shape == ck.a2_dig.shape == shape
    assert ck.a1_dig.is_contiguous() and ck.a1_dig.dtype == torch.int8
    ref = interop.commitment_key_from_numpy(ck.a1.numpy(), ck.a2.numpy(), params, "cpu")
    for got, want in zip(ck, ref):
        assert torch.equal(got, want)


def test_colblock_wrapper_checks_input():
    ring = tntt.get_ring(16, Q)
    w3 = torch.zeros((4, 48, 16), dtype=torch.int8)
    v = torch.zeros((2, 48), dtype=torch.int32)
    assert k_mv.matvec_digits_colblock(ring, w3, 16, v, 1).shape == (2, 16)
    with pytest.raises(ValueError):
        k_mv.matvec_digits_colblock(ring, w3, 16, v.to(torch.int64), 1)
    with pytest.raises(ValueError):
        k_mv.matvec_digits_colblock(ring, w3, 16, v, 5)
    with pytest.raises(ValueError):
        k_mv.matvec_digits_colblock(ring, w3[:, :, :12], 16, v, 1)
    with pytest.raises(ValueError):
        k_mv.matvec_digits_colblock(ring, w3.reshape(48, 64), 16, v, 1)
    with pytest.raises(ValueError):
        k_mv.matvec_digits_colblock(ring, torch.zeros((4, 16, 48), dtype=torch.int8)
                                    .transpose(1, 2), 16, v, 1)


@pytest.mark.parametrize("rows,n", [(1, 16), (1, 1024), (2, 128)])
def test_both_layouts_pack_to_one_tensor(rows, n):
    """The side-by-side [kN, 4*rowsN] and blocked [4, kN, rowsN] layouts of
    one key pack to the same tensor (the one K3 and K6 read), and unpacking
    gives the stored planes back."""
    rng = np.random.default_rng(rows + n)
    ring = tntt.get_ring(n, Q)
    planes = tconv.operator_planes(torch.from_numpy(key(rng, rows, 3, n)), ring)
    side = tconv._planes_side_by_side(planes)
    blocked = tconv.to_blocked_layout(side)
    packed = k_mv.pack_planes(blocked)
    assert torch.equal(k_mv.pack_planes(k_mv.key_planes(side, rows * n)), packed)
    kn, rows_n = 3 * n, rows * n
    assert packed.shape == (-(-rows_n // 64), -(-kn // 32), 4, 2, 64, 16)
    assert torch.equal(k_mv.unpack_planes(packed, kn, rows_n), blocked)
    assert torch.equal(k_mv.unpack_planes(packed, kn, rows_n).permute(1, 0, 2)
                       .reshape(kn, 4 * rows_n), side)


@pytest.mark.parametrize("kn,rows_n", [(48, 16), (96, 200), (3072, 1024)])
def test_packed_block_layout(kn, rows_n):
    """Where the kernels read W_dw[k, c]: block (c // 64, k // 32), plane dw
    at 2 KB, the k half at 1 KB (the descriptors' leading byte offset),
    column c % 64 at 16 bytes (8 columns: the 128-byte stride offset), byte
    k % 16; zero past kN and rowsN."""
    rng = np.random.default_rng(kn + rows_n)
    planes = torch.from_numpy(rng.integers(-128, 128, size=(4, kn, rows_n)).astype(np.int8))
    flat = k_mv.pack_planes(planes).reshape(-1)
    ks = -(-kn // 32)
    dw, k, c = (rng.integers(0, m, size=4096) for m in (4, kn, rows_n))
    off = (((c // 64) * ks + k // 32) * 8192 + dw * 2048 + (k % 32 // 16) * 1024
           + (c % 64) * 16 + k % 16)
    assert torch.equal(flat[torch.from_numpy(off)], planes[dw, k, c])
    assert int(flat.abs().sum()) == int(planes.abs().sum())   # the padding is zero


def test_packed_twin_follows_the_operator():
    """The wrapper's packed twin is built once per operator tensor and
    rebuilt after the operator is written to."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.integers(-128, 128, size=(4, 96, 64)).astype(np.int8))
    first = k_mv.packed_operator(w, w)
    assert k_mv.packed_operator(w, w) is first
    w[0, 0, 0] += 1
    again = k_mv.packed_operator(w, w)
    assert again is not first and torch.equal(again, k_mv.pack_planes(w))
