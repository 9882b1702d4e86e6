"""The port's CUDA kernels on the card: each against its plain version.

Every test needs a CUDA GPU and skips without one. This file imports no
jax, so it runs where only torch is installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ringzk_tpu_torch import Params, interop
from ringzk_tpu_torch.ops import conv_mxu, kernels, ntt_dense, sampling
from ringzk_tpu_torch.ops.kernels import challenge as k_chal
from ringzk_tpu_torch.ops.kernels import mac as k_mac
from ringzk_tpu_torch.ops.kernels import matvec as k_mv
from ringzk_tpu_torch.ops.kernels import ntt as k_ntt
from ringzk_tpu_torch.ops.kernels import ntt_dense as k_dense
from ringzk_tpu_torch.ops.kernels import ntt_one as k_one
from ringzk_tpu_torch.ops.kernels import ntt_wide as k_wide
from ringzk_tpu_torch.ops.kernels import scalar_mul_add as k_sma
from ringzk_tpu_torch.ops.ntt import get_ring
from ringzk_tpu_torch.protocols import commit as commit_mod
from ringzk_tpu_torch.protocols import linear
from ringzk_tpu_torch.protocols import open as open_mod
from ringzk_tpu_torch.protocols import sum as sum_mod
from ringzk_tpu_torch.utils import serial
from ntt_wrap_rows import wrap_rows
from range_names import phase_names, want_op_names

pytestmark = pytest.mark.cuda
Q = 3_515_337_053
Q33, Q63 = 2**33 + 9, 9223372036854775783   # wide rings
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def centered(rng, shape, bound=Q // 2):
    return torch.from_numpy(rng.integers(-bound, bound + 1, size=shape).astype(np.int32))


@pytest.mark.parametrize("rows", [1, 37])
@pytest.mark.parametrize("n", [4, 8, 16, 128, 256, 512, 1024, 4096, 8192])
def test_ntt_kernels_match_plain(cuda, n, rows):
    """K1 and K2 at the default modulus, 32749 and 2^32 - 5, every prime
    count, at every plan of the register transform (E = 4, 8, 16; lanes
    repeating below N=128; groups of up to 512 threads; at N=8192 and
    num=3 K2's 96 KB tile), on a row count that is no multiple of K1's
    four groups a block. K1 also at int32's extremes, K2 also at p - 1 in
    every plane and on K1's images."""
    rng = np.random.default_rng(n + rows)
    for q in (Q, 32749, 2**32 - 5):
        ring = get_ring(n, q)
        x = rng.integers(-2**31, 2**31, size=(rows, n)).astype(np.int32)
        x[0, :min(n, 4)] = [-2**31, 2**31 - 1, 0, -1][:min(n, 4)]
        x = torch.from_numpy(x).to(cuda)
        for num in (1, 2, 3):
            h = k_ntt.fwd_all(ring, x, num)
            assert torch.equal(h, k_ntt.fwd_all_plain(ring, x, num)), (q, num)
            assert torch.equal(k_ntt.inv_all(ring, h), k_ntt.inv_all_plain(ring, h)), (q, num)
            res = np.stack([rng.integers(0, p, size=(rows, n)) for p in ring.primes[:num]])
            res[:, -1, : n // 2] = np.array(ring.primes[:num])[:, None] - 1
            res[:, 0, -1] = 0
            res = torch.from_numpy(res.astype(np.uint32).view(np.int32)).to(cuda)
            assert torch.equal(k_ntt.inv_all(ring, res), k_ntt.inv_all_plain(ring, res)), (q, num)
        xc = centered(rng, (rows, n), q // 2).to(cuda)
        assert torch.equal(ring.inv(ring.fwd(xc)), xc), q
        # against the CPU's plain versions (left out at N=8192, where the
        # CPU's plain product is slow)
        if n <= 4096:
            assert torch.equal(ring.polymul(xc, xc).cpu(), ring.polymul(xc.cpu(), xc.cpu())), q


@pytest.mark.parametrize("rows", [1, 37])
@pytest.mark.parametrize("n", [4, 8, 16, 128, 256, 512, 1024, 4096, 8192])
def test_wide_ntt_kernels_match_plain(cuda, n, rows):
    """K7 and K8 at q = 2^33+9 (num 1-3) and the largest prime below 2^63
    (num 1-5, the fifth prime above 2^30: strict butterflies), at every
    plan of the register transform (E = 4, 8, 16; one warp; groups of up
    to 512 threads; at N=8192 and num=5 K8's 160 KB tile), on a row count
    that is no multiple of a block's groups. K7 also at int64's extremes,
    K8 also at 0 and p-1 of every prime; K8 inverts K7."""
    rng = np.random.default_rng(n + rows)
    for q in (Q33, Q63):
        ring = get_ring(n, q)
        x = rng.integers(-(q // 2), q // 2 + 1, size=(rows, n), dtype=np.int64)
        edges = [q // 2, -(q // 2), 2**63 - 1, -2**63, 0, -1]
        x[0, :min(n, 6)] = edges[:min(n, 6)]
        x = torch.from_numpy(x).to(cuda)
        for num in range(1, ring.num_primes + 1):
            h = k_wide.fwd_wide_all(ring, x, num)
            assert torch.equal(h, k_wide.fwd_wide_all_plain(ring, x, num)), (q, num)
            res = np.stack([rng.integers(0, p, size=(rows, n)) for p in ring.primes[:num]])
            res[:, -1, : n // 2] = np.array(ring.primes[:num])[:, None] - 1
            res[:, 0, -1] = 0
            res = torch.from_numpy(res.astype(np.uint32).view(np.int32)).to(cuda)
            assert torch.equal(k_wide.inv_wide_all(ring, res),
                               k_wide.inv_wide_all_plain(ring, res)), (q, num)
        back = k_wide.inv_wide_all(ring, h)
        assert torch.equal(back, k_wide.inv_wide_all_plain(ring, h)), q
        centered_cols = [j for j in (0, 1, 4, 5) if j < n]  # row 0's values inside (-q/2, q/2)
        assert torch.equal(back[1:], x[1:]), q
        assert torch.equal(back[0, centered_cols], x[0, centered_cols]), q
        # through the ring's entry points, and against the CPU's plain versions
        # (left out at N=8192, where the CPU's plain product is slow)
        back = ring.inv(ring.fwd(x))
        assert torch.equal(back[1:], x[1:]), q
        assert torch.equal(back[0, centered_cols], x[0, centered_cols]), q
        if n <= 4096:
            assert torch.equal(ring.polymul(x, x).cpu(), ring.polymul(x.cpu(), x.cpu())), q


@pytest.mark.parametrize("rows", [1, 37])
@pytest.mark.parametrize("n", [4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192])
def test_ntt_one_kernel_matches_plain(cuda, n, rows):
    """K9 forward and inverse at every prime of q = 3515337053, 32749,
    2^32 - 5, 2^33 + 9 and 2^63 - 25 (whose extension primes 469762049 and
    2013265921, the latter at or above 2^30), at every plan of the register
    transform, on residues, on any uint32 and on rows crafted to reach the
    wrap of MontCtx.sub (tests/ntt_wrap_rows.py); on residues inv_one
    inverts fwd_one, and on the narrow rings fwd_one is plane i of K1's
    images."""
    rng = np.random.default_rng(n + rows)
    for q in (Q, 32749, 2**32 - 5, Q33, Q63):
        ring = get_ring(n, q)
        for i, p in enumerate(ring.primes):
            for kind in ("residues", "any-uint32", "wrap"):
                if kind == "wrap":
                    x = wrap_rows(rows, n, p, rng)
                else:
                    hi = p if kind == "residues" else 2**32
                    x = rng.integers(0, hi, size=(rows, n), dtype=np.uint64).astype(np.uint32)
                x = torch.from_numpy(x.view(np.int32)).to(cuda)
                h = k_one.fwd_one(ring, i, x)
                assert torch.equal(h, k_one.fwd_one_plain(ring, i, x)), (q, i, kind)
                assert torch.equal(k_one.inv_one(ring, i, x),
                                   k_one.inv_one_plain(ring, i, x)), (q, i, kind)
                if kind == "residues":
                    assert torch.equal(k_one.inv_one(ring, i, h), x), (q, i)
                    if q < 2**32:
                        assert torch.equal(h, k_ntt.fwd_all(ring, x, 3)[i]), (q, i)


@pytest.mark.parametrize("n", [32, 64, 128, 256, 512, 1024])
def test_dense_kernel_matches_plain(cuda, n):
    """K10 forward and inverse at every prime, ragged 77 rows, inputs up to
    the 4-digit capacity; both equal K9 on the same inputs."""
    rng = np.random.default_rng(n + 4)
    ring = get_ring(n, Q)
    edge = conv_mxu.digit_capacity(4)
    x = rng.integers(-(Q // 2), Q // 2 + 1, size=(77, n)).astype(np.int32)
    x[0, :2] = [edge, -edge]
    x = torch.from_numpy(x).to(cuda)
    for i, p in enumerate(ring.primes):
        h = ntt_dense.fwd_one_dense(ring, i, x)
        assert torch.equal(h, k_dense.dense_apply_plain(
            ring, i, ntt_dense.operator(ring, i, "mf", cuda), x)), (n, i)
        xr = torch.remainder(x.to(torch.int64), p).to(torch.int32)
        assert torch.equal(h, k_one.fwd_one(ring, i, xr)), (n, i)
        back = ntt_dense.inv_one_dense(ring, i, h)
        assert torch.equal(back, k_dense.dense_apply_plain(
            ring, i, ntt_dense.operator(ring, i, "mi", cuda), h)), (n, i)
        assert torch.equal(back, xr), (n, i)


def test_mac_kernel_matches_plain(cuda):
    """K11 over a shape that is no multiple of its block, and at the
    calibration's shape."""
    rng = np.random.default_rng(64)
    for shape in ((37, 100), (3 * 8192, 512)):
        x = torch.from_numpy(rng.integers(-2**31, 2**31, size=shape).astype(np.int32)).to(cuda)
        assert torch.equal(k_mac.mac_chain(x), k_mac.mac_chain_plain(x)), shape


@pytest.mark.parametrize("n,batch", [(16, 5), (512, 77), (1024, 130)])
def test_matvec_kernel_matches_plain(cuda, n, batch):
    """Ragged batch and column tiles, every digit count."""
    rng = np.random.default_rng(n + batch)
    ring = get_ring(n, Q)
    for rows in (1, 2):
        w = conv_mxu.build_operator_digits_device(centered(rng, (rows, 3, n)).to(cuda), ring)
        for nd in (1, 2, 3, 4):
            v = centered(rng, (batch, 3 * n), conv_mxu.digit_capacity(nd)).to(cuda)
            got = k_mv.matvec_digits(ring, w, rows * n, v, nd)
            assert torch.equal(got, k_mv.matvec_digits_plain(ring, w, rows * n, v, nd))


@pytest.mark.parametrize("n", [1024, 2048, 4096])
def test_colblock_kernel_matches_plain(cuda, n):
    """K6 on the blocked operator of N = 1024-4096 keys, rows 1 and 2, every
    digit count, a ragged batch, and a column count cut to no multiple of
    the 64-column tile."""
    rng = np.random.default_rng(n + 7)
    ring = get_ring(n, Q)
    for rows in (1, 2):
        w3 = conv_mxu.operator_planes(centered(rng, (rows, 3, n)).to(cuda), ring).contiguous()
        for rows_n, w in ((rows * n, w3), (rows * n - 36, w3[:, :, 36:].contiguous())):
            for nd in (1, 2, 3, 4):
                v = centered(rng, (77, 3 * n), conv_mxu.digit_capacity(nd)).to(cuda)
                got = k_mv.matvec_digits_colblock(ring, w, rows_n, v, nd)
                want = k_mv.matvec_digits_colblock_plain(ring, w, rows_n, v, nd)
                assert torch.equal(got, want), (rows, rows_n, nd)


def ends(batch: int) -> torch.Tensor:
    """Row indices of a batch's first and last 128 rows (all rows of a
    small batch): where a large batch's check against the plain version
    looks."""
    if batch <= 256:
        return torch.arange(batch)
    return torch.cat([torch.arange(128), torch.arange(batch - 128, batch)])


@pytest.mark.parametrize("batch", [1, 63, 65, 131071])
@pytest.mark.parametrize("layout", ["side by side", "blocked"])
def test_matvec_ragged_batch(cuda, batch, layout):
    """K3 (side-by-side operator) and K6 (blocked operator, the same planes)
    at batches that are no multiple of the 128-row tile, every digit count,
    at N=512 (rows_n 512, kN 1536)."""
    rng = np.random.default_rng(batch)
    ring = get_ring(512, Q)
    planes = conv_mxu.operator_planes(centered(rng, (1, 3, 512)).to(cuda), ring)
    for nd in (1, 2, 3, 4):
        v = centered(rng, (batch, 3 * 512), conv_mxu.digit_capacity(nd)).to(cuda)
        rows = ends(batch).to(cuda)
        if layout == "blocked":
            w = planes.contiguous()
            got = k_mv.matvec_digits_colblock(ring, w, 512, v, nd)[rows]
            want = k_mv.matvec_digits_colblock_plain(ring, w, 512, v[rows], nd)
        else:
            w = conv_mxu._planes_side_by_side(planes)
            got = k_mv.matvec_digits(ring, w, 512, v, nd)[rows]
            want = k_mv.matvec_digits_plain(ring, w, 512, v[rows], nd)
        assert torch.equal(got, want), (batch, nd)


def test_matvec_smallest_shapes(cuda):
    """kN = 48 and rows_n = 16 (N=16): both under one tile, on both layouts."""
    rng = np.random.default_rng(16)
    ring = get_ring(16, Q)
    planes = conv_mxu.operator_planes(centered(rng, (1, 3, 16)).to(cuda), ring)
    for nd in (1, 2, 3, 4):
        v = centered(rng, (65, 48), conv_mxu.digit_capacity(nd)).to(cuda)
        w2 = conv_mxu._planes_side_by_side(planes)
        want = k_mv.matvec_digits_plain(ring, w2, 16, v, nd)
        assert torch.equal(k_mv.matvec_digits(ring, w2, 16, v, nd), want), nd
        assert torch.equal(k_mv.matvec_digits_colblock(ring, planes.contiguous(), 16, v, nd),
                           want), nd


@pytest.mark.parametrize("n", [512, 4096])
def test_matvec_extreme_group_sums(cuda, n):
    """The largest shift-group sums: every key digit -128 or 127 and every
    input at +-capacity (all digits +-127), for each digit count; K3 at
    N=512, K6 at N=4096."""
    ring = get_ring(n, Q)
    kn = 3 * n
    rows = torch.arange(64, device=cuda)
    for fill in (-128, 127):
        planes = torch.full((4, kn, n), fill, dtype=torch.int8, device=cuda)
        for nd in (1, 2, 3, 4):
            cap = conv_mxu.digit_capacity(nd)
            v = torch.full((64, kn), cap, dtype=torch.int32, device=cuda)
            v[1::2] = -cap
            v[2, ::2] = -cap
            if n == 512:
                w = conv_mxu._planes_side_by_side(planes)
                got = k_mv.matvec_digits(ring, w, n, v, nd)
                want = k_mv.matvec_digits_plain(ring, w, n, v[rows], nd)
            else:
                got = k_mv.matvec_digits_colblock(ring, planes, n, v, nd)
                want = k_mv.matvec_digits_colblock_plain(ring, planes, n, v[rows], nd)
            assert torch.equal(got, want), (fill, nd)


def test_n1024_open_roundtrip_runs_k6_not_k3(cuda):
    """An N=1024 key holds the blocked operator: its open round trip
    verifies through K6 and never launches K3."""
    params = Params()
    gen = torch.Generator(device=cuda).manual_seed(6)
    ck = commit_mod.keygen(gen, params, 1024)
    assert ck.a1_dig.shape == (4, 3 * 1024, 1024)
    x = sampling.uniform_centered(gen, (200, params.l), 1024, params.q, cuda)
    kernels.reset_launches()
    ok, opening_ok = open_mod.roundtrip(gen, ck, x, params)
    assert ok.all() and opening_ok.all()
    assert kernels.LAUNCHES["matvec_colblock"] == 4 and kernels.LAUNCHES["matvec_digits"] == 0
    assert kernels.LAUNCHES["challenge_select"] > 0 and kernels.LAUNCHES["scalar_mul_add"] > 0


@pytest.mark.parametrize("q", [Q, 32749, 2**32 - 5])
@pytest.mark.parametrize("n", [16, 32, 64, 512, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 3, 12])
def test_scalar_mul_add_kernel_matches_plain(cuda, n, rows, q):
    """K5 at every prime count and every plan of its register transform
    (N=8192 also takes the largest shared-memory request), at the default
    modulus and at the narrow 32749 and 2^32 - 5 (the fold constants
    depend on q), with d over the centered range and m and t over the whole
    int32 range, and a batch (37) that is no multiple of any tile."""
    rng = np.random.default_rng(n + rows + (q % 1000 if q != Q else 0))
    ring = get_ring(n, q)
    full = np.iinfo(np.int32)
    d = centered(rng, (37, n), min(q // 2, full.max)).to(cuda)
    m = torch.from_numpy(rng.integers(full.min, full.max, size=(37, rows, n),
                                      endpoint=True).astype(np.int32)).to(cuda)
    t = torch.from_numpy(rng.integers(full.min, full.max, size=(37, rows, n),
                                      endpoint=True).astype(np.int32)).to(cuda)
    for num in (1, 2, 3):
        got = k_sma.scalar_mul_add(ring, d, m, t, num)
        assert torch.equal(got, k_sma.scalar_mul_add_plain(ring, d, m, t, num)), num
    if n <= 4096:  # the CPU's plain version, through the ring's entry point
        got = ring.scalar_mul_add(d, m, t, 3)
        assert torch.equal(got.cpu(), ring.scalar_mul_add(d.cpu(), m.cpu(), t.cpu(), 3))


@pytest.mark.parametrize("n,kappa,alphabet", [(16, 7, 2**32), (512, 36, 2**32),
                                              (512, 36, 3), (2048, 36, 5), (512, 511, 2),
                                              (4, 1, 2**32), (64, 63, 2**32), (512, 1, 2**32),
                                              (512, 511, 1), (1024, 36, 2**32),
                                              (8192, 36, 2**32), (8192, 1, 3),
                                              (8192, 8191, 2**32), (8192, 100, 1)])
def test_challenge_kernel_matches_plain(cuda, n, kappa, alphabet):
    """K4 from N=4 to 8192, kappa from 1 to N-1, a one-key alphabet (every
    lane of a row ties), on 50 rows (no multiple of a block's 8)."""
    rng = np.random.default_rng(n + kappa + alphabet % 97)
    u = rng.integers(0, alphabet, size=(50, n), dtype=np.uint64).astype(np.uint32)
    u = torch.from_numpy(u.view(np.int32)).to(cuda)
    signs = torch.from_numpy((1 - 2 * rng.integers(0, 2, size=(50, n))).astype(np.int32)).to(cuda)
    got = k_chal.challenge_select(u, signs, kappa)
    assert torch.equal(got, k_chal.challenge_select_plain(u, signs, kappa))
    assert (got.abs().sum(-1) == kappa).all()


def test_known_answers_on_card(cuda):
    """The JAX package's messages and verdicts, reproduced on the card."""
    kat = np.load(REPO / "ringzk_tpu_torch" / "kat_open_n512.npz")

    def T(name):
        a = kat[name]
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(cuda)

    params = Params()
    ck = interop.commitment_key_from_numpy(kat["a1"], kat["a2"], params, cuda)
    rctx, pcom = open_mod.prover_commit(None, ck, T("x"), params, r=T("r"), y=T("y"))
    vctx, chal = open_mod.generate_challenge(None, pcom, params, signs=T("signs"), u=T("u"))
    resp = open_mod.create_response(rctx, chal, params)
    for got, name in ((pcom.c.c, "c"), (pcom.t, "t"), (chal.d, "d"), (resp.z, "z"),
                      (open_mod.verify(ck, resp, vctx, params), "ok")):
        assert torch.equal(got, T(name)), name


@pytest.mark.parametrize("proto", ["linear", "sum"])
def test_linear_and_sum_known_answers_on_card(cuda, proto):
    kat = np.load(REPO / "ringzk_tpu_torch" / f"kat_{proto}_n512.npz")

    def T(name):
        a = kat[name]
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(cuda)

    params = Params()
    ck = interop.commitment_key_from_numpy(kat["a1"], kat["a2"], params)
    if proto == "linear":
        rctx, pcom = linear.prover_commit(None, ck, T("g"), T("x"), params, r=T("r"),
                                          rp=T("rp"), y=T("y"), yp=T("yp"))
        vctx, chal = linear.generate_challenge(None, pcom, params, signs=T("signs"), u=T("u"))
        resp = linear.create_response(rctx, chal, params)
        got = dict(c=pcom.c.c, cp=pcom.cp.c, t=pcom.t, u_msg=pcom.u, z=resp.z, zp=resp.zp,
                   ok=linear.verify(ck, resp, vctx, params))
    else:
        rctx, pcom = sum_mod.prover_commit(None, ck, T("gs"), T("xs"), params, rs=T("rs"),
                                           rp=T("rp"), ys=T("ys"), yp=T("yp"))
        vctx, chal = sum_mod.generate_challenge(None, pcom, params, signs=T("signs"),
                                                u=T("u"))
        resp = sum_mod.create_response(rctx, chal, params)
        got = dict(cp=pcom.cp.c, cs=pcom.cs.c, ts=pcom.ts, u_msg=pcom.u, zs=resp.zs,
                   zp=resp.zp, ok=sum_mod.verify(ck, resp, vctx, params))
    for name, value in got.items():
        assert torch.equal(value, T(name)), name


def test_roundtrip_runs_every_kernel(cuda):
    """Open, linear and sum round trips: each launches K3, K4 and K5; the
    wide open round trip launches K4, K7 and K8 and neither K3 nor K5; the
    N=1024 open round trip launches K6 and not K3; every protocol kernel
    (K1-K8) launches on at least one of them, and none of the calibration's
    K9-K11."""
    params, wide = Params(), Params(q=Q33 // 2, modulus=Q33)
    gen = torch.Generator(device=cuda).manual_seed(5)
    ck = commit_mod.keygen(gen, params, 512)
    ck33 = commit_mod.keygen(gen, wide, 512)
    ck1024 = commit_mod.keygen(gen, params, 1024)
    x = sampling.uniform_centered(gen, (300, params.l), 512, params.q, cuda)
    g = sampling.uniform_centered(gen, (300,), 512, params.q, cuda)
    xs = sampling.uniform_centered(gen, (100, 4, params.l), 512, params.q, cuda)
    gs = sampling.uniform_centered(gen, (100, 4), 512, params.q, cuda)
    xw = sampling.uniform_centered(gen, (300, wide.l), 512, wide.q, cuda)
    x1024 = sampling.uniform_centered(gen, (100, params.l), 1024, params.q, cuda)
    runs = {"open": lambda: open_mod.roundtrip(gen, ck, x, params),
            "linear": lambda: linear.roundtrip(gen, ck, g, x, params),
            "sum": lambda: sum_mod.roundtrip(gen, ck, gs, xs, params),
            "open q=2^33+9": lambda: open_mod.roundtrip(gen, ck33, xw, wide),
            "open N=1024": lambda: open_mod.roundtrip(gen, ck1024, x1024, params)}
    calibration = ("ntt_fwd_one", "ntt_inv_one", "ntt_dense", "mac_chain")
    seen = dict.fromkeys(kernels.LAUNCHES, 0)
    for name, run in runs.items():
        kernels.reset_launches()
        ok, opening_ok = run()
        assert ok.all() and opening_ok.all(), name
        wide_run, large = "q=" in name, "N=" in name
        matvec, other = ("matvec_colblock", "matvec_digits") if large else \
            ("matvec_digits", "matvec_colblock")
        runs_k = (("challenge_select", "ntt_fwd_wide", "ntt_inv_wide") if wide_run
                  else (matvec, "challenge_select", "scalar_mul_add"))
        for k in runs_k:
            assert kernels.LAUNCHES[k] > 0, (name, kernels.LAUNCHES)
        assert kernels.LAUNCHES[other] == 0, (name, kernels.LAUNCHES)
        if wide_run:
            assert kernels.LAUNCHES["matvec_digits"] == kernels.LAUNCHES["scalar_mul_add"] == 0
            assert (kernels.LAUNCHES["ntt_fwd_wide"], kernels.LAUNCHES["ntt_inv_wide"]) == (7, 6)
        for k, count in kernels.LAUNCHES.items():
            seen[k] += count
    assert all(count > 0 for k, count in seen.items() if k not in calibration), seen
    assert all(seen[k] == 0 for k in calibration), seen


def test_wide_known_answers_on_card(cuda):
    """The JAX package's wide open proof (q = 2^33+9), reproduced on the card."""
    kat = np.load(REPO / "ringzk_tpu_torch" / "kat_open_q2e33_n512.npz")

    def T(name):
        a = kat[name]
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(cuda)

    params = Params(q=Q33 // 2, modulus=Q33)
    ck = interop.commitment_key_from_numpy(kat["a1"], kat["a2"], params, cuda)
    rctx, pcom = open_mod.prover_commit(None, ck, T("x"), params, r=T("r"), y=T("y"))
    vctx, chal = open_mod.generate_challenge(None, pcom, params, signs=T("signs"), u=T("u"))
    resp = open_mod.create_response(rctx, chal, params)
    for got, name in ((pcom.c.c, "c"), (pcom.t, "t"), (chal.d, "d"), (resp.z, "z"),
                      (open_mod.verify(ck, resp, vctx, params), "ok")):
        assert torch.equal(got, T(name)), name


@pytest.mark.parametrize("proto,fname,modulus", [
    ("linear", "kat_linear_n2048.npz", None),
    ("open", "kat_open_q2e33_n8192.npz", Q33),
    ("open", "kat_open_q2e63_n4096.npz", Q63)])
def test_config_known_answers_on_card(cuda, proto, fname, modulus):
    """One known-answer file of scripts/make_torch_kat.py's KAT_CONFIGS per
    ring family, replayed on the card: the default ring at N=2048 (K1/K2,
    K6 on the 50 MB operator), q = 2^33+9 at N=8192 and q = 2^63-25 at
    N=4096 (K7/K8 at three and five primes). Every message and verdict,
    the tampered probes' included, equals the JAX package's."""
    from torch_replay import T, kat_key, replay

    kat = dict(np.load(REPO / "ringzk_tpu_torch" / fname))
    params = Params() if modulus is None else Params(q=modulus // 2, modulus=modulus)
    kernels.reset_launches()
    got = replay(proto, kat, params, kat_key(kat, params, cuda), cuda)
    want = (("ntt_fwd", "ntt_inv", "matvec_colblock") if modulus is None
            else ("ntt_fwd_wide", "ntt_inv_wide"))
    assert all(kernels.LAUNCHES[k] > 0 for k in want), kernels.LAUNCHES
    assert got["ok"].all() and not any(got[k].any() for k in got if k.startswith("ok_"))
    for name, value in got.items():
        assert torch.equal(value.cpu(), T(kat[name])), name


@pytest.mark.parametrize("name", ["default", "q15_32749", "q32_2p32m5", "q33_wide"])
def test_golden_transcripts_on_card(cuda, name):
    """The four transcript goldens (tests/golden/transcripts.json) on the
    card, from the JAX package's draws in kat_golden_n16.npz, through the
    object API; the digests are taken of the card's tensors."""
    import json

    import ringzk_tpu_torch as rt
    from ringzk_tpu_torch.utils.testvectors import transcript_digest

    want = json.loads((REPO / "tests" / "golden" / "transcripts.json").read_text())[name]
    with np.load(REPO / "ringzk_tpu_torch" / "kat_golden_n16.npz") as kat:
        g = {k.split(".", 1)[1]: kat[k] for k in kat.files if k.startswith(name + ".")}

    def T(k):
        return torch.from_numpy(g[k].view(np.int32) if g[k].dtype == np.uint32 else g[k]).to(cuda)

    m = int(g["modulus"])
    params = Params() if m == Q else Params(q=m // 2, modulus=m)
    ck = interop.commitment_key_from_numpy(g["a1"], g["a2"], params, cuda)
    prover, verifier = rt.OpenProofProver(ck, params), rt.OpenProofVerifier(ck, params)
    rctx, pcom = prover.commit(None, T("x"), r=T("r"), y=T("y"))
    vctx, chal = verifier.generate_challenge(None, pcom, signs=T("signs"), u=T("u"))
    resp = prover.create_response(rctx, chal)
    assert pcom.t.is_cuda and resp.z.is_cuda
    assert bool(verifier.verify(resp, vctx).all())
    got = {"ck": transcript_digest({"a1": ck.a1, "a2": ck.a2}),
           "proof_commitment": transcript_digest(pcom),
           "challenge": transcript_digest(chal), "response": transcript_digest(resp)}
    assert got == want


def test_chained_open_roundtrip_on_card(cuda):
    """open.roundtrip at chains=4 on the card: every proof and opening
    verifies, K3, K4 and K5 launch, and the result is the chains' own
    unchained round trips concatenated."""
    params = Params()
    gen = torch.Generator(device=cuda).manual_seed(8)
    ck = commit_mod.keygen(gen, params, 512)
    x = sampling.uniform_centered(gen, (4096, params.l), 512, params.q, cuda)
    kernels.reset_launches()
    ok, opening_ok = open_mod.roundtrip(torch.Generator(device=cuda).manual_seed(3), ck, x,
                                        params, chains=4)
    assert ok.shape == (4096,) and bool(ok.all()) and bool(opening_ok.all())
    for k in ("matvec_digits", "challenge_select", "scalar_mul_add"):
        assert kernels.LAUNCHES[k] >= 4, kernels.LAUNCHES
    gens = commit_mod.chain_generators(torch.Generator(device=cuda).manual_seed(3), 4)
    parts = [open_mod.roundtrip(g, ck, xc, params) for g, xc in zip(gens, x.split(1024))]
    assert torch.equal(ok, torch.cat([p[0] for p in parts]))
    assert torch.equal(opening_ok, torch.cat([p[1] for p in parts]))


def test_dp_world_one_over_nccl_on_card(cuda, tmp_path):
    """The dp entry points in a one-rank NCCL group on the card: open,
    linear and sum verify, each equal to the one-process round trip on the
    rank's generator (chain_generators(gen, 1)[0]); the AND-reduce turns
    false on a forged proof; batch_verify_run verifies."""
    from ringzk_tpu_torch.parallel import mesh as mesh_mod
    from ringzk_tpu_torch.parallel import multihost

    assert multihost.init_distributed(f"file://{tmp_path}/rendezvous", 1, 0) == (0, 1)
    try:
        mesh = multihost.global_mesh()
        assert mesh.device == torch.device("cuda", 0) and mesh.world_size == 1
        params = Params()
        gen = torch.Generator(device=cuda).manual_seed(6)
        ck = mesh_mod.replicate(mesh, commit_mod.keygen(gen, params, 512), params)
        x = sampling.uniform_centered(gen, (1024, params.l), 512, params.q, cuda)
        g = sampling.uniform_centered(gen, (1024,), 512, params.q, cuda)
        xs = sampling.uniform_centered(gen, (256, 4, params.l), 512, params.q, cuda)
        gs = sampling.uniform_centered(gen, (256, 4), 512, params.q, cuda)
        for batched, mod, data in ((mesh_mod.batched_open_prove_verify, open_mod, (x,)),
                                   (mesh_mod.batched_linear_prove_verify, linear, (g, x)),
                                   (mesh_mod.batched_sum_prove_verify, sum_mod, (gs, xs))):
            ok, all_ok = batched(mesh, torch.Generator(device=cuda).manual_seed(1), ck, *data,
                                 params)
            ok = mesh_mod.gather_ok(mesh, ok)
            g0 = commit_mod.chain_generators(torch.Generator(device=cuda).manual_seed(1), 1)[0]
            want, op_ok = mod.roundtrip(g0, ck, *data, params)
            assert torch.equal(ok, want & op_ok) and bool(ok.all()) and bool(all_ok)
        assert not bool(mesh_mod.all_verified(mesh, torch.tensor([True, False], device=cuda)))
        out = multihost.batch_verify_run(total_batch=2048, n_deg=512, iters=1)
        assert out["all_ok"] is True and out["n_devices"] == 1 and out["chains"] == 1
    finally:
        torch.distributed.destroy_process_group()


def test_batched_keys_on_card(cuda):
    """One key per proof on the card (open and linear, 64 keys; sum, 8 keys
    of B=8 proofs of V=8 summands): every message and verdict equal to the
    CPU's plain versions given the card's draws; a forged response
    rejects."""
    params = Params()
    gen = torch.Generator(device=cuda).manual_seed(11)
    for proto, k in (("open", 64), ("linear", 64), ("sum", 8)):
        ck = commit_mod.keygen(gen, params, 512, batch_shape=(k,))
        assert ck.a1_dig is None and ck.a1_hat.is_cuda
        cck = interop.commitment_key_from_numpy(ck.a1.cpu().numpy(), ck.a2.cpu().numpy(),
                                                params, "cpu")
        mod = {"open": open_mod, "linear": linear, "sum": sum_mod}[proto]
        if proto == "sum":
            data = (sampling.uniform_centered(gen, (k, k), 512, params.q, cuda),
                    sampling.uniform_centered(gen, (k, k, params.l), 512, params.q, cuda))
        else:
            data = ((sampling.uniform_centered(gen, (k,), 512, params.q, cuda),)
                    if proto == "linear" else ()) + (
                sampling.uniform_centered(gen, (k, params.l), 512, params.q, cuda),)
        rctx, pcom = mod.prover_commit(gen, ck, *data, params)
        signs, u = sampling.challenge_draws(gen, (k,), 512, cuda)
        vctx, chal = mod.generate_challenge(None, pcom, params, signs=signs, u=u)
        resp = mod.create_response(rctx, chal, params)
        ok = mod.verify(ck, resp, vctx, params)
        zname = "zs" if proto == "sum" else "z"
        forged = getattr(resp, zname).clone()
        forged[..., 0, 0] += 1
        assert bool(ok.all())
        assert not bool(mod.verify(ck, resp._replace(**{zname: forged}), vctx, params).any())
        draws = {"open": ("r", "y"), "linear": ("r", "rp", "y", "yp"),
                 "sum": ("rs", "rp", "ys", "yp")}[proto]
        if proto == "open":
            values = (rctx.opening.r, rctx.y)
        elif proto == "linear":
            values = (rctx.opening.r, rctx.opening_p.r, rctx.y, rctx.yp)
        else:
            values = (rctx.openings.r, rctx.opening_p.r, rctx.ys, rctx.yp)
        crctx, cpcom = mod.prover_commit(None, cck, *(a.cpu() for a in data), params,
                                         **{n: v.cpu() for n, v in zip(draws, values)})
        cvctx, cchal = mod.generate_challenge(None, cpcom, params, signs=signs.cpu(), u=u.cpu())
        cresp = mod.create_response(crctx, cchal, params)
        for mine, plain in ((pcom, cpcom), (chal, cchal), (resp, cresp)):
            assert serial.dumps(mine) == serial.dumps(plain), (proto, type(mine).__name__)
        assert torch.equal(ok.cpu(), mod.verify(cck, cresp, cvctx, params))


@pytest.mark.parametrize("n,sp", [(64, 2), (1024, 4), (1024, 8), (8192, 2), (8192, 4)])
def test_sp_local_stages_kernel_matches_plain(cuda, n, sp):
    """K9 with each rank's table (the sp axis's local stages) against the
    plain ``_local_stage`` network and K9's plain version on the same
    table, forward and inverse, at every prime and rank; a block below
    K9's four lanes raises on the card."""
    from ringzk_tpu_torch.parallel import ntt_sp

    rng = np.random.default_rng(n + sp)
    ring = get_ring(n, Q)
    for i, p in enumerate(ring.primes):
        for dev in range(sp):
            x = rng.integers(0, p, size=(37, n // sp), dtype=np.uint64).astype(np.uint32)
            x = torch.from_numpy(x.view(np.int32)).to(cuda)
            for kern, net, tab in ((ntt_sp.fwd_local, ntt_sp.fwd_local_plain,
                                    ntt_sp.fwd_table_plain),
                                   (ntt_sp.inv_local, ntt_sp.inv_local_plain,
                                    ntt_sp.inv_table_plain)):
                got = kern(ring, i, sp, dev, x)
                assert torch.equal(got, net(ring, i, sp, dev, x)), (i, dev, kern.__name__)
                assert torch.equal(got, tab(ring, i, sp, dev, x)), (i, dev, kern.__name__)
    x = torch.zeros((3, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="N_loc=2 .* sp=4"):
        ntt_sp.fwd_local(get_ring(8, Q), 0, 4, 0, x)


def test_sp_world_one_over_nccl_on_card(cuda, tmp_path):
    """The sp entry points at sp = 1 in a one-rank NCCL group on the card,
    N=1024: open, linear and sum launch K9 and K4 and none of K1, K2, K3,
    K5, K6, and equal the unsharded round trip on the rank's generator."""
    from ringzk_tpu_torch.parallel import multihost, protocol_sp

    assert multihost.init_distributed(f"file://{tmp_path}/rendezvous", 1, 0) == (0, 1)
    try:
        mesh = protocol_sp.make_sp_mesh(1, 1)
        params, n = Params(), 1024
        gen = torch.Generator(device=cuda).manual_seed(8)
        ck = commit_mod.keygen(gen, params, n)
        x = sampling.uniform_centered(gen, (64, params.l), n, params.q, cuda)
        g = sampling.uniform_centered(gen, (64,), n, params.q, cuda)
        xs = sampling.uniform_centered(gen, (16, 3, params.l), n, params.q, cuda)
        gs = sampling.uniform_centered(gen, (16, 3), n, params.q, cuda)
        for entry, mod, data in ((protocol_sp.open_roundtrip_sp, open_mod, (x,)),
                                 (protocol_sp.linear_roundtrip_sp, linear, (g, x)),
                                 (protocol_sp.sum_roundtrip_sp, sum_mod, (gs, xs))):
            kernels.reset_launches()
            ok, all_ok = entry(mesh, torch.Generator(device=cuda).manual_seed(2), ck, *data,
                               params)
            counts = dict(kernels.LAUNCHES)
            assert counts["ntt_fwd_one"] and counts["ntt_inv_one"] and counts["challenge_select"]
            assert not any(counts[c] for c in ("ntt_fwd", "ntt_inv", "matvec_digits",
                                               "scalar_mul_add", "matvec_colblock")), counts
            g0 = commit_mod.chain_generators(torch.Generator(device=cuda).manual_seed(2), 1)[0]
            want, op_ok = mod.roundtrip(g0, ck, *data, params)
            assert torch.equal(ok, want & op_ok) and bool(ok.all()) and bool(all_ok)
    finally:
        torch.distributed.destroy_process_group()


def test_native_codec_on_card_response(cuda):
    """An open response made on the card goes through the native RZK1 codec
    after ``.cpu()``: the bytes equal the plain codec's and rebuild on the
    card exactly."""
    params = Params()
    gen = torch.Generator(device=cuda).manual_seed(9)
    ck = commit_mod.keygen(gen, params, 512)
    x = sampling.uniform_centered(gen, (4096, params.l), 512, params.q, cuda)
    rctx, pcom = open_mod.prover_commit(gen, ck, x, params)
    resp = open_mod.create_response(rctx, open_mod.generate_challenge(gen, pcom, params)[1],
                                    params)
    z = resp.z.cpu().numpy()
    assert z.shape[0] * z.shape[1] >= serial._MT_ROWS   # the threaded encoder
    assert serial.encode_rows(z) == serial._encode_rows_numpy(z)
    import chip_smoke

    for obj in (resp, rctx):
        back = serial.rebuild(type(obj), serial.loads(serial.dumps(obj)), device=cuda)
        assert chip_smoke._same(back, obj)


def test_phase_ranges_on_the_device_timeline(cuda):
    """A profiled open round trip records on the host exactly its six phase
    ranges, its round-trip range and the op ranges its phases run, each op
    under its phase's name (``open_proof/verify/key_matvec``) and each name
    under one parent; on the device timeline only ranges the host
    recorded. ``chip_smoke.device_split`` counts none of those spans as
    device work, and the device time under the ranges is part of it."""
    import chip_smoke
    from ringzk_tpu_torch.utils import profiling
    from torch.profiler import ProfilerActivity, profile

    params = Params()
    gen = torch.Generator(device=cuda).manual_seed(10)
    ck = commit_mod.keygen(gen, params, 512)
    x = sampling.uniform_centered(gen, (2048, params.l), 512, params.q, cuda)
    phases = phase_names("open")
    want = phases | {"open_proof/roundtrip"} | want_op_names("open", "roundtrip")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        open_mod.roundtrip(gen, ck, x, params)
        torch.cuda.synchronize()
    events = prof.events()
    ups = {}
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA or not e.is_user_annotation
                or ":" in e.name):
            continue
        up = e.cpu_parent
        while up is not None and not up.is_user_annotation:
            up = up.cpu_parent
        ups.setdefault(e.name, set()).add(None if up is None else up.name)
    spans = {e.name for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA and e.is_user_annotation}
    assert set(ups) == want, (sorted(set(ups) - want), sorted(want - set(ups)))
    assert ups["open_proof/roundtrip"] == {None}
    assert ups["commit_scheme/commit"] == {"open_proof/commit"}
    for name in want - phases - {"open_proof/roundtrip"}:
        assert ups[name] == {name.rpartition("/")[0]}, (name, ups[name])
    for name in phases - {"commit_scheme/commit"}:
        assert ups[name] == {"open_proof/roundtrip"}, (name, ups[name])
    assert {f"{p}/key_matvec" for p in ("commit_scheme/commit", "open_proof/commit",
                                        "open_proof/verify")} <= spans <= want
    assert not any(e.is_user_annotation or e.name in want
                   for e in profiling.device_work(events))
    split = chip_smoke.device_split(lambda: open_mod.roundtrip(gen, ck, x, params), ranges=True)
    assert set(split.parents) == want
    assert set(split.ranges) <= spans
    assert split.parents["commit_scheme/commit"] == "open_proof/commit"
    assert split.parents["open_proof/verify/key_matvec"] == "open_proof/verify"
    # every work event counts once; the two sums differ only by rounding
    assert 0 < sum(split.ranges.values()) <= sum(split.split.values()) * (1 + 1e-9)


def test_ranges_reach_emit_nvtx(cuda, monkeypatch):
    """Under ``emit_nvtx`` (Nsight Systems' view) a profiler listens: an
    open round trip on the card enters ``record_function``, which pushes
    each NVTX range, for its phases and its op ranges by their recorded
    names."""
    from ringzk_tpu_torch.utils import profiling

    params = Params()
    gen = torch.Generator(device=cuda).manual_seed(11)
    ck = commit_mod.keygen(gen, params, 512)
    x = sampling.uniform_centered(gen, (256, params.l), 512, params.q, cuda)
    names, real = [], torch.profiler.record_function

    def counting(name, *args, **kwargs):
        names.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with torch.autograd.profiler.emit_nvtx():
        assert profiling.enabled()
        ok, op = open_mod.roundtrip(gen, ck, x, params)
        torch.cuda.synchronize()
    assert bool(ok.all()) and bool(op.all())
    assert not profiling.enabled()
    assert {"open_proof/roundtrip", "open_proof/verify", "commit_scheme/commit",
            "open_proof/verify/key_matvec", "open_proof/verify/norm",
            "open_proof/generate_challenge/challenge"} <= set(names)
    assert profiling._open_ranges() == []


def test_two_party_example_on_card(cuda):
    """examples_torch/two_party.py on the card: the prover a fresh
    interpreter sharing it, over RZK1 pipes."""
    import subprocess
    import sys

    run = subprocess.run([sys.executable, str(REPO / "examples_torch" / "two_party.py")],
                         capture_output=True, text=True, timeout=600, cwd=REPO)
    assert run.returncode == 0, run.stderr
    assert "two-party open proof verified: True" in run.stdout


@pytest.mark.parametrize("q", [Q, Q33, Q63])
def test_ring_algebra_on_card(cuda, q):
    """The reference Mat algebra, KeyOperator and the norm family on the
    card (K1/K2, or K7/K8 on wide rings, and K3) equal the same calls on
    the CPU's plain versions, at N=64: mat.dot at contraction 3 and 20,
    componentwise_mul, equal_mod_q_hat on an unreduced product against
    its reduced image, the norms of full-range rows."""
    from ringzk_tpu_torch.ops import mat, norms

    rng = np.random.default_rng(q % 1000)
    n, ring = 64, get_ring(64, q)
    dtype = np.int32 if q < 2**32 else np.int64

    def draw(shape):
        return torch.from_numpy(rng.integers(-(q // 2), q // 2 + 1, size=shape,
                                             dtype=np.int64).astype(dtype))

    a3, b3, a20, b20 = draw((2, 3, n)), draw((5, 3, 2, n)), draw((2, 20, n)), draw((20, 1, n))
    m, g = draw((5, 3, n)), draw((5, n))
    cases = {
        "dot3": lambda d: mat.dot(ring, a3.to(d), b3.to(d)),
        "dot20": lambda d: mat.dot(ring, a20.to(d), b20.to(d)),
        "cmul": lambda d: mat.componentwise_mul(ring, m.to(d), g.to(d)),
        "eq": lambda d: mat.equal_mod_q_hat(
            ring, ring.dot_hat(ring.fwd_const(g.to(d)).unsqueeze(-2), ring.fwd(m.to(d))),
            ring.fwd(mat.componentwise_mul(ring, m.to(d), g.to(d)))),
    }
    for name, fn in cases.items():
        kernels.reset_launches()
        got = fn(cuda)
        launched = kernels.LAUNCHES["ntt_fwd_wide" if ring.wide else "ntt_fwd"]
        assert launched > 0, name
        assert torch.equal(got.cpu(), fn("cpu")), name
    assert bool(cases["eq"](cuda).all())
    if q == Q:
        a = draw((2, 3, n))
        op = conv_mxu.KeyOperator(a.to(cuda), ring)
        assert op.w_digits.device.type == cuda.type
        v = torch.from_numpy(rng.integers(-1, 2, size=(7, 3, n)).astype(np.int32))
        kernels.reset_launches()
        got = op.matvec(v.to(cuda), 1)
        assert kernels.LAUNCHES["matvec_digits"] == 1
        assert torch.equal(got.cpu(), conv_mxu.KeyOperator(a, ring).matvec(v, 1))
    x = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(9, n), dtype=np.int64))
    x[0] = -2**63
    x = x if q >= 2**32 else x.to(torch.int32)
    for fn in (norms.norm2_squared, norms.norm1, norms.norm_inf):
        got, want = fn(x.to(cuda)), fn(x)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        assert all(torch.equal(g_.cpu(), w_) for g_, w_ in zip(got, want)), fn.__name__


def _modq_pairs(rng, shape, q):
    """int32 a, b over the whole range, whose flat starts hold the edges 0,
    +-1, +-(q-1)/2, -2^31 and 2^31-1 in every pairing (as many as fit)."""
    full = np.iinfo(np.int32)
    edge = np.array([0, 1, -1, q // 2, -(q // 2), full.min, full.max], np.int64)
    a, b = (rng.integers(full.min, full.max, size=shape, endpoint=True) for _ in range(2))
    k = min(edge.size ** 2, a.size)
    a.reshape(-1)[:k], b.reshape(-1)[:k] = np.repeat(edge, edge.size)[:k], \
        np.tile(edge, edge.size)[:k]
    return (torch.from_numpy(v.astype(np.int32)) for v in (a, b))


@pytest.mark.parametrize("q", [Q, 32749])
@pytest.mark.parametrize("op", ["add", "sub"])
def test_modq_kernel_matches_plain(cuda, op, q):
    """The centred add and sub kernel equals its plain version bit for bit,
    at the default modulus (MontCtx.add's carry branch) and at 32749 (its
    wrapping branch below 2^31): int32 over the whole range with the edges
    in every pairing; the three benchmark cells' shapes at a reduced batch
    (open [B, 2, 512] and [B, 2, 1024], sum's [B, 4, 2, 1024]); lengths that
    are no multiple of 4; a broadcast operand, a non-contiguous one and
    one off a 16-byte boundary. Every call is one launch."""
    from ringzk_tpu_torch.ops.kernels import modq as k_modq
    from ringzk_tpu_torch.ops.montgomery import MontCtx

    ctx = MontCtx.make(q)
    fn, plain = ((k_modq.modq_add, k_modq.modq_add_plain) if op == "add"
                 else (k_modq.modq_sub, k_modq.modq_sub_plain))
    rng = np.random.default_rng(q % 1000 + (op == "sub"))

    def held(a, b, label):
        before = kernels.LAUNCHES[f"modq_{op}"]
        got = fn(ctx, a.to(cuda), b.to(cuda))
        assert kernels.LAUNCHES[f"modq_{op}"] == before + 1, label
        want = plain(ctx, a, b)
        assert got.dtype == torch.int32 and got.shape == want.shape, label
        assert torch.equal(got.cpu(), want), label

    for shape in [(300, 2, 512), (300, 2, 1024), (77, 4, 2, 1024), (1001,), (5, 3, 7), (3,),
                  (1,), (4,), (49,)]:
        held(*_modq_pairs(rng, shape, q), shape)
    a, b = _modq_pairs(rng, (300, 3, 512), q)
    held(a, b[:, :1], "broadcast rows")
    held(b[0, 0], a, "broadcast polynomial")
    held(a.transpose(0, 1), b.transpose(0, 1), "non-contiguous")
    held(a.reshape(-1)[1:4001], b.reshape(-1)[5:4005], "off a 16-byte boundary")


@pytest.mark.parametrize("proto", ["open", "sum"])
def test_modq_kernel_carries_every_narrow_centred_add(cuda, monkeypatch, proto):
    """Open at N=512 and sum at N=1024, small batches, on the card: every
    narrow centred add and sub of the round trip is one kernel launch and
    none takes the plain chain; open makes two adds (the commit's c = A r
    + [0; x] and the opening check's) and no sub; both verdicts all true."""
    from ringzk_tpu_torch.ops.kernels import modq as k_modq

    calls = {"modq_add": 0, "modq_sub": 0}
    for name in calls:
        def counted(ctx, a, b, real=getattr(k_modq, name), name=name):
            calls[name] += 1
            return real(ctx, a, b)
        monkeypatch.setattr(k_modq, name, counted)

    def refuse(*args):
        raise AssertionError("the plain chain ran on the card")
    monkeypatch.setattr(k_modq, "modq_add_plain", refuse)
    monkeypatch.setattr(k_modq, "modq_sub_plain", refuse)
    params = Params()
    gen = torch.Generator(device=cuda).manual_seed(20)
    n = 512 if proto == "open" else 1024
    ck = commit_mod.keygen(gen, params, n)
    if proto == "open":
        x = sampling.uniform_centered(gen, (200, params.l), n, params.q, cuda)
        run = lambda: open_mod.roundtrip(gen, ck, x, params)  # noqa: E731
    else:
        xs = sampling.uniform_centered(gen, (40, 4, params.l), n, params.q, cuda)
        gs = sampling.uniform_centered(gen, (40, 4), n, params.q, cuda)
        run = lambda: sum_mod.roundtrip(gen, ck, gs, xs, params)  # noqa: E731
    kernels.reset_launches()
    ok, opening_ok = run()
    torch.cuda.synchronize()
    assert ok.all() and opening_ok.all()
    assert {k: kernels.LAUNCHES[k] for k in calls} == calls
    assert calls["modq_add"] > 0
    if proto == "open":
        assert calls == {"modq_add": 2, "modq_sub": 0}
    else:
        assert calls["modq_sub"] > 0
