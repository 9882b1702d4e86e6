"""The port's wide rings (2^32 <= q < 2^63) against the JAX package.

Wide rings carry centered int64 residues, extend the CRT prime set past
PRIMES, fold mod q on 64-bit limb pairs and transform in K7 and K8 (plain
versions on the CPU). Inputs come from seeded numpy generators and go
through both packages; every value is an integer, so the tolerance is zero.
The JAX side needs 64-bit arrays: each test scopes ``jax.enable_x64``, as
tests/test_bigmod.py does. tests/test_torch_wide_protocols.py runs the
three protocols against the JAX package with its draws, and
tests/test_torch_wide_kat.py holds the known-answer files equal to what the
JAX package computes (both apart from this file for their JAX compile time).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringzk_tpu.ops import mont64 as jmont64
from ringzk_tpu.ops.montgomery import MontCtx as JMontCtx
from ringzk_tpu.ops import norms as jnorms
from ringzk_tpu.ops import ntt as jntt
from ringzk_tpu.ops import sampling as jsampling
from ringzk_tpu.ops import u64 as ju64
from ringzk_tpu_torch import Params, interop
from ringzk_tpu_torch.ops import mont64, norms, sampling, u64
from ringzk_tpu_torch.ops import ntt as tntt
from ringzk_tpu_torch.ops.kernels import ntt as tkernels_ntt
from ringzk_tpu_torch.ops.kernels import ntt_wide as k_wide
from ringzk_tpu_torch.protocols import commit as commit_mod
from ringzk_tpu_torch.protocols import linear
from ringzk_tpu_torch.protocols import open as open_mod
from ringzk_tpu_torch.protocols import sum as sum_mod

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
Q33 = 2**33 + 9                       # odd, just past 2^32
Q63 = 9223372036854775783             # the largest prime below 2^63
QS = [pytest.param(Q33, id="q2e33"), pytest.param(Q63, id="q2e63")]
I64 = np.iinfo(np.int64)


def wide_params(q):
    return Params(q=q // 2, modulus=q)


def centered(rng, q, shape):
    return rng.integers(-(q // 2), q // 2 + 1, size=shape, dtype=np.int64)


def as_i32(a) -> np.ndarray:
    """A JAX array (uint32 or int32) as the port stores it: int32 bits."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def T(a) -> torch.Tensor:
    return torch.from_numpy(as_i32(np.array(a)))


def pair(lo, hi):
    return [np.asarray(v).astype(np.int64) for v in (lo, hi)]


@pytest.mark.parametrize("q", QS)
def test_mont64_twins_match_jax(q):
    """redc_small, add, sub and the centered boundary on limb pairs, with
    0, q-1, 2^32-1 and int64's extremes among the inputs."""
    rng = np.random.default_rng(q % 1000)
    jc, tc = jmont64.Mont64Ctx.make(q), mont64.Mont64Ctx.make(q)
    assert (jc.q, jc.qinv_neg) == (tc.q, tc.qinv_neg) and tc.is64
    a = rng.integers(0, q, size=4096, dtype=np.int64)
    b = rng.integers(0, q, size=4096, dtype=np.int64)
    a[:4], b[:4] = [0, q - 1, 2**32 - 1, q - 1], [0, q - 1, q - 1, 0]
    v = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    v[:3] = [0, 1, 2**32 - 1]
    split = lambda x: (np.uint32(x & 0xFFFFFFFF), np.uint32(x >> 32))  # noqa: E731
    with jax.enable_x64(True):
        for k in (1, 2**32 - 1, q - 1, int(b[7])):
            k_lo, k_hi = tc.h_to_mont(k)
            assert (k_lo, k_hi) == tuple(int(t) for t in jc.h_to_mont(k))
            got = tc.redc_small(torch.from_numpy(v.astype(np.int64)), k_lo, k_hi)
            want = jc.redc_small(jnp.asarray(v), *jc.h_to_mont(k))
            for g_, w_ in zip(got, pair(*want)):
                np.testing.assert_array_equal(g_.numpy(), w_)
        (a_lo, a_hi), (b_lo, b_hi) = split(a.astype(np.uint64)), split(b.astype(np.uint64))
        ja, jb = (jnp.asarray(t) for t in (a_lo, a_hi)), (jnp.asarray(t) for t in (b_lo, b_hi))
        ja, jb = tuple(ja), tuple(jb)
        ta = tuple(torch.from_numpy(t.astype(np.int64)) for t in (a_lo, a_hi))
        tb = tuple(torch.from_numpy(t.astype(np.int64)) for t in (b_lo, b_hi))
        for name in ("add", "sub"):
            got = getattr(tc, name)(*ta, *tb)
            want = getattr(jc, name)(*ja, *jb)
            for g_, w_ in zip(got, pair(*want)):
                np.testing.assert_array_equal(g_.numpy(), w_, err_msg=name)
        np.testing.assert_array_equal(tc.to_centered_i64(*ta).numpy(),
                                      np.asarray(jc.to_centered_i64(*ja)))
        x = rng.integers(I64.min, I64.max, size=64, dtype=np.int64, endpoint=True)
        x[:4] = [I64.min, I64.max, -1, 0]
        lo, hi = tc.split_i64(torch.from_numpy(x))
        jlo, jhi = jc.split_i64(jnp.asarray(x))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo).astype(np.int64))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi).astype(np.int64))
        c1, c2 = centered(rng, q, 4096), centered(rng, q, 4096)
        c1[:2], c2[:2] = [q // 2, -(q // 2)], [q // 2, -(q // 2)]
        for name in ("add_centered_i64", "sub_centered_i64"):
            got = getattr(tc, name)(torch.from_numpy(c1), torch.from_numpy(c2)).numpy()
            np.testing.assert_array_equal(got, np.asarray(getattr(jc, name)(c1, c2)))
        # the limb-pair helpers the twins are built on
        hi_a = rng.integers(0, 2**32, size=512, dtype=np.int64)
        hi_b = hi_a.copy()
        hi_b[::2] = rng.integers(0, 2**32, size=256, dtype=np.int64)
        lo_a, lo_b = (rng.integers(0, 2**32, size=512, dtype=np.int64) for _ in range(2))
        targs = [torch.from_numpy(t) for t in (hi_a, lo_a, hi_b, lo_b)]
        jargs = [jnp.asarray(t.astype(np.uint32)) for t in (hi_a, lo_a, hi_b, lo_b)]
        for name in ("lt64", "le64"):
            np.testing.assert_array_equal(getattr(u64, name)(*targs).numpy(),
                                          np.asarray(getattr(ju64, name)(*jargs)))
        for g_, w_ in zip(u64.add64(*targs), pair(*ju64.add64(*jargs))):
            np.testing.assert_array_equal(g_.numpy(), w_)


@pytest.mark.parametrize("q", QS)
def test_wide_ring_constants_match_jax(q):
    with jax.enable_x64(True):
        jring = jntt.get_ring(512, q)
        ring = tntt.get_ring(512, q)
        assert ring.wide and ring.dtype == torch.int64
        assert ring.primes == jring.primes and ring.generators == jring.generators
        assert ring.num_primes == {Q33: 3, Q63: 5}[q]
        for num in range(1, ring.num_primes + 1):
            mine, ref = ring._garner(num), jring._garner(num)
            assert mine["c_mont"] == [int(c) for c in ref["c_mont"]]
            assert mine["k_mont"] == [tuple(int(t) for t in k) for k in ref["k_mont"]]
            assert mine["m_mod_q"] == tuple(int(t) for t in ref["m_mod_q"])
            assert mine["half_digits"] == tuple(int(h) for h in ref["half_digits"])
        for p, g in zip(ring.primes, ring.generators):
            for mine, ref in zip(tntt._prime_tables(p, g, 64), jntt._prime_tables(p, g, 64)):
                np.testing.assert_array_equal(np.asarray(mine), np.asarray(ref))


def wide_input(rng, q, rows, n):
    """Centered draws with +-(q-1)/2, int64 max and min, 0 and -1 in row 0."""
    x = centered(rng, q, (rows, n))
    x[0, :6] = [q // 2, -(q // 2), I64.max, I64.min, 0, -1]
    return x


def residues(rng, primes, rows, n):
    return np.stack([rng.integers(0, p, size=(rows, n)) for p in primes]).astype(np.uint32)


@pytest.mark.parametrize("q", QS)
def test_k7_k8_plain_match_jax_xla(q):
    """The plain K7/K8 against the JAX package's XLA wide path at N=512,
    at every prime count."""
    rng = np.random.default_rng(q % 997)
    with jax.enable_x64(True):
        jring, ring = jntt.get_ring(512, q), tntt.get_ring(512, q)
        x = wide_input(rng, q, 3, 512)
        for num in range(1, ring.num_primes + 1):
            got = k_wide.fwd_wide_all_plain(ring, torch.from_numpy(x), num)
            np.testing.assert_array_equal(got.numpy(), as_i32(jring.fwd(jnp.asarray(x), num)))
            xh = residues(rng, ring.primes[:num], 3, 512)
            got = k_wide.inv_wide_all_plain(ring, torch.from_numpy(xh.view(np.int32)))
            np.testing.assert_array_equal(got.numpy(), np.asarray(jring.inv(jnp.asarray(xh))))
        back = ring.inv(ring.fwd(torch.from_numpy(x)))
        np.testing.assert_array_equal(back.numpy()[1:], x[1:])


@pytest.mark.parametrize("q", QS)
def test_k7_k8_plain_match_pallas_interpret(q):
    """The plain K7/K8 against fwd_wide_all_pallas and inv_wide_all_pallas
    in interpret mode at N=128, as tests/test_bigmod.py runs them."""
    from ringzk_tpu.ops.pallas import ntt_kernel

    rng = np.random.default_rng(q % 991)
    with jax.enable_x64(True):
        jring, ring = jntt.get_ring(128, q), tntt.get_ring(128, q)
        x = wide_input(rng, q, 5, 128)
        want = ntt_kernel.fwd_wide_all_pallas(jring, jnp.asarray(x), ring.num_primes,
                                              interpret=True)
        got = ring.fwd(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), as_i32(want))
        xh = residues(rng, ring.primes, 5, 128)
        want = ntt_kernel.inv_wide_all_pallas(jring, jnp.asarray(xh), interpret=True)
        got = ring.inv(torch.from_numpy(xh.view(np.int32)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", jntt.PRIMES + jntt.EXT_PRIMES)
def test_butterfly_form_per_prime_follows_jax(p, monkeypatch):
    """K7/K8 take the lazy butterflies for a prime exactly where the Pallas
    kernels' _fwd_stages/_inv_stages take _fwd_stages_lazy (4p < 2^32),
    the strict ones elsewhere; each wide ring's constant block marks its
    primes so."""
    from ringzk_tpu.ops.pallas import ntt_kernel

    taken = []
    for form in ("lazy", "strict"):
        monkeypatch.setattr(ntt_kernel, f"_fwd_stages_{form}",
                            lambda *a, form=form: taken.append(("fwd", form)))
        monkeypatch.setattr(ntt_kernel, f"_inv_stages_{form}",
                            lambda *a, form=form: taken.append(("inv", form)))
    ctx = JMontCtx.make(p)
    ntt_kernel._fwd_stages(ctx, 16, None, None)
    ntt_kernel._inv_stages(ctx, 16, None, None, None)
    want = "lazy" if k_wide.lazy_butterflies(p) else "strict"
    assert taken == [("fwd", want), ("inv", want)]
    for q in (Q33, Q63):
        ring = tntt.get_ring(16, q)
        if p in ring.primes:
            i = ring.primes.index(p)
            c = k_wide.wide_consts(ring, ring.num_primes).numpy().view(np.uint32)
            assert c[8 * i] == p and c[8 * i + 7] == (want == "lazy")


@pytest.mark.parametrize("q", QS)
def test_twiddle_pairs_of_wide_rings_match_jax(q):
    """The uint2 table K5, K7 and K8 read (ops/kernels/ntt.py
    twiddle_pairs), at N=16 on a wide ring: per prime the JAX ring's
    psi_rev and psi_inv_rev, each beside its Shoup companion."""
    ring = tntt.get_ring(16, q)
    tw = tkernels_ntt.twiddle_pairs(ring, "cpu").numpy().view(np.uint32)
    with jax.enable_x64(True):
        jring = jntt.get_ring(16, q)
        assert tw.shape == (jring.num_primes, 2, 16, 2)
        for i, p in enumerate(jring.primes):
            for which in (0, 1):
                w = np.asarray(jring._tables[i][which]).astype(np.uint64)
                np.testing.assert_array_equal(tw[i, which, :, 0], w)
                np.testing.assert_array_equal(tw[i, which, :, 1], (w << np.uint64(32)) // p)


@pytest.mark.parametrize("q", QS)
def test_polymul_and_scalar_mul_add_match_schoolbook(q):
    rng = np.random.default_rng(q % 983)
    n = 32
    ring = tntt.get_ring(n, q)
    a, b = centered(rng, q, (3, n)), centered(rng, q, (3, n))
    got = ring.polymul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), tntt.negacyclic_schoolbook(a, b, q))
    # t + d*m with a kappa-sparse ternary d and full-range m, t
    m, t = centered(rng, q, (2, 3, n)), centered(rng, q, (2, 3, n))
    d = np.zeros((2, n), np.int64)
    d[:, :7] = rng.choice([-1, 1], size=(2, 7))
    num = ring.primes_needed(36 * (q // 2 + 1))
    got = ring.scalar_mul_add(torch.from_numpy(d), torch.from_numpy(m), torch.from_numpy(t), num)
    want = (tntt.negacyclic_schoolbook(d[:, None], m, q).astype(object) + t.astype(object)) % q
    want = np.where(want > q // 2, want - q, want).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    with jax.enable_x64(True):
        jring = jntt.get_ring(n, q)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jring.scalar_mul_add(d, m, t, num)))


def test_wide_small_q_takes_ntt_path():
    """A wide modulus with a small sampling bound builds no digit operator
    (its uint32 fold cannot carry wide residues): the NTT path, and the
    round trip verifies."""
    params = Params(q=10**6, modulus=Q33)
    gen = torch.Generator().manual_seed(140)
    ck = commit_mod.keygen(gen, params, 32, "cpu")
    assert ck.a1_dig is None and ck.a2_dig is None and ck.a1.dtype == torch.int64
    x = sampling.uniform_centered(gen, (3, 1), 32, params.q, "cpu")
    ok, opening_ok = open_mod.roundtrip(gen, ck, x, params)
    assert ok.all() and opening_ok.all()
    narrow_ck = commit_mod.keygen(gen, Params(q=10**6), 32, "cpu")
    assert narrow_ck.a1_dig is not None


def test_matvec_key_transforms_v_once(monkeypatch):
    """On the NTT path, matvec_key('a') transforms v once for both row
    blocks and equals the two row-block matvecs."""
    params = wide_params(Q33)
    gen = torch.Generator().manual_seed(141)
    ck = commit_mod.keygen(gen, params, 32, "cpu")
    ring = tntt.get_ring(32, Q33)
    v = sampling.uniform_centered(gen, (4, params.k), 32, 5, "cpu")
    calls = []
    fwd = tntt.RingContext.fwd
    monkeypatch.setattr(tntt.RingContext, "fwd",
                        lambda self, *a, **k: calls.append(1) or fwd(self, *a, **k))
    both = commit_mod.matvec_key(ring, ck, "a", v, 5)
    assert len(calls) == 1
    parts = [commit_mod.matvec_key(ring, ck, w, v, 5) for w in ("a1", "a2")]
    assert torch.equal(both, torch.cat(parts, dim=-2))


def test_interop_keeps_wide_keys_exact():
    rng = np.random.default_rng(142)
    params = wide_params(Q63)
    a1 = centered(rng, Q63, (1, 3, 16))
    a2 = centered(rng, Q63, (1, 3, 16))
    a1[0, 1, :2] = [Q63 // 2, -(Q63 // 2)]
    ck = interop.commitment_key_from_numpy(a1, a2, params, "cpu")
    assert ck.a1.dtype == torch.int64
    np.testing.assert_array_equal(ck.a1.numpy(), a1)
    np.testing.assert_array_equal(ck.a2.numpy(), a2)
    narrow = interop.commitment_key_from_numpy(a1.astype(np.int32), a2.astype(np.int32),
                                               Params(), "cpu")
    assert narrow.a1.dtype == torch.int32


def test_uniform_centered_int64_draws():
    gen = torch.Generator().manual_seed(143)
    for bound, dtype in ((2**31 - 2, torch.int32), (2**31 - 1, torch.int64),
                         (Q33 // 2, torch.int64), (2**62, torch.int64)):
        v = sampling.uniform_centered(gen, (64,), 64, bound, "cpu")
        assert v.dtype == dtype and int(v.abs().max()) <= bound
        assert int(v.abs().max()) > bound // 2
    with jax.enable_x64(True):
        assert jsampling.uniform_centered(jax.random.PRNGKey(1), (2,), 8,
                                          Q33 // 2).dtype == jnp.int64
    keys = commit_mod.keygen(gen, wide_params(Q33), 32, "cpu")
    assert int(keys.a1[:, 1:].abs().max()) > 2**31


def test_norm2_leq_int64_adversarial():
    """int64 coefficients far outside int32 reject: 2^61, 2^32 (whose low
    32 bits are 0) and -2^63, where abs wraps to -2^63. The JAX package
    accepts the last (its clip follows abs): the port must not."""
    bound = 10_000
    z = torch.zeros((5, 3, 32), dtype=torch.int64)
    z[0, 0, 0] = 2**61
    z[1, 0, 0] = 2**32
    z[2, 0, 0] = -2**63
    z[3, 0, 0] = -bound
    z[4, 0, 0] = bound + 1
    got = norms.norm2_leq(z, bound).tolist()
    assert got == [[False, True, True], [False, True, True], [False, True, True],
                   [True, True, True], [False, True, True]]
    with jax.enable_x64(True):
        want = np.asarray(jnorms.norm2_leq(jnp.asarray(z.numpy()), bound))
    assert want[[0, 1, 3, 4]].tolist() == [got[i] for i in (0, 1, 3, 4)]
    assert bool(want[2, 0]), "the JAX package's int64-min acceptance is fixed: update ROADMAP"
    with pytest.raises(ValueError, match="2\\^31"):
        norms.norm2_leq(z, 2**31)
    assert norms.norm2_leq(z.to(torch.int32)[3:], bound).tolist() == got[3:]


def test_keygen_refuses_wide_commit_bound_past_int32():
    params = Params(q=Q33 // 2, modulus=Q33, b=2**19)
    assert params.commit_bound(32) >= 2**31
    with pytest.raises(ValueError, match="commit bound"):
        commit_mod.keygen(torch.Generator(), params, 32, "cpu")


WIDE_KATS = [pytest.param("open", "q2e33", Q33, id="open-q2e33"),
             pytest.param("open", "q2e63", Q63, id="open-q2e63"),
             pytest.param("linear", "q2e33", Q33, id="linear-q2e33"),
             pytest.param("sum", "q2e33", Q33, id="sum-q2e33")]


@pytest.mark.parametrize("proto,tag,q", WIDE_KATS)
def test_wide_kat_replayed_by_port(proto, tag, q):
    """The port replays the draws of a wide known-answer file at N=512 and
    reproduces every message and verdict the JAX package stored."""
    kat = np.load(REPO / "ringzk_tpu_torch" / f"kat_{proto}_{tag}_n512.npz")
    K = lambda name: T(kat[name])  # noqa: E731
    params = wide_params(q)
    ck = interop.commitment_key_from_numpy(kat["a1"], kat["a2"], params, "cpu")
    vb1 = params.verify_bound(512) + 1
    if proto == "open":
        rctx, pcom = open_mod.prover_commit(None, ck, K("x"), params, r=K("r"), y=K("y"))
        vctx, chal = open_mod.generate_challenge(None, pcom, params, signs=K("signs"), u=K("u"))
        resp = open_mod.create_response(rctx, chal, params)
        got = dict(c=pcom.c.c, t=pcom.t, d=chal.d, z=resp.z)
        verify, zname, forged_at, norm_at = open_mod.verify, "z", (0, 0), (0, 0)
    elif proto == "linear":
        rctx, pcom = linear.prover_commit(None, ck, K("g"), K("x"), params, r=K("r"),
                                          rp=K("rp"), y=K("y"), yp=K("yp"))
        vctx, chal = linear.generate_challenge(None, pcom, params, signs=K("signs"), u=K("u"))
        resp = linear.create_response(rctx, chal, params)
        got = dict(c=pcom.c.c, cp=pcom.cp.c, t=pcom.t, tp=pcom.tp, u_msg=pcom.u, d=chal.d,
                   z=resp.z, zp=resp.zp)
        got["ok_relation"] = linear.verify(ck, resp, vctx._replace(g=K("g_bad")), params)
        verify, zname, forged_at, norm_at = linear.verify, "z", (0, 0), (0, 0)
    else:
        rctx, pcom = sum_mod.prover_commit(None, ck, K("gs"), K("xs"), params, rs=K("rs"),
                                           rp=K("rp"), ys=K("ys"), yp=K("yp"))
        vctx, chal = sum_mod.generate_challenge(None, pcom, params, signs=K("signs"), u=K("u"))
        resp = sum_mod.create_response(rctx, chal, params)
        got = dict(cp=pcom.cp.c, cs=pcom.cs.c, tp=pcom.tp, ts=pcom.ts, u_msg=pcom.u, d=chal.d,
                   zs=resp.zs, zp=resp.zp)
        verify, zname, forged_at, norm_at = sum_mod.verify, "zs", (1, 0, 0), (0, 0, 0)
    # the probes of scripts/make_torch_kat.py: z + 1 (sum: z_1 + 3) and a
    # coefficient past the verify bound
    got["ok"] = verify(ck, resp, vctx, params)
    z = getattr(resp, zname).clone()
    z[(..., *forged_at)] += 3 if proto == "sum" else 1
    got["ok_forged"] = verify(ck, resp._replace(**{zname: z}), vctx, params)
    z = getattr(resp, zname).clone()
    z[(..., *norm_at)] = vb1
    got["ok_norm"] = verify(ck, resp._replace(**{zname: z}), vctx, params)
    if proto != "open":
        zp = resp.zp.clone()
        zp[..., 0, 0] += 1
        got["ok_forged_zp"] = verify(ck, resp._replace(zp=zp), vctx, params)
    assert set(got) == set(kat.files) - {"a1", "a2", "x", "xs", "g", "g_bad", "gs", "r", "rp",
                                         "rs", "y", "yp", "ys", "signs", "u"}
    for name, value in got.items():
        np.testing.assert_array_equal(value.numpy(), as_i32(kat[name]), err_msg=name)
    assert kat["ok"].all() and not any(kat[k].any() for k in kat.files
                                       if k.startswith("ok_"))
