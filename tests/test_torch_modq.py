"""The narrow ring's centred mod-q add and sub (``ops/kernels/modq.py``).

On the CPU the wrapper takes its plain version, which is the chain
``zq.add_centered`` / ``sub_centered`` ran themselves before the kernel:
its values are held against that chain, written out here, against the
JAX package's ``zq`` and, on centred operands, against Python's modular
arithmetic, over the whole int32 range and its edges. The kernel's uint32
arithmetic (``csrc/modq.cu`` ``addsub``) is transcribed in numpy and held
against the plain version on the same inputs; the kernel itself is held
to the plain version on the card (``tests/test_torch_cuda.py``).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ringzk_tpu.ops import montgomery as jmont
from ringzk_tpu.ops import zq as jzq
from ringzk_tpu_torch.ops import kernels, mont64, zq
from ringzk_tpu_torch.ops.kernels import modq
from ringzk_tpu_torch.ops.montgomery import MontCtx

REPO = Path(__file__).resolve().parents[1]
Q = 3515337053
# the default modulus (above 2^31: MontCtx.add's carry branch), the narrow
# moduli of the known-answer configurations (below 2^31: its wrapping
# branch; just under 2^32), and the smallest odd modulus
MODULI = [Q, 32749, 2**32 - 5, 2**31 - 1, 3]
I32 = np.iinfo(np.int32)
OPS = {"add": (modq.modq_add, zq.add_centered, jzq.add_centered, lambda x, y: x + y),
       "sub": (modq.modq_sub, zq.sub_centered, jzq.sub_centered, lambda x, y: x - y)}


def edges(q: int) -> list:
    half = q // 2
    return [0, 1, -1, half, -half, half - 1, -half + 1, half + 1, -half - 1, q - 1, -(q - 1),
            int(I32.min), int(I32.max), int(I32.min) + 1, int(I32.max) - 1]


def operands(q: int, size: int = 4096, seed: int = 0):
    """a, b int32: every pair of edge values, then the whole int32 range."""
    rng = np.random.default_rng(seed + q % 997)
    e = np.asarray([v for v in edges(q) if I32.min <= v <= I32.max], np.int64)
    a = rng.integers(I32.min, I32.max, size=size, endpoint=True)
    b = rng.integers(I32.min, I32.max, size=size, endpoint=True)
    a[:e.size * e.size], b[:e.size * e.size] = np.repeat(e, e.size), np.tile(e, e.size)
    return torch.from_numpy(a.astype(np.int32)), torch.from_numpy(b.astype(np.int32))


def chain(ctx: MontCtx, a, b, op: str):
    """The chain ``zq`` ran itself before the kernel, as it was."""
    f = ctx.add if op == "add" else ctx.sub
    return zq.to_centered(ctx, f(zq.to_unsigned(ctx, a), zq.to_unsigned(ctx, b)))


def kernel_arith(q: int, a: np.ndarray, b: np.ndarray, op: str) -> np.ndarray:
    """``csrc/modq.cu``'s addsub in numpy uint32 (rz::add_mod / add_mod31 /
    sub_mod / to_centered of ``modarith.cuh``)."""
    with np.errstate(over="ignore"):
        p = np.uint32(q)
        ua = a.view(np.uint32) + np.where(a < 0, p, np.uint32(0))
        ub = b.view(np.uint32) + np.where(b < 0, p, np.uint32(0))
        if op == "sub":
            u = np.where(ua >= ub, ua - ub, ua + (p - ub))
        elif q > 2**31:
            s = ua.astype(np.uint64) + ub
            u = np.where(s >= q, s - q, s).astype(np.uint32)
        else:
            s = ua + ub
            u = np.where(s >= p, s - p, s)
        return np.where(u > p // np.uint32(2), u - p, u).view(np.int32)


@pytest.mark.parametrize("op", ["add", "sub"])
@pytest.mark.parametrize("q", MODULI)
def test_cpu_takes_the_plain_chain(q, op):
    """On CPU tensors the wrapper and ``zq`` give the old chain's values,
    int32, on any int32 operands, and the JAX package's."""
    wrapper, entry, jax_fn, _ = OPS[op]
    ctx = MontCtx.make(q)
    a, b = operands(q)
    want = chain(ctx, a, b, op)
    assert want.dtype == torch.int32
    for got in (wrapper(ctx, a, b), entry(ctx, a, b)):
        assert got.dtype == torch.int32 and torch.equal(got, want)
    jax_got = np.asarray(jax_fn(jmont.MontCtx.make(q), a.numpy(), b.numpy()))
    np.testing.assert_array_equal(want.numpy(), jax_got)


@pytest.mark.parametrize("op", ["add", "sub"])
@pytest.mark.parametrize("q", MODULI)
def test_centred_operands_give_the_residue(q, op):
    """On centred operands the result is the centred residue of a ± b."""
    wrapper, _, _, fn = OPS[op]
    half = q // 2
    rng = np.random.default_rng(q % 1009)
    e = [v for v in edges(q) if abs(v) <= half]
    a = np.concatenate([np.repeat(e, len(e)), rng.integers(-half, half + 1, size=512)])
    b = np.concatenate([np.tile(e, len(e)), rng.integers(-half, half + 1, size=512)])
    got = wrapper(MontCtx.make(q), *(torch.from_numpy(v.astype(np.int32)) for v in (a, b)))
    want = [(r := fn(int(x), int(y)) % q) - (q if r > half else 0) for x, y in zip(a, b)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


@pytest.mark.parametrize("op", ["add", "sub"])
@pytest.mark.parametrize("q", MODULI)
def test_kernel_arithmetic_equals_plain(q, op):
    """The kernel's uint32 branches, transcribed, give the plain version's
    value on every operand pair, centred or not."""
    a, b = operands(q, seed=1)
    want = chain(MontCtx.make(q), a, b, op).numpy()
    np.testing.assert_array_equal(kernel_arith(q, a.numpy(), b.numpy(), op), want)


@pytest.mark.parametrize("op", ["add", "sub"])
def test_cpu_broadcasts_as_before(op):
    """A broadcast operand gives the values of the same operand expanded."""
    wrapper = OPS[op][0]
    ctx = MontCtx.make(Q)
    a, b = operands(Q, size=3 * 4 * 32)
    a3, b3, b1 = a.reshape(3, 4, 32), b.reshape(3, 4, 32), b[-32:]
    want = wrapper(ctx, a3, b1.expand(3, 4, 32).contiguous())
    assert torch.equal(wrapper(ctx, a3, b1), want)
    assert torch.equal(wrapper(ctx, a3[:, :1], b3),
                       wrapper(ctx, a3[:, :1].expand(3, 4, 32).contiguous(), b3))


@pytest.mark.parametrize("op", ["add", "sub"])
def test_wrapper_raises_on_what_it_does_not_take(op):
    """int64 operands, mixed devices and a wide ring's context raise; the
    wide ring's route through ``zq`` stays its int64 add."""
    wrapper, entry = OPS[op][:2]
    ctx = MontCtx.make(Q)
    a = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        wrapper(ctx, a.to(torch.int64), a)
    with pytest.raises(ValueError, match="int32"):
        wrapper(ctx, a, a.to(torch.int64))
    with pytest.raises(ValueError, match="need all on the CPU"):
        wrapper(ctx, a, torch.zeros(8, dtype=torch.int32, device="meta"))
    wide = mont64.Mont64Ctx.make(2**33 + 9)
    with pytest.raises(ValueError, match="wide ring"):
        wrapper(wide, a, a)
    x = torch.tensor([2**32 + 4, -(2**32 + 4), 5], dtype=torch.int64)
    y = torch.tensor([2**32 + 4, -(2**32 + 4), -7], dtype=torch.int64)
    want = wide.add_centered_i64(x, y) if op == "add" else wide.sub_centered_i64(x, y)
    assert torch.equal(entry(wide, x, y), want)


def test_cpu_launches_nothing_and_reset_clears_the_counters():
    """The plain route counts no launch; ``reset_launches`` zeroes the
    kernel's counters."""
    kernels.reset_launches()
    ctx = MontCtx.make(Q)
    a, b = operands(Q, size=256)
    zq.add_centered(ctx, a, b), zq.sub_centered(ctx, a, b)
    assert kernels.LAUNCHES["modq_add"] == kernels.LAUNCHES["modq_sub"] == 0
    kernels.LAUNCHES["modq_add"], kernels.LAUNCHES["modq_sub"] = 3, 5
    kernels.reset_launches()
    assert kernels.LAUNCHES["modq_add"] == kernels.LAUNCHES["modq_sub"] == 0


def test_card_route_imports_nothing_at_first_call():
    """The card route's first call, broadcast operands included, loads no
    module that is not loaded already (``torch.broadcast_shapes`` would
    import sympy, seconds of a run's set-up): run in a fresh process, with
    the device check and the launch replaced by the kernel's arithmetic."""
    code = """
import sys
import torch
from ringzk_tpu_torch.ops.kernels import modq
from ringzk_tpu_torch.ops.montgomery import MontCtx

def launch(name, fn, device, a, b, out, p, count):
    assert a.shape == b.shape == out.shape and a.is_contiguous() and b.is_contiguous()
    out.copy_((modq.modq_add_plain if name == "modq_add" else modq.modq_sub_plain)(
        MontCtx.make(p), a, b))

modq.on_cuda, modq.launch = (lambda name, *t: True), launch
ctx, a, b = MontCtx.make(3515337053), torch.arange(24, dtype=torch.int32), torch.ones(1, dtype=torch.int32)
before = set(sys.modules)
got = (modq.modq_add(ctx, a.reshape(2, 3, 4), b), modq.modq_sub(ctx, a[:4], a.reshape(6, 4)))
assert torch.equal(got[0], modq.modq_add_plain(ctx, a.reshape(2, 3, 4), b))
assert torch.equal(got[1], modq.modq_sub_plain(ctx, a[:4], a.reshape(6, 4)))
print(sorted(set(sys.modules) - before))
"""
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "[]", run.stdout[:2000]
