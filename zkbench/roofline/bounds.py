"""The bound arithmetic of the port's kernels against published H100 peaks.

A frozen copy of ``chip_smoke.py``'s ``KERNEL_NAMES``, the peaks and
``Cost``/``PEAK``, ``ntt_ops``, ``bound``, ``crt_ops``, ``k1_bound``,
``k2_bound``, ``wide_crt_ops``, ``k7_bound``, ``k8_bound``, ``k5_bound``,
``k4_bound`` and ``matvec_bound`` (as of the commit that added this
benchmark), and of ``ringzk_tpu_torch/ops/conv_mxu.py``'s
``digits_for_bound``, unchanged but for this docstring: the yardstick stays
what it is when the program changes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# substrings of the kernels' names as the profiler reports them
KERNEL_NAMES = {"K1": "ntt_fwd_kernel", "K2": "ntt_inv_kernel",
                "K3": "matvec_digits_kernel", "K4": "challenge_select_kernel",
                "K5": "scalar_mul_add_kernel", "K6": "matvec_colblock_kernel",
                "K7": "ntt_fwd_wide_kernel", "K8": "ntt_inv_wide_kernel",
                "K9": "_one_kernel", "K10": "ntt_dense_kernel", "K11": "mac_chain_kernel"}

# Published H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and dense
# int8 tensor-core operations/s. The 32-bit integer rate, which bounds the
# modular arithmetic: the CUDA C++ Programming Guide's table of arithmetic
# instruction throughput gives compute capability 9.0 64 results a clock an
# SM for a 32-bit integer multiply or multiply-add, and 64 for an add,
# compare, min/max or select; 132 SMs at the 1.98 GHz that the data sheet's
# 67 TFLOP/s of float32 (128 fused multiply-adds a clock an SM) implies give
# 1.673e13/s. The multiplies issue to the FMA-heavy pipe and the adds,
# compares and selects to the ALU pipe (Nsight Compute's pipe list: the ALU
# pipe runs integer work except IMAD and IMUL), side by side, and an SM
# dispatches four warp instructions a clock: so m multiplies and a other
# operations take max(m, a, (m + a) / 2) / INT32_OPS.
HBM_BPS, INT8_OPS = 3.35e12, 1979e12
INT32_OPS = 132 * 64 * 1.98e9
# 32-bit operations per modular product (Shoup or Montgomery: three
# multiplies; an input reduction counts as one) and per modular add or sub
# (add and select), as [multiply pipe, ALU pipe]; a butterfly is one
# product, one add, one sub.
MULMOD, ADDMOD, MADD = np.array([3, 0]), np.array([0, 2]), np.array([1, 0])


class Cost(NamedTuple):
    """What an op bound charges: 32-bit operations per modular product, per
    modular add, sub or compare, and per 32-bit multiply-add, as [multiply
    pipe, ALU pipe], at ``rate`` per second and pipe. PEAK charges them all
    at the integer rate, a multiply-add as one operation; the calibrated
    cost (phase [8]) charges only the multiplies, at K11's measured
    multiply-adds/s."""

    mulmod: np.ndarray
    addmod: np.ndarray
    madd: np.ndarray
    rate: float


PEAK = Cost(MULMOD, ADDMOD, MADD, INT32_OPS)


def ntt_ops(n: int, cost: Cost) -> np.ndarray:
    """32-bit operations of one transform of degree n: n/2 log n butterflies."""
    return n // 2 * (n.bit_length() - 1) * (cost.mulmod + 2 * cost.addmod)


def bound(nbytes: float, ops, rate: float) -> tuple:
    """(least ms, what bounds it): bytes at the HBM rate against operations
    at ``rate``. ``ops`` is a count, or [multiply pipe, ALU pipe] counts of
    which the two pipes take max(m, a, (m + a) / 2) issue slots."""
    m, a = np.broadcast_to(np.asarray(ops, dtype=np.float64), (2,))
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, max(m, a, (m + a) / 2) / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def crt_ops(num: int, cost: Cost) -> np.ndarray:
    """32-bit operations of K2's per-coefficient epilogue: N^-1 scaling,
    Garner's digits, the digit compare and the mod-q fold."""
    m, a = cost.mulmod, cost.addmod
    garner = {1: 0, 2: 2 * m + a, 3: 5 * m + 3 * a}[num]
    return num * m + garner + num * a + num * m + num * a


def k1_bound(rows: int, num: int, n: int, cost: Cost = PEAK) -> tuple:
    return bound(4 * n * rows * (1 + num),
                 num * rows * (ntt_ops(n, cost) + n * cost.mulmod), cost.rate)


def k2_bound(rows: int, num: int, n: int, cost: Cost = PEAK) -> tuple:
    return bound(4 * n * rows * (num + 1),
                 rows * (num * ntt_ops(n, cost) + n * crt_ops(num, cost)), cost.rate)


def wide_crt_ops(num: int, cost: Cost) -> np.ndarray:
    """32-bit operations of K8's per-coefficient epilogue: N^-1 scaling,
    Garner's digits (num(num-1)/2 products and subtractions, num-1 inverse
    products), the digit compare, the 64-bit fold (a 64-bit Shoup product
    counted as 4 products, and its add) and the centering."""
    m, a = cost.mulmod, cost.addmod
    garner = num * (num - 1) // 2 * (m + a) + (num - 1) * m
    return num * m + garner + num * a + num * (4 * m + a) + 2 * a


def k7_bound(rows: int, num: int, n: int, cost: Cost = PEAK) -> tuple:
    """int64 in (8N bytes a row), num images out; per prime the limb
    reduction (two products and an add) and the stages."""
    return bound(n * rows * (8 + 4 * num),
                 num * rows * (ntt_ops(n, cost) + n * (2 * cost.mulmod + cost.addmod)),
                 cost.rate)


def k8_bound(rows: int, num: int, n: int, cost: Cost = PEAK) -> tuple:
    return bound(n * rows * (4 * num + 8),
                 rows * (num * ntt_ops(n, cost) + n * wide_crt_ops(num, cost)), cost.rate)


def k5_bound(b: int, rows: int, num: int, n: int, cost: Cost = PEAK) -> tuple:
    """d, m, t read once and out written once; num*(rows+1) forward and
    num*rows inverse transforms, d's to-Montgomery, the pointwise products,
    the CRT epilogue and the add of t."""
    nbytes = 4 * n * b * (1 + 2 * rows) + 4 * n * b * rows
    per_b = (num * (2 * rows + 1) * ntt_ops(n, cost) + num * n * (rows + 2) * cost.mulmod
             + rows * n * (crt_ops(num, cost) + 2 * cost.addmod))
    return bound(nbytes, b * per_b, cost.rate)


def k4_bound(b: int, n: int, cost: Cost = PEAK) -> tuple:
    """keys and signs read once, the challenge written once; 32 bisection
    steps of a compare and a count per lane."""
    return bound(12 * b * n, 32 * cost.addmod * b * n, cost.rate)


def matvec_bound(b: int, kn: int, rows_n: int, v_digits: int) -> tuple:
    """K3 and K6: v read once, the operator's four planes read once, out
    written once; 2 * v_digits * 4 int8 operations per (row, k, column)."""
    return bound(4 * b * kn + 4 * kn * rows_n + 4 * b * rows_n,
                 2 * v_digits * 4 * b * kn * rows_n, INT8_OPS)


RADIX = 256   # conv_mxu.RADIX: balanced digits in [-128, 127]


def digits_for_bound(bound: int) -> int:
    """Number of balanced base-256 digits covering |v| <= bound (the
    symmetric-safe capacity 127*(1 + 256 + ...))."""
    d = 1
    cap = RADIX // 2 - 1
    while cap < bound:
        cap = cap * RADIX + RADIX // 2 - 1
        d += 1
    return d
