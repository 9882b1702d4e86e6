#!/usr/bin/env python3
"""Drive the PyTorch port's three sigma protocols once on one CUDA GPU and
check them.

    python3 chip_smoke.py

The paths are the round trips of ``ringzk_tpu_torch.protocols`` with
bench.py's default batches, one chain each. At N=512 on the default
(narrow) ring: open (``open.roundtrip``, B=131072), linear
(``linear.roundtrip``, B=49152) and sum (``sum.roundtrip``, VL=4 summands,
B=24576). At N=512 on wide rings (Params(q=Q//2, modulus=Q), int64
residues; ``bench.py --modulus``): open at Q = 2^33+9 (B=131072), open at
the largest prime below 2^63 (B=131072), linear (B=49152) and sum (VL=4,
B=24576) at 2^33+9. On the larger rings of the default modulus, whose keys
hold the blocked digit operator (``bench.py --n``): open, linear and sum at
N=1024 with the same batches, open at N=2048 (B=24576) and at N=4096
(B=2048), the JAX package's documented ring-degree scan. Then the
calibration entry point (``ringzk_tpu_torch.calibrate``, the port of
scripts/calibrate_vpu.py and bench.py's NTT roofline row), the path that
runs K9-K11. Phases, each fatal on failure:

1. device: exactly one CUDA device must be visible; print its name and
   power limit;
2. build: compile the kernel library from ``ringzk_tpu_torch/csrc`` (one
   nvcc per source, all at once) and print ptxas's registers, shared
   memory and spills per kernel, with a line per N of the register-resident
   kernels (K1, K2, K5, K7, K8, K9's forward and inverse); K11's SASS must
   hold its 2 * 64 IMADs;
3. kernels: K1-K8 at the paths' shapes (K1 and K2 at every shape linear
   and sum launch them, at N=512 and N=1024; K7 also at the int64 extremes;
   K6 at the full batch of each larger-ring path, compared on 8192 of its
   rows; K4 and K5 also at open N=1024 and N=4096's shapes, compared on
   8192 rows or batch elements), K1 at all three primes and K2 on its images over the
   calibration's 393,216 rows, K9 forward and inverse at each prime (8192
   rows, and 393,216 at prime 0), K10 at each prime at N=512 and at prime
   0 at N=1024 (8192 rows), K11 at [24576, 512], each equal to its plain
   PyTorch version (the digit operators of K3, K6 and K10 are packed
   first, as set-up, and the packing time is printed)
   (integers: the tolerance is zero); K9's images of residues equal plane
   i of K1's, and K10's forward and inverse equal K9's;
4. known answers: the port with the draws of
   ``ringzk_tpu_torch/kat_{open,linear,sum}_n512.npz``, of the four wide
   files ``kat_*_q2e33_n512.npz``, ``kat_open_q2e63_n512.npz`` and of
   ``kat_{open,linear,sum}_n1024.npz`` reproduces the JAX package's
   messages and verdicts bit for bit;
5. round trips, one path after the other, each from launch counts set to
   0: every proof and opening verifies, and the forged and norm-violating
   probes (linear's wrong relation, and on wide rings a z coefficient of
   -2^63) reject; every shape at which the run launched K1 or K2 must be
   one that [3] checked;
6. launch counts: K3, K4 and K5 and not K6 ran on every narrow N=512
   path; K4, K7 and K8 and none of K3, K5 and K6 on every wide one; K4, K5
   and K6 and not K3 on every larger-ring path (linear and sum also K1 and
   K2); K1, K2, K9, K10 and K11 in the calibration run; and each of K1-K11
   on at least one run;
7. timing, with CUDA events after a warm-up, per path: the round trip
   (median of 5 calls), each phase (median of 5), one round trip under
   ``torch.profiler`` (after a warm-up call) for the device time by kind
   (K1-K8, other device work) and the idle share, the latter only when
   the profiler recorded every launch the counters saw, and one round trip
   for the peak device memory;
   then K5 at each of its shapes (the five N=512 ones, and open's response
   and verify at N=1024 and N=4096) against its plain version and against
   the composed route it replaced (K1, dot_hat, K2 and the centered add),
   and K1-K4 (K1 and K2 at each shape the paths launched them and at the
   calibration's; K4 also at open N=1024 and N=4096) and K6-K11 (K7 and K8
   at each shape of [3]) against their plain versions, each beside its bound
   and its calibrated bound (K10 forward and inverse at the calibration's
   393,216 rows also equal to their plain versions); K6 also beside K3 on
   the side-by-side layout of the same operator; K3, K6 and K10 beside
   ``torch._int_mm`` of their digit planes with the operator row-major and
   column-major (the faster is the yardstick), and with their share of the
   int8 peak; a kernel that runs faster than either bound fails the run
   (the bound would be wrong);
8. calibration: ``calibrate.main()`` from launch counts set to 0 (probes
   A-D, the roofline row of K1, K9 and K10, each transform checked on its
   inverse). K11 is timed again here as the best of 5 windows of 200
   calls; the higher of its multiply-adds/s and the calibration's is the
   calibrated 32-bit rate: the calibrated bound charges each kernel's
   32-bit multiplies at it (a modular product is three of them; adds
   and selects are left out, so it stays a least time), against its
   bytes.

The last line is a JSON object {"ok": true, "device": {...}}; the line
before it lists the kernels with their launches, errors, times and both
bounds.
"""

from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
N_DEG = 512
B_OPEN, B_LINEAR, B_SUM, VL = 131072, 49152, 24576, 4
# the larger rings: their open batches (bench.py's default at N=1024; the
# JAX package's ring-degree scan, BENCHMARKS.md, at 2048 and 4096)
B_OPEN_LARGE = {1024: B_OPEN, 2048: 24576, 4096: 2048}
K6_CHECK_ROWS = 8192   # rows of each K6 launch held against the plain version
Q33, Q63 = 2**33 + 9, 9223372036854775783   # wide moduli: 2^33+9, largest prime < 2^63
# substrings of the kernels' names as the profiler reports them
KERNEL_NAMES = {"K1": "ntt_fwd_kernel", "K2": "ntt_inv_kernel",
                "K3": "matvec_digits_kernel", "K4": "challenge_select_kernel",
                "K5": "scalar_mul_add_kernel", "K6": "matvec_colblock_kernel",
                "K7": "ntt_fwd_wide_kernel", "K8": "ntt_inv_wide_kernel",
                "K9": "_one_kernel", "K10": "ntt_dense_kernel", "K11": "mac_chain_kernel"}
# each kernel's launch counters (K9's forward and inverse are two kernels)
COUNTERS = {"K1": ("ntt_fwd",), "K2": ("ntt_inv",), "K3": ("matvec_digits",),
            "K4": ("challenge_select",), "K5": ("scalar_mul_add",), "K6": ("matvec_colblock",),
            "K7": ("ntt_fwd_wide",), "K8": ("ntt_inv_wide",),
            "K9": ("ntt_fwd_one", "ntt_inv_one"), "K10": ("ntt_dense",), "K11": ("mac_chain",)}
K9_ROWS = 3 * B_OPEN      # bench.py's NTT roofline polynomials, 131072 * k
CHECK_ROWS = 8192         # rows of the K9 (every prime) and K10 checks
K11_SHAPE = (3 * 8192, 512)   # calibrate_vpu.py's probe
# K5 at each shape the paths give it: (label, B, rows, num, N); the larger
# rings' open shapes are checked on K6_CHECK_ROWS of their batch elements
K5_SHAPES = (("open response z = y + d.r", B_OPEN, 3, 1, N_DEG),
             ("open verify t + c1.d", B_OPEN, 1, 2, N_DEG),
             ("linear response z, zp", B_LINEAR, 3, 1, N_DEG),
             ("sum response zs", B_SUM, VL * 3, 1, N_DEG),
             ("sum verify t_i + c1_i.d", B_SUM, VL, 2, N_DEG),
             ("open response z = y + d.r", B_OPEN_LARGE[1024], 3, 1, 1024),
             ("open verify t + c1.d", B_OPEN_LARGE[1024], 1, 2, 1024),
             ("open response z = y + d.r", B_OPEN_LARGE[4096], 3, 1, 4096),
             ("open verify t + c1.d", B_OPEN_LARGE[4096], 1, 2, 4096))
# K4 at the larger rings' open batches, beside N=512's (phase [3] and [7])
K4_LARGE = (1024, 4096)
# K1 and K2 at each shape linear and sum launch them on the default ring,
# (kernel, N, num, rows); every launch there is at all three primes. Linear
# transforms its g products, u and verify's terms over its B rows; sum its
# forward terms over the VL*B summands and its inverses, after summing them,
# over B. Phase [5] fails if a path launches them at any other shape.
K12_PATH_SHAPES = tuple((k, n, 3, rows) for n in (N_DEG, 1024)
                        for k, rows in (("K1", B_LINEAR), ("K1", VL * B_SUM),
                                        ("K2", B_LINEAR), ("K2", B_SUM)))
# the register-resident kernels whose ptxas lines [2] sums up per N (K9's
# forward and inverse are two kernels)
REGS_KERNELS = {"K1": "ntt_fwd_kernel", "K2": "ntt_inv_kernel", "K5": "scalar_mul_add_kernel",
                "K7": "ntt_fwd_wide_kernel", "K8": "ntt_inv_wide_kernel",
                "K9": "ntt_fwd_one_kernel", "K9 (inv)": "ntt_inv_one_kernel"}
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


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the current stream, after one
    warm-up call."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cuda_call_ms(fn, calls: int) -> list:
    """Milliseconds of each of ``calls`` calls of fn, after one warm-up."""
    fn()
    times = []
    for _ in range(calls):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return times


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {got.dtype} {tuple(got.shape)} vs plain {want.dtype} {tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
    if not torch.equal(got, want):
        fail(f"{name}: differs from its plain version (max abs err {err})")
    print(f"  {name}: equal to plain over {tuple(got.shape)}", flush=True)
    return err


def phase_ms(phases: Callable, calls: int) -> dict:
    """Median milliseconds of each phase of a round trip over ``calls``
    calls after one warm-up. ``phases(mark)`` runs the round trip's calls
    in its order and calls ``mark(name)`` after each phase; a CUDA event is
    recorded there."""
    rows = []
    names = []
    for _ in range(calls + 1):
        names.clear()
        ev = [torch.cuda.Event(enable_timing=True)]
        torch.cuda.synchronize()
        ev[0].record()

        def mark(name):
            names.append(name)
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()

        phases(mark)
        torch.cuda.synchronize()
        rows.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
    cols = [sorted(col) for col in zip(*rows[1:])]
    return {name: col[len(col) // 2] for name, col in zip(names, cols)}


def device_split(fn) -> tuple:
    """Run fn twice under torch.profiler (host and device activity), with a
    spin kernel between the calls. The first call takes the profiler's
    start-up, whose first kernels can go unrecorded; only the kernels after
    the spin on the device timeline count. Returns (wall ms of the second
    call, {kind: device ms}, {kind: kernel events recorded}) with kinds
    K1-K8 and "other"; the dicts are empty when the profiler recorded no
    device time after the spin."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spins = [e.time_range.end for e in device if "spin_kernel" in e.name]
    split = dict.fromkeys([*KERNEL_NAMES, "other"], 0.0)
    counts = dict.fromkeys(split, 0)
    for e in device:
        if not spins or e.time_range.start < max(spins):
            continue
        kind = next((k for k, sub in KERNEL_NAMES.items() if sub in e.name), "other")
        split[kind] += e.time_range.elapsed_us() / 1e3
        counts[kind] += 1
    return wall_ms, *((split, counts) if sum(split.values()) > 0 else ({}, {}))


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


def k9_bound(rows: int, n: int, inverse: bool, cost: Cost = PEAK) -> tuple:
    """One prime: 4N bytes in and out a row; the stages, and for the inverse
    the N^-1 product."""
    return bound(8 * n * rows, rows * (ntt_ops(n, cost) + inverse * n * cost.mulmod), cost.rate)


def k10_bound(rows: int, n: int) -> tuple:
    """x read and out written once, the [4N, 4N] operator read once; 2 * 4N
    * 4N int8 operations a row (the fold's few 32-bit operations a
    coefficient are left out)."""
    return bound(8 * n * rows + 16 * n * n, 2 * rows * 16 * n * n, INT8_OPS)


def k11_bound(elements: int, chain: int, cost: Cost = PEAK) -> tuple:
    """4 bytes in and out an element; 2 * chain multiply-adds."""
    return bound(8 * elements, elements * 2 * chain * cost.madd, cost.rate)


def launched(counts: dict, k: str) -> int:
    """Launches of kernel k in one run's launch counts."""
    return sum(counts[c] for c in COUNTERS[k])


def sass_imads(lib_path: Path, nvcc: str, kernel: str) -> tuple:
    """(plain IMADs, other IMAD forms: .MOV, .IADD, .SHL, .WIDE, ...) in the
    SASS of the kernel whose mangled name contains ``kernel``, by
    cuobjdump."""
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    bodies = [b for b in sass.split("Function : ")[1:] if kernel in b.splitlines()[0]]
    if len(bodies) != 1:
        fail(f"{len(bodies)} SASS functions named like {kernel}")
    return len(re.findall(r"\bIMAD\s", bodies[0])), len(re.findall(r"\bIMAD\.", bodies[0]))


def matvec_bound(b: int, kn: int, rows_n: int, v_digits: int) -> tuple:
    """K3 and K6: v read once, the operator's four planes read once, out
    written once; 2 * v_digits * 4 int8 operations per (row, k, column)."""
    return bound(4 * b * kn + 4 * kn * rows_n + 4 * b * rows_n,
                 2 * v_digits * 4 * b * kn * rows_n, INT8_OPS)


def tampered(proto: str, resp, vb1: int, int64_min: bool) -> dict:
    """Forged and norm-violating copies of a response, keyed by the name of
    the verdict they give in the known-answer files (as
    scripts/make_torch_kat.py makes them); with ``int64_min`` (wide rings)
    also one whose first z coefficient is -2^63, where |z| wraps in int64."""
    zname = "zs" if proto == "sum" else "z"
    z = getattr(resp, zname)
    first = (..., 0, 0, 0) if proto == "sum" else (..., 0, 0)
    z_f, z_n = z.clone(), z.clone()
    z_f[(..., 1, 0, 0) if proto == "sum" else first] += 3 if proto == "sum" else 1
    z_n[first] = vb1
    out = {"ok_forged": resp._replace(**{zname: z_f}), "ok_norm": resp._replace(**{zname: z_n})}
    if int64_min:
        z_m = z.clone()
        z_m[first] = -2**63
        out["ok_int64_min"] = resp._replace(**{zname: z_m})
    if proto != "open":
        zp_f = resp.zp.clone()
        zp_f[..., 0, 0] += 1
        out["ok_forged_zp"] = resp._replace(zp=zp_f)
    return out


def verdicts(proto: str, verify, ck, resp, vctx, params, vctx_bad=None,
             int64_min: bool = False) -> dict:
    """Verdicts of the honest response ("ok", must accept), of its tampered
    copies and, for linear, of a context whose public g was swapped
    ("ok_relation"); every one but "ok" must reject."""
    out = {"ok": verify(ck, resp, vctx, params)}
    n = (resp.zs if proto == "sum" else resp.z).shape[-1]
    for name, bad in tampered(proto, resp, params.verify_bound(n) + 1, int64_min).items():
        out[name] = verify(ck, bad, vctx, params)
    if vctx_bad is not None:
        out["ok_relation"] = verify(ck, resp, vctx_bad, params)
    return out


class ProtoPath(NamedTuple):
    """One protocol's main path on one ring: its round trip, its phases in
    the round trip's order (``phases(mark)``, returning the response and
    the verifier's context), its probes (``verdicts`` of one run), and the
    kernels it must launch and must not."""

    name: str
    n: int
    batch: int
    roundtrip: Callable
    phases: Callable
    probes: Callable
    runs: tuple
    skips: tuple


def path_kernels(proto: str, wide: bool, n: int) -> tuple:
    """(kernels the path must launch, kernels it must not): K3 carries the
    key matvecs of N=512 keys, K6 those of larger ones; wide rings take the
    NTT path (K7, K8) and no K3, K5 or K6; linear and sum transform their g
    products with K1/K2 on narrow rings."""
    if wide:
        return ("K4", "K7", "K8"), ("K3", "K5", "K6")
    matvec, other = ("K3", "K6") if n == N_DEG else ("K6", "K3")
    g_products = ("K1", "K2") if proto != "open" else ()
    return g_products + (matvec, "K4", "K5"), (other,)


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    if torch.cuda.device_count() != 1:
        fail(f"{torch.cuda.device_count()} CUDA devices visible; the smoke drives one "
             "(set CUDA_VISIBLE_DEVICES)")
    if not (REPO / "ringzk_tpu_torch" / "csrc").is_dir():
        fail(f"ringzk_tpu_torch/csrc not found beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    from ringzk_tpu_torch import Params, calibrate, interop
    from ringzk_tpu_torch.ops import conv_mxu, ntt_dense, sampling, zq
    from ringzk_tpu_torch.ops import kernels
    from ringzk_tpu_torch.ops.kernels import _lib
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

    VERIFY = {"open": open_mod.verify, "linear": linear.verify, "sum": sum_mod.verify}

    # 2. build
    t0 = time.perf_counter()
    path = _lib.build()
    _lib.lib()
    print(f"[2] build: {path.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line or "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    summary = _lib.ptxas_summary(path.with_suffix(".log").read_text(), REGS_KERNELS)
    for line in _lib.ptxas_lines(summary, REGS_KERNELS):
        print(f"[2] ptxas {line}", flush=True)
    if set(REGS_KERNELS) - {r[0] for r in summary}:
        fail(f"ptxas reported no instances of {set(REGS_KERNELS) - {r[0] for r in summary}}")
    imads, other = sass_imads(path, _lib._nvcc(), "mac_chain_kernel")
    if imads < 2 * k_mac.CHAIN:
        fail(f"K11's SASS holds {imads} IMADs, fewer than its {2 * k_mac.CHAIN} chain steps")
    print(f"[2] K11 mac_chain_kernel (chain {k_mac.CHAIN}): {imads} IMADs and {other} other IMAD "
          f"forms (.MOV, .IADD, .WIDE, ...) in its SASS (cuobjdump), for {2 * k_mac.CHAIN} chain "
          "steps per element", flush=True)

    params = Params()
    ring = get_ring(N_DEG, params.modulus)
    q = params.modulus
    p33, p63 = Params(q=Q33 // 2, modulus=Q33), Params(q=Q63 // 2, modulus=Q63)
    ring33, ring63 = get_ring(N_DEG, Q33), get_ring(N_DEG, Q63)
    gen = torch.Generator(device=dev).manual_seed(0)

    def centered(shape, bound_=q // 2):
        return sampling.uniform_centered(gen, shape[:-1], shape[-1], bound_, dev)

    def residues(ring_, num, rows):
        """NTT-domain residues in [0, p_i) for the first num primes."""
        return torch.stack([torch.randint(0, p, (rows, ring_.n), generator=gen, device=dev,
                                          dtype=torch.int64).to(torch.int32)
                            for p in ring_.primes[:num]])

    def k12_input(kind, n, num, rows):
        """K1's centered rows or K2's residues at one of K12_PATH_SHAPES."""
        return centered((rows, n)) if kind == "K1" else residues(get_ring(n, q), num, rows)

    def k12_pair(kind, n, num, x):
        """(kernel call, plain call) of K1 or K2 on x; the plain version
        B_LINEAR rows at a time."""
        kring = get_ring(n, q)
        if kind == "K1":
            return (lambda: k_ntt.fwd_all(kring, x, num),
                    lambda: torch.cat([k_ntt.fwd_all_plain(kring, c, num)
                                       for c in x.split(B_LINEAR)], dim=1))
        return (lambda: k_ntt.inv_all(kring, x),
                lambda: torch.cat([k_ntt.inv_all_plain(kring, c)
                                   for c in x.split(B_LINEAR, dim=1)]))

    # 3. kernels against their plain versions, at the paths' shapes
    print("[3] kernels against plain versions", flush=True)
    errs = {}
    x3 = centered((3 * B_OPEN, N_DEG))
    x1 = centered((B_OPEN, N_DEG))
    errs["K1"] = max(
        compare(f"K1 fwd num={num} rows={x.shape[0]}", k_ntt.fwd_all(ring, x, num),
                k_ntt.fwd_all_plain(ring, x, num))
        for x, num in ((x3, 1), (x1, 2), (x3[:3], 3))
    )
    resid = {num: residues(ring, num, rows) for num, rows in ((1, 3 * B_OPEN), (2, B_OPEN))}
    errs["K2"] = max(
        compare(f"K2 inv num={num} rows={xh.shape[1]}", k_ntt.inv_all(ring, xh),
                k_ntt.inv_all_plain(ring, xh))
        for num, xh in resid.items()
    )
    # K1 and K2 at every shape linear and sum launch them (phase [5] holds
    # the paths' launches to this list; [7] times each)
    for kk, n, num, rows in K12_PATH_SHAPES:
        kern, plain = k12_pair(kk, n, num, k12_input(kk, n, num, rows))
        errs[kk] = max(errs[kk], compare(
            f"{kk} {'fwd' if kk == 'K1' else 'inv'} N={n} num={num} rows={rows} "
            "(a linear/sum path shape)", kern(), plain()))
        del kern, plain
    # the calibration's K1 and K2: all three primes over 393,216 rows, K2 on
    # K1's images; the plain versions B_LINEAR rows at a time
    h3 = k_ntt.fwd_all(ring, x3, 3)
    errs["K1"] = max(errs["K1"], compare(
        f"K1 fwd num=3 rows={x3.shape[0]}", h3,
        torch.cat([k_ntt.fwd_all_plain(ring, c, 3) for c in x3.split(B_LINEAR)], dim=1)))
    errs["K2"] = max(errs["K2"], compare(
        f"K2 inv num=3 rows={x3.shape[0]} (K1's images)", k_ntt.inv_all(ring, h3),
        torch.cat([k_ntt.inv_all_plain(ring, c) for c in h3.split(B_LINEAR, dim=1)])))
    del h3
    ck = commit_mod.keygen(gen, params, N_DEG)   # device=None: the card
    kn = params.k * N_DEG
    pack_ms = {}

    def pack(label, w, planes):
        """Build operator w's packed twin from its planes (the kernels'
        set-up, never inside a timed window) and record its time."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k_mv.packed_operator(w, planes)
        torch.cuda.synchronize()
        pack_ms[label] = (time.perf_counter() - t0) * 1e3

    pack("K3 N=512 a1", ck.a1_dig, k_mv.key_planes(ck.a1_dig, N_DEG))
    pack("K3 N=512 a2", ck.a2_dig, k_mv.key_planes(ck.a2_dig, N_DEG))
    vs = {}
    for bnd in (params.b, open_mod.gaussian_bound(params, N_DEG),
                params.verify_bound(N_DEG)):
        nd = conv_mxu.digits_for_bound(bnd)
        vs[nd] = sampling.uniform_centered(gen, (B_OPEN,), kn, bnd, dev)
    errs["K3"] = max(
        compare(f"K3 matvec {which} v_digits={nd}",
                k_mv.matvec_digits(ring, w, N_DEG, v, nd),
                k_mv.matvec_digits_plain(ring, w, N_DEG, v, nd))
        for nd, v in vs.items() for which, w in (("a1", ck.a1_dig), ("a2", ck.a2_dig))
    )
    def check_rows(b):
        """The first and last K6_CHECK_ROWS / 2 of b rows (all when fewer),
        where a larger-ring launch is held against its plain version."""
        half = min(K6_CHECK_ROWS, b) // 2
        return torch.cat([torch.arange(half, device=dev), torch.arange(b - half, b, device=dev)])

    k4_in = {N_DEG: sampling.challenge_draws(gen, (B_OPEN,), N_DEG, dev)}
    signs, u = k4_in[N_DEG]
    errs["K4"] = compare("K4 challenge kappa=36",
                         k_chal.challenge_select(u, signs, params.kappa),
                         k_chal.challenge_select_plain(u, signs, params.kappa))
    for n in K4_LARGE:
        k4_in[n] = sampling.challenge_draws(gen, (B_OPEN_LARGE[n],), n, dev)
        sg, uu = k4_in[n]
        sel = check_rows(uu.shape[0])
        errs["K4"] = max(errs["K4"], compare(
            f"K4 challenge N={n} B={uu.shape[0]} kappa=36 (rows {sel.numel()} of them)",
            k_chal.challenge_select(uu, sg, params.kappa)[sel],
            k_chal.challenge_select_plain(uu[sel], sg[sel], params.kappa)))
    k5_in = []
    errs["K5"] = 0
    for label, b, rows, num, n in K5_SHAPES:
        # d a ternary challenge; m ternary r (num=1) or any int32 off the wire
        d = centered((b, n), 1)
        m = (centered((b, rows, n), 1) if num == 1 else
             torch.randint(-2**31, 2**31, (b, rows, n), generator=gen, device=dev,
                           dtype=torch.int64).to(torch.int32))
        t = centered((b, rows, n))
        k5_in.append((d, m, t))
        kring = get_ring(n, q)
        sel = check_rows(b) if n != N_DEG else torch.arange(b, device=dev)
        errs["K5"] = max(errs["K5"], compare(
            f"K5 scalar_mul_add {label} N={n} B={b} rows={rows} num={num}"
            + (f" (batch elements {sel.numel()} of them)" if n != N_DEG else ""),
            k_sma.scalar_mul_add(kring, d, m, t, num)[sel],
            k_sma.scalar_mul_add_plain(kring, d[sel], m[sel], t[sel], num)))

    def wide_input(ring_, rows):
        """Centered int64 draws with, in row 0, the values K7 must take:
        +-(q-1)/2, int64 max and min, 0 and -1 (verify's c1 is any int64)."""
        x = centered((rows, N_DEG), ring_.q // 2)
        x[0, :6] = torch.tensor([ring_.q // 2, -(ring_.q // 2), 2**63 - 1, -2**63, 0, -1])
        return x

    # K7 and K8 at the wide open path's shapes, (q, num, rows), checked here
    # and timed in [7]: commit and verify fwd over 3B rows (num 3, and num 1
    # in the response), fwd(c1) at num 2 and fwd(d) over B rows; the
    # inverses of the key matvecs at num 3 over B rows, of verify's c1.d at
    # num 2, of the response's d.r at num 1 over 3B rows; q = 2^63-25 at
    # its five primes, the fifth above 2^30 (strict butterflies)
    wrings = {"2^33+9": ring33, "2^63-25": ring63}
    k7_shapes = (("2^33+9", 3, 3 * B_OPEN), ("2^33+9", 2, B_OPEN), ("2^33+9", 1, B_OPEN),
                 ("2^33+9", 1, 3 * B_OPEN), ("2^63-25", 5, B_OPEN))
    k8_shapes = (("2^33+9", 3, B_OPEN), ("2^33+9", 2, B_OPEN), ("2^33+9", 1, 3 * B_OPEN),
                 ("2^63-25", 5, B_OPEN))
    k7_in = {(label, rows): wide_input(wrings[label], rows)
             for label, _, rows in k7_shapes}
    k8_in = {(label, num): residues(wrings[label], num, rows) for label, num, rows in k8_shapes}
    errs["K7"] = max(
        compare(f"K7 fwd_wide q={label} num={num} rows={rows}",
                k_wide.fwd_wide_all(wrings[label], k7_in[label, rows], num),
                k_wide.fwd_wide_all_plain(wrings[label], k7_in[label, rows], num))
        for label, num, rows in k7_shapes
    )
    errs["K8"] = max(
        compare(f"K8 inv_wide q={label} num={num} rows={rows}",
                k_wide.inv_wide_all(wrings[label], k8_in[label, num]),
                k_wide.inv_wide_all_plain(wrings[label], k8_in[label, num]))
        for label, num, rows in k8_shapes
    )

    # K6 at each larger-ring path's batch, v_digits 1 (r) and 3 (y, z), on
    # both row blocks of the key: the launch runs at the full batch, and the
    # plain version (tens of GB at the full batch) checks its first and
    # last K6_CHECK_ROWS / 2 rows
    large_ck = {n: commit_mod.keygen(gen, params, n) for n in B_OPEN_LARGE}
    for n, lck in large_ck.items():
        pack(f"K6 N={n} a1", lck.a1_dig, lck.a1_dig)
        pack(f"K6 N={n} a2", lck.a2_dig, lck.a2_dig)
    k6_batches = {1024: (B_OPEN, B_LINEAR, (VL + 1) * B_SUM), 2048: (B_OPEN_LARGE[2048],),
                  4096: (B_OPEN_LARGE[4096],)}
    k6_v = {}
    errs["K6"] = 0
    for n, batches in k6_batches.items():
        lck, lring, lkn = large_ck[n], get_ring(n, q), params.k * n
        for nd, bnd in ((1, params.b), (3, params.verify_bound(n))):
            if conv_mxu.digits_for_bound(bnd) != nd:
                fail(f"N={n}: bound {bnd} takes {conv_mxu.digits_for_bound(bnd)} digits, not {nd}")
            v_full = sampling.uniform_centered(gen, (max(batches),), lkn, bnd, dev)
            if n == 1024:
                k6_v[nd] = v_full
            for b in batches:
                v = v_full[:b]
                rows = check_rows(b)
                half = rows.numel() // 2
                for which, w3 in (("a1", lck.a1_dig), ("a2", lck.a2_dig)):
                    got = k_mv.matvec_digits_colblock(lring, w3, n, v, nd)[rows]
                    want = k_mv.matvec_digits_colblock_plain(lring, w3, n, v[rows], nd)
                    errs["K6"] = max(errs["K6"], compare(
                        f"K6 matvec_colblock N={n} B={b} {which} v_digits={nd} "
                        f"(rows 0-{half - 1} and {b - half}-{b - 1})", got, want))
            del v_full

    # K9 at each prime on residues and on any uint32 (8192 rows), and at
    # prime 0 on residues over bench.py's 393,216 roofline polynomials;
    # its images of residues are plane i of K1's
    def uint32s(rows, hi, n=N_DEG):
        return torch.randint(0, hi, (rows, n), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    x9 = uint32s(K9_ROWS, ring.primes[0])
    errs["K9"] = 0
    for i, p in enumerate(ring.primes):
        inputs = [("residues", uint32s(CHECK_ROWS, p)), ("any uint32", uint32s(CHECK_ROWS, 2**32))]
        if i == 0:
            inputs.append(("residues", x9))
        for label, x in inputs:
            h = k_one.fwd_one(ring, i, x)
            what = f"prime {i} {label} rows={x.shape[0]}"
            errs["K9"] = max(errs["K9"],
                             compare(f"K9 fwd_one {what}", h, k_one.fwd_one_plain(ring, i, x)),
                             compare(f"K9 inv_one {what}", k_one.inv_one(ring, i, x),
                                     k_one.inv_one_plain(ring, i, x)))
            if label == "residues":
                if not torch.equal(h, k_ntt.fwd_all(ring, x, i + 1)[i]):
                    fail(f"K9 fwd_one prime {i} differs from plane {i} of K1's images")
                if not torch.equal(k_one.inv_one(ring, i, h), x):
                    fail(f"K9 inv_one prime {i} does not invert its forward")
    print("  K9 images of residues equal plane i of K1's images; inv_one inverts fwd_one",
          flush=True)
    # K10 at each prime at N=512 and at prime 0 at N=1024 (8192 rows):
    # forward on centered x, inverse on its images, both against K9
    errs["K10"] = 0
    for n, primes in ((N_DEG, (0, 1, 2)), (1024, (0,))):
        dring = get_ring(n, q)
        xc = centered((CHECK_ROWS, n))
        xc[0, :2] = torch.tensor([conv_mxu.digit_capacity(4), -conv_mxu.digit_capacity(4)])
        for i in primes:
            for which in ("mf", "mi"):
                m = ntt_dense.operator(dring, i, which, dev)
                pack(f"K10 N={n} prime {i} {which}", m, k_dense.dense_planes(m, n))
            h = ntt_dense.fwd_one_dense(dring, i, xc)
            back = ntt_dense.inv_one_dense(dring, i, h)
            errs["K10"] = max(errs["K10"], compare(
                f"K10 fwd_one_dense N={n} prime {i} rows={CHECK_ROWS}", h,
                k_dense.dense_apply_plain(dring, i, ntt_dense.operator(dring, i, "mf", dev), xc)),
                compare(f"K10 inv_one_dense N={n} prime {i} rows={CHECK_ROWS}", back,
                        k_dense.dense_apply_plain(dring, i, ntt_dense.operator(dring, i, "mi", dev),
                                                  h)))
            xr = torch.remainder(xc.to(torch.int64), dring.primes[i]).to(torch.int32)
            if not torch.equal(h, k_one.fwd_one(dring, i, xr)):
                fail(f"K10 fwd N={n} prime {i} differs from K9 fwd of x mod p")
            if not torch.equal(back, k_one.inv_one(dring, i, h)) or not torch.equal(back, xr):
                fail(f"K10 inv N={n} prime {i} differs from K9 inv")
    print("  K10 forward of centered x equals K9 forward of x mod p; K10 inverse equals K9 "
          "inverse and gives x mod p back", flush=True)
    print("[3] set-up, operator packing (pack_planes, once per operator): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in pack_ms.items()), flush=True)
    x11 = uint32s(K11_SHAPE[0], 2**32, K11_SHAPE[1])
    errs["K11"] = compare(f"K11 mac_chain chain={k_mac.CHAIN}", k_mac.mac_chain(x11),
                          k_mac.mac_chain_plain(x11))

    # 4. known answers (the JAX package's own outputs, with its draws)
    kat_files = (("open", "kat_open_n512.npz", params), ("linear", "kat_linear_n512.npz", params),
                 ("sum", "kat_sum_n512.npz", params), ("open", "kat_open_q2e33_n512.npz", p33),
                 ("open", "kat_open_q2e63_n512.npz", p63),
                 ("linear", "kat_linear_q2e33_n512.npz", p33),
                 ("sum", "kat_sum_q2e33_n512.npz", p33),
                 ("open", "kat_open_n1024.npz", params), ("linear", "kat_linear_n1024.npz", params),
                 ("sum", "kat_sum_n1024.npz", params))
    for proto, fname, kp in kat_files:
        kat = np.load(REPO / "ringzk_tpu_torch" / fname)
        T = lambda k: torch.from_numpy(kat[k].view(np.int32) if kat[k].dtype == np.uint32
                                       else kat[k]).to(dev)
        kck = interop.commitment_key_from_numpy(kat["a1"], kat["a2"], kp)
        vctx_bad = None
        if proto == "open":
            rctx, pcom = open_mod.prover_commit(None, kck, T("x"), kp, r=T("r"), y=T("y"))
            vctx, chal = open_mod.generate_challenge(None, pcom, kp, signs=T("signs"),
                                                     u=T("u"))
            resp = open_mod.create_response(rctx, chal, kp)
            got = dict(c=pcom.c.c, t=pcom.t, d=chal.d, z=resp.z)
        elif proto == "linear":
            rctx, pcom = linear.prover_commit(None, kck, T("g"), T("x"), kp, r=T("r"),
                                              rp=T("rp"), y=T("y"), yp=T("yp"))
            vctx, chal = linear.generate_challenge(None, pcom, kp, signs=T("signs"),
                                                   u=T("u"))
            resp = linear.create_response(rctx, chal, kp)
            vctx_bad = vctx._replace(g=T("g_bad"))
            got = dict(c=pcom.c.c, cp=pcom.cp.c, t=pcom.t, tp=pcom.tp, u_msg=pcom.u,
                       d=chal.d, z=resp.z, zp=resp.zp)
        else:
            rctx, pcom = sum_mod.prover_commit(None, kck, T("gs"), T("xs"), kp,
                                               rs=T("rs"), rp=T("rp"), ys=T("ys"),
                                               yp=T("yp"))
            vctx, chal = sum_mod.generate_challenge(None, pcom, kp, signs=T("signs"),
                                                    u=T("u"))
            resp = sum_mod.create_response(rctx, chal, kp)
            got = dict(cp=pcom.cp.c, cs=pcom.cs.c, tp=pcom.tp, ts=pcom.ts, u_msg=pcom.u,
                       d=chal.d, zs=resp.zs, zp=resp.zp)
        got.update(verdicts(proto, VERIFY[proto], kck, resp, vctx, kp, vctx_bad))
        for k, v in got.items():
            if not torch.equal(v, T(k)):
                fail(f"known answer {proto}.{k} differs from the JAX package's")
        print(f"[4] known answers {fname}: {', '.join(got)} equal to the JAX package's "
              f"(B={kat['d'].shape[0]}, N={kat['d'].shape[-1]}, operator "
              f"{list(kck.a1_dig.shape) if kck.a1_dig is not None else None})", flush=True)

    # 5.-7. the paths, one after the other: the three protocols on the
    # default ring, then on the wide rings
    def open_path(name, pp, pck, n=N_DEG, batch=B_OPEN) -> ProtoPath:
        x = centered((batch, pp.l, n), pp.q)
        wide = get_ring(n, pp.modulus).wide

        def phases(mark):
            rctx, pcom, ar = open_mod._prover_commit(gen, pck, x, pp)
            mark("prover_commit (commit + t = a1.y)")
            commit_mod.verify(pck, pcom.c, rctx.opening, pp, honest_r_bound=pp.b, ar=ar)
            mark("opening check (reuses A.r)")
            vctx, chal = open_mod.generate_challenge(gen, pcom, pp)
            mark("challenge")
            resp = open_mod.create_response(rctx, chal, pp)
            mark("response z = y + d.r")
            open_mod.verify(pck, resp, vctx, pp)
            mark("verify")
            return resp, vctx

        def probes():
            return verdicts("open", open_mod.verify, pck, *phases(lambda name: None), pp,
                            int64_min=wide)

        return ProtoPath(name, n, batch, lambda: open_mod.roundtrip(gen, pck, x, pp),
                         phases, probes, *path_kernels("open", wide, n))

    def linear_path(name, pp, pck, n=N_DEG) -> ProtoPath:
        x = centered((B_LINEAR, pp.l, n), pp.q)
        g = centered((B_LINEAR, n), pp.q)
        g_bad = centered((B_LINEAR, n), pp.q)
        wide = get_ring(n, pp.modulus).wide

        def phases(mark):
            rctx, pcom, ar, arp = linear._prover_commit(gen, pck, g, x, pp)
            mark("prover_commit (g.x, 2 commits, t, tp, u)")
            commit_mod.verify(pck, pcom.c, rctx.opening, pp, honest_r_bound=pp.b, ar=ar)
            commit_mod.verify(pck, pcom.cp, rctx.opening_p, pp, honest_r_bound=pp.b, ar=arp)
            mark("opening checks (reuse A.r)")
            vctx, chal = linear.generate_challenge(gen, pcom, pp)
            mark("challenge")
            resp = linear.create_response(rctx, chal, pp)
            mark("response z, zp")
            linear.verify(pck, resp, vctx, pp)
            mark("verify")
            return resp, vctx

        def probes():
            resp, vctx = phases(lambda name: None)
            return verdicts("linear", linear.verify, pck, resp, vctx, pp,
                            vctx._replace(g=g_bad), int64_min=wide)

        return ProtoPath(name, n, B_LINEAR, lambda: linear.roundtrip(gen, pck, g, x, pp),
                         phases, probes, *path_kernels("linear", wide, n))

    def sum_path(name, pp, pck, n=N_DEG) -> ProtoPath:
        xs_ = centered((B_SUM, VL, pp.l, n), pp.q)
        gs = centered((B_SUM, VL, n), pp.q)
        wide = get_ring(n, pp.modulus).wide

        def phases(mark):
            rctx, pcom, ars, arp = sum_mod._prover_commit(gen, pck, gs, xs_, pp)
            mark("prover_commit (sum g_i.x_i, V+1 commits, ts, tp, u)")
            commit_mod.verify(pck, pcom.cp, rctx.opening_p, pp, honest_r_bound=pp.b, ar=arp)
            commit_mod.verify(pck, pcom.cs, rctx.openings, pp, honest_r_bound=pp.b, ar=ars)
            mark("opening checks (reuse A.r)")
            vctx, chal = sum_mod.generate_challenge(gen, pcom, pp)
            mark("challenge")
            resp = sum_mod.create_response(rctx, chal, pp)
            mark("response zs, zp")
            sum_mod.verify(pck, resp, vctx, pp)
            mark("verify")
            return resp, vctx

        def probes():
            return verdicts("sum", sum_mod.verify, pck, *phases(lambda name: None), pp,
                            int64_min=wide)

        return ProtoPath(name, n, B_SUM, lambda: sum_mod.roundtrip(gen, pck, gs, xs_, pp),
                         phases, probes, *path_kernels("sum", wide, n))

    ck33 = commit_mod.keygen(gen, p33, N_DEG)
    ck63 = commit_mod.keygen(gen, p63, N_DEG)
    ck1024 = large_ck[1024]
    paths = ((open_path, "open", params, ck, {}), (linear_path, "linear", params, ck, {}),
             (sum_path, "sum", params, ck, {}), (open_path, "open q=2^33+9", p33, ck33, {}),
             (open_path, "open q=2^63-25", p63, ck63, {}),
             (linear_path, "linear q=2^33+9", p33, ck33, {}),
             (sum_path, "sum q=2^33+9", p33, ck33, {}),
             (open_path, "open N=1024", params, ck1024, dict(n=1024)),
             (linear_path, "linear N=1024", params, ck1024, dict(n=1024)),
             (sum_path, "sum N=1024", params, ck1024, dict(n=1024)),
             (open_path, "open N=2048", params, large_ck[2048],
              dict(n=2048, batch=B_OPEN_LARGE[2048])),
             (open_path, "open N=4096", params, large_ck[4096],
              dict(n=4096, batch=B_OPEN_LARGE[4096])))
    # the shapes the paths launch K1 and K2 at, recorded around the
    # wrappers the ring calls (the launch counters stay the wrappers' own)
    k12_seen, k12_launched = set(), set()

    def recorded(kind, fn):
        def wrapped(ring_, t, *args):
            num, rows = (args[0], t.shape[0]) if kind == "K1" else tuple(t.shape[:2])
            k12_seen.add((kind, ring_.n, num, rows))
            return fn(ring_, t, *args)
        return wrapped

    k_ntt.fwd_all, k_ntt.inv_all = recorded("K1", k_ntt.fwd_all), recorded("K2", k_ntt.inv_all)
    launches = {}
    path_ms = {}
    for make, name, pp, pck, size in paths:
        gc.collect()
        torch.cuda.empty_cache()
        p = make(name, pp, pck, **size)
        shape = f"N={p.n} B={p.batch}" + (f" VL={VL}" if p.name.startswith("sum") else "")
        # 5. the main path's run, counting kernel launches
        torch.cuda.synchronize()
        kernels.reset_launches()
        k12_seen.clear()
        ok, opening_ok = p.roundtrip()
        torch.cuda.synchronize()
        launches[p.name] = dict(kernels.LAUNCHES)
        if k12_seen - set(K12_PATH_SHAPES):
            fail(f"{p.name}: K1/K2 launched at (kernel, N, num, rows) "
                 f"{sorted(k12_seen - set(K12_PATH_SHAPES))}, which [3] did not check")
        k12_launched |= k12_seen
        if ok.shape != (p.batch,) or opening_ok.shape != (p.batch,):
            fail(f"{p.name}: verdict shapes {tuple(ok.shape)}, {tuple(opening_ok.shape)}; "
                 f"want ({p.batch},)")
        if not bool(ok.all()) or not bool(opening_ok.all()):
            fail(f"{p.name} round trip: {int((~ok).sum())} proofs and "
                 f"{int((~opening_ok).sum())} openings rejected")
        del ok, opening_ok
        probes = p.probes()
        if not bool(probes.pop("ok").all()):
            fail(f"{p.name}: an honest proof rejected in the probe run")
        for probe, verdict in probes.items():
            if bool(verdict.any()):
                fail(f"{p.name}: probe {probe} verified")
        print(f"[5] {p.name} round trip {shape}: all {p.batch} proofs and openings verify; "
              f"probes {', '.join(probes)} reject", flush=True)
        del probes
        # 6. the kernels this path must run, and must not
        print(f"[6] launches in the {p.name} round trip: {launches[p.name]}"
              + (f"; K1/K2 at (kernel, N, num, rows) {sorted(k12_seen)}" if k12_seen else ""),
              flush=True)
        for k in p.runs:
            if launched(launches[p.name], k) <= 0:
                fail(f"kernel {k} was not launched in the {p.name} round trip")
        for k in p.skips:
            if launched(launches[p.name], k) != 0:
                fail(f"kernel {k} was launched in the {p.name} round trip")
        # 7. timing
        rt = sorted(cuda_call_ms(p.roundtrip, calls=5))
        path_ms[p.name] = rt_ms = rt[len(rt) // 2]
        print(f"[7] {p.name} round trip: median {rt_ms:.3f} ms per call of 5 (min "
              f"{rt[0]:.3f}, max {rt[-1]:.3f}), {p.batch / rt_ms * 1e3:.1f} verified "
              f"proofs/s ({shape}) on {smi}", flush=True)
        phases = phase_ms(p.phases, calls=5)
        for name, ms in phases.items():
            print(f"  {p.name} phase {name}: median {ms:.3f} ms of 5 on {smi}", flush=True)
        print(f"  {p.name} phases sum {sum(phases.values()):.3f} ms", flush=True)
        wall_ms, split, counts = device_split(p.roundtrip)
        # the profiler's kernel events against the launch counters of the
        # same round trip: where it missed launches, its device time falls
        # short and the idle share is not measured
        missed = {k: (counts[k], launched(launches[p.name], k)) for k in COUNTERS
                  if split and counts[k] != launched(launches[p.name], k)}
        if split:
            dev_ms = sum(split.values())
            idle = ("not measured: the profiler recorded " + ", ".join(
                f"{got} of {want} {k} launches" for k, (got, want) in missed.items())
                if missed else f"{max(0.0, 1 - dev_ms / wall_ms):.2%}")
            print(f"  {p.name} profiled round trip: device time {dev_ms:.3f} ms against a "
                  f"host wall of {wall_ms:.3f} ms (idle share {idle}); "
                  + ", ".join(f"{k} {v:.3f} ms ({v / dev_ms:.1%})" for k, v in split.items())
                  + f" on {smi}", flush=True)
        else:
            print(f"  {p.name} profiled round trip: the profiler recorded no device time; "
                  "device split not measured", flush=True)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        p.roundtrip()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"  {p.name} device memory: peak {peak / 2**30:.2f} GiB allocated during one "
              f"round trip, {(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB "
              "this script held before it (key, kernel-check inputs, path inputs)",
              flush=True)
        del p
    gc.collect()
    torch.cuda.empty_cache()

    # 8. the calibration entry point, from launch counts set to 0; K11's
    # multiply-add rate prices the calibrated bounds of phase [7]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    cal = calibrate.main()
    torch.cuda.synchronize()
    launches["calibrate"] = dict(kernels.LAUNCHES)
    print(f"[8] calibrate: {time.perf_counter() - t0:.1f} s on {smi}; launches "
          f"{launches['calibrate']}", flush=True)
    for k in ("K1", "K2", "K9", "K10", "K11"):
        if launched(launches["calibrate"], k) <= 0:
            fail(f"kernel {k} was not launched in the calibration run")
    # K11 again, as calibrate times it (the [7] time of K11): the higher of
    # the two rates is the calibrated one, so that no K11 run is faster
    # than its calibrated bound
    k11_ms = min(cuda_ms(lambda: k_mac.mac_chain(x11), reps=200) for _ in range(5))
    k11_madd = x11.numel() * 2 * k_mac.CHAIN / (k11_ms / 1e3)
    calibrated = Cost(MULMOD, 0 * ADDMOD, MADD, max(cal["k11_madd_per_s"], k11_madd))
    print(f"[8] calibrated 32-bit rate: {calibrated.rate:.4e} multiply-adds/s, the higher of "
          f"the calibration's {cal['k11_madd_per_s']:.4e} and {k11_madd:.4e} here (K11 "
          f"{k11_ms:.4f} ms a call, best of 5 windows of 200); "
          f"{calibrated.rate / INT32_OPS:.1%} of the {INT32_OPS:.4e}/s integer rate, on {smi}",
          flush=True)

    for k in COUNTERS:
        for counter in COUNTERS[k]:
            if not any(launches[name][counter] > 0 for name in launches):
                fail(f"kernel {k} ({counter}) was not launched on any run")
    if set(K12_PATH_SHAPES) - k12_launched:
        fail(f"no path launched K1/K2 at {sorted(set(K12_PATH_SHAPES) - k12_launched)}")
    print("[6] every kernel K1-K11 launched on at least one run; K3, K4 and K5 and not K6 "
          "on each narrow N=512 path; K4, K7 and K8 and none of K3, K5 and K6 on each wide "
          "one; K4, K5 and K6 and not K3 on each larger-ring path; K1, K2, K9, K10 and K11 in "
          "the calibration run", flush=True)

    # 7. K5 at its shapes: kernel, plain version, and the composed route it
    # replaced (K1 + plain to_mont + plain dot_hat + K2 + plain centered add)
    def composed(kring, d, m, t, num):
        dm = kring.inv(kring.dot_hat(kring.fwd_const(d, num).unsqueeze(-2), kring.fwd(m, num)))
        return zq.add_centered(kring.qctx, t, dm)

    def k5_plain_chunked(kring, d, m, t, num):
        """K5's plain version B_SUM batch elements at a time (its int64
        planes of a full N=1024 batch would take tens of GB)."""
        return torch.cat([k_sma.scalar_mul_add_plain(kring, *a, num)
                          for a in zip(d.split(B_SUM), m.split(B_SUM), t.split(B_SUM))])

    k5_rows = []
    for (label, b, rows, num, n), (d, m, t) in zip(K5_SHAPES, k5_in):
        kring = get_ring(n, q)
        if not torch.equal(composed(kring, d, m, t, num),
                           k_sma.scalar_mul_add(kring, d, m, t, num)):
            fail(f"K5 {label}: differs from the composed route")
        kern = cuda_ms(lambda: k_sma.scalar_mul_add(kring, d, m, t, num), reps=10)
        comp = cuda_ms(lambda: composed(kring, d, m, t, num), reps=3)
        plain = cuda_ms(lambda: k5_plain_chunked(kring, d, m, t, num), reps=2)
        bms, bby = k5_bound(b, rows, num, n)
        cms, cby = k5_bound(b, rows, num, n, calibrated)
        k5_rows.append((f"{label} N={n}", b, rows, num, kern, plain, comp, bms, bby, cms, cby))
        print(f"  K5 {label} N={n} B={b} rows={rows} num={num}: kernel {kern:.3f} ms, plain "
              f"{plain:.3f} ms, composed route (K1 + dot_hat + K2 + add) {comp:.3f} ms, "
              f"bound {bms:.3f} ms ({bby}), calibrated bound {cms:.3f} ms ({cby}) on {smi}",
              flush=True)
    del k5_in

    # 7. K1-K4, K7 and K8 against their plain versions, each beside its bound
    v3 = vs[3]
    rows_n = N_DEG
    ring1024, w1024 = get_ring(1024, q), ck1024.a1_dig

    def k6_plain_chunked(v, nd):
        """K6's plain version over the full batch, K6_CHECK_ROWS rows at a
        time (its float64 planes of the whole batch would not fit)."""
        return torch.cat([k_mv.matvec_digits_colblock_plain(ring1024, w1024, 1024, c, nd)
                          for c in v.split(K6_CHECK_ROWS)])

    # each row: kernel, plain version, shape, and its bound as a function
    # of the cost (the int8 kernels' bounds do not depend on it)
    mf512 = ntt_dense.operator(ring, 0, "mf", dev)
    mi512 = ntt_dense.operator(ring, 0, "mi", dev)
    h10 = ntt_dense.fwd_one_dense(ring, 0, x3)

    def k10_plain_chunked(m, x):
        """K10's plain version CHECK_ROWS rows at a time (its float64 planes
        of 393,216 rows would take 13 GB)."""
        return torch.cat([k_dense.dense_apply_plain(ring, 0, m, c) for c in x.split(CHECK_ROWS)])

    # K10 at the calibration's shape: forward on x3, inverse on its images
    errs["K10"] = max(errs["K10"],
                      compare(f"K10 fwd_one_dense prime 0 rows={K9_ROWS}",
                              k_dense.dense_apply(ring, 0, mf512, x3),
                              k10_plain_chunked(mf512, x3)),
                      compare(f"K10 inv_one_dense prime 0 rows={K9_ROWS}",
                              k_dense.dense_apply(ring, 0, mi512, h10),
                              k10_plain_chunked(mi512, h10)))

    timed = {}
    # K1 and K2 at each shape the paths launched them at: the first of each
    # (linear N=512) is the kernels line's row
    for kk, n, num, rows in K12_PATH_SHAPES:
        first = (n, rows) == (N_DEG, B_LINEAR)
        timed[kk if first else f"{kk} (N={n} num={num} rows={rows})"] = (
            *k12_pair(kk, n, num, k12_input(kk, n, num, rows)),
            f"{'fwd' if kk == 'K1' else 'inv'} N={n} num={num} rows={rows}",
            lambda c, kk=kk, n=n, num=num, rows=rows: (k1_bound if kk == "K1" else k2_bound)(
                rows, num, n, c))
    timed.update({
        "K1 (num=1)": (lambda: k_ntt.fwd_all(ring, x3, 1),
                       lambda: k_ntt.fwd_all_plain(ring, x3, 1),
                       f"fwd num=1 rows={3 * B_OPEN}", lambda c: k1_bound(3 * B_OPEN, 1, N_DEG, c)),
        "K2 (num=1)": (lambda: k_ntt.inv_all(ring, resid[1]),
                       lambda: k_ntt.inv_all_plain(ring, resid[1]),
                       f"inv num=1 rows={3 * B_OPEN}", lambda c: k2_bound(3 * B_OPEN, 1, N_DEG, c)),
        "K3": (lambda: k_mv.matvec_digits(ring, ck.a1_dig, rows_n, v3, 3),
               lambda: k_mv.matvec_digits_plain(ring, ck.a1_dig, rows_n, v3, 3),
               f"matvec v_digits=3 B={B_OPEN}", lambda c: matvec_bound(B_OPEN, kn, rows_n, 3)),
        "K3 (v_digits=1)": (lambda: k_mv.matvec_digits(ring, ck.a1_dig, rows_n, vs[1], 1),
                            lambda: k_mv.matvec_digits_plain(ring, ck.a1_dig, rows_n, vs[1], 1),
                            f"matvec v_digits=1 B={B_OPEN}",
                            lambda c: matvec_bound(B_OPEN, kn, rows_n, 1)),
        "K4": (lambda: k_chal.challenge_select(u, signs, params.kappa),
               lambda: k_chal.challenge_select_plain(u, signs, params.kappa),
               f"challenge B={B_OPEN}", lambda c: k4_bound(B_OPEN, N_DEG, c)),
        # open N=1024's key matvecs: y and z at 3 digits, r at 1
        "K6": (lambda: k_mv.matvec_digits_colblock(ring1024, w1024, 1024, k6_v[3], 3),
               lambda: k6_plain_chunked(k6_v[3], 3),
               f"matvec_colblock N=1024 v_digits=3 B={B_OPEN}",
               lambda c: matvec_bound(B_OPEN, 3 * 1024, 1024, 3)),
        "K6 (v_digits=1)": (lambda: k_mv.matvec_digits_colblock(ring1024, w1024, 1024, k6_v[1], 1),
                            lambda: k6_plain_chunked(k6_v[1], 1),
                            f"matvec_colblock N=1024 v_digits=1 B={B_OPEN}",
                            lambda c: matvec_bound(B_OPEN, 3 * 1024, 1024, 1)),
        # the calibration's roofline shape: one prime over 393,216 rows
        "K9": (lambda: k_one.fwd_one(ring, 0, x9), lambda: k_one.fwd_one_plain(ring, 0, x9),
               f"fwd_one prime 0 rows={K9_ROWS}", lambda c: k9_bound(K9_ROWS, N_DEG, False, c)),
        "K9 (inv)": (lambda: k_one.inv_one(ring, 0, x9), lambda: k_one.inv_one_plain(ring, 0, x9),
                     f"inv_one prime 0 rows={K9_ROWS}",
                     lambda c: k9_bound(K9_ROWS, N_DEG, True, c)),
        "K10": (lambda: k_dense.dense_apply(ring, 0, mf512, x3),
                lambda: k10_plain_chunked(mf512, x3),
                f"fwd_one_dense prime 0 rows={K9_ROWS}", lambda c: k10_bound(K9_ROWS, N_DEG)),
        "K10 (inv)": (lambda: k_dense.dense_apply(ring, 0, mi512, h10),
                      lambda: k10_plain_chunked(mi512, h10),
                      f"inv_one_dense prime 0 rows={K9_ROWS}", lambda c: k10_bound(K9_ROWS, N_DEG)),
        "K11": (lambda: k_mac.mac_chain(x11), lambda: k_mac.mac_chain_plain(x11),
                f"mac_chain chain={k_mac.CHAIN} [{K11_SHAPE[0]}, {K11_SHAPE[1]}]",
                lambda c: k11_bound(x11.numel(), k_mac.CHAIN, c)),
    })
    # K7 and K8 at each shape of [3]: the first of each is the kernels
    # line's row
    for j, (label, num, rows) in enumerate(k7_shapes):
        x, wring = k7_in[label, rows], wrings[label]
        timed["K7" if j == 0 else f"K7 (q={label} num={num} rows={rows})"] = (
            lambda x=x, wring=wring, num=num: k_wide.fwd_wide_all(wring, x, num),
            lambda x=x, wring=wring, num=num: k_wide.fwd_wide_all_plain(wring, x, num),
            f"fwd_wide q={label} num={num} rows={rows}",
            lambda c, rows=rows, num=num: k7_bound(rows, num, N_DEG, c))
    for j, (label, num, rows) in enumerate(k8_shapes):
        xh, wring = k8_in[label, num], wrings[label]
        timed["K8" if j == 0 else f"K8 (q={label} num={num} rows={rows})"] = (
            lambda xh=xh, wring=wring: k_wide.inv_wide_all(wring, xh),
            lambda xh=xh, wring=wring: k_wide.inv_wide_all_plain(wring, xh),
            f"inv_wide q={label} num={num} rows={rows}",
            lambda c, rows=rows, num=num: k8_bound(rows, num, N_DEG, c))
    # K4 at the larger rings' open batches: kernel and bound
    for n in K4_LARGE:
        sg, uu = k4_in[n]
        timed[f"K4 (N={n})"] = (
            lambda sg=sg, uu=uu: k_chal.challenge_select(uu, sg, params.kappa),
            lambda sg=sg, uu=uu: k_chal.challenge_select_plain(uu, sg, params.kappa),
            f"challenge N={n} B={uu.shape[0]}",
            lambda c, b=uu.shape[0], n=n: k4_bound(b, n, c))
    # K6 at the other larger rings' open batches, v_digits=3: kernel and bound
    for n in (2048, 4096):
        b, lring, lck = B_OPEN_LARGE[n], get_ring(n, q), large_ck[n]
        v = sampling.uniform_centered(gen, (b,), params.k * n, params.verify_bound(n), dev)
        timed[f"K6 (N={n})"] = (
            lambda lring=lring, lck=lck, v=v, n=n: k_mv.matvec_digits_colblock(
                lring, lck.a1_dig, n, v, 3),
            lambda lring=lring, lck=lck, v=v, n=n: torch.cat([
                k_mv.matvec_digits_colblock_plain(lring, lck.a1_dig, n, c, 3)
                for c in v.split(K6_CHECK_ROWS)]),
            f"matvec_colblock N={n} v_digits=3 B={b}",
            lambda c, b=b, n=n: matvec_bound(b, params.k * n, n, 3))
    results = {}
    for name, (kern, plain, shape, bound_of) in timed.items():
        (bms, bby), (cms, cby) = bound_of(PEAK), bound_of(calibrated)
        # K11's time is the one its calibrated rate came from
        results[name] = (k11_ms if name == "K11" else cuda_ms(kern, reps=10),
                         cuda_ms(plain, reps=1 if name.startswith(("K6", "K10")) else 2),
                         bms, bby, shape, cms, cby)
        print(f"  {name} {shape}: kernel {results[name][0]:.3f} ms, plain "
              f"{results[name][1]:.3f} ms, bound {bms:.3f} ms ({bby}), calibrated bound "
              f"{cms:.3f} ms ({cby}) on {smi}", flush=True)
    # context for K3's redesign, not a yardstick of the same function: the
    # digit-plane GEMM alone in one library call (no digit split, no fold)
    planes = torch.randint(-128, 128, (3 * B_OPEN, kn), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
    int_mm = {}

    def int_mm_ms(label, a, w, reps):
        """torch._int_mm(a, w) with w row-major and with w column-major (the
        K-major "TN" form cuBLASLt's int8 kernels take); prints both and
        returns the faster."""
        w_cm = w.t().contiguous().t()
        times = {}
        for form, ww in (("row-major", w), ("column-major", w_cm)):
            try:
                times[form] = cuda_ms(lambda ww=ww: torch._int_mm(a, ww), reps=reps)
            except RuntimeError as err:
                print(f"  {label}: torch._int_mm with the operator {form} not measured ({err})",
                      flush=True)
        del w_cm
        print(f"  {label}: torch._int_mm of the digit-plane GEMM alone (no digit split, no "
              f"fold) {list(a.shape)} x {list(w.shape)} int8: "
              + ", ".join(f"operator {f} {t:.3f} ms" for f, t in times.items()) + f" on {smi}",
              flush=True)
        return min(times.values()) if times else None

    int_mm["K3"] = int_mm_ms("K3 context", planes, ck.a1_dig, 10)
    del planes
    # K6's yardsticks at open N=1024's shape: K3 on the side-by-side layout
    # of the same operator (what the layout rule chose against), and the
    # digit-plane GEMM alone in torch._int_mm (no digit split, no fold)
    w1024_2d = conv_mxu.build_operator_digits_device(ck1024.a1, ring1024)
    if not torch.equal(k_mv.matvec_digits(ring1024, w1024_2d, 1024, k6_v[3], 3),
                       k_mv.matvec_digits_colblock(ring1024, w1024, 1024, k6_v[3], 3)):
        fail("K3 on the side-by-side layout differs from K6 on the blocked one at N=1024")
    k3_on_2d = cuda_ms(lambda: k_mv.matvec_digits(ring1024, w1024_2d, 1024, k6_v[3], 3), reps=10)
    print(f"  K6 context: K3 on the side-by-side layout of the same N=1024 operator, v_digits=3 "
          f"B={B_OPEN}: {k3_on_2d:.3f} ms (K6 {results['K6'][0]:.3f} ms) on {smi}", flush=True)
    planes = torch.randint(-128, 128, (3 * B_OPEN, 3 * 1024), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
    int_mm["K6"] = int_mm_ms("K6 context", planes, w1024_2d, 5)
    del planes, w1024_2d
    # K10's library yardstick: torch._int_mm of its digit planes against the
    # operator (the GEMM alone: no digit split, no fold)
    planes = torch.randint(-128, 128, (K9_ROWS, 4 * N_DEG), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
    int_mm["K10"] = int_mm_ms("K10 library", planes, mf512, 10)
    lib_k10 = "not measured" if int_mm["K10"] is None else f"{int_mm['K10']:.3f} ms"
    print(f"  K10 {results['K10'][0]:.3f} ms forward, {results['K10 (inv)'][0]:.3f} ms inverse "
          f"against torch._int_mm's faster form {lib_k10} on {smi}", flush=True)
    del planes
    # the int8 kernels' share of the dense int8 peak (their bounds are
    # operations at INT8_OPS)
    shares = {name: r[2] / r[0] for name, r in results.items()
              if name.startswith(("K3", "K6", "K10")) and r[3] == "operations"}
    print("  int8 share of the dense int8 peak (1,979 T/s): "
          + ", ".join(f"{name} {share:.1%}" for name, share in shares.items()) + f" on {smi}",
          flush=True)

    # the kernels line: launches summed over the runs
    r5 = k5_rows[0]
    results["K5"] = (r5[4], r5[5], r5[7], r5[8],
                     f"{r5[0]} B={r5[1]} rows={r5[2]} num={r5[3]}", r5[9], r5[10])
    # every timed kernel shape: (name, ms, bound, by, calibrated bound, by)
    shapes = ([(n, r[0], r[2], r[3], r[5], r[6]) for n, r in results.items() if n != "K5"]
              + [(f"K5 {r[0]}", r[4], r[7], r[8], r[9], r[10]) for r in k5_rows])
    # a bound is a least time: a kernel that beats it shows the bound wrong
    # (relative slack 1e-9 for K11, whose calibrated bound is its own time)
    beaten = [f"{name} {ms:.4f} ms < {max(b, cb):.4f} ms"
              for name, ms, b, _, cb, _ in shapes if ms < max(b, cb) * (1 - 1e-9)]
    if beaten:
        fail(f"kernels faster than their bound or calibrated bound: {', '.join(beaten)}")
    print("  every kernel time is at or above its bound and its calibrated bound", flush=True)
    flips = [f"{name} ({by} -> {cby})" for name, _, _, by, _, cby in shapes if by != cby]
    print(f"  what bounds each kernel under the calibrated rate, where it differs from the "
          f"data sheet's: {', '.join(flips) or 'none'}", flush=True)
    meta = [
        ("K1", "fwd_all (ntt_fwd)", "ringzk_tpu_torch/csrc/ntt.cu",
         "ringzk_tpu/ops/pallas/ntt_kernel.py:190"),
        ("K2", "inv_all (ntt_inv)", "ringzk_tpu_torch/csrc/ntt.cu",
         "ringzk_tpu/ops/pallas/ntt_kernel.py:221"),
        ("K3", "matvec_digits", "ringzk_tpu_torch/csrc/matvec_digits.cu",
         "ringzk_tpu/ops/pallas/matvec_kernel.py:273"),
        ("K4", "challenge_select", "ringzk_tpu_torch/csrc/challenge_select.cu",
         "ringzk_tpu/ops/pallas/challenge_kernel.py:73"),
        ("K5", "scalar_mul_add", "ringzk_tpu_torch/csrc/scalar_mul_add.cu",
         "ringzk_tpu/ops/pallas/ntt_kernel.py:292 and :392"),
        ("K6", "matvec_digits_colblock", "ringzk_tpu_torch/csrc/matvec_colblock.cu",
         "ringzk_tpu/ops/pallas/matvec_kernel.py:217"),
        ("K7", "fwd_wide_all (ntt_fwd_wide)", "ringzk_tpu_torch/csrc/ntt_wide.cu",
         "ringzk_tpu/ops/pallas/ntt_kernel.py:606"),
        ("K8", "inv_wide_all (ntt_inv_wide)", "ringzk_tpu_torch/csrc/ntt_wide.cu",
         "ringzk_tpu/ops/pallas/ntt_kernel.py:642"),
        ("K9", "fwd_one / inv_one (ntt_fwd_one, ntt_inv_one)", "ringzk_tpu_torch/csrc/ntt_one.cu",
         "ringzk_tpu/ops/pallas/ntt_kernel.py:467 and :483 (pallas_call :452)"),
        ("K10", "dense_apply (ntt_dense)", "ringzk_tpu_torch/csrc/ntt_dense.cu",
         "archive/ntt_dense_kernel.py:81"),
        ("K11", "mac_chain", "ringzk_tpu_torch/csrc/mac_probe.cu", "scripts/calibrate_vpu.py:98"),
    ]
    print(json.dumps({"kernels": [
        {"name": f"{k} {label}", "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(launched(launches[p], k) for p in launches),
         "launches_per_path": {p: launched(launches[p], k) for p in launches},
         "max_abs_err": errs[k], "ms": results[k][0], "plain_ms": results[k][1],
         "bound_ms": results[k][2], "bound_by": results[k][3],
         "calibrated_bound_ms": results[k][5], "calibrated_bound_by": results[k][6],
         "library_ms": int_mm["K10"] if k == "K10" else None,
         "shape": results[k][4],
         **({"int8_peak_share": shares.get(k),
             "setup_pack_ms": {lb: t for lb, t in pack_ms.items() if lb.startswith(k + " ")}}
            if k in ("K3", "K6", "K10") else {}),
         **({"int_mm_ms": int_mm.get(k)} if k in ("K3", "K6") else {}),
         **({"k3_on_2d_ms": k3_on_2d} if k == "K6" else {}),
         **({"shapes_ms": {r[0]: r[4] for r in k5_rows}} if k == "K5" else {}),
         **({"shapes_ms": {name: r[0] for name, r in results.items() if name.startswith("K4")}}
            if k == "K4" else {}),
         **({"shapes_ms": {r[4]: r[0] for name, r in results.items() if name.split()[0] == k}}
            if k in ("K1", "K2", "K7", "K8") else {}),
         **({"inv_ms": results[f"{k} (inv)"][0], "inv_plain_ms": results[f"{k} (inv)"][1]}
            if k in ("K9", "K10") else {})}
        for k, label, src, rep in meta
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
