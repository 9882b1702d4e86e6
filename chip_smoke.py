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
runs K9-K11. Last, the layer users call above the protocols: the object
API, chained round trips (bench.py's default chain counts), the relaxed
opening and the RZK1 wire format. Phases, each fatal on failure:

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
   0 at N=1024 (8192 rows), K11 at [24576, 512], modq (the narrow ring's
   centred add and sub) at the benchmark cells' shapes on centred operands
   and the int32 extremes, each equal to its plain
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
6. launch counts: K3, K4, K5 and modq and not K6 ran on every narrow
   N=512 path; K4, K7 and K8 and none of K3, K5, K6 and modq on every wide
   one; K4, K5, K6 and modq and not K3 on every larger-ring path (linear
   and sum also K1 and K2); K1, K2, K9, K10 and K11 in the calibration run;
   and each of K1-K11 and modq on at least one run;
7. timing, with CUDA events after a warm-up, per path: the round trip
   (median of 5 calls), each phase (median of 5), one round trip under
   ``torch.profiler`` (after a warm-up call) for the device time by kind
   (K1-K11, modq, other device work: kernels and memory operations, not the
   phase ranges' spans on the device timeline) and the idle share, the
   latter only when the profiler recorded every launch the counters saw,
   with the device time under each phase range, and one round trip for the
   peak device memory;
   then K5 at each of its shapes (the five N=512 ones, and open's response
   and verify at N=1024 and N=4096) against its plain version and against
   the composed route it replaced (K1, dot_hat, K2 and the centered add),
   and K1-K4 (K1 and K2 at each shape the paths launched them and at the
   calibration's; K4 also at open N=1024 and N=4096) and K6-K11 (K7 and K8
   at each shape of [3]) and modq (at [3]'s shapes, its bound 12 bytes an
   element) against their plain versions, each beside its bound
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
   bytes;
9. the user surface (``user_surface``), each part from launch counts set
   to 0, every kernel launch of it held against the plain version at its
   shape: (a) the four transcript goldens of tests/golden/transcripts.json
   rebuilt on the card from ``kat_golden_n16.npz`` through the object API,
   every digest equal; (b) open, linear and sum through the
   Prover/Verifier classes at the paths' batches (honest proofs verify, a
   forged z rejects), then ``roundtrip`` at one chain and at bench.py's
   32 / 12 / 24 chains: ms per call (median of 5), verified proofs/s, one
   profiled call's idle share and the peak memory of each; (c) the
   relaxed opening at open's batch: f = 1 accepts as f = None does, an
   f = c - c' from ``challenge_difference`` rejects every honest
   commitment, (x, f.r, f) accepts, f and the verdicts equal to a CPU run
   of the plain versions on RELAXED_CHECK_ROWS rows; (d) the RZK1 wire
   round trip (``dumps``, ``loads``, ``rebuild``, compact and raw) of
   open's five messages and contexts at B_WIRE, exact, with bytes per
   proof and host milliseconds;
10. the dp and tp axes and batched keys (``parallel_phase``): (a) a
   one-rank NCCL group on the card (``multihost.init_distributed``), the
   dp entry points ``batched_{open,linear,sum}_prove_verify`` at the
   paths' batches, each verdict equal to the one-process round trip on
   the rank's generator and the first MSG_ROWS proofs' messages equal,
   ``all_ok`` true and false after one forged z, timed beside [7]'s round
   trip with the AND all-reduce alone; then
   ``multihost.batch_verify_run(total_batch=131072, n_deg=512)``; (b)
   spawned gloo ranks on the one card, after checking that gloo takes
   CUDA tensors for all-reduce, broadcast and all-gather (the runs are
   left out, and the refusal printed, where it does not): dp open over two
   ranks at B=8192 against ``roundtrip(..., chains=2)``, and
   ``polymul_tp`` over three ranks on 4096 rows at N=512 against
   ``RingContext.polymul``, each rank's K9 launches (at least 2 forward
   and 1 inverse) against K9's plain version and timed; (c) one key per
   proof (``keygen(..., batch_shape=...)``, the NTT path): open with 4096
   keys, linear with 2048, sum with 64 (64 proofs of 64 summands), every
   proof and opening verifying, the probes rejecting, every K1, K2, K4
   and K5 launch held against its plain version, timed against one key on
   the same inputs, with the peak memory;
11. the sp axis at N=8192 (``sp_phase``): (a) a one-rank NCCL group,
   sp = 1: open (B=2048), linear (B=1024) and sum (VL=4, B=256) through
   ``protocol_sp.{open,linear,sum}_roundtrip_sp``, each launching K9 and
   K4 and none of K1-K3, K5, K6, every K4 and K9 launch of the call held
   against its plain version at its shape, its verdicts equal to the
   unsharded round trip's on the same generator and the first MSG_ROWS
   proofs' RZK1 messages equal, both timed and both profiled (device time
   by kernel, idle share); (b) gloo groups of two and four ranks spawned
   on the card: open at B=8 over dp 1 x sp 2, dp 1 x sp 4 and dp 2 x
   sp 2, every rank's K4 and K9 launches held against their plain
   versions, every rank's lanes of the messages equal to the one-process
   round trip's, a forged and an over-bound z on one rank's lanes rejected
   on every rank (all_ok false everywhere), the call timed with the
   exchanges' share of it (host clock, B=8: gloo's staging on one card,
   no measure of an exchange between cards); (c) K9 with each rank's table at
   [6144, 4096] and [6144, 2048] (N=8192 over sp = 2 and 4), every rank
   and prime, held against the plain ``_local_stage`` network and against
   K9's plain version on the same table, timed beside both and its bound;
12. the last modules (``last_modules``): (a) the native RZK1 row codec
   (``ringzk_tpu_torch/runtime/codec.cpp``, built by the host compiler):
   open's response and response context at B=131072 through ``dumps``,
   ``loads`` and ``rebuild``, exact, on the threaded encoder; the native
   bytes and arrays equal to the plain numpy codec's at B=8192; host ms of
   both; each payload of MALFORMED rejected alike by both decoders, those
   past 32 bits as corrupt; (b) ``utils/benchtime.timed_row`` of open's
   round trip at B=131072 beside [7]'s CUDA-event median, with its windows,
   its fetch-forced window and ``engine_fingerprint()``; (c) the device ms
   under each phase range of the JAX package's names (``utils/profiling``)
   in [7]'s profiled open, linear and sum round trips at N=512, each of
   which must record every range it passes through, in [11]'s profiled
   open pair at N=8192 (sp path and unsharded) and in one keygen; (d)
   ``examples_torch/custom_modulus.py`` and ``two_party.py`` as
   subprocesses on the card, each exiting 0;
13. the ring algebra (``ring_algebra``), each call from launch counts set
   to 0 and every kernel launch of it held against the plain version at
   its shape: (a) ``mat.dot([a1; a2], r)`` (``extend_rows``,
   ``from_vec``, ``one_d_mat_to_vec``) at open's B=131072, N=512, equal
   bit for bit to the A.r ``commit`` computes through K3 (``matvec_key``);
   (b) ``mat.componentwise_mul(x, g)`` at linear's B=49152 equal to
   linear's own g.x (its ``opening_p.x``); (c) (a) and (b) on the wide ring
   q = 2^33+9 at B=16384 and (a) at q = 2^63-25 at B=4096 (K7, K8), each
   equal to the protocol's matvec or product; (d)
   ``conv_mxu.KeyOperator(a1).matvec(r, 1)`` at N=512 and N=1024, B=131072
   (K3 on the side-by-side operator), equal to the key's own matvec (K3
   at N=512, K6 at N=1024), its ``w_digits`` equal byte for byte to
   ``build_operator_digits_device`` and to the key's stored operator; (e)
   ``mat.equal_mod_q_hat`` on open's verify equation a1.z == t + d.c1 in
   the NTT domain at B=131072: true for the honest proofs, false for
   every proof of each tampered response; (f) ``norm2_squared``,
   ``norm1`` and ``norm_inf`` of open's z at B=131072 equal to the same
   calls on the CPU row for row, and on full-range int64 rows (+-(2^63-1),
   -2^63, 2^40) equal to Python integers. K1, K2, K3, K7 and K8 must each
   launch in [13], and no other kernel. Each call and its reference are
   timed.
14. the configurations no other phase runs (``configurations``; run right
   after [2], while the card holds nothing else, so that no tensor of
   [3]-[13] cuts its batches): K1 and
   K2 must spill nothing at N=2048 and 4096 (ptxas, [2]); (a) the known
   answers of ringzk_tpu_torch/kat_configs.py (linear and sum at
   N=2048 and 4096; open, linear and sum at q = 2^33+9, N=1024; open at
   2^33+9, N=8192 and at 2^63-25, N=4096; sum with VL=8 at N=1024;
   BASELINE.json configs 1 and 3 at N=512), every message and verdict bit
   for bit; (b) full-width round trips
   (``RUNS14``): linear and sum at N=2048 and 4096 (B=49152, 24576); the
   wide open, linear and sum at N=1024, open at 2^33+9, N=4096 and 8192
   and at 2^63-25, N=4096, at the ring-degree scan's batches, halved while
   a probe at 1/16 of the batch predicts a peak past 85% of the card;
   open, linear and sum at N=1024 at 32 / 12 / 24 chains; BASELINE.json
   configs 1-4 as scripts/baseline_configs.py builds them. Each run calls
   ``roundtrip`` once from launch counts set to 0, every proof and opening
   verifying and the kernels of its path launched; then, outside that
   count, a proof of up to 4096 of the first chain's inputs, accepted,
   and with z forged, rejected; then 5 calls of ``roundtrip``,
   each one's verdicts all true (CUDA events: median, proofs/s, peak
   memory). (c) Every launch of (a) and (b) at a shape [14]
   had not yet held, and K7/K8 at five primes at N=1024 and 8192, against
   the plain version on up to 8192 polynomials, timed beside its bound.
   Then the script's own wall time.

The last line is a JSON object {"ok": true, "device": {...}}; the line
before it lists the kernels with their launches (over the paths of [5],
[8], [10], [11], [13] and [14]), errors, times and both bounds.

``python3 chip_smoke.py --roundtrips <tree>`` times [7]'s one-chain round
trips of the port in another checkout (``time_roundtrips``), to compare
two trees in one call.
"""

from __future__ import annotations

import gc
import json
import os
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
# phase [7]'s one-chain round trips, which ``time_roundtrips`` also times:
# (protocol, modulus (None: the default ring), N, B)
PATHS7 = (("open", None, N_DEG, B_OPEN), ("linear", None, N_DEG, B_LINEAR),
          ("sum", None, N_DEG, B_SUM), ("open", Q33, N_DEG, B_OPEN),
          ("open", Q63, N_DEG, B_OPEN), ("linear", Q33, N_DEG, B_LINEAR),
          ("sum", Q33, N_DEG, B_SUM), ("open", None, 1024, B_OPEN),
          ("linear", None, 1024, B_LINEAR), ("sum", None, 1024, B_SUM),
          ("open", None, 2048, B_OPEN_LARGE[2048]), ("open", None, 4096, B_OPEN_LARGE[4096]))
# substrings of the kernels' names as the profiler reports them
KERNEL_NAMES = {"K1": "ntt_fwd_kernel", "K2": "ntt_inv_kernel",
                "K3": "matvec_digits_kernel", "K4": "challenge_select_kernel",
                "K5": "scalar_mul_add_kernel", "K6": "matvec_colblock_kernel",
                "K7": "ntt_fwd_wide_kernel", "K8": "ntt_inv_wide_kernel",
                "K9": "_one_kernel", "K10": "ntt_dense_kernel", "K11": "mac_chain_kernel",
                "modq": "modq_addsub_kernel"}
# each kernel's launch counters (K9's forward and inverse are two kernels,
# modq's add and sub two instances of one)
COUNTERS = {"K1": ("ntt_fwd",), "K2": ("ntt_inv",), "K3": ("matvec_digits",),
            "K4": ("challenge_select",), "K5": ("scalar_mul_add",), "K6": ("matvec_colblock",),
            "K7": ("ntt_fwd_wide",), "K8": ("ntt_inv_wide",),
            "K9": ("ntt_fwd_one", "ntt_inv_one"), "K10": ("ntt_dense",), "K11": ("mac_chain",),
            "modq": ("modq_add", "modq_sub")}
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
# modq, the narrow ring's centred add and sub, at its shapes in the
# benchmark's cells: (label, operand shape, add or sub); the first is the
# kernels line's row
MODQ_SHAPES = (("open N=512 c = A r + [0; x]", (B_OPEN, 2, N_DEG), "add"),
               ("open N=1024 c = A r + [0; x]", (B_OPEN, 2, 1024), "add"),
               ("sum N=1024 the summands' commits", (B_SUM, VL, 2, 1024), "add"),
               ("sum N=1024 the aggregate's commit", (B_SUM, 2, 1024), "add"),
               ("sum N=1024 the verify's sub", (B_SUM, 1, 1024), "sub"))
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
# phase [9]: bench.py's default chain counts (bench.py:105-107), the wire
# batch, and the rows of the relaxed opening held against a CPU run
CHAINS = {"open": 32, "linear": 12, "sum": 24}
B_WIRE = 8192
RELAXED_CHECK_ROWS = 64
GOLDEN_SETS = ("default", "q15_32749", "q32_2p32m5", "q33_wide")
# phase [10]: the proofs whose messages the dp run holds equal, the dp
# batch over two gloo ranks on the one card, polymul_tp's rows, and the
# batched-key paths: one key per proof (sum: B = V = 64, the only shape
# with a key batch past 1 that the JAX package's broadcasting takes)
MSG_ROWS = 64
B_DP_GLOO = 8192
TP_ROWS = 4096
BATCHED_KEYS = {"open": 4096, "linear": 2048, "sum": 64}
# phase [11]: the sp axis at the JAX package's sp size, N=8192 on the
# default ring: the batches of the one-rank NCCL run, the batch and (dp, sp)
# grids of the gloo runs on the one card, and the rows of K9's checks at
# each rank's table (the y and z transforms of open at B_SP["open"])
N_SP = 8192
B_SP = {"open": 2048, "linear": 1024, "sum": 256}
B_SP_GLOO = 8
SP_GLOO = ((1, 2), (1, 4), (2, 2))
K9_SP_ROWS = 3 * B_SP["open"]
# phase [12]: malformed compact rows, each read as shape (1, 4): a u32 count
# of the coefficients kept, then zigzag varints. The first two pass 32 bits
# on their fifth byte, which the JAX package's native decoder wraps
# (ROADMAP.md, "Reference faults the port must not copy").
MALFORMED = (
    ("5-byte varint, fifth byte 0x7F", b"\x01\0\0\0\xff\xff\xff\xff\x7f"),
    ("5-byte varint, fifth byte 0x10", b"\x01\0\0\0\x80\x80\x80\x80\x10"),
    ("6-byte varint", b"\x01\0\0\0" + b"\xff" * 5 + b"\x01"),
    ("kept > row_len", b"\x05\0\0\0" + b"\x02" * 5),
    ("truncated header", b"\x01\0"),
    ("truncated varint", b"\x02\0\0\0\x02\xff"),
    ("trailing bytes", b"\x02\0\0\0\x02\x05\xff\x00\x07"),
)
# phase [13]: the ring algebra at the protocols' widths: mat.dot runs its
# pointwise products B_DOT_CHUNK proofs at a time; the wide rings' batches
# (q = 2^33+9, the largest prime below 2^63); the full-range int64 rows the
# norm family is held to Python integers on; the rows of each CPU norm call
B_DOT_CHUNK = 32768
B_ALG_WIDE = {Q33: 16384, Q63: 4096}
NORM_ROWS = 64
NORM_CPU_CHUNK = 16384
# phase [14]: the configurations no other phase runs. (a) the known-answer
# files of ringzk_tpu_torch/kat_configs.py (read in ``configurations``);
# (b) full-width round trips: (label, protocol, modulus (None: the default
# ring), N, B, VL, chains, inputs (None: drawn)). Linear and sum on the
# default ring at N=2048 and 4096 at bench.py's batches; the wide rings at
# the JAX package's ring-degree scan's batches (BENCHMARKS.md: 49152 at
# N=1024, 2048 at N=4096, 1024 at N=8192; sum at bench.py's 24576), each
# halved until its predicted peak memory fits the card (fit_batch); open,
# linear and sum at N=1024 at bench.py's 32 / 12 / 24 chains; BASELINE.json
# configs 1-4 as scripts/baseline_configs.py:74-107 builds them.
RUNS14 = (
    ("linear N=2048", "linear", None, 2048, B_LINEAR, None, 1, None),
    ("sum N=2048", "sum", None, 2048, B_SUM, VL, 1, None),
    ("linear N=4096", "linear", None, 4096, B_LINEAR, None, 1, None),
    ("sum N=4096", "sum", None, 4096, B_SUM, VL, 1, None),
    ("open q=2^33+9 N=1024", "open", Q33, 1024, 49152, None, 1, None),
    ("linear q=2^33+9 N=1024", "linear", Q33, 1024, 49152, None, 1, None),
    ("sum q=2^33+9 N=1024", "sum", Q33, 1024, B_SUM, VL, 1, None),
    ("open q=2^33+9 N=4096", "open", Q33, 4096, 2048, None, 1, None),
    ("open q=2^33+9 N=8192", "open", Q33, 8192, 1024, None, 1, None),
    ("open q=2^63-25 N=4096", "open", Q63, 4096, 2048, None, 1, None),
    ("open N=1024 32 chains", "open", None, 1024, B_OPEN, None, CHAINS["open"], None),
    ("linear N=1024 12 chains", "linear", None, 1024, B_LINEAR, None, CHAINS["linear"], None),
    ("sum N=1024 24 chains", "sum", None, 1024, B_SUM, VL, CHAINS["sum"], None),
    ("BASELINE 1: open of [1, 2, 3, 4]", "open", None, N_DEG, 1, None, 1, "config1"),
    ("BASELINE 2: open B=1024", "open", None, N_DEG, 1024, None, 1, None),
    ("BASELINE 3: linear, scalar [3, 5]", "linear", None, N_DEG, 256, None, 1, "config3"),
    ("BASELINE 4: sum VL=8 N=1024", "sum", None, 1024, 32, 8, 1, None),
)
# proofs of each run whose z is forged after its counted round trip
PROBE_ROWS = 4096
# (c) rows (polynomials) of each new kernel shape held against the plain
# version; the wide transforms also at five primes where no path runs them
K14_CHECK_ROWS = 8192
K78_EXTRA = ((Q63, 1024), (Q63, 8192))
# a run's batch is halved while its predicted peak passes this share of the
# card's memory; the prediction scales a probe at 1/FIT_PROBE of the batch
FIT_SHARE, FIT_PROBE = 0.85, 16
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


def queued_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn with the ``reps`` calls queued
    behind a spin of about 2 ms, so that the device runs them back to back
    whatever the host's launch rate (a launch that takes the device less
    time than the host takes to issue it), after one warm-up call."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(4_000_000)
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


class Profiled(NamedTuple):
    """One call profiled by :func:`device_split`: its host wall ms, device
    ms and kernel events by kind, and with ``ranges`` the device ms of the
    work whose innermost phase range each range is
    (``profiling.device_ranges``) and the range each range ran in
    (``profiling.range_parents``)."""

    wall_ms: float
    split: dict
    counts: dict
    ranges: dict
    parents: dict


def device_split(fn, ranges: bool = False) -> Profiled:
    """Run fn twice under torch.profiler (host and device activity), with a
    spin kernel between the calls. The first call takes the profiler's
    start-up, whose first kernels can go unrecorded; only the kernels after
    the spin on the device timeline count. Device time is that of kernels
    and memory operations (``profiling.device_work``): the spans the phase
    ranges leave on the device timeline (gpu_user_annotation) overlap them
    and are left out. The split and counts have the kinds of
    ``KERNEL_NAMES`` and "other";
    they are empty when the profiler recorded no device time after the
    spin."""
    from torch.profiler import ProfilerActivity, profile

    from ringzk_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = profiling.device_work(events)
    spins = [e.time_range.end for e in device if "spin_kernel" in e.name]
    split = dict.fromkeys([*KERNEL_NAMES, "other"], 0.0)
    counts = dict.fromkeys(split, 0)
    for e in device:
        if not spins or e.time_range.start < max(spins):
            continue
        kind = next((k for k, sub in KERNEL_NAMES.items() if sub in e.name), "other")
        split[kind] += e.time_range.elapsed_us() / 1e3
        counts[kind] += 1
    by_range, parents = {}, {}
    if ranges and spins:
        by_range = profiling.device_ranges(events, since_us=max(spins))
        parents = profiling.range_parents(events)
    return Profiled(wall_ms, *((split, counts) if sum(split.values()) > 0 else ({}, {})),
                    by_range, parents)


def nested_ms(prof: Profiled, name: str) -> float:
    """Device ms of a profiled call under the range ``name``: its own work
    and that of every range nested in it, by ``prof.parents``."""
    return prof.ranges.get(name, 0.0) + sum(nested_ms(prof, c)
                                            for c, up in prof.parents.items() if up == name)


def range_report(label: str, prof: Profiled, smi: str) -> dict:
    """Print the device ms under each phase range of a profiled call: its
    own work, and with the ranges nested in it; and the share of the call's
    device time the ranges hold. Returns {range: (own ms, with nested)}."""
    dev_ms = sum(prof.split.values())
    if not prof.ranges or not dev_ms:
        print(f"  {label}: the profiler recorded no device time under a range; not measured",
              flush=True)
        return {}
    rows = {name: (prof.ranges.get(name, 0.0), nested_ms(prof, name)) for name in prof.parents}
    held = sum(prof.ranges.values())
    print(f"  {label}: device ms by phase range, own work [with the ranges nested in it]: "
          + ", ".join(f"{name} {own:.3f}" + (f" [{tot:.3f}]" if tot != own else "")
                      for name, (own, tot) in rows.items())
          + f"; the ranges hold {held:.3f} of the call's {dev_ms:.3f} ms device time "
          f"({held / dev_ms:.1%}) on {smi}", flush=True)
    return rows


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


def replay_kat(proto: str, fname: str, kp, dev: torch.device, phase: str) -> None:
    """The port with the draws of the known-answer file ``fname`` (made by
    scripts/make_torch_kat.py from the JAX package) on ``dev``: every
    message and verdict, the tampered probes' included, must equal the
    file's, bit for bit."""
    from ringzk_tpu_torch import interop
    from ringzk_tpu_torch.protocols import linear
    from ringzk_tpu_torch.protocols import open as open_mod
    from ringzk_tpu_torch.protocols import sum as sum_mod

    kat = np.load(REPO / "ringzk_tpu_torch" / fname)
    T = lambda k: torch.from_numpy(kat[k].view(np.int32) if kat[k].dtype == np.uint32
                                   else kat[k]).to(dev)
    kck = interop.commitment_key_from_numpy(kat["a1"], kat["a2"], kp, dev)
    vctx_bad = None
    if proto == "open":
        rctx, pcom = open_mod.prover_commit(None, kck, T("x"), kp, r=T("r"), y=T("y"))
        vctx, chal = open_mod.generate_challenge(None, pcom, kp, signs=T("signs"), u=T("u"))
        resp = open_mod.create_response(rctx, chal, kp)
        got = dict(c=pcom.c.c, t=pcom.t, d=chal.d, z=resp.z)
        verify = open_mod.verify
    elif proto == "linear":
        rctx, pcom = linear.prover_commit(None, kck, T("g"), T("x"), kp, r=T("r"),
                                          rp=T("rp"), y=T("y"), yp=T("yp"))
        vctx, chal = linear.generate_challenge(None, pcom, kp, signs=T("signs"), u=T("u"))
        resp = linear.create_response(rctx, chal, kp)
        vctx_bad = vctx._replace(g=T("g_bad"))
        got = dict(c=pcom.c.c, cp=pcom.cp.c, t=pcom.t, tp=pcom.tp, u_msg=pcom.u,
                   d=chal.d, z=resp.z, zp=resp.zp)
        verify = linear.verify
    else:
        rctx, pcom = sum_mod.prover_commit(None, kck, T("gs"), T("xs"), kp, rs=T("rs"),
                                           rp=T("rp"), ys=T("ys"), yp=T("yp"))
        vctx, chal = sum_mod.generate_challenge(None, pcom, kp, signs=T("signs"), u=T("u"))
        resp = sum_mod.create_response(rctx, chal, kp)
        got = dict(cp=pcom.cp.c, cs=pcom.cs.c, tp=pcom.tp, ts=pcom.ts, u_msg=pcom.u,
                   d=chal.d, zs=resp.zs, zp=resp.zp)
        verify = sum_mod.verify
    got.update(verdicts(proto, verify, kck, resp, vctx, kp, vctx_bad))
    for k, v in got.items():
        if not torch.equal(v, T(k)):
            fail(f"{phase} known answer {fname} {proto}.{k} differs from the JAX package's")
    print(f"{phase} known answers {fname}: {', '.join(got)} equal to the JAX package's "
          f"(B={kat['d'].shape[0]}, N={kat['d'].shape[-1]}, q={kp.modulus}, operator "
          f"{list(kck.a1_dig.shape) if kck.a1_dig is not None else None})", flush=True)


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
    NTT path (K7, K8) and no K3, K5 or K6, and add their centred int64
    residues without modq; linear and sum transform their g products with
    K1/K2 on narrow rings."""
    if wide:
        return ("K4", "K7", "K8"), ("K3", "K5", "K6", "modq")
    matvec, other = ("K3", "K6") if n == N_DEG else ("K6", "K3")
    g_products = ("K1", "K2") if proto != "open" else ()
    return g_products + (matvec, "K4", "K5", "modq"), (other,)


class Recorder:
    """Records the arguments of the first launch at each shape of kernel
    wrappers (the protocol kernels' K1-K5, K7, K8; the sp path's K4, K9)
    while active, so that :meth:`check` can hold each kernel against its
    plain version at the shapes a path gave it. The launch counters stay
    the wrappers' own."""

    def __init__(self, targets: dict):
        # name: (module, wrapper attribute, plain version, the batch axis of
        # each argument for the plain version's chunks (None: not split),
        # the batch axis of the output)
        self.targets = targets
        self.calls = {}
        self.counts = {}   # launches at each shape while active

    def __enter__(self):
        self.saved = {}
        for name, (mod, attr, *_) in self.targets.items():
            fn = self.saved[name] = getattr(mod, attr)

            def wrapped(*args, _name=name, _fn=fn):
                key = (_name,) + tuple((tuple(a.shape), a.dtype) if torch.is_tensor(a)
                                       else (a.n, a.q) if hasattr(a, "primes") else a
                                       for a in args)
                self.calls.setdefault(key, args)
                self.counts[key] = self.counts.get(key, 0) + 1
                return _fn(*args)
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr, *_) in self.targets.items():
            setattr(mod, attr, self.saved[name])

    def results(self, chunk: int):
        """(kernel name, argument shapes, kernel output, plain output) of
        each recorded launch, the plain version ``chunk`` batch rows at a
        time; forgets the calls."""
        for key, args in self.calls.items():
            name = key[0]
            mod, attr, plain, axes, out_axis = self.targets[name]
            kern = getattr(mod, attr)(*args)
            rows = next(a.shape[ax] for a, ax in zip(args, axes) if ax is not None)
            parts = []
            for lo in range(0, rows, chunk):
                part = [a.narrow(ax, lo, min(chunk, rows - lo)) if ax is not None else a
                        for a, ax in zip(args, axes)]
                parts.append(plain(*part))
            shape = ", ".join(str(list(a.shape)) for a in args if torch.is_tensor(a))
            yield name, shape, kern, torch.cat(parts, dim=out_axis)
        self.calls.clear()

    def check(self, phase: str, chunk: int) -> dict:
        """Each recorded launch against its plain version (:meth:`results`);
        fails the run on a difference, else returns the largest error per
        kernel."""
        errs = {}
        for name, shape, kern, want in self.results(chunk):
            errs[name] = max(errs.get(name, 0), compare(f"{phase} {name} at {shape}", kern, want))
        return errs


def protocol_recorder() -> tuple:
    """A :class:`Recorder` over the protocol kernels' wrappers (K1-K5, K7,
    K8), and the kernel name of each of their launch counters."""
    from ringzk_tpu_torch.ops.kernels import challenge as k_chal
    from ringzk_tpu_torch.ops.kernels import matvec as k_mv
    from ringzk_tpu_torch.ops.kernels import ntt as k_ntt
    from ringzk_tpu_torch.ops.kernels import ntt_wide as k_wide
    from ringzk_tpu_torch.ops.kernels import scalar_mul_add as k_sma

    rec = Recorder({
        "K1": (k_ntt, "fwd_all", k_ntt.fwd_all_plain, (None, 0, None), 1),
        "K2": (k_ntt, "inv_all", k_ntt.inv_all_plain, (None, 1), 0),
        "K3": (k_mv, "matvec_digits", k_mv.matvec_digits_plain, (None, None, None, 0, None), 0),
        "K4": (k_chal, "challenge_select", k_chal.challenge_select_plain, (0, 0, None), 0),
        "K5": (k_sma, "scalar_mul_add", k_sma.scalar_mul_add_plain, (None, 0, 0, 0, None), 0),
        "K7": (k_wide, "fwd_wide_all", k_wide.fwd_wide_all_plain, (None, 0, None), 1),
        "K8": (k_wide, "inv_wide_all", k_wide.inv_wide_all_plain, (None, 1), 0),
    })
    names = {"ntt_fwd": "K1", "ntt_inv": "K2", "matvec_digits": "K3", "challenge_select": "K4",
             "scalar_mul_add": "K5", "ntt_fwd_wide": "K7", "ntt_inv_wide": "K8"}
    return rec, names


def sp_recorder() -> Recorder:
    """A :class:`Recorder` over the kernels of the sp path: K4 and K9's
    local stages on each rank's table (``ntt_sp.fwd_local``/``inv_local``,
    held against the ``_local_stage`` network)."""
    from ringzk_tpu_torch.ops.kernels import challenge as k_chal
    from ringzk_tpu_torch.parallel import ntt_sp

    rows = (None, None, None, None, 0)   # (ring, prime, sp, rank, x)
    return Recorder({
        "K4": (k_chal, "challenge_select", k_chal.challenge_select_plain, (0, 0, None), 0),
        "K9 fwd": (ntt_sp, "fwd_local", ntt_sp.fwd_local_plain, rows, 0),
        "K9 inv": (ntt_sp, "inv_local", ntt_sp.inv_local_plain, rows, 0),
    })


def user_surface(dev: torch.device, smi: str) -> None:
    """Phase [9]: the user-facing layer on the card. (a) the four golden
    transcripts through the object API; (b) open, linear and sum through
    the Prover/Verifier classes at full width, then ``roundtrip`` at one
    chain and at bench.py's chain counts, timed, with peak memory; (c) the
    relaxed opening (f = 1, f from ``challenge_difference``, and (x, f.r,
    f)) at open's full batch, against a CPU run on some rows; (d) the RZK1
    wire round trip of open's messages and contexts at B_WIRE. Every kernel
    launch of each part is recorded and held against the plain version at
    its shape; each part runs from launch counts set to 0."""
    import ringzk_tpu_torch as rt
    from ringzk_tpu_torch import interop
    from ringzk_tpu_torch.ops import kernels, sampling
    from ringzk_tpu_torch.ops.ntt import get_ring
    from ringzk_tpu_torch.utils import serial
    from ringzk_tpu_torch.utils.testvectors import transcript_digest

    rec, names = protocol_recorder()
    errs = {}

    def run(label: str, fn, must: tuple):
        """fn() from launch counts set to 0, its kernel launches recorded;
        fails unless each kernel of ``must`` launched."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        with rec:
            out = fn()
        torch.cuda.synchronize()
        counts = {names[k]: v for k, v in kernels.LAUNCHES.items() if v and k in names}
        for k in must:
            if not counts.get(k):
                fail(f"[9] {label}: kernel {k} was not launched ({counts})")
        print(f"[9] launches in {label}: {counts}", flush=True)
        return out

    def held(part: str):
        for k, e in rec.check(f"[9] {part}", chunk=B_SUM).items():
            errs[k] = max(errs.get(k, 0), e)

    def T(a):
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)

    # (a) the goldens, from the JAX package's draws
    want = json.loads((REPO / "tests" / "golden" / "transcripts.json").read_text())
    with np.load(REPO / "ringzk_tpu_torch" / "kat_golden_n16.npz") as kat:
        golden = {name: {k.split(".", 1)[1]: kat[k] for k in kat.files
                         if k.startswith(name + ".")} for name in GOLDEN_SETS}
    for name, g in golden.items():
        m = int(g["modulus"])
        gp = rt.Params() if m == rt.DEFAULT_PARAMS.modulus else rt.Params(q=m // 2, modulus=m)
        gck = interop.commitment_key_from_numpy(g["a1"], g["a2"], gp)

        def transcript():
            prover, verifier = rt.OpenProofProver(gck, gp), rt.OpenProofVerifier(gck, gp)
            rctx, pcom = prover.commit(None, T(g["x"]), r=T(g["r"]), y=T(g["y"]))
            vctx, chal = verifier.generate_challenge(None, pcom, signs=T(g["signs"]),
                                                     u=T(g["u"]))
            resp = prover.create_response(rctx, chal)
            return pcom, chal, resp, verifier.verify(resp, vctx)

        pcom, chal, resp, ok = run(f"golden {name}", transcript,
                                   ("K7", "K8") if m >= 2**32 else ("K5",))
        got = {"ck": transcript_digest({"a1": gck.a1, "a2": gck.a2}),
               "proof_commitment": transcript_digest(pcom),
               "challenge": transcript_digest(chal), "response": transcript_digest(resp)}
        if not bool(ok.all()) or got != want[name]:
            fail(f"[9] golden {name}: verdicts {ok.tolist()}, digests {got} against {want[name]}")
        print(f"[9] golden {name} (q={m}, N=16, B=2): all four digests equal "
              f"tests/golden/transcripts.json: " + ", ".join(f"{k} {v[:12]}" for k, v in got.items()),
              flush=True)
    held("goldens")

    # (b) the object API at full width, then roundtrip at 1 and at bench.py's chains
    params = rt.Params()
    gen = torch.Generator(device=dev).manual_seed(9)
    ck = rt.generate_commitment_key(gen, params, N_DEG)

    def centered(shape, bound=params.q):
        return sampling.uniform_centered(gen, shape[:-1], shape[-1], bound, dev)

    inputs = {"open": (centered((B_OPEN, params.l, N_DEG)),),
              "linear": (centered((B_LINEAR, N_DEG)), centered((B_LINEAR, params.l, N_DEG))),
              "sum": (centered((B_SUM, VL, N_DEG)), centered((B_SUM, VL, params.l, N_DEG)))}
    classes = {"open": (rt.OpenProofProver, rt.OpenProofVerifier, rt.open_proof),
               "linear": (rt.LinearProofProver, rt.LinearProofVerifier, rt.linear_proof),
               "sum": (rt.SumProofProver, rt.SumProofVerifier, rt.sum_proof)}
    surface = {}
    for proto, (prover_cls, verifier_cls, mod) in classes.items():
        prover, verifier = prover_cls(ck, params), verifier_cls(ck, params)
        args = inputs[proto]
        batch = args[0].shape[0]
        must = ("K3", "K4", "K5") + (("K1", "K2") if proto != "open" else ())

        def flow(prover=prover, verifier=verifier, args=args):
            rctx, pcom = prover.commit(gen, *args)
            vctx, chal = verifier.generate_challenge(gen, pcom)
            resp = prover.create_response(rctx, chal)
            return resp, vctx, verifier.verify(resp, vctx)

        resp, vctx, ok = run(f"the {proto} API flow B={batch}", flow, must)
        zname = "zs" if proto == "sum" else "z"
        forged = getattr(resp, zname).clone()
        forged[..., 0, 0] += 1
        bad = verifier.verify(resp._replace(**{zname: forged}), vctx)
        if not bool(ok.all()) or bool(bad.any()):
            fail(f"[9] {proto} API flow: {int((~ok).sum())} honest proofs rejected, "
                 f"{int(bad.sum())} forged ones verified")
        del resp, vctx, ok, bad, forged
        held(f"{proto} API flow")
        flow_ms = sorted(cuda_call_ms(flow, calls=5))[2]
        print(f"[9] {proto} API flow (Prover.commit, Verifier.generate_challenge, "
              f"Prover.create_response, Verifier.verify) B={batch}: every proof verifies, a "
              f"forged {zname} rejects; median {flow_ms:.3f} ms of 5, "
              f"{batch / flow_ms * 1e3:.1f} verified proofs/s on {smi}", flush=True)
        rows = {}
        for chains in (1, CHAINS[proto]):
            def rt_call(chains=chains, mod=mod, args=args):
                return mod.roundtrip(gen, ck, *args, params, chains=chains)

            ok, op_ok = run(f"the {proto} roundtrip chains={chains}", rt_call, must)
            if ok.shape != (batch,) or not bool(ok.all()) or not bool(op_ok.all()):
                fail(f"[9] {proto} roundtrip chains={chains}: {int((~ok).sum())} proofs and "
                     f"{int((~op_ok).sum())} openings rejected of {tuple(ok.shape)}")
            del ok, op_ok
            held(f"{proto} roundtrip chains={chains}")
            ms = sorted(cuda_call_ms(rt_call, calls=5))[2]
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            rt_call()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - before
            rows[chains] = (ms, batch / ms * 1e3, peak)
            wall_ms, split = device_split(rt_call)[:2]
            idle = (f"device time {sum(split.values()):.3f} ms against a host wall of "
                    f"{wall_ms:.3f} ms (idle share {max(0.0, 1 - sum(split.values()) / wall_ms):.2%}"
                    f"; K1-K11 and modq {sum(v for k, v in split.items() if k != 'other'):.3f} ms)"
                    if split else "device split not measured")
            print(f"[9] {proto} roundtrip chains={chains} B={batch}: median {ms:.3f} ms of 5, "
                  f"{batch / ms * 1e3:.1f} verified proofs/s, peak {peak / 2**30:.3f} GiB above "
                  f"the {before / 2**30:.3f} GiB held before it; one profiled call: {idle}; on "
                  f"{smi}", flush=True)
        (ms1, rate1, peak1), (msc, ratec, peakc) = rows[1], rows[CHAINS[proto]]
        surface[proto] = rows
        print(f"[9] {proto} chains={CHAINS[proto]} against chains=1: peak memory "
              f"{peakc / 2**30:.3f} against {peak1 / 2**30:.3f} GiB ({peakc / peak1 - 1:+.1%}), "
              f"rate {ratec:.1f} against {rate1:.1f} proofs/s ({ratec / rate1 - 1:+.2%})",
              flush=True)

    # (c) the relaxed opening at open's full batch
    ring = get_ring(N_DEG, params.modulus)
    x = inputs["open"][0]
    s1, u1 = sampling.challenge_draws(gen, (B_OPEN,), N_DEG, dev)
    s2, u2 = sampling.challenge_draws(gen, (B_OPEN,), N_DEG, dev)
    one = torch.zeros((B_OPEN, N_DEG), dtype=torch.int32, device=dev)
    one[:, 0] = 1

    def relaxed():
        opening, com = rt.commit(gen, ck, x, params)
        f = sampling.challenge_difference(None, (B_OPEN,), N_DEG, params.kappa, dev,
                                          signs=(s1, s2), u=(u1, u2))
        fr = ring.polymul(f.unsqueeze(-2), opening.r)
        cases = {"f=None": opening, "f=1": opening._replace(f=one),
                 "f=c-c'": opening._replace(f=f), "(x, f.r, f)": rt.Opening(x, fr, f)}
        return opening, com, f, {k: rt.verify(ck, com, o, params) for k, o in cases.items()}

    opening, com, f, verdicts = run(f"the relaxed opening B={B_OPEN}", relaxed,
                                    ("K1", "K2", "K3", "K4"))
    if not (bool(verdicts["f=None"].all()) and torch.equal(verdicts["f=1"], verdicts["f=None"])
            and not bool(verdicts["f=c-c'"].any()) and bool(verdicts["(x, f.r, f)"].all())):
        fail("[9] relaxed opening verdicts: " + ", ".join(
            f"{k} {int(v.sum())} of {B_OPEN}" for k, v in verdicts.items()))
    held("relaxed opening")
    none_ms = sorted(cuda_call_ms(lambda: rt.verify(ck, com, opening, params), calls=5))[2]
    f_ms = sorted(cuda_call_ms(lambda: rt.verify(ck, com, opening._replace(f=f), params),
                               calls=5))[2]
    # the same rows on the CPU, the plain versions throughout
    r_ = RELAXED_CHECK_ROWS
    cck = interop.commitment_key_from_numpy(ck.a1.cpu().numpy(), ck.a2.cpu().numpy(), params,
                                            "cpu")
    cf = sampling.challenge_difference(None, (r_,), N_DEG, params.kappa, "cpu",
                                       signs=(s1[:r_].cpu(), s2[:r_].cpu()),
                                       u=(u1[:r_].cpu(), u2[:r_].cpu()))
    if not torch.equal(cf, f[:r_].cpu()):
        fail("[9] challenge_difference on the card differs from the CPU's on the same draws")
    cop = rt.Opening(x[:r_].cpu(), opening.r[:r_].cpu())
    ccom = rt.Commitment(com.c[:r_].cpu())
    cfr = get_ring(N_DEG, params.modulus).polymul(cf.unsqueeze(-2), cop.r)
    cpu_cases = {"f=None": cop, "f=1": cop._replace(f=one[:r_].cpu()),
                 "f=c-c'": cop._replace(f=cf), "(x, f.r, f)": rt.Opening(cop.x, cfr, cf)}
    for k, o in cpu_cases.items():
        if not torch.equal(rt.verify(cck, ccom, o, params), verdicts[k][:r_].cpu()):
            fail(f"[9] relaxed opening {k}: the card's verdicts differ from the CPU's")
    print(f"[9] relaxed opening B={B_OPEN}: f=None and f=1 accept all, f = c - c' "
          f"(challenge_difference) rejects all, (x, f.r, f) accepts all; f and the verdicts "
          f"equal a CPU run of the plain versions on {r_} rows; verify {none_ms:.3f} ms with "
          f"f=None, {f_ms:.3f} ms with f (median of 5) on {smi}", flush=True)
    del opening, com, f, verdicts, one, s1, s2, u1, u2

    # (d) the wire: open's messages and contexts at B_WIRE
    xw = x[:B_WIRE]
    prover, verifier = rt.OpenProofProver(ck, params), rt.OpenProofVerifier(ck, params)

    def wire_flow():
        rctx, pcom = prover.commit(gen, xw)
        vctx, chal = verifier.generate_challenge(gen, pcom)
        return rctx, pcom, vctx, chal, prover.create_response(rctx, chal)

    objs = run(f"the open API flow B={B_WIRE}", wire_flow, ("K3", "K4", "K5"))
    held("wire flow")
    if not bool(verifier.verify(objs[4], objs[2]).all()):
        fail("[9] wire: the B_WIRE proofs do not verify")

    def same(a, b) -> bool:
        if hasattr(a, "_fields"):
            return type(a) is type(b) and all(same(u, v) for u, v in zip(a, b))
        if a is None or b is None:
            return a is None and b is None
        return a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)

    for obj in objs:
        for compact in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blob = serial.dumps(obj, compact)
            t1 = time.perf_counter()
            back = serial.rebuild(type(obj), serial.loads(blob), device=dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if not same(back, obj) or serial.dumps(back, compact) != blob:
                fail(f"[9] wire: {type(obj).__name__} ({'compact' if compact else 'raw'}) "
                     "does not round-trip exactly")
            print(f"[9] wire {type(obj).__name__} {'compact' if compact else 'raw'} "
                  f"B={B_WIRE}: {len(blob)} bytes ({len(blob) / B_WIRE:.1f} per proof), dumps "
                  f"{(t1 - t0) * 1e3:.1f} ms, loads + rebuild {(t2 - t1) * 1e3:.1f} ms (host "
                  "clock), round trip exact", flush=True)
    del objs
    print(f"[9] user surface: kernels held against their plain versions at every shape "
          f"phase [9] launched them, largest errors {errs}", flush=True)


def _head(obj, rows: int):
    """The first ``rows`` proofs of a protocol message (a NamedTuple of
    batch-leading tensors, possibly nested)."""
    if hasattr(obj, "_fields"):
        return type(obj)(*(_head(f, rows) for f in obj))
    return None if obj is None else obj[:rows].clone()


def _same(a, b) -> bool:
    """Equal tensors in equal (nested) tuples."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(u, v) for u, v in zip(a, b))
    return (a is None and b is None) or torch.equal(a, b)


def recording_roundtrip(mod, params, log: list, forge: bool = False):
    """A round trip with ``roundtrip``'s signature and order of draws that
    keeps the messages of its first MSG_ROWS proofs in ``log`` (the opening
    checks draw nothing and are left out); with ``forge`` it verifies a
    response whose first z coefficient is one off (``tampered``)."""

    def fn(gen, ck, *args, chains=1):
        data = args[:-1]  # the last argument is the round trip's params
        rctx, pcom = mod.prover_commit(gen, ck, *data, params)
        vctx, chal = mod.generate_challenge(gen, pcom, params)
        resp = mod.create_response(rctx, chal, params)
        log.append(tuple(_head(m, MSG_ROWS) for m in (pcom, chal, resp)))
        if forge:
            proto = "sum" if hasattr(resp, "zs") else "open"
            resp = tampered(proto, resp, params.verify_bound(N_DEG) + 1, False)["ok_forged"]
        ok = mod.verify(ck, resp, vctx, params)
        return ok, torch.ones_like(ok)

    return fn


def _gloo_rank(task: str, rank: int, world: int, init: str, seed: int, queue,
               device: str) -> None:
    """One rank of a gloo group on ``device`` (the card), spawned by phase
    [10] or [11]: runs ``task`` ("dp", "tp" or "sp") and puts (rank,
    result) on ``queue``, or (rank, the error) when it fails."""
    import traceback

    try:
        sys.path.insert(0, str(REPO))
        import torch.distributed as dist

        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
        try:
            tasks = {"dp": _gloo_dp, "tp": _gloo_tp, "sp": _gloo_sp}
            queue.put((rank, tasks[task](rank, world, seed, dev)))
        finally:
            dist.destroy_process_group()
    except Exception:  # the parent reports it and fails the run
        queue.put((rank, {"error": traceback.format_exc()}))


def _gloo_collectives(rank: int, world: int, dev) -> str:
    """Whether gloo takes CUDA tensors for the collectives the dp and tp
    paths use: "" when it does, else the refusal."""
    import torch.distributed as dist

    try:
        t = torch.tensor([rank + 1], dtype=torch.int32, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        b = torch.full((4,), rank, dtype=torch.int32, device=dev)
        dist.broadcast(b, 0)
        parts = [torch.empty_like(b) for _ in range(world)]
        dist.all_gather(parts, b)
        torch.cuda.synchronize()
    except RuntimeError as err:
        return f"{type(err).__name__}: {err}"
    if t.item() != 1 or b.tolist() != [0] * 4 or any(p.tolist() != [0] * 4 for p in parts):
        return f"wrong results: all_reduce {t.item()}, broadcast {b.tolist()}"
    return ""


def _gloo_dp(rank: int, world: int, seed: int, dev: torch.device) -> dict:
    """dp open at B_DP_GLOO over this gloo group on the card: rank 0's key
    replicated, the global x made alike on every rank from ``seed``."""
    from ringzk_tpu_torch import Params
    from ringzk_tpu_torch.ops import kernels, sampling
    from ringzk_tpu_torch.parallel import mesh as mesh_mod
    from ringzk_tpu_torch.protocols import commit as commit_mod

    refused = _gloo_collectives(rank, world, dev)
    if refused:
        return {"refused": refused}
    params = Params()
    mesh = mesh_mod.make_mesh(device=dev)
    ck0 = (commit_mod.keygen(torch.Generator(device=dev).manual_seed(seed), params, N_DEG)
           if rank == 0 else None)
    ck = mesh_mod.replicate(mesh, ck0, params)
    x = sampling.uniform_centered(torch.Generator(device=dev).manual_seed(seed + 1),
                                  (B_DP_GLOO, params.l), N_DEG, params.q, dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    ok, all_ok = mesh_mod.batched_open_prove_verify(
        mesh, torch.Generator(device=dev).manual_seed(seed + 2), ck, x, params)
    torch.cuda.synchronize()
    return {"ok": mesh_mod.gather_ok(mesh, ok).cpu().tolist(), "all_ok": bool(all_ok), "launches": dict(kernels.LAUNCHES)}


def _gloo_tp(rank: int, world: int, seed: int, dev: torch.device) -> dict:
    """polymul_tp at N=512 over TP_ROWS rows on this tp group of three
    gloo ranks on the card: the product against ``RingContext.polymul`` on
    the card, each K9 launch against K9's plain version, K9's launches, and
    times."""
    import torch.distributed as dist

    from ringzk_tpu_torch import Params
    from ringzk_tpu_torch.ops import kernels, sampling
    from ringzk_tpu_torch.ops.kernels import ntt_one as k_one
    from ringzk_tpu_torch.ops.ntt import get_ring
    from ringzk_tpu_torch.parallel import ntt_tp

    refused = _gloo_collectives(rank, world, dev)
    if refused:
        return {"refused": refused}
    q = Params().modulus
    ring = get_ring(N_DEG, q)
    tpm = ntt_tp.make_tp_mesh(dp=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    a, b = (sampling.uniform_centered(gen, (TP_ROWS,), N_DEG, q // 2, dev) for _ in range(2))
    calls = []
    fwd, inv = k_one.fwd_one, k_one.inv_one

    def recorded(kind, fn):
        def wrapped(ring_, i, x):
            out = fn(ring_, i, x)
            calls.append((kind, i, x, out))
            return out
        return wrapped

    k_one.fwd_one, k_one.inv_one = recorded("fwd", fwd), recorded("inv", inv)
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = ntt_tp.polymul_tp(tpm, a, b, N_DEG, q)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    finally:
        k_one.fwd_one, k_one.inv_one = fwd, inv
    plain = {"fwd": k_one.fwd_one_plain, "inv": k_one.inv_one_plain}
    errs = [int((got.to(torch.int64) - plain[kind](ring, i, x).to(torch.int64)).abs().max())
            for kind, i, x, got in calls]
    # each rank times its first forward and its inverse while the others
    # wait, so that no two ranks share the card then; at 4096 rows a K9
    # launch is shorter than its host call, so the launches are queued
    kind_ms = {}
    for turn in range(world):
        dist.barrier()
        for kind, i, x, _ in calls if turn == rank else ():
            if kind not in kind_ms:
                kind_ms[kind] = (
                    queued_ms(lambda: (fwd if kind == "fwd" else inv)(ring, i, x), reps=20),
                    cuda_ms(lambda: plain[kind](ring, i, x), reps=2))
    dist.barrier()
    tp_ms = sorted(cuda_call_ms(lambda: ntt_tp.polymul_tp(tpm, a, b, N_DEG, q), calls=5))[2]
    return {"prime": tpm.tp_rank, "equal": torch.equal(out, ring.polymul(a, b)),
            "launches": launches, "errs": errs,
            "k9_ms": kind_ms, "polymul_tp_ms": tp_ms}


def spawn_gloo(task: str, world: int, seed: int, device: str = "cuda:0",
               timeout: float = 240, phase: str = "[10]") -> list:
    """Run ``task`` on ``world`` spawned gloo ranks on ``device`` and return
    their results in rank order; every process is joined (or killed) before
    this returns."""
    import socket

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    init = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    s.close()
    procs = [ctx.Process(target=_gloo_rank, args=(task, r, world, init, seed, queue, device))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=timeout) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    errors = {r: res["error"] for r, res in got.items() if "error" in res}
    if errors:
        fail(f"{phase} gloo {task} ranks failed: {errors}")
    return [got[r] for r in range(world)]


def parallel_phase(dev: torch.device, smi: str, path_ms: dict) -> dict:
    """Phase [10]: the dp and tp axes and batched keys on the card. (a) dp
    over a one-rank NCCL group at the paths' batches, each against the
    one-process round trip on the rank's generator (verdicts and the first
    proofs' messages), the AND-reduce false after a forged proof, timed
    beside [7]'s round trip with the all-reduce alone; then
    ``multihost.batch_verify_run``; (b) two gloo ranks on the card for dp
    open and three for ``polymul_tp`` (K9 on each rank); (c) one key per
    proof for open, linear and sum, every kernel launch held against its
    plain version. Returns the launch counts of each path it drove, and
    K9's milliseconds on the tp path by prime and direction."""
    import tempfile

    import torch.distributed as dist

    from ringzk_tpu_torch import Params
    from ringzk_tpu_torch.ops import kernels, sampling
    from ringzk_tpu_torch.ops.kernels import ntt_one as k_one
    from ringzk_tpu_torch.parallel import mesh as mesh_mod
    from ringzk_tpu_torch.parallel import multihost
    from ringzk_tpu_torch.protocols import commit as commit_mod
    from ringzk_tpu_torch.protocols import linear
    from ringzk_tpu_torch.protocols import open as open_mod
    from ringzk_tpu_torch.protocols import sum as sum_mod

    mods = {"open": open_mod, "linear": linear, "sum": sum_mod}
    batched = {"open": mesh_mod.batched_open_prove_verify,
               "linear": mesh_mod.batched_linear_prove_verify,
               "sum": mesh_mod.batched_sum_prove_verify}
    params = Params()
    launches = {}
    gen = torch.Generator(device=dev).manual_seed(10)

    def centered(shape):
        return sampling.uniform_centered(gen, shape[:-1], shape[-1], params.q, dev)

    def counted(label: str, fn, must: tuple, must_not: tuple = ()):
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches[label] = dict(kernels.LAUNCHES)
        for k in must:
            if not launched(launches[label], k):
                fail(f"[10] {label}: kernel {k} was not launched ({launches[label]})")
        for k in must_not:
            if launched(launches[label], k):
                fail(f"[10] {label}: kernel {k} was launched ({launches[label]})")
        return out

    # (a) dp over a one-rank NCCL group
    rdzv = tempfile.mkdtemp()
    if multihost.init_distributed(f"file://{rdzv}/rendezvous", 1, 0) != (0, 1):
        fail("[10] init_distributed did not give a one-rank group")
    try:
        mesh = multihost.global_mesh()
        if dist.get_backend() != "nccl" or mesh.device != dev:
            fail(f"[10] the group is {dist.get_backend()} on {mesh.device}, not NCCL on {dev}")
        ck = mesh_mod.replicate(mesh, commit_mod.keygen(gen, params, N_DEG), params)
        data = {"open": (centered((B_OPEN, params.l, N_DEG)),),
                "linear": (centered((B_LINEAR, N_DEG)), centered((B_LINEAR, params.l, N_DEG))),
                "sum": (centered((B_SUM, VL, N_DEG)), centered((B_SUM, VL, params.l, N_DEG)))}
        for proto, mod in mods.items():
            args, batch = data[proto], data[proto][0].shape[0]

            def new_gen():
                return torch.Generator(device=dev).manual_seed(20)

            def dp_call(proto=proto, args=args):
                return batched[proto](mesh, new_gen(), ck, *args, params)

            ok, all_ok = counted(f"dp {proto} world 1", dp_call,
                                 path_kernels(proto, False, N_DEG)[0])
            want, op_ok = mod.roundtrip(commit_mod.chain_generators(new_gen(), 1)[0], ck, *args,
                                        params)
            if not (torch.equal(ok, want & op_ok) and bool(ok.all()) and bool(all_ok)):
                fail(f"[10] dp {proto}: {int((~ok).sum())} of {batch} rejected, all_ok "
                     f"{bool(all_ok)}, {int((ok != (want & op_ok)).sum())} verdicts differ from "
                     "the one-process round trip")
            del want, op_ok
            log_dp, log_1p, log_f = [], [], []
            local = mesh_mod.shard_batch(mesh, args)
            mesh_mod._step_fn(mesh, recording_roundtrip(mod, params, log_dp), ck, params)(
                new_gen(), *local)
            recording_roundtrip(mod, params, log_1p)(
                commit_mod.chain_generators(new_gen(), 1)[0], ck, *args, params)
            if not _same(log_dp[0], log_1p[0]):
                fail(f"[10] dp {proto}: the first {MSG_ROWS} proofs' messages differ from the "
                     "one-process round trip's")
            _, forged_all = mesh_mod._step_fn(
                mesh, recording_roundtrip(mod, params, log_f, forge=True), ck, params)(
                new_gen(), *local)
            if bool(forged_all):
                fail(f"[10] dp {proto}: all_ok stayed true with a forged proof")
            del log_dp, log_1p, log_f
            ms = sorted(cuda_call_ms(dp_call, calls=5))[2]
            ar_ms = cuda_ms(lambda ok=ok: mesh_mod.all_verified(mesh, ok), reps=50)
            print(f"[10] dp {proto} over one NCCL rank B={batch}: every verdict equal to the "
                  f"one-process round trip on the rank's generator, the first {MSG_ROWS} proofs' "
                  f"messages equal, all_ok true and false after one forged z; median {ms:.3f} ms "
                  f"of 5, {batch / ms * 1e3:.1f} verified proofs/s against [7]'s round trip "
                  f"{path_ms[proto]:.3f} ms ({ms / path_ms[proto] - 1:+.2%}); the AND all-reduce "
                  f"alone {ar_ms:.4f} ms; launches {launches[f'dp {proto} world 1']} on {smi}",
                  flush=True)
            del ok, all_ok
        del data
        gc.collect()
        torch.cuda.empty_cache()
        out = multihost.batch_verify_run(total_batch=B_OPEN, n_deg=N_DEG)
        if out["all_ok"] is not True:
            fail(f"[10] batch_verify_run: {out}")
        print(f"[10] multihost.batch_verify_run(total_batch={B_OPEN}, n_deg={N_DEG}) over one "
              f"NCCL rank: {json.dumps(out)} on {smi}", flush=True)
    finally:
        dist.destroy_process_group()

    # (b) several gloo ranks on the one card
    k9_tp = {}
    ranks = spawn_gloo("dp", 2, seed=30)
    refused = [r["refused"] for r in ranks if "refused" in r]
    if refused:
        print(f"[10] gloo refused CUDA tensors ({refused[0]}): the multi-rank runs on the one "
              "card are left out", flush=True)
    else:
        ck2 = commit_mod.keygen(torch.Generator(device=dev).manual_seed(30), params, N_DEG)
        x2 = sampling.uniform_centered(torch.Generator(device=dev).manual_seed(31),
                                       (B_DP_GLOO, params.l), N_DEG, params.q, dev)
        want, op_ok = open_mod.roundtrip(torch.Generator(device=dev).manual_seed(32), ck2, x2,
                                         params, chains=2)
        want = (want & op_ok).cpu().tolist()
        for r, res in enumerate(ranks):
            if res["ok"] != want or not res["all_ok"] or not all(want):
                fail(f"[10] gloo dp rank {r}: verdicts differ from roundtrip(chains=2) or "
                     f"reject ({sum(res['ok'])} of {B_DP_GLOO} accepted)")
            for k in ("K3", "K4", "K5"):
                if not launched(res["launches"], k):
                    fail(f"[10] gloo dp rank {r}: kernel {k} was not launched")
        launches["dp open over 2 gloo ranks"] = {
            c: sum(res["launches"][c] for res in ranks) for c in kernels.LAUNCHES}
        print(f"[10] dp open over two gloo ranks on the one card, B={B_DP_GLOO}: the gathered "
              f"verdicts of each rank equal the one-process roundtrip(chains=2), all true; "
              f"launches per rank {[res['launches'] for res in ranks]}", flush=True)
        ranks = spawn_gloo("tp", 3, seed=40)
        for r, res in enumerate(ranks):
            if "refused" in res:
                fail(f"[10] gloo tp rank {r}: {res['refused']}")
            n_fwd, n_inv = res["launches"]["ntt_fwd_one"], res["launches"]["ntt_inv_one"]
            if not res["equal"] or any(res["errs"]) or n_fwd < 2 or n_inv < 1:
                fail(f"[10] tp rank {r}: product equal to polymul {res['equal']}, K9 errors "
                     f"{res['errs']}, K9 launches {n_fwd} forward and {n_inv} inverse")
            (f_ms, f_plain), (i_ms, i_plain) = res["k9_ms"]["fwd"], res["k9_ms"]["inv"]
            fb, ib = k9_bound(TP_ROWS, N_DEG, False), k9_bound(TP_ROWS, N_DEG, True)
            print(f"[10] tp rank {r} (prime {res['prime']}): polymul_tp over {TP_ROWS} rows at "
                  f"N={N_DEG} equals RingContext.polymul on the card; K9 launched {n_fwd} forward "
                  f"and {n_inv} inverse, each equal to its plain version; mean of 20 launches "
                  f"queued behind a spin, the ranks in turn: K9 forward {f_ms:.4f} "
                  f"ms (plain {f_plain:.3f}, bound {fb[0]:.4f} by {fb[1]}), inverse {i_ms:.4f} ms "
                  f"(plain {i_plain:.3f}, bound {ib[0]:.4f} by {ib[1]}) at [{TP_ROWS}, {N_DEG}]; "
                  f"polymul_tp median {res['polymul_tp_ms']:.3f} ms of 5 on {smi}", flush=True)
        launches["tp polymul over 3 gloo ranks"] = {
            c: sum(res["launches"][c] for res in ranks) for c in kernels.LAUNCHES}
        k9_tp = {f"prime {res['prime']} {kind} [{TP_ROWS}, {N_DEG}]": res["k9_ms"][kind][0]
                 for res in ranks for kind in ("fwd", "inv")}

    # (c) batched keys: one key per proof
    rec, _ = protocol_recorder()
    errs = {}
    single = commit_mod.keygen(gen, params, N_DEG)
    for proto, k in BATCHED_KEYS.items():
        mod = mods[proto]
        ckb = commit_mod.keygen(gen, params, N_DEG, batch_shape=(k,))
        if ckb.a1_dig is not None:
            fail("[10] a batched key holds digit operators")
        args = {"open": lambda: (centered((k, params.l, N_DEG)),),
                "linear": lambda: (centered((k, N_DEG)), centered((k, params.l, N_DEG))),
                "sum": lambda: (centered((k, k, N_DEG)), centered((k, k, params.l, N_DEG)))
                }[proto]()
        label = f"{proto} with {k} keys"
        with rec:
            ok, op_ok = counted(label, lambda: mod.roundtrip(gen, ckb, *args, params),
                                ("K1", "K2", "K4", "K5"), ("K3", "K6"))
        for kk, e in rec.check(f"[10] {label}", chunk=B_SUM).items():
            errs[kk] = max(errs.get(kk, 0), e)
        if not (bool(ok.all()) and bool(op_ok.all())):
            fail(f"[10] {label}: {int((~ok).sum())} proofs, {int((~op_ok).sum())} openings rejected")
        rctx, pcom = mod.prover_commit(gen, ckb, *args, params)
        vctx, chal = mod.generate_challenge(gen, pcom, params)
        probes = verdicts(proto, mod.verify, ckb, mod.create_response(rctx, chal, params), vctx,
                          params)
        if not bool(probes.pop("ok").all()) or any(bool(v.any()) for v in probes.values()):
            fail(f"[10] {label}: an honest proof rejected or a probe verified")
        del rctx, pcom, vctx, chal, probes
        ms = sorted(cuda_call_ms(lambda: mod.roundtrip(gen, ckb, *args, params), calls=5))[2]
        ms1 = sorted(cuda_call_ms(lambda: mod.roundtrip(gen, single, *args, params), calls=5))[2]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        mod.roundtrip(gen, ckb, *args, params)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - before
        shape = f"B={k}" + (f" VL={k}" if proto == "sum" else "")
        print(f"[10] {label} ({shape}, NTT-path key matvecs): every proof and opening verifies, "
              f"the forged and norm-violating probes reject; median {ms:.3f} ms of 5, {k / ms * 1e3:.1f} verified proofs/s, against "
              f"one key (K3) on the same inputs {ms1:.3f} ms ({ms / ms1:.2f}x); peak "
              f"{peak / 2**30:.3f} GiB above the {before / 2**30:.3f} GiB held; launches "
              f"{launches[label]} on {smi}", flush=True)
        del ok, op_ok, args, ckb
    print(f"[10] batched keys: kernels held against their plain versions at every shape "
          f"they launched at, largest errors {errs}", flush=True)
    return launches, k9_tp


def _leaves(obj) -> list:
    """The tensors of (nested tuples of) messages, in field order."""
    if isinstance(obj, tuple):
        return [t for f in obj for t in _leaves(f)]
    return [] if obj is None else [obj]


def _gloo_sp(rank: int, world: int, seed: int, dev: torch.device) -> dict:
    """open at N_SP on each (dp, sp) grid of SP_GLOO with ``world`` ranks,
    over this gloo group on the card: the key and the global x made alike
    on every rank from ``seed``. Per grid: the verdicts, all_ok and the
    launches of one call, and each of its K4 and K9 launches against the
    plain version (name and shape, equal, max abs err); this rank's lanes of the first proofs' messages;
    open's z one off, and over the norm bound, on the last sp rank's lanes
    only (verdicts and all_ok); the call's host ms (median of 3) and the
    exchanges' share of one more call, each exchange timed between two
    synchronizations."""
    import torch.distributed as dist

    from ringzk_tpu_torch import Params
    from ringzk_tpu_torch.ops import kernels, sampling
    from ringzk_tpu_torch.ops.ntt import ring_override
    from ringzk_tpu_torch.parallel import mesh as mesh_mod
    from ringzk_tpu_torch.parallel import ntt_sp, protocol_sp
    from ringzk_tpu_torch.parallel.ring_sp import sp_ring
    from ringzk_tpu_torch.protocols import commit as commit_mod
    from ringzk_tpu_torch.protocols import open as open_mod

    refused = _gloo_collectives(rank, world, dev)
    if refused:
        return {"refused": refused}
    params = Params()
    ck = commit_mod.keygen(torch.Generator(device=dev).manual_seed(seed), params, N_SP)
    x = sampling.uniform_centered(torch.Generator(device=dev).manual_seed(seed + 1),
                                  (B_SP_GLOO, params.l), N_SP, params.q, dev)
    grid = mesh_mod.Mesh(None, rank, world, dev)
    rec, out = sp_recorder(), {}
    for dp, sp in SP_GLOO:
        if dp * sp != world:
            continue
        mesh = protocol_sp.make_sp_mesh(dp, sp, device=dev)

        def new_gen():
            return torch.Generator(device=dev).manual_seed(seed + 2)

        def call(mesh=mesh):
            return protocol_sp.open_roundtrip_sp(mesh, new_gen(), ck, x, params)

        torch.cuda.synchronize()
        kernels.reset_launches()
        with rec:
            ok, all_ok = call()
        torch.cuda.synchronize()
        res = {"ok": ok.cpu().tolist(), "all_ok": bool(all_ok), "launches": dict(kernels.LAUNCHES)}
        res["checked"] = [(f"{name} at {shape}", torch.equal(kern, want),
                           int((kern.to(torch.int64) - want.to(torch.int64)).abs().max()))
                          for name, shape, kern, want in rec.results(B_SP_GLOO)]
        log = []
        protocol_sp._step_fn(mesh, recording_roundtrip(open_mod, params, log), ck, params)(
            new_gen(), x)
        res["msgs"] = [t.cpu().numpy() for t in _leaves(log[0])]
        ring = sp_ring(mesh, N_SP, params.modulus)
        ck_l = protocol_sp.lane_split_key(ring, ck)
        gen_r = commit_mod.chain_generators(new_gen(), dp)[mesh.dp_rank]
        with ring_override(ring):
            rctx, pcom = open_mod.prover_commit(gen_r, ck_l, ring.lanes(mesh.batch_block(x)),
                                                params)
            vctx, chal = open_mod.generate_challenge(gen_r, pcom, params)
            resp = open_mod.create_response(rctx, chal, params)
            for name, value in (("forged", None), ("norm", params.verify_bound(N_SP) + 1)):
                z = resp.z.clone()
                if mesh.sp_rank == sp - 1:
                    z[0, 0, 5] = z[0, 0, 5] + 1 if value is None else value
                ok_t = open_mod.verify(ck_l, resp._replace(z=z), vctx, params)
                res[name] = (ok_t.cpu().tolist(), bool(mesh_mod.all_verified(grid, ok_t)))
        del rctx, pcom, vctx, chal, resp
        dist.barrier()
        host_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        spent, exchange = [], ntt_sp._exchange

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = exchange(*args)
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - t0)
            return got

        ntt_sp._exchange = timed
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        finally:
            ntt_sp._exchange = exchange
        res.update(ms=sorted(host_ms)[1], traced_ms=traced_ms, exchanges=len(spent),
                   exchange_ms=sum(spent) * 1e3)
        out[f"dp {dp} x sp {sp}"] = res
    return out


def sp_phase(dev: torch.device, smi: str) -> tuple:
    """Phase [11]: the sp axis at N_SP on the card. (a) a one-rank NCCL
    group, sp = 1: open, linear and sum through ``protocol_sp`` at B_SP,
    each launching K9 and K4 and none of K1-K3, K5, K6, each of their
    launches held against its plain version at its shape (``sp_recorder``),
    its verdicts equal to the unsharded round trip's on the same generator
    and the first MSG_ROWS proofs' RZK1 messages equal, both timed and
    profiled; (b) gloo groups of 2 and 4 ranks on the card: open at
    B_SP_GLOO on each grid of SP_GLOO, each rank's K4 and K9 launches held
    against their plain versions, every rank's lanes of the messages equal
    to the one-process round trip's, a forged and an over-bound z on one
    rank's lanes rejected on every rank, the call timed with the
    exchanges' share; (c) K9 with each
    rank's table at [K9_SP_ROWS, N_loc] for N_loc = 4096 and 2048, held
    against the plain ``_local_stage`` network and against K9's plain
    version on the same table, timed beside both and its bound. Returns the
    launch counts of each path it drove, K9's ms at the sp shapes, the
    largest error of K4 and K9 against their plain versions, and the
    profiled calls of open's pair with their phase ranges ([12])."""
    import tempfile

    import torch.distributed as dist

    from ringzk_tpu_torch import Params
    from ringzk_tpu_torch.ops import kernels, sampling
    from ringzk_tpu_torch.ops.ntt import get_ring
    from ringzk_tpu_torch.parallel import multihost, ntt_sp, protocol_sp
    from ringzk_tpu_torch.protocols import commit as commit_mod
    from ringzk_tpu_torch.protocols import linear
    from ringzk_tpu_torch.protocols import open as open_mod
    from ringzk_tpu_torch.protocols import sum as sum_mod
    from ringzk_tpu_torch.utils import serial

    mods = {"open": open_mod, "linear": linear, "sum": sum_mod}
    entry = {"open": protocol_sp.open_roundtrip_sp, "linear": protocol_sp.linear_roundtrip_sp,
             "sum": protocol_sp.sum_roundtrip_sp}
    params = Params()
    launches = {}
    gen = torch.Generator(device=dev).manual_seed(60)
    sp_kernels, off_path = ("K4", "K9"), ("K1", "K2", "K3", "K5", "K6")
    rec, errs = sp_recorder(), {}
    profiled = {}   # the open pair's profiled calls, for phase [12]

    def centered(shape):
        return sampling.uniform_centered(gen, shape[:-1], shape[-1], params.q, dev)

    # (a) sp = 1 over a one-rank NCCL group, against the unsharded round trip
    rdzv = tempfile.mkdtemp()
    if multihost.init_distributed(f"file://{rdzv}/rendezvous", 1, 0) != (0, 1):
        fail("[11] init_distributed did not give a one-rank group")
    try:
        if dist.get_backend() != "nccl":
            fail(f"[11] the group is {dist.get_backend()}, not NCCL")
        mesh = protocol_sp.make_sp_mesh(1, 1)
        ck = commit_mod.keygen(gen, params, N_SP)
        data = {"open": (centered((B_SP["open"], params.l, N_SP)),),
                "linear": (centered((B_SP["linear"], N_SP)),
                           centered((B_SP["linear"], params.l, N_SP))),
                "sum": (centered((B_SP["sum"], VL, N_SP)),
                        centered((B_SP["sum"], VL, params.l, N_SP)))}
        for proto, mod in mods.items():
            args, batch = data[proto], data[proto][0].shape[0]
            label = f"sp {proto} N={N_SP} over one NCCL rank"

            def new_gen():
                return torch.Generator(device=dev).manual_seed(61)

            def sp_call(proto=proto, args=args):
                return entry[proto](mesh, new_gen(), ck, *args, params)

            def one_call(mod=mod, args=args):
                return mod.roundtrip(commit_mod.chain_generators(new_gen(), 1)[0], ck, *args,
                                     params)

            torch.cuda.synchronize()
            kernels.reset_launches()
            with rec:
                ok, all_ok = sp_call()
            torch.cuda.synchronize()
            launches[label] = dict(kernels.LAUNCHES)
            for k, e in rec.check(f"[11] {label}", chunk=B_SP["sum"]).items():
                errs[k[:2]] = max(errs.get(k[:2], 0), e)
            for k in sp_kernels:
                if not launched(launches[label], k):
                    fail(f"[11] {label}: kernel {k} was not launched ({launches[label]})")
            for k in off_path:
                if launched(launches[label], k):
                    fail(f"[11] {label}: kernel {k} was launched ({launches[label]})")
            torch.cuda.synchronize()
            kernels.reset_launches()
            want, op_ok = one_call()
            torch.cuda.synchronize()
            one_launches = {k: launched(kernels.LAUNCHES, k) for k in COUNTERS
                            if launched(kernels.LAUNCHES, k)}
            if not (torch.equal(ok, want & op_ok) and bool(ok.all()) and bool(all_ok)):
                fail(f"[11] {label}: {int((~ok).sum())} of {batch} rejected, all_ok "
                     f"{bool(all_ok)}, {int((ok != (want & op_ok)).sum())} verdicts differ from "
                     "the unsharded round trip")
            del ok, want, op_ok
            log_sp, log_1p = [], []
            protocol_sp._step_fn(mesh, recording_roundtrip(mod, params, log_sp), ck, params)(
                new_gen(), *args)
            recording_roundtrip(mod, params, log_1p)(commit_mod.chain_generators(new_gen(), 1)[0],
                                                     ck, *args, params)
            for i, (a, b) in enumerate(zip(log_sp[0], log_1p[0])):
                if serial.dumps(_head(a, MSG_ROWS)) != serial.dumps(_head(b, MSG_ROWS)):
                    fail(f"[11] {label}: message {i} of the first {MSG_ROWS} proofs differs from "
                         "the unsharded round trip's as RZK1 bytes")
            del log_sp, log_1p
            ms_sp = sorted(cuda_call_ms(sp_call, calls=3))[1]
            ms_1p = sorted(cuda_call_ms(one_call, calls=3))[1]
            shape = f"B={batch}" + (f" VL={VL}" if proto == "sum" else "")
            print(f"[11] {label} ({shape}): every verdict equal to the unsharded round trip on the "
                  f"same generator (all true), the first {MSG_ROWS} proofs' messages equal as RZK1 "
                  f"bytes, every K4 and K9 launch equal to its plain version; median of 3: sp path "
                  f"{ms_sp:.3f} ms ({batch / ms_sp * 1e3:.1f} verified "
                  f"proofs/s), unsharded round trip {ms_1p:.3f} ms ({batch / ms_1p * 1e3:.1f}/s, "
                  f"its first run at N={N_SP} on the card, launching {one_launches}); launches "
                  f"{launches[label]} on {smi}",
                  flush=True)
            for name, fn in (("sp path", sp_call), ("unsharded round trip", one_call)):
                prof = device_split(fn, ranges=proto == "open")
                wall_ms, split = prof.wall_ms, prof.split
                if proto == "open":
                    profiled[name] = prof
                if not split:
                    print(f"  {label} {name} profiled: the profiler recorded no device time; "
                          "device split not measured", flush=True)
                    continue
                dev_ms = sum(split.values())
                print(f"  {label} {name} profiled: device time {dev_ms:.3f} ms against a host "
                      f"wall of {wall_ms:.3f} ms (idle share {max(0.0, 1 - dev_ms / wall_ms):.2%}); "
                      + ", ".join(f"{k} {v:.3f} ms ({v / dev_ms:.1%})"
                                  for k, v in split.items() if v)
                      + f" on {smi}", flush=True)
        del data, ck
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # (b) gloo groups of two and four ranks on the one card
    for world in sorted({dp * sp for dp, sp in SP_GLOO}):
        ranks = spawn_gloo("sp", world, seed=70, phase="[11]")
        refused = [r["refused"] for r in ranks if "refused" in r]
        if refused:
            fail(f"[11] gloo refused CUDA tensors over {world} ranks: {refused[0]}")
        ck = commit_mod.keygen(torch.Generator(device=dev).manual_seed(70), params, N_SP)
        x = sampling.uniform_centered(torch.Generator(device=dev).manual_seed(71),
                                      (B_SP_GLOO, params.l), N_SP, params.q, dev)
        for dp, sp in SP_GLOO:
            if dp * sp != world:
                continue
            grid = f"dp {dp} x sp {sp}"
            n_loc, b_loc = N_SP // sp, B_SP_GLOO // dp
            ref = []
            for d, gen_d in enumerate(commit_mod.chain_generators(
                    torch.Generator(device=dev).manual_seed(72), dp)):
                log = []
                recording_roundtrip(open_mod, params, log)(gen_d, ck, x[d * b_loc:(d + 1) * b_loc],
                                                           params)
                ref.append(_leaves(log[0]))
            for r, res in enumerate(r[grid] for r in ranks):
                d, s = divmod(r, sp)
                for i, (want, got) in enumerate(zip(ref[d], res["msgs"])):
                    if not np.array_equal(want[..., s * n_loc:(s + 1) * n_loc].cpu().numpy(), got):
                        fail(f"[11] gloo {grid} rank {r}: its lanes of message leaf {i} differ "
                             "from the one-process round trip's")
                if not (all(res["ok"]) and res["all_ok"]):
                    fail(f"[11] gloo {grid} rank {r}: an honest proof rejected ({res['ok']})")
                for probe in ("forged", "norm"):
                    ok_t, all_t = res[probe]
                    if ok_t[0] or not all(ok_t[1:]) or all_t:
                        fail(f"[11] gloo {grid} rank {r}: {probe} z on sp rank {sp - 1}'s lanes "
                             f"gave {ok_t}, all_ok {all_t}")
                for k in sp_kernels:
                    if not launched(res["launches"], k):
                        fail(f"[11] gloo {grid} rank {r}: kernel {k} was not launched")
                for name, equal, err in res["checked"]:
                    if not equal:
                        fail(f"[11] gloo {grid} rank {r}: {name} differs from its plain version "
                             f"(max abs err {err})")
                    errs[name[:2]] = max(errs.get(name[:2], 0), err)
                if {name[:2] for name, *_ in res["checked"]} != set(sp_kernels):
                    fail(f"[11] gloo {grid} rank {r}: the recorded launches "
                         f"{[c[0] for c in res['checked']]} miss a kernel of the path")
                for k in off_path:
                    if launched(res["launches"], k):
                        fail(f"[11] gloo {grid} rank {r}: kernel {k} was launched")
            label = f"sp open N={N_SP} {grid} over {world} gloo ranks"
            launches[label] = {c: sum(r[grid]["launches"][c] for r in ranks)
                               for c in kernels.LAUNCHES}
            per_rank = [r[grid] for r in ranks]
            print(f"[11] gloo {grid} on the one card, open N={N_SP} B={B_SP_GLOO}: every rank's "
                  f"lanes of the messages equal the one-process round trip's (generator d of "
                  f"chain_generators(gen, {dp}) for dp row d), all verdicts true; z one off and z "
                  f"over the norm bound on sp rank {sp - 1}'s lanes reject the first proof of "
                  f"each dp row and give all_ok false on every rank; per rank: call median of 3 "
                  + ", ".join(f"{r['ms']:.2f}" for r in per_rank)
                  + " ms (host clock), exchanges "
                  + ", ".join(f"{r['exchanges']} taking {r['exchange_ms']:.2f} of "
                              f"{r['traced_ms']:.2f} ms ({r['exchange_ms'] / r['traced_ms']:.1%})"
                              for r in per_rank)
                  + f"; launches per rank {per_rank[0]['launches']}, each rank's K4 and K9 "
                  f"launches at {sorted({c[0] for r in per_rank for c in r['checked']})} equal to "
                  f"their plain versions, on {smi}", flush=True)
        del ck, x

    # (c) K9 with each rank's table at the sp shapes
    ring = get_ring(N_SP, params.modulus)
    k9_sp = {}
    for sp in (2, 4):
        n_loc = N_SP // sp
        for dev_r in range(sp):
            for i, p in enumerate(ring.primes):
                rows = K9_SP_ROWS if (dev_r, i) == (0, 0) else 1024
                x = torch.randint(0, p, (rows, n_loc), generator=gen, device=dev,
                                  dtype=torch.int64).to(torch.int32)
                for kind, kern, plain_net, plain_tab in (
                        ("fwd", ntt_sp.fwd_local, ntt_sp.fwd_local_plain, ntt_sp.fwd_table_plain),
                        ("inv", ntt_sp.inv_local, ntt_sp.inv_local_plain,
                         ntt_sp.inv_table_plain)):
                    got = kern(ring, i, sp, dev_r, x)
                    name = f"K9 {kind} sp={sp} rank {dev_r} prime {i} [{rows}, {n_loc}]"
                    errs["K9"] = max(errs.get("K9", 0),
                                     compare(f"{name} vs the _local_stage network", got,
                                             plain_net(ring, i, sp, dev_r, x)),
                                     compare(f"{name} vs K9's plain version on the rank's table",
                                             got, plain_tab(ring, i, sp, dev_r, x)))
                    if rows == K9_SP_ROWS:
                        ms = cuda_ms(lambda: kern(ring, i, sp, dev_r, x), reps=20)
                        net_ms = cuda_ms(lambda: plain_net(ring, i, sp, dev_r, x), reps=2)
                        tab_ms = cuda_ms(lambda: plain_tab(ring, i, sp, dev_r, x), reps=2)
                        bms, by = k9_bound(rows, n_loc, kind == "inv")
                        k9_sp[f"{kind} [{rows}, {n_loc}]"] = ms
                        print(f"[11] K9 {kind} with rank {dev_r}'s table at [{rows}, {n_loc}] "
                              f"(N={N_SP} over sp={sp}): {ms:.4f} ms, the _local_stage network "
                              f"{net_ms:.3f} ms, K9's plain version {tab_ms:.3f} ms, bound "
                              f"{bms:.4f} ms by {by} on {smi}", flush=True)
                del x
    for lb, counts in launches.items():
        print(f"[11] K9 launches, {lb}: {launched(counts, 'K9')} (forward "
              f"{counts['ntt_fwd_one']}, inverse {counts['ntt_inv_one']}), K4 "
              f"{launched(counts, 'K4')}", flush=True)
    return launches, k9_sp, errs, profiled


def _compact_leaves(obj) -> dict:
    """{path: host array} of the leaves of a message that RZK1 writes in
    the compact row encoding (int32, one axis or more)."""
    from ringzk_tpu_torch.utils import serial

    return {path: a for path, a in serial._flatten_with_paths(obj)
            if a is not None and a.dtype == np.int32 and a.ndim >= 1}


def _answer(decode, payload: bytes):
    """A decoder's answer on a payload read as shape (1, 4): the array, or
    the message of its ValueError."""
    try:
        return decode(payload, (1, 4)).tolist()
    except ValueError as err:
        return f"ValueError: {err}"


def last_modules(dev: torch.device, smi: str, open_ms: float, profiled: dict,
                 sp_profiled: dict) -> None:
    """Phase [12]: the modules of the last slice, each step fatal on
    failure. (a) the native RZK1 row codec on the card's host: open's
    response z and response context at B_OPEN round-tripped exactly through
    ``dumps``/``loads``/``rebuild`` (the threaded encoder), the native bytes
    and arrays equal to the plain numpy codec's at B_WIRE, host ms of both,
    and each malformed payload of MALFORMED rejected alike by both
    decoders; (b) ``benchtime.timed_row`` of open's round trip at B_OPEN
    beside [7]'s CUDA-event median (``open_ms``), with the windows' spread,
    the fetch-forced cross-check and ``engine_fingerprint()``; (c) the
    phase and op ranges: the device ms under each range of the profiled
    round trips of [7] (open, linear and sum at N=512, each of which must
    record its six phases and its round-trip range, commit_scheme/commit
    inside its proof's commit, and every other range as ``<parent>/<op>``
    under that parent, each phase holding by its nested ranges what the
    ranges named under it hold) and of [11] (open at N=8192 unsharded and through
    ``protocol_sp`` at one NCCL rank, side by side), and of one keygen; (d)
    both examples of ``examples_torch`` as subprocesses on the card."""
    from ringzk_tpu_torch import Params, runtime
    from ringzk_tpu_torch.ops import sampling
    from ringzk_tpu_torch.protocols import commit as commit_mod
    from ringzk_tpu_torch.protocols import open as open_mod
    from ringzk_tpu_torch.utils import benchtime, profiling, serial

    params = Params()
    gen = torch.Generator(device=dev).manual_seed(120)

    # (a) the native codec
    t0 = time.perf_counter()
    lib_path = runtime.build()
    runtime.lib()
    print(f"[12] native RZK1 codec: {lib_path.name} built or found by {runtime.compiler()} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ck = commit_mod.keygen(gen, params, N_DEG)
    x = sampling.uniform_centered(gen, (B_OPEN, params.l), N_DEG, params.q, dev)
    rctx, pcom = open_mod.prover_commit(gen, ck, x, params)
    resp = open_mod.create_response(rctx, open_mod.generate_challenge(gen, pcom, params)[1],
                                    params)
    torch.cuda.synchronize()
    for obj in (resp, rctx):
        leaves = _compact_leaves(obj)
        rows = sum(a.size // a.shape[-1] for a in leaves.values())
        t0 = time.perf_counter()
        blob = serial.dumps(obj)
        enc_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back = serial.rebuild(type(obj), serial.loads(blob), device=dev)
        dec_ms = (time.perf_counter() - t0) * 1e3
        if not _same(back, obj):
            fail(f"[12] {type(obj).__name__} at B={B_OPEN}: the native RZK1 round trip is not "
                 "exact")
        print(f"[12] {type(obj).__name__} at B={B_OPEN} ({rows} compact rows of {N_DEG}, threads "
              f"from {serial._MT_ROWS} rows): dumps {enc_ms:.1f} ms, loads + rebuild "
              f"{dec_ms:.1f} ms (host clock, device copies included), {len(blob)} bytes "
              f"({len(blob) / B_OPEN:.1f} a proof), exact", flush=True)
        del blob, back
    codec_ms = {}
    for label, batch in (("native", B_OPEN), ("native", B_WIRE), ("plain", B_WIRE)):
        enc, dec = (serial.encode_rows, serial.decode_rows) if label == "native" else (
            serial._encode_rows_numpy, serial._decode_rows_numpy)
        arrays = {f"{type(o).__name__}.{p}": a for o in (resp, rctx)
                  for p, a in _compact_leaves(_head(o, batch)).items()}
        t0 = time.perf_counter()
        blobs = {k: enc(a) for k, a in arrays.items()}
        t1 = time.perf_counter()
        outs = {k: dec(blobs[k], a.shape) for k, a in arrays.items()}
        t2 = time.perf_counter()
        if any(not np.array_equal(outs[k], a) for k, a in arrays.items()):
            fail(f"[12] the {label} codec at B={batch} does not decode what it encoded")
        codec_ms[label, batch] = ((t1 - t0) * 1e3, (t2 - t1) * 1e3, blobs)
        rows = sum(a.size // a.shape[-1] for a in arrays.values())
        print(f"[12] {label} row codec at B={batch}, {rows} rows of {N_DEG} (z, x, r, y): encode "
              f"{codec_ms[label, batch][0]:.1f} ms, decode {codec_ms[label, batch][1]:.1f} ms "
              f"(host clock, {os.cpu_count()} cores)", flush=True)
    if codec_ms["native", B_WIRE][2] != codec_ms["plain", B_WIRE][2]:
        fail(f"[12] the native codec's bytes differ from the plain codec's at B={B_WIRE}")
    (ne, nd, _), (pe, pd, _) = codec_ms["native", B_WIRE], codec_ms["plain", B_WIRE]
    print(f"[12] at B={B_WIRE} the native bytes equal the plain codec's; native against plain: "
          f"encode {ne:.1f} against {pe:.1f} ms ({pe / ne:.1f}x), decode {nd:.1f} against "
          f"{pd:.1f} ms ({pd / nd:.1f}x)", flush=True)
    del codec_ms, rctx, pcom, resp
    for name, payload in MALFORMED:
        native, plain = _answer(serial.decode_rows, payload), _answer(serial._decode_rows_numpy,
                                                                      payload)
        if native != plain:
            fail(f"[12] malformed payload '{name}' ({payload.hex(' ')}): native {native}, "
                 f"plain {plain}")
        print(f"[12] malformed payload '{name}' ({payload.hex(' ')}) as (1, 4): native and plain "
              f"decoders both give {native}", flush=True)
    if any(_answer(serial.decode_rows, pl) != "ValueError: corrupt varint"
           for _, pl in MALFORMED[:2]):
        fail("[12] the native decoder accepts a varint past 32 bits")

    # (b) benchtime's median of windows beside [7]'s CUDA-event median
    def rt_call():
        return open_mod.roundtrip(gen, ck, x, params)

    dt, dts = benchtime.timed_row(rt_call, (), iters=2, windows=5, warmup=3)
    rec = benchtime.windows_record(B_OPEN, dt, dts)
    benchtime.fetch_forced_pass([(rec, rt_call, (), B_OPEN)], iters=2)
    print(f"[12] benchtime.timed_row of the open round trip N={N_DEG} B={B_OPEN} (5 windows of 2 "
          f"calls, host clock to a synchronize): median {dt * 1e3:.3f} ms, windows "
          + ", ".join(f"{t * 1e3:.3f}" for t in dts)
          + f" ms; [7]'s CUDA-event median {open_ms:.3f} ms; ratio {dt * 1e3 / open_ms:.4f}; "
          f"record {rec}; engine {benchtime.engine_fingerprint()} on {smi}", flush=True)
    del x

    # (d) the examples, each in its own interpreter, run beside (c)
    examples = {name: subprocess.Popen([sys.executable, str(REPO / "examples_torch" / name)],
                                       cwd=REPO, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
                for name in ("custom_modulus.py", "two_party.py")}
    t_ex = time.perf_counter()

    # (c) the phase and op ranges
    for proto in ("open", "linear", "sum"):
        prof = profiled[proto]
        trip = f"{proto}_proof/roundtrip"
        phases = {f"{proto}_proof/{p}" for p in ("commit", "generate_challenge",
                                                  "create_response", "verify")}
        phases |= {"commit_scheme/commit", "commit_scheme/verify"}
        if not phases | {trip} <= set(prof.parents):
            fail(f"[12] the {proto} round trip recorded the ranges {sorted(prof.parents)}, "
                 f"without {sorted(phases | {trip} - set(prof.parents))}")
        if prof.parents["commit_scheme/commit"] != f"{proto}_proof/commit":
            fail(f"[12] the {proto} round trip ran commit_scheme/commit inside "
                 f"{prof.parents['commit_scheme/commit']}, not {proto}_proof/commit")
        # every other range is an op under the range it ran in, and named by it
        strays = {name: up for name, up in prof.parents.items() if name not in phases | {trip}
                  and (name.rpartition("/")[2] not in profiling.OPS
                       or name.rpartition("/")[0] != up)}
        if strays:
            fail(f"[12] the {proto} round trip recorded ranges that are not "
                 f"<parent>/<op in profiling.OPS> under that parent: {strays}")
        if not set(prof.ranges) <= set(prof.parents):
            fail(f"[12] the {proto} round trip's device work fell under the ranges "
                 f"{sorted(set(prof.ranges) - set(prof.parents))}, which the host never "
                 "recorded")
        # the tree of parents and the names agree: a phase holds its own work and
        # that of the ranges named under it (open's commit also commit_scheme/commit)
        for name in phases:
            by_name = sum(ms for r, ms in prof.ranges.items()
                          if r == name or r.startswith(name + "/"))
            if name == f"{proto}_proof/commit":
                by_name += nested_ms(prof, "commit_scheme/commit")
            if abs(nested_ms(prof, name) - by_name) > 1e-9 * max(1.0, by_name):
                fail(f"[12] the {proto} round trip's {name} holds {nested_ms(prof, name):.6f} "
                     f"device ms by its nested ranges but {by_name:.6f} by their names")
        if abs(nested_ms(prof, trip) - sum(prof.ranges.values())) > 1e-9 * max(
                1.0, sum(prof.ranges.values())):
            fail(f"[12] the {proto} round trip's ranged device work is not all under {trip}")
        if not nested_ms(prof, f"{proto}_proof/verify") > 0:
            fail(f"[12] the {proto} round trip's verify held no device work")
        range_report(f"[12] {proto} N={N_DEG} round trip of [7]", prof, smi)
    kprof = device_split(lambda: commit_mod.keygen(gen, params, N_DEG), ranges=True)
    if not nested_ms(kprof, "commit_scheme/keygen") > 0:
        fail(f"[12] keygen recorded the ranges {kprof.parents} on the device {kprof.ranges}")
    range_report(f"[12] keygen N={N_DEG}", kprof, smi)
    sp_rows = {name: range_report(f"[12] open N={N_SP} B={B_SP['open']} {name} of [11]", prof,
                                  smi) for name, prof in sp_profiled.items()}
    sp, one = sp_rows.get("sp path", {}), sp_rows.get("unsharded round trip", {})
    if sp and one:
        print(f"[12] open N={N_SP}, sp path at one NCCL rank against the unsharded round trip, "
              "device ms by range with nested ranges: "
              + ", ".join(f"{name} {sp[name][1]:.3f} / {one[name][1]:.3f}"
                          + (f" ({sp[name][1] / one[name][1]:.2f}x)" if one[name][1] else "")
                          for name in one if name in sp)
              + f" on {smi}", flush=True)

    # (d) the examples' verdicts
    for name, proc in examples.items():
        try:
            out, _ = proc.communicate(timeout=max(1.0, 300 - (time.perf_counter() - t_ex)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"[12] examples_torch/{name} did not end within 300 s")
        if proc.returncode != 0:
            fail(f"[12] examples_torch/{name} exited {proc.returncode}:\n{out}")
        for line in out.splitlines():
            print(f"[12] examples_torch/{name}: {line}", flush=True)
    print(f"[12] both examples ran on the card and exited 0 in "
          f"{time.perf_counter() - t_ex:.1f} s", flush=True)


def ring_algebra(dev: torch.device, smi: str) -> tuple:
    """Phase [13]: the reference's Mat algebra, the norm family and
    KeyOperator on the card, at the protocols' widths ((a)-(f) of the
    module docstring). Each call runs from launch counts set to 0, its
    launches added to [13]'s counts, and every kernel launch of it is held
    against the plain version at its shape afterwards (launches the
    comparison makes are not counted). Returns ([13]'s launch counts, the
    largest error per kernel)."""
    from ringzk_tpu_torch import Params
    from ringzk_tpu_torch.ops import conv_mxu, kernels, mat, norms, sampling
    from ringzk_tpu_torch.ops.ntt import get_ring
    from ringzk_tpu_torch.protocols import commit as commit_mod
    from ringzk_tpu_torch.protocols import linear
    from ringzk_tpu_torch.protocols import open as open_mod

    rec, names = protocol_recorder()
    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    errs = {}

    def algebra(label: str, fn, must: tuple):
        """fn() from launch counts set to 0, its launches recorded and added
        to [13]'s counts; fails unless each kernel of ``must`` launched."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        with rec:
            out = fn()
        torch.cuda.synchronize()
        for k, v in kernels.LAUNCHES.items():
            counts[k] += v
        got = {k: launched(kernels.LAUNCHES, k) for k in COUNTERS
               if launched(kernels.LAUNCHES, k)}
        for k in must:
            if not got.get(k):
                fail(f"[13] {label}: kernel {k} was not launched ({got})")
        print(f"[13] launches in {label}: {got}", flush=True)
        for k, e in rec.check(f"[13] {label}", chunk=B_SUM).items():
            errs[k] = max(errs.get(k, 0), e)
        return out

    def same(label: str, got: torch.Tensor, want: torch.Tensor) -> None:
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            fail(f"[13] {label}: {got.dtype} {tuple(got.shape)} differs from {want.dtype} "
                 f"{tuple(want.shape)}")

    def times(label: str, calls: dict) -> None:
        ms = {name: cuda_ms(fn, reps=3) for name, fn in calls.items()}
        print(f"[13] {label}: " + ", ".join(f"{name} {t:.3f} ms" for name, t in ms.items())
              + f" (cuda_ms, mean of 3 after a warm-up) on {smi}", flush=True)

    def dot_ar(ring, a, r):
        """[a1; a2] . r through mat.dot, B_DOT_CHUNK proofs at a time."""
        return torch.cat([mat.one_d_mat_to_vec(mat.dot(ring, a, mat.from_vec(c)))
                          for c in r.split(B_DOT_CHUNK)])

    params = Params()
    gen = torch.Generator(device=dev).manual_seed(130)
    rings = {params.modulus: (params, B_OPEN)}
    rings.update({q: (Params(q=q // 2, modulus=q), b) for q, b in B_ALG_WIDE.items()})

    # (a) and (c): mat.dot against the commitment's A.r, on each ring
    for q, (qp, b) in rings.items():
        ring = get_ring(N_DEG, q)
        ck = commit_mod.keygen(gen, qp, N_DEG)
        r = sampling.uniform_centered(gen, (b, qp.k), N_DEG, qp.b, dev)
        a = mat.extend_rows(ck.a1, ck.a2)
        ar = commit_mod.matvec_key(ring, ck, "a", r, qp.b)
        must = ("K7", "K8") if ring.wide else ("K1", "K2")
        label = f"mat.dot [a1; a2] . r q={q} N={N_DEG} B={b}"
        same(label, algebra(label, lambda: dot_ar(ring, a, r), must), ar)
        times(f"{label}, equal to commit's A.r ({'K7/K8' if ring.wide else 'K3'})",
              {"mat.dot": lambda: dot_ar(ring, a, r),
               "commit's matvec_key": lambda: commit_mod.matvec_key(ring, ck, "a", r, qp.b)})
        del r, a, ar
        if q == Q63:
            continue
        # (b) and (c): componentwise_mul against linear's own g.x
        bl = B_LINEAR if q == params.modulus else b
        g = sampling.uniform_centered(gen, (bl,), N_DEG, qp.q, dev)
        x = sampling.uniform_centered(gen, (bl, qp.l), N_DEG, qp.q, dev)
        rctx, _ = linear.prover_commit(gen, ck, g, x, qp)
        label = f"mat.componentwise_mul x . g q={q} N={N_DEG} B={bl}"
        same(label, algebra(label, lambda: mat.componentwise_mul(ring, x, g), must),
             rctx.opening_p.x)
        times(f"{label}, equal to linear's g.x",
              {"componentwise_mul": lambda: mat.componentwise_mul(ring, x, g),
               "linear's route": lambda: ring.inv(mat.scalar_mul_hat(
                   ring, ring.fwd_const(g), ring.fwd(x)))})
        del g, x, rctx
        if q != params.modulus:
            continue
        # (d) KeyOperator at N=512 and N=1024 against the key's own matvec
        for n, kck in ((N_DEG, ck), (1024, commit_mod.keygen(gen, params, 1024))):
            kring = get_ring(n, q)
            op = conv_mxu.KeyOperator(kck.a1, kring)
            built = conv_mxu.build_operator_digits_device(kck.a1, kring)
            stored = op.w_digits if kck.a1_dig.dim() == 2 else conv_mxu.to_blocked_layout(
                op.w_digits)
            if not (torch.equal(op.w_digits, built) and torch.equal(kck.a1_dig, stored)):
                fail(f"[13] KeyOperator N={n}: w_digits differs from "
                     "build_operator_digits_device or from the key's operator")
            r = sampling.uniform_centered(gen, (B_OPEN, params.k), n, params.b, dev)
            label = f"KeyOperator.matvec N={n} B={B_OPEN} v_digits=1"
            want = commit_mod.matvec_key(kring, kck, "a1", r, params.b)
            same(label, algebra(label, lambda: op.matvec(r, 1), ("K3",)), want)
            times(f"{label} (K3, [kN, 4 rowsN] operator {list(op.w_digits.shape)}), equal to "
                  f"the key's matvec ({'K3' if kck.a1_dig.dim() == 2 else 'K6, blocked'})",
                  {"KeyOperator.matvec": lambda: op.matvec(r, 1),
                   "the key's matvec": lambda: commit_mod.matvec_key(kring, kck, "a1", r,
                                                                     params.b)})
            del op, built, stored, r, want
        # (e) equal_mod_q_hat on open's verify equation, (f) the norm family
        x = sampling.uniform_centered(gen, (B_OPEN, params.l), N_DEG, params.q, dev)
        rctx, pcom = open_mod.prover_commit(gen, ck, x, params)
        vctx, chal = open_mod.generate_challenge(gen, pcom, params)
        resp = open_mod.create_response(rctx, chal, params)
        if not bool(open_mod.verify(ck, resp, vctx, params).all()):
            fail("[13] open's honest proofs do not verify")

        def equation(z):
            """a1.z == t + d.c1, both sides left in the NTT domain."""
            lhs = mat.matvec_hat(ring, ck.a1_hat, ring.fwd(z))
            rhs = ring.add_hat(ring.fwd(vctx.t), mat.scalar_mul_hat(
                ring, ring.fwd_const(vctx.d), ring.fwd(vctx.c1)))
            return mat.equal_mod_q_hat(ring, lhs, rhs)

        probes = {"honest": resp, **tampered("open", resp, params.verify_bound(N_DEG) + 1, False)}
        for name, probe in probes.items():
            label = f"equal_mod_q_hat on open's verify equation, {name} z, B={B_OPEN}"
            eq = algebra(label, lambda: equation(probe.z), ("K1", "K2"))
            if eq.shape != (B_OPEN,) or bool(eq.all()) != (name == "honest") or (
                    name != "honest" and bool(eq.any())):
                fail(f"[13] {label}: {int(eq.sum())} of {tuple(eq.shape)} equal")
        times(f"open's verify equation at B={B_OPEN} in the NTT domain (equal_mod_q_hat) against "
              "open.verify", {"equal_mod_q_hat": lambda: equation(resp.z),
                              "open.verify": lambda: open_mod.verify(ck, resp, vctx, params)})
        z, zc = resp.z, resp.z.cpu()
        for fn in (norms.norm2_squared, norms.norm1, norms.norm_inf):
            got = algebra(f"{fn.__name__} of open's z {list(z.shape)}", lambda: fn(z), ())
            got = got if isinstance(got, tuple) else (got,)
            parts = [fn(c) for c in zc.split(NORM_CPU_CHUNK)]
            want = [torch.cat([p[i] if isinstance(p, tuple) else p for p in parts])
                    for i in range(len(got))]
            for i, (g_, w_) in enumerate(zip(got, want)):
                same(f"{fn.__name__} limb {i} on the card against the CPU", g_.cpu(), w_)
        times(f"the norm family of open's z {list(z.shape)}",
              {fn.__name__: lambda fn=fn: fn(z) for fn in (norms.norm2_squared, norms.norm1,
                                                            norms.norm_inf)})
        del x, rctx, pcom, vctx, chal, resp, probes, z, zc
    # (f) full-range int64 rows against Python integers
    w = torch.randint(-2**63, 2**63 - 1, (NORM_ROWS, N_DEG), generator=gen, device=dev,
                      dtype=torch.int64)
    w[0], w[1] = -2**63, 2**63 - 1
    w[2, :4] = torch.tensor([2**63 - 1, -(2**63 - 1), -2**63, 2**40])
    w[3] = 0
    w[3, :4] = torch.tensor([2**33 + 5, -3, 7, -2**40])
    rows = w.cpu().numpy().astype(object)
    exact = {"norm2_squared": (rows * rows).sum(-1), "norm1": np.abs(rows).sum(-1),
             "norm_inf": np.abs(rows).max(-1)}
    for fn in (norms.norm2_squared, norms.norm1, norms.norm_inf):
        value = 0
        for limb in fn(w):
            value = (value << 32) + limb.cpu().numpy().astype(object)
        if not (value == exact[fn.__name__]).all():
            fail(f"[13] {fn.__name__} of full-range int64 rows differs from Python integers")
    print(f"[13] norm2_squared, norm1 and norm_inf of {NORM_ROWS} full-range int64 rows of "
          f"{N_DEG} on the card (+-(2^63-1), -2^63, 2^40, [2^33+5, -3, 7, -2^40]) equal Python "
          f"integers: e.g. norm_inf of [2^33+5, -3, 7, -2^40] is {exact['norm_inf'][3]}, and of "
          f"a row of -2^63 {exact['norm_inf'][0]}", flush=True)
    for k in COUNTERS:
        if bool(launched(counts, k)) != (k in ("K1", "K2", "K3", "K7", "K8")):
            fail(f"[13] kernel {k} was launched {launched(counts, k)} times in [13]")
    print(f"[13] ring algebra: K1, K2, K3, K7 and K8 launched and no other kernel "
          f"({ {k: launched(counts, k) for k in COUNTERS if launched(counts, k)} }); every "
          f"launch equal to its plain version, largest errors {errs}", flush=True)
    return counts, errs


def _k14_bound(name: str, args: tuple) -> tuple:
    """(least ms, what bounds it) of one recorded launch, from its arguments."""
    if name in ("K1", "K7"):
        ring, x, num = args
        return (k1_bound if name == "K1" else k7_bound)(x.shape[0], num, ring.n)
    if name in ("K2", "K8"):
        ring, xh = args
        return (k2_bound if name == "K2" else k8_bound)(xh.shape[1], xh.shape[0], ring.n)
    if name in ("K3", "K6"):
        ring, w, rows_n, v, nd = args
        return matvec_bound(v.shape[0], v.shape[1], rows_n, nd)
    if name == "K4":
        return k4_bound(*args[0].shape)
    ring, d, m, t, num = args
    return k5_bound(m.shape[0], m.shape[1], num, ring.n)


def _shape_label(name: str, args: tuple) -> str:
    """A recorded launch's shape: N, prime count and rows (K4: B; K5: B and
    rows; K3/K6: B, kN and digits)."""
    if name in ("K1", "K7"):
        return f"N={args[0].n} num={args[2]} rows={args[1].shape[0]}"
    if name in ("K2", "K8"):
        return f"N={args[0].n} num={args[1].shape[0]} rows={args[1].shape[1]}"
    if name in ("K3", "K6"):
        return f"N={args[2]} B={args[3].shape[0]} kN={args[3].shape[1]} v_digits={args[4]}"
    if name == "K4":
        return f"N={args[0].shape[1]} B={args[0].shape[0]}"
    return f"N={args[0].n} B={args[2].shape[0]} rows={args[2].shape[1]} num={args[4]}"


def configurations(dev: torch.device, smi: str, summary: list) -> tuple:
    """Phase [14]: the configurations no other phase runs ((a)-(c) of the
    module docstring). Returns (the launch counts of each run of (b), the
    largest error per kernel, and {kernel: {shape: [launches in (b), ms,
    plain ms on the checked rows, checked rows, bound ms, bound by]}} of
    every kernel shape [14] launched)."""
    from ringzk_tpu_torch import Params
    from ringzk_tpu_torch.kat_configs import KAT_CONFIGS
    from ringzk_tpu_torch.ops import kernels, sampling
    from ringzk_tpu_torch.ops.kernels import matvec as k_mv
    from ringzk_tpu_torch.ops.kernels import ntt_wide as k_wide
    from ringzk_tpu_torch.ops.ntt import get_ring
    from ringzk_tpu_torch.protocols import api, linear
    from ringzk_tpu_torch.protocols import commit as commit_mod
    from ringzk_tpu_torch.protocols import open as open_mod
    from ringzk_tpu_torch.protocols import sum as sum_mod

    t_phase = time.perf_counter()
    mods = {"open": open_mod, "linear": linear, "sum": sum_mod}
    rec, _ = protocol_recorder()
    rec.targets["K6"] = (k_mv, "matvec_digits_colblock", k_mv.matvec_digits_colblock_plain,
                         (None, None, None, 0, None), 0)
    launches, errs, shapes, held = {}, {}, {}, set()
    gen = torch.Generator(device=dev).manual_seed(140)

    def params_of(modulus):
        return Params() if modulus is None else Params(q=modulus // 2, modulus=modulus)

    # ptxas: K1 and K2 must not spill at the degrees linear and sum now reach
    spills = [r for r in summary if r[0] in ("K1", "K2") and r[1] in (2048, 4096) and any(r[4:])]
    if spills:
        fail(f"[14] K1/K2 spill at N=2048/4096 (kernel, N, num, regs, store, load): {spills}")
    print("[14] ptxas: K1 and K2 spill no bytes at N=2048 and 4096 ("
          + ", ".join(f"{k} N={n} {regs} registers" for k, n, _, regs, *_ in summary
                      if k in ("K1", "K2") and n in (2048, 4096)) + ")", flush=True)

    def check_new(label: str) -> None:
        """Each launch the recorder saw at a shape [14] has not held yet,
        against its plain version on up to K14_CHECK_ROWS polynomials, timed
        (CUDA events, mean of 3 after a warm-up) beside its bound. The
        launches made here are not counted."""
        for key, args in rec.calls.items():
            if key in held:
                continue
            held.add(key)
            name = key[0]
            mod, attr, plain, axes, out_axis = rec.targets[name]
            fn = getattr(mod, attr)
            rows = next(a.shape[ax] for a, ax in zip(args, axes) if ax is not None)
            per_row = args[2].shape[1] if name == "K5" else 1
            k = min(rows, max(1, K14_CHECK_ROWS // per_row))
            part = [a.narrow(ax, 0, k) if ax is not None else a for a, ax in zip(args, axes)]
            shape = _shape_label(name, args)
            err = compare(f"[14] {label}: {name} {shape}, first {k} of {rows}",
                          fn(*args).narrow(out_axis, 0, k), plain(*part))
            errs[name] = max(errs.get(name, 0), err)
            ms, plain_ms = cuda_ms(lambda: fn(*args), reps=3), cuda_ms(lambda: plain(*part), reps=1)
            bms, bby = _k14_bound(name, args)
            shapes.setdefault(name, {})[shape] = [rec.counts[key], ms, plain_ms, k, bms, bby]
            print(f"  [14] {name} {shape}: {rec.counts[key]} launches in {label}; kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms on {k} rows, bound {bms:.3f} ms ({bby}) "
                  f"on {smi}", flush=True)
        rec.calls.clear()
        rec.counts.clear()

    # (a) the known-answer files, every launch held against its plain version
    for stem, proto, modulus, *_ in KAT_CONFIGS:
        fname = f"kat_{stem}.npz"
        with rec:
            replay_kat(proto, fname, params_of(modulus), dev, "[14]")
        check_new(f"known answers {fname}")

    # (b) the full-width round trips
    def inputs(proto, pp, n, b, vl, special):
        def c(shape):
            return sampling.uniform_centered(gen, shape[:-1], shape[-1], pp.q, dev)
        if special == "config1":
            return (api.prepare_value(pp, [[[1, 2, 3, 4]]], n, device=dev),)
        if special == "config3":
            return (api.prepare_scalar(pp, [[3, 5]] * b, n, device=dev), c((b, pp.l, n)))
        return {"open": lambda: (c((b, pp.l, n)),),
                "linear": lambda: (c((b, n)), c((b, pp.l, n))),
                "sum": lambda: (c((b, vl, n)), c((b, vl, pp.l, n)))}[proto]()

    def fit_batch(label, proto, pp, ck, n, b, vl, chains, special):
        """The run's batch: b, halved while the peak memory predicted from a
        round trip at b / FIT_PROBE passes FIT_SHARE of the card."""
        if b < 4096 or special:
            return b
        probe_b = b // FIT_PROBE
        xs = inputs(proto, pp, n, probe_b, vl, None)
        torch.cuda.synchronize()
        held_bytes = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        mods[proto].roundtrip(gen, ck, *xs, pp, chains=chains)
        torch.cuda.synchronize()
        per_probe = torch.cuda.max_memory_allocated(dev) - held_bytes
        del xs
        limit = FIT_SHARE * torch.cuda.get_device_properties(dev).total_memory
        fit = b
        while held_bytes + per_probe * fit / probe_b > limit and fit % (2 * chains) == 0:
            fit //= 2
        print(f"[14] {label}: a round trip at B={probe_b} peaks {per_probe / 2**30:.2f} GiB "
              f"above the {held_bytes / 2**30:.2f} GiB held; predicted at B={b}: "
              f"{(held_bytes + per_probe * b / probe_b) / 2**30:.2f} GiB of "
              f"{limit / 2**30:.2f}; batch {fit}", flush=True)
        return fit

    keys = {}
    for label, proto, modulus, n, b, vl, chains, special in RUNS14:
        gc.collect()
        torch.cuda.empty_cache()
        pp = params_of(modulus)
        if (modulus, n) not in keys:
            keys.clear()
            gc.collect()
            torch.cuda.empty_cache()
            keys[modulus, n] = commit_mod.keygen(gen, pp, n)
        ck = keys[modulus, n]
        b = fit_batch(label, proto, pp, ck, n, b, vl, chains, special)
        xs = inputs(proto, pp, n, b, vl, special)
        # the main path's run, from launch counts set to 0
        torch.cuda.synchronize()
        kernels.reset_launches()
        with rec:
            ok, op_ok = mods[proto].roundtrip(gen, ck, *xs, pp, chains=chains)
            torch.cuda.synchronize()
        launches[f"[14] {label}"] = dict(kernels.LAUNCHES)
        if ok.shape != (b,) or op_ok.shape != (b,):
            fail(f"[14] {label}: verdict shapes {tuple(ok.shape)}, {tuple(op_ok.shape)}; "
                 f"want ({b},)")
        if not bool(ok.all()) or not bool(op_ok.all()):
            fail(f"[14] {label}: {int((~ok).sum())} proofs and {int((~op_ok).sum())} "
                 "openings rejected")
        got = {k: launched(launches[f'[14] {label}'], k) for k in COUNTERS
               if launched(launches[f'[14] {label}'], k)}
        for k in path_kernels(proto, modulus is not None, n)[0]:
            if not got.get(k):
                fail(f"[14] {label}: kernel {k} was not launched ({got})")
        del ok, op_ok
        check_new(label)
        # after the count: a proof of the first chain's first PROBE_ROWS
        # inputs, accepted, and the same proof with z forged, rejected
        mod, rows = mods[proto], min(b // chains, PROBE_ROWS)
        rctx, pcom = mod.prover_commit(gen, ck, *(a[:rows] for a in xs), pp)
        vctx, chal = mod.generate_challenge(gen, pcom, pp)
        resp = mod.create_response(rctx, chal, pp)
        forged = tampered(proto, resp, pp.verify_bound(n) + 1, False)["ok_forged"]
        if not bool(mod.verify(ck, resp, vctx, pp).all()):
            fail(f"[14] {label}: an honest proof rejected in the probe run")
        if bool(mod.verify(ck, forged, vctx, pp).any()):
            fail(f"[14] {label}: a proof with a forged z verified")
        del rctx, pcom, vctx, chal, resp, forged
        # 5 calls of the user's entry point, each timed by CUDA events,
        # with the peak memory over them
        call = lambda: mods[proto].roundtrip(gen, ck, *xs, pp, chains=chains)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        times, timed = [], []
        for _ in range(5):
            start, stop = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize()
            start.record()
            timed.append(call())
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        peak = torch.cuda.max_memory_allocated(dev)
        if not all(bool(v.all()) for pair in timed for v in pair):
            fail(f"[14] {label}: a timed round trip rejected a proof or an opening")
        times.sort()
        print(f"[14] {label} (N={n} B={b}" + (f" VL={vl}" if vl else "")
              + (f", {chains} chains" if chains > 1 else "") + f", q={pp.modulus}): all {b} "
              f"proofs and openings verify in each call, {rows} forged z reject; "
              f"median {times[2]:.3f} ms of 5 "
              f"(min {times[0]:.3f}, max {times[-1]:.3f}), {b / times[2] * 1e3:.1f} verified "
              f"proofs/s; peak {peak / 2**30:.2f} GiB allocated ({(peak - before) / 2**30:.2f} "
              f"above the {before / 2**30:.2f} held); launches {got} on {smi}", flush=True)
        del xs, call
    keys.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # (c) K7 and K8 at five primes where no path runs them
    for modulus, n in K78_EXTRA:
        wring = get_ring(n, modulus)
        x = sampling.uniform_centered(gen, (K14_CHECK_ROWS,), n, modulus // 2, dev)
        num = wring.num_primes
        with rec:
            xh = k_wide.fwd_wide_all(wring, x, num)
            back = k_wide.inv_wide_all(wring, xh)
        if not torch.equal(back, x):
            fail(f"[14] K8(K7(x)) != x at q={modulus} N={n} num={num}")
        check_new(f"K7/K8 q={modulus} N={n}")
        del x, xh, back
    print(f"[14] the configurations: {time.perf_counter() - t_phase:.1f} s on {smi}", flush=True)
    return launches, errs, shapes


def time_roundtrips(tree: Path) -> None:
    """The one-chain round trips of phase [7] (``PATHS7``: bench.py's
    batches on the default ring at N=512, the wide rings, and N=1024-4096)
    of the port in ``tree``, a checkout of this repository: its kernels
    built from its own sources, then each path's median ms of 5 calls
    (CUDA events, after a warm-up), printed as one JSON line. Run it for
    two trees in one call (parent, change, change, parent) to compare them
    on one card:

        python3 chip_smoke.py --roundtrips <tree>
    """
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, str(tree))
    from ringzk_tpu_torch import Params
    from ringzk_tpu_torch.ops import sampling
    from ringzk_tpu_torch.ops.kernels import _lib
    from ringzk_tpu_torch.protocols import commit as commit_mod
    from ringzk_tpu_torch.protocols import linear
    from ringzk_tpu_torch.protocols import open as open_mod
    from ringzk_tpu_torch.protocols import sum as sum_mod

    _lib.build()
    _lib.lib()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    mods = {"open": open_mod, "linear": linear, "sum": sum_mod}
    out = {"tree": str(tree)}
    for proto, modulus, n, b in PATHS7:
        pp = Params() if modulus is None else Params(q=modulus // 2, modulus=modulus)
        ck = commit_mod.keygen(gen, pp, n)

        def c(shape):
            return sampling.uniform_centered(gen, shape[:-1], shape[-1], pp.q, dev)

        xs = {"open": lambda: (c((b, pp.l, n)),), "linear": lambda: (c((b, n)), c((b, pp.l, n))),
              "sum": lambda: (c((b, VL, n)), c((b, VL, pp.l, n)))}[proto]()
        ms = sorted(cuda_call_ms(lambda: mods[proto].roundtrip(gen, ck, *xs, pp), calls=5))
        out[f"{proto} q={pp.modulus} N={n} B={b}"] = ms[2]
        del ck, xs
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    # 1. device
    t_start = time.perf_counter()
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

    from ringzk_tpu_torch import Params, calibrate
    from ringzk_tpu_torch.ops import conv_mxu, ntt_dense, sampling, zq
    from ringzk_tpu_torch.ops import kernels
    from ringzk_tpu_torch.ops.kernels import _lib
    from ringzk_tpu_torch.ops.kernels import challenge as k_chal
    from ringzk_tpu_torch.ops.kernels import mac as k_mac
    from ringzk_tpu_torch.ops.kernels import matvec as k_mv
    from ringzk_tpu_torch.ops.kernels import modq as k_modq
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
    # 14. the configurations, on a card that holds nothing yet: its runs'
    # batches are then the paths' own, not cut by the tensors [3]-[13] keep
    config_launches, config_errs, config_shapes = configurations(dev, smi, summary)
    gc.collect()
    torch.cuda.empty_cache()

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
    # modq on centred operands, the paths' values, with the int32 extremes
    # and the centred edges in the first elements of both
    edges = torch.tensor([q // 2, -(q // 2), 0, 1, -1, -2**31, 2**31 - 1], dtype=torch.int32,
                         device=dev)
    pairs = torch.cartesian_prod(edges, edges).t()
    modq_in, errs["modq"] = {}, 0
    for label, shape, op in MODQ_SHAPES:
        a, b = centered(shape), centered(shape)
        a.view(-1)[:pairs.shape[1]], b.view(-1)[:pairs.shape[1]] = pairs
        fn, plain = ((k_modq.modq_add, k_modq.modq_add_plain) if op == "add"
                     else (k_modq.modq_sub, k_modq.modq_sub_plain))
        modq_in[label] = a, b
        errs["modq"] = max(errs["modq"], compare(f"modq {op} {label} {list(shape)}",
                                                 fn(ring.qctx, a, b), plain(ring.qctx, a, b)))

    # 4. known answers (the JAX package's own outputs, with its draws)
    kat_files = (("open", "kat_open_n512.npz", params), ("linear", "kat_linear_n512.npz", params),
                 ("sum", "kat_sum_n512.npz", params), ("open", "kat_open_q2e33_n512.npz", p33),
                 ("open", "kat_open_q2e63_n512.npz", p63),
                 ("linear", "kat_linear_q2e33_n512.npz", p33),
                 ("sum", "kat_sum_q2e33_n512.npz", p33),
                 ("open", "kat_open_n1024.npz", params), ("linear", "kat_linear_n1024.npz", params),
                 ("sum", "kat_sum_n1024.npz", params))
    for proto, fname, kp in kat_files:
        replay_kat(proto, fname, kp, dev, "[4]")

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

    def linear_path(name, pp, pck, n=N_DEG, batch=B_LINEAR) -> ProtoPath:
        x = centered((batch, pp.l, n), pp.q)
        g = centered((batch, n), pp.q)
        g_bad = centered((batch, n), pp.q)
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

        return ProtoPath(name, n, batch, lambda: linear.roundtrip(gen, pck, g, x, pp),
                         phases, probes, *path_kernels("linear", wide, n))

    def sum_path(name, pp, pck, n=N_DEG, batch=B_SUM) -> ProtoPath:
        xs_ = centered((batch, VL, pp.l, n), pp.q)
        gs = centered((batch, VL, n), pp.q)
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

        return ProtoPath(name, n, batch, lambda: sum_mod.roundtrip(gen, pck, gs, xs_, pp),
                         phases, probes, *path_kernels("sum", wide, n))

    makers = {"open": open_path, "linear": linear_path, "sum": sum_path}
    ring_params = {None: params, Q33: p33, Q63: p63}
    path_keys = {(None, N_DEG): ck, (Q33, N_DEG): commit_mod.keygen(gen, p33, N_DEG),
                 (Q63, N_DEG): commit_mod.keygen(gen, p63, N_DEG),
                 **{(None, n): k for n, k in large_ck.items()}}
    ring_names = {None: "", Q33: " q=2^33+9", Q63: " q=2^63-25"}
    paths = tuple((makers[proto], proto + ring_names[modulus] + (f" N={n}" if n != N_DEG else ""),
                   ring_params[modulus], path_keys[modulus, n], dict(n=n, batch=b))
                  for proto, modulus, n, b in PATHS7)
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
    profiled = {}   # each path's profiled round trip, for phase [12]
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
        prof = device_split(p.roundtrip, ranges=True)
        wall_ms, split, counts = prof.wall_ms, prof.split, prof.counts
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
        range_report(f"{p.name} profiled round trip", prof, smi)
        profiled[p.name] = prof
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
    print("[6] every kernel K1-K11 and modq launched on at least one run; K3, K4, K5 and modq "
          "and not K6 on each narrow N=512 path; K4, K7 and K8 and none of K3, K5, K6 and modq "
          "on each wide one; K4, K5, K6 and modq and not K3 on each larger-ring path; K1, K2, "
          "K9, K10 and K11 in "
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
    ck1024 = large_ck[1024]
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
    # modq at each of its shapes: bytes bound it, 4 in from each operand
    # and 4 out an element (its ~20 32-bit operations an element take a
    # third of that time at the ALU rate)
    for j, (label, shape, op) in enumerate(MODQ_SHAPES):
        a, b = modq_in.pop(label)
        fn, plain = ((k_modq.modq_add, k_modq.modq_add_plain) if op == "add"
                     else (k_modq.modq_sub, k_modq.modq_sub_plain))
        timed["modq" if j == 0 else f"modq ({label})"] = (
            lambda a=a, b=b, fn=fn: fn(ring.qctx, a, b),
            lambda a=a, b=b, plain=plain: plain(ring.qctx, a, b),
            f"{op} {label} {list(shape)}",
            lambda c, e=a.numel(): bound(12 * e, 0, c.rate))
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
        ("modq", "modq_add / modq_sub", "ringzk_tpu_torch/csrc/modq.cu", "none (XLA fused)"),
    ]
    gc.collect()
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    user_surface(dev, smi)
    print(f"[9] user surface: {time.perf_counter() - t9:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    parallel_launches, k9_tp = parallel_phase(dev, smi, path_ms)
    launches.update(parallel_launches)
    print(f"[10] dp, tp and batched keys: {time.perf_counter() - t10:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    sp_launches, k9_sp, sp_errs, sp_profiled = sp_phase(dev, smi)
    launches.update(sp_launches)
    for k, e in sp_errs.items():
        errs[k] = max(errs[k], e)
    print(f"[11] the sp axis: {time.perf_counter() - t11:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    last_modules(dev, smi, path_ms["open"], profiled, sp_profiled)
    print(f"[12] the last modules: {time.perf_counter() - t12:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    launches["ring algebra"], alg_errs = ring_algebra(dev, smi)
    for k, e in alg_errs.items():
        errs[k] = max(errs[k], e)
    print(f"[13] the ring algebra: {time.perf_counter() - t13:.1f} s", flush=True)
    launches.update(config_launches)
    for k, e in config_errs.items():
        errs[k] = max(errs[k], e)
    print(f"chip_smoke.py wall time: {time.perf_counter() - t_start:.1f} s from its start to "
          f"here (build, phases [1]-[14]), on {smi}", flush=True)
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
            if k in ("K1", "K2", "K7", "K8", "modq") else {}),
         **({"shapes_plain_ms": {r[4]: r[1] for name, r in results.items()
                                 if name.split()[0] == k}} if k == "modq" else {}),
         **({"inv_ms": results[f"{k} (inv)"][0], "inv_plain_ms": results[f"{k} (inv)"][1]}
            if k in ("K9", "K10") else {}),
         **({"tp_ms": k9_tp, "sp_ms": k9_sp} if k == "K9" else {}),
         **({"config_shapes": config_shapes[k]} if k in config_shapes else {})}
        for k, label, src, rep in meta
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--roundtrips"]:
        time_roundtrips(Path(sys.argv[2]).resolve())
        sys.exit(0)
    sys.exit(main())
