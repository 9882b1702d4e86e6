"""Time design alternatives of the register-resident kernels beside the
kernels as they are, on one CUDA card.

    python -m ringzk_tpu_torch.variants wide [VARIANT ...]   # K7/K8, csrc/ntt_wide.cu
    python -m ringzk_tpu_torch.variants one [VARIANT ...]    # K9, csrc/ntt_one.cu

A variant is the set's source with a few lines of it, or of a header it
includes, substituted (``SETS``). The variants named (all of the set's
when none is) are built each by its own ``nvcc``, all at once, into
``build/variants/<set>/<variant>/``; a substituted header is written
beside the variant's source, where its ``#include`` finds it first. Each
variant's output is held against the plain version (it prints WRONG where
it differs) and timed with CUDA events as the mean of 20 calls after one
warm-up. Then it prints ptxas' registers and spills per kernel and N, and
the card's name and power limit.

``wide``, at the N=512 shapes of ``chip_smoke.py`` [7]:

- ``as_is``: the source unchanged: K7 one group per row, the int64 row
  read once and held while the planes are taken in turn, each plane
  stored straight from the last pass's layout (E consecutive words a
  thread); K8 one group per row, its planes inverted in turn into the
  shared tile;
- ``k7_transpose``: K7 transposes each plane once more, from the last
  pass's layout back to pass 0's, and stores it from there (the warp's
  16-byte vectors contiguous);
- ``k7_per_prime``: K7 with one group per (row, prime), so the int64 row is
  read once per prime;
- ``k8_per_prime``: K8 with one warp per (row, prime): a block of num
  warps inverts a row's planes in parallel;
- ``strict_min``: the strict butterflies' subtract as min(d, d + p) in
  place of MontCtx's compare-and-add (``rz::sub_mod``), equal on [0, p).

``one``, at prime 0 of the default ring, N = 128, 512, 1024 and 4096, over
rows that make one 805 MB array (393,216 rows at N=512, the calibration's
shape): ``as_is``, the block size (``threads64``..``threads512``: threads a
block, so rows a block at N <= 1024) and the register cap (``cap96``,
``cap64``).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import torch

from .ops.kernels import _lib
from .ops.kernels import ntt_one as k_one
from .ops.kernels import ntt_wide as kw
from .ops.kernels.ntt import twiddle_pairs
from .ops.ntt import get_ring

OUT_DIR = _lib.BUILD_DIR.parent / "variants"
Q = 3_515_337_053
Q33, Q63 = 2**33 + 9, 2**63 - 25

K7_STORE = """    if (writer) {
      uint32_t* o = out + (static_cast<size_t>(i) * rows + row) * N;
#pragma unroll
      for (int cc = 0; cc < E / 4; ++cc)
        *reinterpret_cast<uint4*>(o + vec_last<L>(vt, cc)) ="""
K8_HEAD = """  const uint32_t vt = threadIdx.x & (VT - 1);
  const bool writer = threadIdx.x < VT;
  const size_t row = blockIdx.x;
#pragma unroll 1
  for (int i = 0; i < num; ++i) {"""
WIDE = "ntt_wide.cu"
WIDE_VARIANTS = {
    "as_is": [],
    "k7_transpose": [(WIDE, K7_STORE,
                      "    rz::regs::transpose<L, GT, P::kPasses - 1, 0>(v, buf, vt, writer, g);\n"
                      + K7_STORE.replace("vec_last", "vec_first"))],
    "k7_per_prime": [
        (WIDE, """  const size_t row = static_cast<size_t>(blockIdx.x) * G + g;
  if (row >= static_cast<size_t>(rows)) return;  // the whole group""",
         """  const size_t item = static_cast<size_t>(blockIdx.x) * G + g;
  if (item >= static_cast<size_t>(rows) * num) return;
  const size_t row = item % rows;
  const int i0 = static_cast<int>(item / rows);"""),
        (WIDE, "  for (int i = 0; i < num; ++i) {\n    const uint32_t p = k.c[8 * i], one_sh",
         "  for (int i = i0; i <= i0; ++i) {\n    const uint32_t p = k.c[8 * i], one_sh"),
        (WIDE, "static_cast<unsigned>((rows + groups - 1) / groups)",
         "static_cast<unsigned>((static_cast<long long>(rows) * num + groups - 1) / groups)")],
    "k8_per_prime": [
        (WIDE, K8_HEAD, """  const int g = threadIdx.x / GT;
  const uint32_t vt = threadIdx.x % GT & (VT - 1);
  const bool writer = threadIdx.x % GT < VT;
  const size_t row = blockIdx.x;
#pragma unroll 1
  for (int i = g; i < num; i += blockDim.x / GT) {"""),
        (WIDE, "(v, slot, twi, vt, writer, 0, p);", "(v, slot, twi, vt, writer, g, p);"),
        (WIDE, "rz::regs::group_sync<GT>(0);", "rz::regs::group_sync<GT>(g);"),
        (WIDE, "kern<<<rows, GT, smem, stream>>>(xhat", "kern<<<rows, num * GT, smem, stream>>>(xhat")],
    "strict_min": [("ntt_regs.cuh", "sub_mod(x0, pr, prime)", "min(x0 - pr, x0 - pr + prime)"),
                   ("ntt_regs.cuh", "sub_mod(x0, x1, prime)", "min(x0 - x1, x0 - x1 + prime)")],
}
THREADS, CAP = "constexpr int kThreads = 128;", "constexpr int kRegCap = 128;"
ONE_VARIANTS = {"as_is": []} | {
    f"threads{t}": [("ntt_one.cu", THREADS, THREADS.replace("128", str(t)))]
    for t in (64, 256, 512)} | {
    f"cap{c}": [("ntt_one.cu", CAP, CAP.replace("128", str(c)))] for c in (96, 64)}


def mean_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def timed(libs: dict, entry: str, args: tuple, out, want) -> str:
    """Each variant's ``entry`` on ``args``, its ``out`` held against
    ``want``: "name ms" cells."""
    cells = []
    for name, lib in libs.items():
        fn = getattr(lib, entry)
        out.zero_()
        if fn(*args) != 0:
            raise SystemExit(f"{name}: {entry} failed to launch")
        torch.cuda.synchronize()
        ok = torch.equal(out, want)
        cells.append(f"{name} {mean_ms(lambda: fn(*args)):.3f}{'' if ok else ' WRONG'}")
    return ", ".join(cells)


def run_wide(libs: dict, dev, gen, stream) -> None:
    n = 512
    for q, num, rows in ((Q33, 3, 393216), (Q33, 2, 131072), (Q33, 1, 131072),
                         (Q33, 1, 393216), (Q63, 5, 131072)):
        ring = get_ring(n, q)
        x = torch.randint(-(q // 2), q // 2 + 1, (rows, n), generator=gen, device=dev)
        x[0, :4] = torch.tensor([2**63 - 1, -2**63, q // 2, -(q // 2)])
        out = torch.empty((num, rows, n), dtype=torch.int32, device=dev)
        args = (x.data_ptr(), out.data_ptr(), twiddle_pairs(ring, dev).data_ptr(),
                kw.wide_consts(ring, num).data_ptr(), num, rows, n, stream)
        cells = timed(libs, "rz_ntt_fwd_wide", args, out, kw.fwd_wide_all_plain(ring, x, num))
        print(f"K7 q={q} num={num} rows={rows}: {cells}", flush=True)
    for q, num, rows in ((Q33, 3, 131072), (Q33, 2, 131072), (Q33, 1, 393216), (Q63, 5, 131072)):
        ring = get_ring(n, q)
        xh = torch.stack([torch.randint(0, p, (rows, n), generator=gen, device=dev)
                          for p in ring.primes[:num]]).to(torch.int32)
        out = torch.empty((rows, n), dtype=torch.int64, device=dev)
        args = (xh.data_ptr(), out.data_ptr(), twiddle_pairs(ring, dev).data_ptr(),
                kw.wide_consts(ring, num).data_ptr(), num, rows, n, stream)
        cells = timed(libs, "rz_ntt_inv_wide", args, out, kw.inv_wide_all_plain(ring, xh))
        print(f"K8 q={q} num={num} rows={rows}: {cells}", flush=True)


def run_one(libs: dict, dev, gen, stream) -> None:
    for n in (128, 512, 1024, 4096):
        rows = 393216 * 512 // n
        ring = get_ring(n, Q)
        x = torch.randint(0, ring.primes[0], (rows, n), generator=gen, device=dev,
                          dtype=torch.int32)
        out = torch.empty_like(x)
        for entry, plain in (("rz_ntt_fwd_one", k_one.fwd_one_plain),
                             ("rz_ntt_inv_one", k_one.inv_one_plain)):
            args = (x.data_ptr(), out.data_ptr(), twiddle_pairs(ring, dev)[0].data_ptr(),
                    k_one.one_consts(ring, 0).data_ptr(), rows, n, stream)
            cells = timed(libs, entry, args, out, plain(ring, 0, x))
            print(f"K9 {entry[7:]} N={n} rows={rows}: {cells}", flush=True)


class Set(NamedTuple):
    source: str
    entries: tuple
    kernels: dict  # label -> kernel name, for the ptxas lines
    variants: dict  # name -> [(file, old, new), ...]
    run: Callable


SETS = {
    "wide": Set(WIDE, ("rz_ntt_fwd_wide", "rz_ntt_inv_wide"),
                {"K7": "ntt_fwd_wide_kernel", "K8": "ntt_inv_wide_kernel"}, WIDE_VARIANTS,
                run_wide),
    "one": Set("ntt_one.cu", ("rz_ntt_fwd_one", "rz_ntt_inv_one"),
               {"K9": "ntt_fwd_one_kernel", "K9 (inv)": "ntt_inv_one_kernel"}, ONE_VARIANTS,
               run_one),
}


def variant_files(s: Set, subs: list) -> dict:
    """{file name: text} of the set's source and of every file ``subs``
    substitute in, substituted."""
    texts = {s.source: (_lib.CSRC / s.source).read_text()}
    for f, old, new in subs:
        text = texts.get(f) or (_lib.CSRC / f).read_text()
        if old not in text:
            raise SystemExit(f"substitution target missing from {f}: {old[:60]!r}")
        texts[f] = text.replace(old, new)
    return texts


def build(set_name: str, names: list) -> dict[str, ctypes.CDLL]:
    """The variants ``names`` of set ``set_name``, each built by its own
    nvcc, all at once; nvcc's report kept beside each as ``nvcc.log``."""
    s, nvcc, procs = SETS[set_name], _lib._nvcc(), {}
    for name in names:
        d = OUT_DIR / set_name / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in variant_files(s, s.variants[name]).items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC), "-shared", "-o", str(d / "lib.so"),
             str(d / s.source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        (OUT_DIR / set_name / name / "nvcc.log").write_text(log)
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(str(OUT_DIR / set_name / name / "lib.so"))
        for f in s.entries:
            getattr(lib, f).argtypes = _lib.SIGNATURES[f]
            getattr(lib, f).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv: list) -> None:
    if not argv or argv[0] not in SETS or set(argv[1:]) - set(SETS[argv[0]].variants):
        raise SystemExit(f"usage: python -m ringzk_tpu_torch.variants {{{','.join(SETS)}}} "
                         "[VARIANT ...]")
    if not torch.cuda.is_available():
        raise SystemExit("variants needs a CUDA card")
    s = SETS[argv[0]]
    names = argv[1:] or list(s.variants)
    t0 = time.perf_counter()
    libs = build(argv[0], names)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    s.run(libs, dev, torch.Generator(device=dev).manual_seed(1),
          torch.cuda.current_stream().cuda_stream)
    for name in names:
        summary = _lib.ptxas_summary((OUT_DIR / argv[0] / name / "nvcc.log").read_text(),
                                     s.kernels)
        for line in _lib.ptxas_lines(summary, s.kernels):
            print(f"ptxas {name} {line}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main(sys.argv[1:])
