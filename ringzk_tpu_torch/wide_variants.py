"""Time the design alternatives of K7 and K8 (``csrc/ntt_wide.cu``) beside
the kernels as they are, on one CUDA card.

    python -m ringzk_tpu_torch.wide_variants

Each variant is ``csrc/ntt_wide.cu`` with a few lines substituted, built
for N=512 only, every variant by its own ``nvcc``, all at once, into
``build/wide_variants/``:

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
  warps inverts a row's planes in parallel.

Every variant's output is held against the plain version (it prints
WRONG where it differs) and timed with CUDA events as the mean of 20
calls after one warm-up, at the N=512 shapes of ``chip_smoke.py`` [7].
Then it prints ptxas' registers and spills per variant and the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import time

import torch

from .ops.kernels import _lib
from .ops.kernels import ntt_wide as kw
from .ops.kernels.ntt import twiddle_pairs
from .ops.ntt import get_ring

SRC = _lib.CSRC / "ntt_wide.cu"
OUT_DIR = _lib.BUILD_DIR.parent / "wide_variants"
N = 512
Q33, Q63 = 2**33 + 9, 2**63 - 25
K7_SHAPES = ((Q33, 3, 393216), (Q33, 2, 131072), (Q33, 1, 131072), (Q33, 1, 393216),
             (Q63, 5, 131072))
K8_SHAPES = ((Q33, 3, 131072), (Q33, 2, 131072), (Q33, 1, 393216), (Q63, 5, 131072))

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
VARIANTS = {
    "as_is": [],
    "k7_transpose": [(K7_STORE, "    rz::regs::transpose<L, GT, P::kPasses - 1, 0>(v, buf, vt, writer, g);\n"
                      + K7_STORE.replace("vec_last", "vec_first"))],
    "k7_per_prime": [
        ("""  const size_t row = static_cast<size_t>(blockIdx.x) * G + g;
  if (row >= static_cast<size_t>(rows)) return;  // the whole group""",
         """  const size_t item = static_cast<size_t>(blockIdx.x) * G + g;
  if (item >= static_cast<size_t>(rows) * num) return;
  const size_t row = item % rows;
  const int i0 = static_cast<int>(item / rows);"""),
        ("  for (int i = 0; i < num; ++i) {\n    const uint32_t p = k.c[8 * i], one_sh",
         "  for (int i = i0; i <= i0; ++i) {\n    const uint32_t p = k.c[8 * i], one_sh"),
        ("static_cast<unsigned>((rows + groups - 1) / groups)",
         "static_cast<unsigned>((static_cast<long long>(rows) * num + groups - 1) / groups)")],
    "k8_per_prime": [
        (K8_HEAD, """  const int g = threadIdx.x / GT;
  const uint32_t vt = threadIdx.x % GT & (VT - 1);
  const bool writer = threadIdx.x % GT < VT;
  const size_t row = blockIdx.x;
#pragma unroll 1
  for (int i = g; i < num; i += blockDim.x / GT) {"""),
        ("(v, slot, twi, vt, writer, 0, p);", "(v, slot, twi, vt, writer, g, p);"),
        ("rz::regs::group_sync<GT>(0);", "rz::regs::group_sync<GT>(g);"),
        ("kern<<<rows, GT, smem, stream>>>(xhat", "kern<<<rows, num * GT, smem, stream>>>(xhat")],
}


def variant_source(subs) -> str:
    s = SRC.read_text()
    for old, new in subs:
        if old not in s:
            raise SystemExit(f"substitution target missing from {SRC.name}: {old[:60]!r}")
        s = s.replace(old, new)
    return re.sub(r"    case (?!512:)\d+: return launch\(std::integral_constant<int, \d+>\{\}\);\n",
                  "", s)


def build() -> dict[str, ctypes.CDLL]:
    nvcc = _lib._nvcc()
    procs = {}
    for name, subs in VARIANTS.items():
        d = OUT_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "ntt_wide.cu").write_text(variant_source(subs))
        procs[name] = subprocess.Popen(
            [nvcc, *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC), "-shared", "-o", str(d / "lib.so"),
             str(d / "ntt_wide.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}")
        lib = ctypes.CDLL(str(OUT_DIR / name / "lib.so"))
        for f in ("rz_ntt_fwd_wide", "rz_ntt_inv_wide"):
            getattr(lib, f).argtypes = _lib.SIGNATURES[f]
            getattr(lib, f).restype = ctypes.c_int
        libs[name] = lib
    return libs


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


def run(libs, entry: str, ring, inp, out, want, num: int, rows: int) -> str:
    cells = []
    stream = torch.cuda.current_stream().cuda_stream
    args = (inp.data_ptr(), out.data_ptr(), twiddle_pairs(ring, inp.device).data_ptr(),
            kw.wide_consts(ring, num).data_ptr(), num, rows, N, stream)
    for name, lib in libs.items():
        fn = getattr(lib, entry)
        out.zero_()
        if fn(*args) != 0:
            raise SystemExit(f"{name}: {entry} failed to launch")
        torch.cuda.synchronize()
        ok = torch.equal(out, want)
        cells.append(f"{name} {mean_ms(lambda: fn(*args)):.3f}{'' if ok else ' WRONG'}")
    return ", ".join(cells)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("wide_variants needs a CUDA card")
    t0 = time.perf_counter()
    libs = build()
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for q, num, rows in K7_SHAPES:
        ring = get_ring(N, q)
        x = torch.randint(-(q // 2), q // 2 + 1, (rows, N), generator=gen, device=dev)
        x[0, :4] = torch.tensor([2**63 - 1, -2**63, q // 2, -(q // 2)])
        out = torch.empty((num, rows, N), dtype=torch.int32, device=dev)
        cells = run(libs, "rz_ntt_fwd_wide", ring, x, out, kw.fwd_wide_all_plain(ring, x, num),
                    num, rows)
        print(f"K7 q={q} num={num} rows={rows}: {cells}", flush=True)
    for q, num, rows in K8_SHAPES:
        ring = get_ring(N, q)
        xh = torch.stack([torch.randint(0, p, (rows, N), generator=gen, device=dev)
                          for p in ring.primes[:num]]).to(torch.int32)
        out = torch.empty((rows, N), dtype=torch.int64, device=dev)
        cells = run(libs, "rz_ntt_inv_wide", ring, xh, out, kw.inv_wide_all_plain(ring, xh),
                    num, rows)
        print(f"K8 q={q} num={num} rows={rows}: {cells}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
