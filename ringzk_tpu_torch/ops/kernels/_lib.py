"""Build and load the port's CUDA kernel library.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all at once, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``. The
library's name carries a hash of the sources and flags, so an edited
source builds anew and a stale library is never loaded. The build happens
at first use, into ``build/ringzk_tpu_torch/`` beside the package, and
never at import. Nothing here is needed on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "ringzk_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _U, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
# C entry points: name -> argument types. Each returns cudaGetLastError().
SIGNATURES = {
    "rz_ntt_fwd": (_P, _P, _P, _P, _I, _I, _I, _P),
    "rz_ntt_inv": (_P, _P, _P, _P, _I, _I, _I, _P),
    "rz_matvec_digits": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "rz_matvec_colblock": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "rz_challenge_select": (_P, _P, _P, _I, _I, _I, _P),
    "rz_scalar_mul_add": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "rz_ntt_fwd_wide": (_P, _P, _P, _P, _I, _I, _I, _P),
    "rz_ntt_inv_wide": (_P, _P, _P, _P, _I, _I, _I, _P),
    "rz_ntt_fwd_one": (_P, _P, _P, _P, _I, _I, _P),
    "rz_ntt_inv_one": (_P, _P, _P, _P, _I, _I, _P),
    "rz_ntt_dense": (_P, _P, _P, _P, _I, _I, _P),
    "rz_mac_chain": (_P, _P, _P, _L, _P),
    "rz_modq_add": (_P, _P, _P, _U, _L, _P),
    "rz_modq_sub": (_P, _P, _P, _U, _L, _P),
}

_loaded: ctypes.CDLL | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build() -> Path:
    """Compile the kernel library if it is not built yet; return its path.
    nvcc's report (registers, shared memory, spills per kernel) is kept
    beside it as ``.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode() + b"\0" + f.read_bytes())
    out = BUILD_DIR / f"libringzk_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objdir = Path(f"{tmp}.obj")
    objdir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [objdir / f"{src.stem}.o" for src in sources]
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        out.with_suffix(".log").write_text("".join(logs))
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _loaded
    if _loaded is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded = handle
    return _loaded


def ptxas_summary(log: str, kernels: dict) -> list:
    """(kernel, N, NUM or None, registers, spill store bytes, spill load
    bytes) per instance of the register-resident kernels in nvcc's -Xptxas
    -v report, sorted by ``kernels``' order, NUM and N. ``kernels`` maps a
    label to a kernel's name; its instances are templates on log2(N) (and
    K5's prime count), named in their mangled names."""
    rows, entry, spill = [], None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = next(([k, *(int(a) for a in re.findall(r"Li(\d+)E", t.group(1)))]
                          for k, sub in kernels.items()
                          if (t := re.search(rf"\d{sub}I((?:Li\d+E)+)E", m.group(1)))), None)
            spill = (0, 0)
        elif entry and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            spill = tuple(int(v) for v in m.groups())
        elif entry and (m := re.search(r"Used (\d+) registers", line)):
            kind, log_n, *num = entry
            rows.append((kind, 1 << log_n, num[0] if num else None, int(m.group(1)), *spill))
            entry = None
    return sorted(rows, key=lambda r: (list(kernels).index(r[0]), r[2] or 0, r[1]))


def ptxas_lines(summary: list, kernels: dict) -> list:
    """One line per kernel (and NUM) of a :func:`ptxas_summary`: its
    registers and spills per N."""
    return [f"{kk} {kernels[kk]}" + (f" num={num}" if num else "")
            + ": registers (spill store/load bytes) " + ", ".join(
                f"N={n} {regs} ({st}/{ld})" for k, n, m, regs, st, ld in summary
                if (k, m) == (kk, num))
            for kk, num in dict.fromkeys((r[0], r[2]) for r in summary)]
