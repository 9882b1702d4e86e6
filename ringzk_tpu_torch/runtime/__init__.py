"""The native RZK1 row codec (``codec.cpp``), built at first use.

Port of ``ringzk_tpu.runtime``: the same C interface and bytes, with a
decoder that rejects varints past 32 bits and names each fault (see the
header of ``codec.cpp``). The library is compiled by the host C++ compiler
(``g++``, else ``c++``; ``-O3 -shared -fPIC -pthread``) the first time
:func:`lib` is called, never at import, into ``build/ringzk_tpu_torch/``
beside the package, under a name hashed from the source, the flags and the
compiler's path and version. Each process compiles into a file of its own
and renames it into place, so processes that build at once never load half
a library. There is no fallback: a missing compiler or a failed build
raises with the compiler's output. ``utils/serial.py`` encodes and decodes every compact
row through :func:`encode_rows` and :func:`decode_rows`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("codec.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ringzk_tpu_torch"
CXX_FLAGS = ("-O3", "-Wall", "-shared", "-fPIC", "-pthread")

# rzk_decode_rows_ex's fault codes, as the numpy decoder words them
FAULTS = {
    1: "corrupt wire payload: truncated row header",
    2: "corrupt row: kept > row_len",
    3: "corrupt wire payload: truncated varints",
    4: "corrupt varint",
}

_P, _U64 = ctypes.c_void_p, ctypes.c_uint64
SIGNATURES = {
    "rzk_encode_bound": (_U64, (_U64, _U64)),
    "rzk_encode_rows": (_U64, (_P, _U64, _U64, _P)),
    "rzk_encode_rows_mt": (_U64, (_P, _U64, _U64, _P, ctypes.c_uint32)),
    "rzk_decode_rows": (_U64, (_P, _U64, _P, _U64, _U64)),
    "rzk_decode_rows_ex": (_U64, (_P, _U64, _P, _U64, _U64, _P)),
}

_loaded: ctypes.CDLL | None = None
_lock = threading.Lock()


def compiler() -> str:
    """The host C++ compiler: ``g++``, else ``c++``."""
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++ or c++) found: the native RZK1 codec "
                       "cannot be built")


def build(build_dir: Path | None = None) -> Path:
    """Compile the codec if it is not built yet; return the library's path."""
    cxx = compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    digest = hashlib.sha256("\0".join((cxx, version, *CXX_FLAGS)).encode()
                            + SOURCE.read_bytes())
    out = Path(build_dir or BUILD_DIR) / f"libcodec_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        run = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE.name} ({run.returncode}):\n"
                               f"{run.stdout}{run.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded codec library (built on first call)."""
    global _loaded
    with _lock:
        if _loaded is None:
            handle = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype, fn.argtypes = restype, argtypes
            _loaded = handle
    return _loaded


def encode_rows(a2d: np.ndarray, threads: int = 1) -> bytes:
    """The compact encoding of the rows of a C-contiguous int32 [rows, N]
    array; ``threads`` > 1 splits the rows over that many threads (the same
    bytes)."""
    if a2d.dtype != np.int32 or a2d.ndim != 2 or not a2d.flags.c_contiguous:
        raise ValueError("encode_rows takes a C-contiguous int32 [rows, N] array")
    codec = lib()
    rows, n = a2d.shape
    out = np.empty(codec.rzk_encode_bound(rows, n), np.uint8)
    if threads > 1:
        used = codec.rzk_encode_rows_mt(a2d.ctypes.data, rows, n, out.ctypes.data, threads)
    else:
        used = codec.rzk_encode_rows(a2d.ctypes.data, rows, n, out.ctypes.data)
    return out[:used].tobytes()


def decode_rows(buf, n_rows: int, row_len: int) -> np.ndarray:
    """Decode ``n_rows`` rows of ``row_len`` coefficients from the start of
    ``buf`` (trailing bytes are ignored) into an int32 [n_rows, row_len]
    array. Raises ValueError, worded as the numpy decoder words it, on a
    truncated row header, a row that keeps more than ``row_len``
    coefficients, a payload that ends inside a row's varints, or a varint
    longer than 5 bytes or past 32 bits."""
    src = np.frombuffer(buf, np.uint8)
    data = np.zeros((n_rows, row_len), np.int32)
    fault = ctypes.c_int32(0)
    lib().rzk_decode_rows_ex(src.ctypes.data, src.size, data.ctypes.data, n_rows, row_len,
                             ctypes.byref(fault))
    if fault.value:
        raise ValueError(FAULTS[fault.value])
    return data
