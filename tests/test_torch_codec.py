"""The port's native RZK1 row codec (``ringzk_tpu_torch/runtime/codec.cpp``)
against the JAX package's native codec and both packages' numpy codecs.

The JAX package's ``libcodec.so`` is compiled here from
``ringzk_tpu/runtime/codec.cpp`` with the flags of
``scripts/build_native.sh``, into a directory of this test's own: the script
writes into the JAX package, where tests/test_serial.py may be building it
at the same time.
"""

import ctypes
import re
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ringzk_tpu.utils import serial as jserial
from ringzk_tpu_torch import runtime
from ringzk_tpu_torch.utils import serial

REPO = Path(__file__).resolve().parents[1]
N = 32


@pytest.fixture(scope="module")
def jax_codec(tmp_path_factory):
    """The JAX package's native codec, built as scripts/build_native.sh
    builds it."""
    script = (REPO / "scripts" / "build_native.sh").read_text()
    flags = re.search(r"^g\+\+ (.*) -o libcodec\.so codec\.cpp$", script, re.M).group(1).split()
    out = tmp_path_factory.mktemp("jax_codec") / "libcodec.so"
    subprocess.run([runtime.compiler(), *flags, "-o", str(out),
                    str(REPO / "ringzk_tpu" / "runtime" / "codec.cpp")], check=True)
    lib = ctypes.CDLL(str(out))
    p, u64 = ctypes.c_void_p, ctypes.c_uint64
    lib.rzk_encode_bound.restype = u64
    lib.rzk_encode_bound.argtypes = [u64, u64]
    lib.rzk_encode_rows_mt.restype = u64
    lib.rzk_encode_rows_mt.argtypes = [p, u64, u64, p, ctypes.c_uint32]
    lib.rzk_decode_rows.restype = u64
    lib.rzk_decode_rows.argtypes = [p, u64, p, u64, u64]
    return lib


def jax_encode(lib, a2d, threads=1):
    out = np.empty(lib.rzk_encode_bound(*a2d.shape), np.uint8)
    used = lib.rzk_encode_rows_mt(a2d.ctypes.data, *a2d.shape, out.ctypes.data, threads)
    return out[:used].tobytes()


def jax_decode(lib, buf, n_rows, row_len):
    """(array, bytes consumed); 0 bytes consumed on a malformed payload."""
    src = np.frombuffer(buf, np.uint8)
    data = np.zeros((n_rows, row_len), np.int32)
    used = lib.rzk_decode_rows(src.ctypes.data, src.size, data.ctypes.data, n_rows, row_len)
    return data, used


def _rows(kind, rng):
    if kind == "int32 extremes":
        a = rng.integers(-(2**31), 2**31, size=(12, N), dtype=np.int64).astype(np.int32)
        a[::2, ::3] = -(2**31)
        a[1::2, ::3] = 2**31 - 1
        return a
    if kind == "every varint length":
        # zigzag values at each length's edges: 1 to 5 bytes
        edges = [0, 63, -64, 64, -65, 1 << 12, -(1 << 13), 1 << 13, 1 << 19, -(1 << 20),
                 1 << 20, 1 << 26, -(1 << 27), 1 << 27, 2**31 - 1, -(2**31)]
        return np.tile(np.asarray(edges, np.int32), (3, 2))
    if kind == "all-zero rows":
        a = np.zeros((7, N), np.int32)
        a[3, 0] = 1
        return a
    if kind == "trailing-zero rows":
        a = rng.integers(-5000, 5000, size=(9, N)).astype(np.int32)
        for r in range(9):
            a[r, 3 * r + 1:] = 0
        return a
    raise KeyError(kind)


KINDS = ("int32 extremes", "every varint length", "all-zero rows", "trailing-zero rows")


@pytest.mark.parametrize("kind", KINDS)
def test_encode_equals_jax_codecs(jax_codec, rng, kind):
    """The port's native bytes equal the JAX native codec's and both numpy
    codecs'."""
    a = _rows(kind, rng)
    enc = serial.encode_rows(a)
    assert enc == jax_encode(jax_codec, a)
    assert enc == jserial._encode_rows_numpy(a)
    assert enc == serial._encode_rows_numpy(a)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_equals_jax_codecs(jax_codec, rng, kind):
    a = _rows(kind, rng)
    enc = jserial._encode_rows_numpy(a)
    got = serial.decode_rows(enc, a.shape)
    np.testing.assert_array_equal(got, a)
    jax_native, used = jax_decode(jax_codec, enc, *a.shape)
    assert used == len(enc)
    np.testing.assert_array_equal(got, jax_native)
    np.testing.assert_array_equal(got, jserial._decode_rows_numpy(memoryview(enc), *a.shape)[0])
    np.testing.assert_array_equal(got, serial._decode_rows_numpy(enc, a.shape))


def test_multithreaded_encoder_matches_one_thread(jax_codec, rng):
    """9,000 rows: past serial's thread threshold, the threads' bytes equal
    one thread's, the JAX codec's with 7 threads, and decode back."""
    a = rng.integers(-(2**20), 2**20, size=(9000, N)).astype(np.int32)
    a[::5, 10:] = 0
    assert a.shape[0] >= serial._MT_ROWS
    one = runtime.encode_rows(a, 1)
    assert runtime.encode_rows(a, 8) == one
    assert runtime.encode_rows(a, 3) == one
    assert serial.encode_rows(a) == one
    assert jax_encode(jax_codec, a, 7) == one
    np.testing.assert_array_equal(serial.decode_rows(one, a.shape), a)


def _head(kept):
    return struct.pack("<I", kept)


# name -> (payload read as shape (1, 4), answer: an array or the ValueError
# message of both port decoders)
MALFORMED = {
    "5 bytes, fifth 0x10 (2^32)": (_head(1) + bytes([0x80, 0x80, 0x80, 0x80, 0x10]),
                                   "corrupt varint"),
    "5 bytes, fifth 0x7F (2^35 - 1)": (_head(1) + bytes([0xFF, 0xFF, 0xFF, 0xFF, 0x7F]),
                                       "corrupt varint"),
    "6-byte varint": (_head(1) + b"\xff" * 5 + b"\x01", "corrupt varint"),
    "kept > row_len": (_head(5) + b"\x02" * 5, "corrupt row: kept > row_len"),
    "truncated header": (b"\x01\x00", "corrupt wire payload: truncated row header"),
    "truncated varint": (_head(2) + b"\x02\xff", "corrupt wire payload: truncated varints"),
    "trailing bytes": (_head(2) + b"\x02\x05" + b"\xff\x00\x07",
                       np.asarray([[1, -3, 0, 0]], np.int32)),
    "largest 5-byte varint (fifth 0x0F)": (_head(1) + bytes([0xFF, 0xFF, 0xFF, 0xFF, 0x0F]),
                                           np.asarray([[-(2**31), 0, 0, 0]], np.int32)),
}
# payloads whose varint passes 32 bits: the JAX package's native decoder
# drops the bits past 32 and returns a value (ROADMAP.md, "Reference faults
# the port must not copy")
PAST_32_BITS = {"5 bytes, fifth 0x10 (2^32)": 0, "5 bytes, fifth 0x7F (2^35 - 1)": -(2**31)}


def _answer(decode, payload):
    try:
        return decode(payload, (1, 4))
    except ValueError as err:
        return str(err)


@pytest.mark.parametrize("name", MALFORMED)
def test_malformed_payloads(jax_codec, name):
    """The port's native and plain decoders give the same array or the same
    ValueError message on each malformed payload."""
    payload, want = MALFORMED[name]
    native, plain = _answer(serial.decode_rows, payload), _answer(serial._decode_rows_numpy,
                                                                  payload)
    if isinstance(want, str):
        assert native == plain == want
    else:
        np.testing.assert_array_equal(native, want)
        np.testing.assert_array_equal(plain, want)
    jax_native, used = jax_decode(jax_codec, payload, 1, 4)
    if name in PAST_32_BITS:
        # the reference fault: libcodec.so accepts the row and wraps it
        assert used == len(payload) and jax_native[0, 0] == PAST_32_BITS[name]
        assert isinstance(native, str)
    elif isinstance(want, str):
        assert used == 0
    else:
        np.testing.assert_array_equal(jax_native, want)


def test_port_entry_point_keeps_jax_interface(rng):
    """rzk_decode_rows keeps the JAX package's contract (bytes consumed, 0
    on a malformed payload), with the 32-bit check."""
    codec = runtime.lib()
    a = rng.integers(-99, 99, size=(3, N)).astype(np.int32)
    enc = np.frombuffer(serial.encode_rows(a), np.uint8)
    out = np.zeros_like(a)
    assert codec.rzk_decode_rows(enc.ctypes.data, enc.size, out.ctypes.data, 3, N) == enc.size
    np.testing.assert_array_equal(out, a)
    bad = np.frombuffer(MALFORMED["5 bytes, fifth 0x7F (2^35 - 1)"][0], np.uint8)
    out = np.zeros((1, 4), np.int32)
    assert codec.rzk_decode_rows(bad.ctypes.data, bad.size, out.ctypes.data, 1, 4) == 0


def test_dumps_runs_the_native_codec(monkeypatch, rng):
    """Every compact row of dumps and loads goes through the native codec."""
    calls = []
    enc, dec = runtime.encode_rows, runtime.decode_rows
    monkeypatch.setattr(runtime, "encode_rows", lambda *a: calls.append("enc") or enc(*a))
    monkeypatch.setattr(runtime, "decode_rows", lambda *a: calls.append("dec") or dec(*a))
    tree = {"z": rng.integers(-9, 9, size=(2, 3, 8)).astype(np.int32),
            "t": rng.integers(-9, 9, size=(2, 8)).astype(np.int32)}
    back = serial.loads(serial.dumps(tree))
    assert calls == ["enc", "enc", "dec", "dec"]
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k], v)


_BUILD = ("import sys; from pathlib import Path; from ringzk_tpu_torch import runtime; "
          "print(runtime.build(Path(sys.argv[1])))")


def test_concurrent_first_builds_are_atomic(tmp_path):
    """Two processes build into a fresh directory at once: both name the same
    library, which loads and encodes, and no temporary file is left."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert sorted(f.name for f in tmp_path.iterdir()) == [Path(paths.pop()).name]
    lib = ctypes.CDLL(str(next(tmp_path.iterdir())))
    lib.rzk_encode_bound.restype = ctypes.c_uint64
    assert lib.rzk_encode_bound(2, 3) == 2 * (4 + 5 * 3)


def test_no_compiler_raises(monkeypatch, tmp_path):
    """No quiet fallback: without a compiler the build raises."""
    monkeypatch.setattr(runtime.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        runtime.build(tmp_path)


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    broken = tmp_path / "codec.cpp"
    broken.write_text("extern \"C\" int rzk_encode_bound( {\n")
    monkeypatch.setattr(runtime, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="failed on codec.cpp") as err:
        runtime.build(tmp_path / "out")
    assert "error" in str(err.value)
    assert not any((tmp_path / "out").iterdir())
