"""Deterministic packed wire format for protocol objects (RZK1).

Port of ``ringzk_tpu.utils.serial``, byte for byte: a JAX object and the
port's object holding the same values encode to the same bytes. Every
protocol object is a NamedTuple of tensors, so the wire format is a flat,
deterministic container of named arrays:

  header:  b"RZK1" | u16 version | u32 n_entries
  entry:   u16 path_len | path utf-8 | u8 dtype | u8 encoding
           u8 ndim | u32 dims[ndim] | u64 payload_len | payload

encodings: 0 = raw little-endian; 1 = per-row trailing-zero-trimmed zigzag
varints (the bincode-analog compact form; rows are the innermost N axis).
Encoding 1 runs through the port's native C++ codec (``runtime/codec.cpp``,
built at first use by the host compiler; threads past :data:`_MT_ROWS`
rows), with no fallback. The vectorized numpy codec
(:func:`_encode_rows_numpy`, :func:`_decode_rows_numpy`) is its plain
version, which the tests hold it to; both write the JAX package's bytes.

Tensors go to the host as numpy at :func:`dumps` only, with the JAX
package's dtype codes. The port stores the uint32 lanes of a key's NTT
images as int32 bit patterns; the wire says uint32 for them
(:data:`UINT32_FIELDS`), as it does for the JAX key. :func:`rebuild` puts
the tensors back on a device (default: the CUDA card).
"""

from __future__ import annotations

import os
import struct
import typing
from typing import Any

import numpy as np
import torch

from .. import runtime
from ..protocols.commit import CommitmentKey, resolve_device

_MAGIC = b"RZK1"
_VERSION = 1
# code 3 (int64) carries wide-ring residues (modulus >= 2^32); RAW-encoded
# only -- the varint path stays int32-native
_DTYPES = {0: np.int32, 1: np.uint32, 2: np.bool_, 3: np.int64}
_DTYPE_CODES = {
    np.dtype(np.int32): 0,
    np.dtype(np.uint32): 1,
    np.dtype(np.bool_): 2,
    np.dtype(np.int64): 3,
}

RAW = 0
TRIMMED_VARINT = 1

# NamedTuple fields the port holds as int32 bit patterns of uint32 lanes,
# which the JAX package holds (and the wire carries) as uint32
UINT32_FIELDS = {CommitmentKey: ("a1_hat", "a2_hat")}


# -- row codec (bincode-analog) ---------------------------------------------


# Row count past which the native encoder fans out across threads (the
# multi-host interchange path serializes 10^4..10^5 proofs at once).
_MT_ROWS = 4096


def encode_rows(a: np.ndarray) -> bytes:
    """Trailing-zero-trimmed zigzag varint encoding of [..., N] int32: per
    row a u32 count of the coefficients kept (up to the last nonzero one),
    then each kept coefficient as a zigzag LEB128 varint. Runs the native
    codec, on min(8, cores) threads from :data:`_MT_ROWS` rows up."""
    a2d = np.ascontiguousarray(a, np.int32).reshape(-1, a.shape[-1])
    threads = min(8, os.cpu_count() or 1) if a2d.shape[0] >= _MT_ROWS else 1
    return runtime.encode_rows(a2d, threads)


def decode_rows(buf: bytes, shape) -> np.ndarray:
    """Inverse of :func:`encode_rows` into an int32 array of ``shape``,
    through the native codec. Raises ValueError on a corrupt stream, as
    :func:`_decode_rows_numpy` does and with its words: a row count above
    the row length, a varint longer than 5 bytes or past 32 bits, or a
    payload that ends early (trailing bytes are ignored)."""
    shape, n_rows = _rows_of(shape)
    return runtime.decode_rows(buf, n_rows, shape[-1]).reshape(shape)


def _rows_of(shape) -> tuple:
    """(shape, number of rows) of a varint entry, which needs a row axis."""
    shape = tuple(shape)
    if not shape:
        raise ValueError("corrupt wire payload: a varint entry needs a row axis")
    return shape, int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) > 1 else 1


def _encode_rows_numpy(a: np.ndarray) -> bytes:
    """The plain version of :func:`encode_rows`, vectorized numpy."""
    a2d = np.ascontiguousarray(a, np.int32).reshape(-1, a.shape[-1])
    rows, n = a2d.shape
    kept = np.where(a2d != 0, np.arange(1, n + 1), 0).max(1, initial=0)
    v = a2d.astype(np.int64)
    z = ((v << 1) ^ (v >> 31)) & 0xFFFFFFFF
    nbytes = 1 + sum((z >= 1 << (7 * j)).astype(np.int64) for j in (1, 2, 3, 4))
    nbytes[np.arange(n)[None, :] >= kept[:, None]] = 0
    row_len = 4 + nbytes.sum(1)
    row_start = np.concatenate([[0], np.cumsum(row_len)[:-1]]).astype(np.int64)
    out = np.zeros(int(row_len.sum()), np.uint8)
    heads = row_start[:, None] + np.arange(4)
    out[heads] = kept.astype("<u4").view(np.uint8).reshape(rows, 4)
    # each coefficient's first byte, after its row's header and the bytes
    # of the coefficients before it
    first = (row_start + 4)[:, None] + np.cumsum(nbytes, 1) - nbytes
    for j in range(5):
        sel = nbytes > j
        byte = (z[sel] >> (7 * j)) & 0x7F
        out[first[sel] + j] = byte | np.where(nbytes[sel] > j + 1, 0x80, 0)
    return out.tobytes()


def _decode_rows_numpy(buf: bytes, shape) -> np.ndarray:
    """The plain version of :func:`decode_rows`, vectorized numpy. Raises
    ValueError on a corrupt stream: a row count above the row length, a
    varint longer than 5 bytes or past 32 bits, or a payload that ends
    early (trailing bytes are ignored, as the JAX codec ignores them)."""
    shape, n_rows = _rows_of(shape)
    row_len = shape[-1]
    b = np.frombuffer(buf, np.uint8)
    ends = np.flatnonzero(b < 0x80)      # candidate varint terminators
    # the row headers, in order (each row's start depends on the rows
    # before it): its count, its first varint byte, its first terminator
    heads = []
    pos = 0
    for r in range(n_rows):
        if pos + 4 > b.size:
            raise ValueError("corrupt wire payload: truncated row header")
        kept = int.from_bytes(buf[pos:pos + 4], "little")
        pos += 4
        if kept > row_len:
            raise ValueError("corrupt row: kept > row_len")
        if kept:
            i = int(np.searchsorted(ends, pos))
            if i + kept > ends.size:
                raise ValueError("corrupt wire payload: truncated varints")
            heads.append((r, kept, pos, i))
            pos = int(ends[i + kept - 1]) + 1
    data = np.zeros((n_rows, row_len), np.int32)
    if not heads:
        return data.reshape(shape)
    rows, kepts, starts, firsts = (np.asarray(c, np.int64) for c in zip(*heads))
    # every coefficient: its row, its column, its first and last byte
    offs = np.cumsum(kepts) - kepts
    col = np.arange(int(kepts.sum())) - np.repeat(offs, kepts)
    last = ends[np.repeat(firsts, kepts) + col]
    first = np.empty_like(last)
    first[1:] = last[:-1] + 1
    first[offs] = starts
    length = last - first + 1
    if (length > 5).any():
        raise ValueError("corrupt varint")
    z = np.zeros(last.size, np.int64)
    for j in range(int(length.max())):
        has = length > j
        z[has] |= (b[first[has] + j].astype(np.int64) & 0x7F) << (7 * j)
    if (z >= 2**32).any():                       # a fifth byte above 0x0F
        raise ValueError("corrupt varint")
    val = (z >> 1) ^ (-(z & 1) & 0xFFFFFFFF)     # un-zigzag, uint32
    data[np.repeat(rows, kepts), col] = np.where(val >= 2**31, val - 2**32, val)
    return data.reshape(shape)


# -- container ---------------------------------------------------------------


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array: tensors are copied off their device."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree, prefix=""):
    """Deterministic (path, leaf) flattening of NamedTuple/dict/list trees,
    the JAX package's paths and order; leaves as host numpy arrays."""
    if hasattr(tree, "_fields"):  # NamedTuple
        as_u32 = UINT32_FIELDS.get(type(tree), ())
        for f in tree._fields:
            leaf = getattr(tree, f)
            if f in as_u32 and isinstance(leaf, torch.Tensor):
                yield (f"{prefix}{f}", _host(leaf).view(np.uint32))
            else:
                yield from _flatten_with_paths(leaf, f"{prefix}{f}.")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_paths(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(v, f"{prefix}{i}.")
    elif tree is None:
        yield (prefix + "__none__", None)
    else:
        yield (prefix.rstrip("."), _host(tree))


def dumps(tree: Any, compact: bool = True) -> bytes:
    """Serialize a protocol object to the RZK1 wire format."""
    entries = list(_flatten_with_paths(tree))
    out = bytearray()
    out += _MAGIC
    out += struct.pack("<HI", _VERSION, len(entries))
    for path, leaf in entries:
        pb = path.encode()
        out += struct.pack("<H", len(pb)) + pb
        if leaf is None:
            out += struct.pack("<BBB", 255, 0, 0) + struct.pack("<Q", 0)
            continue
        code = _DTYPE_CODES.get(leaf.dtype)
        if code is None:
            raise TypeError(f"unsupported dtype {leaf.dtype} at {path}")
        enc = TRIMMED_VARINT if (compact and code == 0 and leaf.ndim >= 1) else RAW
        out += struct.pack("<BBB", code, enc, leaf.ndim)
        out += b"".join(struct.pack("<I", d) for d in leaf.shape)
        payload = (
            encode_rows(leaf) if enc == TRIMMED_VARINT
            else np.ascontiguousarray(leaf).astype(leaf.dtype, copy=False).tobytes()
        )
        out += struct.pack("<Q", len(payload)) + payload
    return bytes(out)


def loads(buf: bytes, max_array_bytes: int = 2**31) -> dict:
    """Deserialize to a {path: np.ndarray} dict (structure-agnostic; use
    :func:`rebuild` to get typed objects on a device).

    Raises ValueError on any malformed input (bad magic/version, truncated
    header or payload, corrupt varint stream, inconsistent dtype/encoding
    pair, RAW payload length not matching its declared shape, or a declared
    array larger than ``max_array_bytes``) -- failure detection is a clean
    exception, never silent garbage, a leaked struct/index error, or an
    attacker-sized allocation. ``max_array_bytes`` (default 2 GiB) bounds
    the decoded size a hostile shape header can demand *before* any
    allocation happens; callers moving larger checkpoints pass a higher
    limit explicitly. A varint entry's payload can be much smaller than its
    decoded array (all-zero rows trim to 4 bytes each), so the allocation
    bound is the shape header, not the payload length.
    """
    if buf[:4] != _MAGIC:
        raise ValueError("bad magic")
    try:
        return _loads_body(buf, max_array_bytes)
    except (struct.error, IndexError, UnicodeDecodeError) as e:
        raise ValueError(f"truncated or corrupt RZK1 container: {e}") from e


def _loads_body(buf: bytes, max_array_bytes: int) -> dict:
    version, n = struct.unpack_from("<HI", buf, 4)
    if version != _VERSION:
        raise ValueError(f"unsupported version {version}")
    pos = 10
    out = {}
    for _ in range(n):
        (plen,) = struct.unpack_from("<H", buf, pos)
        pos += 2
        path = buf[pos : pos + plen].decode()
        pos += plen
        code, enc, ndim = struct.unpack_from("<BBB", buf, pos)
        pos += 3
        if code == 255:
            pos += 8
            out[path] = None
            continue
        if code not in _DTYPES:
            raise ValueError(f"unknown dtype code {code} at {path}")
        if enc not in (RAW, TRIMMED_VARINT):
            raise ValueError(f"unknown encoding {enc} at {path}")
        if enc == TRIMMED_VARINT and code != 0:
            raise ValueError(f"varint encoding requires int32 at {path}")
        shape = tuple(
            struct.unpack_from("<I", buf, pos + 4 * i)[0] for i in range(ndim)
        )
        pos += 4 * ndim
        (plen8,) = struct.unpack_from("<Q", buf, pos)
        pos += 8
        if pos + plen8 > len(buf):
            raise ValueError(f"payload of {path} extends past the buffer")
        nbytes = int(np.prod(shape, dtype=object)) * np.dtype(_DTYPES[code]).itemsize
        if nbytes > max_array_bytes:
            raise ValueError(
                f"declared array at {path} is {nbytes} bytes "
                f"(> max_array_bytes={max_array_bytes})"
            )
        if enc == TRIMMED_VARINT and shape:
            n_rows = int(np.prod(shape[:-1], dtype=object)) if len(shape) > 1 else 1
            if n_rows * 4 > plen8:
                raise ValueError(f"row count of {path} exceeds its payload")
        if enc == RAW and plen8 != nbytes:
            raise ValueError(
                f"RAW payload of {path} is {plen8} bytes, expected {nbytes}"
            )
        payload = buf[pos : pos + plen8]
        pos += plen8
        if enc == TRIMMED_VARINT:
            out[path] = decode_rows(payload, shape)
        else:
            out[path] = np.frombuffer(payload, _DTYPES[code]).reshape(shape).copy()
    return out


def _unwrap_optional(typ):
    """Optional[T] / Union[T, None] -> T; anything else unchanged."""
    if typing.get_origin(typ) is typing.Union:
        args = [a for a in typing.get_args(typ) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return typ


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A wire array as the port holds it: uint32 lanes as int32 bit
    patterns, every other dtype as itself."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def rebuild(cls, data: dict, prefix: str = "", device=None):
    """Rebuild a typed NamedTuple (possibly nested) from a :func:`loads`
    dict, its tensors on ``device`` (default: the CUDA card).

    Generic over the protocol surface: field types are resolved from the
    class's annotations, and any field whose (Optional-unwrapped) type is
    itself a NamedTuple -- Commitment, Opening, or a whole message family
    -- is rebuilt recursively. A dict that the JAX package's ``loads`` made
    from its own bytes rebuilds into the port's object the same way.
    """
    device = resolve_device(device)
    try:
        hints = typing.get_type_hints(cls)
    except NameError:  # pragma: no cover - unresolvable forward refs
        hints = dict(getattr(cls, "__annotations__", {}))
    kwargs = {}
    for f in cls._fields:
        key = f"{prefix}{f}"
        sub_prefix = f"{prefix}{f}."
        inner = _unwrap_optional(hints.get(f))
        if isinstance(inner, type) and hasattr(inner, "_fields"):
            if f"{sub_prefix}__none__" in data:
                kwargs[f] = None
            else:
                kwargs[f] = rebuild(inner, data, sub_prefix, device)
        elif key in data:
            kwargs[f] = None if data[key] is None else _tensor(np.asarray(data[key]), device)
        elif f"{sub_prefix}__none__" in data:
            kwargs[f] = None
        else:
            raise KeyError(f"missing field {key}")
    return cls(**kwargs)
