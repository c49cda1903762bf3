"""ctypes bindings for the native (C++) columnar codec.

Loads native/build/libeventql_native.so, building it on first use if a
toolchain is available. All entry points have numpy fallbacks in
eventql_tpu.columnar.cstable; the native path is the production ingest
codec (the reference's equivalent decoders are C++:
io/cstable/columns/*, util/util/BitPackDecoder.cc).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO_PATH = os.path.abspath(
    os.path.join(_NATIVE_DIR, "build", "libeventql_native.so")
)

_lib = None
_load_failed = False


def build_native(target: str) -> bool:
    """Build native/build/<target> (and the rest of native/) with make
    unless it exists. Concurrent processes (test workers, servers)
    serialize on a file lock, so one runs make and the others find its
    output. Returns whether the target exists afterwards."""
    import fcntl

    native_dir = os.path.abspath(_NATIVE_DIR)
    path = os.path.join(native_dir, "build", target)
    if os.path.exists(path):
        return True
    with open(os.path.join(native_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            try:
                subprocess.run(
                    ["make", "-C", native_dir],
                    check=True,
                    capture_output=True,
                    timeout=300,
                )
            except (subprocess.SubprocessError, FileNotFoundError):
                pass
    return os.path.exists(path)


def _try_load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if os.environ.get("EVENTQL_TPU_NO_NATIVE") == "1":
        _load_failed = True
        return None
    if not build_native("libeventql_native.so"):
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        _load_failed = True
        return None

    lib.evql_simdbp128_unpack.restype = ctypes.c_int
    lib.evql_simdbp128_unpack.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_uint32,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.evql_leb128_decode.restype = ctypes.c_int64
    lib.evql_leb128_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.evql_leb128_encode.restype = ctypes.c_int64
    lib.evql_leb128_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.evql_lenenc_strings.restype = ctypes.c_int64
    lib.evql_lenenc_strings.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.evql_json_shred.restype = ctypes.c_void_p
    lib.evql_json_shred.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.evql_records_shred.restype = ctypes.c_void_p
    lib.evql_records_shred.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.evql_shred_rids.restype = ctypes.c_int
    lib.evql_shred_rids.argtypes = [
        ctypes.c_void_p,
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.evql_shred_status.restype = ctypes.c_int
    lib.evql_shred_status.argtypes = [ctypes.c_void_p]
    lib.evql_shred_nrows.restype = ctypes.c_uint64
    lib.evql_shred_nrows.argtypes = [ctypes.c_void_p]
    lib.evql_shred_error.restype = ctypes.c_char_p
    lib.evql_shred_error.argtypes = [ctypes.c_void_p]
    for getter in ("num", "valid", "stroff", "strbytes"):
        fn = getattr(lib, f"evql_shred_{getter}")
        fn.restype = ctypes.c_void_p
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.evql_shred_free.restype = None
    lib.evql_shred_free.argtypes = [ctypes.c_void_p]
    lib.evql_sha1_rows.restype = ctypes.c_int
    lib.evql_sha1_rows.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64,
        ctypes.c_char_p,
    ]
    lib.evql_record_ids_u64.restype = ctypes.c_int
    lib.evql_record_ids_u64.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_char_p,
    ]
    lib.evql_record_ids_i64.restype = ctypes.c_int
    lib.evql_record_ids_i64.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_char_p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _try_load() is not None


def simdbp128_unpack(buf: bytes, n: int, maxbits: int) -> Optional[np.ndarray]:
    lib = _try_load()
    if lib is None:
        return None
    out = np.zeros(n, dtype=np.uint32)
    rc = lib.evql_simdbp128_unpack(
        buf,
        len(buf),
        maxbits,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    if rc != 0:
        return None
    return out


def leb128_decode(buf: bytes, count: int) -> Optional[np.ndarray]:
    lib = _try_load()
    if lib is None:
        return None
    out = np.zeros(count, dtype=np.uint64)
    rc = lib.evql_leb128_decode(
        buf, len(buf), count, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    )
    if rc < 0:
        return None
    return out


def leb128_encode(values: np.ndarray):
    """C LEB128 encoder (None when the native lib is unavailable; the
    caller falls back to the Python encoder). The segment flush
    encodes every integer column this way — the Python per-byte
    version was 66% of the insert wall (PERF.md insert ladder)."""
    lib = _try_load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(values, dtype=np.uint64)
    n = len(vals)
    if n == 0:
        return b""
    out = np.empty(n * 10, dtype=np.uint8)
    written = lib.evql_leb128_encode(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out[:written].tobytes()


def lenenc_strings(buf: bytes, count: int):
    lib = _try_load()
    if lib is None:
        return None
    offsets = np.zeros(count, dtype=np.uint64)
    lengths = np.zeros(count, dtype=np.uint32)
    rc = lib.evql_lenenc_strings(
        buf,
        len(buf),
        count,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    if rc < 0:
        return None
    return offsets, lengths


class ShredError(Exception):
    """A row-level insert error from the native shredder, carrying the
    count of rows shredded before the failing row (Python's per-row
    insert applies rows before the error) and Python's exact message."""

    def __init__(self, message: str, rows_before_error: int, partial=None):
        super().__init__(message)
        self.rows_before_error = rows_before_error
        # (nrows, cols) of the successfully shredded prefix
        self.partial = partial


def _extract_cols(lib, h, stypes, nrows):
    cols = []
    for i, st in enumerate(stypes):
        nv = int(nrows)
        valid = np.ctypeslib.as_array(
            ctypes.cast(
                lib.evql_shred_valid(h, i), ctypes.POINTER(ctypes.c_uint8)
            ),
            shape=(nv,),
        ).copy() if nv else np.zeros(0, np.uint8)
        if int(st) == 5:  # STRING
            off = np.ctypeslib.as_array(
                ctypes.cast(
                    lib.evql_shred_stroff(h, i),
                    ctypes.POINTER(ctypes.c_uint32),
                ),
                shape=(nv + 1,),
            ).copy()
            nbytes = int(off[-1]) if nv else 0
            if nbytes:
                raw = ctypes.string_at(lib.evql_shred_strbytes(h, i), nbytes)
            else:
                raw = b""
            cols.append((off, raw, valid))
        else:
            vals = np.ctypeslib.as_array(
                ctypes.cast(
                    lib.evql_shred_num(h, i),
                    ctypes.POINTER(ctypes.c_uint64),
                ),
                shape=(nv,),
            ).copy() if nv else np.zeros(0, np.uint64)
            cols.append((vals, valid))
    return cols


def records_shred(buf: bytes, count: int, names, stypes, pk_idx=None):
    """Shred `count` lenenc-framed JSON records (a native-protocol
    INSERT frame's record region) into typed columns, computing
    primary-key record ids in the same pass when pk_idx is given.

    Returns (nrows, cols, rids, complete):
      nrows    — rows shredded (== count when complete)
      cols     — per-column buffers, same layout as json_shred
      rids     — list of 20-byte SHA1 record ids (None when pk_idx is
                 None or a pk column type has no native wire encoding)
      complete — False when a record needs the Python path (error,
                 fallback value, malformed framing): the caller resumes
                 at record index `nrows` with the per-record path,
                 reproducing the exact Python error/conversion there
    or None when the native library is unavailable."""
    lib = _try_load()
    if lib is None:
        return None
    ncols = len(names)
    name_arr = (ctypes.c_char_p * ncols)(
        *[n.encode("utf-8") for n in names]
    )
    type_arr = (ctypes.c_uint32 * ncols)(*[int(t) for t in stypes])
    h = lib.evql_records_shred(
        buf, len(buf), count, ncols, name_arr, type_arr
    )
    if not h:
        return None
    try:
        status = lib.evql_shred_status(h)
        nrows = int(lib.evql_shred_nrows(h))
        cols = _extract_cols(lib, h, stypes, nrows)
        rids = None
        if pk_idx is not None and nrows:
            npk = len(pk_idx)
            pk_arr = (ctypes.c_uint32 * npk)(*[int(i) for i in pk_idx])
            out = np.zeros(nrows * 20, dtype=np.uint8)
            ok = lib.evql_shred_rids(
                h, npk, pk_arr,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
            if ok:
                raw = out.tobytes()
                rids = [raw[i * 20 : i * 20 + 20] for i in range(nrows)]
        return nrows, cols, rids, status == 0
    finally:
        lib.evql_shred_free(h)


def json_shred(json_bytes: bytes, names, stypes):
    """Shred a JSON array of flat records into typed columns.

    Returns (nrows, cols) where cols[i] is
      (values_u64, valid_u8)            for numeric/bool columns, or
      (offsets_u32, bytes, valid_u8)    for string columns,
    or None when the native library is unavailable or the batch needs
    the Python path (nested values, big ints, exotic float syntax).
    Raises ShredError for genuine row errors (unknown column,
    non-convertible value) with Python's message.
    """
    lib = _try_load()
    if lib is None:
        return None
    ncols = len(names)
    name_arr = (ctypes.c_char_p * ncols)(
        *[n.encode("utf-8") for n in names]
    )
    type_arr = (ctypes.c_uint32 * ncols)(*[int(t) for t in stypes])
    h = lib.evql_json_shred(
        json_bytes, len(json_bytes), ncols, name_arr, type_arr
    )
    if not h:
        return None
    try:
        status = lib.evql_shred_status(h)
        if status in (2, 3):  # FALLBACK / BAD_INPUT → Python decides
            return None
        nrows = lib.evql_shred_nrows(h)
        cols = []
        for i, st in enumerate(stypes):
            nv = int(nrows)
            valid = np.ctypeslib.as_array(
                ctypes.cast(
                    lib.evql_shred_valid(h, i), ctypes.POINTER(ctypes.c_uint8)
                ),
                shape=(nv,),
            ).copy() if nv else np.zeros(0, np.uint8)
            if int(st) == 5:  # STRING
                off = np.ctypeslib.as_array(
                    ctypes.cast(
                        lib.evql_shred_stroff(h, i),
                        ctypes.POINTER(ctypes.c_uint32),
                    ),
                    shape=(nv + 1,),
                ).copy()
                nbytes = int(off[-1]) if nv else 0
                if nbytes:
                    raw = ctypes.string_at(lib.evql_shred_strbytes(h, i), nbytes)
                else:
                    raw = b""
                cols.append((off, raw, valid))
            else:
                vals = np.ctypeslib.as_array(
                    ctypes.cast(
                        lib.evql_shred_num(h, i),
                        ctypes.POINTER(ctypes.c_uint64),
                    ),
                    shape=(nv,),
                ).copy() if nv else np.zeros(0, np.uint64)
                cols.append((vals, valid))
        if status == 1:  # ROW_ERROR
            raise ShredError(
                lib.evql_shred_error(h).decode("utf-8", "replace"),
                int(nrows),
                partial=(int(nrows), cols),
            )
        return int(nrows), cols
    finally:
        lib.evql_shred_free(h)


def sha1_rows(payload: bytes, offsets: np.ndarray) -> Optional[np.ndarray]:
    """SHA1 digests of n packed rows (offsets: uint64[n+1]); returns a
    (n, 20) uint8 array or None when the native lib is unavailable.
    The insert path's record ids (reference computes them in C++,
    db/table_service.cc:795-837)."""
    lib = _try_load()
    if lib is None:
        return None
    n = len(offsets) - 1
    out = np.empty(n * 20, dtype=np.uint8)
    off = np.ascontiguousarray(offsets, dtype=np.uint64)
    rc = lib.evql_sha1_rows(
        payload,
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n,
        out.ctypes.data_as(ctypes.c_char_p),
    )
    if rc != 0:
        return None
    return out.reshape(n, 20)


def record_ids_numeric(data: np.ndarray, valid: np.ndarray) -> Optional[np.ndarray]:
    """Record ids for a single numeric primary-key column: SHA1 of the
    decimal wire string per row ("" for NULL). (n, 20) uint8 or None."""
    lib = _try_load()
    if lib is None:
        return None
    n = len(data)
    out = np.empty(n * 20, dtype=np.uint8)
    v = np.ascontiguousarray(valid, dtype=np.uint8)
    if data.dtype == np.uint64:
        d = np.ascontiguousarray(data)
        rc = lib.evql_record_ids_u64(
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            v.ctypes.data_as(ctypes.c_char_p),
            n,
            out.ctypes.data_as(ctypes.c_char_p),
        )
    elif data.dtype == np.int64:
        d = np.ascontiguousarray(data)
        rc = lib.evql_record_ids_i64(
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            v.ctypes.data_as(ctypes.c_char_p),
            n,
            out.ctypes.data_as(ctypes.c_char_p),
        )
    else:
        return None
    if rc != 0:
        return None
    return out.reshape(n, 20)
