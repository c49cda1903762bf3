"""ctypes wrapper over the native C client library
(native/evql_client.c — the analog of the reference's libeventql C API,
reference: src/eventql/eventql.h:160-298 + client.c).

Python callers should normally use NativeTCPClient; this wrapper exists
to exercise and expose the C library, which non-Python programs link
directly."""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB = None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    from eventql_tpu.columnar.native import build_native

    path = os.path.abspath(os.path.join(_NATIVE_DIR, "build", "libevql_client.so"))
    if not build_native("libevql_client.so"):
        return None
    lib = ctypes.CDLL(path)
    lib.evql_client_init.restype = ctypes.c_void_p
    lib.evql_client_connect.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint,
        ctypes.c_char_p, ctypes.c_long,
    ]
    lib.evql_client_setauth.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_long,
    ]
    lib.evql_query.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
    ]
    lib.evql_fetch_row.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char_p)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_size_t)),
    ]
    lib.evql_num_columns.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    ]
    lib.evql_column_name.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.evql_next_result.argtypes = [ctypes.c_void_p]
    lib.evql_client_geterror.argtypes = [ctypes.c_void_p]
    lib.evql_client_geterror.restype = ctypes.c_char_p
    lib.evql_client_close.argtypes = [ctypes.c_void_p]
    lib.evql_client_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


class CClientError(Exception):
    pass


class CClient:
    """High-level handle over the C library."""

    def __init__(self, host: str, port: int, database: str = "",
                 auth_token: str = ""):
        lib = _load()
        if lib is None:
            raise CClientError("libevql_client.so unavailable")
        self._lib = lib
        self._c = lib.evql_client_init()
        if auth_token:
            tok = auth_token.encode()
            lib.evql_client_setauth(
                self._c, b"auth_token", len(b"auth_token"), tok, len(tok), 0
            )
        rc = lib.evql_client_connect(
            self._c, host.encode(), port, database.encode(), 0
        )
        if rc != 0:
            err = lib.evql_client_geterror(self._c).decode()
            lib.evql_client_destroy(self._c)
            self._c = None
            raise CClientError(err)

    def query(
        self, sql: str, flags: int = 0
    ) -> List[Tuple[List[str], List[List[str]]]]:
        # flags: EVQL_QUERY_* bits (reference eventql.h:114-117;
        # 0x4 = SENDPROGRESS enables QUERY_PROGRESS frames)
        lib = self._lib
        results = []
        rc = lib.evql_query(self._c, sql.encode(), b"", flags)
        if rc != 0:
            raise CClientError(lib.evql_client_geterror(self._c).decode())
        while True:
            ncols = ctypes.c_size_t()
            lib.evql_num_columns(self._c, ctypes.byref(ncols))
            cols = []
            for i in range(ncols.value):
                name = ctypes.c_char_p()
                nlen = ctypes.c_size_t()
                lib.evql_column_name(
                    self._c, i, ctypes.byref(name), ctypes.byref(nlen)
                )
                cols.append(
                    ctypes.string_at(name, nlen.value).decode()
                    if name.value is not None else ""
                )
            rows = []
            fields = ctypes.POINTER(ctypes.c_char_p)()
            lens = ctypes.POINTER(ctypes.c_size_t)()
            while True:
                rc = lib.evql_fetch_row(
                    self._c, ctypes.byref(fields), ctypes.byref(lens)
                )
                if rc < 0:
                    raise CClientError(
                        lib.evql_client_geterror(self._c).decode()
                    )
                if rc == 0:
                    break
                row = []
                for i in range(ncols.value):
                    row.append(
                        ctypes.string_at(fields[i], lens[i]).decode()
                    )
                rows.append(row)
            results.append((cols, rows))
            rc = lib.evql_next_result(self._c)
            if rc < 0:
                raise CClientError(lib.evql_client_geterror(self._c).decode())
            if rc == 0:
                return results

    def close(self):
        if self._c is not None:
            self._lib.evql_client_close(self._c)
            self._lib.evql_client_destroy(self._c)
            self._c = None
