"""Native binary TCP protocol — server and client.

Wire-compatible implementation of the reference's framed TCP protocol
(reference: doc/internals/binary_protocol.txt, opcodes
src/eventql/eventql.h:71-100, frame payload layouts
transport/native/frames/*.cc):

  frame   = {opcode u16 BE}{flags u16 BE}{length u32 BE}{payload}
  varint  = LEB128; lenencstr = varint length + bytes

  HELLO        varint protover=1, lenencstr version, varint flags,
               varint idle_timeout, varint authdata_len + blob,
               [lenencstr database if flags & SWITCHDB]
  READY        varint 0, varint idle_timeout
  ERROR        lenencstr message
  QUERY        lenencstr query, varint flags, varint maxrows,
               [lenencstr database if flags & SWITCHDB]
  QUERY_RESULT varint flags, varint ncols, varint nrows, 4x varint
               stats, ncols lenencstr names, rows as lenencstr cells
  INSERT       varint flags, lenencstr database, lenencstr table,
               varint encoding (1=JSON), varint count, records

The handshake and request loop mirror transport/native/server.cc
(HELLO→READY, then one request at a time, QUERY_NEXT advancing
multi-statement queries).
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from typing import List, Optional, Tuple

from eventql_tpu.core.errors import ProtocolDesyncError, SQLError

# opcodes (reference: eventql.h:71-100)
OP_HELLO = 0x5E00
OP_PING = 0x0001
OP_HEARTBEAT = 0x0002
OP_ERROR = 0x0003
OP_READY = 0x0004
OP_BYE = 0x0005
OP_QUERY = 0x0006
OP_QUERY_RESULT = 0x0007
OP_QUERY_CONTINUE = 0x0008
OP_QUERY_DISCARD = 0x0009
OP_QUERY_PROGRESS = 0x000A
OP_QUERY_NEXT = 0x000B
OP_ACK = 0x000F
OP_INSERT = 0x0010
OP_REPL_INSERT = 0x0110
OP_QUERY_PARTIALAGGR = 0x0101
OP_QUERY_PARTIALAGGR_RESULT = 0x0102
OP_QUERY_REMOTE = 0x0103
OP_QUERY_REMOTE_RESULT = 0x0104
# metadata ops (reference: eventql.h:89-100, transport/native/ops/meta_*.cc);
# payloads here are lenencstr JSON documents (our plan/row payload
# encodings diverge from the reference the same way)
OP_META_PERFORMOP = 0x0200
OP_META_PERFORMOP_RESULT = 0x0201
OP_META_CREATEFILE = 0x0202
OP_META_GETFILE = 0x0203
OP_META_GETFILE_RESULT = 0x0204
OP_META_DISCOVER = 0x0205
OP_META_DISCOVER_RESULT = 0x0206
OP_META_LISTPARTITIONS = 0x0207
OP_META_LISTPARTITIONS_RESULT = 0x0208
OP_META_FINDPARTITION = 0x0209
OP_META_FINDPARTITION_RESULT = 0x020A
# extension (no reference opcode): drop an aborted CAS txn file; the
# reference leaves orphans for GC, we clean them up eagerly
OP_META_DROPFILE = 0x02F0

F_ENDOFREQUEST = 0x1

HELLO_SWITCHDB = 0x2
# query flags (reference: eventql.h:114-117)
QUERY_SWITCHDB = 0x1
QUERY_MULTISTMT = 0x2
QUERY_SENDPROGRESS = 0x4
QUERY_NOSTATS = 0x8
# extension: execute against this node's local tables only (no cluster
# fan-out) — used for server-to-server DDL broadcast and schema
# lookups; deliberately above the reference's flag range
QUERY_LOCALONLY = 0x40
QR_COMPLETE = 0x1
QR_HASSTATS = 0x2
QR_HASCOLNAMES = 0x4
QR_PENDINGSTMT = 0x8

INSERT_CTYPE_JSON = 0x01
# extension: insert into this node's local tables only (no partition
# routing) — set on coordinator-to-replica writes
INSERT_LOCALONLY = 0x40


# -- varint / lenencstr codecs ---------------------------------------------


def write_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, pos


def write_lenencstr(s: bytes) -> bytes:
    return write_varint(len(s)) + s


# precomputed 1- and 2-byte varint prefixes (bulk framing fast path)
_VARINT1 = [bytes([i]) for i in range(128)]


class _Varint2Table:
    __slots__ = ("_cache",)

    def __init__(self):
        self._cache = {}

    def __getitem__(self, v: int) -> bytes:
        b = self._cache.get(v)
        if b is None:
            b = self._cache[v] = write_varint(v)
        return b


_VARINT2 = _Varint2Table()


def read_lenencstr(buf: bytes, pos: int) -> Tuple[bytes, int]:
    n, pos = read_varint(buf, pos)
    return buf[pos : pos + n], pos + n


# frame size limits (reference: transport/native/connection.h:34-35 —
# kMaxFrameSize 256 MB hard cap on any received frame, kMaxFrameSizeSoft
# 32 MB at which the server flushes a result frame mid-statement)
MAX_FRAME_SIZE = 256 * 1024 * 1024
MAX_FRAME_SIZE_SOFT = 32 * 1024 * 1024


def _send_frame(sock, opcode: int, flags: int, payload: bytes):
    sock.sendall(struct.pack(">HHI", opcode, flags, len(payload)) + payload)


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed")
        buf += chunk
    return buf


def _recv_frame(sock) -> Tuple[int, int, bytes]:
    header = _recv_exact(sock, 8)
    opcode, flags, length = struct.unpack(">HHI", header)
    if length > MAX_FRAME_SIZE:
        # reference: connection_tcp.cc:151 closes the connection on an
        # oversized frame rather than attempting to buffer it
        raise ConnectionError("frame too large")
    payload = _recv_exact(sock, length) if length else b""
    return opcode, flags, payload


# -- server -----------------------------------------------------------------


class NativeTCPServer:
    """The native protocol listener (reference:
    transport/native/server.cc; thread per connection like
    db/database.cc:555-573)."""

    def __init__(
        self, table_service, host="127.0.0.1", port=9176,
        query_provider_factory=None, client_auth=None,
        metadata_service=None, query_cache=None,
    ):
        from eventql_tpu.exec.runtime import PlanCache, Runtime
        from eventql_tpu.server.auth import TrustClientAuth

        self.table_service = table_service
        # partial-aggregate result cache (reference: QueryCache on the
        # partition servers, groupby.cc:255-295)
        self.query_cache = query_cache
        self.query_provider_factory = (
            query_provider_factory or (lambda: self.table_service)
        )
        self.metadata_service = metadata_service
        self.client_auth = client_auth or TrustClientAuth()
        # server-side plan cache: repeated queries skip parse+plan
        # (invalidated by the provider's schema version)
        self.runtime = Runtime(plan_cache=PlanCache())
        self.host = host
        self.port = port
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self):
        outer = self
        self._active_conns = set()
        self._conns_lock = threading.Lock()

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                with outer._conns_lock:
                    outer._active_conns.add(self.request)
                try:
                    outer._handle_connection(self.request)
                except (ConnectionError, OSError):
                    pass
                finally:
                    with outer._conns_lock:
                        outer._active_conns.discard(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            # connection threads must not block shutdown: a peer holding
            # a pooled connection open would wedge server_close()'s join
            daemon_threads = True
            block_on_close = False

        self._server = Server((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            # a stopped server must stop SERVING, not just listening:
            # peers holding pooled connections would otherwise keep
            # getting responses from live handler threads
            with self._conns_lock:
                conns = list(self._active_conns)
                self._active_conns.clear()
            for s in conns:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass

    # server-side idle timeout (reference: server.c2s_idle_timeout)
    IDLE_TIMEOUT = 300.0

    # -- connection loop ------------------------------------------------
    def _handle_connection(self, sock):
        sock.settimeout(self.IDLE_TIMEOUT)
        # request-response protocol: Nagle + delayed ACK would stall
        # any frame spanning two writes
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # handshake: expect HELLO, answer READY
        opcode, flags, payload = _recv_frame(sock)
        if opcode != OP_HELLO:
            _send_frame(
                sock, OP_ERROR, F_ENDOFREQUEST, write_lenencstr(b"expected HELLO")
            )
            return
        pos = 0
        ver, pos = read_varint(payload, pos)
        if ver != 1:
            _send_frame(
                sock,
                OP_ERROR,
                F_ENDOFREQUEST,
                write_lenencstr(b"invalid protocol version"),
            )
            return
        _version, pos = read_lenencstr(payload, pos)
        _hflags, pos = read_varint(payload, pos)
        idle_timeout, pos = read_varint(payload, pos)

        # authdata: varint length + "key\0value\0..." pairs
        # (reference: transport/native/frames/hello.cc:97-110; auth check
        # server.cc:156-185)
        auth_data = {}
        if pos < len(payload):
            alen, pos = read_varint(payload, pos)
            if alen:
                parts = payload[pos : pos + alen].split(b"\x00")
                pos += alen
                for i in range(0, len(parts) - 1, 2):
                    auth_data[parts[i].decode()] = parts[i + 1].decode()
        from eventql_tpu.server.auth import AuthError

        try:
            self.client_auth.authenticate(auth_data)
        except AuthError as e:
            _send_frame(
                sock,
                OP_ERROR,
                F_ENDOFREQUEST,
                write_lenencstr(str(e).encode("utf-8")),
            )
            return

        _send_frame(
            sock, OP_READY, 0, write_varint(0) + write_varint(idle_timeout)
        )

        while True:
            opcode, flags, payload = _recv_frame(sock)
            if opcode == OP_BYE:
                return
            if opcode == OP_PING:
                _send_frame(sock, OP_PING, 0, b"")
                continue
            if opcode == OP_QUERY:
                self._handle_query(sock, payload)
            elif opcode == OP_INSERT:
                self._handle_insert(sock, payload)
            elif opcode == OP_REPL_INSERT:
                self._handle_repl_insert(sock, payload)
            elif opcode == OP_QUERY_PARTIALAGGR:
                self._handle_partialaggr(sock, payload)
            elif opcode == OP_QUERY_REMOTE:
                self._handle_query_remote(sock, payload)
            elif OP_META_PERFORMOP <= opcode <= OP_META_FINDPARTITION or (
                opcode == OP_META_DROPFILE
            ):
                self._handle_meta(sock, opcode, payload)
            else:
                _send_frame(
                    sock,
                    OP_ERROR,
                    F_ENDOFREQUEST,
                    write_lenencstr(b"invalid opcode"),
                )

    # reference: the server emits heartbeat frames while a query runs so
    # idle timeouts don't kill long queries (session heartbeat_interval,
    # transport/native/connection_tcp.cc)
    HEARTBEAT_INTERVAL = 1.0

    def _handle_query(self, sock, payload):
        pos = 0
        query, pos = read_lenencstr(payload, pos)
        qflags, pos = read_varint(payload, pos)
        maxrows, pos = read_varint(payload, pos)
        if maxrows == 0:
            # reference parity: ops/query.cc:64-66 (0 means 1, not
            # unlimited — the reference C client sends 10)
            maxrows = 1

        send_lock = threading.Lock()
        done = threading.Event()
        # heartbeats flow for the whole request — including while
        # result pages stream, since streamable statements now execute
        # LAZILY inside _stream_result (the reference's heartbeat
        # callback fires from inside query execution, ops/query.cc:
        # 68-71, which for us IS the streaming loop). Wire safety:
        # every frame send (heartbeat and result alike) takes
        # send_lock, so frames never interleave mid-write; both the
        # python and C clients skip HEARTBEAT/PROGRESS frames at any
        # point of the result stream.
        executing = threading.Event()
        progress = {"done": 0, "total": 1, "t0": time.monotonic(),
                    "ctx": None}
        want_progress = bool(qflags & QUERY_SENDPROGRESS)

        def heartbeats():
            while not done.wait(self.HEARTBEAT_INTERVAL):
                if not executing.is_set():
                    continue
                try:
                    with send_lock:
                        # re-check under the lock: the main thread's
                        # "clear executing, then take send_lock" barrier
                        # only excludes heartbeats that observe the
                        # cleared flag — a heartbeat that passed the
                        # outer check before the clear must not send
                        # once streaming may have begun
                        if not executing.is_set():
                            continue
                        if want_progress:
                            # real per-query counters + shard-granular
                            # progress (the reference defines these
                            # fields but zeroes them, ops/query.cc:
                            # 91-126, frames/query_progress.cc:63-70;
                            # task counters from the ExecutionContext
                            # analog, execution_context.h:30-54)
                            ctx = progress["ctx"]
                            snap = ctx.snapshot() if ctx else {}
                            if snap.get("num_tasks"):
                                permill = ctx.progress_permill()
                            else:
                                # statement-granular fallback
                                permill = (
                                    1000 * progress["done"]
                                    // progress["total"]
                                )
                            elapsed_ms = int(
                                (time.monotonic() - progress["t0"]) * 1000
                            )
                            body = bytearray()
                            body += write_varint(
                                snap.get("rows_modified", 0)
                            )
                            body += write_varint(
                                snap.get("rows_scanned", 0)
                            )
                            body += write_varint(
                                snap.get("bytes_scanned", 0)
                            )
                            body += write_varint(permill)
                            body += write_varint(elapsed_ms)
                            body += write_varint(0)  # eta
                            _send_frame(
                                sock, OP_QUERY_PROGRESS, 0, bytes(body)
                            )
                        else:
                            _send_frame(sock, OP_HEARTBEAT, 0, b"")
                except OSError:
                    return

        hb = threading.Thread(target=heartbeats, daemon=True)
        hb.start()
        from eventql_tpu.utils.stats import evqld_stats

        evqld_stats().num_queries.incr()
        executing.set()
        try:
            provider = (
                self.table_service
                if qflags & QUERY_LOCALONLY
                else self.query_provider_factory()
            )
            txn = self.runtime.new_transaction(provider)
            # cluster providers are per-request: hand them the query's
            # ExecutionContext so shard fan-outs feed task/row counters
            if hasattr(provider, "_per_partition"):
                provider.exec_ctx = txn.exec_ctx
            plan = self.runtime.build_query_plan(txn, query.decode("utf-8"))
            progress["total"] = max(1, plan.num_queries)
            progress["ctx"] = txn.exec_ctx
        except SQLError as e:
            done.set()
            hb.join()
            _send_frame(
                sock,
                OP_ERROR,
                F_ENDOFREQUEST,
                write_lenencstr(e.message.encode("utf-8")),
            )
            return

        # statements execute lazily, one at a time, with each result
        # streamed in maxrows-row frames before the next statement runs
        # (reference: ops/query.cc:135-230 — the row loop flushes a
        # QUERY_RESULT frame whenever rowcount exceeds maxrows or row
        # bytes exceed the 32 MB soft cap, then blocks on
        # QUERY_CONTINUE/QUERY_DISCARD before producing more rows)
        num = plan.num_queries
        try:
            for i in range(num):
                executing.set()
                try:
                    # streamable shapes return a lazy cursor here and
                    # execute chunk-by-chunk inside _stream_result
                    # (bounded server memory, reference:
                    # result_cursor.h:35-75); blocking shapes execute
                    # eagerly and raise here
                    result = plan.execute_stream(i)
                except SQLError as e:
                    executing.clear()
                    with send_lock:
                        _send_frame(
                            sock,
                            OP_ERROR,
                            F_ENDOFREQUEST,
                            write_lenencstr(e.message.encode("utf-8")),
                        )
                    return
                progress["done"] = i + 1
                # executing STAYS SET through streaming: for streamable
                # statements the actual scan now happens lazily inside
                # _stream_result, and heartbeats/QUERY_PROGRESS must
                # keep flowing during it (both clients skip HEARTBEAT/
                # PROGRESS frames anywhere in the result stream). Every
                # send below takes send_lock, so a heartbeat can only
                # interleave BETWEEN frames, never mid-frame.
                pending = i + 1 < num

                def result_stats():
                    snap = txn.exec_ctx.snapshot()
                    return (
                        snap["rows_modified"],
                        snap["rows_scanned"],
                        snap["bytes_scanned"],
                        int((time.monotonic() - progress["t0"]) * 1000),
                    )

                try:
                    self._stream_result(
                        sock, result, pending, maxrows, result_stats,
                        send_lock=send_lock,
                    )
                except SQLError as e:
                    # lazy chunk execution failed mid-stream: the wire
                    # is at a frame boundary (errors surface between
                    # row appends, before any partial frame write), so
                    # an ERROR frame ends the request cleanly
                    with send_lock:
                        _send_frame(
                            sock,
                            OP_ERROR,
                            F_ENDOFREQUEST,
                            write_lenencstr(e.message.encode("utf-8")),
                        )
                    return
                if pending:
                    # wait for QUERY_NEXT (reference: ops/query.cc:196-230)
                    opcode, _f, _p = _recv_frame(sock)
                    if opcode == OP_QUERY_DISCARD:
                        return
                    if opcode != OP_QUERY_NEXT:
                        _send_frame(
                            sock,
                            OP_ERROR,
                            F_ENDOFREQUEST,
                            write_lenencstr(b"unexpected opcode"),
                        )
                        return
        finally:
            done.set()
            hb.join()

    def _result_header(
        self, result, qflags: int, nrows: int, stats=None
    ) -> bytearray:
        # every frame re-sends column names + stats (reference:
        # frames/query_result.cc:63-97 sets HASCOLNAMES|HASSTATS on
        # each writeTo, not just the first — though the reference
        # hardcodes the four stats to zero; here they carry the
        # query's real rows_modified/rows_scanned/bytes_scanned/
        # runtime_ms from the ExecutionContext)
        body = bytearray()
        body += write_varint(qflags)
        body += write_varint(result.num_columns)
        body += write_varint(nrows)
        for v in stats if stats is not None else (0, 0, 0, 0):
            body += write_varint(v)
        for c in result.columns:
            body += write_lenencstr(c.encode("utf-8"))
        return body

    def _stream_result(
        self, sock, result, pending: bool, maxrows: int, stats_fn=None,
        send_lock=None,
    ):
        """Stream one statement's rows as flow-controlled QUERY_RESULT
        frames; returns True when the statement's final (COMPLETE)
        frame went out. A QUERY_DISCARD between pages abandons the
        remaining rows of THIS statement only — the final frame still
        goes out (with the zero rows accumulated since the flush) and
        multi-statement handling proceeds, exactly like the reference's
        cont=false break (ops/query.cc:160-193).

        Frame boundaries mirror the reference: a row is always appended
        first, THEN the frame flushes when its row count EXCEEDS
        maxrows or its bytes exceed the 32 MB soft cap — so paged
        frames carry maxrows+1 rows (ops/query.cc:150-158)."""
        data = bytearray()
        nrows = 0
        # iter_rows formats lazily: a DISCARD after the first page (or
        # a LIMITed pull) never pays string formatting for the
        # abandoned rows (ResultList defers whole-column sql_tostring)
        row_iter = result.iter_rows() if hasattr(result, "iter_rows") else iter(result.rows)
        for row in row_iter:
            for cell in row:
                data += write_lenencstr(cell.encode("utf-8"))
            nrows += 1
            if nrows > maxrows or len(data) > MAX_FRAME_SIZE_SOFT:
                body = self._result_header(
                    result,
                    QR_HASCOLNAMES | QR_HASSTATS,
                    nrows,
                    stats_fn() if stats_fn else None,
                )
                body += data
                if send_lock is not None:
                    with send_lock:
                        _send_frame(sock, OP_QUERY_RESULT, 0, bytes(body))
                else:
                    _send_frame(sock, OP_QUERY_RESULT, 0, bytes(body))
                data = bytearray()
                nrows = 0
                # block until the client pulls the next page
                # (reference: ops/query.cc:160-193)
                opcode, _f, _p = _recv_frame(sock)
                if opcode == OP_QUERY_DISCARD:
                    break
                if opcode != OP_QUERY_CONTINUE:
                    # reference: unexpected opcode closes the connection
                    sock.close()
                    raise ConnectionError("unexpected opcode")
        qflags = QR_HASCOLNAMES | QR_HASSTATS | QR_COMPLETE
        if pending:
            qflags |= QR_PENDINGSTMT
        body = self._result_header(
            result, qflags, nrows, stats_fn() if stats_fn else None
        )
        body += data
        # ENDOFREQUEST rides every statement-final frame (reference:
        # query_result.cc:91-97 — is_last_ sets it even with a pending
        # statement)
        if send_lock is not None:
            with send_lock:
                _send_frame(
                    sock, OP_QUERY_RESULT, F_ENDOFREQUEST, bytes(body)
                )
        else:
            _send_frame(sock, OP_QUERY_RESULT, F_ENDOFREQUEST, bytes(body))
        return True

    def _mesh_provider_for(self, tname, table=None):
        """A cached MeshTableProvider over this worker's local table
        when EVENTQL_TPU_MESH_DEVICES is set; None otherwise.
        Invalidates when the table's relation identity changes
        (mutations rebuild it)."""
        import os

        mesh_n = os.environ.get("EVENTQL_TPU_MESH_DEVICES")
        if not mesh_n:
            return None
        from eventql_tpu.parallel.mesh_provider import MeshTableProvider

        if table is None:
            table = self.table_service.get_table_data(tname)
        cache = getattr(self, "_mesh_providers", None)
        if cache is None:
            cache = self._mesh_providers = {}
        entry = cache.get(tname)
        if entry is None or entry[0] != id(table):
            p = MeshTableProvider(n_devices=int(mesh_n))
            p.add_table(tname, table)
            cache[tname] = (id(table), p)
        return cache[tname][1]

    def _mesh_partial(self, node, tname, table):
        """Partial GROUP BY over this worker's device mesh when
        EVENTQL_TPU_MESH_DEVICES is set (exec/mesh_exec.py
        try_execute_mesh_groupby(partial=True)); None -> host path."""
        provider = self._mesh_provider_for(tname, table)
        if provider is None:
            return None
        from eventql_tpu.exec.mesh_exec import try_execute_mesh_groupby
        from eventql_tpu.exec.runtime import Runtime

        txn = Runtime().new_transaction(provider)
        return try_execute_mesh_groupby(node, txn, partial=True)

    def _handle_partialaggr(self, sock, payload):
        """Execute a shipped partial-aggregate plan against local tables
        (reference: transport/native/ops/query_partialaggr.cc:41-110)."""
        from eventql_tpu.exec.operators import _exec_group_by_local
        from eventql_tpu.parallel.cluster import partial_to_bytes
        from eventql_tpu.plan.coder import decode_plan

        pos = 0
        plan_data, pos = read_lenencstr(payload, pos)
        try:
            node = decode_plan(plan_data)
            tname = node.table.table_name
            cache_key = None
            if self.query_cache is not None:
                # keyed by the shipped plan + the table's data version
                # (reference: scan cache key + expression fingerprint,
                # groupby.cc:256-295)
                version_fn = getattr(
                    self.table_service, "table_version", None
                )
                if version_fn is not None:
                    from eventql_tpu.exec.query_cache import QueryCache

                    cache_key = QueryCache.fingerprint(
                        "partialaggr",
                        plan_data.hex(),
                        tname,
                        version_fn(tname),
                    )
                    cached = self.query_cache.get_blob(cache_key)
                    if cached is not None:
                        _send_frame(
                            sock,
                            OP_QUERY_PARTIALAGGR_RESULT,
                            F_ENDOFREQUEST,
                            cached,
                        )
                        return
            table = self.table_service.get_table_data(tname)
            partial = None
            if node.table.keyrange is None:
                # TCP-over-mesh composition: with a mesh attached
                # (EVENTQL_TPU_MESH_DEVICES=N), this worker aggregates
                # its shard ON ITS DEVICE MESH and ships only the
                # O(groups) accumulator states — partial aggregation
                # between the host's devices, GroupByMerge over TCP
                # across hosts (reference analog: the partition server
                # IS the compute in groupby.cc:438-714)
                partial = self._mesh_partial(node, tname, table)
            if partial is None:
                partial = _exec_group_by_local(node, table)
            body = partial_to_bytes(partial, rows_scanned=table.num_rows)
            if cache_key is not None:
                self.query_cache.store_blob(cache_key, body)
        except SQLError as e:
            _send_frame(
                sock,
                OP_ERROR,
                F_ENDOFREQUEST,
                write_lenencstr(e.message.encode("utf-8")),
            )
            return
        _send_frame(sock, OP_QUERY_PARTIALAGGR_RESULT, F_ENDOFREQUEST, body)

    def _handle_query_remote(self, sock, payload):
        """Execute a shipped subtree (scan, or limit/order-by pushdown)
        against local tables and stream rows back (reference:
        transport/native/ops/query_remote.cc:40-140)."""
        from eventql_tpu.exec.operators import execute_node
        from eventql_tpu.parallel.cluster import relation_to_bytes
        from eventql_tpu.plan.coder import decode_plan

        pos = 0
        plan_data, pos = read_lenencstr(payload, pos)
        try:
            node = decode_plan(plan_data)
            # shipped limit/order pushdowns also run over the worker's
            # mesh when one is attached (the mesh provider transparently
            # host-falls-back on ineligible shapes, so this is safe for
            # every shipped subtree); keyrange-scoped scans stay on the
            # host path (the device routes refuse them)
            provider = self.table_service
            scan = node
            from eventql_tpu.plan import nodes as _qn

            while not isinstance(scan, _qn.SequentialScanNode) and hasattr(
                scan, "table"
            ):
                scan = scan.table
            if (
                isinstance(scan, _qn.SequentialScanNode)
                and scan.keyrange is None
            ):
                mp = self._mesh_provider_for(scan.table_name)
                if mp is not None:
                    provider = mp
            txn = self.runtime.new_transaction(provider)
            rel = execute_node(node, txn)
            body = relation_to_bytes(rel)
        except SQLError as e:
            _send_frame(
                sock,
                OP_ERROR,
                F_ENDOFREQUEST,
                write_lenencstr(e.message.encode("utf-8")),
            )
            return
        _send_frame(sock, OP_QUERY_REMOTE_RESULT, F_ENDOFREQUEST, body)

    def _handle_insert(self, sock, payload):
        # reference: InsertFrame::parseFrom (frames/insert.cc:72-89)
        pos = 0
        iflags, pos = read_varint(payload, pos)
        _database, pos = read_lenencstr(payload, pos)
        table, pos = read_lenencstr(payload, pos)
        encoding, pos = read_varint(payload, pos)
        if iflags & 0x01:
            _encinfo, pos = read_lenencstr(payload, pos)
        count, pos = read_varint(payload, pos)
        try:
            if encoding != INSERT_CTYPE_JSON:
                raise SQLError("unsupported record encoding")
            # clustered nodes route inserts by partition key (with
            # replica writes) unless the sender asked for local-only —
            # coordinator-to-replica writes must not re-route
            from eventql_tpu.utils.stats import evqld_stats

            target = self.table_service
            if not iflags & INSERT_LOCALONLY:
                provider = self.query_provider_factory()
                if hasattr(provider, "insert_json"):
                    target = provider
            evqld_stats().num_inserts.incr(count)
            if target is self.table_service and hasattr(
                target, "insert_records_wire"
            ):
                # local store: the rest of the frame (lenenc records)
                # shreds in ONE native pass — frame walk, JSON parse,
                # typed conversion, and pk record ids all in C++
                # (reference: the insert path is C++ end to end,
                # db/table_service.cc:758-926)
                target.insert_records_wire(
                    table.decode("utf-8"), payload[pos:], count
                )
            else:
                for _ in range(count):
                    rec, pos = read_lenencstr(payload, pos)
                    target.insert_json(
                        table.decode("utf-8"), rec.decode("utf-8")
                    )
        except SQLError as e:
            _send_frame(
                sock,
                OP_ERROR,
                F_ENDOFREQUEST,
                write_lenencstr(e.message.encode("utf-8")),
            )
            return
        _send_frame(sock, OP_ACK, F_ENDOFREQUEST, b"")

    def _handle_repl_insert(self, sock, payload):
        """Replication push: a peer replica offers records for a
        partition this server owns (reference:
        transport/native/ops/repl_insert.cc — internal-only op, body is
        a ShreddedRecordList; rows insert LOCALLY, never re-routed)."""
        from eventql_tpu.db.shredded_record_list import (
            ShreddedRecordList,
            to_row_dicts,
        )

        pos = 0
        _rflags, pos = read_varint(payload, pos)
        _database, pos = read_lenencstr(payload, pos)
        table, pos = read_lenencstr(payload, pos)
        _partition_id, pos = read_lenencstr(payload, pos)
        body, pos = read_lenencstr(payload, pos)
        try:
            records = ShreddedRecordList.decode(body)
            tname = table.decode("utf-8")
            info = self.table_service.describe(tname)
            schema = dict(info.columns) if info is not None else None
            rows = to_row_dicts(records, schema=schema)
            import json as _json

            # record versions ride the wire so a REPLAYED push is a
            # write-time no-op: every record's version equals the local
            # head version and drops (reference:
            # partition_writer.cc:169-187 record_flags_skip)
            self.table_service.insert_json_batch(
                tname,
                _json.dumps(rows).encode(),
                versions=records.record_versions or None,
            )
        except (SQLError, ValueError) as e:
            _send_frame(
                sock,
                OP_ERROR,
                F_ENDOFREQUEST,
                write_lenencstr(str(e).encode("utf-8")),
            )
            return
        _send_frame(sock, OP_ACK, F_ENDOFREQUEST, b"")

    def _handle_meta(self, sock, opcode, payload):
        """Serve METADATA-file operations for tables whose metadata
        chain lives on this server (reference:
        transport/native/ops/meta_performop.cc, meta_createfile.cc,
        meta_getfile.cc, meta_discover.cc, meta_listpartitions.cc,
        meta_findpartition.cc). Request/response bodies are JSON."""
        import json

        from eventql_tpu.core.errors import RuntimeError_

        svc = self.metadata_service
        try:
            if svc is None:
                raise RuntimeError_("no metadata service on this server")
            req_raw, _pos = read_lenencstr(payload, 0)
            req = json.loads(req_raw.decode("utf-8"))
            if opcode == OP_META_CREATEFILE:
                from eventql_tpu.db.metadata_file import MetadataFile

                svc.create_file(
                    req["db"], req["table"], MetadataFile.from_json(req["file"])
                )
                _send_frame(sock, OP_ACK, F_ENDOFREQUEST, b"")
                return
            if opcode == OP_META_GETFILE:
                f = svc.get_file(req["db"], req["table"], req["txnid"])
                body = json.dumps({"file": f.to_json()}).encode("utf-8")
                _send_frame(
                    sock, OP_META_GETFILE_RESULT, F_ENDOFREQUEST,
                    write_lenencstr(body),
                )
                return
            if opcode == OP_META_PERFORMOP:
                from eventql_tpu.db.metadata_file import MetadataOperation

                checksum, out = svc.perform_operation(
                    MetadataOperation.from_json(req["op"])
                )
                body = json.dumps(
                    {"checksum": checksum, "file": out}
                ).encode("utf-8")
                _send_frame(
                    sock, OP_META_PERFORMOP_RESULT, F_ENDOFREQUEST,
                    write_lenencstr(body),
                )
                return
            if opcode == OP_META_DISCOVER:
                resp = svc.discover(
                    req["db"], req["table"],
                    int(req.get("min_txnseq", 0)), req["request"],
                )
                body = json.dumps(resp.to_json()).encode("utf-8")
                _send_frame(
                    sock, OP_META_DISCOVER_RESULT, F_ENDOFREQUEST,
                    write_lenencstr(body),
                )
                return
            if opcode == OP_META_LISTPARTITIONS:
                f = svc.store.latest_file(req["db"], req["table"])
                if f is None:
                    raise RuntimeError_("metadata file not available")
                idxs = f.range_indices(
                    req.get("begin", ""), req.get("end", "")
                )
                body = json.dumps(
                    {
                        "txnid": f.txnid,
                        "partitions": [
                            {
                                "partition_id": f.entries[i].partition_id,
                                "keyrange_begin": f.entries[i].begin,
                                "keyrange_end": f.entry_end(i),
                                "servers": [
                                    p.server_id for p in f.entries[i].servers
                                ],
                            }
                            for i in idxs
                        ],
                    }
                ).encode("utf-8")
                _send_frame(
                    sock, OP_META_LISTPARTITIONS_RESULT, F_ENDOFREQUEST,
                    write_lenencstr(body),
                )
                return
            if opcode == OP_META_FINDPARTITION:
                f = svc.store.latest_file(req["db"], req["table"])
                if f is None:
                    raise RuntimeError_("metadata file not available")
                i = f.lookup_index(req["key"])
                body = json.dumps(
                    {
                        "txnid": f.txnid,
                        "partition_id": f.entries[i].partition_id,
                        "keyrange_begin": f.entries[i].begin,
                        "keyrange_end": f.entry_end(i),
                        "servers": [
                            p.server_id for p in f.entries[i].servers
                        ],
                    }
                ).encode("utf-8")
                _send_frame(
                    sock, OP_META_FINDPARTITION_RESULT, F_ENDOFREQUEST,
                    write_lenencstr(body),
                )
                return
            if opcode == OP_META_DROPFILE:
                svc.drop_file(req["db"], req["table"], req["txnid"])
                _send_frame(sock, OP_ACK, F_ENDOFREQUEST, b"")
                return
            raise RuntimeError_("invalid opcode")
        except Exception as e:
            _send_frame(
                sock,
                OP_ERROR,
                F_ENDOFREQUEST,
                write_lenencstr(str(e).encode("utf-8")),
            )


# -- client -----------------------------------------------------------------


class NativeTCPClient:
    """Blocking client (reference: transport/native/client_tcp.h:39
    TCPClient + the C client library's flow, client.c)."""

    def __init__(
        self, host: str, port: int, database: str = "",
        auth_token: str = "", user: str = "", password: str = "",
    ):
        self.sock = socket.create_connection((host, port))
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        auth_pairs = []
        if auth_token:
            auth_pairs += ["auth_token", auth_token]
        if user:
            auth_pairs += ["user", user]
        if password:
            auth_pairs += ["password", password]
        if database:
            auth_pairs += ["database", database]
        authdata = b"\x00".join(p.encode() for p in auth_pairs)
        payload = (
            write_varint(1)
            + write_lenencstr(b"eventql_tpu v0.1")
            + write_varint(0)
            + write_varint(0)
            + write_varint(len(authdata))
            + authdata
        )
        _send_frame(self.sock, OP_HELLO, 0, payload)
        # stats parsed from the newest QUERY_RESULT frame (reference
        # field order, frames/query_result.cc:78-82)
        self.last_result_stats = None
        opcode, _f, body = _recv_frame(self.sock)
        if opcode == OP_ERROR:
            msg, _ = read_lenencstr(body, 0)
            raise SQLError(msg.decode())
        if opcode != OP_READY:
            raise ProtocolDesyncError(f"unexpected opcode in handshake: {opcode:#x}")

    # result page size sent as the QUERY frame's maxrows: the server
    # flushes a frame after batch_size+1 rows (reference flush quirk)
    # and waits for our QUERY_CONTINUE — bounding both sides' memory
    # (reference: ops/query.cc:150-193; the reference C client uses 10)
    DEFAULT_BATCH_SIZE = 4096

    def query(self, query: str, local: bool = False, on_progress=None,
              batch_size: int = None):
        qflags = QUERY_LOCALONLY if local else 0
        if on_progress is not None:
            qflags |= QUERY_SENDPROGRESS
        if batch_size is None:
            batch_size = self.DEFAULT_BATCH_SIZE
        payload = (
            write_lenencstr(query.encode("utf-8"))
            + write_varint(qflags)
            + write_varint(batch_size)
        )
        _send_frame(self.sock, OP_QUERY, 0, payload)
        results = []
        cur_columns: List[str] = []
        cur_rows: List[List[str]] = []
        while True:
            opcode, flags, body = _recv_frame(self.sock)
            if opcode == OP_ERROR:
                msg, _ = read_lenencstr(body, 0)
                raise SQLError(msg.decode())
            if opcode == OP_QUERY_PROGRESS:
                if on_progress is not None:
                    # frames/query_progress.cc:63-70
                    pos = 0
                    vals = []
                    for _ in range(6):
                        v, pos = read_varint(body, pos)
                        vals.append(v)
                    on_progress(
                        {
                            "rows_modified": vals[0],
                            "rows_scanned": vals[1],
                            "bytes_scanned": vals[2],
                            "progress_permill": vals[3],
                            "elapsed_ms": vals[4],
                            "eta_ms": vals[5],
                        }
                    )
                continue
            if opcode == OP_HEARTBEAT:
                continue
            if opcode != OP_QUERY_RESULT:
                raise ProtocolDesyncError(f"unexpected opcode: {opcode:#x}")
            qrflags, pos = read_varint(body, 0)
            ncols, pos = read_varint(body, pos)
            nrows, pos = read_varint(body, pos)
            if qrflags & QR_HASSTATS:
                svals = []
                for _ in range(4):
                    _v, pos = read_varint(body, pos)
                    svals.append(_v)
                # reference field order: frames/query_result.cc:78-82
                self.last_result_stats = {
                    "rows_modified": svals[0],
                    "rows_scanned": svals[1],
                    "bytes_scanned": svals[2],
                    "runtime_ms": svals[3],
                }
            if qrflags & QR_HASCOLNAMES:
                cur_columns = []
                for _ in range(ncols):
                    c, pos = read_lenencstr(body, pos)
                    cur_columns.append(c.decode("utf-8"))
            for _ in range(nrows):
                row = []
                for _ in range(ncols):
                    cell, pos = read_lenencstr(body, pos)
                    row.append(cell.decode("utf-8"))
                cur_rows.append(row)
            if not qrflags & QR_COMPLETE:
                # partial page: pull the next one
                _send_frame(self.sock, OP_QUERY_CONTINUE, 0, b"")
                continue
            results.append((cur_columns, cur_rows))
            cur_columns, cur_rows = [], []
            if qrflags & QR_PENDINGSTMT:
                _send_frame(self.sock, OP_QUERY_NEXT, 0, b"")
                continue
            return results

    def insert_json(self, table: str, records, local: bool = False):
        head = bytearray()
        head += write_varint(INSERT_LOCALONLY if local else 0)
        head += write_lenencstr(b"")
        head += write_lenencstr(table.encode("utf-8"))
        head += write_varint(INSERT_CTYPE_JSON)
        head += write_varint(len(records))
        # batch framing fast path: typical records are < 16 KB so the
        # lenenc prefix is 1-2 bytes — join-of-parts with a small-varint
        # table measured ~2x the per-record bytearray appends (this is
        # the load-generator/client hot loop, evqlslap analog)
        parts = [bytes(head)]
        for r in records:
            rb = r.encode("utf-8")
            ln = len(rb)
            if ln < 128:
                parts.append(_VARINT1[ln])
            elif ln < 16384:
                parts.append(_VARINT2[ln])
            else:
                parts.append(write_varint(ln))
            parts.append(rb)
        _send_frame(self.sock, OP_INSERT, 0, b"".join(parts))
        opcode, _f, payload = _recv_frame(self.sock)
        if opcode == OP_ERROR:
            msg, _ = read_lenencstr(payload, 0)
            raise SQLError(msg.decode())
        if opcode != OP_ACK:
            raise ProtocolDesyncError(f"unexpected opcode: {opcode:#x}")

    def repl_insert(self, table: str, partition_id: str, records,
                    database: str = ""):
        """Push a ShreddedRecordList to a replica
        (reference: EVQL_OP_REPL_INSERT, frames/repl_insert.cc:63-85
        — varint flags, lenenc database/table/partition, lenenc body)."""
        body = bytearray()
        body += write_varint(0)
        body += write_lenencstr(database.encode("utf-8"))
        body += write_lenencstr(table.encode("utf-8"))
        body += write_lenencstr(partition_id.encode("utf-8"))
        body += write_lenencstr(records.encode())
        _send_frame(self.sock, OP_REPL_INSERT, 0, bytes(body))
        opcode, _f, payload = _recv_frame(self.sock)
        if opcode == OP_ERROR:
            msg, _ = read_lenencstr(payload, 0)
            raise SQLError(msg.decode())
        if opcode != OP_ACK:
            raise ProtocolDesyncError(f"unexpected opcode: {opcode:#x}")

    def query_partialaggr(self, plan_data) -> bytes:
        """Ship a partial-aggregate plan; returns serialized partial.
        plan_data: binary qtree bytes (default) or JSON str (debug)."""
        if isinstance(plan_data, str):
            plan_data = plan_data.encode("utf-8")
        _send_frame(
            self.sock,
            OP_QUERY_PARTIALAGGR,
            0,
            write_lenencstr(plan_data),
        )
        opcode, _f, payload = _recv_frame(self.sock)
        if opcode == OP_ERROR:
            msg, _ = read_lenencstr(payload, 0)
            raise SQLError(msg.decode())
        if opcode != OP_QUERY_PARTIALAGGR_RESULT:
            raise ProtocolDesyncError(f"unexpected opcode: {opcode:#x}")
        return payload

    def query_remote(self, plan_data) -> bytes:
        if isinstance(plan_data, str):
            plan_data = plan_data.encode("utf-8")
        _send_frame(
            self.sock,
            OP_QUERY_REMOTE,
            0,
            write_lenencstr(plan_data),
        )
        opcode, _f, payload = _recv_frame(self.sock)
        if opcode == OP_ERROR:
            msg, _ = read_lenencstr(payload, 0)
            raise SQLError(msg.decode())
        if opcode != OP_QUERY_REMOTE_RESULT:
            raise ProtocolDesyncError(f"unexpected opcode: {opcode:#x}")
        return payload

    def meta_request(self, opcode: int, request: dict):
        """One METADATA-service RPC; returns the decoded JSON response
        (None for ACK-only replies). Raises SQLError on ERROR frames."""
        import json

        _send_frame(
            self.sock,
            opcode,
            0,
            write_lenencstr(json.dumps(request).encode("utf-8")),
        )
        rop, _f, payload = _recv_frame(self.sock)
        if rop == OP_ERROR:
            msg, _ = read_lenencstr(payload, 0)
            raise SQLError(msg.decode())
        if rop == OP_ACK:
            return None
        body, _ = read_lenencstr(payload, 0)
        return json.loads(body.decode("utf-8"))

    def ping(self):
        _send_frame(self.sock, OP_PING, 0, b"")
        opcode, _f, _p = _recv_frame(self.sock)
        return opcode == OP_PING

    def close(self):
        try:
            _send_frame(self.sock, OP_BYE, 0, b"")
        except OSError:
            pass
        self.sock.close()
