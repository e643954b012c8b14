"""Served-engine endpoint: SQL over HTTP, results as Arrow IPC streams.

The reference ships ``exon-py`` — a client for a hosted "Exome" catalog
service speaking gRPC + ADBC/FlightSQL (exon-py/exon_py/__init__.py:30-80;
the server is not in that repo). This engine's analog is self-contained:
``ExonServer`` hosts an ``ExonSession`` behind a tiny HTTP endpoint that
accepts SQL (POST /sql, body = query text) and streams the result back as
an Arrow IPC stream — the same wire format FlightSQL rides — and
``exon_tpu.client.ExonClient`` is the exon-py-shaped consumer.

Design: stdlib http.server (no gRPC dependency in the image) + pyarrow IPC.
Concurrency is reader-writer: SELECT-shaped statements run in parallel
under a shared lock, while catalog-mutating statements (CREATE/DROP/SET/
INSERT/COPY) serialize exclusively. Results stream back per record batch
with chunked transfer encoding — the first batch is materialized before
the status line so planner/execution errors still surface as 400 JSON.
Health check at GET /health (exon-py health proto analog).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class _RWLock:
    """Reader-writer lock: many readers OR one writer (writer priority —
    a waiting writer blocks new readers so DDL can't starve)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()


_READONLY_HEADS = ("select", "with", "values", "explain", "show",
                   "describe", "table")


def _is_readonly(sql: str) -> bool:
    """True only when EVERY statement in the body is SELECT-shaped.
    The split is a conservative heuristic: a ';' inside a string literal
    over-splits, which can only misclassify toward the exclusive write
    lock — never toward concurrent readers racing a mutation."""
    ok = False
    for stmt in sql.split(";"):
        head = stmt.lstrip().lstrip("(").split(None, 1)
        if not head:
            continue
        if head[0].lower() not in _READONLY_HEADS:
            return False
        ok = True
    return ok


class _ChunkSink:
    """File-like that frames writes as HTTP/1.1 chunks (small buffer so
    pyarrow's many tiny header writes don't become tiny chunks)."""

    closed = False

    def __init__(self, wfile, bufsize: int = 1 << 16):
        self._w = wfile
        self._buf = bytearray()
        self._bufsize = bufsize

    def writable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return False

    def close(self) -> None:  # pyarrow closes the wrapped sink on exit
        self.flush()

    def write(self, data) -> int:
        self._buf += data
        if len(self._buf) >= self._bufsize:
            self.flush()
        return len(data)

    def flush(self) -> None:
        if self._buf:
            self._w.write(f"{len(self._buf):X}\r\n".encode())
            self._w.write(bytes(self._buf))
            self._w.write(b"\r\n")
            self._buf.clear()

    def finish(self) -> None:
        self.flush()
        self._w.write(b"0\r\n\r\n")


class _Handler(BaseHTTPRequestHandler):
    server_version = "exon-tpu"
    protocol_version = "HTTP/1.1"  # chunked transfer needs 1.1

    def log_message(self, fmt, *args):  # route through engine tracing
        from .tracing import logger

        logger.debug("serve: " + fmt, *args)

    def _send_json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/health":
            self._send_json(200, {"status": "SERVING"})
        else:
            self.send_error(404)

    def do_POST(self):
        if self.path != "/sql":
            self.send_error(404)
            return
        import pyarrow as pa

        n = int(self.headers.get("Content-Length", 0))
        sql = self.rfile.read(n).decode("utf-8")
        session = self.server.exon_session  # type: ignore[attr-defined]
        lock: _RWLock = self.server.exon_rwlock  # type: ignore[attr-defined]
        readonly = _is_readonly(sql)
        if readonly:
            lock.acquire_read()
        else:
            lock.acquire_write()
        try:
            try:
                df = session.sql(sql)
                from .plan.physical import host_rooted

                plan = host_rooted(df._execute(df._plan))
                bit = plan.batches()
                first = next(bit, None)
            except Exception as e:  # surface engine errors as 400 + message
                self._send_json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            self.send_response(200)
            self.send_header("Content-Type",
                             "application/vnd.apache.arrow.stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            sink = _ChunkSink(self.wfile)
            if first is None:
                # empty stream: build the schema directly — re-running the
                # plan just to recover it would redo the whole scan
                from .batch import arrow_type

                pa_schema = pa.schema(
                    [pa.field(f.name, arrow_type(f.dtype), f.nullable)
                     for f in plan.schema().all_fields])
                with pa.ipc.new_stream(sink, pa_schema) as w:
                    pass
            else:
                rb = first.to_arrow()
                with pa.ipc.new_stream(sink, rb.schema) as w:
                    if rb.num_rows:
                        w.write_batch(rb)
                    for b in bit:  # stream as produced — bounded memory
                        rb = b.to_arrow()
                        if rb.num_rows:
                            w.write_batch(rb)
            sink.finish()
        finally:
            if readonly:
                lock.release_read()
            else:
                lock.release_write()


class ExonServer:
    """Host an ExonSession over HTTP (SQL in, Arrow IPC out)."""

    def __init__(self, session=None, host: str = "127.0.0.1",
                 port: int = 0):
        if session is None:
            from .session import ExonSession

            session = ExonSession.new_exon()
        self.session = session
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.exon_session = session  # type: ignore[attr-defined]
        self._httpd.exon_rwlock = _RWLock()  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ExonServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="exon-tpu-serve")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        self._httpd.server_close()

    def __enter__(self) -> "ExonServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def main(argv=None) -> None:
    """``python -m exon_tpu.serve [--host H] [--port P]``"""
    import argparse

    ap = argparse.ArgumentParser(description="exon-tpu SQL server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8815)
    args = ap.parse_args(argv)
    srv = ExonServer(host=args.host, port=args.port)
    print(f"exon-tpu serving on {srv.address}")
    srv._httpd.serve_forever()


if __name__ == "__main__":
    main()
