"""Per-node process service — mailbox + file server + block cache.

The analog of the reference's per-worker daemon (``ProcessService/``):

- **versioned property mailbox** (``ProcessService.cs:42-126``
  ``ValueVersion``/``MailboxRecord``): the control plane.  The job
  manager sets a command property; the worker long-polls for a version
  newer than the last it saw, and posts status back the same way.
- **file server** (``HttpServer.cs:498,631-667`` FileServer): serves
  channel/partition files by ``?offset=&length=`` range reads so remote
  consumers stream persisted stage outputs over HTTP/DCN.
- **block cache with spill-to-disk** (``Cache.cs:32``,
  ``SpillMachine.cs:30``): hot file blocks stay in memory under a byte
  budget; evicted blocks spill to a local directory before re-reading
  from the source.

In this framework this service is the DCN-side control/data plane for
multi-host jobs; intra-slice data movement rides ICI collectives inside
compiled programs and never touches it.
"""

from __future__ import annotations

import collections
import http.client
import http.server
import os
import threading
import time
import urllib.parse
from typing import Dict, List, Optional, Tuple

from dryad_tpu_torch.utils.logging import get_logger

log = get_logger("dryad_tpu_torch.cluster.service")

DEFAULT_BLOCK = 2 * 1024 * 1024  # 2MB blocks, HttpServer.cs FileServer


class Mailbox:
    """Versioned key-value property store, long-poll reads."""

    def __init__(self) -> None:
        self._lock = threading.Condition()
        # (pid, name) -> (version, value)
        self._props: Dict[Tuple[str, str], Tuple[int, bytes]] = {}
        self._closed = False
        # in-process observers: fn(pid, name, version, value), called
        # after every set_prop OUTSIDE the mailbox lock (a watch that
        # re-enters the mailbox must not deadlock).  Wake signal only —
        # two racing sets may deliver out of order; observers that care
        # must re-read and compare versions.
        self._watches: List = []

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Mark closed and wake every blocked long-poll immediately.
        Subsequent ``get_prop`` calls return without waiting."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    def add_watch(self, fn) -> None:
        with self._lock:
            self._watches.append(fn)

    def remove_watch(self, fn) -> None:
        with self._lock:
            try:
                self._watches.remove(fn)
            except ValueError:
                pass

    def set_prop(self, pid: str, name: str, value: bytes) -> int:
        with self._lock:
            ver = self._props.get((pid, name), (0, b""))[0] + 1
            self._props[(pid, name)] = (ver, value)
            self._lock.notify_all()
            watches = tuple(self._watches)
        for fn in watches:
            try:
                fn(pid, name, ver, value)
            except Exception:  # noqa: BLE001 — a watch must not poison sets
                log.exception("mailbox watch failed for %s/%s", pid, name)
        return ver

    def get_prop(
        self,
        pid: str,
        name: str,
        after_version: int = 0,
        timeout: float = 0.0,
    ) -> Optional[Tuple[int, bytes]]:
        """Return (version, value) once version > after_version, else
        None after ``timeout`` (0 = non-blocking) or as soon as the
        mailbox closes (shutdown must not wait out long-polls)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                cur = self._props.get((pid, name))
                if cur is not None and cur[0] > after_version:
                    return cur
                left = deadline - time.monotonic()
                if left <= 0 or self._closed:
                    return None
                self._lock.wait(left)

    def del_prop(self, pid: str, name: str) -> None:
        """Drop a property outright (result GC after delivery)."""
        with self._lock:
            self._props.pop((pid, name), None)

    def processes(self) -> List[str]:
        with self._lock:
            return sorted({pid for pid, _ in self._props})


class BlockCache:
    """Memory block cache with LRU spill-to-disk (Cache + SpillMachine)."""

    def __init__(
        self,
        root: str,
        spill_dir: Optional[str] = None,
        memory_budget: int = 64 * 1024 * 1024,
        block_size: int = DEFAULT_BLOCK,
    ):
        self.root = os.path.abspath(root)
        self.block_size = block_size
        self.memory_budget = memory_budget
        self.spill_dir = spill_dir
        self._lock = threading.Lock()
        self._mem: "collections.OrderedDict[Tuple[str, int], bytes]" = (
            collections.OrderedDict()
        )
        self._mem_bytes = 0
        self._spilled: Dict[Tuple[str, int], str] = {}
        self.hits = self.misses = self.spills = 0
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    def _source_path(self, rel: str) -> str:
        # realpath resolves symlinks too, so a link under root pointing
        # outside cannot bypass the containment check
        path = os.path.realpath(os.path.join(self.root, rel))
        root = os.path.realpath(self.root)
        if not path.startswith(root + os.sep) and path != root:
            raise PermissionError(f"path escapes root: {rel}")
        return path

    def _load_block(self, rel: str, bi: int) -> bytes:
        key = (rel, bi)
        spath = self._spilled.get(key)
        if spath is not None and os.path.exists(spath):
            with open(spath, "rb") as fh:
                return fh.read()
        with open(self._source_path(rel), "rb") as fh:
            fh.seek(bi * self.block_size)
            return fh.read(self.block_size)

    def _put(self, key: Tuple[str, int], block: bytes) -> None:
        old = self._mem.pop(key, None)
        if old is not None:
            self._mem_bytes -= len(old)
        self._mem[key] = block
        self._mem_bytes += len(block)
        while self._mem_bytes > self.memory_budget and len(self._mem) > 1:
            old_key, old = self._mem.popitem(last=False)
            self._mem_bytes -= len(old)
            if self.spill_dir and old_key not in self._spilled:
                import hashlib

                digest = hashlib.sha1(
                    f"{old_key[0]}:{old_key[1]}".encode()
                ).hexdigest()
                sp = os.path.join(self.spill_dir, f"{digest}.blk")
                with open(sp, "wb") as fh:
                    fh.write(old)
                self._spilled[old_key] = sp
                self.spills += 1

    def invalidate(self, rel: str) -> None:
        """Drop cached blocks of one file (after an overwrite)."""
        with self._lock:
            for key in [k for k in self._mem if k[0] == rel]:
                self._mem_bytes -= len(self._mem.pop(key))
            for key in [k for k in self._spilled if k[0] == rel]:
                sp = self._spilled.pop(key)
                try:
                    os.unlink(sp)
                except OSError:
                    pass

    def read(self, rel: str, offset: int, length: int) -> bytes:
        """Range read through the cache."""
        out = bytearray()
        end = offset + length
        while offset < end:
            bi = offset // self.block_size
            key = (rel, bi)
            with self._lock:
                block = self._mem.get(key)
                if block is not None:
                    self._mem.move_to_end(key)
                    self.hits += 1
            if block is None:
                block = self._load_block(rel, bi)
                with self._lock:
                    self.misses += 1
                    # a short tail block may still be growing (reader
                    # racing a writer) — serving it from cache later
                    # would permanently truncate the file
                    if len(block) == self.block_size:
                        self._put(key, block)
            lo = offset - bi * self.block_size
            take = min(end - offset, len(block) - lo)
            if take <= 0:
                break  # EOF
            out += block[lo : lo + take]
            offset += take
        return bytes(out)

    def file_size(self, rel: str) -> int:
        return os.path.getsize(self._source_path(rel))


class _Handler(http.server.BaseHTTPRequestHandler):
    """Routes:
    GET  /prop/<pid>/<name>?after=V&timeout=T   long-poll property read
    POST /prop/<pid>/<name>                     set property (body=value)
    GET  /file/<relpath>?offset=O&length=L      range read via block cache
         (&compress=1: zlib-deflate the payload — the channel-boundary
         compression transform of the reference, ``dryadvertex.h:33-48``)
    PUT  /file/<relpath>                        write a file under root
         (X-Encoding: deflate body accepted) — the bulk-store egress
    GET  /status                                service health/stats
    """

    service: "ProcessService"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code: int, body: bytes, headers: Dict[str, str] = {}):
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        u = urllib.parse.urlparse(self.path)
        q = urllib.parse.parse_qs(u.query)
        parts = u.path.strip("/").split("/")
        try:
            if parts[0] == "prop" and len(parts) >= 3:
                pid, name = parts[1], "/".join(parts[2:])
                after = int(q.get("after", ["0"])[0])
                timeout = float(q.get("timeout", ["0"])[0])
                got = self.service.mailbox.get_prop(pid, name, after, timeout)
                if got is None:
                    self._send(204, b"")
                else:
                    ver, val = got
                    self._send(200, val, {"X-Version": str(ver)})
            elif parts[0] == "file" and len(parts) >= 2:
                # Per-segment unquote: every shipped client percent-
                # encodes (enc=1 marks the encoding generation for
                # future format changes).  WIRE-FORMAT LOCKSTEP: a
                # client that does NOT encode must not send literal '%'
                # in paths — the decode here would corrupt them.  The
                # root realpath check below still contains any
                # reintroduced separators.
                rel = "/".join(urllib.parse.unquote(p) for p in parts[1:])
                offset = int(q.get("offset", ["0"])[0])
                length = int(
                    q.get("length", [str(self.service.cache.block_size)])[0]
                )
                data = self.service.cache.read(rel, offset, length)
                headers = {
                    "X-File-Size": str(self.service.cache.file_size(rel)),
                    "X-Raw-Length": str(len(data)),
                }
                if q.get("compress", ["0"])[0] == "1":
                    import zlib

                    data = zlib.compress(data, 1)
                    headers["X-Encoding"] = "deflate"
                self._send(200, data, headers)
            elif parts[0] == "status":
                c = self.service.cache
                body = (
                    f'{{"hits": {c.hits}, "misses": {c.misses}, '
                    f'"spills": {c.spills}}}'
                ).encode()
                self._send(200, body, {"Content-Type": "application/json"})
            else:
                self._send(404, b"not found")
        except (FileNotFoundError, PermissionError) as e:
            self._send(404, str(e).encode())
        except Exception as e:  # noqa: BLE001
            self._send(500, str(e).encode())

    def do_POST(self):
        u = urllib.parse.urlparse(self.path)
        parts = u.path.strip("/").split("/")
        try:
            if parts[0] == "prop" and len(parts) >= 3:
                n = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(n)
                pid, name = parts[1], "/".join(parts[2:])
                ver = self.service.mailbox.set_prop(pid, name, body)
                self._send(200, b"", {"X-Version": str(ver)})
            else:
                self._send(404, b"not found")
        except Exception as e:  # noqa: BLE001
            self._send(500, str(e).encode())

    def do_PUT(self):
        u = urllib.parse.urlparse(self.path)
        parts = u.path.strip("/").split("/")
        try:
            if parts[0] == "file" and len(parts) >= 2:
                n = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(n)
                if self.headers.get("X-Encoding") == "deflate":
                    import zlib

                    body = zlib.decompress(body)
                # same decode + lockstep rule as do_GET
                self.service.write_file(
                    "/".join(urllib.parse.unquote(p) for p in parts[1:]),
                    body,
                )
                self._send(200, b"")
            else:
                self._send(404, b"not found")
        except PermissionError as e:
            self._send(403, str(e).encode())
        except Exception as e:  # noqa: BLE001
            self._send(500, str(e).encode())


class ProcessService:
    """The per-node daemon: mailbox + file server on one HTTP port."""

    def __init__(
        self,
        root: str,
        port: int = 0,
        spill_dir: Optional[str] = None,
        memory_budget: int = 64 * 1024 * 1024,
        block_size: int = DEFAULT_BLOCK,
        host: str = "127.0.0.1",
    ):
        """``host``: bind address — loopback by default; "0.0.0.0" for
        a service remote workers must reach (multi-host jobs)."""
        self.root = os.path.abspath(root)
        self.mailbox = Mailbox()
        self.cache = BlockCache(
            self.root, spill_dir, memory_budget, block_size
        )
        handler = type("BoundHandler", (_Handler,), {"service": self})
        self._httpd = http.server.ThreadingHTTPServer((host, port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dryad-psvc", daemon=True
        )
        self._thread.start()
        log.info("ProcessService on port %d root=%s", self.port, self.root)

    def write_file(self, rel: str, data: bytes) -> None:
        """Write a file under the served root (bulk-store ingest path);
        atomic replace, stale cache blocks dropped."""
        path = os.path.realpath(os.path.join(self.root, rel))
        root = os.path.realpath(self.root)
        if not path.startswith(root + os.sep) and path != root:
            raise PermissionError(f"path escapes root: {rel}")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.put.tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)
        self.cache.invalidate(rel)

    def close(self) -> None:
        # Close the mailbox FIRST: ThreadingHTTPServer.shutdown() joins
        # its handler threads, and any handler parked in a get_prop
        # long-poll would otherwise hold shutdown hostage for the full
        # poll timeout (regression: close took 30s with one 30s
        # long-poll outstanding).
        self.mailbox.close()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ServiceClient:
    """HTTP client for a remote ProcessService (HttpReader/ICluster side,
    ``managedchannel/HttpReader.cs:78-110``)."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self.wire_bytes = 0  # bytes on the wire (post-compression)
        self.raw_bytes = 0  # decoded payload bytes
        self._acct = threading.Lock()

    def _account(self, wire: int, raw: int) -> None:
        with self._acct:
            self.wire_bytes += wire
            self.raw_bytes += raw

    def _conn(self, timeout: float = 30.0) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(self.host, self.port, timeout=timeout)

    def set_prop(self, pid: str, name: str, value: bytes) -> int:
        c = self._conn()
        try:
            c.request("POST", f"/prop/{pid}/{name}", body=value)
            r = c.getresponse()
            r.read()
            if r.status != 200:
                raise RuntimeError(f"set_prop failed: {r.status}")
            return int(r.getheader("X-Version", "0"))
        finally:
            c.close()

    def get_prop(
        self, pid: str, name: str, after_version: int = 0, timeout: float = 0.0
    ) -> Optional[Tuple[int, bytes]]:
        # socket deadline must outlast the server-side long-poll window
        c = self._conn(timeout=timeout + 30.0)
        try:
            c.request(
                "GET",
                f"/prop/{pid}/{name}?after={after_version}&timeout={timeout}",
            )
            r = c.getresponse()
            body = r.read()
            if r.status == 204:
                return None
            if r.status != 200:
                raise RuntimeError(f"get_prop failed: {r.status} {body!r}")
            return int(r.getheader("X-Version", "0")), body
        finally:
            c.close()

    def read_file(
        self,
        rel: str,
        offset: int = 0,
        length: int = DEFAULT_BLOCK,
        compress: bool = False,
    ) -> bytes:
        """One range read; ``compress`` applies the wire-compression
        transform (zlib over the DCN hop, ``dryadvertex.h:33-48``).
        ``self.wire_bytes``/``self.raw_bytes`` accumulate transfer
        accounting for observability."""
        c = self._conn()
        try:
            quoted = urllib.parse.quote(rel, safe="/")
            url = f"/file/{quoted}?offset={offset}&length={length}&enc=1"
            if compress:
                url += "&compress=1"
            c.request("GET", url)
            r = c.getresponse()
            body = r.read()
            if r.status == 404:
                raise FileNotFoundError(rel)
            if r.status != 200:
                raise RuntimeError(f"read_file failed: {r.status} {body!r}")
            wire = len(body)
            if r.getheader("X-Encoding") == "deflate":
                import zlib

                body = zlib.decompress(body)
            self._account(wire, len(body))
            return body
        finally:
            c.close()

    def read_whole_file(
        self, rel: str, chunk: int = DEFAULT_BLOCK, compress: bool = False
    ) -> bytes:
        """Stream a whole remote file by range reads."""
        out = bytearray()
        offset = 0
        while True:
            data = self.read_file(rel, offset, chunk, compress=compress)
            out += data
            offset += len(data)
            if len(data) < chunk:
                return bytes(out)

    def write_file(self, rel: str, data: bytes, compress: bool = True) -> None:
        """PUT a whole file to the remote store root (bulk egress)."""
        headers = {}
        body = data
        if compress:
            import zlib

            body = zlib.compress(data, 1)
            headers["X-Encoding"] = "deflate"
        c = self._conn()
        try:
            c.request(
                "PUT",
                f"/file/{urllib.parse.quote(rel, safe='/')}?enc=1",
                body=body, headers=headers,
            )
            r = c.getresponse()
            msg = r.read()
            if r.status != 200:
                raise RuntimeError(f"write_file failed: {r.status} {msg!r}")
            self._account(len(body), len(data))
        finally:
            c.close()
