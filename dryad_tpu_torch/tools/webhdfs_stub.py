"""In-tree WebHDFS protocol stub server (tests / demos / bench); a copy
of ``dryad_tpu/tools/webhdfs_stub.py``, so the port's samples need
nothing of the JAX package.

Serves the WebHDFS v1 REST surface over a local root directory, playing
BOTH cluster roles so clients exercise the faithful two-hop protocol:
as "namenode" it answers metadata ops and 307-redirects data ops
(OPEN/CREATE) to itself with a ``datanode=1`` marker; as "datanode" it
moves the bytes.  This is the protocol peer the reference's
``DrHdfsClient.cpp:32-69`` talks to — not a framework-private gateway —
so ``columnar/webhdfs.py`` is validated against real WebHDFS semantics
(redirects, offset/length ranges, two-step CREATE, RemoteException
JSON errors).
"""

from __future__ import annotations

import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

PREFIX = "/webhdfs/v1"


def _file_status(path: str, name: str = "") -> dict:
    st = os.stat(path)
    return {
        "pathSuffix": name,
        "type": "DIRECTORY" if os.path.isdir(path) else "FILE",
        "length": 0 if os.path.isdir(path) else st.st_size,
        "modificationTime": int(st.st_mtime * 1000),
        "blockSize": 128 * 1024 * 1024,
        "replication": 1,
        "owner": "stub",
        "group": "stub",
        "permission": "755",
    }


class _Handler(BaseHTTPRequestHandler):
    server_version = "WebHdfsStub/1.0"
    protocol_version = "HTTP/1.1"

    # quiet: tests drive many requests
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    # -- helpers -----------------------------------------------------------
    def _split(self):
        u = urllib.parse.urlsplit(self.path)
        if not u.path.startswith(PREFIX):
            return None, {}
        rel = urllib.parse.unquote(u.path[len(PREFIX):]).lstrip("/")
        q = {k: v[0] for k, v in urllib.parse.parse_qs(u.query).items()}
        return rel, q

    def _fs(self, rel: str) -> str:
        root = self.server.root  # type: ignore[attr-defined]
        p = os.path.realpath(os.path.join(root, rel))
        if not p.startswith(os.path.realpath(root)):
            raise PermissionError(rel)
        return p

    def _send(self, code: int, body: bytes, ctype="application/json",
              location: Optional[str] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if location:
            self.send_header("Location", location)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode())

    def _remote_exc(self, code: int, kind: str, msg: str) -> None:
        self._json(code, {
            "RemoteException": {
                "exception": kind, "javaClassName": f"stub.{kind}",
                "message": msg,
            }
        })

    def _redirect(self, rel: str, q: dict) -> None:
        """307 the data op to this same server, datanode role."""
        self.server.redirects += 1  # type: ignore[attr-defined]
        q = dict(q, datanode="1")
        host, port = self.server.server_address[:2]  # type: ignore[attr-defined]
        loc = (
            f"http://{host}:{port}{PREFIX}/"
            f"{urllib.parse.quote(rel, safe='/')}?{urllib.parse.urlencode(q)}"
        )
        self._send(307, b"", location=loc)

    # -- verbs -------------------------------------------------------------
    def do_GET(self):  # noqa: N802
        rel, q = self._split()
        if rel is None:
            return self._remote_exc(400, "IllegalArgumentException", self.path)
        op = q.get("op", "").upper()
        try:
            if op == "GETFILESTATUS":
                p = self._fs(rel)
                if not os.path.exists(p):
                    return self._remote_exc(
                        404, "FileNotFoundException", rel
                    )
                return self._json(200, {"FileStatus": _file_status(p)})
            if op == "LISTSTATUS":
                p = self._fs(rel)
                if not os.path.isdir(p):
                    return self._remote_exc(
                        404, "FileNotFoundException", rel
                    )
                sts = [
                    _file_status(os.path.join(p, n), n)
                    for n in sorted(os.listdir(p))
                ]
                return self._json(
                    200, {"FileStatuses": {"FileStatus": sts}}
                )
            if op == "OPEN":
                p = self._fs(rel)
                if not os.path.isfile(p):
                    return self._remote_exc(
                        404, "FileNotFoundException", rel
                    )
                if self.server.redirect_data and "datanode" not in q:  # type: ignore[attr-defined]
                    return self._redirect(rel, q)
                offset = int(q.get("offset", "0"))
                length = q.get("length")
                with open(p, "rb") as fh:
                    fh.seek(offset)
                    data = (
                        fh.read(int(length)) if length is not None
                        else fh.read()
                    )
                self.server.bytes_read += len(data)  # type: ignore[attr-defined]
                return self._send(
                    200, data, ctype="application/octet-stream"
                )
            return self._remote_exc(
                400, "UnsupportedOperationException", op
            )
        except PermissionError as e:
            return self._remote_exc(403, "AccessControlException", str(e))

    def do_PUT(self):  # noqa: N802
        rel, q = self._split()
        if rel is None:
            return self._remote_exc(400, "IllegalArgumentException", self.path)
        op = q.get("op", "").upper()
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        try:
            if op == "MKDIRS":
                os.makedirs(self._fs(rel), exist_ok=True)
                return self._json(200, {"boolean": True})
            if op == "CREATE":
                p = self._fs(rel)
                if self.server.redirect_data and "datanode" not in q:  # type: ignore[attr-defined]
                    # faithful two-step: the namenode PUT carries no
                    # body; the client re-PUTs the bytes at the
                    # redirect target
                    return self._redirect(rel, q)
                if (
                    os.path.exists(p)
                    and q.get("overwrite", "false") != "true"
                ):
                    return self._remote_exc(
                        403, "FileAlreadyExistsException", rel
                    )
                os.makedirs(os.path.dirname(p), exist_ok=True)
                tmp = f"{p}.{threading.get_ident()}.tmp"
                with open(tmp, "wb") as fh:
                    fh.write(body)
                os.replace(tmp, p)
                self.server.bytes_written += len(body)  # type: ignore[attr-defined]
                return self._send(201, b"")
            return self._remote_exc(
                400, "UnsupportedOperationException", op
            )
        except PermissionError as e:
            return self._remote_exc(403, "AccessControlException", str(e))

    def do_DELETE(self):  # noqa: N802
        rel, q = self._split()
        if rel is None or q.get("op", "").upper() != "DELETE":
            return self._remote_exc(400, "IllegalArgumentException", self.path)
        p = self._fs(rel)
        import shutil

        if not os.path.exists(p):
            return self._json(200, {"boolean": False})
        if os.path.isdir(p):
            if q.get("recursive", "false") != "true" and os.listdir(p):
                return self._remote_exc(
                    403, "PathIsNotEmptyDirectoryException", rel
                )
            shutil.rmtree(p)
        else:
            os.unlink(p)
        return self._json(200, {"boolean": True})


class WebHdfsStubServer:
    """``with WebHdfsStubServer(root) as srv: ... srv.port ...``"""

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0,
                 redirect_data: bool = True):
        os.makedirs(root, exist_ok=True)
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.root = root  # type: ignore[attr-defined]
        self._httpd.redirect_data = redirect_data  # type: ignore[attr-defined]
        self._httpd.redirects = 0  # type: ignore[attr-defined]
        self._httpd.bytes_read = 0  # type: ignore[attr-defined]
        self._httpd.bytes_written = 0  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def redirects(self) -> int:
        return self._httpd.redirects  # type: ignore[attr-defined]

    @property
    def bytes_read(self) -> int:
        return self._httpd.bytes_read  # type: ignore[attr-defined]

    @property
    def bytes_written(self) -> int:
        return self._httpd.bytes_written  # type: ignore[attr-defined]

    def start(self) -> "WebHdfsStubServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "WebHdfsStubServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
