"""In-tree Azure Blob service protocol stub (tests / demos / bench); a
copy of ``dryad_tpu/tools/azblob_stub.py``, so the port's tests need
nothing of the JAX package.

Serves the Blob REST subset ``columnar/azblob.py`` speaks — Put Blob
(BlockBlob), Get Blob with ``x-ms-range``, Get Blob Properties (HEAD),
List Blobs (XML), Create Container, Delete Blob — over a local root
directory, with Azure-style XML error bodies.  This is the protocol
peer of the reference's ``DrAzureBlobClient.h``, so the client is
validated against real Blob REST semantics (range headers, 201/202
status codes, XML listings) without a cloud account.
"""

from __future__ import annotations

import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from xml.sax.saxutils import escape


class _Handler(BaseHTTPRequestHandler):
    server_version = "AzBlobStub/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102 - quiet
        pass

    # -- helpers -----------------------------------------------------------
    def _split(self):
        u = urllib.parse.urlsplit(self.path)
        parts = urllib.parse.unquote(u.path).strip("/").split("/", 1)
        container = parts[0] if parts and parts[0] else None
        blob = parts[1] if len(parts) > 1 else ""
        q = {k: v[0] for k, v in urllib.parse.parse_qs(u.query).items()}
        return container, blob, q

    def _fs(self, *rel: str) -> str:
        root = self.server.root  # type: ignore[attr-defined]
        p = os.path.realpath(os.path.join(root, *rel))
        if not p.startswith(os.path.realpath(root)):
            raise PermissionError("/".join(rel))
        return p

    def _send(self, code: int, body: bytes = b"",
              ctype: str = "application/octet-stream",
              extra: dict = {}) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, az_code: str, msg: str) -> None:
        body = (
            f"<?xml version=\"1.0\"?><Error><Code>{az_code}</Code>"
            f"<Message>{escape(msg)}</Message></Error>"
        ).encode()
        self._send(code, body, ctype="application/xml")

    # -- verbs -------------------------------------------------------------
    def do_PUT(self):  # noqa: N802
        container, blob, q = self._split()
        if container is None:
            return self._error(400, "InvalidUri", self.path)
        if q.get("restype") == "container" and not blob:
            os.makedirs(self._fs(container), exist_ok=True)
            return self._send(201)
        if not os.path.isdir(self._fs(container)):
            return self._error(404, "ContainerNotFound", container)
        if self.headers.get("x-ms-blob-type") != "BlockBlob":
            return self._error(
                400, "MissingRequiredHeader", "x-ms-blob-type"
            )
        n = int(self.headers.get("Content-Length") or 0)
        data = self.rfile.read(n) if n else b""
        p = self._fs(container, blob)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = f"{p}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, p)
        self.server.bytes_written += len(data)  # type: ignore[attr-defined]
        self._send(201)

    def do_HEAD(self):  # noqa: N802
        container, blob, _q = self._split()
        p = self._fs(container or "", blob)
        if not (container and blob and os.path.isfile(p)):
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        # HEAD carries the size in Content-Length with an empty body
        self.send_response(200)
        self.send_header("Content-Length", str(os.path.getsize(p)))
        self.send_header("x-ms-blob-type", "BlockBlob")
        self.end_headers()

    def do_GET(self):  # noqa: N802
        container, blob, q = self._split()
        if container is None:
            return self._error(400, "InvalidUri", self.path)
        if q.get("comp") == "list":
            base = self._fs(container)
            if not os.path.isdir(base):
                return self._error(404, "ContainerNotFound", container)
            prefix = q.get("prefix", "")
            names = []
            for dirpath, _dirs, files in os.walk(base):
                for f in sorted(files):
                    rel = os.path.relpath(os.path.join(dirpath, f), base)
                    rel = rel.replace(os.sep, "/")
                    if rel.startswith(prefix):
                        names.append(rel)
            blobs = "".join(
                f"<Blob><Name>{escape(n)}</Name></Blob>" for n in sorted(names)
            )
            body = (
                f"<?xml version=\"1.0\"?><EnumerationResults>"
                f"<Blobs>{blobs}</Blobs></EnumerationResults>"
            ).encode()
            return self._send(200, body, ctype="application/xml")
        p = self._fs(container, blob)
        if not os.path.isfile(p):
            return self._error(404, "BlobNotFound", f"{container}/{blob}")
        rng = self.headers.get("x-ms-range") or self.headers.get("Range")
        with open(p, "rb") as fh:
            if rng and rng.startswith("bytes="):
                a, _, b = rng[len("bytes="):].partition("-")
                start = int(a)
                end = int(b) if b else os.path.getsize(p) - 1
                fh.seek(start)
                data = fh.read(end - start + 1)
                self.server.bytes_read += len(data)  # type: ignore[attr-defined]
                return self._send(206, data)
            data = fh.read()
        self.server.bytes_read += len(data)  # type: ignore[attr-defined]
        self._send(200, data)

    def do_DELETE(self):  # noqa: N802
        container, blob, _q = self._split()
        p = self._fs(container or "", blob)
        if not (container and blob and os.path.isfile(p)):
            return self._error(404, "BlobNotFound", f"{container}/{blob}")
        os.unlink(p)
        self._send(202)


class AzureBlobStubServer:
    """``with AzureBlobStubServer(root) as srv: ... srv.port ...``"""

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0):
        os.makedirs(root, exist_ok=True)
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.root = root  # type: ignore[attr-defined]
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
    def bytes_read(self) -> int:
        return self._httpd.bytes_read  # type: ignore[attr-defined]

    @property
    def bytes_written(self) -> int:
        return self._httpd.bytes_written  # type: ignore[attr-defined]

    def start(self) -> "AzureBlobStubServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "AzureBlobStubServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
