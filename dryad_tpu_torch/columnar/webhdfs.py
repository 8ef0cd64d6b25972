"""Real WebHDFS REST client — the cloud-DFS ingest/egress path (a copy
of ``dryad_tpu/columnar/webhdfs.py``).

The reference reads and writes HDFS natively through libhdfs/WebHDFS
(``GraphManager/filesystem/DrHdfsClient.cpp:32-69``; the vertex-side
stream reader ``DryadVertex/VertexHost/system/channel/channelbufferhdfs.cpp``).
This module speaks the actual WebHDFS HTTP protocol:

- ``OPEN`` with ``offset``/``length`` range params, following the
  namenode's 307 redirect to the datanode (the two-hop read dance);
- ``CREATE`` via the two-step redirect PUT (namenode allocates, the
  data body goes to the redirect target);
- ``MKDIRS``, ``GETFILESTATUS``, ``LISTSTATUS``, ``DELETE``.

Large files are fetched **chunked-parallel**: a window of ranged OPEN
reads runs on a thread pool, and completed chunks flow to the consumer
in order through the native ``Fifo`` (``runtime/native/
dryadnative.cpp`` — the async channel-buffer reader pattern of
``channelbufferhdfs.cpp``'s read-ahead), so memory stays bounded at
``depth`` chunks while the network pipe stays full.

Simple (user.name) authentication only; set ``DRYAD_TPU_HDFS_USER`` or
pass ``user=``.  Kerberos/delegation tokens are out of scope — gate via
a fronting gateway for secured clusters (``uri.DfsGatewayProvider``).
"""

from __future__ import annotations

import http.client
import json
import os
import urllib.parse
from typing import Dict, List, Optional, Tuple

DEFAULT_CHUNK = 4 * 1024 * 1024
DEFAULT_THREADS = 4
DEFAULT_DEPTH = 4


class WebHdfsError(IOError):
    def __init__(self, status: int, body: bytes, context: str):
        self.status = status
        try:
            msg = json.loads(body.decode("utf-8", "replace"))
            exc = msg.get("RemoteException", {})
            kind = exc.get("exception", "")
            detail = ": ".join(
                p for p in (kind, exc.get("message")) if p
            ) or str(msg)
        except Exception:  # noqa: BLE001 - body may be html/plain
            detail = body[:200].decode("utf-8", "replace")
        super().__init__(f"webhdfs {context}: HTTP {status}: {detail}")


class WebHdfsClient:
    """Minimal WebHDFS v1 client over ``http.client`` (stdlib only)."""

    def __init__(
        self,
        host: str,
        port: int,
        user: Optional[str] = None,
        chunk: int = DEFAULT_CHUNK,
        threads: int = DEFAULT_THREADS,
        depth: int = DEFAULT_DEPTH,
        timeout: float = 30.0,
    ):
        self.host = host
        self.port = int(port)
        self.user = user or os.environ.get("DRYAD_TPU_HDFS_USER")
        self.chunk = int(chunk)
        self.threads = int(threads)
        self.depth = int(depth)
        self.timeout = timeout

    # -- low-level request with one-hop redirect following -----------------
    def _url(self, path: str, op: str, **params) -> str:
        if not path.startswith("/"):
            path = "/" + path
        q = {"op": op}
        if self.user:
            q["user.name"] = self.user
        for k, v in params.items():
            if v is not None:
                q[k] = str(v).lower() if isinstance(v, bool) else str(v)
        quoted = urllib.parse.quote(path, safe="/")
        return f"/webhdfs/v1{quoted}?{urllib.parse.urlencode(q)}"

    def _request(
        self,
        method: str,
        url: str,
        body: Optional[bytes] = None,
        host: Optional[str] = None,
        port: Optional[int] = None,
        follow: bool = True,
        context: str = "",
    ) -> Tuple[int, Dict[str, str], bytes]:
        c = http.client.HTTPConnection(
            host or self.host, port or self.port, timeout=self.timeout
        )
        try:
            c.request(method, url, body=body)
            r = c.getresponse()
            data = r.read()
            headers = {k.lower(): v for k, v in r.getheaders()}
            if follow and r.status in (301, 302, 307) and "location" in headers:
                # The namenode redirects data operations to a datanode
                # (DrHdfsClient.cpp follows the same two-hop protocol).
                loc = urllib.parse.urlsplit(headers["location"])
                path = loc.path + (f"?{loc.query}" if loc.query else "")
                return self._request(
                    method, path, body=body,
                    host=loc.hostname or self.host,
                    port=loc.port or self.port,
                    follow=False, context=context,
                )
            return r.status, headers, data
        finally:
            c.close()

    def _json(self, method: str, url: str, context: str, ok=(200,)) -> dict:
        status, _h, data = self._request(method, url, context=context)
        if status not in ok:
            raise WebHdfsError(status, data, context)
        return json.loads(data.decode("utf-8")) if data else {}

    # -- metadata ----------------------------------------------------------
    def status(self, path: str) -> dict:
        """GETFILESTATUS -> the FileStatus dict (raises FileNotFoundError)."""
        url = self._url(path, "GETFILESTATUS")
        st, _h, data = self._request("GET", url, context=f"status {path}")
        if st == 404:
            raise FileNotFoundError(path)
        if st != 200:
            raise WebHdfsError(st, data, f"status {path}")
        return json.loads(data.decode("utf-8"))["FileStatus"]

    def list_dir(self, path: str) -> List[dict]:
        """LISTSTATUS -> FileStatus list."""
        out = self._json(
            "GET", self._url(path, "LISTSTATUS"), f"list {path}"
        )
        return out["FileStatuses"]["FileStatus"]

    def mkdirs(self, path: str) -> None:
        self._json("PUT", self._url(path, "MKDIRS"), f"mkdirs {path}")

    def delete(self, path: str, recursive: bool = False) -> bool:
        out = self._json(
            "DELETE",
            self._url(path, "DELETE", recursive=recursive),
            f"delete {path}",
        )
        return bool(out.get("boolean"))

    # -- data --------------------------------------------------------------
    def open_range(
        self, path: str, offset: int = 0, length: Optional[int] = None
    ) -> bytes:
        """One ranged OPEN read (namenode 307 -> datanode GET)."""
        url = self._url(path, "OPEN", offset=offset, length=length)
        st, _h, data = self._request("GET", url, context=f"open {path}")
        if st == 404:
            raise FileNotFoundError(path)
        if st != 200:
            raise WebHdfsError(st, data, f"open {path}")
        return data

    def read_file(self, path: str) -> bytes:
        """Whole file, chunked-parallel: a ``depth``-deep window of
        ranged reads on a thread pool, re-ordered through the native
        Fifo so the consumer sees bytes in order with bounded
        memory (the channelbufferhdfs read-ahead pipeline,
        ``columnar/chunked.py``)."""
        from dryad_tpu_torch.columnar.chunked import chunked_read

        size = int(self.status(path)["length"])
        return chunked_read(
            size,
            lambda off, ln: self.open_range(path, off, ln),
            self.chunk, self.threads, self.depth,
        )

    def create(self, path: str, data: bytes, overwrite: bool = True) -> None:
        """Two-step CREATE: PUT to the namenode with no body -> 307
        Location -> PUT the bytes to the redirect target (201)."""
        url = self._url(path, "CREATE", overwrite=overwrite)
        st, headers, body = self._request(
            "PUT", url, follow=False, context=f"create {path}"
        )
        if st in (301, 302, 307) and "location" in headers:
            loc = urllib.parse.urlsplit(headers["location"])
            st, _h, body = self._request(
                "PUT",
                loc.path + (f"?{loc.query}" if loc.query else ""),
                body=data,
                host=loc.hostname or self.host,
                port=loc.port or self.port,
                follow=False,
                context=f"create {path}",
            )
        elif st in (200, 201):
            # server accepted the body-less PUT directly (noredirect
            # mode); re-send with the body
            st, _h, body = self._request(
                "PUT", url, body=data, follow=False,
                context=f"create {path}",
            )
        if st not in (200, 201):
            raise WebHdfsError(st, body, f"create {path}")


def parse_hdfs_netloc(rest: str) -> Tuple[str, int, str]:
    """Split the non-scheme part of hdfs://host:port/path."""
    netloc, _, rel = rest.partition("/")
    host, _, port = netloc.partition(":")
    return host, int(port or 9870), "/" + rel.strip("/")
