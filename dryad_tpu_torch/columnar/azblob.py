"""Azure Blob Storage REST client — the ``wasb://`` / ``abfs://``
ingest/egress path (a copy of ``dryad_tpu/columnar/azblob.py``).

The reference reads/writes Azure blobs natively
(``GraphManager/filesystem/DrAzureBlobClient.h:25,42``; the managed
``AzureCollectionPartition`` streams).  This module speaks the actual
Blob service REST surface:

- ``Get Blob`` with an ``x-ms-range`` header (206 partial content) —
  chunk-parallel through the shared read-ahead pipeline
  (``columnar/chunked.py``);
- ``Put Blob`` (``x-ms-blob-type: BlockBlob``);
- ``Get Blob Properties`` (HEAD), ``List Blobs``
  (``restype=container&comp=list``, XML), ``Create Container``,
  ``Delete Blob``.

Auth: a SAS token appended to every request's query string
(``DRYAD_TPU_AZURE_SAS`` or ``sas=``) — the standard
shared-access-signature scheme; anonymous works against public
containers, Azurite, and the in-tree stub (``tools/azblob_stub.py``).
Shared-Key signing is out of scope — use SAS or route through the
framework file gateway (``uri.DfsGatewayProvider``).
"""

from __future__ import annotations

import http.client
import os
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

DEFAULT_CHUNK = 4 * 1024 * 1024


class AzureBlobError(IOError):
    def __init__(self, status: int, body: bytes, context: str):
        self.status = status
        detail = body[:300].decode("utf-8", "replace")
        # Azure error bodies are XML: <Error><Code>..</Code><Message>..
        try:
            root = ET.fromstring(body.decode("utf-8"))
            code = root.findtext("Code") or ""
            msg = (root.findtext("Message") or "").splitlines()[0]
            detail = f"{code}: {msg}"
        except Exception:  # noqa: BLE001 - non-XML body
            pass
        super().__init__(f"azure blob {context}: HTTP {status}: {detail}")


class AzureBlobClient:
    """Minimal Blob service client over ``http.client`` (stdlib only).

    ``host``/``port`` address the blob endpoint (the account host in
    real Azure, e.g. ``acct.blob.core.windows.net:443``; a local
    Azurite/stub otherwise)."""

    def __init__(
        self,
        host: str,
        port: int = 443,
        sas: Optional[str] = None,
        https: Optional[bool] = None,
        chunk: int = DEFAULT_CHUNK,
        threads: int = 4,
        depth: int = 4,
        timeout: float = 30.0,
    ):
        self.host = host
        self.port = int(port)
        self.sas = (sas or os.environ.get("DRYAD_TPU_AZURE_SAS") or "").lstrip("?")
        self.https = bool(port == 443) if https is None else https
        self.chunk = int(chunk)
        self.threads = int(threads)
        self.depth = int(depth)
        self.timeout = timeout

    # -- plumbing ----------------------------------------------------------
    def _url(self, container: str, blob: str = "", **params) -> str:
        path = f"/{urllib.parse.quote(container)}"
        if blob:
            path += f"/{urllib.parse.quote(blob, safe='/')}"
        q = [(k, str(v)) for k, v in params.items() if v is not None]
        query = urllib.parse.urlencode(q)
        if self.sas:
            query = f"{query}&{self.sas}" if query else self.sas
        return f"{path}?{query}" if query else path

    def _request(
        self,
        method: str,
        url: str,
        body: Optional[bytes] = None,
        headers: Optional[Dict[str, str]] = None,
        context: str = "",
    ) -> Tuple[int, Dict[str, str], bytes]:
        cls = (
            http.client.HTTPSConnection if self.https
            else http.client.HTTPConnection
        )
        c = cls(self.host, self.port, timeout=self.timeout)
        try:
            hs = {"x-ms-version": "2021-08-06", **(headers or {})}
            c.request(method, url, body=body, headers=hs)
            r = c.getresponse()
            data = r.read()
            return r.status, {k.lower(): v for k, v in r.getheaders()}, data
        finally:
            c.close()

    # -- container / metadata ---------------------------------------------
    def create_container(self, container: str) -> None:
        st, _h, body = self._request(
            "PUT", self._url(container, restype="container"),
            context=f"create container {container}",
        )
        if st not in (201, 409):  # 409 = already exists
            raise AzureBlobError(st, body, f"create container {container}")

    def blob_size(self, container: str, blob: str) -> int:
        st, h, body = self._request(
            "HEAD", self._url(container, blob),
            context=f"head {container}/{blob}",
        )
        if st == 404:
            raise FileNotFoundError(f"{container}/{blob}")
        if st != 200:
            raise AzureBlobError(st, body, f"head {container}/{blob}")
        return int(h.get("content-length", "0"))

    def list_blobs(self, container: str, prefix: str = "") -> List[str]:
        """List Blobs (flat): names under ``prefix``."""
        st, _h, body = self._request(
            "GET",
            self._url(
                container, restype="container", comp="list",
                prefix=prefix or None,
            ),
            context=f"list {container}",
        )
        if st != 200:
            raise AzureBlobError(st, body, f"list {container}")
        root = ET.fromstring(body.decode("utf-8"))
        return [
            el.text or ""
            for el in root.findall("./Blobs/Blob/Name")
        ]

    def delete_blob(self, container: str, blob: str) -> bool:
        st, _h, body = self._request(
            "DELETE", self._url(container, blob),
            context=f"delete {container}/{blob}",
        )
        if st == 404:
            return False
        if st != 202:
            raise AzureBlobError(st, body, f"delete {container}/{blob}")
        return True

    # -- data --------------------------------------------------------------
    def get_range(
        self, container: str, blob: str, offset: int, length: int
    ) -> bytes:
        st, _h, data = self._request(
            "GET", self._url(container, blob),
            headers={"x-ms-range": f"bytes={offset}-{offset + length - 1}"},
            context=f"get {container}/{blob}",
        )
        if st == 404:
            raise FileNotFoundError(f"{container}/{blob}")
        if st not in (200, 206):
            raise AzureBlobError(st, data, f"get {container}/{blob}")
        return data

    def get_blob(self, container: str, blob: str) -> bytes:
        """Whole blob via the shared chunk-parallel read-ahead."""
        from dryad_tpu_torch.columnar.chunked import chunked_read

        size = self.blob_size(container, blob)
        return chunked_read(
            size,
            lambda off, ln: self.get_range(container, blob, off, ln),
            self.chunk, self.threads, self.depth,
        )

    def put_blob(self, container: str, blob: str, data: bytes) -> None:
        st, _h, body = self._request(
            "PUT", self._url(container, blob), body=data,
            headers={
                "x-ms-blob-type": "BlockBlob",
                "Content-Length": str(len(data)),
            },
            context=f"put {container}/{blob}",
        )
        if st != 201:
            raise AzureBlobError(st, body, f"put {container}/{blob}")


def parse_wasb_netloc(rest: str) -> Tuple[str, str, int, str]:
    """Split the non-scheme part of
    ``wasb://container@host[:port]/path`` -> (container, host, port,
    path).  Raises ValueError when no ``container@`` authority is
    present (those URIs route through the legacy file gateway)."""
    netloc, _, rel = rest.partition("/")
    if "@" not in netloc:
        raise ValueError(f"no container@account authority in {rest!r}")
    container, _, hostport = netloc.partition("@")
    host, _, port = hostport.partition(":")
    return container, host, int(port or 443), rel.strip("/")
