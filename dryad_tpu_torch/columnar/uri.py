"""Data-provider URI registry — the DataProvider/DataPath analog (a copy
of ``dryad_tpu/columnar/uri.py``).

The reference maps URI schemes to pluggable storage providers
(``LinqToDryad/DataProvider.cs:682`` scheme registry, ``DataPath.cs``:
``partfile://``, ``hdfs://``, ``azureblob://``).  Here:

- ``partfile://<dir>`` (or a bare path) — local partitioned columnar
  store (``columnar/io.py``).
- ``file://<path>``   — raw text file (one STRING ``line`` column).
- ``mem://<name>``    — in-process named table registry (the
  LocalDebug-style test provider).
- ``hdfs://namenode:port/<path>`` — REAL WebHDFS REST
  (``columnar/webhdfs.py``: ranged OPEN with the namenode->datanode
  redirect, two-step CREATE — ``DrHdfsClient.cpp:32-69``,
  ``channelbufferhdfs.cpp``).
- ``wasb://container@host[:port]/<path>``, ``abfs://`` — REAL Azure
  Blob REST (``columnar/azblob.py``).

- ``http://host:port/<rel>`` — a store on a remote node's
  ProcessService file server (``cluster/service.py``'s
  ``ServiceClient``: range reads and writes with zlib on the wire).
- the framework file gateway: with ``DRYAD_TPU_DFS_GATEWAY=host:port``
  set, ``hdfs://``, ``wasb://`` and ``abfs://`` stores live under
  ``<gateway>/<scheme>/<authority>/<path>`` on such a file server, as
  does a ``wasb://``/``abfs://`` URI without a ``container@`` authority
  (whose authority is then the file server itself).

Register custom providers with ``register_provider``.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from dryad_tpu_torch.columnar import io as CIO
from dryad_tpu_torch.columnar.schema import ColumnType, Schema, StringDictionary

ReadResult = Tuple[Schema, List[Dict[str, np.ndarray]], StringDictionary]


class DataProvider:
    """Provider interface: read a URI into (schema, partitions,
    dictionary); optionally write a store to a URI."""

    def read(self, uri: str) -> ReadResult:
        raise NotImplementedError

    def write(
        self,
        uri: str,
        partitions: List[Dict[str, np.ndarray]],
        schema: Schema,
        dictionary: Optional[StringDictionary],
        compression: Optional[str],
    ) -> None:
        raise NotImplementedError(f"provider for {uri!r} is read-only")


_PROVIDERS: Dict[str, DataProvider] = {}


def register_provider(scheme: str, provider: DataProvider) -> None:
    _PROVIDERS[scheme] = provider


def split_uri(uri: str) -> Tuple[str, str]:
    """(scheme, rest); bare paths map to 'partfile'."""
    if "://" not in uri:
        return "partfile", uri
    scheme, rest = uri.split("://", 1)
    return scheme.lower(), rest


def get_provider(uri: str) -> Tuple[DataProvider, str]:
    scheme, rest = split_uri(uri)
    p = _PROVIDERS.get(scheme)
    if p is None:
        raise ValueError(
            f"no data provider for scheme {scheme!r} "
            f"(registered: {sorted(_PROVIDERS)})"
        )
    return p, rest


def read_store_uri(uri: str) -> ReadResult:
    p, rest = get_provider(uri)
    return p.read(rest)


def write_store_uri(
    uri: str,
    partitions: List[Dict[str, np.ndarray]],
    schema: Schema,
    dictionary: Optional[StringDictionary],
    compression: Optional[str],
) -> None:
    p, rest = get_provider(uri)
    p.write(rest, partitions, schema, dictionary, compression)


# -- built-in providers ----------------------------------------------------

class PartfileProvider(DataProvider):
    def read(self, path: str) -> ReadResult:
        return CIO.read_store(path)

    def write(self, path, partitions, schema, dictionary, compression,
              threads: int = 4):
        CIO.write_store(
            path, partitions, schema, dictionary, compression, threads
        )


class TextFileProvider(DataProvider):
    """Raw text: one partition, one STRING column ``line``."""

    def read(self, path: str) -> ReadResult:
        from dryad_tpu_torch.columnar.schema import hash64_str, string_prefix_rank

        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            lines = [ln.rstrip("\n") for ln in fh]
        arr = np.array(lines, object)
        schema = Schema([("line", ColumnType.STRING)])
        dictionary = StringDictionary()
        h = np.array([hash64_str(s) for s in lines], np.uint64)
        for hv, s in zip(h, lines):
            dictionary._map[int(hv)] = s
        cols = {
            "line#h0": (h & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            "line#h1": (h >> np.uint64(32)).astype(np.uint32),
            "line#r0": string_prefix_rank(arr),
            "line#r1": string_prefix_rank(arr, offset=4),
        }
        return schema, [cols], dictionary


class MemProvider(DataProvider):
    """In-process named stores (testing / LocalDebug analog)."""

    def __init__(self) -> None:
        self._tables: Dict[str, Tuple] = {}

    def read(self, name: str) -> ReadResult:
        if name not in self._tables:
            raise FileNotFoundError(f"mem://{name}")
        schema, parts, dictionary = self._tables[name]
        return schema, [dict(p) for p in parts], dictionary

    def write(self, name, partitions, schema, dictionary, compression):
        self._tables[name] = (
            schema,
            [dict(p) for p in partitions],
            dictionary or StringDictionary(),
        )


def _read_store_via(fetch: Callable[[str], bytes], threads: int) -> ReadResult:
    """Store read parameterized over a byte transport: manifest ->
    schema, optional dictionary, parallel part-file fan-in."""
    from concurrent.futures import ThreadPoolExecutor

    manifest = json.loads(fetch(CIO.MANIFEST).decode("utf-8"))
    schema = Schema([(n, ColumnType(t)) for n, t in manifest["schema"]])
    dictionary = StringDictionary()
    try:
        dmap = json.loads(fetch(CIO.DICTFILE).decode("utf-8"))
        for h, s in dmap.items():
            dictionary._map[int(h, 16)] = s
    except FileNotFoundError:
        pass
    n = manifest["partitions"]
    with ThreadPoolExecutor(max_workers=min(threads, max(n, 1))) as ex:
        parts = list(
            ex.map(
                lambda i: CIO.parse_partition_bytes(
                    fetch(f"part-{i:05d}.dpf"), copy=False
                ),
                range(n),
            )
        )
    return schema, parts, dictionary


def _write_store_via(
    ship: Callable[[str, bytes], None],
    partitions, schema, dictionary, compression, threads: int,
) -> None:
    """Store write parameterized over a byte transport: stage the exact
    on-disk layout locally, then ship each file in parallel (the
    reference stages partitions to the DFS the same way,
    ``DrPartitionFile.h:50``)."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    tmp = tempfile.mkdtemp(prefix="dryad-store-stage-")
    try:
        CIO.write_store(tmp, partitions, schema, dictionary, compression)
        names = sorted(os.listdir(tmp))

        def one(name: str) -> None:
            with open(os.path.join(tmp, name), "rb") as fh:
                ship(name, fh.read())

        with ThreadPoolExecutor(
            max_workers=min(threads, max(len(names), 1))
        ) as ex:
            list(ex.map(one, names))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class HttpStoreProvider(DataProvider):
    """A partitioned store on a remote ProcessService FileServer:
    ``http://host:port/<relative store dir>`` — the bulk remote-store
    scheme (the reference's HDFS/Azure stream role,
    ``GraphManager/filesystem/DrHdfsClient.h:29,63``,
    ``channelbufferhdfs.cpp``).  Reads are 2MB HTTP range reads with
    zlib wire compression (``managedchannel/HttpReader.cs:78-110``;
    transform ``dryadvertex.h:33-48``); writes PUT each store file,
    compressed, so TB-scale ingest/egress rides the DCN file plane.
    Partition fetches run on a small thread pool (the async
    channel-reader analog)."""

    THREADS = 4

    def _client(self, rest: str):
        from dryad_tpu_torch.cluster.service import ServiceClient

        netloc, _, rel = rest.partition("/")
        host, _, port = netloc.partition(":")
        return ServiceClient(host, int(port or 80)), rel.strip("/")

    def read(self, rest: str) -> ReadResult:
        client, prefix = self._client(rest)
        return _read_store_via(
            lambda name: client.read_whole_file(
                f"{prefix}/{name}" if prefix else name, compress=True
            ),
            self.THREADS,
        )

    def write(self, rest, partitions, schema, dictionary, compression):
        client, prefix = self._client(rest)
        _write_store_via(
            lambda name, data: client.write_file(
                f"{prefix}/{name}" if prefix else name, data, compress=True
            ),
            partitions, schema, dictionary, compression, self.THREADS,
        )


class DfsGatewayProvider(DataProvider):
    """Cloud-DFS scheme adapter: ``hdfs://``, ``wasb://``, ``abfs://``
    URIs route through a cluster file gateway speaking the
    ProcessService file-plane protocol (2MB range reads + zlib wire
    compression).  The reference reads these schemes through a managed
    WebHDFS/Azure REST bridge (``DrHdfsClient.cpp:32-69``,
    ``DrAzureBlobClient.h:25``) — the same gateway-REST pattern; here
    the gateway is any ProcessService-compatible file server.

    Routing: with ``DRYAD_TPU_DFS_GATEWAY=host:port`` set, the store
    lives under ``<gateway>/<scheme>/<authority>/<path>`` (one gateway
    fronts many DFS namespaces); without it, the URI authority itself
    must be a reachable ``host:port`` file server (an "HDFS namenode"
    that IS the gateway)."""

    def __init__(self, scheme: str, via: "HttpStoreProvider"):
        self.scheme = scheme
        self.via = via

    def _route(self, rest: str) -> str:
        gw = os.environ.get("DRYAD_TPU_DFS_GATEWAY")
        if not gw:
            return rest
        netloc, _, rel = rest.partition("/")
        path = f"{self.scheme}/{netloc}/{rel}".rstrip("/")
        return f"{gw}/{path}"

    def read(self, rest: str) -> ReadResult:
        return self.via.read(self._route(rest))

    def write(self, rest, partitions, schema, dictionary, compression):
        self.via.write(
            self._route(rest), partitions, schema, dictionary, compression
        )


class WebHdfsProvider(DataProvider):
    """``hdfs://namenode:port/path`` speaking REAL WebHDFS REST
    (``columnar/webhdfs.py``): ranged OPEN with the namenode->datanode
    307 redirect, two-step CREATE, LISTSTATUS — the protocol the
    reference's ``DrHdfsClient.cpp:32-69`` and ``channelbufferhdfs.cpp``
    speak.  Part files fetch in parallel, each chunked-parallel through
    the native Fifo pipeline.

    With ``DRYAD_TPU_DFS_GATEWAY`` set the scheme instead routes
    through the framework file gateway (``DfsGatewayProvider``) — the
    escape hatch for secured (Kerberos) clusters the plain client
    can't talk to."""

    THREADS = 4

    def _gateway(self) -> Optional["DfsGatewayProvider"]:
        if os.environ.get("DRYAD_TPU_DFS_GATEWAY"):
            return DfsGatewayProvider("hdfs", _HTTP)
        return None

    def _client(self, rest: str):
        from dryad_tpu_torch.columnar.webhdfs import (
            WebHdfsClient, parse_hdfs_netloc,
        )

        host, port, path = parse_hdfs_netloc(rest)
        return WebHdfsClient(host, port), path

    def read(self, rest: str) -> ReadResult:
        gw = self._gateway()
        if gw is not None:
            return gw.read(rest)
        client, base = self._client(rest)
        return _read_store_via(
            lambda name: client.read_file(f"{base}/{name}"), self.THREADS
        )

    def write(self, rest, partitions, schema, dictionary, compression):
        gw = self._gateway()
        if gw is not None:
            return gw.write(rest, partitions, schema, dictionary, compression)
        client, base = self._client(rest)
        client.mkdirs(base)
        _write_store_via(
            lambda name, data: client.create(f"{base}/{name}", data),
            partitions, schema, dictionary, compression, self.THREADS,
        )


class AzureBlobProvider(DataProvider):
    """``wasb://container@host[:port]/path`` (and ``abfs://``) speaking
    REAL Azure Blob REST (``columnar/azblob.py``: ranged Get Blob,
    BlockBlob Put, XML List Blobs — the surface of
    ``DrAzureBlobClient.h:25,42``).  SAS auth via
    ``DRYAD_TPU_AZURE_SAS``.

    URIs WITHOUT the ``container@`` authority, or any URI when
    ``DRYAD_TPU_DFS_GATEWAY`` is set, keep the legacy framework
    file-gateway route (``DfsGatewayProvider``) — the secured-cluster /
    Shared-Key escape hatch."""

    THREADS = 4

    def __init__(self, scheme: str, gateway: "DfsGatewayProvider"):
        self.scheme = scheme
        self.gateway = gateway

    def _route(self, rest: str):
        from dryad_tpu_torch.columnar.azblob import (
            AzureBlobClient, parse_wasb_netloc,
        )

        if os.environ.get("DRYAD_TPU_DFS_GATEWAY"):
            return None
        try:
            container, host, port, base = parse_wasb_netloc(rest)
        except ValueError:
            return None  # no container@ authority: legacy gateway form
        return AzureBlobClient(host, port), container, base

    def read(self, rest: str) -> ReadResult:
        routed = self._route(rest)
        if routed is None:
            return self.gateway.read(rest)
        client, container, base = routed
        return _read_store_via(
            lambda name: client.get_blob(
                container, f"{base}/{name}" if base else name
            ),
            self.THREADS,
        )

    def write(self, rest, partitions, schema, dictionary, compression):
        routed = self._route(rest)
        if routed is None:
            return self.gateway.write(
                rest, partitions, schema, dictionary, compression
            )
        client, container, base = routed
        client.create_container(container)
        _write_store_via(
            lambda name, data: client.put_blob(
                container, f"{base}/{name}" if base else name, data
            ),
            partitions, schema, dictionary, compression, self.THREADS,
        )


_HTTP = HttpStoreProvider()
register_provider("partfile", PartfileProvider())
register_provider("file", TextFileProvider())
register_provider("mem", MemProvider())
register_provider("http", _HTTP)
register_provider("hdfs", WebHdfsProvider())
for _scheme in ("wasb", "abfs"):
    register_provider(_scheme, AzureBlobProvider(_scheme, DfsGatewayProvider(_scheme, _HTTP)))
