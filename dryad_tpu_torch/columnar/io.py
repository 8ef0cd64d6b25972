"""Partitioned columnar stores on the filesystem (a copy of
``dryad_tpu/columnar/io.py``: both packages write the same bytes and
read each other's stores).

The analog of the reference's partitioned-table data providers
(``LinqToDryad/DataProvider.cs``, partfile scheme ``DataPath.cs``;
metadata ``DryadLinqMetaData.cs``): a store is a directory with a JSON
manifest (logical schema, partition count, compression), one ``.dpf``
columnar partition file per partition, and the string dictionary.

``.dpf`` format (implemented natively in ``runtime/native`` too):
one JSON header line (column name, dtype, row count, compressed byte
length per column) terminated by ``\\n``, then each column's payload —
little-endian raw array bytes, zlib-compressed when ``comp='zlib'``.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from dryad_tpu_torch.columnar.schema import ColumnType, Schema, StringDictionary

MANIFEST = "manifest.json"
DICTFILE = "dictionary.json"


def _part_name(i: int) -> str:
    return f"part-{i:05d}.dpf"


def write_partition_file(
    path: str, cols: Dict[str, np.ndarray], compression: Optional[str] = None
) -> None:
    names = list(cols.keys())
    rows = len(cols[names[0]]) if names else 0
    payloads: List[bytes] = []
    header = {"rows": rows, "columns": []}
    for n in names:
        a = np.ascontiguousarray(cols[n])
        raw = a.tobytes()
        comp = compression or "none"
        data = zlib.compress(raw) if comp == "zlib" else raw
        header["columns"].append(
            {"name": n, "dtype": str(a.dtype), "rows": rows,
             "comp": comp, "nbytes": len(data)}
        )
        payloads.append(data)
    with open(path, "wb") as fh:
        fh.write((json.dumps(header) + "\n").encode("utf-8"))
        for p in payloads:
            fh.write(p)


def parse_partition_bytes(
    buf: bytes, copy: bool = True
) -> Dict[str, np.ndarray]:
    """``copy=False`` returns zero-copy (read-only) views over ``buf``
    for uncompressed columns — callers that immediately repack into a
    device layout (the ``store`` ingest binding) skip one full memcpy
    of the dataset."""
    nl = buf.index(b"\n")
    header = json.loads(buf[:nl].decode("utf-8"))
    out: Dict[str, np.ndarray] = {}
    at = nl + 1
    # compressed columns inflate in parallel on native threads when the
    # runtime is available (channelbuffernativereader analog)
    comp_srcs: List[bytes] = []
    comp_dsts: List[np.ndarray] = []
    for c in header["columns"]:
        data = buf[at : at + c["nbytes"]]
        at += c["nbytes"]
        if c["comp"] == "zlib":
            dt = np.dtype(c["dtype"])
            arr = np.empty(c["rows"], dt)
            out[c["name"]] = arr
            comp_srcs.append(data)
            comp_dsts.append(arr)
        else:
            view = np.frombuffer(data, dtype=np.dtype(c["dtype"]))
            out[c["name"]] = view if not copy else view.copy()
    if comp_srcs:
        from dryad_tpu_torch.runtime.bindings import decompress_batch

        if not decompress_batch(comp_srcs, comp_dsts):
            for src, dst in zip(comp_srcs, comp_dsts):
                dst[:] = np.frombuffer(zlib.decompress(src), dst.dtype)
    return out


def read_partition_file(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as fh:
        return parse_partition_bytes(fh.read())


def write_store_meta(
    path: str,
    n_partitions: int,
    schema: Schema,
    dictionary: Optional[StringDictionary] = None,
    compression: Optional[str] = None,
) -> None:
    """Store manifest + dictionary files — the single writer of the
    store metadata format (shared with the streaming store writer)."""
    os.makedirs(path, exist_ok=True)
    manifest = {
        "version": 1,
        "partitions": n_partitions,
        "compression": compression or "none",
        "schema": [[f.name, f.ctype.value] for f in schema.fields],
    }
    with open(os.path.join(path, MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=1)
    if dictionary is not None:
        with open(os.path.join(path, DICTFILE), "w") as fh:
            json.dump({format(h, "016x"): s for h, s in dictionary.items()}, fh)


def load_store_meta(path: str):
    """(manifest, schema, hash->string map) — the single reader of the
    store metadata format."""
    with open(os.path.join(path, MANIFEST)) as fh:
        manifest = json.load(fh)
    schema = Schema([(n, ColumnType(t)) for n, t in manifest["schema"]])
    dict_map: Dict[int, str] = {}
    dpath = os.path.join(path, DICTFILE)
    if os.path.exists(dpath):
        with open(dpath) as fh:
            for h, s in json.load(fh).items():
                dict_map[int(h, 16)] = s
    return manifest, schema, dict_map


def write_store(
    path: str,
    partitions: List[Dict[str, np.ndarray]],
    schema: Schema,
    dictionary: Optional[StringDictionary] = None,
    compression: Optional[str] = None,
    threads: int = 4,
) -> None:
    write_store_meta(path, len(partitions), schema, dictionary, compression)
    # Native writer compresses columns on a thread pool when available
    # (falls back to write_partition_file); partitions additionally
    # write concurrently — the async channel-writer analog
    # (channelbuffernativewriter.cpp), GIL released inside ctypes.
    from concurrent.futures import ThreadPoolExecutor

    from dryad_tpu_torch.runtime.bindings import write_partition

    if threads <= 1 or len(partitions) <= 1:
        for i, cols in enumerate(partitions):
            write_partition(
                os.path.join(path, _part_name(i)), cols, compression
            )
        return
    with ThreadPoolExecutor(max_workers=min(threads, len(partitions))) as ex:
        futs = [
            ex.submit(
                write_partition,
                os.path.join(path, _part_name(i)), cols, compression,
            )
            for i, cols in enumerate(partitions)
        ]
        for f in futs:
            f.result()


def read_store(
    path: str,
) -> Tuple[Schema, List[Dict[str, np.ndarray]], StringDictionary]:
    manifest, schema, dict_map = load_store_meta(path)
    dictionary = StringDictionary()
    dictionary._map.update(dict_map)
    # Background-prefetched ordered reads via the native channel reader
    # (Python fallback inside PrefetchChannel when the lib is absent).
    from dryad_tpu_torch.runtime.bindings import PrefetchChannel

    paths = [
        os.path.join(path, _part_name(i)) for i in range(manifest["partitions"])
    ]
    with PrefetchChannel(paths, depth=4, threads=2) as ch:
        # zero-copy views: the store binding repacks into the (P x cap)
        # device layout anyway, so that repack is THE copy
        parts = [parse_partition_bytes(buf, copy=False) for buf in ch]
    return schema, parts, dictionary
