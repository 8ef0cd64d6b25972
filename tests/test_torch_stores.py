"""Stores, codecs, providers and the host I/O routines: the port
(dryad_tpu_torch, device="cpu") against the JAX package on its 8-device
CPU mesh.

All of this is host code, so the tolerance is zero: equal bytes.  Each
``.dpf`` part file, ``manifest.json`` and ``dictionary.json`` the port
writes equals the reference's for the same table or query at the same
P, uncompressed and zlib-compressed; each package reads the other's
stores with equal rows and equal placement (partition of every row and
per-partition capacity, the P=16 -> P=8 fold included).  The one query
result that is not byte-equal between the packages is a float sum of
the sort path (the port sums in fixed point, within
``n_g * 2^-23 * sum|v|`` of the reference, ROADMAP.md), so the
``group_by`` whose store bytes are compared aggregates integers.
"""

import os
import threading
import zlib

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.columnar import codecs as jcodecs
from dryad_tpu.columnar import io as jio
from dryad_tpu.exec.events import EventLog
from dryad_tpu_torch.tools.azblob_stub import AzureBlobStubServer
from dryad_tpu_torch.columnar import codecs as tcodecs
from dryad_tpu_torch.columnar import io as tio
from dryad_tpu_torch.columnar import uri as turi
from dryad_tpu_torch.runtime import bindings as RB
from dryad_tpu_torch.tools.webhdfs_stub import WebHdfsStubServer

P = 8


def _ctxs(**cfg):
    jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg))
    jc.executor.events = EventLog(None)
    tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg), device="cpu")
    return jc, tc


def _table(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    return {
        "k": rng.integers(-60, 60, n).astype(np.int32),
        "w": rng.integers(-1000, 1000, n).astype(np.int32),
        "v": rng.standard_normal(n).astype(np.float32),
        "u": rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        "L": rng.integers(-2**40, 2**40, n).astype(np.int64),
        "d": rng.standard_normal(n),
        "b": rng.random(n) < 0.5,
        "s": np.array([f"w{i}" for i in rng.integers(0, 40, n)], object),
    }


def _store_bytes(path):
    return {f: open(os.path.join(path, f), "rb").read() for f in sorted(os.listdir(path))}


def _assert_tables_equal(a, b):
    assert list(a) == list(b)
    for c in a:
        assert a[c].dtype == b[c].dtype, c
        if a[c].dtype == object:
            assert a[c].tolist() == b[c].tolist(), c
        else:
            np.testing.assert_array_equal(a[c].view(np.uint8), b[c].view(np.uint8), err_msg=c)


INT_AGGS = {"c": ("count", None), "sw": ("sum", "w"), "mn": ("min", "w"), "mx": ("max", "k")}

STORE_QUERIES = {
    "table": lambda ctx, t: ctx.from_arrays(t),
    "group_by": lambda ctx, t: ctx.from_arrays(t).group_by("k", INT_AGGS),
    "order_by": lambda ctx, t: ctx.from_arrays(t).order_by([("k", False), ("v", True)]),
    "join": lambda ctx, t: ctx.from_arrays(t).join(
        ctx.from_arrays({"k": np.arange(-60, 60, 3, dtype=np.int32),
                         "r": np.arange(40, dtype=np.int32)}), "k", strategy="shuffle"),
    "wordcount": lambda ctx, t: ctx.from_text(" ".join(t["s"].tolist()))
    .group_by("word", {"n": ("count", None)}),
}


@pytest.mark.parametrize("comp", [None, "zlib"], ids=["none", "zlib"])
@pytest.mark.parametrize("name", sorted(STORE_QUERIES))
def test_store_files_byte_equal(tmp_path, name, comp):
    t = _table()
    paths = []
    for tag, ctx in zip("jt", _ctxs(intermediate_compression=comp)):
        paths.append(str(tmp_path / tag))
        STORE_QUERIES[name](ctx, t).to_store(paths[-1])
    ref, port = (_store_bytes(p) for p in paths)
    assert sorted(port) == sorted(ref) == sorted(
        [tio.MANIFEST, tio.DICTFILE] + [tio._part_name(i) for i in range(P)])
    for f in ref:
        assert port[f] == ref[f], f


def test_sort_path_float_sums_within_the_bound(tmp_path):
    """The float sums of a stored sort-path group_by: the port's are
    within n_g * 2^-23 * sum|v| of the reference's (all other bytes of
    the store equal)."""
    t = _table(1)
    parts = []
    for tag, ctx in zip("jt", _ctxs()):
        ctx.from_arrays(t).group_by("k", {"c": ("count", None), "sv": ("sum", "v")}).to_store(
            str(tmp_path / tag))
        parts.append([tio.read_partition_file(str(tmp_path / tag / tio._part_name(i)))
                      for i in range(P)])
    for a, b in zip(*parts):
        np.testing.assert_array_equal(a["k"], b["k"])
        np.testing.assert_array_equal(a["c"], b["c"])
        absum = np.array([np.abs(t["v"][t["k"] == k]).astype(np.float64).sum() for k in a["k"]])
        assert np.all(np.abs(a["sv"].astype(np.float64) - b["sv"]) <= a["c"] * 2.0**-23 * absum)


def _placement(batch, P):
    """(valid (P, cap), {column: (P, cap) uint64 words}) of a bound
    store batch of either package."""
    valid = np.asarray(batch.valid).reshape(P, -1)
    cols = {}
    for c, v in batch.data.items():
        a = np.asarray(v).reshape(P, -1)
        cols[c] = np.where(valid, a.astype(np.int64).astype(np.uint64) & 0xFFFFFFFF
                           if a.dtype in (np.uint32, np.int64) else a.view(np.uint32)
                           if a.itemsize == 4 else a, 0)
    return valid, cols


@pytest.mark.parametrize("writer,writer_P", [("ref", 4), ("ref", 8), ("port", 4), ("port", 8),
                                             ("port", 16)])
def test_each_package_reads_the_others_store(tmp_path, writer, writer_P):
    """A store written by one package at ``writer_P`` binds in both at
    P=8 with the same rows in the same partitions (store partition i
    folds into i % 8) and the same capacity; collect() of it is equal.
    (The reference's CPU mesh has 8 devices, so P=16 stores come from
    the port.)"""
    t = _table(2, n=2000)
    path = str(tmp_path / "s")
    wctx = (J.DryadContext(num_partitions_=writer_P) if writer == "ref"
            else T.DryadContext(num_partitions_=writer_P, device="cpu"))
    wctx.from_arrays(t).where(lambda c: c["k"] > -40).to_store(path)
    jc, tc = _ctxs()
    jq, tq = jc.from_store(path), tc.from_store(path)
    jb, tb = jc._bind_device(jq.node), tc._bind_device(tq.node)
    assert tb.capacity == jb.capacity // P
    jv, jcols = _placement(jb, P)
    tv, tcols = _placement(tb, P)
    np.testing.assert_array_equal(tv, jv)
    assert sorted(tcols) == sorted(jcols)
    for c in jcols:
        np.testing.assert_array_equal(tcols[c], jcols[c], err_msg=c)
    _assert_tables_equal(tq.collect(), jq.collect())
    assert tc.io_native is True


def test_store_strings_merge_the_dictionary_and_gate_auto_dense(tmp_path):
    """A STRING store's dictionary merges into the reader's; each STRING
    column takes the store's hashes as its vocabulary, so a group_by
    over it still lowers to string_code (the same op list as the
    reference's) and counts equal the reference's."""
    t = _table(3)
    path = str(tmp_path / "w")
    T.DryadContext(num_partitions_=P, device="cpu").from_arrays({"s": t["s"]}).to_store(path)
    jc, tc = _ctxs()
    jq, tq = (c.from_store(path).group_by("s", {"n": ("count", None)}) for c in (jc, tc))
    assert sorted(tc.dictionary._map) == sorted(jc.dictionary._map)
    np.testing.assert_array_equal(tq.node.inputs[0].params["str_vocab"]["s"],
                                  jq.node.inputs[0].params["str_vocab"]["s"])
    assert "string_code" in tq.explain() and "exchange_hash" not in tq.explain()
    _assert_tables_equal(tq.collect(), jq.collect())


# -- the native routines against their plain versions ----------------------------

def test_native_partition_writer_equals_the_python_writer(tmp_path):
    t = _table(4, n=777)
    cols = {"a": t["k"], "b": t["v"], "c": t["u"], "d": t["b"], "e\"q\\x": t["w"][:777]}
    for comp in (None, "zlib"):
        native, plain, ref = (str(tmp_path / f"{tag}_{comp}.dpf") for tag in "npr")
        RB.write_partition(native, cols, comp)
        tio.write_partition_file(plain, cols, comp)
        jio.write_partition_file(ref, cols, comp)
        a, b, c = (open(p, "rb").read() for p in (native, plain, ref))
        assert a == b == c
        got = tio.read_partition_file(native)
        for k in cols:
            np.testing.assert_array_equal(got[k], cols[k])


def test_native_batch_decompress_equals_zlib():
    rng = np.random.default_rng(5)
    arrays = [rng.integers(0, 7, 5000).astype(np.int32), rng.standard_normal(3000).astype(np.float32),
              np.zeros(0, np.uint32)]
    srcs = [zlib.compress(a.tobytes()) for a in arrays]
    dsts = [np.empty_like(a) for a in arrays]
    assert RB.decompress_batch(srcs, dsts) is True
    for a, d, s in zip(arrays, dsts, srcs):
        np.testing.assert_array_equal(d, np.frombuffer(zlib.decompress(s), a.dtype))
    with pytest.raises(ValueError, match="corrupt"):
        RB.decompress_batch([srcs[0][:-3]], [np.empty_like(arrays[0])])


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_prefetch_channel_reads_in_order(tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setattr(RB, "_load_io", lambda: None)
    paths = []
    for i in range(12):
        paths.append(str(tmp_path / f"f{i}"))
        with open(paths[-1], "wb") as fh:
            fh.write(bytes([i]) * (1000 * (12 - i)))
    with RB.PrefetchChannel(paths, depth=2, threads=3) as ch:
        assert (ch._handle is not None) == native
        got = list(ch)
    assert got == [open(p, "rb").read() for p in paths]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_fifo_pipelined_and_closed_semantics(monkeypatch, native):
    if not native:
        monkeypatch.setattr(RB, "_load_io", lambda: None)
    f = RB.Fifo(depth=2)
    assert (f._handle is not None) == native
    blocks = [bytes([i]) * (i + 1) for i in range(50)]

    def produce():
        for b in blocks:
            assert f.push(b)
        f.close()

    th = threading.Thread(target=produce)
    th.start()
    got = []
    while (b := f.pop()) is not None:
        got.append(b)
    th.join()
    assert got == blocks
    assert f.pop() is None and f.push(b"x") is False
    f.destroy()


# -- providers ---------------------------------------------------------------------

def test_mem_file_and_partfile_providers_round_trip(tmp_path):
    t = {"k": np.arange(100, dtype=np.int32), "s": np.array([f"x{i % 7}" for i in range(100)], object)}
    tc = T.DryadContext(num_partitions_=P, device="cpu")
    for uri in ("mem://t1", f"partfile://{tmp_path}/p", str(tmp_path / "bare")):
        tc.from_arrays(t).to_store(uri)
        back = T.DryadContext(num_partitions_=P, device="cpu").from_store(uri).collect()
        _assert_tables_equal(back, tc.from_arrays(t).collect())
    with pytest.raises(FileNotFoundError):
        turi.read_store_uri("mem://missing")
    text = tmp_path / "lines.txt"
    text.write_text("alpha beta\ngamma\n\ndelta\n")
    jq = J.DryadContext(num_partitions_=P).from_store(f"file://{text}")
    tq = tc.from_store(f"file://{text}")
    _assert_tables_equal(tq.collect(), jq.collect())
    assert tq.collect()["line"].tolist() == ["alpha beta", "gamma", "", "delta"]


def test_hdfs_round_trip_through_the_webhdfs_stub(tmp_path, monkeypatch):
    monkeypatch.delenv("DRYAD_TPU_DFS_GATEWAY", raising=False)
    t = _table(6, n=500)
    with WebHdfsStubServer(str(tmp_path / "hdfs")) as nn:
        uri = f"hdfs://{nn.host}:{nn.port}/warehouse/t"
        jc, tc = _ctxs()
        tc.from_arrays(t).group_by("k", INT_AGGS).to_store(uri)
        assert nn.redirects > 0
        local = str(tmp_path / "local")
        jc.from_arrays(t).group_by("k", INT_AGGS).to_store(local)
        assert _store_bytes(str(tmp_path / "hdfs" / "warehouse" / "t")) == _store_bytes(local)
        _assert_tables_equal(T.DryadContext(num_partitions_=P, device="cpu").from_store(uri).collect(),
                             J.DryadContext(num_partitions_=P).from_store(uri).collect())


@pytest.mark.parametrize("scheme", ["wasb", "abfs"])
def test_azure_blob_round_trip_through_the_reference_stub(tmp_path, monkeypatch, scheme):
    monkeypatch.delenv("DRYAD_TPU_DFS_GATEWAY", raising=False)
    t = _table(7, n=400)
    with AzureBlobStubServer(str(tmp_path / "az")) as srv:
        uri = f"{scheme}://warehouse@{srv.host}:{srv.port}/tables/t"
        T.DryadContext(num_partitions_=P, device="cpu").from_arrays(t).to_store(uri)
        assert srv.bytes_written > 0
        jq = J.DryadContext(num_partitions_=P).from_store(uri)
        tq = T.DryadContext(num_partitions_=P, device="cpu").from_store(uri)
        _assert_tables_equal(tq.collect(), jq.collect())
        assert srv.bytes_read > 0


def test_http_and_the_gateway_name_their_roadmap_item(tmp_path, monkeypatch):
    """``http://`` and the file gateway route of ``hdfs://``, ``wasb://``
    and ``abfs://`` resolve to the ``ServiceClient`` providers, as the
    reference's do; an unknown scheme raises ValueError in both."""
    from dryad_tpu.columnar import uri as juri

    monkeypatch.setenv("DRYAD_TPU_DFS_GATEWAY", "127.0.0.1:1")
    for mod in (turi, juri):
        assert isinstance(mod.get_provider("http://127.0.0.1:1/x")[0], mod.HttpStoreProvider)
        assert mod.WebHdfsProvider()._gateway().scheme == "hdfs"
        for scheme in ("wasb", "abfs"):
            p = mod.get_provider(f"{scheme}://c@h:1/x")[0]
            assert p._route("c@h:1/x") is None and p.gateway.scheme == scheme
        with pytest.raises(ValueError, match="no data provider"):
            mod.get_provider("s3://bucket/x")


@pytest.fixture()
def file_server(tmp_path):
    from dryad_tpu_torch.cluster.service import ProcessService

    with ProcessService(str(tmp_path / "fs")) as svc:
        yield svc


def _server_files(root, rel):
    d = os.path.join(root, rel)
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("name", ["table", "group_by"])
def test_http_store_files_byte_equal_to_the_reference(tmp_path, file_server, name):
    """Each package writes the same query to ``http://`` stores on one
    port ``ProcessService``: the files on the server are byte-equal, and
    each package reads the other's store back."""
    t = _table(11, n=1500)
    jc, tc = _ctxs()
    base = f"http://127.0.0.1:{file_server.port}"
    STORE_QUERIES[name](jc, t).to_store(f"{base}/stores/j")
    STORE_QUERIES[name](tc, t).to_store(f"{base}/stores/t")
    root = str(tmp_path / "fs")
    assert _server_files(root, "stores/j") == _server_files(root, "stores/t")
    a = J.DryadContext(num_partitions_=P).from_store(f"{base}/stores/t").collect()
    b = T.DryadContext(num_partitions_=P, device="cpu").from_store(f"{base}/stores/j").collect()
    _assert_tables_equal(b, a)


def test_terasort_from_to_http_store(file_server):
    """The reference's remote-store TeraSort: read the input from
    ``http://``, sort, write the output to ``http://``, read it back."""
    rng = np.random.default_rng(3)
    n = 4000
    tbl = {"key": rng.integers(-(2 ** 31), 2 ** 31 - 1, n).astype(np.int32),
           "payload": rng.standard_normal(n).astype(np.float32)}
    base = f"http://127.0.0.1:{file_server.port}"
    T.DryadContext(num_partitions_=P, device="cpu").from_arrays(tbl).to_store(f"{base}/in")
    T.DryadContext(num_partitions_=P, device="cpu").from_store(f"{base}/in").order_by(
        ["key"]).to_store(f"{base}/sorted")
    out = T.DryadContext(num_partitions_=P, device="cpu").from_store(f"{base}/sorted").collect()
    np.testing.assert_array_equal(out["key"], np.sort(tbl["key"]))
    assert len(out["payload"]) == n


@pytest.mark.parametrize("scheme", ["hdfs", "wasb", "abfs"])
def test_dfs_gateway_round_trip_byte_equal_to_the_reference(tmp_path, file_server, monkeypatch,
                                                            scheme):
    """With ``DRYAD_TPU_DFS_GATEWAY`` set, a DFS URI's store lives under
    ``<gateway>/<scheme>/<authority>/<path>``: the same files as the
    reference's, read back by either package."""
    monkeypatch.setenv("DRYAD_TPU_DFS_GATEWAY", f"127.0.0.1:{file_server.port}")
    rng = np.random.default_rng(4)
    tbl = {"k": rng.integers(0, 50, 400).astype(np.int32)}
    jc, tc = _ctxs()
    auth = "nn.example:9000" if scheme == "hdfs" else "c@acct.example"
    juri_, turi_ = f"{scheme}://{auth}/warehouse/j", f"{scheme}://{auth}/warehouse/t"
    jc.from_arrays(tbl).group_by("k", {"c": ("count", None)}).to_store(juri_)
    tc.from_arrays(tbl).group_by("k", {"c": ("count", None)}).to_store(turi_)
    root = str(tmp_path / "fs")
    assert _server_files(root, f"{scheme}/{auth}/warehouse/j") == \
        _server_files(root, f"{scheme}/{auth}/warehouse/t")
    out = T.DryadContext(num_partitions_=P, device="cpu").from_store(juri_).collect()
    got = dict(zip(out["k"].tolist(), out["c"].tolist()))
    want = np.bincount(tbl["k"], minlength=50)
    assert got == {int(k): int(c) for k, c in enumerate(want) if c}
    _assert_tables_equal(out, J.DryadContext(num_partitions_=P).from_store(turi_).collect())


def test_wasb_without_a_container_uses_its_authority_as_the_gateway(tmp_path, file_server,
                                                                  monkeypatch):
    monkeypatch.delenv("DRYAD_TPU_DFS_GATEWAY", raising=False)
    tbl = {"v": np.arange(64, dtype=np.int32)}
    uri = f"wasb://127.0.0.1:{file_server.port}/container/blob"
    T.DryadContext(num_partitions_=P, device="cpu").from_arrays(tbl).to_store(uri)
    assert os.path.isdir(str(tmp_path / "fs" / "container" / "blob"))
    for ctx in (T.DryadContext(num_partitions_=P, device="cpu"), J.DryadContext(num_partitions_=P)):
        assert sorted(ctx.from_store(uri).collect()["v"].tolist()) == list(range(64))


def test_tlv_blocks_equal_the_reference_binding():
    """The TLV property block codec (native, and its Python twin) gives
    the reference binding's bytes and entries, and rejects what the
    reference rejects."""
    from dryad_tpu.runtime import bindings as JB

    rng = np.random.default_rng(5)
    cases = [
        [(1, b"hello"), (42, b""), (65535, bytes(range(256)))],
        [],
        [(int(t), rng.integers(0, 256, int(n), dtype=np.uint8).tobytes())
         for t, n in zip(rng.integers(0, 65536, 50), rng.integers(0, 300, 50))],
    ]
    for entries in cases:
        buf = RB.tlv_encode(entries)
        assert buf == JB.tlv_encode(entries)
        assert RB.tlv_decode(buf) == JB.tlv_decode(buf) == entries
    buf = RB.tlv_encode(cases[0])
    for bad in (buf[:-1], b"\x01\x00"):
        with pytest.raises(ValueError):
            RB.tlv_decode(bad)
    for tag in (0x10000, -1):
        with pytest.raises(ValueError):
            RB.tlv_encode([(tag, b"x")])
    assert RB.io_native_loaded()


def test_tlv_python_twin_equals_the_native_routines(monkeypatch):
    entries = [(7, b"abc"), (0, b""), (300, bytes(range(200)))]
    native = RB.tlv_encode(entries)
    monkeypatch.setattr(RB, "_load_io", lambda: None)
    assert RB.tlv_encode(entries) == native
    assert RB.tlv_decode(native) == entries
    with pytest.raises(ValueError):
        RB.tlv_decode(native[:-2])


# -- codecs, ingest, results ---------------------------------------------------------

CODEC_COLS = {
    "z": ("ComplexCodec", lambda rng, n: rng.standard_normal(n) + 1j * rng.standard_normal(n)),
    "ts": ("DatetimeCodec", lambda rng, n: np.datetime64("2020-01-01T00:00:00", "us")
           + rng.integers(0, 10**12, n).astype("timedelta64[us]")),
    "pr": ("PairCodec", lambda rng, n: [(float(a), float(b)) for a, b in rng.integers(0, 9, (n, 2))]),
}


def test_codecs_through_a_query_equal_the_reference():
    rng = np.random.default_rng(8)
    n = 600
    t = {"k": rng.integers(0, 30, n).astype(np.int32)}
    t.update({c: gen(rng, n) for c, (_, gen) in CODEC_COLS.items()})
    outs = []
    for ctx, mod in zip(_ctxs(), (jcodecs, tcodecs)):
        codecs = {c: getattr(mod, name)() for c, (name, _) in CODEC_COLS.items()}
        q = ctx.from_arrays(t, codecs=codecs)
        outs.append((q.where(lambda c: c["k"] < 20).order_by([("k", False), ("ts.us", True)]).collect(),
                     q.project(["k", "z.re"]).collect()))
    (ja, jb), (ta, tb) = outs
    assert list(ta) == list(ja) and sorted(ta) == ["k", "pr", "ts", "z"]
    for c in ja:
        assert ta[c].dtype == ja[c].dtype, c
        assert ta[c].tolist() == ja[c].tolist(), c
    _assert_tables_equal(tb, jb)
    with pytest.raises(ValueError, match="declared"):
        class Bad(tcodecs.ComplexCodec):
            def encode(self, values):
                return {"re": np.zeros(len(values), np.float32)}
        T.DryadContext(num_partitions_=P, device="cpu").from_arrays({"z": t["z"]}, codecs={"z": Bad()})


def test_multi_file_from_text_equals_the_reference(tmp_path):
    rng = np.random.default_rng(9)
    words = np.array(["the", "a", "fox", "é", "naïveté", "longerthaneight", "x"], object)
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"part{i}.txt"))
        toks = words[rng.integers(0, len(words), 200 + 50 * i)]
        with open(paths[-1], "w", encoding="utf-8") as fh:
            fh.write(" ".join(toks) + ("\n" if i % 2 else "\t"))
    jc, tc = _ctxs()
    jq, tq = jc.from_text(paths), tc.from_text(paths)
    assert tc.io_native is True
    jb, tb = jc._bind_device(jq.node), tc._bind_device(tq.node)
    for c in jb.data:
        np.testing.assert_array_equal(tb.data[c].numpy().reshape(-1),
                                      np.asarray(jb.data[c]).astype(np.int64), err_msg=c)
    assert tc.dictionary._map == jc.dictionary._map
    np.testing.assert_array_equal(tq.node.params["str_vocab"]["word"], jq.node.params["str_vocab"]["word"])
    one = T.DryadContext(num_partitions_=P, device="cpu").from_text(
        b"".join(open(p, "rb").read() for p in paths))
    gb = {"n": ("count", None)}
    _assert_tables_equal(tq.group_by("word", gb).collect(), one.group_by("word", gb).collect())
    _assert_tables_equal(tq.group_by("word", gb).collect(), jq.group_by("word", gb).collect())
    assert tc.from_text([]).collect()["word"].tolist() == []


def test_submit_equals_collect_and_to_store_returns_the_rows(tmp_path):
    t = _table(10)
    jc, tc = _ctxs()
    q = tc.from_arrays(t).group_by("s", {"n": ("count", None), "mx": ("max", "w")})
    h = q.submit()
    assert h.path is None
    _assert_tables_equal(h.result(), q.collect())
    _assert_tables_equal(h.result(), jc.from_arrays(t).group_by(
        "s", {"n": ("count", None), "mx": ("max", "w")}).submit().result())
    st = q.to_store(str(tmp_path / "s"))
    assert st.path == str(tmp_path / "s")
    _assert_tables_equal(st.result(), q.collect())
    assert {"run_s", "fetch_s", "write_s", "write_bytes"} <= set(tc.io_stats)
    stored = tio.read_store(st.path)[1]
    assert tc.io_stats["write_bytes"] == sum(a.nbytes for part in stored for a in part.values())


def test_compression_config_is_checked():
    with pytest.raises(ValueError, match="intermediate_compression"):
        T.DryadContext(config=T.DryadConfig(intermediate_compression="gzip"), device="cpu")
    with pytest.raises(ValueError, match="obs_events_mem_cap"):
        T.DryadContext(config=T.DryadConfig(obs_events_mem_cap=-1), device="cpu")
