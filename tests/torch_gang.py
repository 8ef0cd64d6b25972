"""Helpers of the gang tests of the port (not a test module).

``run_ranks(world, fn, *args)`` starts ``world`` processes that join one
``gloo`` group on the CPU (``parallel/multihost.py::init_distributed``)
and returns each rank's ``fn(rank, world, *args)``.  ``CORPUS`` holds
the op corpus: query plans written against the API both packages
share, run at ``P`` partitions by one process or by a gang whose ranks
each hold ``P / world`` of them.  Nothing here imports jax or the JAX
package: the ranks import this module.
"""

from __future__ import annotations

import multiprocessing
import os
import socket
import traceback

import numpy as np

GROUP_TIMEOUT_S = 60.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, fn_name, args, timeout, queue):
    try:
        from dryad_tpu_torch.parallel.multihost import init_distributed

        init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu", timeout=timeout)
        queue.put((rank, globals()[fn_name](rank, world, *args), None))
    except BaseException:  # noqa: BLE001 - reported to the parent
        queue.put((rank, None, traceback.format_exc()))


def run_ranks(world: int, fn_name: str, *args, timeout: float = GROUP_TIMEOUT_S, wait: float = 240.0):
    """``[fn(rank, world, *args) for rank in range(world)]``, each in a
    process of its own over one gloo group; raises with the first
    rank's traceback when any rank failed."""
    mp = multiprocessing.get_context("spawn")
    queue = mp.Queue()
    port = free_port()
    procs = [
        mp.Process(target=_rank_main, args=(r, world, port, fn_name, args, timeout, queue))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    out, errs = {}, {}
    try:
        for _ in range(world):
            rank, value, err = queue.get(timeout=wait)
            out[rank] = value
            if err:
                errs[rank] = err
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    if errs:
        r = min(errs)
        raise RuntimeError(f"rank {r} of {world} failed:\n{errs[r]}")
    return [out[r] for r in range(world)]


# -- the collectives of parallel/partition.py ---------------------------------------

def collectives_case(rank, world, P, seed):
    """Every collective of the partition layer on this rank's rows of
    seeded ``(P, ...)`` tensors; returns each result as numpy."""
    import torch

    from dryad_tpu_torch.parallel import partition as PART
    from dryad_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(P, "cpu")
    rows = slice(mesh.base, mesh.base + mesh.local)
    t = collectives_inputs(P, seed)
    mine = {k: torch.from_numpy(v[rows].copy()) for k, v in t.items()}
    return collectives_apply(PART, mine, mesh, P)


def collectives_inputs(P, seed):
    rng = np.random.default_rng(seed)
    B = 3
    return {
        "i": rng.integers(-1000, 1000, (P, P * 5)).astype(np.int64),
        "f": rng.standard_normal((P, P * 5)).astype(np.float32),
        "n": rng.integers(0, 50, (P,)).astype(np.int64),
        "send": rng.integers(-99, 99, (P, P, B)).astype(np.int32),
        "b": rng.random((P, 7)) < 0.1,
    }


def collectives_apply(PART, t, mesh, P):
    """The collectives on ``t`` (this rank's rows); numpy results."""
    import torch

    prefix, total = PART.exclusive_prefix(t["n"], mesh)
    out = {
        "psum_scatter_i": PART.psum_scatter(t["i"], mesh),
        "psum_scatter_f": PART.psum_scatter(t["f"], mesh),
        "all_gather": PART.all_gather(t["i"], mesh),
        "all_to_all": PART.all_to_all(t["send"], mesh),
        "axis_index": PART.axis_index(P, "cpu", mesh),
        "psum_i": PART.psum(t["i"], mesh),
        "psum_f": PART.psum(t["f"], mesh),
        "pmin": PART.pmin(t["i"], mesh),
        "pmax": PART.pmax(t["f"], mesh),
        "any": PART.any_(t["b"], mesh),
        "prefix": prefix,
        "total": total,
        # a cyclic shift by 3 partitions; partition 1 receives nothing
        "ppermute": PART.ppermute(t["send"], [(s, (s + 3) % P) for s in range(P)
                                              if (s + 3) % P != 1], mesh),
        "first_valid": torch.tensor([
            -1 if v is None else int(v)
            for v in (PART.first_valid(t["n"], t["n"] > th, mesh) for th in (10, 40, 99))
        ]),
    }
    return {k: v.numpy().copy() for k, v in out.items()}


# -- the staged exchange over a group -------------------------------------------------

def staged_inputs(P, seed, cap=48):
    """A seeded ``(P, cap)`` batch (an int32 key, an f32 value, a uint32
    word on its int64 carrier, a bool) with a skewed destination."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 97, (P, cap)).astype(np.int32)
    k[rng.random((P, cap)) < 0.3] = 5  # one hot destination
    return {
        "k": k,
        "v": rng.standard_normal((P, cap)).astype(np.float32),
        "w": rng.integers(0, 2**32, (P, cap)).astype(np.int64),
        "b": rng.random((P, cap)) < 0.5,
        "valid": rng.random((P, cap)) < 0.85,
    }


def staged_apply(t, P, window, capacity, mesh, slack=1.5):
    """``exchange`` (window 0) or ``exchange_staged`` of ``t``'s rows,
    bound for ``k * 7 % P``; numpy columns, the valid mask, the overflow
    flag and the bytes the rank handed to the group."""
    import torch

    from dryad_tpu_torch.columnar.batch import ColumnBatch
    from dryad_tpu_torch.ops import shuffle as SH
    from dryad_tpu_torch.plan.xchgplan import plan_exchange

    b = ColumnBatch({c: torch.from_numpy(np.ascontiguousarray(t[c])) for c in ("k", "v", "w", "b")},
                    torch.from_numpy(np.ascontiguousarray(t["valid"])))
    dest = (b.data["k"].to(torch.int64) * 7) % P
    B = SH.bucket_capacity(b.capacity, P, slack)
    sent = 0 if mesh is None else mesh.sent_bytes
    if window:
        out, ovf = SH.exchange_staged(b, dest, P, B, plan_exchange(P, window), capacity, mesh)
    else:
        out, ovf = SH.exchange(b, dest, P, B, capacity, mesh)
    res = {c: v.numpy() for c, v in out.data.items()}
    res["valid"] = out.valid.numpy()
    res["overflow"] = np.array([bool(ovf)])
    res["sent"] = np.array([0 if mesh is None else mesh.sent_bytes - sent])
    return res


def staged_case(rank, world, P, seed, windows, capacity):
    """This rank's part of :func:`staged_apply` over a P-partition gang,
    at each of ``windows``."""
    from dryad_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(P, "cpu")
    rows = slice(mesh.base, mesh.base + mesh.local)
    t = {c: v[rows] for c, v in staged_inputs(P, seed).items()}
    return [staged_apply(t, P, w, capacity, mesh) for w in windows]


# -- the op corpus --------------------------------------------------------------------

CORPUS_ROWS = 3000


def corpus_table(n: int = CORPUS_ROWS) -> dict:
    rng = np.random.default_rng(11)
    return {
        "k": rng.integers(-2**31, 2**31, n, dtype=np.int32),
        "g": rng.integers(-60, 60, n).astype(np.int32),
        "d": rng.integers(0, 300, n).astype(np.int32),
        "b": rng.random(n) < 0.5,
        "s": np.array([f"w{i}" for i in rng.integers(0, 90, n)], object),
        "v": (rng.standard_normal(n) * 10.0 ** rng.integers(-2, 3, n)).astype(np.float32),
        "w": rng.integers(-1000, 1000, n).astype(np.int32),
        "L": rng.integers(-2**40, 2**40, n, dtype=np.int64),
        "id": np.arange(n, dtype=np.int32),
    }


def corpus_join_tables(n: int = CORPUS_ROWS):
    rng = np.random.default_rng(12)
    left = {"k": rng.integers(0, 300, n).astype(np.int32), "lv": np.arange(n, dtype=np.int32),
            "x": rng.standard_normal(n).astype(np.float32)}
    m = n // 4
    right = {"k": rng.integers(0, 360, m).astype(np.int32),
             "rv": rng.standard_normal(m).astype(np.float32),
             "w": rng.integers(-1000, 1000, m).astype(np.int32)}
    return left, right


AGGS = {"c": ("count", None), "sv": ("sum", "v"), "mv": ("mean", "v"), "mnw": ("min", "w"),
        "sL": ("sum", "L"), "mL": ("mean", "L"), "fw": ("first", "w"), "ab": ("any", "b")}


def _t(ctx):
    return ctx.from_arrays(corpus_table())


def _join(kind, strategy):
    def build(ctx):
        left, right = corpus_join_tables()
        a, b = ctx.from_arrays(left), ctx.from_arrays(right)
        if kind == "inner":
            return [a.join(b, "k", strategy=strategy)]
        if kind == "left":
            return [a.left_join(b, "k", right_defaults={"rv": -1.0}, strategy=strategy)]
        if kind == "semi":
            return [a.semi_join(b, "k", strategy=strategy), a.anti_join(b, "k", strategy=strategy)]
        if kind == "count":
            return [a.group_join_count(b, "k", strategy=strategy)]
        return [a.group_join(
            b, "k", order=[("rv", True)], rank_limit=2, strategy=strategy,
            selector=lambda p: p.group_by("gj_lid", {"m": ("count", None), "top": ("max", "rv")}),
            defaults={"m": 0})]
    return build


def _dowhile(ctx):
    q = ctx.from_arrays({"x": corpus_table()["w"]})
    return [q.do_while(lambda s: s.select(lambda c: {"x": c["x"] // 2}).distinct(),
                       lambda s: s.count_as_query().select(lambda c: {"go": c["count"] > 5}),
                       max_iter=30)]


def _fork(ctx):
    q = _t(ctx)
    a, b = q.fork(lambda bt: (bt.filter(bt["b"]), bt.filter(bt["w"] > 0)), [q.schema, q.schema])
    return [a, b]


def _dup_neg_w(cols):
    import torch

    w = cols["w"]
    return {"w": torch.stack([w, -w], 1)}, torch.stack([w > 0, w < 0], 1)


def _variance_dec():
    from dryad_tpu_torch import ColumnType, Decomposable

    return Decomposable(
        seed=lambda c: {"cnt": c["v"] * 0 + 1.0, "s1": c["v"], "s2": c["v"] * c["v"]},
        merge=lambda a, b: {k: a[k] + b[k] for k in ("cnt", "s1", "s2")},
        state_cols=["cnt", "s1", "s2"],
        finalize=lambda c: {**c, "var": c["s2"] / c["cnt"] - (c["s1"] / c["cnt"]) ** 2},
        out_fields=[(n, ColumnType.FLOAT32) for n in ("cnt", "s1", "s2", "var")])


CORPUS = {
    "terasort": lambda c: [_t(c).order_by([("k", False)])],
    "order_by_multikey": lambda c: [_t(c).order_by([("g", False), ("v", True), ("id", False)])],
    "group_by_sort_path": lambda c: [_t(c).group_by("g", AGGS)],
    "group_by_two_keys": lambda c: [_t(c).group_by(["g", "b"], AGGS)],
    "group_by_salt": lambda c: [_t(c).group_by("g", AGGS, salt=3)],
    "group_by_dense": lambda c: [_t(c).group_by("d", {"c": ("count", None), "sw": ("sum", "w"),
                                                      "sv": ("sum", "v")})],
    "group_by_string": lambda c: [_t(c).group_by("s", {"c": ("count", None), "sw": ("sum", "w")})],
    "distinct": lambda c: [_t(c).distinct(["g", "b"])],
    "hash_partition": lambda c: [_t(c).hash_partition(["g"])],
    "range_partition": lambda c: [_t(c).range_partition(["g"]).order_by([("g", False), ("id", False)])],
    "order_by_take": lambda c: [_t(c).order_by([("v", True)]).take(200)],
    "fan_reduced": lambda c: [_t(c).order_by([("id", False)]).take(500).group_by("g", {"n": ("count", None)})],
    "scalar": lambda c: [_t(c).aggregate_as_query({
        "n": ("count", None), "sv": ("sum", "v"), "mv": ("mean", "v"), "sw": ("sum", "w"),
        "mnw": ("min", "w"), "mxv": ("max", "v"), "sL": ("sum", "L"), "mnL": ("min", "L"),
        "mL": ("mean", "L"), "ab": ("any", "b"), "allb": ("all", "b")})],
    "scalar_empty": lambda c: [_t(c).where(lambda x: x["id"] < 0).aggregate_as_query({
        "n": ("count", None), "sv": ("sum", "v"), "mnw": ("min", "w")})],
    "rank_ops": lambda c: [_t(c).with_rank("r"), _t(c).take(37), _t(c).skip(CORPUS_ROWS - 50),
                           _t(c).tail(25)],
    "take_skip_while": lambda c: [_t(c).take_while(lambda x: x["id"] < 1700),
                                  _t(c).skip_while(lambda x: x["w"] < 900)],
    "reverse": lambda c: [_t(c).hash_partition(["g"]).reverse()],
    "default_if_empty": lambda c: [_t(c).where(lambda x: x["id"] < 0).default_if_empty(
        {"g": 3, "s": "none", "L": -5})],
    "zip": lambda c: [_t(c).zip_(_t(c).where(lambda x: x["b"]))],
    "sliding_window": lambda c: [_t(c).where(lambda x: x["g"] > 40).sliding_window(3, ["v", "w"])],
    "apply_with_index": lambda c: [_t(c).apply(
        lambda b, i: b.with_column("w", b["w"] * 0 + i).filter(b["b"]), cap_factor=2.0,
        with_index=True).group_by("w", {"n": ("count", None)})],
    "fork": _fork,
    "concat": lambda c: [_t(c).where(lambda x: x["b"]).concat(_t(c).where(lambda x: x["w"] > 500))],
    "project": lambda c: [_t(c).select(lambda x: {"y": x["w"] + 1, "g": x["g"]}).where(
        lambda x: x["y"] > 0)],
    "decomposable": lambda c: [_t(c).group_by("g", decomposable=_variance_dec())],
    "select_many": lambda c: [_t(c).select_many(_dup_neg_w, 2)],
    "do_while": _dowhile,
    "join_inner_shuffle": _join("inner", "shuffle"),
    "join_inner_broadcast": _join("inner", "broadcast"),
    "join_left_auto": _join("left", "auto"),
    "semi_anti": _join("semi", "shuffle"),
    "group_join_count": _join("count", "shuffle"),
    "group_join_ranked": _join("ranked", "shuffle"),
}

# the plans whose functions are written for torch only (the
# rest also build on the JAX package, for the reference comparison)
PORT_ONLY = {"decomposable", "select_many"}


def partition_rows(batch):
    """A ``(parts, cap)`` batch -> (capacity, [each partition's valid
    physical columns, uint32 words restored])."""
    from dryad_tpu_torch.columnar.batch import to_host_column

    valid = batch.valid.cpu().numpy()
    cols = {c: to_host_column(v) for c, v in batch.data.items()}
    return batch.capacity, [
        {c: v[i][valid[i]] for c, v in sorted(cols.items())} for i in range(valid.shape[0])
    ]


def run_corpus(ctx, names):
    """{name: [(capacity, partitions) per output]} of the corpus queries
    run in ``ctx``, and the stage op kinds they reached."""
    from dryad_tpu_torch.exec import kernels

    reached = set()
    apply_op = kernels.apply_op

    def recording(sctx, kind, p):
        reached.add(kind)
        if sctx.resize_to is not None:  # the plan's resize, fused into the exchange
            reached.add("resize")
        return apply_op(sctx, kind, p)

    kernels.apply_op = recording
    try:
        out = {n: [partition_rows(ctx.execute(q)) for q in CORPUS[n](ctx)] for n in names}
    finally:
        kernels.apply_op = apply_op
    return out, reached


def corpus_case(rank, world, P, names, window=0):
    """One rank's part of the op corpus over a P-partition gang, its
    exchanges staged at ``window`` (0: flat)."""
    from dryad_tpu_torch import DryadConfig, DryadContext
    from dryad_tpu_torch.parallel.mesh import make_mesh

    cfg = DryadConfig(exchange_window=window)
    return run_corpus(DryadContext(mesh=make_mesh(P, "cpu"), config=cfg), names)


def diverge_case(rank, world, P):
    """Rank 1 fails before its exchange; rank 0 runs on into it.
    Returns what each rank saw."""
    import time

    from dryad_tpu_torch import DryadContext
    from dryad_tpu_torch.parallel.mesh import make_mesh

    ctx = DryadContext(mesh=make_mesh(P, "cpu"))
    q = _t(ctx).hash_partition(["g"])
    t0 = time.monotonic()
    if rank == 1:
        return ("raised before the exchange", time.monotonic() - t0)
    try:
        ctx.execute(q)
    except Exception as e:  # noqa: BLE001 - the point of the case
        return (f"{type(e).__name__}: {e}", time.monotonic() - t0)
    return ("completed", time.monotonic() - t0)


# -- a gang worker's own modules -------------------------------------------------------

def forbidden_modules(cols, i):
    """``apply_host`` function: how many modules of jax or the JAX
    package the process running it holds, and its partition."""
    import sys

    bad = sum(1 for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "dryad_tpu"))
    return {"bad": np.array([bad], np.int32), "pid": np.array([i], np.int32)}


def forbidden_schema():
    from dryad_tpu_torch import ColumnType, Schema

    return Schema([("bad", ColumnType.INT32), ("pid", ColumnType.INT32)])
