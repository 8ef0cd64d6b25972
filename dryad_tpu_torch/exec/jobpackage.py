"""Job packages — the serialized submission artifact (the counterpart
of ``dryad_tpu/exec/jobpackage.py``).

The reference ships a job as staged resources: the generated vertex
DLL, the XML query plan, and a serialized object store of client-side
objects captured by lambdas (``LinqToDryad/DryadLinqObjectStore.cs:173``).
Here the logical plan IS Python objects, so a job package is one pickle
blob holding the node DAG, the input bindings (host tables, store
partitions), the string dictionary and the config.  A worker process
told the package path over the mailbox loads it into a context of its
own, on its own device, and runs it.

User functions (lambdas and ``__main__``-level defs included) ship BY
VALUE through cloudpickle when it imports.  Without cloudpickle the
standard pickler applies, functions ship by reference and must live in
a module the worker can import; a lambda then fails to pack with the
standard pickler's own error.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional

import numpy as np

from dryad_tpu_torch.plan.nodes import fresh_id, walk

try:
    import cloudpickle as _pickler
except ImportError:  # the card's machine may lack it
    _pickler = pickle

PACKAGE_VERSION = 1


def pack_query(
    query, path: str, binding_overrides: Optional[Dict[int, tuple]] = None
) -> Dict[str, Any]:
    """Serialize a lazy Query (plan + reachable input bindings +
    dictionary + config) to ``path``.  Returns the manifest summary.

    ``binding_overrides``: node id -> replacement binding shipped in
    place of the context's (the driver-routed ``host_routed`` layouts
    of co-partitioned vertex submissions); the live context's bindings
    stay untouched."""
    ctx = query.ctx
    nodes = walk([query.node])
    bindings: Dict[int, tuple] = {}
    overrides = binding_overrides or {}
    for n in nodes:
        if n.id in overrides:
            bindings[n.id] = overrides[n.id]
            continue
        if n.id in ctx._bindings:
            kind = ctx._bindings[n.id][0]
            if kind == "device":
                raise ValueError(
                    "cannot pack a query over device-resident bindings; "
                    "materialize to host or a store first"
                )
            bindings[n.id] = ctx._bindings[n.id]
    blob = {
        "version": PACKAGE_VERSION,
        "node": query.node,
        "bindings": bindings,
        "dictionary": dict(ctx.dictionary._map),
        "config": ctx.config,
    }
    with open(path, "wb") as fh:
        _pickler.dump(blob, fh, protocol=pickle.HIGHEST_PROTOCOL)
    return {
        "version": PACKAGE_VERSION,
        "nodes": len(nodes),
        "bindings": len(bindings),
        "dict_entries": len(ctx.dictionary._map),
    }


def load_query(path: str, ctx=None, mesh=None, device=None,
               num_partitions: Optional[int] = None):
    """Load a job package into a (possibly provided) context and return
    the lazy Query, NOT yet executed.  ``mesh`` lets a worker run the
    plan over a specific mesh (a gang's, spanning processes, or a
    one-partition mesh for a vertex task); ``device`` and
    ``num_partitions`` build the fresh context otherwise (from the
    packaged config) when ``ctx`` is None."""
    from dryad_tpu_torch.api.context import DryadContext
    from dryad_tpu_torch.api.query import Query

    if ctx is not None and (mesh is not None or device is not None or num_partitions is not None):
        raise ValueError(
            "pass either ctx or device/num_partitions/mesh, not both (a "
            "provided ctx already owns its mesh, device and partitions)"
        )
    with open(path, "rb") as fh:
        blob = pickle.load(fh)
    if blob.get("version") != PACKAGE_VERSION:
        raise ValueError(f"unsupported package version {blob.get('version')}")
    if ctx is None:
        ctx = DryadContext(num_partitions, config=blob["config"], device=device, mesh=mesh)
    ctx.dictionary._map.update(blob["dictionary"])
    # Re-key the loaded DAG onto THIS process's node-id counter: ids are
    # process-local, and a loaded DAG carrying the packer's ids collides
    # with nodes built here (lowering's own nodes, a second package);
    # walk would silently drop one of the twins.
    remap: Dict[int, int] = {}
    for n in walk([blob["node"]]):
        remap[n.id] = n.id = fresh_id()
    ctx._bindings.update(
        {remap[i]: b for i, b in blob["bindings"].items() if i in remap}
    )
    return Query(ctx, blob["node"])


def slice_binding(binding: tuple, part: int, nparts: int) -> tuple:
    """Restrict one packed input binding to vertex-task ``part`` of
    ``nparts`` (a ``DrStorageVertex`` holds one input partition,
    ``GraphManager/vertex/DrVertex.h:146``).  Host rows split into
    ``nparts`` contiguous blocks; store partitions deal round-robin.
    The union over parts is exactly the full input."""
    kind, *rest = binding
    if kind == "host":
        arrays, _cap = rest
        return (
            "host",
            {k: np.array_split(np.asarray(v), nparts)[part]
             for k, v in arrays.items()},
            None,
        )
    if kind == "host_routed":
        # driver-routed layout: rows pre-ordered by key bucket, part p
        # owns [offsets[p], offsets[p+1]) — the co-partitioned input
        # channels of a routed join/sort vertex submission
        arrays, offsets = rest
        lo, hi = int(offsets[part]), int(offsets[part + 1])
        return (
            "host",
            {k: np.asarray(v)[lo:hi] for k, v in arrays.items()},
            None,
        )
    if kind == "host_physical":
        phys, *_opt = rest
        return (
            "host_physical",
            {k: np.array_split(np.asarray(v), nparts)[part]
             for k, v in phys.items()},
        )
    if kind == "store":
        parts, schema = rest
        return ("store", parts[part::nparts], schema)
    raise ValueError(f"cannot slice binding kind {kind!r}")


def run_package(path: str, ctx=None, device=None):
    """Load a job package and execute it, returning the host table."""
    return load_query(path, ctx=ctx, device=device).collect()
