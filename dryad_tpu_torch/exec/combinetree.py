"""Topology- and distribution-aware combine trees (the counterpart of
``dryad_tpu/exec/combinetree.py``).

Two observations shape the streaming group_by's combine path:

1. **Placement.** Per-chunk partial batches are co-hash-partitioned on
   the group keys (every chunk's partial ``group_by`` used the same
   hash over the same P partitions), so equal keys are colocated across
   chunks and an intermediate merge needs no exchange: concat + one
   local reduce (``assume_hash_partition`` elides the exchange).  Only
   the final fold pays one full exchange, which on a hybrid mesh rides
   the tree exchange (``exec/kernels.py::_tree_exchange_hash``): one
   ICI hop, the per-slice combine, then exactly one DCN hop.
2. **Distribution.** Partials are placed onto tree groups by
   key-histogram similarity: chunks with similar key distributions
   merge early because they collapse more.  The same per-key-range
   histograms (``obs/metrics.py::KeyRangeHistogram``) drive per-range
   host degradation: a range whose distinct-key estimate tracks its row
   count never reduces under merging and streams to host accumulation,
   while hot, still-reducing ranges stay on the device.

The device combine path here reads no table and no batch payload:
placement decisions read histogram snapshots only.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from dryad_tpu_torch.parallel.mesh import dcn_slice_count, ici_partitions_per_slice

# evidence floor: a key range must have shown at least this many rows
# before its reduction estimate may degrade it to host accumulation
MIN_DEGRADE_ROWS = 512


# -- tree shape / byte accounting -------------------------------------------


class TreeShape:
    """Mesh-derived tree geometry: level-0 group count and the ICI/DCN
    extents the byte estimator splits exchange traffic over.  A flat
    mesh is one slice of P partitions (``ici_bytes`` counts the bytes
    that change partition, ``dcn_bytes`` is 0); a hybrid mesh is
    ``dcn_slices`` slices of ``ici`` partitions."""

    __slots__ = ("groups", "dcn_slices", "ici_partitions", "fan")

    def __init__(self, mesh, config) -> None:
        self.dcn_slices = dcn_slice_count(mesh)
        self.ici_partitions = ici_partitions_per_slice(mesh)
        g = int(getattr(config, "combine_tree_groups", 0) or 0)
        # auto: one level-0 group per DCN slice keeps every pre-fold
        # merge off the DCN; flat meshes get a small similarity fan
        self.groups = g if g > 0 else max(self.dcn_slices, 1)
        if self.groups == 1 and self.dcn_slices == 1:
            self.groups = 4
        self.fan = max(2, int(getattr(config, "combine_tree_fan", 16)))

    def exchange_split(self, in_bytes: int, out_bytes: int) -> Tuple[int, int]:
        """Estimated (ici_bytes, dcn_bytes) one full hash exchange
        moves for a merge of ``in_bytes`` of partial layout folding to
        ``out_bytes``.  On a hybrid mesh the tree exchange pays hop 1
        over ICI at input volume and hop 2 over DCN at the per-slice
        combined volume; a flat mesh has no DCN at all.  Uniform-hash
        destinations make a (n-1)/n fraction of rows cross."""
        d, p = self.dcn_slices, self.ici_partitions
        ici = in_bytes * (p - 1) // p if p > 1 else 0
        dcn = (
            min(in_bytes, out_bytes) * (d - 1) // d if d > 1 else 0
        )
        return ici, dcn


def batch_bytes(batch) -> int:
    """Layout bytes of a device batch — shape metadata only, no
    readback (``nbytes`` never syncs the dispatch loop)."""
    return sum(int(v.nbytes) for v in batch.data.values()) + int(
        batch.valid.nbytes
    )


def layout_rows(batch) -> int:
    """Layout rows of a partial batch as the reference counts them: P *
    cap (the reference's ``capacity``; the port's batch counts capacity
    per partition).  The stream driver compacts the tree's batches and
    records the reference's count of the un-compacted layout as
    ``nominal_rows``; the tree's flush cadence and its events follow
    that count."""
    nominal = getattr(batch, "nominal_rows", None)
    return int(batch.valid.numel()) if nominal is None else nominal


def neutral_snapshot(ranges: int) -> Dict[str, Any]:
    """Histogram snapshot for a chunk whose keys cannot be hashed
    host-side (physical pre-encoded chunks): zero counts everywhere, so
    similarity placement treats it as shapeless (empty-group preferred)
    and the degrade planner never acts on it."""
    return {
        "ranges": ranges,
        "rows": 0,
        "counts": [0] * ranges,
        "distinct": [0] * ranges,
        "reduction_ratios": [0.0] * ranges,
    }


# -- similarity placement (snapshot-only) -----------------------------------


def _cosine(a, b) -> float:
    """Cosine similarity of two per-range count vectors; 0 when either
    is empty.  A plain-Python fold over count lists."""
    dot = na = nb = 0.0
    for x, y in zip(a, b):
        fx, fy = float(x), float(y)
        dot += fx * fy
        na += fx * fx
        nb += fy * fy
    if na <= 0.0 or nb <= 0.0:
        return 0.0
    return dot / ((na ** 0.5) * (nb ** 0.5))


def place(snapshot: Dict[str, Any], centroids: Sequence[Any]) -> int:
    """Pick the tree group for one partial from its key-range snapshot:
    the group whose accumulated count vector is most SIMILAR (similar
    distributions collapse more under merging), preferring an empty
    group over a dissimilar one.  Reads the snapshot dict only."""
    counts = snapshot["counts"]
    best, best_sim, empty = -1, -1.0, -1
    for gi, cent in enumerate(centroids):
        if cent is None:
            if empty < 0:
                empty = gi
            continue
        sim = _cosine(counts, cent)
        if sim > best_sim:
            best, best_sim = gi, sim
    if best_sim <= 0.0 and empty >= 0:
        return empty  # empty group beats any fully-dissimilar one
    return max(best, 0)


def plan_groups(
    snapshots: Sequence[Dict[str, Any]], n_groups: int
) -> List[List[int]]:
    """Similarity grouping of N partials into at most ``n_groups``
    merge groups (the gang driver's level-0 plan): greedy placement of
    each snapshot against running centroids, exactly the device tree's
    routing applied post-hoc.  Reads snapshots only."""
    n_groups = max(1, min(n_groups, len(snapshots)))
    groups: List[List[int]] = [[] for _ in range(n_groups)]
    centroids: List[Optional[List[float]]] = [None] * n_groups
    for i, snap in enumerate(snapshots):
        gi = place(snap, centroids)
        groups[gi].append(i)
        counts = snap["counts"]
        if centroids[gi] is None:
            centroids[gi] = [float(c) for c in counts]
        else:
            cent = centroids[gi]
            for r, c in enumerate(counts):
                cent[r] += float(c)
    return [g for g in groups if g]


# -- per-key-range degrade planner ------------------------------------------


class CombineTreePlanner:
    """Accumulates the stream's key-range distribution and decides
    which ranges stop paying for device merging.

    A range degrades when its cumulative distinct-key estimate is at
    least ``degrade_ratio`` of its cumulative row count (merging keeps
    >= that fraction of rows — the per-range analog of the flat
    combiner's 3/4 capacity check) once it has ``MIN_DEGRADE_ROWS`` of
    evidence.  Decisions consume histogram snapshots only."""

    def __init__(self, ranges: int, degrade_ratio: float) -> None:
        self.ranges = ranges
        self.degrade_ratio = float(degrade_ratio)
        self._counts = [0] * ranges
        self._distinct = [0.0] * ranges
        self._degraded: set = set()

    def note_chunk(self, snapshot: Dict[str, Any]) -> None:
        """Fold one chunk's snapshot into the cumulative view.  The
        cumulative distinct estimate per range is the max of per-chunk
        estimates and the running sum-of-new-mass lower bound is
        skipped: summing per-chunk distinct OVERCOUNTS recurring keys,
        which is exactly the signal — a range where the per-chunk sum
        keeps growing ahead of any one chunk's estimate is recurring
        (reducible), one where counts and distinct grow in lockstep is
        not."""
        counts = snapshot["counts"]
        distinct = snapshot["distinct"]
        for r in range(self.ranges):
            self._counts[r] += int(counts[r])
            self._distinct[r] = max(self._distinct[r], float(distinct[r]))

    def note_cumulative(self, snapshot: Dict[str, Any]) -> None:
        """Replace the cumulative view with an already-merged stream
        snapshot (the driver keeps ONE merged histogram; its distinct
        estimates span the whole stream)."""
        counts = snapshot["counts"]
        distinct = snapshot["distinct"]
        for r in range(self.ranges):
            self._counts[r] = int(counts[r])
            self._distinct[r] = float(distinct[r])

    def degrade_set(self) -> set:
        """Ranges that should stream to host accumulation (monotone:
        once degraded a range stays degraded for the stream — the
        re-probe lever for the FLAT host path lives in the driver)."""
        for r in range(self.ranges):
            if r in self._degraded:
                continue
            c = self._counts[r]
            if c < MIN_DEGRADE_ROWS:
                continue
            if self._distinct[r] >= self.degrade_ratio * c:
                self._degraded.add(r)
        return set(self._degraded)

    def degraded_fraction(self) -> float:
        return len(self._degraded) / float(self.ranges)


# -- the device-side tree combiner ------------------------------------------


class TreeCombiner:
    """Hierarchical accumulator of device-resident partial batches.

    Level 0: per-group pending lists, routed by :func:`place`; a group
    flush is ONE elided N-ary concat+local-reduce (``merge_local`` —
    zero collective bytes, stable fan-in, compile reuse).  Level 1:
    flushed representatives; when they pile past the fan they fold
    through ``merge_local`` again (still exchange-free — partials stay
    co-partitioned under local reduction).  The single exchanged merge
    is the CALLER's final fold+finalize query — the one DCN hop.

    No capacity-based reduction check lives here: whether device
    merging pays is the planner's per-key-range call, made from
    histogram snapshots before batches ever reach the tree."""

    def __init__(
        self,
        merge_local: Callable[[List[Any]], Any],
        shape: TreeShape,
        combine_rows: int,
        emit: Callable[..., None],
    ) -> None:
        self._merge_local = merge_local
        self._shape = shape
        self._combine_rows = max(1, int(combine_rows))
        self._emit = emit
        self._pending: List[List[Any]] = [[] for _ in range(shape.groups)]
        self._caps: List[int] = [0] * shape.groups
        self._centroids: List[Optional[List[float]]] = [None] * shape.groups
        self._reps: List[Any] = []
        self.max_level = 0

    def _group_threshold(self) -> int:
        # divide the row budget over the groups HOLDING batches, not all
        # groups: a low-skew stream routes every partial to one group,
        # and billing that group a 1/groups share would flush 4x more
        # eagerly than the flat baseline for the same HBM bound.  Total
        # held rows stay <= combine_rows either way.
        active = sum(1 for p in self._pending if p) or 1
        return max(1, self._combine_rows // active)

    def push(self, batch, snapshot: Dict[str, Any]) -> None:
        """Route one partial batch to its similarity group; flush the
        group when its layout rows pass the per-group threshold or the
        fan cap.  Never signals degrade — that is the planner's job."""
        gi = place(snapshot, self._centroids)
        self._pending[gi].append(batch)
        self._caps[gi] += layout_rows(batch)
        counts = snapshot["counts"]
        if self._centroids[gi] is None:
            self._centroids[gi] = [float(c) for c in counts]
        else:
            cent = self._centroids[gi]
            for r, c in enumerate(counts):
                cent[r] += float(c)
        if (
            len(self._pending[gi]) >= 2
            and (
                self._caps[gi] > self._group_threshold()
                or len(self._pending[gi]) >= self._shape.fan
            )
        ):
            self._flush_group(gi)
        if len(self._reps) >= self._shape.fan:
            self._fold_reps()

    def _flush_group(self, gi: int) -> None:
        batches = self._pending[gi]
        in_bytes = sum(batch_bytes(b) for b in batches)
        fan = len(batches)
        merged = self._merge_local(batches)
        self._pending[gi] = []
        self._caps[gi] = 0
        self._reps.append(merged)
        self._emit(
            "combine_tree_level", level=0, group=gi, fan_in=fan,
            cap_rows=layout_rows(merged), bytes=in_bytes,
            ici_bytes=0, dcn_bytes=0, device=True,
        )

    def _fold_reps(self) -> None:
        """Collapse level-1 representatives with another elided merge —
        representatives are still co-partitioned partials, so no
        exchange is due yet."""
        reps = self._reps
        in_bytes = sum(batch_bytes(b) for b in reps)
        fan = len(reps)
        merged = self._merge_local(reps)
        self.max_level = max(self.max_level, 1)
        self._reps = [merged]
        self._emit(
            "combine_tree_level", level=1, fan_in=fan,
            cap_rows=layout_rows(merged), bytes=in_bytes,
            ici_bytes=0, dcn_bytes=0, device=True,
        )

    def drain(self) -> List[Any]:
        """All held batches (per-range degrade hands the remainder to
        the host path); the tree is empty afterwards."""
        out: List[Any] = []
        for gi in range(len(self._pending)):
            out.extend(self._pending[gi])
            self._pending[gi] = []
            self._caps[gi] = 0
        out.extend(self._reps)
        self._reps = []
        return out

    def fold(self, width: int = 1):
        """The surviving partials reduced via elided merges (bounded fan
        per program) down to at most ``max(width, 1)`` batches; empty
        list when nothing was pushed.  Elided merges are nearly free,
        while whatever the caller does next — the exchanged root
        reduction, or a D2H into host accumulation — pays per byte it
        ingests, so callers fold to 1 and hand the minimum onward."""
        left = self.drain()
        while len(left) > max(1, width):
            take = left[: self._shape.fan]  # always >= 2 (fan >= 2)
            left = left[self._shape.fan:]
            in_bytes = sum(batch_bytes(b) for b in take)
            merged = self._merge_local(take)
            self.max_level = max(self.max_level, 1)
            self._emit(
                "combine_tree_level", level=1, fan_in=len(take),
                cap_rows=layout_rows(merged), bytes=in_bytes,
                ici_bytes=0, dcn_bytes=0, device=True,
            )
            left.append(merged)
        return left
