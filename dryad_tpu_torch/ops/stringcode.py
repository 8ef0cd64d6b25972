"""Dictionary-code lookup for STRING keys — the auto-dense bridge.

The counterpart of ``dryad_tpu/ops/stringcode.py``: the host-side table
builds are the reference's, line for line, so both packages assign the
same codes and probe slots; the device lookup and decode gather are
PyTorch.  Device tables arrive as tensors from the executor's
``exec.operands.DeviceOperandPool`` (a widening scatters its delta).

Reference notes follow.

A STRING device column is Hash64 word pairs (``columnar/schema.py``);
the context ``StringDictionary`` knows every distinct string a context
ever ingested.  That makes a plain ``group_by`` over a string column a
*dense* problem in disguise: assign each dictionary entry a dense code
(its insertion rank), map rows (h0, h1) -> code on device, and the
whole GroupBy rides the MXU bucket kernel (``ops/pallas_bucket.py``)
with no shuffle — the reference pays a full hash repartition for the
same query (``DryadLinqQueryNode.cs:3581``).

The mapping table is host-built open addressing over the 64-bit hash
(linear probing, power-of-two slots, load <= 0.5); lookup is an
unrolled vectorized gather loop.  Tables are wrapped in VALUE-equal
objects so the executor's structural compile cache can key on table
*content* (the legacy baked-constant path), or — with
``stringcode_runtime_tables`` — on the table's **shape palette tier**
only, with the arrays fed as call-time device operands (the
static-vs-operand split: DrJAX keeps MapReduce primitives compiling
once per shape the same way).  Every table dimension is quantized to
the power-of-two palette (:func:`palette_domain`), so a widening
vocabulary crosses O(log vocab) tiers instead of forcing O(widenings)
recompiles.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dryad_tpu_torch.columnar.batch import MASK32
from dryad_tpu_torch.columnar.schema import split64, string_prefix_rank

_GOLDEN = 0x9E3779B9


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for int64 tensors of uint32 values, without
    int64 overflow: the constant is split into 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) * 0x10000
    return (lo + hi) & MASK32


def _mix(h0: np.ndarray, h1: np.ndarray) -> np.ndarray:
    """Slot hash from the two Hash64 words (uint32)."""
    return (h0 ^ (h1 * np.uint32(0x9E3779B9))).astype(np.uint32)


def palette_domain(n: int) -> int:
    """Power-of-two shape-palette step for a dense code domain of ``n``
    codes (min 4).  ONE quantization shared by CodeTable slot sizing,
    DecodeTable padding, and the ingest scope's tier-change test — a
    vocabulary that widens within a step keeps every traced shape (and
    therefore every compile-cache key) identical."""
    d = 4
    while d < max(n, 1):
        d *= 2
    return d


class CodeTable:
    """Open-addressing (h0, h1) -> dense code map; VALUE-equal.

    ``slots_h0/h1``: uint32 hash words per slot; ``slots_code``: int32
    code or -1 for empty; ``num_codes`` = K; misses map to
    ``num_codes_padded`` (past every real code — the dense kernel's
    out-of-range drop in BOTH palette modes).

    Shape palette: ``num_slots`` is ``2 * palette_domain(K)`` (load
    <= 0.5) and the unrolled probe loop runs ``probe_bound`` (the
    observed max probe rounded up to a power of two) iterations, so the
    traced lookup depends only on the ``(num_slots, probe_bound)`` tier
    — two tables of the same tier produce byte-identical traces and the
    arrays can travel as runtime operands (``operand_arrays``)."""

    operand_arity = 3  # (slots_h0, slots_h1, slots_code)

    def __init__(self, pairs: np.ndarray):
        """``pairs``: (K, 2) uint32 — (h0, h1) per code, in code order."""
        K = len(pairs)
        S = 2 * palette_domain(K)
        h0 = pairs[:, 0].astype(np.uint32)
        h1 = pairs[:, 1].astype(np.uint32)
        slots_h0 = np.zeros(S, np.uint32)
        slots_h1 = np.zeros(S, np.uint32)
        slots_code = np.full(S, -1, np.int32)
        start = _mix(h0, h1) & np.uint32(S - 1)
        max_probe = 1
        for code in range(K):
            j = int(start[code])
            probe = 1
            while slots_code[j] >= 0:
                j = (j + 1) & (S - 1)
                probe += 1
            slots_h0[j] = h0[code]
            slots_h1[j] = h1[code]
            slots_code[j] = code
            max_probe = max(max_probe, probe)
        self.num_slots = S
        self.num_codes = K
        self.num_codes_padded = S // 2  # pow2 >= K: the palette domain
        self.max_probe = max_probe
        # pow2-quantized probe budget: tier-static, so an append that
        # lengthens one probe chain within the budget does not change
        # the traced loop (probing past a key's true chain is harmless:
        # hits require an exact stored (h0, h1) match)
        self.probe_bound = palette_domain(max_probe)
        self.slots_h0 = slots_h0
        self.slots_h1 = slots_h1
        self.slots_code = slots_code
        import hashlib

        # Content digest FIRST; the Python-level fingerprint derives
        # from it so __hash__ is process-stable (Python's hash() over
        # bytes is per-process salted — job packages and checkpoint
        # meta compare fingerprints across processes).
        self._sha = hashlib.sha1(
            np.int64(S).tobytes()
            + slots_h0.tobytes() + slots_h1.tobytes() + slots_code.tobytes()
        ).hexdigest()
        self._fp = int(self._sha[:16], 16)

    def __eq__(self, other) -> bool:
        return (
            type(other) is CodeTable
            and other._fp == self._fp
            and other.num_slots == self.num_slots
            and np.array_equal(other.slots_h0, self.slots_h0)
            and np.array_equal(other.slots_h1, self.slots_h1)
            and np.array_equal(other.slots_code, self.slots_code)
        )

    def __hash__(self) -> int:
        return self._fp

    def __repr__(self) -> str:
        # content-addressed and PROCESS-STABLE (checkpoint fingerprints
        # embed repr(param)); digest frozen at init — arrays immutable
        return (
            f"CodeTable(S={self.num_slots},K={self.num_codes},"
            f"probe={self.max_probe},sha={self._sha[:12]})"
        )

    # -- runtime-operand protocol (exec.operands.DeviceOperandPool) ----
    def operand_signature(self) -> Tuple:
        """Shape-palette tier: everything the traced lookup bakes in.
        Tables sharing a signature are interchangeable at call time."""
        return ("CodeTable", self.num_slots, self.probe_bound)

    def operand_arrays(self) -> Tuple[np.ndarray, ...]:
        return (self.slots_h0, self.slots_h1, self.slots_code)

    def operand_sha(self) -> str:
        return self._sha

    def lookup(self, h0, h1, operands):
        """Device lookup: uint32 words (int64 carrier) -> int32 codes,
        misses -> ``num_codes_padded`` (dropped by the dense kernel's
        range mask).  ``operands``: the device
        ``(slots_h0, slots_h1, slots_code)`` tensors."""
        S = self.num_slots
        th0, th1, tco = operands
        idx = (h0 ^ mul32(h1, _GOLDEN)) & (S - 1)
        code = torch.full(h0.shape, -1, dtype=torch.int32, device=h0.device)
        for p in range(self.probe_bound):
            j = (idx + p) & (S - 1)
            c = tco[j]
            hit = (th0[j] == h0) & (th1[j] == h1) & (c >= 0)
            code = torch.where(hit & (code < 0), c, code)
        return torch.where(
            code < 0, torch.full_like(code, self.num_codes_padded), code
        )


class DecodeTable:
    """Dense code -> STRING physical words (h0, h1, r0, r1); VALUE-equal.

    ``words``: (K, 4) uint32 in code order.  The padded gather buffer
    (``2 * palette_domain(K)`` rows, zero-filled past K) is built ONCE
    at construction — it doubles as the zero-pad for any per-partition
    slice and as the fixed-shape runtime operand."""

    operand_arity = 1  # (padded words buffer,)

    def __init__(self, words: np.ndarray):
        import hashlib

        self.words = np.ascontiguousarray(words, np.uint32)
        K = len(self.words)
        self.num_codes_padded = palette_domain(K)
        R = 2 * self.num_codes_padded
        padded = np.zeros((R, 4), np.uint32)
        padded[:K] = self.words
        self.words_padded = padded
        self._sha = hashlib.sha1(
            np.int64(R).tobytes() + self.words.tobytes()
        ).hexdigest()
        self._fp = int(self._sha[:16], 16)

    def __eq__(self, other) -> bool:
        return (
            type(other) is DecodeTable
            and other._fp == self._fp
            and np.array_equal(other.words, self.words)
        )

    def __hash__(self) -> int:
        return self._fp

    def __repr__(self) -> str:
        return f"DecodeTable(K={len(self.words)},sha={self._sha[:12]})"

    # -- runtime-operand protocol --------------------------------------
    def operand_signature(self) -> Tuple:
        return ("DecodeTable", self.words_padded.shape[0])

    def operand_arrays(self) -> Tuple[np.ndarray, ...]:
        return (self.words_padded,)

    def operand_sha(self) -> str:
        return self._sha

    def slice_rows(self, start: torch.Tensor, count: int, operands):
        """Device gather of ``count`` code rows from each ``start``
        (a ``(P, 1)`` tensor): returns ``(P, count, 4)`` words, rows past
        K zero-filled.  The start is clamped to ``[0, R - count]`` as
        ``lax.dynamic_slice_in_dim`` clamps it in the reference.
        ``operands``: the padded device buffer, as a 1-tuple."""
        (tab,) = operands
        R = tab.shape[0]
        s = start.clamp(0, R - count)
        rows = s + torch.arange(count, device=tab.device)
        return tab[rows]


def build_tables(dictionary) -> Tuple[CodeTable, DecodeTable]:
    """Build the (code, decode) pair from a context StringDictionary in
    insertion order (stable per context; the job package ships the
    driver's lowered plan, so one table serves the whole job).

    Memoized on the dictionary keyed by its length — entries are
    append-only, so length is a valid version stamp; repeated lowers of
    a warm pipeline skip the O(vocabulary) Python build.

    Known granularity limit: the table covers the whole CONTEXT
    dictionary, not the key column's own vocabulary — a context that
    ingested unrelated string columns pays proportionally more buckets
    (correctness unaffected; empty buckets drop at the validity mask).
    """
    cached = getattr(dictionary, "_stringcode_cache", None)
    if cached is not None and cached[0] == len(dictionary):
        return cached[1]
    hashes = []
    strings = []
    for h, s in dictionary.items():
        hashes.append(h)
        strings.append(s)
    tables = _tables_from(hashes, strings)
    dictionary._stringcode_cache = (len(hashes), tables)
    return tables


def _tables_from(hashes, strings) -> Tuple[CodeTable, DecodeTable]:
    """Assemble the (code, decode) pair from parallel hash/string lists
    — the ONE place that knows the physical word layout (shared by the
    whole-dictionary and per-ingest-subset builders)."""
    K = len(hashes)
    arr = np.asarray(hashes, np.uint64)
    lo, hi = split64(arr)
    sarr = np.asarray(strings, object)
    r0 = string_prefix_rank(sarr, 0) if K else np.zeros(0, np.uint32)
    r1 = string_prefix_rank(sarr, 4) if K else np.zeros(0, np.uint32)
    pairs = np.stack([lo, hi], axis=1) if K else np.zeros((0, 2), np.uint32)
    words = (
        np.stack([lo, hi, r0, r1], axis=1) if K else np.zeros((0, 4), np.uint32)
    )
    return CodeTable(pairs), DecodeTable(words)


def build_tables_subset(
    dictionary, hashes: np.ndarray
) -> Tuple[CodeTable, DecodeTable]:
    """Build the (code, decode) pair over a SUBSET of the dictionary —
    the key column's own per-ingest vocabulary (``api.query.
    static_str_vocab``) — in dictionary INSERTION order (deterministic
    given the context dictionary; the job package ships the tables
    inside the lowered plan).  Insertion order makes a widening
    vocabulary's tables APPEND-ONLY: existing codes keep their values
    and their probe slots, so the runtime-operand pool can scatter just
    the new entries into the device buffers instead of re-uploading
    (sorted-hash order would renumber every code past each insertion
    point).  Hashes absent from the dictionary are skipped: they cannot
    decode, and the runtime miss guard covers fabricated values.  A
    (len, digest)-keyed memo on the dictionary makes warm re-lowers
    O(1)."""
    hs = np.unique(np.asarray(hashes, np.uint64))
    key = (len(dictionary), hs.tobytes())
    cached = getattr(dictionary, "_stringcode_subset_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    want = set(hs.tolist())
    kept = []
    strings = []
    for h, s in dictionary.items():  # insertion (= code) order
        if h in want:
            kept.append(h)
            strings.append(s)
    tables = _tables_from(kept, strings)
    dictionary._stringcode_subset_cache = (key, tables)
    return tables
