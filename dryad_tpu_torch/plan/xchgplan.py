"""Memory-bounded exchange planner: staged redistribution schedules.

The counterpart of ``dryad_tpu/plan/xchgplan.py``, kept as the port's
own copy (the port imports nothing of the JAX package).

The flat exchange (:func:`dryad_tpu_torch.ops.shuffle.exchange`) moves
every source's ``P`` buckets of ``B`` rows at once, so its in-flight
footprint grows linearly with the partition count ``P``.  Following
"Memory-efficient array redistribution through portable collective
communication" (arxiv 2112.01075), any all-to-all redistribution
decomposes into a schedule of collective-permute *hops*: hop
``(sd, sp)`` ships, from every partition ``(d, p)``, the bucket destined
for partition ``((d + sd) % D, (p + sp) % ici)``.  Each hop touches one
``(B, ...)`` block per column, so grouping hops into rounds of at most
``window`` bounds the in-flight exchange footprint at ``O(window * B)``
instead of ``O(P * B)``.

Topology ordering follows ``exec/combinetree.py``'s mesh model: the
ICI-local hops (``sd == 0``, traffic stays inside a slice) run first in
``window``-wide rounds; every DCN-crossing slice offset ``sd != 0`` then
batches ALL of its intra-slice offsets into a single round, so a
2-slice hybrid mesh pays exactly one DCN round.  (DCN rounds ignore the
window: fewer cross-slice launches beat staging on the slow fabric.)

Everything here is static, pure-Python planning with no data-dependent
decision, so a schedule is a constant of the stage and its byte
accounting is emitted as ``exchange_round`` events without any device
read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class ExchangeRound:
    """One scheduled round: a group of hops issued together.

    ``hops`` are ``(sd, sp)`` offset pairs (slice offset and
    intra-slice offset), never the local ``(0, 0)`` hop, which ships no
    network bytes and is placed in place.
    """

    index: int
    hops: Tuple[Tuple[int, int], ...]
    dcn: bool  # True when every hop in the round crosses slices

    @property
    def width(self) -> int:
        return len(self.hops)


@dataclasses.dataclass(frozen=True)
class ExchangeSchedule:
    """A full staged-exchange plan for one mesh shape.

    ``num_partitions == dcn_slices * ici_partitions`` always holds; on
    a single-slice (1-axis) mesh ``dcn_slices == 1`` and every hop is
    ICI-local.
    """

    num_partitions: int
    dcn_slices: int
    ici_partitions: int
    window: int
    rounds: Tuple[ExchangeRound, ...]

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    @property
    def dcn_rounds(self) -> int:
        return sum(1 for r in self.rounds if r.dcn)

    @property
    def peak_width(self) -> int:
        """Most hops in flight in any one round (the peak multiplier)."""
        return max((r.width for r in self.rounds), default=0)

    def accounting(self, bucket_rows: int, row_bytes: int) -> List[Dict[str, int]]:
        """Static per-round byte accounting for ``exchange_round`` events.

        ``bytes`` is the round's peak send-block footprint per partition
        (``width * B * row_bytes``); ``ici_bytes``/``dcn_bytes`` split
        the shipped bytes by fabric, as
        ``combinetree.TreeShape.exchange_split`` does.
        """
        block = bucket_rows * row_bytes
        out = []
        for r in self.rounds:
            ici_hops = sum(1 for sd, _ in r.hops if sd == 0)
            dcn_hops = r.width - ici_hops
            out.append({
                "round": r.index,
                "window": self.window,
                "bytes": r.width * block,
                "ici_bytes": ici_hops * block,
                "dcn_bytes": dcn_hops * block,
            })
        return out


def flat_accounting(
    num_partitions: int, dcn_slices: int, bucket_rows: int, row_bytes: int
) -> Dict[str, int]:
    """Byte accounting for the flat one-collective exchange.

    One pseudo-round with ``window=0``: the peak footprint is the whole
    ``(P, B)`` send buffer; network bytes exclude the self bucket.
    """
    ici = num_partitions // max(dcn_slices, 1)
    block = bucket_rows * row_bytes
    return {
        "round": 0,
        "window": 0,
        "bytes": num_partitions * block,
        "ici_bytes": (ici - 1) * block,
        "dcn_bytes": (dcn_slices - 1) * ici * block,
    }


def resolve_window(
    config_window: int,
    num_partitions: int,
    bucket_bytes: int,
    budget_bytes: int,
    hint: "int | None" = None,
    headroom_bytes: "int | None" = None,
) -> int:
    """The effective staged-exchange window of one stage dispatch.

    - ``config_window >= 0``: the static knob, returned as it is
      (0 = flat).
    - ``config_window == -1``: auto, with precedence rewriter hint >
      measured headroom > configured budget.  An explicit ``hint`` (the
      rewriter's ``retune_exchange``) wins outright; otherwise the
      staging bound is ``headroom_bytes`` (measured device headroom from
      ``obs/telemetry.py``) when given, else ``budget_bytes``: flat while
      the whole ``P * bucket_bytes`` send buffer fits the bound, else
      the widest window whose ``O(window * B)`` footprint does (clamped
      to ``[1, P-1]``).

    Pure and deterministic: equal inputs resolve equally (callers
    quantize the measured headroom before passing it).
    """
    if config_window >= 0:
        return int(config_window)
    if hint is not None:
        return max(0, min(int(hint), max(num_partitions - 1, 0)))
    if num_partitions <= 1:
        return 0
    bound = int(headroom_bytes) if headroom_bytes is not None else int(budget_bytes)
    block = max(1, int(bucket_bytes))
    if num_partitions * block <= bound:
        return 0  # flat fits: one collective beats any staging
    return max(1, min(int(bound // block), num_partitions - 1))


def plan_exchange(num_partitions: int, window: int, dcn_slices: int = 1) -> ExchangeSchedule:
    """Plan a staged exchange over a ``dcn_slices x ici`` mesh.

    ICI-local hops (intra-slice offsets ``1..ici-1``) are chunked into
    ``window``-wide rounds and scheduled first; each DCN slice offset
    ``1..D-1`` then gets exactly one round carrying all of its ``ici``
    intra-slice offsets.
    """
    if num_partitions < 1:
        raise ValueError(f"num_partitions must be >= 1: {num_partitions}")
    if window < 1:
        raise ValueError(f"window must be >= 1 for staged plans: {window}")
    if dcn_slices < 1 or num_partitions % dcn_slices:
        raise ValueError(
            f"dcn_slices {dcn_slices} must divide num_partitions {num_partitions}"
        )
    ici = num_partitions // dcn_slices
    rounds: List[ExchangeRound] = []
    ici_hops = [(0, sp) for sp in range(1, ici)]
    for i in range(0, len(ici_hops), window):
        rounds.append(ExchangeRound(index=len(rounds), hops=tuple(ici_hops[i : i + window]),
                                    dcn=False))
    for sd in range(1, dcn_slices):
        rounds.append(ExchangeRound(index=len(rounds), hops=tuple((sd, sp) for sp in range(ici)),
                                    dcn=True))
    return ExchangeSchedule(
        num_partitions=num_partitions,
        dcn_slices=dcn_slices,
        ici_partitions=ici,
        window=window,
        rounds=tuple(rounds),
    )
