"""The partition mesh: P global partitions over the ranks of a group.

The counterpart of ``dryad_tpu/parallel/mesh.py``.  The reference lays
P partitions over a ``jax.sharding.Mesh`` of devices (one partition a
device) with one named axis ``"p"``; a multi-process gang's mesh spans
every process's devices, flattened rank-major.  Here a
:class:`PartitionMesh` lays P partitions over the ranks of a
``torch.distributed`` group, ``local = P // world`` partitions a rank,
each rank's partitions on its one device as the leading axis of every
``(local, cap)`` tensor.  Rank r holds global partitions
``[r * local, (r + 1) * local)``.  With no group (one process) the mesh
holds all P partitions and every collective of
``parallel/partition.py`` is a tensor operation on that axis.

A hybrid mesh lays the P partitions out as ``dcn_slices`` slices of
``ici`` partitions each, as the reference's 2-D ``(DCN_AXIS, AXIS)``
device mesh does: global partition ``d * ici + p`` is partition ``p``
of slice ``d``.  Its exchanges follow the reference's topology (the
tree exchange's ICI hop within each slice, then one DCN hop across
slices, and the staged exchange's ICI rounds before its DCN round), and
its byte accounting splits traffic by fabric.  In one process
(:func:`make_hybrid_mesh`) every partition lives on the one device.
Over the rank threads of ``DryadContext(devices=..., dcn_slices=...)``
a slice holds whole cards: with ``W`` cards, slice ``d`` is cards
``d * C .. d * C + C - 1`` (``C = W / dcn``), so global partition
``d * ici + p`` lies on card ``d * C + p // local``, the reference's
slice-major order.  Each rank then holds two sub-groups of its group
(``parallel/ranks.py``): its slice's ``C`` cards (the ICI axis) and the
``dcn`` cards at its position ``rank % C`` in every slice (the DCN
axis); :meth:`PartitionMesh.axis_mesh` is the view an exchange over one
axis runs its collectives over.  A gang keeps the flat mesh, as the
reference's ``LocalJobSubmission`` does.

The ranks of a group are processes (a gang: ``init_distributed``) or
threads of one process, one a card, as the reference's single
controller spans ``jax.devices()``: ``DryadContext(devices=...)``
builds one mesh a rank over an unregistered group
(``parallel/ranks.py``), each holding ``link``, the state its peers
share (the cards, the abort flag, the host exchange).

``force_cpu_backend`` has no counterpart: ``device="cpu"`` pins a
context, or a gang's workers, to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

AXIS = "p"
# the cross-slice axis of a hybrid mesh: partitions within a slice talk
# over ICI (AXIS), slices over DCN (DCN_AXIS), the reference's names
DCN_AXIS = "d"

# partitions of a context or hybrid mesh that names none
DEFAULT_PARTITIONS = 8

# seconds a group's collective may wait for its peers, unless the group
# was joined with another bound (parallel/multihost.py::init_distributed)
DEFAULT_TIMEOUT_S = 300.0


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` -> the current CUDA device; raises when there is none.
    The CPU is used only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dryad_tpu_torch: no CUDA device available; pass "
                "device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class PartitionMesh:
    """P global partitions over ``world`` ranks, this process rank
    ``rank``, holding ``local = P // world`` of them on ``device``.
    ``group`` is the ``torch.distributed`` process group the
    collectives run over, ``None`` in one process; ``backend`` is its
    backend (``"nccl"`` or ``"gloo"``).  ``dcn_slices`` makes the mesh
    hybrid (2-D): ``dcn_slices`` slices of ``ici = P // dcn_slices``
    partitions, slice-major, in one process or over the rank threads of
    one process (``link`` set), a slice of whole cards; ``ici_group``
    and ``dcn_group`` are then this rank's sub-groups (None where the
    axis stays on the card: one card a slice, or one slice)."""

    def __init__(
        self,
        num_partitions: int,
        device=None,
        rank: int = 0,
        world: int = 1,
        group=None,
        backend: Optional[str] = None,
        dcn_slices: Optional[int] = None,
        timeout: Optional[float] = None,
        link=None,
        ici_group=None,
        dcn_group=None,
    ):
        P, world = int(num_partitions), int(world)
        dcn = 1 if dcn_slices is None else int(dcn_slices)
        if P < 1:
            raise ValueError("num_partitions must be >= 1")
        if dcn < 1 or P % dcn:
            raise ValueError(f"dcn_slices {dcn} must divide num_partitions {P}")
        if dcn_slices is not None and world > 1 and link is None:
            raise ValueError("a gang keeps the flat mesh: dcn_slices needs the rank "
                             "threads of one process (DryadContext(devices=...))")
        if world < 1 or not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        if P % world:
            raise ValueError(
                f"num_partitions {P} is not a multiple of the {world} ranks "
                "(every rank holds the same number of partitions)"
            )
        if world % dcn and world > 1:
            raise ValueError(
                f"dcn_slices {dcn} does not divide the {world} cards: a DCN slice "
                "holds whole cards")
        if world > 1 and group is None:
            raise ValueError("a mesh over several ranks needs their process group")
        self.P = P
        self.rank = int(rank)
        self.world = world
        self.local = P // world
        self.device = resolve_device(device)
        self.group = group
        self.backend = backend
        self.sent_bytes = 0  # bytes this rank handed to the group's collectives
        self.timeout = float(timeout) if timeout is not None else DEFAULT_TIMEOUT_S
        # (event, stage) of the work enqueued on the card since the last
        # settle (an NCCL group's; parallel/partition.py::settle)
        self.inflight: list = []
        self.replayed = False  # a graph replay among them
        # ranks that are threads of one process: what they share
        # (parallel/ranks.py::RankLink); None for a gang's process or one
        # process alone
        self.link = link
        self.stage: Optional[str] = None  # the unit the rank runs (error messages)
        # the 2-D (DCN_AXIS, AXIS) layout of the whole mesh: dcn slices
        # of ici partitions
        self.hybrid = dcn_slices is not None
        self.dcn = dcn
        self.ici = P // dcn
        # over ranks: cards a slice, this rank's slice and its position
        # in it, and the sub-groups of the two axes
        self.cards_per_slice = max(world // dcn, 1)
        self.slice_index = self.rank // self.cards_per_slice
        self.position = self.rank % self.cards_per_slice
        self.ici_group, self.dcn_group = ici_group, dcn_group

    @property
    def base(self) -> int:
        """Global id of this rank's first partition."""
        return self.rank * self.local

    def axis_mesh(self, axis: str) -> "AxisMesh":
        """The flat mesh an exchange over one axis of a hybrid mesh over
        ranks runs its collectives over (:class:`AxisMesh`)."""
        C = self.cards_per_slice
        if axis == AXIS:
            return AxisMesh(self, self.ici, self.position, C, self.ici_group, strided=False)
        return AxisMesh(self, self.dcn * self.local, self.slice_index, self.dcn,
                        self.dcn_group, strided=True)

    def __repr__(self) -> str:
        return (
            f"PartitionMesh(P={self.P}, rank={self.rank}, world={self.world}, "
            f"local={self.local}, device={self.device}, backend={self.backend}"
            + (f", dcn_slices={self.dcn}, ici={self.ici})" if self.hybrid else ")")
        )


class AxisMesh:
    """One axis of a hybrid mesh over ranks, as the flat mesh the
    collectives of ``parallel/partition.py`` take: ``world`` ranks of
    the axis's sub-group (``group``; None where the axis stays on this
    card), this rank ``rank`` of them, each holding the whole mesh's
    ``local`` partitions, sub-ids ``rank * local + i``.

    - The ICI axis (``strided`` False): the slice's ``ici`` partitions
      over its ``C`` cards, one exchange group, member ``sub-id``.
    - The DCN axis (``strided`` True): the ``dcn`` cards at one
      position, whose local partition ``i`` is member ``rank`` of
      exchange group ``i`` (the partitions at one ICI index).

    Device, backend, timeout, link and stage are the whole mesh's, and
    the bytes sent and the work in flight count on it."""

    hybrid = False
    dcn = 1

    def __init__(self, whole: PartitionMesh, P: int, rank: int, world: int, group,
                 strided: bool):
        self.whole = whole
        self.P, self.rank, self.world, self.group = P, rank, world, group
        self.local = whole.local
        self.strided = strided

    @property
    def base(self) -> int:
        return self.rank * self.local

    def __getattr__(self, name):  # device, backend, timeout, link, stage
        return getattr(self.whole, name)

    @property
    def sent_bytes(self) -> int:
        return self.whole.sent_bytes

    @sent_bytes.setter
    def sent_bytes(self, v: int) -> None:
        self.whole.sent_bytes = v

    @property
    def inflight(self) -> list:
        return self.whole.inflight

    @inflight.setter
    def inflight(self, v: list) -> None:
        self.whole.inflight = v

    @property
    def replayed(self) -> bool:
        return self.whole.replayed

    @replayed.setter
    def replayed(self, v: bool) -> None:
        self.whole.replayed = v


def make_mesh(num_partitions: Optional[int] = None, device=None, group=None) -> PartitionMesh:
    """A flat mesh of ``num_partitions`` partitions.

    In a process that joined a ``torch.distributed`` group
    (``parallel/multihost.py::init_distributed``), the mesh spans the
    group's ranks, as the reference's ``make_mesh`` spans every
    process's devices once the multi-controller runtime is up;
    ``group`` names another group.  ``num_partitions`` defaults to one
    partition a rank and must be a multiple of the rank count; ``device``
    to the current CUDA device (the CPU only when named)."""
    import torch.distributed as dist

    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return PartitionMesh(num_partitions or 1, device)
    from dryad_tpu_torch.parallel import multihost

    world = dist.get_world_size(group)
    return PartitionMesh(
        num_partitions or world, device, rank=dist.get_rank(group), world=world,
        group=group, backend=str(dist.get_backend(group)), timeout=multihost.group_timeout(),
    )


def make_hybrid_mesh(dcn_slices: int, ici_partitions: Optional[int] = None,
                     device=None) -> PartitionMesh:
    """The reference's 2-D ``(DCN_AXIS, AXIS)`` mesh in one process:
    ``dcn_slices`` slices of ``ici_partitions`` partitions each
    (default ``DEFAULT_PARTITIONS // dcn_slices``, as the reference
    splits its devices), on ``device`` (the current CUDA device unless
    the CPU is named).  Global partition ``d * ici + p`` is partition
    ``p`` of slice ``d``."""
    if dcn_slices < 1:
        raise ValueError("dcn_slices must be >= 1")
    n_ici = ici_partitions if ici_partitions is not None else DEFAULT_PARTITIONS // dcn_slices
    if n_ici < 1:
        raise ValueError(
            f"hybrid mesh {dcn_slices}x{n_ici} has no partition in a slice"
        )
    return PartitionMesh(dcn_slices * n_ici, device, dcn_slices=dcn_slices)


def exclude_devices(mesh: PartitionMesh, bad_ids):
    """The mesh without the excluded devices (the reference's elastic
    recovery step).  A flat rank holds one device, named by its rank:
    excluding none of them returns the mesh; a one-process mesh whose
    device is excluded is empty.  Ranks that are threads of one process
    (``mesh.link``) return the list of the surviving cards, in order,
    over which ``DryadContext.rebuild_mesh`` builds its ranks anew; a
    process group cannot shrink, so a multi-process mesh is rebuilt by
    restarting the gang (``LocalJobSubmission.rebuild_gang``).

    A hybrid mesh keeps its 2-D structure, as the reference's: each
    slice sheds its excluded devices, the slices shrink to the smallest
    survivor (rows stay rectangular) and a slice left with none is
    dropped.  In one process each partition stands for one of the
    reference's devices, named by its global id, and the result is the
    smaller mesh; over rank threads a device is a card, named by its
    rank, and the result is the surviving cards a slice, in slice
    order (a list of lists)."""
    if mesh.hybrid:
        bad = set(bad_ids)
        over_cards = mesh.link is not None
        n, per = (mesh.world, mesh.cards_per_slice) if over_cards else (mesh.P, mesh.ici)
        rows = [[i for i in range(d * per, (d + 1) * per) if i not in bad]
                for d in range(n // per)]
        rows = [r for r in rows if r]
        if not rows:
            raise ValueError("excluding all devices leaves an empty mesh")
        k = min(len(r) for r in rows)
        if over_cards:
            return [[mesh.link.devices[i] for i in r[:k]] for r in rows]
        if len(rows) == mesh.dcn and k == mesh.ici:
            return mesh
        return PartitionMesh(len(rows) * k, mesh.device, dcn_slices=len(rows))
    bad = set(bad_ids) & set(range(mesh.world))
    if mesh.link is not None:
        keep = [d for i, d in enumerate(mesh.link.devices) if i not in bad]
        if not keep:
            raise ValueError("excluding all devices leaves an empty mesh")
        return keep
    if not bad:
        return mesh
    if mesh.world == 1:
        raise ValueError("excluding all devices leaves an empty mesh")
    raise ValueError(
        "a process group cannot shrink: restart the gang without the "
        f"excluded ranks {sorted(bad)} (LocalJobSubmission.rebuild_gang)"
    )


def mesh_axes(mesh: PartitionMesh) -> tuple:
    """The mesh's partition axes, outermost first: ``("p",)`` for a flat
    mesh, ``(DCN_AXIS, AXIS)`` for a hybrid one."""
    return (DCN_AXIS, AXIS) if mesh is not None and mesh.hybrid else (AXIS,)


def axis_sizes(mesh: PartitionMesh) -> tuple:
    """The extent of each of ``mesh_axes(mesh)``."""
    return (mesh.dcn, mesh.ici) if mesh.hybrid else (mesh.P,)


def num_partitions(mesh: PartitionMesh) -> int:
    return mesh.P


def dcn_slice_count(mesh: Optional[PartitionMesh]) -> int:
    """Number of DCN-connected slice groups: the outer extent of a
    hybrid mesh, 1 for a flat mesh or none.  The combine-tree planner
    sizes its level-0 groups from it."""
    return 1 if mesh is None else mesh.dcn


def ici_partitions_per_slice(mesh: Optional[PartitionMesh]) -> int:
    """Partitions reachable over the fast fabric from any one partition:
    the inner extent of a hybrid mesh, the whole flat mesh (1 with no
    mesh)."""
    return 1 if mesh is None else mesh.ici
