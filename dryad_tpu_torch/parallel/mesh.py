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

A hybrid mesh (:func:`make_hybrid_mesh`) lays the P partitions of one
process out as ``dcn_slices`` slices of ``ici`` partitions each, as the
reference's 2-D ``(DCN_AXIS, AXIS)`` device mesh does: global
partition ``d * ici + p`` is partition ``p`` of slice ``d``.  Its
exchanges follow the reference's topology (the tree exchange's ICI hop
within each slice, then one DCN hop across slices, and the staged
exchange's ICI rounds before its DCN round), and its byte accounting
splits traffic by fabric; all partitions still live on the one device.
A gang keeps the flat mesh, as the reference's ``LocalJobSubmission``
does.

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
    partitions, slice-major (one process only)."""

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
    ):
        P, world = int(num_partitions), int(world)
        dcn = 1 if dcn_slices is None else int(dcn_slices)
        if P < 1:
            raise ValueError("num_partitions must be >= 1")
        if dcn < 1 or P % dcn:
            raise ValueError(f"dcn_slices {dcn} must divide num_partitions {P}")
        if dcn_slices is not None and world > 1:
            raise ValueError("a hybrid mesh lives in one process: a gang keeps the flat mesh")
        if world < 1 or not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        if P % world:
            raise ValueError(
                f"num_partitions {P} is not a multiple of the {world} ranks "
                "(every rank holds the same number of partitions)"
            )
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
        # the 2-D (DCN_AXIS, AXIS) layout: dcn slices of ici partitions
        self.hybrid = dcn_slices is not None
        self.dcn = dcn
        self.ici = P // dcn

    @property
    def base(self) -> int:
        """Global id of this rank's first partition."""
        return self.rank * self.local

    def __repr__(self) -> str:
        return (
            f"PartitionMesh(P={self.P}, rank={self.rank}, world={self.world}, "
            f"local={self.local}, device={self.device}, backend={self.backend}"
            + (f", dcn_slices={self.dcn}, ici={self.ici})" if self.hybrid else ")")
        )


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
    restarting the gang (``LocalJobSubmission.rebuild_gang``).  On a
    hybrid mesh each
    partition stands for one of the reference's devices, named by its
    global id: as the reference's, the mesh keeps its 2-D structure,
    each slice sheds its excluded partitions, the slices shrink to the
    smallest survivor (rows stay rectangular) and a slice left with
    none is dropped."""
    if mesh.hybrid:
        bad = set(bad_ids)
        rows = [[d * mesh.ici + p for p in range(mesh.ici) if d * mesh.ici + p not in bad]
                for d in range(mesh.dcn)]
        rows = [r for r in rows if r]
        if not rows:
            raise ValueError("excluding all devices leaves an empty mesh")
        if len(rows) == mesh.dcn and min(map(len, rows)) == mesh.ici:
            return mesh
        k = min(len(r) for r in rows)
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
