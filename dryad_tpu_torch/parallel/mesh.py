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

``force_cpu_backend`` has no counterpart: ``device="cpu"`` pins a
context, or a gang's workers, to the CPU.  The hybrid DCN x ICI mesh
(``make_hybrid_mesh``) is ROADMAP queue 1 item 11.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

AXIS = "p"

HYBRID_PENDING = (
    "the hybrid DCN x ICI mesh (make_hybrid_mesh, dcn_slices) is not "
    "ported yet: ROADMAP queue 1 item 11"
)


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
    backend (``"nccl"`` or ``"gloo"``)."""

    def __init__(
        self,
        num_partitions: int,
        device=None,
        rank: int = 0,
        world: int = 1,
        group=None,
        backend: Optional[str] = None,
    ):
        P, world = int(num_partitions), int(world)
        if P < 1:
            raise ValueError("num_partitions must be >= 1")
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

    @property
    def base(self) -> int:
        """Global id of this rank's first partition."""
        return self.rank * self.local

    def __repr__(self) -> str:
        return (
            f"PartitionMesh(P={self.P}, rank={self.rank}, world={self.world}, "
            f"local={self.local}, device={self.device}, backend={self.backend})"
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
    world = dist.get_world_size(group)
    return PartitionMesh(
        num_partitions or world, device, rank=dist.get_rank(group), world=world,
        group=group, backend=str(dist.get_backend(group)),
    )


def make_hybrid_mesh(dcn_slices: int, ici_partitions: Optional[int] = None):
    """The reference's 2-D (DCN, ICI) mesh: not ported (item 11)."""
    raise NotImplementedError(HYBRID_PENDING)


def exclude_devices(mesh: PartitionMesh, bad_ids) -> PartitionMesh:
    """The mesh without the excluded devices (the reference's elastic
    recovery step, flat case).  A rank holds one device, named by its
    rank: excluding none of them returns the mesh; a one-process mesh
    whose device is excluded is empty; a process group cannot shrink,
    so a multi-rank mesh is rebuilt by restarting the gang
    (``LocalJobSubmission.rebuild_gang``)."""
    bad = set(bad_ids) & set(range(mesh.world))
    if not bad:
        return mesh
    if mesh.world == 1:
        raise ValueError("excluding all devices leaves an empty mesh")
    raise ValueError(
        "a process group cannot shrink: restart the gang without the "
        f"excluded ranks {sorted(bad)} (LocalJobSubmission.rebuild_gang)"
    )


def mesh_axes(mesh: PartitionMesh) -> tuple:
    """The mesh's partition axes: ``("p",)`` (flat)."""
    return (AXIS,)


def num_partitions(mesh: PartitionMesh) -> int:
    return mesh.P


def dcn_slice_count(mesh: Optional[PartitionMesh]) -> int:
    """Number of DCN-connected slice groups: 1 for a flat mesh or none."""
    return 1


def ici_partitions_per_slice(mesh: Optional[PartitionMesh]) -> int:
    """Partitions reachable from any one device over the fast fabric:
    the whole flat mesh (1 with no mesh)."""
    return 1 if mesh is None else mesh.P
