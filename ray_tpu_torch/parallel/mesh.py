"""Device meshes over the ranks of a ``torch.distributed`` world.

Counterpart of ``ray_tpu/parallel/mesh.py``.  The reference is one
controller over a ``jax.sharding.Mesh`` of devices; here every card is a
process (a rank), and a mesh is a ``torch.distributed.device_mesh.
DeviceMesh`` over the ranks with the reference's ``AXIS_ORDER`` as its
``mesh_dim_names``.  Every rank builds the same mesh (a collective call:
the mesh makes one process group per axis) and then owns one position in
it; collectives over an axis run on ``mesh.get_group(axis)``.

Standard axis names (outer-to-inner):

    pp    pipeline stages          (GPipe, parallel/pipeline.py)
    dp    pure data parallel
    fsdp  data parallel + param sharding (ZeRO-3)
    sp    sequence/context parallel (ring attention)
    tp    tensor parallel          (innermost: neighbouring ranks)
    ep    expert parallel          (a data axis outside MoE layers)

A mesh whose every axis is 1 is valid in a process that joined no
process group: it is world 1, and one card runs it.  Where the reference
speaks of devices (``devices=``, ``slice_groups``) the port passes global
ranks; a TPU slice becomes a host (the ranks of one node).
"""

from __future__ import annotations

import dataclasses
import math
import socket
from typing import Dict, List, Optional, Sequence, Tuple

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# Process-default mesh: where tensors crossing the object plane with a
# placement are re-placed on deserialization (serialization.py consults
# it), and where iter_jax_batches lays batches out when no sharding is
# given.
_default_mesh = None


def set_default_mesh(mesh) -> None:
    """Install (or clear, with None) this process's default mesh."""
    global _default_mesh
    _default_mesh = mesh


def get_default_mesh():
    return _default_mesh


class default_mesh:
    """Context manager: ``with default_mesh(mesh): ...``"""

    def __init__(self, mesh):
        self._mesh = mesh

    def __enter__(self):
        self._prev = get_default_mesh()
        set_default_mesh(self._mesh)
        return self._mesh

    def __exit__(self, *exc):
        set_default_mesh(self._prev)
        return False


def _world() -> Tuple[int, int, Optional[str]]:
    """(world size, this rank, backend) of the default process group, or
    (1, 0, None) in a process that joined none."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.get_backend()
    return 1, 0, None


def _device_type(device_type: Optional[str], backend: Optional[str]) -> str:
    """The mesh's device type: the caller's, else the group's (nccl: cuda,
    gloo: cpu), else the card (raising without one), as every entry point
    of the port resolves its device."""
    if device_type is not None:
        return device_type
    if backend is not None:
        return "cuda" if backend == "nccl" else "cpu"
    from ray_tpu_torch._device import resolve_device

    return resolve_device(None).type


def _device_mesh(ranks, shape: Tuple[int, ...], names: Tuple[str, ...],
                 device_type: Optional[str]):
    """A DeviceMesh of ``shape`` over the global ``ranks`` (row-major)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    world, rank, backend = _world()
    arr = torch.tensor(list(ranks), dtype=torch.int).reshape(shape)
    dev = _device_type(device_type, backend)
    if backend is None:
        if arr.numel() != 1:
            raise ValueError(
                f"a mesh over {arr.numel()} ranks needs torch.distributed's "
                f"default group (init_process_group, or a trainer's "
                f"JaxConfig(mode='spmd')); this process joined none")
        # world 1 without a group: no axis has a peer, so no group is made
        return DeviceMesh(dev, arr, mesh_dim_names=names,
                          _init_backend=False, _rank=0)
    bad = [r for r in arr.flatten().tolist() if not 0 <= r < world]
    if bad:
        raise ValueError(f"ranks {bad} outside the world of {world}")
    return DeviceMesh(dev, arr, mesh_dim_names=names)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape; -1 on at most one axis means 'fill'."""

    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = self.sizes()
        fill = [a for a, s in sizes.items() if s == -1]
        if len(fill) > 1:
            raise ValueError(f"at most one -1 axis allowed: {sizes}")
        known = math.prod(s for s in sizes.values() if s != -1)
        if fill:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by {known} for {sizes}")
            sizes[fill[0]] = n_devices // known
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {math.prod(sizes.values())} devices, "
                f"got {n_devices}")
        return MeshSpec(**sizes)

    def build(self, devices: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None):
        """The mesh over ``devices`` (global ranks; default: every rank of
        the world, in order).  Collective: every rank calls it."""
        if devices is None:
            devices = range(_world()[0])
        devices = list(devices)
        spec = self.resolve(len(devices))
        shape = tuple(spec.sizes()[a] for a in AXIS_ORDER)
        return _device_mesh(devices, shape, AXIS_ORDER, device_type)


def make_mesh(*, pp: int = 1, dp: int = 1, fsdp: int = 1, ep: int = 1,
              sp: int = 1, tp: int = 1,
              devices: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None):
    return MeshSpec(pp=pp, dp=dp, fsdp=fsdp, ep=ep, sp=sp,
                    tp=tp).build(devices, device_type)


def mesh_device(mesh):
    """Where this rank's shards live: its current card on a cuda mesh."""
    import torch

    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size}: the reference's ``mesh.shape``."""
    return {a: int(mesh.size(i)) for i, a in enumerate(mesh.mesh_dim_names)}


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
    return int(mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)])


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``; None for an
    axis of size 1 (no peer, nothing to communicate)."""
    if axis_sizes(mesh).get(axis, 1) == 1:
        return None
    return mesh.get_group(axis)


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes a per-example batch is sharded over."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("dp", "fsdp", "ep") if sizes.get(a, 1) >= 1)


def batch_sharding(mesh):
    """Canonical input-batch sharding: batch over the data axes (dp,
    fsdp, ep — ep doubles as a data axis outside MoE layers), seq over
    sp."""
    from .sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P(("dp", "fsdp", "ep"), "sp"))


def replicated(mesh):
    from .sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P())


_hosts_cache: Dict[int, List[str]] = {}


def rank_hosts() -> List[str]:
    """Every rank's host name, in rank order (a collective the first time
    in a world; cached after)."""
    import torch.distributed as dist

    world, _, backend = _world()
    if backend is None:
        return [socket.gethostname()]
    key = id(dist.group.WORLD)
    if key not in _hosts_cache:
        out: List[Optional[str]] = [None] * world
        dist.all_gather_object(out, socket.gethostname())
        _hosts_cache[key] = [str(h) for h in out]
    return _hosts_cache[key]


def local_mesh(n: Optional[int] = None, device_type: Optional[str] = None,
               **axes):
    """Mesh over the ranks on this host (the reference's over its local
    devices).  Collective: every rank of the world calls it, and the
    meshes of every host are made in host order; each rank gets its own
    host's."""
    hosts = rank_hosts()
    order = list(dict.fromkeys(hosts))
    mine = None
    for host in order:
        ranks = [r for r, h in enumerate(hosts) if h == host]
        if n is not None:
            ranks = ranks[:n]
        sizes = dict(axes) if axes else {"dp": len(ranks)}
        mesh = make_mesh(devices=ranks, device_type=device_type, **sizes)
        if host == socket.gethostname():
            mine = mesh
    return mine


def slice_groups(devices: Sequence[int]) -> List[List[int]]:
    """Group ranks by host, the port's counterpart of a TPU slice (hosts
    in order of their first rank)."""
    hosts = rank_hosts()
    by: Dict[str, List[int]] = {}
    for r in devices:
        by.setdefault(hosts[r], []).append(r)
    return list(by.values())


def make_multislice_mesh(*, dcn: Dict[str, int], ici: Dict[str, int],
                         devices: Optional[Sequence[int]] = None,
                         num_slices: Optional[int] = None,
                         device_type: Optional[str] = None):
    """Mesh spanning several hosts (the reference's TPU slices over DCN).

    ``dcn`` assigns exactly one axis to the cross-host dimension (e.g.
    ``{"dp": 2}`` for 2-host data parallelism); ``ici`` is the per-host
    mesh shape.  The layout keeps every ``ici`` axis inside one host, so
    only the dcn axis's collectives cross the network.  ``num_slices``
    groups the ranks into that many contiguous blocks instead of by host
    (to simulate hosts on one node).
    """
    if len(dcn) != 1:
        raise ValueError(f"exactly one DCN axis supported, got {dcn}")
    (dcn_axis, n_dcn), = dcn.items()
    if dcn_axis not in AXIS_ORDER:
        raise ValueError(f"unknown axis {dcn_axis!r}")
    if dcn_axis not in ("pp", "dp", "ep"):
        import warnings

        warnings.warn(
            f"axis {dcn_axis!r} over DCN: fsdp/sp/tp collectives are "
            f"per-layer and will bottleneck on cross-slice bandwidth")
    devices = list(devices if devices is not None
                   else range(_world()[0]))
    if num_slices is not None:
        if len(devices) % num_slices:
            raise ValueError(f"{len(devices)} devices not divisible "
                             f"into {num_slices} slices")
        per = len(devices) // num_slices
        groups = [devices[i * per:(i + 1) * per]
                  for i in range(num_slices)]
    else:
        groups = slice_groups(devices)
    if len(groups) != n_dcn:
        raise ValueError(
            f"dcn={{{dcn_axis}: {n_dcn}}} but found {len(groups)} "
            f"slices (pass num_slices to simulate)")

    ici_sizes = {a: ici.get(a, 1) for a in AXIS_ORDER}
    per_slice = math.prod(ici_sizes.values())
    for g in groups:
        if len(g) != per_slice:
            raise ValueError(
                f"slice has {len(g)} devices, ici shape needs {per_slice}")
    import numpy as np

    ici_shape = tuple(ici_sizes[a] for a in AXIS_ORDER)
    blocks = [np.array(g).reshape(ici_shape) for g in groups]
    axis_i = AXIS_ORDER.index(dcn_axis)
    # stack hosts as the outer factor of the dcn axis: positions that
    # differ only inside a host stay on that host
    arr = np.stack(blocks, axis=axis_i)
    full_shape = tuple(
        ici_sizes[a] * (n_dcn if a == dcn_axis else 1)
        for a in AXIS_ORDER)
    return _device_mesh(arr.reshape(full_shape).flatten().tolist(),
                        full_shape, AXIS_ORDER, device_type)
