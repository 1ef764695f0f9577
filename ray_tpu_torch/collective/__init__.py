"""Collectives for the port (see ray_tpu/collective): the group API over
``torch.distributed`` (store rendezvous) and over the runtime's
control-plane KV (the ``kv`` backend), the rank-local collectives with
their int8-compressed paths, and the compression config and codec."""

from .collective import (AllreduceHandle, CollectiveTeardownTimeout,
                         allgather, allreduce, allreduce_async, barrier,
                         broadcast,
                         destroy_collective_group, get_group_handle,
                         init_collective_group, recv, reducescatter, send)
from .compression import (CompressionConfig, compress_array, decompress_array,
                          parse_compression, resolve_compression,
                          set_group_compression)
from .nccl_group import (mesh_allgather, mesh_allreduce, mesh_all_to_all,
                         mesh_broadcast, mesh_ppermute, mesh_reducescatter)

__all__ = [
    "init_collective_group", "destroy_collective_group", "get_group_handle",
    "allreduce", "allreduce_async", "AllreduceHandle",
    "CollectiveTeardownTimeout",
    "allgather", "reducescatter", "broadcast", "barrier",
    "send", "recv",
    "CompressionConfig", "parse_compression", "resolve_compression",
    "set_group_compression", "compress_array", "decompress_array",
    "mesh_allreduce", "mesh_allgather", "mesh_reducescatter",
    "mesh_broadcast", "mesh_ppermute", "mesh_all_to_all",
]
