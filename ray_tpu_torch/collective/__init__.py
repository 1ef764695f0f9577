"""Collectives for the port (see ray_tpu/collective): the group API over
``torch.distributed`` (store rendezvous) and over the runtime's
control-plane KV (the ``kv`` backend), the rank-local collectives with
their int8-compressed paths, and the compression config and codec.

Exports resolve on first use (PEP 562), so ``collective.compression``
(numpy only: the config the trainer's configs carry) loads without
torch."""

_EXPORTS = {
    **{name: "collective" for name in (
        "init_collective_group", "destroy_collective_group",
        "get_group_handle", "allreduce", "allreduce_async",
        "AllreduceHandle", "CollectiveTeardownTimeout", "allgather",
        "reducescatter", "broadcast", "barrier", "send", "recv")},
    **{name: "compression" for name in (
        "CompressionConfig", "parse_compression", "resolve_compression",
        "set_group_compression", "compress_array", "decompress_array")},
    **{name: "nccl_group" for name in (
        "mesh_allreduce", "mesh_allgather", "mesh_reducescatter",
        "mesh_broadcast", "mesh_ppermute", "mesh_all_to_all")},
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
