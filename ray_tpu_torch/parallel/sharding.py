"""Logical-axis sharding rules, and explicit data-parallel gradient sync
with compressed collectives.

Counterpart of ``ray_tpu/parallel/sharding.py``.  Parameters carry
*logical* axis names and a rule table maps them to mesh axes: ZeRO-3 is
sharding every parameter's embed axis over ``fsdp``, TP sharding the
head / mlp / vocab axes over ``tp``, SP sharding the sequence axis of
activations over ``sp``.  A ``PartitionSpec`` names the mesh axes of
each tensor dim as the reference's does; ``NamedSharding(mesh, spec)``
turns it into a ``DTensor`` placement list (``Shard(d)`` on each mesh
dim that tensor dim ``d`` names, ``Replicate()`` elsewhere), and
``shard_tree`` places a tree with ``DTensor.from_local``: every rank
passes the same global tensor and keeps its own block (the reference's
``jax.device_put``), with no communication.

``GradientSynchronizer`` is the reference's (:129-296) bucketed,
int8-compressed data-parallel gradient sync over a collective group.
"""

from __future__ import annotations

import math
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from ray_tpu_torch.collective import collective
from ray_tpu_torch.collective.compression import (CompressionConfig,
                                                  auto_pipeline_chunks,
                                                  chunk_layout,
                                                  resolve_compression,
                                                  result_block_size)
from ray_tpu_torch.collective.nccl_group import _resolve_rs_impl
from ray_tpu_torch.ops.quantize import padded_len, quantization_error


class PartitionSpec(tuple):
    """The reference's ``jax.sharding.PartitionSpec``: one entry per
    tensor dim, each None, a mesh axis name, or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicate)
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("dp", "fsdp", "ep"),
    "seq": "sp",
    "embed": "fsdp",       # ZeRO-3: shard params' embed dim over fsdp
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "vocab": "tp",
    "layers": "pp",        # stacked-layer leading axis: stage-sharded when pp>1
    "stages": "pp",
    "experts": "ep",
    "conv_in": None,
    "conv_out": "fsdp",
    "norm": None,
}

# Rules for ACTIVATION constraints: fsdp shards PARAMETER embed dims
# (ZeRO-3: gathered on use); activations keep fsdp on their batch dim, so
# their embed dim stays unsharded (the reference's split, :36-48).
ACTIVATION_RULES: Dict[str, Any] = {
    **DEFAULT_RULES,
    "embed": None,
    "conv_out": None,
}


def _sizes(mesh) -> Dict[str, int]:
    from .mesh import axis_sizes

    return axis_sizes(mesh)


def spec_from_logical(logical: Sequence[Optional[str]],
                      rules: Optional[Dict[str, Any]] = None,
                      mesh=None) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec.

    Axes whose mesh axis has size 1 (or is absent) become None so the same
    model code runs on any mesh shape; a mesh axis shards one tensor dim
    only, and on a clash the leftmost dim keeps it.
    """
    rules = {**DEFAULT_RULES, **(rules or {})}
    sizes = _sizes(mesh) if mesh is not None else None
    out = []
    used: set = set()
    for name in logical:
        mesh_axes = rules.get(name) if name is not None else None
        if mesh_axes is None:
            out.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        if sizes is not None:
            mesh_axes = tuple(a for a in mesh_axes if sizes.get(a, 1) > 1)
        mesh_axes = tuple(a for a in mesh_axes if a not in used)
        used.update(mesh_axes)
        if not mesh_axes:
            out.append(None)
        elif len(mesh_axes) == 1:
            out.append(mesh_axes[0])
        else:
            out.append(tuple(mesh_axes))
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


class Logical:
    """Annotation carried on parameter tree leaves."""

    __slots__ = ("axes",)

    def __init__(self, *axes: Optional[str]):
        self.axes = axes

    def __repr__(self):
        return f"Logical{self.axes!r}"


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``): its DTensor
    placements, and the block of a global tensor each rank holds."""

    def __init__(self, mesh, spec: Sequence = ()):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)
        names = tuple(mesh.mesh_dim_names)
        seen = []
        for entry in self.spec:
            for a in _entry_axes(entry):
                if a not in names:
                    raise ValueError(f"spec {self.spec} names axis {a!r}, "
                                     f"not in the mesh {names}")
                if a in seen:
                    raise ValueError(f"spec {self.spec} names {a!r} twice")
                seen.append(a)
        # DTensor splits a dim over several mesh dims in mesh order,
        # outermost first, as a tuple entry lists them outer to inner
        for entry in self.spec:
            axes = _entry_axes(entry)
            if list(axes) != sorted(axes, key=names.index):
                raise ValueError(f"spec entry {entry} lists mesh axes out "
                                 f"of the mesh's order {names}")

    @property
    def placements(self) -> Tuple[Any, ...]:
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in self.mesh.mesh_dim_names:
            dim = next((d for d, e in enumerate(self.spec)
                        if name in _entry_axes(e)), None)
            out.append(Replicate() if dim is None else Shard(dim))
        return tuple(out)

    def shard_counts(self, ndim: int) -> List[int]:
        """How many blocks each tensor dim is cut into."""
        sizes = _sizes(self.mesh)
        return [math.prod(sizes[a] for a in _entry_axes(e))
                for e in (tuple(self.spec) + (None,) * ndim)[:ndim]]

    def local_slices(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's block of a global tensor of ``shape``: even blocks,
        as the reference requires (an indivisible dim raises)."""
        from .mesh import axis_index

        sizes = _sizes(self.mesh)
        out = []
        for d, n in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            axes = _entry_axes(entry)
            count = math.prod(sizes[a] for a in axes)
            if n % count:
                raise ValueError(
                    f"dim {d} of shape {tuple(shape)} ({n}) does not "
                    f"divide over {axes} ({count}) in spec {self.spec}")
            idx = 0
            for a in axes:                  # outer to inner
                idx = idx * sizes[a] + axis_index(self.mesh, a)
            blk = n // count
            out.append(slice(idx * blk, (idx + 1) * blk))
        return tuple(out)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __hash__(self):
        return hash((id(self.mesh), self.spec))

    def __repr__(self):
        return f"NamedSharding({self.spec!r})"


def from_local(local: torch.Tensor, sharding: NamedSharding):
    """The DTensor whose block on this rank is ``local`` (its memory, no
    copy), of the global shape the even blocks make."""
    from torch.distributed.tensor import DTensor

    counts = sharding.shard_counts(local.dim())
    shape = torch.Size(n * c for n, c in zip(local.shape, counts))
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def distribute(x, sharding: NamedSharding):
    """Place a global tensor on the mesh (the reference's
    ``jax.device_put(x, sharding)``): every rank passes the same ``x`` and
    keeps its block, as a DTensor of x's global shape.  A DTensor is
    redistributed instead."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(sharding.mesh, sharding.placements)
    x = torch.as_tensor(x)
    return from_local(x[sharding.local_slices(x.shape)].contiguous(),
                      sharding)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(n)
    return tuple(reversed(stride))


def spec_of(x) -> PartitionSpec:
    """The PartitionSpec of a DTensor's placements (P() for a tensor
    that lies whole on one device)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return PartitionSpec()
    names = x.device_mesh.mesh_dim_names
    dims: Dict[int, List[str]] = {}
    for name, pl in zip(names, x.placements):
        if pl.is_shard():
            dims.setdefault(pl.dim % x.dim(), []).append(name)
    out = [None] * x.dim()
    for d, axes in dims.items():
        out[d] = axes[0] if len(axes) == 1 else tuple(axes)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_shardings(logical_tree, mesh,
                   rules: Optional[Dict[str, Any]] = None):
    """Map a tree of Logical annotations to NamedShardings."""
    return _tree_map(
        lambda l: NamedSharding(mesh, spec_from_logical(l.axes, rules, mesh)),
        logical_tree)


def shard_tree(tree, logical_tree, mesh,
               rules: Optional[Dict[str, Any]] = None):
    """Place a concrete tree (tensors or numpy arrays, global values) on
    the mesh per its logical annotations: a tree of DTensors."""
    sh = tree_shardings(logical_tree, mesh, rules)
    return _tree_map(lambda x, s: distribute(x, s), tree, sh)


def with_constraint(x, logical: Tuple[Optional[str], ...],
                    rules: Optional[Dict[str, Any]] = None):
    """Sharding constraint by logical axes (the reference's
    ``with_sharding_constraint``): a DTensor is redistributed to the
    spec on its own mesh; anything else is returned as it is (no mesh)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    spec = spec_from_logical(logical, rules, mesh)
    return x.redistribute(mesh, NamedSharding(mesh, spec).placements)


def _flatten(tree, path: str = ""
             ) -> Tuple[List[Tuple[str, Any]], Callable[[List], Any]]:
    """(path, leaf) of a nested dict / list / tuple, in order, and the
    function that rebuilds the structure from new leaves; anything else
    is a leaf.  A path reads like an index into the tree
    (``['layers'][0]``), so an error can name its leaf."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k], f"{path}[{k!r}]") for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v, f"{path}[{i}]") for i, v in enumerate(tree)]
    else:
        return [(path, tree)], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(new: List):
        out, off = [], 0
        for (_, build), n in zip(parts, sizes):
            out.append(build(new[off:off + n]))
            off += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


def bucket_sizes(sizes: Sequence[int], cap: int) -> List[int]:
    """The f32 elements of each bucket ``GradientSynchronizer`` issues for
    float leaves of ``sizes`` elements, pushed in order: a bucket goes
    once the f32 bytes pending reach ``cap`` (``push``), the rest at
    ``finish``."""
    out, cur = [], 0
    for n in sizes:
        cur += n
        if 4 * cur >= cap:
            out.append(cur)
            cur = 0
    if cur:
        out.append(cur)
    return out


SYNC_KERNELS = ("quantize", "dequantize", "dequantize_accumulate",
                "fused_reduce_scatter")


class KernelLaunch(NamedTuple):
    """One quantize-kernel launch of a sync: the kernel (its name in
    ``ops._kernels``), the elements it takes (K6 and K7: of each of
    ``world`` peers), and its block."""
    kernel: str
    n: int
    block: int
    world: int = 1


def sync_plan(sizes: Sequence[int], cc: CompressionConfig, world: int,
              peers: bool = True,
              fused: Optional[bool] = None) -> List[KernelLaunch]:
    """Every K4-K7 launch of one ``GradientSynchronizer`` sync of float
    leaves of ``sizes`` elements on a CUDA group of ``world`` ranks,
    bucket by bucket.  Per compressed bucket, phase 1 runs once per
    pipeline chunk (``chunk_layout`` at auto chunks): K7 where the
    reference's rule picks the fused hop (``_resolve_rs_impl``: world > 1,
    a block multiple of 128, deterministic rounding, the chunk under the
    8 MiB VMEM cap, ``peers`` — the group has peer memory), else K4 and
    K6; phase 2 requantizes at the result block and dequantizes once per
    chunk (or once, when chunks cannot pipeline it); error feedback
    quantizes and dequantizes the bucket once more.  ``fused=True`` plans
    a run that forces the fused hop on every chunk."""
    plan: List[KernelLaunch] = []
    block, rblock = cc.block_size, result_block_size(cc.block_size)
    for n in bucket_sizes(sizes, cc.bucket_bytes):
        if n < cc.min_size:
            continue
        sub = padded_len(n, world * block) // world
        chunks = [nb * block for nb in chunk_layout(
            sub // block,
            cc.pipeline_chunks or auto_pipeline_chunks(n, 4, "gpu"))]
        fused_here = (_resolve_rs_impl("auto", world, block, cc.stochastic,
                                       max(chunks), peers) == "fused"
                      if fused is None else fused)
        for c in chunks:
            plan += ([KernelLaunch("fused_reduce_scatter", c, block, world)]
                     if fused_here else
                     [KernelLaunch("quantize", world * c, block),
                      KernelLaunch("dequantize_accumulate", c, block, world)])
        for c in (chunks if len(chunks) > 1 and block % rblock == 0
                  else [sub]):
            plan += [KernelLaunch("quantize", c, rblock),
                     KernelLaunch("dequantize", world * padded_len(c, rblock),
                                  rblock)]
        if cc.error_feedback:
            plan += [KernelLaunch("quantize", n, block),
                     KernelLaunch("dequantize", n, block)]
    return plan


def sync_launch_counts(plan: Sequence[KernelLaunch]) -> Dict[str, int]:
    """Launches of each of K4-K7 in a ``sync_plan``."""
    counts = dict.fromkeys(SYNC_KERNELS, 0)
    for launch in plan:
        counts[launch.kernel] += 1
    return counts


class GradientSynchronizer:
    """Cross-process gradient sync with optional compressed collectives.

    Each rank computes its local grads, then ``sync(grads)`` allreduces
    every leaf (op="mean" by default) through the group, compressed per
    ``compression`` / the group default / the RAY_TPU_COLLECTIVE_COMPRESSION
    flag.

    Float gradients are COALESCED into f32 buckets of ~``bucket_bytes``
    (CompressionConfig.bucket_bytes unless overridden here) and each
    bucket is issued through ``collective.allreduce_async`` the moment it
    fills, so with the incremental ``begin()/push()/finish()`` API the
    first buckets are in flight while the rest are still being pushed.
    A bucket below the config's ``min_size`` goes uncompressed.

    With ``error_feedback`` on (the CompressionConfig default), the
    compression residual e_t = g_t - deq(quant(g_t)) is kept in the
    PARAMETER dtype and re-injected into the next step's gradient (the
    EF-SGD construction).  Buckets and residuals stay on the gradients'
    device: the residual of each bucket is
    ``ops.quantize.quantization_error`` at the bucket's block size (K4
    then K5 on the card), bit for bit the host codec the reference
    recomputes it with (``compression_residual``).  Push order must
    match across ranks: it is the collective issue order.  A pushed
    tensor must not change before ``finish()``."""

    def __init__(self, group_name: str = "default", op: str = "mean",
                 compression=None, bucket_bytes: Optional[int] = None):
        self.group_name = group_name
        self.op = op
        self.compression = compression
        self.bucket_bytes = bucket_bytes
        self._residuals: Optional[Dict[int, torch.Tensor]] = None
        self._stream: Optional[dict] = None

    def reset(self):
        """Drop accumulated error-feedback residuals (e.g. after a
        checkpoint restore on different parameters)."""
        self._residuals = None

    @property
    def residuals(self) -> Dict[int, torch.Tensor]:
        """The error-feedback residual of each slot, in the parameter
        dtype (empty before the first sync or without error feedback)."""
        return dict(self._residuals or {})

    # -- incremental streaming API ---------------------------------------

    def begin(self):
        """Start a sync stream; feed leaves with push(), collect with
        finish()."""
        cc = resolve_compression(self.compression)
        cap = self.bucket_bytes
        if cap is None:
            cap = cc.bucket_bytes if cc is not None else 4 << 20
        if self._residuals is None:
            self._residuals = {}
        self._stream = {
            "cc": cc,
            "use_ef": cc is not None and cc.error_feedback,
            "cap": max(1, int(cap)),
            "pending": [],        # (slot, tensor) awaiting bucket flush
            "pending_bytes": 0,
            "buckets": [],        # flushed: (handle, corrected, segments)
            "singles": {},        # slot -> handle (non-bucketed leaves)
            "meta": {},           # slot -> (shape, dtype)
            "nslots": 0,
        }
        return self

    def push(self, g: torch.Tensor) -> int:
        """Enqueue one gradient leaf; returns its slot id.  Issues the
        current bucket's allreduce as soon as it crosses bucket_bytes."""
        st = self._stream
        if st is None:
            raise RuntimeError("push() outside begin()/finish() — call "
                               "begin() first (or use __call__)")
        slot = st["nslots"]
        st["nslots"] += 1
        st["meta"][slot] = (g.shape, g.dtype)
        if st["cc"] is not None and g.is_floating_point():
            st["pending"].append((slot, g))
            st["pending_bytes"] += g.numel() * 4     # bucket carries f32
            if st["pending_bytes"] >= st["cap"]:
                self._flush_bucket()
        else:
            st["singles"][slot] = collective.allreduce_async(
                g, self.group_name, op=self.op, compression=st["cc"])
        return slot

    def _flush_bucket(self):
        st = self._stream
        if not st["pending"]:
            return
        parts, segments, off = [], [], 0
        for slot, g in st["pending"]:
            flat = g.reshape(-1).to(torch.float32)
            res = self._residuals.get(slot) if st["use_ef"] else None
            if res is not None:
                flat = flat + res.reshape(-1).to(torch.float32)
            parts.append(flat)
            segments.append((slot, off, off + flat.numel()))
            off += flat.numel()
        st["pending"] = []
        st["pending_bytes"] = 0
        corrected = parts[0] if len(parts) == 1 else torch.cat(parts)
        handle = collective.allreduce_async(corrected, self.group_name,
                                            op=self.op, compression=st["cc"])
        st["buckets"].append((handle, corrected, segments))

    def finish(self) -> List[torch.Tensor]:
        """Flush the tail bucket, await every in-flight reduce, update
        residuals, and return the synced leaves in push order."""
        st = self._stream
        if st is None:
            raise RuntimeError("finish() without begin()")
        self._flush_bucket()
        cc = st["cc"]
        out: List[Optional[torch.Tensor]] = [None] * st["nslots"]
        for handle, corrected, segments in st["buckets"]:
            reduced = handle.result()
            # did the wire actually compress this bucket?  (mirrors
            # collective._resolve_op_compression: small buckets go exact)
            compressed = cc is not None and corrected.numel() >= cc.min_size
            resid = (quantization_error(corrected, cc.block_size)
                     if compressed and st["use_ef"] else None)
            for slot, a, b in segments:
                shape, dtype = st["meta"][slot]
                out[slot] = reduced[a:b].reshape(shape).to(dtype)
                if resid is not None:
                    # parameter dtype on purpose: bf16 params keep bf16
                    # residuals (the re-injection upcasts to f32)
                    self._residuals[slot] = resid[a:b].reshape(shape).to(
                        dtype)
                elif st["use_ef"]:
                    # an exact (uncompressed) sync consumed whatever
                    # residual was injected
                    self._residuals[slot] = torch.zeros(
                        shape, dtype=dtype, device=corrected.device)
        for slot, handle in st["singles"].items():
            out[slot] = handle.result()
        self._stream = None
        return out

    def __call__(self, grads):
        """Sync a tree (nested dicts, lists, tuples) of gradient tensors;
        returns the same structure of synced tensors."""
        leaves, rebuild = _flatten(grads)
        for path, g in leaves:
            if not isinstance(g, torch.Tensor):
                raise TypeError(
                    f"gradient trees hold tensors in dicts, lists and "
                    f"tuples; got {type(g).__name__} at {path or '<root>'}")
        self.begin()
        for _, g in leaves:
            self.push(g)
        return rebuild(self.finish())
