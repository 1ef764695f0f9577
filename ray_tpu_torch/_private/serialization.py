"""Serialization: pickle-5 out-of-band buffers + device-tensor awareness.

The port's copy of ``ray_tpu/_private/serialization.py`` (reference Ray:
python/ray/_private/serialization.py — cloudpickle + zero-copy numpy via
plasma buffers), with ``torch.Tensor`` where the reference has
``jax.Array``.  Inside one process a CUDA tensor stays device-resident in
the in-process store (core.py); when a tensor crosses a process boundary
through the object plane it is staged to host as a numpy array, which
rides pickle 5's out-of-band path, and restored by the receiver:

  * a tensor that lived on a card lands on the receiving process's
    default device — a CUDA tensor in a worker that sees a GPU, a CPU
    tensor in a CPU-only worker (as ``_restore_device_array`` gives a jax
    default-device array in the reference);
  * a CPU tensor stays a CPU tensor;
  * bf16 has no numpy dtype: its bits travel as ``uint16`` (float8 as
    ``uint8``);
  * non-contiguous tensors arrive contiguous, and a tensor that requires
    grad arrives detached (a leaf with ``requires_grad=False``: autograd
    graphs never cross processes);
  * a load that only passes values on (the client server's) keeps a
    tensor staged from a card as its host-side stand-in, which is
    serialized again as such (``keep_stand_ins=True``).

torch is looked up in ``sys.modules``, never imported at load: a process
that never held a tensor never pays torch's import.  Large device-to-
device movement belongs to the collective plane, not the object store —
this path is correctness, not the fast path.

ObjectRefs inside values are swapped for SerializedRef markers; the
deserializing side re-wraps them via a context hook so borrower ref-counting
works (reference: reference_count.h borrower protocol).
"""

from __future__ import annotations

import contextvars
import io
import pickle
import sys
import warnings
from typing import Any, Callable, List, Optional, Tuple

import cloudpickle

from .common import SerializedRef

# Hooks installed by core.py: map ObjectRef -> SerializedRef and back.
_ref_to_marker: Optional[Callable[[Any], Any]] = None
_marker_to_ref: Optional[Callable[[SerializedRef], Any]] = None
_ref_type: Optional[type] = None


def install_ref_hooks(ref_type: type, to_marker, from_marker) -> None:
    global _ref_type, _ref_to_marker, _marker_to_ref
    _ref_type = ref_type
    _ref_to_marker = to_marker
    _marker_to_ref = from_marker


def _torch():
    return sys.modules.get("torch")


class _TensorStandIn:
    """Host-staged stand-in for a torch.Tensor crossing the object plane:
    the host bytes as a numpy array (bf16 and float8 as unsigned integers
    of their width), the tensor's dtype name and the device type it was
    staged from.  ``placement`` is the counterpart of the reference's
    sharding descriptor; mesh placement waits for the port's meshes
    (ROADMAP A.6), so it is carried and left unused."""

    def __init__(self, np_value, dtype: str, device_type: str,
                 placement=None):
        self.np_value = np_value
        self.dtype = dtype
        self.device_type = device_type
        self.placement = placement


# numpy has no dtype for these: their bits travel as unsigned integers of
# the same width
_BITS_AS = {"bfloat16": "uint16", "float8_e4m3fn": "uint8",
            "float8_e5m2": "uint8", "float8_e4m3fnuz": "uint8",
            "float8_e5m2fnuz": "uint8"}
_SIGNED = {"uint16": "int16", "uint8": "int8"}

# Test hook: the device a tensor staged from a card is restored on.  None
# means the receiving process's default (cuda when it sees a card).
_restore_device_override: Optional[Callable[[], str]] = None


def set_restore_device(fn: Optional[Callable[[], str]]) -> None:
    """Inject the device choice of ``_restore_tensor`` (None: default)."""
    global _restore_device_override
    _restore_device_override = fn


def _receiving_device(torch) -> str:
    if _restore_device_override is not None:
        return _restore_device_override()
    return "cuda" if torch.cuda.is_available() else "cpu"


# A load that only passes values through (the client server's) keeps a
# tensor staged from a card as its stand-in: it is serialized again as
# what it was and comes back to life in the process that finally reads it,
# while this one imports no torch for it and opens no CUDA context.  Set
# for the length of that one load, so that every other load in the process
# (other threads, a driver beside the server) restores as usual.
_keeping_stand_ins = contextvars.ContextVar("keeping_stand_ins",
                                            default=False)


def _load(thunk: Callable[[], Any], keep_stand_ins: bool) -> Any:
    if not keep_stand_ins:
        return thunk()
    token = _keeping_stand_ins.set(True)
    try:
        return thunk()
    finally:
        _keeping_stand_ins.reset(token)


def _stage_tensor(t) -> _TensorStandIn:
    """Host copy of ``t`` (one D2H copy for a CUDA tensor)."""
    torch = _torch()
    dtype = str(t.dtype).split(".", 1)[1]
    host = t.detach().to("cpu").contiguous()
    bits = _BITS_AS.get(dtype)
    if bits is not None:
        # view as the signed integer of the same width (every torch has
        # those), then reinterpret in numpy
        arr = host.view(getattr(torch, _SIGNED[bits])).numpy().view(bits)
    else:
        arr = host.numpy()
    return _TensorStandIn(arr, dtype, t.device.type)


def _restore_tensor(stand_in: _TensorStandIn):
    import numpy as np
    import torch

    dev = "cpu" if stand_in.device_type == "cpu" else \
        _receiving_device(torch)
    arr = stand_in.np_value
    if not arr.flags.writeable and dev == "cpu":
        # out-of-band buffers map the store's read-only pages; a CPU
        # tensor must own memory it may write (a copy to the card owns
        # its memory already)
        arr = np.array(arr, copy=True)
    bits = _BITS_AS.get(stand_in.dtype)
    if bits is not None:
        arr = arr.view(_SIGNED[bits])
    with warnings.catch_warnings():
        # a read-only array only feeds the copy to the card below
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    if bits is not None:
        t = t.view(getattr(torch, stand_in.dtype))
    return t if dev == "cpu" else t.to(dev)


def _restore_stand_in(np_value, dtype: str, device_type: str,
                      placement=None):
    """Unpickle a tensor: its stand-in in a load that keeps them (for a
    tensor staged from a card), else the tensor."""
    stand_in = _TensorStandIn(np_value, dtype, device_type, placement)
    if device_type != "cpu" and _keeping_stand_ins.get():
        return stand_in
    return _restore_tensor(stand_in)


def _reduce_stand_in(s: _TensorStandIn):
    return (_restore_stand_in,
            (s.np_value, s.dtype, s.device_type, s.placement))


def holds_cuda_tensor(value, _depth: int = 0) -> bool:
    """True for a CUDA tensor, or a dict/list/tuple holding one (two
    levels deep at most, enough for a model's parameter dict)."""
    torch = _torch()
    if torch is None:
        return False
    if isinstance(value, torch.Tensor):
        return value.is_cuda
    if _depth >= 2:
        return False
    if isinstance(value, dict):
        return any(holds_cuda_tensor(v, _depth + 1) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(holds_cuda_tensor(v, _depth + 1) for v in value)
    return False


def device_nbytes(value) -> Optional[int]:
    """Bytes of a tensor, or of the tensors of a dict/list/tuple holding a
    CUDA tensor; None for anything else."""
    torch = _torch()
    if torch is None:
        return None
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if not holds_cuda_tensor(value):
        return None
    leaves = value.values() if isinstance(value, dict) else value
    return sum(device_nbytes(v) or 0 for v in leaves)


class _Pickler(cloudpickle.Pickler):
    def __init__(self, file, buffer_callback=None):
        super().__init__(file, protocol=5, buffer_callback=buffer_callback)

    def reducer_override(self, obj):
        if _ref_type is not None and type(obj) is _ref_type:
            return (_deserialize_marker, (_ref_to_marker(obj),))
        if type(obj) is _TensorStandIn:
            return _reduce_stand_in(obj)
        torch = _torch()
        if torch is not None and isinstance(obj, torch.Tensor):
            return _reduce_stand_in(_stage_tensor(obj))
        # delegate to cloudpickle's own override (functions/classes by value)
        return super().reducer_override(obj)


def _deserialize_marker(marker: SerializedRef):
    if _marker_to_ref is None:
        return marker
    return _marker_to_ref(marker)


# Exact-type primitives can never hit reducer_override (no ObjectRef
# markers, no device arrays, no closures) — plain pickle is safe and
# skips a CloudPickler construction per value on the task hot path.
_PRIMITIVE_TYPES = frozenset({type(None), bool, int, float, str, bytes})


def _is_primitive(value: Any) -> bool:
    t = type(value)
    if t in _PRIMITIVE_TYPES:
        return True
    if t is tuple or t is list:
        return len(value) <= 8 and \
            all(type(v) in _PRIMITIVE_TYPES for v in value)
    return False


def dumps_oob(value: Any) -> Tuple[bytes, List[pickle.PickleBuffer]]:
    """Serialize with out-of-band buffers (zero-copy for numpy/bytes)."""
    if _is_primitive(value):
        return pickle.dumps(value, protocol=5), []
    buffers: List[pickle.PickleBuffer] = []
    f = io.BytesIO()
    p = _Pickler(f, buffer_callback=buffers.append)
    p.dump(value)
    return f.getvalue(), buffers


def loads_oob(meta: bytes, buffers: List[memoryview], *,
              keep_stand_ins: bool = False) -> Any:
    """``keep_stand_ins``: a tensor staged from a card stays its stand-in."""
    return _load(lambda: pickle.loads(meta, buffers=buffers), keep_stand_ins)


def dumps_inline(value: Any) -> bytes:
    """Serialize fully in-band (for RPC messages)."""
    if _is_primitive(value):
        return pickle.dumps(value, protocol=5)
    f = io.BytesIO()
    _Pickler(f).dump(value)
    return f.getvalue()


# -- small-arg fast path ------------------------------------------------------
#
# The task hot path serializes (args, kwargs) once per .remote().  When the
# args are a short tuple of plain scalars/bytes/ObjectRefs with no kwargs
# (the benchmark and RL actor-step shape), full pickle framing through
# _Pickler is pure overhead: a plain protocol-5 pickle of the converted
# tuple suffices, and repeated identical ref-free tuples can reuse their
# bytes outright.  Blobs carry a one-byte prefix that no pickle stream
# starts with (protocol-5 pickles begin with b'\x80'), so loads_inline
# stays a single entry point for both framings.

_SMALL_PREFIX = b"\xf5"
_SMALL_MAX_ARGS = 8

# type-aware memo: hash(1) == hash(True) == hash(1.0) and they compare
# equal, but their pickles differ — the key must carry the value types.
# Only ref-free tuples are memoizable (ref->marker conversion pins the
# object per serialization; reusing a blob must not skip that bookkeeping).
_small_memo: dict = {}


def _small_memo_key(args: tuple):
    try:
        return tuple((type(a), a) for a in args)
    except TypeError:  # pragma: no cover - all eligible types are hashable
        return None


def dumps_args_small(args: tuple, *, limit: int,
                     memo_cap: int = 0) -> Optional[bytes]:
    """Fast inline framing for a no-kwargs call whose args are all plain
    scalars/bytes or ObjectRefs.  Returns None when ineligible (caller
    falls back to the full path); round-trips through loads_inline to the
    same (args, {}) the full path produces."""
    if limit <= 0 or len(args) > _SMALL_MAX_ARGS:
        return None
    has_ref = False
    for a in args:
        t = type(a)
        if t in _PRIMITIVE_TYPES:
            # big strings/bytes would pickle past the limit anyway;
            # bail before paying for the dump on every call
            if (t is bytes or t is str) and len(a) > limit:
                return None
            continue
        if _ref_type is not None and t is _ref_type:
            has_ref = True
            continue
        return None
    if not has_ref and memo_cap > 0:
        key = _small_memo_key(args)
        cached = _small_memo.get(key) if key is not None else None
        if cached is not None:
            return cached
    else:
        key = None
    if has_ref:
        # swap refs for markers by hand — plain pickle can't carry
        # ObjectRefs (their __reduce__ raises), and the conversion's pin
        # bookkeeping must run exactly like the full path's
        ref_pos = []
        conv = []
        for i, a in enumerate(args):
            if type(a) is _ref_type:
                ref_pos.append(i)
                conv.append(_ref_to_marker(a))
            else:
                conv.append(a)
        blob = _SMALL_PREFIX + pickle.dumps(
            (tuple(conv), tuple(ref_pos)), protocol=5)
    else:
        blob = _SMALL_PREFIX + pickle.dumps((args, ()), protocol=5)
    if len(blob) > limit:
        return None
    if key is not None:
        if len(_small_memo) >= memo_cap:
            _small_memo.clear()  # cheap bound; the hot set refills fast
        _small_memo[key] = blob
    return blob


def _loads_args_small(blob: bytes):
    conv, ref_pos = pickle.loads(blob[1:])
    if ref_pos:
        out = list(conv)
        for i in ref_pos:
            out[i] = _marker_to_ref(out[i]) if _marker_to_ref is not None \
                else out[i]
        return tuple(out), {}
    return conv, {}


def loads_inline(blob: bytes, *, keep_stand_ins: bool = False) -> Any:
    if blob[:1] == _SMALL_PREFIX:
        return _loads_args_small(blob)
    return _load(lambda: pickle.loads(blob), keep_stand_ins)


def value_nbytes_estimate(meta: bytes, buffers) -> int:
    return len(meta) + sum(len(b.raw() if hasattr(b, "raw") else b) for b in buffers)
