"""Python endpoints for native shared-memory ring channels.

Binding over ray_tpu_torch/native/shm_channel.cc — the mutable-object
transport under compiled graphs (reference: experimental/channel/
shared_memory_channel.py over experimental_mutable_object_manager.h).

Value envelope (first byte):
  0x01  inline payload: serialization.dumps_inline bytes follow
  0x02  spilled payload: pickled ObjectRef follows (value was larger than
        the slot; it went through the object store instead)
  0x03  error: pickled exception follows (propagates through the DAG)
  0x04  device tensor: tiny (shape, dtype, device type) header + RAW
        buffer bytes — the torch.Tensor fast path (see below)
  0x00  stop sentinel (teardown)

Device tensors (the NCCL-channel role, reference:
experimental/channel/torch_tensor_nccl_channel.py).  The port's copy of
``ray_tpu/dag/channel.py``, with ``torch.Tensor`` where the reference has
``jax.Array``: a stage actor owns its own card (or a share of one), so a
cross-ACTOR edge stages through host memory, and what the channel removes
is the serialization tax.  A tensor moves as one device->shm copy on the
writer, straight into the ring slot and complete before the slot is
published, and one copy out of the slot on the reader, before the slot
is released: straight onto the reader's card for a tensor staged from a
card (``serialization._receiving_device``: the reader's ``cuda`` device
when it sees a card), into an owned host buffer otherwise; a CPU tensor
stays a CPU tensor.  An endpoint that copies between a card and its
mapping page-locks the mapping with CUDA first (``cudaHostRegister``),
so those copies run at DMA rate, not through the driver's pageable
staging.  The raw bytes go through a ``torch.uint8`` view, so bf16 and
float8 need no numpy dtype.

torch is looked up in ``sys.modules``, never imported here: a process
that carries no tensor never pays torch's import.
"""

from __future__ import annotations

import ctypes
import os
import pickle
import struct
import sys
from typing import Any, Optional, Tuple

import cloudpickle

from .._private import serialization
from .._private.core import current_core

TAG_STOP = 0
TAG_INLINE = 1
TAG_SPILLED = 2
TAG_ERROR = 3
TAG_DEVICE = 4

DEFAULT_SLOT_BYTES = 1 << 20
DEFAULT_NSLOTS = 4

# forces the raw tensor path on (1) or off (0) for every tensor; unset, it
# is on for CUDA tensors only
DEVICE_CHANNEL_ENV = "RAY_TPU_TORCH_DAG_DEVICE_CHANNEL"

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from ..native.build import load_library

    lib = load_library("shm_channel", ["shm_channel.cc"])
    lib.rt_chan_open.restype = ctypes.c_void_p
    lib.rt_chan_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                 ctypes.c_uint32]
    lib.rt_chan_close_handle.argtypes = [ctypes.c_void_p]
    lib.rt_chan_slot_size.restype = ctypes.c_uint64
    lib.rt_chan_slot_size.argtypes = [ctypes.c_void_p]
    lib.rt_chan_write_acquire.restype = ctypes.c_int64
    lib.rt_chan_write_acquire.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.rt_chan_write_release.restype = ctypes.c_int
    lib.rt_chan_write_release.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rt_chan_read_acquire.restype = ctypes.c_int64
    lib.rt_chan_read_acquire.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
    lib.rt_chan_read_release.restype = ctypes.c_int
    lib.rt_chan_read_release.argtypes = [ctypes.c_void_p]
    lib.rt_chan_close.argtypes = [ctypes.c_void_p]
    lib.rt_chan_is_closed.restype = ctypes.c_int
    lib.rt_chan_is_closed.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class ChannelClosed(Exception):
    pass


class ChannelTimeout(Exception):
    pass


def _device_path_enabled(t) -> bool:
    """Raw-bytes transport pays off when host staging replaces a pickle of
    device memory; a CPU tensor already IS host memory, and its raw path
    adds a copy on the reader, so it is on by default for CUDA tensors
    only.  RAY_TPU_TORCH_DAG_DEVICE_CHANNEL=1/0 forces either way
    (tests)."""
    env = os.environ.get(DEVICE_CHANNEL_ENV)
    if env is not None:
        return env.strip().lower() not in ("0", "false", "no", "off", "")
    return t.is_cuda


def _as_device_tensor(value):
    """The torch.Tensor fast-path guard (no torch import when unused)."""
    torch = sys.modules.get("torch")
    if torch is None or not isinstance(value, torch.Tensor):
        return None
    # sparse, quantized and meta tensors have no plain raw-bytes form:
    # pickle path
    if value.layout != torch.strided or value.is_quantized \
            or value.is_meta:
        return None
    if not _device_path_enabled(value):
        return None
    return value


def _tensor_header(t) -> bytes:
    meta = pickle.dumps((tuple(t.shape), str(t.dtype).split(".", 1)[1],
                         t.device.type), protocol=5)
    return struct.pack("<I", len(meta)) + meta


class Channel:
    """One endpoint (this process may use it as writer, reader, or both in
    tests).  SPSC: exactly one writer process and one reader process."""

    def __init__(self, path: str, slot_bytes: int = DEFAULT_SLOT_BYTES,
                 nslots: int = DEFAULT_NSLOTS):
        self.path = path
        self._lib = _load()
        self._chan = self._lib.rt_chan_open(path.encode(), slot_bytes,
                                            nslots)
        if not self._chan:
            raise RuntimeError(f"rt_chan_open failed for {path}")
        self._slot = self._lib.rt_chan_slot_size(self._chan)
        self._fd = os.open(path, os.O_RDWR)
        self._mm = None  # lazily map the whole (small) channel file
        self._pinned = None  # the mapping's address once page-locked
        self._closed_handle = False

    def _map(self):
        if self._mm is None:
            import mmap

            size = os.fstat(self._fd).st_size
            self._mm = mmap.mmap(self._fd, size)
        return self._mm

    def _pin(self):
        """Page-lock this process's mapping of the channel with CUDA, once.
        Raises when the driver refuses: a pageable mapping would stage
        every copy through the driver at a tenth of the rate."""
        if self._pinned is not None:
            return
        torch = sys.modules["torch"]
        mm = self._map()
        buf = ctypes.c_char.from_buffer(mm)
        addr = ctypes.addressof(buf)
        del buf                     # no export may outlive it: close() fails
        rc = int(torch.cuda.cudart().cudaHostRegister(addr, len(mm), 0))
        if rc != 0:
            raise RuntimeError(
                f"cudaHostRegister of channel {self.path}'s mapping "
                f"({len(mm)} bytes) failed with CUDA error {rc}")
        self._pinned = addr

    def _acquire_write(self, timeout_s: Optional[float]) -> int:
        t_us = -1 if timeout_s is None else int(timeout_s * 1e6)
        off = self._lib.rt_chan_write_acquire(self._chan, t_us)
        if off == -3:
            raise ChannelClosed(self.path)
        if off == -2:
            raise ChannelTimeout(self.path)
        return off

    # -- write -------------------------------------------------------------

    def write(self, value: Any, timeout_s: Optional[float] = None):
        t = _as_device_tensor(value)
        if t is not None:
            head = _tensor_header(t)
            nbytes = t.numel() * t.element_size()
            if 1 + len(head) + nbytes <= self._slot:
                self._write_device(head, t, nbytes, timeout_s)
                return
        payload = serialization.dumps_inline(value)
        if 1 + len(payload) > self._slot:
            ref = current_core().put(value)
            # dumps_inline swaps the ref for a SerializedRef marker so the
            # reader re-wraps it with borrower ref-counting intact
            payload = serialization.dumps_inline(ref)
            tag = TAG_SPILLED
        else:
            tag = TAG_INLINE
        self._write_raw(tag, payload, timeout_s)

    def _write_device(self, head: bytes, t, nbytes: int,
                      timeout_s: Optional[float]):
        torch = sys.modules["torch"]
        if t.is_cuda:
            self._pin()
        off = self._acquire_write(timeout_s)
        mm = self._map()
        mm[off] = TAG_DEVICE
        pos = off + 1
        mm[pos:pos + len(head)] = head
        pos += len(head)
        if nbytes:
            # raw bytes straight into the ring slot: ONE device -> shm
            # copy, synchronous (a pageable destination), so it is
            # complete before the slot is published below
            view = memoryview(mm)[pos:pos + nbytes]
            try:
                dst = torch.frombuffer(view, dtype=torch.uint8)
                dst.copy_(t.detach().contiguous().reshape(-1)
                          .view(torch.uint8))
                del dst
            finally:
                view.release()
        self._lib.rt_chan_write_release(self._chan, 1 + len(head) + nbytes)

    def write_error(self, exc: BaseException,
                    timeout_s: Optional[float] = None):
        try:
            payload = cloudpickle.dumps(exc)
        except BaseException:
            payload = cloudpickle.dumps(
                RuntimeError(f"{type(exc).__name__}: {exc}"))
        self._write_raw(TAG_ERROR, payload, timeout_s)

    def write_stop(self, timeout_s: Optional[float] = 1.0):
        try:
            self._write_raw(TAG_STOP, b"", timeout_s)
        except (ChannelClosed, ChannelTimeout):
            pass

    def _write_raw(self, tag: int, payload: bytes,
                   timeout_s: Optional[float]):
        if 1 + len(payload) > self._slot:
            raise ValueError(
                f"payload of {len(payload)}B exceeds channel slot "
                f"{self._slot}B even after spilling")
        off = self._acquire_write(timeout_s)
        mm = self._map()
        mm[off] = tag
        mm[off + 1:off + 1 + len(payload)] = payload
        self._lib.rt_chan_write_release(self._chan, 1 + len(payload))

    # -- read --------------------------------------------------------------

    def read(self, timeout_s: Optional[float] = None) -> Tuple[int, Any]:
        """Returns (tag, value).  Raises ChannelClosed / ChannelTimeout."""
        t_us = -1 if timeout_s is None else int(timeout_s * 1e6)
        nbytes = ctypes.c_uint64(0)
        off = self._lib.rt_chan_read_acquire(self._chan,
                                             ctypes.byref(nbytes), t_us)
        if off == -3:
            raise ChannelClosed(self.path)
        if off == -2:
            raise ChannelTimeout(self.path)
        mm = self._map()
        staged = None
        try:
            tag = mm[off]
            if tag == TAG_DEVICE:
                staged = self._stage_device(mm, off, nbytes.value)
            else:
                payload = bytes(mm[off + 1:off + nbytes.value])
        finally:
            # every byte of the slot was copied into memory this process
            # owns: the writer may reuse it now
            self._lib.rt_chan_read_release(self._chan)
        if tag == TAG_DEVICE:
            # the tag is surfaced so tests can observe the fast path;
            # consumers treat any non-STOP/ERROR tag as a value
            return TAG_DEVICE, _restore_staged(*staged)
        if tag == TAG_INLINE:
            return tag, serialization.loads_inline(payload)
        if tag == TAG_SPILLED:
            ref = serialization.loads_inline(payload)
            return TAG_INLINE, current_core().get(ref, timeout=300.0)
        if tag == TAG_ERROR:
            return tag, cloudpickle.loads(payload)
        return TAG_STOP, None

    def _stage_device(self, mm, off: int, end: int):
        """Copy a device-tensor payload out of the ring slot into memory
        this process owns (one copy): onto the reader's card for a tensor
        staged from a card when the reader sees one, else an owned host
        buffer.  A tensor aliasing the slot would be overwritten by the
        next writer."""
        import torch

        view = memoryview(mm)[off + 1:off + end]
        try:
            (meta_len,) = struct.unpack_from("<I", view, 0)
            shape, dtype, device_type = pickle.loads(
                bytes(view[4:4 + meta_len]))
            n = len(view) - 4 - meta_len
            dev = ("cpu" if device_type == "cpu"
                   else serialization._receiving_device(torch))
            staged = torch.empty(n, dtype=torch.uint8, device=dev)
            if staged.is_cuda:
                self._pin()
            if n:
                src = torch.frombuffer(view, dtype=torch.uint8, count=n,
                                       offset=4 + meta_len)
                # synchronous: complete before the slot is released
                staged.copy_(src)
                del src
        finally:
            view.release()
        return staged, shape, dtype

    # -- lifecycle ---------------------------------------------------------

    def close(self):
        """Mark the channel closed (wakes both sides)."""
        if not self._closed_handle:
            self._lib.rt_chan_close(self._chan)

    def release(self):
        if self._closed_handle:
            return
        self._closed_handle = True
        try:
            if self._pinned:
                # unregistered before the mapping goes
                sys.modules["torch"].cuda.cudart().cudaHostUnregister(
                    self._pinned)
        except Exception:
            pass
        try:
            if self._mm is not None:
                self._mm.close()
            os.close(self._fd)
        except OSError:
            pass
        self._lib.rt_chan_close_handle(self._chan)
        self._chan = None

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


def _restore_staged(staged, shape, dtype: str):
    """The owned bytes (host or the reader's card) as a tensor of
    ``dtype`` and ``shape``."""
    import torch

    return staged.view(getattr(torch, dtype)).reshape(shape)
