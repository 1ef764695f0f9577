"""ctypes binding for the native shared-memory arena store.

`NativeShmObjectStore` implements the exact interface of the file-per-object
`FileObjectStore` (shm_store.py) on top of the C++ arena
(ray_tpu_torch/native/shm_arena.cc): one mmap-backed arena file per node session,
page-aligned payloads so each reader maps only its object, pid-validated
reader pins, and inline LRU eviction under memory pressure — the plasma
equivalent (reference: src/ray/object_manager/plasma/store.h) without a
store daemon or socket round-trips.

Objects too large for the arena overflow to the file-per-object store in
the same directory (the role plasma's fallback-allocation-to-disk plays,
reference: plasma/plasma_allocator.h fallback allocator).

The port's copy of ``ray_tpu/_private/native_store.py``: imports
renamed, variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP
§C.
"""

from __future__ import annotations

import ctypes
import logging
import mmap
import os
import weakref
from typing import List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

def DEFAULT_CAPACITY() -> int:
    # read at store-construction time so tests/daemons can size the arena
    # through the environment / _system_config (config.py flag table).
    # Unset: 30% of system memory like the reference's plasma sizing
    # (reference: ray_constants.py DEFAULT_OBJECT_STORE_MEMORY_PROPORTION),
    # clamped to [1 GiB, 64 GiB].  The arena file is sparse — untouched
    # capacity costs nothing.
    from .config import cfg

    configured = cfg().object_store_bytes
    if configured:
        return configured
    total = 0
    try:
        total = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        pass
    # The warm-first extent allocator (shm_arena.cc extent_alloc) keeps
    # the touched page window as small as the live set, so a generous
    # sparse arena costs nothing until used.
    return max(1 << 30, min(int(total * 0.3), 64 << 30))
N_ENTRIES = 16384  # power of two

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from ray_tpu_torch.native.build import load_library

    lib = load_library("shm_arena", ["shm_arena.cc"])
    lib.rt_arena_open.restype = ctypes.c_void_p
    lib.rt_arena_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_uint32]
    lib.rt_arena_close.argtypes = [ctypes.c_void_p]
    lib.rt_create.restype = ctypes.c_uint64
    lib.rt_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_uint64,
                              ctypes.POINTER(ctypes.c_int),
                              ctypes.c_uint32]
    lib.rt_set_primary.restype = ctypes.c_int
    lib.rt_set_primary.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int]
    lib.rt_get_flags.restype = ctypes.c_int64
    lib.rt_get_flags.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    for fn in ("rt_seal", "rt_abort", "rt_release", "rt_delete",
               "rt_contains"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_get.restype = ctypes.c_uint64
    lib.rt_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                           ctypes.POINTER(ctypes.c_uint64)]
    lib.rt_size.restype = ctypes.c_int64
    lib.rt_size.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_list.restype = ctypes.c_uint64
    lib.rt_list.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_uint64]
    lib.rt_stats.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_uint64)] * 4
    lib.rt_memcpy.restype = None
    lib.rt_memcpy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_uint64]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception as e:  # toolchain missing → caller falls back
        logger.warning("native store unavailable: %s", e)
        return False


class NativeShmObjectStore:
    """Arena-backed store with file-per-object overflow."""

    def __init__(self, root: str, capacity: int = 0):
        from .shm_store import FileObjectStore

        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lib = _load()
        self._capacity = capacity or DEFAULT_CAPACITY()
        self._arena_path = os.path.join(root, "arena.shm")
        self._arena = self._lib.rt_arena_open(
            self._arena_path.encode(), self._capacity, N_ENTRIES)
        if not self._arena:
            raise RuntimeError(f"rt_arena_open failed for {self._arena_path}")
        self._fd = os.open(self._arena_path, os.O_RDWR)
        # One long-lived rw mapping of the whole arena for the write path:
        # a per-create mmap/munmap pays ~size/4KiB soft page-faults on every
        # put (the munmap drops the PTEs even though the shm pages stay in
        # the page cache), which halves large-put bandwidth. PTEs under a
        # persistent map survive across puts, so after warmup a put is one
        # memcpy. Readers keep per-object maps — their pin release is tied
        # to the mapping's lifetime (see _map_object).
        self._wmap: Optional[mmap.mmap] = None
        try:
            self._wmap = mmap.mmap(self._fd, 0)
        except (ValueError, OSError):
            pass  # fall back to per-create mappings
        self._overflow = FileObjectStore(root)
        # Shared with reader-pin finalizers: once closed, the arena handle
        # is gone and late releases must become no-ops (pins of a live pid
        # are reclaimed by dead-pid validation only at process exit — the
        # store is only closed at shutdown, so the leak window is nil).
        self._state = {"closed": False}

    # -- write path --------------------------------------------------------

    def _check_open(self):
        if self._state["closed"]:
            raise ValueError("object store is closed")

    PRIMARY = 1  # arena kFlagPrimary: unevictable until spilled

    WARM_ONLY = 1 << 30  # arena kFlagWarmOnly: fail rather than touch cold pages

    def create(self, object_id: str, meta: bytes,
               buffers: Sequence[memoryview], primary: bool = True,
               allow_overflow: bool = True,
               warm_only: bool = False) -> Optional[int]:
        """Write an object into the arena.  Returns its packed size, or
        None when allow_overflow=False and the arena has no room — or
        warm_only=True and only never-touched (cold) space fits — so the
        caller can free memory (e.g. flush deferred deletes) and retry."""
        from .shm_store import layout_size, pack_into

        self._check_open()
        size = layout_size(len(meta), [len(b) for b in buffers])
        oid = object_id.encode()
        err = ctypes.c_int(0)
        flags = self.PRIMARY if primary else 0
        if warm_only:
            flags |= self.WARM_ONLY
        off = self._lib.rt_create(self._arena, oid, size,
                                  ctypes.byref(err), flags)
        if err.value == 1:
            return size  # already created/sealed: objects are immutable
        if off == 0:
            if warm_only or not allow_overflow:
                return None
            # arena exhausted even after eviction → file overflow
            return self._overflow.create(object_id, meta, buffers)
        try:
            if self._wmap is not None and off + size <= len(self._wmap):
                dst = memoryview(self._wmap)[off:off + size]
                try:
                    self._pack_fast(dst, meta, buffers)
                finally:
                    dst.release()
            else:
                mm = mmap.mmap(self._fd, size, offset=off)
                try:
                    self._pack_fast(memoryview(mm), meta, buffers)
                finally:
                    mm.close()
        except BaseException:
            self._lib.rt_abort(self._arena, oid)
            raise
        self._lib.rt_seal(self._arena, oid)
        return size

    _GIL_FREE_COPY_MIN = 1 << 20  # below this, numpy/ctypes setup dominates

    def _pack_fast(self, dst: memoryview, meta: bytes,
                   buffers: Sequence[memoryview]) -> None:
        """pack_into, but large payload copies go through the native
        rt_memcpy — ctypes foreign calls release the GIL, so concurrent
        putters' copies run in parallel instead of serializing on the
        interpreter lock (a memoryview slice-assign holds the GIL for
        the whole memcpy).  The header layout is owned by
        shm_store.pack_header_into (shared with pack_into)."""
        import numpy as np

        from .shm_store import _pad, pack_header_into

        off = pack_header_into(dst, meta, [len(b) for b in buffers])
        dst_np = None
        for b in buffers:
            mv = b.cast("B") if isinstance(b, memoryview) else memoryview(b)
            n = len(mv)
            if n >= self._GIL_FREE_COPY_MIN:
                try:
                    src_np = np.frombuffer(mv, np.uint8)
                    if dst_np is None:
                        dst_np = np.frombuffer(dst, np.uint8)
                    self._lib.rt_memcpy(
                        ctypes.c_void_p(dst_np.ctypes.data + off),
                        ctypes.c_void_p(src_np.ctypes.data),
                        ctypes.c_uint64(n))
                    off = _pad(off + n)
                    continue
                except (ValueError, BufferError):
                    pass  # non-contiguous: plain slice-assign below
            dst[off:off + n] = mv
            off = _pad(off + n)

    def put_raw(self, object_id: str, data: bytes) -> int:
        # raw blobs are cache-like (no owner tracking them): evictable
        return self.create(object_id, b"", [memoryview(data)],
                           primary=False)

    # -- read path ---------------------------------------------------------

    def _map_object(self, object_id: str) -> Optional[memoryview]:
        """Pin + map one object; releases the pin when the mapping (and
        every buffer derived from it) is garbage-collected."""
        self._check_open()
        oid = object_id.encode()
        size = ctypes.c_uint64(0)
        off = self._lib.rt_get(self._arena, oid, ctypes.byref(size))
        if off == 0:
            return None
        if size.value == 0:
            # mmap(length=0) would map to EOF — leaking neighboring objects
            self._lib.rt_release(self._arena, oid)
            return memoryview(b"")
        mm = mmap.mmap(self._fd, size.value, offset=off,
                       prot=mmap.PROT_READ)
        lib, arena, state = self._lib, self._arena, self._state

        def _release():
            if state["closed"]:
                return
            try:
                lib.rt_release(arena, oid)
            except Exception:
                pass  # interpreter teardown

        weakref.finalize(mm, _release)
        return memoryview(mm)

    def contains(self, object_id: str) -> bool:
        self._check_open()
        if self._lib.rt_contains(self._arena, object_id.encode()):
            return True
        return self._overflow.contains(object_id)

    def get(self, object_id: str) -> Optional[Tuple[bytes, List[memoryview]]]:
        from .shm_store import unpack

        buf = self._map_object(object_id)
        if buf is None:
            return self._overflow.get(object_id)
        return unpack(buf)

    def get_raw(self, object_id: str) -> Optional[memoryview]:
        r = self.get(object_id)
        if r is None:
            return None
        _, bufs = r
        return bufs[0] if bufs else memoryview(b"")

    def read_bytes(self, object_id: str) -> Optional[bytes]:
        buf = self._map_object(object_id)
        if buf is None:
            return self._overflow.read_bytes(object_id)
        return bytes(buf)

    def write_bytes(self, object_id: str, data: bytes,
                    primary: bool = False) -> None:
        """Write a pre-packed object.  Non-primary by default: this is the
        path for pulled remote copies and spill restores, both of which
        remain recoverable elsewhere and so may be LRU-evicted."""
        self._check_open()
        oid = object_id.encode()
        err = ctypes.c_int(0)
        off = self._lib.rt_create(self._arena, oid, len(data),
                                  ctypes.byref(err),
                                  self.PRIMARY if primary else 0)
        if err.value == 1:
            return
        if off == 0:
            self._overflow.write_bytes(object_id, data)
            return
        mm = mmap.mmap(self._fd, max(len(data), 1), offset=off)
        try:
            mm[:len(data)] = data
        finally:
            mm.close()
        self._lib.rt_seal(self._arena, oid)

    # -- lifetime ----------------------------------------------------------

    def release(self, object_id: str) -> None:
        pass  # pins are owned by mappings (see _map_object)

    def set_primary(self, object_id: str, on: bool) -> bool:
        self._check_open()
        return self._lib.rt_set_primary(self._arena, object_id.encode(),
                                        1 if on else 0) == 0

    def is_primary(self, object_id: str) -> bool:
        self._check_open()
        flags = self._lib.rt_get_flags(self._arena, object_id.encode())
        if flags >= 0:
            return bool(flags & self.PRIMARY)
        # file-overflow objects hold the only copy of primary creates too;
        # treat unknown-to-arena as spillable
        return self._overflow.contains(object_id)

    def try_free(self, object_id: str) -> bool:
        """Delete only if the memory is actually reclaimed now (a pinned
        arena entry survives rt_delete with rc=1)."""
        self._check_open()
        if self._lib.rt_delete(self._arena, object_id.encode()) == 0:
            return True
        return self._overflow.delete(object_id)

    def delete(self, object_id: str) -> bool:
        self._check_open()
        rc = self._lib.rt_delete(self._arena, object_id.encode())
        dropped = rc >= 0
        if self._overflow.delete(object_id):
            dropped = True
        return dropped

    def size(self, object_id: str) -> Optional[int]:
        self._check_open()
        n = self._lib.rt_size(self._arena, object_id.encode())
        if n >= 0:
            return int(n)
        return self._overflow.size(object_id)

    def list_objects(self) -> List[str]:
        self._check_open()
        buflen = 1 << 20
        buf = ctypes.create_string_buffer(buflen)
        n = self._lib.rt_list(self._arena, buf, buflen)
        ids = buf.raw.split(b"\x00")[:n] if n else []
        out = [i.decode() for i in ids if i]
        for oid in self._overflow.list_objects():
            if oid != "arena.shm" and oid not in out:
                out.append(oid)
        return out

    def stats(self) -> dict:
        self._check_open()
        cap = ctypes.c_uint64(0)
        used = ctypes.c_uint64(0)
        nobj = ctypes.c_uint64(0)
        nevict = ctypes.c_uint64(0)
        self._lib.rt_stats(self._arena, ctypes.byref(cap),
                           ctypes.byref(used), ctypes.byref(nobj),
                           ctypes.byref(nevict))
        return {"capacity": cap.value, "used": used.value,
                "num_objects": nobj.value, "num_evictions": nevict.value}

    def wait_sealed(self, object_id: str, timeout: float) -> bool:
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.contains(object_id):
                return True
            time.sleep(0.002)
        return self.contains(object_id)

    def close(self) -> None:
        if self._state["closed"]:
            return
        self._state["closed"] = True
        if self._wmap is not None:
            try:
                self._wmap.close()
            except (BufferError, ValueError):
                pass  # an exported slice outlives us; drop the ref instead
            self._wmap = None
        try:
            os.close(self._fd)
        except OSError:
            pass
        self._lib.rt_arena_close(self._arena)
        self._arena = None

    def destroy(self) -> None:
        self.close()
        self._overflow.destroy()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
