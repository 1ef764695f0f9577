"""Node-local shared-memory object store (plasma equivalent).

The reference's plasma store keeps immutable objects in a shared-memory arena
inside the raylet, with clients attaching over a unix socket + fd passing
(reference: src/ray/object_manager/plasma/store.h, fling.h).  The TPU-native
redesign uses one mmap-backed file per object under /dev/shm: *create* writes
into a private temp file and *seal* atomically renames it into place, so any
process on the node can open+mmap a sealed object lock-free and zero-copy —
no store round-trip on the read path at all.  The raylet owns lifetime
(delete/evict); see node.py.  A C++ arena allocator with LRU eviction backs
the same interface when built (ray_tpu_torch/native/).

Object layout (64-byte aligned buffers so numpy views are aligned):

    magic u32 | ver u32 | meta_len u64 | nbuf u32 | pad u32 | buf_len u64[nbuf]
    | meta bytes | pad->64 | buf0 | pad->64 | buf1 | ...

The port's copy of ``ray_tpu/_private/shm_store.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import mmap
import os
import struct
import time
from typing import List, Optional, Sequence, Tuple

_MAGIC = 0x52545055  # "RTPU"
_ALIGN = 64


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def layout_size(meta_len: int, buf_lens: Sequence[int]) -> int:
    header = 4 + 4 + 8 + 4 + 4 + 8 * len(buf_lens)
    total = _pad(header + meta_len)
    for b in buf_lens:
        total = _pad(total + b)
    return total


def pack_header_into(buf: memoryview, meta: bytes,
                     lens: Sequence[int]) -> int:
    """Write the object header + meta; returns the (padded) offset where
    buffer 0 starts.  THE single owner of the on-disk layout's header —
    every writer (mmap pack, native-arena fast path) goes through it so a
    format change cannot silently fork."""
    off = 0
    struct.pack_into("<IIQII", buf, off, _MAGIC, 1, len(meta), len(lens), 0)
    off += 4 + 4 + 8 + 4 + 4
    for l in lens:
        struct.pack_into("<Q", buf, off, l)
        off += 8
    buf[off:off + len(meta)] = meta
    return _pad(off + len(meta))


def pack_into(buf: memoryview, meta: bytes, buffers: Sequence[memoryview]) -> None:
    off = pack_header_into(buf, meta, [len(b) for b in buffers])
    for b in buffers:
        n = len(b)
        buf[off:off + n] = b.cast("B") if isinstance(b, memoryview) else memoryview(b)
        off = _pad(off + n)


def unpack(buf: memoryview) -> Tuple[bytes, List[memoryview]]:
    magic, ver, meta_len, nbuf, _ = struct.unpack_from("<IIQII", buf, 0)
    if magic != _MAGIC:
        raise ValueError("bad object magic")
    off = 4 + 4 + 8 + 4 + 4
    lens = []
    for _ in range(nbuf):
        (l,) = struct.unpack_from("<Q", buf, off)
        lens.append(l)
        off += 8
    meta = bytes(buf[off:off + meta_len])
    off = _pad(off + meta_len)
    bufs = []
    for l in lens:
        bufs.append(buf[off:off + l])
        off = _pad(off + l)
    return meta, bufs


class FileObjectStore:
    """File-per-object store rooted at a /dev/shm session directory.

    Pure-Python fallback (and overflow tier) for the native arena store
    (ray_tpu_torch/native/shm_arena.cc via _private/native_store.py)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, object_id: str) -> str:
        return os.path.join(self.root, object_id)

    # -- write path --------------------------------------------------------

    def create(self, object_id: str, meta: bytes, buffers: Sequence[memoryview],
               primary: bool = True, allow_overflow: bool = True,
               warm_only: bool = False) -> int:
        """Write + seal an object; returns its byte size.

        Uses writev() rather than mmap: on tmpfs a streaming write avoids
        the per-page fault + TLB cost of populating a fresh mapping
        (~1.5-2x the bandwidth on the put path; reads stay mmap
        zero-copy)."""
        lens = [len(b) for b in buffers]
        size = layout_size(len(meta), lens)
        tmp = self._path(object_id) + ".tmp.%d" % os.getpid()
        fd = os.open(tmp, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
        try:
            header = bytearray(4 + 4 + 8 + 4 + 4 + 8 * len(lens))
            struct.pack_into("<IIQII", header, 0, _MAGIC, 1, len(meta),
                             len(lens), 0)
            off = 4 + 4 + 8 + 4 + 4
            for l in lens:
                struct.pack_into("<Q", header, off, l)
                off += 8
            pad = b"\0" * _ALIGN
            iov: List = [bytes(header), meta]
            pos = len(header) + len(meta)
            for b in buffers:
                aligned = _pad(pos)
                if aligned != pos:
                    iov.append(pad[:aligned - pos])
                    pos = aligned
                mv = b.cast("B") if isinstance(b, memoryview) else memoryview(b)
                iov.append(mv)
                pos += len(mv)
            if _pad(pos) != pos:
                iov.append(pad[:_pad(pos) - pos])
            written = 0
            while iov:
                n = os.writev(fd, iov[:1024])
                written += n
                # drop fully-written iovecs; split a partial one
                while iov and n >= len(iov[0]):
                    n -= len(iov[0])
                    iov.pop(0)
                if n and iov:
                    iov[0] = memoryview(iov[0])[n:]
            if written < 1:
                os.ftruncate(fd, 1)
            os.rename(tmp, self._path(object_id))  # atomic seal
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        finally:
            os.close(fd)
        return size

    def put_raw(self, object_id: str, data: bytes) -> int:
        return self.create(object_id, b"", [memoryview(data)])

    # -- read path ---------------------------------------------------------

    def contains(self, object_id: str) -> bool:
        return os.path.exists(self._path(object_id))

    def get(self, object_id: str) -> Optional[Tuple[bytes, List[memoryview]]]:
        """Zero-copy read of a sealed object; None if absent.

        Lifetime: the returned memoryviews hold references to the mmap, and
        values deserialized over them (numpy arrays) hold the buffers — the
        mapping closes via GC when the last consumer drops it.  Unlinking
        the file (delete/evict) is safe while mapped (pages live until the
        mappings go away)."""
        try:
            fd = os.open(self._path(object_id), os.O_RDONLY)
        except FileNotFoundError:
            return None
        try:
            size = os.fstat(fd).st_size
            mm = mmap.mmap(fd, size, prot=mmap.PROT_READ)
        finally:
            os.close(fd)
        return unpack(memoryview(mm))

    def get_raw(self, object_id: str) -> Optional[memoryview]:
        r = self.get(object_id)
        if r is None:
            return None
        _, bufs = r
        return bufs[0] if bufs else memoryview(b"")

    def read_bytes(self, object_id: str) -> Optional[bytes]:
        """Copying read of the raw file (for network transfer)."""
        try:
            with open(self._path(object_id), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def write_bytes(self, object_id: str, data: bytes) -> None:
        """Install a raw object file fetched from another node."""
        tmp = self._path(object_id) + ".tmp.%d" % os.getpid()
        with open(tmp, "wb") as f:
            f.write(data)
        os.rename(tmp, self._path(object_id))

    def release(self, object_id: str) -> None:
        """No-op: mappings are GC-owned (see get)."""

    def delete(self, object_id: str) -> bool:
        try:
            os.unlink(self._path(object_id))
            return True
        except FileNotFoundError:
            return False

    def size(self, object_id: str) -> Optional[int]:
        try:
            return os.stat(self._path(object_id)).st_size
        except FileNotFoundError:
            return None

    def list_objects(self) -> List[str]:
        return [n for n in os.listdir(self.root) if not n.endswith(".tmp")
                and ".tmp." not in n and n != "arena.shm"]

    def wait_sealed(self, object_id: str, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.contains(object_id):
                return True
            time.sleep(0.002)
        return self.contains(object_id)

    def destroy(self) -> None:
        try:
            for n in os.listdir(self.root):
                try:
                    os.unlink(os.path.join(self.root, n))
                except OSError:
                    pass
            os.rmdir(self.root)
        except OSError:
            pass


def ShmObjectStore(root: str):
    """Store factory: native C++ arena when the toolchain is available
    (the default), file-per-object otherwise or when
    RAY_TPU_TORCH_DISABLE_NATIVE_STORE=1."""
    if not os.environ.get("RAY_TPU_TORCH_DISABLE_NATIVE_STORE"):
        try:
            from .native_store import NativeShmObjectStore

            return NativeShmObjectStore(root)
        except Exception as e:
            import logging

            logging.getLogger(__name__).warning(
                "native object store unavailable (%s); using file store", e)
    return FileObjectStore(root)
