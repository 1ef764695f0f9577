"""Scheme-dispatched file IO shared by data datasources and train storage.

The reference resolves every dataset/checkpoint path through pyarrow.fs so
s3://, gs://, hdfs:// work anywhere a worker runs (reference:
python/ray/data/datasource/file_based_datasource.py:65,
python/ray/train/_internal/storage.py:358).  Here the abstraction is
fsspec: a path either has a URI scheme (routed through the fsspec
filesystem for that scheme) or is a plain local path (plain os fast path).

Hosts of a multi-node cluster share no local disk, so the remote
filesystem is the only path training data and checkpoints can travel
through.

A `mock-remote://` scheme is registered for tests: it exercises the full
remote code path (every byte moves through the fsspec AbstractFileSystem
API — no os.path shortcuts) while persisting under a plain directory the
test can inspect out-of-band.  Code proven against it holds for any real
scheme (s3/gs via their fsspec drivers).

The port's copy of ``ray_tpu/_private/fileio.py``, unchanged but for
this paragraph.
"""

from __future__ import annotations

import glob as _glob
import os
import threading
from typing import List, Optional

__all__ = [
    "is_uri", "fs_for", "open_file", "filesize", "exists", "makedirs",
    "expand_paths", "register_mock_remote",
]


def is_uri(path: str) -> bool:
    return "://" in (path or "")


_mock_registered = False
_reg_lock = threading.Lock()


def register_mock_remote() -> None:
    """Register the test/dev `mock-remote://` scheme (idempotent)."""
    global _mock_registered
    with _reg_lock:
        if _mock_registered:
            return
        import fsspec
        from fsspec.implementations.local import LocalFileSystem

        class MockRemoteFileSystem(LocalFileSystem):
            protocol = "mock-remote"

            def __init__(self, **kw):
                kw.pop("auto_mkdir", None)
                super().__init__(auto_mkdir=True, **kw)

            @classmethod
            def _strip_protocol(cls, path):
                path = str(path)
                if path.startswith("mock-remote://"):
                    path = path[len("mock-remote://"):]
                return LocalFileSystem._strip_protocol(path)

            def unstrip_protocol(self, name):
                return "mock-remote://" + str(name)

        try:
            fsspec.register_implementation("mock-remote",
                                           MockRemoteFileSystem,
                                           clobber=True)
        except Exception:
            pass
        _mock_registered = True


def fs_for(uri: str):
    """fsspec filesystem + in-fs path for a URI."""
    import fsspec

    register_mock_remote()
    return fsspec.core.url_to_fs(uri)


def _unstrip(fs, path: str) -> str:
    """Reattach the scheme so worker tasks re-resolve the same fs."""
    return fs.unstrip_protocol(path)


def open_file(path: str, mode: str = "rb"):
    """Open a local path or URI; returns a context-manager file object.

    Worker tasks call this inside read/write thunks: the fs is resolved
    on the worker from the scheme, so no filesystem object travels in the
    pickled closure.
    """
    if is_uri(path):
        fs, p = fs_for(path)
        if "w" in mode or "a" in mode:
            parent = p.rsplit("/", 1)[0]
            if parent:
                fs.makedirs(parent, exist_ok=True)
        return fs.open(p, mode)
    return open(path, mode)


def filesize(path: str) -> Optional[int]:
    try:
        if is_uri(path):
            fs, p = fs_for(path)
            return int(fs.size(p))
        return os.path.getsize(path)
    except Exception:
        return None


def exists(path: str) -> bool:
    if is_uri(path):
        fs, p = fs_for(path)
        return fs.exists(p)
    return os.path.exists(path)


def makedirs(path: str) -> None:
    if is_uri(path):
        fs, p = fs_for(path)
        fs.makedirs(p, exist_ok=True)
    else:
        os.makedirs(path, exist_ok=True)


def move(src: str, dst: str) -> None:
    """Rename a file, local or remote (both paths on one filesystem)."""
    if is_uri(src):
        fs, sp = fs_for(src)
        fs.mv(sp, fs_for(dst)[1])
    else:
        os.replace(src, dst)


def expand_paths(paths, suffixes: Optional[List[str]] = None) -> List[str]:
    """Expand dirs (recursive) and globs into concrete file paths, local
    or remote (reference: file_based_datasource.py path resolution —
    dirs list recursively, `*?[` trigger glob, plain paths pass through).
    Remote results keep their scheme so read tasks re-resolve on workers.
    """
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if is_uri(p):
            fs, fp = fs_for(p)
            if any(ch in fp for ch in "*?["):
                found = sorted(fs.glob(fp))
            elif fs.isdir(fp):
                found = sorted(fs.find(fp))
            else:
                found = [fp]
            out.extend(_unstrip(fs, f) for f in found)
        elif os.path.isdir(p):
            for root, _, files in os.walk(p):
                for f in sorted(files):
                    out.append(os.path.join(root, f))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if suffixes:
        out = [p for p in out
               if any(p.endswith(s) for s in suffixes)] or out
    if not out:
        raise FileNotFoundError(f"no input files found for {paths!r}")
    return out
