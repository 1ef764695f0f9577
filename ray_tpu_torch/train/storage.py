"""Run storage: local-or-remote filesystem access for checkpoints and
experiment state.

Mirrors the reference's StorageContext (reference:
python/ray/train/_internal/storage.py:358 — pyarrow.fs-backed persistence
to local dirs, s3://, gs://, hdfs://).  Here the abstraction is fsspec:
every path either has a URI scheme (routed through the fsspec filesystem
for that scheme) or is a plain local path (plain os/shutil fast path).

Hosts of a multi-node run share no local disk: each host's worker uploads
its own checkpoint shard directly to the remote filesystem, which is the
only way such a `JaxTrainer` run can persist anything.

A `mock-remote://` scheme is registered for tests: it exercises the full
remote code path (every byte moves through the fsspec AbstractFileSystem
API — upload/download/ls/open, no os.path shortcuts) while persisting in
a plain directory the test can inspect out-of-band.

The port's copy of ``ray_tpu/train/storage.py``.
"""

from __future__ import annotations

import os
import posixpath
import shutil
import threading
from typing import List, Optional, Tuple

__all__ = [
    "StorageContext", "is_uri", "join", "makedirs", "exists", "listdir",
    "upload_dir", "download_dir", "rmtree", "read_text", "write_text",
    "append_text",
]


# scheme dispatch + mock-remote:// live in _private.fileio so that
# ray_tpu_torch.data shares the exact same resolution path (one registration,
# one set of semantics for every byte that leaves the host)
from ray_tpu_torch._private.fileio import fs_for as _fs_and_path  # noqa: E402
from ray_tpu_torch._private.fileio import is_uri  # noqa: F401,E402
from ray_tpu_torch._private.fileio import \
    register_mock_remote as _register_mock_remote  # noqa: F401,E402


def join(base: str, *parts: str) -> str:
    if is_uri(base):
        return posixpath.join(base, *parts)
    return os.path.join(base, *parts)


def makedirs(path: str) -> None:
    if is_uri(path):
        fs, p = _fs_and_path(path)
        fs.makedirs(p, exist_ok=True)
    else:
        os.makedirs(path, exist_ok=True)


def exists(path: str) -> bool:
    if is_uri(path):
        fs, p = _fs_and_path(path)
        return fs.exists(p)
    return os.path.exists(path)


def listdir(path: str) -> List[str]:
    """Base names of entries under `path` ([] when absent)."""
    if is_uri(path):
        fs, p = _fs_and_path(path)
        if not fs.exists(p):
            return []
        return [posixpath.basename(e.rstrip("/"))
                for e in fs.ls(p, detail=False)]
    if not os.path.isdir(path):
        return []
    return os.listdir(path)


def upload_dir(local_dir: str, dest: str) -> None:
    """Recursively copy a local directory into `dest` (URI or local)."""
    if is_uri(dest):
        fs, p = _fs_and_path(dest)
        fs.makedirs(p, exist_ok=True)
        # fs.put(recursive) with a trailing-slash source copies contents
        fs.put(os.path.join(local_dir, ""), p, recursive=True)
    else:
        shutil.copytree(local_dir, dest, dirs_exist_ok=True)


def download_dir(src: str, local_dir: str) -> None:
    if is_uri(src):
        fs, p = _fs_and_path(src)
        os.makedirs(local_dir, exist_ok=True)
        fs.get(p.rstrip("/") + "/", os.path.join(local_dir, ""),
               recursive=True)
    else:
        shutil.copytree(src, local_dir, dirs_exist_ok=True)


def rmtree(path: str) -> None:
    if is_uri(path):
        fs, p = _fs_and_path(path)
        try:
            fs.rm(p, recursive=True)
        except FileNotFoundError:
            pass
    else:
        shutil.rmtree(path, ignore_errors=True)


def read_text(path: str) -> str:
    if is_uri(path):
        fs, p = _fs_and_path(path)
        with fs.open(p, "r") as f:
            return f.read()
    with open(path) as f:
        return f.read()


def write_text(path: str, text: str) -> None:
    if is_uri(path):
        fs, p = _fs_and_path(path)
        with fs.open(p, "w") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)


def append_text(path: str, text: str) -> None:
    if is_uri(path):
        # remote object stores have no append: read-modify-write (state
        # files here are small jsonl logs; fine for the control path)
        old = read_text(path) if exists(path) else ""
        write_text(path, old + text)
    else:
        with open(path, "a") as f:
            f.write(text)


class StorageContext:
    """Bundles a run's storage root with async checkpoint upload
    (reference: train/_internal/storage.py:358 StorageContext).

    Uploads are pipelined: `upload_dir_async` returns immediately and the
    next call (or `wait`) joins the previous upload first, so step N+1's
    compute overlaps step N's upload — the reference's async persistence
    pattern without unbounded in-flight state."""

    def __init__(self, storage_path: str, experiment_name: str = "",
                 trial_name: str = ""):
        self.storage_path = storage_path
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self._upload_thread: Optional[threading.Thread] = None
        self._upload_error: Optional[BaseException] = None

    @property
    def is_remote(self) -> bool:
        return is_uri(self.storage_path)

    @property
    def experiment_dir(self) -> str:
        return join(self.storage_path, self.experiment_name) \
            if self.experiment_name else self.storage_path

    @property
    def trial_dir(self) -> str:
        return join(self.experiment_dir, self.trial_name) \
            if self.trial_name else self.experiment_dir

    def upload_dir_async(self, local_dir: str, dest: str,
                         on_complete=None) -> None:
        self.wait()

        def run():
            try:
                upload_dir(local_dir, dest)
                if on_complete is not None:
                    on_complete()
            except BaseException as e:  # surfaced on next wait()
                self._upload_error = e

        self._upload_thread = threading.Thread(
            target=run, daemon=True, name="ckpt-upload")
        self._upload_thread.start()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Join the in-flight upload; re-raise its error, if any.

        A timed-out join leaves the upload tracked (still in flight):
        callers must not mistake a timeout for completion — the
        completion marker is only written by the upload itself."""
        t = self._upload_thread
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                raise TimeoutError(
                    f"checkpoint upload still in flight after {timeout}s")
            self._upload_thread = None
        if self._upload_error is not None:
            e, self._upload_error = self._upload_error, None
            raise e
