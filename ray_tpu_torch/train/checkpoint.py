"""Checkpoint: a directory handle on persistent storage.

Mirrors the reference (reference: python/ray/train/_checkpoint.py:56
Checkpoint — "a reference to data persisted as a directory"): create from a
local directory, materialize to a local directory, read/write metadata.
Model state inside the directory is the user's format — for torch models
the idiomatic content is a ``torch.save`` of the state dicts, written by
the training loop.  The port's copy of ``ray_tpu/train/checkpoint.py``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from contextlib import contextmanager
from typing import Any, Dict, Optional

_METADATA_FILE = ".metadata.json"


class Checkpoint:
    """`path` may be a local directory or a remote URI (s3://, gs://,
    mock-remote://...); remote checkpoints materialize through
    `to_directory`/`as_directory` via train.storage (reference:
    train/_checkpoint.py Checkpoint carries a pyarrow filesystem the
    same way)."""

    def __init__(self, path: str):
        from . import storage

        if storage.is_uri(path):
            self.path = path
        else:
            self.path = os.path.abspath(os.path.expanduser(path))

    @property
    def is_remote(self) -> bool:
        from . import storage

        return storage.is_uri(self.path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"not a directory: {path}")
        return cls(path)

    def to_directory(self, path: Optional[str] = None,
                     subdir: Optional[str] = None) -> str:
        """Copy checkpoint contents into `path` (default: temp dir);
        remote checkpoints are downloaded.

        `subdir` limits the transfer to one subdirectory (e.g.
        ``rank_3``): on a pod restore every host holds the same logical
        checkpoint URI but needs only its own shard — downloading all N
        rank dirs to all N hosts would be an N^2 transfer."""
        from . import storage

        src = storage.join(self.path, subdir) if subdir else self.path
        dest = path or tempfile.mkdtemp(prefix="ckpt-")
        os.makedirs(dest, exist_ok=True)
        if self.is_remote:
            storage.download_dir(src, dest)
        elif os.path.abspath(dest) != os.path.abspath(src):
            shutil.copytree(src, dest, dirs_exist_ok=True)
        return dest

    @contextmanager
    def as_directory(self, subdir: Optional[str] = None):
        """Yield a local directory view; remote checkpoints download to a
        temp dir that is removed afterwards, local ones yield in place.
        `subdir` narrows the view (and the download) to one
        subdirectory — see to_directory."""
        from . import storage

        if self.is_remote:
            dest = self.to_directory(subdir=subdir)
            try:
                yield dest
            finally:
                shutil.rmtree(dest, ignore_errors=True)
        else:
            yield storage.join(self.path, subdir) if subdir else self.path

    def get_metadata(self) -> Dict[str, Any]:
        from . import storage

        p = storage.join(self.path, _METADATA_FILE)
        if not storage.exists(p):
            return {}
        return json.loads(storage.read_text(p))

    def set_metadata(self, metadata: Dict[str, Any]) -> None:
        from . import storage

        storage.write_text(storage.join(self.path, _METADATA_FILE),
                           json.dumps(metadata))

    def update_metadata(self, metadata: Dict[str, Any]) -> None:
        m = self.get_metadata()
        m.update(metadata)
        self.set_metadata(m)

    def __reduce__(self):
        return (Checkpoint, (self.path,))

    def __repr__(self):
        return f"Checkpoint(path={self.path})"

    def __eq__(self, other):
        return isinstance(other, Checkpoint) and other.path == self.path

    def __hash__(self):
        return hash(self.path)
