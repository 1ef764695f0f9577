"""Control-plane state persistence — GCS fault tolerance equivalent.

Reference parity: GCS metadata storage is pluggable
(src/ray/gcs/store_client/in_memory_store_client.h vs
redis_store_client.h); with Redis configured, a restarted GCS reloads
``GcsInitData`` and raylets re-sync against it (the ``ha_integration``
test path, gcs_init_data.h).  Here the durable backend is sqlite on
local/shared disk: the control daemon writes through every metadata
mutation (KV, functions, jobs, actors, placement groups) and reloads the
tables on boot; raylets reconnect-and-reregister instead of exiting when
the control connection drops.

sqlite is the right shape for this role on a single control host: one
file, transactional, crash-safe (WAL), zero extra processes — the
"Redis" of the deployment without a second daemon to supervise.

The port's copy of ``ray_tpu/_private/persist.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import pickle
import sqlite3
import threading
from typing import Any, Dict, Optional


class ControlStateStore:
    """Write-through durable store for control-plane tables.

    Two tables:
      kv(ns, k, v)        — the user/internal KV store, values as blobs
      records(tbl, key, data) — pickled metadata records per subsystem
                                (``actor``, ``pg``, ``job``, ``function``)
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS kv ("
            "ns TEXT, k TEXT, v BLOB, PRIMARY KEY (ns, k))")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS records ("
            "tbl TEXT, key TEXT, data BLOB, PRIMARY KEY (tbl, key))")
        self._db.commit()

    # -- kv ----------------------------------------------------------------

    def kv_put(self, ns: str, key: str, val: bytes) -> None:
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO kv (ns, k, v) VALUES (?, ?, ?)",
                (ns, key, sqlite3.Binary(val)))
            self._db.commit()

    def kv_del(self, ns: str, key: str) -> None:
        with self._lock:
            self._db.execute("DELETE FROM kv WHERE ns = ? AND k = ?",
                             (ns, key))
            self._db.commit()

    def load_kv(self) -> Dict[str, Dict[str, bytes]]:
        out: Dict[str, Dict[str, bytes]] = {}
        with self._lock:
            for ns, k, v in self._db.execute("SELECT ns, k, v FROM kv"):
                out.setdefault(ns, {})[k] = bytes(v)
        return out

    # -- records -----------------------------------------------------------

    def rec_put(self, tbl: str, key: str, obj: Any) -> None:
        blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO records (tbl, key, data) "
                "VALUES (?, ?, ?)", (tbl, key, sqlite3.Binary(blob)))
            self._db.commit()

    def rec_del(self, tbl: str, key: str) -> None:
        with self._lock:
            self._db.execute(
                "DELETE FROM records WHERE tbl = ? AND key = ?", (tbl, key))
            self._db.commit()

    def load_table(self, tbl: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        with self._lock:
            rows = self._db.execute(
                "SELECT key, data FROM records WHERE tbl = ?", (tbl,))
            for key, data in rows:
                out[key] = pickle.loads(bytes(data))
        return out

    def close(self) -> None:
        with self._lock:
            try:
                self._db.commit()
                self._db.close()
            except sqlite3.Error:
                pass


def open_store(path: Optional[str]) -> Optional[ControlStateStore]:
    if not path:
        return None
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return ControlStateStore(path)
