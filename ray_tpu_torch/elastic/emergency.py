"""Emergency checkpoints: async device->host snapshots, peer-replicated.

Each training worker keeps an in-memory *vault* of recent snapshots of
its own train-state shard plus the shards of its K ring predecessors
(``replication_factor``).  Replication rides the existing control-plane
KV mailbox (the same transport the kv collective backend uses): rank r
posts its serialized shard at ``{tag}/{step}/shard/{r}``, pulls the
shards of ranks ``(r-1..r-K) mod n`` into its vault, acks each, and the
owner retires its mailbox key once all K successors acked — so steady
state leaves nothing in the KV store, and the durable copies live in
worker memory where recovery can reach them without a persistent-storage
round-trip.

The step path pays only a device->host copy (the snapshot must be
consistent — the next step may donate/overwrite the buffers); pickling
and the network exchange happen on a background thread.

Recovery (driver side, see BackendExecutor.elastic_recover): collect
``_inventory()`` from every reachable worker, pick the freshest step
whose full shard set {0..n_old-1} is covered by the union of survivor
vaults (``select_quorum``), ``_fetch`` the payloads, and hand each new
rank an :class:`EmergencyCheckpoint` with its folded shards
(``old_shard % n_new == new_rank``).

The port's copy of ``ray_tpu/elastic/emergency.py``.  A snapshot takes a
tree (dicts, lists, tuples) of torch tensors and copies every tensor to
the host, detached, where the reference calls ``jax.device_get``.
"""

from __future__ import annotations

import logging
import pickle
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.protocol import Backoff
from ray_tpu_torch.train.checkpoint import Checkpoint

logger = logging.getLogger(__name__)

_NS = "elastic"


def _kv():
    from ray_tpu_torch._private.core import current_core

    return current_core().control


def _kv_put(key: str, val: bytes):
    _kv().call("kv_put", {"ns": _NS, "key": key, "val": val})


def _kv_poll(key: str, deadline: float) -> Optional[bytes]:
    """Non-destructive polling read with an absolute deadline (the shard
    key is read by K fetchers; only the owner deletes it)."""
    bo = Backoff(base=0.005, cap=0.1)
    while True:
        v = _kv().call("kv_get", {"ns": _NS, "key": key})
        if v is not None:
            return v
        if time.monotonic() >= deadline:
            return None
        bo.sleep()


def _kv_del(key: str):
    try:
        _kv().call("kv_del", {"ns": _NS, "key": key})
    except Exception:
        pass


def _to_host(state: Any) -> Any:
    """Device->host copy of a tree of tensors (dicts, lists and tuples;
    other leaves pass through).  This is the only work snapshot() does on
    the step path: the copy must be taken before the next step updates
    the tensors in place, so a tensor already on the CPU is copied too
    (``.cpu()`` alone would alias it)."""
    if isinstance(state, dict):
        return type(state)((k, _to_host(v)) for k, v in state.items())
    if isinstance(state, (list, tuple)):
        out = [_to_host(v) for v in state]
        return type(state)(*out) if hasattr(state, "_fields") \
            else type(state)(out)
    if type(state).__module__.startswith("torch") and \
            hasattr(state, "detach"):
        return state.detach().to("cpu", copy=True)
    return state


# -- per-worker-process vault (module-global: survives checkpointer
# re-initialization across elastic incarnations, which is exactly what
# makes the surviving workers a recovery source) ---------------------------

_LOCK = threading.RLock()
_VAULT: Dict[Tuple[int, int], bytes] = {}   # (step, shard_id) -> payload
_VAULT_WORLDS: Dict[int, int] = {}          # step -> world size at snapshot
_CKPT: Optional["EmergencyCheckpointer"] = None


class EmergencyCheckpointer:
    """Owns the background replication thread of one worker."""

    def __init__(self, tag: str, rank: int, world_size: int,
                 replication_factor: int = 1, keep_steps: int = 2,
                 snapshot_every: int = 1, replicate_timeout_s: float = 15.0):
        self.tag = tag
        self.rank = rank
        self.world_size = world_size
        # can't replicate to more peers than exist
        self.k = max(0, min(replication_factor, world_size - 1))
        self.keep_steps = keep_steps
        self.snapshot_every = max(1, snapshot_every)
        self.replicate_timeout_s = replicate_timeout_s
        self._auto_step = 0
        self._queue: "queue.Queue" = queue.Queue()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"emergency-ckpt-r{rank}")
        self._thread.start()

    # -- step path ---------------------------------------------------------

    def snapshot(self, state: Any, step: Optional[int] = None) -> bool:
        """Enqueue a snapshot of ``state`` for background replication.
        Returns True when the snapshot was accepted (cadence hit)."""
        if step is None:
            step = self._auto_step
        self._auto_step = step + 1
        if step % self.snapshot_every:
            return False
        host_state = _to_host(state)
        # coalesce: if replication lags, drop the oldest queued snapshot
        # rather than stalling the step path (bounded memory; quorum
        # selection skips steps without full coverage)
        while self._queue.qsize() >= 2:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._idle.clear()
        self._queue.put((step, host_state))
        return True

    # -- background thread -------------------------------------------------

    def _loop(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            step, host_state = item
            try:
                self._replicate(step, host_state)
            except Exception:
                logger.warning("emergency replication for step %s failed",
                               step, exc_info=True)
            finally:
                if self._queue.empty():
                    self._idle.set()

    def _key(self, step: int, kind: str, *parts) -> str:
        return "/".join([self.tag, str(step), kind, *map(str, parts)])

    def _replicate(self, step: int, host_state: Any):
        payload = pickle.dumps(host_state, protocol=5)
        n, r, k = self.world_size, self.rank, self.k
        with _LOCK:
            _VAULT[(step, r)] = payload
            _VAULT_WORLDS[step] = n
        if k == 0 or n <= 1:
            self._prune()
            return
        _kv_put(self._key(step, "shard", r), payload)
        deadline = time.monotonic() + self.replicate_timeout_s
        # pull my K ring predecessors' shards into my vault, ack each
        for j in range(1, k + 1):
            src = (r - j) % n
            b = _kv_poll(self._key(step, "shard", src), deadline)
            if b is None:
                logger.warning("rank %d: no shard from peer %d for step %d "
                               "within %.1fs", r, src, step,
                               self.replicate_timeout_s)
                continue
            with _LOCK:
                _VAULT[(step, src)] = b
            _kv_put(self._key(step, "ack", src, r), b"1")
        # wait for my successors' acks, then retire my mailbox key
        acked = True
        for j in range(1, k + 1):
            dst = (r + j) % n
            if _kv_poll(self._key(step, "ack", r, dst), deadline) is None:
                acked = False
            else:
                _kv_del(self._key(step, "ack", r, dst))
        if acked:
            _kv_del(self._key(step, "shard", r))
        self._prune()

    def _prune(self):
        with _LOCK:
            steps = sorted(_VAULT_WORLDS)
            while len(steps) > self.keep_steps:
                s = steps.pop(0)
                _VAULT_WORLDS.pop(s, None)
                for key in [kk for kk in _VAULT if kk[0] == s]:
                    _VAULT.pop(key, None)

    # -- control -----------------------------------------------------------

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        return self._idle.wait(timeout)

    def stop(self, timeout: float = 2.0):
        if self._stop:
            return
        self._stop = True
        self._queue.put(None)
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)


# -- worker-side module API (run inside the worker via execute()) ----------


def _init_worker_checkpointer(tag: str, rank: int, world_size: int,
                              replication_factor: int, keep_steps: int,
                              snapshot_every: int,
                              replicate_timeout_s: float) -> bool:
    """(Re-)install this process's checkpointer.  The vault is module
    state and deliberately survives re-init: after an elastic shrink the
    new incarnation's checkpointer starts fresh while the old shards
    remain fetchable until pruned by new snapshots."""
    global _CKPT
    if _CKPT is not None:
        _CKPT.stop()
    _CKPT = EmergencyCheckpointer(
        tag, rank, world_size, replication_factor=replication_factor,
        keep_steps=keep_steps, snapshot_every=snapshot_every,
        replicate_timeout_s=replicate_timeout_s)
    return True


def get_checkpointer() -> Optional[EmergencyCheckpointer]:
    return _CKPT


def snapshot(state: Any, step: Optional[int] = None) -> bool:
    """User-facing: snapshot this worker's train-state shard from inside
    the train loop (no-op returning False when elastic is not
    configured, so loops stay portable)."""
    ck = _CKPT
    if ck is None:
        return False
    return ck.snapshot(state, step)


def wait_replicated(timeout: Optional[float] = None) -> bool:
    """Block until queued snapshots finished replicating (tests; drain
    handlers that want a final synchronous flush)."""
    ck = _CKPT
    if ck is None:
        return True
    return ck.wait_idle(timeout)


def _inventory() -> List[Dict[str, Any]]:
    """What this worker's vault holds: [{step, world, shards}, ...]."""
    with _LOCK:
        return [{"step": s, "world": w,
                 "shards": sorted(sid for (st, sid) in _VAULT if st == s)}
                for s, w in sorted(_VAULT_WORLDS.items())]


def _fetch(step: int, shard_id: int) -> Optional[bytes]:
    with _LOCK:
        return _VAULT.get((step, shard_id))


def _clear_vault() -> bool:
    """Test hook: wipe this process's vault."""
    with _LOCK:
        _VAULT.clear()
        _VAULT_WORLDS.clear()
    return True


def vault_footprint() -> Dict[str, Any]:
    """Bytes resident in this worker's emergency vault (the device memory
    census reports it as its built-in owner, telemetry/device.py)."""
    with _LOCK:
        return {"entries": len(_VAULT),
                "bytes": sum(len(v) for v in _VAULT.values()),
                "steps": len(_VAULT_WORLDS)}


# -- driver-side recovery helpers ------------------------------------------


def select_quorum(inventories: Dict[int, List[Dict[str, Any]]]
                  ) -> Optional[Tuple[int, int, Dict[int, int]]]:
    """Freshest step whose full shard set is covered by the survivors.

    inventories: worker index -> that worker's ``_inventory()`` output.
    Returns (step, world_size, holders) with holders mapping each
    shard_id to a worker index that can serve it, or None when no step
    has full coverage.
    """
    coverage: Dict[Tuple[int, int], Dict[int, int]] = {}
    for widx, inv in inventories.items():
        for entry in inv or ():
            holders = coverage.setdefault(
                (int(entry["step"]), int(entry["world"])), {})
            for sid in entry["shards"]:
                holders.setdefault(int(sid), widx)
    for (step, world) in sorted(coverage, reverse=True):
        holders = coverage[(step, world)]
        if set(holders) >= set(range(world)):
            return step, world, holders
    return None


def fold_shards(old_world: int, new_rank: int, new_world: int) -> List[int]:
    """Which old shards new rank r owns after shrinking: round-robin
    fold (old_shard % new_world == new_rank), so every old shard has
    exactly one new owner and the load difference is at most one."""
    return [s for s in range(old_world) if s % new_world == new_rank]


class EmergencyCheckpoint(Checkpoint):
    """An in-memory checkpoint handed to resumed workers: the folded
    old-world shards this new rank is responsible for.  Not backed by a
    directory — ``to_directory``/``as_directory`` raise."""

    def __init__(self, step: int, source_world_size: int,
                 shards: Dict[int, bytes]):
        self.step = step
        self.source_world_size = source_world_size
        self.shards = dict(shards)
        self.path = f"emergency://step_{step}"

    def shard_ids(self) -> List[int]:
        return sorted(self.shards)

    def load(self) -> List[Any]:
        """Deserialize this rank's shards, ordered by old rank."""
        return [pickle.loads(self.shards[s]) for s in self.shard_ids()]

    def get_metadata(self) -> Dict[str, Any]:
        return {"tier": "emergency", "step": self.step,
                "source_world_size": self.source_world_size,
                "shards": self.shard_ids()}

    def to_directory(self, path=None, subdir=None):
        raise NotImplementedError(
            "EmergencyCheckpoint is in-memory (peer-replicated shards); "
            "use .load() from the train loop")

    def as_directory(self, subdir=None):
        raise NotImplementedError(
            "EmergencyCheckpoint is in-memory (peer-replicated shards); "
            "use .load() from the train loop")

    def __reduce__(self):
        return (EmergencyCheckpoint,
                (self.step, self.source_world_size, self.shards))

    def __repr__(self):
        return (f"EmergencyCheckpoint(step={self.step}, "
                f"source_world_size={self.source_world_size}, "
                f"shards={self.shard_ids()})")
