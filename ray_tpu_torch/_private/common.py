"""Common types: IDs, task specs, resource math, serialization helpers.

The runtime's re-design of the reference's `src/ray/common/` (id.h,
task/task_spec.h, scheduling/).  IDs are random 16-byte values rendered as
hex; object ids are derived from (owner task id, return index) the same way
the reference derives ObjectIDs from TaskIDs
(reference: src/ray/design_docs/id_specification.md).

The port's copy of ``ray_tpu/_private/common.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import os
import pickle
import threading
from dataclasses import dataclass, field, fields as dataclass_fields
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

_pid_rand = None


def _rand_bytes(n: int) -> bytes:
    # os.urandom is fork-safe and fast enough for id generation.
    return os.urandom(n)


# ids only need cross-process uniqueness, not cryptographic strength: an
# 8-byte urandom prefix drawn once per process + a 16-hex-digit counter is
# collision-safe and ~50x cheaper than os.urandom per id (the task-submit
# hot path mints 2 ids per task).  Fork safety comes from an at-fork hook
# rather than a getpid() check per id — getpid is a real syscall on
# virtualized kernels and was the single hottest line of task submission.
_id_state = None


def _reset_id_state():
    global _id_state
    _id_state = None


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_id_state)


def new_id(prefix: str = "") -> str:
    global _id_state
    st = _id_state
    if st is None:
        import itertools

        _id_state = st = (os.urandom(8).hex(), itertools.count(1))
    # itertools.count.__next__ is atomic in CPython: thread-safe ids
    return f"{prefix}{st[0]}{next(st[1]):016x}"


def job_id() -> str:
    return new_id("job-")


def node_id() -> str:
    return new_id("node-")


def worker_id() -> str:
    return new_id("wkr-")


def actor_id() -> str:
    return new_id("act-")


def task_id() -> str:
    return new_id("tsk-")


def placement_group_id() -> str:
    return new_id("pg-")


def object_id_for_return(tid: str, index: int) -> str:
    """Derive object id from creating task id + return index (lineage key)."""
    return f"obj-{tid[4:]}-{index}"


def put_object_id(owner_worker_id: str, seq: int) -> str:
    return f"obj-put-{owner_worker_id[4:]}-{seq}"


# ---------------------------------------------------------------------------
# Resources
# ---------------------------------------------------------------------------

CPU = "CPU"
GPU = "GPU"
MEM = "memory"
# Granularity for fractional resources (reference uses 1e-4 fixed point).
_GRAN = 10000


def normalize_resources(res: Optional[Dict[str, float]]) -> Dict[str, int]:
    """To fixed-point ints to avoid float drift in accounting."""
    out: Dict[str, int] = {}
    for k, v in (res or {}).items():
        iv = int(round(float(v) * _GRAN))
        if iv < 0:
            raise ValueError(f"resource {k} negative: {v}")
        if iv > 0:
            out[k] = iv
    return out


def denormalize_resources(res: Dict[str, int]) -> Dict[str, float]:
    return {k: v / _GRAN for k, v in res.items()}


def fits(avail: Dict[str, int], demand: Dict[str, int]) -> bool:
    return all(avail.get(k, 0) >= v for k, v in demand.items())


def subtract(avail: Dict[str, int], demand: Dict[str, int]) -> None:
    for k, v in demand.items():
        avail[k] = avail.get(k, 0) - v


def add(avail: Dict[str, int], demand: Dict[str, int]) -> None:
    for k, v in demand.items():
        avail[k] = avail.get(k, 0) + v


# ---------------------------------------------------------------------------
# Task / actor specs
# ---------------------------------------------------------------------------

# Objects smaller than this are owner-held / inlined in messages; larger go to
# the node shared-memory store (reference: max_direct_call_object_size,
# ray_config_def.h).
INLINE_OBJECT_LIMIT = 100 * 1024


@dataclass
class FunctionDescriptor:
    function_id: str          # content hash of the pickled callable
    name: str                 # qualname, for errors/observability
    blob: Optional[bytes]     # pickled callable; None once registered


@dataclass
class TaskSpec:
    task_id: str
    function_id: str
    function_name: str
    # args/kwargs with ObjectRefs replaced by ("__ref__", object_id) markers;
    # pickled by cloudpickle.  Inline values embedded directly.
    args_blob: bytes
    num_returns: int = 1
    resources: Dict[str, int] = field(default_factory=dict)
    max_retries: int = 3
    retry_exceptions: bool = False
    # actor task fields
    actor_id: Optional[str] = None
    seq_no: int = -1
    # actor creation fields
    is_actor_creation: bool = False
    max_restarts: int = 0
    max_concurrency: int = 1
    # placement
    placement_group_id: Optional[str] = None
    placement_bundle_index: int = -1
    scheduling_strategy: Optional[Any] = None
    owner_id: str = ""
    owner_addr: Optional[Tuple[str, int]] = None
    # task that submitted this one (same owner process), for
    # ray.cancel(recursive=True) child propagation
    parent_task_id: Optional[str] = None
    # owning driver job — workers emit it as a log marker so worker
    # stdout can be routed to the right driver (log_monitor.py)
    job_id: str = ""
    # OTel span context carrier (util/tracing.py; reference
    # tracing_helper.py propagates the submit span to the executor)
    trace_ctx: Optional[Dict[str, str]] = None
    # runtime env (env vars, working dir); materialized by the worker
    runtime_env: Optional[Dict[str, Any]] = None
    name: str = ""
    # streaming generators: max unconsumed items before the producer
    # pauses (0 = unbounded; reference _generator_backpressure_num_objects)
    generator_backpressure: int = 0

    def return_ids(self) -> List[str]:
        if self.num_returns == STREAMING_RETURNS:
            return []
        return [object_id_for_return(self.task_id, i) for i in range(self.num_returns)]

    def __reduce__(self):
        # positional-tuple pickling: specs cross the wire once per task,
        # and the default dataclass reduce re-pickles all 20+ field-name
        # strings in every frame
        return (TaskSpec, tuple(getattr(self, n) for n in _SPEC_FIELDS))


# num_returns sentinel for streaming-generator tasks (reference:
# num_returns="streaming" -> ObjectRefGenerator, _raylet.pyx:281)
STREAMING_RETURNS = -1

_SPEC_FIELDS = tuple(f.name for f in dataclass_fields(TaskSpec))


class SerializedRef:
    """Marker for an ObjectRef inside pickled task args / objects.

    Carries enough to reconstruct a borrower-side ObjectRef: id, owner
    address (to fetch / send ref-count messages) and the node hint.
    """

    __slots__ = ("object_id", "owner_addr", "owner_id")

    def __init__(self, object_id: str, owner_addr, owner_id: str):
        self.object_id = object_id
        self.owner_addr = owner_addr
        self.owner_id = owner_id

    def __reduce__(self):
        return (SerializedRef, (self.object_id, self.owner_addr, self.owner_id))


_by_value_registered: set = set()


def _ensure_picklable_by_value(obj: Any) -> None:
    """User-code modules (anything outside the interpreter installation) are
    pickled by value so workers don't need the driver's sys.path — the
    equivalent of the reference exporting functions through the GCS function
    table regardless of importability."""
    import sys

    mod_name = getattr(obj, "__module__", None)
    if not mod_name or mod_name in _by_value_registered:
        return
    if mod_name == "ray_tpu_torch" or mod_name.startswith("ray_tpu_torch."):
        return  # framework code is importable everywhere
    mod = sys.modules.get(mod_name)
    if mod is None or mod_name == "__main__":
        return  # cloudpickle already handles __main__ by value
    mod_file = getattr(mod, "__file__", None)
    if mod_file is None:
        return
    prefix_paths = (sys.prefix, sys.base_prefix)
    if any(mod_file.startswith(p) for p in prefix_paths):
        return  # installed library: importable on workers, keep by-reference
    try:
        cloudpickle.register_pickle_by_value(mod)
        _by_value_registered.add(mod_name)
    except Exception:
        pass


def hash_function(fn: Any) -> Tuple[str, bytes]:
    _ensure_picklable_by_value(fn)
    blob = cloudpickle.dumps(fn)
    import hashlib

    return "fn-" + hashlib.sha1(blob).hexdigest(), blob


class RayTpuError(Exception):
    pass


class TaskError(RayTpuError):
    """Wraps an exception raised inside a remote task (cause + traceback)."""

    def __init__(self, cause: BaseException, tb: str, task_name: str = ""):
        self.cause = cause
        self.tb = tb
        self.task_name = task_name
        super().__init__(f"task {task_name!r} failed: {cause!r}\n{tb}")

    def __reduce__(self):
        return (TaskError, (self.cause, self.tb, self.task_name))


class WorkerCrashedError(RayTpuError):
    pass


class ActorDiedError(RayTpuError):
    pass


class ObjectLostError(RayTpuError):
    pass


class TaskCancelledError(RayTpuError):
    """The task was cancelled via ray_tpu_torch.cancel() (reference:
    ray.exceptions.TaskCancelledError)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


# -- control-plane rendezvous file (failover re-homing) ----------------------
# One format, one reader, one writer: control.py publishes, raylets /
# workers / drivers re-resolve.  rsplit tolerates IPv6-ish hosts.

def write_addr_file(path: str, addr: Tuple[str, int]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{addr[0]}:{addr[1]}")
    os.replace(tmp, path)    # atomic: readers see old or new, never half


def read_addr_file(path: Optional[str]) -> Optional[Tuple[str, int]]:
    if not path:
        return None
    try:
        with open(path) as f:
            host, port = f.read().strip().rsplit(":", 1)
        return (host, int(port))
    except Exception:
        return None
