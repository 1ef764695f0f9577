"""CompiledDAG: persistent per-actor exec loops over shm channels.

Reference: python/ray/dag/compiled_dag_node.py (CompiledDAG :664,
do_exec_tasks :133, ExecutableTask :345, execute :2118).  Compilation turns
a bound DAG into:

  * one long-running "exec loop" task per participating actor (submitted
    via the __apply__ mechanism, so user classes need no changes), running
    its nodes in topo order every iteration;
  * one SPSC shm ring channel per edge (driver->actor, actor->actor,
    actor->driver) — dag/channel.py over native/shm_channel.cc;
  * a driver facade: ``execute(v)`` writes v into the root channels and
    returns a CompiledDAGRef whose ``get()`` reads the leaf channels.

Pipelining: channels hold `nslots` versions, so up to nslots iterations run
concurrently across stages — the substrate for MPMD pipeline parallelism
across cards (each stage actor owns a card or a share of one; the channel
carries host-staged tensors between them, ``channel.py``'s raw path for
CUDA tensors).  Tensors between ranks of one program move through
``ray_tpu_torch.collective``, not channels.

Error semantics: a node exception becomes an error envelope that flows to
the leaf channels; CompiledDAGRef.get() re-raises it.  Teardown closes the
root channels; closure propagates node-to-node and the loops exit.

The port's copy of ``ray_tpu/dag/compiled_dag.py``: channels live under
the session's directory (``/dev/shm/ray_tpu_torch/session-*/channels``),
or ``/dev/shm/ray_tpu_torch_dag`` for a core with no store.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from .._private import api as _api
from .channel import (TAG_ERROR, TAG_INLINE, TAG_STOP, Channel,
                      ChannelClosed, ChannelTimeout)
from .dag_node import (ClassMethodNode, CollectiveOutputNode, DAGNode,
                       InputNode, MultiOutputNode)

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# The exec loop (runs inside each participating actor via __apply__)
# ---------------------------------------------------------------------------

def _dag_exec_loop(actor_self, plan: List[Dict[str, Any]],
                   chan_geometry: Tuple[int, int]) -> bool:
    """Run this actor's nodes forever (until stop/close).

    plan: topo-ordered node descriptors for THIS actor:
      {"method": str, "inputs": [("chan", path) | ("const", value)],
       "outputs": [path, ...]}
    """
    slot_bytes, nslots = chan_geometry
    in_chans: Dict[str, Channel] = {}
    out_chans: Dict[str, Channel] = {}
    for t in plan:
        for kind, src in t["inputs"]:
            if kind == "chan" and src not in in_chans:
                in_chans[src] = Channel(src, slot_bytes, nslots)
        for p in t["outputs"]:
            if p not in out_chans:
                out_chans[p] = Channel(p, slot_bytes, nslots)
    logger.info("dag exec loop up: plan=%s in=%s out=%s",
                [t["method"] for t in plan], list(in_chans),
                list(out_chans))

    def broadcast_stop():
        for c in out_chans.values():
            c.write_stop()
            c.close()

    try:
        while True:
            # Channels are read lazily, at the step that consumes them,
            # in plan (topo) order — NOT all-upfront.  Collectives make
            # the channel graph cyclic across actors (A⇄B contribution
            # exchange); upfront reads would deadlock, while plan-order
            # reads guarantee every contribution is written before the
            # collective step blocks on its peers.  Each channel is
            # still consumed exactly once per iteration (iter_vals).
            iter_vals: Dict[str, Any] = {}
            err: Optional[BaseException] = None
            stop = False

            def read_chan(path: str):
                nonlocal err, stop
                if path in iter_vals:
                    return
                try:
                    tag, v = in_chans[path].read()
                except (ChannelClosed, ChannelTimeout):
                    stop = True
                    iter_vals[path] = (TAG_STOP, None)
                    return
                if tag == TAG_STOP:
                    stop = True
                elif tag == TAG_ERROR and err is None:
                    err = v
                iter_vals[path] = (tag, v)

            node_out: Dict[str, Any] = {}
            for t in plan:
                # resolve inputs first, even under error: every channel
                # must be drained once per iteration to stay aligned
                args = []
                for kind, src in t["inputs"]:
                    if kind == "const":
                        args.append(src)
                    elif kind == "node":
                        args.append(node_out.get(src))
                    else:
                        read_chan(src)
                        if stop:
                            break
                        args.append(iter_vals[src][1])
                if stop:
                    break
                outs = [out_chans[p] for p in t["outputs"]]
                if err is not None:
                    for c in outs:
                        c.write_error(err)
                    continue
                try:
                    if t.get("builtin"):
                        # collective step: reduce own contribution with
                        # the peers' (reference: aDAG collective node —
                        # the reduction runs inside the actor loop)
                        from .collective import REDUCERS

                        out = REDUCERS[t["builtin"]](args)
                    else:
                        method = getattr(actor_self, t["method"])
                        out = method(*args)
                    node_out[t["key"]] = out
                    for c in outs:
                        c.write(out)
                except BaseException as e:  # node failure -> error envelope
                    err = e
                    for c in outs:
                        c.write_error(e)
            if stop:
                broadcast_stop()
                return True
    except BaseException:
        logger.exception("dag exec loop crashed")
        broadcast_stop()
        return False
    finally:
        for c in list(in_chans.values()) + list(out_chans.values()):
            c.release()


# ---------------------------------------------------------------------------
# Driver side
# ---------------------------------------------------------------------------

class CompiledDAGRef:
    """Future for one execute() iteration (reference: CompiledDAGRef)."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq

    def get(self, timeout: Optional[float] = 300.0):
        return self._dag._read_result(self, timeout)


class CompiledDAG:
    def __init__(self, root: DAGNode, *, buffer_size_bytes: int = 1 << 20,
                 nslots: int = 4):
        self._root = root
        self._slot_bytes = buffer_size_bytes
        self._nslots = nslots
        self._lock = threading.Lock()
        self._seq_submitted = 0
        self._seq_read = 0
        self._results: Dict[int, Any] = {}
        self._torn_down = False

        nodes = root.topo_sort()
        self._input_nodes = [n for n in nodes if isinstance(n, InputNode)]
        if isinstance(root, MultiOutputNode):
            self._leaves = list(root.outputs)
        else:
            self._leaves = [root]
        body = [n for n in nodes
                if isinstance(n, (ClassMethodNode, CollectiveOutputNode))]
        if not any(isinstance(n, ClassMethodNode) for n in body):
            raise ValueError("compiled DAG needs at least one actor node")
        for n in nodes:
            if not isinstance(n, (InputNode, ClassMethodNode,
                                  CollectiveOutputNode, MultiOutputNode)):
                raise TypeError(
                    f"compiled DAGs support actor-method, collective and "
                    f"input nodes only, got {n!r}")

        core = _api.current_core()
        store_root = getattr(getattr(core, "store", None), "root", None)
        session_dir = (os.path.dirname(store_root) if store_root
                       else "/dev/shm/ray_tpu_torch_dag")
        base = os.path.join(session_dir, "channels", uuid.uuid4().hex[:12])
        os.makedirs(base, exist_ok=True)
        self._chan_dir = base

        def edge_path(src: DAGNode, dst_desc: str) -> str:
            return os.path.join(base, f"e{src._id}-{dst_desc}")

        # group nodes per actor, build channel edges
        per_actor: Dict[str, Dict[str, Any]] = {}
        consumer_counts: Dict[int, int] = {}
        self._input_chan_paths: List[str] = []
        self._leaf_chan_paths: List[str] = []

        for n in body:
            aid = n.handle._actor_id
            per_actor.setdefault(aid, {"handle": n.handle, "plan": []})

        def dep_input(a: DAGNode, aid: str, consumer: DAGNode):
            """Wire one upstream value into `consumer` on actor `aid`."""
            if a.handle._actor_id == aid:
                # same actor: direct value handoff, no channel
                return ("node", f"n{a._id}")
            p = edge_path(a, f"a{aid[:8]}-{consumer._id}")
            consumer_counts[a._id] = consumer_counts.get(a._id, 0) + 1
            per_actor[a.handle._actor_id].setdefault(
                "extra_out", {}).setdefault(a._id, []).append(p)
            return ("chan", p)

        for n in body:
            aid = n.handle._actor_id
            inputs = []
            if isinstance(n, CollectiveOutputNode):
                # collective step: own contribution by direct handoff,
                # every peer's over a channel (reference: collective_node
                # — the aDAG schedules one send/recv pair per peer)
                for c in n.group:
                    inputs.append(dep_input(c, aid, n))
                per_actor[aid]["plan"].append(
                    {"key": f"n{n._id}", "node_id": n._id,
                     "method": f"allreduce_{n.op}", "builtin": n.op,
                     "inputs": inputs, "outputs": []})
                continue
            for a in list(n.args) + list(n.kwargs.values()):
                if isinstance(a, InputNode):
                    p = edge_path(a, f"a{aid[:8]}-{n._id}")
                    inputs.append(("chan", p))
                    if p not in self._input_chan_paths:
                        self._input_chan_paths.append(p)
                elif isinstance(a, (ClassMethodNode, CollectiveOutputNode)):
                    inputs.append(dep_input(a, aid, n))
                elif isinstance(a, DAGNode):
                    raise TypeError(f"unsupported arg node {a!r}")
                else:
                    inputs.append(("const", a))
            per_actor[aid]["plan"].append(
                {"key": f"n{n._id}", "node_id": n._id, "method": n.method_name,
                 "inputs": inputs, "outputs": []})

        for leaf in self._leaves:
            if not isinstance(leaf, (ClassMethodNode, CollectiveOutputNode)):
                raise TypeError("DAG leaves must be actor-method or "
                                "collective nodes")
            p = edge_path(leaf, "driver")
            self._leaf_chan_paths.append(p)
            aid = leaf.handle._actor_id
            for t in per_actor[aid]["plan"]:
                if t["node_id"] == leaf._id:
                    t["outputs"].append(p)

        for aid, desc in per_actor.items():
            for t in desc["plan"]:
                extra = desc.get("extra_out", {}).get(t["node_id"], [])
                t["outputs"].extend(extra)

        # driver endpoints (create channels before the loops attach)
        geometry = (self._slot_bytes, self._nslots)
        self._input_chans = [Channel(p, *geometry)
                             for p in self._input_chan_paths]
        self._leaf_chans = [Channel(p, *geometry)
                            for p in self._leaf_chan_paths]

        # launch the per-actor loops
        self._loop_refs = []
        for aid, desc in per_actor.items():
            ref = desc["handle"]._actor_call(
                _dag_exec_loop, desc["plan"], geometry)
            self._loop_refs.append(ref)

    # -- execution ----------------------------------------------------------

    def execute(self, *args) -> CompiledDAGRef:
        with self._lock:
            if self._torn_down:
                raise RuntimeError("DAG was torn down")
            value = args[0] if len(args) == 1 else args
            for c in self._input_chans:
                c.write(value, timeout_s=300.0)
            self._seq_submitted += 1
            return CompiledDAGRef(self, self._seq_submitted - 1)

    def _check_loops_alive(self):
        """Surface an exec-loop crash (actor died, channel open failure)
        instead of letting the caller block into a timeout."""
        core = _api.current_core()
        done, _ = core.wait(self._loop_refs,
                               num_returns=len(self._loop_refs),
                               timeout=0.001)
        for r in done:
            try:
                core.get(r, timeout=1.0)
                raise RuntimeError(
                    "compiled DAG exec loop exited unexpectedly")
            except (RuntimeError,):
                raise
            except BaseException as e:
                raise RuntimeError(
                    f"compiled DAG exec loop died: {e}") from e

    def _read_leaf(self, c: Channel, timeout: Optional[float]):
        """Read one leaf value, polling in slices so a dead exec loop
        raises its real error instead of a bare ChannelTimeout."""
        deadline = None if timeout is None else \
            (time.monotonic() + timeout)
        while True:
            slice_s = 1.0 if deadline is None else \
                min(1.0, max(deadline - time.monotonic(), 0.01))
            try:
                return c.read(timeout_s=slice_s)
            except ChannelTimeout:
                self._check_loops_alive()
                if deadline is not None and time.monotonic() > deadline:
                    raise

    def _read_result(self, ref: CompiledDAGRef, timeout: Optional[float]):
        with self._lock:
            if ref._seq < self._seq_read:
                # read ahead by a later ref's get()
                if ref._seq not in self._results:
                    raise ValueError(
                        f"result of execution {ref._seq} was already got")
                result, is_err = self._results.pop(ref._seq)
                if is_err:
                    raise result
                return result
            while self._seq_read <= ref._seq:
                outs = []
                for c in self._leaf_chans:
                    tag, v = self._read_leaf(c, timeout)
                    if tag == TAG_STOP:
                        raise ChannelClosed("DAG torn down mid-read")
                    outs.append((tag, v))
                seq = self._seq_read
                self._seq_read += 1
                errs = [v for tag, v in outs if tag == TAG_ERROR]
                if errs:
                    result = errs[0]
                    is_err = True
                else:
                    vals = [v for _, v in outs]
                    result = vals[0] if not isinstance(
                        self._root, MultiOutputNode) else vals
                    is_err = False
                if seq == ref._seq:
                    if is_err:
                        raise result
                    return result
                self._results[seq] = (result, is_err)
        raise RuntimeError("unreachable")

    # -- lifecycle ----------------------------------------------------------

    def teardown(self, timeout_s: float = 10.0):
        with self._lock:
            if self._torn_down:
                return
            self._torn_down = True
        for c in self._input_chans:
            c.write_stop()
            c.close()
        # close leaf channels too: a loop blocked writing an unread result
        # must wake (ChannelClosed) instead of stranding the actor
        for c in self._leaf_chans:
            c.close()
        try:
            _api.current_core().wait(self._loop_refs,
                                     num_returns=len(self._loop_refs),
                                     timeout=timeout_s)
        except Exception:
            pass
        for c in self._input_chans + self._leaf_chans:
            c.release()
        try:
            import shutil

            shutil.rmtree(self._chan_dir, ignore_errors=True)
        except OSError:
            pass

    def __del__(self):
        try:
            self.teardown(timeout_s=2.0)
        except Exception:
            pass
