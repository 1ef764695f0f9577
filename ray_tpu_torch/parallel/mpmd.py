"""MPMD pipeline parallelism: per-stage programs on separate gangs.

The port's copy of ``ray_tpu/parallel/mpmd.py``.  The SPMD path
(``parallel/pipeline.py``) runs every stage's schedule on every pp rank
and burns the fill-drain bubble (n-1)/(M+n-1) each step.  Here the model
is partitioned into per-stage programs (``models/gpt.py``
``partition_stage_params`` / ``stage_hidden`` / ``stage_loss``), each run
by its own gang on its own device, with activation and gradient edges
over the DAG's shared-memory channels (``dag/channel.py``: a CUDA tensor
moves as one device -> shm copy of its raw bytes on the writer and one
shm -> device copy on the reader, no pickle).

Schedules (one ``PipelineSchedule`` interface):
  fill_drain  all M forwards, then all M backwards (GPipe)
  1f1b        warmup F's, steady (F,B) pairs, drain B's: the same bubble
              as fill-drain, the activation stash bounded by the depth
  zb          zero-bubble (ZB-H1 family): the backward split into Bx (the
              input gradient only: ``autograd.grad(inputs=x)`` runs no
              weight-gradient product) and W (the weight gradients only);
              W ops run whenever the gang would otherwise wait on a
              channel, filling the warmup and drain bubbles

Each stage's programs take the stage's params and its stashed INPUT: a
backward recomputes the stage forward from that input (the reference's
``jax.vjp`` inside the program), so ``peak_stash`` counts inputs and K1
runs again in every backward (twice with ``cfg.remat``, whose blocks
recompute once more); both zb halves recompute, and K2 and K3 run in
both (q, k and v lie on the path to x and to the weights).  Each
result carries the kernel launches of every op kind, per stage.

Stages that share a device take turns on it: each compute op runs under
that device's lock and ends with a device sync (the reference's
``block_until_ready``), so an op's duration is its own and the launches
counted during it are its stage's.  A channel read's or write's copy
between the card and shared memory takes the lock too: otherwise it
would queue behind another stage's kernels, and the replay would read
that stage's work as this edge's cost.

Bubble measurement: ``replay_bubble`` replays the recorded per-op
durations and p2p edge costs in virtual time, each stage on a dedicated
executor (op start = max(executor free, dependency ready + edge cost)),
recovering the schedule's own bubble from a host whose stages share
cores or a card.  Per-stage phases land in the flight recorder as
``pipeline.fwd`` / ``.bwd`` / ``.bwd_w`` / ``.p2p`` / ``.idle``.

Elastic: each stage commits its params and optimizer state at step
boundaries and snapshots them through ``elastic/emergency.py``'s vault;
a dead stage gang is respawned from its ``EmergencyCheckpoint`` while the
survivors roll back to the committed step.  ``torch.optim`` updates in
place, so a commit holds COPIES (the reference keeps references to
immutable arrays): a clone of every param and a deep copy of the
optimizer's ``state_dict()``.

The tied table's gradient exchanged between the end stages is the whole
[V, D] table in the param dtype (154.5 MB at GPT-2-small's width), far
above an activation's slot: its two channels are sized for it (one slot
each), so the exchange never takes the channel's spill path, which needs
a running runtime.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import os
import queue
import shutil
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .sharding import _flatten, _tree_map

SCHEDULES = ("fill_drain", "1f1b", "zb")

PIPELINE_ENV = "RAY_TPU_TORCH_TRAIN_PIPELINE"


@dataclasses.dataclass
class PipelineConfig:
    """MPMD pipeline shape (JaxConfig.pipeline / MPMDPipeline).

    stages: number of pipeline stages (one gang each).
    schedule: "fill_drain" | "1f1b" | "zb".
    microbatches: per-step microbatch count M (default = stages).
    transport: "threads" (in-process gangs, shm channels) or "actors"
        (one runtime actor per stage gang).
    grad_sync_group: when set, each stage syncs its grads through
        GradientSynchronizer over collective group "<name>-s<stage>"
        (per-stage bucketed allreduce for dp>1 gangs).
    snapshot_every: emergency-vault snapshot cadence in steps.
    slot_bytes / nslots: the activation and gradient channels' ring.
    """

    stages: int = 2
    schedule: str = "1f1b"
    microbatches: Optional[int] = None
    transport: str = "threads"
    grad_sync_group: Optional[str] = None
    snapshot_every: int = 1
    slot_bytes: int = 8 << 20
    nslots: int = 4

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; "
                             f"one of {SCHEDULES}")
        if self.stages < 1:
            raise ValueError(f"stages must be >= 1, got {self.stages}")
        if self.transport not in ("threads", "actors"):
            raise ValueError(f"unknown transport {self.transport!r}")
        if self.microbatches is not None and self.microbatches < 1:
            raise ValueError("microbatches must be >= 1")

    @property
    def num_microbatches(self) -> int:
        return self.microbatches or self.stages

    def to_spec(self) -> str:
        """Env-var form (see from_spec): the train backend publishes this
        to workers as RAY_TPU_TORCH_TRAIN_PIPELINE."""
        parts = [f"stages={self.stages}", f"schedule={self.schedule}",
                 f"microbatches={self.num_microbatches}",
                 f"transport={self.transport}"]
        if self.grad_sync_group:
            parts.append(f"grad_sync_group={self.grad_sync_group}")
        if self.snapshot_every != 1:
            parts.append(f"snapshot_every={self.snapshot_every}")
        return ",".join(parts)

    @classmethod
    def from_spec(cls, spec: str) -> "PipelineConfig":
        kw: Dict[str, Any] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad pipeline spec item {part!r} "
                                 f"in {spec!r}")
            k, v = part.split("=", 1)
            k = k.strip()
            if k in ("stages", "microbatches", "snapshot_every",
                     "slot_bytes", "nslots"):
                kw[k] = int(v)
            elif k in ("schedule", "transport", "grad_sync_group"):
                kw[k] = v.strip()
            else:
                raise ValueError(f"unknown pipeline spec key {k!r}")
        return cls(**kw)

    @classmethod
    def from_env(cls) -> Optional["PipelineConfig"]:
        spec = os.environ.get(PIPELINE_ENV, "").strip()
        return cls.from_spec(spec) if spec else None


# ---------------------------------------------------------------------------
# Schedule library


class PipelineSchedule:
    """Per-stage op streams behind one interface.

    ops() returns the ordered (kind, microbatch) list one gang executes:
    kind in {"F", "B", "Bx", "W"}.  Cross-stage consistency is the
    schedule's contract: stage s emits sends in exactly the order stage
    s±1 posts the matching recvs.
    """

    name = "base"
    split_backward = False  # zb: B split into Bx (input grad) + W (weights)

    def ops(self, stage: int, stages: int, microbatches: int
            ) -> List[Tuple[str, int]]:
        raise NotImplementedError

    @staticmethod
    def theoretical_fill_drain_bubble(stages: int, microbatches: int
                                      ) -> float:
        """(n-1)/(M+n-1): the GPipe bubble both the SPMD pipeline and the
        fill_drain schedule pay, the floor MPMD schedules beat."""
        n, m = stages, microbatches
        return (n - 1) / (m + n - 1) if n > 1 else 0.0


class FillDrain(PipelineSchedule):
    name = "fill_drain"

    def ops(self, stage, stages, microbatches):
        # backwards in LIFO order (the GPipe activation stack)
        return ([("F", i) for i in range(microbatches)]
                + [("B", i) for i in reversed(range(microbatches))])


class OneFOneB(PipelineSchedule):
    name = "1f1b"

    def ops(self, stage, stages, microbatches):
        warm = min(microbatches, stages - 1 - stage)
        out = [("F", i) for i in range(warm)]
        b = 0
        for f in range(warm, microbatches):
            out.append(("F", f))
            out.append(("B", b))
            b += 1
        out.extend(("B", i) for i in range(b, microbatches))
        return out


class ZeroBubble(OneFOneB):
    """1F1B skeleton with B split into Bx + W.  The W ops listed at the
    tail are a completeness fallback: the gang runs pending W's early
    whenever a channel wait would otherwise idle it."""

    name = "zb"
    split_backward = True

    def ops(self, stage, stages, microbatches):
        base = super().ops(stage, stages, microbatches)
        out = [("Bx", mb) if kind == "B" else (kind, mb)
               for kind, mb in base]
        out.extend(("W", i) for i in range(microbatches))
        return out


_SCHEDULE_CLASSES = {c.name: c for c in (FillDrain, OneFOneB, ZeroBubble)}


def get_schedule(name: str) -> PipelineSchedule:
    try:
        return _SCHEDULE_CLASSES[name]()
    except KeyError:
        raise ValueError(f"unknown schedule {name!r}; one of {SCHEDULES}")


# ---------------------------------------------------------------------------
# Bubble measurement: virtual-time replay of the recorded event log


def replay_bubble(events_by_stage: List[List[Dict[str, Any]]]
                  ) -> Dict[str, Any]:
    """Replay per-op durations against the schedule's dependency graph.

    Dependencies: F(s,mb) needs F(s-1,mb) + fwd edge cost; B/Bx(s,mb)
    needs B/Bx(s+1,mb) + bwd edge cost (last stage: its own F(mb));
    W(s,mb) needs Bx(s,mb).  Edge cost = measured send dur (writer) +
    recv dur (reader).  Per-stage ops execute in recorded order on a
    dedicated virtual executor, so a W that really ran inside a channel
    wait replays inside the same gap.

    Returns per-stage bubble fractions (1 - busy/span), their mean (the
    headline metric) and max, and the virtual makespan.
    """
    n = len(events_by_stage)
    comp: List[List[Tuple[str, int, float]]] = [[] for _ in range(n)]
    edge_f: List[Dict[int, float]] = [dict() for _ in range(n)]
    edge_b: List[Dict[int, float]] = [dict() for _ in range(n)]
    for s, evs in enumerate(events_by_stage):
        for e in evs:
            k, mb, dur = e["kind"], e.get("mb", -1), e["dur"]
            if k in ("F", "B", "Bx", "W"):
                comp[s].append((k, mb, dur))
            elif k == "send_f":
                edge_f[s][mb] = edge_f[s].get(mb, 0.0) + dur
            elif k == "recv_f" and s > 0:
                edge_f[s - 1][mb] = edge_f[s - 1].get(mb, 0.0) + dur
            elif k == "send_b":
                edge_b[s][mb] = edge_b[s].get(mb, 0.0) + dur
            elif k == "recv_b" and s + 1 < n:
                edge_b[s + 1][mb] = edge_b[s + 1].get(mb, 0.0) + dur

    end: Dict[Tuple[int, str, int], float] = {}

    def dep_ready(s: int, kind: str, mb: int) -> Optional[float]:
        if kind == "F":
            if s == 0:
                return 0.0
            t = end.get((s - 1, "F", mb))
            return None if t is None else t + edge_f[s - 1].get(mb, 0.0)
        if kind in ("B", "Bx"):
            if s == n - 1:
                return end.get((s, "F", mb))
            t = end.get((s + 1, "B", mb))
            return None if t is None else t + edge_b[s + 1].get(mb, 0.0)
        return end.get((s, "B", mb))  # W

    idx = [0] * n
    cursor = [0.0] * n
    first = [None] * n
    last = [0.0] * n
    busy = [0.0] * n
    total = sum(len(c) for c in comp)
    done = 0
    while done < total:
        progressed = False
        for s in range(n):
            while idx[s] < len(comp[s]):
                kind, mb, dur = comp[s][idx[s]]
                dep = dep_ready(s, kind, mb)
                if dep is None:
                    break
                t0 = max(cursor[s], dep)
                t1 = t0 + dur
                cursor[s] = t1
                key = "B" if kind in ("B", "Bx") else kind
                end[(s, key, mb)] = t1
                if first[s] is None:
                    first[s] = t0
                last[s] = t1
                busy[s] += dur
                idx[s] += 1
                done += 1
                progressed = True
        if not progressed:
            missing = [(s, comp[s][idx[s]]) for s in range(n)
                       if idx[s] < len(comp[s])]
            raise RuntimeError(f"replay deadlock; blocked ops: {missing}")

    bubbles = []
    for s in range(n):
        span = last[s] - (first[s] or 0.0)
        bubbles.append(0.0 if span <= 0 else max(0.0, 1 - busy[s] / span))
    return {
        "per_stage": bubbles,
        "mean": sum(bubbles) / max(1, n),
        "max": max(bubbles) if bubbles else 0.0,
        "span_s": max(last) if n else 0.0,
    }


def mean_op_events(steps: List[List[List[Dict[str, Any]]]]
                   ) -> List[List[Dict[str, Any]]]:
    """The last step's event log with each event's duration set to the
    mean over ``steps`` (each an ``events_by_stage`` log) of its stage
    and kind.  Replayed, it gives the schedule's bubble at the measured
    op and edge costs and the stages' imbalance, without the per-op
    spread of the host's dispatch times."""
    sums: Dict[Tuple[int, str], List[float]] = {}
    for events_by_stage in steps:
        for s, evs in enumerate(events_by_stage):
            for e in evs:
                acc = sums.setdefault((s, e["kind"]), [0.0, 0])
                acc[0] += e["dur"]
                acc[1] += 1
    return [[dict(e, dur=sums[(s, e["kind"])][0] / sums[(s, e["kind"])][1])
             for e in evs] for s, evs in enumerate(steps[-1])]


_TRACE_NAMES = {"F": "pipeline.fwd", "B": "pipeline.bwd",
                "Bx": "pipeline.bwd", "W": "pipeline.bwd_w",
                "send_f": "pipeline.p2p", "recv_f": "pipeline.p2p",
                "send_b": "pipeline.p2p", "recv_b": "pipeline.p2p",
                "send_tie": "pipeline.p2p", "recv_tie": "pipeline.p2p",
                "wait": "pipeline.idle"}


def schedule_chrome_trace(events_by_stage: List[List[Dict[str, Any]]]
                          ) -> List[Dict[str, Any]]:
    """Per-op chrome trace (one pid per stage): load in chrome://tracing
    or Perfetto to SEE the schedule — F/B/W slices, p2p edges, idle."""
    out: List[Dict[str, Any]] = []
    t_base = min((e["t0"] for evs in events_by_stage for e in evs),
                 default=0.0)
    for s, evs in enumerate(events_by_stage):
        out.append({"ph": "M", "pid": s, "tid": 0, "name": "process_name",
                    "args": {"name": f"pipeline stage {s}"}})
        for e in evs:
            out.append({
                "ph": "X", "pid": s, "tid": 0,
                "name": _TRACE_NAMES.get(e["kind"], e["kind"]),
                "cat": "pipeline",
                "ts": (e["t0"] - t_base) * 1e6,
                "dur": max(0.01, e["dur"] * 1e6),
                "args": {"kind": e["kind"], "mb": e.get("mb", -1)},
            })
    return out


# ---------------------------------------------------------------------------
# Stage programs


_PROG_LOCK = threading.Lock()
_PROGRAM_CACHE: Dict[Any, Dict[str, Any]] = {}  # guarded-by: _PROG_LOCK


def _stage_programs(cfg, stage: int, stages: int) -> Dict[str, Any]:
    """fwd/bwd/bwd_x/bwd_w programs of one stage slice, made once per
    process under the reference's ledger names (``mpmd.s<s>of<n>.*``).

    fwd(p, x[, tgt]) runs the stage forward with no graph; the backward
    programs rebuild it from the stashed input x and ask autograd for
    (dx, dp), dx alone (``bwd_x``) or dp alone (``bwd_w``).  The first
    stage's input is tokens: it has no bwd_x, and all of its B is W work.
    """
    key = (cfg, stage, stages)
    with _PROG_LOCK:
        progs = _PROGRAM_CACHE.get(key)
    if progs is not None:
        return progs

    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.telemetry import device as devtel

    n, s = stages, stage
    first, last = s == 0, s == stages - 1
    tag = f"mpmd.s{s}of{n}"

    def forward(p, x, aux):
        if last:
            return gpt.stage_loss(p, x, aux, cfg, s, n)
        return gpt.stage_hidden(p, x, cfg, s, n)

    def fwd(p, x, aux=None):
        with torch.no_grad():
            return forward(p, x, aux)

    def grads(p, x, aux, want_x: bool, want_p: bool):
        """(dx or None, the param-gradient tree or None).  ``aux`` is the
        targets on the last stage, the output's gradient elsewhere."""
        want_x = want_x and not first
        with torch.enable_grad():
            xin = x.detach().requires_grad_() if want_x else x
            out = forward(p, xin, aux)
            leaves, rebuild = _flatten(p)
            leaves = [t for _, t in leaves] if want_p else []
            got = torch.autograd.grad(
                out, ([xin] if want_x else []) + leaves,
                grad_outputs=None if last else aux)
        dx = got[0] if want_x else None
        dp = rebuild(got[1:] if want_x else got) if want_p else None
        return dx, dp

    def inst(fn, kind):
        return devtel.instrument(fn, name=f"{tag}.{kind}")

    if last:
        def bwd(p, x, tgt):
            dx, dp = grads(p, x, tgt, True, True)
            # a single-stage pipeline has no input gradient: (x, dp)
            return (x if first else dx), dp

        progs = {"fwd": inst(fwd, "fwd"), "bwd": inst(bwd, "bwd"),
                 "bwd_x": inst(lambda p, x, g: grads(p, x, g, True,
                                                     False)[0], "bwd_x"),
                 "bwd_w": inst(lambda p, x, g: grads(p, x, g, False,
                                                     True)[1], "bwd_w")}
    elif first:
        bwd0 = inst(lambda p, x, g: grads(p, x, g, False, True)[1], "bwd")
        progs = {"fwd": inst(fwd, "fwd"), "bwd": bwd0,
                 "bwd_x": None,  # tokens have no grad; all of B is W work
                 "bwd_w": bwd0}
    else:
        progs = {"fwd": inst(fwd, "fwd"),
                 "bwd": inst(lambda p, x, g: grads(p, x, g, True, True),
                             "bwd"),
                 "bwd_x": inst(lambda p, x, g: grads(p, x, g, True,
                                                     False)[0], "bwd_x"),
                 "bwd_w": inst(lambda p, x, g: grads(p, x, g, False,
                                                     True)[1], "bwd_w")}
    with _PROG_LOCK:
        # a concurrent builder may have won the race: keep ITS programs
        progs = _PROGRAM_CACHE.setdefault(key, progs)
    return progs


# One lock per device: stages that share a card take turns on it
_DEVICE_LOCKS: Dict[str, threading.Lock] = {}  # guarded-by: _PROG_LOCK


def _device_lock(device) -> threading.Lock:
    with _PROG_LOCK:
        return _DEVICE_LOCKS.setdefault(str(device), threading.Lock())


def _tie_slot_bytes(cfg, pcfg: PipelineConfig) -> int:
    """A slot that holds the tied table's gradient (param dtype) with
    room for its header or pickle."""
    import torch

    esize = torch.empty((), dtype=cfg.param_dtype).element_size()
    return max(pcfg.slot_bytes, cfg.vocab_size * cfg.d_model * esize
               + (1 << 16))


def _channel_geometry(cfg, pcfg: PipelineConfig, path: str
                      ) -> Tuple[int, int]:
    """(slot_bytes, nslots) of the channel at ``path``: the tied-table
    exchange carries one table a step each way; the activation and
    gradient edges use the config's ring."""
    if os.path.basename(path).startswith("tie_"):
        return _tie_slot_bytes(cfg, pcfg), 1
    return pcfg.slot_bytes, pcfg.nslots


class StageRuntime:
    """One pipeline stage: its programs, params, optimizer and schedule.

    Transport-agnostic: the threads transport runs it on a dedicated
    thread (one per gang, the stage on ``cuda:<stage % cards>``); the
    actors transport inside a runtime actor (its own card or share of
    one).  All mutable state is owned by the thread driving run_step;
    cross-thread traffic goes through shm channels and the transport's
    queues.

    ``tx`` is an optimizer factory (``models.training.OptimizerFactory``)
    over the stage's param leaves; ``opt_state`` an optimizer
    ``state_dict()`` to start from.
    """

    def __init__(self, cfg, pcfg: PipelineConfig, stage: int, stage_params,
                 tx=None, opt_state=None, device=None,
                 telemetry: bool = False, vault_tag: Optional[str] = None,
                 restore=None, grad_sync=None, incarnation: int = 0):
        import torch

        from ray_tpu_torch._device import resolve_device

        self.cfg = cfg
        self.pcfg = pcfg
        self.stage = stage
        self.stages = pcfg.stages
        self.M = pcfg.num_microbatches
        self._schedule = get_schedule(pcfg.schedule)
        self._zb = self._schedule.split_backward
        self._device = resolve_device(device)
        if self._device.type == "cuda":
            if self._device.index is None:   # an actor's own card
                self._device = torch.device("cuda",
                                            torch.cuda.current_device())
            # "cuda" in this thread (a channel's reader, the caching
            # allocator) is the stage's card
            torch.cuda.set_device(self._device)
        self._lock = _device_lock(self._device)
        if restore is not None:
            # fold the lost gang's state back from its emergency shard
            payload = restore.load()[0]
            stage_params = payload["params"]
            opt_state = payload["opt_state"]
        # the stage's own leaves: never views of the caller's tensors,
        # and leaves autograd can take gradients for
        self._params = _tree_map(
            lambda t: torch.as_tensor(t).detach().to(
                device=self._device, dtype=cfg.param_dtype,
                copy=True).requires_grad_(), stage_params)
        self._leaves = [t for _, t in _flatten(self._params)[0]]
        self._opt = tx(self._leaves) if tx is not None else None
        if self._opt is not None and opt_state is not None:
            self._opt.load_state_dict(opt_state)
        self._committed = (-1, self._state_copy())
        self._grad_sync = grad_sync
        if grad_sync is None and pcfg.grad_sync_group:
            from ray_tpu_torch.parallel.sharding import GradientSynchronizer

            self._grad_sync = GradientSynchronizer(
                group_name=f"{pcfg.grad_sync_group}-s{stage}")
        self._ckpt = None
        if vault_tag:
            from ray_tpu_torch.elastic.emergency import EmergencyCheckpointer

            self._ckpt = EmergencyCheckpointer(
                vault_tag, rank=stage, world_size=self.stages,
                replication_factor=(1 if pcfg.transport == "actors" else 0),
                keep_steps=2, snapshot_every=pcfg.snapshot_every)
        self._vault_tag = vault_tag
        self._timer = None
        if telemetry:
            from ray_tpu_torch.telemetry.recorder import StepTimer

            self._timer = StepTimer(rank=stage, incarnation=incarnation)
        self._chans: Dict[str, Any] = {}
        self._epoch = -1
        progs = _stage_programs(cfg, stage, self.stages)
        self._fwd = progs["fwd"]
        self._bwd = progs["bwd"]
        self._bwd_x = progs["bwd_x"]
        self._bwd_w = progs["bwd_w"]

    # -- state ---------------------------------------------------------------

    def _state_copy(self):
        """(a clone of every param, a deep copy of the optimizer state):
        what a commit keeps, since the update runs in place."""
        params = _tree_map(lambda t: t.detach().clone(), self._params)
        opt = (copy.deepcopy(self._opt.state_dict())
               if self._opt is not None else None)
        return params, opt

    def _sync(self):
        if self._device.type == "cuda":
            import torch

            torch.cuda.synchronize(self._device)

    # -- channels -----------------------------------------------------------

    def connect(self, paths: Dict[str, str], epoch: int):
        """(Re-)open this stage's channel endpoints for `epoch` (recovery
        bumps the epoch so survivors drop closed rings and re-attach)."""
        if epoch == self._epoch and self._chans:
            return
        from ray_tpu_torch.dag.channel import Channel

        self.disconnect()
        self._chans = {
            k: Channel(p, *_channel_geometry(self.cfg, self.pcfg, p))
            for k, p in paths.items()}
        self._epoch = epoch

    def disconnect(self):
        for ch in self._chans.values():
            try:
                ch.release()
            except Exception:
                pass
        self._chans = {}

    def abort_step(self):
        """A peer died mid-step: drop partial state, restore the commit
        (copied back into the live tensors, which the optimizer holds)."""
        import torch

        params, opt = self._committed[1]
        with self._lock, torch.no_grad():
            for t, (_, c) in zip(self._leaves, _flatten(params)[0]):
                t.copy_(c)
            if self._opt is not None:
                self._opt.load_state_dict(copy.deepcopy(opt))
        self.disconnect()
        if self._timer is not None:
            # discard the partial step (a fresh step_start resets phases)
            self._timer.step_start(None)

    # -- the scheduler loop --------------------------------------------------

    def run_step(self, step: int, mbs_in=None, mbs_tgt=None,
                 apply_update: bool = True, return_grads: bool = False,
                 fail_at: Optional[int] = None,
                 deadline_s: float = 180.0) -> Dict[str, Any]:
        import torch

        from ray_tpu_torch.dag.channel import (TAG_ERROR, TAG_STOP,
                                               ChannelClosed, ChannelTimeout)
        from ray_tpu_torch.ops import _kernels

        n, s, M = self.stages, self.stage, self.M
        first, last = s == 0, s == n - 1
        deadline = time.monotonic() + deadline_s
        ev: List[Dict[str, Any]] = []
        stash: Dict[int, Any] = {}
        gstash: Dict[int, Any] = {}
        tgts: Dict[int, Any] = {}
        pending_w: "collections.deque[int]" = collections.deque()
        acc: Dict[str, Any] = {}
        launches: Dict[str, Dict[str, int]] = {}
        loss_sum = 0.0
        p2p_bytes = 0
        peak_stash = 0
        if self._timer is not None:
            self._timer.step_start(step)

        def put(x):
            return torch.as_tensor(x).to(self._device)

        def record(kind, mb, t0, t1, **kw):
            ev.append({"kind": kind, "mb": mb, "t0": t0,
                       "dur": t1 - t0, **kw})

        def compute(kind, mb, fn, *args, then=None):
            """One op on the stage's device, alone there: its duration
            and the launches it made.  ``then(out)`` runs after the timed
            op, still alone on the device (the gradient accumulation), so
            no other stage's op or copy meets its kernels."""
            with self._lock:
                before = _kernels.device_launch_counts(self._device)
                t0 = time.perf_counter()
                out = fn(*args)
                self._sync()
                t1 = time.perf_counter()
                after = _kernels.device_launch_counts(self._device)
                if then is not None:
                    then(out)
                    self._sync()
            if mb is not None:
                record(kind, mb, t0, t1)
            got = launches.setdefault(kind, {})
            for k, v in after.items():
                got[k] = got.get(k, 0) + v - before[k]
            return out

        def accumulate(dp):
            if not acc:
                acc.update(_flatten(dp)[0])
                return
            for k, g in _flatten(dp)[0]:
                acc[k].add_(g)

        def run_w(mb):
            g = gstash.pop(mb)
            x = stash.pop(mb)
            compute("W", mb, self._bwd_w, self._params, x, g,
                    then=accumulate)

        def check_deadline():
            if time.monotonic() > deadline:
                raise ChannelTimeout(
                    f"stage {s} step {step} exceeded {deadline_s}s")

        def recv(chan, kind, mb):
            """Poll-read so channel waits are measured as idle (and, for
            zb, filled with pending W work) apart from the copy of the
            successful read."""
            t_wait0 = time.perf_counter()
            while True:
                # timeout 0 = immediate check: a successful read's
                # duration is the copy alone, never a peer's wait; taken
                # alone on the device, its host -> device copy waits for
                # no other stage's kernels
                with self._lock:
                    t0 = time.perf_counter()
                    try:
                        tag, val = chan.read(timeout_s=0.0)
                        t1 = time.perf_counter()
                        break
                    except ChannelTimeout:
                        pass
                if self._zb and pending_w:
                    run_w(pending_w.popleft())
                else:
                    time.sleep(0.0002)
                check_deadline()
            waited = t0 - t_wait0
            if tag == TAG_ERROR:
                raise val if isinstance(val, BaseException) \
                    else RuntimeError(str(val))
            if tag == TAG_STOP:
                raise ChannelClosed(chan.path)
            if waited > 1e-6:
                ev.append({"kind": "wait", "mb": mb, "t0": t_wait0,
                           "dur": waited})
            record(kind, mb, t0, t1)
            return val

        def send(chan, val, kind, mb):
            """Poll-write: backpressure from a full ring is idle, not
            p2p, and zb fills it with W work too."""
            nonlocal p2p_bytes
            t_wait0 = time.perf_counter()
            while True:
                with self._lock:    # the device -> shm copy, alone
                    t0 = time.perf_counter()
                    try:
                        chan.write(val, timeout_s=0.0)
                        t1 = time.perf_counter()
                        break
                    except ChannelTimeout:
                        pass
                if self._zb and pending_w:
                    run_w(pending_w.popleft())
                else:
                    time.sleep(0.0002)
                check_deadline()
            waited = t0 - t_wait0
            if waited > 1e-6:
                ev.append({"kind": "wait", "mb": mb, "t0": t_wait0,
                           "dur": waited})
            nb = int(val.numel() * val.element_size())
            record(kind, mb, t0, t1, bytes=nb)
            p2p_bytes += nb

        ops = self._schedule.ops(s, n, M)
        for op_idx, (kind, mb) in enumerate(ops):
            if fail_at is not None and op_idx == fail_at:
                raise RuntimeError(
                    f"injected gang failure: stage {s} step {step} "
                    f"op {op_idx} ({kind}{mb})")
            if kind == "F":
                if first:
                    x = put(mbs_in[mb])
                else:
                    x = put(recv(self._chans["in"], "recv_f", mb))
                stash[mb] = x
                peak_stash = max(peak_stash, len(stash))
                if last:
                    tgts[mb] = put(mbs_tgt[mb])
                    loss = compute("F", mb, self._fwd, self._params, x,
                                   tgts[mb])
                    loss_sum += float(loss)
                else:
                    y = compute("F", mb, self._fwd, self._params, x)
                    send(self._chans["out"], y, "send_f", mb)
            elif kind == "B":
                if last:
                    g = tgts.pop(mb)
                else:
                    g = put(recv(self._chans["gin"], "recv_b", mb))
                x = stash.pop(mb)
                if last or not first:  # the last stage returns (dx, dp)
                    dx, _ = compute("B", mb, self._bwd, self._params, x, g,
                                    then=lambda out: accumulate(out[1]))
                else:
                    compute("B", mb, self._bwd, self._params, x, g,
                            then=accumulate)
                    dx = None
                if not first:
                    send(self._chans["gout"], dx, "send_b", mb)
            elif kind == "Bx":
                if last:
                    g = tgts.pop(mb)
                else:
                    g = put(recv(self._chans["gin"], "recv_b", mb))
                gstash[mb] = g
                if self._bwd_x is not None:
                    dx = compute("Bx", mb, self._bwd_x, self._params,
                                 stash[mb], g)
                else:
                    record("Bx", mb, time.perf_counter(),
                           time.perf_counter())
                if not first:
                    send(self._chans["gout"], dx, "send_b", mb)
                pending_w.append(mb)
            else:  # "W": skip if an idle-fill already ran it
                if pending_w:
                    run_w(pending_w.popleft())

        # -- step finalize: grad average, tied-embed exchange, sync, apply
        keys, rebuild = _flatten(self._params)
        grads = rebuild([acc[k] / M for k, _ in keys])
        if self.cfg.tie_embeddings and n > 1 and (first or last):
            # both end stages hold the tied table; exchange partials so
            # each applies the TOTAL grad and the copies stay identical
            if last:
                send(self._chans["tie_out"], grads["embed"], "send_tie", -1)
                grads["embed"] = put(recv(self._chans["tie_in"],
                                          "recv_tie", -1))
            else:
                partial = put(recv(self._chans["tie_in"], "recv_tie", -1))
                grads["embed"] = grads["embed"] + partial
                send(self._chans["tie_out"], grads["embed"], "send_tie", -1)
        if self._grad_sync is not None:
            grads = self._grad_sync(grads)
        loss = (loss_sum / M) if last else None
        if apply_update and self._opt is not None:
            def update():
                for t, (_, g) in zip(self._leaves, _flatten(grads)[0]):
                    t.grad = g
                self._opt.step()
                for t in self._leaves:
                    t.grad = None

            compute("update", None, update)
        if apply_update:
            self._committed = (step, self._state_copy())
            if self._ckpt is not None:
                self._ckpt.snapshot(
                    {"pipeline": self._vault_tag, "stage": s,
                     "step": step,
                     "params": _tree_map(lambda t: t.detach(),
                                         self._params),
                     "opt_state": (self._opt.state_dict()
                                   if self._opt is not None else None)},
                    step=step)

        def total(*kinds):
            return sum(e["dur"] for e in ev if e["kind"] in kinds)

        fwd_t = total("F")
        bwd_t = total("B", "Bx")
        bwd_w_t = total("W")
        p2p_t = sum(e["dur"] for e in ev
                    if e["kind"].startswith(("send_", "recv_")))
        idle_t = total("wait")
        if self._timer is not None:
            self._timer.add_phase_time("pipeline", fwd_t + bwd_t + bwd_w_t
                                       + p2p_t + idle_t)
            self._timer.add_phase_time("pipeline.fwd", fwd_t)
            self._timer.add_phase_time("pipeline.bwd", bwd_t)
            self._timer.add_phase_time("pipeline.bwd_w", bwd_w_t)
            self._timer.add_phase_time("pipeline.p2p", p2p_t)
            self._timer.add_phase_time("pipeline.idle", idle_t)
            self._timer.step_end(step)

        res: Dict[str, Any] = {
            "stage": s, "step": step, "loss": loss, "events": ev,
            "p2p_bytes": p2p_bytes, "peak_stash": peak_stash,
            "launches": launches,
            "phase_s": {"fwd": fwd_t, "bwd": bwd_t, "bwd_w": bwd_w_t,
                        "p2p": p2p_t, "idle": idle_t},
        }
        if self._timer is not None:
            res["telemetry"] = self._timer.snapshot()
        if return_grads:
            res["grads"] = _tree_map(lambda g: g.detach().cpu(), grads)
        return res

    def committed_step(self) -> int:
        return self._committed[0]

    def wait_snapshot(self, timeout: float = 10.0) -> bool:
        return self._ckpt.wait_idle(timeout) if self._ckpt else True

    def close(self):
        self.disconnect()
        if self._ckpt is not None:
            self._ckpt.stop()


# ---------------------------------------------------------------------------
# Threads transport: one scheduler thread per gang


class _StageThread:
    """Thread-transport gang handle.  Commands flow through Queues; the
    runtime itself is owned by the scheduler thread alone.  A generic
    exception kills the gang (the runtime is dropped, modeling host
    loss); ChannelClosed means a PEER died: the gang aborts the step,
    restores its commit, and waits for a new epoch."""

    def __init__(self, stage: int, make_runtime: Callable[[], StageRuntime]):
        self.stage = stage
        self._make = make_runtime
        self._inbox: "queue.Queue" = queue.Queue()
        self._outbox: "queue.Queue" = queue.Queue()
        self._runtime: Optional[StageRuntime] = None
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"mpmd-stage{stage}")
        self._thread.start()

    def _loop(self):
        from ray_tpu_torch.dag.channel import ChannelClosed

        try:
            self._runtime = self._make()
        except BaseException as e:  # noqa: BLE001 — report, don't hang
            self._outbox.put(("failed", -1, e))
            return
        self._outbox.put(("ready", -1, None))
        while True:
            cmd = self._inbox.get()
            if cmd[0] == "stop":
                self._runtime.close()
                self._outbox.put(("stopped", -1, None))
                return
            _, step, paths, epoch, kwargs = cmd
            try:
                self._runtime.connect(paths, epoch)
                res = self._runtime.run_step(step, **kwargs)
                self._outbox.put(("ok", step, res))
            except ChannelClosed as e:
                self._runtime.abort_step()
                self._outbox.put(("aborted", step, e))
            except BaseException as e:  # noqa: BLE001 — gang death
                rt, self._runtime = self._runtime, None
                try:
                    rt.disconnect()
                except Exception:
                    pass
                self._outbox.put(("failed", step, e))
                return

    def submit(self, step, paths, epoch, kwargs):
        self._inbox.put(("step", step, paths, epoch, kwargs))

    def stop(self):
        if self._thread.is_alive():
            self._inbox.put(("stop",))

    def result(self, timeout: float):
        return self._outbox.get(timeout=timeout)

    def kill(self):
        """The gang is gone already (its thread ended on the failure)."""

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()


# ---------------------------------------------------------------------------
# Actors transport: one runtime actor per gang.  Defined lazily so
# importing mpmd never requires a cluster.

_STAGE_ACTOR_CLS = None


def _stage_actor_cls():
    global _STAGE_ACTOR_CLS
    if _STAGE_ACTOR_CLS is not None:
        return _STAGE_ACTOR_CLS
    import ray_tpu_torch

    @ray_tpu_torch.remote
    class MPMDStageActor:
        """Per-gang scheduler actor: owns one StageRuntime and drives its
        schedule; activations and grads ride shm channels, NOT actor
        RPC."""

        def __init__(self, kw):
            t0 = time.time()
            self._rt = StageRuntime(**kw)
            self._built = (t0, time.time(), os.getpid())

        def built(self):
            """(wall time the runtime's build began, ended; pid)."""
            return self._built

        def run_step(self, step, paths, epoch, kwargs):
            from ray_tpu_torch.dag.channel import ChannelClosed

            try:
                self._rt.connect(paths, epoch)
                res = self._rt.run_step(step, **kwargs)
                return ("ok", step, res)
            except ChannelClosed as e:
                self._rt.abort_step()
                return ("aborted", step, repr(e))

        def vault_inventory(self):
            from ray_tpu_torch.elastic import emergency

            return emergency._inventory()

        def vault_fetch(self, step, stage):
            from ray_tpu_torch.elastic import emergency

            return emergency._fetch(step, stage)

        def wait_snapshot(self, timeout=10.0):
            return self._rt.wait_snapshot(timeout)

        def close(self):
            self._rt.close()
            return True

    _STAGE_ACTOR_CLS = MPMDStageActor
    return MPMDStageActor


class _StageActorHandle:
    def __init__(self, stage: int, runtime_kwargs: Dict[str, Any],
                 actor_options: Dict[str, Any]):
        self.stage = stage
        cls = _stage_actor_cls()
        if actor_options:
            cls = cls.options(**actor_options)
        self._actor = cls.remote(runtime_kwargs)
        self._pending = None

    def submit(self, step, paths, epoch, kwargs):
        self._pending = self._actor.run_step.remote(step, paths, epoch,
                                                    kwargs)

    def result(self, timeout: float):
        import ray_tpu_torch

        try:
            return ray_tpu_torch.get(self._pending, timeout=timeout)
        except ray_tpu_torch.GetTimeoutError:
            raise queue.Empty() from None  # still running: poll again
        except Exception as e:
            return ("failed", -1, e)  # actor death / RPC error = gang loss

    def stop(self):
        import ray_tpu_torch

        try:
            ray_tpu_torch.get(self._actor.close.remote(), timeout=10)
        except Exception:
            pass
        self.kill()

    def kill(self):
        """End the actor (its card share goes back to the cluster)."""
        import ray_tpu_torch

        try:
            ray_tpu_torch.kill(self._actor)
        except Exception:
            pass

    @property
    def alive(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# Driver


class MPMDPipeline:
    """Driver for an MPMD pipeline over ``models/gpt.py``.

    Partitions params into per-stage trees (partition_stage_params),
    spawns one gang per stage (threads or actors transport), wires
    activation/grad channels, and drives steps.

    params: the whole tree (default ``gpt.init(cfg, seed=seed)``); the
        pipeline keeps a host copy of each stage's slice, and each stage
        its own copy on its device.
    tx: an optimizer factory (``models.training.adamw(...)``), built per
        stage over its leaves; None runs no update.
    device: where the stages run: None is the card (each thread-transport
        stage on ``cuda:<stage % cards>``, each actor on its own card or
        share), "cpu" the host (tests).
    actor_options: the stage actors' options (default ``{"num_gpus": 1}``
        on the card; ``{"num_gpus": 0.5}`` puts two stages on one card).
    """

    def __init__(self, cfg, pcfg: PipelineConfig, params=None, seed: int = 0,
                 tx=None, telemetry: bool = False, base_dir: Optional[str]
                 = None, grad_sync_factory: Optional[Callable[[int], Any]]
                 = None, auto_recover: bool = True, device=None,
                 actor_options: Optional[Dict[str, Any]] = None):
        import torch

        from ray_tpu_torch._device import resolve_device
        from ray_tpu_torch.models import gpt

        self._device = resolve_device(device)
        if params is None:
            params = gpt.init(cfg, seed=seed, device=self._device)
        self.cfg = cfg
        self.pcfg = pcfg
        self.M = pcfg.num_microbatches
        self._tx = tx
        self._telemetry = telemetry
        self._grad_sync_factory = grad_sync_factory
        self._auto_recover = auto_recover
        self._actor_options = (
            dict(actor_options) if actor_options is not None
            else ({"num_gpus": 1} if self._device.type == "cuda" else {}))
        self._tag = f"mpmd-{os.getpid()}-{id(self) & 0xffff:x}"
        root = base_dir
        if root is None:
            shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
            root = tempfile.mkdtemp(prefix="mpmd-", dir=shm)
            self._owns_dir = True
        else:
            os.makedirs(root, exist_ok=True)
            self._owns_dir = False
        self._dir = root
        self._epoch = 0
        self._last_step = -1
        self._last_results: List[Dict[str, Any]] = []
        self._fail_next: Dict[int, int] = {}
        # host copies: the caller may go on updating its tensors in place
        self._init_state = [
            _tree_map(lambda t: torch.as_tensor(t).detach().to(
                "cpu", copy=True), st)
            for st in gpt.partition_stage_params(params, cfg, pcfg.stages)]
        self._reg_lock = threading.Lock()
        self._runtimes: Dict[int, StageRuntime] = {}  # guarded-by: _reg_lock
        self._handles: List[Any] = [
            self._spawn(s, self._init_state[s], restore=None)
            for s in range(pcfg.stages)]
        if self.pcfg.transport == "threads":
            for h in self._handles:
                self._wait_ready(h, "failed to start")

    # -- gang lifecycle ----------------------------------------------------

    def _stage_device(self, stage: int) -> str:
        if self._device.type != "cuda":
            return str(self._device)
        if self.pcfg.transport == "actors":
            return "cuda"   # the actor's own card
        import torch

        return f"cuda:{stage % torch.cuda.device_count()}"

    def _runtime_kwargs(self, stage: int, stage_params, restore):
        return dict(
            cfg=self.cfg, pcfg=self.pcfg, stage=stage,
            stage_params=stage_params, tx=self._tx,
            device=self._stage_device(stage),
            telemetry=self._telemetry, vault_tag=self._tag,
            restore=restore, incarnation=self._epoch)

    def _spawn(self, stage: int, stage_params, restore):
        if self.pcfg.transport == "actors":
            return _StageActorHandle(
                stage, self._runtime_kwargs(stage, stage_params, restore),
                self._actor_options)

        def make(stage=stage, restore=restore):
            grad_sync = (self._grad_sync_factory(stage)
                         if self._grad_sync_factory else None)
            rt = StageRuntime(grad_sync=grad_sync,
                              **self._runtime_kwargs(stage, stage_params,
                                                     restore))
            with self._reg_lock:
                self._runtimes[stage] = rt
            return rt

        return _StageThread(stage, make)

    @staticmethod
    def _wait_ready(handle, what: str):
        status, _, err = handle.result(timeout=300.0)
        if status != "ready":
            raise RuntimeError(f"stage {handle.stage} {what}") from err

    def _paths(self, stage: int) -> Dict[str, str]:
        d = os.path.join(self._dir, f"e{self._epoch}")
        os.makedirs(d, exist_ok=True)
        n = self.pcfg.stages
        p: Dict[str, str] = {}
        if stage > 0:
            p["in"] = os.path.join(d, f"act{stage - 1}")
            p["gout"] = os.path.join(d, f"grad{stage - 1}")
        if stage < n - 1:
            p["out"] = os.path.join(d, f"act{stage}")
            p["gin"] = os.path.join(d, f"grad{stage}")
        if self.cfg.tie_embeddings and n > 1:
            if stage == n - 1:
                p["tie_out"] = os.path.join(d, "tie_a")
                p["tie_in"] = os.path.join(d, "tie_b")
            elif stage == 0:
                p["tie_in"] = os.path.join(d, "tie_a")
                p["tie_out"] = os.path.join(d, "tie_b")
        return p

    def _close_epoch_channels(self):
        """Wake every gang blocked on an epoch-e channel (recovery)."""
        from ray_tpu_torch.dag.channel import Channel

        d = os.path.join(self._dir, f"e{self._epoch}")
        if not os.path.isdir(d):
            return
        for name in os.listdir(d):
            path = os.path.join(d, name)
            try:
                ch = Channel(path, *_channel_geometry(self.cfg, self.pcfg,
                                                      path))
                ch.close()
                ch.release()
            except Exception:
                pass

    # -- stepping ----------------------------------------------------------

    def _split(self, batch):
        from .pipeline import split_microbatches

        if "inputs" in batch:
            inputs, targets = batch["inputs"], batch["targets"]
        else:
            toks = batch["tokens"]
            inputs, targets = toks[:, :-1], toks[:, 1:]
        inp = split_microbatches(inputs, self.M)
        tgt = split_microbatches(targets, self.M)
        if self.pcfg.transport == "actors":
            # the microbatches cross processes: as host tensors
            import torch

            inp, tgt = (torch.as_tensor(inp).cpu(),
                        torch.as_tensor(tgt).cpu())
        return ([inp[i] for i in range(self.M)],
                [tgt[i] for i in range(self.M)])

    def inject_failure(self, stage: int, op_index: int = 0):
        """Kill stage's gang at op_index of the NEXT step (tests/bench:
        proves a lost gang folds back from emergency checkpoints)."""
        self._fail_next[stage] = op_index

    def step(self, batch, apply_update: bool = True,
             return_grads: bool = False, deadline_s: float = 180.0,
             _retry: bool = False) -> Dict[str, Any]:
        step = self._last_step + 1
        mbs_in, mbs_tgt = self._split(batch)
        n = self.pcfg.stages
        for s, h in enumerate(self._handles):
            kwargs = dict(apply_update=apply_update,
                          return_grads=return_grads,
                          deadline_s=deadline_s,
                          fail_at=self._fail_next.pop(s, None))
            if s == 0:
                kwargs["mbs_in"] = mbs_in
            if s == n - 1:
                kwargs["mbs_tgt"] = mbs_tgt
            h.submit(step, self._paths(s), self._epoch, kwargs)
        statuses: List[Optional[Tuple]] = [None] * n
        t_end = time.monotonic() + deadline_s + 30.0
        failed: List[int] = []
        while any(st is None for st in statuses):
            for s, h in enumerate(self._handles):
                if statuses[s] is not None:
                    continue
                try:
                    out = h.result(timeout=0.2)
                except queue.Empty:
                    continue
                statuses[s] = out
                if out[0] == "failed":
                    failed.append(s)
                    # wake peers blocked on this gang's channels so they
                    # abort instead of timing out
                    self._close_epoch_channels()
            if time.monotonic() > t_end:
                raise TimeoutError(
                    f"pipeline step {step} stuck; statuses="
                    f"{[st and st[0] for st in statuses]}")
        if failed:
            if any(st[0] == "ok" for st in statuses):
                # a gang already committed this step while another died:
                # rolling the committed gang back is not supported, so
                # surface it rather than silently diverge
                raise RuntimeError(
                    f"unrecoverable: gang(s) {failed} died after "
                    f"{sum(st[0] == 'ok' for st in statuses)} gang(s) "
                    f"committed step {step}")
            if _retry or not self._auto_recover:
                errs = [statuses[s][2] for s in failed]
                raise RuntimeError(
                    f"stage gang(s) {failed} died: {errs}") from errs[0]
            self.recover(failed)
            return self.step(batch, apply_update=apply_update,
                             return_grads=return_grads,
                             deadline_s=deadline_s, _retry=True)
        aborted = [s for s, st in enumerate(statuses) if st[0] != "ok"]
        if aborted:
            raise RuntimeError(
                f"gang(s) {aborted} aborted step {step} without a "
                f"detected failure: {[statuses[s][2] for s in aborted]}")
        results = [st[2] for st in statuses]
        self._last_step = step
        self._last_results = results
        out: Dict[str, Any] = {
            "step": step,
            "loss": results[-1]["loss"],
            "p2p_bytes": sum(r["p2p_bytes"] for r in results),
            "peak_stash": [r["peak_stash"] for r in results],
            "events": [r["events"] for r in results],
            "launches": [r["launches"] for r in results],
            "recovered": _retry,
        }
        if return_grads:
            from ray_tpu_torch.models import gpt

            out["grads"] = gpt.merge_stage_trees(
                [r["grads"] for r in results], self.cfg, grads=True,
                tie_summed=True)  # the step's exchange already totalled it
        return out

    def forward_backward(self, batch) -> Tuple[float, Any]:
        """One no-update pass: (loss, the whole gradient tree on the
        host), the parity surface against loss_fn and its gradients."""
        res = self.step(batch, apply_update=False, return_grads=True)
        return res["loss"], res["grads"]

    # -- elastic recovery --------------------------------------------------

    def recover(self, dead_stages: List[int]):
        """Respawn dead gangs from their freshest emergency shards; the
        survivors already rolled back to the committed step when their
        channels closed.  Channels are rebuilt under a new epoch."""
        from ray_tpu_torch.elastic import emergency
        from ray_tpu_torch.elastic.emergency import EmergencyCheckpoint

        step = self._last_step
        self._close_epoch_channels()
        self._epoch += 1
        for s in dead_stages:
            restore = None
            with self._reg_lock:
                rt = self._runtimes.pop(s, None)
            if rt is not None:
                rt.wait_snapshot(10.0)
            if step >= 0:
                payload = emergency._fetch(step, s)
                if payload is None and self.pcfg.transport == "actors":
                    import ray_tpu_torch

                    # the dead gang's shard lives in its ring successors'
                    # vaults (EmergencyCheckpointer peer replication)
                    for h in self._handles:
                        if h.stage == s:
                            continue
                        try:
                            payload = ray_tpu_torch.get(
                                h._actor.vault_fetch.remote(step, s),
                                timeout=30)
                        except Exception:
                            continue
                        if payload is not None:
                            break
                if payload is not None:
                    restore = EmergencyCheckpoint(step, self.pcfg.stages,
                                                  {s: payload})
            if restore is None and step >= 0:
                raise RuntimeError(
                    f"no emergency shard for stage {s} at step {step}")
            # a dead actor may still hold its card share
            self._handles[s].kill()
            self._handles[s] = self._spawn(s, self._init_state[s], restore)
            if self.pcfg.transport == "threads":
                self._wait_ready(self._handles[s], "respawn failed")

    # -- reporting ---------------------------------------------------------

    def bubble_report(self) -> Dict[str, Any]:
        """Measured (virtual-replay) bubble of the LAST step vs the
        fill-drain theoretical floor at the same (n, M)."""
        if not self._last_results:
            raise RuntimeError("no step recorded yet")
        rep = replay_bubble([r["events"] for r in self._last_results])
        rep["theoretical_fill_drain"] = \
            PipelineSchedule.theoretical_fill_drain_bubble(
                self.pcfg.stages, self.M)
        rep["schedule"] = self.pcfg.schedule
        return rep

    def chrome_trace(self) -> List[Dict[str, Any]]:
        if not self._last_results:
            return []
        return schedule_chrome_trace(
            [r["events"] for r in self._last_results])

    def telemetry_snapshots(self) -> List[Dict[str, Any]]:
        return [r["telemetry"] for r in self._last_results
                if "telemetry" in r]

    def close(self):
        for h in self._handles:
            try:
                h.stop()
            except Exception:
                pass
        if self.pcfg.transport == "threads":
            for h in self._handles:
                try:
                    h.result(timeout=10.0)
                except Exception:
                    pass
        if self._owns_dir:
            shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
