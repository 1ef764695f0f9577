"""Podracer architectures: Anakin and Sebulba (arXiv 2104.06272).

The port of ``ray_tpu/rl/podracer.py``: two actor–learner topologies
over the IMPALA V-trace learner (rl/algorithms/impala.py), on the card
unless a config asks for the CPU:

  * **Anakin** — the single-gang form: environment stepping and the
    learner update live on one device; the whole training run is one
    loop of (rollout -> V-trace update) that issues device work only,
    with no host round-trip per update, and keeps its metrics on the
    device until the end.  The speed-of-light baseline.

  * **Sebulba** — the decomposed form and the hard one: N *elastic*
    actor gangs step vectorized ``jax_env`` environments and stream
    fixed-shape trajectory batches to a learner gang over the
    streaming-generator protocol (bounded in-flight window with
    explicit backpressure, per-batch ``policy_version`` stamps).
    V-trace clips the importance weights, so the learner absorbs the
    bounded staleness — which is exactly what lets actor gangs die,
    drain, and regrow without ever stalling the learner.

Determinism under chaos — the design invariant everything else hangs
off: consumption is round-robin over ``num_gangs`` FIXED logical slots
(update ``t`` consumes slot ``t % G``, sequence ``t // G``), every
batch is produced from a FRESH per-batch env carry with
``rng = fold_in(sample_seed, slot * 1_000_003 + seq)`` (a stable hash,
the same in every process) and the params at exactly
``policy_version = max(0, t - staleness_bound)``.  Batch content is
therefore a pure function of (seed, slot, seq, params-history) — a
replacement gang (incarnation + 1) regenerates, bit for bit, the
batches its dead predecessor owed, so the final learner params depend
only on the seed, never on the chaos schedule.  On the card that holds
because every op of a batch and of an update is deterministic there (no
atomics: ``rl_module.take_action_logp``) and every process computes f32
matmuls alike (a gang takes the driver's TF32 setting).

``ChaosSchedule`` turns the run into a sustained chaos workload: hard
actor-gang kills (the streaming consumer surfaces ``ActorDiedError``
instead of hanging), ``straggler_multiple``-tripping slowdowns
(StepAggregator detects, RemediationEngine quarantines, the respawn
sheds the slow host), and preemption notices (PreemptionWatcher ->
``report_draining`` -> graceful retire) — while goodput-predicted
resume width (elastic/resume.py) and run-state goodput publishing (the
autoscaler GoodputPolicy's input) act on every recovery.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .core.rl_module import to_numpy_params as _to_numpy
from .core.rl_module import tree_leaves

logger = logging.getLogger(__name__)


def params_digest(params) -> str:
    """Stable content hash of a params tree (bitwise-reproducibility
    checks across chaos runs).  Leaves in the JAX tree's order (dict
    keys sorted, then list order), each with its numpy dtype name and
    shape, so the digest of params carried over from the JAX package
    equals that package's digest of them."""
    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        a = leaf.detach().cpu().numpy() if hasattr(leaf, "detach") \
            else np.asarray(leaf)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _learner_factory(env_spec: Dict[str, Any], hidden: Tuple[int, ...],
                     hp: Dict[str, Any]):
    """Module-level so LearnerGroup's remote learner actors can pickle
    the factory by reference."""
    from .algorithms.impala import make_impala_learner

    return make_impala_learner(env_spec, hidden=tuple(hidden), **hp)


# ---------------------------------------------------------------------------
# Anakin: the whole training loop on the device
# ---------------------------------------------------------------------------


@dataclass
class AnakinConfig:
    env_name: str = "CartPole-v1"
    num_envs: int = 64
    rollout_len: int = 16
    num_updates: int = 100
    hidden: Tuple[int, ...] = (32, 32)
    lr: float = 3e-4
    gamma: float = 0.99
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    clip_rho: float = 1.0
    clip_c: float = 1.0
    seed: int = 0
    #: where it runs (None: the card)
    device: Optional[str] = None
    #: ``torch.cuda.set_sync_debug_mode`` for the timed call on a card
    #: ("error": any host sync inside it raises)
    sync_debug_mode: Optional[str] = None


def _synchronize(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_anakin(cfg: AnakinConfig) -> Dict[str, Any]:
    """Single-gang Podracer: ``num_updates`` x (rollout -> V-trace
    update) on one device, the analog of Anakin's replicated loop on a
    single host.  The loop issues device work only (no ``.item()``, no
    copy back, no branch on a tensor), so the host runs ahead of the
    card; the metrics stay stacked on the device until the end.  The run
    goes through the port's program ledger as ``rl.anakin.train``.
    Returns final params, per-update metric curves, and steady-state
    throughput (timed on a second call; ``compile_s`` is the first call's
    excess over it: the card's lazy setup, not a compile)."""
    import torch

    from .._device import resolve_device
    from ..telemetry import device as devtel
    from .algorithms.impala import make_impala_learner
    from .core.rl_module import make_generator
    from .env import jax_env

    device = resolve_device(cfg.device)
    env = jax_env.make_env(cfg.env_name)
    learner = make_impala_learner(
        env.spec, hidden=cfg.hidden, device=device, gamma=cfg.gamma,
        vf_coeff=cfg.vf_coeff, entropy_coeff=cfg.entropy_coeff,
        clip_rho=cfg.clip_rho, clip_c=cfg.clip_c, lr=cfg.lr, seed=cfg.seed)
    module = learner.module
    update_fn = learner._update_fn

    def train(params, opt_state, env_key: int, rng_key: int):
        # the env carry's generators are made here, so every call starts
        # from the same state (the reference's carry is immutable)
        env_carry = jax_env.init_carry(env, env_key, cfg.num_envs, device)
        up_rng = make_generator(rng_key, device)
        curves = []
        for _ in range(cfg.num_updates):
            env_carry, batch = jax_env.rollout(
                env, module.forward_exploration, params, env_carry,
                cfg.rollout_len)
            upd = {k: batch[k].transpose(0, 1)
                   for k in ("obs", "action", "reward", "done", "logp")}
            with torch.no_grad():
                upd["final_vf"] = module.value(params, env_carry[1])
            params, opt_state, metrics = update_fn(params, opt_state, upd,
                                                   up_rng)
            curves.append(metrics)
        return params, opt_state, {k: torch.stack([m[k] for m in curves])
                                   for k in curves[0]}

    # one program per Anakin run in the ledger; its first call is
    # recorded, the timed second call is not
    train = devtel.instrument(train, name="rl.anakin.train")
    args = (learner.params, learner.opt_state, cfg.seed + 1, cfg.seed + 17)

    t0 = time.monotonic()
    params, _, metrics = train(*args)
    _synchronize(device)
    first_s = time.monotonic() - t0
    debug = cfg.sync_debug_mode if device.type == "cuda" else None
    t1 = time.monotonic()
    if debug is not None:
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(debug)
    try:
        params, _, metrics = train(*args)   # same inputs, same result
    finally:
        if debug is not None:
            torch.cuda.set_sync_debug_mode(prev)
    _synchronize(device)
    run_s = max(time.monotonic() - t1, 1e-9)

    env_steps = cfg.num_updates * cfg.rollout_len * cfg.num_envs
    np_params = _to_numpy(params)
    np_metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
    return {
        "params": np_params,
        "params_digest": params_digest(np_params),
        "metrics": np_metrics,
        "final_loss": float(np_metrics["loss"][-1]),
        "env_steps": env_steps,
        "env_steps_per_s": env_steps / run_s,
        "updates_per_s": cfg.num_updates / run_s,
        "compile_s": max(first_s - run_s, 0.0),
        "run_s": run_s,
        "device": str(device),
        "sync_debug_mode": debug,
    }


# ---------------------------------------------------------------------------
# Chaos schedule
# ---------------------------------------------------------------------------


@dataclass
class ChaosEvent:
    at_update: int
    kind: str              # "kill" | "straggle" | "preempt"
    slot: int = 0
    #: straggle: injected per-batch delay seconds; preempt: grace_s
    value: float = 0.0


class ChaosSchedule:
    """Deterministic fault injections keyed to learner update indices.
    Seeded from ``RAY_TPU_TORCH_CHAOS_SEED`` so two runs of the same schedule
    inject the same faults — and the determinism invariant above means
    the learner params match bitwise anyway."""

    def __init__(self, events: Sequence[ChaosEvent] = ()):
        self.events: List[ChaosEvent] = sorted(events,
                                               key=lambda e: e.at_update)
        self.fired: List[ChaosEvent] = []
        self._i = 0

    def due(self, t: int) -> List[ChaosEvent]:
        out = []
        while self._i < len(self.events) \
                and self.events[self._i].at_update <= t:
            ev = self.events[self._i]
            self._i += 1
            self.fired.append(ev)
            out.append(ev)
        return out

    @classmethod
    def sustained(cls, num_updates: int, num_gangs: int, *,
                  kills: int = 1, stragglers: int = 1, preemptions: int = 1,
                  straggle_delay_s: float = 0.25, grace_s: float = 30.0,
                  seed: Optional[int] = None) -> "ChaosSchedule":
        """A sustained schedule: the requested faults spread evenly
        through the run, kinds and victim slots drawn from the chaos
        seed (env ``RAY_TPU_TORCH_CHAOS_SEED`` when ``seed`` is None)."""
        if seed is None:
            seed = int(os.environ.get("RAY_TPU_TORCH_CHAOS_SEED", "0"))
        rng = np.random.default_rng(seed)
        kinds = (["straggle"] * stragglers + ["kill"] * kills
                 + ["preempt"] * preemptions)
        rng.shuffle(kinds)
        span = max(1, num_updates // (len(kinds) + 1))
        events = []
        for i, kind in enumerate(kinds):
            events.append(ChaosEvent(
                at_update=span * (i + 1), kind=kind,
                slot=int(rng.integers(num_gangs)),
                value=straggle_delay_s if kind == "straggle" else grace_s))
        return cls(events)


# ---------------------------------------------------------------------------
# Sebulba: actor gangs streaming to the learner gang
# ---------------------------------------------------------------------------


@dataclass
class SebulbaConfig:
    env_name: str = "CartPole-v1"
    num_gangs: int = 2
    num_envs: int = 8
    rollout_len: int = 16
    num_updates: int = 24
    #: max learner-vs-behavior version lag a batch may carry; None ->
    #: 2 * num_gangs (one full round of run-ahead per gang)
    staleness_bound: Optional[int] = None
    #: streaming-generator backpressure: max unconsumed items in flight
    #: per gang stream
    window: int = 2
    #: a learner inter-batch wait above this counts as a stall
    #: (availability = fraction of waits under it)
    stall_bound_s: float = 30.0
    min_gangs: int = 1
    num_learners: int = 0          # 0 = in-process learner
    hidden: Tuple[int, ...] = (32, 32)
    lr: float = 3e-4
    gamma: float = 0.99
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    clip_rho: float = 1.0
    clip_c: float = 1.0
    seed: int = 0
    trial: str = "sebulba_00000"
    name: str = "podracer"
    #: wall floor per produced batch — stabilizes the straggler median
    #: on jittery CI hosts (0 = produce at full speed)
    min_produce_s: float = 0.0
    straggler_multiple: float = 2.0
    straggler_sustain: int = 2
    remediation_max_episodes: int = 1
    remediation_cooldown_s: float = 0.0
    remediation_effect_window: int = 2
    remediation_recover_tolerance: float = 0.15
    quarantine_grace_s: float = 30.0
    drain_grace_s: float = 30.0
    debounce_s: float = 0.0
    weights_wait_s: float = 120.0
    get_timeout_s: float = 120.0
    #: test hook: probe(stage, info) fires synchronously at probe points
    #: ("goodput_dip" after a death publishes a dipped goodput)
    probe: Optional[Callable[[str, Dict[str, Any]], None]] = None
    #: where the learner computes (None: the card)
    device: Optional[str] = None
    #: each gang's device, slot s taking ``gang_devices[s % len]``
    #: (None: the learner's device type, e.g. "cuda": the gang worker's
    #: first card); on four cards ("cuda:1", "cuda:2", "cuda:3") keeps
    #: the gangs off the learner's card 0.  A gang on a card asks the
    #: runtime for 1 / (num_gangs + 1) of a GPU: room for a replacement
    #: beside the live gangs
    gang_devices: Optional[Sequence[str]] = None


#: the CPUs a gang's lease holds, and its torch's intra-op threads
GANG_CPUS = 1


class _GangWorker:
    """One actor gang: vectorized env stepping on the gang's host,
    streaming fixed-shape batches.  Async control methods (put_weights /
    inject_delay / ping) run on the actor's event loop concurrently
    with the live ``stream()`` generator, which the worker drains on
    its stream-executor thread — weight pushes land WHILE a batch is
    being produced."""

    def __init__(self, slot: int, incarnation: int, start_seq: int,
                 spec: Dict[str, Any]):
        import torch

        from .core.rl_module import DiscretePolicyModule
        from .env import jax_env
        from .env.env_runner import use_cpu_threads

        if spec["device"].startswith("cuda"):
            # f32 matmuls as the driver computes them: the batches must
            # be the bits an in-process replay makes
            torch.backends.cuda.matmul.allow_tf32 = spec["allow_tf32"]
        use_cpu_threads(spec["num_cpus"])
        self._slot = int(slot)
        self._incarnation = int(incarnation)
        self._start_seq = int(start_seq)
        self._spec = dict(spec)
        self._env = jax_env.make_env(spec["env_name"])
        self._module = DiscretePolicyModule(self._env.spec["obs_dim"],
                                            self._env.spec["num_actions"],
                                            tuple(spec["hidden"]),
                                            device=spec["device"])
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # version -> params pytree
        self._weights: Dict[int, Any] = {}   # guarded-by: _lock
        # injected straggler delay seconds
        self._delay = 0.0   # guarded-by: _lock

    async def put_weights(self, version: int, params) -> bool:
        with self._cv:
            self._weights[int(version)] = params
            self._cv.notify_all()
        return True

    async def put_weights_many(self, versions: Dict[int, Any]) -> int:
        with self._cv:
            for v, p in versions.items():
                self._weights[int(v)] = p
            self._cv.notify_all()
        return len(versions)

    async def inject_delay(self, seconds: float) -> bool:
        with self._lock:
            self._delay = float(seconds)
        return True

    async def ping(self) -> str:
        return "ok"

    async def cpu_threads(self) -> int:
        import torch

        return torch.get_num_threads()

    async def node_id(self) -> Optional[str]:
        return os.environ.get("RAY_TPU_TORCH_NODE_ID")

    def _wait_weights(self, version: int, timeout: float):
        deadline = time.monotonic() + timeout
        with self._cv:
            while version not in self._weights:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RuntimeError(
                        f"gang {self._slot} timed out waiting for weights "
                        f"v{version} ({timeout:.0f}s)")
                self._cv.wait(min(remaining, 0.5))
            # needed versions are nondecreasing in seq: older ones are dead
            for old in [v for v in self._weights if v < version]:
                del self._weights[old]
            return self._weights[version]

    def stream(self):
        """The gang's batch stream.  seq s of slot k feeds learner
        update t = s*G + k using params at exactly
        v = max(0, t - staleness_bound) — the fixed-staleness scheme
        that makes every batch regenerable by a replacement gang."""
        from .core.rl_module import fold_in
        from .env.env_runner import fixed_shape_batch

        spec = self._spec
        G = spec["num_gangs"]
        D = spec["staleness_bound"]
        # warm the rollout on shape-identical throwaway params BEFORE the
        # produce loop: the device's first-use setup never lands in
        # produce_s, so a replacement gang's first batch doesn't read as
        # a straggler to the remediation effect watch (and
        # env_steps_per_s measures stepping, not setup)
        warm = self._module.init(0)
        fixed_shape_batch(self._env, self._module, warm, 0,
                          spec["num_envs"], spec["rollout_len"])
        seq = self._start_seq
        while True:
            t = seq * G + self._slot
            if t >= spec["num_updates"]:
                return
            version = max(0, t - D)
            params = self._wait_weights(version, spec["weights_wait_s"])
            t0 = time.monotonic()
            rng = fold_in(spec["sample_seed"], self._slot * 1_000_003 + seq)
            batch = fixed_shape_batch(self._env, self._module, params, rng,
                                      spec["num_envs"], spec["rollout_len"])
            elapsed = time.monotonic() - t0
            if elapsed < spec["min_produce_s"]:
                time.sleep(spec["min_produce_s"] - elapsed)
            with self._lock:
                delay = self._delay
            if delay > 0:
                time.sleep(delay)  # the injected straggler
            yield {
                "gang": self._slot,
                "incarnation": self._incarnation,
                "seq": seq,
                "policy_version": version,
                "produce_s": time.monotonic() - t0,
                "batch": batch,
            }
            seq += 1


class Sebulba:
    """The Sebulba supervisor: staffs ``num_gangs`` actor gangs, runs
    the learner consumption loop, and drives every robustness subsystem
    at once — PreemptionWatcher drains, RemediationEngine quarantines,
    goodput-predicted resume width on each regrow, and run-state
    goodput publishing for the autoscaler's GoodputPolicy."""

    def __init__(self, cfg: SebulbaConfig,
                 chaos: Optional[ChaosSchedule] = None):
        self.cfg = cfg
        self.chaos = chaos or ChaosSchedule()
        self._D = (cfg.staleness_bound if cfg.staleness_bound is not None
                   else 2 * cfg.num_gangs)
        if cfg.num_gangs < 2:
            raise ValueError("Sebulba needs >= 2 actor gangs (the "
                             "straggler median needs a quorum)")

    # -- gang lifecycle ----------------------------------------------------

    def _gang_spec(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "env_name": cfg.env_name, "hidden": tuple(cfg.hidden),
            "num_gangs": cfg.num_gangs, "staleness_bound": self._D,
            "num_updates": cfg.num_updates, "num_envs": cfg.num_envs,
            "rollout_len": cfg.rollout_len,
            "sample_seed": cfg.seed + 777,
            "min_produce_s": cfg.min_produce_s,
            "weights_wait_s": cfg.weights_wait_s,
            "allow_tf32": self._allow_tf32,
            "num_cpus": GANG_CPUS,
        }

    def _gang_device(self, slot: int) -> str:
        if self.cfg.gang_devices:
            return str(self.cfg.gang_devices[slot % len(self.cfg.gang_devices)])
        return self._device.type

    def _spawn(self, slot: int, incarnation: int, start_seq: int):
        self._spawn_many([(slot, incarnation, start_seq)])

    def _spawn_many(self, gangs: List[Tuple[int, int, int]]):
        """Start gangs (slot, incarnation, start_seq) together, then wait
        for each: GPU workers come up in parallel."""
        import ray_tpu_torch as rt

        started = []
        for slot, incarnation, start_seq in gangs:
            spec = dict(self._spec, device=self._gang_device(slot))
            opts = {"num_cpus": GANG_CPUS}
            if spec["device"].startswith("cuda"):
                opts["num_gpus"] = self._gang_num_gpus
            remote = self._RemoteGang.options(**opts)
            started.append((slot, incarnation,
                            remote.remote(slot, incarnation, start_seq,
                                          spec)))
        for slot, incarnation, h in started:
            nid = rt.get(h.node_id.remote(), timeout=self.cfg.get_timeout_s)
            # replay the retained params history: a replacement gang must
            # be able to regenerate every batch it owes, which needs
            # every version from its next seq's v(t) upward
            rt.get(h.put_weights_many.remote(dict(self._versions)),
                   timeout=self.cfg.get_timeout_s)
            gen = h.stream.options(
                num_returns="streaming",
                _generator_backpressure_num_objects=self.cfg.window).remote()
            self._handles[slot] = h
            self._gens[slot] = gen
            self._nodes[slot] = nid
            self._incs[slot] = incarnation
            self._gang_devs[slot] = self._gang_device(slot)
            self._gang_threads[slot] = rt.get(
                h.cpu_threads.remote(), timeout=self.cfg.get_timeout_s)

    def _respawn(self, slot: int, t: int):
        """Regrow a dead/retired slot at the next unconsumed seq.  The
        width decision genuinely consults the goodput history
        (elastic/resume.choose_width); the fixed-slot determinism
        scheme still staffs every logical slot, and the decision is
        recorded so callers can see the predictor at work."""
        now = time.monotonic()
        from ..elastic.resume import choose_width

        self._history.end(rounds=t, now=now)
        width = choose_width(self.cfg.num_gangs, self.cfg.min_gangs,
                             self.cfg.num_gangs, 1, self._history)
        self._resume_widths.append(int(width))
        self._era += 1
        self._spawn(slot, self._incs[slot] + 1, self._next_seq[slot])
        self._respawns += 1
        self._history.begin(self._era, width=self.cfg.num_gangs, rounds=t,
                            now=time.monotonic())
        self._publish_goodput(t, staffed=self.cfg.num_gangs)

    def _retire(self, slot: int, t: int, reason: str):
        """Coordinated retirement (drain / quarantine): stop the stream,
        kill the gang, regrow with incarnation + 1."""
        import ray_tpu_torch as rt

        try:
            rt.cancel(self._gens[slot])
        except Exception:
            pass
        try:
            rt.kill(self._handles[slot])
        except Exception:
            pass
        self._note_death(slot, t, reason)
        self._respawn(slot, t)

    def _note_death(self, slot: int, t: int, kind: str):
        self.deaths.append({"slot": slot, "at_update": t, "kind": kind,
                            "incarnation": self._incs[slot]})
        self._publish_goodput(t, staffed=self.cfg.num_gangs - 1)
        if self.cfg.probe is not None:
            try:
                self.cfg.probe("goodput_dip", {
                    "slot": slot, "at_update": t, "kind": kind,
                    "goodput": self._goodput_trace[-1]})
            except Exception:
                logger.exception("probe hook failed")

    # -- control-plane integration ----------------------------------------

    def _publish_goodput(self, t: int, staffed: int):
        from ..train.backend import publish_run_state

        goodput = staffed / float(self.cfg.num_gangs)
        self._goodput_trace.append(goodput)
        publish_run_state(
            self.cfg.trial, "RUNNING", name=self.cfg.name,
            workers=staffed, rounds=t,
            metrics=self._last_metrics,
            telemetry={"goodput": {"goodput": goodput},
                       "stragglers": self._agg.summary(),
                       "remediations": self._eng.summary()})

    def _on_preempt_notice(self, notice):
        """PreemptionWatcher callback (fired inline from poll_once):
        report the gang's node draining, retire the gang gracefully at
        the batch boundary, regrow, then clear the notice source."""
        slot = self._preempt_victim
        node = self._nodes[slot]
        t = self._t
        try:
            self._core.control.call("report_draining", {
                "node_id": node,
                "grace_s": notice.grace_s or self.cfg.drain_grace_s,
                "reason": notice.reason}, timeout=10.0)
            self._drained_nodes.add(node)
        except Exception:
            logger.exception("report_draining failed")
        self.drains.append({"slot": slot, "at_update": t, "node": node,
                            "reason": notice.reason})
        self._retire(slot, t, "drain")
        self._src.clear()

    def _enforce(self, decision: Dict[str, Any], t: int, round_idx: int):
        """RemediationEngine said quarantine: bench the gang's node on
        the control plane, retire + regrow the gang (the replacement
        has no injected delay, so the effect watch recovers)."""
        slot = int(decision["rank"])
        node = self._nodes[slot]
        try:
            self._core.control.call("report_quarantine", {
                "node_id": node, "grace_s": self.cfg.quarantine_grace_s,
                "reason": decision["reason"]}, timeout=10.0)
            self._quarantined_nodes.add(node)
        except Exception:
            logger.exception("report_quarantine failed")
        self._eng.note_enforced(decision, node_id=node)
        self._retire(slot, t, "quarantine")
        self._eng.note_recovered(new_world=self.cfg.num_gangs,
                                 step=round_idx)

    def _fire_chaos(self, ev: ChaosEvent, t: int):
        """Inject one fault.  Its outcome goes into ``chaos_outcomes``;
        a fault whose injection failed is not counted as fired."""
        import ray_tpu_torch as rt

        error: Optional[str] = None
        if ev.kind == "kill":
            # hard kill: no drain, no warning — the consumer discovers
            # it when the stream errors
            try:
                rt.kill(self._handles[ev.slot])
            except Exception as e:
                error = repr(e)
        elif ev.kind == "straggle":
            try:
                rt.get(
                    self._handles[ev.slot].inject_delay.remote(ev.value),
                    timeout=self.cfg.get_timeout_s)
            except Exception as e:
                error = repr(e)
        elif ev.kind == "preempt":
            self._preempt_victim = ev.slot
            self._src.trigger(reason=f"chaos-preempt-u{t}",
                              grace_s=ev.value or self.cfg.drain_grace_s)
        else:
            raise ValueError(f"unknown chaos kind {ev.kind!r}")
        self._chaos_outcomes.append({
            "kind": ev.kind, "at_update": t, "slot": ev.slot,
            "incarnation": self._incs.get(ev.slot), "ok": error is None,
            "error": error})
        if error is not None:
            logger.warning("chaos %s on slot %d at update %d failed: %s",
                           ev.kind, ev.slot, t, error)

    # -- the consumption loop ----------------------------------------------

    def _consume(self, slot: int, t: int) -> Dict[str, Any]:
        """Next batch from the slot's stream; on producer death, respawn
        at the next unconsumed seq and retry — regeneration, not loss."""
        import ray_tpu_torch as rt

        t0 = time.monotonic()
        attempts = 0
        while True:
            try:
                ref = next(self._gens[slot])
                item = rt.get(ref, timeout=self.cfg.get_timeout_s)
                self._waits.append(time.monotonic() - t0)
                return item
            except StopIteration:
                err: Any = "stream exhausted early"
            except Exception as e:
                err = e
            attempts += 1
            if attempts > 5:
                raise RuntimeError(
                    f"slot {slot} failed {attempts} consecutive respawns "
                    f"at update {t}: {err}")
            logger.warning("slot %d stream failed at update %d (%s); "
                           "respawning", slot, t, err)
            self._note_death(slot, t, "stream-error")
            self._respawn(slot, t)

    def _broadcast(self, version: int):
        import ray_tpu_torch as rt

        params = self._versions[version]
        refs = [(s, h.put_weights.remote(version, params))
                for s, h in self._handles.items()]
        for s, r in refs:
            try:
                rt.get(r, timeout=self.cfg.get_timeout_s)
            except Exception:
                # dead gang: the consume path respawns it (with the full
                # retained history replayed), so a lost push is benign
                logger.debug("weight push v%d to slot %d failed", version, s)

    def _prune_versions(self, t: int):
        floor = t - self._D - 2 * self.cfg.num_gangs - 4
        for v in [v for v in self._versions if v < floor]:
            del self._versions[v]

    def run(self) -> Dict[str, Any]:
        import torch

        import ray_tpu_torch as rt

        from .._device import resolve_device
        from .._private.core import current_core
        from ..elastic import ElasticConfig
        from ..elastic.preemption import (FakePreemptionSource,
                                          PreemptionWatcher)
        from ..elastic.remediation import RemediationEngine
        from ..elastic.resume import IncarnationHistory
        from ..telemetry import StepAggregator, TelemetryConfig
        from ..train.backend import publish_run_state
        from .core.learner import LearnerGroup
        from .env import jax_env

        cfg = self.cfg
        G = cfg.num_gangs
        self._device = resolve_device(cfg.device)
        self._allow_tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
        self._gang_num_gpus = 1.0 / (G + 1)
        self._core = current_core()
        self._spec = self._gang_spec()
        self._RemoteGang = rt.remote(_GangWorker)

        env = jax_env.make_env(cfg.env_name)
        hp = dict(gamma=cfg.gamma, vf_coeff=cfg.vf_coeff,
                  entropy_coeff=cfg.entropy_coeff, clip_rho=cfg.clip_rho,
                  clip_c=cfg.clip_c, lr=cfg.lr, seed=cfg.seed,
                  device=str(self._device))
        learners = LearnerGroup(
            partial(_learner_factory, dict(env.spec), tuple(cfg.hidden), hp),
            cfg.num_learners)

        self._agg = StepAggregator(
            TelemetryConfig(straggler_multiple=cfg.straggler_multiple,
                            straggler_sustain=cfg.straggler_sustain),
            trial=cfg.trial)
        self._eng = RemediationEngine(
            ElasticConfig(
                remediation_mode="enforce",
                remediation_confirm_rounds=1,
                remediation_cooldown_s=cfg.remediation_cooldown_s,
                remediation_max_episodes=cfg.remediation_max_episodes,
                remediation_effect_window=cfg.remediation_effect_window,
                remediation_recover_tolerance=(
                    cfg.remediation_recover_tolerance),
                quarantine_grace_s=cfg.quarantine_grace_s),
            trial=cfg.trial)
        self._src = FakePreemptionSource()
        self._watcher = PreemptionWatcher(self._src, self._on_preempt_notice,
                                          debounce_s=cfg.debounce_s)
        self._history = IncarnationHistory()

        self._versions: Dict[int, Any] = {0: _to_numpy(learners.get_weights())}
        self._handles: Dict[int, Any] = {}
        self._gang_devs: Dict[int, str] = {}
        self._gang_threads: Dict[int, int] = {}
        self._gens: Dict[int, Any] = {}
        self._nodes: Dict[int, Optional[str]] = {}
        self._incs: Dict[int, int] = {s: -1 for s in range(G)}
        self._next_seq = [0] * G
        self._era = 0
        self._respawns = 0
        self._resume_widths: List[int] = []
        self._goodput_trace: List[float] = []
        self._waits: List[float] = []
        self._last_metrics: Optional[Dict[str, float]] = None
        self._preempt_victim = 0
        self._drained_nodes: set = set()
        self._quarantined_nodes: set = set()
        self.deaths: List[Dict[str, Any]] = []
        self.drains: List[Dict[str, Any]] = []
        self._chaos_outcomes: List[Dict[str, Any]] = []
        rounds: List[Dict[str, Any]] = []
        consumed: List[Tuple[int, int, int, int]] = []
        consumed_keys: set = set()
        staleness: List[int] = []
        produce_last: Dict[int, float] = {}
        produce_total = 0.0
        metrics: Dict[str, float] = {}

        t_start = time.monotonic()
        error: Optional[BaseException] = None
        try:
            self._spawn_many([(slot, 0, 0) for slot in range(G)])
            self._history.begin(self._era, width=G, rounds=0,
                                now=time.monotonic())
            self._publish_goodput(0, staffed=G)

            for t in range(cfg.num_updates):
                self._t = t
                slot = t % G
                for ev in self.chaos.due(t):
                    self._fire_chaos(ev, t)
                self._watcher.poll_once()

                item = self._consume(slot, t)
                # exactly-once, in-order, staleness-bounded — the
                # invariants chaos must not break
                if item["seq"] != self._next_seq[slot]:
                    raise AssertionError(
                        f"slot {slot} yielded seq {item['seq']}, expected "
                        f"{self._next_seq[slot]} (ordering broken)")
                key = (slot, item["seq"])
                if key in consumed_keys:
                    raise AssertionError(
                        f"duplicate batch {key} (exactly-once broken)")
                consumed_keys.add(key)
                self._next_seq[slot] += 1
                lag = t - item["policy_version"]
                if not 0 <= lag <= self._D:
                    raise AssertionError(
                        f"staleness {lag} outside [0, {self._D}] at "
                        f"update {t}")
                staleness.append(lag)
                consumed.append((slot, item["incarnation"], item["seq"],
                                 item["policy_version"]))
                produce_last[slot] = item["produce_s"]
                produce_total += item["produce_s"]

                metrics = learners.update(item["batch"])
                self._last_metrics = metrics
                self._versions[t + 1] = _to_numpy(learners.get_weights())
                self._prune_versions(t)
                self._broadcast(t + 1)

                if (t + 1) % G == 0:
                    round_idx = (t + 1) // G - 1
                    self._agg.ingest_round([
                        {"step": round_idx, "ts": 0.0,
                         "dur": produce_last.get(s, 0.0),
                         "phases": {"compute": produce_last.get(s, 0.0)},
                         "rank": s, "incarnation": self._incs[s]}
                        for s in range(G)])
                    busy = dict(self._agg.last_view()["busy"])
                    rounds.append({
                        "round": round_idx, "busy": busy,
                        "median": float(np.median(list(busy.values()))),
                        "incarnations": dict(self._incs)})
                    # no device advisory is this run's: its learner
                    # update is eager, no program of the ledger, and the
                    # ledger's advisories are other programs' (ROADMAP §C)
                    decision = self._eng.observe_round(self._agg)
                    if decision is not None:
                        self._enforce(decision, t, round_idx)
                    self._publish_goodput(t + 1, staffed=G)
            self._history.end(rounds=cfg.num_updates, now=time.monotonic())
        except BaseException as e:
            error = e
            raise
        finally:
            for h in self._handles.values():
                try:
                    rt.kill(h)
                except Exception:
                    pass
            for node, method in [(n, "report_draining")
                                 for n in self._drained_nodes] + \
                                [(n, "report_quarantine")
                                 for n in self._quarantined_nodes]:
                try:
                    self._core.control.call(method, {
                        "node_id": node, "cancel": True}, timeout=10.0)
                except Exception:
                    pass
            learners.stop()
            publish_run_state(
                cfg.trial, "ERRORED" if error else "FINISHED",
                name=cfg.name, workers=G, rounds=cfg.num_updates,
                metrics=self._last_metrics,
                telemetry={"goodput": {"goodput": 1.0},
                           "remediations": self._eng.summary()})

        elapsed = max(time.monotonic() - t_start, 1e-9)
        samples = cfg.num_updates * cfg.num_envs * cfg.rollout_len
        final = self._versions[cfg.num_updates]
        stal = np.asarray(staleness)
        waits = np.asarray(self._waits)
        return {
            "params": final,
            "params_digest": params_digest(final),
            "updates": cfg.num_updates,
            "learner_samples": samples,
            "learner_samples_per_s": samples / elapsed,
            "env_steps_per_s": samples / max(produce_total, 1e-9),
            "staleness": {"bound": self._D, "max": int(stal.max()),
                          "p99": float(np.percentile(stal, 99)),
                          "mean": float(stal.mean())},
            "availability": float(np.mean(waits <= cfg.stall_bound_s)),
            "wait_p99_s": float(np.percentile(waits, 99)),
            "consumed": consumed,
            "deaths": self.deaths,
            "drains": self.drains,
            "respawns": self._respawns,
            "resume_widths": self._resume_widths,
            "incarnations": dict(self._incs),
            "remediation": self._eng.summary(),
            "remediation_records": list(self._eng.records),
            "goodput_trace": self._goodput_trace,
            "notices": {"fired": self._watcher.notices_fired,
                        "suppressed": self._watcher.notices_suppressed},
            "chaos_fired": [(o["kind"], o["at_update"], o["slot"])
                            for o in self._chaos_outcomes if o["ok"]],
            "chaos_outcomes": list(self._chaos_outcomes),
            "rounds": rounds,
            "quarantined_nodes": sorted(self._quarantined_nodes),
            "drained_nodes": sorted(self._drained_nodes),
            "final_metrics": metrics,
            "elapsed_s": elapsed,
            "device": str(self._device),
            "gang_devices": dict(self._gang_devs),
            "gang_cpu_threads": dict(self._gang_threads),
            "gang_num_gpus": (self._gang_num_gpus
                              if self._device.type == "cuda" else 0.0),
        }


def run_sebulba(cfg: SebulbaConfig,
                chaos: Optional[ChaosSchedule] = None) -> Dict[str, Any]:
    return Sebulba(cfg, chaos).run()


def replay_sebulba(cfg: SebulbaConfig) -> Dict[str, Any]:
    """Sebulba's learner updates with no gang: update t's batch is made
    in this process by ``fixed_shape_batch`` for slot ``t % G``, sequence
    ``t // G``, from the params at version ``max(0, t - D)`` — what the
    design invariant says every gang yields.  Its ``params_digest``
    equals ``run_sebulba(cfg)``'s (with or without chaos) exactly when
    every batch the gangs produced, respawned ones' too, is bit-identical
    to the batch this process makes; no worker is spawned."""
    from .._device import resolve_device
    from .core.rl_module import fold_in
    from .env import jax_env
    from .env.env_runner import fixed_shape_batch

    device = resolve_device(cfg.device)
    G = cfg.num_gangs
    D = cfg.staleness_bound if cfg.staleness_bound is not None else 2 * G
    env = jax_env.make_env(cfg.env_name)
    learner = _learner_factory(
        dict(env.spec), tuple(cfg.hidden),
        dict(gamma=cfg.gamma, vf_coeff=cfg.vf_coeff,
             entropy_coeff=cfg.entropy_coeff, clip_rho=cfg.clip_rho,
             clip_c=cfg.clip_c, lr=cfg.lr, seed=cfg.seed,
             device=str(device)))
    versions = {0: _to_numpy(learner.get_weights())}
    metrics: Dict[str, float] = {}
    t0 = time.monotonic()
    for t in range(cfg.num_updates):
        slot, seq = t % G, t // G
        batch = fixed_shape_batch(
            env, learner.module, versions[max(0, t - D)],
            fold_in(cfg.seed + 777, slot * 1_000_003 + seq),
            cfg.num_envs, cfg.rollout_len)
        metrics = learner.update(batch)
        versions[t + 1] = _to_numpy(learner.get_weights())
        versions.pop(t - D - 1, None)
    final = versions[cfg.num_updates]
    return {"params": final, "params_digest": params_digest(final),
            "final_metrics": metrics,
            "elapsed_s": time.monotonic() - t0}
