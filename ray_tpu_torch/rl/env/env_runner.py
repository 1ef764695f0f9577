"""EnvRunners: sampling actors.

The port of ``ray_tpu/rl/env/env_runner.py`` (reference:
rllib/env/env_runner.py, rllib/env/env_runner_group.py): a group of
actors each owning vectorized environments, sampling with the current
policy weights, returning batches to the algorithm.

Two runner kinds:
  * JaxEnvRunner — the ``jax_env`` environments, vectorized over device
    tensors: a rollout is a loop of device ops with no host sync (the
    device-native path).
  * GymEnvRunner — gymnasium envs stepped host-side (API-parity path for
    external envs the reference supports).

Both return batches as a dict of numpy [T, B, ...] arrays plus episode
stats, so learners consume one format.  Runners take their device from
``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch as rt


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _EpisodeTracker:
    """Accumulates per-env episode return/length across batch boundaries."""

    def __init__(self, num_envs: int):
        self.returns = np.zeros(num_envs)
        self.lengths = np.zeros(num_envs, np.int64)
        self.completed: List[float] = []

    def update(self, rewards: np.ndarray, dones: np.ndarray):
        # rewards/dones: [T, B]
        for t in range(rewards.shape[0]):
            self.returns += rewards[t]
            self.lengths += 1
            for i in np.nonzero(dones[t])[0]:
                self.completed.append(float(self.returns[i]))
                self.returns[i] = 0.0
                self.lengths[i] = 0

    def pop_stats(self) -> Dict[str, float]:
        done, self.completed = self.completed, []
        if not done:
            return {"episodes_this_iter": 0}
        return {
            "episodes_this_iter": len(done),
            "episode_return_mean": float(np.mean(done)),
            "episode_return_max": float(np.max(done)),
            "episode_return_min": float(np.min(done)),
        }


class JaxEnvRunner:
    """Sampling over the ``jax_env`` environments on one device; the
    rollout is a device loop (``jax_env.rollout``).

    `env_to_module` (a ConnectorV2/pipeline) runs on observations INSIDE
    that loop, so it must be traceable; stateful host-side connectors
    (NormalizeObs) belong on GymEnvRunner.
    """

    def __init__(self, env_name: str, module_spec: Dict[str, Any],
                 num_envs: int = 8, seed: int = 0,
                 explore_kwargs: Optional[Dict[str, Any]] = None,
                 env_to_module=None, device=None,
                 cpu_threads: Optional[int] = None):
        from ..._device import resolve_device
        from ..core.rl_module import module_for_env
        from . import jax_env

        if cpu_threads is not None:         # a remote runner's grant
            use_cpu_threads(cpu_threads)
        self.device = resolve_device(device)
        self.env = jax_env.make_env(env_name)
        self.module = module_for_env(self.env.spec,
                                     kind=module_spec.get("kind", "policy"),
                                     **module_spec.get("kwargs", {}),
                                     hidden=module_spec.get("hidden",
                                                            (64, 64)),
                                     device=self.device)
        self.num_envs = num_envs
        self.explore_kwargs = explore_kwargs or {}
        if env_to_module is not None and not env_to_module.traceable:
            raise ValueError(
                "JaxEnvRunner connectors run inside the device rollout "
                f"loop and must be traceable; {env_to_module!r} is not "
                "(use GymEnvRunner for stateful connectors like "
                "NormalizeObs)")
        self.env_to_module = env_to_module
        self.params = self.module.init(seed)
        self.carry = jax_env.init_carry(self.env, seed + 1, num_envs,
                                        self.device)
        self.tracker = _EpisodeTracker(num_envs)
        self._steps_sampled = 0
        self._build_policy_fn()

    def _build_policy_fn(self):
        kwargs = dict(self.explore_kwargs)
        module = self.module
        e2m = self.env_to_module

        def policy_fn(params, obs, rng):
            if e2m is not None:
                obs = e2m(obs)
            return module.forward_exploration(params, obs, rng, **kwargs)

        self._policy_fn = policy_fn

    def set_explore(self, **kwargs):
        """Update exploration params (e.g. epsilon decay)."""
        self.explore_kwargs.update(kwargs)
        self._build_policy_fn()

    def set_weights(self, params):
        from ..core.rl_module import to_device_params

        self.params = to_device_params(params, self.device)

    def get_weights(self):
        return self.params

    def env_spec(self) -> Dict[str, Any]:
        return dict(self.env.spec)

    def sample(self, num_steps: int) -> Dict[str, Any]:
        """num_steps per env; returns [T, B, ...] numpy batch + stats."""
        import torch

        from .jax_env import rollout

        self.carry, batch = rollout(self.env, self._policy_fn, self.params,
                                    self.carry, num_steps)
        with torch.no_grad():
            if self.env_to_module is not None:
                # the rollout records RAW env obs; the policy sampled from
                # TRANSFORMED obs (the connector runs inside policy_fn) —
                # the learner must see the same representation actions
                # came from, or importance ratios / value targets are
                # silently wrong.  Connectors are written against
                # [B, ...]; collapse [T, B] so FlattenObs-style shape ops
                # see one batch axis.
                obs = batch["obs"]
                tb = obs.shape[:2]
                flat = self.env_to_module(obs.reshape(-1, *obs.shape[2:]))
                batch["obs"] = flat.reshape(*tb, *flat.shape[1:])
            # bootstrap value for the obs after the last step (GAE tail)
            final_obs = self.carry[1]
            if self.env_to_module is not None:
                final_obs = self.env_to_module(final_obs)
            if hasattr(self.module, "value"):
                batch["final_vf"] = self.module.value(self.params, final_obs)
        batch = {k: _host(v) for k, v in batch.items()}
        self.tracker.update(batch["reward"], batch["done"])
        self._steps_sampled += num_steps * self.num_envs
        stats = self.tracker.pop_stats()
        stats["env_steps_sampled"] = self._steps_sampled
        return {"batch": batch, "stats": stats}


def fixed_shape_batch(env, module, params, rng, num_envs: int,
                      num_steps: int) -> Dict[str, np.ndarray]:
    """One deterministic fixed-shape trajectory batch from a FRESH
    vectorized carry.

    Unlike JaxEnvRunner.sample (which threads env state across calls for
    continuous sampling), the batch here is a pure function of
    (env, module, params, rng, shapes): no hidden state survives the
    call, and ``rng`` is a key (an int), from which fresh generators on
    the module's device are made.  That purity is what lets a
    replacement Podracer actor gang regenerate, bit for bit, the batches
    its dead predecessor owed the learner (see rl/podracer.py) —
    respawn cost is O(1), not O(history).  Every op is deterministic on
    the card, so the same inputs give the same bits in any process on
    the same card and build.

    Returns a dict of [B, T, ...] numpy arrays (batch-major, the order
    ImpalaLearner.compute_loss consumes) for obs/action/reward/done/logp
    plus final_vf [B] (the V-trace bootstrap tail).
    """
    import torch

    from ..core.rl_module import to_device_params
    from . import jax_env

    params = to_device_params(params, module.device)
    carry = jax_env.init_carry(env, rng, num_envs, module.device)
    carry, batch = jax_env.rollout(env, module.forward_exploration,
                                   params, carry, num_steps)
    with torch.no_grad():
        final_vf = module.value(params, carry[1])
    out = {k: np.swapaxes(_host(batch[k]), 0, 1)
           for k in ("obs", "action", "reward", "done", "logp")}
    out["final_vf"] = _host(final_vf)
    return out


class GymEnvRunner:
    """Host-side gymnasium sampling (reference:
    single_agent_env_runner.py with gym.vector.SyncVectorEnv); the module
    runs on ``device``."""

    def __init__(self, env_name: str, module_spec: Dict[str, Any],
                 num_envs: int = 8, seed: int = 0,
                 explore_kwargs: Optional[Dict[str, Any]] = None,
                 env_to_module=None, module_to_env=None, device=None,
                 cpu_threads: Optional[int] = None):
        import gymnasium as gym

        if cpu_threads is not None:         # a remote runner's grant
            use_cpu_threads(cpu_threads)
        from ..._device import resolve_device
        from ..connectors import default_env_to_module, default_module_to_env
        from ..core.rl_module import make_generator, module_for_env

        self.device = resolve_device(device)
        self.envs = gym.vector.SyncVectorEnv(
            [lambda: gym.make(env_name) for _ in range(num_envs)])
        obs_space = self.envs.single_observation_space
        act_space = self.envs.single_action_space
        self.spec = {"obs_dim": int(np.prod(obs_space.shape)),
                     "max_episode_steps": 0}
        if hasattr(act_space, "n"):                 # Discrete
            self.spec["num_actions"] = int(act_space.n)
        else:                                       # Box (continuous)
            low = np.asarray(act_space.low, np.float64).reshape(-1)
            high = np.asarray(act_space.high, np.float64).reshape(-1)
            if not (np.isfinite(low).all() and np.isfinite(high).all()):
                raise ValueError(
                    f"Box action space has non-finite bounds "
                    f"(low={low}, high={high}): the squashed-Gaussian "
                    f"policy needs a bounded range — wrap the env with "
                    f"a RescaleAction/ClipAction wrapper")
            self.spec.update(
                # per-dimension bounds (lists: specs cross process
                # boundaries) — collapsing to scalars would mis-scale
                # heterogeneous spaces like CarRacing's [steer, gas,
                # brake]
                action_dim=int(np.prod(act_space.shape)),
                action_low=low.tolist(),
                action_high=high.tolist())
        self.module = module_for_env(self.spec,
                                     kind=module_spec.get("kind", "policy"),
                                     **module_spec.get("kwargs", {}),
                                     hidden=module_spec.get("hidden",
                                                            (64, 64)),
                                     device=self.device)
        self.num_envs = num_envs
        self.explore_kwargs = explore_kwargs or {}
        # obs/action handling as composable pipelines (reference:
        # connectors/env_to_module/, module_to_env/) — not hardcoded here
        self.env_to_module = (env_to_module if env_to_module is not None
                              else default_env_to_module())
        self.module_to_env = (module_to_env if module_to_env is not None
                              else default_module_to_env())
        self.params = self.module.init(seed)
        self.rng = make_generator(seed + 1, self.device)
        self.obs, _ = self.envs.reset(seed=seed)
        self.tracker = _EpisodeTracker(num_envs)
        self._steps_sampled = 0

    def set_explore(self, **kwargs):
        self.explore_kwargs.update(kwargs)

    def set_weights(self, params):
        from ..core.rl_module import to_device_params

        self.params = to_device_params(params, self.device)

    def get_weights(self):
        return self.params

    def env_spec(self) -> Dict[str, Any]:
        return dict(self.spec)

    def _to_device(self, obs):
        import torch

        return torch.as_tensor(np.asarray(_host(obs), np.float32),
                               device=self.device)

    def sample(self, num_steps: int) -> Dict[str, Any]:
        import torch

        rows = []
        with torch.no_grad():
            for _ in range(num_steps):
                obs = self._to_device(self.env_to_module(self.obs))
                action, extras = self.module.forward_exploration(
                    self.params, obs, self.rng, **self.explore_kwargs)
                action_np = self.module_to_env(action)
                next_obs, reward, term, trunc, _ = self.envs.step(action_np)
                done = np.logical_or(term, trunc)
                rows.append({"obs": _host(obs), "action": action_np,
                             "reward": np.asarray(reward, np.float32),
                             "done": done,
                             # terminated vs truncated matters to value
                             # learners: a time-limit hit must not cut the
                             # bootstrap target (gymnasium's distinction)
                             "terminated": np.asarray(term, bool),
                             **{k: _host(v) for k, v in extras.items()}})
                self.obs = next_obs
            batch = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
            if hasattr(self.module, "value"):
                # bootstrap obs goes through the SAME pipeline the
                # recorded obs did (the value net was trained on
                # transformed obs); no_update so stateful filters don't
                # double-count it when the next sample() transforms it
                # again
                fin = self.env_to_module(self.obs, {"no_update": True})
                batch["final_vf"] = _host(self.module.value(
                    self.params, self._to_device(fin)))
        self.tracker.update(batch["reward"], batch["done"])
        self._steps_sampled += num_steps * self.num_envs
        stats = self.tracker.pop_stats()
        stats["env_steps_sampled"] = self._steps_sampled
        return {"batch": batch, "stats": stats}


def make_runner(kind: str, **kwargs):
    return (JaxEnvRunner if kind == "jax" else GymEnvRunner)(**kwargs)


def use_cpu_threads(num_cpus) -> None:
    """Give this worker's torch as many intra-op threads as the CPUs its
    lease grants (``num_cpus``, at least one).  torch's default, a thread
    per core, oversubscribes a host that other workers share: beside six
    busy test processes on eight cores a gang's rollout of small ops
    took 0.25-0.6 s of wall time, and 0.48 s of CPU in spinning threads,
    against 2 ms with one thread (ROADMAP §C)."""
    import torch

    torch.set_num_threads(max(1, int(num_cpus)))


def gpu_share(device, count: int) -> Dict[str, Any]:
    """Actor options for ``count`` actors that share one card when
    ``device`` (a resolved ``torch.device``) is a card, as pipeline's
    stage actors do; none on the CPU."""
    if device.type != "cuda":
        return {}
    return {"num_gpus": 1.0 / max(1, int(count))}


class EnvRunnerGroup:
    """N remote runner actors + weight broadcast (reference:
    rllib/env/env_runner_group.py EnvRunnerGroup.sync_weights).  Remote
    runners on the card share it (``num_gpus = 1 / num_runners`` each)."""

    def __init__(self, *, env_name: str, module_spec: Dict[str, Any],
                 num_runners: int = 2, num_envs_per_runner: int = 8,
                 runner_kind: str = "jax", seed: int = 0,
                 explore_kwargs: Optional[Dict[str, Any]] = None,
                 local: bool = False, env_to_module=None,
                 module_to_env=None, device=None):
        from ..._device import resolve_device

        conn_kw: Dict[str, Any] = {}
        if env_to_module is not None:
            conn_kw["env_to_module"] = env_to_module
        if module_to_env is not None:
            if runner_kind == "jax":
                # jax-env rollouts feed actions straight back into the
                # device env step — there is no host boundary for this
                # hook, and silently dropping it would train differently
                # than the same config on the gym runner
                raise ValueError(
                    "module_to_env connectors are not supported with "
                    "runner_kind='jax' (actions never cross a host "
                    "boundary inside the device rollout); use "
                    "runner_kind='gym' or drop the connector")
            conn_kw["module_to_env"] = module_to_env
        dev = resolve_device(device)
        self.local = local or num_runners == 0
        if self.local:
            self.runner = make_runner(
                runner_kind, env_name=env_name, module_spec=module_spec,
                num_envs=num_envs_per_runner, seed=seed,
                explore_kwargs=explore_kwargs, device=dev, **conn_kw)
            self.actors = []
        else:
            RemoteRunner = rt.remote(
                JaxEnvRunner if runner_kind == "jax" else GymEnvRunner)
            opts = {"num_cpus": 1, **gpu_share(dev, num_runners)}
            RemoteRunner = RemoteRunner.options(**opts)
            self.actors = [
                RemoteRunner.remote(
                    env_name=env_name, module_spec=module_spec,
                    num_envs=num_envs_per_runner, seed=seed + 1000 * i,
                    explore_kwargs=explore_kwargs, device=dev.type,
                    cpu_threads=opts["num_cpus"], **conn_kw)
                for i in range(num_runners)
            ]

    def env_spec(self) -> Dict[str, Any]:
        if self.local:
            return self.runner.env_spec()
        return rt.get(self.actors[0].env_spec.remote())

    def sample(self, num_steps: int) -> List[Dict[str, Any]]:
        if self.local:
            return [self.runner.sample(num_steps)]
        return rt.get([a.sample.remote(num_steps) for a in self.actors])

    def sync_weights(self, params):
        if self.local:
            self.runner.set_weights(params)
        else:
            from ..core.rl_module import to_numpy_params

            ref = rt.put(to_numpy_params(params))
            rt.get([a.set_weights.remote(ref) for a in self.actors])

    def set_explore(self, **kwargs):
        if self.local:
            self.runner.set_explore(**kwargs)
        else:
            rt.get([a.set_explore.remote(**kwargs) for a in self.actors])

    def stop(self):
        for a in self.actors:
            try:
                rt.kill(a)
            except Exception:
                pass
