"""Multi-agent environment protocol + runner.

Analog of the reference's MultiAgentEnv (reference:
rllib/env/multi_agent_env.py:32) and MultiAgentEnvRunner
(rllib/env/multi_agent_env_runner.py): dict-keyed parallel stepping —
every live agent submits an action each step and receives its own
observation/reward, with per-agent termination.

The runner maps agents onto POLICIES via `policy_mapping_fn` and emits
one [T, B_agents, ...] batch PER POLICY, so a learner per policy trains
on exactly its own experience (reference:
rl_module/multi_rl_module.py MultiRLModule).  The port of
``ray_tpu/rl/env/multi_agent_env.py``: the envs step on the host, the
policies run on the runner's device (the card unless the caller asks
for the CPU).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch as rt


class MultiAgentEnv:
    """Parallel multi-agent env (reference: multi_agent_env.py:32).

    Subclasses define:
      possible_agents: list of agent ids
      observation_spec(agent) -> {"obs_dim": int}
      action_spec(agent) -> {"num_actions": int}
      reset(seed) -> obs_dict
      step(action_dict) -> (obs_dict, reward_dict, terminated_dict,
                            truncated_dict, info_dict); the special key
                            "__all__" in terminated ends the episode.
    """

    possible_agents: List[str] = []

    def observation_spec(self, agent: str) -> Dict[str, int]:
        raise NotImplementedError

    def action_spec(self, agent: str) -> Dict[str, int]:
        raise NotImplementedError

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, int]):
        raise NotImplementedError


# -- env registry (reference: tune.register_env) ----------------------------

_ENV_REGISTRY: Dict[str, Callable[[], MultiAgentEnv]] = {}


def register_env(name: str, creator: Callable[[], MultiAgentEnv]) -> None:
    _ENV_REGISTRY[name] = creator


def make_multi_agent_env(name_or_creator) -> MultiAgentEnv:
    if callable(name_or_creator):
        return name_or_creator()
    creator = _ENV_REGISTRY.get(name_or_creator)
    if creator is None:
        raise ValueError(f"no registered multi-agent env "
                         f"{name_or_creator!r}; register_env() it first")
    return creator()


class CooperativeMatchEnv(MultiAgentEnv):
    """Tiny cooperative debug env (the reference's MultiAgentCartPole
    role): each agent sees its own one-hot target; the TEAM earns +1 only
    when every agent outputs its own target.  Distinct observations per
    agent force distinct policies."""

    def __init__(self, num_agents: int = 2, num_targets: int = 4,
                 episode_len: int = 8):
        self.possible_agents = [f"agent_{i}" for i in range(num_agents)]
        self.k = num_targets
        self.episode_len = episode_len
        self._rng = np.random.default_rng(0)
        self._t = 0
        self._targets: Dict[str, int] = {}

    def observation_spec(self, agent: str) -> Dict[str, int]:
        return {"obs_dim": self.k}

    def action_spec(self, agent: str) -> Dict[str, int]:
        return {"num_actions": self.k}

    def _obs(self) -> Dict[str, np.ndarray]:
        return {a: np.eye(self.k, dtype=np.float32)[self._targets[a]]
                for a in self.possible_agents}

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._targets = {a: int(self._rng.integers(self.k))
                         for a in self.possible_agents}
        return self._obs()

    def step(self, actions: Dict[str, int]):
        self._t += 1
        all_correct = all(int(actions[a]) == self._targets[a]
                          for a in self.possible_agents)
        reward = 1.0 if all_correct else 0.0
        self._targets = {a: int(self._rng.integers(self.k))
                         for a in self.possible_agents}
        done = self._t >= self.episode_len
        obs = self._obs()
        rewards = {a: reward for a in self.possible_agents}
        terms = {a: done for a in self.possible_agents}
        terms["__all__"] = done
        truncs = {a: False for a in self.possible_agents}
        truncs["__all__"] = False
        return obs, rewards, terms, truncs, {}


register_env("coop_match", CooperativeMatchEnv)


class MultiAgentEnvRunner:
    """Samples B env copies in lockstep; emits one batch per POLICY.

    Synchronous parallel protocol: every agent acts each step (the
    reference's env-runner also drives the env check/parallel API).
    Episodes auto-reset on "__all__".
    """

    def __init__(self, env_name: str, policies: List[str],
                 policy_mapping_fn: Callable[[str], str],
                 module_spec: Dict[str, Any], num_envs: int = 4,
                 seed: int = 0, device=None,
                 cpu_threads: Optional[int] = None):
        from ..._device import resolve_device
        from ..core.multi_rl_module import MultiRLModule
        from ..core.rl_module import make_generator
        from .env_runner import use_cpu_threads

        if cpu_threads is not None:         # a remote runner's grant
            use_cpu_threads(cpu_threads)
        self.device = resolve_device(device)

        self.envs = [make_multi_agent_env(env_name)
                     for _ in range(num_envs)]
        self.num_envs = num_envs
        self.agents = list(self.envs[0].possible_agents)
        self.policy_mapping_fn = policy_mapping_fn
        self.policies = list(policies)
        # per-policy spec from any agent mapped to it
        specs = {}
        for pid in self.policies:
            agents = [a for a in self.agents
                      if policy_mapping_fn(a) == pid]
            if not agents:
                raise ValueError(f"policy {pid!r} maps to no agent")
            a0 = agents[0]
            specs[pid] = {**self.envs[0].observation_spec(a0),
                          **self.envs[0].action_spec(a0)}
        self.module = MultiRLModule(
            specs, hidden=module_spec.get("hidden", (64, 64)),
            device=self.device)
        self.params = self.module.init(seed)
        self.rng = make_generator(seed + 1, self.device)
        self.obs = [env.reset(seed=seed + i)
                    for i, env in enumerate(self.envs)]
        self._returns = np.zeros(num_envs)
        self._completed: List[float] = []
        self._steps_sampled = 0

    def env_spec(self) -> Dict[str, Any]:
        return {pid: dict(self.module.specs[pid])
                for pid in self.policies}

    def set_weights(self, params):
        from ..core.rl_module import to_device_params

        self.params = to_device_params(params, self.device)

    def get_weights(self):
        return self.params

    def sample(self, num_steps: int) -> Dict[str, Any]:
        import torch

        with torch.no_grad():
            return self._sample(num_steps)

    def _host(self, x) -> np.ndarray:
        return x.detach().cpu().numpy()

    def _sample(self, num_steps: int) -> Dict[str, Any]:
        import torch

        # per-policy rows, each step: obs/action/... stacked over the
        # (env, agent) pairs that policy controls
        per_policy_agents = {
            pid: [a for a in self.agents
                  if self.policy_mapping_fn(a) == pid]
            for pid in self.policies}
        rows: Dict[str, List[Dict[str, np.ndarray]]] = {
            pid: [] for pid in self.policies}
        for _ in range(num_steps):
            actions_per_env: List[Dict[str, int]] = [
                {} for _ in range(self.num_envs)]
            for pid in self.policies:
                agents = per_policy_agents[pid]
                obs = np.stack([self.obs[e][a]
                                for e in range(self.num_envs)
                                for a in agents])
                act, extras = self.module.forward_exploration(
                    pid, self.params,
                    torch.as_tensor(obs, device=self.device), self.rng)
                act = self._host(act)
                i = 0
                for e in range(self.num_envs):
                    for a in agents:
                        actions_per_env[e][a] = int(act[i])
                        i += 1
                rows[pid].append(
                    {"obs": obs, "action": act,
                     **{k: self._host(v) for k, v in extras.items()}})
            step_reward = np.zeros(
                (self.num_envs, len(self.agents)), np.float32)
            step_done = np.zeros((self.num_envs, len(self.agents)),
                                 bool)
            for e, env in enumerate(self.envs):
                obs, rew, term, trunc, _ = env.step(actions_per_env[e])
                for ai, a in enumerate(self.agents):
                    step_reward[e, ai] = rew.get(a, 0.0)
                    step_done[e, ai] = bool(term.get(a)) or \
                        bool(trunc.get(a))
                self._returns[e] += sum(rew.values())
                if term.get("__all__") or trunc.get("__all__"):
                    self._completed.append(float(self._returns[e]))
                    self._returns[e] = 0.0
                    obs = env.reset()
                self.obs[e] = obs
            # attach this step's reward/done per policy (its agents)
            for pid in self.policies:
                idx = [self.agents.index(a)
                       for a in per_policy_agents[pid]]
                rows[pid][-1]["reward"] = \
                    step_reward[:, idx].reshape(-1)
                rows[pid][-1]["done"] = step_done[:, idx].reshape(-1)
        batches = {}
        for pid in self.policies:
            batch = {k: np.stack([r[k] for r in rows[pid]])
                     for k in rows[pid][0]}
            # bootstrap value of the post-rollout obs (GAE tail)
            agents = per_policy_agents[pid]
            final_obs = np.stack([self.obs[e][a]
                                  for e in range(self.num_envs)
                                  for a in agents])
            batch["final_vf"] = self._host(self.module.value(
                pid, self.params,
                torch.as_tensor(final_obs, device=self.device)))
            batches[pid] = batch
        self._steps_sampled += num_steps * self.num_envs
        done, self._completed = self._completed, []
        stats = {"episodes_this_iter": len(done),
                 "env_steps_sampled": self._steps_sampled}
        if done:
            stats["episode_return_mean"] = float(np.mean(done))
        return {"batches": batches, "stats": stats}


class MultiAgentEnvRunnerGroup:
    """N remote multi-agent runners + weight broadcast (reference:
    env_runner_group.py over MultiAgentEnvRunner)."""

    def __init__(self, *, env_name, policies, policy_mapping_fn,
                 module_spec, num_runners: int = 0,
                 num_envs_per_runner: int = 4, seed: int = 0, device=None):
        from ..._device import resolve_device
        from .env_runner import gpu_share

        dev = resolve_device(device)
        self.local = num_runners == 0
        # mapping fns / env creators travel as actor-constructor args:
        # register their driver-only modules for by-value pickling or the
        # runner actor dies unpickling them
        from ..._private.common import _ensure_picklable_by_value

        _ensure_picklable_by_value(policy_mapping_fn)
        if callable(env_name):
            _ensure_picklable_by_value(env_name)
        kwargs = dict(env_name=env_name, policies=policies,
                      policy_mapping_fn=policy_mapping_fn,
                      module_spec=module_spec,
                      num_envs=num_envs_per_runner)
        if self.local:
            self.runner = MultiAgentEnvRunner(seed=seed, device=dev,
                                              **kwargs)
            self.actors = []
        else:
            opts = {"num_cpus": 1, **gpu_share(dev, num_runners)}
            Remote = rt.remote(MultiAgentEnvRunner).options(**opts)
            self.actors = [Remote.remote(seed=seed + 1000 * i,
                                         device=dev.type,
                                         cpu_threads=opts["num_cpus"],
                                         **kwargs)
                           for i in range(num_runners)]

    def env_spec(self):
        if self.local:
            return self.runner.env_spec()
        return rt.get(self.actors[0].env_spec.remote())

    def sample(self, num_steps: int):
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

    def stop(self):
        for a in self.actors:
            try:
                rt.kill(a)
            except Exception:
                pass
