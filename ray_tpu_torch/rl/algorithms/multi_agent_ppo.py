"""Multi-agent PPO: one PPO learner per policy over shared experience.

Analog of the reference's multi-agent stack (reference:
rllib/env/multi_agent_env.py:32 + rllib/core/rl_module/multi_rl_module.py
+ ppo trained per policy via policies/policy_mapping_fn in
AlgorithmConfig.multi_agent()): agents map onto policies, each policy
trains a separate clipped-surrogate PPO loss on exactly the transitions
its agents generated.  The port of
``ray_tpu/rl/algorithms/multi_agent_ppo.py``; its learners and runners
compute on ``config.device`` (the card unless the caller asks for the
CPU).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core.learner import LearnerGroup
from ..core.rl_module import DiscretePolicyModule
from ..env.multi_agent_env import MultiAgentEnvRunnerGroup

from .algorithm import Algorithm, AlgorithmConfig, merge_batches
from .ppo import PPOLearner, ppo_update_on_batch


class MultiAgentPPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.2
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.0
        self.gae_lambda = 0.95
        self.num_epochs = 4
        self.minibatch_size = 256
        self.lr = 3e-4
        self.policies: List[str] = []
        self.policy_mapping_fn: Optional[Callable[[str], str]] = None

    def multi_agent(self, *, policies: List[str],
                    policy_mapping_fn: Callable[[str], str]
                    ) -> "MultiAgentPPOConfig":
        """(reference: AlgorithmConfig.multi_agent)"""
        self.policies = list(policies)
        self.policy_mapping_fn = policy_mapping_fn
        return self


class MultiAgentPPO(Algorithm):
    def __init__(self, config: MultiAgentPPOConfig):
        if not config.policies or config.policy_mapping_fn is None:
            raise ValueError(
                "MultiAgentPPO needs config.multi_agent(policies=..., "
                "policy_mapping_fn=...)")
        self.config = config
        self.iteration = 0
        self.runners = MultiAgentEnvRunnerGroup(
            env_name=config.env_name,
            policies=config.policies,
            policy_mapping_fn=config.policy_mapping_fn,
            module_spec={"hidden": config.hidden},
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            seed=config.seed,
            device=config.device,
        )
        self.env_spec = self.runners.env_spec()  # {pid: spec}
        self._setup()
        self._last_stats: Dict[str, Any] = {}

    def _setup(self):
        cfg = self.config
        self.learner_groups: Dict[str, LearnerGroup] = {}
        device = self._learner_device()
        for pid in cfg.policies:
            spec = self.env_spec[pid]

            def factory(spec=spec):
                module = DiscretePolicyModule(
                    spec["obs_dim"], spec["num_actions"], cfg.hidden,
                    device=device)
                return PPOLearner(module, clip_param=cfg.clip_param,
                                  vf_coeff=cfg.vf_coeff,
                                  entropy_coeff=cfg.entropy_coeff,
                                  lr=cfg.lr, seed=cfg.seed)

            self.learner_groups[pid] = LearnerGroup(
                factory, cfg.num_learners, self._learner_options())
        self.runners.sync_weights(self._weights())

    def _weights(self) -> Dict[str, Any]:
        return {pid: g.get_weights()
                for pid, g in self.learner_groups.items()}

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        results = self.runners.sample(cfg.rollout_len)
        stats: Dict[str, Any] = {
            "episodes_this_iter": sum(
                r["stats"].get("episodes_this_iter", 0)
                for r in results),
            "env_steps_sampled": sum(
                r["stats"].get("env_steps_sampled", 0)
                for r in results)}
        rets = [r["stats"]["episode_return_mean"] for r in results
                if "episode_return_mean" in r["stats"]]
        if rets:
            stats["episode_return_mean"] = float(np.mean(rets))

        rng = np.random.default_rng(cfg.seed + self.iteration)
        for pid, group in self.learner_groups.items():
            batch = merge_batches([r["batches"][pid] for r in results])
            metrics = ppo_update_on_batch(group, batch, cfg, rng)
            for k, v in metrics.items():
                stats[f"{pid}/{k}"] = v
        self.runners.sync_weights(self._weights())
        return stats

    def save(self, path: str):
        import pickle

        with open(path, "wb") as f:
            pickle.dump({"iteration": self.iteration,
                         "learner_state": {
                             pid: g.state()
                             for pid, g in self.learner_groups.items()}},
                        f)

    def restore(self, path: str):
        import pickle

        with open(path, "rb") as f:
            state = pickle.load(f)
        self.iteration = state["iteration"]
        for pid, s in state["learner_state"].items():
            self.learner_groups[pid].load_state(s)
        self.runners.sync_weights(self._weights())

    def stop(self):
        self.runners.stop()
        for g in self.learner_groups.values():
            g.stop()


MultiAgentPPOConfig.algo_cls = MultiAgentPPO
