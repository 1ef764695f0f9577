"""PPO: clipped-surrogate policy optimization with GAE.

The port of ``ray_tpu/rl/algorithms/ppo.py`` (reference:
rllib/algorithms/ppo/ppo.py, ppo_learner.py,
torch/ppo_torch_learner.py): GAE is a reverse loop over the time axis;
the minibatch epoch loop keeps the reference's host-side steps
(advantage normalisation with numpy's population std, the permutation
from the caller's numpy ``Generator``), so with the same batch and the
same numpy seed the whole update is comparable with the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.learner import LearnerGroup
from ..core.learner import Learner
from ..core.rl_module import DiscretePolicyModule, take_action_logp
from .algorithm import Algorithm, AlgorithmConfig


def compute_gae(rewards, dones, values, final_value, gamma, lam):
    """[T, B] tensors -> (advantages, value targets) via a reverse loop
    (reference: rllib general_advantage_estimation connector)."""
    with torch.no_grad():
        nonterminal = 1.0 - dones.to(torch.float32)
        next_adv = torch.zeros_like(final_value)
        next_value = final_value
        advs = [None] * rewards.shape[0]
        for t in range(rewards.shape[0] - 1, -1, -1):
            delta = rewards[t] + gamma * next_value * nonterminal[t] \
                - values[t]
            next_adv = delta + gamma * lam * nonterminal[t] * next_adv
            next_value = values[t]
            advs[t] = next_adv
        advs = torch.stack(advs)
    return advs, advs + values


class PPOLearner(Learner):
    def __init__(self, module: DiscretePolicyModule, *,
                 clip_param: float = 0.2, vf_coeff: float = 0.5,
                 entropy_coeff: float = 0.0, **kwargs):
        self.clip_param = clip_param
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff
        super().__init__(module, **kwargs)

    def compute_loss(self, params, batch, rng):
        logits = self.module.logits(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = take_action_logp(logp_all, batch["action"])
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["advantage"]
        surrogate = torch.minimum(
            ratio * adv,
            torch.clip(ratio, 1 - self.clip_param,
                       1 + self.clip_param) * adv)
        pi_loss = -torch.mean(surrogate)
        value = self.module.value(params, batch["obs"])
        vf_loss = torch.mean((value - batch["value_target"]) ** 2)
        entropy = -torch.mean(
            torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        loss = pi_loss + self.vf_coeff * vf_loss \
            - self.entropy_coeff * entropy
        return loss, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                      "entropy": entropy,
                      "clip_frac": torch.mean(
                          (torch.abs(ratio - 1) > self.clip_param)
                          .to(torch.float32))}


def ppo_update_on_batch(learner_group, batch, cfg, rng) -> Dict[str, float]:
    """GAE -> advantage normalization -> minibatched epoch loop: the PPO
    update procedure shared by single- and multi-agent PPO (one owner —
    a fix here reaches both paths).  GAE runs on the host's CPU on the
    runners' numpy batch; each minibatch crosses to the learner's device
    in ``Learner.update``."""
    t = {k: torch.as_tensor(np.asarray(batch[k]))
         for k in ("reward", "done", "vf", "final_vf")}
    adv, vtarg = compute_gae(t["reward"].to(torch.float32), t["done"],
                             t["vf"].to(torch.float32),
                             t["final_vf"].to(torch.float32),
                             cfg.gamma, cfg.gae_lambda)
    adv = adv.numpy().reshape(-1)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    flat = {
        "obs": np.asarray(batch["obs"]).reshape(-1, batch["obs"].shape[-1]),
        "action": np.asarray(batch["action"]).reshape(-1),
        "logp_old": np.asarray(batch["logp"]).reshape(-1),
        "advantage": adv,
        "value_target": vtarg.numpy().reshape(-1),
    }
    n = flat["obs"].shape[0]
    metrics: Dict[str, float] = {}
    for _ in range(cfg.num_epochs):
        perm = rng.permutation(n)
        for lo in range(0, n, cfg.minibatch_size):
            idx = perm[lo:lo + cfg.minibatch_size]
            metrics = learner_group.update(
                {k: v[idx] for k, v in flat.items()})
    return metrics


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.2
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.0
        self.gae_lambda = 0.95
        self.num_epochs = 4
        self.minibatch_size = 256
        self.lr = 3e-4


class PPO(Algorithm):
    module_kind = "policy"

    def _setup(self):
        cfg: PPOConfig = self.config
        spec = self.env_spec
        device = self._learner_device()

        def factory():
            module = DiscretePolicyModule(spec["obs_dim"],
                                          spec["num_actions"], cfg.hidden,
                                          device=device)
            return PPOLearner(module, clip_param=cfg.clip_param,
                              vf_coeff=cfg.vf_coeff,
                              entropy_coeff=cfg.entropy_coeff,
                              lr=cfg.lr, seed=cfg.seed)

        self.learner_group = LearnerGroup(factory, cfg.num_learners,
                                          self._learner_options())
        self.runners.sync_weights(self.learner_group.get_weights())

    def training_step(self) -> Dict[str, Any]:
        cfg: PPOConfig = self.config
        results = self.runners.sample(cfg.rollout_len)
        batch, stats = self._merge_runner_results(results)
        rng = np.random.default_rng(cfg.seed + self.iteration)
        metrics = ppo_update_on_batch(self.learner_group, batch, cfg, rng)
        self.runners.sync_weights(self.learner_group.get_weights())
        return {**stats, **metrics}


PPOConfig.algo_cls = PPO
