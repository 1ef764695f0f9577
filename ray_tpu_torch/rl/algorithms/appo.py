"""APPO: asynchronous PPO — IMPALA's architecture with PPO's loss.

The port of ``ray_tpu/rl/algorithms/appo.py`` (reference:
rllib/algorithms/appo/appo.py, torch/appo_torch_learner.py): sampling
uses possibly-stale behavior weights (like IMPALA), the learner corrects
off-policyness with V-trace and optimizes the PPO clipped surrogate
against a periodically-updated *target* policy network, plus a KL
penalty pulling the learner policy toward the target (reference:
appo.py `use_kl_loss`, `kl_coeff`, `target_network_update_freq`).

V-trace is IMPALA's; the target network (``target_pi``) is not
trainable, holds no optimizer state, and is refreshed by a copy in
``extra_update``, outside the gradient step.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.learner import Learner, LearnerGroup
from ..core.rl_module import (DiscretePolicyModule, _mlp_apply,
                              take_action_logp, tree_map)
from .algorithm import Algorithm, AlgorithmConfig
from .impala import vtrace


class APPOLearner(Learner):
    def __init__(self, module: DiscretePolicyModule, *,
                 gamma: float = 0.99, clip_param: float = 0.3,
                 vf_coeff: float = 0.5, entropy_coeff: float = 0.01,
                 kl_coeff: float = 0.2, clip_rho: float = 1.0,
                 clip_c: float = 1.0,
                 target_update_freq: int = 4, **kwargs):
        self.gamma = gamma
        self.clip_param = clip_param
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff
        self.kl_coeff = kl_coeff
        self.clip_rho = clip_rho
        self.clip_c = clip_c
        self.target_update_freq = target_update_freq
        self._updates_since_target = 0
        super().__init__(module, **kwargs)
        # target policy: a frozen copy refreshed every N updates
        self.params = {**self.params,
                       "target_pi": tree_map(torch.clone,
                                             self.params["pi"])}

    def _trainable(self, params):
        return {"pi": params["pi"], "vf": params["vf"]}

    def _merge(self, params, trained):
        return {**trained, "target_pi": params["target_pi"]}

    def compute_loss(self, params, batch, rng):
        # batch arrives [B, T]; V-trace wants time-major
        batch = dict(batch)
        for k in ("obs", "action", "reward", "done", "logp"):
            batch[k] = batch[k].transpose(0, 1)
        logits = self.module.logits(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        target_logp = take_action_logp(logp_all, batch["action"])
        values = self.module.value(params, batch["obs"])

        # V-trace targets use the *target network's* action probabilities
        # as the stable "current" policy (reference: APPO computes
        # advantages against the target net so the surrogate's anchor
        # doesn't move every SGD step)
        tgt_logits = self._target_logits(params, batch["obs"])
        tgt_logp_all = torch.log_softmax(tgt_logits, dim=-1)
        tgt_logp = take_action_logp(tgt_logp_all, batch["action"])

        vs, pg_adv = vtrace(batch["logp"], tgt_logp, batch["reward"],
                            batch["done"], values, batch["final_vf"],
                            self.gamma, self.clip_rho, self.clip_c)

        # PPO clipped surrogate with the behavior policy in the ratio
        ratio = torch.exp(target_logp - batch["logp"])
        surr = torch.minimum(
            ratio * pg_adv,
            torch.clip(ratio, 1 - self.clip_param,
                       1 + self.clip_param) * pg_adv)
        pi_loss = -torch.mean(surr)
        vf_loss = 0.5 * torch.mean((values - vs) ** 2)
        entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all,
                                        dim=-1))
        # KL(target || learner): keeps the learner near the anchor
        kl = torch.mean(torch.sum(
            torch.exp(tgt_logp_all) * (tgt_logp_all - logp_all), dim=-1))
        loss = pi_loss + self.vf_coeff * vf_loss \
            - self.entropy_coeff * entropy + self.kl_coeff * kl
        return loss, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                      "entropy": entropy, "kl": kl,
                      "mean_ratio": torch.mean(ratio)}

    def _target_logits(self, params, obs):
        with torch.no_grad():
            return _mlp_apply(params["target_pi"], obs)

    def extra_update(self, params, metrics):
        self._updates_since_target += 1
        if self._updates_since_target >= self.target_update_freq:
            self._updates_since_target = 0
            params = {**params,
                      "target_pi": tree_map(torch.clone, params["pi"])}
        return params


class APPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.clip_param = 0.3
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.kl_coeff = 0.2
        self.clip_rho = 1.0
        self.clip_c = 1.0
        self.target_update_freq = 4

    algo_cls = None


class APPO(Algorithm):
    module_kind = "policy"

    def _setup(self):
        cfg: APPOConfig = self.config
        spec = self.env_spec
        device = self._learner_device()

        def factory():
            module = DiscretePolicyModule(spec["obs_dim"],
                                          spec["num_actions"], cfg.hidden,
                                          device=device)
            return APPOLearner(
                module, gamma=cfg.gamma, clip_param=cfg.clip_param,
                vf_coeff=cfg.vf_coeff, entropy_coeff=cfg.entropy_coeff,
                kl_coeff=cfg.kl_coeff, clip_rho=cfg.clip_rho,
                clip_c=cfg.clip_c,
                target_update_freq=cfg.target_update_freq,
                lr=cfg.lr, seed=cfg.seed)

        self.learner_group = LearnerGroup(factory, cfg.num_learners,
                                          self._learner_options())
        self.runners.sync_weights(self.learner_group.get_weights())

    def training_step(self) -> Dict[str, Any]:
        cfg: APPOConfig = self.config
        results = self.runners.sample(cfg.rollout_len)
        batch, stats = self._merge_runner_results(results)
        update_batch = {
            k: np.swapaxes(np.asarray(batch[k]), 0, 1)
            for k in ("obs", "action", "reward", "done", "logp")
        }
        update_batch["final_vf"] = np.asarray(batch["final_vf"])
        metrics = self.learner_group.update(update_batch)
        self.runners.sync_weights(self.learner_group.get_weights())
        metrics.update(stats)
        return metrics


APPOConfig.algo_cls = APPO
