"""IMPALA: importance-weighted actor-critic with V-trace.

The port of ``ray_tpu/rl/algorithms/impala.py`` (reference:
rllib/algorithms/impala/impala.py, torch/vtrace_torch_v2.py): actors
sample with a (possibly stale) behavior policy; the learner corrects
off-policyness with V-trace truncated importance weights.  V-trace is a
reverse loop over the time axis on [T, B] tensors, on the learner's
device, with no host sync.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.learner import Learner, LearnerGroup
from ..core.rl_module import DiscretePolicyModule, take_action_logp
from .algorithm import Algorithm, AlgorithmConfig


def vtrace(behavior_logp, target_logp, rewards, dones, values, final_value,
           gamma, clip_rho: float = 1.0, clip_c: float = 1.0):
    """V-trace targets + policy-gradient advantages over [T, B] tensors
    (Espeholt et al. 2018, eq. 1), f32, outside the gradient."""
    with torch.no_grad():
        rho = torch.exp(target_logp - behavior_logp)
        rho_bar = torch.clamp(rho, max=clip_rho)
        c_bar = torch.clamp(rho, max=clip_c)
        nonterminal = 1.0 - dones.to(torch.float32)
        next_values = torch.cat([values[1:], final_value[None]], dim=0)
        deltas = rho_bar * (rewards + gamma * next_values * nonterminal
                            - values)
        acc = torch.zeros_like(final_value)
        out = [None] * deltas.shape[0]
        for t in range(deltas.shape[0] - 1, -1, -1):
            acc = deltas[t] + gamma * c_bar[t] * nonterminal[t] * acc
            out[t] = acc
        vs = torch.stack(out) + values
        next_vs = torch.cat([vs[1:], final_value[None]], dim=0)
        pg_adv = rho_bar * (rewards + gamma * next_vs * nonterminal - values)
    return vs.detach(), pg_adv.detach()


class ImpalaLearner(Learner):
    def __init__(self, module: DiscretePolicyModule, *,
                 gamma: float = 0.99, vf_coeff: float = 0.5,
                 entropy_coeff: float = 0.01, clip_rho: float = 1.0,
                 clip_c: float = 1.0, **kwargs):
        self.gamma = gamma
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff
        self.clip_rho = clip_rho
        self.clip_c = clip_c
        super().__init__(module, **kwargs)

    def compute_loss(self, params, batch, rng):
        # batch arrives [B, T] (batch-major so LearnerGroup's axis-0
        # sharding splits episodes, not time); V-trace wants time-major
        batch = dict(batch)
        for k in ("obs", "action", "reward", "done", "logp"):
            batch[k] = batch[k].transpose(0, 1)
        logits = self.module.logits(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        target_logp = take_action_logp(logp_all, batch["action"])
        values = self.module.value(params, batch["obs"])
        vs, pg_adv = vtrace(batch["logp"], target_logp, batch["reward"],
                            batch["done"], values, batch["final_vf"],
                            self.gamma, self.clip_rho, self.clip_c)
        pi_loss = -torch.mean(pg_adv * target_logp)
        vf_loss = 0.5 * torch.mean((values - vs) ** 2)
        entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all,
                                        dim=-1))
        loss = pi_loss + self.vf_coeff * vf_loss \
            - self.entropy_coeff * entropy
        return loss, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                      "entropy": entropy,
                      "mean_rho": torch.mean(
                          torch.exp(target_logp - batch["logp"]))}


def make_impala_learner(env_spec: Dict[str, Any],
                        hidden=(64, 64), device=None,
                        **hyperparams) -> ImpalaLearner:
    """A standalone ImpalaLearner over the default discrete policy
    module on ``device`` — the piece Podracer shares with the Impala
    Algorithm without dragging in runner groups (see rl/podracer.py).
    ``hyperparams`` pass through to ImpalaLearner/Learner (gamma,
    vf_coeff, entropy_coeff, clip_rho, clip_c, lr, grad_clip, seed, ...)."""
    module = DiscretePolicyModule(env_spec["obs_dim"],
                                  env_spec["num_actions"], hidden,
                                  device=device)
    return ImpalaLearner(module, **hyperparams)


class ImpalaConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.clip_rho = 1.0
        self.clip_c = 1.0

    algo_cls = None  # set below


class Impala(Algorithm):
    module_kind = "policy"

    def _setup(self):
        cfg: ImpalaConfig = self.config
        spec = self.env_spec
        device = self._learner_device()

        def factory():
            module = DiscretePolicyModule(spec["obs_dim"],
                                          spec["num_actions"], cfg.hidden,
                                          device=device)
            return ImpalaLearner(module, gamma=cfg.gamma,
                                 vf_coeff=cfg.vf_coeff,
                                 entropy_coeff=cfg.entropy_coeff,
                                 clip_rho=cfg.clip_rho, clip_c=cfg.clip_c,
                                 lr=cfg.lr, seed=cfg.seed)

        self.learner_group = LearnerGroup(factory, cfg.num_learners,
                                          self._learner_options())
        self.runners.sync_weights(self.learner_group.get_weights())

    def training_step(self) -> Dict[str, Any]:
        cfg: ImpalaConfig = self.config
        results = self.runners.sample(cfg.rollout_len)
        batch, stats = self._merge_runner_results(results)
        # [T, B] -> [B, T] so every key (incl. final_vf [B]) shards along
        # episodes under LearnerGroup's axis-0 split
        update_batch = {
            k: np.swapaxes(np.asarray(batch[k]), 0, 1)
            for k in ("obs", "action", "reward", "done", "logp")
        }
        update_batch["final_vf"] = np.asarray(batch["final_vf"])
        metrics = self.learner_group.update(update_batch)
        self.runners.sync_weights(self.learner_group.get_weights())
        metrics.update(stats)
        return metrics


ImpalaConfig.algo_cls = Impala
IMPALA = Impala
IMPALAConfig = ImpalaConfig
