"""MARWIL + BC: offline policy learning from logged experience.

The port of ``ray_tpu/rl/algorithms/marwil.py`` (reference:
rllib/algorithms/marwil/marwil.py, torch/marwil_torch_learner.py;
rllib/algorithms/bc/bc.py — BC is MARWIL with beta=0): exponentially
advantage-weighted behavior cloning with a value baseline.  The
advantage's scale is the batch's root mean square, as in the JAX
package (the reference keeps a moving average).  Offline data comes
from file paths, an ``OfflineData``, a Dataset, or any iterable of
sample dicts (e.g. rollouts recorded by an EnvRunnerGroup).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..core.learner import Learner, LearnerGroup
from ..core.rl_module import DiscretePolicyModule, take_action_logp
from .algorithm import Algorithm, AlgorithmConfig


class MarwilLearner(Learner):
    def __init__(self, module: DiscretePolicyModule, *, beta: float = 1.0,
                 vf_coeff: float = 1.0, advantage_clip: float = 10.0,
                 **kwargs):
        self.beta = beta
        self.vf_coeff = vf_coeff
        self.advantage_clip = advantage_clip
        super().__init__(module, **kwargs)

    def compute_loss(self, params, batch, rng):
        logits = self.module.logits(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = take_action_logp(logp_all, batch["action"])
        value = self.module.value(params, batch["obs"])
        returns = batch["return"]
        vf_loss = torch.mean((value - returns) ** 2)
        if self.beta == 0.0:
            # plain behavior cloning
            weights = torch.ones_like(logp)
        else:
            with torch.no_grad():
                adv = returns - value
                rms = torch.sqrt(torch.mean(adv ** 2) + 1e-8)
                weights = torch.exp(torch.clip(self.beta * adv / rms,
                                               -self.advantage_clip,
                                               self.advantage_clip))
        pi_loss = -torch.mean(weights * logp)
        loss = pi_loss + self.vf_coeff * vf_loss * float(self.beta != 0.0)
        entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all,
                                        dim=-1))
        return loss, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                      "entropy": entropy,
                      "mean_weight": torch.mean(weights)}


def episodes_to_batch(batch: Dict[str, np.ndarray],
                      gamma: float) -> Dict[str, np.ndarray]:
    """[T, B] rollout arrays -> flat {obs, action, return} with
    discounted reward-to-go computed per column, resetting at dones."""
    rewards = np.asarray(batch["reward"], np.float32)
    dones = np.asarray(batch["done"], bool)
    T = rewards.shape[0]
    returns = np.zeros_like(rewards)
    acc = np.zeros(rewards.shape[1], np.float32)
    for t in range(T - 1, -1, -1):
        acc = rewards[t] + gamma * acc * (~dones[t])
        returns[t] = acc
    flat = lambda a: np.asarray(a).reshape(-1, *np.asarray(a).shape[2:])  # noqa
    return {"obs": flat(batch["obs"]),
            "action": flat(batch["action"]),
            "return": returns.reshape(-1)}


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.beta = 1.0
        self.vf_coeff = 1.0
        self.lr = 1e-3
        self.num_epochs = 1
        self.minibatch_size = 512
        #: offline experience: list of flat sample dicts
        #: ({obs, action, return}) or [T,B] rollout dicts
        self.offline_data: Optional[Iterable[Dict[str, Any]]] = None

    algo_cls = None

    def offline(self, data: Iterable[Dict[str, Any]]):
        self.offline_data = data
        return self


class MARWIL(Algorithm):
    """Offline when config.offline_data is set; otherwise clones its own
    rollouts (useful as a smoke test / for on-policy distillation)."""

    module_kind = "policy"

    def _setup(self):
        cfg: MARWILConfig = self.config
        spec = self.env_spec
        device = self._learner_device()

        def factory():
            module = DiscretePolicyModule(spec["obs_dim"],
                                          spec["num_actions"], cfg.hidden,
                                          device=device)
            return MarwilLearner(module, beta=cfg.beta,
                                 vf_coeff=cfg.vf_coeff,
                                 lr=cfg.lr, seed=cfg.seed)

        self.learner_group = LearnerGroup(factory, cfg.num_learners,
                                          self._learner_options())
        self.runners.sync_weights(self.learner_group.get_weights())
        from ..offline import resolve_offline_data

        # file paths / OfflineData / Dataset / legacy in-memory iterable
        # (reference: offline_data.py:22 feeds ray.data into the learner)
        self._offline: List[Dict[str, np.ndarray]] = resolve_offline_data(
            cfg.offline_data, gamma=cfg.gamma,
            batch_size=cfg.minibatch_size, want_return=True)
        self._rng = np.random.RandomState(cfg.seed)

    def _offline_minibatches(self):
        cfg: MARWILConfig = self.config
        data = self._offline
        all_idx = [(i, j) for i, d in enumerate(data)
                   for j in range(0, len(d["obs"]), cfg.minibatch_size)]
        self._rng.shuffle(all_idx)
        for i, j in all_idx:
            d = data[i]
            yield {k: v[j:j + cfg.minibatch_size] for k, v in d.items()}

    def training_step(self) -> Dict[str, Any]:
        cfg: MARWILConfig = self.config
        metrics: Dict[str, float] = {}
        if self._offline:
            for _ in range(cfg.num_epochs):
                for mb in self._offline_minibatches():
                    metrics = self.learner_group.update(mb)
            self.runners.sync_weights(self.learner_group.get_weights())
            return metrics
        # no dataset: clone own behavior (BC smoke mode)
        results = self.runners.sample(cfg.rollout_len)
        batch, stats = self._merge_runner_results(results)
        flat = episodes_to_batch(batch, cfg.gamma)
        metrics = self.learner_group.update(flat)
        self.runners.sync_weights(self.learner_group.get_weights())
        metrics.update(stats)
        return metrics


MARWILConfig.algo_cls = MARWIL


class BCConfig(MARWILConfig):
    """Behavior cloning = MARWIL with beta=0 (reference: bc.py)."""

    def __init__(self):
        super().__init__()
        self.beta = 0.0


class BC(MARWIL):
    pass


BCConfig.algo_cls = BC
