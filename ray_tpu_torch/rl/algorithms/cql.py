"""CQL: conservative Q-learning for offline RL.

The port of ``ray_tpu/rl/algorithms/cql.py`` (reference:
rllib/algorithms/cql/cql.py, torch/cql_torch_learner.py — SAC's learner
plus the conservative regularizer).  Discrete-action variant (CQL(H),
Kumar et al. 2020 eq. 4): the critic loss adds

    E_s[ logsumexp_a Q(s, a) - Q(s, a_data) ]

which pushes down Q on out-of-distribution actions and up on dataset
actions — exact (no sampled actions) in the discrete case, a dense
[batch, actions] logsumexp.  Q(s, a_data) is a one-hot product
(``rl_module.take_action_logp``); the target net moves by SAC's Polyak
average.

Offline data comes the same way as MARWIL/BC: file paths, an
``OfflineData``, a Dataset, or any iterable of sample dicts with {obs,
action, reward, done, next_obs}.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..core.learner import Learner, LearnerGroup
from ..core.rl_module import QModule, take_action_logp
from .algorithm import Algorithm, AlgorithmConfig
from .sac import polyak


class CQLLearner(Learner):
    def __init__(self, module: QModule, *, gamma: float = 0.99,
                 cql_alpha: float = 1.0, tau: float = 0.005, **kwargs):
        self.gamma = gamma
        self.cql_alpha = cql_alpha
        self.tau = tau
        super().__init__(module, **kwargs)

    def _trainable(self, params):
        return {"q": params["q"]}

    def _merge(self, params, trained):
        return {**trained, "target_q": params["target_q"]}

    def compute_loss(self, params, batch, rng):
        q_all = self.module.q_values(params, batch["obs"])
        q_data = take_action_logp(q_all, batch["action"])
        # double-DQN style target from the frozen net
        with torch.no_grad():
            next_q_online = self.module.q_values(params, batch["next_obs"])
            next_a = torch.argmax(next_q_online, dim=-1)
            next_q_target = self.module.q_values(params, batch["next_obs"],
                                                 target=True)
            next_q = take_action_logp(next_q_target, next_a)
            nonterminal = 1.0 - batch["done"].to(torch.float32)
            td_target = batch["reward"] + self.gamma * nonterminal * next_q
        bellman = 0.5 * torch.mean((q_data - td_target) ** 2)
        # the conservative term: logsumexp over all actions minus the
        # dataset action's Q (CQL(H), exact for discrete actions)
        conservative = torch.mean(torch.logsumexp(q_all, dim=-1) - q_data)
        loss = bellman + self.cql_alpha * conservative
        return loss, {"bellman_loss": bellman,
                      "cql_loss": conservative,
                      "mean_q_data": torch.mean(q_data),
                      "mean_q_max": torch.mean(torch.max(q_all, dim=-1)[0])}

    def extra_update(self, params, metrics):
        # polyak target update (SAC-style, reference cql keeps SAC's)
        return {**params,
                "target_q": polyak(params["target_q"], params["q"],
                                   self.tau)}


def transitions_from_rollout(batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """[T, B] rollout arrays -> flat {obs, action, reward, done, next_obs}
    transitions (next_obs shifted along T; the last step of each column
    is dropped since its successor is unknown)."""
    obs = np.asarray(batch["obs"])
    flat = lambda a: a.reshape(-1, *a.shape[2:])  # noqa: E731
    return {
        "obs": flat(obs[:-1]),
        "next_obs": flat(obs[1:]),
        "action": flat(np.asarray(batch["action"])[:-1]),
        "reward": flat(np.asarray(batch["reward"], np.float32)[:-1]),
        "done": flat(np.asarray(batch["done"], bool)[:-1]),
    }


class CQLConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.cql_alpha = 1.0
        self.tau = 0.005
        self.num_epochs = 1
        self.minibatch_size = 256
        #: offline experience: iterable of flat transition dicts
        #: ({obs, action, reward, done, next_obs}) or [T,B] rollouts
        self.offline_data: Optional[Iterable[Dict[str, Any]]] = None

    algo_cls = None

    def offline(self, data: Iterable[Dict[str, Any]]):
        self.offline_data = data
        return self


class CQL(Algorithm):
    """Offline when config.offline_data is set; otherwise trains
    conservatively on its own rollouts (smoke mode)."""

    module_kind = "q"

    def _setup(self):
        cfg: CQLConfig = self.config
        spec = self.env_spec
        device = self._learner_device()

        def factory():
            module = QModule(spec["obs_dim"], spec["num_actions"],
                             cfg.hidden, device=device)
            return CQLLearner(module, gamma=cfg.gamma,
                              cql_alpha=cfg.cql_alpha, tau=cfg.tau,
                              lr=cfg.lr, seed=cfg.seed)

        self.learner_group = LearnerGroup(factory, cfg.num_learners,
                                          self._learner_options())
        self.runners.sync_weights(self.learner_group.get_weights())
        from ..offline import resolve_offline_data

        # file paths / OfflineData / Dataset / legacy in-memory iterable
        # all land here as flat numpy transition batches (reference:
        # offline_data.py:22 feeds ray.data into the learner)
        self._offline: List[Dict[str, np.ndarray]] = resolve_offline_data(
            cfg.offline_data, gamma=cfg.gamma,
            batch_size=cfg.minibatch_size)
        self._rng = np.random.RandomState(cfg.seed)

    def _offline_minibatches(self):
        cfg: CQLConfig = self.config
        all_idx = [(i, j) for i, d in enumerate(self._offline)
                   for j in range(0, len(d["obs"]), cfg.minibatch_size)]
        self._rng.shuffle(all_idx)
        for i, j in all_idx:
            d = self._offline[i]
            yield {k: v[j:j + cfg.minibatch_size] for k, v in d.items()}

    def training_step(self) -> Dict[str, Any]:
        cfg: CQLConfig = self.config
        metrics: Dict[str, float] = {}
        if self._offline:
            for _ in range(cfg.num_epochs):
                for mb in self._offline_minibatches():
                    metrics = self.learner_group.update(mb)
            self.runners.sync_weights(self.learner_group.get_weights())
            return metrics
        results = self.runners.sample(cfg.rollout_len)
        batch, stats = self._merge_runner_results(results)
        metrics = self.learner_group.update(transitions_from_rollout(batch))
        self.runners.sync_weights(self.learner_group.get_weights())
        metrics.update(stats)
        return metrics


CQLConfig.algo_cls = CQL
