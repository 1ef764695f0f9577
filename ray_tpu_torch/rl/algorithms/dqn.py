"""DQN: double Q-learning with target network + replay.

The port of ``ray_tpu/rl/algorithms/dqn.py`` (reference:
rllib/algorithms/dqn/dqn.py, torch/dqn_torch_learner.py):
epsilon-greedy sampling into a replay buffer; double-DQN targets;
periodic target-net hard sync.

Q(s, a) is a one-hot product (``rl_module.take_action_logp``), whose
backward adds in a fixed order on the card.  Epsilon decays through
``runners.set_explore``: the rollout is eager device work with no
compiled program, so a new epsilon every ``train()`` costs nothing
(the reference's jitted rollout retraces on each).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.learner import Learner, LearnerGroup
from ..core.rl_module import QModule, take_action_logp, tree_map
from ..utils.replay_buffer import ReplayBuffer
from .algorithm import Algorithm, AlgorithmConfig


class DQNLearner(Learner):
    def __init__(self, module: QModule, *, gamma: float = 0.99,
                 target_update_freq: int = 100, **kwargs):
        self.gamma = gamma
        self.target_update_freq = target_update_freq
        self._updates = 0
        super().__init__(module, **kwargs)

    # optimizer trains only the online net; the target net syncs by copy
    def _trainable(self, params):
        return params["q"]

    def _merge(self, params, trained):
        return {"q": trained, "target_q": params["target_q"]}

    def compute_loss(self, params, batch, rng):
        q = self.module.q_values(params, batch["obs"])
        q_a = take_action_logp(q, batch["action"])
        with torch.no_grad():
            # double DQN: online net picks, target net evaluates
            next_q_online = self.module.q_values(params, batch["next_obs"])
            next_a = torch.argmax(next_q_online, dim=-1)
            next_q_target = self.module.q_values(params, batch["next_obs"],
                                                 target=True)
            next_q = take_action_logp(next_q_target, next_a)
            target = batch["reward"] + self.gamma * next_q \
                * (1.0 - batch["done"].to(torch.float32))
        loss = torch.mean(optax_huber(q_a - target))
        return loss, {"q_mean": torch.mean(q_a),
                      "target_mean": torch.mean(target)}

    def extra_update(self, params, metrics):
        self._updates += 1
        if self._updates % self.target_update_freq == 0:
            params = {"q": params["q"],
                      "target_q": tree_map(torch.clone, params["q"])}
        return params


def optax_huber(x, delta: float = 1.0):
    abs_x = torch.abs(x)
    return torch.where(abs_x <= delta, 0.5 * x ** 2,
                       delta * (abs_x - 0.5 * delta))


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.buffer_capacity = 50_000
        self.learn_starts = 1000
        self.target_update_freq = 200
        self.epsilon = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_iters = 30
        self.updates_per_iter = 64
        self.train_batch_size = 64
        self.rollout_len = 64


class DQN(Algorithm):
    module_kind = "q"

    def _explore_kwargs(self):
        return {"epsilon": float(self.config.epsilon)}

    def _setup(self):
        cfg: DQNConfig = self.config
        spec = self.env_spec
        device = self._learner_device()

        def factory():
            module = QModule(spec["obs_dim"], spec["num_actions"],
                             cfg.hidden, device=device)
            return DQNLearner(module, gamma=cfg.gamma,
                              target_update_freq=cfg.target_update_freq,
                              lr=cfg.lr, grad_clip=10.0, seed=cfg.seed)

        self.learner_group = LearnerGroup(factory, cfg.num_learners,
                                          self._learner_options())
        self.buffer = ReplayBuffer(cfg.buffer_capacity, seed=cfg.seed)
        self.runners.sync_weights(self.learner_group.get_weights())

    def _epsilon(self) -> float:
        cfg: DQNConfig = self.config
        frac = min(1.0, self.iteration / max(1, cfg.epsilon_decay_iters))
        return float(cfg.epsilon + frac * (cfg.epsilon_final - cfg.epsilon))

    def training_step(self) -> Dict[str, Any]:
        cfg: DQNConfig = self.config
        self.runners.set_explore(epsilon=self._epsilon())
        results = self.runners.sample(cfg.rollout_len)
        batch, stats = self._merge_runner_results(results)

        # [T, B] -> flat transitions with next_obs via time shift;
        # the final step of each rollout bootstraps next iteration
        obs = np.asarray(batch["obs"])          # [T, B, D]
        next_obs = np.roll(obs, -1, axis=0)
        valid = np.ones(obs.shape[:2], bool)
        valid[-1] = False                        # unknown next_obs
        # done steps auto-reset: next_obs is the new episode start, so the
        # (1 - done) mask in the loss already ignores it — keep them.
        flat_idx = valid.reshape(-1)
        flatten = lambda a: a.reshape(-1, *a.shape[2:])[flat_idx]  # noqa
        self.buffer.add_batch({
            "obs": flatten(obs),
            "next_obs": flatten(next_obs),
            "action": flatten(np.asarray(batch["action"])),
            "reward": flatten(np.asarray(batch["reward"])),
            "done": flatten(np.asarray(batch["done"])),
        })

        metrics: Dict[str, float] = {}
        if len(self.buffer) >= cfg.learn_starts:
            for _ in range(cfg.updates_per_iter):
                metrics = self.learner_group.update(
                    self.buffer.sample(cfg.train_batch_size))
            self.runners.sync_weights(self.learner_group.get_weights())
        metrics["epsilon"] = self._epsilon()
        metrics["buffer_size"] = len(self.buffer)
        return {**stats, **metrics}


DQNConfig.algo_cls = DQN
