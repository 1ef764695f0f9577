"""SAC: soft actor-critic with twin Q-nets and learned temperature,
for BOTH action-space families.

The port of ``ray_tpu/rl/algorithms/sac.py`` (reference:
rllib/algorithms/sac/sac.py, torch/sac_torch_learner.py):

  * continuous (Box) — the canonical SAC: SquashedGaussian policy with
    reparameterized sampling through twin Q(s, a) critics (reference:
    sac.py:320-322 requires SquashedGaussian for bounded continuous
    spaces); demonstrated learning on Pendulum in the suite.
  * discrete — the Christodoulou 2019 variant: soft value and policy
    objectives as exact expectations over the action set, dense matmuls
    over [batch, actions].

The algorithm picks the module/learner pair from the env spec
(action_dim => continuous, num_actions => discrete).  Draws: discrete
actions by Gumbel-max (``rl_module.categorical``), the reparameterised
sample from a standard normal; each sampling function takes that noise
as an optional argument, and the continuous loss reads its two draws
through ``rl_module.draw`` ("next", "pi"), so the parity tests can feed
the JAX package's draws to both.  Q(s, a) of a discrete action is a
one-hot product (``take_action_logp``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.learner import Learner, LearnerGroup
from ..core.rl_module import (MODULE_REGISTRY, RLModule, _mlp_apply,
                              _mlp_init, categorical, draw, make_generator,
                              module_for_env, take_action_logp,
                              tree_flatten, tree_map, tree_unflatten)
from ..utils.replay_buffer import ReplayBuffer
from .algorithm import Algorithm, AlgorithmConfig


def _detached(tree):
    return tree_map(lambda x: x.detach(), tree)


class SACModule(RLModule):
    """Policy + twin soft-Q nets (+ polyak targets + log temperature)."""

    def init(self, rng):
        gen = make_generator(rng, self.device)
        sizes = (self.obs_dim, *self.hidden)
        pi = _mlp_init(gen, (*sizes, self.num_actions))
        q1 = _mlp_init(gen, (*sizes, self.num_actions), out_scale=0.01)
        q2 = _mlp_init(gen, (*sizes, self.num_actions), out_scale=0.01)
        return {
            "pi": pi,
            "q1": q1,
            "q2": q2,
            "target_q1": tree_map(torch.clone, q1),
            "target_q2": tree_map(torch.clone, q2),
            "log_alpha": torch.zeros((), device=self.device),
        }

    def logits(self, params, obs):
        return _mlp_apply(params["pi"], obs)

    def q_values(self, params, obs, which: str):
        return _mlp_apply(params[which], obs)

    def forward_exploration(self, params, obs, rng, noise=None):
        """``noise``: the Gumbel draw at the logits' shape."""
        action = categorical(rng, self.logits(params, obs), noise)
        return action, {}

    def forward_inference(self, params, obs):
        return torch.argmax(self.logits(params, obs), dim=-1)


MODULE_REGISTRY["sac"] = SACModule


class SACContinuousModule(RLModule):
    """Squashed-Gaussian policy + twin Q(s,a) critics for Box action
    spaces (reference: rllib/algorithms/sac/sac.py:320-322 — continuous
    spaces get a SquashedGaussian distribution; torch/sac_torch_learner
    uses the reparameterized sample).  Actions are tanh-squashed and
    affine-mapped to [low, high]; log-probs carry the tanh + scale
    Jacobian corrections."""

    LOG_STD_MIN = -20.0
    LOG_STD_MAX = 2.0

    def __init__(self, obs_dim: int, action_dim: int, hidden=(64, 64), *,
                 low=-1.0, high=1.0, device=None):
        super().__init__(obs_dim, action_dim, hidden, device=device)
        self.action_dim = action_dim
        # scalar or per-dimension bounds (heterogeneous Boxes like
        # [steer, gas, brake] scale each dim independently)
        lo = np.broadcast_to(np.asarray(low, np.float32), (action_dim,))
        hi = np.broadcast_to(np.asarray(high, np.float32), (action_dim,))
        if not (np.isfinite(lo).all() and np.isfinite(hi).all()):
            raise ValueError("squashed-Gaussian SAC needs finite action "
                             f"bounds; got low={low} high={high}")
        self.low = torch.as_tensor(lo.copy(), device=self.device)
        self.high = torch.as_tensor(hi.copy(), device=self.device)
        self.scale = (self.high - self.low) / 2.0
        self.center = (self.high + self.low) / 2.0

    def init(self, rng):
        gen = make_generator(rng, self.device)
        pi_sizes = (self.obs_dim, *self.hidden, 2 * self.action_dim)
        q_sizes = (self.obs_dim + self.action_dim, *self.hidden, 1)
        pi = _mlp_init(gen, pi_sizes)
        q1 = _mlp_init(gen, q_sizes, out_scale=0.01)
        q2 = _mlp_init(gen, q_sizes, out_scale=0.01)
        return {
            "pi": pi,
            "q1": q1,
            "q2": q2,
            "target_q1": tree_map(torch.clone, q1),
            "target_q2": tree_map(torch.clone, q2),
            "log_alpha": torch.zeros((), device=self.device),
        }

    def pi_dist(self, params, obs):
        out = _mlp_apply(params["pi"], obs)
        mu, log_std = torch.split(out, self.action_dim, dim=-1)
        log_std = torch.clip(log_std, self.LOG_STD_MIN, self.LOG_STD_MAX)
        return mu, log_std

    def sample_and_logp(self, params, obs, rng,
                        noise: Optional[torch.Tensor] = None):
        """Reparameterized squashed sample -> (env-scaled action [B, A],
        log-prob [B]).  ``noise``: the standard normal draw at mu's
        shape, in place of one from ``rng``."""
        mu, log_std = self.pi_dist(params, obs)
        std = torch.exp(log_std)
        if noise is None:
            noise = torch.randn(mu.shape, generator=rng, device=mu.device,
                                dtype=mu.dtype)
        u = mu + std * noise
        a = torch.tanh(u)
        logp = torch.sum(
            -0.5 * (((u - mu) / std) ** 2 + 2 * log_std
                    + math.log(2 * math.pi))
            - torch.log(1.0 - a ** 2 + 1e-6)
            - torch.log(self.scale), dim=-1)
        return a * self.scale + self.center, logp

    def q_values(self, params, obs, action, which: str):
        """Q(s, a) with the action normalized back to [-1, 1] (the net
        should not have to learn the env's scale)."""
        a_n = (action - self.center) / self.scale
        return _mlp_apply(params[which],
                          torch.cat([obs, a_n], dim=-1))[..., 0]

    def forward_exploration(self, params, obs, rng, noise=None):
        action, _ = self.sample_and_logp(params, obs, rng, noise)
        return action, {}

    def forward_inference(self, params, obs):
        mu, _ = self.pi_dist(params, obs)
        return torch.tanh(mu) * self.scale + self.center


MODULE_REGISTRY["sac_continuous"] = SACContinuousModule


class SACLearner(Learner):
    def __init__(self, module: SACModule, *, gamma: float = 0.99,
                 tau: float = 0.005, target_entropy: float = None,
                 **kwargs):
        self.gamma = gamma
        self.tau = tau
        # default target entropy: 0.98 * max entropy (discrete-SAC paper)
        self.target_entropy = (target_entropy if target_entropy is not None
                               else 0.98 * float(np.log(module.num_actions)))
        super().__init__(module, **kwargs)

    def _trainable(self, params):
        return {"pi": params["pi"], "q1": params["q1"], "q2": params["q2"],
                "log_alpha": params["log_alpha"]}

    def _merge(self, params, trained):
        return {**trained, "target_q1": params["target_q1"],
                "target_q2": params["target_q2"]}

    def compute_loss(self, params, batch, rng):
        m: SACModule = self.module
        alpha = torch.exp(params["log_alpha"]).detach()
        logits = m.logits(params, batch["obs"])
        logp = torch.log_softmax(logits, dim=-1)
        probs = torch.exp(logp)

        # soft target value from the *next* state, exact over actions
        with torch.no_grad():
            next_logp = torch.log_softmax(
                m.logits(params, batch["next_obs"]), dim=-1)
            next_probs = torch.exp(next_logp)
            next_q = torch.minimum(
                m.q_values(params, batch["next_obs"], "target_q1"),
                m.q_values(params, batch["next_obs"], "target_q2"))
            next_v = torch.sum(next_probs * (next_q - alpha * next_logp),
                               dim=-1)
            target = batch["reward"] + self.gamma * next_v \
                * (1.0 - batch["done"].to(torch.float32))

        q1_all = m.q_values(params, batch["obs"], "q1")
        q2_all = m.q_values(params, batch["obs"], "q2")
        q1_a = take_action_logp(q1_all, batch["action"])
        q2_a = take_action_logp(q2_all, batch["action"])
        q_loss = 0.5 * (torch.mean((q1_a - target) ** 2)
                        + torch.mean((q2_a - target) ** 2))

        # policy: minimize E_s[ sum_a pi(a|s) (alpha log pi - min Q) ]
        q_min = torch.minimum(q1_all, q2_all).detach()
        pi_loss = torch.mean(torch.sum(probs * (alpha * logp - q_min),
                                       dim=-1))

        # temperature: drive policy entropy toward target_entropy
        entropy = -torch.sum(probs * logp, dim=-1)
        alpha_loss = torch.mean(params["log_alpha"] * (
            entropy - self.target_entropy).detach())

        loss = q_loss + pi_loss + alpha_loss
        return loss, {"q_loss": q_loss, "pi_loss": pi_loss,
                      "alpha": torch.exp(params["log_alpha"]),
                      "entropy": torch.mean(entropy)}

    def extra_update(self, params, metrics):
        # polyak target sync (a host-side step after the update)
        params["target_q1"] = polyak(params["target_q1"], params["q1"],
                                     self.tau)
        params["target_q2"] = polyak(params["target_q2"], params["q2"],
                                     self.tau)
        return params


def polyak(target, online, tau: float):
    """``(1 - tau) * target + tau * online``, leaf by leaf."""
    t_leaves, tdef = tree_flatten(target)
    with torch.no_grad():
        return tree_unflatten(tdef, [
            (1 - tau) * a + tau * b
            for a, b in zip(t_leaves, tree_flatten(online)[0])])


class SACContinuousLearner(Learner):
    """Continuous-action SAC losses: reparameterized policy gradient
    through min-Q, twin-critic TD targets with entropy bonus, learned
    temperature toward target entropy -|A| (the SAC paper default)."""

    def __init__(self, module: SACContinuousModule, *, gamma: float = 0.99,
                 tau: float = 0.005, target_entropy: float = None,
                 **kwargs):
        self.gamma = gamma
        self.tau = tau
        self.target_entropy = (target_entropy if target_entropy is not None
                               else -float(module.action_dim))
        super().__init__(module, **kwargs)

    _trainable = SACLearner._trainable
    _merge = SACLearner._merge
    extra_update = SACLearner.extra_update

    def compute_loss(self, params, batch, rng):
        m: SACContinuousModule = self.module
        obs, next_obs = batch["obs"], batch["next_obs"]
        shape = (obs.shape[0], m.action_dim)

        def normal(gen):
            return torch.randn(shape, generator=gen, device=obs.device,
                               dtype=obs.dtype)

        next_noise = draw(rng, "next", normal)
        pi_noise = draw(rng, "pi", normal)
        alpha = torch.exp(params["log_alpha"]).detach()

        # critic target: r + gamma (min target-Q(s', a') - alpha logp')
        with torch.no_grad():
            next_a, next_logp = m.sample_and_logp(params, next_obs, None,
                                                  next_noise)
            next_q = torch.minimum(
                m.q_values(params, next_obs, next_a, "target_q1"),
                m.q_values(params, next_obs, next_a, "target_q2"))
            target = batch["reward"] + self.gamma \
                * (next_q - alpha * next_logp) \
                * (1.0 - batch["done"].to(torch.float32))

        action = batch["action"]
        if action.ndim == 1:
            action = action[..., None]
        q1 = m.q_values(params, obs, action, "q1")
        q2 = m.q_values(params, obs, action, "q2")
        q_loss = 0.5 * (torch.mean((q1 - target) ** 2)
                        + torch.mean((q2 - target) ** 2))

        # actor: reparameterized sample through min-Q (critics frozen)
        pi_a, logp = m.sample_and_logp(params, obs, None, pi_noise)
        frozen = {"q1": _detached(params["q1"]),
                  "q2": _detached(params["q2"])}
        q_min = torch.minimum(m.q_values(frozen, obs, pi_a, "q1"),
                              m.q_values(frozen, obs, pi_a, "q2"))
        pi_loss = torch.mean(alpha * logp - q_min)

        # temperature: entropy (-logp) toward target_entropy
        alpha_loss = torch.mean(
            params["log_alpha"] * (-logp - self.target_entropy).detach())

        loss = q_loss + pi_loss + alpha_loss
        return loss, {"q_loss": q_loss, "pi_loss": pi_loss,
                      "alpha": torch.exp(params["log_alpha"]),
                      "entropy": -torch.mean(logp)}


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.tau = 0.005
        self.buffer_capacity = 50_000
        self.learn_starts = 500
        self.updates_per_iter = 32
        self.train_batch_size = 128
        self.rollout_len = 64
        self.target_entropy = None

    algo_cls = None


class SAC(Algorithm):
    module_kind = "sac"

    def _setup(self):
        cfg: SACConfig = self.config
        spec = self.env_spec
        device = self._learner_device()

        def factory():
            # module_for_env owns the continuous-vs-discrete dispatch
            # (and the action-bound defaults) — the learner follows the
            # module type, so runner and learner can't desynchronize
            module = module_for_env(spec, "sac", hidden=cfg.hidden,
                                    device=device)
            learner_cls = (SACContinuousLearner
                           if isinstance(module, SACContinuousModule)
                           else SACLearner)
            return learner_cls(module, gamma=cfg.gamma, tau=cfg.tau,
                               target_entropy=cfg.target_entropy,
                               lr=cfg.lr, seed=cfg.seed)

        self.learner_group = LearnerGroup(factory, cfg.num_learners,
                                          self._learner_options())
        self.buffer = ReplayBuffer(cfg.buffer_capacity, seed=cfg.seed)
        self.runners.sync_weights(self.learner_group.get_weights())

    def training_step(self) -> Dict[str, Any]:
        cfg: SACConfig = self.config
        results = self.runners.sample(cfg.rollout_len)
        batch, stats = self._merge_runner_results(results)

        obs = np.asarray(batch["obs"])          # [T, B, D]
        next_obs = np.roll(obs, -1, axis=0)
        done = np.asarray(batch["done"], bool)
        # terminated vs truncated: a TRUNCATION boundary must neither
        # cut the TD target (the state isn't terminal) nor bootstrap
        # through the auto-reset (next_obs is the NEXT episode's reset
        # state) — dropping those transitions is the unbiased option.
        # Runners that report `terminated` give the split directly
        # (gym); time_limit_only jax envs are all-truncation.
        if "terminated" in batch:
            terminated = np.asarray(batch["terminated"], bool)
        elif self.env_spec.get("time_limit_only"):
            terminated = np.zeros_like(done)
        else:
            terminated = done
        valid = np.ones(obs.shape[:2], bool)
        valid[-1] = False
        valid &= ~(done & ~terminated)
        flat_idx = valid.reshape(-1)
        flatten = lambda a: a.reshape(-1, *a.shape[2:])[flat_idx]  # noqa
        self.buffer.add_batch({
            "obs": flatten(obs),
            "next_obs": flatten(next_obs),
            "action": flatten(np.asarray(batch["action"])),
            "reward": flatten(np.asarray(batch["reward"])),
            "done": flatten(terminated),
        })

        metrics: Dict[str, float] = {}
        if len(self.buffer) >= cfg.learn_starts:
            for _ in range(cfg.updates_per_iter):
                metrics = self.learner_group.update(
                    self.buffer.sample(cfg.train_batch_size))
            self.runners.sync_weights(self.learner_group.get_weights())
        metrics.update(stats)
        return metrics


SACConfig.algo_cls = SAC
