"""DreamerV3: model-based RL via a learned world model.

The port of ``ray_tpu/rl/algorithms/dreamerv3.py`` (reference:
rllib/algorithms/dreamerv3/dreamerv3.py, torch/dreamerv3_torch_learner.py,
utils/ — RSSM world model, imagination rollouts, actor-critic on
dreamed trajectories).  A compact variant with the same moving parts,
sized for vector-obs envs:

  * RSSM: GRU deterministic state + straight-through categorical
    stochastic latent; prior (h -> z) and posterior (h, embed -> z)
  * heads: decoder (obs recon), reward (symlog MSE), continue (bernoulli)
  * KL balancing with free bits (v3's stop-grad two-sided KL)
  * imagination: a loop of H steps under the actor through the prior
    dynamics, on the device (the JAX package's ``lax.scan``)
  * actor: REINFORCE on lambda-returns (v3's discrete-action estimator),
    critic: symlog regression with an EMA-free lite target (stop-grad)

Everything trains under one update with one Adam (the reference uses one
optimizer per component; the stop-gradient structure is what matters
for correctness).  The GRU keeps the JAX package's gate order (r, u, c)
and its ``[wx | wh]`` layout, so weights cross with ``from_jax_params``.
Draws: every categorical sample is Gumbel-max; the loss reads its three
draws through ``rl_module.draw`` ("observe" [T, B, classes],
"imagine_action" [H, T*B, actions], "imagine_latent" [H, T*B, classes]),
so the parity tests can feed the JAX package's draws.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ..core.learner import Learner, LearnerGroup
from ..core.rl_module import (MODULE_REGISTRY, RLModule, _mlp_apply,
                              _mlp_init, categorical, draw, gumbel,
                              make_generator, take_action_logp, tree_map)
from .algorithm import Algorithm, AlgorithmConfig


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def _uniform(gen: torch.Generator, shape, bound: float):
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return u * (2 * bound) - bound


def _gru_init(gen: torch.Generator, n_in: int, n_hidden: int):
    return {
        "wx": _uniform(gen, (n_in, 3 * n_hidden), 1.0 / math.sqrt(n_in)),
        "wh": _uniform(gen, (n_hidden, 3 * n_hidden),
                       1.0 / math.sqrt(n_hidden)),
        "b": torch.zeros((3 * n_hidden,), device=gen.device),
    }


def _gru(p, h, x):
    gates = x @ p["wx"] + h @ p["wh"] + p["b"]
    r, u, c = torch.chunk(gates, 3, dim=-1)
    r = torch.sigmoid(r)
    u = torch.sigmoid(u)
    c = torch.tanh(r * c)
    return u * h + (1 - u) * c


def _one_hot(idx, n: int):
    return torch.nn.functional.one_hot(idx.long(), n).to(torch.float32)


def _st_categorical(rng, logits, noise=None):
    """Straight-through one-hot sample (v3's unimix omitted for lite).
    ``noise``: the Gumbel draw at the logits' shape."""
    idx = categorical(rng, logits, noise)
    one_hot = _one_hot(idx, logits.shape[-1])
    probs = torch.softmax(logits, dim=-1)
    return one_hot + probs - probs.detach()


class DreamerModule(RLModule):
    """World model + actor + critic parameter bundle.

    Latent state = (h deterministic, z stochastic one-hot); the feature
    vector fed to heads/actor/critic is concat(h, z)."""

    def __init__(self, obs_dim: int, num_actions: int, hidden=(64, 64), *,
                 deter: int = 128, classes: int = 32, device=None):
        super().__init__(obs_dim, num_actions, hidden, device=device)
        self.deter = deter
        self.classes = classes

    @property
    def feat_dim(self):
        return self.deter + self.classes

    def init(self, rng):
        gen = make_generator(rng, self.device)
        h = self.hidden
        return {
            "encoder": _mlp_init(gen, (self.obs_dim, *h, h[-1]),
                                 out_scale=1.0),
            "gru": _gru_init(gen, self.classes + self.num_actions,
                             self.deter),
            "prior": _mlp_init(gen, (self.deter, *h, self.classes),
                               out_scale=1.0),
            "posterior": _mlp_init(
                gen, (self.deter + h[-1], *h, self.classes),
                out_scale=1.0),
            "decoder": _mlp_init(gen, (self.feat_dim, *h, self.obs_dim),
                                 out_scale=1.0),
            "reward": _mlp_init(gen, (self.feat_dim, *h, 1)),
            "cont": _mlp_init(gen, (self.feat_dim, *h, 1), out_scale=1.0),
            "actor": _mlp_init(gen, (self.feat_dim, *h, self.num_actions)),
            "critic": _mlp_init(gen, (self.feat_dim, *h, 1),
                                out_scale=0.01),
        }

    # -- world model pieces -------------------------------------------------

    def encode(self, params, obs):
        return _mlp_apply(params["encoder"], obs)

    def dynamics_step(self, params, h, z, action_onehot):
        return _gru(params["gru"], h,
                    torch.cat([z, action_onehot], dim=-1))

    def prior_logits(self, params, h):
        return _mlp_apply(params["prior"], h)

    def posterior_logits(self, params, h, embed):
        return _mlp_apply(params["posterior"],
                          torch.cat([h, embed], dim=-1))

    def feat(self, h, z):
        return torch.cat([h, z], dim=-1)

    # -- policy API (used by env runners) -----------------------------------

    def _posterior_feat(self, params, obs):
        h = torch.zeros((*obs.shape[:-1], self.deter), device=obs.device,
                        dtype=obs.dtype)
        embed = self.encode(params, obs)
        z = torch.softmax(self.posterior_logits(params, h, embed), dim=-1)
        return self.feat(h, z)

    def logits(self, params, obs):
        """Stateless policy view for the runner: posterior latent from a
        zero GRU state.  Dreaming/training uses the recurrent path; this
        keeps the plain EnvRunner protocol working without carried
        state (lite simplification of the reference's stateful
        EnvRunner)."""
        return _mlp_apply(params["actor"], self._posterior_feat(params, obs))

    def value(self, params, obs):
        return _mlp_apply(params["critic"],
                          self._posterior_feat(params, obs))[..., 0]

    def forward_exploration(self, params, obs, rng, noise=None):
        """``noise``: the Gumbel draw at the logits' shape."""
        logits = self.logits(params, obs)
        action = categorical(rng, logits, noise)
        logp_a = take_action_logp(torch.log_softmax(logits, dim=-1), action)
        return action, {"logp": logp_a, "vf": self.value(params, obs)}

    def forward_inference(self, params, obs):
        return torch.argmax(self.logits(params, obs), dim=-1)


MODULE_REGISTRY["dreamer"] = DreamerModule


def _cat_kl(p_logits, q_logits):
    p = torch.softmax(p_logits, dim=-1)
    return torch.sum(p * (torch.log_softmax(p_logits, dim=-1)
                          - torch.log_softmax(q_logits, dim=-1)), dim=-1)


class DreamerLearner(Learner):
    def __init__(self, module: DreamerModule, *, gamma: float = 0.99,
                 lam: float = 0.95, horizon: int = 15,
                 kl_scale: float = 1.0, free_bits: float = 1.0,
                 entropy_coeff: float = 3e-3, **kwargs):
        self.gamma = gamma
        self.lam = lam
        self.horizon = horizon
        self.kl_scale = kl_scale
        self.free_bits = free_bits
        self.entropy_coeff = entropy_coeff
        super().__init__(module, **kwargs)

    # -- world-model observation (posterior loop over the sequence) --------

    def _observe(self, params, obs_seq, action_seq, noise):
        """obs [T,B,D], action [T,B], Gumbel noise [T,B,classes] ->
        posterior states + KL loss."""
        m = self.module
        T, B = action_seq.shape
        embed = m.encode(params, obs_seq)
        a_onehot = _one_hot(action_seq, m.num_actions)
        h = torch.zeros((B, m.deter), device=obs_seq.device)
        z = torch.zeros((B, m.classes), device=obs_seq.device)
        hs, zs, priors, posts = [], [], [], []
        for t in range(T):
            h = m.dynamics_step(params, h, z, a_onehot[t])
            prior = m.prior_logits(params, h)
            post = m.posterior_logits(params, h, embed[t])
            z = _st_categorical(None, post, noise[t])
            hs.append(h)
            zs.append(z)
            priors.append(prior)
            posts.append(post)
        hs, zs = torch.stack(hs), torch.stack(zs)
        priors, posts = torch.stack(priors), torch.stack(posts)

        # KL balancing (v3): dyn loss trains the prior toward the (frozen)
        # posterior; rep loss nudges the posterior toward the (frozen)
        # prior; both clipped below by free bits
        dyn = _cat_kl(posts.detach(), priors)
        rep = _cat_kl(posts, priors.detach())
        kl = 0.5 * torch.clamp(dyn, min=self.free_bits).mean() \
            + 0.1 * torch.clamp(rep, min=self.free_bits).mean()
        return hs, zs, kl

    # -- imagination --------------------------------------------------------

    def _imagine(self, params, h, z, action_noise, latent_noise):
        """Roll the prior dynamics H steps under the actor.  Dynamics are
        stop-grad for the actor (REINFORCE estimator, v3 discrete)."""
        m = self.module
        p_sg = tree_map(lambda x: x.detach(), params)
        feats, logps, entropies = [], [], []
        for t in range(self.horizon):
            feat = m.feat(h, z)
            logits = _mlp_apply(params["actor"], feat)
            action = categorical(None, logits.detach(), action_noise[t])
            logp_all = torch.log_softmax(logits, dim=-1)
            logp = take_action_logp(logp_all, action)
            entropy = -torch.sum(torch.softmax(logits, dim=-1) * logp_all,
                                 dim=-1)
            h = m.dynamics_step(p_sg, h, z, _one_hot(action, m.num_actions))
            z = _st_categorical(None, m.prior_logits(p_sg, h),
                                latent_noise[t]).detach()
            feats.append(feat)
            logps.append(logp)
            entropies.append(entropy)
        return (torch.stack(feats), torch.stack(logps),
                torch.stack(entropies), m.feat(h, z))

    # -- loss ---------------------------------------------------------------

    def compute_loss(self, params, batch, rng):
        m = self.module
        # batch arrives [B, T]; observe loops over time
        obs = batch["obs"].transpose(0, 1)
        action = batch["action"].transpose(0, 1).long()
        reward = batch["reward"].transpose(0, 1)
        done = batch["done"].transpose(0, 1).to(torch.float32)
        T, B = action.shape
        N, H = T * B, self.horizon

        def noise(shape):
            return lambda gen: gumbel(gen, shape)

        obs_noise = draw(rng, "observe", noise((T, B, m.classes)))
        act_noise = draw(rng, "imagine_action", noise((H, N, m.num_actions)))
        lat_noise = draw(rng, "imagine_latent", noise((H, N, m.classes)))

        hs, zs, kl = self._observe(params, obs, action, obs_noise)
        feats = m.feat(hs, zs)

        recon = _mlp_apply(params["decoder"], feats)
        recon_loss = torch.mean(torch.sum((recon - symlog(obs)) ** 2,
                                          dim=-1))
        pred_r = _mlp_apply(params["reward"], feats)[..., 0]
        reward_loss = torch.mean((pred_r - symlog(reward)) ** 2)
        cont_logit = _mlp_apply(params["cont"], feats)[..., 0]
        cont_target = 1.0 - done
        cont_loss = torch.mean(
            torch.clamp(cont_logit, min=0) - cont_logit * cont_target
            + torch.log1p(torch.exp(-torch.abs(cont_logit))))
        wm_loss = recon_loss + reward_loss + cont_loss + self.kl_scale * kl

        # ---- dream from every posterior state (flattened T*B starts)
        h0 = hs.reshape(-1, m.deter).detach()
        z0 = zs.reshape(-1, m.classes).detach()
        feats_i, logps_i, ent_i, last_feat = self._imagine(
            params, h0, z0, act_noise, lat_noise)

        with torch.no_grad():
            r_i = symexp(_mlp_apply(params["reward"], feats_i)[..., 0])
            c_i = torch.sigmoid(_mlp_apply(params["cont"], feats_i)[..., 0])
        v_i = _mlp_apply(params["critic"], feats_i)[..., 0]
        v_last = _mlp_apply(params["critic"], last_feat)[..., 0]

        # lambda-returns over the dream (v3 eq. 7), all stop-grad values:
        # a reverse loop (the JAX package's reverse lax.scan)
        with torch.no_grad():
            disc = self.gamma * c_i
            v_sg = v_i.detach()
            v_next_seq = torch.cat([v_sg[1:], v_last.detach()[None]], dim=0)
            acc = v_last.detach()
            returns = [None] * H
            for t in range(H - 1, -1, -1):
                acc = r_i[t] + disc[t] * ((1 - self.lam) * v_next_seq[t]
                                          + self.lam * acc)
                returns[t] = acc
            returns = torch.stack(returns)

        critic_loss = torch.mean((v_i - returns) ** 2)
        with torch.no_grad():
            adv = returns - v_sg
            # v3 return normalization (lite): numpy's population std
            adv = adv / (torch.std(adv, correction=0) + 1e-3)
        actor_loss = -torch.mean(adv * logps_i) \
            - self.entropy_coeff * torch.mean(ent_i)

        loss = wm_loss + actor_loss + 0.5 * critic_loss
        return loss, {"wm_loss": wm_loss, "recon_loss": recon_loss,
                      "reward_loss": reward_loss, "kl": kl,
                      "actor_loss": actor_loss,
                      "critic_loss": critic_loss,
                      "dream_return": torch.mean(returns)}


class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.horizon = 15
        self.lam = 0.95
        self.kl_scale = 1.0
        self.free_bits = 1.0
        self.entropy_coeff = 3e-3
        self.deter = 128
        self.classes = 32
        self.rollout_len = 64

    algo_cls = None


class DreamerV3(Algorithm):
    module_kind = "dreamer"

    def _module_kwargs(self):
        return {"deter": self.config.deter, "classes": self.config.classes}

    def _setup(self):
        cfg: DreamerV3Config = self.config
        spec = self.env_spec
        device = self._learner_device()

        def factory():
            module = DreamerModule(spec["obs_dim"], spec["num_actions"],
                                   cfg.hidden, deter=cfg.deter,
                                   classes=cfg.classes, device=device)
            return DreamerLearner(
                module, gamma=cfg.gamma, lam=cfg.lam,
                horizon=cfg.horizon, kl_scale=cfg.kl_scale,
                free_bits=cfg.free_bits,
                entropy_coeff=cfg.entropy_coeff,
                lr=cfg.lr, seed=cfg.seed)

        self.learner_group = LearnerGroup(factory, cfg.num_learners,
                                          self._learner_options())
        self.runners.sync_weights(self.learner_group.get_weights())

    def training_step(self) -> Dict[str, Any]:
        cfg: DreamerV3Config = self.config
        results = self.runners.sample(cfg.rollout_len)
        batch, stats = self._merge_runner_results(results)
        update_batch = {
            k: np.swapaxes(np.asarray(batch[k]), 0, 1)
            for k in ("obs", "action", "reward", "done")
        }
        metrics = self.learner_group.update(update_batch)
        self.runners.sync_weights(self.learner_group.get_weights())
        metrics.update(stats)
        return metrics


DreamerV3Config.algo_cls = DreamerV3
